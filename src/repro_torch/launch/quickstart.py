"""Quickstart: the whole paper through ``repro_torch.api``.

The torch variant of ``examples/quickstart.py``, on the card unless told
otherwise::

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu] [--T 2000]

One declarative :class:`RunSpec` names the scenario (model × sampler ×
combiners × M); the staged :class:`Pipeline` runs the paper's dataflow —
partition → sample (zero communication) → combine → score — with every
stage's artifact inspectable on the way. The linear-Gaussian model has a
closed-form posterior, so the combiners are graded against the exact answer
key, not just a long chain.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

from repro_torch.api import Pipeline, RunSpec
from repro_torch.models.bayes import linear_gaussian as lg

SPEC = RunSpec(
    model="linear",
    sampler="rwmh",  # paper §2's example sampler; any registry name works
    combiner=("parametric", "nonparametric", "semiparametric", "subpost_average"),
    M=8,
    T=2000,
    n=4096,
    warmup=300,
    groundtruth_T=2000,
    score_metric="logl2",  # the linear posterior is narrow: score in log space
    seed=0,
)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--T", type=int, default=SPEC.T, help="draws per subposterior chain")
    args = ap.parse_args(argv)
    spec = dataclasses.replace(SPEC, T=args.T)
    print(f"spec {spec.spec_id}: {spec.to_json()}")

    pipe = Pipeline(spec, device=args.device)

    # -- stage 1: partition onto M "machines" -----------------------------------
    sharded = pipe.partition()
    posterior = lg.posterior_moments(sharded.data)  # closed form: the answer key
    print(f"partitioned n={spec.n} rows into M={spec.M} shards "
          f"(counts={sharded.counts.tolist()})")
    print(f"true posterior mean: {posterior.mean[:4].tolist()}...")

    # -- stage 2: each machine samples its subposterior (Eq 2.1), independently
    draws = pipe.sample()
    print(f"sampled {spec.M} subposteriors in parallel: θ {tuple(draws.theta.shape)}, "
          f"mean acceptance {float(draws.accept.mean()):.2f}, backend={draws.backend}")

    # -- stage 3: combine (the only communicating stage) ------------------------
    mean_errors = {}
    for name, result in pipe.combine().items():
        mean_errors[name] = float((result.samples.mean(0) - posterior.mean).norm())
        print(f"{name:16s}: |combined mean − true mean| = {mean_errors[name]:.4f} "
              f"(IMG acceptance {float(result.acceptance_rate):.2f})")

    # -- stage 4: score against a full-data groundtruth chain -------------------
    # (subpost_average is the paper's Fig-1 cautionary baseline: watch it lose)
    board = pipe.score()
    print(board.table())
    return {"mean_errors": mean_errors, "errors": dict(board.errors)}


if __name__ == "__main__":
    main()
