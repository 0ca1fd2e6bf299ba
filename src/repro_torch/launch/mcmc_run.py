"""Run the paper's pipeline with the port and print one scoreboard per seed.

    PYTHONPATH=src python -m repro_torch.launch.mcmc_run --device cpu --seeds 0 1 2
    PYTHONPATH=src python -m repro_torch.launch.mcmc_run --device cpu --seeds 0 1 2 --combiner all

The default spec is the paper's §8.1 logistic-regression experiment at full
width (:data:`PAPER_SPEC`: n=50,000, d=50, M=10, T=1200, MALA, the
parametric / nonparametric / semiparametric combiners with kernel-scored IMG
sweeps of 16 chains). ``--combiner all`` scores every registered combiner
(:data:`ALL_SPEC`: the same run, plus a density-guided Weierstrass start over
a 1,000-point pool); ``--combiner NAME ...`` scores the named ones under
ALL_SPEC's options. Each seed prints its scoreboard as one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional, Sequence

from repro_torch.api import Pipeline, RunSpec
from repro_torch.core.combiners import available_combiners

PAPER_SPEC = RunSpec(
    model="logreg", sampler="mala", M=10, T=1200, seed=0,
    combiner=("parametric", "nonparametric", "semiparametric"),
    combiner_options={"weight_eval": "kernel", "n_batch": 16},
)
ALL_SPEC = RunSpec(
    model="logreg", sampler="mala", M=10, T=1200, seed=0,
    combiner="all",
    combiner_options={"weight_eval": "kernel", "n_batch": 16, "init_pool": 1000},
)


def spec_for(combiner: Optional[Sequence[str]]) -> RunSpec:
    """PAPER_SPEC without ``--combiner``; ALL_SPEC for ``all``; else the named
    combiners under ALL_SPEC's options."""
    if not combiner:
        return PAPER_SPEC
    if list(combiner) == ["all"]:
        return ALL_SPEC
    return dataclasses.replace(ALL_SPEC, combiner=tuple(combiner))


def add_combiner_option(ap: argparse.ArgumentParser) -> None:
    """``--combiner``: the argument :func:`spec_for` takes."""
    ap.add_argument(
        "--combiner", nargs="+", default=None, choices=("all",) + available_combiners(),
        help="all, or registry names (default: the paper's three combiners)",
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seeds", type=int, nargs="+", default=[PAPER_SPEC.seed])
    add_combiner_option(ap)
    args = ap.parse_args(argv)
    base = spec_for(args.combiner)
    for seed in args.seeds:
        spec = dataclasses.replace(base, seed=seed)
        board = Pipeline(spec, device=args.device).run()
        print(json.dumps({"seed": seed, "device": args.device or "cuda", **board.to_dict()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
