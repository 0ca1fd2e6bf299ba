"""Run the paper's pipeline with the port and print one scoreboard per seed.

    PYTHONPATH=src python -m repro_torch.launch.mcmc_run --device cpu --seeds 0 1 2

The spec is the paper's §8.1 logistic-regression experiment at full
width (:data:`PAPER_SPEC`: n=50,000, d=50, M=10, T=1200, MALA, the
parametric / nonparametric / semiparametric combiners with kernel-scored IMG
sweeps of 16 chains). Each seed prints its scoreboard as one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional, Sequence

from repro_torch.api import Pipeline, RunSpec

PAPER_SPEC = RunSpec(
    model="logreg", sampler="mala", M=10, T=1200, seed=0,
    combiner=("parametric", "nonparametric", "semiparametric"),
    combiner_options={"weight_eval": "kernel", "n_batch": 16},
)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seeds", type=int, nargs="+", default=[PAPER_SPEC.seed])
    args = ap.parse_args(argv)
    for seed in args.seeds:
        spec = dataclasses.replace(PAPER_SPEC, seed=seed)
        board = Pipeline(spec, device=args.device).run()
        print(json.dumps({"seed": seed, "device": args.device or "cuda", **board.to_dict()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
