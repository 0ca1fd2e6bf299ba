"""Stage times of ``Pipeline(spec).run()``, to compare two trees in turns.

    python src/repro_torch/launch/time_stages.py [--tree DIR] [--repeats 3] \\
        [--mesh-shape 2,1 --devices cuda:0,cuda:0] CELL [CELL ...]

A cell is a spec of ``launch/mcmc_run.py`` (``PAPER_SPEC``, ``LINEAR_SPEC``,
``POISSON_SPEC``, ...), optionally ``:sampler`` (``LINEAR_SPEC:gibbs``).
The script imports ``repro_torch`` from ``DIR/src`` (default: this
checkout's), so one command can time a parent tree and a changed tree one
after the other on the same card. Each cell runs once to warm up (kernel
builds, captures, allocator), then ``--repeats`` times; every run prints one
JSON line with the tree, the cell and the board's stage times. With
``--mesh-shape`` the cell runs on chain groups over ``--devices``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cells", nargs="+", help="SPEC_NAME[:sampler] of launch/mcmc_run.py")
    ap.add_argument("--tree", default=None,
                    help="the checkout whose repro_torch is timed (default: this one)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--mesh-shape", default=None, metavar="NDATA[,NMODEL]")
    ap.add_argument("--devices", default=None, help="the chain groups' devices, comma-separated")
    ap.add_argument("--T", type=int, default=None, help="draws a chain (default: the spec's)")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    src = os.path.join(os.path.abspath(args.tree), "src") if args.tree else here
    sys.path.insert(0, src)

    import repro_torch
    from repro_torch.api import Pipeline
    from repro_torch.launch import mcmc_run

    mesh = tuple(int(x) for x in args.mesh_shape.split(",")) if args.mesh_shape else None
    devices = tuple(args.devices.split(",")) if args.devices else None
    for cell in args.cells:
        name, _, sampler = cell.partition(":")
        spec = getattr(mcmc_run, name)
        over = dict(sampler=sampler) if sampler else {}
        if mesh is not None:
            over["mesh_shape"] = mesh
        if args.T is not None:
            over["T"] = args.T
        spec = dataclasses.replace(spec, **over)
        extra = dict(devices=devices) if devices else {}
        for run in range(args.repeats + 1):
            board = Pipeline(spec, device=args.device, **extra).run()
            if run == 0:
                continue  # the warm-up
            print(json.dumps({"tree": os.path.dirname(os.path.dirname(repro_torch.__file__)),
                              "cell": cell, "mesh_shape": mesh,
                              "run": run, "backend": board.backend,
                              "timings_s": board.timings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
