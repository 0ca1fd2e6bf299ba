"""Run the paper's pipeline with the port and print one scoreboard per seed.

    PYTHONPATH=src python -m repro_torch.launch.mcmc_run --device cpu --seeds 0 1 2
    PYTHONPATH=src python -m repro_torch.launch.mcmc_run --device cpu --seeds 0 1 2 --combiner all
    PYTHONPATH=src python -m repro_torch.launch.mcmc_run --device cpu --combiner all --stream-every 120
    PYTHONPATH=src python -m repro_torch.launch.mcmc_run --device cpu --model poisson --sampler gibbs
    PYTHONPATH=src python -m repro_torch.launch.mcmc_run --device cpu --combiner all --stream-every 120 --serve

The default spec is the paper's §8.1 logistic-regression experiment at full
width (:data:`PAPER_SPEC`: n=50,000, d=50, M=10, T=1200, MALA, the
parametric / nonparametric / semiparametric combiners with kernel-scored IMG
sweeps of 16 chains). ``--combiner all`` scores every registered combiner
(:data:`ALL_SPEC`: the same run, plus a density-guided Weierstrass start over
a 1,000-point pool); ``--combiner NAME ...`` scores the named ones under
ALL_SPEC's options. ``--stream-every N`` combines while sampling
(``Pipeline.stream_combine``, :data:`STREAM_SPEC` is ALL_SPEC at N = 120 =
T/10) and prints the trajectory first; ``--checkpoint-dir`` /
``--checkpoint-every`` persist the sampling stage and resume it. Each seed
prints its scoreboard as one JSON line.

``--model`` runs the paper's other experiments at ``repro``'s own model
defaults, M=10, T=1200 and the same three combiners: :data:`LINEAR_SPEC`
(the closed-form oracle, n=10,000, d=10, MALA), :data:`POISSON_SPEC` (§8.3,
n=50,000, d=2, Gibbs over the latents) and :data:`GMM_SPEC` (§8.2, n=50,000,
K=10 means in 2-d, d=20, random-walk MH, scored in logL2). ``--sampler`` and ``--n`` override
the spec's sampler and dataset size, as in ``repro``'s CLI.

``--mesh-shape NDATA[,NMODEL]`` splits the chains into NDATA groups over
devices (one CUDA device a group, or the comma-separated ``--mesh-devices``,
where a device may repeat: ``--device cpu --mesh-shape 2,1 --mesh-devices
cpu,cpu``); the draws are the batched run's, bit for bit, and the scoreboard
line carries ``collectives_checked``.

``--serve`` runs the same Pipeline behind the :mod:`repro_torch.serve`
posterior server (it needs ``--stream-every``): sampling streams chunks into
the folder while ``--serve-readers`` concurrent TCP readers (and any external
``repro_torch.serve.ServeClient`` on ``--serve-port``) query mean/cov,
quantiles, predictive draws and the machine-KDE log density, with staleness
metadata on every response; then the ordinary scoreboard is scored over the
served draws. :data:`SERVE_SPEC` is the serving cell: ``STREAM_SPEC`` served.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional, Sequence

from repro_torch.api import Pipeline, RunSpec
from repro_torch.core.combiners import available_combiners
from repro_torch.models.bayes import available_models, get_model
from repro_torch.samplers import available_samplers

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
STREAM_SPEC = dataclasses.replace(ALL_SPEC, stream_every=120)
# the posterior server's cell: STREAM_SPEC's fields, nothing cut
SERVE_SPEC = STREAM_SPEC
# the paper's other experiments, at repro's model defaults (n, d, sampler)
LINEAR_SPEC = dataclasses.replace(PAPER_SPEC, model="linear", sampler=None)
POISSON_SPEC = dataclasses.replace(PAPER_SPEC, model="poisson", sampler="gibbs")
# scored in logL2: the GMM's subposteriors are so concentrated (n=50,000,
# 500 points a mean) that the raw L2's KDE normalizer overflows float32 at
# d=20 (L2 inf or NaN in both packages' runs)
GMM_SPEC = dataclasses.replace(PAPER_SPEC, model="gmm", sampler=None, score_metric="logl2")
MODEL_SPECS = {"logreg": PAPER_SPEC, "linear": LINEAR_SPEC, "poisson": POISSON_SPEC,
               "gmm": GMM_SPEC}


def spec_for(combiner: Optional[Sequence[str]], model: Optional[str] = None) -> RunSpec:
    """PAPER_SPEC without ``--combiner``; ALL_SPEC for ``all``; else the named
    combiners under ALL_SPEC's options. ``model``: that model's spec
    (:data:`MODEL_SPECS`, else PAPER_SPEC's fields on it) in place of logreg's."""
    if not combiner:
        base = PAPER_SPEC
    elif list(combiner) == ["all"]:
        base = ALL_SPEC
    else:
        base = dataclasses.replace(ALL_SPEC, combiner=tuple(combiner))
    if model is None:
        return base
    name = get_model(model).name
    own = MODEL_SPECS.get(name, dataclasses.replace(PAPER_SPEC, model=name, sampler=None))
    return dataclasses.replace(base, model=own.model, sampler=own.sampler,
                               score_metric=own.score_metric)


def add_combiner_option(ap: argparse.ArgumentParser) -> None:
    """``--combiner``: the argument :func:`spec_for` takes."""
    ap.add_argument(
        "--combiner", nargs="+", default=None, choices=("all",) + available_combiners(),
        help="all, or registry names (default: the paper's three combiners)",
    )


def print_trajectory(sr) -> None:
    """The stream's trajectory, as the reference CLI prints it."""
    first = sr.trajectory[0] if sr.trajectory else None
    if first is not None:
        print(
            f"streaming: first {sr.metric} estimate ({first['combiner']}, t={first['t']}) "
            f"after {first['elapsed_s']:.1f}s; {len(sr.trajectory)} trajectory points "
            f"over {sr.t_done}/{sr.total} draws"
        )
    for row in sr.trajectory:
        err = "  -  " if row["error"] is None else f"{row['error']:.4f}"
        print(f"  t={row['t']:6d} {sr.metric}({row['combiner']:15s}) = {err}"
              f"  [{row['elapsed_s']:.1f}s]")


def parse_mesh(arg: Optional[str]):
    """``"4,1"`` → ``(4, 1)``; ``"4"`` → ``(4, 1)``; ``None``/``""`` → None."""
    if not arg:
        return None
    parts = tuple(int(x) for x in arg.split(",") if x)
    return parts if len(parts) == 2 else parts + (1,)


def build_spec(args: argparse.Namespace) -> RunSpec:
    """The adapter: argparse namespace → the declarative RunSpec of the first
    seed (:func:`spec_for` the combiners and model, then the overrides)."""
    spec = dataclasses.replace(spec_for(args.combiner, args.model),
                               stream_every=args.stream_every, seed=args.seeds[0],
                               mesh_shape=parse_mesh(getattr(args, "mesh_shape", None)))
    if args.sampler is not None:
        spec = dataclasses.replace(spec, sampler=args.sampler)
    if args.n is not None:
        spec = dataclasses.replace(spec, n=args.n)
    return spec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seeds", type=int, nargs="+", default=[PAPER_SPEC.seed])
    ap.add_argument("--model", default=None, choices=available_models(),
                    help="model registry name (default: logreg, the paper's §8.1)")
    ap.add_argument("--sampler", default=None, choices=available_samplers(),
                    help="sampler registry name (default: the spec's, else the model's)")
    ap.add_argument("--n", type=int, default=None, help="dataset size (default: the model's)")
    add_combiner_option(ap)
    ap.add_argument(
        "--stream-every", type=int, default=0,
        help="combine-while-sampling: fold every N landed draws into the streaming "
        "combiners and print the scoreboard trajectory (0 = off)",
    )
    ap.add_argument("--mesh-shape", default=None, metavar="NDATA[,NMODEL]",
                    help="split the chains into NDATA groups over devices (default: one "
                    "device; more than one visible CUDA device dividing M splits over all)")
    ap.add_argument("--mesh-devices", default=None, metavar="DEV,DEV,...",
                    help="the groups' devices (a device may repeat; default: one CUDA "
                    "device a group)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="persist/resume the sampling stage here (chunked kernel state)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="draws per sampling checkpoint (with --checkpoint-dir; 0 = at end)")
    ap.add_argument(
        "--serve", action="store_true",
        help="posterior-as-a-service: run sampling behind a repro_torch.serve asyncio "
        "server (needs --stream-every) and answer posterior queries while the chains "
        "extend; composes with --checkpoint-dir (restart resumes from the last checkpoint)",
    )
    ap.add_argument("--serve-port", type=int, default=0,
                    help="TCP port for --serve (0 = ephemeral, printed at startup)")
    ap.add_argument(
        "--serve-readers", type=int, default=4,
        help="concurrent self-probe readers cycling posterior queries during --serve "
        "(each asserts staleness counters monotone); 0 = serve without probing",
    )
    args = ap.parse_args(argv)
    if args.checkpoint_dir is not None and len(args.seeds) > 1:
        # a checkpoint belongs to one spec, and the seed is part of it
        ap.error("--checkpoint-dir takes one seed (each seed is its own run to resume)")
    if args.serve and args.stream_every <= 0:
        ap.error("--serve needs --stream-every > 0 (the serving cadence)")
    base = build_spec(args)
    for seed in args.seeds:
        spec = dataclasses.replace(base, seed=seed)
        devices = None if args.mesh_devices is None else tuple(args.mesh_devices.split(","))
        pipe = Pipeline(spec, device=args.device, checkpoint_dir=args.checkpoint_dir,
                        checkpoint_every=args.checkpoint_every, devices=devices)
        if args.serve:
            from repro_torch.serve import serve_pipeline

            serve_pipeline(pipe, port=args.serve_port, probe_readers=args.serve_readers)
            # sampling is complete (and cached on the Pipeline): fall through
            # to the ordinary combine+score scoreboard over the served draws
        elif args.stream_every > 0:
            print_trajectory(pipe.stream_combine())
        board = pipe.run()
        print(json.dumps({"seed": seed, "device": args.device or "cuda", **board.to_dict()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
