"""Multi-process launch: ``python -m repro_torch.api.launch``.

The port of ``repro/api/launch.py``. The paper's algorithm is embarrassingly
parallel across machines: each process owns a slice of the chains, samples
it with no communication, and only the combination step talks. Every
process runs the same command with its ``--process-id``, and

- **data** is generated identically everywhere from the spec's seed, and a
  rank's shards are its slice of the same global partition;
- **sampling** streams the rank's chains ``[lo, hi)``
  (:func:`~repro_torch.api.streaming.stream_sample` with ``chains=``), whose
  draws are replayed at the full width M from the sampling stage's
  generator (:func:`~repro_torch.api.sampling.chain_slice_kernel`): a
  chain's draws depend only on the spec and its index, so 1, 2 or M
  processes give the same draws per chain, and the single-process run is
  the Pipeline's chunked run;
- **combination** folds every chunk into a moments-backed streaming
  combiner (``online``), and only that O(M·d²) state and the per-chain
  acceptance rates cross processes: each rank puts its slice into a
  :class:`torch.distributed.TCPStore` (rank 0 is the master; no process
  group, no NCCL) as numpy ``savez`` bytes, leaves named so they sort, and
  every rank concatenates the slices along the chain axis in rank order
  (per-chain moments are disjoint, so the concatenation is the
  single-process state). The draws, O(M·T·d), never leave their process.

Finalisation uses the Pipeline's combine-stage generators, so a launch
scores as the same experiment. Two processes on one machine::

    python -m repro_torch.api.launch --coordinator localhost:29512 \\
        --num-processes 2 --process-id 1 --model poisson --sampler gibbs &
    python -m repro_torch.api.launch --coordinator localhost:29512 \\
        --num-processes 2 --process-id 0 --model poisson --sampler gibbs

Rank 0 prints the record (``--json PATH`` writes it from any rank); with
``--num-processes 1`` (the default) no coordinator is needed. ``--device``
is ``cuda`` unless given.
"""

from __future__ import annotations

import argparse
import datetime
import io
import json
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

# moments-backed streaming combiners: their state does not grow with T
LAUNCHABLE_COMBINERS = ("online",)


def _kv_allgather(store, tag: str, tree: Any, rank: int, num_processes: int,
                  device: torch.device):
    """Allgather a small tensor tree through the store: every leaf
    concatenated along its leading (chain) axis in rank order. Returns the
    merged tree and the bytes this rank put into the store."""
    from repro_torch.samplers.base import tree_leaves, tree_map

    leaves = tree_leaves(tree)
    buf = io.BytesIO()
    # fixed-width names keep np.load's order past 10 leaves
    np.savez(buf, **{f"a{i:03d}": leaf.detach().cpu().numpy() for i, leaf in enumerate(leaves)})
    payload = buf.getvalue()
    store.set(f"{tag}/{rank}", payload)
    per_rank = []
    for r in range(num_processes):
        raw = payload if r == rank else store.get(f"{tag}/{r}")  # waits for the key
        with np.load(io.BytesIO(raw)) as z:
            per_rank.append([z[f"a{i:03d}"] for i in range(len(leaves))])
    merged = iter([torch.from_numpy(np.concatenate([g[i] for g in per_rank], axis=0)).to(device)
                   for i in range(len(leaves))])
    return tree_map(lambda _: next(merged), tree), len(payload)


def run_launch(spec, *, num_processes: int = 1, process_id: int = 0,
               device: str | torch.device | None = None, store=None) -> Dict[str, Any]:
    """One rank of the multi-process run; returns its record (every rank
    computes the same finalized estimate). ``store``: the run's
    :class:`torch.distributed.TCPStore`, needed with more than one process."""
    from repro_torch import resolve_device
    from repro_torch.api.backends import BackendId
    from repro_torch.api.pipeline import COMBINE_DEFAULTS, stream_generator
    from repro_torch.api.streaming import stream_sample
    from repro_torch.core.combiners import filter_options, get_streaming_combiner
    from repro_torch.models.bayes import get_model

    spec = spec.validate()
    names = spec.combiner_names()
    bad = [n for n in names if n not in LAUNCHABLE_COMBINERS]
    if bad:
        raise ValueError(
            f"combiner(s) {bad} cannot run on the launch path — only the moments-backed "
            f"{LAUNCHABLE_COMBINERS} exchange O(M*d^2) state across processes (draw-buffer "
            "streaming states grow with T; run those in one process via "
            "Pipeline.stream_combine)"
        )
    if spec.M % num_processes != 0:
        raise ValueError(f"M={spec.M} chains must divide evenly over --num-processes "
                         f"{num_processes}")
    if spec.mesh_shape is not None:
        raise ValueError(
            "the launch path shards chains across *processes* — "
            f"mesh_shape={spec.mesh_shape} (within-process device mesh) belongs to "
            "repro_torch.api.Pipeline"
        )
    if num_processes > 1 and store is None:
        raise ValueError("more than one process needs the coordinator's store")

    t_start = time.time()
    device = resolve_device(device)
    model = get_model(spec.model)
    data, _ = model.generate_data(stream_generator(spec.seed, "data", device),
                                  spec.resolved_n())
    per = spec.M // num_processes
    T = spec.T
    scs = {name: get_streaming_combiner(name) for name in names}
    states = {name: scs[name].init(per, model.d, device=device) for name in names}

    def fold(ev) -> None:
        for name in names:
            states[name] = scs[name].update(states[name], ev.theta)

    # the rank's chains, streamed at the cadence into the combiners
    res = stream_sample(
        stream_generator(spec.seed, "sample", device), model, data, spec.M, T,
        sampler=spec.resolved_sampler(), warmup=spec.warmup,
        burn_in=spec.resolved_burn_in(), step_size=spec.step_size, sgld_batch=spec.sgld_batch,
        sampler_options=spec.sampler_options, chunk_size=spec.stream_every, on_chunk=[fold],
        chains=(process_id * per, (process_id + 1) * per),
    ).result
    accept = res.accept

    # the only traffic between processes: combine state and acceptance rates
    sent = 0
    if num_processes > 1:
        for name in names:
            states[name], n = _kv_allgather(store, f"combine/{name}", states[name], process_id,
                                            num_processes, device)
            sent += n
        accept, n = _kv_allgather(store, "accept", accept, process_id, num_processes, device)
        sent += n

    options = dict(COMBINE_DEFAULTS, **dict(spec.combiner_options))
    combined = {}
    for name in names:
        fn = scs[name].finalize
        res = fn(stream_generator(spec.seed, "combine", device, name), states[name], T,
                 **filter_options(fn, options))
        combined[name] = res.samples.cpu()
    return {
        "spec_id": spec.spec_id,
        "backend": BackendId.distributed(num_processes),
        "model": spec.model,
        "sampler": spec.resolved_sampler(),
        "M": spec.M,
        "T": T,
        "seed": spec.seed,
        "num_processes": num_processes,
        "process_id": process_id,
        "device": str(device),
        "accept": float(accept.mean()),
        "combined": {
            name: {"mean": s.mean(dim=0).tolist(), "std": s.std(dim=0, correction=0).tolist(),
                   "samples": s.tolist()}
            for name, s in combined.items()
        },
        "store_bytes": sent,  # what this rank put into the store
        "wall_s": time.time() - t_start,
    }


def _connect(coordinator: str, num_processes: int, process_id: int,
            timeout_s: float) -> "torch.distributed.TCPStore":
    """The run's store at ``HOST:PORT``: rank 0 serves it, every rank
    connects, each waiting at most ``timeout_s``."""
    from torch.distributed import TCPStore

    host, _, port = coordinator.rpartition(":")
    return TCPStore(host or "localhost", int(port), num_processes, process_id == 0,
                    timeout=datetime.timedelta(seconds=timeout_s), wait_for_workers=True)


def main(argv=None) -> Optional[Dict[str, Any]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="rank 0's store address; required when --num-processes > 1")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--model", default="poisson")
    ap.add_argument("--sampler", default=None)
    ap.add_argument("--combiner", default="online")
    ap.add_argument("--M", type=int, default=4)
    ap.add_argument("--T", type=int, default=200)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--step", type=float, default=0.1)
    ap.add_argument("--n", type=int, default=0, help="dataset size (0 = model default)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stream-every", type=int, default=0,
                    help="chunk cadence (0 = one chunk)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a rank waits for the store and the other ranks' slices")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write this rank's result record here")
    args = ap.parse_args(argv)

    store = None
    if args.num_processes > 1:
        if args.coordinator is None:
            raise SystemExit("--num-processes > 1 needs --coordinator HOST:PORT "
                             "(rank 0's address, same value on every rank)")
        store = _connect(args.coordinator, args.num_processes, args.process_id, args.timeout)

    from repro_torch.api.spec import RunSpec

    spec = RunSpec(
        model=args.model, sampler=args.sampler, combiner=args.combiner, M=args.M, T=args.T,
        warmup=args.warmup, step_size=args.step, n=args.n, seed=args.seed,
        stream_every=args.stream_every,
    )
    record = run_launch(spec, num_processes=args.num_processes, process_id=args.process_id,
                        device=args.device, store=store)
    out = json.dumps(record, indent=1)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out + "\n")
    if args.process_id == 0:
        print(out)
    if store is not None:
        # rank 0 serves the store: it leaves once every rank has read
        store.set(f"done/{args.process_id}", b"1")
        if args.process_id == 0:
            store.wait([f"done/{r}" for r in range(args.num_processes)],
                       datetime.timedelta(seconds=args.timeout))
    return record if args.process_id == 0 else None


if __name__ == "__main__":
    main()
