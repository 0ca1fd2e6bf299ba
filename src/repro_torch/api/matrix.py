"""Scenario-matrix driver: sweep RunSpecs with chain-loop reuse.

The port of ``repro/api/matrix.py``. ``run_matrix(specs)`` executes an
iterable of :class:`RunSpec` cells and emits a tidy results table (stdout +
JSON). ``repro`` compiles one jitted sampling program a signature; the
port's counterpart is **one set of chain loops a signature**:

- specs are grouped by :meth:`RunSpec.executable_signature` (plus whether
  the shards are padded); one :class:`~repro_torch.api.backends.
  BatchedChunkBackend` is built a group, owning its inputs, and every cell
  of the group copies its shards, counts and step size into them (the
  backend refreshes what its kernels derived from the data) and runs in the
  same warmup and collection loops: on the card the same captured graphs.
  ``seed`` (the generator) and an adapted kernel's ``step_size`` (the
  warmup's initial step) are runtime inputs; a fixed-step kernel reads its
  step as a number, so its group also keys on the step;
- groundtruth chains get the same treatment keyed by
  :meth:`RunSpec.groundtruth_signature` (and the compensated step);
- stage outputs are reused too: cells that differ only in combiner share one
  set of subposterior draws and one groundtruth chain.

RNG discipline as :class:`~repro_torch.api.Pipeline`'s (data, sampling,
groundtruth and per-combiner streams from the seed), so a cell's scoreboard
is a standalone Pipeline's for the same spec. A spec with a ``mesh_shape``
is refused, as in the reference.

``backend="mesh_fanout"`` deals the sampling stage of independent cells out
over devices (:func:`_fanout_sample`): the cells of one signature are
stacked in order, padded to a multiple of the device count by repeating the
last, and device k runs its contiguous share through one set of chain loops
of that signature, on a stream of its own; each fan is held to the
chain-group check. The cells draw from their own generators at their own
width, so the rows are the batched sweep's, bit for bit. Groundtruth chains,
combine and score stay on the sweep's device.

CLI::

  PYTHONPATH=src python -m repro_torch.api.matrix --device cpu \\
      --models poisson,linear --samplers rwmh,gibbs \\
      --combiners parametric,nonparametric --M 4 --T 200 --json perf/
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.api.backends import (
    BackendId,
    BatchedChunkBackend,
    GroupStreams,
    resolve_mesh_devices,
)
from repro_torch.api.pipeline import (
    combine_spec_draws,
    groundtruth_step_size,
    resolve_metric,
    stream_generator,
)
from repro_torch.api.sampling import is_padded, make_shard_kernel
from repro_torch.api.spec import RunSpec
from repro_torch.core.subposterior import partition_data
from repro_torch.models.bayes import get_model
from repro_torch.samplers import sampler_spec

Signature = Tuple[Any, ...]
BACKENDS = ("batched", "mesh_fanout")


class MatrixResult(NamedTuple):
    """Outcome of one sweep: tidy rows + chain-loop accounting."""

    rows: List[Dict[str, Any]]
    n_specs: int
    n_executables: int  # sampling chain-loop sets built (one a signature)
    n_groundtruth_executables: int
    signatures: Dict[str, int]  # repr(signature) -> specs served
    backend: str = "batched"  # BackendId string of the sampling executor
    n_graphs: int = 0  # CUDA graphs captured by those loops (0 off the card)
    # operators the fans' chain-group checks watched (None: no fan)
    collectives_checked: Optional[int] = None

    def table(self) -> str:
        head = f"{'spec_id':12s} {'model':8s} {'sampler':8s} {'combiner':16s} " \
               f"{'M':>3s} {'T':>5s} {'seed':>4s} {'acc':>5s} {'metric':6s} {'error':>10s} {'wall_s':>7s}"
        lines = [head, "-" * len(head)]
        for r in self.rows:
            lines.append(
                f"{r['spec_id']:12s} {r['model']:8s} {r['sampler']:8s} "
                f"{r['combiner']:16s} {r['M']:3d} {r['T']:5d} {r['seed']:4d} "
                f"{r['accept']:5.2f} {r['metric']:6s} {r['error']:10.4f} "
                f"{r['wall_s']:7.2f}"
            )
        lines.append(
            f"# {self.n_specs} cells on {self.backend}, "
            f"{self.n_executables} sampling executables, "
            f"{self.n_groundtruth_executables} groundtruth "
            f"executables (chain loops reused for the rest; {self.n_graphs} graphs captured)"
        )
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._asdict())


class ExecutableCache:
    """Per-signature chain loops: one backend (warmup and collection loops)
    for each sampling signature and each groundtruth signature, on inputs it
    owns; each use loads the cell's data into them."""

    def __init__(self):
        self.sample: Dict[Signature, BatchedChunkBackend] = {}
        self.groundtruth: Dict[Signature, BatchedChunkBackend] = {}
        self.fan: Dict[Tuple[Signature, int], BatchedChunkBackend] = {}  # (sig, slot)

    @staticmethod
    def _backend(cache, sig, model, num_shards, spec, use_counts, shards, counts, *,
                 burn_in, step_size) -> BatchedChunkBackend:
        if not (sampler_spec(spec.resolved_sampler()).adaptive and spec.warmup > 0):
            sig = sig + (float(step_size),)  # a fixed step is read as a number
        backend = cache.get(sig)
        if backend is None:
            sk = make_shard_kernel(model, num_shards, spec.resolved_sampler(),
                                   sgld_batch=spec.sgld_batch, use_counts=use_counts,
                                   sampler_options=spec.sampler_options)
            backend = BatchedChunkBackend(sk, shards, counts, burn_in=burn_in,
                                          warmup=spec.warmup, step_size=step_size, owned=True)
            cache[sig] = backend
        else:
            backend.load(shards, counts, step_size)
        return backend

    def sample_backend(self, spec: RunSpec, model, padded: bool, shards,
                       counts: torch.Tensor) -> BatchedChunkBackend:
        """The backend of ``spec``'s sampling signature, loaded with ``shards``."""
        return self._backend(self.sample, spec.executable_signature() + (padded,), model,
                             spec.M, spec, padded, shards, counts,
                             burn_in=spec.resolved_burn_in(), step_size=spec.step_size)

    def groundtruth_backend(self, spec: RunSpec, model, data) -> BatchedChunkBackend:
        """The backend of ``spec``'s groundtruth signature, loaded with ``data``
        as one shard, at the compensated step."""
        keys = model.shard_keys or tuple(data)
        one = {k: (v.unsqueeze(0) if k in keys else v) for k, v in data.items()}
        counts = torch.full((1,), data[keys[0]].shape[0], dtype=torch.int32,
                            device=data[keys[0]].device)
        return self._backend(self.groundtruth, spec.groundtruth_signature(), model, 1, spec,
                             False, one, counts, burn_in=spec.groundtruth_T // 6,
                             step_size=groundtruth_step_size(spec))

    def fan_backend(self, sig: Signature, slot: int, device: torch.device, spec: RunSpec,
                    model, padded: bool, shards, counts: torch.Tensor) -> BatchedChunkBackend:
        """Fan slot ``slot``'s backend of ``spec``'s sampling signature, on
        ``device``, loaded with ``shards`` (moved there)."""
        rows = {k: v.to(device) for k, v in shards.items()}
        return self._backend(self.fan, (sig, slot), model, spec.M, spec, padded, rows,
                             counts.to(device), burn_in=spec.resolved_burn_in(),
                             step_size=spec.step_size)

    def n_graphs(self) -> int:
        return sum(loop.graph is not None
                   for cache in (self.sample, self.groundtruth, self.fan)
                   for backend in cache.values() for loop in backend.loops())


def _partitioned(spec: RunSpec, model, device, part_cache: Dict[Tuple, Tuple]):
    """Data generation + partition, as ``Pipeline.partition``, cached across
    cells that share them."""
    part_key = (spec.model, spec.resolved_n(), spec.seed, spec.M)
    if part_key not in part_cache:
        data, _ = model.generate_data(stream_generator(spec.seed, "data", device),
                                      spec.resolved_n())
        shards, counts = partition_data(data, spec.M, only=model.shard_keys, pad=True)
        part_cache[part_key] = (data, shards, counts)
    return part_cache[part_key]


def _fanout_devices(devices, device: torch.device) -> Tuple[torch.device, ...]:
    """The fan's devices: ``devices`` as given (a device may repeat), else
    every visible CUDA device; fewer than 2 raises."""
    if devices is None:
        count = torch.cuda.device_count() if device.type == "cuda" else 0
        if count < 2:
            raise ValueError(
                f"run_matrix(backend='mesh_fanout') needs >= 2 devices and {count} "
                f"{device.type} devices are visible; pass devices= (a device may repeat) "
                "or use backend='batched'")
        return tuple(torch.device("cuda", i) for i in range(count))
    devs = resolve_mesh_devices((len(tuple(devices)), 1), devices, device)
    if len(devs) < 2:
        raise ValueError("run_matrix(backend='mesh_fanout') needs >= 2 devices")
    return devs


def _fanout_sample(
    specs: List[RunSpec],
    execs: ExecutableCache,
    part_cache: Dict[Tuple, Tuple],
    draws_cache: Dict[Tuple, Tuple],
    devices: Tuple[torch.device, ...],
    device: torch.device,
    *,
    verbose: bool = False,
) -> Tuple[int, int]:
    """The mesh_fanout prepass: fill ``draws_cache`` for every distinct draw
    cell, a fan (one set of chain loops on each device) a signature.

    Cells of a signature (distinct seed or step) are stacked in order and
    padded to a multiple of the device count with the last; device k runs
    the k-th contiguous share, each cell setup and one chunk of T from the
    cell's own generator, on the device's own stream. Every fan's first
    cells are held to the chain-group check before their chunks run.
    Returns ``(fans, operators checked)``.
    """
    ndev = len(devices)
    groups: Dict[Signature, List[Tuple]] = {}
    pending: set = set()
    for spec in specs:
        model = get_model(spec.model)
        _, shards, counts = _partitioned(spec, model, device, part_cache)
        padded = is_padded(model, shards, counts, spec.resolved_sampler())
        sig = spec.executable_signature() + (padded,)
        draws_key = (sig, spec.seed, spec.step_size)
        if draws_key in draws_cache or draws_key in pending:
            continue
        pending.add(draws_key)
        groups.setdefault(sig, []).append((draws_key, spec, model, padded, shards, counts))

    lanes = GroupStreams(devices, device)
    checked = 0
    for sig, cells in groups.items():
        per = -(-len(cells) // ndev)
        padded_cells = cells + [cells[-1]] * (per * ndev - len(cells))
        shares = [padded_cells[k * per:(k + 1) * per] for k in range(ndev)]
        results: List[List[Tuple]] = [[] for _ in range(ndev)]
        for i in range(per):
            cell = [share[i] for share in shares]

            def start(k, draws_key, spec, model, padded, shards, counts):
                b = execs.fan_backend(sig, k, devices[k], spec, model, padded, shards, counts)
                gen = stream_generator(spec.seed, "sample", devices[k])
                state, eps = b.setup(gen)
                return b, gen, state, eps

            started = lanes.run([lambda k=k, c=c: start(k, *c) for k, c in enumerate(cell)])
            backends, gens, states, eps = zip(*started)
            if i == 0:  # the fan's check: one eager chunk of every slot
                checked += lanes.check(backends, states, eps)
            chunks = lanes.run([lambda b=b, gen=gen, st=st, e=e, T=c[1].T:
                                b.next_chunk(gen, e, st, T)
                                for b, gen, st, e, c in zip(backends, gens, states, eps, cell)])
            for k, ((_, theta, accept_sum), c) in enumerate(zip(chunks, cell)):
                results[k].append((c[0], theta.to(device), accept_sum.to(device), c[1].T))
        for share in results:
            for draws_key, theta, accept_sum, T in share:
                draws_cache[draws_key] = (theta, accept_sum / T)
        if verbose:
            print(f"# fanout: {len(cells)} cell(s) of signature {cells[0][1].spec_id}-group "
                  f"over {ndev} devices (padded to {per * ndev})", flush=True)
    return len(groups), checked


def run_matrix(
    specs: Iterable[RunSpec],
    *,
    json_path: Optional[str] = None,
    verbose: bool = False,
    backend: str = "batched",
    device: str | torch.device | None = None,
    devices=None,
) -> MatrixResult:
    """Execute every spec; build one set of chain loops a signature; return
    tidy rows (see the module docstring). ``device``: ``cuda`` unless given.
    ``backend="mesh_fanout"`` deals the cells' sampling over ``devices``
    (default: every visible CUDA device; fewer than 2 raises)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown run_matrix backend {backend!r} — expected one of {BACKENDS}")
    device = resolve_device(device)
    fan_devices = _fanout_devices(devices, device) if backend == "mesh_fanout" else None
    if devices is not None and fan_devices is None:
        raise ValueError("devices= deals cells out over devices: it needs "
                         "backend='mesh_fanout'")
    specs = [s.validate() for s in specs]
    for spec in specs:
        if spec.mesh_shape is not None:
            raise ValueError(
                f"spec {spec.spec_id}: run_matrix drives the vmap backend only within a "
                f"cell — mesh_shape={spec.mesh_shape} belongs to repro_torch.api.Pipeline"
            )
    execs = ExecutableCache()
    draws_cache: Dict[Tuple, Tuple] = {}  # (sig, seed, step) -> (theta, accept)
    gt_cache: Dict[Tuple, torch.Tensor] = {}
    part_cache: Dict[Tuple, Tuple] = {}  # (model, n, seed, M) -> stage inputs
    rows: List[Dict[str, Any]] = []
    signatures: Dict[str, int] = {}
    n_fans = n_checked = None
    if fan_devices is not None:
        n_fans, n_checked = _fanout_sample(specs, execs, part_cache, draws_cache, fan_devices,
                                           device, verbose=verbose)

    for spec in specs:
        t0 = time.time()
        model = get_model(spec.model)
        data, shards, counts = _partitioned(spec, model, device, part_cache)
        padded = is_padded(model, shards, counts, spec.resolved_sampler())
        sig = spec.executable_signature() + (padded,)
        signatures[repr(sig)] = signatures.get(repr(sig), 0) + 1

        draws_key = (sig, spec.seed, spec.step_size)
        if draws_key not in draws_cache:
            b = execs.sample_backend(spec, model, padded, shards, counts)
            theta, accept_sum = b.run_fused(stream_generator(spec.seed, "sample", device),
                                            spec.T)
            draws_cache[draws_key] = (theta, accept_sum / spec.T)
        theta, acc = draws_cache[draws_key]

        # keyed on the compensated step (it depends on M, which the
        # groundtruth signature leaves out)
        gt_key = (spec.groundtruth_signature(), spec.seed, groundtruth_step_size(spec))
        if gt_key not in gt_cache:
            b = execs.groundtruth_backend(spec, model, data)
            gt, _ = b.run_fused(stream_generator(spec.seed, "groundtruth", device),
                                spec.groundtruth_T)
            gt_cache[gt_key] = gt[0]
        gt = gt_cache[gt_key]

        dist, label = resolve_metric(spec, model.d)
        t_row = time.time()
        for name in spec.combiner_names():
            out = combine_spec_draws(spec, theta, names=(name,))[name]
            err = float(dist(gt, out.samples))  # waits for the device
            now = time.time()
            rows.append({
                "spec_id": spec.spec_id,
                "model": spec.model,
                "sampler": spec.resolved_sampler(),
                "combiner": name,
                "M": spec.M,
                "T": spec.T,
                "seed": spec.seed,
                "accept": float(acc.mean()),
                "metric": label,
                "error": err,
                # per-row delta (the first row absorbs the cell's sampling
                # and groundtruth cost)
                "wall_s": now - t_row,
            })
            t_row = now
        if verbose:
            print(f"# cell {spec.spec_id} ({spec.model}/{spec.resolved_sampler()}) "
                  f"done in {time.time() - t0:.1f}s", flush=True)

    result = MatrixResult(
        rows=rows,
        n_specs=len(specs),
        n_executables=len(execs.sample) if n_fans is None else n_fans,
        n_groundtruth_executables=len(execs.groundtruth),
        signatures=signatures,
        backend=(BackendId.batched(device.type) if fan_devices is None
                 else BackendId.mesh_fanout(device.type, len(fan_devices))),
        n_graphs=execs.n_graphs(),
        collectives_checked=n_checked,
    )
    if json_path is not None:
        path = _json_path(json_path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(result.to_dict(), f, indent=1)
    return result


def _json_path(arg: str) -> str:
    """A ``.json`` arg is a file; anything else a directory getting an
    auto-named ``MATRIX_<timestamp>.json``."""
    if arg.endswith(".json") and not os.path.isdir(arg):
        return arg
    return os.path.join(arg, f"MATRIX_{time.strftime('%Y%m%d_%H%M%S')}.json")


def main(argv=None) -> MatrixResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--models", default="poisson,linear")
    ap.add_argument("--samplers", default="rwmh,gibbs")
    ap.add_argument("--combiners", default="parametric,nonparametric")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--M", type=int, default=4)
    ap.add_argument("--T", type=int, default=200)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--step", type=float, default=0.1)
    ap.add_argument("--n", type=int, default=0, help="dataset size (0 = model default)")
    ap.add_argument("--gt-T", type=int, default=400)
    ap.add_argument(
        "--metric", default="auto", choices=("auto", "l2", "logl2"),
        help="scoreboard distance (logl2 keeps narrow posteriors finite)",
    )
    ap.add_argument("--json", default=None, metavar="PATH")
    ap.add_argument("--backend", default="batched", choices=BACKENDS,
                    help="mesh_fanout deals cells out over devices")
    ap.add_argument("--devices", default=None,
                    help="mesh_fanout's devices, comma-separated (a device may repeat; "
                    "default: every visible CUDA device)")
    args = ap.parse_args(argv)

    split = lambda s: tuple(x for x in s.split(",") if x)  # noqa: E731
    specs = [
        RunSpec(
            model=m, sampler=s, combiner=c, M=args.M, T=args.T,
            warmup=args.warmup, step_size=args.step, n=args.n,
            seed=int(seed), groundtruth_T=args.gt_T,
            score_metric=args.metric,
        )
        for m, s, c, seed in itertools.product(
            split(args.models), split(args.samplers),
            split(args.combiners), split(args.seeds),
        )
    ]
    result = run_matrix(specs, json_path=args.json, verbose=True, backend=args.backend,
                        device=args.device,
                        devices=None if args.devices is None else split(args.devices))
    print(result.table())
    return result


if __name__ == "__main__":
    main()
