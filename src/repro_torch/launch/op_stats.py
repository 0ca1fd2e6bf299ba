"""Per-device flops, bytes, collectives and memory of one step, tallied as it runs.

The counterpart of ``repro/launch/hlo_stats.py``'s ``analyze``. The
reference parses the SPMD-partitioned HLO of a compiled step; PyTorch runs
the step eagerly and has no HLO to read, so this module watches the step
instead: a :class:`~torch.utils._python_dispatch.TorchDispatchMode` sees
every operator one rank dispatches on its local shards (on the meta device
in the dry run, so nothing is computed and nothing allocated). DTensor's
own operators are let through to their local operators, and DTensor's
sharding propagation (fake tensors of the global shapes) is not counted.
Per device:

- ``flops``: every local operator's flops by ``torch.utils.flop_counter``'s
  formulas (matrix products, convolutions, attention), plus the flash
  kernels' work on the meta device (``kernels/flash_attention/ops.py``'s
  ``META_WORK``: 2·(hd + hd_v) a visible pair forward, 2.5 times that
  backward);
- ``bytes_accessed``: every operator's operand and output bytes, view
  operators excluded, the flash kernels' included: the eager counterpart of
  hlo_stats' fusion-boundary proxy. It overcounts what a fused step moves:
  each elementwise pass of an eager step is its own operator;
- ``collective_bytes`` (operand bytes) and ``collective_count``, by kind
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``broadcast``), and each collective's rank group and bytes
  (:attr:`OpStats.groups`, what ``distributed/epmcmc.py``'s chain check
  and the dry run's link rates read);
- ``argument_bytes`` and ``output_bytes``: the local bytes of the step's
  inputs and results, each storage once;
- ``peak_bytes``: the most bytes live at once, starting from the
  arguments: every new storage an operator returns is added when it is
  made and taken off when Python frees it (a finalizer on the storage), so
  autograd's saved tensors count while they are held. The card's caching
  allocator rounds blocks and keeps freed ones, which this does not model.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

KINDS = {
    "all_gather": "all-gather", "all_reduce": "all-reduce", "allreduce": "all-reduce",
    "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all", "alltoall": "all-to-all",
    "broadcast": "broadcast", "allgather": "all-gather", "shard_dim_alltoall": "all-to-all",
}
COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d", "_dtensor")
# DTensor's sharding propagation methods that run operators on stand-ins of
# the global shapes (paused: no device does that work)
PROPAGATION = ("_propagate_tensor_meta_non_cached", "propagate_op_sharding_non_cached")


class OpStats(NamedTuple):
    flops: float
    bytes_accessed: float
    collective_bytes: float
    collective_bytes_by_kind: Dict[str, float]
    collective_count: Dict[str, int]
    argument_bytes: int
    output_bytes: int
    peak_bytes: int
    ops: int
    groups: List[Tuple[str, List[int], int]]  # (kind, ranks, operand bytes) a collective


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    return []


def _local(t: torch.Tensor) -> torch.Tensor:
    return getattr(t, "_local_tensor", t)


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


def local_bytes(tree) -> int:
    """The local bytes of every tensor in ``tree`` (DTensors by their shards),
    each storage once."""
    seen, total = set(), 0
    for t in _leaves(tree):
        s = _storage(_local(t))
        if s is not None and id(s) not in seen:
            seen.add(id(s))
            total += s.nbytes()
    return total


def _kind(func) -> str:
    name = func._schema.name.split("::")[-1]
    for key, kind in KINDS.items():
        if name.startswith(key):
            return kind
    return name


def _group_ranks(args) -> List[int]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, str):
            try:
                return dist.get_process_group_ranks(_resolve_process_group(a))
            except (ValueError, RuntimeError, KeyError):
                continue
        if isinstance(a, dist.ProcessGroup):
            return dist.get_process_group_ranks(a)
    return []


class Tally(TorchDispatchMode):
    """The dispatch mode behind :func:`analyze` (usable alone: enter it, run,
    read :meth:`stats`)."""

    def __init__(self, argument_bytes: int = 0):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_bytes: Dict[str, float] = {}
        self.coll_count: Dict[str, int] = {}
        self.groups: List[Tuple[str, List[int], int]] = []
        self.ops = 0
        self.argument_bytes = argument_bytes
        self.live = argument_bytes
        self.peak = argument_bytes
        self.tracked = set()
        self.paused = 0

    def hold(self, tree) -> None:
        """Mark the storages of ``tree`` (the step's arguments, already in
        ``argument_bytes``) as tracked: an in-place result on them is not new."""
        for t in _leaves(tree):
            s = _storage(_local(t))
            if s is not None and id(s) not in self.tracked:
                self.tracked.add(id(s))
                weakref.finalize(s, self._free, id(s), s.nbytes())

    def _free(self, key, nbytes):
        self.tracked.discard(key)
        self.live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        s = _storage(t)
        if s is None or id(s) in self.tracked:
            return
        key, nbytes = id(s), s.nbytes()
        self.tracked.add(key)
        weakref.finalize(s, self._free, key, nbytes)
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs its local operators, seen below
        out = func(*args, **kwargs)
        if self.paused or any(issubclass(t, FakeTensor) for t in types):
            return out  # sharding propagation on global shapes: no device work
        tensors_in = _leaves(list(args) + list(kwargs.values()))
        tensors_out = _leaves(out)
        name = func._schema.name
        self.ops += 1
        if func.namespace in COLLECTIVE_NAMESPACES:
            kind = _kind(func)
            if kind in KINDS.values():
                nbytes = sum(t.numel() * t.element_size() for t in tensors_in)
                self.coll_bytes[kind] = self.coll_bytes.get(kind, 0.0) + nbytes
                self.coll_count[kind] = self.coll_count.get(kind, 0) + 1
                self.groups.append((kind, _group_ranks(list(args) + list(kwargs.values())),
                                    nbytes))
        else:
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            if not func.is_view and not name.split("::")[-1].startswith("empty"):
                self.bytes += sum(t.numel() * t.element_size() for t in tensors_in + tensors_out)
        if not func.is_view:
            inputs = {id(s) for s in map(_storage, tensors_in) if s is not None}
            for t in tensors_out:
                s = _storage(t)
                if s is not None and id(s) not in inputs:
                    self._track(t)
        return out

    def __enter__(self):
        """Also pause the tally inside DTensor's uncached sharding
        propagation, which runs operators on global-shape meta stand-ins.
        Raises when this torch lacks one of those methods: the tally would
        count the stand-ins' work as the device's."""
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        missing = [n for n in PROPAGATION if not hasattr(ShardingPropagator, n)]
        if missing:
            raise RuntimeError(
                f"torch {torch.__version__}'s ShardingPropagator has no {', '.join(missing)}: "
                "op_stats cannot tell DTensor's global-shape propagation from a rank's work")
        self._patched = []
        for name in PROPAGATION:
            orig = getattr(ShardingPropagator, name)

            def paused(prop, *a, _orig=orig, **k):
                self.paused += 1
                try:
                    return _orig(prop, *a, **k)
                finally:
                    self.paused -= 1

            setattr(ShardingPropagator, name, paused)
            self._patched.append((name, orig))
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        for name, orig in self._patched:
            setattr(ShardingPropagator, name, orig)
        return super().__exit__(*exc)

    def stats(self, output_bytes: int = 0, meta_work=(0.0, 0.0)) -> OpStats:
        return OpStats(
            flops=self.flops + meta_work[0], bytes_accessed=self.bytes + meta_work[1],
            collective_bytes=sum(self.coll_bytes.values()),
            collective_bytes_by_kind=dict(self.coll_bytes),
            collective_count=dict(self.coll_count), argument_bytes=self.argument_bytes,
            output_bytes=output_bytes, peak_bytes=self.peak, ops=self.ops,
            groups=list(self.groups))


def analyze(fn: Callable, *args: Any) -> Tuple[Any, OpStats]:
    """Run ``fn(*args)`` under the tally: ``(its result, OpStats)``."""
    from repro_torch.kernels.flash_attention.ops import META_WORK

    before = (META_WORK["flops"], META_WORK["bytes"])
    tally = Tally(local_bytes(args))
    tally.hold(args)
    with tally:
        out = fn(*args)
    work = (META_WORK["flops"] - before[0], META_WORK["bytes"] - before[1])
    return out, tally.stats(local_bytes(out), work)
