"""The chunk-emitting execution backend of the sampling stage, and its names.

The port of ``repro/api/backends.py``. :class:`BackendId` is the one
constructor of the ``SampleResult.backend`` strings; the one-shot batch path
keeps ``"batched[cuda]"`` / ``"batched[cpu]"``, and the chunk modes add a tag
after the device: ``"batched[cuda,chunked]"`` (the subscriber-driven chunk
loop), ``"batched[cuda,fused]"`` (all T draws with no host synchronisation,
folded in chunks afterwards) and ``"batched[cuda,resumable]"``
(checkpointed). Chains split over devices read ``"mesh[cuda](2 devices)"``
(and ``"mesh[cuda,chunked](2 devices)"`` ...), a sweep's cells dealt over
devices ``"mesh_fanout[cuda](2 devices)"`` and the multi-process launch
``"torch.distributed(2 processes)"``.

:class:`ChunkBackend` is what the drivers (:mod:`repro_torch.api.streaming`,
:mod:`repro_torch.api.matrix`) program against; :class:`BatchedChunkBackend`,
the M chains batched on one device, is its implementation. It drives the
chains in chunks: ``setup`` (init, warmup, burn-in), ``next_chunk`` (the
next n draws), ``localize`` (a no-op on one device) and ``run_fused`` (setup
and one chunk of T, with no host synchronisation). Every method draws from
the caller's generator in the order of the one-shot driver, so any chunking
gives the same draws bitwise. :class:`MeshChunkBackend` splits the chains
into groups, one a device, and draws what the batched backend draws. The
batched backend keeps its chain loops
(:class:`~repro_torch.samplers.base.TransitionLoop`): the warmup's and the
collection's, which burn-in shares, so on the card each is captured once and
every later transition, chunk and setup replays it. A kept draw is the shared
θ (``ShardKernel.extract``: a Gibbs state's latents stay in the chain state,
out of the draws).

:func:`get_chunk_backend` caches backends by the reference's statics (plus
the device and the shard shapes): a backend it makes owns copies of its
inputs and records what its kernels derive from them, so :meth:`~BatchedChunkBackend.load`
swaps in another run's data without building, or capturing, a loop again.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Protocol, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.api.sampling import (
    ShardKernel,
    chain_rows,
    chain_slice_kernel,
    make_shard_kernel,
    shard_chunk,
)
from repro_torch.distributed.epmcmc import ChainGroup
from repro_torch.models.bayes import BayesModel
from repro_torch.samplers.adaptation import WarmupLoop
from repro_torch.samplers.base import MCMCKernel, TransitionLoop, tree_map

# execution modes a chunk backend can report (BackendId tags)
CHUNKED = "chunked"
FUSED = "fused"
RESUMABLE = "resumable"
_MODES = (None, CHUNKED, FUSED, RESUMABLE)


class BackendId:
    """The one constructor for sampling-backend identifier strings."""

    @staticmethod
    def _tag(device_type: str, mode: Optional[str]) -> str:
        if mode not in _MODES:
            raise ValueError(
                f"unknown backend mode {mode!r} (choices: {', '.join(map(repr, _MODES))})"
            )
        return device_type if mode is None else f"{device_type},{mode}"

    @staticmethod
    def batched(device_type: str, mode: Optional[str] = None) -> str:
        """``"batched[<device>]"`` or ``"batched[<device>,<mode>]"``."""
        return f"batched[{BackendId._tag(device_type, mode)}]"

    @staticmethod
    def mesh(device_type: str, ndata: int, mode: Optional[str] = None) -> str:
        """``"mesh[<device>](<ndata> devices)"`` or ``"mesh[<device>,<mode>](...)"``:
        the chains split into ``ndata`` groups, one a device (a device may
        be named twice)."""
        return f"mesh[{BackendId._tag(device_type, mode)}]({int(ndata)} devices)"

    @staticmethod
    def mesh_fanout(device_type: str, ndev: int) -> str:
        """``run_matrix`` dealing whole cells out over ``ndev`` devices."""
        return f"mesh_fanout[{device_type}]({int(ndev)} devices)"

    @staticmethod
    def distributed(num_processes: int) -> str:
        """The multi-process launch (:mod:`repro_torch.api.launch`)."""
        return f"torch.distributed({int(num_processes)} processes)"


class ChunkBackend(Protocol):
    """What every chunk-emitting execution backend provides: the surface the
    chunk driver, the checkpoint subscriber, ``Pipeline.stream_combine`` and
    ``run_matrix`` program against."""

    kind: str

    def backend_id(self, mode: Optional[str] = None) -> str:
        """This backend's :class:`BackendId` string for ``mode``."""

    def setup(self, gen: torch.Generator) -> Tuple[Any, torch.Tensor]:
        """Init, warmup and burn-in: ``(state, eps (M, 1))``."""

    def next_chunk(self, gen: torch.Generator, eps: torch.Tensor, state: Any,
                   n: int) -> Tuple[Any, torch.Tensor, torch.Tensor]:
        """``(state, theta (M, n, d), accepted count (M,))``."""

    def localize(self, tree: Any) -> Any:
        """An emitted chunk (or a carry) on the caller's device, in chain
        order, before subscribers or a checkpoint see it."""

    def put_carry(self, carry: Dict[str, Any]) -> Dict[str, Any]:
        """A restored (full-width) carry laid out as the backend holds it."""

    @property
    def collectives_checked(self) -> Optional[int]:
        """Operators the chain-group check watched (None: no check)."""

    def run_fused(self, gen: torch.Generator,
                  num_samples: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The whole run with no host synchronisation: ``(theta, accept_sum)``."""


class _Made(TorchDispatchMode):
    """Every value an operator returns while the mode is on, in order."""

    def __init__(self):
        super().__init__()
        self.made: List[Any] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.made.extend(out if isinstance(out, (tuple, list)) else (out,))
        return out


class _RecordedBuild:
    """One kernel build on a backend's own inputs, with every value the build
    derived from them (prepared data, masks, factors: what the kernel and so
    its captured graph read). :meth:`refresh` builds again on the inputs'
    new contents and copies the new values into the first build's tensors,
    so the first kernel, and its loop, go on with the new data."""

    def __init__(self, build: Callable[[], MCMCKernel]):
        self.build = build
        with torch.no_grad(), _Made() as rec:
            self.kernel = build()
        self.made = rec.made

    def refresh(self) -> None:
        with torch.no_grad():
            with _Made() as rec:
                self.build()
            if len(rec.made) != len(self.made):
                raise RuntimeError("a kernel build took another path on new data: "
                                   f"{len(rec.made)} values against {len(self.made)}")
            for old, new in zip(self.made, rec.made):
                if isinstance(old, torch.Tensor) != isinstance(new, torch.Tensor):
                    raise RuntimeError("a kernel build took another path on new data")
                if not isinstance(old, torch.Tensor):
                    if old != new:  # a value of the data read on the host at build
                        raise ValueError(f"the kernel's build reads {old!r} from the data on "
                                         f"the host, and the new data gives {new!r}: its "
                                         "kernel cannot be reused")
                elif old is not new and old._base is None:  # views follow their base
                    if old.shape != new.shape or old.dtype != new.dtype:
                        raise RuntimeError(f"a kernel build made {tuple(new.shape)} "
                                           f"{new.dtype} where it made {tuple(old.shape)} "
                                           f"{old.dtype}")
                    old.copy_(new)


class BatchedChunkBackend:
    """M chains batched on one device, advanced in chunks of any size.

    ``owned``: the backend copies ``shards`` and ``counts`` and records its
    kernels' builds, so that :meth:`load` can put another run's data (of the
    same shapes) under the same kernels and loops.
    """

    kind = "batched"

    def __init__(
        self,
        sk: ShardKernel,
        shards,
        counts: torch.Tensor,
        *,
        burn_in: int,
        warmup: int,
        step_size: float,
        owned: bool = False,
    ):
        self.sk = sk
        self.owned = owned
        self.shards = {k: v.clone() for k, v in shards.items()} if owned else shards
        self.counts = counts.clone() if owned else counts
        self.n_chains = int(counts.shape[0])
        self.device = counts.device
        self.burn_in, self.warmup, self.step_size = burn_in, warmup, step_size
        # adapted kernels run at the per-chain steps in the carry; fixed-step
        # ones at the spec's float, as the one-shot driver does
        self.adapts = sk.adaptive and warmup > 0
        self._builds: List[_RecordedBuild] = []
        self._warmup: Optional[WarmupLoop] = None  # built by the first setup
        self._kernel: Optional[MCMCKernel] = None  # the collection kernel
        self._loop: Optional[TransitionLoop] = None  # its loop, which burn-in shares
        self._eps: Optional[torch.Tensor] = None  # the collection kernel's step sizes

    def backend_id(self, mode: Optional[str] = None) -> str:
        return BackendId.batched(self.device.type, mode)

    def _build(self, step_size) -> MCMCKernel:
        if not self.owned:
            return self.sk.build(self.shards, self.counts, step_size)
        rec = _RecordedBuild(lambda: self.sk.build(self.shards, self.counts, step_size))
        self._builds.append(rec)
        return rec.kernel

    def load(self, shards, counts: torch.Tensor, step_size: Optional[float] = None) -> None:
        """Put another run's shards and counts (and, for an adapted kernel, its
        initial step size) under this backend's kernels: the next ``setup``
        runs that run's chains in the loops already built."""
        if not self.owned:
            raise RuntimeError("load() needs a backend that owns its inputs (owned=True)")
        if step_size is not None and step_size != self.step_size:
            if not self.adapts:
                raise ValueError("a fixed-step kernel reads its step as a number: build a "
                                 "backend for each step size")
            self.step_size = float(step_size)
        if set(shards) != set(self.shards):
            raise ValueError(f"shards hold {sorted(shards)}, the backend {sorted(self.shards)}")
        with torch.no_grad():
            for k, v in shards.items():
                self.shards[k].copy_(v)
            self.counts.copy_(counts)
        for rec in self._builds:
            rec.refresh()

    def setup(self, gen: torch.Generator) -> Tuple[Any, torch.Tensor]:
        """Init, warmup and burn-in: ``(state, eps (M, 1))``, drawing from
        ``gen`` as :func:`~repro_torch.api.sampling.setup_shard_chains` does."""
        pos = self.sk.init_position(gen, self.shards)
        if self.adapts:
            if self._warmup is None:
                self._warmup = WarmupLoop(self._build, tuple(pos.shape[:-1]), self.device,
                                          target_accept=self.sk.target_accept)
            pos, eps = self._warmup.run(gen, pos, self.warmup, self.step_size)
            burn = self.burn_in
        else:
            eps = torch.full((self.n_chains, 1), self.step_size, dtype=torch.float32,
                             device=self.device)
            burn = self.burn_in + (0 if self.sk.adaptive else self.warmup)
        kernel = self.kernel(eps)
        state = kernel.init(pos)
        if burn > 0:
            loop = self.loop(eps, state)
            loop.load(state)
            for _ in range(burn):
                loop.step(gen)
            state = loop.snapshot()
        if kernel.check is not None:
            kernel.check(state)
        return state, eps

    def kernel(self, eps: torch.Tensor) -> MCMCKernel:
        """The collection kernel, built at the first call and kept: later
        calls copy ``eps`` into its step sizes."""
        if self._kernel is None:
            self._eps = eps.clone() if self.adapts else None
            self._kernel = self._build(self._eps if self.adapts else self.step_size)
        elif self.adapts:
            self._eps.copy_(eps)
        return self._kernel

    def loop(self, eps: torch.Tensor, state: Any) -> TransitionLoop:
        """The collection loop (burn-in's too), built at its first use and kept."""
        kernel = self.kernel(eps)
        if self._loop is None:
            self._loop = TransitionLoop(kernel, state)
        return self._loop

    def loops(self) -> List[TransitionLoop]:
        """The chain loops built so far (on the card, each one captured graph
        once it has run two transitions)."""
        warm = [self._warmup.loop] if self._warmup is not None and self._warmup.loop else []
        return warm + ([self._loop] if self._loop is not None else [])

    def next_chunk(
        self, gen: torch.Generator, eps: torch.Tensor, state: Any, n: int
    ) -> Tuple[Any, torch.Tensor, torch.Tensor]:
        """``(state, theta (M, n, d), accepted count (M,) float32)``."""
        state, theta, accepted = shard_chunk(self.loop(eps, state), gen, state, n,
                                             self.sk.extract)
        return state, theta, accepted.to(torch.float32).sum(dim=-1)

    def localize(self, tree):
        """Chunks already live on the one device."""
        return tree

    def put_carry(self, carry):
        """A restored carry is already on the one device."""
        return carry

    @property
    def collectives_checked(self) -> Optional[int]:
        return None  # one device: no chain groups to check

    def run_fused(
        self, gen: torch.Generator, num_samples: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The whole run with no host synchronisation: setup and one chunk
        of T, the one-shot driver's path. ``(theta (M, T, d), accept_sum (M,))``."""
        state, eps = self.setup(gen)
        _, theta, accept_sum = self.next_chunk(gen, eps, state, num_samples)
        return theta, accept_sum


def slice_backend(sk: ShardKernel, model: BayesModel, shards, counts: torch.Tensor, lo: int,
                  hi: int, device: Optional[torch.device] = None,
                  **options) -> BatchedChunkBackend:
    """The chains ``[lo, hi)`` of a run of ``counts.shape[0]`` as one
    :class:`BatchedChunkBackend` on ``device`` (default: the data's), drawing
    what the whole run draws for them
    (:func:`~repro_torch.api.sampling.chain_slice_kernel`): a mesh's chain
    group, or a launch's rank. ``options`` are the backend's."""
    device = counts.device if device is None else device
    rows = {k: v.to(device) for k, v in chain_rows(model, shards, lo, hi).items()}
    return BatchedChunkBackend(chain_slice_kernel(sk, model, lo, hi, int(counts.shape[0])),
                               rows, counts[lo:hi].to(device), **options)


class Grouped(tuple):
    """The values of a :class:`MeshChunkBackend`'s chain groups, in group
    order (their states, step sizes, emitted chunks): what
    :meth:`MeshChunkBackend.localize` gathers into one full-width value."""


def _gather(parts, device: torch.device) -> torch.Tensor:
    """The groups' rows of one leaf, concatenated in group order on
    ``device``; a 0-d leaf (a count: Gibbs' unresolved gamma lanes) summed."""
    if parts[0].dim() == 0:
        return sum(p.to(device) for p in parts[1:]) + parts[0].to(device)
    return torch.cat([p.to(device) for p in parts])


def resolve_mesh_devices(
    mesh_shape: Sequence[int],
    devices: Optional[Sequence] = None,
    primary: "torch.device | str" = "cuda",
    num_chains: Optional[int] = None,
) -> Tuple[torch.device, ...]:
    """The device of each chain group of ``mesh_shape = (ndata[, nmodel])``.

    The mesh is ndata × nmodel devices, row-major over (data, model), as the
    reference's ``jax.make_mesh``: chain group g owns the model row of
    devices g·nmodel … g·nmodel + nmodel − 1. A Bayes model's θ has nothing
    to shard, so a group replicates over its row, as the reference's chains
    do (``P("data")``, replicated over ``model``): the group runs on its
    row's first device, and a replica would draw the same numbers, so the
    results are the (ndata,) mesh's bit for bit.

    ``devices`` defaults to one CUDA device a mesh position, and the call
    raises with the visible count when fewer exist. An explicit list (all
    ndata × nmodel of them) may name one device more than once (the
    counterpart of ``repro``'s forced host device count); it is never
    inferred. Every device is of ``primary``'s type: the groups replay one
    generator's draws.
    """
    shape = tuple(int(x) for x in mesh_shape)
    if len(shape) not in (1, 2) or min(shape) < 1:
        raise ValueError(f"mesh_shape must be (ndata[, nmodel]) with positive sizes, got {shape}")
    ndata, nmodel = shape[0], (shape[1] if len(shape) == 2 else 1)
    need = ndata * nmodel
    if num_chains is not None and num_chains % ndata:
        raise ValueError(f"mesh data axis {ndata} must divide M={num_chains}")
    primary = torch.device(primary)
    visible = torch.cuda.device_count() if primary.type == "cuda" else 0
    if devices is None:
        if primary.type != "cuda":
            raise ValueError(
                f"mesh_shape={shape} needs {need} devices: on the {primary.type} name them "
                f"(e.g. devices={(primary.type,) * need})")
        if visible < need:
            raise ValueError(
                f"mesh_shape={shape} needs {need} CUDA devices and {visible} visible; pass "
                "devices= to place several chain groups on one device")
        return tuple(torch.device("cuda", i * nmodel) for i in range(ndata))
    devs = tuple(torch.device(d) for d in devices)
    if len(devs) != need:
        raise ValueError(f"mesh_shape={shape} has {need} devices (chain groups × model axis) "
                         f"and devices= names {len(devs)}")
    for d in devs:
        if d.type != primary.type:
            raise ValueError(f"chain group device {d} is not a {primary.type} device like the "
                             "run's: the groups replay one generator's draws")
    if primary.type == "cuda":
        devs = tuple(torch.device("cuda", torch.cuda.current_device() if d.index is None
                                  else d.index) for d in devs)
        for d in devs:
            if d.index >= visible:
                raise ValueError(f"chain group device {d}: {visible} CUDA devices visible")
    return devs[::nmodel]  # each group's model row, by its first device


# transitions of the eager chunk the chain-group check watches
CHECK_TRANSITIONS = 2


def probe_group(backend: BatchedChunkBackend, state: Any, eps: torch.Tensor) -> ChainGroup:
    """``backend``'s chains as the chain-group check sees them: its inputs
    (shards, counts, what its kernel builds derived), its carry and loop
    states, and one eager chunk of :data:`CHECK_TRANSITIONS` collection
    transitions on a copy of ``state`` from a generator of its own (the run's
    generator and states are left alone)."""
    kernel = backend.kernel(eps)
    owned = [backend.shards, backend.counts, state, eps,
             [rec.made for rec in backend._builds], [loop.state for loop in backend.loops()]]

    def run():
        gen = torch.Generator(device=backend.device).manual_seed(0)
        st = tree_map(torch.clone, state)
        for _ in range(CHECK_TRANSITIONS):
            st, _ = kernel.step(gen, st, *kernel.draw(gen, st.position))
        backend.sk.extract(st.position)

    return ChainGroup(backend.device, owned, run)


class GroupStreams:
    """Where chain groups (a mesh's, or a fan's slots) run: group g on
    ``devices[g]``, on the card on a CUDA stream of its own.

    :meth:`run` queues every group's work before the caller waits for any:
    each stream first waits once for the work queued so far on the caller's
    device and its own, and the caller's streams wait for every group after
    the last is queued. So groups on two cards, or on two streams of one,
    overlap on the device as far as the host queues them ahead.
    """

    def __init__(self, devices: Sequence[torch.device], primary: torch.device):
        self.devices = tuple(torch.device(d) for d in devices)
        self.primary = torch.device(primary)
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
                        for d in self.devices]

    def run(self, fns: Sequence[Callable[[], Any]],
            groups: Optional[Sequence[int]] = None) -> list:
        """``fns[i]()`` on the stream of group ``groups[i]`` (default: group
        i), all queued before any is waited for; their results."""
        groups = range(len(fns)) if groups is None else groups
        streams = [(self.streams[g], {self.primary, self.devices[g]}) for g in groups]
        for stream, devs in streams:
            if stream is not None:
                for d in devs:
                    stream.wait_stream(torch.cuda.current_stream(d))
        out = []
        for (stream, _), fn in zip(streams, fns):
            if stream is None:
                out.append(fn())
                continue
            with torch.cuda.stream(stream):
                out.append(fn())
        for stream, devs in streams:
            if stream is not None:
                for d in devs:
                    torch.cuda.current_stream(d).wait_stream(stream)
        return out

    def check(self, backends: Sequence[BatchedChunkBackend], states, eps) -> int:
        """The chain-group check on one eager chunk of every group
        (:func:`probe_group`), each on its stream; the operators it watched."""
        from repro_torch.distributed.epmcmc import assert_no_cross_chain_collectives

        probes = [probe_group(b, st, e) for b, st, e in zip(backends, states, eps)]
        return assert_no_cross_chain_collectives([
            p._replace(run=lambda g=g, run=p.run: self.run([run], [g])[0])
            for g, p in enumerate(probes)])


class MeshChunkBackend:
    """M chains split into ``len(devices)`` groups of M/ndata, group g on
    ``devices[g]`` with its shards, each driven by its own
    :class:`BatchedChunkBackend` (its own chain loops: on the card its own
    captured graphs, replayed on a CUDA stream of the group's).

    The draws are the batched backend's, bit for bit: every group replays
    the caller's generator at the full width M and keeps its rows
    (:func:`~repro_torch.api.sampling.chain_slice_kernel`), and the caller's
    generator ends where the batched run's would, so a checkpoint's one
    ``rng`` leaf still describes the run. States, step sizes and emitted
    chunks are :class:`Grouped`; :meth:`localize` gathers them onto the
    caller's device in chain order (every subscriber then runs unchanged)
    and :meth:`put_carry` splits a restored carry over the groups. The
    first :meth:`setup` runs
    :func:`~repro_torch.distributed.epmcmc.assert_no_cross_chain_collectives`
    on one eager chunk of every group (``collectives_checked``).

    The groups' work is queued by one host thread, every group's before the
    caller waits for any (:class:`GroupStreams`).
    """

    kind = "mesh"

    def __init__(
        self,
        sk: ShardKernel,
        model: BayesModel,
        shards,
        counts: torch.Tensor,
        *,
        devices: Sequence[torch.device],
        burn_in: int,
        warmup: int,
        step_size: float,
    ):
        M, ndata = int(counts.shape[0]), len(devices)
        if ndata < 2 or M % ndata:
            raise ValueError(f"a mesh splits M={M} chains into 2 or more equal groups, "
                             f"not {ndata}")
        self.model = model
        self.device = counts.device  # where chunks land
        self.lanes = GroupStreams(devices, self.device)
        self.devices = self.lanes.devices
        self.n_chains = M
        self.step_size = step_size
        self.bounds = [(g * M // ndata, (g + 1) * M // ndata) for g in range(ndata)]
        self.groups: List[BatchedChunkBackend] = [
            slice_backend(sk, model, shards, counts, lo, hi, dev, burn_in=burn_in,
                          warmup=warmup, step_size=step_size, owned=True)
            for (lo, hi), dev in zip(self.bounds, self.devices)]
        self.gens = [torch.Generator(device=d) for d in self.devices]
        self.collectives_checked: Optional[int] = None

    def backend_id(self, mode: Optional[str] = None) -> str:
        return BackendId.mesh(self.device.type, len(self.groups), mode)

    def _each(self, gen: torch.Generator, fn: Callable[..., Any]) -> list:
        """``fn(g, group, generator)`` for every group, each generator set to
        ``gen``'s state, all queued on their streams before any is waited
        for; ``gen`` then takes the state they end in, which is the same for
        all (each draws the full width)."""
        start = gen.get_state()
        for gg in self.gens:
            gg.set_state(start)
        out = self.lanes.run([lambda g=g, b=b, gg=gg: fn(g, b, gg)
                              for g, (b, gg) in enumerate(zip(self.groups, self.gens))])
        ends = [gg.get_state() for gg in self.gens]
        if any(not torch.equal(e, ends[0]) for e in ends[1:]):
            raise RuntimeError("chain groups drew different amounts of randomness")
        gen.set_state(ends[0])
        return out

    def setup(self, gen: torch.Generator) -> Tuple[Grouped, Grouped]:
        """Every group's init, warmup and burn-in: ``(states, eps)``, then,
        the first time, the chain-group check."""
        res = self._each(gen, lambda g, b, gg: b.setup(gg))
        states, eps = Grouped(r[0] for r in res), Grouped(r[1] for r in res)
        if self.collectives_checked is None:
            self.collectives_checked = self.check_groups(states, eps)
        return states, eps

    def check_groups(self, states: Grouped, eps: Grouped) -> int:
        """The chain-group check on one eager chunk of every group; returns
        the operators it watched."""
        return self.lanes.check(self.groups, states, eps)

    def next_chunk(self, gen: torch.Generator, eps: Grouped, state: Grouped,
                   n: int) -> Tuple[Grouped, Grouped, Grouped]:
        """``(states, theta, accepted count)``, each :class:`Grouped`."""
        res = self._each(gen, lambda g, b, gg: b.next_chunk(gg, eps[g], state[g], n))
        return tuple(Grouped(r[i] for r in res) for i in range(3))

    def localize(self, tree):
        """Grouped values gathered onto the caller's device in chain order
        (into a dict's values too); anything else as it is."""
        if isinstance(tree, Grouped):
            return tree_map(lambda *parts: _gather(parts, self.device), *tree)
        if isinstance(tree, dict):
            return {k: self.localize(v) for k, v in tree.items()}
        return tree

    def split(self, tree) -> Grouped:
        """A full-width tree (a restored state) as the groups' rows, each on
        its group's device; a 0-d leaf (a count) goes to group 0."""
        def part(g, lo, hi, dev):
            return tree_map(lambda x: (x[lo:hi] if x.dim() else
                                       (x if g == 0 else torch.zeros_like(x))).to(dev), tree)

        return Grouped(part(g, lo, hi, dev)
                       for g, ((lo, hi), dev) in enumerate(zip(self.bounds, self.devices)))

    def put_carry(self, carry: Dict[str, Any]) -> Dict[str, Any]:
        """A restored carry's chain state and step sizes split over the groups."""
        return {**carry, "state": self.split(carry["state"]), "eps": self.split(carry["eps"])}

    def run_fused(self, gen: torch.Generator,
                  num_samples: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Setup and one chunk of T on every group, gathered:
        ``(theta (M, T, d), accept_sum (M,))``."""
        state, eps = self.setup(gen)
        _, theta, accept_sum = self.next_chunk(gen, eps, state, num_samples)
        return self.localize(theta), self.localize(accept_sum)

    def load(self, shards, counts: torch.Tensor, step_size: Optional[float] = None) -> None:
        """Another run's data (same shapes) under every group's kernels."""
        for (lo, hi), dev, b in zip(self.bounds, self.devices, self.groups):
            rows = {k: v.to(dev) for k, v in chain_rows(self.model, shards, lo, hi).items()}
            b.load(rows, counts[lo:hi].to(dev), step_size)

    def loops(self) -> List[TransitionLoop]:
        return [loop for b in self.groups for loop in b.loops()]


def _freeze_options(options) -> Tuple:
    items = options.items() if hasattr(options, "items") else options
    return tuple(sorted((str(k), v) for k, v in items))


# Per-process backend cache, keyed by the reference's statics plus the
# device and the shard shapes: repeated streams of one configuration build,
# and on the card capture, their chain loops once.
_BACKEND_CACHE: Dict[Tuple, "BatchedChunkBackend | MeshChunkBackend"] = {}


def get_chunk_backend(
    model: BayesModel,
    num_shards: int,
    sampler: str,
    *,
    warmup: int = 200,
    burn_in: int = 0,
    step_size: float = 0.1,
    sgld_batch: int = 256,
    sampler_options=(),
    use_counts: bool = True,
    shards,
    counts: torch.Tensor,
    mesh_shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence] = None,
) -> "BatchedChunkBackend | MeshChunkBackend":
    """Resolve (and cache) the chunk backend for one sampling configuration,
    loaded with ``shards`` and ``counts``.

    The cache key is ``repro``'s (model, sampler, M, warmup, burn-in, step,
    SGLD batch, sampler options, counts correction) plus the device and the
    shapes of ``shards`` and ``counts``; a hit loads this call's data into
    the cached backend's own tensors. A ``mesh_shape`` whose data axis is
    larger than 1 selects :class:`MeshChunkBackend` on ``devices``
    (:func:`resolve_mesh_devices`); otherwise the batched backend.
    """
    use_mesh = mesh_shape is not None and int(mesh_shape[0]) > 1
    if devices is not None and not use_mesh:
        raise ValueError("devices= places chain groups: it needs a mesh_shape whose data "
                         "axis is above 1")
    base_key = (
        model.name, sampler, num_shards, warmup, burn_in, float(step_size),
        sgld_batch, _freeze_options(sampler_options), use_counts,
    )
    if use_mesh:
        devs = resolve_mesh_devices(mesh_shape, devices, counts.device, num_shards)
        kind = ("mesh", tuple(str(d) for d in devs))
    else:
        kind = ("batched",)
    cache_key = base_key + kind + (
        str(counts.device),
        tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(shards.items())),
        tuple(counts.shape),
    )
    backend = _BACKEND_CACHE.get(cache_key)
    if backend is None:
        sk = make_shard_kernel(model, num_shards, sampler, sgld_batch=sgld_batch,
                               use_counts=use_counts, sampler_options=sampler_options)
        if use_mesh:
            backend = MeshChunkBackend(sk, model, shards, counts, devices=devs, burn_in=burn_in,
                                       warmup=warmup, step_size=step_size)
        else:
            backend = BatchedChunkBackend(sk, shards, counts, burn_in=burn_in, warmup=warmup,
                                          step_size=step_size, owned=True)
        _BACKEND_CACHE[cache_key] = backend
    else:
        backend.load(shards, counts)
    return backend
