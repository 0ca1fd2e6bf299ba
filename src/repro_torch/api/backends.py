"""The chunk-emitting execution backend of the sampling stage, and its names.

The port of ``repro/api/backends.py`` for one device. :class:`BackendId` is
the one constructor of the ``SampleResult.backend`` strings; the one-shot
batch path keeps ``"batched[cuda]"`` / ``"batched[cpu]"``, and the chunk
modes add a tag after the device: ``"batched[cuda,chunked]"`` (the
subscriber-driven chunk loop), ``"batched[cuda,fused]"`` (all T draws with
no host synchronisation, folded in chunks afterwards) and ``"batched[cuda,resumable]"`` (checkpointed).

:class:`ChunkBackend` is what the drivers (:mod:`repro_torch.api.streaming`,
:mod:`repro_torch.api.matrix`) program against; :class:`BatchedChunkBackend`,
the M chains batched on one device, is its implementation. It drives the
chains in chunks: ``setup`` (init, warmup, burn-in), ``next_chunk`` (the
next n draws), ``localize`` (a no-op on one device) and ``run_fused`` (setup
and one chunk of T, with no host synchronisation). Every method draws from
the caller's generator in the order of the one-shot driver, so any chunking
gives the same draws bitwise. The backend keeps its chain loops
(:class:`~repro_torch.samplers.base.TransitionLoop`): the warmup's and the
collection's, which burn-in shares, so on the card each is captured once and
every later transition, chunk and setup replays it. A kept draw is the shared
θ (``ShardKernel.extract``: a Gibbs state's latents stay in the chain state,
out of the draws).

:func:`get_chunk_backend` caches backends by the reference's statics (plus
the device and the shard shapes): a backend it makes owns copies of its
inputs and records what its kernels derive from them, so :meth:`~BatchedChunkBackend.load`
swaps in another run's data without building, or capturing, a loop again.
The reference's ``MeshChunkBackend`` (chains split over devices) is ROADMAP
Queue 1 item 9.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Protocol, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.api.sampling import ShardKernel, make_shard_kernel, shard_chunk
from repro_torch.models.bayes import BayesModel
from repro_torch.samplers.adaptation import WarmupLoop
from repro_torch.samplers.base import MCMCKernel, TransitionLoop

# execution modes a chunk backend can report (BackendId tags)
CHUNKED = "chunked"
FUSED = "fused"
RESUMABLE = "resumable"
_MODES = (None, CHUNKED, FUSED, RESUMABLE)


class BackendId:
    """The one constructor for sampling-backend identifier strings."""

    @staticmethod
    def batched(device_type: str, mode: Optional[str] = None) -> str:
        """``"batched[<device>]"`` or ``"batched[<device>,<mode>]"``."""
        if mode not in _MODES:
            raise ValueError(
                f"unknown backend mode {mode!r} (choices: {', '.join(map(repr, _MODES))})"
            )
        return f"batched[{device_type}]" if mode is None else f"batched[{device_type},{mode}]"


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
        """An emitted chunk on the default device, before subscribers see it."""

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

    def run_fused(
        self, gen: torch.Generator, num_samples: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The whole run with no host synchronisation: setup and one chunk
        of T, the one-shot driver's path. ``(theta (M, T, d), accept_sum (M,))``."""
        state, eps = self.setup(gen)
        _, theta, accept_sum = self.next_chunk(gen, eps, state, num_samples)
        return theta, accept_sum


def _freeze_options(options) -> Tuple:
    items = options.items() if hasattr(options, "items") else options
    return tuple(sorted((str(k), v) for k, v in items))


# Per-process backend cache, keyed by the reference's statics plus the
# device and the shard shapes: repeated streams of one configuration build,
# and on the card capture, their chain loops once.
_BACKEND_CACHE: Dict[Tuple, BatchedChunkBackend] = {}


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
) -> BatchedChunkBackend:
    """Resolve (and cache) the chunk backend for one sampling configuration,
    loaded with ``shards`` and ``counts``.

    The cache key is ``repro``'s (model, sampler, M, warmup, burn-in, step,
    SGLD batch, sampler options, counts correction) plus the device and the
    shapes of ``shards`` and ``counts``; a hit loads this call's data into
    the cached backend's own tensors. A ``mesh_shape`` whose data axis is
    larger than 1 asks for chains split over devices: ROADMAP Queue 1 item 9.
    """
    if mesh_shape is not None and int(mesh_shape[0]) > 1:
        raise NotImplementedError(
            f"mesh_shape={tuple(mesh_shape)} splits chains over devices: the port's mesh "
            "backend is ROADMAP Queue 1 item 9"
        )
    base_key = (
        model.name, sampler, num_shards, warmup, burn_in, float(step_size),
        sgld_batch, _freeze_options(sampler_options), use_counts,
    )
    cache_key = base_key + (
        "batched", str(counts.device),
        tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(shards.items())),
        tuple(counts.shape),
    )
    backend = _BACKEND_CACHE.get(cache_key)
    if backend is None:
        sk = make_shard_kernel(model, num_shards, sampler, sgld_batch=sgld_batch,
                               use_counts=use_counts, sampler_options=sampler_options)
        backend = BatchedChunkBackend(sk, shards, counts, burn_in=burn_in, warmup=warmup,
                                      step_size=step_size, owned=True)
        _BACKEND_CACHE[cache_key] = backend
    else:
        backend.load(shards, counts)
    return backend
