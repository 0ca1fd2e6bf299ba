"""Combiner engine API: result type, registry, streaming faces, shared tensor helpers.

The port of ``repro/core/combiners/api.py``. A combiner is

    combiner(gen, samples, n_draws, *, counts=None, **options) -> CombineResult

with ``samples`` the dense ``(M, T, d)`` subposterior stack, ``counts (M,)``
the valid prefix of each chain, and ``gen`` a :class:`torch.Generator` on the
samples' device. Implementations self-register with :func:`register`;
callers resolve them with :func:`get_combiner` and filter a shared option
dict per signature with :func:`filter_options`.

Streaming (paper §4, combine as draws arrive): every registered name also
resolves to a :class:`StreamingCombiner` through
:func:`get_streaming_combiner`, either a native incremental implementation
(``register(..., streaming=)`` or :func:`register_streaming`) or the exact
buffered fallback (:func:`buffered_streaming`), whose updates then
``finalize`` are bitwise the batch combiner on the gathered stack. The fused
streaming path folds through the :class:`ScanStreamingFace` that
:func:`get_scan_face` resolves. A generator takes the place of the
reference's key in every face.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import bandwidth as bw
from repro_torch.core.gaussian import GaussianMoments
from repro_torch.utils.options import filter_kwargs


class CombineResult(NamedTuple):
    """Output of a combination procedure (``extras``: combiner diagnostics)."""

    samples: torch.Tensor  # (n_draws, d)
    acceptance_rate: torch.Tensor  # IMG acceptance (1.0 for non-MCMC combiners)
    moments: Optional[GaussianMoments] = None
    extras: Optional[Dict[str, torch.Tensor]] = None


class StreamingCombiner(NamedTuple):
    """Uniform incremental combination protocol (paper §4).

    - ``init(M, d, device=None) -> state``: empty accumulator;
    - ``update(state, chunk, chunk_counts=None) -> state``: fold one dense
      ``(M, C, d)`` chunk in; ``chunk_counts (M,)`` marks each machine's valid
      prefix within the chunk (None ⇒ all C);
    - ``finalize(gen, state, n_draws, **options) -> CombineResult``: draw the
      combined estimate; the state is not changed and may be finalized again;
    - ``estimate`` (optional): a cheap mid-stream snapshot with
      ``finalize``'s signature, what the stream's trajectory calls.

    Host-driven: ``update`` may branch on concrete counts.
    """

    init: Callable[..., Any]
    update: Callable[..., Any]
    finalize: Callable[..., CombineResult]
    estimate: Optional[Callable[..., CombineResult]] = None


class ScanStreamingFace(NamedTuple):
    """The face the fused streaming path folds through.

    - ``init(M, d, device=None) -> scan_state`` (``()`` when the draws the
      fused path already holds are the whole state);
    - ``update(scan_state, chunk) -> scan_state``: one dense ``(M, C, d)``
      chunk, no counts (the fused path's chunks are dense);
    - ``to_state(scan_state, theta, counts) -> state``: the host
      :class:`StreamingCombiner` state from the final scan state and the
      gathered ``(M, T, d)`` draws, so the host ``finalize`` runs unchanged;
    - ``estimate`` (optional): ``(gen, scan_state, n_draws, **options) ->
      (n_draws, d)`` trajectory draws at a boundary. ``None`` means the fused
      driver computes the host ``estimate`` on the buffered prefix instead.
    """

    init: Callable[..., Any]
    update: Callable[..., Any]
    to_state: Callable[..., Any]
    estimate: Optional[Callable[..., torch.Tensor]] = None


Combiner = Callable[..., CombineResult]
_REGISTRY: Dict[str, Combiner] = {}
_CANONICAL: Dict[str, Combiner] = {}
_STREAMING: Dict[str, StreamingCombiner] = {}  # native incremental implementations
_SCAN: Dict[str, ScanStreamingFace] = {}  # faces the fused path folds through


def register(
    name: str, *aliases: str, streaming: Optional[StreamingCombiner] = None
) -> Callable[[Combiner], Combiner]:
    """Decorator: add a combiner to the registry under ``name`` (+ aliases);
    ``streaming=`` attaches a native :class:`StreamingCombiner` to them."""

    def deco(fn: Combiner) -> Combiner:
        for key in (name, *aliases):
            if key in _REGISTRY:
                raise ValueError(f"combiner {key!r} already registered")
            _REGISTRY[key] = fn
            if streaming is not None:
                _STREAMING[key] = streaming
        _CANONICAL[name] = fn
        return fn

    return deco


def _aliases_of(name: str) -> Tuple[str, ...]:
    fn = get_combiner(name)
    return tuple(key for key, batch in _REGISTRY.items() if batch is fn)


def register_streaming(name: str, sc: StreamingCombiner) -> StreamingCombiner:
    """Attach a native streaming implementation to a registered combiner
    (and its aliases)."""
    for key in _aliases_of(name):
        _STREAMING[key] = sc
    return sc


def register_scan_face(name: str, face: ScanStreamingFace) -> ScanStreamingFace:
    """Attach a scan face to a registered combiner (and its aliases)."""
    for key in _aliases_of(name):
        _SCAN[key] = face
    return face


def get_combiner(name: str) -> Combiner:
    """Resolve a combiner by registry name (raises KeyError with choices)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown combiner {name!r}; available: {', '.join(available_combiners())}"
        ) from None


def available_combiners() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def canonical_combiners() -> Tuple[str, ...]:
    return tuple(sorted(_CANONICAL))


def streaming_combiners() -> Tuple[str, ...]:
    """Canonical names with a native incremental implementation (every other
    name still streams through the buffered fallback)."""
    return tuple(sorted(k for k in _STREAMING if k in _CANONICAL))


def get_streaming_combiner(name: str) -> StreamingCombiner:
    """The native :class:`StreamingCombiner` of ``name``, else
    :func:`buffered_streaming` over its batch callable."""
    if name in _STREAMING:
        return _STREAMING[name]
    return buffered_streaming(get_combiner(name))


class EstimateUnavailable(RuntimeError):
    """A streaming combiner has no cheap mid-stream ``estimate``.

    Carries the combiner name and the reason, so a caller can report a typed
    failure instead of calling ``None``.
    """

    def __init__(self, combiner: str, reason: str):
        self.combiner = combiner
        self.reason = reason
        super().__init__(f"{combiner}: {reason}")


def streaming_estimate(name: str) -> Callable[..., CombineResult]:
    """``get_streaming_combiner(name).estimate``, or :class:`EstimateUnavailable`."""
    sc = get_streaming_combiner(name)
    if sc.estimate is None:
        raise EstimateUnavailable(
            name,
            "no cheap mid-stream estimate: this combiner streams through "
            "the buffered fallback and only finalizes (its batch body is "
            "too heavy to re-run per refresh); query it after the stream "
            "completes, or pick a combiner with a streaming estimate",
        )
    return sc.estimate


def get_scan_face(name: str) -> Optional[ScanStreamingFace]:
    """The :class:`ScanStreamingFace` of ``name``, if it has one.

    Three cases decide whether ``Pipeline.stream_combine`` may fuse:

    - a registered face (``parametric``, ``online``, ...): that face;
    - no native streaming implementation (the buffered fallback): the trivial
      face, whose scan state is ``()`` and whose ``to_state`` wraps the
      gathered draws in a :class:`BufferState`, so ``finalize`` replays the
      batch combiner bitwise;
    - a native streaming implementation without a face: ``None``, and the
      driver stays on the subscriber path.
    """
    if name in _SCAN:
        return _SCAN[name]
    if name not in _STREAMING:
        get_combiner(name)
        return BUFFER_SCAN
    return None


# ---------------------------------------------------------------------------
# buffered streaming state (the exact fallback)
# ---------------------------------------------------------------------------


class BufferState(NamedTuple):
    """Dense accumulated draws ``(M, t, d)`` with the valid-prefix ``counts``."""

    theta: torch.Tensor  # (M, t, d)
    counts: torch.Tensor  # (M,) int32 valid prefix per machine


def buffer_init(
    M: int, d: int, dtype=torch.float32, device: torch.device | str | None = None
) -> BufferState:
    return BufferState(
        theta=torch.zeros((M, 0, d), dtype=dtype, device=device),
        counts=torch.zeros((M,), dtype=torch.int32, device=device),
    )


def buffer_append(
    state: BufferState, chunk: torch.Tensor, chunk_counts: Optional[torch.Tensor] = None
) -> BufferState:
    """Append a dense ``(M, C, d)`` chunk, keeping valid rows a prefix.

    Dense-so-far chunks concatenate as they are (the bitwise-fallback path);
    ragged ones are compacted per machine, so chain m's valid draws stay rows
    ``[0, counts[m])``.
    """
    M, C, _ = chunk.shape
    if chunk_counts is None:
        cc = torch.full((M,), C, dtype=torch.int32, device=chunk.device)
    else:
        cc = torch.as_tensor(chunk_counts, device=chunk.device).to(torch.int32)
    t = state.theta.shape[1]
    stacked = torch.cat([state.theta, chunk], dim=1)
    total = state.counts + cc
    if bool((state.counts == t).all()) and bool((cc == C).all()):
        return BufferState(stacked, total)
    # compact: the old valid prefix, then this chunk's valid prefix; the tail
    # beyond total[m] is garbage and invalid by construction
    j = torch.arange(t + C, device=chunk.device)[None, :]
    old = state.counts[:, None].long()
    idx = torch.where(j < old, j, t + j - old).clamp(0, t + C - 1)
    gathered = torch.gather(stacked, 1, idx[:, :, None].expand(-1, -1, stacked.shape[2]))
    return BufferState(gathered, total)


def buffer_batch_args(state: BufferState):
    """``(theta, counts)`` for a batch combiner call; ``counts`` is ``None``
    when every chain is dense, so the fallback takes exactly the code path of
    the gather-then-combine caller."""
    t = state.theta.shape[1]
    dense = bool((state.counts == t).all())
    return state.theta, (None if dense else state.counts)


def buffered_streaming(fn: Combiner) -> StreamingCombiner:
    """The exact streaming fallback for a batch combiner: the state is the
    growing :class:`BufferState` and ``finalize`` replays the batch combiner
    on it, so ``update*k + finalize`` ≡ batch bitwise."""

    def finalize(gen, state: BufferState, n_draws: int, **options):
        theta, counts = buffer_batch_args(state)
        if theta.shape[1] == 0:
            raise ValueError("streaming finalize before any update() chunk")
        kwargs = filter_kwargs(fn, options)
        if counts is not None:
            kwargs["counts"] = counts
        return fn(gen, theta, n_draws, **kwargs)

    return StreamingCombiner(init=buffer_init, update=buffer_append, finalize=finalize)


# the scan face of every buffer-state combiner: the fused path already holds
# the draws, so the scan state is () and the BufferState is rebuilt from them
BUFFER_SCAN = ScanStreamingFace(
    init=lambda M, d, device=None: (),
    update=lambda state, chunk: state,
    to_state=lambda state, theta, counts: BufferState(theta, counts),
)


def filter_options(combiner: Combiner, options: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only the ``options`` the combiner's signature declares
    (``**options`` passes everything through, ``**_ignored`` drops)."""
    return filter_kwargs(combiner, options)


Schedule = Callable[[torch.Tensor], torch.Tensor]


def resolve_schedule(
    samples: torch.Tensor, schedule: Optional[Schedule], rescale: bool
) -> Schedule:
    """Default bandwidth schedule: Algorithm 1's anneal, optionally rescaled
    by the pooled sample scale."""
    if schedule is not None:
        return schedule
    if rescale:
        scale = bw.pooled_scale(samples)
    else:
        scale = torch.ones((), dtype=samples.dtype, device=samples.device)
    return bw.annealed(samples.shape[-1], scale=scale)


def counts_or_full(samples: torch.Tensor, counts: Optional[torch.Tensor]) -> torch.Tensor:
    """Normalize ``counts`` to an int32 ``(M,)`` tensor (None ⇒ all-T)."""
    M, T, _ = samples.shape
    if counts is None:
        return torch.full((M,), T, dtype=torch.int32, device=samples.device)
    return torch.as_tensor(counts, device=samples.device).to(torch.int32)


def valid_masks(samples: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``(M, T)`` 0/1 mask of valid rows under ragged ``counts``."""
    T = samples.shape[1]
    t = torch.arange(T, device=samples.device)
    return (t[None, :] < counts[:, None]).to(samples.dtype)


def ragged_gather(samples: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Densify ragged chains: row t of chain m becomes ``samples[m, t % counts[m]]``.

    Every machine keeps contributing under stragglers and the output stays a
    dense ``(M, T, d)`` tensor — the shared gather behind subpostAvg, pool,
    consensus and the pooled clouds of the KDE combiners. An empty chain
    (``counts[m] = 0``) has no valid row and repeats its row 0.
    """
    T = samples.shape[1]
    t = torch.arange(T, device=samples.device)
    idx = t[None, :] % counts.long().clamp(min=1)[:, None]  # (M, T)
    return torch.gather(samples, 1, idx[:, :, None].expand(-1, -1, samples.shape[2]))


def categorical(gen: torch.Generator, logits: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` independent draws from Categorical(softmax(logits)) → (n,) int64."""
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, n, replacement=True, generator=gen)


def gumbel(gen: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise ``−log(−log u)`` with u uniform in (0, 1)."""
    tiny = torch.finfo(like.dtype).tiny
    u = torch.rand(shape, generator=gen, dtype=like.dtype, device=like.device)
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def log_weight_bruteforce(theta_sel: torch.Tensor, h: torch.Tensor | float) -> torch.Tensor:
    """Unnormalized log w_t (Eq. 3.5) for selected samples ``(..., M, d)``."""
    mean = theta_sel.mean(dim=-2, keepdim=True)
    sse = ((theta_sel - mean) ** 2).sum(dim=(-1, -2))
    m, d = theta_sel.shape[-2:]
    h = torch.as_tensor(h, dtype=theta_sel.dtype, device=theta_sel.device)
    return -0.5 * sse / h**2 - m * (d / 2.0) * torch.log(2.0 * math.pi * h**2)
