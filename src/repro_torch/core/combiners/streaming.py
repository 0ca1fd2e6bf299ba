"""Native streaming implementations of the core combiners (paper §4).

The port of ``repro/core/combiners/streaming.py``, attached to the registry
with :func:`~repro_torch.core.combiners.api.register_streaming` (``online``
attaches its own in :mod:`repro_torch.core.combiners.online`):

``parametric``
    State = the draw buffer plus Welford moments. ``finalize`` replays the
    batch combiner on the buffer (bitwise the gather-then-combine result);
    ``estimate`` samples the product of the running moments in O(d²).

``pool`` / ``subpost_average``
    The buffered adapter (bitwise finalize), with an ``estimate`` that reads
    ``n_draws`` even-strided rows off the buffer, the rows the batch body
    would select, without replaying it.

``nonparametric``
    Buffered finalize (the full IMG chain of Algorithm 1 on the gathered
    stack); ``estimate`` runs a batched IMG with ``n_batch`` floored at 8.

Every other registered name streams through the generic buffered fallback.

Scan faces (the fused path): ``parametric`` folds its Welford moments with
the plain chunk merge and estimates their product; ``pool``,
``subpost_average`` and ``nonparametric`` take the buffer face
(:data:`~repro_torch.core.combiners.api.BUFFER_SCAN`), whose state is
rebuilt from the gathered draws after the fold.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.combiners.api import (
    BUFFER_SCAN,
    BufferState,
    CombineResult,
    ScanStreamingFace,
    StreamingCombiner,
    buffer_append,
    buffer_init,
    buffered_streaming,
    register_scan_face,
    register_streaming,
)
from repro_torch.core.combiners.baselines import pool_combiner, subpost_average_combiner
from repro_torch.core.combiners.img import nonparametric
from repro_torch.core.combiners.online import (
    OnlineMoments,
    online_init,
    online_product,
    online_update_chunk,
)
from repro_torch.core.combiners.online import _finalize as _online_finalize
from repro_torch.core.combiners.parametric import parametric
from repro_torch.core.gaussian import sample_gaussian

# ---------------------------------------------------------------------------
# parametric: exact buffered finalize + O(d²) Welford trajectory estimates
# ---------------------------------------------------------------------------


class ParametricStreamState(NamedTuple):
    buffer: BufferState
    moments: OnlineMoments


_PARAMETRIC_BUFFERED = buffered_streaming(parametric)


def _parametric_init(M: int, d: int, device=None) -> ParametricStreamState:
    return ParametricStreamState(
        buffer_init(M, d, device=device), online_init(M, d, device=device)
    )


def _parametric_update(state, chunk, chunk_counts=None) -> ParametricStreamState:
    return ParametricStreamState(
        buffer=buffer_append(state.buffer, chunk, chunk_counts),
        moments=online_update_chunk(state.moments, chunk, chunk_counts),
    )


def _parametric_finalize(gen, state, n_draws, **options) -> CombineResult:
    return _PARAMETRIC_BUFFERED.finalize(gen, state.buffer, n_draws, **options)


def _parametric_estimate(
    gen, state, n_draws, *, jitter: float = 1e-8, **_ignored
) -> CombineResult:
    return _online_finalize(gen, state.moments, n_draws, jitter=jitter)


PARAMETRIC_STREAMING = register_streaming(
    "parametric",
    StreamingCombiner(
        init=_parametric_init,
        update=_parametric_update,
        finalize=_parametric_finalize,
        estimate=_parametric_estimate,
    ),
)


def _parametric_scan_estimate(
    gen, moments: OnlineMoments, n_draws: int, *, jitter: float = 1e-8, **_ignored
) -> torch.Tensor:
    return sample_gaussian(gen, online_product(moments, jitter=jitter), n_draws)


PARAMETRIC_SCAN = register_scan_face(
    "parametric",
    ScanStreamingFace(
        init=online_init,
        # the plain merge, not the kernel: trajectory estimates then follow
        # the subscriber path's moment arithmetic (the kernel is online's)
        update=online_update_chunk,
        to_state=lambda moments, theta, counts: ParametricStreamState(
            BufferState(theta, counts), moments
        ),
        estimate=_parametric_scan_estimate,
    ),
)


# ---------------------------------------------------------------------------
# pool / subpost_average: the buffered adapter is the streaming form, and the
# estimate reads O(n_draws) rows off the buffer
# ---------------------------------------------------------------------------


def _strided(n_draws: int, total: int, device) -> torch.Tensor:
    """``n_draws`` even-strided indices into ``total`` rows (wrapping when
    more are asked for than there are)."""
    i = torch.arange(n_draws, device=device)
    return (i * total) // n_draws if n_draws <= total else i % total


def _pool_estimate(gen, state: BufferState, n_draws, **_ignored) -> CombineResult:
    """Even-strided ``n_draws`` rows of the current union: the rows ``pool``'s
    finalize puts at those indices (same ``m·t + r`` flattening, same ragged
    wrap), without materializing the M·t cloud."""
    theta, counts = state.theta, state.counts
    M, t, _ = theta.shape
    if t == 0:
        raise ValueError("streaming estimate before any update() chunk")
    flat = _strided(n_draws, M * t, theta.device)
    m_idx, r_idx = flat // t, flat % t
    r_idx = r_idx % counts[m_idx].long().clamp(min=1)
    return CombineResult(
        samples=theta[m_idx, r_idx], acceptance_rate=torch.ones((), device=theta.device)
    )


def _subpost_avg_estimate(gen, state: BufferState, n_draws, **_ignored) -> CombineResult:
    """subpostAvg at ``n_draws`` even-strided draw indices: the rows the full
    gather-then-average finalize selects (the mean over machines commutes
    with row selection)."""
    theta, counts = state.theta, state.counts
    M, t, d = theta.shape
    if t == 0:
        raise ValueError("streaming estimate before any update() chunk")
    idx = _strided(n_draws, t, theta.device)
    rows = idx[None, :] % counts[:, None].long().clamp(min=1)  # (M, n_draws)
    sel = torch.gather(theta, 1, rows[:, :, None].expand(-1, -1, d))
    return CombineResult(
        samples=sel.mean(dim=0), acceptance_rate=torch.ones((), device=theta.device)
    )


POOL_STREAMING = register_streaming(
    "pool", buffered_streaming(pool_combiner)._replace(estimate=_pool_estimate)
)
SUBPOST_AVERAGE_STREAMING = register_streaming(
    "subpost_average",
    buffered_streaming(subpost_average_combiner)._replace(estimate=_subpost_avg_estimate),
)


# ---------------------------------------------------------------------------
# nonparametric: buffered finalize + batched-IMG estimates
# ---------------------------------------------------------------------------

_NONPARAMETRIC_BUFFERED = buffered_streaming(nonparametric)


def _nonparametric_estimate(gen, state, n_draws, **options) -> CombineResult:
    # mid-stream snapshots ride batched index chains: the same stationary
    # distribution per chain, ~1/n_batch the sweeps
    opts = dict(options)
    opts["n_batch"] = max(int(opts.get("n_batch", 1) or 1), 8)
    return _NONPARAMETRIC_BUFFERED.finalize(gen, state, n_draws, **opts)


NONPARAMETRIC_STREAMING = register_streaming(
    "nonparametric",
    StreamingCombiner(
        init=buffer_init,
        update=buffer_append,
        finalize=_NONPARAMETRIC_BUFFERED.finalize,
        estimate=_nonparametric_estimate,
    ),
)

for _name in ("pool", "subpost_average", "nonparametric"):
    register_scan_face(_name, BUFFER_SCAN)
