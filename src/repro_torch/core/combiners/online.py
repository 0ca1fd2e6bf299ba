"""Online parametric combiner (paper §4: combine as samples stream in).

The port of ``repro/core/combiners/online.py``: Welford moments per machine,
O(d²) state and O(1) work per sample, so the parametric product estimate
needs no gathered ``(M, T, d)`` stack. Three faces:

- batch: ``online(gen, samples, n_draws, counts=...)`` folds the whole stack
  through one chunk update and samples the product;
- streaming (host): :data:`ONLINE_STREAMING`, whose state is
  :class:`OnlineMoments` and whose folds run the plain
  :func:`online_update_chunk`; its estimate is its finalize;
- scan (the fused streaming path): :data:`ONLINE_SCAN`, whose folds run the
  hand-written ``online_update`` kernel through
  :func:`online_update_chunk_kernel`.

The kernel and the plain fold agree to float32 rounding per fold, never
bitwise (see :mod:`repro_torch.kernels.online_update.ops`), so fused and
subscriber ``online`` results agree to merge rounding; the bitwise streaming
guarantee belongs to the buffered combiners.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.combiners.api import (
    CombineResult,
    ScanStreamingFace,
    StreamingCombiner,
    counts_or_full,
    register,
    register_scan_face,
)
from repro_torch.core.gaussian import GaussianMoments, product_moments, sample_gaussian


class OnlineMoments(NamedTuple):
    """Welford running moments per subposterior — O(d²) state, O(1) per sample."""

    count: torch.Tensor  # (M,)
    mean: torch.Tensor  # (M, d)
    m2: torch.Tensor  # (M, d, d) sum of outer products of residuals


def online_init(
    M: int, d: int, dtype=torch.float32, device: torch.device | str | None = None
) -> OnlineMoments:
    return OnlineMoments(
        count=torch.zeros((M,), dtype=dtype, device=device),
        mean=torch.zeros((M, d), dtype=dtype, device=device),
        m2=torch.zeros((M, d, d), dtype=dtype, device=device),
    )


def online_update(state: OnlineMoments, m: int, theta: torch.Tensor) -> OnlineMoments:
    """Fold one new sample ``theta`` (d,) from machine ``m`` into the moments."""
    n = state.count[m] + 1.0
    delta = theta - state.mean[m]
    mean_m = state.mean[m] + delta / n
    m2_m = state.m2[m] + torch.outer(delta, theta - mean_m)
    count, mean, m2 = state.count.clone(), state.mean.clone(), state.m2.clone()
    count[m], mean[m], m2[m] = n, mean_m, m2_m
    return OnlineMoments(count, mean, m2)


def online_update_chunk(
    state: OnlineMoments,
    chunk: torch.Tensor,
    chunk_counts: Optional[torch.Tensor] = None,
) -> OnlineMoments:
    """Fold a dense ``(M, C, d)`` chunk into the moments (Chan's parallel
    Welford merge, batched over machines).

    ``chunk_counts (M,)`` marks each machine's valid prefix within the chunk
    (None ⇒ all C rows). Invalid rows may hold NaN: they are excluded with
    ``where``, never mask-multiplied.
    """
    M, C, d = chunk.shape
    if chunk_counts is None:
        cc = torch.full((M,), C, dtype=torch.int32, device=chunk.device)
    else:
        cc = torch.as_tensor(chunk_counts, device=chunk.device).to(torch.int32)
    mask = (torch.arange(C, device=chunk.device)[None, :] < cc[:, None])[..., None]
    n_b = cc.to(chunk.dtype)
    n_b_safe = n_b.clamp(min=1.0)
    valid = torch.where(mask, chunk, 0.0)
    mean_b = valid.sum(dim=1) / n_b_safe[:, None]  # (M, d)
    cent = torch.where(mask, chunk - mean_b[:, None, :], 0.0)
    m2_b = torch.einsum("mci,mcj->mij", cent, cent)  # (M, d, d)

    n_a = state.count
    n = n_a + n_b
    n_safe = n.clamp(min=1.0)
    delta = mean_b - state.mean
    mean = state.mean + delta * (n_b / n_safe)[:, None]
    m2 = state.m2 + m2_b + torch.einsum("mi,mj->mij", delta, delta) * (
        n_a * n_b / n_safe
    )[:, None, None]
    # machines contributing nothing this chunk keep their state untouched
    upd = (n_b > 0)[:, None]
    return OnlineMoments(
        count=n,
        mean=torch.where(upd, mean, state.mean),
        m2=torch.where(upd[..., None], m2, state.m2),
    )


def online_update_chunk_kernel(
    state: OnlineMoments,
    chunk: torch.Tensor,
    chunk_counts: Optional[torch.Tensor] = None,
) -> OnlineMoments:
    """The same merge as :func:`online_update_chunk`, computed by the fused
    ``online_update`` kernel on the card (one launch for all machines) and by
    its plain version on the CPU; the scan face's update."""
    from repro_torch.kernels.online_update import online_moments_update

    return OnlineMoments(*online_moments_update(
        state.count, state.mean, state.m2, chunk, chunk_counts
    ))


def online_product(state: OnlineMoments, *, jitter: float = 1e-8) -> GaussianMoments:
    """Current parametric product estimate from streaming moments."""
    d = state.mean.shape[-1]
    denom = (state.count - 1.0).clamp(min=1.0)[:, None, None]
    eye = torch.eye(d, dtype=state.m2.dtype, device=state.m2.device)
    return product_moments(state.mean, state.m2 / denom + jitter * eye)


def _finalize(
    gen: torch.Generator,
    state: OnlineMoments,
    n_draws: int,
    *,
    jitter: float = 1e-8,
    **_ignored,
) -> CombineResult:
    prod = online_product(state, jitter=jitter)
    return CombineResult(
        samples=sample_gaussian(gen, prod, n_draws),
        acceptance_rate=torch.ones((), device=state.mean.device),
        moments=prod,
    )


# estimate IS finalize: sampling the moment product is already O(d²)
ONLINE_STREAMING = StreamingCombiner(
    init=online_init,
    update=online_update_chunk,
    finalize=_finalize,
    estimate=_finalize,
)


@register("online", "online_parametric", streaming=ONLINE_STREAMING)
def online(
    gen: torch.Generator,
    samples: torch.Tensor,
    n_draws: int,
    *,
    counts: Optional[torch.Tensor] = None,
    jitter: float = 1e-8,
    **_ignored,
) -> CombineResult:
    """Batch face of the streaming moments: one whole-stack chunk update."""
    counts = counts_or_full(samples, counts)
    M, _, d = samples.shape
    state = online_update_chunk(
        online_init(M, d, samples.dtype, samples.device), samples, counts
    )
    return _finalize(gen, state, n_draws, jitter=jitter)


def _online_scan_estimate(
    gen, state: OnlineMoments, n_draws: int, *, jitter: float = 1e-8, **_ignored
) -> torch.Tensor:
    """Trajectory draws of the fused path: the host estimate's moment-product
    sample, as raw draws."""
    return sample_gaussian(gen, online_product(state, jitter=jitter), n_draws)


# the host state is the scan state: OnlineMoments pass through to_state, and
# the fused path's folds run the kernel
ONLINE_SCAN = register_scan_face(
    "online",
    ScanStreamingFace(
        init=online_init,
        update=online_update_chunk_kernel,
        to_state=lambda scan_state, theta, counts: scan_state,
        estimate=_online_scan_estimate,
    ),
)
