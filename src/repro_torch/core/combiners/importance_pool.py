"""Importance-weighted pooling — reweight the pooled cloud to the product.

The port of ``repro/core/combiners/importance_pool.py``. The pooled union of
all subposterior draws targets the mixture (1/M)Σ_m p_m; self-normalized
importance sampling corrects it to the product:

    target    p(θ)  ∝ ∏_m p̂_m(θ)        (product of subposterior KDEs)
    proposal  q(θ)  =  (1/M) Σ_m p̂_m(θ)  (the pooled cloud's own law)
    log w_i   =  Σ_m log p̂_m(θ_i) − log q(θ_i)

on every pooled point, both scores from one ``product_mixture`` call of the
batched KDE kernel. Resampling then emits exactly ``n_draws`` rows, with two
optional safeguards: ``truncate`` clips log-weights at log w̄ + ½·log N
(Ionides 2008), ``smooth`` adds N(0, h̄²/M · I) jitter. ``extras["ess"]`` is
the importance ESS (Σw)²/Σw².
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.combiners.api import (
    CombineResult,
    categorical,
    counts_or_full,
    ragged_gather,
    register,
)
from repro_torch.core.combiners.density import machine_kde_scores, masked_silverman


@register("importance_pool", "importance_weighted_pool")
def importance_pool(
    gen: torch.Generator,
    samples: torch.Tensor,
    n_draws: int,
    *,
    counts: Optional[torch.Tensor] = None,
    bandwidth: Optional[float] = None,
    truncate: bool = True,
    smooth: bool = True,
    temper: float = 1.0,
    **_ignored,
) -> CombineResult:
    """Self-normalized importance resampling of the pooled cloud.

    ``bandwidth`` overrides the per-machine Silverman bandwidths with a
    shared scalar; ``temper`` ∈ (0, 1] flattens the weights (w^temper).
    """
    M, T, d = samples.shape
    dtype, dev = samples.dtype, samples.device
    counts_arr = counts_or_full(samples, counts)
    N = M * T

    pooled = ragged_gather(samples, counts_arr).reshape(N, d)
    if bandwidth is None:
        h = masked_silverman(samples, counts_arr)  # (M,)
    else:
        h = torch.full((M,), float(bandwidth), dtype=dtype, device=dev)

    # wrap-densified chains each contribute exactly T pooled rows, so the
    # pooled law is the uniform mixture of the per-machine KDEs
    target, log_q = machine_kde_scores(
        pooled, samples, counts if counts is None else counts_arr, h,
        reduce="product_mixture", mixture_weights="uniform",
    )
    log_w = (target - log_q) * temper

    if truncate:
        log_mean_w = torch.logsumexp(log_w, dim=0) - math.log(N)
        log_w = torch.minimum(log_w, log_mean_w + 0.5 * math.log(N))

    idx = categorical(gen, log_w, n_draws)
    draws = pooled[idx]
    if smooth:
        h_prod = h.mean() / math.sqrt(M)
        eps = torch.randn((n_draws, d), generator=gen, dtype=dtype, device=dev)
        draws = draws + h_prod * eps

    log_z = torch.logsumexp(log_w, dim=0)
    ess = torch.exp(2.0 * log_z - torch.logsumexp(2.0 * log_w, dim=0))
    return CombineResult(
        samples=draws,
        acceptance_rate=torch.ones((), device=dev),  # one-shot resampler
        moments=None,
        extras={
            "ess": ess,
            "log_weight_max": log_w.max() - log_z,
            "h_mean": h.mean(),
        },
    )
