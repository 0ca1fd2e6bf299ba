"""Shared subposterior-KDE evaluation for the sample-reweighting combiners.

The port of ``repro/core/combiners/density.py``. Weierstrass refinement and
importance-weighted pooling both need ``log p̂_m(θ)``, each machine's
Gaussian-KDE log density, at many query points. One code path serves dense
and ragged chains: :func:`repro_torch.kernels.kde_density.
machine_kde_log_density` scores all machines in one launch of the
hand-written kernel on the card (its plain version on the CPU), with
per-machine bandwidth and valid-prefix ``counts`` applied inside. Callers
that need only the pooled product score Σ_m log p̂_m or a mixture score use
:func:`machine_kde_scores`, whose fused reductions skip the (M, Q) matrix's
round trip through the caller.

Bandwidths come from :func:`masked_silverman`: Silverman's rule per machine
over the valid prefix only.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels.kde_density import machine_kde_log_density


def masked_silverman(samples: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Per-machine Silverman bandwidth over the valid prefix → ``(M,)``.

    h_m = (4/(d+2))^{1/(d+4)} · T_m^{-1/(d+4)} · σ̄_m with σ̄_m the mean
    marginal std of chain m's first ``counts[m]`` rows (unbiased normalizer),
    floored at 1e-8 so a constant chain gives a point mass, not NaN.
    """
    M, T, d = samples.shape
    # where (not mask-multiply): invalid rows may hold NaN
    mask = (torch.arange(T, device=samples.device)[None, :] < counts[:, None])[..., None]
    n = counts.to(samples.dtype).clamp(min=1.0)
    mean = torch.where(mask, samples, 0.0).sum(dim=1) / n[:, None]
    var = (torch.where(mask, samples - mean[:, None, :], 0.0) ** 2).sum(dim=1)
    var = var / (n - 1.0).clamp(min=1.0)[:, None]
    sigma = var.sqrt().mean(dim=-1)
    h = (4.0 / (d + 2.0)) ** (1.0 / (d + 4.0)) * n ** (-1.0 / (d + 4.0)) * sigma
    return h.clamp(min=1e-8)


def machine_kde_logpdfs(
    queries: torch.Tensor,  # (Q, d)
    samples: torch.Tensor,  # (M, T, d)
    counts: Optional[torch.Tensor],  # None ⇒ every chain dense
    h: torch.Tensor,  # (M,)
) -> torch.Tensor:
    """``log p̂_m(queries)`` for every machine → ``(M, Q)``."""
    return machine_kde_log_density(queries, samples, h, counts)


def machine_kde_scores(
    queries: torch.Tensor,  # (Q, d)
    samples: torch.Tensor,  # (M, T, d)
    counts: Optional[torch.Tensor],
    h: torch.Tensor,  # (M,)
    *,
    reduce: str,
    mixture_weights: str = "uniform",
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Fused pooled scores: ``reduce`` ∈ {"product", "mixture",
    "product_mixture"} → (Q,) (or a pair of them)."""
    return machine_kde_log_density(
        queries, samples, h, counts, reduce=reduce, mixture_weights=mixture_weights
    )
