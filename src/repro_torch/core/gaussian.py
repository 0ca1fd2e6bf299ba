"""Gaussian-product algebra for subposterior combination (paper Eqs. 3.1–3.2).

The port of ``repro/core/gaussian.py``. Cholesky-based throughout, as there:
subposterior covariances can be poorly conditioned and the product multiplies
M precisions. ``fit_moments`` also takes a leading batch of machines
``(M, T, d)``, the written-out form of the reference's ``vmap``. The
``*_ex`` factorizations never wait for the device to report a failure.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

_LOG2PI = math.log(2.0 * math.pi)


class GaussianMoments(NamedTuple):
    """First two moments of a (sub)posterior sample set."""

    mean: torch.Tensor  # (..., d)
    cov: torch.Tensor  # (..., d, d), or (..., d) when diagonal


def _eye(d: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(d, dtype=like.dtype, device=like.device)


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; a failure shows as NaN downstream, no host sync."""
    return torch.linalg.cholesky_ex(a).L


def fit_moments(
    samples: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    diag: bool = False,
    jitter: float = 1e-8,
) -> GaussianMoments:
    """Sample mean/covariance of ``samples`` ``(..., T, d)``.

    ``mask (..., T)`` marks valid rows (ragged chains). The covariance uses
    the unbiased 1/(T−1) normalizer and is jittered for Cholesky stability.
    """
    T, d = samples.shape[-2:]
    if mask is None:
        n = torch.full(samples.shape[:-2], float(T), dtype=samples.dtype, device=samples.device)
        mean = samples.mean(dim=-2)
        centered = samples - mean.unsqueeze(-2)
    else:
        mask = mask.to(samples.dtype)
        n = mask.sum(dim=-1).clamp(min=2.0)
        mean = (samples * mask.unsqueeze(-1)).sum(dim=-2) / n.unsqueeze(-1)
        centered = (samples - mean.unsqueeze(-2)) * mask.unsqueeze(-1)
    denom = (n - 1.0).clamp(min=1.0)
    if diag:
        var = (centered**2).sum(dim=-2) / denom.unsqueeze(-1) + jitter
        return GaussianMoments(mean=mean, cov=var)
    cov = centered.transpose(-1, -2) @ centered / denom[..., None, None]
    return GaussianMoments(mean=mean, cov=cov + jitter * _eye(d, samples))


def product_moments(
    means: torch.Tensor, covs: torch.Tensor, *, jitter: float = 1e-10
) -> GaussianMoments:
    """Moments of ``∏_m N(θ | μ_m, Σ_m)`` — paper Eqs. 3.1 / 3.2.

    means ``(M, d)``, covs ``(M, d, d)``; precision space with Cholesky solves.
    """
    d = means.shape[-1]
    eye = _eye(d, means)
    precs = torch.cholesky_solve(eye.expand_as(covs), cholesky(covs))  # (M, d, d)
    lam = precs.sum(dim=0) + jitter * eye
    eta = (precs @ means.unsqueeze(-1)).sum(dim=0)  # (d, 1)
    chol_lam = cholesky(lam)
    mean = torch.cholesky_solve(eta, chol_lam)[:, 0]
    cov = torch.cholesky_solve(eye, chol_lam)
    return GaussianMoments(mean=mean, cov=0.5 * (cov + cov.T))


def product_moments_diag(means: torch.Tensor, variances: torch.Tensor) -> GaussianMoments:
    """Diagonal-covariance version of :func:`product_moments`."""
    precs = 1.0 / variances
    lam = precs.sum(dim=0)
    return GaussianMoments(mean=(precs * means).sum(dim=0) / lam, cov=1.0 / lam)


def sample_gaussian(
    gen: torch.Generator, moments: GaussianMoments, n: int
) -> torch.Tensor:
    """Draw ``n`` samples from N(mean, cov); cov may be full or diagonal."""
    mean = moments.mean
    eps = torch.randn((n, mean.shape[-1]), generator=gen, dtype=mean.dtype, device=mean.device)
    if moments.cov.dim() == 1:
        return mean + eps * moments.cov.sqrt()
    return mean + eps @ cholesky(moments.cov).T


def log_normal_pdf(
    x: torch.Tensor, mean: torch.Tensor, cov: torch.Tensor
) -> torch.Tensor:
    """log N(x | mean, cov) with full ``(d,d)`` or diagonal ``(d,)`` cov.

    Broadcasts over leading dims of ``x``.
    """
    d = x.shape[-1]
    diff = x - mean
    if cov.dim() == 1:
        quad = (diff**2 / cov).sum(dim=-1)
        logdet = cov.log().sum()
    else:
        chol = cholesky(cov)
        flat = diff.reshape(-1, d).T  # (d, B)
        sol = torch.linalg.solve_triangular(chol, flat, upper=False)
        quad = (sol**2).sum(dim=0).reshape(diff.shape[:-1])
        logdet = 2.0 * chol.diagonal().log().sum()
    return -0.5 * (quad + logdet + d * _LOG2PI)
