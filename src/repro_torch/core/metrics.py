"""The paper's L2 density distance (§8), in closed form over Gaussian KDEs.

The port of ``repro/core/metrics.py``. The score:

  ‖p̂ − q̂‖₂² = 1/T² ΣΣ N(xᵢ−xⱼ | 0, 2h₁²I) + 1/S² ΣΣ N(yᵢ−yⱼ | 0, 2h₂²I)
              − 2/(TS) ΣΣ N(xᵢ−yⱼ | 0, (h₁²+h₂²)I)

Each double sum is a chunked pairwise-Gaussian logsumexp. The reference
leaves this work to XLA, not to a Pallas kernel, so here it is plain tensor
code (the cross term is a float32 matmul; TF32 is off, see the package).
Beside it: the KDE log density of a query set (:func:`kde_logpdf`), the
effective sample size of a chain (:func:`effective_sample_size`) and the
biased RBF MMD² (:func:`mmd2_rbf`), the second metric printed beside L2,
and the z-scores of many chains' moments against exact ones
(:func:`moment_z_scores`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core import bandwidth as bw

_LOG2PI = math.log(2.0 * math.pi)


def log_mean_gaussian_cross(
    x: torch.Tensor, y: torch.Tensor, var: torch.Tensor | float, *, chunk: int = 512
) -> torch.Tensor:
    """log [ 1/(TS) ΣΣ N(xᵢ − yⱼ | 0, var·I) ] computed in row chunks of x."""
    T, d = x.shape
    S = y.shape[0]
    var = torch.as_tensor(var, dtype=x.dtype, device=x.device)
    log_norm = -0.5 * d * (torch.log(var) + _LOG2PI)
    y_sq = (y**2).sum(dim=-1)
    block_lses = []
    for start in range(0, T, chunk):
        xc = x[start:start + chunk]
        sq = (xc**2).sum(dim=-1)[:, None] + y_sq[None, :] - 2.0 * xc @ y.T
        block_lses.append(torch.logsumexp((-0.5 * sq / var).reshape(-1), dim=0))
    total = torch.logsumexp(torch.stack(block_lses), dim=0)
    return total + log_norm - math.log(T * S)


def _cross_terms(p_samples, q_samples, h_p, h_q, chunk):
    hp = bw.silverman(p_samples) if h_p is None else torch.as_tensor(h_p)
    hq = bw.silverman(q_samples) if h_q is None else torch.as_tensor(h_q)
    t_pp = log_mean_gaussian_cross(p_samples, p_samples, 2.0 * hp**2, chunk=chunk)
    t_qq = log_mean_gaussian_cross(q_samples, q_samples, 2.0 * hq**2, chunk=chunk)
    t_pq = log_mean_gaussian_cross(p_samples, q_samples, hp**2 + hq**2, chunk=chunk)
    m = torch.maximum(torch.maximum(t_pp, t_qq), t_pq)
    val = torch.exp(t_pp - m) + torch.exp(t_qq - m) - 2.0 * torch.exp(t_pq - m)
    return 0.5 * (torch.log(val.clamp(min=1e-38)) + m)


def l2_distance(
    p_samples: torch.Tensor,
    q_samples: torch.Tensor,
    *,
    h_p: Optional[float] = None,
    h_q: Optional[float] = None,
    chunk: int = 512,
) -> torch.Tensor:
    """Paper's d₂(p, q) between two sample sets; Silverman bandwidths by default.

    Overflows float32 beyond d≈40 — use :func:`log_l2_distance` there.
    """
    return torch.exp(_cross_terms(p_samples, q_samples, h_p, h_q, chunk))


def log_l2_distance(
    p_samples: torch.Tensor,
    q_samples: torch.Tensor,
    *,
    h_p: Optional[float] = None,
    h_q: Optional[float] = None,
    chunk: int = 512,
) -> torch.Tensor:
    """log d₂(p, q) — overflow-proof form for high-d comparisons."""
    return _cross_terms(p_samples, q_samples, h_p, h_q, chunk)


def kde_logpdf(
    queries: torch.Tensor, samples: torch.Tensor, h: torch.Tensor | float, *, chunk: int = 512
) -> torch.Tensor:
    """log p̂(queries) under the Gaussian KDE of ``samples`` with bandwidth h.

    queries ``(Q, d)``, samples ``(T, d)`` → ``(Q,)``, in chunks of queries.
    """
    Q, d = queries.shape
    T = samples.shape[0]
    h = torch.as_tensor(h, dtype=queries.dtype, device=queries.device)
    log_norm = -0.5 * d * (2.0 * torch.log(h) + _LOG2PI) - math.log(T)
    s_sq = (samples**2).sum(dim=-1)
    out = []
    for start in range(0, Q, chunk):
        qc = queries[start:start + chunk]
        sq = (qc**2).sum(dim=-1)[:, None] + s_sq[None, :] - 2.0 * qc @ samples.T
        out.append(torch.logsumexp(-0.5 * sq / h**2, dim=1))
    return torch.cat(out) + log_norm


def effective_sample_size(chain: torch.Tensor) -> torch.Tensor:
    """ESS of a 1-d chain via FFT autocorrelation + Geyer initial positive pairs."""
    n = chain.shape[0]
    x = chain - chain.mean()
    f = torch.fft.rfft(x, 2 * n)
    acov = torch.fft.irfft(f * torch.conj(f), 2 * n)[:n] / n
    rho = acov / acov[0]
    # Geyer: sum consecutive pairs Γ_k = ρ_{2k}+ρ_{2k+1}; truncate at first Γ<0
    n_pairs = n // 2
    gamma = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]
    positive = torch.cumprod((gamma > 0.0).to(gamma.dtype), dim=0)
    tau = -1.0 + 2.0 * (gamma * positive).sum()
    return n / tau.clamp(min=1.0)


def moment_z_scores(
    theta: torch.Tensor, mean: torch.Tensor, std: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """z-scores of C independent chains' pooled moments against exact ones:
    ``theta (C, T, d)``; the pooled mean against ``mean (d,)`` and the pooled
    second moment about ``mean`` against ``std²``, each over its Monte Carlo
    error, the spread of the C chains' own values over √C (which carries the
    chains' autocorrelation). In ``mean``'s dtype."""
    theta = theta.to(mean.dtype)
    C = theta.shape[0]
    per_mean = theta.mean(dim=1)
    per_var = ((theta - mean) ** 2).mean(dim=1)
    z_mean = (per_mean.mean(dim=0) - mean) / (per_mean.std(dim=0) / math.sqrt(C))
    z_var = (per_var.mean(dim=0) - std**2) / (per_var.std(dim=0) / math.sqrt(C))
    return z_mean, z_var


def mmd2_rbf(
    x: torch.Tensor, y: torch.Tensor, lengthscale: float | torch.Tensor, *, chunk: int = 512
) -> torch.Tensor:
    """Biased MMD² with an RBF kernel (sanity-check metric alongside d₂)."""
    v = 2.0 * torch.as_tensor(lengthscale, dtype=x.dtype, device=x.device) ** 2
    d = x.shape[-1]

    def mean_k(a, b):
        # undo the Gaussian normalizer so k(0)=1
        return torch.exp(log_mean_gaussian_cross(a, b, v, chunk=chunk)
                         + 0.5 * d * (torch.log(v) + _LOG2PI))

    return mean_k(x, x) + mean_k(y, y) - 2.0 * mean_k(x, y)
