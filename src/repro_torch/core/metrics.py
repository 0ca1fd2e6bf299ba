"""The paper's L2 density distance (§8), in closed form over Gaussian KDEs.

The port of the scoring half of ``repro/core/metrics.py``:

  ‖p̂ − q̂‖₂² = 1/T² ΣΣ N(xᵢ−xⱼ | 0, 2h₁²I) + 1/S² ΣΣ N(yᵢ−yⱼ | 0, 2h₂²I)
              − 2/(TS) ΣΣ N(xᵢ−yⱼ | 0, (h₁²+h₂²)I)

Each double sum is a chunked pairwise-Gaussian logsumexp. The reference
leaves this work to XLA, not to a Pallas kernel, so here it is plain tensor
code (the cross term is a float32 matmul; TF32 is off, see the package).
"""

from __future__ import annotations

import math
from typing import Optional

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
