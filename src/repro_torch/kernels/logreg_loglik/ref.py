"""Plain PyTorch version of the fused logistic log-likelihood and gradient.

The counterpart of ``repro/kernels/logreg_loglik/ref.py``, batched over a
leading problem axis G:

    ℓ[g, c]  = scale · Σ_i log σ(y_gi · x_gi·β_gc)            (y ∈ {−1, +1})
    ∇ℓ[g, c] = scale · Σ_i y_gi · σ(−y_gi · x_gi·β_gc) · x_gi

It serves the CPU path and the tests; on the card the hand-written kernel
computes the same function.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def logreg_loglik_grad_ref(
    X: torch.Tensor,  # (G, N, d)
    y: torch.Tensor,  # (G, N) in {-1, +1}
    beta: torch.Tensor,  # (G, d, C)
    *,
    scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ ``ℓ (G, C)``, ``∇ℓ (G, d, C)``, float32."""
    X = X.float()
    y = y.float()[..., None]
    beta = beta.float()
    z = y * torch.bmm(X, beta)  # (G, N, C)
    loglik = F.logsigmoid(z).sum(dim=1)
    coeff = y * torch.sigmoid(-z)
    grad = torch.bmm(X.transpose(1, 2), coeff)
    return scale * loglik, scale * grad
