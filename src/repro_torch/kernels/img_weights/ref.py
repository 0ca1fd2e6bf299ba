"""Plain PyTorch version of the IMG mixture log-weights (paper Eq. 3.5).

The counterpart of ``repro/kernels/img_weights/ref.py``: for P candidate
components ``theta (P, M, d)`` (one selected sample per machine),

    log w_p = −SSE_p / (2h²) − M·(d/2)·log(2π h²),
    SSE_p   = Σ_m ‖θ_pm − θ̄_p‖².

It serves the CPU path and the tests; on the card the hand-written kernel
computes the same function.
"""

from __future__ import annotations

import math

import torch


def img_log_weights_ref(theta: torch.Tensor, h: torch.Tensor | float) -> torch.Tensor:
    """theta (P, M, d), scalar h → (P,) float32 log weights."""
    theta = theta.float()
    h = torch.as_tensor(h, dtype=torch.float32, device=theta.device).reshape(())
    mean = theta.mean(dim=1, keepdim=True)
    sse = ((theta - mean) ** 2).sum(dim=(1, 2))
    m, d = theta.shape[1], theta.shape[2]
    return -0.5 * sse / (h * h) - m * (d / 2.0) * torch.log(2.0 * math.pi * h * h)
