"""Bandwidth schedules for the (semi)nonparametric combiners.

The port of ``repro/core/bandwidth.py``: Algorithm 1's anneal
``h_i = i^{-1/(4+d)}``, a fixed bandwidth, Silverman's rule, and the pooled
scale that rescales the anneal. The reference's ``jnp.std`` is the
population std (ddof=0), so every ``torch.std`` here passes
``correction=0``.
"""

from __future__ import annotations

from typing import Callable

import torch


def annealed(
    d: int, *, scale: float | torch.Tensor = 1.0
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Paper's Algorithm 1 line 3: ``h_i = i^{-1/(4+d)}`` (times ``scale``)."""
    exponent = -1.0 / (4.0 + d)

    def schedule(i: torch.Tensor | int) -> torch.Tensor:
        if isinstance(i, torch.Tensor):
            return scale * i.to(torch.float32) ** exponent
        # a host index never becomes a device tensor: no copy, no wait
        return torch.as_tensor(scale * float(i) ** exponent, dtype=torch.float32)

    return schedule


def fixed(h: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """Constant bandwidth."""

    def schedule(i: torch.Tensor | int) -> torch.Tensor:
        del i
        return torch.as_tensor(h, dtype=torch.float32)

    return schedule


def silverman(samples: torch.Tensor) -> torch.Tensor:
    """Silverman's rule-of-thumb bandwidth for ``(T, d)`` samples (scalar h).

    The spread in ``jnp.std``'s form, the mean and then the centred second
    moment: for a chain that never moves, the mean's rounding leaves a
    residual and h stays positive, as in ``repro`` (``torch.std`` gives
    exactly 0 there, so h = 0 and a NaN distance).
    """
    T, d = samples.shape
    centred = samples - samples.mean(dim=0)
    sigma = (centred * centred).mean(dim=0).sqrt().mean()
    return (4.0 / (d + 2.0)) ** (1.0 / (d + 4.0)) * T ** (-1.0 / (d + 4.0)) * sigma


def pooled_scale(samples: torch.Tensor) -> torch.Tensor:
    """Mean marginal std across all subposteriors ``(M, T, d)`` → scalar."""
    return samples.std(dim=1, correction=0).mean()
