"""Bandwidth schedules for the (semi)nonparametric combiners.

The port of ``repro/core/bandwidth.py``: Algorithm 1's anneal
``h_i = i^{-1/(4+d)}``, Silverman's rule, and the pooled scale that rescales
the anneal. The reference's ``jnp.std`` is the population std (ddof=0), so
every ``torch.std`` here passes ``correction=0``.
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


def silverman(samples: torch.Tensor) -> torch.Tensor:
    """Silverman's rule-of-thumb bandwidth for ``(T, d)`` samples (scalar h)."""
    T, d = samples.shape
    sigma = samples.std(dim=0, correction=0).mean()
    return (4.0 / (d + 2.0)) ** (1.0 / (d + 4.0)) * T ** (-1.0 / (d + 4.0)) * sigma


def pooled_scale(samples: torch.Tensor) -> torch.Tensor:
    """Mean marginal std across all subposteriors ``(M, T, d)`` → scalar."""
    return samples.std(dim=1, correction=0).mean()
