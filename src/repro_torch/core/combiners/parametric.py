"""§3.1 parametric combiner: Gaussian (BvM) product — approximate, fast."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.combiners.api import (
    CombineResult,
    counts_or_full,
    register,
    valid_masks,
)
from repro_torch.core.gaussian import (
    fit_moments,
    product_moments,
    product_moments_diag,
    sample_gaussian,
)


@register("parametric")
def parametric(
    gen: torch.Generator,
    samples: torch.Tensor,
    n_draws: int,
    *,
    counts: Optional[torch.Tensor] = None,
    diag: bool = False,
    **_ignored,
) -> CombineResult:
    """Sample from the Gaussian product estimate (Eqs. 3.1–3.2)."""
    counts = counts_or_full(samples, counts)
    moments = fit_moments(samples, valid_masks(samples, counts), diag=diag)
    if diag:
        prod = product_moments_diag(moments.mean, moments.cov)
    else:
        prod = product_moments(moments.mean, moments.cov)
    draws = sample_gaussian(gen, prod, n_draws)
    return CombineResult(
        samples=draws,
        acceptance_rate=torch.ones((), device=samples.device),
        moments=prod,
    )
