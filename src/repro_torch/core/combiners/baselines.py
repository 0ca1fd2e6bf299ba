"""§7/§8 experimental baselines: subpostAvg, subpostPool, consensus MC.

The port of ``repro/core/combiners/baselines.py``. Each baseline has two
faces: the tensor function (``subpost_average`` / ``pool`` /
``consensus_weighted``) and a registered adapter with the uniform combiner
signature.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.combiners.api import (
    CombineResult,
    counts_or_full,
    ragged_gather,
    register,
    valid_masks,
)
from repro_torch.core.gaussian import fit_moments


def subpost_average(
    samples: torch.Tensor, *, counts: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """"subpostAvg": θ_t = (1/M) Σ_m θ^m_t — one aligned draw per machine
    (index t wraps modulo counts[m] under ragged chains)."""
    counts = counts_or_full(samples, counts)
    return ragged_gather(samples, counts).mean(dim=0)


def consensus_weighted(
    samples: torch.Tensor, *, counts: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Consensus Monte Carlo (Scott et al. 2013): precision-weighted averaging

        θ_t = (Σ_m Σ̂_m^{-1})^{-1} Σ_m Σ̂_m^{-1} θ^m_t.
    """
    d = samples.shape[-1]
    counts = counts_or_full(samples, counts)
    moments = fit_moments(samples, valid_masks(samples, counts))
    eye = torch.eye(d, dtype=samples.dtype, device=samples.device)
    precs = torch.linalg.inv_ex(moments.cov + 1e-10 * eye).inverse  # (M, d, d)
    chol = torch.linalg.cholesky_ex(precs.sum(dim=0)).L
    gathered = ragged_gather(samples, counts)  # (M, T, d)
    weighted = torch.einsum("mij,mtj->ti", precs, gathered)
    return torch.cholesky_solve(weighted.T, chol).T


def pool(samples: torch.Tensor, *, counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """"subpostPool": the union of all subposterior samples, ``(M·T, d)``
    (invalid rows replaced by wrapping valid ones)."""
    M, T, d = samples.shape
    counts = counts_or_full(samples, counts)
    return ragged_gather(samples, counts).reshape(M * T, d)


def _ones(samples: torch.Tensor) -> torch.Tensor:
    return torch.ones((), device=samples.device)


def _as_result(draws: torch.Tensor, n_draws: int) -> CombineResult:
    """Resize subpostAvg/consensus output (naturally T rows) to ``n_draws``:
    even stride when shrinking, wrap when growing."""
    n = draws.shape[0]
    i = torch.arange(n_draws, device=draws.device)
    idx = (i * n) // n_draws if n_draws <= n else i % n
    return CombineResult(samples=draws[idx], acceptance_rate=_ones(draws))


@register("subpost_average", "subpostAvg")
def subpost_average_combiner(
    gen: torch.Generator,
    samples: torch.Tensor,
    n_draws: int,
    *,
    counts: Optional[torch.Tensor] = None,
    **_ignored,
) -> CombineResult:
    return _as_result(subpost_average(samples, counts=counts), n_draws)


@register("consensus")
def consensus_combiner(
    gen: torch.Generator,
    samples: torch.Tensor,
    n_draws: int,
    *,
    counts: Optional[torch.Tensor] = None,
    **_ignored,
) -> CombineResult:
    return _as_result(consensus_weighted(samples, counts=counts), n_draws)


@register("pool", "subpostPool")
def pool_combiner(
    gen: torch.Generator,
    samples: torch.Tensor,
    n_draws: int,
    *,
    counts: Optional[torch.Tensor] = None,
    **_ignored,
) -> CombineResult:
    """``n_draws`` is ignored: subpostPool *is* the full M·T union."""
    return CombineResult(samples=pool(samples, counts=counts), acceptance_rate=_ones(samples))
