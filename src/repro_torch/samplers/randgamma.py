"""Exact Gamma sampling — Marsaglia & Tsang (2000) squeeze-free rejection.

The port of ``repro/samplers/randgamma.py``. For α ≥ 1:

    d = α − 1/3,  c = 1/sqrt(9d),  v = (1 + c·x)³ with x ~ N(0,1):
    accept v > 0 with  log u < x²/2 + d − d·v + d·log v   →   d·v ~ Gamma(α)

and for α < 1 Stirling's boost, Gamma(α) = Gamma(α+1) · U^{1/α}.

The reference loops until every lane has accepted (a data-dependent
``while_loop``). A captured CUDA graph cannot loop on a condition the host
reads, so here the rounds are a fixed number R, all drawn up front
(:func:`draw_rounds`), and each lane keeps its first accepted round
(:func:`gamma_from_rounds`). That is still exact: the rounds are independent
and the value a round accepts has the target law whichever round it is, so
conditioning on acceptance within R rounds leaves it Gamma(α). What it can
do is fail: a lane with no accepted round. Each round accepts with
probability ≥ 0.95 once α ≥ 1 (after the boost every lane has α ≥ 1), so a
lane fails all R = 10 with probability below 0.05^10 ≈ 1e-13; a Poisson–gamma
run of 2.4e8 lane draws (50,000 latents × 4,866 sweeps) expects 2e-5
failures. Failures are counted on the device and returned, never replaced:
the caller raises once it reads the count outside the graph.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

# rounds a lane gets; see the module docstring for the failure bound
ROUNDS = 10


class GammaRounds(NamedTuple):
    """The random inputs of one batch of gamma draws."""

    normal: torch.Tensor  # (R, *shape)
    uniform: torch.Tensor  # (R, *shape)
    boost: torch.Tensor  # (*shape), the α < 1 boost's uniform


def draw_rounds(
    gen: Optional[torch.Generator],
    shape: Tuple[int, ...],
    *,
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.float32,
    out: Optional[GammaRounds] = None,
) -> GammaRounds:
    """R = :data:`ROUNDS` rounds of (normal, uniform) for every lane of
    ``shape``, then the boost uniform, drawn in that order (into ``out`` when
    given)."""
    if out is None:
        like = dict(generator=gen, device=device, dtype=dtype)
        normal = torch.randn((ROUNDS,) + tuple(shape), **like)
        uniform = torch.rand((ROUNDS,) + tuple(shape), **like)
        boost = torch.rand(tuple(shape), **like)
    else:
        normal, uniform, boost = out
        torch.randn(normal.shape, generator=gen, out=normal)
        torch.rand(uniform.shape, generator=gen, out=uniform)
        torch.rand(boost.shape, generator=gen, out=boost)
    return GammaRounds(normal, uniform, boost)


def gamma_from_rounds(
    alpha: torch.Tensor, rounds: GammaRounds
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gamma(α, 1) draws from drawn rounds: ``(values, unresolved)``, with
    ``unresolved`` the count (a 0-d int64 tensor) of lanes that accepted in no
    round (their value is NaN). No host synchronisation."""
    normal, uniform, boost = rounds
    a = torch.broadcast_to(alpha, boost.shape)
    tiny = torch.finfo(boost.dtype).tiny
    small = a < 1.0
    d = torch.where(small, a + 1.0, a) - 1.0 / 3.0  # boosted shape for the α<1 lanes
    c = 1.0 / torch.sqrt(9.0 * d)
    v = (1.0 + c * normal) ** 3
    # the reference's test; log v guarded for the rejected v ≤ 0 lanes
    logv = torch.where(v > 0.0, torch.log(v.clamp(min=tiny)), torch.zeros_like(v))
    ok = (v > 0.0) & (torch.log(uniform) < 0.5 * normal * normal + d - d * v + d * logv)
    # each lane's first accepted round (R where none accepted, read as R − 1)
    R = normal.shape[0]
    idx = torch.arange(R, device=v.device).reshape((R,) + (1,) * (v.dim() - 1))
    first = torch.where(ok, idx, R).amin(dim=0, keepdim=True).clamp(max=R - 1)
    val = d * torch.gather(v, 0, first)[0]
    resolved = ok.any(dim=0)
    val = torch.where(resolved, val, torch.full_like(val, float("nan")))
    # Gamma(α) = Gamma(α+1) · U^{1/α} for α < 1 (U ≥ tiny keeps U^{1/α} > 0)
    u_boost = boost.clamp(min=tiny) ** (1.0 / a.clamp(min=tiny))
    return torch.where(small, val * u_boost, val), (~resolved).sum()


def gamma(
    gen: Optional[torch.Generator],
    alpha: torch.Tensor | float,
    shape: Optional[Tuple[int, ...]] = None,
    *,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Exact Gamma(α, 1) draws of ``shape`` (α's own by default), eagerly:
    raises if a lane is left with no accepted round (it reads the count, so
    it waits for the device; the samplers use :func:`gamma_from_rounds`)."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    shape = tuple(alpha.shape) if shape is None else tuple(shape)
    rounds = draw_rounds(gen, shape, device=alpha.device)
    val, unresolved = gamma_from_rounds(alpha, rounds)
    n = int(unresolved)
    if n:
        raise RuntimeError(f"randgamma: {n} lanes accepted in none of {ROUNDS} rounds")
    return val
