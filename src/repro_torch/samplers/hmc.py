"""Hamiltonian Monte Carlo with leapfrog integration + Stan-style warmup.

The port of ``repro/samplers/hmc.py``, batched over chains. The trajectory
length L is jittered uniformly in [1, L_max] per chain and transition, drawn
apart from the step with the momentum and log u (``draw``), and every chain
runs L_max leapfrog steps with those past its own L masked out, as the
reference does with ``active = i < n``: a fixed amount of work, so the
transition can be captured as one CUDA graph. Each leapfrog step is one
autograd value-and-grad over all chains. The step reads its step size when it
runs, so the dual-averaging warmup adapts a ``(..., 1)`` tensor in place.

:func:`window_adaptation` is the reference's two-phase warmup (dual
averaging with a unit metric while a Welford variance accumulates, then the
diagonal metric frozen and ε adapted again); no pipeline path runs it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.samplers.adaptation import da_init, da_update
from repro_torch.samplers.base import LogDensityFn, MCMCKernel, StepInfo
from repro_torch.samplers.mala import value_and_grad


class HMCState(NamedTuple):
    position: torch.Tensor  # (..., d)
    log_density: torch.Tensor  # (...)
    grad: torch.Tensor  # (..., d)


def _kinetic(momentum: torch.Tensor, inv_mass: torch.Tensor) -> torch.Tensor:
    return 0.5 * (momentum * inv_mass * momentum).sum(dim=-1)


def hmc_kernel(
    logdensity: LogDensityFn,
    step_size: float | torch.Tensor = 0.1,
    num_integration_steps: int = 16,
    inv_mass: Optional[torch.Tensor] = None,
    *,
    jitter_steps: bool = True,
) -> MCMCKernel:
    """Fixed-length HMC; ``jitter_steps`` draws L in [1, L_max] per chain and
    transition (cheap anti-resonance). ``step_size`` is a float or a
    per-chain ``(..., 1)`` tensor, ``inv_mass`` a diagonal metric broadcast
    against the position (unit by default); both are read at every step.
    Inputs, in the step's order: the raw momentum ``(..., d)``, log u
    ``(...)`` and L ``(...)``."""
    L_max = num_integration_steps

    def init(position: torch.Tensor) -> HMCState:
        ld, g = value_and_grad(logdensity, position)
        return HMCState(position, ld, g)

    def draw(gen: torch.Generator, position: torch.Tensor, out=None):
        batch = position.shape[:-1]
        like = dict(dtype=position.dtype, device=position.device)
        if out is None:
            raw = torch.randn(position.shape, generator=gen, **like)
            log_u = torch.rand(batch, generator=gen, **like)
            steps = (torch.randint(1, L_max + 1, batch, generator=gen, device=position.device)
                     if jitter_steps else torch.full(batch, L_max, device=position.device))
        else:
            raw, log_u, steps = out
            torch.randn(raw.shape, generator=gen, out=raw)
            torch.rand(log_u.shape, generator=gen, out=log_u)
            if jitter_steps:
                torch.randint(1, L_max + 1, steps.shape, generator=gen, out=steps)
        return raw, log_u.log_(), steps

    def step(gen: Optional[torch.Generator], state: HMCState, *inputs):
        """One transition; ``inputs`` (raw momentum, log u, L) may be given."""
        raw, log_u, steps = inputs if inputs else draw(gen, state.position)
        im = torch.ones_like(state.position) if inv_mass is None else inv_mass
        eps = step_size
        # p ~ N(0, M): a standard normal scaled by sqrt(mass) = 1/sqrt(im)
        momentum = raw / torch.sqrt(im)
        q, p, g, ld = state.position, momentum, state.grad, state.log_density
        for i in range(L_max):
            active = i < steps
            p_half = p + 0.5 * eps * g
            q_new = q + eps * (im * p_half)
            ld_new, g_new = value_and_grad(logdensity, q_new)
            p_new = p_half + 0.5 * eps * g_new
            a = active.unsqueeze(-1)
            q = torch.where(a, q_new, q)
            p = torch.where(a, p_new, p)
            g = torch.where(a, g_new, g)
            ld = torch.where(active, ld_new, ld)
        h_old = -state.log_density + _kinetic(momentum, im)
        h_new = -ld + _kinetic(p, im)
        log_ratio = h_old - h_new
        log_ratio = torch.where(torch.isfinite(log_ratio), log_ratio,
                                torch.full_like(log_ratio, -math.inf))
        accept_prob = torch.exp(log_ratio.clamp(max=0.0)).clamp(max=1.0)
        accepted = log_u < log_ratio
        acc = accepted.unsqueeze(-1)
        new_state = HMCState(
            position=torch.where(acc, q, state.position),
            log_density=torch.where(accepted, ld, state.log_density),
            grad=torch.where(acc, g, state.grad),
        )
        return new_state, StepInfo(accept_prob, accepted, new_state.log_density)

    return MCMCKernel(init=init, step=step, draw=draw)


def window_adaptation(
    logdensity: LogDensityFn,
    position: torch.Tensor,
    gen: torch.Generator,
    num_steps: int = 500,
    *,
    num_integration_steps: int = 16,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-phase warmup of the chains in ``position (..., d)``: returns
    ``(position, step_size (..., 1), inv_mass (..., d))``.

    Phase 1 (first half): ε by dual averaging with a unit metric while a
    Welford variance of the position accumulates. Phase 2 (second half): the
    diagonal metric frozen to that variance, ε adapted again from the first
    phase's average. Eager, one transition at a time.
    """
    batch = position.shape[:-1]
    half = num_steps // 2
    eps = torch.empty(batch + (1,), dtype=position.dtype, device=position.device)
    inv_mass = torch.ones_like(position)
    kern = hmc_kernel(logdensity, eps, num_integration_steps, inv_mass)
    state = kern.init(position)

    da = da_init(initial_step_size, batch, position.device)
    count = 0.0
    w_mean = torch.zeros_like(position)
    w_m2 = torch.zeros_like(position)
    for _ in range(half):
        eps.copy_(torch.exp(da.log_eps).unsqueeze(-1))
        state, info = kern.step(gen, state)
        da = da_update(da, info.accept_prob, target_accept)
        count += 1.0  # Welford over positions
        delta = state.position - w_mean
        w_mean = w_mean + delta / count
        w_m2 = w_m2 + delta * (state.position - w_mean)
    var = w_m2 / max(count - 1.0, 1.0) + 1e-6  # inv_mass = posterior variance
    inv_mass.copy_(var)

    da = da_init(initial_step_size, batch, position.device)._replace(
        log_eps=da.log_eps_avg, mu=math.log(10.0) + da.log_eps_avg)
    for _ in range(num_steps - half):
        eps.copy_(torch.exp(da.log_eps).unsqueeze(-1))
        state, info = kern.step(gen, state)
        da = da_update(da, info.accept_prob, target_accept)
    return state.position, torch.exp(da.log_eps_avg).unsqueeze(-1), var
