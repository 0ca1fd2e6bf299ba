"""Dual-averaging step-size adaptation shared by every MH-style kernel.

The port of ``repro/samplers/adaptation.py`` (Hoffman & Gelman 2011, Alg. 5
constants). State fields are tensors with one entry per chain, so the
adaptation of M chains runs as one batched update; :func:`warmup_chain`
rebuilds the kernel at every step from the chains' current step sizes
``(..., 1)``, as the reference does at its traced ε.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch.samplers.base import MCMCKernel

KernelFactory = Callable[[torch.Tensor], MCMCKernel]  # step_size -> kernel


class DualAveragingState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_avg: torch.Tensor
    step: torch.Tensor
    mu: torch.Tensor


def da_init(
    initial_step_size: float,
    batch_shape: Tuple[int, ...] = (),
    device: torch.device | str | None = None,
) -> DualAveragingState:
    log_eps = torch.full(batch_shape, math.log(initial_step_size), dtype=torch.float32,
                         device=device)
    zeros = torch.zeros_like(log_eps)
    return DualAveragingState(log_eps, zeros, zeros, zeros, math.log(10.0) + log_eps)


def da_update(
    state: DualAveragingState, accept_prob: torch.Tensor, target: float = 0.8
) -> DualAveragingState:
    """Nesterov dual averaging (Hoffman & Gelman 2011, Alg. 5 constants)."""
    t0, gamma, kappa = 10.0, 0.05, 0.75
    step = state.step + 1.0
    eta_h = 1.0 / (step + t0)
    h_avg = (1.0 - eta_h) * state.h_avg + eta_h * (target - accept_prob)
    log_eps = state.mu - torch.sqrt(step) / gamma * h_avg
    eta_x = step ** (-kappa)
    log_eps_avg = eta_x * log_eps + (1.0 - eta_x) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, h_avg, step, state.mu)


def warmup_chain(
    gen: torch.Generator,
    factory: KernelFactory,
    position: torch.Tensor,
    num_steps: int,
    *,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
) -> Tuple[MCMCKernel, torch.Tensor, torch.Tensor]:
    """Dual-averaging warmup of the chains in ``position (..., d)``.

    Returns ``(kernel, position, step_size)`` with the kernel frozen at each
    chain's averaged ε, ``step_size`` shaped ``(..., 1)``.
    """
    batch = position.shape[:-1]
    da = da_init(initial_step_size, batch, position.device)
    state = factory(torch.exp(da.log_eps).unsqueeze(-1)).init(position)
    for _ in range(num_steps):
        kern = factory(torch.exp(da.log_eps).unsqueeze(-1))
        state, info = kern.step(gen, state)
        da = da_update(da, info.accept_prob, target_accept)
    step_size = torch.exp(da.log_eps_avg).unsqueeze(-1)
    return factory(step_size), state.position, step_size
