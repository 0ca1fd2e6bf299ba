"""Dual-averaging step-size adaptation shared by every MH-style kernel.

The port of ``repro/samplers/adaptation.py`` (Hoffman & Gelman 2011, Alg. 5
constants). State fields are tensors with one entry per chain, so the
adaptation of M chains runs as one batched update. The reference rebuilds
the kernel inside its scan at the traced ε; :func:`warmup_chain` builds it
once on a ``(..., 1)`` step-size tensor that each transition rewrites in
place from the dual-averaging state, so the whole adaptation step (MALA
transition, update, new ε) is one transition of a
:class:`~repro_torch.samplers.base.TransitionLoop`: a CUDA graph on the card.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.samplers.base import MCMCKernel, StepInfo, TransitionLoop

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


class WarmupLoop:
    """The dual-averaging warmup as a kept chain loop: one kernel built on a
    ``(..., 1)`` step-size tensor the loop rewrites each transition, and the
    :class:`~repro_torch.samplers.base.TransitionLoop` that runs it.

    :meth:`run` resets the adaptation state and continues from the given
    position, so one loop (on the card, one captured graph) serves every
    warmup of chains of the same shape whose kernel reads the same tensors.
    """

    def __init__(self, factory: KernelFactory, batch: Tuple[int, ...],
                 device: torch.device, *, target_accept: float = 0.8):
        # the loop updates these in place
        self.da = DualAveragingState(*(torch.zeros(batch, dtype=torch.float32, device=device)
                                       for _ in DualAveragingState._fields))
        self.eps = torch.empty(batch + (1,), dtype=torch.float32, device=device)
        self.kernel = factory(self.eps)
        self.target_accept = target_accept
        self.loop: Optional[TransitionLoop] = None

    def _adapt(self, info: StepInfo) -> None:
        for dst, src in zip(self.da, da_update(self.da, info.accept_prob, self.target_accept)):
            dst.copy_(src)
        self.eps.copy_(torch.exp(self.da.log_eps).unsqueeze(-1))  # the next transition's ε

    def run(self, gen: torch.Generator, position: torch.Tensor, num_steps: int,
            initial_step_size: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """``num_steps`` adapting transitions from ``position``:
        ``(position, step_size (..., 1))``, the step each chain's average."""
        for dst, src in zip(self.da, da_init(initial_step_size, tuple(self.eps.shape[:-1]),
                                             self.eps.device)):
            dst.copy_(src)
        self.eps.copy_(torch.exp(self.da.log_eps).unsqueeze(-1))
        state = self.kernel.init(position)
        if self.loop is None:
            self.loop = TransitionLoop(self.kernel, state, inner=self._adapt)
        else:
            self.loop.load(state)
        for _ in range(num_steps):
            self.loop.step(gen)
        return (self.loop.state.position.clone(),
                torch.exp(self.da.log_eps_avg).unsqueeze(-1))


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
    warm = WarmupLoop(factory, tuple(position.shape[:-1]), position.device,
                      target_accept=target_accept)
    position, step_size = warm.run(gen, position, num_steps, initial_step_size)
    return factory(step_size), position, step_size
