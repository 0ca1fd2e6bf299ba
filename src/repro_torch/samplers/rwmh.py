"""Random-walk Metropolis–Hastings with Gaussian proposals, batched over chains.

The port of ``repro/samplers/rwmh.py``, the paper's §2 example sampler: the
subposterior (underweighted prior) lives entirely in the ``logdensity``
closure, so the kernel is the same for full-posterior and subposterior use.
As MALA's, the step reads its step size when it runs (the warmup rewrites a
``(..., 1)`` tensor in place) and ``draw`` makes its random inputs apart from
it, in the step's own order: the proposal's, then log u.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.samplers.base import LogDensityFn, MCMCKernel, StepInfo


class Proposal(NamedTuple):
    """A proposal split for capture: ``draw(gen, position, out=None) ->
    inputs`` (its random inputs, in order) and ``move(position, *inputs) ->
    proposal``."""

    draw: Callable[..., Tuple[torch.Tensor, ...]]
    move: Callable[..., torch.Tensor]


class RWMHState(NamedTuple):
    position: torch.Tensor  # (..., d)
    log_density: torch.Tensor  # (...)


def _gaussian_walk(step_size) -> Proposal:
    def draw(gen, position, out=None):
        if out is None:
            return (torch.randn(position.shape, generator=gen, dtype=position.dtype,
                                device=position.device),)
        (noise,) = out
        torch.randn(noise.shape, generator=gen, out=noise)
        return (noise,)

    def move(position, noise):
        return position + step_size * noise

    return Proposal(draw, move)


def rwmh_kernel(
    logdensity: LogDensityFn,
    step_size: float | torch.Tensor = 0.1,
    *,
    proposal_fn: Optional[Proposal] = None,
) -> MCMCKernel:
    """Symmetric Gaussian random-walk MH.

    ``step_size`` is a float or a per-chain ``(..., 1)`` tensor, read at
    every step. ``proposal_fn`` (a :class:`Proposal`) replaces the proposal
    entirely, e.g. the GMM's label-permutation moves (paper §8.2), which are
    symmetric and need no ratio correction.
    """
    proposal = proposal_fn if proposal_fn is not None else _gaussian_walk(step_size)

    def init(position: torch.Tensor) -> RWMHState:
        with torch.no_grad():
            return RWMHState(position, logdensity(position))

    def draw(gen: torch.Generator, position: torch.Tensor, out=None):
        if out is None:
            ins = proposal.draw(gen, position)
            log_u = torch.rand(position.shape[:-1], generator=gen, dtype=position.dtype,
                               device=position.device)
        else:
            *prop_out, log_u = out
            ins = proposal.draw(gen, position, out=tuple(prop_out))
            torch.rand(log_u.shape, generator=gen, out=log_u)
        return (*ins, log_u.log_())

    def step(gen: Optional[torch.Generator], state: RWMHState, *inputs):
        """One transition; ``inputs`` (the proposal's, then log u) may be given."""
        if not inputs:
            inputs = draw(gen, state.position)
        *prop_in, log_u = inputs
        pos = state.position
        with torch.no_grad():
            cand = proposal.move(pos, *prop_in)
            ld_prop = logdensity(cand)
        log_ratio = ld_prop - state.log_density
        accept_prob = torch.exp(log_ratio.clamp(max=0.0)).clamp(max=1.0)
        accepted = log_u < log_ratio
        new_state = RWMHState(
            position=torch.where(accepted.unsqueeze(-1), cand, pos),
            log_density=torch.where(accepted, ld_prop, state.log_density),
        )
        return new_state, StepInfo(accept_prob, accepted, new_state.log_density)

    return MCMCKernel(init=init, step=step, draw=draw)
