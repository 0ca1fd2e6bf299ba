"""Metropolis-adjusted Langevin algorithm (MALA), batched over chains.

The port of ``repro/samplers/mala.py``. The value and gradient of the
log-density come from one autograd call over all chains at once; with the
logistic model that is one launch of the fused likelihood kernel per step.

The step reads its step size when it runs (ε² is formed inside the step), so
a kernel built on a ``(..., 1)`` tensor follows in-place updates of it: the
warmup adapts ε that way, and a captured CUDA graph of the step sees each
new value. ``draw`` makes the step's random inputs apart from the step, so a
chain driver can draw them outside a graph in the order the step would.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.samplers.base import LogDensityFn, MCMCKernel, StepInfo


class MALAState(NamedTuple):
    position: torch.Tensor  # (..., d)
    log_density: torch.Tensor  # (...)
    grad: torch.Tensor  # (..., d)


def value_and_grad(logdensity: LogDensityFn, x: torch.Tensor):
    """``(logdensity(x), ∇logdensity(x))`` for a batch of independent chains."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        ld = logdensity(x)
        (g,) = torch.autograd.grad(ld.sum(), x)
    return ld.detach(), g


def mala_kernel(
    logdensity: LogDensityFn, step_size: float | torch.Tensor = 0.05
) -> MCMCKernel:
    """θ' = θ + (ε²/2)∇log p(θ) + ε ξ with the exact MH correction.

    ``step_size`` is a float or a per-chain ``(..., 1)`` tensor, read at
    every step.
    """
    eps = step_size

    def init(position: torch.Tensor) -> MALAState:
        ld, g = value_and_grad(logdensity, position)
        return MALAState(position, ld, g)

    def forward_logq(x_from, g_from, x_to, eps2, eps2_row):
        # log q(x_to | x_from) up to a constant: −‖x_to − x_from − (ε²/2)g‖²/(2ε²)
        diff = x_to - (x_from + 0.5 * eps2 * g_from)
        return -(diff * diff).sum(dim=-1) / (2.0 * eps2_row)

    def draw(gen: torch.Generator, position: torch.Tensor, out=None):
        """The step's random inputs ``(noise (..., d), log_u (...))``, drawn
        from ``gen`` in the step's own order (into ``out`` when given)."""
        if out is None:
            noise = torch.randn(position.shape, generator=gen, dtype=position.dtype,
                                device=position.device)
            log_u = torch.rand(position.shape[:-1], generator=gen, dtype=position.dtype,
                               device=position.device)
        else:
            noise, log_u = out
            torch.randn(noise.shape, generator=gen, out=noise)
            torch.rand(log_u.shape, generator=gen, out=log_u)
        return noise, log_u.log_()

    def step(
        gen: torch.Generator,
        state: MALAState,
        noise: Optional[torch.Tensor] = None,
        log_u: Optional[torch.Tensor] = None,
    ):
        """One transition; ``noise (..., d)`` and ``log_u (...)`` may be given."""
        pos = state.position
        if noise is None:
            noise = torch.randn(pos.shape, generator=gen, dtype=pos.dtype, device=pos.device)
        if log_u is None:
            log_u = torch.log(
                torch.rand(pos.shape[:-1], generator=gen, dtype=pos.dtype, device=pos.device)
            )
        eps2 = eps**2
        # per-chain ε² for the (...)-shaped proposal log-density
        eps2_row = eps2[..., 0] if isinstance(eps2, torch.Tensor) and eps2.dim() > 0 else eps2
        proposal = (pos + 0.5 * eps2 * state.grad) + eps * noise
        ld_prop, g_prop = value_and_grad(logdensity, proposal)
        log_ratio = (
            ld_prop
            - state.log_density
            + forward_logq(proposal, g_prop, pos, eps2, eps2_row)
            - forward_logq(pos, state.grad, proposal, eps2, eps2_row)
        )
        accept_prob = torch.exp(log_ratio.clamp(max=0.0)).clamp(max=1.0)
        accepted = log_u < log_ratio
        acc = accepted.unsqueeze(-1)
        new_state = MALAState(
            position=torch.where(acc, proposal, pos),
            log_density=torch.where(accepted, ld_prop, state.log_density),
            grad=torch.where(acc, g_prop, state.grad),
        )
        return new_state, StepInfo(accept_prob, accepted, new_state.log_density)

    return MCMCKernel(init=init, step=step, draw=draw)
