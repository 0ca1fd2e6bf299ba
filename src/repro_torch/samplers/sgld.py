"""Stochastic-gradient Langevin dynamics (Welling & Teh 2011) + pSGLD.

The port of ``repro/samplers/sgld.py``, batched over chains: each chain runs
SGLD on its shard's subposterior,

    θ ← θ + (ε/2)·∇[ (1/M)·log p(θ) + (N_m/B)·log p(batch|θ) ] + √ε·ξ .

SGLD consumes a data batch per step, so :func:`sgld_kernel`'s ``step`` is
``step(state, batch, noise)``. With ``preconditioner="rmsprop"`` this is
pSGLD (Li et al. 2016). ``step_size`` may be a schedule ``t -> ε_t`` of the
step counter, a device tensor in the state, so a schedule is a torch
function of it and a captured step follows it. The registry's ``sgld``
(:mod:`repro_torch.samplers.registry`) wraps this in the ``(init, step,
draw)`` protocol.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

GradEstimator = Callable[[torch.Tensor, Any], torch.Tensor]  # (θ, batch) -> ∇ log subposterior


class SGLDState(NamedTuple):
    position: torch.Tensor  # (..., d)
    v: torch.Tensor  # (..., d) RMSProp second moment (zeros when unpreconditioned)
    step: torch.Tensor  # (...) int32 step counter


class SGLDKernel(NamedTuple):
    init: Callable[[torch.Tensor], SGLDState]
    step: Callable[[SGLDState, Any, torch.Tensor], Tuple[SGLDState, torch.Tensor]]


def sgld_kernel(
    grad_estimator: GradEstimator,
    step_size: float | torch.Tensor | Callable[[torch.Tensor], torch.Tensor] = 1e-5,
    *,
    preconditioner: Optional[str] = None,
    rmsprop_decay: float = 0.99,
    rmsprop_eps: float = 1e-5,
    temperature: float = 1.0,
) -> SGLDKernel:
    """SGLD/pSGLD kernel. ``step_size`` is a float, a ``(..., 1)`` tensor or
    a schedule ``t (...) -> ε_t (...)``. ``temperature=0`` is preconditioned
    SGD. ``step(state, batch, noise (..., d)) -> (state, ‖∇‖ (...))``."""

    def eps_at(t: torch.Tensor):
        if callable(step_size):
            return step_size(t).unsqueeze(-1)
        return step_size

    def init(position: torch.Tensor) -> SGLDState:
        return SGLDState(position, torch.zeros_like(position),
                         torch.zeros(position.shape[:-1], dtype=torch.int32,
                                     device=position.device))

    def step(state: SGLDState, batch: Any, noise: torch.Tensor):
        eps = eps_at(state.step)
        grad = grad_estimator(state.position, batch)
        if preconditioner == "rmsprop":
            v = rmsprop_decay * state.v + (1.0 - rmsprop_decay) * grad * grad
            g_scale = 1.0 / (torch.sqrt(v) + rmsprop_eps)
        else:
            v = state.v
            g_scale = torch.ones_like(grad)
        new_position = (state.position + 0.5 * eps * g_scale * grad
                        + torch.sqrt(temperature * eps * g_scale) * noise)
        gnorm = torch.sqrt((grad**2).sum(dim=-1))
        return SGLDState(new_position, v, state.step + 1), gnorm

    return SGLDKernel(init=init, step=step)
