"""AdamW (decoupled weight decay) with float32 state, over named tensors.

The counterpart of ``repro/optim/adamw.py``: global-norm clipping of the
gradients, μ and ν kept in ``state_dtype`` (float32 unless a config asks for
bfloat16), bias correction, decoupled decay, the arithmetic in float32 and
each parameter cast back to its own dtype. Parameters, gradients and state
are dicts keyed by the port's parameter names (``dict(model.named_parameters())``),
where the reference maps pytrees. The reference returns new arrays; the port
updates parameters, μ and ν in place (under ``torch.no_grad``), which saves a
copy of the model and of both moments at every step, and returns them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    mu: Tensors
    nu: Tensors
    count: int


def adamw_init(params: Tensors, *, state_dtype: torch.dtype = torch.float32) -> AdamWState:
    """Zero moments in ``state_dtype`` (storage only: the update's arithmetic
    is always float32), placed as their parameters are."""
    return AdamWState(
        mu={n: torch.zeros_like(p, dtype=state_dtype) for n, p in params.items()},
        nu={n: torch.zeros_like(p, dtype=state_dtype) for n, p in params.items()},
        count=0,
    )


def global_norm(grads: Tensors) -> torch.Tensor:
    """sqrt(Σ g²) over every gradient, in float32, on the gradients' device.
    On placed gradients each leaf's sum reduces over the axes that shard it,
    so the norm is the whole model's on every rank."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))


@torch.no_grad()
def adamw_update(
    params: Tensors,
    grads: Tensors,
    state: AdamWState,
    *,
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
) -> Tuple[Tensors, AdamWState]:
    """One AdamW step, in place; returns ``(params, state)``."""
    count = state.count + 1
    scale = None
    if grad_clip:  # stays on the device: no host sync
        scale = torch.clamp(grad_clip / torch.clamp(global_norm(grads), min=1e-9), max=1.0)
    c1 = 1.0 - b1**count
    c2 = 1.0 - b2**count
    for name, p in params.items():
        g = grads[name].float()
        if scale is not None:
            g = g * scale
        m, v = state.mu[name], state.nu[name]
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * torch.square(g)
        m.copy_(m32)
        v.copy_(v32)
        m32, v32 = m.float(), v.float()  # the stored moments, rounded as the reference's are
        step = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
        step = step + weight_decay * p.float()
        p.copy_(p.float() - lr * step)
    return params, AdamWState(mu=state.mu, nu=state.nu, count=count)
