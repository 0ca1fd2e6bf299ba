"""Primitive layers of the LM, as plain functions on tensors.

The counterpart of ``repro/models/lm/layers.py`` for what the dense and MoE
families use (:class:`MLP` holds a SwiGLU's weights: a dense layer's FFN, an
MoE layer's shared experts). Weights keep the reference's ``x @ w`` layout,
``(d_in, d_out)``, so they cross between the packages without a transpose. Matrix products run in
the activations' dtype (``cfg.dtype``); RMSNorm statistics and the RoPE
rotation are float32, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.lm.placement import fence, is_placed, like, placements, settle, shards

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name (``cfg.dtype``, ``cfg.param_dtype``) as a torch dtype."""
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; the port runs {sorted(DTYPES)}")
    return DTYPES[name]


def init_linear(
    d_in: int,
    d_out: int,
    *,
    generator: torch.Generator,
    device: torch.device,
    dtype: torch.dtype = torch.bfloat16,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """(d_in, d_out) weight, N(0, 1) · d_in^-½ drawn in float32, then cast
    (scaled in place: one float32 temporary, not two)."""
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    w = torch.randn((d_in, d_out), generator=generator, device=device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def trainable(t: torch.Tensor) -> nn.Parameter:
    """A weight: a parameter autograd differentiates (serving runs under
    ``torch.inference_mode`` and builds no graph)."""
    return nn.Parameter(t, requires_grad=True)


def linear_param(
    d_in: int, d_out: int, *, generator: Optional[torch.Generator], device, dtype: torch.dtype
) -> nn.Parameter:
    """A (d_in, d_out) weight drawn by :func:`init_linear`; zeros without a
    generator (a model whose weights are loaded next)."""
    if generator is None:
        return trainable(torch.zeros((d_in, d_out), dtype=dtype, device=device))
    return trainable(init_linear(d_in, d_out, generator=generator, device=device, dtype=dtype))


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Rotate even/odd pairs. x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = like(x, rope_frequencies(hd, theta, device=x.device))  # (hd/2,)
    angles = like(x, positions)[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x·W_gate) ⊙ x·W_up)·W_down."""
    gate = F.silu(x @ w_gate.to(x.dtype))
    up = x @ w_up.to(x.dtype)
    return (gate * up) @ w_down.to(x.dtype)


class MLP(nn.Module):
    """SwiGLU weights in ``x @ w`` layout: w_gate, w_up (d, d_ff), w_down (d_ff, d)."""

    def __init__(self, d: int, d_ff: int, *, generator=None, dtype: torch.dtype, device=None):
        super().__init__()
        init = dict(generator=generator, device=device, dtype=dtype)
        self.w_gate = linear_param(d, d_ff, **init)
        self.w_up = linear_param(d, d_ff, **init)
        self.w_down = linear_param(d_ff, d, **init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(x, self.w_gate, self.w_up, self.w_down)


def init_embed(
    vocab: int, d: int, *, generator: torch.Generator, device: torch.device,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=generator, device=device, dtype=torch.float32)
    return w.mul_(0.02).to(dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    if is_placed(table):
        mesh = table.device_mesh  # the rows' FSDP split gathered first, as FSDP does
        vocab = {n: 0 for n in mesh.mesh_dim_names if shards(table, n, 0)}
        table = table.redistribute(mesh, placements(mesh, vocab))
        if vocab:  # DTensor's vocab-parallel lookup, masked, then summed over the vocab axes
            return fence(settle(F.embedding(like(table, tokens), table))).to(compute_dtype)
        return table[like(table, tokens)].to(compute_dtype)  # whole rows: the plain lookup
    return table[tokens].to(compute_dtype)
