"""GQA attention of the dense LM family: prefill through flash, decode through einsum.

The counterpart of the GQA part of ``repro/models/lm/attention.py``:

- ``gqa_forward``: full-sequence attention (forward and prefill). ``sdpa``
  keeps the reference's dispatch exactly: flash when ``cfg.attn_impl ==
  "chunked"`` and the sequence is longer than ``cfg.attn_chunk``, else the
  einsum path that materializes the scores. That is the model's
  configuration, not a kernel fallback: on the card flash is the
  hand-written kernel.
- ``gqa_decode``: one token against a KV cache laid out (B, max_len, K, hd),
  through the einsum path over the whole cache masked by ``position + 1``
  (plain PyTorch in the reference too). The cache is updated in place, where
  the reference returns a new one: it saves a copy of every layer's cache
  per token.

:class:`GQA` holds one layer's weights in the reference's ``x @ w`` layout:
``w_q`` (d, H·hd), ``w_k``/``w_v`` (d, K·hd), ``w_o`` (H·hd, d), and
``b_q``/``b_k``/``b_v`` when ``cfg.qkv_bias``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.lm.config import ModelConfig
from repro_torch.models.lm.flash import flash_attention
from repro_torch.models.lm.layers import apply_rope, dtype_of, linear, linear_param, trainable

NEG_INF = -1e30
Cache = Dict[str, torch.Tensor]


class GQA(nn.Module):
    """One layer's GQA projections (``init_gqa`` in the reference); random
    from ``generator``, zeros without one."""

    def __init__(
        self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None, device=None
    ):
        super().__init__()
        self.cfg = cfg
        d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        dtype = dtype_of(cfg.param_dtype)
        init = dict(generator=generator, device=device, dtype=dtype)
        self.w_q = linear_param(d, h * hd, **init)
        self.w_k = linear_param(d, kh * hd, **init)
        self.w_v = linear_param(d, kh * hd, **init)
        self.w_o = linear_param(h * hd, d, **init)
        for name, width in (("b_q", h * hd), ("b_k", kh * hd), ("b_v", kh * hd)):
            bias = trainable(torch.zeros((width,), dtype=dtype, device=device)) if cfg.qkv_bias else None
            self.register_parameter(name, bias)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *, causal: bool = True):
        return gqa_forward(self, x, positions, causal=causal)


def _project_qkv(attn: GQA, x: torch.Tensor, positions: torch.Tensor):
    cfg = attn.cfg
    b, s, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = linear(x, attn.w_q, attn.b_q).reshape(b, s, h, hd)
    k = linear(x, attn.w_k, attn.b_k).reshape(b, s, kh, hd)
    v = linear(x, attn.w_v, attn.b_v).reshape(b, s, kh, hd)
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def _einsum_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, T, K, hd)
    v: torch.Tensor,  # (B, T, K, hd_v)
    *,
    causal: bool,
    q_offset: int = 0,
    kv_valid_len: Optional[torch.Tensor] = None,  # (B,)
) -> torch.Tensor:
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * hd ** -0.5
    cols = torch.arange(t, device=q.device)
    if causal:
        qpos = torch.arange(s, device=q.device) + q_offset
        scores = torch.where(qpos[:, None] >= cols[None, :], scores, NEG_INF)
    if kv_valid_len is not None:
        valid = cols[None, :] < kv_valid_len[:, None]  # (B, T)
        scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, v.shape[-1])


def sdpa(
    cfg: ModelConfig,
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, T, K, hd)
    v: torch.Tensor,  # (B, T, K, hd_v)
    *,
    causal: bool,
) -> torch.Tensor:
    """Flash when S exceeds one ``attn_chunk`` under ``attn_impl="chunked"``, else einsum."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    if cfg.attn_impl == "chunked" and s > cfg.attn_chunk:
        q5 = q.reshape(b, s, kh, h // kh, hd)
        out = flash_attention(q5, k, v, causal, cfg.attn_chunk, cfg.attn_chunk)
    else:
        out = _einsum_attention(q, k, v, causal=causal)
    return out.reshape(b, s, h, v.shape[-1])


def gqa_forward(
    attn: GQA, x: torch.Tensor, positions: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Full-sequence attention. x: (B, S, d); positions: (B, S)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(attn, x, positions)
    out = sdpa(attn.cfg, q, k, v, causal=causal)
    return out.reshape(b, s, -1) @ attn.w_o.to(x.dtype)


def init_gqa_cache(
    cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype, device=None
) -> Cache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(
    attn: GQA,
    x: torch.Tensor,  # (B, 1, d)
    cache: Cache,
    position: int,  # write index; the same for the whole batch
) -> Tuple[torch.Tensor, Cache]:
    b = x.shape[0]
    pos = torch.full((b, 1), position, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(attn, x, pos)
    cache["k"][:, position] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, position] = v_new[:, 0].to(cache["v"].dtype)
    valid_len = torch.full((b,), position + 1, dtype=torch.int64, device=x.device)
    out = _einsum_attention(
        q, cache["k"].to(x.dtype), cache["v"].to(x.dtype), causal=False, kv_valid_len=valid_len
    )
    return out.reshape(b, 1, -1) @ attn.w_o.to(x.dtype), cache
