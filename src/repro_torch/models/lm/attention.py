"""GQA, MLA and cross-attention of the LM: prefill through flash, decode through einsum.

The counterpart of ``repro/models/lm/attention.py``:

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

MLA (DeepSeek-V2's multi-head latent attention, ``cfg.mla``):

- ``mla_forward``: the expanded form. q is nope ⊕ rope a head; k is the
  latent ``c_kv`` up-projected by ``w_uk`` ⊕ the one shared ``k_rope``
  copied to every head, v the latent up-projected by ``w_uv``. Their dot
  products add, so ``sdpa`` runs it as GQA with K = H, G = 1, hd = nope +
  rope (its scale (nope + rope)^-½ is MLA's) and hd_v = v: flash at
  deepseek-v2's (192, 128) on the tensor-core routes.
- ``mla_decode``: the absorbed form against a cache of the latents alone,
  ``c_kv`` (B, max_len, kv_lora) and ``k_rope`` (B, max_len, rope):
  ``w_uk`` folds into q and ``w_uv`` into the output, so the scores and the
  context stay in the latent space (float32 scores, positions after
  ``position`` masked, as the reference). The cache is updated in place.

:class:`MLA` holds ``init_mla``'s weights: ``w_dq`` (d, q_lora), ``q_norm``
(q_lora), ``w_uq`` (q_lora, H·(nope + rope)), or ``w_q`` (d, H·(nope + rope))
when ``q_lora_rank`` is 0; ``w_dkv`` (d, kv_lora + rope), ``kv_norm``
(kv_lora), ``w_uk`` (kv_lora, H·nope), ``w_uv`` (kv_lora, H·v), ``w_o``
(H·v, d). The reference keeps them as bare arrays (no ``"w"`` level).

Cross-attention (Whisper's decoder, the reference's ``init_cross`` and
``cross_forward``): :class:`Cross` holds GQA's weights; ``cross_forward``
takes q from the decoder's x and k, v from the encoder's ``memory`` (B,
T_enc, d) on every call, prefill and each decode step alike, with no RoPE
and no mask, through the einsum path (the reference calls
``_einsum_attention`` there, never flash).

Each self-attention class's ``prefill`` (the forward plus the layer's cache,
padded to ``max_len``) and ``decode`` (one token against it) are what a
:class:`~repro_torch.models.lm.model.Block` calls.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.lm.config import ModelConfig
from repro_torch.models.lm.flash import flash_attention
from repro_torch.models.lm.placement import is_placed, like, merge, split
from repro_torch.models.lm.layers import (
    apply_rope,
    dtype_of,
    linear,
    linear_param,
    rmsnorm,
    trainable,
)

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

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, max_len: int
                ) -> Tuple[torch.Tensor, Cache]:
        """The causal forward and the k/v cache, zero beyond the prompt up to ``max_len``."""
        q, k, v = _project_qkv(self, x, positions)
        out = sdpa(self.cfg, q, k, v, causal=True)
        # zeros after the prompt; a placed k, v pads each rank's own block
        cache = {"k": _pad_seq(k, max_len), "v": _pad_seq(v, max_len)}
        return merge(out, 2) @ self.w_o.to(x.dtype), cache

    def decode(self, x: torch.Tensor, cache: Cache, position: int) -> Tuple[torch.Tensor, Cache]:
        return gqa_decode(self, x, cache, position)


def _pad_seq(t: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B, S, ...) → (B, max_len, ...), zeros after S."""
    pad = [0, 0] * (t.dim() - 2) + [0, max_len - t.shape[1]]
    return torch.nn.functional.pad(t, pad)


def _write(cache: torch.Tensor, position: int, new: torch.Tensor) -> torch.Tensor:
    """``cache`` (B, T, ...) with ``new`` (B, ...) at ``position``: in place on
    a plain cache; on a placed one (its T may be sharded over ``model``) a new
    cache, ``new`` selected by a one-hot over T."""
    if not is_placed(cache):
        cache[:, position] = new.to(cache.dtype)
        return cache
    hot = like(cache, torch.arange(cache.shape[1], device=cache.device) == position)
    hot = hot.reshape((1, -1) + (1,) * (cache.dim() - 2))
    return torch.where(hot, new[:, None].to(cache.dtype), cache)


def _project_qkv(attn: GQA, x: torch.Tensor, positions: torch.Tensor):
    cfg = attn.cfg
    b, s, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = split(linear(x, attn.w_q, attn.b_q), 2, (h, hd))
    k = split(linear(x, attn.w_k, attn.b_k), 2, (kh, hd))
    v = split(linear(x, attn.w_v, attn.b_v), 2, (kh, hd))
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
    qg = split(q, 2, (kh, h // kh))
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * hd ** -0.5
    cols = torch.arange(t, device=q.device)
    if causal:
        qpos = torch.arange(s, device=q.device) + q_offset
        scores = torch.where(like(q, qpos[:, None] >= cols[None, :]), scores, NEG_INF)
    if kv_valid_len is not None:
        valid = like(q, cols)[None, :] < like(q, kv_valid_len)[:, None]  # (B, T)
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
        q5 = split(q, 2, (kh, h // kh))
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
    return merge(out, 2) @ attn.w_o.to(x.dtype)


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
    cache["k"] = _write(cache["k"], position, k_new[:, 0])
    cache["v"] = _write(cache["v"], position, v_new[:, 0])
    valid_len = torch.full((b,), position + 1, dtype=torch.int64, device=x.device)
    out = _einsum_attention(
        q, cache["k"].to(x.dtype), cache["v"].to(x.dtype), causal=False, kv_valid_len=valid_len
    )
    return merge(out, 2) @ attn.w_o.to(x.dtype), cache


class Cross(GQA):
    """One decoder layer's cross-attention weights: GQA's (the reference's
    ``init_cross`` is ``init_gqa``), applied by :func:`cross_forward`."""

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        return cross_forward(self, x, memory)


def cross_forward(attn: GQA, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """Attention of x (B, S, d) onto ``memory`` (B, T_enc, d): no RoPE, no
    mask, the einsum path."""
    cfg = attn.cfg
    b, s, _ = x.shape
    t = memory.shape[1]
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = split(linear(x, attn.w_q, attn.b_q), 2, (h, hd))
    k = split(linear(memory, attn.w_k, attn.b_k), 2, (kh, hd))
    v = split(linear(memory, attn.w_v, attn.b_v), 2, (kh, hd))
    out = _einsum_attention(q, k, v, causal=False)
    return merge(out, 2) @ attn.w_o.to(x.dtype)


class MLA(nn.Module):
    """One layer's MLA projections (``init_mla`` in the reference); random
    from ``generator``, zeros without one (the norms' scales ones)."""

    def __init__(
        self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None, device=None
    ):
        super().__init__()
        self.cfg = cfg
        m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
        dtype = dtype_of(cfg.param_dtype)
        init = dict(generator=generator, device=device, dtype=dtype)
        qk = m.nope_head_dim + m.rope_head_dim
        for name in ("w_dq", "q_norm", "w_uq", "w_q"):
            self.register_parameter(name, None)
        if m.q_lora_rank:
            self.w_dq = linear_param(d, m.q_lora_rank, **init)
            self.q_norm = trainable(torch.ones((m.q_lora_rank,), dtype=dtype, device=device))
            self.w_uq = linear_param(m.q_lora_rank, h * qk, **init)
        else:
            self.w_q = linear_param(d, h * qk, **init)
        self.w_dkv = linear_param(d, m.kv_lora_rank + m.rope_head_dim, **init)
        self.kv_norm = trainable(torch.ones((m.kv_lora_rank,), dtype=dtype, device=device))
        self.w_uk = linear_param(m.kv_lora_rank, h * m.nope_head_dim, **init)
        self.w_uv = linear_param(m.kv_lora_rank, h * m.v_head_dim, **init)
        self.w_o = linear_param(h * m.v_head_dim, d, **init)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return mla_forward(self, x, positions)

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, max_len: int
                ) -> Tuple[torch.Tensor, Cache]:
        """The forward and the latent cache, zero beyond the prompt up to
        ``max_len``. The reference computes ``_mla_latents`` twice here (in
        ``mla_forward`` and again for the cache, reference ``model.py:181``);
        once gives the same values."""
        latents = _mla_latents(self, x, positions)
        out = mla_forward(self, x, positions, latents=latents)
        c_kv, k_rope = latents
        return out, {"c_kv": _pad_seq(c_kv, max_len), "k_rope": _pad_seq(k_rope, max_len)}

    def decode(self, x: torch.Tensor, cache: Cache, position: int) -> Tuple[torch.Tensor, Cache]:
        return mla_decode(self, x, cache, position)


def _mla_q(attn: MLA, x: torch.Tensor, positions: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope)), RoPE on q_rope."""
    cfg, m = attn.cfg, attn.cfg.mla
    b, s, _ = x.shape
    if m.q_lora_rank:
        q = linear(rmsnorm(linear(x, attn.w_dq), attn.q_norm, cfg.norm_eps), attn.w_uq)
    else:
        q = linear(x, attn.w_q)
    q = split(q, 2, (cfg.num_heads, m.nope_head_dim + m.rope_head_dim))
    q_nope, q_rope = q[..., : m.nope_head_dim], q[..., m.nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latents(attn: MLA, x: torch.Tensor, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(c_kv (B, S, kv_lora) normalised, k_rope (B, S, rope) rotated as one head)."""
    cfg, m = attn.cfg, attn.cfg.mla
    dkv = linear(x, attn.w_dkv)  # (B, S, kv_lora + rope)
    c_kv = rmsnorm(dkv[..., : m.kv_lora_rank], attn.kv_norm, cfg.norm_eps)
    k_rope = apply_rope(dkv[..., None, m.kv_lora_rank:], positions, cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def mla_forward(
    attn: MLA,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (B, S)
    *,
    latents: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # _mla_latents(x), if known
) -> torch.Tensor:
    """Training and prefill MLA, the expanded form through ``sdpa`` (causal)."""
    cfg, m = attn.cfg, attn.cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    q_nope, q_rope = _mla_q(attn, x, positions)
    c_kv, k_rope = _mla_latents(attn, x, positions) if latents is None else latents
    k_nope = split(linear(c_kv, attn.w_uk), 2, (h, m.nope_head_dim))
    v = split(linear(c_kv, attn.w_uv), 2, (h, m.v_head_dim))
    q_full = torch.cat([q_nope, q_rope], dim=-1)  # (B, S, H, nope + rope)
    # the concatenation writes k_rope into every head: k_full is contiguous,
    # with no stride-0 axis, so bf16 flash takes the tensor-core routes
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, m.rope_head_dim)], dim=-1)
    out = sdpa(cfg, q_full, k_full, v, causal=True)
    return merge(out, 2) @ attn.w_o.to(x.dtype)


def init_mla_cache(
    cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype, device=None
) -> Cache:
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, m.rope_head_dim), dtype=dtype, device=device)}


def mla_decode(
    attn: MLA,
    x: torch.Tensor,  # (B, 1, d)
    cache: Cache,
    position: int,  # write index; the same for the whole batch
) -> Tuple[torch.Tensor, Cache]:
    """Absorbed-form decode: q_eff[h] = W_uk[h]ᵀ q_nope[h], scores q_eff·c_kv
    + q_rope·k_rope over the cache, the context Σ_t α_t c_kv[t] in the latent
    space, then W_uv[h] and w_o. A token's cache is kv_lora + rope values a
    layer, where the expanded form's would be H·(nope + rope + v)."""
    cfg, m = attn.cfg, attn.cfg.mla
    b, h = x.shape[0], cfg.num_heads
    pos = torch.full((b, 1), position, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _mla_q(attn, x, pos)  # (B, 1, H, nope), (B, 1, H, rope)
    c_new, kr_new = _mla_latents(attn, x, pos)
    cache["c_kv"] = _write(cache["c_kv"], position, c_new[:, 0])
    cache["k_rope"] = _write(cache["k_rope"], position, kr_new[:, 0])
    cache_c, cache_r = cache["c_kv"].to(x.dtype), cache["k_rope"].to(x.dtype)
    w_uk = split(attn.w_uk.to(x.dtype), 1, (h, m.nope_head_dim))
    q_eff = torch.einsum("bshd,lhd->bshl", q_nope, w_uk)  # (B, 1, H, kv_lora)
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    scores = (torch.einsum("bshl,btl->bhst", q_eff, cache_c)
              + torch.einsum("bshd,btd->bhst", q_rope, cache_r)).float() * scale
    valid = like(x, torch.arange(cache_c.shape[1], device=x.device) <= position)  # (T,)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhst,btl->bshl", probs, cache_c)  # (B, 1, H, kv_lora)
    w_uv = split(attn.w_uv.to(x.dtype), 1, (h, m.v_head_dim))
    out = merge(torch.einsum("bshl,lhd->bshd", ctx, w_uv), 2)
    return out @ attn.w_o.to(x.dtype), cache
