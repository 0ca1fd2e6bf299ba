"""Plain PyTorch version of the GQA flash-attention forward.

The counterpart of ``repro/kernels/flash_attention/ref.py``: float32 scores
``q·kᵀ·hd^-½``, the finite ``-1e30`` mask (never ``-inf``, so no NaN
appears), a softmax over the kv axis, and the output in ``q.dtype``. GQA
layout: q ``(B, S, K, G, hd)``, k ``(B, T, K, hd)``, v ``(B, T, K, hd_v)``;
hd_v may differ from hd.

The mask is the hand-written kernel's: kv position ``t`` is visible to query
position ``s`` when ``t < kv_len`` and, if causal, ``s ≥ t`` (no offset).
Masked positions get weight exactly 0. For a row with at least one visible
position that is the reference's softmax to the bit (``exp(-1e30 - m)`` is
0 in float32); a row with none (``kv_len = 0``) gives zeros, where a plain
softmax would average v uniformly. The reference's callers never build such
a row: causal with no offset always leaves kv position 0 visible.

It serves the CPU path and the tests; on the card the hand-written kernel
computes the same function. A float64 input is computed in float64, so a
float64 call is the tight check of the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,  # (B, S, K, G, hd)
    k: torch.Tensor,  # (B, T, K, hd)
    v: torch.Tensor,  # (B, T, K, hd_v)
    *,
    causal: bool = True,
    kv_len: Optional[int] = None,  # kv positions ≥ kv_len are masked (None ⇒ T)
) -> torch.Tensor:
    """Returns (B, S, K, G, hd_v) in ``q.dtype``."""
    s, hd = q.shape[1], q.shape[-1]
    t = k.shape[1]
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bskgd,btkd->bkgst", q.to(acc), k.to(acc)) * hd ** -0.5
    cols = torch.arange(t, device=q.device)
    mask = (cols < (t if kv_len is None else int(kv_len)))[None, :].expand(s, t)
    if causal:
        mask = mask & (torch.arange(s, device=q.device)[:, None] >= cols[None, :])
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.where(mask, torch.softmax(scores, dim=-1), 0.0)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(acc))
    return out.to(q.dtype)
