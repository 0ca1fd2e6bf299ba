"""Plain PyTorch versions of the GQA flash-attention forward and backward.

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

:func:`flash_attention_bwd_ref` is the backward from the saved ``out`` and
``lse``. They serve the CPU path and the tests; on the card the
hand-written kernels compute the same functions. A float64 input is computed in float64, so a
float64 call is the tight check of the kernels.
:func:`flash_attention_ref_split` models the float32 tensor-core route's
arithmetic (3×TF32 products) for the tests and the card probe.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.tf32 import tf32_split

NEG_INF = -1e30


def _mask(s: int, t: int, causal: bool, kv_len: Optional[int], device) -> torch.Tensor:
    """(S, T): kv position t visible to query position s."""
    cols = torch.arange(t, device=device)
    mask = (cols < (t if kv_len is None else int(kv_len)))[None, :].expand(s, t)
    if causal:
        mask = mask & (torch.arange(s, device=device)[:, None] >= cols[None, :])
    return mask


def flash_attention_ref(
    q: torch.Tensor,  # (B, S, K, G, hd)
    k: torch.Tensor,  # (B, T, K, hd)
    v: torch.Tensor,  # (B, T, K, hd_v)
    *,
    causal: bool = True,
    kv_len: Optional[int] = None,  # kv positions ≥ kv_len are masked (None ⇒ T)
    return_lse: bool = False,
):
    """Returns (B, S, K, G, hd_v) in ``q.dtype``; with ``return_lse`` also
    each row's log-sum-exp of its scaled scores (B, S, K, G), natural log,
    in float32 (float64 for a float64 input), +inf on a row with nothing
    visible (the kernels' sentinel, which zeroes that row's gradients)."""
    s, hd = q.shape[1], q.shape[-1]
    t = k.shape[1]
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bskgd,btkd->bkgst", q.to(acc), k.to(acc)) * hd ** -0.5
    mask = _mask(s, t, causal, kv_len, q.device)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.where(mask, torch.softmax(scores, dim=-1), 0.0)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(acc)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(mask.any(dim=-1), torch.logsumexp(scores, dim=-1), float("inf"))
    return out, lse.permute(0, 3, 1, 2).contiguous()  # (B, K, G, S) -> (B, S, K, G)


def flash_attention_bwd_ref(
    q: torch.Tensor,  # (B, S, K, G, hd)
    k: torch.Tensor,  # (B, T, K, hd)
    v: torch.Tensor,  # (B, T, K, hd_v)
    out: torch.Tensor,  # (B, S, K, G, hd_v)
    lse: torch.Tensor,  # (B, S, K, G)
    dout: torch.Tensor,  # (B, S, K, G, hd_v)
    *,
    causal: bool = True,
    kv_len: Optional[int] = None,
):
    """The backward of :func:`flash_attention_ref` from the saved ``out`` and
    ``lse``: ``(dq, dk, dv)`` in the dtypes of q, k and v.

    The reference's ``_flash_bwd`` (``repro/models/lm/flash.py:122``) in one
    pass: D = rowsum(dout∘out), P = exp(s·hd^-½ − lse) (0 where masked),
    dS = P∘(dP − D) with dP = dout·vᵀ; dv = Pᵀ·dout, dk = dSᵀ·q·hd^-½,
    dq = dS·k·hd^-½, dk and dv summed over the G heads of a kv head. Its
    cast points: P (for dv) and dS, from the unrounded P, are rounded to the
    input dtype before their products; everything else is float32 (float64
    for a float64 input).
    """
    s, hd = q.shape[1], q.shape[-1]
    t = k.shape[1]
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = hd ** -0.5
    mask = _mask(s, t, causal, kv_len, q.device)
    qa, ka, va, oa, da = (x.to(acc) for x in (q, k, v, out, dout))
    scores = torch.einsum("bskgd,btkd->bkgst", qa, ka) * scale
    lse_t = lse.to(acc).permute(0, 2, 3, 1)[..., None]  # (B, K, G, S, 1)
    p = torch.where(mask, torch.exp(scores - lse_t), 0.0)
    dsum = (da * oa).sum(dim=-1).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bskgd,btkd->bkgst", da, va)
    ds = (p * (dp - dsum)).to(q.dtype).to(acc)
    p = p.to(q.dtype).to(acc)
    dv = torch.einsum("bkgst,bskgd->btkd", p, da)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qa) * scale
    dq = torch.einsum("bkgst,btkd->bskgd", ds, ka) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _split_product(a: torch.Tensor, b: torch.Tensor, equation: str, passes: int) -> torch.Tensor:
    """``einsum(equation, a, b)`` from TF32 halves: hi·lo + lo·hi + hi·hi
    (``passes=3``) or hi·hi alone (``passes=1``), in float32."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    out = torch.einsum(equation, a_hi, b_hi)
    if passes == 3:
        out = (torch.einsum(equation, a_hi, b_lo) + torch.einsum(equation, a_lo, b_hi)) + out
    return out


def flash_attention_ref_split(
    q: torch.Tensor,  # (B, S, K, G, hd)
    k: torch.Tensor,  # (B, T, K, hd)
    v: torch.Tensor,  # (B, T, K, hd_v)
    *,
    causal: bool = True,
    kv_len: Optional[int] = None,
    passes: int = 3,
) -> torch.Tensor:
    """A model of the ``"tf32x3"`` route's arithmetic, in float32.

    Both products from TF32 halves rounded to nearest (``tf32_split``):
    ``passes=3`` sums hi·lo + lo·hi + hi·hi, ``passes=1`` takes hi·hi
    alone. The scores q·kᵀ·hd^-½ are masked as :func:`flash_attention_ref`
    masks them; P = exp(score − row max) (0 where masked) is split as the
    kernel splits its P fragment, and the output is P·v over Σ P (a row
    with nothing visible gives zeros). The kernel takes the softmax online,
    tile by tile, and sums in another order, so this model is held to it by
    tolerance, never bitwise. It serves the tests and
    ``launch/flash_probe.py``; no path calls it. Returns (B, S, K, G, hd_v)
    in float32.
    """
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    s, hd = q.shape[1], q.shape[-1]
    t = k.shape[1]
    q32, k32, v32 = (x.to(torch.float32) for x in (q, k, v))
    mask = _mask(s, t, causal, kv_len, q.device)
    scores = _split_product(q32, k32, "bskgd,btkd->bkgst", passes) * hd ** -0.5
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.where(mask, torch.exp(scores - scores.amax(dim=-1, keepdim=True)), 0.0)
    denom = p.sum(dim=-1).clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]  # (B, S, K, G, 1)
    return _split_product(p, v32, "bkgst,btkd->bskgd", passes) / denom
