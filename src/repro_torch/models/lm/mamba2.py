"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) block of the ssm family.

The counterpart of ``repro/models/lm/mamba2.py``. The chunked SSD forward
(training and prefill) is the within-chunk quadratic term plus the
across-chunk linear recurrence; decode carries the recurrent state h (B, H,
hd, N) and a causal-conv window: O(1) a token at any length, which is why the
``long_500k`` shape (524,288 tokens) runs on this family.

The reference computes the SSD as einsums, elementwise passes and a
``lax.scan``, outside any Pallas kernel, so the port runs plain PyTorch: the
products on cuBLAS, the rest elementwise. Its cast points are the
reference's: the conv taps summed in the activation dtype tap by tap; ``dt``
a float32 softplus plus ``dt_bias``; the chunk products ``cb``, the decays and
the chunk summaries float32; ``att`` cast to the activation dtype before the
intra-chunk product; the inter-chunk term float32 cast down; the forward's
``D`` term in the activation dtype, decode's in float32.

Where the reference's einsums take three operands the port writes two
products (a scale, then one product), the same order on every machine:
``torch.einsum`` contracts three operands left to right unless
``opt_einsum`` is installed, and left to right the inter-chunk term would
build a (B, L, Q, H, N) temporary. The chunk recurrence is a Python loop over
the L chunks, as the reference's scan. Temporaries of the SSD core are
dropped once used: at 524,288 tokens one (B, L, Q, Q, H) float32 tensor is
12.9 GB. ``cfg.ssm.head_block`` runs the core over head blocks (the
reference's ``lax.map``), its memory knob.

``ssm_state_after`` (the prefill's cache) is the reference's: one float32
cumsum of the log decays over the whole prompt, then ``exp(cum[-1] − cum)``.
At long prompts that sum loses digits the chunked forward keeps;
``chip_smoke.py`` phase 4l measures the gap and the port keeps the
arithmetic.

:class:`Mamba2` holds ``init_mamba2``'s parameters, bare as the reference
keeps them: ``w_z``, ``w_x`` (d, d_inner), ``w_B``, ``w_C`` (d, N), ``w_dt``
(d, H), the conv taps ``conv_x``, ``conv_B``, ``conv_C`` (d_conv, ·) and
biases ``conv_bias_{x,B,C}``, ``A_log``, ``dt_bias``, ``D`` (H,), ``norm``
(d_inner) and ``w_out`` (d_inner, d). ``A_log``, ``dt_bias`` and ``D`` are
float32 whatever ``cfg.param_dtype`` is; the rest take it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from repro_torch.models.lm.config import ModelConfig
from repro_torch.models.lm import placement
from repro_torch.models.lm.layers import dtype_of, init_linear, rmsnorm, trainable
from repro_torch.models.lm.placement import is_placed

def _dims(cfg: ModelConfig) -> Tuple[int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim


def check_seq(cfg: ModelConfig, seq: int) -> None:
    """Raise unless the chunked forward takes ``seq`` tokens: a multiple of
    ``min(cfg.ssm.chunk, seq)`` (the reference's assert, ``mamba2.py:179``)."""
    q = min(cfg.ssm.chunk, seq)
    if seq % q:
        raise ValueError(f"{cfg.name}: a sequence of {seq} tokens does not divide into SSD "
                         f"chunks of {q}; the chunked forward takes a multiple of the chunk "
                         f"({cfg.ssm.chunk}) or fewer tokens than one chunk")


class Mamba2(nn.Module):
    """One layer's Mamba-2 parameters, drawn from ``generator`` as
    ``init_mamba2`` draws them (N(0, 1)·d_in^-½ projections, N(0, 1)·(1/d_conv)^½
    conv taps, zero conv biases, ``A_log = log(linspace(1, 16, H))``,
    ``dt_bias`` the inverse softplus of a log-uniform draw in [dt_min,
    dt_max], unit ``D`` and ``norm``); the random ones zero without a
    generator (weights loaded next)."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        s, d = cfg.ssm, cfg.d_model
        d_inner, n_heads = _dims(cfg)
        pd = dtype_of(cfg.param_dtype)

        def lin(i, o):
            if generator is None:
                return trainable(torch.zeros((i, o), dtype=pd, device=device))
            return trainable(init_linear(i, o, generator=generator, device=device, dtype=pd))

        def conv_w(ch):
            if generator is None:
                return trainable(torch.zeros((s.d_conv, ch), dtype=pd, device=device))
            w = torch.randn((s.d_conv, ch), generator=generator, device=device,
                            dtype=torch.float32)
            return trainable((w * (1.0 / s.d_conv) ** 0.5).to(pd))

        def const(t):
            return trainable(t.to(device))

        self.w_z = lin(d, d_inner)
        self.w_x = lin(d, d_inner)
        self.w_B = lin(d, s.d_state)
        self.w_C = lin(d, s.d_state)
        self.w_dt = lin(d, n_heads)
        self.conv_x = conv_w(d_inner)
        self.conv_B = conv_w(s.d_state)
        self.conv_C = conv_w(s.d_state)
        self.conv_bias_x = const(torch.zeros((d_inner,), dtype=pd))
        self.conv_bias_B = const(torch.zeros((s.d_state,), dtype=pd))
        self.conv_bias_C = const(torch.zeros((s.d_state,), dtype=pd))
        # the reference's values to float32 rounding: XLA's linspace and log
        # round some points to the neighbouring float32
        self.A_log = const(torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=torch.float32)))
        if generator is None:
            dt_bias = torch.zeros((n_heads,), dtype=torch.float32)
        else:
            u = torch.rand((n_heads,), generator=generator, device=device, dtype=torch.float32)
            dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min)) + math.log(s.dt_min))
            dt_bias = torch.log(torch.exp(dt) - 1.0 + 1e-6)  # softplus^-1(dt)
        self.dt_bias = const(dt_bias)
        self.D = const(torch.ones((n_heads,), dtype=torch.float32))
        self.norm = const(torch.ones((d_inner,), dtype=pd))
        self.w_out = lin(d_inner, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mamba2_forward(self, x)


class SSMCache(NamedTuple):
    """One Mamba-2 layer's decode state: the last ``d_conv − 1`` pre-conv
    inputs of each conv, ``x`` (B, d_conv − 1, d_inner), ``B`` and ``C``
    (B, d_conv − 1, N) in the activations' dtype, and the recurrent state
    ``h`` (B, H, hd, N) float32. The same size at every sequence length."""

    x: torch.Tensor
    B: torch.Tensor
    C: torch.Tensor
    h: torch.Tensor

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


def _causal_conv(conv_w: torch.Tensor, conv_b: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along axis 1. u: (B, S, C); taps (K, C), summed
    in u's dtype in tap order."""
    k, s = conv_w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = torch.zeros_like(u)
    for i in range(k):  # k = 4: unrolled taps, as the reference
        out = out + pad[:, i:i + s, :] * conv_w[i].to(u.dtype)
    return out + conv_b.to(u.dtype)


def _project(p: Mamba2, x: torch.Tensor, *, conv: bool = True):
    """x (B, S, d) → z, xs, B, C (post-conv, silu), dt (float32 softplus)."""
    z = x @ p.w_z.to(x.dtype)
    xs = x @ p.w_x.to(x.dtype)
    b_ = x @ p.w_B.to(x.dtype)
    c_ = x @ p.w_C.to(x.dtype)
    dt = x @ p.w_dt.to(x.dtype)
    if conv:
        xs = F.silu(_causal_conv(p.conv_x, p.conv_bias_x, xs))
        b_ = F.silu(_causal_conv(p.conv_B, p.conv_bias_B, b_))
        c_ = F.silu(_causal_conv(p.conv_C, p.conv_bias_C, c_))
    dt = F.softplus(dt.float() + p.dt_bias)
    return z, xs, b_, c_, dt


def _ssd_core(
    xh: torch.Tensor,  # (B, L, Q, H, hd)
    bh: torch.Tensor,  # (B, L, Q, N)
    ch: torch.Tensor,  # (B, L, Q, N)
    dtc: torch.Tensor,  # (B, L, Q, H) float32
    cum: torch.Tensor,  # (B, L, Q, H) float32 inclusive cumulative log decay
    out_dtype: torch.dtype,
) -> torch.Tensor:
    b, n_chunks, q, h, hd = xh.shape
    # ---- intra-chunk (quadratic within Q)
    with record_function("ssd.decay"):
        cb = torch.einsum("blqn,blpn->blqp", ch.float(), bh.float())
        # decay(i, j) = exp(cum_i − cum_j) for i ≥ j, evaluated in float32;
        # each temporary dropped as soon as the next exists
        dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, L, Q, Q, H)
        mask = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
        dec = torch.where(mask[None, None, :, :, None], dec, -math.inf)
        dec = torch.exp(dec)
        dec = cb[..., None] * dec
        del cb
        dec = dec * dtc[:, :, None, :, :]
        att = dec.to(out_dtype)  # (B, L, Q, Q, H)
        del dec
    with record_function("ssd.products"):
        y_intra = torch.einsum("blqph,blphd->blqhd", att, xh)
        del att
        # chunk summary Σ_j exp(cum_Q − cum_j)·dt_j·B_j ⊗ x_j: the scale on x,
        # then one product over the chunk's positions
        scale = torch.exp(cum[:, :, -1:, :] - cum) * dtc  # (B, L, Q, H)
        summary = torch.einsum("blqhd,blqn->blhdn", xh.float() * scale[..., None], bh.float())
        del scale
    total_dec = torch.exp(cum[:, :, -1, :])  # (B, L, H)

    # ---- inter-chunk recurrence: the state entering each chunk
    with record_function("ssd.chunk_scan"):
        hstate = torch.zeros((b, h, hd, bh.shape[-1]), dtype=torch.float32, device=xh.device)
        states = []
        for i in range(n_chunks):
            states.append(hstate)
            hstate = hstate * total_dec[:, i, :, None, None] + summary[:, i]
        h_states = torch.stack(states, dim=1)  # (B, L, H, hd, N)
        del states, summary
    with record_function("ssd.products"):
        # Σ_n C_n h_{dn} over the chunk, then the decay into the chunk
        y_inter = torch.einsum("blqn,blhdn->blqhd", ch.float(), h_states)
        del h_states
        y_inter = (y_inter * torch.exp(cum)[..., None]).to(out_dtype)
    return y_intra + y_inter  # (B, L, Q, H, hd)


def _ssd(xh, bh, ch, dtc, cum, out_dtype: torch.dtype, hb: int) -> torch.Tensor:
    """:func:`_ssd_core` over blocks of ``hb`` heads when they divide the heads."""
    n_heads = xh.shape[3]
    if hb and hb < n_heads and n_heads % hb == 0:
        return torch.cat([
            _ssd_core(xh[:, :, :, i:i + hb], bh, ch, dtc[..., i:i + hb], cum[..., i:i + hb],
                      out_dtype)
            for i in range(0, n_heads, hb)], dim=3)
    return _ssd_core(xh, bh, ch, dtc, cum, out_dtype)


def _ssd_placed(xh, bh, ch, dtc, cum, out_dtype: torch.dtype, hb: int) -> torch.Tensor:
    """:func:`_ssd` on local shards (a ``local_map`` region): the batch over
    the data axes and the heads over ``model`` where xh, dtc and cum all have
    them; B and C replicated over ``model`` (every head reads them), their
    gradients summed over it when the heads are split."""
    mesh = xh.device_mesh
    keep = {}
    for name in mesh.mesh_dim_names:
        if name in placement.DATA_AXES and all(placement.shards(t, name, 0)
                                               for t in (xh, bh, ch, dtc, cum)):
            keep[name] = 0
        elif name == "model" and all(placement.shards(t, name, 3) for t in (xh, dtc, cum)):
            keep[name] = 3
    heads = [n for n, d in keep.items() if d == 3]
    batch = {n: d for n, d in keep.items() if d == 0}
    per_head = placement.placements(mesh, keep)
    shared = placement.placements(mesh, batch)
    return placement.region(
        lambda a, b_, c, d, e: _ssd(a, b_, c, d, e, out_dtype, hb), mesh, (xh, bh, ch, dtc, cum),
        (per_head, shared, shared, per_head, per_head), per_head,
        (per_head, placement.placements(mesh, batch, partial=heads),
         placement.placements(mesh, batch, partial=heads), per_head, per_head))


def mamba2_forward(p: Mamba2, x: torch.Tensor) -> torch.Tensor:
    """Chunked SSD. x: (B, S, d) → (B, S, d); S a multiple of the chunk (or
    shorter than one, :func:`check_seq`)."""
    cfg = p.cfg
    s_cfg = cfg.ssm
    d_inner, n_heads = _dims(cfg)
    hd, ds = s_cfg.head_dim, s_cfg.d_state
    b, seq, _ = x.shape
    check_seq(cfg, seq)
    q = min(s_cfg.chunk, seq)
    n_chunks = seq // q

    z, xs, b_, c_, dt = _project(p, x)
    a_log = -torch.exp(p.A_log) * dt  # log a_t (B, S, H), ≤ 0

    xh = xs.reshape(b, n_chunks, q, n_heads, hd)
    bh = b_.reshape(b, n_chunks, q, ds)
    ch = c_.reshape(b, n_chunks, q, ds)
    dtc = dt.reshape(b, n_chunks, q, n_heads)
    cum = torch.cumsum(a_log.reshape(b, n_chunks, q, n_heads), dim=2)
    del a_log

    if is_placed(xh):
        y = _ssd_placed(xh, bh, ch, dtc, cum, x.dtype, s_cfg.head_block)
    else:
        y = _ssd(xh, bh, ch, dtc, cum, x.dtype, s_cfg.head_block)
    del bh, ch, dtc, cum

    y = y.reshape(b, seq, n_heads, hd)
    y = y + xs.reshape(b, seq, n_heads, hd) * p.D.to(x.dtype)[None, None, :, None]
    y = y.reshape(b, seq, d_inner)
    y = rmsnorm(y * F.silu(z), p.norm, cfg.norm_eps)
    return y @ p.w_out.to(x.dtype)


def ssm_state_after(p: Mamba2, x: torch.Tensor) -> SSMCache:
    """The recurrent state after consuming x (B, S, d): the prefill's cache,
    by the reference's arithmetic (one float32 cumsum over the prompt)."""
    cfg = p.cfg
    s_cfg = cfg.ssm
    _, n_heads = _dims(cfg)
    hd = s_cfg.head_dim
    b, seq, _ = x.shape
    # conv windows: the last d_conv − 1 *pre-conv* inputs of each component
    k = s_cfg.d_conv - 1
    # (copies: a view would hold the whole (B, S, ·) projection alive)
    windows = [(x @ w.to(x.dtype))[:, -k:, :].clone() for w in (p.w_x, p.w_B, p.w_C)]
    _, xs, b_, _, dt = _project(p, x)
    a_log = -torch.exp(p.A_log) * dt  # (B, S, H)
    cum = torch.cumsum(a_log, dim=1)
    scale = torch.exp(cum[:, -1:, :] - cum) * dt  # decay from t to the end, times dt_t
    del a_log, cum
    xh = xs.reshape(b, seq, n_heads, hd).float() * scale[..., None]
    h = torch.einsum("bshd,bsn->bhdn", xh, b_.float())
    return SSMCache(*windows, h)


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype, device=None) -> SSMCache:
    s = cfg.ssm
    d_inner, n_heads = _dims(cfg)
    k = s.d_conv - 1
    return SSMCache(
        x=torch.zeros((batch, k, d_inner), dtype=dtype, device=device),
        B=torch.zeros((batch, k, s.d_state), dtype=dtype, device=device),
        C=torch.zeros((batch, k, s.d_state), dtype=dtype, device=device),
        h=torch.zeros((batch, n_heads, s.head_dim, s.d_state), dtype=torch.float32,
                      device=device),
    )


def mamba2_decode(p: Mamba2, x: torch.Tensor, cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    """One-token recurrent step, x: (B, 1, d). The cache is updated in place
    (each window shifted by one, h replaced) and returned."""
    cfg = p.cfg
    d_inner, n_heads = _dims(cfg)
    hd = cfg.ssm.head_dim
    b = x.shape[0]
    x0 = x[:, 0]
    z = x0 @ p.w_z.to(x.dtype)
    dt = x0 @ p.w_dt.to(x.dtype)

    def conv_step(window_cache, w_in, conv_w, conv_b):
        raw = x0 @ w_in.to(x.dtype)
        window = torch.cat([window_cache.to(x.dtype), raw[:, None]], dim=1)  # (B, K, C)
        out = torch.einsum("bkc,kc->bc", window, conv_w.to(x.dtype)) + conv_b.to(x.dtype)
        window_cache.copy_(window[:, 1:])
        return F.silu(out)

    xs = conv_step(cache.x, p.w_x, p.conv_x, p.conv_bias_x)
    b_ = conv_step(cache.B, p.w_B, p.conv_B, p.conv_bias_B)
    c_ = conv_step(cache.C, p.w_C, p.conv_C, p.conv_bias_C)

    dt = F.softplus(dt.float() + p.dt_bias)  # (B, H)
    a = torch.exp(-torch.exp(p.A_log) * dt)  # (B, H)
    xh = xs.reshape(b, n_heads, hd).float()
    # dt·x ⊗ B: the scale on x, then the outer product
    h = cache.h * a[..., None, None] + (xh * dt[..., None])[..., None] * b_.float()[:, None, None]
    cache.h.copy_(h)
    y = torch.einsum("bn,bhdn->bhd", c_.float(), h)
    y = y + xh * p.D[None, :, None]
    y = y.reshape(b, d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p.norm, cfg.norm_eps)
    return (y @ p.w_out.to(x.dtype))[:, None], cache
