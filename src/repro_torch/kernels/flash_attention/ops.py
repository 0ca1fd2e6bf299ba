"""Public wrappers of the GQA flash-attention forward and backward: dispatch by the tensor's device.

CUDA tensors launch one of the three hand-written kernels of
``csrc/flash_attention.cu``, one launch per call; CPU tensors take the plain
version (``ref.py``); meta tensors (the dry run) get the output shapes alone,
and the work the kernel would do is added to :data:`META_WORK`; any other
device raises. :func:`_route` picks the kernel from the tensors alone,
before the launch. Both tensor-core routes need what TMA takes: every base
pointer 16-byte aligned, a contiguous last axis and every other stride of an
axis longer than 1 a positive multiple of 16 bytes. Then
``"tensor_core"`` (bf16 ``wgmma``) takes bfloat16 q, k and v with hd and hd_v
multiples of 64 up to 256, and ``"tf32x3"`` (float32 as error-compensated
3×TF32 ``wgmma``, after a pre-pass that splits k and vᵀ into TF32 halves in
a scratch buffer the wrapper allocates) takes float32 q, k and v with hd and
hd_v in {64, 128}; ``"fma"`` (float32 FMAs) takes everything else. Each
route raises when its launch fails; none falls back to another.
``KERNEL.launches`` counts the launches of all routes,
``KERNEL.route_launches`` each route's (a launch of ``"tf32x3"`` is its
pre-pass and main kernel, counted once). The
reference wrapper's transposes to ``(B·K, S, G·hd)``, its padding of S and T
to block multiples and its ``min_kernel_s=64`` fallback to its jnp version
are not carried over: the kernels read q, k and v in place through their
strides and mask the ragged S and T tails themselves.

On the card q, k and v must share a device and a dtype (float32 or
bfloat16), have a contiguous last axis, hd and hd_v ≤ 256, G ≤ 64 and
B·K ≤ 65,535; anything else raises. The output is a new contiguous tensor
in q's dtype. With ``return_lse=True`` every route also writes each row's
log-sum-exp (B, S, K, G) float32, natural log, +inf on a row with nothing
visible, into a tensor the wrapper allocates; without it the kernels are
handed a null pointer and write none. The result carries no gradient
(``models/lm/flash.py`` wraps both wrappers in a ``torch.autograd.Function``).

:func:`flash_attention_bwd` is the backward from the saved ``out`` and
``lse``: ``csrc/flash_attention_bwd.cu``'s two kernels (dq; dk and dv) a
call, counted as one launch of ``KERNEL_BWD``, for float32 or bfloat16
operands with hd, hd_v ≤ 256, G ≤ 64; the plain version
(``ref.flash_attention_bwd_ref``) on the CPU. :func:`_route_bwd` picks the
kernels from the tensors alone, before the launch: ``"tensor_core"`` (bf16
``wgmma`` + TMA) takes bfloat16 q, k, v, out and dout with (hd, hd_v) in
``BWD_TC_HEAD_DIMS`` ({64, 128}², and MLA's (192, 128)) that TMA takes,
``"fma"`` (float32 FMAs) every other call;
``KERNEL_BWD.route_launches`` counts each route's launches, and a failed
launch raises on either route, never falling back. :func:`bwd_tc_plan`
mirrors the tensor-core route's launch plan (the C source's
``flash_attention_bwd_tc_plan``) and :func:`bwd_tc_pairs` the tile pairs its
loops visit. Float32 sums throughout with the reference's cast points (P
and dS rounded to the input dtype before their products), in another
order than the plain version's, so they agree to float32 rounding (bf16:
to the rounding of P and dS); a fixed input gives the same bits on every
run on either route (no float atomics).

Tolerance: every route sums q·k and P·v in float32 in another order than
the plain version's matrix products, so they agree to float32 rounding
(and, in bfloat16, to the output's rounding), never bitwise. The FMA kernel
multiplies in float32. The ``"tf32x3"`` kernel multiplies TF32 halves (hi =
tf32(x), lo = tf32(x − hi), rounded to nearest) as hi·lo + lo·hi + hi·hi
and drops lo·lo, ~2^-22 of each product, so it stays within the same
float32 tolerance of the float64 result as the FMA kernel
(``ref.flash_attention_ref_split`` models it; one TF32 pass would not).
The bf16 tensor-core kernel rounds P to bfloat16 before P·v, as the
bfloat16 plain version does; it stays within the output's own bfloat16
rounding of the float64 result. A fixed input gives the same bits on every
run on every route (no float atomics).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import KERNELS, check_error, device_index, plain_version, stream_handle
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, flash_attention_ref

KERNEL = KERNELS["flash_attention"]
KERNEL_BWD = KERNELS["flash_attention_bwd"]
ROUTES = ("tensor_core", "tf32x3", "fma")
KERNEL.route_launches.update({route: 0 for route in ROUTES})
BWD_ROUTES = ("tensor_core", "fma")
KERNEL_BWD.route_launches.update({route: 0 for route in BWD_ROUTES})
BWD_TC_HEAD_DIMS = ((64, 64), (64, 128), (128, 64), (128, 128), (192, 128))  # (hd, hd_v)
MAX_HEAD_DIM = 256
MAX_GROUP = 64
TF32X3_HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.cache
def _entry(route: str):
    """The loaded library and the entry point of ``route`` with C types set."""
    lib = KERNEL.lib()
    if route == "tensor_core":
        fn = lib.flash_attention_fwd_tc
        fn.argtypes = [_I, _P, _P, _P, _P, _P, *[_I] * 9, ctypes.c_float, *[_L] * 10, _P]
    elif route == "tf32x3":
        fn = lib.flash_attention_fwd_tf32x3
        fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, *[_I] * 9, ctypes.c_float, *[_L] * 10, _P]
        lib.flash_tf32x3_scratch_floats.argtypes = [_I] * 6
        lib.flash_tf32x3_scratch_floats.restype = _L
    else:
        fn = lib.flash_attention_fwd
        fn.argtypes = [_I, _I, _P, _P, _P, _P, _P, *[_I] * 9, ctypes.c_float, _I, *[_L] * 10, _P]
    fn.restype = _I
    lib.flash_attention_error_string.argtypes = [_I]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib, fn


def _tma_strides(t: torch.Tensor) -> list:
    """Strides of every axis but the last, in elements, as a tensor map takes
    them: an axis of length 1 is never stepped along, so its stride is set to
    the row length (any multiple of 16 bytes would do)."""
    return [st if n > 1 else t.shape[-1] for st, n in zip(t.stride()[:-1], t.shape[:-1])]


def _tma_ok(t: torch.Tensor) -> bool:
    """A tensor map can take ``t``: a 16-byte aligned base, a contiguous last
    axis and every stride it steps along a positive multiple of 16 bytes."""
    per16 = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st > 0 and st % per16 == 0 for st in _tma_strides(t)))


def _route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"tensor_core"``, ``"tf32x3"`` or ``"fma"``: which kernel takes the
    call, from the tensors alone (dtypes, head dims, alignment and strides)."""
    dtypes = {x.dtype for x in (q, k, v)}
    hd, hd_v = q.shape[-1], v.shape[-1]
    if dtypes == {torch.bfloat16}:
        route = "tensor_core"
        dims_ok = all(d % 64 == 0 and 64 <= d <= MAX_HEAD_DIM for d in (hd, hd_v))
    elif dtypes == {torch.float32}:
        route = "tf32x3"
        dims_ok = hd in TF32X3_HEAD_DIMS and hd_v in TF32X3_HEAD_DIMS
    else:
        return "fma"
    return route if dims_ok and all(_tma_ok(x) for x in (q, k, v)) else "fma"


def _vec4(t: torch.Tensor) -> bool:
    """Every row of ``t`` starts aligned for one 4-element vector load."""
    strides = [st for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
    return t.data_ptr() % (4 * t.element_size()) == 0 and all(st % 4 == 0 for st in strides)


def _launch(q, k, v, causal: bool, kv_len: int, want_lse: bool):
    b, s, kh, g, hd = q.shape
    t, hd_v = k.shape[1], v.shape[-1]
    device = q.device
    for name, x in (("k", k), ("v", v)):
        if x.device != device or x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype} on {x.device}; q is {q.dtype} on {device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must be float32 or bfloat16 on the card, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.shape[-1] > 1 and x.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous, got strides {x.stride()}")
    if hd > MAX_HEAD_DIM or hd_v > MAX_HEAD_DIM or hd < 1 or hd_v < 1:
        raise ValueError(f"need 1 <= hd, hd_v <= {MAX_HEAD_DIM}; got hd={hd} hd_v={hd_v}")
    if g > MAX_GROUP or b * kh > 65535:
        raise ValueError(f"need G <= {MAX_GROUP} and B*K <= 65535; got G={g} B={b} K={kh}")
    out = torch.empty((b, s, kh, g, hd_v), dtype=q.dtype, device=device)
    lse = torch.empty((b, s, kh, g), dtype=torch.float32, device=device) if want_lse else None
    if out.numel() == 0:
        return out, lse  # nothing to compute: no launch
    lse_ptr = None if lse is None else lse.data_ptr()
    route = _route(q, k, v)
    lib, fn = _entry(route)
    scale = hd ** -0.5
    if route == "tensor_core":
        qs, ks, vs = _tma_strides(q), _tma_strides(k), _tma_strides(v)
        err = fn(
            device_index(device), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse_ptr, b, s, t, kh, g, hd, hd_v, kv_len, int(causal), scale,
            *qs, *ks, *vs, stream_handle(device),
        )
    elif route == "tf32x3":  # k and v go through the pre-pass by their strides
        scratch = torch.empty((lib.flash_tf32x3_scratch_floats(b, t, kh, hd, hd_v, kv_len),),
                              dtype=torch.float32, device=device)
        err = fn(
            device_index(device), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse_ptr, scratch.data_ptr(), b, s, t, kh, g, hd, hd_v, kv_len, int(causal), scale,
            *_tma_strides(q), *k.stride()[:3], *v.stride()[:3], stream_handle(device),
        )
    else:
        vec = int(_vec4(q)) | int(_vec4(k)) << 1 | int(_vec4(v)) << 2
        err = fn(
            device_index(device), _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse_ptr, b, s, t, kh, g, hd, hd_v, kv_len, int(causal), scale, vec,
            *q.stride()[:4], k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), stream_handle(device),
        )
    check_error(KERNEL, err, lib.flash_attention_error_string)
    KERNEL.count_launch(route)
    return out, lse


def _check_qkv(q, k, v) -> None:
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"need q (B,S,K,G,hd), k (B,T,K,hd), v (B,T,K,hd_v); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, _, kh, _, hd = q.shape
    if k.shape[0] != b or k.shape[2] != kh or k.shape[3] != hd or v.shape[:3] != k.shape[:3]:
        raise ValueError(
            f"shapes disagree: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )


def _kv_len(k: torch.Tensor, kv_len: Optional[int]) -> int:
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    if kv_len < 0:
        raise ValueError(f"kv_len must be >= 0, got {kv_len}")
    return kv_len


# Work of the kernels' meta calls (shapes only, nothing computed), read by
# ``launch/op_stats.py``: flops at 2·(hd + hd_v) a visible (query, kv) pair
# forward and 2.5 times that backward (PERF.md §6 rows 6 and 7), and the
# bytes of every operand read and result written once.
META_WORK = {"flops": 0.0, "bytes": 0.0}


def visible_pairs(s: int, t: int, causal: bool, kv_len: int) -> int:
    """(query, kv) pairs a head sees: kv positions below ``kv_len`` and, when
    causal, at or before the query's position."""
    if not causal:
        return s * kv_len
    full = min(s, kv_len)  # rows i < kv_len see i + 1 positions, the rest kv_len
    return full * (full + 1) // 2 + (s - full) * kv_len


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _meta(q, k, v, causal: bool, kv_len: int, *, backward: bool, extra=()):
    """The meta device's flash: output shapes (forward: out (B, S, K, G, hd_v)
    and the float32 lse; backward: dq, dk, dv), and the work tallied."""
    b, s, kh, g, hd = q.shape
    hd_v = v.shape[-1]
    flops = 2.0 * (hd + hd_v) * b * kh * g * visible_pairs(s, k.shape[1], causal, kv_len)
    if backward:
        outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        flops *= 2.5
    else:
        outs = (torch.empty((b, s, kh, g, hd_v), dtype=q.dtype, device=q.device),
                torch.empty((b, s, kh, g), dtype=torch.float32, device=q.device))
    META_WORK["flops"] += flops
    META_WORK["bytes"] += _nbytes(q, k, v, *extra, *outs)
    return outs


def flash_attention(
    q: torch.Tensor,  # (B, S, K, G, hd)
    k: torch.Tensor,  # (B, T, K, hd)
    v: torch.Tensor,  # (B, T, K, hd_v)
    *,
    causal: bool = True,
    kv_len: Optional[int] = None,  # kv positions ≥ kv_len are masked (None ⇒ T)
    return_lse: bool = False,
):
    """Flash-attention forward; returns (B, S, K, G, hd_v) in q's dtype, and
    with ``return_lse`` also the rows' lse (B, S, K, G) float32."""
    _check_qkv(q, k, v)
    kv_len = _kv_len(k, kv_len)
    if q.device.type == "cuda":
        out, lse = _launch(q, k, v, causal, kv_len, return_lse)
        return (out, lse) if return_lse else out
    if q.device.type == "cpu":
        with plain_version():
            return flash_attention_ref(q, k, v, causal=causal, kv_len=kv_len,
                                       return_lse=return_lse)
    if q.device.type == "meta":
        out, lse = _meta(q, k, v, causal, kv_len, backward=False)
        return (out, lse) if return_lse else out
    raise ValueError(f"no flash_attention for device {q.device}")


@functools.cache
def _bwd_entry(route: str):
    """The loaded library and the backward entry point of ``route`` with C
    types set."""
    lib = KERNEL_BWD.lib()
    if route == "tensor_core":
        fn = lib.flash_attention_bwd_tc
        fn.argtypes = [_I, *[_P] * 10, *[_I] * 9, ctypes.c_float, _P, _P]
        lib.flash_attention_bwd_tc_plan.argtypes = [*[_I] * 8, _P]
        lib.flash_attention_bwd_tc_plan.restype = _I
    else:
        fn = lib.flash_attention_bwd
        fn.argtypes = [_I, _I, *[_P] * 10, *[_I] * 9, ctypes.c_float, _I, _P, _P]
    fn.restype = _I
    lib.flash_attention_bwd_error_string.argtypes = [_I]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib, fn


def _route_bwd(q, k, v, out, dout) -> str:
    """``"tensor_core"`` or ``"fma"``: which backward kernels take the call,
    from the tensors alone (dtypes, head dims, alignment and strides)."""
    xs = (q, k, v, out, dout)
    if ({x.dtype for x in xs} == {torch.bfloat16}
            and (q.shape[-1], v.shape[-1]) in BWD_TC_HEAD_DIMS and all(_tma_ok(x) for x in xs)):
        return "tensor_core"
    return "fma"


class BwdPlan(NamedTuple):
    """One kernel of the tensor-core backward as it is launched."""

    blocks: int
    threads: int  # a block
    smem: int  # dynamic shared bytes a block
    scratch_floats: int  # lse·log2(e) and D, both kernels'


# the tensor-core backward's tiles (csrc/flash_attention_bwd.cu, namespace tc)
TC_TILE = 64  # positions a q slab, q tile or kv tile
TC_WARPGROUPS = 2  # consumer warpgroups a block, both kernels
TC_STAGES = 2  # ring depth, both kernels
_TC_BLOCK = 64 * 128  # bytes of a 64-column block of a 64-row bf16 tile
_TC_BARRIERS = 8 * (1 + 2 * TC_STAGES) + 1024  # mbarriers + the alignment slack


def bwd_tc_smem(kernel: str, hd: int, hd_v: int) -> int:
    """Dynamic shared bytes a block of ``kernel`` ("dq" or "dkdv") takes."""
    kq, ko = hd // 64 * _TC_BLOCK, hd_v // 64 * _TC_BLOCK
    if kernel == "dq":  # each warpgroup's q, dout and out; the K/V ring
        return TC_WARPGROUPS * (kq + 2 * ko) + TC_STAGES * (kq + ko) + _TC_BARRIERS
    # each warpgroup's K and V; the q/dout ring and its lse·log2(e) and D
    # slices; a float32 accumulator of dk's columns past 128 a warpgroup (hd 192)
    dk_shared = max(hd - 128, 0) // 2 * 128 * 4
    return ((TC_WARPGROUPS + TC_STAGES) * (kq + ko) + TC_STAGES * 2 * TC_TILE * 4
            + TC_WARPGROUPS * dk_shared + _TC_BARRIERS)


def bwd_tc_plan(kernel: str, b: int, s: int, t: int, kh: int, g: int, hd: int,
                hd_v: int) -> Optional[BwdPlan]:
    """The tensor-core backward's launch of ``kernel`` ("dq" or "dkdv"), as
    the C source plans it (``flash_attention_bwd_tc_plan``, held equal on
    the card); None for a shape the route does not take."""
    if (hd, hd_v) not in BWD_TC_HEAD_DIMS or min(b, s, t, kh, g) < 1:
        return None
    n_qt = -(-s // TC_TILE)
    if kernel == "dq":  # TC_WARPGROUPS (position slab, head) slabs a block
        per_bk = -(-n_qt * g // TC_WARPGROUPS)
    else:  # TC_WARPGROUPS kv tiles a block
        per_bk = -(-t // (TC_WARPGROUPS * TC_TILE))
    return BwdPlan(per_bk * b * kh, (TC_WARPGROUPS + 1) * 128, bwd_tc_smem(kernel, hd, hd_v),
                   2 * b * kh * g * n_qt * TC_TILE)


def _dq_tiles(ps: int, s: int, kv_lim: int, causal: bool) -> int:
    end = min(kv_lim, (ps + 1) * TC_TILE, s) if causal else kv_lim
    return -(-end // TC_TILE)


def bwd_tc_pairs(kernel: str, s: int, t: int, g: int, causal: bool, kv_len: int) -> list:
    """The (head, q tile, kv tile) pairs, tiles of 64, whose products
    ``kernel``'s consumer warpgroups compute for one (b, kv head), in the
    order of the C source's loops: a mirror of them for the tests."""
    n_qt = -(-s // TC_TILE)
    kv_lim = max(0, min(kv_len, t))
    pairs = []
    if kernel == "dq":
        n_slabs = n_qt * g
        for grp in range(-(-n_slabs // TC_WARPGROUPS)):
            slab0 = grp * TC_WARPGROUPS
            last = min(slab0 + TC_WARPGROUPS, n_slabs) - 1
            n_tiles = _dq_tiles(last // g, s, kv_lim, causal)  # the block's loads
            for slab in range(slab0, last + 1):
                ps, head = divmod(slab, g)
                mine = _dq_tiles(ps, s, kv_lim, causal)
                pairs += [(head, ps, jt) for jt in range(n_tiles) if jt < mine]
        return pairs
    for kvb in range(-(-t // (TC_WARPGROUPS * TC_TILE))):
        kv0b = kvb * TC_WARPGROUPS * TC_TILE
        qt0 = kvb * TC_WARPGROUPS if causal else 0
        n_q = max(0, n_qt - qt0) if kv0b < kv_lim else 0
        for i in range(g * n_q):  # the block's loads: heads, then q tiles
            head, qt = i // n_q, qt0 + i % n_q
            for w in range(TC_WARPGROUPS):
                kvw = kv0b + w * TC_TILE
                if kvw < kv_lim and (not causal or min(qt * TC_TILE + TC_TILE, s) - 1 >= kvw):
                    pairs.append((head, qt, kvw // TC_TILE))
    return pairs


def _launch_bwd(q, k, v, out, lse, dout, causal: bool, kv_len: int,
                route: Optional[str] = None):
    b, s, kh, g, hd = q.shape
    t, hd_v = k.shape[1], v.shape[-1]
    device = q.device
    for name, x in (("k", k), ("v", v), ("out", out), ("dout", dout)):
        if x.device != device or x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype} on {x.device}; q is {q.dtype} on {device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must be float32 or bfloat16 on the card, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
        if x.shape[-1] > 1 and x.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous, got strides {x.stride()}")
    if lse.device != device or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError(f"lse must be contiguous float32 on {device}, got {lse.dtype} on "
                        f"{lse.device}")
    if hd > MAX_HEAD_DIM or hd_v > MAX_HEAD_DIM or hd < 1 or hd_v < 1:
        raise ValueError(f"need 1 <= hd, hd_v <= {MAX_HEAD_DIM}; got hd={hd} hd_v={hd_v}")
    if g > MAX_GROUP or b * kh > 65535:
        raise ValueError(f"need G <= {MAX_GROUP} and B*K <= 65535; got G={g} B={b} K={kh}")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, t, kh, hd), dtype=k.dtype, device=device)
    dv = torch.empty((b, t, kh, hd_v), dtype=v.dtype, device=device)
    if b == 0 or s == 0 or t == 0:  # nothing to compute: no launch
        return dq.zero_(), dk.zero_(), dv.zero_()
    route = _route_bwd(q, k, v, out, dout) if route is None else route
    if route == "tensor_core" and q.dtype != torch.bfloat16:  # the C entry sees no dtype
        raise TypeError(f"the tensor-core backward takes bfloat16 only, got {q.dtype}")
    lib, fn = _bwd_entry(route)
    if route == "tensor_core":  # scratch: lse·log2(e) and D, by (b·K + kv head, head, position)
        plan = bwd_tc_plan("dq", b, s, t, kh, g, hd, hd_v)
        scratch = torch.empty((plan.scratch_floats if plan else 1,), dtype=torch.float32,
                              device=device)
        strides = (ctypes.c_longlong * 18)(*_tma_strides(q), *_tma_strides(k), *_tma_strides(v),
                                           *_tma_strides(out), *_tma_strides(dout))
        err = fn(device_index(device), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), b, s, t, kh, g, hd, hd_v, kv_len, int(causal),
                 hd ** -0.5, strides, stream_handle(device))
    else:
        dsum = torch.empty((b, s, kh, g), dtype=torch.float32, device=device)  # D, the scratch
        vec = (int(_vec4(q)) | int(_vec4(k)) << 1 | int(_vec4(v)) << 2 | int(_vec4(out)) << 3
               | int(_vec4(dout)) << 4)
        strides = (ctypes.c_longlong * 18)(*q.stride()[:4], *k.stride()[:3], *v.stride()[:3],
                                           *out.stride()[:4], *dout.stride()[:4])
        err = fn(device_index(device), _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, t, kh, g, hd, hd_v, kv_len,
                 int(causal), hd ** -0.5, vec, strides, stream_handle(device))
    check_error(KERNEL_BWD, err, lib.flash_attention_bwd_error_string)
    KERNEL_BWD.count_launch(route)
    return dq, dk, dv


def flash_attention_bwd(
    q: torch.Tensor,  # (B, S, K, G, hd)
    k: torch.Tensor,  # (B, T, K, hd)
    v: torch.Tensor,  # (B, T, K, hd_v)
    out: torch.Tensor,  # (B, S, K, G, hd_v), the forward's
    lse: torch.Tensor,  # (B, S, K, G) float32, the forward's
    dout: torch.Tensor,  # (B, S, K, G, hd_v)
    *,
    causal: bool = True,
    kv_len: Optional[int] = None,
):
    """Flash-attention backward: ``(dq, dk, dv)`` in the dtypes of q, k, v."""
    _check_qkv(q, k, v)
    b, s, kh, g, _ = q.shape
    want = (b, s, kh, g, v.shape[-1])
    if tuple(out.shape) != want or tuple(dout.shape) != want or tuple(lse.shape) != want[:4]:
        raise ValueError(f"out and dout must be {want} and lse {want[:4]}; got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)}, {tuple(lse.shape)}")
    kv_len = _kv_len(k, kv_len)
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, out, lse, dout, causal, kv_len)
    if q.device.type == "cpu":
        with plain_version():
            return flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                           kv_len=kv_len)
    if q.device.type == "meta":
        return _meta(q, k, v, causal, kv_len, backward=True, extra=(out, lse, dout))
    raise ValueError(f"no flash_attention_bwd for device {q.device}")
