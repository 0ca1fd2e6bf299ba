"""Public wrapper of the GQA flash-attention forward: dispatch by the tensor's device.

CUDA tensors launch one of the three hand-written kernels of
``csrc/flash_attention.cu``, one launch per call; CPU tensors take the plain
version (``ref.py``). :func:`_route` picks the kernel from the tensors alone,
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
in q's dtype. Forward only: the result carries no gradient (the backward
comes with the training slice).

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
from typing import Optional

import torch

from repro_torch.kernels import KERNELS, check_error, device_index, stream_handle
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

KERNEL = KERNELS["flash_attention"]
ROUTES = ("tensor_core", "tf32x3", "fma")
KERNEL.route_launches.update({route: 0 for route in ROUTES})
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
        fn.argtypes = [_I, _P, _P, _P, _P, *[_I] * 9, ctypes.c_float, *[_L] * 10, _P]
    elif route == "tf32x3":
        fn = lib.flash_attention_fwd_tf32x3
        fn.argtypes = [_I, _P, _P, _P, _P, _P, *[_I] * 9, ctypes.c_float, *[_L] * 10, _P]
        lib.flash_tf32x3_scratch_floats.argtypes = [_I] * 6
        lib.flash_tf32x3_scratch_floats.restype = _L
    else:
        fn = lib.flash_attention_fwd
        fn.argtypes = [_I, _I, _P, _P, _P, _P, *[_I] * 9, ctypes.c_float, _I, *[_L] * 10, _P]
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


def _launch(q, k, v, causal: bool, kv_len: int) -> torch.Tensor:
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
    if out.numel() == 0:
        return out  # nothing to compute: no launch
    route = _route(q, k, v)
    lib, fn = _entry(route)
    scale = hd ** -0.5
    if route == "tensor_core":
        qs, ks, vs = _tma_strides(q), _tma_strides(k), _tma_strides(v)
        err = fn(
            device_index(device), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, kh, g, hd, hd_v, kv_len, int(causal), scale,
            *qs, *ks, *vs, stream_handle(device),
        )
    elif route == "tf32x3":  # k and v go through the pre-pass by their strides
        scratch = torch.empty((lib.flash_tf32x3_scratch_floats(b, t, kh, hd, hd_v, kv_len),),
                              dtype=torch.float32, device=device)
        err = fn(
            device_index(device), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, s, t, kh, g, hd, hd_v, kv_len, int(causal), scale,
            *_tma_strides(q), *k.stride()[:3], *v.stride()[:3], stream_handle(device),
        )
    else:
        vec = int(_vec4(q)) | int(_vec4(k)) << 1 | int(_vec4(v)) << 2
        err = fn(
            device_index(device), _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, s, t, kh, g, hd, hd_v, kv_len, int(causal), scale, vec,
            *q.stride()[:4], k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), stream_handle(device),
        )
    check_error(KERNEL, err, lib.flash_attention_error_string)
    KERNEL.count_launch(route)
    return out


def flash_attention(
    q: torch.Tensor,  # (B, S, K, G, hd)
    k: torch.Tensor,  # (B, T, K, hd)
    v: torch.Tensor,  # (B, T, K, hd_v)
    *,
    causal: bool = True,
    kv_len: Optional[int] = None,  # kv positions ≥ kv_len are masked (None ⇒ T)
) -> torch.Tensor:
    """Flash-attention forward; returns (B, S, K, G, hd_v) in q's dtype."""
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
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    if kv_len < 0:
        raise ValueError(f"kv_len must be >= 0, got {kv_len}")
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, kv_len)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, kv_len=kv_len)
    raise ValueError(f"no flash_attention for device {q.device}")
