"""Public wrapper of the fused online-moments update: dispatch by the tensor's device.

CUDA tensors launch the hand-written kernel (``csrc/online_update.cu``), one
launch per fold for all M machines; CPU tensors take the plain version
(``ref.py``). The reference wrapper's ``C < 32`` fallback to its jnp version
and its padding of C and d to lane multiples are not carried over: the
kernel takes any C ≥ 0 and d ≥ 1 and masks its own edges. The chunk may be a
``(M, C, d)`` slice of a longer ``(M, T, d)`` draw buffer (rows contiguous,
any machine stride), which the fused stream folds without a copy.

The kernel has two routes, chosen by :func:`_plan` before the launch and
counted apart in ``KERNEL.route_launches`` (``KERNEL.launches`` counts both):
``"whole"`` copies a machine's C rows into shared memory at once when they
fit :data:`WHOLE_BUDGET` bytes with the rest of the block's state, and
``"slab"`` streams them through a ring of slabs otherwise. Both add the same
numbers in the same order, so they give the same bits.

Tolerance (the ``online`` combiner's merge-rounding contract, as in
``repro/kernels/online_update/ops.py``): the kernel sums the chunk mean and
the centred Gram in another order than the plain version, so the two agree
to float32 rounding per fold, never bitwise. A fixed input gives the same
bits on every run (no float atomics). Streams that need bitwise agreement
with the batch combiners use the buffered combiners.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import (
    KERNELS,
    check_error,
    check_tensor,
    device_index,
    stream_handle,
)
from repro_torch.kernels.online_update.ref import online_moments_update_ref

KERNEL = KERNELS["online_update"]
ROUTES = ("whole", "slab")
KERNEL.route_launches.update({route: 0 for route in ROUTES})
_P = ctypes.c_void_p
_I = ctypes.c_int

# The kernel's shared-memory layout (csrc/online_update.cu, smem_floats),
# which decides the route; the kernel derives its bytes itself
# (online_update_smem_bytes, held equal to smem_bytes by the card tests)
THREADS = 512  # a block
TILE = 16  # m2 tile edge
GROUPS = 8  # row groups of a tile's Gram
PARTS = 8  # partial sums a column of the chunk mean
SLAB_ROWS = 256  # rows a slab of the slab route
SLOTS = 2 * TILE  # a tile's columns: its row set and its column set
WHOLE_BUDGET = 96 * 1024  # the whole route's bytes at most: two blocks an SM


class Plan(NamedTuple):
    """A launch: the route, blocks a machine (one per upper-triangle tile of
    m2; the grid is ``(blocks, M)``), and a block's dynamic shared memory in
    bytes. Only the route crosses to the kernel, which derives the grid and
    the bytes itself."""

    route: str
    blocks: int
    smem: int


def _up4(n: int) -> int:
    return (n + 3) & ~3


def smem_bytes(route: str, C: int, d: int) -> int:
    """Dynamic shared memory a block of ``route`` needs at C rows of d."""
    if route == "whole":
        lead = _up4(C * d + 3 + TILE)  # the span, shifted to its alignment, + pad
    else:
        lead = 2 * SLAB_ROWS * SLOTS  # the two-stage ring
    return 4 * (lead + (2 + PARTS) * SLOTS + 2 * TILE * TILE + GROUPS * TILE * (TILE + 1))


@functools.lru_cache(maxsize=256)
def _plan(M: int, C: int, d: int) -> Plan:
    """The launch for ``M`` machines of ``C`` rows of ``d``: the whole route
    when C rows fit :data:`WHOLE_BUDGET` (chunk counts only shorten a
    machine's span), the slab route otherwise; one block per upper-triangle
    16×16 tile of m2 per machine on either. Where a machine's span starts
    (its alignment, hence its copy width) is the kernel's to see, not the
    plan's."""
    del M  # the grid is (blocks, M) whatever M is
    tiles = -(-d // TILE)
    blocks = tiles * (tiles + 1) // 2
    whole = smem_bytes("whole", C, d)
    if whole <= WHOLE_BUDGET:
        return Plan("whole", blocks, whole)
    return Plan("slab", blocks, smem_bytes("slab", C, d))


@functools.cache
def _entry():
    """The loaded library and its entry point with C types set."""
    lib = KERNEL.lib()
    fn = lib.online_update_f32
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong,
                   _I, _P]
    fn.restype = _I
    lib.online_update_smem_bytes.argtypes = [_I, _I, _I]
    lib.online_update_smem_bytes.restype = ctypes.c_longlong
    lib.online_update_error_string.argtypes = [_I]
    lib.online_update_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(count, mean, m2, chunk, chunk_counts, route: Optional[str] = None):
    """Check, launch and count. ``route`` overrides the plan's, for the card
    tests' check that both routes give the same bits."""
    M, C, d = chunk.shape
    device = chunk.device
    if chunk.dtype != torch.float32:
        raise TypeError(f"chunk must be float32 on {device}, got {chunk.dtype}")
    if C > 1 and chunk.stride(1) != d or d > 1 and chunk.stride(2) != 1:
        raise ValueError(f"chunk rows must be contiguous, got strides {chunk.stride()}")
    check_tensor(count, "count", device=device, ndim=1)
    check_tensor(mean, "mean", device=device, ndim=2)
    check_tensor(m2, "m2", device=device, ndim=3)
    if count.shape != (M,) or mean.shape != (M, d) or m2.shape != (M, d, d):
        raise ValueError(
            f"shapes disagree: chunk {tuple(chunk.shape)}, count {tuple(count.shape)}, "
            f"mean {tuple(mean.shape)}, m2 {tuple(m2.shape)}"
        )
    if M < 1 or d < 1 or M > 65535:
        raise ValueError(f"need 1 <= M <= 65535 and d >= 1; got M={M} d={d}")
    cc_ptr = None
    if chunk_counts is not None:
        cc = chunk_counts
        if not (isinstance(cc, torch.Tensor) and cc.dtype == torch.int32
                and cc.device == device and cc.is_contiguous()):
            cc = torch.as_tensor(chunk_counts, device=device).to(torch.int32).contiguous()
        if cc.shape != (M,):
            raise ValueError(f"chunk_counts must be ({M},), got {tuple(cc.shape)}")
        cc_ptr = cc.data_ptr()
    if route is None:
        route = _plan(M, C, d).route
    lib, fn = _entry()
    count_out = torch.empty_like(count)
    mean_out = torch.empty_like(mean)
    m2_out = torch.empty_like(m2)
    err = fn(
        device_index(device), chunk.data_ptr(), cc_ptr, count.data_ptr(), mean.data_ptr(),
        m2.data_ptr(), count_out.data_ptr(), mean_out.data_ptr(), m2_out.data_ptr(),
        M, C, d, chunk.stride(0), ROUTES.index(route), stream_handle(device),
    )
    check_error(KERNEL, err, lib.online_update_error_string)
    KERNEL.count_launch(route)
    return count_out, mean_out, m2_out


def online_moments_update(
    count: torch.Tensor,  # (M,)
    mean: torch.Tensor,  # (M, d)
    m2: torch.Tensor,  # (M, d, d)
    chunk: torch.Tensor,  # (M, C, d)
    chunk_counts: Optional[torch.Tensor] = None,  # (M,) valid prefix (None ⇒ C)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold a dense ``(M, C, d)`` chunk into running ``(count, mean, m2)``.

    Returns new tensors; the inputs are not written. On the card every
    operand must be float32 and on the chunk's device, the state contiguous
    and the chunk's rows contiguous.
    """
    if chunk.dim() != 3:
        raise ValueError(f"chunk must be (M, C, d), got {tuple(chunk.shape)}")
    if chunk.device.type == "cuda":
        return _launch(count, mean, m2, chunk, chunk_counts)
    if chunk.device.type == "cpu":
        return online_moments_update_ref(count, mean, m2, chunk, chunk_counts)
    raise ValueError(f"no online_moments_update for device {chunk.device}")
