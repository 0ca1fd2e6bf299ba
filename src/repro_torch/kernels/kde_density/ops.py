"""Public wrappers of the KDE log-density kernel: shapes, dispatch by device.

CUDA tensors launch the hand-written kernel (``csrc/kde_density.cu``: the
centred cross term as 3xTF32 on the tensor cores); CPU tensors take the
plain versions (``ref.py``). The reference's ``min_kernel_n`` size threshold
and its ``impl``/``interpret`` switches are not carried over. ``h``,
``counts`` and the mixture's log weights stay on the device, so a wrapper
call never waits for the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import (
    KERNELS,
    Kernel,
    check_error,
    check_tensor,
    device_index,
    stream_handle,
)
from repro_torch.kernels.kde_density.ref import (
    kde_log_density_ref,
    machine_kde_log_density_ref,
)

MACHINE_KERNEL = KERNELS["machine_kde_log_density"]
CLOUD_KERNEL = KERNELS["kde_log_density"]
REDUCES = ("none", "product", "mixture", "product_mixture")
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _entry():
    """The loaded library (shared by both kernels) and its entry point."""
    lib = MACHINE_KERNEL.lib()
    fn = lib.kde_machine_log_density_f32
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    lib.kde_machine_splits.argtypes = [_I, _I, _I, _I]
    lib.kde_machine_splits.restype = _I
    lib.kde_scratch_floats.argtypes = [_I, _I, _I]
    lib.kde_scratch_floats.restype = ctypes.c_longlong
    lib.kde_error_string.argtypes = [_I]
    lib.kde_error_string.restype = ctypes.c_char_p
    return lib, fn


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(
    kernel: Kernel,
    queries: torch.Tensor,
    samples: torch.Tensor,
    h: torch.Tensor,
    counts: torch.Tensor,
    logw: Optional[torch.Tensor],
    reduce: str,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    Q, d = queries.shape
    M, T, _ = samples.shape
    device = queries.device
    check_tensor(queries, "queries", device=device, ndim=2)
    check_tensor(samples, "samples", device=device, ndim=3)
    check_tensor(h, "h", device=device, ndim=1)
    if counts.device != device or counts.dtype != torch.int32 or counts.shape != (M,):
        raise ValueError(f"counts must be int32 ({M},) on {device}")
    if samples.shape[2] != d or h.shape != (M,):
        raise ValueError(f"shapes disagree: queries {tuple(queries.shape)}, "
                         f"samples {tuple(samples.shape)}, h {tuple(h.shape)}")
    if min(Q, M, T, d) < 1 or M > 65535:
        raise ValueError(f"need Q, M, T, d >= 1 and M <= 65535; got Q={Q} M={M} T={T} d={d}")
    lib, fn = _entry()
    # the kernel splits each machine's rows S ways when Q alone would not
    # fill the card; one buffer holds the centred TF32 halves of the samples
    # (first: the allocation's alignment is TMA's) and the splits' partial
    # logsumexps
    S = lib.kde_machine_splits(Q, M, T, _num_sms(device_index(device)))
    n_scratch = lib.kde_scratch_floats(M, T, d)
    buf = torch.empty((n_scratch + 2 * S * M * Q,), dtype=torch.float32, device=device)
    scratch, part = buf[:n_scratch], buf[n_scratch:].view(2, S, M, Q)
    lp = torch.empty((M, Q), dtype=torch.float32, device=device)
    prod = mix = None
    if reduce in ("product", "product_mixture"):
        prod = torch.empty((Q,), dtype=torch.float32, device=device)
    if reduce in ("mixture", "product_mixture"):
        mix = torch.empty((Q,), dtype=torch.float32, device=device)
        check_tensor(logw, "logw", device=device, ndim=1)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = fn(
        device_index(device), queries.data_ptr(), samples.data_ptr(), h.data_ptr(),
        counts.data_ptr(), ptr(logw), scratch.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
        lp.data_ptr(), ptr(prod), ptr(mix), Q, M, T, d, S, stream_handle(device),
    )
    check_error(kernel, err, lib.kde_error_string)
    kernel.count_launch()
    if reduce == "none":
        return lp
    if reduce == "product_mixture":
        return prod, mix
    return prod if prod is not None else mix


def machine_kde_log_density(
    queries: torch.Tensor,  # (Q, d)
    samples: torch.Tensor,  # (M, T, d)
    h: torch.Tensor | float,  # (M,) or scalar per-machine bandwidth
    counts: Optional[torch.Tensor] = None,  # (M,) int; None ⇒ all rows valid
    *,
    reduce: str = "none",
    mixture_weights: str = "counts",
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Every machine's KDE log density at every query, in one launch.

    ``reduce="none"`` → (M, Q); ``"product"`` / ``"mixture"`` → (Q,);
    ``"product_mixture"`` → both (Q,) scores. Rows at index ≥ ``counts[m]``
    are never read, so they may hold NaN; an empty machine gives −inf.
    """
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce={reduce!r}")
    if mixture_weights not in ("counts", "uniform"):
        raise ValueError(f"unknown mixture_weights={mixture_weights!r}")
    if queries.dim() != 2 or samples.dim() != 3:
        raise ValueError(f"need queries (Q, d) and samples (M, T, d); got "
                         f"{tuple(queries.shape)} and {tuple(samples.shape)}")
    if queries.device.type == "cpu":
        return machine_kde_log_density_ref(
            queries, samples, h, counts, reduce=reduce, mixture_weights=mixture_weights
        )
    if queries.device.type != "cuda":
        raise ValueError(f"no machine_kde_log_density for device {queries.device}")
    device = queries.device
    queries, samples = queries.contiguous(), samples.contiguous()
    M, T, _ = samples.shape
    h_dev = torch.as_tensor(h, dtype=torch.float32, device=device).reshape(-1).expand(M).contiguous()
    if counts is None:
        counts_dev = torch.full((M,), T, dtype=torch.int32, device=device)
    else:
        counts_dev = torch.as_tensor(counts, device=device).to(torch.int32)
    logw = None
    if reduce in ("mixture", "product_mixture"):
        if mixture_weights == "uniform":
            logw = torch.full((M,), -math.log(M), dtype=torch.float32, device=device)
        else:
            cf = counts_dev.to(torch.float32)
            logw = torch.log(cf) - torch.log(cf.sum())
    return _launch(MACHINE_KERNEL, queries, samples, h_dev, counts_dev, logw, reduce)


def kde_log_density(
    queries: torch.Tensor,  # (nq, d)
    centers: torch.Tensor,  # (ns, d)
    h: torch.Tensor | float,
) -> torch.Tensor:
    """Single-cloud KDE log density (nq,): the machine kernel at M = 1."""
    if queries.dim() != 2 or centers.dim() != 2:
        raise ValueError(f"need queries (nq, d) and centers (ns, d); got "
                         f"{tuple(queries.shape)} and {tuple(centers.shape)}")
    if queries.device.type == "cpu":
        return kde_log_density_ref(queries, centers, h)
    if queries.device.type != "cuda":
        raise ValueError(f"no kde_log_density for device {queries.device}")
    device = queries.device
    queries, centers = queries.contiguous(), centers.contiguous()
    ns = centers.shape[0]
    h_dev = torch.as_tensor(h, dtype=torch.float32, device=device).reshape(1)
    counts = torch.full((1,), ns, dtype=torch.int32, device=device)
    return _launch(CLOUD_KERNEL, queries, centers[None], h_dev, counts, None, "none")[0]
