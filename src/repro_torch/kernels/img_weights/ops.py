"""Public wrapper of the IMG log-weight kernel: dispatch by the tensor's device.

CUDA tensors launch the hand-written kernel (``csrc/img_weights.cu``); CPU
tensors take the plain version (``ref.py``). ``h`` may be a float or a
one-element tensor; on the card it is read by the kernel from device memory,
so a bandwidth computed on the device never has to reach the host.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (
    KERNELS,
    check_error,
    check_tensor,
    device_index,
    stream_handle,
)
from repro_torch.kernels.img_weights.ref import img_log_weights_ref

KERNEL = KERNELS["img_log_weights"]
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _entry():
    """The loaded library and its entry point with C types set."""
    lib = KERNEL.lib()
    fn = lib.img_log_weights_f32
    fn.argtypes = [_I, _P, _P, _P, _I, _I, _I, _P]
    fn.restype = _I
    lib.img_error_string.argtypes = [_I]
    lib.img_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(theta: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    P, M, d = theta.shape
    device = theta.device
    check_tensor(theta, "theta", device=device, ndim=3)
    check_tensor(h, "h", device=device, ndim=1)
    if P < 1 or M < 1 or d < 1 or h.numel() != 1:
        raise ValueError(f"need P, M, d >= 1 and one h; got {tuple(theta.shape)}, h {tuple(h.shape)}")
    lib, fn = _entry()
    out = torch.empty((P,), dtype=torch.float32, device=device)
    err = fn(
        device_index(device), theta.data_ptr(), h.data_ptr(), out.data_ptr(),
        P, M, d, stream_handle(device),
    )
    check_error(KERNEL, err, lib.img_error_string)
    KERNEL.launches += 1
    return out


def img_log_weights(theta: torch.Tensor, h: torch.Tensor | float) -> torch.Tensor:
    """theta (P, M, d) float32, scalar h → (P,) float32 log weights."""
    if theta.dim() != 3:
        raise ValueError(f"theta must be (P, M, d), got {tuple(theta.shape)}")
    if theta.device.type == "cuda":
        h_dev = torch.as_tensor(h, dtype=torch.float32, device=theta.device).reshape(1)
        return _launch(theta, h_dev)
    if theta.device.type == "cpu":
        return img_log_weights_ref(theta, h)
    raise ValueError(f"no img_log_weights for device {theta.device}")
