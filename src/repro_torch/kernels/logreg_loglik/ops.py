"""Public wrapper of the logistic log-likelihood kernel: shapes, dispatch, gradient.

:func:`logreg_loglik_grad` returns ``(ℓ, ∇ℓ)`` from one pass over X: the
hand-written CUDA kernel (``csrc/logreg_loglik.cu``) for CUDA tensors, the
plain version (``ref.py``) for CPU tensors. :func:`logreg_loglik` is ℓ alone
as a differentiable function of β: a :class:`torch.autograd.Function` whose
forward keeps the fused ∇ℓ, so a value-and-gradient costs one launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import (
    KERNELS,
    check_error,
    check_tensor,
    device_index,
    stream_handle,
)
from repro_torch.kernels.logreg_loglik.ref import logreg_loglik_grad_ref

KERNEL = KERNELS["logreg_loglik_grad"]
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _entry():
    """The loaded library, its entry point with C types set, and the rows
    each block of pass 1 takes (the kernel's own constant)."""
    lib = KERNEL.lib()
    fn = lib.logreg_loglik_grad_f32
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P]
    fn.restype = _I
    lib.logreg_rows_per_block.restype = _I
    lib.logreg_error_string.argtypes = [_I]
    lib.logreg_error_string.restype = ctypes.c_char_p
    return lib, fn, lib.logreg_rows_per_block()


def _launch(X, y, beta, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    G, N, d = X.shape
    C = beta.shape[2]
    device = X.device
    for t, name, nd in ((X, "X", 3), (y, "y", 2), (beta, "beta", 3)):
        check_tensor(t, name, device=device, ndim=nd)
    if N < 1 or G > 65535:
        raise ValueError(f"need 1 <= N and G <= 65535, got N={N}, G={G}")
    lib, fn, rpb = _entry()
    nblk = -(-N // rpb)
    R = C + d * C
    part = torch.empty((G, R, nblk), dtype=torch.float32, device=device)
    out = torch.empty((G, R), dtype=torch.float32, device=device)
    err = fn(
        device_index(device), X.data_ptr(), y.data_ptr(), beta.data_ptr(),
        part.data_ptr(), out.data_ptr(), G, N, d, C, float(scale),
        stream_handle(device),
    )
    check_error(KERNEL, err, lib.logreg_error_string)
    KERNEL.launches += 1
    return out[:, :C], out[:, C:].view(G, d, C)


def logreg_loglik_grad(
    X: torch.Tensor,  # (G, N, d), or (N, d) as in repro
    y: torch.Tensor,  # (G, N), or (N,); in {-1, +1}
    beta: torch.Tensor,  # (G, d, C); with 2-D X: (d,) or (d, C)
    *,
    scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ``(ℓ, ∇ℓ)`` of the logistic likelihood.

    Batched: ``((G, C), (G, d, C))``. With ``repro``'s signature (2-D X):
    ``((), (d,))`` for 1-D beta and ``((C,), (d, C))`` for 2-D beta.
    """
    if X.dim() == 2:
        single = beta.dim() == 1
        b = beta[:, None] if single else beta
        ll, g = logreg_loglik_grad(X[None], y[None], b[None], scale=scale)
        return (ll[0, 0], g[0, :, 0]) if single else (ll[0], g[0])
    if X.dim() != 3 or y.dim() != 2 or beta.dim() != 3:
        raise ValueError(
            f"expected X (G,N,d), y (G,N), beta (G,d,C); got {tuple(X.shape)}, "
            f"{tuple(y.shape)}, {tuple(beta.shape)}"
        )
    G, N, d = X.shape
    if tuple(y.shape) != (G, N) or tuple(beta.shape[:2]) != (G, d):
        raise ValueError(
            f"shape mismatch: X {tuple(X.shape)}, y {tuple(y.shape)}, "
            f"beta {tuple(beta.shape)}"
        )
    if X.device.type == "cuda":
        return _launch(X, y, beta, scale)
    if X.device.type == "cpu":
        return logreg_loglik_grad_ref(X, y, beta, scale=scale)
    raise ValueError(f"no logreg_loglik_grad for device {X.device}")


class LogregLogLik(torch.autograd.Function):
    """ℓ as a function of β; backward reuses the fused ∇ℓ of the forward."""

    @staticmethod
    def forward(ctx, X, y, beta, scale):
        ll, grad = logreg_loglik_grad(X, y, beta, scale=scale)
        ctx.save_for_backward(grad)
        return ll

    @staticmethod
    def backward(ctx, grad_output):
        (grad,) = ctx.saved_tensors
        return None, None, grad_output.unsqueeze(1) * grad, None


def logreg_loglik(
    X: torch.Tensor, y: torch.Tensor, beta: torch.Tensor, *, scale: float = 1.0
) -> torch.Tensor:
    """Differentiable ``ℓ (G, C)`` for X (G, N, d), y (G, N), beta (G, d, C)."""
    return LogregLogLik.apply(X, y, beta, scale)
