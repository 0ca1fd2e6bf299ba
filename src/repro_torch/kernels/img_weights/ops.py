"""Public wrappers of the IMG log-weight kernel: dispatch by the tensor's device.

CUDA tensors launch the hand-written kernel (``csrc/img_weights.cu``); CPU
tensors take the plain versions (``ref.py``). The kernel has two routes,
counted apart in ``KERNEL.route_launches`` (``KERNEL.launches`` counts both):

``"generic"`` — :func:`img_log_weights`
    Eq. 3.5 for P given candidate states ``(P, M, d)``. ``h`` may be a float
    or a one-element tensor; on the card it is read by the kernel from device
    memory, so a bandwidth computed on the device never has to reach the host.

``"sweep"`` — :func:`img_sweep`
    One whole kernel-mode IMG sweep of B chains in one launch: one block a
    chain gathers its M candidates, scores every single-site state with the
    generic route's arithmetic, forms the Gram of the deltas and runs the
    site recursion, then writes the new carry. For the semiparametric ``W_t``
    it takes the state term as one Cholesky factor (:class:`StateTerm`). One
    block holds the chain's state and candidates in shared memory, so
    ``2·M·d`` floats plus the W_t terms must fit in one block
    (:func:`sweep_smem_bytes`); beyond that the wrapper raises ``ValueError``.
    There is no other route for it.

Tolerance: the sweep route scores each single-site state as the generic
route does (the same function of the same rows, within float32 rounding of
the plain version: rtol 1e-5, atol 1e-3 on log weights); its site recursion
adds the same terms in the plain version's order, but its Gram, SSE and, for
W_t, its triangular solves (M + 1 of them a sweep, combined by linearity in
place of one solve a site, their squares taken through the solves' Gram)
round otherwise. An accept decision can therefore
differ from the plain version's only where ``log u`` falls within that
rounding of the plain log ratio. A fixed input gives the same bits on every
launch (no atomics).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.kernels import (
    KERNELS,
    check_error,
    check_tensor,
    device_index,
    stream_handle,
)
from repro_torch.kernels.img_weights.ref import ImgSweep, img_log_weights_ref, img_sweep_ref

KERNEL = KERNELS["img_log_weights"]
ROUTES = ("generic", "sweep")
KERNEL.route_launches.update({route: 0 for route in ROUTES})
MAX_SMEM_BYTES = 232_448  # dynamic shared memory one H100 block may take
SWEEP_RTOL, SWEEP_ATOL = 1e-5, 1e-3  # on log weights, as the generic route
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


class StateTerm(NamedTuple):
    """The semiparametric state term ``log N(θ̄ | μ̂_M, Σ̂_M + h²/M·I)`` at one
    bandwidth: ``chol (d, d)`` the lower Cholesky factor of the covariance,
    ``logdet`` its log-determinant (one element), ``mean (d,)`` μ̂_M."""

    chol: torch.Tensor
    logdet: torch.Tensor
    mean: torch.Tensor


def sweep_smem_bytes(M: int, d: int, wt: bool) -> int:
    """Shared memory one sweep block takes: the state and the candidates
    (2·M·d floats), the mean, the Gram and seven per-site vectors, and for W_t
    the factor (d²) and its diagonal's reciprocals, the M + 1 solves, their
    Gram and one more per-site vector."""
    floats = 2 * M * d + d + M * M + 7 * M
    if wt:
        floats += d * d + d + (M + 1) * d + (M + 1) ** 2 + M
    return 4 * floats


def check_sweep_fits(M: int, d: int, wt: bool) -> None:
    """Raise ``ValueError`` when one sweep block cannot hold the chain."""
    need = sweep_smem_bytes(M, d, wt)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"img_sweep: one chain at M={M}, d={d}{' with the W_t terms' if wt else ''} needs "
            f"{need} bytes of shared memory, more than one block can hold ({MAX_SMEM_BYTES})"
        )


@functools.cache
def _entry():
    """The loaded library and its entry points with C types set."""
    lib = KERNEL.lib()
    fn = lib.img_log_weights_f32
    fn.argtypes = [_I, _P, _P, _P, _I, _I, _I, _P]
    fn.restype = _I
    sweep = lib.img_sweep_f32
    sweep.argtypes = [_I, _P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float,
                      _P, _L, _P, _L, _L, _P, _P, *[_P] * 9, _I, _I, _I, _P]
    sweep.restype = _I
    lib.img_sweep_smem_bytes.argtypes = [_I, _I, _I]
    lib.img_sweep_smem_bytes.restype = _L
    lib.img_error_string.argtypes = [_I]
    lib.img_error_string.restype = ctypes.c_char_p
    return lib, fn, sweep


def _launch(theta: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    P, M, d = theta.shape
    device = theta.device
    check_tensor(theta, "theta", device=device, ndim=3)
    check_tensor(h, "h", device=device, ndim=1)
    if P < 1 or M < 1 or d < 1 or h.numel() != 1:
        raise ValueError(f"need P, M, d >= 1 and one h; got {tuple(theta.shape)}, h {tuple(h.shape)}")
    lib, fn, _ = _entry()
    out = torch.empty((P,), dtype=torch.float32, device=device)
    err = fn(
        device_index(device), theta.data_ptr(), h.data_ptr(), out.data_ptr(),
        P, M, d, stream_handle(device),
    )
    check_error(KERNEL, err, lib.img_error_string)
    KERNEL.count_launch("generic")
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


def _check_sweep_shapes(carry, samples, c, u, aux, state_term) -> None:
    """Shapes and index dtypes every device requires of a sweep."""
    if samples.dim() != 3:
        raise ValueError(f"samples must be (M, T, d), got {tuple(samples.shape)}")
    M, T, d = samples.shape
    t_idx, theta_sel, mean, sumsq, extra, n_accept = carry
    B = mean.shape[0] if mean.dim() == 2 else -1
    want = {"t_idx": (t_idx, (B, M)), "theta_sel": (theta_sel, (B, M, d)),
            "mean": (mean, (B, d)), "sumsq": (sumsq, (B,)), "extra": (extra, (B,)),
            "n_accept": (n_accept, (B,)), "c": (c, (B, M)), "u": (u, (B, M))}
    if aux is not None:
        want["aux"] = (aux, (M, T))
    if state_term is not None:
        want["chol"] = (state_term.chol, (d, d))
        want["state mean"] = (state_term.mean, (d,))
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"img_sweep: {name} is {tuple(x.shape)}, expected {shape} for "
                             f"samples {tuple(samples.shape)} and mean {tuple(mean.shape)}")
    if state_term is not None and state_term.logdet.numel() != 1:
        raise ValueError(f"img_sweep: logdet must hold one value, got {tuple(state_term.logdet.shape)}")
    for name, x in (("t_idx", t_idx), ("c", c)):
        if x.dtype != torch.int64:
            raise TypeError(f"img_sweep: {name} must be int64, got {x.dtype}")


def _launch_sweep(carry, samples, c, u, h, aux, state_term: Optional[StateTerm]) -> ImgSweep:
    M, T, d = samples.shape
    t_idx, theta_sel, mean, sumsq, extra, n_accept = carry
    B = mean.shape[0]
    device = samples.device
    floats = {"theta_sel": (theta_sel, 3), "mean": (mean, 2), "sumsq": (sumsq, 1),
              "extra": (extra, 1), "n_accept": (n_accept, 1), "u": (u, 2)}
    if state_term is not None:
        floats.update({"logdet": (state_term.logdet.reshape(1), 1), "state mean": (state_term.mean, 1)})
    for name, (x, ndim) in floats.items():
        check_tensor(x, name, device=device, ndim=ndim)
    for name, x in (("t_idx", t_idx), ("c", c)):
        if x.device != device or not x.is_contiguous():
            raise ValueError(f"img_sweep: {name} must be contiguous on {device}")
    strided = {"samples": samples, "aux": aux,
               "chol": None if state_term is None else state_term.chol}
    for name, x in strided.items():
        if x is None:
            continue
        if x.device != device:
            raise ValueError(f"img_sweep: {name} is on {x.device}, expected {device}")
        if x.dtype != torch.float32:
            raise TypeError(f"img_sweep: {name} must be float32, got {x.dtype}")
        if name != "chol" and x.stride(-1) != 1:
            raise ValueError(f"img_sweep: {name}'s last axis must be contiguous")
    if min(B, M, T, d) < 1:
        raise ValueError(f"img_sweep: need B, M, T, d >= 1; got B={B}, samples {tuple(samples.shape)}")
    check_sweep_fits(M, d, state_term is not None)
    if isinstance(h, torch.Tensor) and h.device.type == "cuda":
        check_tensor(h.reshape(1), "h", device=device, ndim=1)
        h_ptr, h_val = h.data_ptr(), 0.0
    else:  # a host value goes by value: no copy to the card
        h_ptr, h_val = None, float(h)
    lib, _, fn = _entry()
    out = ImgSweep(
        t_idx=torch.empty((B, M), dtype=torch.int64, device=device),
        theta_sel=torch.empty((B, M, d), dtype=torch.float32, device=device),
        mean=torch.empty((B, d), dtype=torch.float32, device=device),
        sumsq=torch.empty((B,), dtype=torch.float32, device=device),
        extra=torch.empty((B,), dtype=torch.float32, device=device),
        n_accept=torch.empty((B,), dtype=torch.float32, device=device),
        lw_base=torch.empty((B, M), dtype=torch.float32, device=device),
        log_ratio=torch.empty((B, M), dtype=torch.float32, device=device),
        accept=torch.empty((B, M), dtype=torch.bool, device=device),
    )
    wt = state_term is not None
    chol = state_term.chol if wt else None
    err = fn(
        device_index(device), samples.data_ptr(), samples.stride(0), samples.stride(1),
        t_idx.data_ptr(), theta_sel.data_ptr(), mean.data_ptr(), sumsq.data_ptr(),
        extra.data_ptr(), n_accept.data_ptr(), c.data_ptr(), u.data_ptr(), h_ptr, h_val,
        aux.data_ptr() if wt and aux is not None else None, aux.stride(0) if aux is not None else 0,
        chol.data_ptr() if wt else None, chol.stride(0) if wt else 0, chol.stride(1) if wt else 0,
        state_term.logdet.data_ptr() if wt else None, state_term.mean.data_ptr() if wt else None,
        *(x.data_ptr() for x in out), B, M, d, stream_handle(device),
    )
    check_error(KERNEL, err, lib.img_error_string)
    KERNEL.count_launch("sweep")
    return out


def img_sweep(
    carry,
    samples: torch.Tensor,
    c: torch.Tensor,
    u: torch.Tensor,
    h: torch.Tensor | float,
    *,
    aux: Optional[torch.Tensor] = None,
    extra_lw: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    state_term: Optional[StateTerm] = None,
) -> ImgSweep:
    """One kernel-mode IMG sweep of B chains (see :func:`img_sweep_ref`).

    ``carry``: ``(t_idx (B, M) int64, theta_sel (B, M, d), mean (B, d),
    sumsq (B,), extra (B,), n_accept (B,))``; ``c (B, M)`` int64 proposals
    below each machine's count, ``u (B, M)`` uniforms, ``h`` one bandwidth.
    The W_t state term comes in the form each route takes: on the card as
    ``state_term`` (one Cholesky factor), on the CPU as the callable
    ``extra_lw`` (the plain version's); ``aux (M, T)`` is its per-sample
    table. With neither the weights are w_t.
    """
    _check_sweep_shapes(tuple(carry), samples, c, u, aux, state_term)
    if samples.device.type == "cuda":
        if extra_lw is not None:
            raise ValueError("img_sweep: on the card the W_t term comes as state_term "
                             "(one Cholesky factor), not as a callable")
        return _launch_sweep(tuple(carry), samples, c, u, h, aux, state_term)
    if samples.device.type == "cpu":
        if state_term is not None:
            raise ValueError("img_sweep: on the CPU the W_t term comes as the callable "
                             "extra_lw, not as state_term")
        return img_sweep_ref(carry, samples, c, u, h, aux, extra_lw)
    raise ValueError(f"no img_sweep for device {samples.device}")


def sweep_agreement(got: ImgSweep, want: ImgSweep, u: torch.Tensor) -> dict:
    """How a sweep ``got`` (the kernel's) agrees with ``want`` (the plain
    version's) on the same carry and draws, ``u`` the sweep's uniforms.

    ``lw_base`` within rtol ``SWEEP_RTOL`` and atol ``SWEEP_ATOL``. A site is
    *clear* when the plain margin ``|log u − log_ratio|`` exceeds four times
    that tolerance at its ``lw_base``; only a site inside the margin may take
    another decision, and the chain's later sites then start from another
    state, so such a chain is counted as ``diverged`` and left out of the
    carry check. Every other chain's carry must agree: indices, rows and
    accept counts exactly, ``mean`` within 1e-5 (values of size ~1),
    ``sumsq`` within rtol 1e-5, ``extra`` within rtol 1e-4 (the W_t per-sample
    sums, ~1e3; float32 sums in another order). Returns ``ok`` and the
    numbers behind it.
    """
    f64 = {name: (a.double(), b.double()) for name, a, b in zip(ImgSweep._fields, got, want)
           if a.is_floating_point()}
    lw, lw_w = f64["lw_base"]
    scale = SWEEP_ATOL + SWEEP_RTOL * lw_w.abs()
    lw_err = (lw - lw_w).abs()
    clear = (torch.log(u.double()) - f64["log_ratio"][1]).abs() > 4.0 * scale
    differ = got.accept != want.accept
    first = differ.to(torch.int8).argmax(dim=1)
    diverged = differ.any(dim=1)
    flag_faults = int((diverged & clear.gather(1, first[:, None])[:, 0]).sum())
    keep = ~diverged
    carry_faults = 0
    for name in ("t_idx", "theta_sel", "n_accept"):
        a, b = getattr(got, name)[keep], getattr(want, name)[keep]
        carry_faults += int(not torch.equal(a, b))
    for name, rtol, atol in (("mean", 0.0, 1e-5), ("sumsq", 1e-5, 0.0), ("extra", 1e-4, 0.0)):
        a, b = (x[keep] for x in f64[name])
        carry_faults += int(not bool(((a - b).abs() <= atol + rtol * b.abs()).all()))
    mean_err = (f64["mean"][0] - f64["mean"][1])[keep].abs()
    return {
        "ok": bool((lw_err <= scale).all()) and flag_faults == 0 and carry_faults == 0
        and bool(torch.isfinite(lw).all()),
        "lw_max_abs_err": float(lw_err.max()),
        "sites": int(clear.numel()),
        "inside_margin": int((~clear).sum()),
        "accepted": int(want.accept.sum()),
        "diverged_chains": int(diverged.sum()),
        "flag_faults": flag_faults,
        "carry_faults": carry_faults,
        "mean_max_abs_err": float(mean_err.max()) if mean_err.numel() else 0.0,
    }
