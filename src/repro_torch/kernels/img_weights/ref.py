"""Plain PyTorch versions of the IMG mixture log-weights (paper Eq. 3.5) and
of one kernel-mode IMG sweep.

The counterpart of ``repro/kernels/img_weights/ref.py``: for P candidate
components ``theta (P, M, d)`` (one selected sample per machine),

    log w_p = −SSE_p / (2h²) − M·(d/2)·log(2π h²),
    SSE_p   = Σ_m ‖θ_pm − θ̄_p‖².

:func:`img_sweep_ref` is one sweep of the IMG engine's ``"kernel"`` weight
mode for B chains, the counterpart of ``repro/core/combiners/img.py``'s
``_img_kernel_sweep`` with its draws given: every single-site candidate state
scored in one batch, then the site recursion through the exact rank-one
correction (see :mod:`repro_torch.core.combiners.img`).

Both serve the CPU path and the tests; on the card the two routes of the
hand-written kernel compute the same functions.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch


class ImgSweep(NamedTuple):
    """One sweep's result: the chains' new carry, then per-site diagnostics."""

    t_idx: torch.Tensor  # (B, M) int64
    theta_sel: torch.Tensor  # (B, M, d)
    mean: torch.Tensor  # (B, d)
    sumsq: torch.Tensor  # (B,)
    extra: torch.Tensor  # (B,)
    n_accept: torch.Tensor  # (B,)
    lw_base: torch.Tensor  # (B, M) log weight of the state with row m replaced
    log_ratio: torch.Tensor  # (B, M) lw_prop − lw_cur at site m
    accept: torch.Tensor  # (B, M) bool


def img_log_weights_ref(theta: torch.Tensor, h: torch.Tensor | float) -> torch.Tensor:
    """theta (P, M, d), scalar h → (P,) float32 log weights."""
    theta = theta.float()
    h = torch.as_tensor(h, dtype=torch.float32, device=theta.device).reshape(())
    mean = theta.mean(dim=1, keepdim=True)
    sse = ((theta - mean) ** 2).sum(dim=(1, 2))
    m, d = theta.shape[1], theta.shape[2]
    return -0.5 * sse / (h * h) - m * (d / 2.0) * torch.log(2.0 * math.pi * h * h)


def img_sweep_ref(
    carry,
    samples: torch.Tensor,
    c: torch.Tensor,
    u: torch.Tensor,
    h: torch.Tensor | float,
    aux: Optional[torch.Tensor] = None,
    extra_lw: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
) -> ImgSweep:
    """One sweep for B chains from their ``carry`` (fields ``t_idx (B, M)``,
    ``theta_sel (B, M, d)``, ``mean (B, d)``, ``sumsq``, ``extra``,
    ``n_accept (B,)``), index proposals ``c (B, M)`` and uniforms ``u (B, M)``.

    ``extra_lw(mean (B, d), extra (B,)) -> (B,)``, the state-level term of
    the semiparametric ``W_t`` (None ⇒ the ``w_t`` weights), and ``aux (M, T)``
    its per-sample table (None ⇒ 0).
    """
    t_idx, theta_sel, mean, sumsq, extra, n_accept = carry
    M, T, d = samples.shape
    B = mean.shape[0]
    dev, dtype = samples.device, samples.dtype
    rows = torch.arange(M, device=dev)[None, :]

    cand = samples[rows, c]  # (B, M, d): cand[b, m] = samples[m, c[b, m]]
    delta = cand - theta_sel
    nsq = (cand**2).sum(dim=-1) - (theta_sel**2).sum(dim=-1)  # (B, M)
    b_dot = torch.einsum("bd,bmd->bm", mean, delta)  # θ̄₀·Δ_m
    gram = torch.einsum("bmd,bnd->bmn", delta, delta)  # Δ_j·Δ_m
    msq0 = (mean**2).sum(dim=-1)

    h32 = torch.as_tensor(h).to(torch.float32)
    inv2h2 = 0.5 / (h32 * h32)
    log_norm = M * (d / 2.0) * torch.log(2.0 * math.pi * h32 * h32)

    # every single-site candidate state of every chain, scored in one batch
    eye = torch.eye(M, dtype=dtype, device=dev)[None, :, :, None]  # (1, prop, machine, 1)
    theta_prop = (1.0 - eye) * theta_sel[:, None, :, :] + eye * cand[:, :, None, :]
    lw_base = img_log_weights_ref(theta_prop.reshape(B * M, M, d), h32).reshape(B, M)

    lw_cur = -(sumsq - M * msq0) * inv2h2 - log_norm
    semip = extra_lw is not None
    if semip:
        if aux is not None:
            delta_aux = (aux[rows, c] - aux[rows, t_idx]).to(torch.float32)
        else:
            delta_aux = torch.zeros((B, M), dtype=torch.float32, device=dev)
        lw_cur = lw_cur + extra_lw(mean, extra)
        s_vec = torch.zeros((B, d), dtype=dtype, device=dev)
        acc_aux = torch.zeros((B,), dtype=torch.float32, device=dev)

    zeros_b = torch.zeros((B,), dtype=torch.float32, device=dev)
    acc_nsq, s_b, s_g, n_acc = zeros_b, zeros_b, zeros_b, zeros_b
    g = torch.zeros((B, M), dtype=torch.float32, device=dev)
    a_mask = torch.zeros((B, M), dtype=torch.bool, device=dev)
    log_u = torch.log(u)
    ratios = []
    for m in range(M):
        g_m = g[:, m]
        corr = -(acc_nsq - 2.0 * s_b - (s_g + 2.0 * g_m) / M) * inv2h2
        lw_prop = lw_base[:, m] + corr
        if semip:
            mean_m = mean + (s_vec + delta[:, m]) / M  # candidate θ̄
            extra_m = extra + acc_aux + delta_aux[:, m]
            lw_prop = lw_prop + extra_lw(mean_m, extra_m)
        ratios.append(lw_prop - lw_cur)
        accept = log_u[:, m] < ratios[-1]
        af = accept.to(torch.float32)
        lw_cur = torch.where(accept, lw_prop, lw_cur)
        acc_nsq = acc_nsq + af * nsq[:, m]
        s_b = s_b + af * b_dot[:, m]
        s_g = s_g + af * (2.0 * g_m + gram[:, m, m])
        g = g + af[:, None] * gram[:, m, :]
        if semip:
            s_vec = s_vec + af[:, None] * delta[:, m]
            acc_aux = acc_aux + af * delta_aux[:, m]
        a_mask[:, m] = accept
        n_acc = n_acc + af

    af = a_mask.to(dtype)
    return ImgSweep(
        t_idx=torch.where(a_mask, c, t_idx),
        theta_sel=torch.where(a_mask[:, :, None], cand, theta_sel),
        mean=mean + torch.einsum("bm,bmd->bd", af, delta) / M,
        sumsq=sumsq + (af * nsq).sum(dim=-1),
        extra=extra + acc_aux if semip else extra,
        n_accept=n_accept + n_acc,
        lw_base=lw_base,
        log_ratio=torch.stack(ratios, dim=1),
        accept=a_mask,
    )
