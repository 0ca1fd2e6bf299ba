"""The shared IMG engine behind the asymptotically exact combiners (§3.2/§3.3).

The port of ``repro/core/combiners/img.py``: one Algorithm-1 core,
parameterized by a weight model (:class:`ImgWeightModel`) —

- nonparametric ``w_t`` (Eq. 3.5) with Gaussian KDE components       — §3.2
- semiparametric ``W_t`` (Hjort–Glad correction)                      — §3.3
- semiparametric components with ``w_t`` weights                      — §3.3

B index-chains run at once, batched by construction (the reference
``vmap``\\ s them), each ``ceil(n_draws/B)`` sweeps long. Two ways to score a
sweep's proposals (``weight_eval``):

``"incremental"``
    Sites in turn, each proposal scored in O(d) from the running mean θ̄ and
    Σ_m‖θ_m‖², using Σ_m ‖θ_m − θ̄‖² = Σ_m ‖θ_m‖² − M·‖θ̄‖². Chain b's sweep
    i anneals at the global index i·B + b + 1, as the serial chain would.

``"kernel"``
    All M single-site candidates of all B chains drawn up front and scored
    in one launch of the ``img_log_weights`` kernel on ``(B·M, M, d)``
    candidate states built here; the site recursion then runs on O(M)
    scalars per chain through the exact rank-one correction

        log w(state_J ∪ {m}) = LW_m − (1/2h²)·[A − 2·s_B − (s_G + 2·g_m)/M]

    (LW_m the kernel's base-state weight of the single-site change, A, s_B,
    s_G, g_m running sums over the accepted set J from the Gram matrix of
    the deltas; see the reference's module docstring). Full semiparametric
    ``W_t`` also carries the accepted delta sum S ``(B, d)`` and δaux sum.
    All chains of a sweep share h at the block's most-annealed index.

Index proposals ``randint(0, counts[m])`` are drawn as ``floor(u·counts[m])``
clamped to ``counts[m] − 1``: the per-machine bound torch's ``randint`` lacks.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.combiners.api import (
    CombineResult,
    counts_or_full,
    register,
    resolve_schedule as _resolve_schedule,
    valid_masks,
)
from repro_torch.core.gaussian import (
    GaussianMoments,
    cholesky,
    fit_moments,
    log_normal_pdf,
    product_moments,
)
from repro_torch.kernels.img_weights import img_log_weights

Schedule = Callable[[torch.Tensor], torch.Tensor]
_LOG2PI = math.log(2.0 * math.pi)


class ImgWeightModel(NamedTuple):
    """What varies between §3.2 and §3.3, batched over B chains.

    ``aux (M, T)``: per-sample additive log-weight terms (semiparametric
    −log N(θ^m_t | μ̂_m, Σ̂_m); None ⇒ 0). ``extra_logweight(h (B,))`` builds
    ``term(mean (B, d), extra_sum (B,)) -> (B,)``, the state-level additive
    log-weight (None ⇒ 0). ``draw(gen, mean (B, d), h (B,)) -> (B, d)``: one
    draw from each chain's selected mixture component.
    """

    aux: Optional[torch.Tensor]
    extra_logweight: Optional[Callable[[torch.Tensor], Callable]]
    draw: Callable[[torch.Generator, torch.Tensor, torch.Tensor], torch.Tensor]
    moments: Optional[GaussianMoments]


class _ImgCarry(NamedTuple):
    """State of B index-chains."""

    t_idx: torch.Tensor  # (B, M) current component indices
    theta_sel: torch.Tensor  # (B, M, d) samples[m, t_idx[:, m]]
    mean: torch.Tensor  # (B, d) running θ̄_t
    sumsq: torch.Tensor  # (B,) running Σ_m ‖θ^m_{t_m}‖²
    extra: torch.Tensor  # (B,) running Σ_m aux[m, t_m] (0 without aux)
    n_accept: torch.Tensor  # (B,) accepted proposals


def _randint_below(gen: torch.Generator, shape, counts: torch.Tensor) -> torch.Tensor:
    """Uniform integers in ``[0, counts)``, ``counts`` broadcast against ``shape``."""
    u = torch.rand(shape, generator=gen, device=counts.device)
    return torch.minimum((u * counts).long(), counts.long() - 1)


def _init_img_carry(
    gen: torch.Generator,
    samples: torch.Tensor,
    counts: torch.Tensor,
    aux: Optional[torch.Tensor],
    n_chains: int,
) -> _ImgCarry:
    M = samples.shape[0]
    rows = torch.arange(M, device=samples.device)[None, :]
    t0 = _randint_below(gen, (n_chains, M), counts)  # Alg 1 line 1
    theta_sel = samples[rows, t0]
    zeros = torch.zeros((n_chains,), dtype=samples.dtype, device=samples.device)
    return _ImgCarry(
        t_idx=t0,
        theta_sel=theta_sel,
        mean=theta_sel.mean(dim=1),
        sumsq=(theta_sel**2).sum(dim=(1, 2)),
        extra=zeros if aux is None else aux[rows, t0].sum(dim=-1),
        n_accept=zeros,
    )


def _img_gibbs_sweep(
    gen: torch.Generator,
    carry: _ImgCarry,
    samples: torch.Tensor,
    counts: torch.Tensor,
    h: torch.Tensor,  # (B,)
    aux: Optional[torch.Tensor],
    extra_lw: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]],
) -> _ImgCarry:
    """One sweep of Alg 1 lines 4–11 for B chains: each site m in turn."""
    M = samples.shape[0]
    B = carry.mean.shape[0]
    inv_m = 1.0 / M

    def log_w(mean, sumsq, extra):
        lw = -0.5 * (sumsq - M * (mean**2).sum(dim=-1)) / h**2
        if extra_lw is not None:
            lw = lw + extra_lw(mean, extra)
        return lw

    t_idx, theta_sel = carry.t_idx.clone(), carry.theta_sel.clone()
    mean, sumsq, extra, n_acc = carry.mean, carry.sumsq, carry.extra, carry.n_accept
    for m in range(M):
        c_m = _randint_below(gen, (B,), counts[m])  # line 6
        theta_new = samples[m, c_m]
        theta_old = theta_sel[:, m]
        mean_new = mean + (theta_new - theta_old) * inv_m
        sumsq_new = sumsq + (theta_new**2).sum(dim=-1) - (theta_old**2).sum(dim=-1)
        extra_new = extra if aux is None else extra - aux[m, t_idx[:, m]] + aux[m, c_m]
        log_ratio = log_w(mean_new, sumsq_new, extra_new) - log_w(mean, sumsq, extra)
        u = torch.rand((B,), generator=gen, device=samples.device)
        accept = torch.log(u) < log_ratio  # lines 7–8
        t_idx[:, m] = torch.where(accept, c_m, t_idx[:, m])
        theta_sel[:, m] = torch.where(accept[:, None], theta_new, theta_old)
        mean = torch.where(accept[:, None], mean_new, mean)
        sumsq = torch.where(accept, sumsq_new, sumsq)
        extra = torch.where(accept, extra_new, extra)
        n_acc = n_acc + accept.to(n_acc.dtype)
    return _ImgCarry(t_idx, theta_sel, mean, sumsq, extra, n_acc)


def _img_kernel_sweep(
    carry: _ImgCarry,
    samples: torch.Tensor,
    counts: torch.Tensor,
    h: torch.Tensor,  # scalar
    aux: Optional[torch.Tensor] = None,
    extra_lw: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    *,
    gen: Optional[torch.Generator] = None,
    c: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
) -> _ImgCarry:
    """One sweep for B chains, all B·M candidate weights from one kernel launch.

    ``c (B, M)`` index proposals and ``u (B, M)`` uniforms are drawn from
    ``gen`` unless given (the tests feed the reference's draws).
    """
    M, T, d = samples.shape
    B = carry.mean.shape[0]
    dev, dtype = samples.device, samples.dtype
    if c is None:
        c = _randint_below(gen, (B, M), counts)
    if u is None:
        u = torch.rand((B, M), generator=gen, device=dev)
    rows = torch.arange(M, device=dev)[None, :]

    cand = samples[rows, c]  # (B, M, d): cand[b, m] = samples[m, c[b, m]]
    delta = cand - carry.theta_sel
    nsq = (cand**2).sum(dim=-1) - (carry.theta_sel**2).sum(dim=-1)  # (B, M)
    b_dot = torch.einsum("bd,bmd->bm", carry.mean, delta)  # θ̄₀·Δ_m
    gram = torch.einsum("bmd,bnd->bmn", delta, delta)  # Δ_j·Δ_m
    msq0 = (carry.mean**2).sum(dim=-1)

    h32 = h.to(torch.float32)
    inv2h2 = 0.5 / (h32 * h32)
    log_norm = M * (d / 2.0) * torch.log(2.0 * math.pi * h32 * h32)

    # every single-site candidate state of every chain, scored in one launch
    eye = torch.eye(M, dtype=dtype, device=dev)[None, :, :, None]  # (1, prop, machine, 1)
    theta_prop = (1.0 - eye) * carry.theta_sel[:, None, :, :] + eye * cand[:, :, None, :]
    lw_base = img_log_weights(theta_prop.reshape(B * M, M, d), h32).reshape(B, M)

    lw_cur = -(carry.sumsq - M * msq0) * inv2h2 - log_norm
    semip = extra_lw is not None
    if semip:
        if aux is not None:
            delta_aux = (aux[rows, c] - aux[rows, carry.t_idx]).to(torch.float32)
        else:
            delta_aux = torch.zeros((B, M), dtype=torch.float32, device=dev)
        lw_cur = lw_cur + extra_lw(carry.mean, carry.extra)
        s_vec = torch.zeros((B, d), dtype=dtype, device=dev)
        acc_aux = torch.zeros((B,), dtype=torch.float32, device=dev)

    zeros_b = torch.zeros((B,), dtype=torch.float32, device=dev)
    acc_nsq, s_b, s_g, n_acc = zeros_b, zeros_b, zeros_b, zeros_b
    g = torch.zeros((B, M), dtype=torch.float32, device=dev)
    a_mask = torch.zeros((B, M), dtype=torch.bool, device=dev)
    log_u = torch.log(u)
    for m in range(M):
        g_m = g[:, m]
        corr = -(acc_nsq - 2.0 * s_b - (s_g + 2.0 * g_m) / M) * inv2h2
        lw_prop = lw_base[:, m] + corr
        if semip:
            mean_m = carry.mean + (s_vec + delta[:, m]) / M  # candidate θ̄
            extra_m = carry.extra + acc_aux + delta_aux[:, m]
            lw_prop = lw_prop + extra_lw(mean_m, extra_m)
        accept = log_u[:, m] < lw_prop - lw_cur
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
    return _ImgCarry(
        t_idx=torch.where(a_mask, c, carry.t_idx),
        theta_sel=torch.where(a_mask[:, :, None], cand, carry.theta_sel),
        mean=carry.mean + torch.einsum("bm,bmd->bd", af, delta) / M,
        sumsq=carry.sumsq + (af * nsq).sum(dim=-1),
        extra=carry.extra + acc_aux if semip else carry.extra,
        n_accept=carry.n_accept + n_acc,
    )


def _run_chains(
    gen: torch.Generator,
    samples: torch.Tensor,
    counts: torch.Tensor,
    n_sweeps: int,
    n_batch: int,
    schedule: Schedule,
    model: ImgWeightModel,
    weight_eval: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B chains × ``n_sweeps`` sweeps → draws ``(n_sweeps, B, d)``, accepts ``(B,)``."""
    dev, dtype = samples.device, samples.dtype
    carry = _init_img_carry(gen, samples, counts, model.aux, n_batch)
    offsets = torch.arange(1, n_batch + 1, dtype=torch.float32, device=dev)
    draws = []
    for i in range(n_sweeps):
        if weight_eval == "kernel":
            # one h for the block: its most-annealed global index
            h = schedule((i + 1) * n_batch).to(dtype)
            hb = h.expand(n_batch)
        else:
            hb = schedule(offsets + i * n_batch).to(dtype)  # chain b: i·B + b + 1
        extra_lw = model.extra_logweight(hb) if model.extra_logweight is not None else None
        if weight_eval == "kernel":
            carry = _img_kernel_sweep(
                carry, samples, counts, h, model.aux, extra_lw, gen=gen
            )
        else:
            carry = _img_gibbs_sweep(gen, carry, samples, counts, hb, model.aux, extra_lw)
        draws.append(model.draw(gen, carry.mean, hb))  # line 12
    return torch.stack(draws), carry.n_accept


def run_img(
    gen: torch.Generator,
    samples: torch.Tensor,
    n_draws: int,
    model: ImgWeightModel,
    *,
    counts: torch.Tensor,
    schedule: Schedule,
    n_batch: int = 1,
    weight_eval: str = "incremental",
) -> CombineResult:
    """Run the IMG engine and package draws + diagnostics."""
    if weight_eval not in ("incremental", "kernel"):
        raise ValueError(f"unknown weight_eval {weight_eval!r}")
    M, T, d = samples.shape
    n_batch = max(1, min(int(n_batch), int(n_draws)))
    n_sweeps = -(-n_draws // n_batch)
    draws, n_acc = _run_chains(
        gen, samples, counts, n_sweeps, n_batch, schedule, model, weight_eval
    )
    # ceil-rounding emits < n_batch surplus draws; drop the earliest
    # (least annealed) rows
    draws = draws.reshape(n_sweeps * n_batch, d)[-n_draws:]
    return CombineResult(
        samples=draws,
        acceptance_rate=n_acc.sum() / (n_sweeps * n_batch * M),
        moments=model.moments,
        extras={
            "n_batch": n_batch,
            "n_sweeps_per_chain": n_sweeps,
            "per_chain_acceptance": n_acc / (n_sweeps * M),
        },
    )


def nonparametric_model(samples: torch.Tensor) -> ImgWeightModel:
    """§3.2: weights w_t (Eq. 3.5), components N(θ̄_t, h²/M I)."""
    M, _, d = samples.shape

    def draw(gen, mean, h):
        eps = torch.randn(mean.shape, generator=gen, dtype=mean.dtype, device=mean.device)
        return mean + eps * (h / math.sqrt(M))[:, None]

    return ImgWeightModel(aux=None, extra_logweight=None, draw=draw, moments=None)


def semiparametric_model(
    samples: torch.Tensor,
    counts: torch.Tensor,
    *,
    nonparametric_weights: bool = False,
) -> ImgWeightModel:
    """§3.3: components N(μ_t, Σ_t) with Σ_t = (M/h² I + Σ̂_M^{-1})^{-1},
    μ_t = Σ_t (M/h² θ̄_t + Σ̂_M^{-1} μ̂_M).

    ``nonparametric_weights=False``: IMG weights W_t (paper's primary form)
        log W_t = log w_t + log N(θ̄_t | μ̂_M, Σ̂_M + h²/M I)
                  − Σ_m log N(θ^m_{t_m} | μ̂_m, Σ̂_m).
    ``nonparametric_weights=True``: weights w_t, same components.
    """
    M, T, d = samples.shape
    eye = torch.eye(d, dtype=samples.dtype, device=samples.device)
    moments = fit_moments(samples, valid_masks(samples, counts))
    prod = product_moments(moments.mean, moments.cov)
    lam_m = torch.linalg.inv_ex(prod.cov + 1e-10 * eye).inverse  # Σ̂_M^{-1}
    eta_m = lam_m @ prod.mean  # Σ̂_M^{-1} μ̂_M

    if nonparametric_weights:
        aux = None
        extra_logweight = None
    else:
        # term3: −Σ_m log N(θ^m_{t_m} | μ̂_m, Σ̂_m), gathered per index
        aux = -torch.stack([
            log_normal_pdf(samples[m], moments.mean[m], moments.cov[m]) for m in range(M)
        ])

        def extra_logweight(h):
            chol = cholesky(prod.cov + (h**2 / M)[:, None, None] * eye)  # (B, d, d)
            logdet = 2.0 * chol.diagonal(dim1=-2, dim2=-1).log().sum(dim=-1)

            def term(mean, extra_sum):
                # + log N(θ̄ | μ̂_M, Σ̂_M + h²/M I) + Σ_m aux  (aux already −logN)
                diff = (mean - prod.mean).unsqueeze(-1)
                sol = torch.linalg.solve_triangular(chol, diff, upper=False)[..., 0]
                quad = (sol**2).sum(dim=-1)
                return -0.5 * (quad + logdet + d * _LOG2PI) + extra_sum

            return term

    def draw(gen, mean, h):
        # precision form: P = M/h² I + Λ_M, θ = μ_t + chol(P)^{-T} ε
        s = M / h**2  # (B,)
        chol_p = cholesky(s[:, None, None] * eye + lam_m)
        rhs = s[:, None] * mean + eta_m
        mu_t = torch.cholesky_solve(rhs.unsqueeze(-1), chol_p)[..., 0]
        eps = torch.randn(mean.shape, generator=gen, dtype=mean.dtype, device=mean.device)
        noise = torch.linalg.solve_triangular(
            chol_p.transpose(-1, -2), eps.unsqueeze(-1), upper=True
        )[..., 0]
        return mu_t + noise

    return ImgWeightModel(aux=aux, extra_logweight=extra_logweight, draw=draw, moments=prod)


@register("nonparametric", "nonparametric_img")
def nonparametric(
    gen: torch.Generator,
    samples: torch.Tensor,
    n_draws: int,
    *,
    counts: Optional[torch.Tensor] = None,
    schedule: Optional[Schedule] = None,
    rescale: bool = False,
    n_batch: int = 1,
    weight_eval: str = "incremental",
    **_ignored,
) -> CombineResult:
    """Algorithm 1 — asymptotically exact sampling from ∏_m KDE(p_m)."""
    counts = counts_or_full(samples, counts)
    schedule = _resolve_schedule(samples, schedule, rescale)
    return run_img(
        gen, samples, n_draws, nonparametric_model(samples),
        counts=counts, schedule=schedule, n_batch=n_batch, weight_eval=weight_eval,
    )


@register("semiparametric", "semiparametric_img")
def semiparametric(
    gen: torch.Generator,
    samples: torch.Tensor,
    n_draws: int,
    *,
    counts: Optional[torch.Tensor] = None,
    schedule: Optional[Schedule] = None,
    rescale: bool = False,
    nonparametric_weights: bool = False,
    n_batch: int = 1,
    weight_eval: str = "incremental",
    **_ignored,
) -> CombineResult:
    """§3.3 semiparametric combiner (see :func:`semiparametric_model`)."""
    counts = counts_or_full(samples, counts)
    schedule = _resolve_schedule(samples, schedule, rescale)
    model = semiparametric_model(samples, counts, nonparametric_weights=nonparametric_weights)
    return run_img(
        gen, samples, n_draws, model,
        counts=counts, schedule=schedule, n_batch=n_batch, weight_eval=weight_eval,
    )


@register("semiparametric_w", "semiparametric_wt")
def semiparametric_w(
    gen: torch.Generator,
    samples: torch.Tensor,
    n_draws: int,
    *,
    counts: Optional[torch.Tensor] = None,
    **options,
) -> CombineResult:
    """§3.3 second variant: semiparametric components, nonparametric weights."""
    options.pop("nonparametric_weights", None)
    return semiparametric(
        gen, samples, n_draws, counts=counts, nonparametric_weights=True, **options
    )
