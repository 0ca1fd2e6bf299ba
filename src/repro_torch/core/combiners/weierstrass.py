"""Weierstrass refinement sampler — exact Gibbs over latent per-machine draws.

The port of ``repro/core/combiners/weierstrass.py`` (Wang & Dunson's
Weierstrass transform view of the density product). Each sweep, for B
independent chains at once:

1. refinement — for each machine m the latent θᵐ is one of chain m's valid
   draws, chosen with probability ∝ N(θ | θᵐ_t, h²I) (a Gumbel-max over the
   negative squared distances);
2. pooling — θ | θ¹..θᴹ ~ N(θ̄, h²/M · I).

No accept/reject (acceptance ≡ 1). Chain b's sweep i anneals at the shared
global index i·B + b + 1, and the draws interleave to one (n_draws, d)
output. The reference's ``lax.scan`` over sweeps is a Python loop here,
batched over the B chains.

``init_pool > 0`` starts each chain from a density-guided draw: a strided
subsample of the pooled cloud is scored under Σ_m log p̂_m by one call of the
batched KDE kernel (product epilogue) and θ₀ is drawn from its softmax;
``init_pool = 0`` starts at a uniform pooled draw. The final latent states
are scored by the ``img_log_weights`` kernel (``extras["final_log_weight"]``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.combiners.api import (
    CombineResult,
    Schedule,
    categorical,
    counts_or_full,
    gumbel,
    ragged_gather,
    register,
    resolve_schedule,
)
from repro_torch.core.combiners.density import machine_kde_scores, masked_silverman
from repro_torch.kernels.img_weights import img_log_weights


@register("weierstrass", "weierstrass_refine")
def weierstrass(
    gen: torch.Generator,
    samples: torch.Tensor,
    n_draws: int,
    *,
    counts: Optional[torch.Tensor] = None,
    schedule: Optional[Schedule] = None,
    rescale: bool = False,
    n_chains: int = 8,
    init_pool: int = 0,
    **_ignored,
) -> CombineResult:
    """Gibbs refinement sampling from the Weierstrass-smoothed density product.

    ``n_chains``: ensemble size (independent chains, interleaved draws).
    ``init_pool``: 0 starts each chain at a uniform pooled draw; > 0 starts
    from the density-guided pool of that size.
    """
    M, T, d = samples.shape
    dtype, dev = samples.dtype, samples.device
    counts_arr = counts_or_full(samples, counts)
    schedule = resolve_schedule(samples, schedule, rescale)
    n_batch = max(1, min(int(n_chains), int(n_draws)))
    n_sweeps = -(-n_draws // n_batch)  # ceil

    pooled = ragged_gather(samples, counts_arr).reshape(M * T, d)
    if init_pool and init_pool > 0:
        h0 = masked_silverman(samples, counts_arr)  # (M,)
        stride = max(1, (M * T) // min(int(init_pool), M * T))
        cand = pooled[::stride]
        # Σ_m log p̂_m over the candidate pool: one kernel launch, product epilogue
        score = machine_kde_scores(
            cand, samples, counts if counts is None else counts_arr, h0, reduce="product",
        )
        theta = cand[categorical(gen, score, n_batch)]  # (B, d)
    else:
        theta = pooled[torch.randint(0, M * T, (n_batch,), generator=gen, device=dev)]

    mask = torch.arange(T, device=dev)[None, :] < counts_arr[:, None]  # (M, T)
    csq = torch.where(mask, (samples**2).sum(dim=-1), 0.0)  # (M, T)
    offsets = torch.arange(1, n_batch + 1, dtype=torch.float32, device=dev)
    inv_sqrt_m = 1.0 / math.sqrt(M)
    rows = torch.arange(M, device=dev)[None, :]
    sel = torch.zeros((n_batch, M, d), dtype=dtype, device=dev)
    draws = []
    for i in range(n_sweeps):
        h = schedule(offsets + i * n_batch).to(dtype)  # (B,)
        # refinement: Gumbel-max over each machine's valid prefix with
        # logits −‖θ − θᵐ_t‖²/(2h²)
        cross = torch.einsum("mtd,bd->bmt", samples, theta)
        qsq = (theta**2).sum(dim=-1)  # (B,)
        sq = csq[None, :, :] - 2.0 * cross + qsq[:, None, None]
        logits = -0.5 * sq / (h[:, None, None] ** 2)
        logits = torch.where(mask[None, :, :], logits, -math.inf)
        t_sel = (logits + gumbel(gen, logits.shape, logits)).argmax(dim=-1)  # (B, M)
        sel = samples[rows, t_sel]  # (B, M, d)
        # pooling: θ ~ N(θ̄, h²/M I), the product of the M kernels
        eps = torch.randn((n_batch, d), generator=gen, dtype=dtype, device=dev)
        theta = sel.mean(dim=1) + eps * (h[:, None] * inv_sqrt_m)
        draws.append(theta)

    # (n_sweeps, B, d) flattened: row i·B + b carries anneal index i·B + b + 1;
    # drop the earliest (least annealed) ceil-surplus rows
    draws = torch.stack(draws).reshape(n_sweeps * n_batch, d)[-n_draws:]
    h_final = schedule(n_sweeps * n_batch)
    final_lw = img_log_weights(sel.contiguous(), h_final.to(torch.float32))  # (B,)
    return CombineResult(
        samples=draws,
        acceptance_rate=torch.ones((), device=dev),  # exact Gibbs: every sweep accepted
        moments=None,
        extras={
            "n_chains": n_batch,
            "n_sweeps_per_chain": n_sweeps,
            "h_final": h_final,
            "final_log_weight": final_lw,
        },
    )
