"""Plain PyTorch versions of the KDE log densities.

The counterpart of ``repro/kernels/kde_density/ref.py``, formula for formula.
For queries q (Q, d) and a sample set s (ns, d) with bandwidth h:

    log p̂(q) = logsumexp_j [ −‖q − s_j‖² / (2h²) ] − log(ns) − (d/2)·log(2πh²)

:func:`machine_kde_log_density_ref` scores M machines' sets (M, T, d) at once
with per-machine h and valid-prefix ``counts``; it forms distances with the
identity ‖q‖² + ‖s‖² − 2q·s as the reference does. The CPU path, the tests
and the card's comparisons use these; on the card the hand-written kernel
(``csrc/kde_density.cu``) computes the same functions.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

_LOG2PI = math.log(2.0 * math.pi)


def machine_kde_log_density_ref(
    queries: torch.Tensor,  # (Q, d)
    samples: torch.Tensor,  # (M, T, d)
    h: torch.Tensor | float,  # (M,) or scalar bandwidth
    counts: Optional[torch.Tensor] = None,  # (M,) int; None ⇒ all T rows valid
    *,
    reduce: str = "none",
    mixture_weights: str = "counts",
    chunk: int = 256,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Chunked masked-logsumexp version of the batched all-machines KDE.

    Queries go through in ``chunk``-row tiles, each scored against every
    machine by one einsum. Rows at index ≥ ``counts[m]`` are where-selected
    to −inf before the logsumexp, so NaN in the invalid suffix is inert.
    ``reduce``: ``"none"`` → (M, Q); ``"product"`` → (Q,) Σ_m log p̂_m;
    ``"mixture"`` → (Q,) logsumexp_m(log w_m + log p̂_m) with w from
    ``counts`` or uniform; ``"product_mixture"`` → both. Computes in the
    queries' dtype.
    """
    M, T, d = samples.shape
    dtype, dev = queries.dtype, queries.device
    h = torch.as_tensor(h, dtype=dtype, device=dev).reshape(-1).expand(M)
    if counts is None:
        counts = torch.full((M,), T, dtype=torch.int32, device=dev)
    counts = torch.as_tensor(counts, device=dev).to(torch.int32)

    mask = torch.arange(T, device=dev)[None, :] < counts[:, None]  # (M, T)
    csq = (samples**2).sum(dim=-1)  # (M, T)
    lse = []
    for q0 in range(0, queries.shape[0], chunk):
        qc = queries[q0:q0 + chunk]
        sq = (
            (qc**2).sum(dim=-1)[None, :, None]
            + csq[:, None, :]
            - 2.0 * torch.einsum("qd,mtd->mqt", qc, samples)
        )
        logk = -0.5 * sq / (h[:, None, None] ** 2)
        logk = torch.where(mask[:, None, :], logk, -math.inf)
        lse.append(torch.logsumexp(logk, dim=-1))
    lse = torch.cat(lse, dim=1) if lse else queries.new_zeros((M, 0))
    log_norm = -torch.log(counts.to(dtype).clamp(min=1.0)) - 0.5 * d * (2.0 * torch.log(h) + _LOG2PI)
    logp = lse + log_norm[:, None]

    if reduce == "none":
        return logp
    want_prod = reduce in ("product", "product_mixture")
    want_mix = reduce in ("mixture", "product_mixture")
    if not (want_prod or want_mix):
        raise ValueError(f"unknown reduce={reduce!r}")
    prod = logp.sum(dim=0) if want_prod else None
    mix = None
    if want_mix:
        if mixture_weights == "uniform":
            # subtract-after, as the reference
            mix = torch.logsumexp(logp, dim=0) - math.log(M)
        elif mixture_weights == "counts":
            cf = counts.to(dtype)
            logw = torch.log(cf) - torch.log(cf.sum())
            mix = torch.logsumexp(logp + logw[:, None], dim=0)
        else:
            raise ValueError(f"unknown mixture_weights={mixture_weights!r}")
    if want_prod and want_mix:
        return prod, mix
    return prod if want_prod else mix


def kde_log_density_ref(
    queries: torch.Tensor,  # (nq, d)
    centers: torch.Tensor,  # (ns, d)
    h: torch.Tensor | float,
) -> torch.Tensor:
    """Single-cloud KDE log density (nq,), direct distances, in float32."""
    q, s = queries.float(), centers.float()
    h = torch.as_tensor(h, dtype=torch.float32, device=q.device)
    d = q.shape[-1]
    sq = ((q[:, None, :] - s[None, :, :]) ** 2).sum(dim=-1)  # (nq, ns)
    lse = torch.logsumexp(-0.5 * sq / (h * h), dim=1)
    return lse - math.log(s.shape[0]) - 0.5 * d * torch.log(2.0 * math.pi * h * h)
