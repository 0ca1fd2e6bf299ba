"""Plain PyTorch versions of the KDE log densities.

The counterpart of ``repro/kernels/kde_density/ref.py``, formula for formula.
For queries q (Q, d) and a sample set s (ns, d) with bandwidth h:

    log p̂(q) = logsumexp_j [ −‖q − s_j‖² / (2h²) ] − log(ns) − (d/2)·log(2πh²)

:func:`machine_kde_log_density_ref` scores M machines' sets (M, T, d) at once
with per-machine h and valid-prefix ``counts``; it forms distances with the
identity ‖q‖² + ‖s‖² − 2q·s as the reference does. The CPU path, the tests
and the card's comparisons use these; on the card the hand-written kernel
(``csrc/kde_density.cu``) computes the same functions, by the same identity
on centred operands with the cross term as 3×TF32 on the tensor cores:
:func:`machine_kde_log_density_split` models that arithmetic for the tests
and the card probe.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels.tf32 import tf32_split

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
    return _reduce(lse, counts, h, d, reduce, mixture_weights)


def _reduce(lse, counts, h, d, reduce, mixture_weights):
    """Log densities (M, Q) from the masked logsumexps, then ``reduce``."""
    M, dtype = lse.shape[0], lse.dtype
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


_CENTRE_ROWS = 256  # the card kernel's kCentreRows


def kde_centres(samples: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Each machine's centre (M, d), as the card kernel takes it: the mean of
    up to 256 of its valid rows, evenly spaced (row j·n // k of k =
    min(n, 256)); zero for an empty machine."""
    M, T, d = samples.shape
    mu = samples.new_zeros((M, d))
    for m in range(M):
        n = int(counts[m].clamp(0, T))
        k = min(n, _CENTRE_ROWS)
        if k:
            mu[m] = samples[m, torch.arange(k, device=samples.device) * n // k].sum(dim=0) / k
    return mu


_MODEL_CHUNK = 256  # queries a step of the model, to bound its (M, C, T) products


def machine_kde_log_density_split(
    queries: torch.Tensor,  # (Q, d)
    samples: torch.Tensor,  # (M, T, d)
    h: torch.Tensor | float,
    counts: Optional[torch.Tensor] = None,
    *,
    reduce: str = "none",
    mixture_weights: str = "counts",
    passes: int = 3,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """A model of the card kernel's arithmetic, in float32.

    The distances by ‖q_c‖² + ‖s_c‖² − 2q_c·s_c on operands centred by each
    machine's :func:`kde_centres`, as the kernel forms them:
    one product q_c·s_c − ‖s_c‖²/2 of operands widened by a column (1 for
    the queries, −‖s_c‖²/2 for the samples), from TF32 halves
    (:func:`tf32_split`): ``passes=3`` sums hi·lo + lo·hi + hi·hi,
    ``passes=1`` takes hi·hi alone; products and sums in float32. Rows past
    ``counts`` are where-selected away before they enter anything. The card
    sums in another order, so this model is held to the kernel by tolerance,
    never bitwise. It serves the tests and ``launch/kde_probe.py``; no path
    calls it.
    """
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    M, T, d = samples.shape
    dev = queries.device
    q, s = queries.to(torch.float32), samples.to(torch.float32)
    h = torch.as_tensor(h, dtype=torch.float32, device=dev).reshape(-1).expand(M)
    if counts is None:
        counts = torch.full((M,), T, dtype=torch.int32, device=dev)
    counts = torch.as_tensor(counts, device=dev).to(torch.int32)
    n = counts.clamp(0, T)
    mask = torch.arange(T, device=dev)[None, :] < n[:, None]  # (M, T)
    s = torch.where(mask[..., None], s, 0.0)
    mu = kde_centres(s, n)
    s_c = torch.where(mask[..., None], s - mu[:, None, :], 0.0)
    # column d carries each row's −‖s_c‖²/2, the queries 1 there: one product
    # gives q_c·s_c − ‖s_c‖²/2
    s_aug = torch.cat([s_c, -0.5 * (s_c * s_c).sum(dim=-1, keepdim=True)], dim=-1)
    s_hi, s_lo = tf32_split(s_aug)
    lse = []
    for q0 in range(0, q.shape[0], _MODEL_CHUNK):
        q_c = q[None, q0:q0 + _MODEL_CHUNK] - mu[:, None, :]  # (M, C, d)
        q_hi, q_lo = tf32_split(torch.cat([q_c, torch.ones_like(q_c[..., :1])], dim=-1))
        prod = q_hi @ s_hi.transpose(1, 2)
        if passes == 3:
            prod = (q_hi @ s_lo.transpose(1, 2) + q_lo @ s_hi.transpose(1, 2)) + prod
        # −(‖q_c‖² + ‖s_c‖² − 2q_c·s_c)/2h² = (2·prod − ‖q_c‖²)/2h²
        score = (2.0 * prod - (q_c * q_c).sum(dim=-1)[:, :, None]) / (2.0 * h[:, None, None] ** 2)
        logk = torch.where(mask[:, None, :], score, -math.inf)
        lse.append(torch.logsumexp(logk, dim=-1))
    lse = torch.cat(lse, dim=1) if lse else q.new_zeros((M, 0))
    return _reduce(lse, counts, h, d, reduce, mixture_weights)


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
