"""Subposterior construction — paper Eq. 2.1.

The port of ``repro/core/subposterior.py``. For machine m,

    p_m(θ) ∝ p(θ)^{1/M} · p(x^{n_m} | θ).

Data is a dict of tensors. Stacked shards carry a leading ``(M, ...)`` axis,
and the log-density built here is batched the same way: θ ``(M, d)`` →
``(M,)``, one value per machine, which is how the chains run all M machines
at once. :func:`make_minibatch_logpdf` is SGLD's stochastic estimate of it,
and :func:`mh_correction_ratio` the paper's §2 MH ratio on a subposterior.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

Data = Dict[str, torch.Tensor]
LogDensityFn = Callable[[torch.Tensor], torch.Tensor]


def partition_data(
    data: Data,
    num_shards: int,
    *,
    only: Optional[Tuple[str, ...]] = None,
    pad: bool = False,
):
    """Split the leading axis of every per-datum leaf into M contiguous shards.

    ``only`` names the per-datum keys (``None`` = all); other leaves are
    broadcast unchanged. ``pad=False``: N must divide by M. ``pad=True``:
    non-divisible N is padded to ``M·ceil(N/M)`` rows by replicating the
    final datum, and the result is ``(shards, counts)`` with ``counts (M,)``
    int32 the real rows of each shard (the combiners' valid-prefix
    convention). Shards are ``(M, ceil(N/M), ...)`` and contiguous.
    """
    keys = tuple(data) if only is None else only
    n = data[keys[0]].shape[0]
    size = -(-n // num_shards)
    if n % num_shards != 0 and not pad:
        raise ValueError(
            f"leading dim {n} not divisible by M={num_shards} "
            "(pass pad=True for edge-padded shards + counts)"
        )

    def split(x: torch.Tensor) -> torch.Tensor:
        if n % num_shards != 0:
            idx = torch.arange(num_shards * size, device=x.device).clamp(max=n - 1)
            x = x[idx]
        return x.reshape((num_shards, size) + tuple(x.shape[1:])).contiguous()

    shards = {k: (split(v) if k in keys else v) for k, v in data.items()}
    if not pad:
        return shards
    device = data[keys[0]].device
    counts = (n - torch.arange(num_shards, device=device) * size).clamp(0, size)
    return shards, counts.to(torch.int32)


def make_subposterior_logpdf(
    log_prior: LogDensityFn,
    log_lik: Callable[[torch.Tensor, Data], torch.Tensor],
    data_shard: Data,
    num_shards: int,
    *,
    count: Optional[torch.Tensor | int] = None,
    per_datum: Optional[Tuple[str, ...]] = None,
) -> LogDensityFn:
    """Build the subposterior log-density (paper Eq. 2.1).

    ``log_lik(theta, shard)`` returns the log-likelihood summed over the
    shard's rows (batched over any leading shard axis). The prior enters at
    power 1/M. ``count`` supports ``partition_data(pad=True)``: rows
    ``[count, S)`` replicate the shard's final row, so the exact masked
    log-likelihood is ``log_lik(shard) − (S − count)·log_lik(final row)``.
    ``per_datum`` names the per-datum keys (``None`` = every leaf).
    """
    inv_m = 1.0 / float(num_shards)
    if count is None:
        def logpdf(theta: torch.Tensor) -> torch.Tensor:
            return inv_m * log_prior(theta) + log_lik(theta, data_shard)

        return logpdf

    keys = tuple(data_shard) if per_datum is None else per_datum
    first = data_shard[keys[0]]
    count = torch.as_tensor(count, device=first.device)
    axis = count.dim()  # rows follow the leading shard axes, one per dim of count
    shard_size = first.shape[axis]
    last_row = {
        k: (v.narrow(axis, shard_size - 1, 1).contiguous() if k in keys else v)
        for k, v in data_shard.items()
    }
    n_pad = float(shard_size) - count.to(torch.float32)

    def logpdf(theta: torch.Tensor) -> torch.Tensor:
        full = log_lik(theta, data_shard)
        pad_ll = log_lik(theta, last_row)
        return inv_m * log_prior(theta) + full - n_pad * pad_ll

    return logpdf


def make_minibatch_logpdf(
    log_prior: LogDensityFn,
    log_lik: Callable[[torch.Tensor, Data], torch.Tensor],
    num_shards: int,
    shard_size: int | torch.Tensor,
) -> Callable[[torch.Tensor, Data], torch.Tensor]:
    """Unbiased minibatch estimator of the subposterior log-density:
    ``(1/M)·log p(θ) + (N_m/B)·log p(batch|θ)``, B the batch's row count.

    ``batch`` holds rows ``(..., B, ...)`` after θ's leading axes; B is read
    from the first key in sorted order (the reference's first leaf), at axis
    ``θ.dim() - 1``. ``shard_size`` is a number or a
    per-chain tensor ``(...)`` (the real rows of each shard).
    """
    inv_m = 1.0 / float(num_shards)

    def logpdf(theta: torch.Tensor, batch: Data) -> torch.Tensor:
        batch_size = batch[sorted(batch)[0]].shape[theta.dim() - 1]
        scale = shard_size / float(batch_size)
        return inv_m * log_prior(theta) + scale * log_lik(theta, batch)

    return logpdf


def mh_correction_ratio(
    log_prior: LogDensityFn,
    log_lik: Callable[[torch.Tensor, Data], torch.Tensor],
    data_shard: Data,
    num_shards: int,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The paper §2 footnote form of the MH ratio on a subposterior:

    log [ p(θ*)^{1/M} p(x^{n_m}|θ*) ] − log [ p(θ)^{1/M} p(x^{n_m}|θ) ].
    """
    logpdf = make_subposterior_logpdf(log_prior, log_lik, data_shard, num_shards)

    def ratio(theta_new: torch.Tensor, theta_old: torch.Tensor) -> torch.Tensor:
        return logpdf(theta_new) - logpdf(theta_old)

    return ratio
