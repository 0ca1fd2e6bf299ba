"""Plain PyTorch version of the fused Welford/Chan-merge update.

The counterpart of ``repro/kernels/online_update/ref.py``: a dense
``(M, C, d)`` chunk is reduced to per-machine batch moments (masked mean and
centred Gram) and Chan-merged into the running ``(count, mean, m2)``,
including the ``δδᵀ·n_a·n_b/n`` term. Rows beyond each machine's
``chunk_counts`` prefix are excluded with ``where``, never mask-multiplied
(0·NaN would leak); a machine whose chunk count is 0 keeps its mean and m2.
It serves the CPU path and the tests; on the card the hand-written kernel
computes the same function. Works in the inputs' dtype, so a float64 call is
the tight check of the float32 kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def online_moments_update_ref(
    count: torch.Tensor,  # (M,)
    mean: torch.Tensor,  # (M, d)
    m2: torch.Tensor,  # (M, d, d)
    chunk: torch.Tensor,  # (M, C, d)
    chunk_counts: Optional[torch.Tensor] = None,  # (M,) valid prefix (None ⇒ C)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    M, C, _ = chunk.shape
    if chunk_counts is None:
        cc = torch.full((M,), C, dtype=torch.int32, device=chunk.device)
    else:
        cc = torch.as_tensor(chunk_counts, device=chunk.device).to(torch.int32)
    mask = (torch.arange(C, device=chunk.device)[None, :] < cc[:, None])[..., None]
    n_b = cc.to(chunk.dtype)
    n_b_safe = n_b.clamp(min=1.0)
    valid = torch.where(mask, chunk, 0.0)
    mean_b = valid.sum(dim=1) / n_b_safe[:, None]  # (M, d)
    cent = torch.where(mask, chunk - mean_b[:, None, :], 0.0)
    m2_b = torch.einsum("mci,mcj->mij", cent, cent)  # (M, d, d)

    n_a = count
    n = n_a + n_b
    n_safe = n.clamp(min=1.0)
    delta = mean_b - mean
    mean_new = mean + delta * (n_b / n_safe)[:, None]
    m2_new = m2 + m2_b + torch.einsum("mi,mj->mij", delta, delta) * (
        n_a * n_b / n_safe
    )[:, None, None]
    upd = (n_b > 0)[:, None]
    return (
        n,
        torch.where(upd, mean_new, mean),
        torch.where(upd[..., None], m2_new, m2),
    )
