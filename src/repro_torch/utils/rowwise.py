"""Per-chain sums and products that do not depend on the batch around them.

EP-MCMC's chain groups (one a device, or one a process) must draw bit for bit
what the whole batch of M chains draws, so a chain's arithmetic may not
depend on how many chains share its batch, and two library choices make it
do so:

- on the CPU a matrix product picks its code path from the batch and the
  operands' alignment (MKL's batched ``gemv`` rounds a vector that starts
  off a 64-byte line otherwise), and on the card the batched library
  product and autograd's sum over a shard's rows take their split from the
  batch too. A chain's own products are therefore formed elementwise and
  summed by the functions below wherever its draws depend on them
  (linear-Gaussian's and the GMM's log-likelihoods and their gradients,
  each an ``autograd.Function`` over them). :func:`matvec` is that form on
  the CPU and the library's product on the card: the Gibbs blocks' small
  (d × d) moves use it, which draw the batched draws on the CPU mesh;
- a CUDA sum over the last axis takes its block's width from the row count
  as well as the row's length once a row holds 64 or more elements (PyTorch's
  reduction config), so ten rows of a Poisson shard's latents are summed in
  another order than five; a long per-chain sum is taken in blocks of 32,
  whose order the row alone fixes (:func:`rowsum`), and a sum over rows by
  :func:`colsum`, the same blocks on the transposed rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# a CUDA sum over a last axis this short has the same block width at any row count
BLOCK = 32


def rowsum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(dim=-1)``, in an order the row alone fixes: blocks of
    :data:`BLOCK` (the last zero-padded; adding +0 is exact) summed, then
    their sums the same way, until one value is left."""
    while x.shape[-1] > BLOCK:
        pad = -x.shape[-1] % BLOCK
        if pad:
            x = F.pad(x, (0, pad))
        x = x.unflatten(-1, (-1, BLOCK)).sum(dim=-1)
    return x.sum(dim=-1)


def colsum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(dim=-2)`` for ``x (..., n, k)`` → ``(..., k)``, in an order the
    rows of each leading index alone fix: :func:`rowsum` over a contiguous
    ``(..., k, n)`` copy (a sum over a strided axis is split as the batch
    says)."""
    return rowsum(x.transpose(-1, -2).contiguous())


def rowdot(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a @ x`` for ``a (..., n, k)``, ``x (..., k)`` → ``(..., n)`` on every
    device: the products formed elementwise and summed by :func:`rowsum`."""
    return rowsum(a * x.unsqueeze(-2))


def matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a @ x`` for ``a (..., n, k)``, ``x (..., k)`` → ``(..., n)``: on
    the CPU elementwise, summed by :func:`rowsum`; on the card the
    library's product."""
    if a.device.type != "cpu":
        return (a @ x.unsqueeze(-1)).squeeze(-1)
    return rowdot(a, x)
