"""Gradient compression for the synchronous (``--mode sgd``) baseline.

The counterpart of ``repro/optim/compression.py``: PowerSGD-style rank-r
compression with error feedback (Vogels et al. 2019). A matrix G (n, m) is
factored G ≈ P Qᵀ by one subspace iteration, P = orth(G Q₀), Q = Gᵀ P, so
that an all-reduce would move r·(n + m) numbers instead of n·m; the error
buffer carries each step's residual into the next, so the signal is kept
over steps. A leaf of more than two axes is reshaped to (−1, m) first; a
leaf with fewer than two axes, or with min(n, m) ≤ r, passes through
uncompressed with its error zeroed.

The reference's arithmetic and cast points are kept: the products in
float32, the QR by ``torch.linalg.qr`` (reduced), the approximation cast to
the gradient's dtype before the residual is taken, the residual cast to the
error buffer's dtype. Randomness is an argument: where the reference takes
a JAX key, these functions take a ``torch.Generator`` (Q₀ ~ N(0, 1) drawn on
its device, one leaf after another in the tree's order), or the projection
Q₀ itself (``q0=``, (m, r); for a tree, a dict of them by leaf name),
which replaces the draw. The same Q₀ gives the reference's numbers; P may differ from the
reference's by column signs (another QR), P Qᵀ does not.

The port's trees are flat dicts ``{name: tensor}``, as AdamW's
(:mod:`repro_torch.optim.adamw`). Nothing of the port calls this module
yet, as nothing of the reference does outside its tests.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch


class LowRankPair(NamedTuple):
    p: torch.Tensor  # (n', r), orthonormal columns
    q: torch.Tensor  # (m, r)


def compress_lowrank(
    generator: Optional[torch.Generator], grad: torch.Tensor, rank: int, *,
    q0: Optional[torch.Tensor] = None,
) -> Tuple[LowRankPair, torch.Tensor]:
    """One-shot subspace iteration: grad (..., n, m) → ((P, Q), residual),
    the residual ``grad − (P Qᵀ)`` in grad's dtype and shape. ``q0`` (m,
    rank) replaces the draw from ``generator``."""
    m = grad.shape[-1]
    g2 = (grad.reshape(-1, m) if grad.ndim > 2 else grad).to(torch.float32)
    if q0 is None:
        if generator is None:
            raise ValueError("compress_lowrank needs a generator or q0")
        q0 = torch.randn((m, rank), generator=generator, device=generator.device,
                         dtype=torch.float32)
    p, _ = torch.linalg.qr(g2 @ q0.to(device=grad.device, dtype=torch.float32))
    q = g2.T @ p
    approx = (p @ q.T).to(grad.dtype).reshape(grad.shape)
    return LowRankPair(p=p, q=q), grad - approx


def decompress_lowrank(pair: LowRankPair, shape) -> torch.Tensor:
    """P Qᵀ (float32) in ``shape``."""
    return (pair.p @ pair.q.T).reshape(shape)


def error_feedback_update(
    generator: Optional[torch.Generator],
    grads: Mapping[str, torch.Tensor],
    error: Mapping[str, torch.Tensor],
    rank: int = 8,
    *,
    q0: Optional[Mapping[str, torch.Tensor]] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Compress and decompress every leaf of two axes or more whose last two
    are both longer than ``rank``, after adding its error buffer: returns
    (the approximations, in each gradient's dtype, that an all-reduce would
    sum; the new error buffers, in theirs). Any other leaf passes through
    and its error becomes zero. ``q0``: the projections by leaf name; a
    compressed leaf without one draws its own from ``generator``, in the
    order of ``grads``."""
    out, new_err = {}, {}
    for name, g in grads.items():
        e = error[name]
        if g.ndim >= 2 and min(g.shape[-2], g.shape[-1]) > rank:
            proj = None if q0 is None else q0.get(name)
            pair, resid = compress_lowrank(generator, g + e.to(g.dtype), rank, q0=proj)
            out[name] = decompress_lowrank(pair, g.shape).to(g.dtype)
            new_err[name] = resid.to(e.dtype)
        else:
            out[name] = g
            new_err[name] = torch.zeros_like(e)
    return out, new_err


def init_error_feedback(grads_like: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Float32 zeros shaped as each leaf, on its device."""
    return {name: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for name, g in grads_like.items()}

