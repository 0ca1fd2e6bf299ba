"""Random-partition-tree pooling — per-leaf product of block densities.

The port of ``repro/core/combiners/rpt.py`` (Wang, Guo & Dunson). A space
partition shared by all machines turns the product of M densities into a
product of M histograms on the same bins; the estimate is the uniform
mixture over an ensemble of ``n_trees`` randomized partitions.

Per tree: permute the pooled ``(M·T, d)`` cloud and keep a multiple of
2^depth points; at each level pick one cut dimension by Gumbel-perturbed
log-variance (mean within-node variance) and split every node at its own
median along it, giving balanced leaves of S points; a leaf's log product
mass is Σ_m log(c_m + α) − Σ_m log(T_m + α·L) − (M−1)·log vol, with vol the
box volume over the cut dimensions. Draws: (tree, leaf) from the normalized
masses, then a member of the leaf plus ``jitter``·leaf-std Gaussian noise
(``within="resample"``) or a uniform point in the leaf's box
(``within="uniform"``).

The reference scans over levels with segment sums and a ``lexsort`` keyed
(cut coordinate, node id), vmapped over trees. Here the trees are a leading
batch axis and the levels a Python loop: a level's nodes are contiguous,
equal segments of the point axis, so its segment sums are a reshape and a
sum, and the lexsort (node id primary, coordinate secondary, both stable) is
one stable sort of the coordinate inside each segment.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.combiners.api import (
    CombineResult,
    categorical,
    counts_or_full,
    gumbel,
    ragged_gather,
    register,
)


def _default_depth(n: int, m: int) -> int:
    """Deepest balanced tree keeping ≥ max(32, 24·m) points per leaf."""
    leaf_target = max(32, 24 * m)
    return max(1, min(12, int(math.floor(math.log2(max(2, n // leaf_target))))))


@register("rpt", "random_partition_tree")
def rpt(
    gen: torch.Generator,
    samples: torch.Tensor,
    n_draws: int,
    *,
    counts: Optional[torch.Tensor] = None,
    depth: Optional[int] = None,
    n_trees: int = 8,
    pseudocount: float = 0.5,
    within: str = "resample",
    jitter: float = 1.0,
    **_ignored,
) -> CombineResult:
    """Sample the random-partition-tree-ensemble product-density estimate.

    ``depth``: tree depth (2^depth leaves; default keeps ≥ max(32, 24M)
    points per leaf). ``n_trees``: ensemble size. ``pseudocount``: Jeffreys
    smoothing α. ``within``: ``"resample"`` or ``"uniform"``.
    """
    if within not in ("resample", "uniform"):
        raise ValueError(f"unknown within={within!r}; use 'resample' or 'uniform'")
    M, T, d = samples.shape
    dtype, dev = samples.dtype, samples.device
    counts_arr = counts_or_full(samples, counts)
    N = M * T
    L = _default_depth(N, M) if depth is None else max(1, int(depth))
    L = min(L, int(math.floor(math.log2(max(2, N)))))
    K = max(1, int(n_trees))
    n_leaf = 2**L
    S = max(1, N // n_leaf)
    n_keep = S * n_leaf

    pooled = ragged_gather(samples, counts_arr).reshape(N, d)
    machine = torch.arange(M, device=dev).repeat_interleave(T)  # (N,)
    # per-dim scale of the degenerate-span guard
    span_floor = 1e-6 * (pooled.max(dim=0).values - pooled.min(dim=0).values) + 1e-12

    perm = torch.stack([
        torch.randperm(N, generator=gen, device=dev)[:n_keep] for _ in range(K)
    ])  # (K, n_keep)
    pts, ids = pooled[perm], machine[perm]  # (K, n_keep, d), (K, n_keep)
    tree = torch.arange(K, device=dev)
    cut_dims = []
    for lvl in range(L):
        n_nodes = 2**lvl
        seg = n_keep // n_nodes
        nodes = pts.reshape(K, n_nodes, seg, d)
        # one cut dim per level: mean within-node variance, Gumbel-perturbed
        node_mean = nodes.sum(dim=2) / seg
        node_var = ((nodes - node_mean[:, :, None, :]) ** 2).sum(dim=2) / seg
        var = node_var.sum(dim=1) / n_nodes  # (K, d)
        cut = (torch.log(var + 1e-20) + gumbel(gen, var.shape, var)).argmax(dim=-1)  # (K,)
        coord = nodes[tree, :, :, cut]  # (K, n_nodes, seg)
        order = torch.sort(coord, dim=-1, stable=True).indices
        order = (order + torch.arange(n_nodes, device=dev)[:, None] * seg).reshape(K, n_keep)
        pts = torch.gather(pts, 1, order[..., None].expand(-1, -1, d))
        ids = torch.gather(ids, 1, order)
        cut_dims.append(cut)
    cut_dims = torch.stack(cut_dims, dim=1)  # (K, L)

    leaves = pts.reshape(K, n_leaf, S, d)
    occ = torch.nn.functional.one_hot(ids.reshape(K, n_leaf, S), M).to(torch.float32).sum(dim=2)
    lo, hi = leaves.min(dim=2).values, leaves.max(dim=2).values  # (K, n_leaf, d)
    std = leaves.std(dim=2, correction=0)
    t_m = occ.sum(dim=1)  # (K, M) per-machine points after truncation
    # volume over the cut-dim multiset only: identical across a tree's
    # leaves in the un-cut dims, so the leaf softmax is exact
    log_span = torch.log(hi - lo + span_floor)  # (K, n_leaf, d)
    log_vol = torch.gather(
        log_span, 2, cut_dims[:, None, :].expand(-1, n_leaf, -1)
    ).sum(dim=-1)  # (K, n_leaf)
    log_w = (
        torch.log(occ + pseudocount).sum(dim=-1)
        - torch.log(t_m + pseudocount * n_leaf).sum(dim=-1, keepdim=True)
        - (M - 1) * log_vol
    )
    log_w = log_w - torch.logsumexp(log_w, dim=-1, keepdim=True)  # per tree

    # uniform tree mixture: (tree, leaf) jointly from the per-tree masses
    flat_logw = (log_w - math.log(K)).reshape(K * n_leaf)
    pick = categorical(gen, flat_logw, n_draws)
    tree_idx, leaf_idx = pick // n_leaf, pick % n_leaf
    if within == "uniform":
        u = torch.rand((n_draws, d), generator=gen, dtype=dtype, device=dev)
        draws = lo[tree_idx, leaf_idx] + u * (hi - lo)[tree_idx, leaf_idx]
    else:
        member = torch.randint(0, S, (n_draws,), generator=gen, device=dev)
        eps = torch.randn((n_draws, d), generator=gen, dtype=dtype, device=dev)
        draws = leaves[tree_idx, leaf_idx, member] + jitter * std[tree_idx, leaf_idx] * eps

    mix_logw = flat_logw - torch.logsumexp(flat_logw, dim=0)
    return CombineResult(
        samples=draws,
        acceptance_rate=torch.ones((), device=dev),  # one-shot estimator
        moments=None,
        extras={
            "depth": L,
            "n_trees": K,
            "leaf_size": S,
            # perplexity of the (tree, leaf) mixture — effective support size
            "leaf_perplexity": torch.exp(-(mix_logw.exp() * mix_logw).sum()),
        },
    )
