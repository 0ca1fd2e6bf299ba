"""Pairwise-recursive combination — paper §3.2 (end) and §4.

The port of ``repro/core/tree_combine.py``. Applying a combiner to pairs of
subposteriors, then to pairs of the resulting sample sets, and so on,
reduces total work to O(dTM) and markedly improves IMG acceptance (with M̃=2
the proposal perturbs half the component).

Samples emitted by a pair's combiner are (asymptotically) draws from
``p_a · p_b`` — the subposterior of the merged shard — so recursion is
closed: round k operates on M/2^k sample sets.

``repro`` vmaps the pairs of a round; here the pairs of a round are combined
one after another, each from its own generator. Every round draws a
generator from the caller's, and each pair one from its round's, in pair
order, so a tree's draws depend only on the caller's generator.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core.combiners import CombineResult, filter_options, get_combiner


def _split(gen: torch.Generator, n: int) -> List[torch.Generator]:
    """``n`` generators seeded from ``gen``'s next draws, in order."""
    seeds = torch.randint(0, 2**62, (n,), generator=gen, device=gen.device).tolist()
    return [torch.Generator(device=gen.device).manual_seed(s) for s in seeds]


def _combine_pairs(
    gen: torch.Generator,
    pairs: torch.Tensor,  # (P, 2, T, d)
    counts: torch.Tensor,  # (P, 2)
    n_draws: int,
    method: str,
    rescale: bool,
) -> torch.Tensor:
    """Every pair of a round combined into ``n_draws`` rows: ``(P, n_draws, d)``."""
    combiner = get_combiner(method)
    # per-signature filtering: baselines without a bandwidth anneal do not
    # receive ``rescale`` (the combiners' option-forwarding convention)
    opts = filter_options(combiner, dict(rescale=rescale))
    out = torch.stack([
        combiner(g, pair, n_draws, counts=cnt, **opts).samples
        for g, pair, cnt in zip(_split(gen, pairs.shape[0]), pairs, counts)
    ])
    if out.shape[1] != n_draws:
        # e.g. "pool" emits the 2T-row union; the next round's valid-prefix
        # counts would then silently keep only the first machine's half.
        raise ValueError(
            f"combiner {method!r} returned {out.shape[1]} rows per pair instead "
            f"of n_draws={n_draws}; it cannot be used as a tree-reduction step"
        )
    return out


def tree_combine(
    gen: torch.Generator,
    samples: torch.Tensor,
    n_draws: int,
    *,
    counts: Optional[torch.Tensor] = None,
    method: str = "nonparametric",
    rescale: bool = False,
) -> CombineResult:
    """Combine ``(M, T, d)`` subposterior samples pairwise until one set remains.

    Odd set counts pass the last set through unchanged (paper §3.2), padded
    by wrapping its valid rows and keeping its own valid count. Output has
    ``n_draws`` samples. O(dTM) total work across all rounds.
    """
    M, T, d = samples.shape
    device = samples.device
    counts = (torch.full((M,), T, dtype=torch.int32, device=device) if counts is None
              else torch.as_tensor(counts, device=device).to(torch.int32))

    level, level_counts = samples, counts
    while level.shape[0] > 1:
        m = level.shape[0]
        n_pairs, odd = m // 2, m % 2 == 1
        paired = level[: 2 * n_pairs].reshape(n_pairs, 2, level.shape[1], d)
        paired_counts = level_counts[: 2 * n_pairs].reshape(n_pairs, 2)
        (sub,) = _split(gen, 1)
        out_t = n_draws if m == 2 else level.shape[1]
        combined = _combine_pairs(sub, paired, paired_counts, out_t, method, rescale)
        new_counts = torch.full((n_pairs,), out_t, dtype=torch.int32, device=device)
        if odd:
            # carry the unpaired set through, its rows wrapped to the round's length
            leftover, leftover_counts = level[-1:], level_counts[-1:]
            if leftover.shape[1] != combined.shape[1]:
                pad_t = combined.shape[1]
                idx = (torch.arange(pad_t, device=device)[None, :]
                       % leftover_counts[:, None].clamp(min=1))
                leftover = torch.gather(leftover, 1, idx[:, :, None].expand(-1, -1, d))
                leftover_counts = leftover_counts.clamp(max=pad_t)
            level = torch.cat([combined, leftover], dim=0)
            level_counts = torch.cat([new_counts, leftover_counts], dim=0)
        else:
            level, level_counts = combined, new_counts

    out = level[0]
    if out.shape[0] != n_draws:
        # the last level came from a pass-through with T != n_draws: wrap rows
        out = out[torch.arange(n_draws, device=device) % out.shape[0]]
    return CombineResult(samples=out, acceptance_rate=torch.ones((), device=device),
                         moments=None)
