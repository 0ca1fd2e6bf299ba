"""Generic Gibbs / Metropolis-within-Gibbs composition, batched over chains.

The port of ``repro/samplers/gibbs.py``. A Gibbs kernel is assembled from
block updates, each of which resamples one block of the position from its
full conditional (or makes an MH-within-Gibbs move for a non-conjugate
block). The reference's block is ``update(key, position) -> position``; here
a :class:`BlockUpdate` splits it in two, so that a sweep can run inside a
captured CUDA graph:

- ``draw(gen, position, out=None) -> inputs``: the block's random inputs
  (they depend on the position's shapes, never its values);
- ``update(position, *inputs) -> (position, unresolved)``: the move itself,
  with no host synchronisation; ``unresolved`` is ``None`` or a 0-d count of
  lanes a rejection sampler left with no accepted round
  (:mod:`repro_torch.samplers.randgamma`).

The kernel sums ``unresolved`` into its state, and its ``check`` raises once
the count is read outside the graph and is not zero.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.samplers.base import (
    LogDensityFn,
    MCMCKernel,
    StepInfo,
    tree_leaves,
    tree_where,
)


class BlockUpdate(NamedTuple):
    draw: Callable[..., Tuple[torch.Tensor, ...]]
    update: Callable[..., Tuple[Any, Optional[torch.Tensor]]]


class GibbsState(NamedTuple):
    position: Any  # (..., d), or a NamedTuple of tensors sharing the chain axes
    unresolved: torch.Tensor  # () int64: gamma lanes with no accepted round, summed


def chain_shape(position: Any) -> Tuple[int, ...]:
    """The chain axes of a position: the first tensor's leading axes."""
    return tuple(tree_leaves(position)[0].shape[:-1])


def gibbs_kernel(
    block_updates: Sequence[BlockUpdate],
    logdensity: Optional[LogDensityFn] = None,
) -> MCMCKernel:
    """Compose block updates into one sweep; ``logdensity`` is only used to
    report diagnostics (Gibbs sweeps always "accept")."""
    blocks = list(block_updates)

    def init(position: Any) -> GibbsState:
        leaf = tree_leaves(position)[0]
        return GibbsState(position, torch.zeros((), dtype=torch.int64, device=leaf.device))

    def draw(gen: torch.Generator, position: Any, out=None):
        """Every block's inputs, block by block in sweep order."""
        if out is None:
            return tuple(b.draw(gen, position) for b in blocks)
        return tuple(b.draw(gen, position, out=o) for b, o in zip(blocks, out))

    def step(gen: Optional[torch.Generator], state: GibbsState, *inputs):
        """One sweep; ``inputs`` (one tuple a block, as ``draw`` gives them)
        may be given, else each block draws its own before it moves."""
        position, unresolved = state
        for i, block in enumerate(blocks):
            ins = inputs[i] if inputs else block.draw(gen, position)
            position, n = block.update(position, *ins)
            if n is not None:
                unresolved = unresolved + n
        batch = chain_shape(position)
        leaf = tree_leaves(position)[0]
        ld = (logdensity(position) if logdensity is not None
              else torch.zeros(batch, dtype=leaf.dtype, device=leaf.device))
        info = StepInfo(torch.ones(batch, dtype=leaf.dtype, device=leaf.device),
                        torch.ones(batch, dtype=torch.bool, device=leaf.device), ld)
        return GibbsState(position, unresolved), info

    def check(state: GibbsState) -> None:
        n = int(state.unresolved)  # waits for the device: outside the graph only
        if n:
            raise RuntimeError(
                f"gibbs: {n} gamma lanes accepted in none of their rejection rounds; "
                "no draw is substituted"
            )

    return MCMCKernel(init=init, step=step, draw=draw, check=check)


def mh_within_gibbs_update(
    conditional_logdensity: Callable[[Any], torch.Tensor],
    select: Callable[[Any], torch.Tensor],
    replace: Callable[[Any, torch.Tensor], Any],
    step_size: float = 0.1,
) -> BlockUpdate:
    """Random-walk MH update of one block (for non-conjugate conditionals).

    ``select(position)`` extracts the block ``(..., k)`` (the chain axes, then
    the block's own); ``replace(position, block)`` writes it back;
    ``conditional_logdensity(position) -> (...)`` is the joint (terms
    constant in the block cancel). Inputs: the proposal's normal ``(..., k)``,
    then ``log u (...)``, the reference's order.
    """

    def draw(gen: torch.Generator, position: Any, out=None):
        block = select(position)
        if out is None:
            noise = torch.randn(block.shape, generator=gen, dtype=block.dtype,
                                device=block.device)
            log_u = torch.rand(block.shape[:-1], generator=gen, dtype=block.dtype,
                               device=block.device)
        else:
            noise, log_u = out
            torch.randn(noise.shape, generator=gen, out=noise)
            torch.rand(log_u.shape, generator=gen, out=log_u)
        return noise, log_u.log_()

    def update(position: Any, noise: torch.Tensor, log_u: torch.Tensor):
        proposal = replace(position, select(position) + step_size * noise)
        log_ratio = conditional_logdensity(proposal) - conditional_logdensity(position)
        return tree_where(log_u < log_ratio, proposal, position), None

    return BlockUpdate(draw, update)
