"""Sampler protocol + chain drivers, batched over chains by construction.

The port of ``repro/samplers/base.py``. A kernel is ``MCMCKernel(init, step)``:

- ``init(position) -> state``                 (``state.position`` exists)
- ``step(gen, state) -> (state, StepInfo)``   (one transition)

Positions are tensors ``(..., d)``; every leading axis is an independent
chain (the reference ``vmap``\\ s :func:`run_chain`; here the batch axis is
written out, and ``lax.scan`` is a Python loop). Randomness comes from an
explicit :class:`torch.Generator`.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

LogDensityFn = Callable[[torch.Tensor], torch.Tensor]


class MCMCKernel(NamedTuple):
    init: Callable[[torch.Tensor], Any]
    step: Callable[..., Tuple[Any, "StepInfo"]]


class StepInfo(NamedTuple):
    """Uniform per-step diagnostics, one entry per chain."""

    accept_prob: torch.Tensor
    is_accepted: torch.Tensor
    log_density: torch.Tensor


def chain_setup(
    gen: torch.Generator,
    kernel: "MCMCKernel | Callable[[torch.Tensor], MCMCKernel]",
    position: torch.Tensor,
    *,
    burn_in: int = 0,
    warmup: int = 0,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
) -> Tuple[MCMCKernel, Any, "torch.Tensor | float"]:
    """Warmup and burn-in of the chains in ``position (..., d)``:
    ``(kernel, state, step_size)``, ready for :func:`chain_collect`.

    ``kernel`` may be a factory ``step_size -> MCMCKernel``; ``warmup > 0``
    requires one: ``warmup`` dual-averaging transitions adapt each chain's
    step size toward ``target_accept`` from ``initial_step_size``, and the
    kernel returned is frozen at the adapted ``(..., 1)`` steps (the returned
    ``step_size``; ``initial_step_size`` otherwise). Warmup and burn-in
    transitions are discarded.
    """
    step_size: "torch.Tensor | float" = initial_step_size
    if warmup > 0:
        from repro_torch.samplers import adaptation

        if isinstance(kernel, MCMCKernel) or not callable(kernel):
            raise TypeError(
                "warmup needs a kernel factory (step_size -> MCMCKernel); "
                "got a built kernel whose step size cannot be adapted"
            )
        kernel, position, step_size = adaptation.warmup_chain(
            gen, kernel, position, warmup,
            initial_step_size=initial_step_size, target_accept=target_accept,
        )
    elif not isinstance(kernel, MCMCKernel) and callable(kernel):
        kernel = kernel(initial_step_size)
    state = kernel.init(position)
    for _ in range(burn_in):
        state, _ = kernel.step(gen, state)
    return kernel, state, step_size


def chain_collect(
    gen: torch.Generator,
    kernel: MCMCKernel,
    state: Any,
    num_samples: int,
    *,
    thin: int = 1,
) -> Tuple[Any, torch.Tensor, StepInfo]:
    """``num_samples`` kept draws from a live state: ``(state, (..., T, d),
    info (..., T))``; ``thin`` keeps every thin-th transition."""
    position = state.position
    batch = position.shape[:-1]
    out = torch.empty((num_samples,) + tuple(position.shape), dtype=position.dtype,
                      device=position.device)
    infos = []
    for t in range(num_samples):
        for _ in range(thin):
            state, info = kernel.step(gen, state)
        out[t] = state.position
        infos.append(info)
    stacked = StepInfo(*(torch.stack(f, dim=-1) for f in zip(*infos)))
    return state, out.movedim(0, len(batch)).contiguous(), stacked


def run_chain(
    gen: torch.Generator,
    kernel: "MCMCKernel | Callable[[torch.Tensor], MCMCKernel]",
    position: torch.Tensor,
    num_samples: int,
    *,
    burn_in: int = 0,
    thin: int = 1,
    warmup: int = 0,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
) -> Tuple[torch.Tensor, StepInfo]:
    """Drive the chains of ``position (..., d)``; returns ``(..., T, d)`` + info ``(..., T)``.

    :func:`chain_setup` (warmup, burn-in) then :func:`chain_collect`, which
    draw from ``gen`` in that order.
    """
    kernel, state, _ = chain_setup(
        gen, kernel, position, burn_in=burn_in, warmup=warmup,
        initial_step_size=initial_step_size, target_accept=target_accept,
    )
    _, out, info = chain_collect(gen, kernel, state, num_samples, thin=thin)
    return out, info


def run_chains(
    gen: torch.Generator,
    kernel: "MCMCKernel | Callable[[torch.Tensor], MCMCKernel]",
    positions: torch.Tensor,
    num_samples: int,
    **options,
) -> Tuple[torch.Tensor, StepInfo]:
    """:func:`run_chain` over a leading chain axis: ``(C, d)`` → ``(C, T, d)``.

    Every chain adapts its own step size under warmup; no chain reads
    another's state.
    """
    if positions.dim() < 2:
        raise ValueError(f"positions need a leading chain axis, got {tuple(positions.shape)}")
    return run_chain(gen, kernel, positions, num_samples, **options)
