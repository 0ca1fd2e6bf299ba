"""The embarrassingly parallel sampling stage behind ``repro_torch.api``.

The port of ``repro/api/sampling.py`` for MH-style samplers. The reference
``vmap``\\ s one chain function over the shards; here the M chains are one
batch from the start: positions ``(M, d)``, per-chain step sizes ``(M, 1)``,
and a subposterior log-density ``(M, d) -> (M,)`` over the stacked shards.
No chain reads another chain's state.

The chain driver comes in two parts, after the reference's chunk backend
(``repro/api/backends.py``, ``_setup_one`` / ``_chunk_one``):
:func:`setup_shard_chains` (init, warmup, burn-in) and :func:`shard_chunk`
(the next n kept draws). Both draw from one generator in order, so a run cut
into chunks of any size draws exactly the numbers of the one-shot run, which
is setup plus one chunk of T.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.subposterior import (
    LogDensityFn,
    make_subposterior_logpdf,
    partition_data,
)
from repro_torch.models.bayes import BayesModel
from repro_torch.samplers import chain_collect, chain_setup, filter_options, sampler_spec
from repro_torch.samplers.base import MCMCKernel, TransitionLoop

Data = Dict[str, torch.Tensor]


class SampleResult(NamedTuple):
    """Output of the parallel sampling stage."""

    theta: torch.Tensor  # (M, T, d)
    accept: torch.Tensor  # (M,) mean acceptance per chain
    counts: torch.Tensor  # (M,) real data rows per shard
    backend: str


class ShardKernel(NamedTuple):
    """One (model, sampler) pairing, ready for a batch of shards.

    ``logpdf(shards, counts)`` is the batched subposterior log-density;
    ``build(logpdf, step_size)`` the kernel at a (per-chain) step size.
    """

    init_position: Callable[[torch.Generator, Tuple[int, ...]], torch.Tensor]
    logpdf: Callable[[Data, torch.Tensor], LogDensityFn]
    build: Callable[[LogDensityFn, torch.Tensor], MCMCKernel]
    adaptive: bool
    target_accept: float


def make_shard_kernel(
    model: BayesModel,
    num_shards: int,
    sampler: str,
    *,
    use_counts: bool = True,
    sampler_options=(),
) -> ShardKernel:
    """Package one registry sampler for one model (MH-style samplers).

    ``use_counts=False`` drops the padded-row correction (every row is
    real). ``sampler_options`` is filtered per factory signature; the keys
    this layer owns are dropped.
    """
    spec = sampler_spec(sampler)
    reserved = ("step_size", "block_updates", "grad_logpdf", "batch_fn")
    extra = {
        k: v
        for k, v in filter_options(spec.factory, dict(sampler_options)).items()
        if k not in reserved
    }

    def logpdf(shards, counts):
        return make_subposterior_logpdf(
            model.log_prior, model.log_lik, model.prepare_data(shards), num_shards,
            count=counts if use_counts else None, per_datum=model.shard_keys,
        )

    return ShardKernel(
        init_position=model.initial_position,
        logpdf=logpdf,
        build=lambda lp, step_size: spec.factory(lp, step_size=step_size, **extra),
        adaptive=spec.adaptive,
        target_accept=spec.target_accept,
    )


def setup_shard_chains(
    sk: ShardKernel,
    lp: LogDensityFn,
    gen: torch.Generator,
    n_chains: int,
    *,
    burn_in: int,
    warmup: int,
    step_size: float,
) -> Tuple[Any, "torch.Tensor | float"]:
    """Init, warmup and burn-in of ``n_chains`` chains on the batched
    log-density ``lp``: ``(kernel state, step size)``.

    Adaptive kernels spend ``warmup`` dual-averaging transitions per chain
    and return their adapted ``(M, 1)`` steps; non-adaptive ones treat the
    warmup as extra burn-in and return ``step_size``. ``sk.build(lp, step)``
    rebuilds the kernel the setup ended with.
    """
    pos0 = sk.init_position(gen, (n_chains,))
    if sk.adaptive and warmup > 0:
        _, state, eps = chain_setup(
            gen, lambda e: sk.build(lp, e), pos0,
            burn_in=burn_in, warmup=warmup,
            initial_step_size=step_size, target_accept=sk.target_accept,
        )
    else:
        _, state, eps = chain_setup(
            gen, sk.build(lp, step_size), pos0,
            burn_in=burn_in + (0 if sk.adaptive else warmup), initial_step_size=step_size,
        )
    return state, eps


def shard_chunk(
    kernel: "MCMCKernel | TransitionLoop", gen: torch.Generator, state: Any, n: int
) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """The next ``n`` kept draws of every chain: ``(state, theta (M, n, d),
    accepted (M, n) bool)``; ``kernel`` may be a kept collection loop."""
    state, theta, info = chain_collect(gen, kernel, state, n)
    return state, theta, info.is_accepted


def run_shard_chain(
    sk: ShardKernel,
    shards: Data,
    counts: torch.Tensor,
    gen: torch.Generator,
    *,
    num_samples: int,
    burn_in: int,
    warmup: int,
    step_size: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chains of all shards in one go: ``(theta (M, T, d), mean_accept (M,))``,
    :func:`setup_shard_chains` then one :func:`shard_chunk` of T."""
    lp = sk.logpdf(shards, counts)
    state, eps = setup_shard_chains(
        sk, lp, gen, counts.shape[0], burn_in=burn_in, warmup=warmup, step_size=step_size
    )
    _, theta, accepted = shard_chunk(sk.build(lp, eps), gen, state, num_samples)
    return theta, accepted.to(torch.float32).mean(dim=-1)


def is_padded(model: BayesModel, shards: Data, counts: torch.Tensor) -> bool:
    """Whether some shard holds edge-padded rows (then the counts correct the
    log-likelihood)."""
    keys = model.shard_keys or tuple(shards)
    return bool((counts != shards[keys[0]].shape[1]).any())


def sample_subposteriors(
    gen: torch.Generator,
    model: BayesModel,
    data: Data,
    num_shards: int,
    num_samples: int,
    *,
    sampler: Optional[str] = None,
    warmup: int = 200,
    burn_in: int = 0,
    step_size: float = 0.1,
    sampler_options=(),
    shards: Optional[Data] = None,
    counts: Optional[torch.Tensor] = None,
) -> SampleResult:
    """M independent subposterior chains, batched on the data's device.

    Partitions ``data`` (edge-padded) unless ``shards``/``counts`` are given.
    """
    from repro_torch.api.backends import BackendId

    if shards is None or counts is None:
        shards, counts = partition_data(data, num_shards, only=model.shard_keys, pad=True)
    sk = make_shard_kernel(
        model, num_shards, sampler or model.default_sampler,
        use_counts=is_padded(model, shards, counts), sampler_options=sampler_options,
    )
    theta, acc = run_shard_chain(
        sk, shards, counts, gen,
        num_samples=num_samples, burn_in=burn_in, warmup=warmup, step_size=step_size,
    )
    return SampleResult(theta, acc, counts, BackendId.batched(counts.device.type))


def groundtruth_chain(
    gen: torch.Generator,
    model: BayesModel,
    data: Data,
    num_samples: int,
    *,
    sampler: Optional[str] = None,
    warmup: int = 200,
    burn_in: int = 0,
    step_size: float = 0.1,
    sampler_options=(),
) -> torch.Tensor:
    """Single full-data chain (num_shards=1) → ``(T, d)``."""
    sk = make_shard_kernel(
        model, 1, sampler or model.default_sampler,
        use_counts=False, sampler_options=sampler_options,
    )
    keys = model.shard_keys or tuple(data)
    one = {k: (v.unsqueeze(0) if k in keys else v) for k, v in data.items()}
    counts = torch.full((1,), data[keys[0]].shape[0], dtype=torch.int32,
                        device=data[keys[0]].device)
    theta, _ = run_shard_chain(
        sk, one, counts, gen,
        num_samples=num_samples, burn_in=burn_in, warmup=warmup, step_size=step_size,
    )
    return theta[0]
