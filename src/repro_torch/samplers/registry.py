"""Sampler registry: MCMC kernels behind one uniform factory signature.

The port of ``repro/samplers/registry.py``. A sampler factory is

    factory(logpdf, *, step_size, **options) -> MCMCKernel

registered with :func:`register_sampler` under a name, with the metadata the
warmup needs (:class:`SamplerSpec`: ``adaptive``, ``target_accept``).
Options broadcast over several samplers are filtered per factory signature
(:func:`filter_options`; ``**_ignored`` marks tolerated-but-unused keys).
The registry holds ``repro``'s five: ``rwmh`` (alias ``mh``), ``mala``,
``hmc``, ``gibbs`` (alias ``metropolis_within_gibbs``) and ``sgld``. Every
kernel they build has a ``draw``, so its chain loop can run as a captured
CUDA graph; where ``repro``'s factory takes a callable that draws from a key
(``rwmh``'s ``proposal_fn``, ``sgld``'s ``batch_fn``), the port's takes one
that reads inputs drawn apart from it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.samplers.base import LogDensityFn, MCMCKernel, StepInfo
from repro_torch.samplers.gibbs import BlockUpdate, gibbs_kernel
from repro_torch.samplers.hmc import hmc_kernel
from repro_torch.samplers.mala import mala_kernel, value_and_grad
from repro_torch.samplers.rwmh import Proposal, rwmh_kernel
from repro_torch.samplers.sgld import sgld_kernel
from repro_torch.utils.options import filter_kwargs

SamplerFactory = Callable[..., MCMCKernel]


class SamplerSpec(NamedTuple):
    """Registry entry: factory + the metadata the warmup phase needs."""

    name: str
    factory: SamplerFactory
    adaptive: bool
    target_accept: float


_REGISTRY: Dict[str, SamplerSpec] = {}
_CANONICAL: Dict[str, SamplerSpec] = {}


def register_sampler(
    name: str, *aliases: str, adaptive: bool = True, target_accept: float = 0.8
) -> Callable[[SamplerFactory], SamplerFactory]:
    """Decorator: add a sampler factory to the registry under ``name``."""

    def deco(fn: SamplerFactory) -> SamplerFactory:
        spec = SamplerSpec(name, fn, adaptive, target_accept)
        for key in (name, *aliases):
            if key in _REGISTRY:
                raise ValueError(f"sampler {key!r} already registered")
            _REGISTRY[key] = spec
        _CANONICAL[name] = spec
        return fn

    return deco


def sampler_spec(name: str) -> SamplerSpec:
    """Resolve the full registry entry (raises KeyError with choices)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown sampler {name!r}; available: {', '.join(available_samplers())}"
        ) from None


def get_sampler(name: str) -> SamplerFactory:
    return sampler_spec(name).factory


def available_samplers() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def canonical_samplers() -> Tuple[str, ...]:
    return tuple(sorted(_CANONICAL))


def filter_options(factory: SamplerFactory, options: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only the keyword options the factory's signature declares."""
    return filter_kwargs(factory, options)


@register_sampler("rwmh", "mh", target_accept=0.35)
def rwmh(
    logpdf: LogDensityFn,
    *,
    step_size: float | torch.Tensor = 0.1,
    proposal_fn: Optional[Proposal] = None,
    **_ignored,
) -> MCMCKernel:
    """Random-walk Metropolis–Hastings (paper §2's example sampler)."""
    return rwmh_kernel(logpdf, step_size=step_size, proposal_fn=proposal_fn)


@register_sampler("mala", target_accept=0.55)
def mala(
    logpdf: LogDensityFn, *, step_size: float | torch.Tensor = 0.05, **_ignored
) -> MCMCKernel:
    """Metropolis-adjusted Langevin."""
    return mala_kernel(logpdf, step_size=step_size)


@register_sampler("hmc", target_accept=0.8)
def hmc(
    logpdf: LogDensityFn,
    *,
    step_size: float | torch.Tensor = 0.1,
    num_integration_steps: int = 10,
    inv_mass: Optional[torch.Tensor] = None,
    **_ignored,
) -> MCMCKernel:
    """Fixed-length HMC with jittered trajectory length."""
    return hmc_kernel(logpdf, step_size=step_size,
                      num_integration_steps=num_integration_steps, inv_mass=inv_mass)


@register_sampler("gibbs", "metropolis_within_gibbs", adaptive=False)
def gibbs(
    logpdf: Optional[LogDensityFn],
    *,
    step_size: float = 0.1,
    block_updates: Sequence[BlockUpdate] = (),
    **_ignored,
) -> MCMCKernel:
    """(Metropolis-within-)Gibbs over model-supplied block updates.

    The blocks come from the model (``BayesModel.gibbs_blocks``, built
    against concrete shards); ``step_size`` is the scale the model used for
    its MH-within-Gibbs blocks, accepted here for signature uniformity.
    ``logpdf`` may be ``None`` (a Gibbs position may carry latents the flat-θ
    log-density cannot score); the kernel uses it for diagnostics only.
    """
    if not block_updates:
        raise ValueError(
            "gibbs requires model-supplied block_updates (see BayesModel.gibbs_blocks)"
        )
    return gibbs_kernel(list(block_updates), logdensity=logpdf)


@register_sampler("sgld", adaptive=False)
def sgld(
    logpdf: Optional[LogDensityFn],
    *,
    step_size: float | torch.Tensor | Callable[[torch.Tensor], torch.Tensor] = 1e-3,
    grad_logpdf: Optional[Callable[[torch.Tensor, Any], torch.Tensor]] = None,
    batch_fn: Optional[Callable[[torch.Tensor, torch.Tensor], Any]] = None,
    batch_size: int = 0,
    preconditioner: Optional[str] = None,
    temperature: float = 1.0,
    **_ignored,
) -> MCMCKernel:
    """SGLD in the ``(init, step, draw)`` protocol.

    Minibatch mode (paper §7): ``grad_logpdf(theta, batch)`` is the
    minibatch gradient and ``batch_fn(u, t)`` forms step ``t``'s batch from
    ``u``, uniforms ``(..., batch_size)`` drawn apart from the step (the
    reference's ``batch_fn(key, t)`` draws from a key instead). With both
    left ``None`` the kernel is full-gradient (unadjusted) Langevin on
    ``logpdf``. No MH correction, so ``accept_prob`` is 1 and the sampler is
    not adaptive. Inputs, in the reference's order: the batch's uniforms
    (minibatch mode only), then the noise ``(..., d)``.
    """
    if grad_logpdf is None:
        if logpdf is None:
            raise ValueError("sgld needs logpdf or an explicit grad_logpdf")
        grad_logpdf = lambda theta, _batch: value_and_grad(logpdf, theta)[1]  # noqa: E731
    if batch_fn is not None and batch_size <= 0:
        raise ValueError("sgld's batch_fn needs batch_size > 0 (the uniforms a step draws)")
    base = sgld_kernel(grad_logpdf, step_size=step_size, preconditioner=preconditioner,
                       temperature=temperature)

    def draw(gen: torch.Generator, position: torch.Tensor, out=None):
        like = dict(dtype=position.dtype, device=position.device)
        if out is None:
            u = (torch.rand(position.shape[:-1] + (batch_size,), generator=gen, **like),) \
                if batch_fn is not None else ()
            return (*u, torch.randn(position.shape, generator=gen, **like))
        for buf, fill in zip(out, ((torch.rand,) if batch_fn is not None else ()) + (torch.randn,)):
            fill(buf.shape, generator=gen, out=buf)
        return out

    def step(gen: Optional[torch.Generator], state, *inputs):
        """One transition; ``inputs`` (the batch's uniforms, the noise) may be given."""
        if not inputs:
            inputs = draw(gen, state.position)
        if batch_fn is None:
            batch, (noise,) = None, inputs
        else:
            u, noise = inputs
            batch = batch_fn(u, state.step)
        state, _ = base.step(state, batch, noise)
        pos = state.position
        batch_shape = pos.shape[:-1]
        info = StepInfo(torch.ones(batch_shape, dtype=pos.dtype, device=pos.device),
                        torch.ones(batch_shape, dtype=torch.bool, device=pos.device),
                        torch.zeros(batch_shape, dtype=pos.dtype, device=pos.device))
        return state, info

    return MCMCKernel(init=base.init, step=step, draw=draw)
