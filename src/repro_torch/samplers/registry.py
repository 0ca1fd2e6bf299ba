"""Sampler registry: MCMC kernels behind one uniform factory signature.

The port of ``repro/samplers/registry.py``. A sampler factory is

    factory(logpdf, *, step_size, **options) -> MCMCKernel

registered with :func:`register_sampler` under a name, with the metadata the
warmup needs (:class:`SamplerSpec`: ``adaptive``, ``target_accept``).
Options broadcast over several samplers are filtered per factory signature
(:func:`filter_options`; ``**_ignored`` marks tolerated-but-unused keys).
Ported so far: ``mala``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.samplers.base import LogDensityFn, MCMCKernel
from repro_torch.samplers.mala import mala_kernel
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


@register_sampler("mala", target_accept=0.55)
def mala(
    logpdf: LogDensityFn, *, step_size: float | torch.Tensor = 0.05, **_ignored
) -> MCMCKernel:
    """Metropolis-adjusted Langevin."""
    return mala_kernel(logpdf, step_size=step_size)
