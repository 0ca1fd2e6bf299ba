"""Bayes-model registry: the ``BayesModel`` surface behind the EP pipeline.

The port of ``repro/models/bayes/registry.py`` (the sampling surface; the
Gibbs surface comes with the models that need it). A model supplies

- ``generate_data(gen, n) -> (data, theta_true)`` from a torch Generator;
- ``log_prior(theta) -> (...)`` and ``log_lik(theta, data) -> (...)``, both
  batched over leading axes of θ ``(..., d)``; ``log_lik`` sums over the
  rows of a shard whose leading axes match θ's (``x (..., N, d)``);
- ``d``, ``default_n``, ``default_sampler`` and ``shard_keys`` as in
  ``repro``;
- ``prepare_data(data) -> data``: per-datum tensors derived once per shard
  before its chain runs, so that no step recomputes them (the identity
  unless the model gives one).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

Data = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BayesModel:
    """One paper-§8-style experiment family, pipeline-ready."""

    name: str
    generate_data: Callable[..., Tuple[Data, torch.Tensor]]
    log_prior: Callable[[torch.Tensor], torch.Tensor]
    log_lik: Callable[[torch.Tensor, Data], torch.Tensor]
    d: int
    default_n: int = 50_000
    default_sampler: str = "rwmh"
    shard_keys: Optional[Tuple[str, ...]] = None
    prepare_data: Callable[[Data], Data] = lambda data: data

    def initial_position(
        self, gen: torch.Generator, batch_shape: Tuple[int, ...]
    ) -> torch.Tensor:
        """θ0 for a batch of chains: a jittered origin, ``batch_shape + (d,)``."""
        return 0.01 * torch.randn(batch_shape + (self.d,), generator=gen, device=gen.device)


_REGISTRY: Dict[str, BayesModel] = {}
_CANONICAL: Dict[str, BayesModel] = {}


def register_model(model: BayesModel, *aliases: str) -> BayesModel:
    """Add a model to the registry under its name (+ aliases)."""
    for key in (model.name, *aliases):
        if key in _REGISTRY:
            raise ValueError(f"model {key!r} already registered")
        _REGISTRY[key] = model
    _CANONICAL[model.name] = model
    return model


def get_model(name: str) -> BayesModel:
    """Resolve a model by registry name (raises KeyError with choices)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; available: {', '.join(available_models())}"
        ) from None


def available_models() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def canonical_models() -> Tuple[str, ...]:
    return tuple(sorted(_CANONICAL))
