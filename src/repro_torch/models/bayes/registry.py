"""Bayes-model registry: the ``BayesModel`` surface behind the EP pipeline.

The port of ``repro/models/bayes/registry.py``. A model supplies

- ``generate_data(gen, n) -> (data, theta_true)`` from a torch Generator;
- ``log_prior(theta) -> (...)`` and ``log_lik(theta, data) -> (...)``, both
  batched over leading axes of θ ``(..., d)``; ``log_lik`` sums over the
  rows of a shard whose leading axes match θ's (``x (..., N, d)``);
- ``d``, ``default_n``, ``default_sampler`` and ``shard_keys`` as in
  ``repro``;
- ``prepare_data(data) -> data``: per-datum tensors derived once per shard
  before its chain runs, so that no step recomputes them (the identity
  unless the model gives one);
- ``init_position(gen, batch_shape) -> θ0``, an optional override of the
  jittered-origin start;
- the optional Gibbs surface (paper §8.3): ``gibbs_blocks(shards,
  num_shards, *, step_size[, count])`` builds the block updates
  (:class:`repro_torch.samplers.gibbs.BlockUpdate`) against concrete stacked
  shards ``(M, S, ...)``; ``gibbs_init(gen, shards)`` gives the M chains'
  starting positions, a tensor ``(M, d)`` or a NamedTuple of tensors with
  leading axis M when the state carries shard-local latents;
  ``gibbs_extract(positions)`` projects them to the shared θ ``(..., d)``.
  ``gibbs_counts=True`` declares that ``gibbs_blocks`` takes ``count=``
  (the valid rows of each shard, ``(M,)``) and masks the edge-padded rows
  out of its conditionals.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

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
    init_position: Optional[Callable[[torch.Generator, Tuple[int, ...]], torch.Tensor]] = None
    gibbs_blocks: Optional[Callable[..., Any]] = None
    gibbs_init: Optional[Callable[[torch.Generator, Data], Any]] = None
    gibbs_extract: Optional[Callable[[Any], torch.Tensor]] = None
    gibbs_counts: bool = False  # gibbs_blocks masks padded rows via count=

    def initial_position(
        self, gen: torch.Generator, batch_shape: Tuple[int, ...]
    ) -> torch.Tensor:
        """θ0 for a batch of chains, ``batch_shape + (d,)``: the model's
        override, or a jittered origin."""
        if self.init_position is not None:
            return self.init_position(gen, batch_shape)
        return 0.01 * torch.randn(batch_shape + (self.d,), generator=gen, device=gen.device)

    @property
    def has_gibbs(self) -> bool:
        return self.gibbs_blocks is not None


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
