"""Combiner engine API: result type, registry, shared tensor helpers.

The port of the batch face of ``repro/core/combiners/api.py``. A combiner is

    combiner(gen, samples, n_draws, *, counts=None, **options) -> CombineResult

with ``samples`` the dense ``(M, T, d)`` subposterior stack, ``counts (M,)``
the valid prefix of each chain, and ``gen`` a :class:`torch.Generator` on the
samples' device. Implementations self-register with :func:`register`;
callers resolve them with :func:`get_combiner` and filter a shared option
dict per signature with :func:`filter_options`. Streaming faces come later.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import bandwidth as bw
from repro_torch.core.gaussian import GaussianMoments
from repro_torch.utils.options import filter_kwargs


class CombineResult(NamedTuple):
    """Output of a combination procedure (``extras``: combiner diagnostics)."""

    samples: torch.Tensor  # (n_draws, d)
    acceptance_rate: torch.Tensor  # IMG acceptance (1.0 for non-MCMC combiners)
    moments: Optional[GaussianMoments] = None
    extras: Optional[Dict[str, torch.Tensor]] = None


Combiner = Callable[..., CombineResult]
_REGISTRY: Dict[str, Combiner] = {}
_CANONICAL: Dict[str, Combiner] = {}


def register(name: str, *aliases: str) -> Callable[[Combiner], Combiner]:
    """Decorator: add a combiner to the registry under ``name`` (+ aliases)."""

    def deco(fn: Combiner) -> Combiner:
        for key in (name, *aliases):
            if key in _REGISTRY:
                raise ValueError(f"combiner {key!r} already registered")
            _REGISTRY[key] = fn
        _CANONICAL[name] = fn
        return fn

    return deco


def get_combiner(name: str) -> Combiner:
    """Resolve a combiner by registry name (raises KeyError with choices)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown combiner {name!r}; available: {', '.join(available_combiners())}"
        ) from None


def available_combiners() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def canonical_combiners() -> Tuple[str, ...]:
    return tuple(sorted(_CANONICAL))


def filter_options(combiner: Combiner, options: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only the ``options`` the combiner's signature declares
    (``**options`` passes everything through, ``**_ignored`` drops)."""
    return filter_kwargs(combiner, options)


Schedule = Callable[[torch.Tensor], torch.Tensor]


def resolve_schedule(
    samples: torch.Tensor, schedule: Optional[Schedule], rescale: bool
) -> Schedule:
    """Default bandwidth schedule: Algorithm 1's anneal, optionally rescaled
    by the pooled sample scale."""
    if schedule is not None:
        return schedule
    if rescale:
        scale = bw.pooled_scale(samples)
    else:
        scale = torch.ones((), dtype=samples.dtype, device=samples.device)
    return bw.annealed(samples.shape[-1], scale=scale)


def counts_or_full(samples: torch.Tensor, counts: Optional[torch.Tensor]) -> torch.Tensor:
    """Normalize ``counts`` to an int32 ``(M,)`` tensor (None ⇒ all-T)."""
    M, T, _ = samples.shape
    if counts is None:
        return torch.full((M,), T, dtype=torch.int32, device=samples.device)
    return torch.as_tensor(counts, device=samples.device).to(torch.int32)


def valid_masks(samples: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``(M, T)`` 0/1 mask of valid rows under ragged ``counts``."""
    T = samples.shape[1]
    t = torch.arange(T, device=samples.device)
    return (t[None, :] < counts[:, None]).to(samples.dtype)


def log_weight_bruteforce(theta_sel: torch.Tensor, h: torch.Tensor | float) -> torch.Tensor:
    """Unnormalized log w_t (Eq. 3.5) for selected samples ``(..., M, d)``."""
    mean = theta_sel.mean(dim=-2, keepdim=True)
    sse = ((theta_sel - mean) ** 2).sum(dim=(-1, -2))
    m, d = theta_sel.shape[-2:]
    h = torch.as_tensor(h, dtype=theta_sel.dtype, device=theta_sel.device)
    return -0.5 * sse / h**2 - m * (d / 2.0) * torch.log(2.0 * math.pi * h**2)
