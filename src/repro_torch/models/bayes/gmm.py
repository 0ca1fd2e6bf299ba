"""Gaussian mixture model with known weights — paper §8.2 (multimodal case).

The port of ``repro/models/bayes/gmm.py``. Data: 50,000 draws from a K=10
component mixture of 2-d Gaussians; the posterior is over the K component
means (θ ∈ R^{K·2}), the weights and the component variance known. Label
permutations leave the posterior invariant, so the posterior over any single
mean has K modes.

:func:`permutation_rw_proposal` is the paper's MH move ("the component
labels were permuted before each step"): a uniform random permutation of the
K means, then Gaussian jitter. Its permutation comes from the argsort of
uniforms drawn apart from the move, so a chain using it can run as a
captured CUDA graph.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.bayes import registry
from repro_torch.samplers.rwmh import Proposal

Data = Dict[str, torch.Tensor]

K_DEFAULT = 10
DIM = 2


def generate_data(
    gen: torch.Generator,
    n: int = 50_000,
    k: int = K_DEFAULT,
    component_std: float = 1.0,
    spread: float = 8.0,
) -> Tuple[Data, torch.Tensor]:
    """Mixture of k 2-d Gaussians with uniform weights, means on a ring."""
    dev = gen.device
    angles = torch.arange(k, device=dev, dtype=torch.float32) * (2.0 * math.pi / k)
    ring = spread * torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)
    means = ring + torch.randn((k, DIM), generator=gen, device=dev)
    assign = torch.randint(0, k, (n,), generator=gen, device=dev)
    x = means[assign] + component_std * torch.randn((n, DIM), generator=gen, device=dev)
    weights = torch.full((k,), 1.0 / k, device=dev)
    return ({"x": x, "weights": weights,
             "component_std": torch.tensor(component_std, device=dev)}, means)


def log_prior(theta: torch.Tensor, sigma: float = 20.0) -> torch.Tensor:
    """Means ~ N(0, σ² I), broad (θ the flattened (K·2,) means), batched."""
    d = theta.shape[-1]
    return -0.5 * (theta**2).sum(dim=-1) / sigma**2 - 0.5 * d * math.log(
        2.0 * math.pi * sigma**2
    )


def log_lik(theta: torch.Tensor, data: Data) -> torch.Tensor:
    """Σ_i log Σ_k w_k N(x_i | μ_k, s² I) with known w, s: θ ``(..., K·2)``
    with ``x (..., N, 2)`` → ``(...)``."""
    k = data["weights"].shape[-1]
    means = theta.reshape(theta.shape[:-1] + (k, DIM))
    s2 = data["component_std"] ** 2
    x = data["x"]
    sq = ((x.unsqueeze(-2) - means.unsqueeze(-3)) ** 2).sum(dim=-1)  # (..., N, K)
    log_comp = -0.5 * sq / s2 - torch.log(2.0 * math.pi * s2)
    return torch.logsumexp(log_comp + torch.log(data["weights"]), dim=-1).sum(dim=-1)


def permutation_rw_proposal(k: int, step_size: float = 0.05) -> Proposal:
    """Proposal for §8.2 MH: permute component means uniformly, then RW jitter.

    Both pieces are symmetric, so plain Metropolis acceptance applies. The
    inputs are ``k`` uniforms a chain, whose argsort is its permutation (a
    uniform one: ties have probability 0 in practice), then the jitter's
    normals ``(..., k·2)``.
    """

    def draw(gen: torch.Generator, theta: torch.Tensor, out: Optional[tuple] = None):
        if out is None:
            keys = torch.rand(theta.shape[:-1] + (k,), generator=gen, dtype=theta.dtype,
                              device=theta.device)
            noise = torch.randn(theta.shape, generator=gen, dtype=theta.dtype,
                                device=theta.device)
        else:
            keys, noise = out
            torch.rand(keys.shape, generator=gen, out=keys)
            torch.randn(noise.shape, generator=gen, out=noise)
        return keys, noise

    def move(theta: torch.Tensor, keys: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        perm = torch.argsort(keys, dim=-1)
        return permute_means(theta, perm, k) + step_size * noise

    return Proposal(draw, move)


def permute_means(theta: torch.Tensor, perm: torch.Tensor, k: int) -> torch.Tensor:
    """θ with its K means reordered: mean j of the result is mean perm[j]."""
    means = theta.reshape(theta.shape[:-1] + (k, DIM))
    idx = perm.unsqueeze(-1).expand(perm.shape + (DIM,))
    return torch.gather(means, -2, idx).reshape(theta.shape)


def single_mean_marginal(samples: torch.Tensor, component: int = 0) -> torch.Tensor:
    """The ``(T, 2)`` marginal of one mean component (Fig. 4's view)."""
    t = samples.shape[0]
    return samples.reshape(t, -1, DIM)[:, component, :]


registry.register_model(
    registry.BayesModel(
        name="gmm",
        generate_data=generate_data,
        log_prior=log_prior,
        log_lik=log_lik,
        d=K_DEFAULT * DIM,
        default_n=50_000,
        default_sampler="rwmh",
        # only x is per-datum; the mixture weights and component_std go to
        # every shard whole
        shard_keys=("x",),
    )
)
