"""Bayesian logistic regression — paper §8.1.

The port of ``repro/models/bayes/logistic_regression.py``. Synthetic data as
§8.1.1: β and X standard normal, y_i ~ Bernoulli(σ(X_i β)), N=50,000, d=50;
``covtype`` is the same correlated, imbalanced stand-in as the reference.
The log-likelihood goes through the fused value-and-gradient kernel
(:mod:`repro_torch.kernels.logreg_loglik`); labels arrive as y ∈ {0, 1} and
become the kernel's s = 2y − 1 once per shard (:func:`signed_labels`).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels.logreg_loglik import logreg_loglik
from repro_torch.models.bayes import registry

Data = Dict[str, torch.Tensor]


def generate_data(
    gen: torch.Generator, n: int = 50_000, d: int = 50
) -> Tuple[Data, torch.Tensor]:
    """§8.1.1 synthetic set: X, β ~ N(0,1) elementwise; y ~ Bern(σ(Xβ))."""
    dev = gen.device
    beta = torch.randn((d,), generator=gen, device=dev)
    x = torch.randn((n, d), generator=gen, device=dev)
    p = torch.sigmoid(x @ beta)
    y = (torch.rand((n,), generator=gen, device=dev) < p).float()
    return {"x": x, "y": y}, beta


def generate_covtype_like(
    gen: torch.Generator, n: int = 581_012, d: int = 54
) -> Tuple[Data, torch.Tensor]:
    """Covtype stand-in: correlated features, heavier class imbalance."""
    dev = gen.device
    beta = torch.randn((d,), generator=gen, device=dev) * 0.5
    base = torch.randn((n, d), generator=gen, device=dev)
    mixer = torch.randn((d, d), generator=gen, device=dev) * (0.3 / math.sqrt(d))
    x = base + base @ mixer
    p = torch.sigmoid(x @ beta - 0.8)
    y = (torch.rand((n,), generator=gen, device=dev) < p).float()
    return {"x": x, "y": y}, beta


def log_prior(theta: torch.Tensor, sigma: float = 5.0) -> torch.Tensor:
    """β ~ N(0, σ² I), batched over leading axes of θ."""
    d = theta.shape[-1]
    return -0.5 * (theta**2).sum(dim=-1) / sigma**2 - 0.5 * d * math.log(
        2.0 * math.pi * sigma**2
    )


def signed_labels(data: Data) -> Data:
    """The data with the kernel's labels ``s = 2y − 1`` beside ``y``."""
    return {**data, "s": 2.0 * data["y"] - 1.0}


def log_lik(theta: torch.Tensor, data: Data) -> torch.Tensor:
    """Σ_i log σ(s_i · x_i β) with s_i = 2y_i − 1, through the fused kernel.

    θ ``(..., d)`` with ``x (..., N, d)``, ``y (..., N)`` → ``(...)``: each
    leading index is one problem of the kernel's batch. ``s`` is taken from
    the data where :func:`signed_labels` put it, else computed from ``y``.
    """
    x = data["x"]
    s = data["s"] if "s" in data else 2.0 * data["y"] - 1.0
    batch = theta.shape[:-1]
    d = theta.shape[-1]
    G = math.prod(batch)
    X = x.reshape(G, x.shape[-2], d)
    s = s.reshape(G, -1)
    return logreg_loglik(X, s, theta.reshape(G, d, 1))[:, 0].reshape(batch)


registry.register_model(
    registry.BayesModel(
        name="logreg",
        generate_data=generate_data,
        log_prior=log_prior,
        log_lik=log_lik,
        prepare_data=signed_labels,
        d=50,
        default_n=50_000,
        default_sampler="mala",
    ),
    "logistic_regression",
)

registry.register_model(
    registry.BayesModel(
        name="covtype",
        generate_data=lambda gen, n=581_012: generate_covtype_like(gen, n),
        log_prior=log_prior,
        log_lik=log_lik,
        prepare_data=signed_labels,
        d=54,
        default_n=581_012,
        default_sampler="mala",
    )
)
