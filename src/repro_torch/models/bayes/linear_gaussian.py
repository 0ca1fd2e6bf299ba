"""Bayesian linear regression with known noise — the exactness test oracle.

The port of ``repro/models/bayes/linear_gaussian.py``. y = Xβ + ε,
ε ~ N(0, σ²), prior β ~ N(0, τ² I). The posterior is Gaussian in closed form,
and so is every subposterior p_m(β) ∝ N(β|0, Mτ² I)·N(y_m|X_m β, σ²): the
parametric combiner recovers the full posterior up to Monte Carlo error.

Batched over chains: θ ``(..., d)`` with ``x (..., N, d)``, ``y (..., N)``.
The Gibbs path samples β in coordinate blocks from their exact conditionals.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.gaussian import GaussianMoments
from repro_torch.models.bayes import registry
from repro_torch.samplers.gibbs import BlockUpdate
from repro_torch.utils.rowwise import colsum, matvec, rowdot, rowsum

Data = Dict[str, torch.Tensor]


def generate_data(
    gen: torch.Generator, n: int = 10_000, d: int = 10, noise_std: float = 1.0
) -> Tuple[Data, torch.Tensor]:
    dev = gen.device
    beta = torch.randn((d,), generator=gen, device=dev)
    x = torch.randn((n, d), generator=gen, device=dev)
    y = x @ beta + noise_std * torch.randn((n,), generator=gen, device=dev)
    return {"x": x, "y": y}, beta


def log_prior(theta: torch.Tensor, tau: float = 3.0) -> torch.Tensor:
    d = theta.shape[-1]
    return -0.5 * (theta**2).sum(dim=-1) / tau**2 - 0.5 * d * math.log(2.0 * math.pi * tau**2)


class SquaredResiduals(torch.autograd.Function):
    """Σ_s (y_s − x_s·θ)² per chain and its gradient −2·Σ_s x_s (y_s − x_s·θ),
    every sum in an order the chain's own rows fix (``utils/rowwise.py``):
    the residuals from elementwise products, not the batched library
    ``gemv``, and the backward's sum over the shard's S rows by ``colsum``,
    not autograd's reduction over ``(M, S, d)``, whose split on the card
    follows M. So a chain draws the same bits in a group of five as among
    ten."""

    @staticmethod
    def forward(ctx, theta, x, y):
        resid = y - rowdot(x, theta)
        ctx.save_for_backward(x, resid)
        ctx.theta_shape = theta.shape
        return rowsum(resid * resid)

    @staticmethod
    def backward(ctx, g):
        x, resid = ctx.saved_tensors
        grad = (-2.0 * g).unsqueeze(-1) * colsum(x * resid.unsqueeze(-1))
        return grad.sum_to_size(ctx.theta_shape), None, None


def log_lik(theta: torch.Tensor, data: Data, noise_std: float = 1.0) -> torch.Tensor:
    n = data["y"].shape[-1]
    sse = SquaredResiduals.apply(theta, data["x"], data["y"])
    return -0.5 * sse / noise_std**2 - 0.5 * n * math.log(2.0 * math.pi * noise_std**2)


def _moments(x, y, prior_prec, noise_std) -> GaussianMoments:
    d = x.shape[-1]
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    prec = eye * prior_prec + (x.transpose(-1, -2) @ x) / noise_std**2
    chol = torch.linalg.cholesky(prec)
    mean = torch.cholesky_solve((x.transpose(-1, -2) @ y.unsqueeze(-1)) / noise_std**2,
                                chol).squeeze(-1)
    cov = torch.cholesky_solve(eye.expand_as(prec), chol)
    return GaussianMoments(mean=mean, cov=0.5 * (cov + cov.transpose(-1, -2)))


def posterior_moments(data: Data, tau: float = 3.0, noise_std: float = 1.0) -> GaussianMoments:
    """Exact posterior N(μ*, Σ*): Σ* = (I/τ² + XᵀX/σ²)⁻¹, μ* = Σ* Xᵀy/σ²."""
    return _moments(data["x"], data["y"], 1.0 / tau**2, noise_std)


def subposterior_moments(
    data_shard: Data, num_shards: int, tau: float = 3.0, noise_std: float = 1.0
) -> GaussianMoments:
    """Exact moments of one subposterior (prior underweighted to 1/M); batched
    over leading shard axes of ``x (..., N, d)``."""
    return _moments(data_shard["x"], data_shard["y"], 1.0 / (num_shards * tau**2), noise_std)


# ---------------------------------------------------------------------------
# Gibbs path (conjugate coordinate blocks)
# ---------------------------------------------------------------------------


def block_statistics(
    data: Data,
    num_shards: int,
    tau: float = 3.0,
    noise_std: float = 1.0,
    count: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The subposterior's precision A = I/(Mτ²) + XᵀX/σ² ``(..., d, d)`` and
    shift b = Xᵀy/σ² ``(..., d)``; ``count (...)`` weights the rows past each
    shard's real ones by 0 (the edge-pad convention)."""
    x, y = data["x"], data["y"]
    d = x.shape[-1]
    if count is None:
        xw = x
    else:
        rows = torch.arange(x.shape[-2], device=x.device)
        w = (rows < count.unsqueeze(-1)).to(x.dtype)
        xw = x * w.unsqueeze(-1)
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    A = eye / (num_shards * tau**2) + (xw.transpose(-1, -2) @ x) / noise_std**2
    b = (xw.transpose(-1, -2) @ y.unsqueeze(-1)).squeeze(-1) / noise_std**2
    return A, b


def gibbs_blocks(
    data: Data,
    num_shards: int,
    n_blocks: int = 2,
    tau: float = 3.0,
    noise_std: float = 1.0,
    count: Optional[torch.Tensor] = None,
):
    """Exact block-Gaussian Gibbs sweeps over β, for every chain at once.

    Each coordinate block S has the conditional β_S | β_₋S ~ N(A_SS⁻¹ (b_S −
    A_{S,₋S} β_₋S), A_SS⁻¹). A is data, not state, so the inverse Cholesky
    factor L⁻¹ of each A_SS = L Lᵀ is formed here, once per shard; a block
    move is then β_S = L⁻ᵀ (L⁻¹ r + z), z ~ N(0, I), r the shift with the
    own-block term added back: batched matrix–vector products, no solver in
    the step. ``count`` masks the padded rows out of A and b.
    """
    A, b = block_statistics(data, num_shards, tau, noise_std, count)
    d = A.shape[-1]
    bounds = [(i * d) // n_blocks for i in range(n_blocks)] + [d]

    def block_update(s0: int, s1: int) -> BlockUpdate:
        A_S = A[..., s0:s1, :].contiguous()  # (..., s, d)
        A_SS = A[..., s0:s1, s0:s1].contiguous()
        b_S = b[..., s0:s1].contiguous()
        chol = torch.linalg.cholesky(A_SS)
        eye = torch.eye(s1 - s0, dtype=A.dtype, device=A.device).expand_as(A_SS)
        linv = torch.linalg.solve_triangular(chol, eye, upper=False)  # L⁻¹
        linv_t = linv.transpose(-1, -2).contiguous()  # L⁻ᵀ

        def draw(gen, beta, out=None):
            if out is None:
                return (torch.randn(beta.shape[:-1] + (s1 - s0,), generator=gen,
                                    dtype=beta.dtype, device=beta.device),)
            (z,) = out
            torch.randn(z.shape, generator=gen, out=z)
            return (z,)

        def update(beta, z):
            r = b_S - matvec(A_S, beta) + matvec(A_SS, beta[..., s0:s1])
            w = matvec(linv, r) + z
            new = matvec(linv_t, w)
            return torch.cat([beta[..., :s0], new, beta[..., s1:]], dim=-1), None

        return BlockUpdate(draw, update)

    return [block_update(s0, s1) for s0, s1 in zip(bounds[:-1], bounds[1:])]


def gibbs_init(gen: torch.Generator, data: Data) -> torch.Tensor:
    """0.01·N(0, I) for every chain: ``(..., d)`` from ``x (..., N, d)``."""
    x = data["x"]
    return 0.01 * torch.randn(x.shape[:-2] + x.shape[-1:], generator=gen, device=x.device)


registry.register_model(
    registry.BayesModel(
        name="linear",
        generate_data=generate_data,
        log_prior=log_prior,
        log_lik=log_lik,
        d=10,
        default_n=10_000,
        default_sampler="mala",
        # conjugate exact-conditional blocks: step_size is accepted for the
        # registry's uniform signature and ignored; count masks padded rows
        gibbs_blocks=lambda shard, num_shards, *, step_size=0.1, count=None:
            gibbs_blocks(shard, num_shards, count=count),
        gibbs_init=gibbs_init,
        gibbs_extract=lambda positions: positions,
        gibbs_counts=True,
    ),
    "linear_gaussian",
)
