"""Hierarchical Poisson–gamma model — paper §8.3.

The port of ``repro/models/bayes/poisson_gamma.py``:

    a ~ Exponential(λ),  b ~ Gamma(α, β),
    q_i ~ Gamma(a, b),   x_i ~ Poisson(q_i·t_i),   i = 1..N (N = 50,000).

Two samplers, as there (criterion 3, any MCMC works):

1. the marginal path: q_i integrates out (a negative-binomial likelihood),
   leaving θ = (log a, log b), unconstrained with the log-transform
   Jacobians; any MH-style sampler runs on it. ``lgamma(x_i + 1)`` does not
   depend on θ, so :func:`prepare_data` forms it once per shard;
2. the Gibbs path: explicit latents, q_i | a,b,x ~ Gamma(a+x_i, b+t_i) and
   b | a,q ~ Gamma(α/M' + N a, β/M + Σq_i) conjugate, a | b,q by
   MH-within-Gibbs on log a. The position is :class:`PoissonPosition`, θ
   ``(M, 2)`` and the shard-local latents q ``(M, S)``; only θ is shared.

The gamma draws are :mod:`repro_torch.samplers.randgamma`'s fixed-round
Marsaglia–Tsang: no host loop inside a sweep, every lane left unresolved
counted and raised on outside the graph.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.bayes import registry
from repro_torch.samplers import randgamma
from repro_torch.samplers.gibbs import BlockUpdate
from repro_torch.utils.rowwise import rowsum

Data = Dict[str, torch.Tensor]

# Hyperparameters (fixed, as the paper fixes λ, α, β before data generation).
LAMBDA = 1.0  # a ~ Exponential(1)
ALPHA = 2.0  # b ~ Gamma(2, 2)
BETA = 2.0


class PoissonPosition(NamedTuple):
    """A Gibbs position: the shared θ = (log a, log b) and the shard's latents."""

    theta: torch.Tensor  # (..., 2)
    q: torch.Tensor  # (..., S)


def generate_data(
    gen: torch.Generator, n: int = 50_000, a_true: float = 2.0, b_true: float = 1.0
) -> Tuple[Data, torch.Tensor]:
    dev = gen.device
    t = torch.exp(0.3 * torch.randn((n,), generator=gen, device=dev))  # exposures t_i > 0
    q = randgamma.gamma(gen, torch.full((n,), a_true, device=dev)) / b_true
    x = torch.poisson(q * t, generator=gen)
    true_theta = torch.log(torch.tensor([a_true, b_true], device=dev))
    return {"x": x, "t": t}, true_theta


def log_prior(theta: torch.Tensor) -> torch.Tensor:
    """Prior on θ=(log a, log b) incl. the log-transform Jacobians, batched."""
    log_a, log_b = theta[..., 0], theta[..., 1]
    a, b = torch.exp(log_a), torch.exp(log_b)
    lp_a = math.log(LAMBDA) - LAMBDA * a + log_a
    lp_b = (ALPHA * math.log(BETA) - math.lgamma(ALPHA) + (ALPHA - 1.0) * torch.log(b)
            - BETA * b + log_b)
    return lp_a + lp_b


def prepare_data(data: Data) -> Data:
    """The shard with ``lgamma(x + 1)`` beside it (constant in θ)."""
    return {**data, "lgx1": torch.lgamma(data["x"] + 1.0)}


def log_lik(theta: torch.Tensor, data: Data) -> torch.Tensor:
    """Marginal (negative-binomial) log-likelihood summed over the shard:
    θ ``(..., 2)`` with ``x, t (..., N)`` → ``(...)``."""
    a = torch.exp(theta[..., 0:1])
    b = torch.exp(theta[..., 1:2])
    x, t = data["x"], data["t"]
    lgx1 = data["lgx1"] if "lgx1" in data else torch.lgamma(x + 1.0)
    log_bt = torch.log(b + t)
    return rowsum(torch.lgamma(x + a) - torch.lgamma(a) - lgx1
                  + a * (torch.log(b) - log_bt) + x * (torch.log(t) - log_bt))


# ---------------------------------------------------------------------------
# Gibbs path (explicit latents)
# ---------------------------------------------------------------------------


def _rounds_block(shape_of, move) -> BlockUpdate:
    """A block whose inputs are one batch of gamma rounds of ``shape_of(pos)``."""

    def draw(gen, pos, out=None):
        leaf = pos.theta
        return (randgamma.draw_rounds(gen, shape_of(pos), device=leaf.device, dtype=leaf.dtype,
                                      out=None if out is None else out[0]),)

    def update(pos, rounds):
        return move(pos, rounds)

    return BlockUpdate(draw, update)


def gibbs_blocks(
    data: Data, num_shards: int, mh_step: float = 0.15, count: Optional[torch.Tensor] = None
):
    """Block updates ``[update_q, update_b, update_a]`` over a
    :class:`PoissonPosition`, for every chain at once.

    The prior on (a,b) is raised to 1/M (Eq. 2.1); the latent q_i are
    shard-local, so their conditionals are untouched by 1/M. ``count (M,)``
    masks the edge-padded rows out of the b- and a-conditionals (Σ w·q,
    Σ w·log q, count·a); every row's q_i is still refreshed, so the draws
    consumed do not depend on it.
    """
    x, t = data["x"], data["t"]
    n = x.shape[-1]
    inv_m = 1.0 / float(num_shards)
    if count is None:
        w, n_eff = None, float(n)
    else:
        w = (torch.arange(n, device=x.device) < count.unsqueeze(-1)).to(x.dtype)
        n_eff = count.to(x.dtype)

    def move_q(pos, rounds):
        # q_i | a,b,x ~ Gamma(a + x_i, rate b + t_i)
        a = torch.exp(pos.theta[..., 0:1])
        b = torch.exp(pos.theta[..., 1:2])
        g, unresolved = randgamma.gamma_from_rounds(a + x, rounds)
        return pos._replace(q=g / (b + t)), unresolved

    def move_b(pos, rounds):
        # b | a, q ~ Gamma((α−1)/M + 1 + N a, β/M + Σ q): the prior tempered by 1/M
        a = torch.exp(pos.theta[..., 0])
        shape = (ALPHA - 1.0) * inv_m + 1.0 + n_eff * a
        rate = BETA * inv_m + rowsum(pos.q if w is None else w * pos.q)
        g, unresolved = randgamma.gamma_from_rounds(shape, rounds)
        theta = torch.stack([pos.theta[..., 0], torch.log(g / rate)], dim=-1)
        return pos._replace(theta=theta), unresolved

    def a_conditional(log_a, log_b, sum_logq):
        a = torch.exp(log_a)
        prior = inv_m * (-LAMBDA * a) + log_a  # tempered Exp(λ) + Jacobian
        return prior + (a - 1.0) * sum_logq + n_eff * (a * log_b - torch.lgamma(a))

    def draw_a(gen, pos, out=None):
        th = pos.theta
        if out is None:
            noise = torch.randn(th.shape[:-1], generator=gen, dtype=th.dtype, device=th.device)
            log_u = torch.rand(th.shape[:-1], generator=gen, dtype=th.dtype, device=th.device)
        else:
            noise, log_u = out
            torch.randn(noise.shape, generator=gen, out=noise)
            torch.rand(log_u.shape, generator=gen, out=log_u)
        return noise, log_u.log_()

    def update_a(pos, noise, log_u):
        # a | b, q: non-conjugate — random-walk MH on log a
        log_q = torch.log(pos.q)
        sum_logq = rowsum(log_q if w is None else w * log_q)
        log_a, log_b = pos.theta[..., 0], pos.theta[..., 1]
        prop = log_a + mh_step * noise
        log_ratio = (a_conditional(prop, log_b, sum_logq)
                     - a_conditional(log_a, log_b, sum_logq))
        new_log_a = torch.where(log_u < log_ratio, prop, log_a)
        return pos._replace(theta=torch.stack([new_log_a, log_b], dim=-1)), None

    return [
        _rounds_block(lambda pos: tuple(pos.q.shape), move_q),
        _rounds_block(lambda pos: tuple(pos.theta.shape[:-1]), move_b),
        BlockUpdate(draw_a, update_a),
    ]


def gibbs_log_target(theta: torch.Tensor, data: Data, num_shards: int) -> torch.Tensor:
    """The log density in θ, up to a constant, that the Gibbs blocks leave
    invariant once q is integrated out: θ ``(..., 2)`` → ``(...)``.

    The blocks temper the prior of (a, b) by 1/M in (a, b) itself and then
    move in θ = (log a, log b), so the Jacobian log a + log b enters whole:
    ``log_lik + (log_prior − J)/M + J``. The marginal path's subposterior
    tempers it with the prior, ``log_lik + log_prior/M``; the two agree at
    M = 1, and either set of M subposteriors multiplies to a posterior.
    """
    jac = theta[..., 0] + theta[..., 1]
    return log_lik(theta, data) + (log_prior(theta) - jac) / num_shards + jac


def gibbs_subposterior_moments(shard: Data, num_shards: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact mean and standard deviation of θ ``(2,)`` under
    :func:`gibbs_log_target` on one shard (``x, t (N,)``), in float64, by
    quadrature: Newton's method from the best point of a coarse grid to the
    mode, then an 81 × 81 grid over ± 10 standard deviations of the Laplace
    approximation, laid out in its Cholesky frame (a step of a quarter of
    one: the sum's error on a near-Gaussian is far below float64's). Raises
    if the grid's edge holds more than 1e-12 of the mass. The reference the
    Gibbs chains are held to: the sampler's target with no sampling in it.
    """
    half_width, points, chunk = 10.0, 81, 2048
    data = prepare_data({k: shard[k].to(torch.float64) for k in ("x", "t")})
    dev = data["x"].device

    def log_p(theta):  # (P, 2) → (P,), a chunk of points at a time
        return torch.cat([gibbs_log_target(theta[i:i + chunk], data, num_shards)
                          for i in range(0, theta.shape[0], chunk)])

    def grid(axis):
        return torch.stack(torch.meshgrid(axis, axis, indexing="ij"), dim=-1).reshape(-1, 2)

    coarse = grid(torch.linspace(-3.0, 3.0, 61, dtype=torch.float64, device=dev))
    theta = coarse[log_p(coarse).argmax()]
    one = lambda th: gibbs_log_target(th, data, num_shards)  # noqa: E731
    for _ in range(50):  # Newton, halving a step that does not climb
        step = torch.linalg.solve(torch.func.hessian(one)(theta), torch.func.grad(one)(theta))
        f0, scale = one(theta), 1.0
        while scale > 1e-6 and not bool(one(theta - scale * step) >= f0):
            scale *= 0.5
        theta = theta - scale * step
        if float(step.abs().max()) * scale < 1e-12:
            break
    frame = torch.linalg.cholesky(torch.linalg.inv(-torch.func.hessian(one)(theta)))
    z = grid(torch.linspace(-half_width, half_width, points, dtype=torch.float64, device=dev))
    pts = theta + z @ frame.T
    w = torch.softmax(log_p(pts), dim=0)
    edge = (z.abs() == half_width).any(dim=-1)
    if float(w[edge].sum()) > 1e-12:
        raise RuntimeError(f"gibbs_subposterior_moments: {float(w[edge].sum()):.3g} of the "
                           "mass on the grid's edge")
    mean = (w.unsqueeze(-1) * pts).sum(dim=0)
    std = (w.unsqueeze(-1) * (pts - mean) ** 2).sum(dim=0).sqrt()
    return mean, std


def gibbs_init(gen: torch.Generator, data: Data) -> PoissonPosition:
    """θ = 0 and q_i = max(x_i / t_i, 0.1) for every chain (no randomness)."""
    x, t = data["x"], data["t"]
    q0 = torch.clamp(x / t.clamp(min=1e-6), min=0.1)
    return PoissonPosition(torch.zeros(x.shape[:-1] + (2,), dtype=x.dtype, device=x.device), q0)


registry.register_model(
    registry.BayesModel(
        name="poisson",
        generate_data=generate_data,
        log_prior=log_prior,
        log_lik=log_lik,
        prepare_data=prepare_data,
        d=2,
        default_n=50_000,
        default_sampler="rwmh",
        # criterion 3 (§8.3): the conjugate latent-q Gibbs path; only
        # (log a, log b) are shared, the q_i stay shard-local; count masks
        # edge-padded rows so ragged shards sample exactly
        gibbs_blocks=lambda shard, num_shards, *, step_size=0.15, count=None:
            gibbs_blocks(shard, num_shards, mh_step=step_size, count=count),
        gibbs_init=gibbs_init,
        gibbs_extract=lambda positions: positions.theta,
        gibbs_counts=True,
    ),
    "poisson_gamma",
)
