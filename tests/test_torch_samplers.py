"""The port's MALA, dual averaging and chain drivers against repro.

One MALA step is held to repro's on injected randomness (JAX's own noise and
uniform fed to the port): same accept decision, and position, log-density and
gradient within float32 tolerance. Whole chains cannot share JAX's threefry
draws, so they are held statistically, on the 2-d Gaussian target of
``tests/test_sampler_registry.py``, batched over 4 chains.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.subposterior import make_subposterior_logpdf as jax_subpost
from repro.models.bayes import get_model as jax_get_model
from repro.samplers.mala import mala_kernel as jax_mala
from repro_torch.core.subposterior import make_subposterior_logpdf
from repro_torch.interop import from_reference_data
from repro_torch.models.bayes import get_model
from repro_torch.samplers import get_sampler, run_chain, run_chains, sampler_spec
from repro_torch.samplers.mala import mala_kernel

MEAN = torch.tensor([1.0, -2.0])
STD = torch.tensor([0.8, 1.4])


def logpdf(theta):
    return -0.5 * (((theta - MEAN) / STD) ** 2).sum(dim=-1)


def test_mala_step_matches_reference_on_injected_randomness():
    """8 chains on a 4-shard logreg subposterior (repro's data, N=2000, d=50),
    step sizes spread so that some proposals are accepted and some rejected.
    Position/gradient: float32 arithmetic in another order, rtol 1e-4 and
    atol 1e-3 (gradients of size ~1e2); log-density rtol 1e-5."""
    jmodel, tmodel = jax_get_model("logreg"), get_model("logreg")
    data, beta = jmodel.generate_data(jax.random.PRNGKey(3), 2000)
    shard = {k: v[:500] for k, v in data.items()}
    K, d = 8, 50
    rng = np.random.default_rng(0)
    pos = (np.asarray(beta) + 0.05 * rng.standard_normal((K, d))).astype(np.float32)
    eps = np.geomspace(0.01, 1.0, K).astype(np.float32)

    jlp = jax_subpost(jmodel.log_prior, jmodel.log_lik, shard, 4)

    @jax.jit
    def jax_step(key, p, e):
        kern = jax_mala(jlp, step_size=e)
        k_prop, k_acc = jax.random.split(key)
        noise = jax.random.normal(jax.random.split(k_prop, 1)[0], p.shape)  # tree_random_normal
        u = jax.random.uniform(k_acc)
        new, info = kern.step(key, kern.init(p))
        return new, info, noise, u

    outs = [jax_step(jax.random.PRNGKey(100 + i), jnp.asarray(pos[i]), eps[i]) for i in range(K)]
    noise = np.stack([np.asarray(o[2]) for o in outs])
    log_u = np.log(np.stack([np.asarray(o[3]) for o in outs]))

    tdata, _ = from_reference_data({k: np.asarray(v) for k, v in shard.items()},
                                   np.asarray(beta), device="cpu")
    batched = {k: v[None].expand(K, *v.shape).contiguous() for k, v in tdata.items()}
    lp = make_subposterior_logpdf(tmodel.log_prior, tmodel.log_lik, batched, 4)
    kern = mala_kernel(lp, step_size=torch.from_numpy(eps)[:, None])
    new, info = kern.step(None, kern.init(torch.from_numpy(pos)),
                          noise=torch.from_numpy(noise), log_u=torch.from_numpy(log_u))

    accepted = np.array([bool(o[1].is_accepted) for o in outs])
    assert accepted.any() and not accepted.all()  # both branches are exercised
    np.testing.assert_array_equal(info.is_accepted.numpy(), accepted)
    np.testing.assert_allclose(new.position.numpy(), np.stack([np.asarray(o[0].position) for o in outs]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(new.log_density.numpy(), np.array([float(o[0].log_density) for o in outs]),
                               rtol=1e-5)
    np.testing.assert_allclose(new.grad.numpy(), np.stack([np.asarray(o[0].grad) for o in outs]),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(info.accept_prob.numpy(), np.array([float(o[1].accept_prob) for o in outs]),
                               rtol=1e-3, atol=1e-4)


def _run(seed, **kw):
    gen = torch.Generator().manual_seed(seed)
    return run_chains(gen, kw.pop("kernel"), torch.zeros(4, 2), kw.pop("n"), **kw)


def test_mala_conformance_moments_probabilities_determinism():
    """repro's conformance contract (test_sampler_registry) on 4 batched chains:
    accept_prob ∈ [0, 1], analytic moments of the pooled chains within the
    same MCSE-sized tolerances as repro's single chain (0.25 on the mean, 0.3
    on the std), bitwise fixed-seed reruns."""
    kern = get_sampler("mala")(logpdf, step_size=0.35)
    pos, info = _run(0, kernel=kern, n=6000, burn_in=1500)
    assert pos.shape == (4, 6000, 2) and info.accept_prob.shape == (4, 6000)
    assert float(info.accept_prob.min()) >= 0.0 and float(info.accept_prob.max()) <= 1.0
    assert torch.isfinite(pos).all()
    pooled = pos.reshape(-1, 2)  # 4 independent chains, 24,000 draws
    np.testing.assert_allclose(pooled.mean(0).numpy(), MEAN.numpy(), atol=0.25)
    np.testing.assert_allclose(pooled.std(0).numpy(), STD.numpy(), atol=0.3)
    short, _ = _run(0, kernel=kern, n=300, burn_in=100)
    assert torch.equal(short, _run(0, kernel=kern, n=300, burn_in=100)[0])
    assert not torch.equal(short, _run(1, kernel=kern, n=300, burn_in=100)[0])


def test_mala_warmup_reaches_target_acceptance_band():
    """From a hostile ε0 = 5 every chain adapts its own step to within 0.15 of
    the registry's 0.55 target (repro's band), and fixed seeds stay bitwise."""
    spec = sampler_spec("mala")
    assert spec.target_accept == 0.55

    def factory(eps):
        return spec.factory(logpdf, step_size=eps)

    kw = dict(kernel=factory, n=2000, burn_in=200, warmup=600, initial_step_size=5.0,
              target_accept=spec.target_accept)
    pos, info = _run(1, **kw)
    acc = info.accept_prob.mean(dim=-1)
    assert torch.all((acc - spec.target_accept).abs() < 0.15), acc
    pos2, _ = _run(1, **kw)
    assert torch.equal(pos, pos2)


def test_thinning_and_single_chain_shapes():
    kern = get_sampler("mala")(logpdf, step_size=0.35)
    gen = torch.Generator().manual_seed(0)
    pos, info = run_chain(gen, kern, torch.zeros(2), 50, burn_in=5, thin=3)
    assert pos.shape == (50, 2) and info.is_accepted.shape == (50,)
    with pytest.raises(TypeError):
        run_chain(gen, kern, torch.zeros(2), 5, warmup=3)
    with pytest.raises(ValueError):
        run_chains(gen, kern, torch.zeros(2), 5)
