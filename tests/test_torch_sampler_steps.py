"""The port's new transitions against repro, one step on repro's own randomness.

- One transition of ``rwmh``, ``hmc`` (jittered L), ``sgld`` (full gradient,
  minibatch, RMSProp with a step schedule) and ``mh_within_gibbs_update``, fed
  the normals, uniforms and L that ``repro``'s own step draws from a known
  key: the same accept decisions, positions within float32 tolerance.
- Every kernel's ``draw`` gives its step's own random inputs: ``step(gen, s)``
  and ``step(gen, s, *draw(gen, s.position))`` agree bit for bit, also with
  ``out=`` buffers (what a captured CUDA graph needs).
- Marsaglia–Tsang in fixed rounds: the mean, variance and a KS test against
  ``scipy.stats.gamma`` at α ∈ {0.3, 1, 4, 40}.
- HMC's window adaptation learns the target's metric.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from repro.samplers import mh_within_gibbs_update as jax_mwg
from repro.samplers.hmc import hmc_kernel as jax_hmc
from repro.samplers.rwmh import rwmh_kernel as jax_rwmh
from repro.samplers.sgld import sgld_kernel as jax_sgld
from repro_torch.samplers import canonical_samplers, get_sampler, randgamma, window_adaptation
from repro_torch.samplers.hmc import hmc_kernel
from repro_torch.samplers.rwmh import rwmh_kernel
from test_torch_sampler_registry import MEAN, STD, _build, _gibbs_blocks, logpdf
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run


def jax_logpdf(theta):
    return -0.5 * jnp.sum(((theta - MEAN) / STD) ** 2)


# -- one transition on repro's own randomness ---------------------------------


def _states(C, seed):
    rng = np.random.default_rng(seed)
    pos = (MEAN + 1.5 * STD * rng.standard_normal((C, 2))).astype(np.float32)
    eps = np.geomspace(0.05, 3.0, C).astype(np.float32)
    return pos, eps


def test_rwmh_step_matches_reference_on_injected_randomness():
    """16 chains at step sizes 0.05–3: decisions equal (both occur), position
    and log-density within atol 1e-6 / rtol 1e-6."""
    C = 16
    pos, eps = _states(C, 0)
    want_pos, want_acc, noise, log_u = [], [], [], []
    for c in range(C):
        key = jax.random.PRNGKey(c)
        kern = jax_rwmh(jax_logpdf, step_size=float(eps[c]))
        new, info = kern.step(key, kern.init(jnp.asarray(pos[c])))
        k_prop, k_acc = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(jax.random.split(k_prop, 1)[0], (2,))))
        log_u.append(np.log(np.asarray(jax.random.uniform(k_acc))))
        want_pos.append(np.asarray(new.position))
        want_acc.append(bool(info.is_accepted))
    kern = rwmh_kernel(logpdf, step_size=torch.from_numpy(eps)[:, None])
    new, info = kern.step(None, kern.init(torch.from_numpy(pos)), torch.from_numpy(np.stack(noise)),
                          torch.from_numpy(np.array(log_u, np.float32)))
    assert any(want_acc) and not all(want_acc)
    np.testing.assert_array_equal(info.is_accepted.numpy(), want_acc)
    np.testing.assert_allclose(new.position.numpy(), np.stack(want_pos), atol=1e-6)


def test_hmc_step_matches_reference_on_injected_randomness():
    """16 chains, L_max = 8 jittered: fed repro's momentum, uniform and L,
    decisions equal (both occur), position within atol 1e-5 after up to 8
    leapfrog steps, gradient within atol 1e-5."""
    C, L = 16, 8
    pos, eps = _states(C, 1)
    want_pos, want_grad, want_acc, raw, log_u, steps = [], [], [], [], [], []
    for c in range(C):
        key = jax.random.PRNGKey(50 + c)
        kern = jax_hmc(jax_logpdf, step_size=float(eps[c]), num_integration_steps=L)
        new, info = kern.step(key, kern.init(jnp.asarray(pos[c])))
        k_mom, k_acc, k_len = jax.random.split(key, 3)
        raw.append(np.asarray(jax.random.normal(jax.random.split(k_mom, 1)[0], (2,))))
        log_u.append(np.log(np.asarray(jax.random.uniform(k_acc))))
        steps.append(int(jax.random.randint(k_len, (), 1, L + 1)))
        want_pos.append(np.asarray(new.position))
        want_grad.append(np.asarray(new.grad))
        want_acc.append(bool(info.is_accepted))
    kern = hmc_kernel(logpdf, step_size=torch.from_numpy(eps)[:, None], num_integration_steps=L)
    new, info = kern.step(None, kern.init(torch.from_numpy(pos)), torch.from_numpy(np.stack(raw)),
                          torch.from_numpy(np.array(log_u, np.float32)), torch.tensor(steps))
    assert any(want_acc) and not all(want_acc) and len(set(steps)) > 2
    np.testing.assert_array_equal(info.is_accepted.numpy(), want_acc)
    np.testing.assert_allclose(new.position.numpy(), np.stack(want_pos), atol=1e-5)
    np.testing.assert_allclose(new.grad.numpy(), np.stack(want_grad), atol=1e-5)


def test_sgld_step_matches_reference_on_injected_randomness():
    """Full-gradient SGLD, and minibatch pSGLD (RMSProp, ε_t = 0.1/(1+t))
    over 5 steps on 3 chains with the batches repro drew: positions and the
    RMSProp accumulator within atol 1e-6 (rtol 1e-5)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((40, 2)).astype(np.float32) + MEAN

    def jgrad(theta, batch):
        return jax.grad(lambda th: -0.5 * jnp.sum(th**2) / 4 + 40 / batch.shape[0]
                        * -0.5 * jnp.sum((batch - th) ** 2))(theta)

    def tgrad(theta, batch):
        theta = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            lp = -0.5 * (theta**2).sum(-1) / 4 + 40 / batch.shape[-2] * -0.5 * (
                (batch - theta.unsqueeze(-2)) ** 2).sum((-1, -2))
            return torch.autograd.grad(lp.sum(), theta)[0]

    # full gradient on the 2-d target
    C = 3
    pos, _ = _states(C, 3)
    kern_t = get_sampler("sgld")(logpdf, step_size=0.05)
    st = kern_t.init(torch.from_numpy(pos))
    for t in range(5):
        noise, want = [], []
        for c in range(C):
            key = jax.random.PRNGKey(1000 * t + c)
            jk = get_jax_sgld_full(0.05)
            new, _ = jk.step(key, jk.init(jnp.asarray(st.position[c].numpy())))
            noise.append(np.asarray(jax.random.normal(jax.random.split(key, 1)[0], (2,))))
            want.append(np.asarray(new.position))
        st, info = kern_t.step(None, st, torch.from_numpy(np.stack(noise)))
        np.testing.assert_allclose(st.position.numpy(), np.stack(want), rtol=1e-5, atol=1e-6)
        assert bool(info.is_accepted.all()) and float(info.accept_prob.min()) == 1.0

    # minibatch pSGLD with a schedule: repro's batches fed as uniforms
    B = 8
    sched_j = lambda t: 0.1 / (1.0 + t)  # noqa: E731
    base_j = jax_sgld(jgrad, sched_j, preconditioner="rmsprop")
    xt = torch.from_numpy(x)
    kern_t = get_sampler("sgld")(
        None, step_size=lambda t: 0.1 / (1.0 + t.to(torch.float32)), grad_logpdf=tgrad,
        batch_fn=lambda u, _t: xt[(u * 40).to(torch.int64)], batch_size=B,
        preconditioner="rmsprop")
    st = kern_t.init(torch.from_numpy(pos))
    jstates = [base_j.init(jnp.asarray(pos[c])) for c in range(C)]
    for t in range(5):
        us, noise = [], []
        for c in range(C):
            key = jax.random.PRNGKey(77 + 10 * t + c)
            k_batch, k_step = jax.random.split(key)
            idx = np.asarray(jax.random.randint(k_batch, (B,), 0, 40))
            us.append(((idx + 0.5) / 40).astype(np.float32))
            noise.append(np.asarray(jax.random.normal(jax.random.split(k_step, 1)[0], (2,))))
            jstates[c], _ = base_j.step(k_step, jstates[c], jnp.asarray(x[idx]))
        st, _ = kern_t.step(None, st, torch.from_numpy(np.stack(us)), torch.from_numpy(np.stack(noise)))
        np.testing.assert_allclose(st.position.numpy(), np.stack([np.asarray(j.position) for j in jstates]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(st.v.numpy(), np.stack([np.asarray(j.v) for j in jstates]),
                                   rtol=1e-5, atol=1e-7)
    assert st.step.tolist() == [5] * C


def get_jax_sgld_full(eps):
    from repro.samplers import get_sampler as jax_get_sampler

    return jax_get_sampler("sgld")(jax_logpdf, step_size=eps)


def test_mh_within_gibbs_update_matches_reference_on_injected_randomness():
    """Both coordinate blocks on 16 chains: fed repro's proposal normal and
    uniform, decisions (both occur) and positions equal (atol 1e-6)."""
    C = 16
    pos, _ = _states(C, 4)
    for i in (0, 1):
        jblock = jax_mwg(jax_logpdf, select=lambda p, i=i: p[i],
                         replace=lambda p, b, i=i: p.at[i].set(b), step_size=1.2)
        tblock = _gibbs_blocks()[i]
        want, noise, log_u = [], [], []
        for c in range(C):
            key = jax.random.PRNGKey(300 + c)
            k_prop, k_acc = jax.random.split(key)
            noise.append(float(jax.random.normal(k_prop, ())))
            log_u.append(float(jnp.log(jax.random.uniform(k_acc))))
            want.append(np.asarray(jblock(key, jnp.asarray(pos[c]))))
        got, unresolved = tblock.update(torch.from_numpy(pos), torch.tensor(noise)[:, None],
                                        torch.tensor(log_u))
        assert unresolved is None
        moved = np.stack(want)[:, i] != pos[:, i]
        assert moved.any() and not moved.all()
        np.testing.assert_allclose(got.numpy(), np.stack(want), atol=1e-6)


# -- draw: the step's own inputs, with and without buffers ----------------------


def _equal(a, b):
    from repro_torch.samplers.base import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("name", sorted(canonical_samplers()))
def test_draw_gives_the_steps_own_random_inputs(name):
    kern = _build(name)
    state = kern.init(torch.zeros(3, 2))
    eager = kern.step(torch.Generator().manual_seed(5), state)
    gen = torch.Generator().manual_seed(5)
    fresh = kern.step(None, state, *kern.draw(gen, state.position))
    gen = torch.Generator().manual_seed(5)
    bufs = kern.draw(torch.Generator().manual_seed(99), state.position)
    filled = kern.step(None, state, *kern.draw(gen, state.position, out=bufs))
    for got in (fresh, filled):
        assert _equal(got[0], eager[0]) and _equal(got[1], eager[1])


# -- Marsaglia–Tsang in fixed rounds --------------------------------------------


@pytest.mark.parametrize("alpha", [0.3, 1.0, 4.0, 40.0])
def test_randgamma_moments_and_ks(alpha):
    """60,000 draws: mean and variance within 4 standard errors of α (the
    variance's s.e. from the fourth central moment, 6α + 3α²... over n), and
    a KS test against scipy's Gamma(α) at p > 1e-3; no unresolved lane."""
    n = 60_000
    x = randgamma.gamma(torch.Generator().manual_seed(int(alpha * 10)), torch.full((n,), alpha))
    x = x.double().numpy()
    se_mean = np.sqrt(alpha / n)
    se_var = np.sqrt((6 * alpha + 3 * alpha**2 - alpha**2) / n)
    assert abs(x.mean() - alpha) < 4 * se_mean
    assert abs(x.var() - alpha) < 4 * se_var
    assert scipy.stats.kstest(x, "gamma", args=(alpha,)).pvalue > 1e-3


def test_window_adaptation_learns_the_metric():
    """Batched over 3 chains on the 2-d target, 600 steps: the inverse metric
    within 35 % of the target's variances (as repro's is on the same
    target, checked here too), ε finite and positive, the position finite."""
    gen = torch.Generator().manual_seed(0)
    pos, eps, inv_mass = window_adaptation(logpdf, torch.zeros(3, 2), gen, 600,
                                           num_integration_steps=8)
    assert eps.shape == (3, 1) and bool((eps > 0).all()) and torch.isfinite(pos).all()
    np.testing.assert_allclose(inv_mass.numpy(), np.broadcast_to(STD**2, (3, 2)), rtol=0.35)
    from repro.samplers.hmc import window_adaptation as jax_window

    _, jeps, jim = jax_window(jax_logpdf, jnp.zeros(2), jax.random.PRNGKey(0), 600,
                              num_integration_steps=8)
    np.testing.assert_allclose(np.asarray(jim), STD**2, rtol=0.35)
    assert 0.2 < float(eps.mean()) / float(jeps) < 5.0
