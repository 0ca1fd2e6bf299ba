"""The port's combiners against repro's on the same subposterior draws.

One kernel-scored IMG sweep is held to repro's decision for decision: both
packages get the same carry, repro's own index proposals ``c`` and uniforms
``u`` (drawn from the carry's keys exactly as ``_img_kernel_sweep`` draws
them), and must accept the same proposals and land on the same mean. With
B·M = 64 candidates repro scores them through the Pallas kernel in interpret
mode. Whole combiner runs use different random streams, so their draws are
held in distribution: mean and covariance within a band of repro's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.combiners import get_combiner as jax_get_combiner
from repro.core.combiners import img as jimg
from repro.core.combiners.api import resolve_schedule as jax_resolve_schedule
from repro_torch.core.combiners import get_combiner, img as timg, log_weight_bruteforce
from repro_torch.core.combiners.api import resolve_schedule

M, T, D, B = 4, 300, 5, 16


def _subposterior_draws(seed=0, M=M, T=T, d=D):
    """M Gaussian subposteriors around a shared centre, as numpy float32."""
    rng = np.random.default_rng(seed)
    centre = rng.standard_normal(d)
    offsets = 0.15 * rng.standard_normal((M, 1, d))
    scales = 0.2 * (1.0 + 0.3 * rng.random((M, 1, d)))
    return (centre + offsets + scales * rng.standard_normal((M, T, d))).astype(np.float32)


def _sweep_inputs(semiparametric):
    samples = _subposterior_draws()
    js = jnp.asarray(samples)
    counts = jnp.full((M,), T, jnp.int32)
    model = (jimg.semiparametric_model(js, counts) if semiparametric
             else jimg.nonparametric_model(js))
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    carry = jax.vmap(lambda k: jimg._init_img_carry(k, js, counts, model.aux))(keys)
    h = jax_resolve_schedule(js, None, True)(jnp.asarray(40.0)).astype(jnp.float32)
    # the draws _img_kernel_sweep makes from the carry's keys
    ks = jax.vmap(lambda k: jax.random.split(k, 3))(carry.key)
    c = jax.vmap(lambda k: jax.random.randint(k, (M,), 0, counts))(ks[:, 1])
    u = jax.vmap(lambda k: jax.random.uniform(k, (M,)))(ks[:, 2])
    return samples, js, counts, model, carry, h, c, u


def _port_carry(carry):
    def t(a, dtype=None):
        return torch.tensor(np.asarray(a, dtype=dtype))

    return timg._ImgCarry(
        t_idx=t(carry.t_idx).long(),
        theta_sel=t(carry.theta_sel),
        mean=t(carry.mean),
        sumsq=t(carry.sumsq),
        extra=t(carry.extra, np.float32).reshape(B),
        n_accept=t(carry.n_accept, np.float32),
    )


@pytest.mark.parametrize("semiparametric", [False, True], ids=["w_t", "W_t"])
def test_kernel_sweep_decisions_match_reference(semiparametric):
    """Same carry, same c and u → the same accepted set in every chain. The
    new mean is float32 arithmetic in another order: atol 1e-5 on values ~1;
    the W_t running Σ aux term (size ~1e1) rtol 1e-4."""
    samples, js, counts, jmodel, carry, h, c, u = _sweep_inputs(semiparametric)
    ts = torch.from_numpy(samples)
    tcounts = torch.full((M,), T, dtype=torch.int32)
    if semiparametric:
        tmodel = timg.semiparametric_model(ts, tcounts)
        np.testing.assert_allclose(tmodel.aux.numpy(), np.asarray(jmodel.aux), rtol=1e-4, atol=1e-3)
        j_extra = jmodel.extra_logweight(h)
        t_extra = tmodel.extra_logweight(torch.tensor(float(h)).expand(B))
        aux = tmodel.aux
    else:
        j_extra = t_extra = aux = None
    # jitted as repro's combiners run it: eager Pallas interpret is far slower
    jout = jax.jit(lambda *a: jimg._img_kernel_sweep(*a, j_extra))(carry, js, counts, h, jmodel.aux)
    tout = timg._img_kernel_sweep(
        _port_carry(carry), ts, tcounts, torch.tensor(float(h)), aux, t_extra,
        c=torch.tensor(np.asarray(c)).long(), u=torch.tensor(np.asarray(u)),
    )
    accepted = np.asarray(jout.t_idx) != np.asarray(carry.t_idx)
    assert 0 < accepted.sum() < accepted.size  # both branches are exercised
    np.testing.assert_array_equal(tout.t_idx.numpy(), np.asarray(jout.t_idx))
    np.testing.assert_array_equal(tout.n_accept.numpy(), np.asarray(jout.n_accept))
    np.testing.assert_allclose(tout.mean.numpy(), np.asarray(jout.mean), atol=1e-5)
    np.testing.assert_allclose(tout.sumsq.numpy(), np.asarray(jout.sumsq), rtol=1e-5)
    np.testing.assert_allclose(tout.extra.numpy(), np.asarray(jout.extra).reshape(B), rtol=1e-4)


def test_kernel_sweep_matches_incremental_recursion_scores():
    """The rank-one correction scores exactly what the O(d) recursion scores:
    with every site proposing the same candidate, one kernel sweep and one
    incremental sweep from the same carry accept the same set."""
    samples, *_ = _sweep_inputs(False)
    ts = torch.from_numpy(samples)
    counts = torch.full((M,), T, dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    carry = timg._init_img_carry(gen, ts, counts, None, B)
    h = torch.tensor(0.05)
    c = torch.randint(0, T, (B, M), generator=gen)
    u = torch.rand((B, M), generator=gen)
    k_out = timg._img_kernel_sweep(carry, ts, counts, h, c=c, u=u)

    # replay the same proposals through the serial single-site recursion
    t_idx, theta_sel = carry.t_idx.clone(), carry.theta_sel.clone()
    for m in range(M):
        cur = log_weight_bruteforce(theta_sel, h)
        prop = theta_sel.clone()
        prop[:, m] = ts[m, c[:, m]]
        acc = torch.log(u[:, m]) < log_weight_bruteforce(prop, h) - cur
        theta_sel = torch.where(acc[:, None, None], prop, theta_sel)
        t_idx[:, m] = torch.where(acc, c[:, m], t_idx[:, m])
    assert torch.equal(k_out.t_idx, t_idx)


# IMG draws from two random streams differ by Monte Carlo error of strongly
# autocorrelated index chains. repro's own spread over 5 keys at these
# settings (``python tests/test_torch_combiners.py``) reached 0.84 of the
# draws' sd between means and a factor 1.47 between sds, so the port is held
# to 1.0 sd and a factor 1.6. parametric's product moments are deterministic
# in the draws: rtol 1e-4 (mean), 1e-3 (covariance, Cholesky solves).
MEAN_BAND_SD, SD_RATIO_BAND = 1.0, 1.6
IN_DISTRIBUTION_CASES = [
    ("parametric", {}),
    ("nonparametric", {"weight_eval": "kernel", "n_batch": 16}),
    ("nonparametric", {"weight_eval": "incremental", "n_batch": 4}),
    ("semiparametric", {"weight_eval": "kernel", "n_batch": 16}),
    ("semiparametric_w", {"weight_eval": "incremental", "n_batch": 1}),
]


@pytest.mark.parametrize("name,options", IN_DISTRIBUTION_CASES, ids=["parametric", "nonparametric-kernel", "nonparametric-incremental",
        "semiparametric-kernel", "semiparametric_w-incremental"])
def test_combiner_draws_match_reference_in_distribution(name, options):
    samples = _subposterior_draws(seed=1)
    n_draws = 1200
    options = dict(options, rescale=True)
    jres = jax_get_combiner(name)(jax.random.PRNGKey(0), jnp.asarray(samples), n_draws, **options)
    gen = torch.Generator().manual_seed(0)
    tres = get_combiner(name)(gen, torch.from_numpy(samples), n_draws, **options)
    jd, td = np.asarray(jres.samples), tres.samples.numpy()
    assert td.shape == jd.shape == (n_draws, D) and np.isfinite(td).all()
    sd = jd.std(0)
    assert np.all(np.abs(td.mean(0) - jd.mean(0)) < MEAN_BAND_SD * sd), (td.mean(0), jd.mean(0), sd)
    ratio = td.std(0) / sd
    assert np.all((ratio > 1 / SD_RATIO_BAND) & (ratio < SD_RATIO_BAND)), ratio
    assert 0.0 < float(tres.acceptance_rate) <= 1.0
    if jres.moments is not None:
        np.testing.assert_allclose(tres.moments.mean.numpy(), np.asarray(jres.moments.mean),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tres.moments.cov.numpy(), np.asarray(jres.moments.cov),
                                   rtol=1e-3, atol=1e-7)
    if name != "parametric":
        assert tres.extras["per_chain_acceptance"].shape == np.asarray(
            jres.extras["per_chain_acceptance"]).shape


def test_schedule_matches_reference():
    samples = _subposterior_draws(seed=2)
    for rescale in (False, True):
        js = jax_resolve_schedule(jnp.asarray(samples), None, rescale)
        ts = resolve_schedule(torch.from_numpy(samples), None, rescale)
        for i in (1, 16, 1200):
            np.testing.assert_allclose(ts(i).item(), float(js(i)), rtol=1e-6)


def test_ragged_counts_keep_invalid_rows_inert():
    """Rows past counts[m] hold large finite garbage (repro's conformance
    convention: fit_moments is NaN-poisoned by design): no combiner may select
    them, so every draw stays near the valid cloud."""
    samples = _subposterior_draws(seed=3)
    counts = torch.tensor([T, T - 50, 120, T], dtype=torch.int32)
    t = torch.from_numpy(samples.copy())
    for m in range(M):
        t[m, counts[m]:] = 1e4
    for name in ("parametric", "nonparametric", "semiparametric", "semiparametric_w"):
        for weight_eval in ("incremental", "kernel"):
            res = get_combiner(name)(torch.Generator().manual_seed(1), t, 200, counts=counts,
                                     rescale=False, n_batch=16, weight_eval=weight_eval)
            assert res.samples.abs().max() < 100.0, (name, weight_eval)


def test_unknown_weight_eval_is_rejected():
    t = torch.from_numpy(_subposterior_draws())
    with pytest.raises(ValueError):
        get_combiner("nonparametric")(torch.Generator(), t, 10, weight_eval="bogus")


if __name__ == "__main__":
    # repro's own key-to-key spread behind MEAN_BAND_SD and SD_RATIO_BAND
    samples = jnp.asarray(_subposterior_draws(seed=1))
    for name, options in IN_DISTRIBUTION_CASES[1:]:
        runs = [np.asarray(jax_get_combiner(name)(jax.random.PRNGKey(k), samples, 1200,
                                                   rescale=True, **options).samples)
                for k in range(5)]
        means = np.stack([r.mean(0) for r in runs])
        sds = np.stack([r.std(0) for r in runs])
        print(name, options, "max mean spread / sd:",
              float(((means.max(0) - means.min(0)) / sds.mean(0)).max()),
              "max sd ratio:", float((sds.max(0) / sds.min(0)).max()))
