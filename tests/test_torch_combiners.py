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
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

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


# ---------------------------------------------------------------------------
# the registry as a whole, and the combiners of the second ring
# ---------------------------------------------------------------------------

from repro.core.combiners import available_combiners as jax_available_combiners  # noqa: E402
from repro.core.combiners import canonical_combiners as jax_canonical_combiners  # noqa: E402
from repro_torch.core.combiners import (  # noqa: E402
    available_combiners,
    canonical_combiners,
    filter_options,
)


def test_registry_names_and_aliases_match_reference():
    assert canonical_combiners() == jax_canonical_combiners()
    assert len(canonical_combiners()) == 11
    assert available_combiners() == jax_available_combiners()
    for alias in available_combiners():
        # each alias resolves to the port's counterpart of repro's function
        assert get_combiner(alias).__name__ == jax_get_combiner(alias).__name__, alias


def _ragged_inputs(seed):
    samples = _subposterior_draws(seed=seed)
    counts = np.array([T, T - 50, 120, T], np.int32)
    return samples, counts


def _both(name, samples, counts, n_draws, **options):
    jres = jax_get_combiner(name)(
        jax.random.PRNGKey(0), jnp.asarray(samples), n_draws,
        counts=None if counts is None else jnp.asarray(counts), **options)
    tres = get_combiner(name)(
        torch.Generator().manual_seed(0), torch.from_numpy(samples), n_draws,
        counts=None if counts is None else torch.from_numpy(counts), **options)
    return jres, tres


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
@pytest.mark.parametrize("name", ["subpost_average", "consensus", "pool"])
def test_baseline_draws_match_reference(name, ragged):
    """Deterministic in the draws: the same rows (atol 1e-6 on values ~1;
    consensus goes through an inverse and a Cholesky solve, atol 1e-5)."""
    samples, counts = _ragged_inputs(4)
    jres, tres = _both(name, samples, counts if ragged else None, 100)
    atol = 1e-5 if name == "consensus" else 1e-6
    np.testing.assert_allclose(tres.samples.numpy(), np.asarray(jres.samples), atol=atol)


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
def test_online_moments_match_reference(ragged):
    """The Welford chunk fold and its product: rtol 1e-4 (mean), 1e-3 (cov)."""
    samples, counts = _ragged_inputs(4)
    jres, tres = _both("online", samples, counts if ragged else None, 100)
    np.testing.assert_allclose(tres.moments.mean.numpy(), np.asarray(jres.moments.mean),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tres.moments.cov.numpy(), np.asarray(jres.moments.cov),
                               rtol=1e-3, atol=1e-7)


def test_online_single_sample_folds_match_chunk_fold_and_reference():
    """Welford one sample at a time ≡ one chunk fold ≡ repro's single-sample
    fold, to float32 rounding (rtol 1e-4 on m2 entries of size ~1e1)."""
    from repro.core.combiners import online_init as jax_online_init
    from repro.core.combiners import online_update as jax_online_update
    from repro_torch.core.combiners import online_init, online_update, online_update_chunk

    samples, _ = _ragged_inputs(5)
    chunk = samples[:, :40]
    state, jstate = online_init(M, D), jax_online_init(M, D)
    for m in range(M):
        for t in range(40):
            state = online_update(state, m, torch.from_numpy(chunk[m, t]))
            jstate = jax_online_update(jstate, m, jnp.asarray(chunk[m, t]))
    folded = online_update_chunk(online_init(M, D), torch.from_numpy(chunk))
    for got, want in zip(state, folded):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
    for got, want in zip(state, jstate):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
def test_importance_pool_diagnostics_match_reference(ragged):
    """ess, log_weight_max and h_mean are deterministic in the draws (the
    resample comes after them). log w is a difference of KDE scores of size
    ~1e2 in float32, so ess is held to rtol 1e-4 and the others to 1e-5."""
    samples, counts = _ragged_inputs(4)
    jres, tres = _both("importance_pool", samples, counts if ragged else None, 100)
    for key, rtol in (("ess", 1e-4), ("log_weight_max", 1e-5), ("h_mean", 1e-5)):
        np.testing.assert_allclose(float(tres.extras[key]), float(jres.extras[key]), rtol=rtol)


@pytest.mark.parametrize("rescale", [False, True])
def test_weierstrass_schedule_and_shape_match_reference(rescale):
    samples, counts = _ragged_inputs(4)
    jres, tres = _both("weierstrass", samples, counts, 100, rescale=rescale, init_pool=200)
    np.testing.assert_allclose(float(tres.extras["h_final"]), float(jres.extras["h_final"]),
                               rtol=1e-6)
    assert tres.extras["n_chains"] == int(jres.extras["n_chains"])
    assert tres.extras["n_sweeps_per_chain"] == int(jres.extras["n_sweeps_per_chain"])
    assert tres.extras["final_log_weight"].shape == np.asarray(jres.extras["final_log_weight"]).shape


@pytest.mark.parametrize("options", [{}, {"depth": 2, "n_trees": 3}, {"within": "uniform"}],
                         ids=["default", "depth2", "uniform"])
def test_rpt_structure_matches_reference(options):
    samples, counts = _ragged_inputs(4)
    jres, tres = _both("rpt", samples, counts, 100, **options)
    for key in ("depth", "leaf_size", "n_trees"):
        assert tres.extras[key] == int(jres.extras[key]), key
    assert 1.0 <= float(tres.extras["leaf_perplexity"]) <= tres.extras["n_trees"] * 2 ** tres.extras["depth"]


def _two_gaussians(seed=0, T=2000):
    """Two Gaussian subposteriors with a closed-form product N(μ*, Σ*)."""
    rng = np.random.default_rng(seed)
    mu = np.array([[-0.3, 0.2], [0.3, 0.0]])
    sd = np.array([[0.5, 0.4], [0.4, 0.6]])
    samples = (mu[:, None, :] + sd[:, None, :] * rng.standard_normal((2, T, 2))).astype(np.float32)
    prec = 1.0 / sd**2
    var_star = 1.0 / prec.sum(0)
    return samples, (prec * mu).sum(0) * var_star, np.sqrt(var_star)


# Monte Carlo bands, from repro's and the port's draws over keys/seeds 0–3 at
# these settings (n = 2,000 draws, T = 2,000 per machine): the draws' means
# scatter by up to 0.14·σ* around μ* and the two packages' sds differ by up
# to 4 %; each method also has its own smoothing bias in the sd (weierstrass
# ~1.3×σ*, rpt ~0.8×σ*). Held: |mean − μ*| and |mean − repro's mean| below
# 0.35·σ*; sd / σ* within [0.7, 1.45]; sd / repro's sd within [1/1.15, 1.15];
# the correlation within 0.1 of repro's (both ~0).
STOCHASTIC_CASES = [
    ("importance_pool", {}),
    ("weierstrass", {}),
    ("weierstrass", {"init_pool": 1000}),
    ("rpt", {}),
    ("online", {}),
]


@pytest.mark.parametrize("name,options", STOCHASTIC_CASES,
                         ids=["importance_pool", "weierstrass", "weierstrass-init_pool", "rpt",
                              "online"])
def test_stochastic_combiners_hit_the_analytic_product(name, options):
    samples, mu_star, sd_star = _two_gaussians()
    n = 2000
    jd = np.asarray(jax_get_combiner(name)(jax.random.PRNGKey(1), jnp.asarray(samples), n,
                                           **options).samples)
    td = get_combiner(name)(torch.Generator().manual_seed(1), torch.from_numpy(samples), n,
                            **options).samples.numpy()
    assert td.shape == (n, 2) and np.isfinite(td).all()
    assert np.all(np.abs(td.mean(0) - mu_star) < 0.35 * sd_star), (td.mean(0), mu_star)
    assert np.all(np.abs(td.mean(0) - jd.mean(0)) < 0.35 * sd_star), (td.mean(0), jd.mean(0))
    ratio = td.std(0) / sd_star
    assert np.all((ratio > 0.7) & (ratio < 1.45)), ratio
    ratio = td.std(0) / jd.std(0)
    assert np.all((ratio > 1 / 1.15) & (ratio < 1.15)), ratio
    assert abs(np.corrcoef(td.T)[0, 1] - np.corrcoef(jd.T)[0, 1]) < 0.1


# repro's conformance contracts (tests/test_combiner_conformance.py) over the
# port's eleven names; garbage beyond counts is NaN here, not 1e4: the port's
# masked moments where-select, so NaN must stay inert in every combiner.
CM, CT, CD = 3, 120, 2


def _conformance_cloud():
    rng = np.random.default_rng(0)
    centers = np.linspace(-1.0, 1.0, CM)[:, None, None] * np.ones((1, 1, CD))
    return torch.from_numpy((centers + 0.5 * rng.standard_normal((CM, CT, CD))).astype(np.float32))


@pytest.mark.parametrize("name", jax_canonical_combiners())
@pytest.mark.parametrize("n_draws", [37, 64])
def test_conformance_emits_exactly_n_draws(name, n_draws):
    res = get_combiner(name)(torch.Generator().manual_seed(1), _conformance_cloud(), n_draws)
    want = (CM * CT, CD) if name == "pool" else (n_draws, CD)
    assert tuple(res.samples.shape) == want, name
    assert torch.isfinite(res.samples).all(), name


@pytest.mark.parametrize("name", jax_canonical_combiners())
def test_conformance_nan_beyond_counts_is_inert(name):
    cloud = _conformance_cloud()
    counts = torch.tensor([CT, 80, 50], dtype=torch.int32)
    for m in range(CM):
        cloud[m, counts[m]:] = float("nan")
    res = get_combiner(name)(torch.Generator().manual_seed(2), cloud, 64, counts=counts)
    assert torch.isfinite(res.samples).all(), name
    assert float(res.samples.abs().max()) < 100.0, name


@pytest.mark.parametrize("name", jax_canonical_combiners())
def test_conformance_unknown_options_are_dropped(name):
    import inspect

    fn = get_combiner(name)
    opts = filter_options(fn, dict(rescale=True, n_batch=2, no_such_option=1))
    passthrough = any(
        p.kind is inspect.Parameter.VAR_KEYWORD and not p.name.startswith("_")
        for p in inspect.signature(fn).parameters.values()
    )
    if not passthrough:
        assert "no_such_option" not in opts
    res = fn(torch.Generator().manual_seed(3), _conformance_cloud(), 16, **opts)
    assert torch.isfinite(res.samples).all(), name
