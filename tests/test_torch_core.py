"""Deterministic modules of the port against repro on identical inputs.

Inputs are made with numpy from a seed and passed to both packages; JAX
stays on the CPU. Each tolerance is stated beside its test with its reason.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.spec import RunSpec as JaxRunSpec
from repro.core import bandwidth as jbw
from repro.core import gaussian as jg
from repro.core import metrics as jm
from repro.core import subposterior as jsub
from repro.models.bayes import get_model as jax_get_model
from repro.samplers import adaptation as jad
from repro.utils.options import filter_kwargs as jax_filter_kwargs
from repro_torch import resolve_device
from repro_torch.api import Pipeline, RunSpec
from repro_torch.core import bandwidth as tbw
from repro_torch.core import gaussian as tg
from repro_torch.core import metrics as tm
from repro_torch.core import subposterior as tsub
from repro_torch.interop import from_reference_data
from repro_torch.models.bayes import get_model
from repro_torch.samplers import adaptation as tad
from repro_torch.utils.options import filter_kwargs


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _draws(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def test_filter_kwargs_matches_reference():
    def plain(*, a=1, b=2, **_ignored):
        pass

    def passthrough(x, *, a=1, **options):
        pass

    opts = {"a": 3, "c": 4, "b": 5}
    for fn in (plain, passthrough):
        assert filter_kwargs(fn, opts) == jax_filter_kwargs(fn, opts)


# Moments of 500 float32 draws: sums in another order than XLA's, relative
# error ~1e-6 → rtol 1e-5, atol 1e-6 for near-zero covariance entries.
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("diag", [False, True])
def test_fit_moments(masked, diag):
    s = _draws(0, (500, 6), 0.7) + 1.5
    mask = (np.arange(500) < 377).astype(np.float32) if masked else None
    got = tg.fit_moments(_t(s), None if mask is None else _t(mask), diag=diag)
    want = jg.fit_moments(jnp.asarray(s), None if mask is None else jnp.asarray(mask), diag=diag)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.cov.numpy(), np.asarray(want.cov), rtol=1e-5, atol=1e-6)


def test_fit_moments_batched_over_machines_is_per_machine():
    s = _draws(1, (4, 200, 5))
    mask = (np.arange(200)[None, :] < np.array([200, 150, 99, 3])[:, None]).astype(np.float32)
    got = tg.fit_moments(_t(s), _t(mask))
    for m in range(4):
        want = jg.fit_moments(jnp.asarray(s[m]), jnp.asarray(mask[m]))
        np.testing.assert_allclose(got.mean[m].numpy(), np.asarray(want.mean), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.cov[m].numpy(), np.asarray(want.cov), rtol=1e-5, atol=1e-6)


def test_product_moments_and_log_normal_pdf():
    """Cholesky solves of 10 well-conditioned 8×8 covariances: rtol 1e-4."""
    rng = np.random.default_rng(2)
    means = rng.standard_normal((10, 8)).astype(np.float32)
    a = rng.standard_normal((10, 8, 8)).astype(np.float32) * 0.3
    covs = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(8, dtype=np.float32)).astype(np.float32)
    got = tg.product_moments(_t(means), _t(covs))
    want = jg.product_moments(jnp.asarray(means), jnp.asarray(covs))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.cov.numpy(), np.asarray(want.cov), rtol=1e-4, atol=1e-6)
    x = rng.standard_normal((3, 7, 8)).astype(np.float32)
    for cov in (covs[0], np.diag(covs[0]).copy()):
        np.testing.assert_allclose(
            tg.log_normal_pdf(_t(x), _t(means[0]), _t(cov)).numpy(),
            np.asarray(jg.log_normal_pdf(jnp.asarray(x), jnp.asarray(means[0]), jnp.asarray(cov))),
            rtol=1e-5, atol=1e-4,
        )
    d_got = tg.product_moments_diag(_t(means), _t(covs[:, 0, :] ** 2 + 0.1))
    d_want = jg.product_moments_diag(jnp.asarray(means), jnp.asarray(covs[:, 0, :] ** 2 + 0.1))
    np.testing.assert_allclose(d_got.mean.numpy(), np.asarray(d_want.mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d_got.cov.numpy(), np.asarray(d_want.cov), rtol=1e-5)


def test_sample_gaussian_moments():
    """Different RNGs: held in distribution. 20,000 draws → mean within 4σ/√n."""
    mean = np.array([1.0, -2.0, 0.5], np.float32)
    cov = np.array([[1.0, 0.3, 0.0], [0.3, 2.0, -0.4], [0.0, -0.4, 0.5]], np.float32)
    gen = torch.Generator().manual_seed(0)
    x = tg.sample_gaussian(gen, tg.GaussianMoments(_t(mean), _t(cov)), 20000).numpy()
    sd = np.sqrt(np.diag(cov))
    assert np.all(np.abs(x.mean(0) - mean) < 4 * sd / np.sqrt(20000))
    np.testing.assert_allclose(np.cov(x.T), cov, atol=0.06)


def test_bandwidths_use_population_std():
    """jnp.std is ddof=0; the port passes correction=0. Relative 1e-5."""
    s = _draws(3, (4, 300, 7), 0.2)
    np.testing.assert_allclose(tbw.pooled_scale(_t(s)).item(), float(jbw.pooled_scale(jnp.asarray(s))),
                               rtol=1e-5)
    np.testing.assert_allclose(tbw.silverman(_t(s[0])).item(), float(jbw.silverman(jnp.asarray(s[0]))),
                               rtol=1e-5)
    i = np.array([1.0, 7.0, 160.0, 1200.0], np.float32)
    np.testing.assert_allclose(
        tbw.annealed(50, scale=0.3)(_t(i)).numpy(),
        np.asarray(jbw.annealed(50, scale=0.3)(jnp.asarray(i))), rtol=1e-6,
    )
    assert abs(tbw.annealed(50, scale=0.3)(160).item() - float(jbw.annealed(50, scale=0.3)(160))) < 1e-6


@pytest.mark.parametrize("T,S,d,chunk", [(300, 700, 5, 128), (1200, 400, 50, 512)])
def test_log_l2_distance(T, S, d, chunk):
    """Pairwise-Gaussian logsumexps of float32 distances in other orders:
    abs 2e-3 on values of size ~10–70 (relative ~1e-4)."""
    p = _draws(T, (T, d), 0.05)
    q = _draws(S, (S, d), 0.05) + 0.01
    got = tm.log_l2_distance(_t(p), _t(q), chunk=chunk).item()
    want = float(jm.log_l2_distance(jnp.asarray(p), jnp.asarray(q), chunk=chunk))
    assert abs(got - want) < 2e-3
    cross = tm.log_mean_gaussian_cross(_t(p), _t(q), 0.01, chunk=chunk).item()
    assert abs(cross - float(jm.log_mean_gaussian_cross(jnp.asarray(p), jnp.asarray(q), 0.01,
                                                        chunk=chunk))) < 2e-3
    if d < 40:
        got = tm.l2_distance(_t(p), _t(q)).item()
        want = float(jm.l2_distance(jnp.asarray(p), jnp.asarray(q)))
        assert abs(got - want) <= 1e-3 * abs(want)


def _logreg_data(n, seed=0):
    data, beta = jax_get_model("logreg").generate_data(jax.random.PRNGKey(seed), n)
    return {k: np.asarray(v) for k, v in data.items()}, np.asarray(beta)


def test_logreg_log_prior_and_log_lik_on_reference_data():
    """Value and gradient of the port's model (through the kernel wrapper's
    plain version) vs repro's jnp model on repro's own data. ℓ is a sum of
    3000 terms: rtol 1e-5; ∇ℓ atol 1e-3."""
    data, beta = _logreg_data(3000)
    tdata, tbeta = from_reference_data(data, beta, device="cpu")
    jm_, tm_ = jax_get_model("logreg"), get_model("logreg")
    theta = (beta + 0.1 * np.random.default_rng(0).standard_normal(50)).astype(np.float32)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    np.testing.assert_allclose(tm_.log_prior(_t(theta)).item(), float(jm_.log_prior(jnp.asarray(theta))),
                               rtol=1e-6)
    th = _t(theta).requires_grad_(True)
    ll = tm_.log_lik(th, tdata)
    (g,) = torch.autograd.grad(ll, th)
    jll, jg_ = jax.value_and_grad(lambda t: jm_.log_lik(t, jdata))(jnp.asarray(theta))
    np.testing.assert_allclose(ll.item(), float(jll), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg_), rtol=1e-4, atol=1e-3)
    # batched over chains: one kernel problem per leading index
    thetas = np.stack([theta, theta * 0.5]).astype(np.float32)
    both = tm_.log_lik(_t(thetas), {k: v[None].expand(2, *v.shape).contiguous()
                                    for k, v in tdata.items()})
    np.testing.assert_allclose(both[1].item(), float(jm_.log_lik(jnp.asarray(thetas[1]), jdata)),
                               rtol=1e-5)


@pytest.mark.parametrize("n,M", [(1003, 4), (997, 10)])
def test_partition_and_subposterior_logpdf(n, M):
    """Padded shards with count < S: value and gradient of every machine's
    subposterior vs repro's per-shard logpdf. rtol 1e-5 on values ~1e2,
    gradients atol 2e-3."""
    data, beta = _logreg_data(n, seed=n)
    tdata, _ = from_reference_data(data, beta, device="cpu")
    tshards, tcounts = tsub.partition_data(tdata, M, pad=True)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    jshards, jcounts = jsub.partition_data(jdata, M, pad=True)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(tshards["x"].numpy(), np.asarray(jshards["x"]))
    model, jmodel = get_model("logreg"), jax_get_model("logreg")
    lp = tsub.make_subposterior_logpdf(model.log_prior, model.log_lik, tshards, M, count=tcounts)
    theta = _draws(5, (M, 50), 0.3)
    th = _t(theta).requires_grad_(True)
    vals = lp(th)
    (grads,) = torch.autograd.grad(vals.sum(), th)

    def one(shard, count, th):
        jlp = jsub.make_subposterior_logpdf(jmodel.log_prior, jmodel.log_lik, shard, M,
                                            count=count)
        return jax.value_and_grad(jlp)(th)

    jv, jgr = jax.jit(jax.vmap(one))(jshards, jcounts, jnp.asarray(theta))
    np.testing.assert_allclose(vals.detach().numpy(), np.asarray(jv), rtol=1e-5)
    np.testing.assert_allclose(grads.numpy(), np.asarray(jgr), rtol=1e-4, atol=2e-3)


def test_subposterior_logpdf_on_prepared_shards_matches_raw_labels():
    """The chains build their log-density on ``prepare_data(shards)``, whose
    ±1 labels ``s`` are made once and sliced with the pad row like every
    other per-datum key: the same labels reach the kernel as when ``log_lik``
    converts ``y`` itself, so values and gradients are equal bit for bit."""
    data, beta = _logreg_data(1003, seed=7)
    tdata, _ = from_reference_data(data, beta, device="cpu")
    shards, counts = tsub.partition_data(tdata, 4, pad=True)
    model = get_model("logreg")
    prepared = model.prepare_data(shards)
    np.testing.assert_array_equal(prepared["s"].numpy(), 2.0 * shards["y"].numpy() - 1.0)
    theta = _t(_draws(6, (4, 50), 0.3))
    out = []
    for sh in (shards, prepared):
        th = theta.clone().requires_grad_(True)
        val = tsub.make_subposterior_logpdf(model.log_prior, model.log_lik, sh, 4, count=counts)(th)
        (grad,) = torch.autograd.grad(val.sum(), th)
        out.append((val.detach().numpy(), grad.numpy()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])


def test_partition_without_pad_rejects_ragged_n():
    with pytest.raises(ValueError):
        tsub.partition_data({"x": torch.zeros(10, 2)}, 3)


def test_da_update_matches_reference():
    """Float32 scalar recursions: rtol 1e-6 after 50 updates."""
    accs = np.random.default_rng(4).random(50).astype(np.float32)
    js = jad.da_init(0.1)
    ts = tad.da_init(0.1, (1,))
    for a in accs:
        js = jad.da_update(js, jnp.asarray(a), 0.55)
        ts = tad.da_update(ts, _t([a]), 0.55)
    for f in ("log_eps", "log_eps_avg", "h_avg", "step", "mu"):
        np.testing.assert_allclose(getattr(ts, f).numpy()[0], float(getattr(js, f)), rtol=1e-6)


@pytest.mark.parametrize("fields", [
    {},
    {"sampler": "mala", "M": 10, "T": 1200, "combiner": ("parametric", "nonparametric", "semiparametric"),
     "combiner_options": {"weight_eval": "kernel", "n_batch": 16}},
    {"combiner": ["nonparametric"], "seed": 7, "n": 2000, "step_size": 0.05},
    {"combiner": "parametric", "score_metric": "logl2", "sampler_options": {"a": [1, 2]}},
])
def test_spec_id_is_byte_identical_to_reference(fields):
    t = RunSpec(model="logreg", **fields)
    j = JaxRunSpec(model="logreg", **fields)
    assert t.to_json() == j.to_json()
    assert t.spec_id == j.spec_id
    assert RunSpec.from_json(t.to_json()) == t
    assert dataclasses.replace(t, seed=1).spec_id != t.spec_id


def test_spec_validates_against_the_ports_registries():
    with pytest.raises(KeyError):
        RunSpec(model="logreg", combiner="weierstrass").validate()
    with pytest.raises(KeyError):
        RunSpec(model="logreg", sampler="hmc").validate()
    with pytest.raises(ValueError):
        RunSpec(model="logreg", M=0)


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = RunSpec(model="logreg", n=200, M=2, T=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pipeline(spec)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        from_reference_data({"x": np.zeros((2, 2))}, np.zeros(2))
    assert Pipeline(spec, device="cpu").device.type == "cpu"


def test_pipeline_rejects_data_of_another_size():
    data, beta = _logreg_data(300)
    with pytest.raises(ValueError, match="rows"):
        Pipeline(RunSpec(model="logreg", n=200), data=from_reference_data(data, beta, device="cpu"),
                 device="cpu")
