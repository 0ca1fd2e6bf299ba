"""The rest of the core maths against repro: gaussian, bandwidth, metrics, subposterior.

Each function of the port takes the same arrays as its ``repro`` counterpart,
made with numpy from a seed and passed through numpy, and is held to a
float32 tolerance stated at each check; the reference tests' own properties
(ESS detecting correlation, MMD near zero for one law, the minibatch
estimator's mean over disjoint batches, the MH ratio's 1/M prior) are held on
the port too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bandwidth as jbw
from repro.core import gaussian as jg
from repro.core import metrics as jm
from repro.core import subposterior as jsub
from repro_torch.core import bandwidth as tbw
from repro_torch.core import gaussian as tg
from repro_torch.core import metrics as tm
from repro_torch.core import subposterior as tsub
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def test_log_isotropic_normal_pdf_matches_reference():
    """Batched x (5, 7, 4) around a mean, at scalar variances; rtol 1e-6 on
    values of size ~10 (float32, the same formula)."""
    rng = np.random.default_rng(0)
    x, mean = _np(rng, 5, 7, 4), _np(rng, 4)
    for var in (0.3, 1.0, 7.5):
        want = np.asarray(jg.log_isotropic_normal_pdf(jnp.asarray(x), jnp.asarray(mean), var))
        got = tg.log_isotropic_normal_pdf(torch.from_numpy(x), torch.from_numpy(mean), var)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_failed_cholesky_is_nan_as_in_the_reference():
    """A factor of a matrix that is not positive definite: NaN in its lower
    triangle and 0 above, as jnp.linalg.cholesky gives (torch's CPU factor
    would be partial and finite), batch entry by batch entry; the Gaussian
    product of chains whose draws repeat (rank below d, the GMM's random
    walk at GMM_SPEC) is then NaN in both packages, and a product of full-rank
    chains matches repro within rtol 1e-4."""
    rng = np.random.default_rng(3)
    bad = np.array([[1.0, 2.0], [2.0, 1.0]], np.float32)
    a = np.stack([bad, np.eye(2, dtype=np.float32) * 2.0])
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(a)))
    got = tg.cholesky(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    assert np.all(got[0][np.triu_indices(2, 1)] == 0.0)
    d, T = 6, 40
    full = _np(rng, 3, T, d)
    stuck = full.copy()
    stuck[1] = np.repeat(full[1, :3], [13, 14, 13], axis=0)  # three distinct draws
    for samples, degenerate in ((full, False), (stuck, True)):
        jfits = [jg.fit_moments(jnp.asarray(chain)) for chain in samples]
        jprod = jg.product_moments(jnp.stack([f.mean for f in jfits]),
                                   jnp.stack([f.cov for f in jfits]))
        tm_ = tg.fit_moments(torch.from_numpy(samples))
        tprod = tg.product_moments(tm_.mean, tm_.cov)
        for j, t in ((jprod.mean, tprod.mean), (jprod.cov, tprod.cov)):
            j, t = np.asarray(j), t.numpy()
            assert np.isnan(j).all() == np.isnan(t).all() == degenerate
            if not degenerate:
                np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6)


def test_fixed_bandwidth_is_constant():
    for h in (0.05, 1.0):
        sched = tbw.fixed(h)
        for i in (1, 10, torch.tensor(1000)):
            assert float(sched(i)) == float(jbw.fixed(h)(i)) == np.float32(h)
            assert sched(i).dtype == torch.float32


@pytest.mark.parametrize("Q,T,d,h", [(37, 300, 3, 0.4), (700, 90, 10, 0.15), (1, 1, 1, 1.0)])
def test_kde_logpdf_matches_reference(Q, T, d, h):
    """Queries in chunks of 512 (Q = 700 spans two): log p̂ within atol 1e-4
    + rtol 1e-5 (the same expanded-square form in float32)."""
    rng = np.random.default_rng(Q)
    q, s = _np(rng, Q, d), _np(rng, T, d)
    want = np.asarray(jm.kde_logpdf(jnp.asarray(q), jnp.asarray(s), h))
    got = tm.kde_logpdf(torch.from_numpy(q), torch.from_numpy(s), h)
    assert got.shape == (Q,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_effective_sample_size_matches_reference_and_detects_correlation():
    """An iid chain and an AR(1) chain (ρ = 0.95) of 4,000, each through both
    packages: ESS within rtol 1e-3 (FFTs in float32 in another library);
    the reference test's property, ESS(AR1) < 0.3·ESS(iid) and ESS(iid) >
    2,000, on the port's values."""
    rng = np.random.default_rng(3)
    iid = _np(rng, 4000)
    noise = _np(rng, 4000)
    ar = np.empty(4000, np.float32)
    x = 0.0
    for i, e in enumerate(noise):
        x = 0.95 * x + np.sqrt(1 - 0.95**2) * e
        ar[i] = x
    ess = {}
    for label, chain in (("iid", iid), ("ar1", ar)):
        want = float(jm.effective_sample_size(jnp.asarray(chain)))
        ess[label] = float(tm.effective_sample_size(torch.from_numpy(chain)))
        np.testing.assert_allclose(ess[label], want, rtol=1e-3)
    assert ess["ar1"] < 0.3 * ess["iid"] and ess["iid"] > 2000


def test_mmd2_rbf_matches_reference():
    """Same law and shifted law at two lengthscales: MMD² within atol 1e-5 +
    rtol 1e-4 of the reference's; the reference test's property (same law
    < 0.01, shifted law > 10× it) on the port's."""
    rng = np.random.default_rng(7)
    a, b = _np(rng, 600, 2), _np(rng, 600, 2)
    c = (2.0 + _np(rng, 600, 2)).astype(np.float32)
    for ls in (1.0, 0.3):
        for y in (b, c):
            want = float(jm.mmd2_rbf(jnp.asarray(a), jnp.asarray(y), ls))
            got = float(tm.mmd2_rbf(torch.from_numpy(a), torch.from_numpy(y), ls))
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    same = float(tm.mmd2_rbf(torch.from_numpy(a), torch.from_numpy(b), 1.0))
    diff = float(tm.mmd2_rbf(torch.from_numpy(a), torch.from_numpy(c), 1.0))
    assert same < 0.01 and diff > 10 * max(same, 1e-6)


def _gauss_prior(th):
    return -0.5 * (th**2).sum(-1)


def _gauss_lik(th, data):
    x = data["x"]
    return -0.5 * ((x - th.unsqueeze(-2)) ** 2).sum(dim=(-1, -2))


def _jgauss_lik(th, data):
    return -0.5 * jnp.sum((data["x"] - th) ** 2)


def test_minibatch_logpdf_matches_reference_and_is_unbiased():
    """On the reference test's case (60 rows, batches of 10, M = 4): each
    disjoint batch's estimate equals the reference's (rtol 1e-6), their mean
    the full subposterior (rtol 1e-5); batched over 3 chains with per-chain
    shard sizes, each chain's value is its own scale's."""
    rng = np.random.default_rng(0)
    x = _np(rng, 60, 2)
    theta = np.array([0.3, -0.7], np.float32)
    est = tsub.make_minibatch_logpdf(_gauss_prior, _gauss_lik, 4, 60)
    jest = jsub.make_minibatch_logpdf(lambda th: -0.5 * jnp.sum(th**2), _jgauss_lik, 4, 60)
    vals = []
    for i in range(6):
        batch = {"x": torch.from_numpy(x[i * 10:(i + 1) * 10])}
        got = float(est(torch.from_numpy(theta), batch))
        want = float(jest(jnp.asarray(theta), {"x": jnp.asarray(x[i * 10:(i + 1) * 10])}))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        vals.append(got)
    full = 0.25 * float(_gauss_prior(torch.from_numpy(theta))) + float(
        _gauss_lik(torch.from_numpy(theta), {"x": torch.from_numpy(x)}))
    np.testing.assert_allclose(np.mean(vals), full, rtol=1e-5)
    sizes = torch.tensor([60.0, 30.0, 10.0])
    th3 = torch.from_numpy(_np(rng, 3, 2))
    batch3 = {"x": torch.from_numpy(_np(rng, 3, 10, 2))}
    got3 = tsub.make_minibatch_logpdf(_gauss_prior, _gauss_lik, 4, sizes)(th3, batch3)
    for m in range(3):
        one = tsub.make_minibatch_logpdf(_gauss_prior, _gauss_lik, 4, float(sizes[m]))(
            th3[m], {"x": batch3["x"][m]})
        np.testing.assert_allclose(float(got3[m]), float(one), rtol=1e-6)


def test_mh_correction_ratio_matches_reference():
    """The reference test's case (8 rows, M = 4) plus random pairs: the ratio
    within rtol 1e-6 / atol 1e-5 of the reference's and of the hand-written
    underweighted-prior difference."""
    rng = np.random.default_rng(1)
    x = _np(rng, 8, 2)
    ratio = tsub.mh_correction_ratio(_gauss_prior, _gauss_lik, {"x": torch.from_numpy(x)}, 4)
    jratio = jsub.mh_correction_ratio(lambda th: -0.5 * jnp.sum(th**2), _jgauss_lik,
                                      {"x": jnp.asarray(x)}, 4)
    pairs = [(np.array([1.0, 0.0], np.float32), np.zeros(2, np.float32))] + [
        (_np(rng, 2), _np(rng, 2)) for _ in range(4)]
    for t1, t0 in pairs:
        got = float(ratio(torch.from_numpy(t1), torch.from_numpy(t0)))
        want = float(jratio(jnp.asarray(t1), jnp.asarray(t0)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
        hand = (0.25 * -0.5 * (t1**2).sum() - 0.5 * ((x - t1) ** 2).sum()) - (
            0.25 * -0.5 * (t0**2).sum() - 0.5 * ((x - t0) ** 2).sum())
        np.testing.assert_allclose(got, hand, rtol=1e-5, atol=1e-4)
