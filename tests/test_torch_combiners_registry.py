"""The port's combiner registry and IMG engine on repro's registry cases.

The cases of ``tests/test_combiners_registry.py`` that no port test mirrored
yet, through the plain versions on the CPU: every registered name round-trips
to a finite result of the right shape; an unknown name raises with the
choices; batched and kernel-mode IMG sweeps target the sequential sweep's
moments and the closed-form product; full semiparametric W_t runs on the
kernel path; and ``img_log_weights`` agrees with the Eq. 3.5 brute force at
repro's (B, m, d) and at the new experiments' widths, d = 2, 10 and 20 (B =
16·M sites, as the path's sweeps score them). The inputs are repro's own
(made by jax.random from the same keys, passed through numpy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.combiners import available_combiners as jax_available_combiners
from repro.core.combiners import log_weight_bruteforce as jax_log_weight_bruteforce
from repro_torch.core.combiners import (
    CombineResult,
    available_combiners,
    get_combiner,
    log_weight_bruteforce,
)
from repro_torch.kernels.img_weights import img_log_weights
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

M, T, D = 2, 600, 2


@pytest.fixture(scope="module")
def two_gaussian_product():
    """repro's fixture: exact draws from N(±0.5, 0.7² I), whose product is
    N(0, 0.7²/2 I) in closed form."""
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (M, T, D)))
    mus = np.stack([np.full((D,), -0.5), np.full((D,), 0.5)]).astype(np.float32)
    sigma = 0.7
    samples = torch.from_numpy((mus[:, None, :] + sigma * eps).astype(np.float32))
    return samples, torch.from_numpy(mus.mean(0)), sigma / np.sqrt(M)


def test_get_combiner_roundtrips_every_registered_name(two_gaussian_product):
    samples, _, _ = two_gaussian_product
    assert available_combiners() == jax_available_combiners()
    for name in available_combiners():
        res = get_combiner(name)(torch.Generator().manual_seed(1), samples, 64, rescale=True)
        assert isinstance(res, CombineResult), name
        if name in ("pool", "subpostPool"):
            # pool ignores n_draws: the baseline is the full M·T union
            assert res.samples.shape == (M * T, D), name
        else:
            assert res.samples.shape == (64, D), name
        assert bool(torch.isfinite(res.samples).all()), name


def test_unknown_combiner_raises_with_choices():
    with pytest.raises(KeyError, match="nonparametric"):
        get_combiner("no_such_combiner")


def _moments(draws):
    return draws.mean(0).numpy(), draws.std(0, correction=0).numpy()


@pytest.mark.parametrize("mode", [
    dict(n_batch=8),
    dict(n_batch=8, weight_eval="kernel"),
    dict(n_batch=1, weight_eval="kernel"),
])
def test_batched_img_matches_sequential_moments(two_gaussian_product, mode):
    """repro's tolerances (about 3× the across-seed scatter at this size):
    the batched or kernel-mode sweep's means within 0.25 and stds within 35 %
    of the sequential sweep's, both means within 0.2 of the product's, the
    batched std within half the product's std of it."""
    samples, prod_mean, prod_std = two_gaussian_product
    combiner = get_combiner("nonparametric")
    seq = combiner(torch.Generator().manual_seed(2), samples, 3000, rescale=True).samples
    bat = combiner(torch.Generator().manual_seed(3), samples, 3000, rescale=True, **mode).samples
    m_seq, s_seq = _moments(seq)
    m_bat, s_bat = _moments(bat)
    np.testing.assert_allclose(m_bat, m_seq, atol=0.25)
    np.testing.assert_allclose(s_bat, s_seq, rtol=0.35)
    np.testing.assert_allclose(m_bat, prod_mean.numpy(), atol=0.2)
    np.testing.assert_allclose(m_seq, prod_mean.numpy(), atol=0.2)
    assert abs(float(s_bat.mean()) - prod_std) < 0.5 * prod_std


def test_kernel_path_supports_full_semiparametric_weights(two_gaussian_product):
    """Full semiparametric W_t on ``weight_eval="kernel"``: finite draws
    whose mean is the product's within 0.2 (repro's tolerance)."""
    samples, prod_mean, _ = two_gaussian_product
    res = get_combiner("semiparametric")(torch.Generator().manual_seed(6), samples, 64,
                                         weight_eval="kernel", n_batch=4)
    out = res.samples
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.mean(0).numpy(), prod_mean.numpy(), atol=0.2)


@pytest.mark.parametrize("B,m,d", [(8, 4, 3), (128, 8, 5), (300, 16, 64),
                                   (160, 10, 2), (160, 10, 10), (160, 10, 20)])
def test_img_weights_kernel_agrees_with_bruteforce(B, m, d):
    """The wrapper's plain version on a CPU tensor against the port's and
    repro's Eq. 3.5 brute force, on repro's draws: rtol 1e-5, atol 1e-3
    (repro's tolerance)."""
    theta = np.array(jax.random.normal(jax.random.PRNGKey(B + d), (B, m, d)))
    got = img_log_weights(torch.from_numpy(theta), torch.tensor(0.6))
    want = np.asarray(jax.vmap(lambda t: jax_log_weight_bruteforce(t, jnp.asarray(0.6)))(
        jnp.asarray(theta)))
    brute = torch.stack([log_weight_bruteforce(torch.from_numpy(t), 0.6) for t in theta])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), brute.numpy(), rtol=1e-5, atol=1e-3)
