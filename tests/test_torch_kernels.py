"""The port's kernel wrappers on the CPU (their plain versions) against repro's.

Inputs are made with numpy from a seed and handed to both packages. The JAX
side runs repro's ``ref.py`` oracles and repro's ``ops.py`` wrappers, which at
these sizes (N ≥ 256, P ≥ 64) run the Pallas kernels in interpret mode. The
hand-written CUDA kernels themselves are held against the same plain versions
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.img_weights import img_log_weights as jax_img_ops
from repro.kernels.img_weights import img_log_weights_ref as jax_img_ref
from repro.kernels.logreg_loglik import logreg_loglik_grad as jax_logreg_ops
from repro.kernels.logreg_loglik import logreg_loglik_grad_ref as jax_logreg_ref
from repro_torch import kernels
from repro_torch.core.combiners import log_weight_bruteforce
from repro_torch.kernels.img_weights import img_log_weights, img_log_weights_ref
from repro_torch.kernels.logreg_loglik import (
    logreg_loglik,
    logreg_loglik_grad,
    logreg_loglik_grad_ref,
)

REPO = Path(__file__).resolve().parents[1]


def _logreg_inputs(seed, N, d, C=None, G=None):
    rng = np.random.default_rng(seed)
    lead = () if G is None else (G,)
    X = rng.standard_normal(lead + (N, d)).astype(np.float32)
    y = np.where(rng.random(lead + (N,)) < 0.5, 1.0, -1.0).astype(np.float32)
    bshape = lead + (d,) if C is None else lead + (d, C)
    beta = (0.3 * rng.standard_normal(bshape)).astype(np.float32)
    return X, y, beta


# ℓ is a float32 sum of N terms taken in another order than XLA's: relative
# error ~1e-6, so rtol 1e-5 (repro's own kernel test uses the same); ∇ℓ
# entries can cancel towards 0, hence an atol of 1e-3 beside rtol 1e-4.
LL_RTOL, G_RTOL, G_ATOL = 1e-5, 1e-4, 1e-3


@pytest.mark.parametrize("N,d", [(5000, 50), (1024, 54), (100, 3), (1025, 16), (1, 50)])
def test_logreg_plain_matches_jax_ref(N, d):
    X, y, beta = _logreg_inputs(N + d, N, d)
    l, g = logreg_loglik_grad(torch.from_numpy(X), torch.from_numpy(y),
                              torch.from_numpy(beta), scale=1.7)
    lr, gr = jax_logreg_ref(jnp.asarray(X), jnp.asarray(y), jnp.asarray(beta), scale=1.7)
    assert l.shape == () and g.shape == (d,)
    np.testing.assert_allclose(l.numpy(), np.asarray(lr), rtol=LL_RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(gr), rtol=G_RTOL, atol=G_ATOL)


@pytest.mark.parametrize("N,d,C", [(2048, 20, 5), (300, 50, 1), (1025, 7, 3)])
def test_logreg_plain_matches_pallas_interpret_multichain(N, d, C):
    """repro's ops wrapper runs the Pallas kernel (interpret) at N ≥ 256."""
    X, y, beta = _logreg_inputs(N * C, N, d, C)
    l, g = logreg_loglik_grad(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(beta))
    lj, gj = jax_logreg_ops(jnp.asarray(X), jnp.asarray(y), jnp.asarray(beta))
    assert l.shape == (C,) and g.shape == (d, C)
    np.testing.assert_allclose(l.numpy(), np.asarray(lj), rtol=LL_RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=G_RTOL, atol=G_ATOL)


def test_logreg_batched_problems_match_pallas_per_problem():
    """The port's leading problem axis G: each problem is repro's kernel call."""
    G, N, d, C = 4, 700, 12, 2
    X, y, beta = _logreg_inputs(7, N, d, C, G=G)
    l, g = logreg_loglik_grad(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(beta),
                              scale=0.25)
    assert l.shape == (G, C) and g.shape == (G, d, C)
    for i in range(G):
        lj, gj = jax_logreg_ops(jnp.asarray(X[i]), jnp.asarray(y[i]), jnp.asarray(beta[i]),
                                scale=0.25)
        np.testing.assert_allclose(l[i].numpy(), np.asarray(lj), rtol=LL_RTOL)
        np.testing.assert_allclose(g[i].numpy(), np.asarray(gj), rtol=G_RTOL, atol=G_ATOL)


def test_logreg_autograd_function_gives_the_true_gradient():
    """Backward of the autograd Function = autograd of the plain ℓ = jax.grad."""
    G, N, d, C = 3, 500, 9, 2
    X, y, beta = _logreg_inputs(11, N, d, C, G=G)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    w = torch.linspace(0.5, 2.0, G * C).reshape(G, C)  # non-uniform upstream gradient
    b1 = torch.from_numpy(beta).requires_grad_(True)
    (g_fn,) = torch.autograd.grad((logreg_loglik(Xt, yt, b1) * w).sum(), b1)
    b2 = torch.from_numpy(beta).requires_grad_(True)
    (g_ad,) = torch.autograd.grad((logreg_loglik_grad_ref(Xt, yt, b2)[0] * w).sum(), b2)
    np.testing.assert_allclose(g_fn.numpy(), g_ad.numpy(), rtol=G_RTOL, atol=G_ATOL)
    jax_g = jax.grad(lambda b: jax_logreg_ref(jnp.asarray(X[0]), jnp.asarray(y[0]), b)[0])(
        jnp.asarray(beta[0, :, 0])
    )
    np.testing.assert_allclose(g_fn[0, :, 0].numpy() / w[0, 0].item(), np.asarray(jax_g),
                               rtol=G_RTOL, atol=G_ATOL)


# log w ≈ −SSE/(2h²) − const, |log w| up to ~1e4 at h=0.3 and d=130: the port
# and XLA sum in other orders, so float32 relative error ~1e-6; rtol 2e-5
# with atol 5e-3 as in repro's own kernel test.
IMG_RTOL, IMG_ATOL = 2e-5, 5e-3


@pytest.mark.parametrize("P,M,d", [(300, 10, 50), (160, 10, 50), (161, 10, 37),
                                   (65, 3, 130), (64, 2, 1), (10, 4, 5)])
@pytest.mark.parametrize("h", [0.3, 1.0])
def test_img_plain_matches_jax(P, M, d, h):
    theta = np.random.default_rng(P + d).standard_normal((P, M, d)).astype(np.float32)
    got = img_log_weights(torch.from_numpy(theta), h)
    assert got.shape == (P,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_img_ref(jnp.asarray(theta), h)),
                               rtol=IMG_RTOL, atol=IMG_ATOL)
    # repro's wrapper: Pallas interpret at P >= 64 (zero-padded d), else its ref
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_img_ops(jnp.asarray(theta), h)),
                               rtol=IMG_RTOL, atol=IMG_ATOL)


def test_img_plain_matches_log_weight_bruteforce():
    theta = torch.from_numpy(np.random.default_rng(0).standard_normal((128, 8, 5)).astype(np.float32))
    h = torch.tensor(0.7)
    np.testing.assert_allclose(img_log_weights(theta, h).numpy(),
                               log_weight_bruteforce(theta, h).numpy(), rtol=1e-5, atol=1e-4)


def test_cpu_tensors_take_the_plain_version_and_never_count_a_launch():
    kernels.reset_launches()
    X, y, beta = _logreg_inputs(3, 300, 8, 2, G=2)
    args = (torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(beta))
    for a, b in zip(logreg_loglik_grad(*args), logreg_loglik_grad_ref(*args)):
        assert torch.equal(a, b)
    theta = torch.randn(70, 4, 9)
    assert torch.equal(img_log_weights(theta, 0.4), img_log_weights_ref(theta, 0.4))
    assert kernels.launch_counts() == {"logreg_loglik_grad": 0, "img_log_weights": 0}


def test_wrappers_reject_mismatched_shapes():
    with pytest.raises(ValueError):
        logreg_loglik_grad(torch.zeros(2, 5, 3), torch.zeros(2, 4), torch.zeros(2, 3, 1))
    with pytest.raises(ValueError):
        logreg_loglik_grad(torch.zeros(2, 5, 3), torch.zeros(2, 5), torch.zeros(3, 1))
    with pytest.raises(ValueError):
        img_log_weights(torch.zeros(4, 3), 1.0)


def test_every_kernel_names_its_tpu_kernel_and_its_cuda_source():
    for k in kernels.KERNELS.values():
        assert k.source.suffix == ".cu" and k.source.exists()
        path, line = k.replaces.split(":")
        src = (REPO / path).read_text().splitlines()
        assert src[int(line) - 1].startswith("def ")
