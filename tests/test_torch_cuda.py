"""The hand-written CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``); without one, the
``cuda_device`` fixture skips it. This file imports no JAX, so it runs on a
machine that has only the port's stack:

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the repo's ``tests/conftest.py`` configures JAX.)
"""

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.img_weights import img_log_weights, img_log_weights_ref
from repro_torch.kernels.logreg_loglik import (
    logreg_loglik,
    logreg_loglik_grad,
    logreg_loglik_grad_ref,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _logreg_inputs(device, G, N, d, C, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((G, N, d), generator=gen, device=device)
    y = torch.where(torch.rand((G, N), generator=gen, device=device) < 0.5, -1.0, 1.0)
    beta = torch.randn((G, d, C), generator=gen, device=device)
    return X, y, beta


# ℓ sums N float32 terms in another order than the plain version: relative
# error ~1e-6 → rtol 1e-5; gradient entries can cancel → atol 1e-2 at N=50,000.
@pytest.mark.parametrize("G,N,d,C", [(10, 5000, 50, 1), (1, 50000, 50, 1), (1, 1, 50, 1),
                                     (3, 4999, 37, 2), (2, 65, 130, 3)])
def test_logreg_kernel_matches_plain(cuda_device, G, N, d, C):
    X, y, beta = _logreg_inputs(cuda_device, G, N, d, C)
    before = kernels.KERNELS["logreg_loglik_grad"].launches
    ll, g = logreg_loglik_grad(X, y, beta, scale=0.5)
    torch.cuda.synchronize()
    assert kernels.KERNELS["logreg_loglik_grad"].launches == before + 1
    ll_r, g_r = logreg_loglik_grad_ref(X, y, beta, scale=0.5)
    torch.testing.assert_close(ll, ll_r, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(g, g_r, rtol=1e-4, atol=1e-2)


def test_logreg_kernel_is_deterministic(cuda_device):
    X, y, beta = _logreg_inputs(cuda_device, 1, 50000, 50, 1)
    first = logreg_loglik_grad(X, y, beta)
    for _ in range(3):
        for a, b in zip(first, logreg_loglik_grad(X, y, beta)):
            assert torch.equal(a, b)


def test_logreg_autograd_on_card(cuda_device):
    X, y, beta = _logreg_inputs(cuda_device, 10, 5000, 50, 1)
    b1 = beta.clone().requires_grad_(True)
    (g1,) = torch.autograd.grad(logreg_loglik(X, y, b1).sum(), b1)
    b2 = beta.clone().requires_grad_(True)
    (g2,) = torch.autograd.grad(logreg_loglik_grad_ref(X, y, b2)[0].sum(), b2)
    torch.testing.assert_close(g1, g2, rtol=1e-4, atol=1e-2)


# log w of size up to ~1e5 at h=0.05; float32 relative error ~1e-6.
@pytest.mark.parametrize("P,M,d,h", [(160, 10, 50, 0.05), (161, 10, 37, 0.3), (1, 1, 1, 1.0),
                                     (64, 2, 130, 0.7)])
def test_img_kernel_matches_plain(cuda_device, P, M, d, h):
    gen = torch.Generator(device=cuda_device).manual_seed(P)
    theta = torch.randn((P, M, d), generator=gen, device=cuda_device)
    out = img_log_weights(theta, torch.tensor(h, device=cuda_device))
    torch.cuda.synchronize()
    torch.testing.assert_close(out, img_log_weights_ref(theta, h), rtol=1e-5, atol=1e-3)


def test_cuda_wrappers_check_operands(cuda_device):
    X, y, beta = _logreg_inputs(cuda_device, 2, 100, 8, 1)
    with pytest.raises(ValueError):
        logreg_loglik_grad(X.transpose(1, 2).contiguous().transpose(1, 2), y, beta)
    with pytest.raises(TypeError):
        logreg_loglik_grad(X.double(), y, beta)
    with pytest.raises(ValueError):
        img_log_weights(torch.randn(4, 3, 2, device=cuda_device).transpose(0, 2), 1.0)
