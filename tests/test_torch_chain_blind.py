"""Per-chain sums that do not follow the chain count: linear-Gaussian's and
the GMM's log-likelihoods and their gradients (``SquaredResiduals``,
``MixtureLogLik``, both over ``utils/rowwise.py``).

Held to ``repro``'s ``log_lik`` and its ``jax.grad`` on the reference's data
and θ, to the analytic gradient in float64 (``gradcheck``), and to
themselves: ten chains' values and gradients equal, bit for bit, the same
chains' in two slices of five. The card test of the same property is
``tests/test_torch_cuda.py::test_log_lik_and_gradient_do_not_follow_the_chain_count``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.subposterior import partition_data as jax_partition
from repro.models.bayes import get_model as jax_get_model
from repro_torch.core.subposterior import partition_data
from repro_torch.interop import from_reference_data
from repro_torch.models.bayes import get_model
from repro_torch.models.bayes.gmm import MixtureLogLik
from repro_torch.models.bayes.linear_gaussian import SquaredResiduals
from repro_torch.samplers.mala import value_and_grad
from repro_torch.utils.rowwise import colsum, rowdot
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

N = {"linear": 3000, "gmm": 3000}


def _shards(name, M, seed=0):
    """The reference's data and a θ near its truth, both packages' shards."""
    jm = jax_get_model(name)
    data, theta = jm.generate_data(jax.random.PRNGKey(seed), N[name])
    data = {k: np.asarray(v) for k, v in data.items()}
    rng = np.random.default_rng(seed)
    thetas = (np.asarray(theta).reshape(-1)
              + 0.1 * rng.standard_normal((M, jm.d))).astype(np.float32)
    jshards = jax_partition({k: jnp.asarray(v) for k, v in data.items()}, M,
                            only=jm.shard_keys)
    tdata, _ = from_reference_data(data, np.asarray(theta), device="cpu")
    return jshards, partition_data(tdata, M, only=get_model(name).shard_keys), thetas


# log-likelihoods of 300 rows of size ~1–10 summed in float32 in another
# order: rtol 1e-5, atol 1e-2 on totals ~1e3; the gradients' entries are sums
# of the same rows with cancellation: atol 1e-3 of max|g| (~1e3) plus rtol 1e-4
@pytest.mark.parametrize("name", ["linear", "gmm"])
def test_log_lik_and_gradient_match_the_reference(name):
    M = 10
    jm, tm = jax_get_model(name), get_model(name)
    jshards, shards, thetas = _shards(name, M)
    keys = jm.shard_keys or tuple(jshards)
    want_ll, want_g = [], []
    for m in range(M):
        shard = {k: (v[m] if k in keys else v) for k, v in jshards.items()}
        ll, g = jax.value_and_grad(lambda th: jm.log_lik(th, shard))(jnp.asarray(thetas[m]))
        want_ll.append(float(ll))
        want_g.append(np.asarray(g))
    ll, g = value_and_grad(lambda th: tm.log_lik(th, shards), torch.from_numpy(thetas))
    want_g = np.stack(want_g)
    np.testing.assert_allclose(ll.numpy(), want_ll, rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-4,
                               atol=1e-3 * np.abs(want_g).max())


@pytest.mark.parametrize("name", ["linear", "gmm"])
def test_ten_chains_are_two_slices_of_five_bitwise(name):
    tm = get_model(name)
    _, shards, thetas = _shards(name, 10, seed=1)
    keys = tm.shard_keys or tuple(shards)
    theta = torch.from_numpy(thetas)
    ll, g = value_and_grad(lambda th: tm.log_lik(th, shards), theta)
    for half in (slice(0, 5), slice(5, 10)):
        part = {k: (v[half] if k in keys else v) for k, v in shards.items()}
        ll_h, g_h = value_and_grad(lambda th: tm.log_lik(th, part), theta[half])
        assert torch.equal(ll_h, ll[half]) and torch.equal(g_h, g[half])


def test_functions_gradients_are_the_analytic_ones_in_float64():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 70, 4), generator=gen, dtype=torch.float64)
    y = torch.randn((3, 70), generator=gen, dtype=torch.float64)
    theta = torch.randn((3, 4), generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda th: SquaredResiduals.apply(th, x, y), (theta,))
    k = 3
    xs = torch.randn((2, 90, 2), generator=gen, dtype=torch.float64)
    w = torch.full((k,), 1.0 / k, dtype=torch.float64)
    s2 = torch.tensor(1.3, dtype=torch.float64)
    means = torch.randn((2, 2 * k), generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda th: MixtureLogLik.apply(th, xs, w, s2), (means,))
    # broadcast: one shard's rows under a batch of chains
    theta2 = torch.randn((5, 4), generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda th: SquaredResiduals.apply(th, x[0], y[0]),
                                    (theta2,))


def test_rowdot_and_colsum_are_the_products_and_sums():
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((4, 100, 7), generator=gen, dtype=torch.float64)
    v = torch.randn((4, 7), generator=gen, dtype=torch.float64)
    torch.testing.assert_close(rowdot(a, v), (a @ v.unsqueeze(-1)).squeeze(-1))
    torch.testing.assert_close(colsum(a), a.sum(dim=-2))
