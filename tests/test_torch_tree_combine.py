"""repro_torch.core.tree_combine: the pairwise reduction, held to repro's.

The tree cases of ``tests/test_combiner_conformance.py`` (the families that
emit exactly ``n_draws`` rows are reduction steps; odd M keeps the
leftover's counts honest), ``tests/test_combiners_registry.py`` (a
fixed-output combiner is refused, with the reference's message) and
``tests/test_metrics_bandwidth.py`` (the parametric tree agrees with the
flat product), within the port. Then the data path against ``repro``
exactly: with a deterministic stand-in combiner in both packages, every
round's pairing, odd-M pass-through, wrap-around padding and counts give
the same output, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.tree_combine as rtree
from repro.core.combiners import CombineResult as RCombineResult
from repro_torch.core import tree_combine as tree_module
from repro_torch.core.combiners import CombineResult, get_combiner
from repro_torch.core.tree_combine import tree_combine
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

M, T, D = 3, 120, 2


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def cloud():
    """Well-separated machines so masking bugs shift the output visibly."""
    rng = np.random.default_rng(0)
    centers = np.linspace(-1.0, 1.0, M)[:, None, None] * np.ones((1, 1, D))
    return torch.from_numpy((centers + 0.5 * rng.normal(size=(M, T, D))).astype(np.float32))


@pytest.mark.parametrize("name", ["weierstrass", "rpt", "importance_pool", "parametric",
                                  "nonparametric", "semiparametric", "consensus"])
def test_new_families_accepted_by_tree_combine(cloud, name):
    """Exactly-n_draws output makes each family a valid reduction step."""
    res = tree_combine(_gen(4), cloud, 48, method=name)
    assert isinstance(res, CombineResult)
    assert res.samples.shape == (48, D)
    assert bool(torch.isfinite(res.samples).all())


def test_tree_combine_odd_m_keeps_counts_honest():
    """Odd-M leftover: the unpaired chain is padded by wrapping its valid
    rows; with NaN planted beyond its count, a dishonest count would poison
    the final draws."""
    m, t, d = 3, 96, 2
    samples = torch.from_numpy(
        (0.4 * np.random.default_rng(5).normal(size=(m, t, d))).astype(np.float32))
    samples[2, 30:] = float("nan")  # invalid tail of the odd chain
    counts = torch.tensor([t, t, 30], dtype=torch.int32)
    res = tree_combine(_gen(6), samples, 40, counts=counts, method="nonparametric")
    assert res.samples.shape == (40, d)
    assert bool(torch.isfinite(res.samples).all())


def test_tree_combine_odd_m_leftover_not_duplicated_into_counts():
    """The padded leftover keeps counts = its valid length, so a sentinel
    at the first invalid row is never read."""
    m, t, d = 3, 64, 1
    base = torch.zeros((m, t, d)) + torch.arange(m, dtype=torch.float32)[:, None, None]
    base[2, 5:] = 1e4
    counts = torch.tensor([t, t, 5], dtype=torch.int32)
    res = tree_combine(_gen(7), base, 32, counts=counts, method="subpost_average")
    assert float(res.samples.abs().max()) < 100.0


def test_tree_combine_rejects_non_reduction_combiners(cloud):
    """pool emits the 2T-row union: not a reduction step (the reference's
    message)."""
    with pytest.raises(ValueError, match="tree-reduction"):
        tree_combine(_gen(0), cloud[:2], 64, method="pool")


def test_pairwise_tree_combiner_matches_flat_on_gaussians():
    """The O(dTM) parametric tree against the flat parametric product on
    Gaussian chains: the tree's sample mean within the reference test's
    0.12 of the flat product's exact mean, its covariance within 25 % of the
    flat product's on the diagonal and 0.02 off it (three rounds of refits
    from 3,000 draws each add a few per cent of sampling error)."""
    m, t, d = 8, 3000, 3
    rng = np.random.default_rng(4)
    means = rng.normal(size=(m, d))
    samples = torch.from_numpy((means[:, None, :] + 0.7 * rng.normal(size=(m, t, d)))
                               .astype(np.float32))
    flat = get_combiner("parametric")(_gen(5), samples, t)
    tree = tree_combine(_gen(6), samples, t, method="parametric")
    np.testing.assert_allclose(tree.samples.mean(0).numpy(), flat.moments.mean.numpy(),
                               atol=0.12)
    cov = torch.cov(tree.samples.T).numpy()
    want = flat.moments.cov.numpy()
    np.testing.assert_allclose(np.diag(cov), np.diag(want), rtol=0.25)
    np.testing.assert_allclose(cov - np.diag(np.diag(cov)), want - np.diag(np.diag(want)),
                               atol=0.02)


def _port_standin(gen, samples, n_draws, *, counts=None):
    """Deterministic stand-in step: machine 0's valid rows wrapped to
    n_draws, shifted by 10 × machine 1's count (so counts show in the bits)."""
    idx = torch.arange(n_draws) % counts[0].clamp(min=1)
    return CombineResult(samples[0][idx] + 10.0 * counts[1].to(torch.float32),
                         torch.ones(()))


def _ref_standin(key, samples, n_draws, *, counts=None):
    idx = jnp.arange(n_draws) % jnp.maximum(counts[0], 1)
    return RCombineResult(samples[0][idx] + 10.0 * counts[1].astype(jnp.float32),
                          jnp.ones(()), None)


@pytest.mark.parametrize("m,t,n_draws,counts", [
    (3, 16, 16, [16, 16, 5]),
    (5, 12, 12, [12, 7, 12, 3, 9]),
    (7, 10, 20, [10, 10, 2, 10, 6, 10, 4]),
    (10, 8, 8, [8] * 10),
    (2, 9, 4, [9, 1]),
])
def test_tree_data_path_matches_reference_exactly(monkeypatch, m, t, n_draws, counts):
    """The rounds, the odd-M pass-through and its padding, and the counts
    each round hands its combiner: with the same deterministic step in both
    packages, the tree's output is the reference's bit for bit."""
    data = np.random.default_rng(m).normal(size=(m, t, 2)).astype(np.float32)
    cnt = np.asarray(counts, np.int32)
    for j, c in enumerate(counts):
        data[j, c:] = 1e4 + j  # never read: beyond the valid prefix
    monkeypatch.setattr(tree_module, "get_combiner", lambda name: _port_standin)
    monkeypatch.setattr(rtree, "get_combiner", lambda name: _ref_standin)
    got = tree_combine(_gen(0), torch.from_numpy(data), n_draws,
                       counts=torch.from_numpy(cnt), method="standin").samples
    want = rtree.tree_combine(jax.random.PRNGKey(0), jnp.asarray(data), n_draws,
                              counts=jnp.asarray(cnt), method="standin").samples
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.abs().max()) < 1e3


def test_tree_draws_depend_only_on_the_callers_generator(cloud):
    a = tree_combine(_gen(9), cloud, 40, method="nonparametric").samples
    b = tree_combine(_gen(9), cloud, 40, method="nonparametric").samples
    c = tree_combine(_gen(10), cloud, 40, method="nonparametric").samples
    assert torch.equal(a, b) and not torch.equal(a, c)
