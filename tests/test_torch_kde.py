"""The port's KDE log densities against repro's, on the same numpy inputs.

``machine_kde_log_density_ref`` (torch) is held to repro's chunked jnp ref and
to repro's Pallas kernel in interpret mode (``impl="kernel", interpret=True``,
as ``tests/test_machine_kde.py`` runs it), over the four shapes of that test,
dense and ragged, every ``reduce`` and both ``mixture_weights``. On the CPU
the port's wrapper is its plain version, so the wrapper is held too.

Tolerance: both sides form distances as ‖q‖² + ‖s‖² − 2q·s in float32 with
sums in another order, so a log-kernel term differs by ~ε·(‖q‖² + ‖s‖²)/2h²
≈ 1.2e-7 · 2·50 / (2·0.2²) ≈ 1.5e-4 at the widest case (d = 50, h ≥ 0.2),
and the log densities themselves reach ~1e2: rtol 1e-5, atol 5e-4. Never
bitwise (on jax 0.9.0 repro's ref is not bitwise even its own historical
form).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.combiners.density import masked_silverman as jax_masked_silverman
from repro.kernels.kde_density import kde_log_density_ref as jax_kde_ref
from repro.kernels.kde_density import machine_kde_log_density as jax_machine_kde
from repro.kernels.kde_density import machine_kde_log_density_ref as jax_machine_ref
from repro_torch.core.combiners import machine_kde_logpdfs, masked_silverman
from repro_torch.kernels.kde_density import (
    kde_log_density,
    kde_log_density_ref,
    machine_kde_log_density,
    machine_kde_log_density_ref,
)
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

RTOL, ATOL = 1e-5, 5e-4
SHAPES = [(5, 700, 7, 300), (3, 512, 50, 256), (8, 130, 2, 65), (2, 64, 1, 64)]
REDUCES = ["none", "product", "mixture", "product_mixture"]


def _case(seed, M, T, d, Q, ragged):
    rng = np.random.default_rng(seed)
    samples = rng.standard_normal((M, T, d)).astype(np.float32)
    queries = rng.standard_normal((Q, d)).astype(np.float32)
    h = (np.abs(rng.standard_normal(M)) * 0.4 + 0.2).astype(np.float32)
    counts = None
    if ragged:
        counts = rng.integers(1, T + 1, M).astype(np.int32)
        counts[0] = T  # keep one dense machine in the mix
    return queries, samples, h, counts


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _assert_lp_close(got, want, rtol=RTOL, atol=ATOL):
    """allclose over log densities, with −inf (empty machines) in the same places."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


@pytest.mark.parametrize("M,T,d,Q", SHAPES)
@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("weights", ["counts", "uniform"])
def test_machine_ref_matches_reference_ref(M, T, d, Q, ragged, reduce, weights):
    q, s, h, c = _case(M * T + Q, M, T, d, Q, ragged)
    want = jax_machine_ref(_j(q), _j(s), _j(h), _j(c), reduce=reduce, mixture_weights=weights)
    got = machine_kde_log_density_ref(_t(q), _t(s), _t(h), _t(c), reduce=reduce,
                                      mixture_weights=weights)
    via_wrapper = machine_kde_log_density(_t(q), _t(s), _t(h), _t(c), reduce=reduce,
                                          mixture_weights=weights)
    for g, w, v in zip(_as_tuple(got), _as_tuple(want), _as_tuple(via_wrapper)):
        _assert_lp_close(g.numpy(), w)
        assert torch.equal(g, v)  # the CPU wrapper is the plain version


@pytest.mark.parametrize("M,T,d,Q", SHAPES)
@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
def test_machine_ref_matches_reference_pallas_kernel(M, T, d, Q, ragged):
    """Against repro's Pallas kernel (interpret mode): the per-machine matrix
    and both fused epilogues at once (product_mixture, counts weights)."""
    q, s, h, c = _case(M * T + Q + 1, M, T, d, Q, ragged)
    for reduce in ("none", "product_mixture"):
        want = jax_machine_kde(_j(q), _j(s), _j(h), _j(c), reduce=reduce,
                               impl="kernel", interpret=True)
        got = machine_kde_log_density_ref(_t(q), _t(s), _t(h), _t(c), reduce=reduce)
        for g, w in zip(_as_tuple(got), _as_tuple(want)):
            _assert_lp_close(g.numpy(), w)


@pytest.mark.parametrize("reduce", REDUCES)
def test_nan_beyond_counts_and_empty_machine(reduce):
    """NaN in the invalid suffix is inert and an empty machine scores −inf,
    enters the product as −inf and the mixture as no mass — as in repro."""
    q, s, h, c = _case(37, 5, 400, 6, 200, ragged=True)
    c[2] = 0  # empty machine
    poisoned = s.copy()
    for m in range(5):
        poisoned[m, c[m]:] = np.nan
    clean = machine_kde_log_density_ref(_t(q), _t(s), _t(h), _t(c), reduce=reduce)
    dirty = machine_kde_log_density_ref(_t(q), _t(poisoned), _t(h), _t(c), reduce=reduce)
    want = jax_machine_ref(_j(q), _j(poisoned), _j(h), _j(c), reduce=reduce)
    for cl, di, w in zip(_as_tuple(clean), _as_tuple(dirty), _as_tuple(want)):
        assert torch.equal(cl, di)
        _assert_lp_close(di.numpy(), w)
    if reduce == "none":
        assert torch.isneginf(dirty[2]).all()
    if reduce in ("product", "product_mixture"):
        assert torch.isneginf(_as_tuple(dirty)[0]).all()
    if reduce in ("mixture", "product_mixture"):
        assert torch.isfinite(_as_tuple(dirty)[-1]).all()


@pytest.mark.parametrize("nq,ns,d,h", [(300, 700, 7, 0.2), (100, 999, 54, 1.0), (64, 64, 1, 3.0),
                                       (1, 1, 1, 1.0)])
def test_kde_ref_matches_reference_ref(nq, ns, d, h):
    """Single-cloud form: direct distances on both sides, rtol 1e-5, atol 1e-4."""
    rng = np.random.default_rng(nq * ns + d)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    s = rng.standard_normal((ns, d)).astype(np.float32)
    want = np.asarray(jax_kde_ref(_j(q), _j(s), h))
    got = kde_log_density_ref(_t(q), _t(s), h)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert torch.equal(kde_log_density(_t(q), _t(s), h), got)
    # the M = 1 machine form is the same function
    one = machine_kde_log_density_ref(_t(q), _t(s)[None], h)[0]
    np.testing.assert_allclose(one.numpy(), want, rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
def test_masked_silverman_matches_reference(ragged):
    """Per-machine bandwidths agree to float32 rounding (rtol 1e-5)."""
    _, s, _, c = _case(5, 6, 300, 9, 1, ragged)
    counts = np.full(6, 300, np.int32) if c is None else c
    poisoned = s.copy()
    for m in range(6):
        poisoned[m, counts[m]:] = np.nan
    want = np.asarray(jax_masked_silverman(_j(poisoned), _j(counts)))
    got = masked_silverman(_t(poisoned), _t(counts))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_masked_silverman_floor_on_constant_and_single_draw_chains():
    """A constant chain (σ = 0) and single-draw chains hit the 1e-8 floor, as
    in repro, and the constant chain's own location scores finite."""
    rng = np.random.default_rng(0)
    s = rng.standard_normal((3, 50, 4)).astype(np.float32)
    s[1] = 1.5
    counts = np.full(3, 50, np.int32)
    got = masked_silverman(_t(s), _t(counts))
    want = np.asarray(jax_masked_silverman(_j(s), _j(counts)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert float(got[1]) == pytest.approx(1e-8)
    q = np.concatenate([np.full((1, 4), 1.5, np.float32), s[0, :4]])
    logp = machine_kde_logpdfs(_t(q), _t(s), _t(counts), got)
    assert torch.isfinite(logp[1, 0]) and not torch.isnan(logp).any()
    ones = np.ones(3, np.int32)
    h1 = masked_silverman(_t(s), _t(ones))
    np.testing.assert_allclose(h1.numpy(), np.asarray(jax_masked_silverman(_j(s), _j(ones))))
    assert (h1 >= 1e-8).all()
