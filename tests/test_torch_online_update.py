"""The port's online_update wrapper against repro's, on the same arrays.

On the CPU the port's ``online_moments_update`` takes its plain version; it is
held against ``repro``'s wrapper (its Pallas kernel in interpret mode, or its
jnp reference where that wrapper sends chunks with C < 32) and against
``repro``'s ``online_moments_update_ref``, all in float32 on the same numpy
inputs, and against two-pass float64 numpy moments of the whole stream.

Tolerances: the same arithmetic in two frameworks and (for the Pallas kernel)
in another association order, in float32: count exact, mean within
rtol 1e-5 / atol 1e-5, m2 within rtol 1e-4 / atol 1e-4 (the reference tests'
figures, ``tests/test_fused_stream.py``). Against the float64 two-pass moments
of the stream, whose sums the Chan merge reassociates: mean rtol 1e-4 /
atol 1e-5, m2 rtol 1e-3 / atol 1e-3, as there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.online_update import online_moments_update as jax_update
from repro.kernels.online_update import online_moments_update_ref as jax_update_ref
from repro_torch import kernels
from repro_torch.kernels.online_update import online_moments_update, online_moments_update_ref
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

MEAN_TOL = dict(rtol=1e-5, atol=1e-5)
M2_TOL = dict(rtol=1e-4, atol=1e-4)


def _state(M, d, rng=None):
    if rng is None:
        return (np.zeros(M, np.float32), np.zeros((M, d), np.float32),
                np.zeros((M, d, d), np.float32))
    a = rng.standard_normal((M, 2 * d, d)).astype(np.float32)
    return (np.full(M, 37.0, np.float32), rng.standard_normal((M, d)).astype(np.float32),
            np.einsum("mci,mcj->mij", a, a).astype(np.float32))


def _torch(*arrays):
    return tuple(None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays)


def _assert_states_close(got, want):
    c, mu, m2 = (np.asarray(x) for x in got)
    cw, muw, m2w = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(c, cw)
    np.testing.assert_allclose(mu, muw, **MEAN_TOL)
    np.testing.assert_allclose(m2, m2w, **M2_TOL)


def _both(state, chunk, counts=None):
    """One fold through the port (plain, on CPU tensors) and through repro's
    wrapper in interpret mode and its reference."""
    port = online_moments_update(*_torch(*state, chunk, counts))
    jstate = tuple(jnp.asarray(a) for a in state)
    jcounts = None if counts is None else jnp.asarray(counts)
    kern = jax_update(*jstate, jnp.asarray(chunk), jcounts, interpret=True)
    ref = jax_update_ref(*jstate, jnp.asarray(chunk), jcounts)
    return port, kern, ref


@pytest.mark.parametrize("M,C,d,seeded", [(3, 40, 5, False), (3, 40, 5, True), (2, 48, 130, True),
                                          (4, 8, 6, True), (1, 33, 3, True), (5, 64, 1, False)])
def test_fold_matches_reference_wrapper_and_ref(M, C, d, seeded):
    """Dense folds; C = 8 goes through repro's ref (its C < 32 fallback), the
    rest through its Pallas kernel in interpret mode."""
    rng = np.random.default_rng(M * 1000 + C + d)
    state = _state(M, d, rng if seeded else None)
    chunk = (2.0 + rng.standard_normal((M, C, d))).astype(np.float32)
    port, kern, ref = _both(state, chunk)
    _assert_states_close(port, kern)
    _assert_states_close(port, ref)
    assert kernels.KERNELS["online_update"].launches == 0  # CPU tensors: the plain version


def test_two_successive_folds_match_and_equal_two_pass_moments():
    rng = np.random.default_rng(3)
    m, c, d = 3, 40, 5
    a = rng.standard_normal((m, c, d)).astype(np.float32)
    b = (2.0 + 0.5 * rng.standard_normal((m, c, d))).astype(np.float32)
    port = online_moments_update(*_torch(*_state(m, d), a))
    port = online_moments_update(*port, torch.from_numpy(b))
    jst = tuple(jnp.asarray(x) for x in _state(m, d))
    kern = jax_update(*jax_update(*jst, jnp.asarray(a), interpret=True), jnp.asarray(b),
                      interpret=True)
    ref = jax_update_ref(*jax_update_ref(*jst, jnp.asarray(a)), jnp.asarray(b))
    _assert_states_close(port, kern)
    _assert_states_close(port, ref)
    for i in range(m):
        full = np.concatenate([a[i], b[i]]).astype(np.float64)
        mu = full.mean(axis=0)
        cent = full - mu
        assert float(port[0][i]) == full.shape[0]
        np.testing.assert_allclose(port[1][i].numpy(), mu, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(port[2][i].numpy(), cent.T @ cent, rtol=1e-3, atol=1e-3)


def test_ragged_fold_masks_nan_rows_and_keeps_an_empty_machine():
    """Rows past each count hold NaN and must not reach the moments; the
    count-0 machine comes back bitwise unchanged (C = 48 takes repro's Pallas
    kernel, which is fed zeros there, as its own test does)."""
    rng = np.random.default_rng(4)
    m, c, d = 3, 48, 4
    state = _state(m, d, rng)
    x = rng.standard_normal((m, c, d)).astype(np.float32)
    counts = np.asarray([48, 17, 0], np.int32)
    mask = np.arange(c)[None, :, None] < counts[:, None, None]
    port, kern, ref = _both(state, np.where(mask, x, 0.0).astype(np.float32), counts)
    port_nan = online_moments_update(*_torch(*state, np.where(mask, x, np.nan), counts))
    for a, b in zip(port_nan, port):
        assert torch.equal(a, b)
    assert all(torch.isfinite(t).all() for t in port_nan)
    _assert_states_close(port_nan, kern)
    _assert_states_close(port_nan, ref)
    for got, before in zip(port_nan, _torch(*state)):
        assert torch.equal(got[2], before[2])


def test_plain_version_is_the_reference_ref_in_torch():
    """The port's ref.py against repro's ref.py, with one count beyond C
    (rows stop at C, the divisor is the count as given) and partial chunks,
    in float32 and, for the port, float64."""
    rng = np.random.default_rng(5)
    m, c, d = 4, 12, 7
    state = _state(m, d, rng)
    chunk = rng.standard_normal((m, c, d)).astype(np.float32)
    counts = np.asarray([12, 15, 1, 6], np.int32)
    port = online_moments_update_ref(*_torch(*state, chunk, counts))
    ref = jax_update_ref(*(jnp.asarray(a) for a in state), jnp.asarray(chunk), jnp.asarray(counts))
    _assert_states_close(port, ref)
    port64 = online_moments_update_ref(*(t.double() for t in _torch(*state, chunk)),
                                       torch.from_numpy(counts))
    assert all(t.dtype == torch.float64 for t in port64)
    _assert_states_close(port64, ref)
