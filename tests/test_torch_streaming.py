"""The port's streaming combiners: the registry's streaming surface, within the
port and against repro's on the same draws.

Within the port (mirroring ``tests/test_streaming.py``): ``update×k +
finalize`` is bitwise the batch combiner for the buffered combiners and
within merge rounding for ``online``; garbage rows beyond the counts stay
out; ragged appends compact; the cheap estimates select the rows their
finalize would. Across packages, the same numpy stack folded in the same
chunks: buffers equal, pool's estimate rows bitwise (pure indexing),
subpost_average's within 1e-6 (a float32 mean over machines in two
frameworks), the online and parametric moments within the float32 fold
tolerance of ``tests/test_torch_online_update.py``. And the port's
``fused_fold`` against its own subscriber folds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.combiners as jc
from repro_torch.api.streaming import fused_fold
from repro_torch.core.combiners import (
    BufferState,
    EstimateUnavailable,
    buffer_append,
    buffer_init,
    canonical_combiners,
    filter_options,
    get_combiner,
    get_scan_face,
    get_streaming_combiner,
    online_init,
    online_update_chunk,
    streaming_combiners,
    streaming_estimate,
)
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

M, T, D = 4, 120, 3


@pytest.fixture(scope="module")
def cloud_np():
    rng = np.random.default_rng(0)
    return (0.4 * rng.standard_normal((M, T, D)) + rng.standard_normal((M, 1, D))).astype(np.float32)


@pytest.fixture(scope="module")
def cloud(cloud_np):
    return torch.from_numpy(cloud_np)


def _gen(seed=7):
    return torch.Generator().manual_seed(seed)


def _fold(name, samples, chunk=40):
    sc = get_streaming_combiner(name)
    state = sc.init(samples.shape[0], samples.shape[2])
    for t0 in range(0, samples.shape[1], chunk):
        state = sc.update(state, samples[:, t0:t0 + chunk])
    return sc, state


def _stream(name, samples, chunk=40, n_draws=64, **options):
    sc, state = _fold(name, samples, chunk)
    return sc.finalize(_gen(), state, n_draws, **filter_options(sc.finalize, options))


def test_streaming_registry_matches_reference():
    assert streaming_combiners() == jc.streaming_combiners()
    assert {"parametric", "pool", "subpost_average", "nonparametric", "online"} <= set(
        streaming_combiners())
    port_scan = [n for n in canonical_combiners() if get_scan_face(n) is not None]
    ref_scan = [n for n in jc.canonical_combiners() if jc.get_scan_face(n) is not None]
    assert port_scan == ref_scan
    for name in canonical_combiners():
        assert (get_streaming_combiner(name).estimate is None) == (
            jc.get_streaming_combiner(name).estimate is None), name
        assert (get_scan_face(name).estimate is None) == (jc.get_scan_face(name).estimate is None)
    with pytest.raises(KeyError, match="unknown combiner"):
        get_streaming_combiner("no_such_combiner")


@pytest.mark.parametrize(
    "name", ["parametric", "pool", "subpost_average", "nonparametric", "consensus", "weierstrass"])
def test_streaming_updates_then_finalize_is_bitwise_batch(cloud, name):
    """update×k + finalize ≡ the batch combiner on the gathered stack, bitwise
    (consensus and weierstrass take the generic buffered fallback)."""
    fin = _stream(name, cloud, rescale=True, n_batch=1)
    fn = get_combiner(name)
    ref = fn(_gen(), cloud, 64, **filter_options(fn, dict(rescale=True, n_batch=1)))
    assert fin.samples.shape == ref.samples.shape
    assert torch.equal(fin.samples, ref.samples), name


def test_online_streamed_matches_batch_to_merge_rounding(cloud):
    fin = _stream("online", cloud)
    ref = get_combiner("online")(_gen(), cloud, 64)
    torch.testing.assert_close(fin.moments.mean, ref.moments.mean, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(fin.samples, ref.samples, rtol=1e-3, atol=1e-4)


def test_online_chunk_update_masks_garbage_rows(cloud):
    chunk = cloud[:, :40].clone()
    chunk[:, 30:] = float("nan")
    counts = torch.full((M,), 30, dtype=torch.int32)
    state = online_update_chunk(online_init(M, D), chunk, counts)
    ref = online_update_chunk(online_init(M, D), cloud[:, :30])
    assert torch.isfinite(state.mean).all()
    torch.testing.assert_close(state.mean, ref.mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(state.m2, ref.m2, rtol=1e-4, atol=1e-5)


def test_buffer_append_compacts_ragged_chunks(cloud):
    c1, c2 = cloud[:, :40], cloud[:, 40:80]
    cc1 = torch.tensor([40, 30, 40, 20], dtype=torch.int32)
    state = buffer_append(buffer_init(M, D), c1, cc1)
    state = buffer_append(state, c2)
    assert state.counts.tolist() == [80, 70, 80, 60]
    for m, c in enumerate([40, 30, 40, 20]):
        assert torch.equal(state.theta[m, :c + 40], torch.cat([c1[m, :c], c2[m]]))


def test_streaming_finalize_before_update_raises():
    sc = get_streaming_combiner("pool")
    with pytest.raises(ValueError, match="before any update"):
        sc.finalize(_gen(0), sc.init(M, D), 16)


def test_pool_and_subpost_average_estimates_select_finalize_rows(cloud):
    state = buffer_append(buffer_init(M, D), cloud)
    pool = get_streaming_combiner("pool")
    est = pool.estimate(_gen(1), state, 32)
    full = pool.finalize(_gen(1), state, 32).samples  # the whole M·T union
    assert est.samples.shape == (32, D)
    assert torch.equal(est.samples, full[(torch.arange(32) * full.shape[0]) // 32])
    avg = get_streaming_combiner("subpost_average")
    assert torch.equal(avg.estimate(_gen(1), state, 32).samples,
                       avg.finalize(_gen(1), state, 32).samples)


def test_online_streaming_face_has_cheap_estimate(cloud):
    sc = get_streaming_combiner("online")
    assert sc.estimate is not None and get_scan_face("online").estimate is not None
    state = online_update_chunk(online_init(M, D), cloud)
    est = sc.estimate(_gen(2), state, 16)
    assert est.samples.shape == (16, D)
    assert torch.equal(est.samples, sc.finalize(_gen(2), state, 16).samples)


def test_streaming_estimate_resolution_is_typed():
    assert streaming_estimate("parametric") is not None
    for name in ("consensus", "weierstrass", "rpt"):
        with pytest.raises(EstimateUnavailable) as exc:
            streaming_estimate(name)
        assert exc.value.combiner == name
        assert "estimate" in exc.value.reason


# -- across packages: the same stack folded in the same chunks ---------------


def _ref_fold(name, cloud_np, chunk=40):
    sc = jc.get_streaming_combiner(name)
    state = sc.init(M, D)
    for t0 in range(0, T, chunk):
        state = sc.update(state, jnp.asarray(cloud_np[:, t0:t0 + chunk]))
    return sc, state


@pytest.mark.parametrize("chunk", [40, 50])
def test_buffers_and_pool_rows_equal_reference(cloud_np, chunk):
    _, ref = _ref_fold("pool", cloud_np, chunk)
    sc, port = _fold("pool", torch.from_numpy(cloud_np), chunk)
    np.testing.assert_array_equal(port.theta.numpy(), np.asarray(ref.theta))
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref.counts))
    for n in (32, 1000):  # fewer rows than the union, and more (wrapping)
        got = sc.estimate(_gen(), port, n).samples.numpy()
        want = jc.get_streaming_combiner("pool").estimate(jax.random.PRNGKey(0), ref, n).samples
        np.testing.assert_array_equal(got, np.asarray(want))


def test_subpost_average_estimate_matches_reference(cloud_np):
    _, ref = _ref_fold("subpost_average", cloud_np)
    sc, port = _fold("subpost_average", torch.from_numpy(cloud_np))
    for n in (32, 300):
        got = sc.estimate(_gen(), port, n).samples.numpy()
        want = jc.get_streaming_combiner("subpost_average").estimate(
            jax.random.PRNGKey(0), ref, n).samples
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["online", "parametric"])
def test_streamed_moments_match_reference(cloud_np, name):
    _, ref = _ref_fold(name, cloud_np)
    _, port = _fold(name, torch.from_numpy(cloud_np))
    if name == "parametric":
        np.testing.assert_array_equal(port.buffer.theta.numpy(), np.asarray(ref.buffer.theta))
        ref, port = ref.moments, port.moments
    np.testing.assert_array_equal(port.count.numpy(), np.asarray(ref.count))
    np.testing.assert_allclose(port.mean.numpy(), np.asarray(ref.mean), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.m2.numpy(), np.asarray(ref.m2), rtol=1e-4, atol=1e-4)


# -- the port's fused fold against its subscriber folds ----------------------


@pytest.mark.parametrize("name", canonical_combiners())
@pytest.mark.parametrize("chunk", [40, 50])
def test_fused_fold_state_matches_subscriber_folds(cloud, name, chunk):
    """Bitwise for the buffered faces (the fold carries the draws); online's
    and parametric's moments to merge rounding (online folds through the
    kernel wrapper, the plain version here; chunk 50 leaves a ragged tail)."""
    face = get_scan_face(name)
    ff = fused_fold(cloud, {name: face}, {}, 16, chunk, {})
    assert ff.boundaries == tuple(range(chunk, T, chunk)) + (T,)
    fused = face.to_state(ff.states[name], cloud, torch.full((M,), T, dtype=torch.int32))
    _, host = _fold(name, cloud, chunk)
    if name == "online":
        for a, b in zip(fused, host):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    elif name == "parametric":
        assert torch.equal(fused.buffer.theta, host.buffer.theta)
        for a, b in zip(fused.moments, host.moments):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    else:
        assert isinstance(fused, BufferState)
        assert torch.equal(fused.theta, host.theta) and torch.equal(fused.counts, host.counts)


def test_fused_fold_estimates_follow_their_generators(cloud):
    """The fold's in-loop estimates are the host estimate's draws at each
    boundary, from that boundary's generator."""
    face = get_scan_face("online")
    gens = [torch.Generator().manual_seed(100 + i) for i in range(3)]
    ff = fused_fold(cloud, {"online": face}, {"online": gens}, 8, 40, {"jitter": 1e-8})
    assert ff.est_draws["online"].shape == (3, 8, D) and ff.ready == (None, None, None)
    sc = get_streaming_combiner("online")
    state = online_init(M, D)
    for i, t0 in enumerate(range(0, T, 40)):
        state = sc.update(state, cloud[:, t0:t0 + 40])
        want = sc.estimate(torch.Generator().manual_seed(100 + i), state, 8).samples
        torch.testing.assert_close(ff.est_draws["online"][i], want, rtol=1e-5, atol=1e-5)
