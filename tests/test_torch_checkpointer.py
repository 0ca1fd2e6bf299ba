"""repro_torch.checkpoint's async writer and elastic restore, and the cached
chunk backends, held to repro's.

``Checkpointer(async_io=True)`` takes its host copy before the write is
submitted (a later change to the caller's tensors does not reach the file)
and overlaps the write with the caller; ``restore_elastic_chains`` gives
exactly ``repro``'s arrays on a checkpoint that ``repro`` wrote, shrinking
and growing (tiled ``key`` leaves bumped as in the reference), and a
checkpoint the port writes restores in ``repro``. ``get_chunk_backend``
returns one cached backend per configuration, loads each call's data into
it (the same draws as a fresh backend on that data) and builds a mesh only
on devices it is given.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as rck
from repro_torch.api import backends as backends_module
from repro_torch.api.backends import BatchedChunkBackend, get_chunk_backend
from repro_torch.api.sampling import make_shard_kernel
from repro_torch.checkpoint import (
    Checkpointer,
    latest_step,
    restore,
    restore_elastic_chains,
    save,
)
from repro_torch.checkpoint import checkpointer as ck_module
from repro_torch.core.subposterior import partition_data
from repro_torch.models.bayes import get_model
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run


def _tree_np():
    return {
        "params": {"w": np.arange(24.0, dtype=np.float32).reshape(4, 6),
                   "b": np.ones((4,), np.float32)},
        "key": np.arange(8, dtype=np.uint32).reshape(4, 2),
        "step": np.asarray(7, np.int32),
    }


def _tree_torch():
    return {k: ({kk: torch.from_numpy(vv.copy()) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.from_numpy(np.array(v)))
            for k, v in _tree_np().items()}


def _flat(tree, prefix=""):
    """``{path: numpy}`` of a nested dict tree, paths as the checkpoints'."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_async_checkpointer_overlaps_and_restores(tmp_path, monkeypatch):
    """Three async saves of a changing tree: each write runs on the worker
    while the caller goes on (it changes its tensors at once), and each
    restores to the values at its save."""
    started, release = threading.Event(), threading.Event()
    real_save = ck_module.save

    def slow_save(*args, **kwargs):
        started.set()
        release.wait(timeout=30)
        return real_save(*args, **kwargs)

    monkeypatch.setattr(ck_module, "save", slow_save)
    tree = _tree_torch()
    ck = Checkpointer(tmp_path, keep=5)
    t0 = time.perf_counter()
    ck.save(0, tree, metadata={"num_chains": 4})
    assert started.wait(timeout=30) and time.perf_counter() - t0 < 10
    tree["params"]["b"].add_(100.0)  # the caller mutates while the write waits
    assert latest_step(tmp_path) is None  # nothing committed yet: the write overlaps
    release.set()
    for s in (1, 2):
        ck.save(s, {**tree, "params": {**tree["params"], "b": tree["params"]["b"] + s}})
    ck.close()
    got0, meta = restore(tmp_path, step=0)
    np.testing.assert_array_equal(got0["params/b"], np.ones(4, np.float32))
    assert meta == {"num_chains": 4}
    got2, _ = restore(tmp_path, step=2)
    np.testing.assert_array_equal(got2["params/b"], np.full(4, 103.0, np.float32))
    np.testing.assert_array_equal(got2["key"], _tree_np()["key"])


def test_sync_checkpointer_writes_at_once(tmp_path):
    ck = Checkpointer(tmp_path, async_io=False)
    ck.save(3, _tree_torch(), metadata={"num_chains": 4})
    assert latest_step(tmp_path) == 3
    ck.close()


@pytest.mark.parametrize("new_chains", [2, 4, 8, 9])
def test_elastic_restore_of_a_reference_checkpoint_matches_reference(tmp_path, new_chains):
    """A checkpoint written by repro's save, restored onto ``new_chains``
    chains by both packages: the same arrays (bumped keys included) and the
    same metadata."""
    ref_tree = jax.tree.map(jnp.asarray, _tree_np())
    rck.save(tmp_path, 1, ref_tree, metadata={"num_chains": 4})

    def resize(x):
        x = np.asarray(x)
        if x.ndim and x.shape[0] == 4:
            return np.take(x, np.arange(new_chains) % 4, axis=0)
        return x

    want, want_meta = rck.restore_elastic_chains(
        tmp_path, jax.tree.map(lambda x: jnp.asarray(resize(x)), ref_tree), new_chains)
    template = {k: ({kk: torch.from_numpy(resize(vv)) for kk, vv in v.items()}
                    if isinstance(v, dict) else torch.from_numpy(resize(v)))
                for k, v in _tree_np().items()}
    got, got_meta = restore_elastic_chains(tmp_path, template, new_chains)
    g, w = _flat(got), _flat(jax.tree.map(np.asarray, want))
    assert sorted(g) == sorted(w)
    for path in w:
        assert g[path].dtype == w[path].dtype, path
        np.testing.assert_array_equal(g[path], w[path], err_msg=path)
    assert got_meta == want_meta
    assert isinstance(got["params"]["w"], torch.Tensor)
    if new_chains > 4:  # tiled RNG keys were bumped so streams de-duplicate
        assert not np.array_equal(g["key"][4], g["key"][0])


def test_port_checkpoint_restores_in_reference(tmp_path):
    tree = _tree_torch()
    save(tmp_path, 5, tree, metadata={"num_chains": 4, "t_done": 120})
    by_path, meta = rck.restore(tmp_path)
    assert meta == {"num_chains": 4, "t_done": 120}
    want = _flat({k: ({kk: vv.numpy() for kk, vv in v.items()} if isinstance(v, dict)
                      else v.numpy()) for k, v in tree.items()})
    assert sorted(by_path) == sorted(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(by_path[path], arr, err_msg=path)
    grown, _ = rck.restore_elastic_chains(
        tmp_path, jax.tree.map(jnp.asarray, _tree_np()), 6)
    assert np.asarray(grown["params"]["w"]).shape == (6, 6)


def test_elastic_restore_needs_num_chains(tmp_path):
    save(tmp_path, 1, _tree_torch())
    with pytest.raises(ValueError, match="num_chains"):
        restore_elastic_chains(tmp_path, _tree_torch(), 2)


def _linear_inputs(seed, M=4, n=400):
    model = get_model("linear")
    data, _ = model.generate_data(torch.Generator().manual_seed(seed), n)
    shards, counts = partition_data(data, M, only=model.shard_keys, pad=True)
    return model, shards, counts


def test_get_chunk_backend_is_cached_and_loads_each_calls_data(monkeypatch):
    monkeypatch.setattr(backends_module, "_BACKEND_CACHE", {})
    model, shards, counts = _linear_inputs(0)
    kw = dict(warmup=20, burn_in=5, step_size=0.1)
    first = get_chunk_backend(model, 4, "mala", shards=shards, counts=counts, **kw)
    theta0, _ = first.run_fused(torch.Generator().manual_seed(1), 15)
    _, shards1, counts1 = _linear_inputs(1)
    again = get_chunk_backend(model, 4, "mala", shards=shards1, counts=counts1, **kw)
    assert again is first
    theta1, acc1 = again.run_fused(torch.Generator().manual_seed(1), 15)
    fresh = BatchedChunkBackend(make_shard_kernel(model, 4, "mala", use_counts=True),
                                shards1, counts1, burn_in=5, warmup=20, step_size=0.1)
    want1, want_acc = fresh.run_fused(torch.Generator().manual_seed(1), 15)
    assert torch.equal(theta1, want1) and torch.equal(acc1, want_acc)
    assert not torch.equal(theta0, theta1)
    assert get_chunk_backend(model, 4, "mala", shards=shards, counts=counts,
                             **dict(kw, step_size=0.2)) is not first
    assert len(backends_module._BACKEND_CACHE) == 2


def test_get_chunk_backend_raises_on_a_mesh():
    """A mesh needs its devices: none is inferred on the CPU, and an explicit
    list gives the mesh backend."""
    from repro_torch.api.backends import MeshChunkBackend

    model, shards, counts = _linear_inputs(0)
    with pytest.raises(ValueError, match="needs 4 devices"):
        get_chunk_backend(model, 4, "mala", shards=shards, counts=counts, mesh_shape=(4, 1))
    assert isinstance(get_chunk_backend(model, 4, "mala", shards=shards, counts=counts,
                                        mesh_shape=(4, 1), devices=("cpu",) * 4),
                      MeshChunkBackend)
    # a data axis of 1 is the one-device backend
    assert isinstance(get_chunk_backend(model, 4, "mala", shards=shards, counts=counts,
                                        mesh_shape=(1, 2)), BatchedChunkBackend)


def test_batched_backend_satisfies_the_chunk_backend_protocol():
    from repro_torch.api.backends import ChunkBackend

    for name in ("backend_id", "setup", "next_chunk", "localize", "run_fused"):
        assert callable(getattr(BatchedChunkBackend, name)), name
        assert hasattr(ChunkBackend, name), name
    assert BatchedChunkBackend.kind == "batched"
