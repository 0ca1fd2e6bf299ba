"""The port's public surface against ``repro``'s: the ``api`` package's names
and ``predictive_accuracy``.

``repro.api.__all__`` is held name by name: each is exported by
``repro_torch.api`` but the two ``NOT_PORTED`` (``make_shard_sampler``,
``VmapChunkBackend``: the port batches the chains, its counterparts are
``make_shard_kernel`` with ``run_shard_chain`` and ``BatchedChunkBackend``).
``predictive_accuracy`` is held to the reference's on the same draws and
data, made with numpy from a seed, within one prediction of n (1/n): the
two can differ only where a mean probability lies within float32 rounding
of 0.5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro_torch.api as api
from repro.models.bayes.logistic_regression import predictive_accuracy as ref_predictive_accuracy
from repro_torch.api import backends, sampling
from repro_torch.models.bayes.logistic_regression import predictive_accuracy
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run


@pytest.mark.parametrize("name", sorted(ref_api.__all__))
def test_every_reference_api_name_is_exported_or_recorded(name):
    if name in api.NOT_PORTED:
        assert not hasattr(api, name)
    else:
        assert getattr(api, name) is not None


@pytest.mark.parametrize("name", ["SampleResult", "ShardKernel", "groundtruth_chain",
                                  "make_shard_kernel", "run_shard_chain", "sample_subposteriors"])
def test_reexports_are_the_sampling_modules(name):
    assert getattr(api, name) is getattr(sampling, name)


def test_chunk_backend_is_the_protocol_the_batched_backend_follows():
    assert api.ChunkBackend is backends.ChunkBackend
    for method in ("backend_id", "setup", "next_chunk", "localize", "put_carry", "run_fused"):
        assert callable(getattr(backends.BatchedChunkBackend, method)), method


@pytest.mark.parametrize("n,chunk", [(2_000, 1024), (1_000, 1_000), (37, 8)])
def test_predictive_accuracy_matches_reference(n, chunk):
    rng = np.random.default_rng(n)
    d, s = 6, 40
    beta = rng.standard_normal(d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-x @ beta))).astype(np.float32)
    betas = (beta + 0.3 * rng.standard_normal((s, d))).astype(np.float32)
    want = float(ref_predictive_accuracy(jnp.asarray(betas), jnp.asarray(x), jnp.asarray(y),
                                         chunk=chunk))
    got = predictive_accuracy(torch.from_numpy(betas), torch.from_numpy(x), torch.from_numpy(y),
                              chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1.0 / n and 0.5 < want < 1.0
