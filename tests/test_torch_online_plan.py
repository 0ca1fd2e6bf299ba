"""The online_update kernel's launch plan, and its plain version at the slab
route's shapes against repro's.

``ops._plan`` picks the kernel's route (``whole``: a machine's C rows copied
into shared memory at once; ``slab``: streamed through a ring) and the
block's shared memory before the launch. The CUDA source derives the same
bytes itself (``online_update_smem_bytes``, held equal to ``ops.smem_bytes``
on the card) and refuses a whole route past its budget. The kernel itself
runs only on the card (``tests/test_torch_cuda.py``).

The plain version, ``online_moments_update_ref``, is held to ``repro``'s
``online_moments_update_ref`` and to its Pallas kernel in interpret mode at
the two slab shapes of the stream path (the whole draw buffer as one chunk,
C = 1,200 at d = 50; d = 300 at C = 120), all in float32 on the same numpy
inputs: count exact, mean within rtol 1e-5 / atol 1e-5, m2 within rtol 1e-4
/ atol 1e-4 (``tests/test_torch_online_update.py``'s figures: the same
arithmetic in two frameworks, the Pallas kernel in another order); and to
two-pass float64 numpy moments within rtol 1e-5 of max|m2| (float32 rounding
of sums of 1,200 terms).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.online_update import online_moments_update as jax_update
from repro.kernels.online_update import online_moments_update_ref as jax_update_ref
from repro_torch import kernels
from repro_torch.kernels.online_update import online_moments_update, online_moments_update_ref, ops
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

# (M, C, d) -> (route, blocks a machine, bytes of shared memory a block)
PLANS = {
    "path fold": ((10, 120, 50), ("whole", 10, 36_112)),
    "slab: the draw buffer as one chunk": ((10, 1200, 50), ("slab", 10, 77_568)),
    "slab: d=300": ((10, 120, 300), ("slab", 190, 77_568)),
    "unaligned: d=37": ((10, 120, 37), ("whole", 6, 29_872)),
    "C=0": ((4, 0, 50), ("whole", 10, 12_112)),
    "C=1": ((3, 1, 50), ("whole", 10, 12_320)),
    "M=d=1": ((1, 7, 1), ("whole", 1, 12_144)),
    "C=31 d=65": ((4, 31, 65), ("whole", 15, 20_176)),
}


@pytest.mark.parametrize("label", list(PLANS))
def test_plan_route_blocks_and_shared_memory(label):
    shape, (route, blocks, smem) = PLANS[label]
    plan = ops._plan(*shape)
    assert plan == ops.Plan(route, blocks, smem)
    assert smem == ops.smem_bytes(route, *shape[1:])
    assert smem <= (ops.WHOLE_BUDGET if route == "whole" else 227 * 1024)


def test_plan_budget_edge_and_slab_bytes_fixed():
    """At d = 50 the whole route holds 430 rows in 96 KiB with the rest of a
    block's state, and 431 go to the slab route, whose bytes depend on
    neither C nor d."""
    assert ops._plan(10, 430, 50).route == "whole"
    assert ops.smem_bytes("whole", 430, 50) <= ops.WHOLE_BUDGET < ops.smem_bytes("whole", 431, 50)
    assert ops._plan(10, 431, 50).route == "slab"
    assert {ops.smem_bytes("slab", C, d) for C, d in ((431, 50), (5, 4000), (1200, 1))} == {77_568}


def test_plan_is_by_rows_not_counts():
    """Chunk counts above C read C rows (n_b = the count): the plan is the one
    for C rows, and on the CPU the fold is the plain version's."""
    rng = np.random.default_rng(7)
    count = torch.full((2,), 37.0)
    mean = torch.from_numpy(rng.standard_normal((2, 9)).astype(np.float32))
    m2 = torch.eye(9).repeat(2, 1, 1)
    chunk = torch.from_numpy(rng.standard_normal((2, 20, 9)).astype(np.float32))
    counts = torch.tensor([25, 20], dtype=torch.int32)
    assert ops._plan(2, 20, 9) == ops.Plan("whole", 1, ops.smem_bytes("whole", 20, 9))
    got = online_moments_update(count, mean, m2, chunk, counts)
    want = online_moments_update_ref(count, mean, m2, chunk, counts)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert float(got[0][0]) == 37.0 + 25.0
    assert kernels.KERNELS["online_update"].route_launches == {"whole": 0, "slab": 0}


def _inputs(M, C, d, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, 2 * d, d)).astype(np.float32)
    state = (np.full(M, 240.0, np.float32), rng.standard_normal((M, d)).astype(np.float32),
             np.einsum("mci,mcj->mij", a, a).astype(np.float32))
    chunk = (state[1][:, None, :] + 0.3 + rng.standard_normal((M, C, d))).astype(np.float32)
    return state, chunk


def _assert_close(got, want):
    c, mu, m2 = (np.asarray(x) for x in got)
    cw, muw, m2w = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(c, cw)
    np.testing.assert_allclose(mu, muw, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m2, m2w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("M,C,d", [(2, 1200, 50), (2, 120, 300)])
def test_plain_version_matches_repro_at_the_slab_shapes(M, C, d):
    state, chunk = _inputs(M, C, d, seed=C + d)
    port = online_moments_update_ref(*(torch.from_numpy(a) for a in (*state, chunk)))
    jstate = tuple(jnp.asarray(a) for a in state)
    _assert_close(port, jax_update_ref(*jstate, jnp.asarray(chunk)))
    _assert_close(port, jax_update(*jstate, jnp.asarray(chunk), interpret=True))
    # two-pass float64 moments of the chunk, merged by Chan's rule
    x = chunk.astype(np.float64)
    mu_b = x.mean(axis=1)
    cent = x - mu_b[:, None, :]
    n_a, mean0, m2_0 = (np.asarray(a, np.float64) for a in state)
    delta = mu_b - mean0
    coef = (n_a * C / (n_a + C))[:, None, None]
    m2 = m2_0 + np.einsum("mci,mcj->mij", cent, cent) + np.einsum("mi,mj->mij", delta, delta) * coef
    np.testing.assert_allclose(port[1].numpy(), mean0 + delta * (C / (n_a + C))[:, None],
                               rtol=1e-5, atol=1e-5)
    scale = np.abs(m2).max(axis=(1, 2), keepdims=True)
    assert float((np.abs(port[2].numpy() - m2) / scale).max()) <= 1e-5
