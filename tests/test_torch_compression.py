"""The port's gradient compression and batch specs on the CPU against ``repro``.

``repro_torch.optim.compression`` against ``repro/optim/compression.py``:
the counterparts of ``tests/test_compression_elastic.py``'s three
compression tests (rank-exact recovery, error feedback keeping the signal
over steps, the bytes ratio) with the port's generator, then parity given
JAX's own projection Q₀ (``jax.random.normal`` of the reference's key, fed
through ``q0=``): the approximation P Qᵀ and the residual within 1e-5 of
the reference's in float32 (one subspace iteration and a QR in float32
over at most 256 × 64 entries, other summation orders), P and Q up to
their columns' signs (another QR may flip a column and its Q partner).
bf16 leaves: within one bf16 rounding (2^-8 relative) of the reference's,
where a flipped rounding of the approximation moves the residual by one
ulp of the gradient. ``repro_torch.data.make_batch_specs`` against
``repro.data.tokens.make_batch_specs`` for the ten configs: keys, shapes and
dtype names equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.data.tokens import make_batch_specs as ref_make_batch_specs
from repro.optim import compression as ref
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import make_batch_specs
from repro_torch.optim import (
    LowRankPair,
    compress_lowrank,
    decompress_lowrank,
    error_feedback_update,
    init_error_feedback,
)
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(_f32(a))).to(dtype)


# ------------------------------------------------- the reference's tests, ported


def test_lowrank_exact_on_lowrank_matrix():
    rng = np.random.default_rng(0)
    g = torch.from_numpy((rng.standard_normal((40, 6)) @ rng.standard_normal((6, 30)))
                         .astype(np.float32))  # exactly rank 6
    pair, resid = compress_lowrank(_gen(2), g, rank=6)
    torch.testing.assert_close(decompress_lowrank(pair, g.shape), g, rtol=1e-3, atol=1e-3)
    assert float(resid.abs().max()) < 1e-3
    assert isinstance(pair, LowRankPair) and pair.p.shape == (40, 6) and pair.q.shape == (30, 6)
    torch.testing.assert_close(pair.p.T @ pair.p, torch.eye(6), rtol=1e-5, atol=1e-5)


def test_error_feedback_preserves_signal_over_steps():
    """The accumulated sent signal tracks Σ_t g_t far better with error
    feedback than compress-and-forget; the vector passes through."""
    rng = np.random.default_rng(1)
    g = {"w": torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32)),
         "b": torch.ones((64,))}
    steps = 12

    def run(with_ef: bool):
        gen = _gen(3)
        err = init_error_feedback(g)
        total = {k: torch.zeros_like(v) for k, v in g.items()}
        for _ in range(steps):
            sent, new_err = error_feedback_update(gen, g, err, rank=4)
            if with_ef:
                err = new_err
            total = {k: total[k] + sent[k] for k in total}
        rel = float(torch.linalg.norm(total["w"] - steps * g["w"])
                    / torch.linalg.norm(steps * g["w"]))
        return rel, total

    rel_ef, total_ef = run(True)
    rel_nef, _ = run(False)
    assert rel_ef < 0.75 * rel_nef, (rel_ef, rel_nef)
    assert rel_ef < 0.9
    torch.testing.assert_close(total_ef["b"], steps * g["b"], rtol=1e-5, atol=0)


def test_compression_ratio():
    g = torch.ones((256, 512))
    pair, _ = compress_lowrank(_gen(0), g, rank=8)
    moved = pair.p.numel() + pair.q.numel()
    assert moved == 8 * (256 + 512) and moved < 0.06 * g.numel()


# ----------------------------------------------------- parity given JAX's draw


def _same_up_to_signs(got: torch.Tensor, want, tol):
    """Columns equal up to each column's sign."""
    want = _f32(want)
    signs = np.sign((got.numpy() * want).sum(axis=0))
    np.testing.assert_allclose(got.numpy() * signs, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,rank", [((64, 48), 8), ((256, 64), 4), ((3, 20, 24), 5)],
                         ids=["matrix", "tall", "three axes"])
def test_compress_lowrank_matches_the_reference_given_its_projection(shape, rank):
    key = jax.random.PRNGKey(7)
    g = jax.random.normal(jax.random.fold_in(key, 1), shape)
    want_pair, want_resid = ref.compress_lowrank(key, g, rank)
    q0 = jax.random.normal(key, (shape[-1], rank), jnp.float32)  # the reference's own draw
    pair, resid = compress_lowrank(None, _t(g), rank, q0=_t(q0))
    np.testing.assert_allclose(resid.numpy(), _f32(want_resid), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(decompress_lowrank(pair, shape).numpy(),
                               _f32(ref.decompress_lowrank(want_pair, shape)), rtol=1e-5,
                               atol=1e-5)
    _same_up_to_signs(pair.p, want_pair.p, 1e-5)
    _same_up_to_signs(pair.q, want_pair.q, 1e-4)


def test_error_feedback_update_matches_the_reference_given_its_projections():
    """A tree of every kind of leaf: float32 and bf16 matrices, a stacked
    (L, n, m) leaf, a matrix too thin to compress (min(n, m) = rank), a
    vector and a scalar; error buffers float32 and nonzero. Outputs in each
    gradient's dtype, errors in the buffers', passthrough leaves exact and
    their errors zero."""
    key = jax.random.PRNGKey(11)
    rank = 6
    ks = jax.random.split(jax.random.fold_in(key, 99), 12)
    grads = {
        "a_w": jax.random.normal(ks[0], (48, 40)),
        "b_bf16": jax.random.normal(ks[1], (32, 64)).astype(jnp.bfloat16),
        "c_stacked": jax.random.normal(ks[2], (2, 24, 16)),
        "d_thin": jax.random.normal(ks[3], (rank, 30)),
        "e_vec": jax.random.normal(ks[4], (40,)),
        "f_scalar": jnp.asarray(1.5),
    }
    error = {k: 0.1 * jax.random.normal(ks[6 + i], v.shape, jnp.float32)
             for i, (k, v) in enumerate(grads.items())}
    want_out, want_err = ref.error_feedback_update(key, grads, error, rank=rank)
    leaves, _ = jax.tree.flatten(grads)  # the reference's leaf order: sorted names
    keys = jax.random.split(key, len(leaves))
    names = sorted(grads)
    q0 = {n: _t(jax.random.normal(k, (grads[n].shape[-1], rank), jnp.float32))
          for n, k in zip(names, keys) if grads[n].ndim >= 2}
    port_grads = {n: _t(v, torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
                  for n, v in grads.items()}
    out, new_err = error_feedback_update(None, port_grads, {n: _t(e) for n, e in error.items()},
                                         rank=rank, q0=q0)
    assert list(out) == list(grads) and list(new_err) == list(grads)
    for n in grads:
        assert out[n].dtype == port_grads[n].dtype and new_err[n].dtype == torch.float32
        tol = 2 ** -8 if n == "b_bf16" else 1e-5
        scale = float(np.abs(_f32(want_out[n])).max())
        np.testing.assert_allclose(out[n].float().numpy(), _f32(want_out[n]), rtol=tol,
                                   atol=tol * scale, err_msg=n)
        np.testing.assert_allclose(new_err[n].numpy(), _f32(want_err[n]), rtol=tol,
                                   atol=tol * scale, err_msg=n)
    for n in ("d_thin", "e_vec", "f_scalar"):
        assert torch.equal(out[n], port_grads[n]) and not bool(new_err[n].any())
    init = init_error_feedback(port_grads)
    ref_init = ref.init_error_feedback(grads)
    for n, e in init.items():
        assert e.dtype == torch.float32 and tuple(e.shape) == ref_init[n].shape
        assert not bool(e.any())


def test_the_generator_draws_the_projection():
    """Without ``q0`` the projection is drawn from the generator on its
    device: the same seed, the same numbers; a call with neither raises."""
    g = torch.from_numpy(np.random.default_rng(4).standard_normal((30, 20)).astype(np.float32))
    a, ra = compress_lowrank(_gen(5), g, 4)
    b, rb = compress_lowrank(_gen(5), g, 4)
    assert torch.equal(a.p, b.p) and torch.equal(ra, rb)
    q0 = torch.randn((20, 4), generator=_gen(5))
    c, rc = compress_lowrank(None, g, 4, q0=q0)
    assert torch.equal(c.q, a.q) and torch.equal(rc, ra)
    with pytest.raises(ValueError, match="generator or q0"):
        compress_lowrank(None, g, 4)


# ------------------------------------------------------------ make_batch_specs


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_batch_specs_matches_the_reference(arch):
    assert ARCH_IDS == REF_ARCH_IDS
    want = ref_make_batch_specs(ref_get_config(arch), 2, 64)
    got = make_batch_specs(get_config(arch), 2, 64)
    assert list(got) == list(want)
    for k, spec in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert str(got[k].dtype).split(".")[-1] == jnp.dtype(spec.dtype).name, k
