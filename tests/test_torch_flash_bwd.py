"""The port's flash-attention backward and the forward's lse on the CPU against ``repro``.

The port's plain versions (``repro_torch.kernels.flash_attention.ref``, what
the wrappers run for a CPU tensor): ``flash_attention_bwd_ref`` from the
saved ``out`` and ``lse`` against ``jax.vjp`` of the reference's pure-JAX
flash (``repro.models.lm.flash.flash_attention``, whose backward is
``_flash_bwd``), and the plain lse against ``_flash_fwd_impl``'s, at the
shapes of ``tests/test_flash.py``: hd 16 and 24 with hd_v 16, causal and
not, S of 64, 100 and 33 against chunks of 16 and 32 (S not a multiple of
the chunk), T ≠ S. Then the model's ``torch.autograd.Function`` against
``jax.grad`` of the same loss as that file's backward test, the rows with
nothing visible (``kv_len = 0``: lse +inf and exactly zero gradients), the
bf16 cast points, and the wrapper's CPU dispatch and shape checks. Inputs
are drawn with numpy from a seed and handed to both packages. Tolerances,
float32: 3e-4 on gradients (the reference test's own figure for two
float32 attention gradients summed in other orders), 2e-4 on lse of size
~5 (float32 sums of ≤ 100 exponentials). The hand-written CUDA kernel is
held to these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm.flash import _flash_fwd_impl
from repro.models.lm.flash import flash_attention as ref_flash
from repro_torch.kernels import KERNELS
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from repro_torch.models.lm.flash import flash_attention as model_flash
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

B, KH, G = 2, 2, 3


def _inputs(b, s, t, kh, g, hd, hd_v, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, kh, g, hd)).astype(dtype)
    k = rng.standard_normal((b, t, kh, hd)).astype(dtype)
    v = rng.standard_normal((b, t, kh, hd_v)).astype(dtype)
    dout = rng.standard_normal((b, s, kh, g, hd_v)).astype(dtype)
    return q, k, v, dout


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _port_grads(q, k, v, dout, causal):
    qt, kt, vt, dt = _t(q, k, v, dout)
    out, lse = flash_attention(qt, kt, vt, causal=causal, return_lse=True)
    return flash_attention_bwd(qt, kt, vt, out, lse, dt, causal=causal)


def _ref_grads(q, k, v, dout, causal, chunk):
    _, vjp = jax.vjp(lambda a, b_, c: ref_flash(a, b_, c, causal, chunk, chunk),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("s,chunk", [(64, 16), (100, 32), (33, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd,hd_v", [(16, 16), (24, 16)])
def test_plain_backward_matches_reference_vjp(s, chunk, causal, hd, hd_v):
    q, k, v, dout = _inputs(B, s, s, KH, G, hd, hd_v, seed=s + hd)
    got = _port_grads(q, k, v, dout, causal)
    want = _ref_grads(q, k, v, dout, causal, chunk)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), w, rtol=3e-4, atol=3e-4, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_reference_vjp_cross_lengths(causal):
    """T ≠ S, as tests/test_flash.py's cross-attention shape (S = 40, T = 96)."""
    q, k, v, dout = _inputs(B, 40, 96, KH, 2, 16, 16, seed=9)
    got = _port_grads(q, k, v, dout, causal)
    want = _ref_grads(q, k, v, dout, causal, 16)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("s,chunk", [(64, 16), (100, 32), (33, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd,hd_v", [(16, 16), (24, 16)])
def test_plain_lse_matches_reference(s, chunk, causal, hd, hd_v):
    q, k, v, _ = _inputs(B, s, s, KH, G, hd, hd_v, seed=3 * s)
    out, lse = flash_attention_ref(*_t(q, k, v), causal=causal, return_lse=True)
    want_out, want_lse = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal, chunk, chunk)
    assert lse.shape == (B, s, KH, G) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("hd,hd_v", [(16, 16), (24, 16)])
def test_model_flash_gradients_match_reference(hd, hd_v):
    """The autograd Function, as tests/test_flash.py's backward test drives
    the reference: the gradient of sum(sin(out)) at S = 72, chunk 32."""
    q, k, v, _ = _inputs(B, 72, 72, KH, 2, hd, hd_v, seed=5)
    qt, kt, vt = (x.requires_grad_() for x in _t(q, k, v))
    torch.sin(model_flash(qt, kt, vt, True, 32, 32)).sum().backward()
    want = jax.grad(lambda a, b_, c: jnp.sum(jnp.sin(ref_flash(a, b_, c, True, 32, 32))),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=3e-4, atol=3e-4)


def test_plain_backward_is_autograd_of_plain_forward():
    """In float64 the plain backward equals autograd through the plain
    forward (a softmax), with kv_len inside the causal reach: 1e-12."""
    q, k, v, dout = _inputs(B, 70, 90, KH, G, 36, 20, seed=11, dtype=np.float64)
    for causal, kv_len in ((True, 17), (False, 60), (True, None)):
        qt, kt, vt = (x.requires_grad_() for x in _t(q, k, v))
        out = flash_attention_ref(qt, kt, vt, causal=causal, kv_len=kv_len)
        want = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(dout))
        o, lse = flash_attention_ref(*_t(q, k, v), causal=causal, kv_len=kv_len, return_lse=True)
        got = flash_attention_bwd(*_t(q, k, v), o, lse, torch.from_numpy(dout), causal=causal,
                                  kv_len=kv_len)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=1e-12, atol=1e-12)


def test_rows_with_nothing_visible_have_inf_lse_and_zero_gradients():
    q, k, v, dout = _inputs(1, 65, 65, 1, 5, 8, 8, seed=2)
    out, lse = flash_attention(*_t(q, k, v), causal=True, kv_len=0, return_lse=True)
    assert bool((out == 0).all()) and bool(torch.isinf(lse).all()) and bool((lse > 0).all())
    for g in flash_attention_bwd(*_t(q, k, v), out, lse, torch.from_numpy(dout), kv_len=0):
        assert bool((g == 0).all())
    # a kv_len cut: positions past it get exactly zero dk and dv
    out, lse = flash_attention(*_t(q, k, v), causal=False, kv_len=20, return_lse=True)
    _, dk, dv = flash_attention_bwd(*_t(q, k, v), out, lse, torch.from_numpy(dout),
                                    causal=False, kv_len=20)
    assert bool((dk[:, 20:] == 0).all()) and bool((dv[:, 20:] == 0).all())
    assert bool((dk[:, :20] != 0).any())


def test_bf16_cast_points():
    """In bfloat16 the plain backward rounds P (for dv) and dS to bf16 before
    their products and returns bf16: within 2e-2 of max|g| of the float64
    backward on the same bf16-valued inputs (P and dS at 2^-8 relative)."""
    q, k, v, dout = _t(*_inputs(1, 96, 96, 2, 3, 32, 32, seed=4))
    q, k, v, dout = (x.to(torch.bfloat16) for x in (q, k, v, dout))
    out, lse = flash_attention_ref(q, k, v, return_lse=True)
    got = flash_attention_bwd_ref(q, k, v, out, lse, dout)
    want = flash_attention_bwd_ref(*(x.double() for x in (q, k, v, out, lse, dout)))
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert float((a.double() - w).abs().max()) <= 2e-2 * float(w.abs().max())


def test_cpu_wrapper_is_the_plain_version_and_checks_shapes():
    q, k, v, dout = _t(*_inputs(2, 40, 50, 2, 3, 16, 8, seed=1))
    out, lse = flash_attention(q, k, v, return_lse=True)
    before = KERNELS["flash_attention_bwd"].launches
    got = flash_attention_bwd(q, k, v, out, lse, dout)
    want = flash_attention_bwd_ref(q, k, v, out, lse, dout)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert KERNELS["flash_attention_bwd"].launches == before  # the plain version: no launch
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, out[:, :-1], lse, dout)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, out, lse[..., :1], dout)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, out, lse, dout, kv_len=-1)
    with pytest.raises(ValueError):
        flash_attention_bwd(q[:, :, :1], k, v, out, lse, dout)
