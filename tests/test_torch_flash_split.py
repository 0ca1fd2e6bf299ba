"""The arithmetic of the card's float32 flash route, modelled in PyTorch on the CPU.

The ``"tf32x3"`` route of ``csrc/flash_attention.cu`` takes both products of
the float32 forward on the tensor cores as 3×TF32: each operand split into
TF32 halves rounded to nearest (hi = tf32(x), lo = tf32(x − hi)), the
product hi·lo + lo·hi + hi·hi in a float32 accumulator, lo·lo dropped.
``ref.flash_attention_ref_split`` models that arithmetic; it runs here,
where the kernel cannot. Inputs drawn with numpy from a seed, at
``tests/test_torch_flash.py``'s shapes (the reference tests' four) and the
route's own head dims (64, 128):

- the three-pass model is within the card's float32 tolerance of the
  float64 plain version (rtol 2e-5, atol 2e-5: what ``chip_smoke.py`` and
  ``tests/test_torch_cuda.py`` hold every float32 route to);
- one TF32 pass is not (its errors are ~1e-4 to 1e-3): the ground for
  three passes;
- the model agrees with ``repro``'s Pallas kernel in interpret mode and with
  ``repro.models.lm.flash.flash_attention`` (JAX on the CPU) at the parity
  tests' float32 figure, 2e-4;
- masked positions weigh exactly 0 and a row with nothing visible gives
  zeros, as on the other routes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_pallas_flash
from repro.models.lm.flash import flash_attention as ref_model_flash
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.flash_attention.ref import flash_attention_ref_split
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

SHAPES = [  # b, s, t, kh, g, hd, hd_v, causal: tests/test_torch_flash.py's four
    (1, 128, 128, 1, 1, 32, 32, True),
    (2, 128, 128, 2, 2, 32, 16, True),
    (1, 100, 160, 1, 4, 16, 16, False),
    (1, 256, 256, 2, 1, 64, 64, True),
]
ROUTE_SHAPES = [  # the route's own head dims, G = 3 as on the serving path
    (1, 200, 200, 2, 3, 128, 128, True),
    (1, 130, 300, 1, 3, 128, 64, False),
    (1, 150, 150, 2, 3, 64, 128, True),
]
RTOL = ATOL = 2e-5  # the card's float32 tolerance against float64 plain


def _inputs(b, s, t, kh, g, hd, hd_v, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, kh, g, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, kh, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kh, hd_v)).astype(np.float32)
    return q, k, v


def _torch(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _float64(q, k, v, **kw):
    return flash_attention_ref(*(x.double() for x in _torch(q, k, v)), **kw).numpy()


def _excess(got, want):
    """The largest amount by which |got − want| passes atol + rtol·|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) - (ATOL + RTOL * np.abs(want))).max())


@pytest.mark.parametrize("b,s,t,kh,g,hd,hd_v,causal", SHAPES + ROUTE_SHAPES)
def test_three_pass_model_meets_the_card_tolerance(b, s, t, kh, g, hd, hd_v, causal):
    q, k, v = _inputs(b, s, t, kh, g, hd, hd_v, seed=s + t)
    got = flash_attention_ref_split(*_torch(q, k, v), causal=causal)
    assert got.shape == (b, s, kh, g, hd_v) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _float64(q, k, v, causal=causal), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,s,t,kh,g,hd,hd_v,causal", SHAPES + ROUTE_SHAPES)
def test_one_tf32_pass_misses_the_tolerance(b, s, t, kh, g, hd, hd_v, causal):
    q, k, v = _inputs(b, s, t, kh, g, hd, hd_v, seed=s + t)
    want = _float64(q, k, v, causal=causal)
    one = flash_attention_ref_split(*_torch(q, k, v), causal=causal, passes=1)
    assert _excess(one, want) > 0
    # and the three passes meet it on the same inputs
    assert _excess(flash_attention_ref_split(*_torch(q, k, v), causal=causal), want) <= 0


@pytest.mark.parametrize("b,s,t,kh,g,hd,hd_v,causal", SHAPES)
def test_model_matches_pallas_kernel(b, s, t, kh, g, hd, hd_v, causal):
    q, k, v = _inputs(b, s, t, kh, g, hd, hd_v, seed=3)
    want = np.asarray(ref_pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=causal, block_q=64, block_k=64))
    got = flash_attention_ref_split(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("b,s,t,kh,g,hd,hd_v,causal", SHAPES)
def test_model_matches_model_flash(b, s, t, kh, g, hd, hd_v, causal):
    q, k, v = _inputs(b, s, t, kh, g, hd, hd_v, seed=7)
    want = np.asarray(ref_model_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal, 64, 64))
    got = flash_attention_ref_split(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_kv_len_masks_the_tail_and_an_empty_row_is_zero():
    q, k, v = _torch(*_inputs(2, 50, 70, 2, 3, 64, 64, seed=11))
    got = flash_attention_ref_split(q, k, v, causal=False, kv_len=33)
    want = flash_attention_ref_split(q, k[:, :33], v[:, :33], causal=False)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), _float64(*(x.numpy() for x in (q, k, v)), causal=False, kv_len=33),
        rtol=RTOL, atol=ATOL)
    empty = flash_attention_ref_split(q, k, v, causal=True, kv_len=0)
    assert torch.equal(empty, torch.zeros_like(empty))


def test_passes_other_than_one_or_three_raise():
    q, k, v = _torch(*_inputs(1, 8, 8, 1, 1, 8, 8))
    with pytest.raises(ValueError):
        flash_attention_ref_split(q, k, v, passes=2)
