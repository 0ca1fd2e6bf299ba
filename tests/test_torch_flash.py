"""The port's flash-attention forward on the CPU against the reference's.

The port's plain version (``repro_torch.kernels.flash_attention.ref``, what
the wrapper runs for a CPU tensor) against the Pallas kernel run in
interpret mode with 64-row blocks, as ``tests/test_flash_kernel.py`` runs
it, at that file's four shapes, and against the LM sidecar's pure-JAX
flash (``repro.models.lm.flash.flash_attention``). Inputs are drawn with
numpy from a seed and handed to both. Tolerances: 2e-4 in float32 (two
float32 softmax-attention paths summed in other orders, the reference
tests' own figure); 3e-2 in bfloat16 (the output's rounding, 2^-8 relative,
on values of size ~1). The hand-written CUDA kernel itself is held to this
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
The wrapper's route rule (which of the three kernels a card call would
take: bf16 or float32 on the tensor cores, or FMAs) is a function of the
tensors alone and is tested here on CPU tensors.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_pallas_flash
from repro.kernels.flash_attention import flash_attention_ref as ref_oracle
from repro.models.lm.flash import flash_attention as ref_model_flash
from repro_torch.kernels import KERNELS
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.lm.flash import flash_attention as model_flash
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

SHAPES = [  # b, s, t, kh, g, hd, hd_v, causal: tests/test_flash_kernel.py's four
    (1, 128, 128, 1, 1, 32, 32, True),
    (2, 128, 128, 2, 2, 32, 16, True),  # GQA + hd_v != hd
    (1, 100, 160, 1, 4, 16, 16, False),  # ragged + cross lengths
    (1, 256, 256, 2, 1, 64, 64, True),
]


def _inputs(b, s, t, kh, g, hd, hd_v, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, kh, g, hd)).astype(dtype)
    k = rng.standard_normal((b, t, kh, hd)).astype(dtype)
    v = rng.standard_normal((b, t, kh, hd_v)).astype(dtype)
    return q, k, v


def _torch(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("b,s,t,kh,g,hd,hd_v,causal", SHAPES)
def test_plain_version_matches_pallas_kernel(b, s, t, kh, g, hd, hd_v, causal):
    q, k, v = _inputs(b, s, t, kh, g, hd, hd_v, seed=s + t)
    want = np.asarray(ref_pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=causal, block_q=64, block_k=64))
    got = flash_attention(*_torch(q, k, v), causal=causal)
    assert got.shape == (b, s, kh, g, hd_v) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        flash_attention_ref(*_torch(q, k, v), causal=causal).numpy(),
        np.asarray(ref_oracle(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)),
        rtol=2e-4, atol=2e-4,
    )


@pytest.mark.parametrize("b,s,t,kh,g,hd,hd_v,causal", SHAPES)
def test_plain_version_matches_model_flash(b, s, t, kh, g, hd, hd_v, causal):
    q, k, v = _inputs(b, s, t, kh, g, hd, hd_v, seed=7)
    want = np.asarray(ref_model_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal, 64, 64))
    got = model_flash(*_torch(q, k, v), causal, 64, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_bf16_matches_pallas_kernel():
    q, k, v = _inputs(1, 128, 128, 1, 2, 32, 32, seed=5, dtype=ml_dtypes.bfloat16)
    want = ref_pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, block_q=64, block_k=64)
    tq, tk, tv = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=3e-2, atol=3e-2)


def test_kv_len_masks_the_tail_and_an_empty_row_is_zero():
    """kv positions ≥ kv_len get weight 0: the same as cutting k and v there;
    with kv_len = 0 every row is masked and gives zeros, not NaN."""
    q, k, v = _torch(*_inputs(2, 50, 70, 2, 3, 16, 8, seed=3))
    got = flash_attention(q, k, v, causal=False, kv_len=33)
    want = flash_attention(q, k[:, :33], v[:, :33], causal=False)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    causal = flash_attention(q, k, v, causal=True, kv_len=10)
    torch.testing.assert_close(
        causal[:, 10:], flash_attention(q, k[:, :10], v[:, :10], causal=False)[:, 10:],
        rtol=1e-6, atol=1e-6,
    )
    empty = flash_attention(q, k, v, causal=True, kv_len=0)
    assert torch.equal(empty, torch.zeros_like(empty))


def test_float64_input_is_computed_in_float64():
    q, k, v = _inputs(1, 40, 40, 1, 2, 8, 8, seed=9, dtype=np.float64)
    out = flash_attention_ref(*_torch(q, k, v))
    assert out.dtype == torch.float64
    np.testing.assert_allclose(
        out.float().numpy(),
        flash_attention_ref(*_torch(*(a.astype(np.float32) for a in (q, k, v)))).numpy(),
        rtol=1e-5, atol=1e-6,
    )


def test_cpu_call_counts_no_launch_and_bad_shapes_raise():
    q, k, v = _torch(*_inputs(1, 16, 16, 2, 2, 8, 8))
    before = KERNELS["flash_attention"].launches
    flash_attention(q, k, v)
    assert KERNELS["flash_attention"].launches == before
    with pytest.raises(ValueError):
        flash_attention(q[..., 0, :], k, v)  # q without its G axis
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :1], v)  # K disagrees
    with pytest.raises(ValueError):
        flash_attention(q, k, v, kv_len=-1)
    # the meta device (the dry run) gets the output's shape alone, no launch
    out = flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape[:4] + (v.shape[-1],)
    assert KERNELS["flash_attention"].launches == before


def test_model_flash_refuses_a_gradient():
    """The backward kernel has no gradient of its own: a second-order
    gradient through the model's flash raises."""
    q, k, v = _torch(*_inputs(1, 16, 16, 1, 2, 8, 8))
    out = model_flash(q.requires_grad_(True), k, v)
    dout = torch.ones_like(out, requires_grad=True)
    (dq,) = torch.autograd.grad(out, (q,), dout, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()


def test_model_flash_takes_a_gradient_on_the_cpu():
    """The model's flash takes a gradient (the autograd Function around the
    forward with lse and the backward, both the plain versions here);
    without one asked it is the forward alone."""
    q, k, v = _torch(*_inputs(1, 16, 16, 1, 2, 8, 8))
    out = model_flash(q.requires_grad_(True), k, v)
    assert out.grad_fn is not None
    (dq,) = torch.autograd.grad(out.sum(), (q,))
    assert dq.shape == q.shape and bool(torch.isfinite(dq).all())
    with torch.no_grad():
        assert torch.equal(model_flash(q, k, v), out.detach())  # no gradient asked: fine


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _route_case(name):
    """(q, k, v) for one route-rule case, CPU tensors of the card's layouts."""
    b, s, kh, g = 2, 8, 2, 3
    k128, v128 = _bf16(b, s, kh, 128), _bf16(b, s, kh, 128)
    if name == "serving view hd 128":  # the model's (B,S,H,hd) reshaped to (B,S,K,G,hd)
        return _bf16(b, s, kh * g, 128).reshape(b, s, kh, g, 128), k128, v128
    if name == "fused qkv view hd 128":  # a view into a q|k|v projection: strided rows
        qkv = _bf16(b, s, kh * g + 2 * kh, 128)
        return (qkv[:, :, :kh * g].reshape(b, s, kh, g, 128), qkv[:, :, kh * g:kh * g + kh],
                qkv[:, :, kh * g + kh:])
    if name == "MLA hd 192 hd_v 128":
        return _bf16(b, s, kh, g, 192), _bf16(b, s, kh, 192), v128
    if name == "hd 64":
        return _bf16(b, s, kh, g, 64), _bf16(b, s, kh, 64), _bf16(b, s, kh, 64)
    if name == "float32 hd 128":
        return (torch.zeros((b, s, kh, g, 128)), torch.zeros((b, s, kh, 128)),
                torch.zeros((b, s, kh, 128)))
    if name == "float32 hd 64":
        return torch.zeros((b, s, kh, g, 64)), torch.zeros((b, s, kh, 64)), torch.zeros((b, s, kh, 64))
    f128 = torch.zeros((b, s, kh, 128))
    if name == "float32 hd 128 hd_v 64":
        return torch.zeros((b, s, kh, g, 128)), f128, torch.zeros((b, s, kh, 64))
    if name == "float32 serving view hd 128":
        return torch.zeros((b, s, kh * g, 128)).reshape(b, s, kh, g, 128), f128, f128
    if name == "float32 hd 32":
        return torch.zeros((b, s, kh, g, 32)), torch.zeros((b, s, kh, 32)), torch.zeros((b, s, kh, 32))
    if name == "float32 MLA hd 192 hd_v 128":
        return torch.zeros((b, s, kh, g, 192)), torch.zeros((b, s, kh, 192)), f128
    if name == "float32 base 4 bytes off 16":
        return torch.zeros(b * s * kh * g * 128 + 1)[1:].view(b, s, kh, g, 128), f128, f128
    if name == "float32 row stride 132 elements":  # 528 bytes: a multiple of 16
        return torch.zeros((b, s, kh, g, 132))[..., :128], f128, f128
    if name == "float32 k row stride 130 elements":  # 520 bytes: not
        return torch.zeros((b, s, kh, g, 128)), torch.zeros((b, s, kh, 130))[..., :128], f128
    if name == "float32 q, bf16 k and v":
        return torch.zeros((b, s, kh, g, 128)), k128, v128
    if name == "hd 32":
        return _bf16(b, s, kh, g, 32), _bf16(b, s, kh, 32), _bf16(b, s, kh, 32)
    if name == "hd 36":
        return _bf16(b, s, kh, g, 36), _bf16(b, s, kh, 36), _bf16(b, s, kh, 36)
    if name == "hd_v 96":
        return _bf16(b, s, kh, g, 128), k128, _bf16(b, s, kh, 96)
    if name == "base 2 bytes off 16":
        q = _bf16(b * s * kh * g * 128 + 1)[1:].view(b, s, kh, g, 128)
        return q, k128, v128
    if name == "row stride 132 elements":
        return _bf16(b, s, kh, g, 132)[..., :128], k128, v128
    if name == "k row stride 136 elements":  # a multiple of 8: stays on tensor cores
        return _bf16(b, s, kh, g, 128), _bf16(b, s, kh, 136)[..., :128], v128
    if name == "v expanded over batch":  # stride 0 on an axis longer than 1
        return _bf16(b, s, kh, g, 128), k128, _bf16(1, s, kh, 128).expand(b, s, kh, 128)
    raise KeyError(name)


ROUTE_CASES = {
    "serving view hd 128": "tensor_core",
    "fused qkv view hd 128": "tensor_core",
    "MLA hd 192 hd_v 128": "tensor_core",
    "hd 64": "tensor_core",
    "k row stride 136 elements": "tensor_core",
    "float32 hd 128": "tf32x3",
    "float32 hd 64": "tf32x3",
    "float32 hd 128 hd_v 64": "tf32x3",
    "float32 serving view hd 128": "tf32x3",
    "float32 row stride 132 elements": "tf32x3",
    "float32 hd 32": "fma",
    "float32 MLA hd 192 hd_v 128": "fma",
    "float32 base 4 bytes off 16": "fma",
    "float32 k row stride 130 elements": "fma",
    "float32 q, bf16 k and v": "fma",
    "hd 32": "fma",
    "hd 36": "fma",
    "hd_v 96": "fma",
    "base 2 bytes off 16": "fma",
    "row stride 132 elements": "fma",
    "v expanded over batch": "fma",
}


@pytest.mark.parametrize("name", sorted(ROUTE_CASES))
def test_route_rule(name):
    q, k, v = _route_case(name)
    assert flash_ops._route(q, k, v) == ROUTE_CASES[name]


def test_tensor_map_strides_of_a_length_one_axis_are_row_lengths():
    """A length-1 axis may carry any stride in torch; the tensor map gets the
    row length there, so only strides that are stepped along decide."""
    q = _bf16(1, 1, 8, 3, 128 + 1)[..., :128]  # B = S = 1, strides (3096, 3096, 387, 129, 1)
    assert flash_ops._tma_strides(q) == [128, 128, 387, 129]
    k, v = _bf16(1, 1, 8, 128), _bf16(1, 1, 8, 128)
    assert flash_ops._route(q, k, v) == "fma"  # K's 387 and G's 129 are stepped along
    assert flash_ops._route(_bf16(1, 1, 8, 3, 136)[..., :128], k, v) == "tensor_core"


def test_cpu_call_counts_no_route_launch():
    kernel = KERNELS["flash_attention"]
    assert set(kernel.route_launches) == {"tensor_core", "tf32x3", "fma"}
    before, routes = kernel.launches, dict(kernel.route_launches)
    for name in ("serving view hd 128", "float32 hd 128"):
        flash_attention(*_route_case(name))
    assert kernel.launches == before and kernel.route_launches == routes
