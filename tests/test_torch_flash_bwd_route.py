"""The flash backward's routing rule and the tensor-core route's launch plan.

``ops._route_bwd`` picks the backward's kernels from the tensors alone,
before the launch: ``"tensor_core"`` (bf16 ``wgmma`` + TMA) for bfloat16 q,
k, v, out and dout with hd and hd_v in {64, 128} that a tensor map takes,
``"fma"`` (float32 FMAs) for every other call. ``ops.bwd_tc_plan`` mirrors
the C source's launch plan (blocks, threads, dynamic shared memory and
scratch of the dq and dkdv kernels; held equal to
``flash_attention_bwd_tc_plan`` on the card) and ``ops.bwd_tc_pairs`` the
(head, q tile, kv tile) pairs its consumer warpgroups compute, in the order
of its loops. Here, on the CPU: the rule on each kind of operand, the
plan's shared memory within the card's 232,448 bytes a block, and the
pairs exactly those that hold a visible position under the plain
version's mask (``ref._mask``), each once. The kernels themselves run only
on the card (``tests/test_torch_cuda.py``).
"""

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention import flash_attention_bwd, ops
from repro_torch.kernels.flash_attention.ref import _mask
from repro_torch.models.lm import flash as model_flash
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

BF16 = torch.bfloat16


def _operands(hd=128, hd_v=128, dtype=BF16, s=8, kh=2, g=3):
    """q, k, v, out, dout of one call, contiguous."""
    return (torch.zeros((1, s, kh, g, hd), dtype=dtype), torch.zeros((1, s, kh, hd), dtype=dtype),
            torch.zeros((1, s, kh, hd_v), dtype=dtype),
            torch.zeros((1, s, kh, g, hd_v), dtype=dtype),
            torch.zeros((1, s, kh, g, hd_v), dtype=dtype))


def _route_case(name):
    q, k, v, out, dout = _operands()
    if name == "bf16 hd 128":
        return q, k, v, out, dout
    if name == "bf16 hd 64":
        return _operands(64, 64)
    if name == "bf16 hd 64 hd_v 128":
        return _operands(64, 128)
    if name == "bf16 hd 128 hd_v 64":
        return _operands(128, 64)
    if name == "the model's strided query view":  # q of a fused q|k|v projection, reshaped
        qkv = torch.zeros((1, 8, 2 * 3 + 2 * 2, 128), dtype=BF16)
        return qkv[:, :, :6].reshape(1, 8, 2, 3, 128), qkv[:, :, 6:8], qkv[:, :, 8:], out, dout
    if name == "float32":
        return _operands(dtype=torch.float32)
    if name == "bf16 out, float32 dout":
        return q, k, v, out, dout.float()
    if name in ("hd 192", "hd 256", "hd 36", "hd_v 256"):
        hd = int(name.split()[-1])
        return _operands(*((128, hd) if name.startswith("hd_v") else (hd, hd)))
    if name == "q's base 2 bytes off 16":
        flat = torch.zeros((q.numel() + 1,), dtype=BF16)
        return flat[1:].view(q.shape), k, v, out, dout
    if name == "dout's row stride 129 elements":
        return q, k, v, out, torch.zeros((1, 8, 2, 3, 129), dtype=BF16)[..., :128]
    if name == "dout expanded over its heads":  # stride 0: a tensor map steps along nothing
        return q, k, v, out, torch.zeros((1, 8, 2, 1, 128), dtype=BF16).expand(dout.shape)
    raise KeyError(name)


ROUTE_CASES = {
    "bf16 hd 128": "tensor_core",
    "bf16 hd 64": "tensor_core",
    "bf16 hd 64 hd_v 128": "tensor_core",
    "bf16 hd 128 hd_v 64": "tensor_core",
    "the model's strided query view": "tensor_core",
    "float32": "fma",
    "bf16 out, float32 dout": "fma",
    "hd 192": "fma",
    "hd 256": "fma",
    "hd_v 256": "fma",
    "hd 36": "fma",
    "q's base 2 bytes off 16": "fma",
    "dout's row stride 129 elements": "fma",
    "dout expanded over its heads": "fma",
}


@pytest.mark.parametrize("name", sorted(ROUTE_CASES))
def test_route_rule(name):
    assert ops._route_bwd(*_route_case(name)) == ROUTE_CASES[name]


# (hd, hd_v) -> dynamic shared bytes of the dq and dkdv kernels: the dq
# kernel's two slabs of q, dout and out and its two-stage K/V ring; the dkdv
# kernel's two K and V tiles, its two-stage q/dout ring and their lse and D
# slices; 40 bytes of mbarriers and 1,024 of alignment slack each
SMEM = {(64, 64): (82_984, 67_624), (64, 128): (132_136, 100_392),
        (128, 64): (115_752, 100_392), (128, 128): (164_904, 133_160)}


@pytest.mark.parametrize("hd,hd_v", sorted(SMEM))
def test_plan_shared_memory_fits_a_block(hd, hd_v):
    for i, kernel in enumerate(("dq", "dkdv")):
        plan = ops.bwd_tc_plan(kernel, 1, 4096, 4096, 8, 3, hd, hd_v)
        assert plan.smem == ops.bwd_tc_smem(kernel, hd, hd_v) == SMEM[hd, hd_v][i]
        assert plan.smem <= 232_448
        assert plan.threads == 384  # two consumer warpgroups and the producer


def test_plan_at_the_training_shape():
    """B=1, S=T=4,096, K=8, G=3: the dq kernel's 64 position slabs × 3
    heads, two a block, and the dkdv kernel's 32 kv blocks of 128 rows, for
    each of the 8 kv heads; lse·log2(e) and D of every row as scratch."""
    assert ops.bwd_tc_plan("dq", 1, 4096, 4096, 8, 3, 128, 128) == \
        ops.BwdPlan(768, 384, 164_904, 196_608)
    assert ops.bwd_tc_plan("dkdv", 1, 4096, 4096, 8, 3, 128, 128) == \
        ops.BwdPlan(256, 384, 133_160, 196_608)
    # ragged: S = 1,000 pads to 16 slabs of 64 positions (× 3 heads, two a
    # block, × B·K = 4), T = 1,000 to 8 kv blocks of 128 rows
    assert ops.bwd_tc_plan("dq", 2, 1000, 1000, 2, 3, 64, 64) == \
        ops.BwdPlan(96, 384, 82_984, 24_576)
    assert ops.bwd_tc_plan("dkdv", 2, 1000, 1000, 2, 3, 64, 64).blocks == 32


@pytest.mark.parametrize("hd,hd_v", [(32, 32), (36, 20), (192, 128), (128, 256), (256, 256),
                                     (96, 128)])
def test_plan_refuses_what_the_route_does_not_take(hd, hd_v):
    assert ops.bwd_tc_plan("dq", 1, 100, 100, 2, 3, hd, hd_v) is None
    assert ops.bwd_tc_plan("dkdv", 1, 100, 100, 2, 3, hd, hd_v) is None


def _visible_pairs(s, t, g, causal, kv_len):
    mask = _mask(s, t, causal, kv_len, "cpu")
    tile = ops.TC_TILE
    return {(head, qt, kt) for qt in range(-(-s // tile)) for kt in range(-(-t // tile))
            if bool(mask[qt * tile:(qt + 1) * tile, kt * tile:(kt + 1) * tile].any())
            for head in range(g)}


SHAPES = [(4096, 4096, 3), (1000, 1000, 3), (130, 130, 3), (200, 1000, 3), (100, 160, 4),
          (70, 90, 1), (300, 100, 8), (64, 64, 1), (1, 1, 2)]


@pytest.mark.parametrize("kernel", ["dq", "dkdv"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,t,g", SHAPES)
def test_loops_visit_exactly_the_visible_tile_pairs(kernel, causal, s, t, g):
    """Under causal and non-causal masks, ragged S and T and kv_len in {0,
    17, T}: every (head, q tile, kv tile) pair that holds a visible
    position is computed once, and no other."""
    for kv_len in (0, 17, t):
        got = ops.bwd_tc_pairs(kernel, s, t, g, causal, kv_len)
        assert len(got) == len(set(got)), (kv_len, "a pair computed twice")
        assert set(got) == _visible_pairs(s, t, g, causal, kv_len), kv_len


def test_causal_training_shape_skips_the_upper_triangle():
    """At S = T = 4,096 causal, both kernels compute 2,080 of the 4,096
    tile pairs of a head (64·65/2), so the design's 7 products a pair are
    7/5 of FlashAttention-2's 5."""
    for kernel in ("dq", "dkdv"):
        assert len(ops.bwd_tc_pairs(kernel, 4096, 4096, 3, True, 4096)) == 3 * 2080


def test_cpu_call_counts_no_route_launch():
    kernel = kernels.KERNELS["flash_attention_bwd"]
    assert set(kernel.route_launches) == set(ops.BWD_ROUTES) == {"tensor_core", "fma"}
    before, routes = kernel.launches, dict(kernel.route_launches)
    q, k, v, out, dout = (x.normal_() for x in _operands(s=16))
    lse = torch.zeros((1, 16, 2, 3))
    flash_attention_bwd(q, k, v, out, lse, dout)
    assert kernel.launches == before and kernel.route_launches == routes


def test_model_backward_hands_the_kernel_a_dout_tma_takes(monkeypatch):
    """The model's autograd Function copies an incoming gradient that a
    tensor map refuses (here autograd's expanded ones of a sum, stride 0)
    into a fresh contiguous one before the backward, so a bf16 gradient
    takes the tensor-core route on the card."""
    seen = []
    real = model_flash._flash_bwd_kernel

    def spy(q, k, v, out, lse, dout, **kw):
        seen.append((dout.is_contiguous(), ops._tma_ok(dout), ops._route_bwd(q, k, v, out, dout)))
        return real(q, k, v, out, lse, dout, **kw)

    monkeypatch.setattr(model_flash, "_flash_bwd_kernel", spy)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen).to(BF16).requires_grad_()
               for shape in ((1, 16, 2, 3, 64), (1, 16, 2, 64), (1, 16, 2, 64)))
    model_flash.flash_attention(q, k, v).sum().backward()
    assert seen == [(True, True, "tensor_core")]
    assert all(x.grad is not None and bool(torch.isfinite(x.grad.float()).all()) for x in (q, k, v))
