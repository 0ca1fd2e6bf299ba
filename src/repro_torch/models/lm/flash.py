"""Flash attention for the LM: forward and backward through the hand-written kernels.

The counterpart of ``repro/models/lm/flash.py``: the reference computes
FlashAttention-2 in pure JAX, a ``custom_vjp`` whose forward (:45) saves
``(q, k, v, out, lse)`` and whose backward (``_flash_bwd`` :122) runs the two
tiled passes from them. The port is the same ``torch.autograd.Function``:
its forward calls the forward kernel with ``return_lse=True`` and saves the
same five tensors, its backward calls :func:`~repro_torch.kernels.
flash_attention.flash_attention_bwd`. Both go by the kernels' dispatch
rule: a CUDA tensor launches the hand-written kernel, a CPU tensor takes its
plain version. Without a gradient to take (serving, ``inference_mode``) the
forward asks for no lse and the kernels write none. The backward copies an
incoming gradient that a tensor map cannot take (``ops._tma_ok``) into a
fresh contiguous tensor, so that a bf16 backward goes to the tensor-core route. The
backward kernel has no gradient of its own, so a second-order gradient
raises.

GQA layout: q (B,S,K,G,hd), k/v (B,T,K,hd|hd_v). ``q_chunk`` and ``kv_chunk``
are accepted for signature parity with the reference; the kernels pick
their own tiles.

Under placements (q, k, v DTensors) every rank runs the same function on its
local shards through a ``local_map`` region: q, k and v may stay sharded on
the batch (over the data axes) and on the KV heads (over ``model``), where
attention is independent; every other placement is redistributed to
``Replicate`` first (a sequence split could build a row with no visible
key). The autograd function runs inside the region, so the forward and the
backward each launch the kernel once a rank on the local shard.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.flash_attention import flash_attention as _flash_kernel
from repro_torch.kernels.flash_attention import flash_attention_bwd as _flash_bwd_kernel
from repro_torch.kernels.flash_attention.ops import _tma_ok
from repro_torch.models.lm import placement
from repro_torch.models.lm.placement import is_placed


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = _flash_kernel(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if not _tma_ok(dout):  # a fresh contiguous copy: bf16 then takes the tensor-core route
            dout = dout.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = _flash_bwd_kernel(q, k, v, out, lse, dout, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,  # (B, S, K, G, hd)
    k: torch.Tensor,  # (B, T, K, hd)
    v: torch.Tensor,  # (B, T, K, hd_v)
    causal: bool = True,
    q_chunk: int = 512,
    kv_chunk: int = 512,
) -> torch.Tensor:
    del q_chunk, kv_chunk  # the kernels' own tiles
    if is_placed(q):
        return _flash_placed(q, k, v, causal)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal)
    return _flash_kernel(q, k, v, causal=causal)


def _flash_placed(q, k, v, causal: bool):
    """Flash on local shards: batch over the data axes and KV heads over
    ``model`` where q, k and v all have them, the rest replicated."""
    mesh = q.device_mesh
    keep = {}
    for name in mesh.mesh_dim_names:
        dim = 0 if name in placement.DATA_AXES else 2 if name == "model" else None
        if dim is not None and all(placement.shards(t, name, dim) for t in (q, k, v)):
            keep[name] = dim
    pl = placement.placements(mesh, keep)
    return placement.region(lambda a, b, c: flash_attention(a, b, c, causal), mesh, (q, k, v),
                            (pl, pl, pl), pl)
