"""Flash attention for the LM sidecar, forward only.

The counterpart of ``repro/models/lm/flash.py:45``: the reference computes
the FlashAttention-2 forward in pure JAX (a ``custom_vjp`` whose forward is
an online-softmax loop over KV tiles); the port computes the same function
with the hand-written kernel (:mod:`repro_torch.kernels.flash_attention`),
by the kernels' dispatch rule: a CUDA tensor launches the kernel, a CPU
tensor takes its plain version.

GQA layout: q (B,S,K,G,hd), k/v (B,T,K,hd|hd_v). ``q_chunk`` and ``kv_chunk``
are accepted for signature parity with the reference; the kernel picks its
own tiles. The backward (the reference's ``_flash_bwd``) comes with the
training slice as a ``torch.autograd.Function`` (ROADMAP Queue 1 item 11):
until then asking for a gradient raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as _flash_kernel


def flash_attention(
    q: torch.Tensor,  # (B, S, K, G, hd)
    k: torch.Tensor,  # (B, T, K, hd)
    v: torch.Tensor,  # (B, T, K, hd_v)
    causal: bool = True,
    q_chunk: int = 512,
    kv_chunk: int = 512,
) -> torch.Tensor:
    del q_chunk, kv_chunk  # the kernel's own tiles
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward only in the port; its backward comes with the "
            "training slice (ROADMAP Queue 1 item 11)"
        )
    return _flash_kernel(q, k, v, causal=causal)
