"""``remat="dots"``: keep a block's matrix products, recompute the rest.

The reference's ``_maybe_remat`` (``repro/models/lm/model.py:303-308``)
wraps each period in ``jax.checkpoint(fn, policy=checkpoint_dots)``: of
what the backward needs, the outputs of ``dot_general`` are saved and
everything else is recomputed from them. The port does the same per block
(``model._Remat`` with ``dots=True``): the block's forward runs without
recording under a :class:`DotTape` that keeps the output of every
``aten.mm``, ``bmm``, ``addmm`` and ``baddbmm`` (the projections, the MLP's
and the MoE experts' products, the SSD's and the einsum attention's
products: the ops ``torch.matmul``, ``F.linear`` and ``torch.einsum``
lower to), in order; the backward runs the block again, recording, under a
tape that hands each product its kept output in place of computing it, and
takes the gradients from that run. The kept outputs are saved through
``save_for_backward``, so ``torch.autograd.graph.saved_tensors_hooks`` see
them.

The replay checks each product against the one kept in its place: the
same op on operands of the same shapes, and as many products in all.

A hand-written kernel is one opaque call on the card (a ``ctypes`` launch,
which no dispatch mode sees), and its plain version, which a CPU tensor
takes, is one to the tape too (``kernels.in_plain_version``), so flash
attention is recomputed, not kept, on every device. So is the reference's
``custom_vjp`` flash under ``checkpoint_dots``: its backward's residuals
are the custom rule's ``(q, k, v, out, lse)``, none of them a
``dot_general`` output (q and k leave RoPE, v a reshape, out and lse the
online softmax), so the reference recomputes the whole flash forward in
the backward and saves none of its tiles. The port's flash forward
likewise runs again in the backward (two forward launches and one
backward launch a layer, as under ``"full"``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import in_plain_version

aten = torch.ops.aten

DOTS = frozenset({aten.mm.default, aten.bmm.default, aten.addmm.default,
                  aten.baddbmm.default})


def _signature(func, args) -> Tuple:
    """A product as the replay checks it: the op and its operands' shapes."""
    return (func, tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor)))


class DotTape(TorchDispatchMode):
    """Keeps (``replay=None``) or hands back (``replay`` the kept outputs,
    ``signatures`` theirs) the outputs of the matrix products run under it,
    in the order they run."""

    def __init__(self, replay: Optional[List[torch.Tensor]] = None,
                 signatures: Optional[List[Tuple]] = None):
        super().__init__()
        self.replay = replay
        self.outputs: List[torch.Tensor] = []
        self.signatures: List[Tuple] = [] if signatures is None else signatures
        self._versions: List[int] = []
        self._next = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in DOTS or in_plain_version():
            return func(*args, **(kwargs or {}))
        if self.replay is None:
            out = func(*args, **(kwargs or {}))
            self.outputs.append(out)
            self.signatures.append(_signature(func, args))
            self._versions.append(out._version)
            return out
        if self._next == len(self.replay):
            raise RuntimeError("remat='dots': the recomputed block ran more matrix products "
                               f"than the {len(self.replay)} its forward kept")
        if _signature(func, args) != self.signatures[self._next]:
            raise RuntimeError(f"remat='dots': matrix product {self._next} of the recomputed "
                               f"block is {_signature(func, args)}, its forward kept "
                               f"{self.signatures[self._next]}")
        out = self.replay[self._next]
        self._next += 1
        return out.detach()  # a fresh tensor on the kept storage: autograd sets its history

    def kept(self) -> List[torch.Tensor]:
        """The outputs kept, after checking that none was written in place
        after its product (the recomputation would then read the new
        values)."""
        for i, (out, version) in enumerate(zip(self.outputs, self._versions)):
            if out._version != version:
                raise RuntimeError(f"remat='dots': matrix product {i} of the block was "
                                   "modified in place after it ran; it cannot be kept")
        return self.outputs

    def check_replayed(self) -> None:
        if self._next != len(self.replay):
            raise RuntimeError(f"remat='dots': the recomputed block ran {self._next} matrix "
                               f"products, its forward {len(self.replay)}")
