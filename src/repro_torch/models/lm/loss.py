"""Token cross-entropy (+ z-loss) of the LM.

The counterpart of ``repro/models/lm/loss.py``: the log-softmax as explicit
max and logsumexp reductions over the vocab axis in float32, the max
detached inside the exponent (the reference's ``stop_gradient``) and added
back undetached, as the reference writes it. Autograd of that expression
is the reference's gradient to the bit of its arithmetic: softmax minus the
label's one-hot, plus the argmax's one-hot (shared among ties, as
``jnp.max``'s derivative shares it) from the undetached max; the value is
the exact logsumexp. ROADMAP Queue 3 lists the extra term as a fault of the
reference; the port keeps it, so that its gradients are the reference's.

Under placements the logits may be vocab-sharded (``Shard(-1)`` over
``model``, the head's layout): the max and the sum of exponentials reduce
through DTensor (a max and a sum over ``model``), and the label's logit is
gathered on each rank's own vocab block, zero outside it, and summed over
``model`` (:func:`_label_logits`). The detached max is kept there too.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.lm import placement
from repro_torch.models.lm.placement import is_placed, like


def cross_entropy(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S) integer
    *,
    z_loss_coeff: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token CE over all positions. Returns (loss, z_loss)."""
    if is_placed(logits):
        return _cross_entropy_placed(logits, labels, z_loss_coeff)
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True)
    shifted = logits - m.detach()
    lse = torch.log(torch.exp(shifted).sum(dim=-1)) + m[..., 0]
    label_logit = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    loss = (lse - label_logit).mean()
    zl = (lse**2).mean() * z_loss_coeff if z_loss_coeff else torch.zeros((), device=logits.device)
    return loss, zl


def _label_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]`` of placed (B, S, V) logits: each rank gathers
    the labels inside its vocab block (its rank on the vocab axis times the
    block's width onwards), zero elsewhere; a vocab split makes the result a
    sum over that axis."""
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    vdim = logits.dim() - 1
    vocab = [n for n in names if placement.shards(logits, n, vdim)]
    keep = {n: 0 for n in names if placement.shards(logits, n, 0) and n not in vocab}
    labels = like(logits, labels)

    def local(lg, lb):
        idx = lb.long()
        if not vocab:
            return torch.take_along_dim(lg, idx[..., None], dim=-1)[..., 0]
        width, block = lg.shape[-1], 0
        for n in vocab:  # this rank's vocab block, row-major over the vocab axes
            block = block * mesh.size(names.index(n)) + mesh.get_local_rank(n)
        idx = idx - block * width
        inside = (idx >= 0) & (idx < width)
        got = torch.take_along_dim(lg, idx.clamp(0, width - 1)[..., None], dim=-1)[..., 0]
        return torch.where(inside, got, torch.zeros((), dtype=got.dtype, device=got.device))

    lg_pl = placement.placements(mesh, dict(keep, **{n: vdim for n in vocab}))
    lb_pl = placement.placements(mesh, keep)
    out_pl = placement.placements(mesh, keep, partial=vocab)
    return placement.region(local, mesh, (logits, labels), (lg_pl, lb_pl), out_pl)


def _cross_entropy_placed(logits, labels, z_loss_coeff: float):
    """:func:`cross_entropy` on placed logits, the same arithmetic."""
    logits = placement.settle(logits).float()
    # the (B, S) intermediates are fenced: their gradients come back in their
    # own layout (batch over the data axes), not split over the batch by model
    m = placement.fence(placement.settle(logits.amax(dim=-1, keepdim=True)))
    shifted = logits - m.detach()
    lse = torch.log(placement.settle(torch.exp(shifted).sum(dim=-1))) + m.squeeze(-1)
    label_logit = _label_logits(logits, labels)
    loss = placement.fence(placement.settle(lse - label_logit)).mean()
    zl = (lse**2).mean() * z_loss_coeff if z_loss_coeff else like(
        lse, torch.zeros((), device=lse.device))
    return loss, zl


def shift_labels(tokens: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """Next-token labels: labels[t] = tokens[t+1]; the final position pads."""
    return torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], pad_id)], dim=1)
