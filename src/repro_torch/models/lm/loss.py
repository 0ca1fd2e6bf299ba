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
"""

from __future__ import annotations

from typing import Tuple

import torch


def cross_entropy(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S) integer
    *,
    z_loss_coeff: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token CE over all positions. Returns (loss, z_loss)."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True)
    shifted = logits - m.detach()
    lse = torch.log(torch.exp(shifted).sum(dim=-1)) + m[..., 0]
    label_logit = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    loss = (lse - label_logit).mean()
    zl = (lse**2).mean() * z_loss_coeff if z_loss_coeff else torch.zeros((), device=logits.device)
    return loss, zl


def shift_labels(tokens: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """Next-token labels: labels[t] = tokens[t+1]; the final position pads."""
    return torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], pad_id)], dim=1)
