"""Train and serve step functions of the LM.

The counterpart of ``repro/models/lm/steps.py``:

- ``loss_fn`` (:29): CE + z-loss + ``MOE_AUX_COEFF``·aux over the model's
  forward; ``train_step`` (:50): its gradients, then AdamW, one optimizer
  step; ``init_train_state`` (:65): the model and its AdamW state. The
  EP-MCMC (pSGLD subposterior) step lives in :mod:`repro_torch.distributed.
  epmcmc` and reuses the same loss. The model is an ``nn.Module`` and
  ``train_step`` updates its parameters in place, where the reference maps
  a parameter pytree to a new one. A parameter the loss does not reach (an
  encoder–decoder's encoder and cross-attention, trained on a batch without
  ``enc_frames``; a vlm's ``img_proj`` on one without ``img_embeds``) gets a
  zero gradient, as ``jax.grad`` gives it, so AdamW's moments and weight
  decay still move it (:func:`grads_of`). A batch with ``img_embeds`` has
  its prefix's logits sliced off before the loss (no next-token loss there).
- ``serve_prefill`` (:82) and ``serve_decode_step`` (:108), each run under
  ``torch.inference_mode()``; the state carries the encoder's memory, and
  its position counts a vlm's image prefix.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.lm import model as mdl
from repro_torch.models.lm.config import ModelConfig
from repro_torch.models.lm.layers import dtype_of
from repro_torch.models.lm.loss import cross_entropy, shift_labels
from repro_torch.models.lm.placement import is_placed, rows
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update

MOE_AUX_COEFF = 0.01
Z_LOSS_COEFF = 1e-4


def loss_fn(
    model: mdl.LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, {"ce", "z_loss", "moe_aux"}): ``moe_aux`` is the forward's
    summed MoE aux loss (0 without MoE blocks), weighted by ``MOE_AUX_COEFF``
    in the total. ``batch["enc_frames"]``, when present, feeds an
    encoder–decoder's encoder; ``batch["img_embeds"]`` a vlm's image prefix,
    whose ``cfg.num_image_tokens`` positions carry no loss."""
    logits, moe_aux = mdl.forward(model, batch["tokens"], img_embeds=batch.get("img_embeds"),
                                  enc_frames=batch.get("enc_frames"))
    labels = batch.get("labels")
    if labels is None:
        labels = shift_labels(batch["tokens"])
    if cfg.num_image_tokens and "img_embeds" in batch:
        logits = logits[:, cfg.num_image_tokens:]
    ce, zl = cross_entropy(logits, labels, z_loss_coeff=Z_LOSS_COEFF)
    total = ce + zl + MOE_AUX_COEFF * moe_aux
    return total, {"ce": ce, "z_loss": zl, "moe_aux": moe_aux}


def grads_of(total: torch.Tensor, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``{name: d total / d param}``, zeros for a parameter ``total`` does not reach."""
    return dict(zip(params, torch.autograd.grad(total, list(params.values()), allow_unused=True,
                                                materialize_grads=True)))


def train_step(
    model: mdl.LM,
    opt_state: AdamWState,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    lr: float = 3e-4,
) -> Tuple[mdl.LM, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step on ``model``'s parameters, in place; returns
    ``(model, opt_state, metrics)`` with ``metrics["loss"]`` the total."""
    params = dict(model.named_parameters())
    total, metrics = loss_fn(model, cfg, batch)
    grads = grads_of(total, params)
    _, opt_state = adamw_update(params, grads, opt_state, lr=lr)
    metrics = {k: v.detach() for k, v in dict(metrics, loss=total).items()}
    return model, opt_state, metrics


def init_train_state(
    generator: torch.Generator, cfg: ModelConfig, *, device=None
) -> Tuple[mdl.LM, AdamWState]:
    """The model drawn from ``generator`` and its AdamW state in
    ``cfg.opt_state_dtype``."""
    model = mdl.init_params(cfg, generator=generator, device=device)
    state = adamw_init(dict(model.named_parameters()), state_dtype=dtype_of(cfg.opt_state_dtype))
    return model, state


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


class DecodeState(NamedTuple):
    caches: mdl.Caches
    position: int  # next cache write index
    last_token: torch.Tensor  # (B, 1) int64
    # (B, 1, V): the logits that chose last_token; the reference's state
    # keeps none, so a caller that wants the prefill's must run it again
    logits: torch.Tensor
    memory: Optional[torch.Tensor] = None  # the encoder's output (encoder–decoder)


def _serving(model: mdl.LM):
    """``torch.inference_mode()``; ``torch.no_grad()`` for a placed model
    (DTensor's views of parameters made outside inference mode fail in it)."""
    return torch.no_grad() if is_placed(model.embed) else torch.inference_mode()


def serve_prefill(model: mdl.LM, batch: Dict[str, torch.Tensor], max_len: int) -> DecodeState:
    with _serving(model):
        return _prefill(model, batch, max_len)


def _prefill(model: mdl.LM, batch: Dict[str, torch.Tensor], max_len: int) -> DecodeState:
    tokens = batch["tokens"]
    logits, caches, memory = mdl.prefill(model, tokens, max_len,
                                         img_embeds=batch.get("img_embeds"),
                                         enc_frames=batch.get("enc_frames"))
    token = torch.argmax(rows(logits[:, -1]), dim=-1)[:, None]
    seq = tokens.shape[1] + (model.cfg.num_image_tokens if "img_embeds" in batch else 0)
    return DecodeState(caches=caches, position=seq, last_token=token, logits=logits,
                       memory=memory)


def serve_decode_step(model: mdl.LM, state: DecodeState) -> Tuple[DecodeState, torch.Tensor]:
    """Greedy one-token step; returns (new state, logits (B, 1, V))."""
    with _serving(model):
        return _decode_step(model, state)


def _decode_step(model: mdl.LM, state: DecodeState) -> Tuple[DecodeState, torch.Tensor]:
    logits, caches = mdl.decode_step(model, state.last_token, state.caches, state.position,
                                     memory=state.memory)
    token = torch.argmax(rows(logits[:, -1]), dim=-1)[:, None]
    return DecodeState(caches, state.position + 1, token, logits, state.memory), logits
