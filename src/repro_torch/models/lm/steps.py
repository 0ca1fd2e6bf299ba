"""Serving step functions of the LM sidecar: prefill, then greedy decode.

The counterpart of the serving half of ``repro/models/lm/steps.py``
(``serve_prefill`` :82, ``serve_decode_step`` :108), each run under
``torch.inference_mode()``. ``train_step`` and ``loss_fn`` come with the
training slice (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.models.lm import model as mdl


class DecodeState(NamedTuple):
    caches: mdl.Caches
    position: int  # next cache write index
    last_token: torch.Tensor  # (B, 1) int64
    # (B, 1, V): the logits that chose last_token; the reference's state
    # keeps none, so a caller that wants the prefill's must run it again
    logits: torch.Tensor


@torch.inference_mode()
def serve_prefill(model: mdl.LM, batch: Dict[str, torch.Tensor], max_len: int) -> DecodeState:
    tokens = batch["tokens"]
    logits, caches = mdl.prefill(model, tokens, max_len)
    token = torch.argmax(logits[:, -1], dim=-1)[:, None]
    return DecodeState(caches=caches, position=tokens.shape[1], last_token=token, logits=logits)


@torch.inference_mode()
def serve_decode_step(model: mdl.LM, state: DecodeState) -> Tuple[DecodeState, torch.Tensor]:
    """Greedy one-token step; returns (new state, logits (B, 1, V))."""
    logits, caches = mdl.decode_step(model, state.last_token, state.caches, state.position)
    token = torch.argmax(logits[:, -1], dim=-1)[:, None]
    return DecodeState(caches, state.position + 1, token, logits), logits
