"""Deterministic, shardable, resumable synthetic token stream.

The counterpart of ``repro/data/tokens.py``: every batch is a function of
``(seed, shard_index, step)`` alone, so a run keeps nothing but the step to
resume and each EP-MCMC chain reads its own shard. Tokens are
``floor(u⁴·(V − 1))`` of uniform u, the reference's Zipf-ish marginal
(E[token] = (V − 1)/5). The uniforms come from a ``torch.Generator`` on the
CPU seeded by a hash of ``(seed, shard_index, step)``, the same on every
device, then move to the stream's device: they are not JAX's
``fold_in`` draws, so the two packages' streams share the law, not the bits.
:func:`make_batch_specs` gives one training batch's stand-ins on the meta
device (shapes and dtypes, no memory), the counterpart of the reference's
``jax.ShapeDtypeStruct`` specs.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import torch

from repro_torch import resolve_device
from repro_torch.models.lm.config import VISION_WIDTH
from repro_torch.models.lm.layers import dtype_of


def seed_of(*parts) -> int:
    """A 63-bit generator seed from a tuple of parts (one batch: ``(seed,
    shard, step)``; the EP-MCMC chains' generators use it too)."""
    digest = hashlib.sha256(":".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class TokenStream:
    """Stateless batch source. ``batch(step) -> {"tokens", "labels"}``,
    each (batch_size, seq_len) int64 on ``device``."""

    def __init__(
        self,
        vocab_size: int,
        batch_size: int,
        seq_len: int,
        *,
        seed: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
        device: str | torch.device | None = None,
    ):
        self.vocab_size = vocab_size
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.device = resolve_device(device)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        gen = torch.Generator().manual_seed(seed_of(self.seed, self.shard_index, int(step)))
        u = torch.rand((self.batch_size, self.seq_len + 1), generator=gen, dtype=torch.float32)
        tokens = (u**4 * (self.vocab_size - 1)).long().to(self.device)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def make_batch_specs(
    cfg, batch_size: int, seq_len: int, *, dtype: torch.dtype = torch.int32
) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins for one training batch of ``cfg``: ``tokens``
    and ``labels`` (batch_size, seq_len) in ``dtype``, and the modality
    stubs' inputs where the config has them, in ``cfg.dtype``:
    ``enc_frames`` (batch_size, ``cfg.encoder_seq``, d) for an
    encoder–decoder, ``img_embeds`` (batch_size, ``cfg.num_image_tokens``,
    ``VISION_WIDTH``) for a vlm; the reference's shapes and dtypes."""
    meta = dict(device="meta")
    specs = {"tokens": torch.empty((batch_size, seq_len), dtype=dtype, **meta),
             "labels": torch.empty((batch_size, seq_len), dtype=dtype, **meta)}
    if cfg.num_encoder_layers:
        specs["enc_frames"] = torch.empty((batch_size, cfg.encoder_seq, cfg.d_model),
                                          dtype=dtype_of(cfg.dtype), **meta)
    if cfg.num_image_tokens:
        specs["img_embeds"] = torch.empty((batch_size, cfg.num_image_tokens, VISION_WIDTH),
                                          dtype=dtype_of(cfg.dtype), **meta)
    return specs
