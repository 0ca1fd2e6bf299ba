"""Deterministic, shardable, resumable synthetic token stream.

The counterpart of ``repro/data/tokens.py``: every batch is a function of
``(seed, shard_index, step)`` alone, so a run keeps nothing but the step to
resume and each EP-MCMC chain reads its own shard. Tokens are
``floor(u⁴·(V − 1))`` of uniform u, the reference's Zipf-ish marginal
(E[token] = (V − 1)/5). The uniforms come from a ``torch.Generator`` on the
CPU seeded by a hash of ``(seed, shard_index, step)``, the same on every
device, then move to the stream's device: they are not JAX's
``fold_in`` draws, so the two packages' streams share the law, not the bits.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import torch

from repro_torch import resolve_device


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
