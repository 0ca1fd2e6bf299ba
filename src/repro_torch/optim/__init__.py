"""Optimizers of the LM's training path: AdamW, and the reference's low-rank
gradient compression with error feedback (``compression.py``)."""

from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.compression import (  # noqa: F401
    LowRankPair,
    compress_lowrank,
    decompress_lowrank,
    error_feedback_update,
    init_error_feedback,
)
