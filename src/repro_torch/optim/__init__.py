"""Optimizers of the LM's training path: AdamW (``compression.py``, the
reference's low-rank gradient compression, is ROADMAP Queue 1 item 11.8)."""

from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update  # noqa: F401
