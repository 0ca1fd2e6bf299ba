"""Atomic step checkpoints of tensor trees (numpy files, no JAX)."""

from repro_torch.checkpoint.checkpointer import latest_step, restore, save

__all__ = ["save", "restore", "latest_step"]
