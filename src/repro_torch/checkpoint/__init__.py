"""Atomic step checkpoints of tensor trees (numpy files, no JAX): sync and
double-buffered async writes, and the elastic chain-count restore."""

from repro_torch.checkpoint.checkpointer import (
    Checkpointer,
    latest_step,
    restore,
    restore_elastic_chains,
    save,
)

__all__ = ["Checkpointer", "save", "restore", "restore_elastic_chains", "latest_step"]
