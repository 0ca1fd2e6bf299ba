"""Fused Welford/Chan-merge streaming-moments update (the ``online`` scan face)."""

from repro_torch.kernels.online_update.ops import online_moments_update
from repro_torch.kernels.online_update.ref import online_moments_update_ref

__all__ = ["online_moments_update", "online_moments_update_ref"]
