"""TF32 rounding and the hi/lo split of the card's 3×TF32 products.

``csrc/tf32x3.cuh`` rounds float32 to TF32 with ``cvt.rna.tf32.f32`` and
splits each operand into TF32 halves; the plain models of the kernels that
use it (``kde_density/ref.py``, ``flash_attention/ref.py``) take the same
rounding and split from here.
"""

from __future__ import annotations

from typing import Tuple

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 stored mantissa bits), to nearest with
    ties away from zero, as the card's ``cvt.rna.tf32.f32``: on the int32 view,
    add half of the 13 dropped bits' range and clear them (finite values)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)``, both TF32, with hi + lo = x to about 2^-22 |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x.to(torch.float32) - hi)
