"""Carry the reference package's dataset across to the port.

The system has no weights: what both packages must share to be compared is
the dataset. :func:`from_reference_data` takes ``repro``'s generated data and
generating parameters, passed as numpy arrays, and returns them as the
port's float32 tensors in the form ``generate_data`` returns, which
``Pipeline(spec, data=...)`` accepts.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


def from_reference_data(
    data: Dict[str, np.ndarray],
    theta_true: np.ndarray,
    *,
    device: str | torch.device | None = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``({key: (N, ...) float32}, theta_true float32)`` on ``device``."""
    device = resolve_device(device)

    def put(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    return {k: put(v) for k, v in data.items()}, put(theta_true)
