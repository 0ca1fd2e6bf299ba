"""repro_torch — the PyTorch/CUDA port of :mod:`repro` for an NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors it module
for module (``repro/core/combiners/img.py`` ↔
``repro_torch/core/combiners/img.py``) and imports neither JAX nor anything
of ``repro``. The TPU kernels on its path are hand-written CUDA kernels under
:mod:`repro_torch.kernels`.

Device rule: every entry point (``Pipeline``, ``sample_subposteriors``, the
combiners, the kernel wrappers) runs on ``cuda`` unless the caller passes
``device="cpu"``; with no card visible and no explicit CPU device it raises
(:func:`resolve_device`) rather than continue on the CPU.

TF32 is switched off for cuBLAS and cuDNN at import, for the whole process:
the Gram einsum of the IMG sweep and the cross terms of ``core/metrics.py``
lose digits under TF32 and would drift from the float32 reference.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` unless told otherwise; raises when CUDA is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA card and none is visible; pass "
            "device='cpu' to run the plain PyTorch path on the CPU"
        )
    return device
