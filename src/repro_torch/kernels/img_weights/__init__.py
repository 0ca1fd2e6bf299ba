from repro_torch.kernels.img_weights.ops import (
    StateTerm,
    check_sweep_fits,
    img_log_weights,
    img_sweep,
    sweep_agreement,
    sweep_smem_bytes,
)
from repro_torch.kernels.img_weights.ref import ImgSweep, img_log_weights_ref, img_sweep_ref

__all__ = [
    "ImgSweep",
    "StateTerm",
    "check_sweep_fits",
    "img_log_weights",
    "img_log_weights_ref",
    "img_sweep",
    "img_sweep_ref",
    "sweep_agreement",
    "sweep_smem_bytes",
]
