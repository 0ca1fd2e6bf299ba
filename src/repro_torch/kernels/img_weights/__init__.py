from repro_torch.kernels.img_weights.ops import img_log_weights
from repro_torch.kernels.img_weights.ref import img_log_weights_ref

__all__ = ["img_log_weights", "img_log_weights_ref"]
