from repro_torch.kernels.kde_density.ops import kde_log_density, machine_kde_log_density
from repro_torch.kernels.kde_density.ref import (
    kde_log_density_ref,
    machine_kde_log_density_ref,
)

__all__ = [
    "kde_log_density",
    "kde_log_density_ref",
    "machine_kde_log_density",
    "machine_kde_log_density_ref",
]
