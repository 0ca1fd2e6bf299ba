"""MCMC samplers of the port: protocol, drivers, adaptation, registry.

See :mod:`repro_torch.samplers.registry` for the registry convention and
:mod:`repro_torch.samplers.base` for the batched chain drivers.
"""

from repro_torch.samplers.adaptation import (  # noqa: F401
    DualAveragingState,
    da_init,
    da_update,
    warmup_chain,
)
from repro_torch.samplers.base import MCMCKernel, StepInfo, run_chain, run_chains  # noqa: F401
from repro_torch.samplers.mala import mala_kernel  # noqa: F401
from repro_torch.samplers.registry import (  # noqa: F401
    SamplerSpec,
    available_samplers,
    canonical_samplers,
    filter_options,
    get_sampler,
    register_sampler,
    sampler_spec,
)
