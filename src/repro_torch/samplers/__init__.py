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
from repro_torch.samplers.base import (  # noqa: F401
    MCMCKernel,
    StepInfo,
    chain_collect,
    chain_setup,
    run_chain,
    run_chains,
)
from repro_torch.samplers.gibbs import gibbs_kernel, mh_within_gibbs_update  # noqa: F401
from repro_torch.samplers.hmc import hmc_kernel, window_adaptation  # noqa: F401
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
from repro_torch.samplers.rwmh import rwmh_kernel  # noqa: F401
from repro_torch.samplers.sgld import sgld_kernel  # noqa: F401
