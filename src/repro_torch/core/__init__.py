"""The paper's maths on tensors: Gaussian algebra, bandwidths, metrics, partitions.

- :mod:`repro_torch.core.subposterior` -- Eq. 2.1 subposterior construction
- :mod:`repro_torch.core.combiners`    -- §3 combiner engine (registry)
- :mod:`repro_torch.core.tree_combine` -- §3.2/§4 O(dTM) pairwise recursion
- :mod:`repro_torch.core.gaussian`     -- Eqs. 3.1/3.2 Gaussian-product algebra
- :mod:`repro_torch.core.bandwidth`    -- h schedules (Alg. 1 line 3, Silverman)
- :mod:`repro_torch.core.metrics`      -- §8 L2 density distance, ESS, MMD
"""

from repro_torch.core import bandwidth as bandwidth  # noqa: F401
from repro_torch.core import combiners as combiners  # noqa: F401
from repro_torch.core import gaussian as gaussian  # noqa: F401
from repro_torch.core import metrics as metrics  # noqa: F401
from repro_torch.core import subposterior as subposterior  # noqa: F401
from repro_torch.core import tree_combine as tree_combine  # noqa: F401
