"""Combiners of the port behind one registry (batch face).

Importing this package registers ``parametric`` (§3.1) and the IMG family
``nonparametric``, ``semiparametric``, ``semiparametric_w`` (§3.2–3.3).
See :mod:`repro_torch.core.combiners.api` for the calling convention.
"""

from repro_torch.core.combiners.api import (  # noqa: F401
    CombineResult,
    available_combiners,
    canonical_combiners,
    counts_or_full,
    filter_options,
    get_combiner,
    log_weight_bruteforce,
    register,
    resolve_schedule,
    valid_masks,
)
from repro_torch.core.combiners import parametric as parametric  # noqa: F401
from repro_torch.core.combiners import img as img  # noqa: F401
