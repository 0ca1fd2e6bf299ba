"""Combiners of the port behind one registry (batch face).

Importing this package registers the same eleven canonical names (and
aliases) as :mod:`repro.core.combiners`: ``parametric`` (§3.1), the IMG family
``nonparametric``, ``semiparametric``, ``semiparametric_w`` (§3.2–3.3), the
baselines ``subpost_average``, ``consensus``, ``pool`` (§7–8), the
KDE-reweighting ``importance_pool`` and ``weierstrass``, ``rpt`` and the batch
face of ``online`` (§4). See :mod:`repro_torch.core.combiners.api` for the
calling convention.
"""

from repro_torch.core.combiners.api import (  # noqa: F401
    CombineResult,
    available_combiners,
    canonical_combiners,
    categorical,
    counts_or_full,
    filter_options,
    get_combiner,
    gumbel,
    log_weight_bruteforce,
    ragged_gather,
    register,
    resolve_schedule,
    valid_masks,
)
from repro_torch.core.combiners.baselines import (  # noqa: F401
    consensus_weighted,
    pool,
    subpost_average,
)
from repro_torch.core.combiners import parametric as parametric  # noqa: F401
from repro_torch.core.combiners import img as img  # noqa: F401
from repro_torch.core.combiners.density import (  # noqa: F401
    machine_kde_logpdfs,
    machine_kde_scores,
    masked_silverman,
)
from repro_torch.core.combiners.importance_pool import importance_pool  # noqa: F401
from repro_torch.core.combiners.online import (  # noqa: F401
    OnlineMoments,
    online,
    online_init,
    online_product,
    online_update,
    online_update_chunk,
)
from repro_torch.core.combiners.rpt import rpt  # noqa: F401
from repro_torch.core.combiners.weierstrass import weierstrass  # noqa: F401
