"""Combiners of the port behind one registry (batch and streaming faces).

Importing this package registers the same eleven canonical names (and
aliases) as :mod:`repro.core.combiners`: ``parametric`` (§3.1), the IMG family
``nonparametric``, ``semiparametric``, ``semiparametric_w`` (§3.2–3.3), the
baselines ``subpost_average``, ``consensus``, ``pool`` (§7–8), the
KDE-reweighting ``importance_pool`` and ``weierstrass``, ``rpt`` and
``online`` (§4). See :mod:`repro_torch.core.combiners.api` for the calling
convention. Every name also resolves to a streaming face
(:func:`get_streaming_combiner`: native for ``parametric``, ``pool``,
``subpost_average``, ``nonparametric`` and ``online``, the exact buffered
fallback for the rest) and to a scan face for the fused streaming path
(:func:`get_scan_face`; ``online``'s folds run the ``online_update`` kernel).
"""

from repro_torch.core.combiners.api import (  # noqa: F401
    BUFFER_SCAN,
    BufferState,
    CombineResult,
    EstimateUnavailable,
    ScanStreamingFace,
    StreamingCombiner,
    available_combiners,
    buffer_append,
    buffer_batch_args,
    buffer_init,
    buffered_streaming,
    canonical_combiners,
    categorical,
    counts_or_full,
    filter_options,
    get_combiner,
    get_scan_face,
    get_streaming_combiner,
    gumbel,
    log_weight_bruteforce,
    ragged_gather,
    register,
    register_scan_face,
    register_streaming,
    resolve_schedule,
    streaming_combiners,
    streaming_estimate,
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
    online_update_chunk_kernel,
)
from repro_torch.core.combiners.rpt import rpt  # noqa: F401
from repro_torch.core.combiners.weierstrass import weierstrass  # noqa: F401

# native streaming implementations attach to the names registered above, so
# this import stays last
from repro_torch.core.combiners import streaming as _streaming  # noqa: F401, E402
