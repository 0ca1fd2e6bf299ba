"""repro_torch.api — the experiment layer of the port.

:class:`RunSpec` (same fields and ``spec_id`` as ``repro``'s) and
:class:`Pipeline` (partition → sample → groundtruth → combine → score)::

    from repro_torch.api import Pipeline, RunSpec

    spec = RunSpec(model="logreg", M=10, T=1200,
                   combiner=("parametric", "nonparametric"),
                   combiner_options={"weight_eval": "kernel", "n_batch": 16})
    print(Pipeline(spec).run().table())          # on the card
    print(Pipeline(spec, device="cpu").run().table())
"""

from repro_torch.api.pipeline import (  # noqa: F401
    LOG_L2_DIM,
    Pipeline,
    Scoreboard,
    ShardedData,
    SubposteriorDraws,
    combine_spec_draws,
)
from repro_torch.api.spec import RunSpec  # noqa: F401
