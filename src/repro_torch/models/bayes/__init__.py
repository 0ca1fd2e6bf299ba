"""Paper §8 experiment models behind the ``BayesModel`` registry.

Importing this package registers every model of ``repro``: ``logreg`` and
``covtype`` (§8.1), ``gmm`` (§8.2), ``poisson`` (§8.3) and ``linear``, the
closed-form oracle.
"""

from repro_torch.models.bayes import registry as registry  # noqa: F401
from repro_torch.models.bayes.registry import (  # noqa: F401
    BayesModel,
    available_models,
    canonical_models,
    get_model,
    register_model,
)

from repro_torch.models.bayes import gmm as gmm  # noqa: F401
from repro_torch.models.bayes import linear_gaussian as linear_gaussian  # noqa: F401
from repro_torch.models.bayes import logistic_regression as logistic_regression  # noqa: F401
from repro_torch.models.bayes import poisson_gamma as poisson_gamma  # noqa: F401
