"""Paper §8 experiment models behind the ``BayesModel`` registry.

Importing this package registers the ported models (``logreg``, ``covtype``).
"""

from repro_torch.models.bayes import registry as registry  # noqa: F401
from repro_torch.models.bayes.registry import (  # noqa: F401
    BayesModel,
    available_models,
    canonical_models,
    get_model,
    register_model,
)

from repro_torch.models.bayes import logistic_regression as logistic_regression  # noqa: F401
