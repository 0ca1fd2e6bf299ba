"""The LM sidecar: config, layers, attention, MoE, Mamba-2, model, loss, train and serve steps."""

from repro_torch.models.lm.config import (  # noqa: F401
    HybridConfig,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
    reduced,
)
from repro_torch.models.lm import model as model  # noqa: F401
from repro_torch.models.lm import steps as steps  # noqa: F401
