from repro_torch.kernels.logreg_loglik.ops import (
    LogregLogLik,
    logreg_loglik,
    logreg_loglik_grad,
)
from repro_torch.kernels.logreg_loglik.ref import logreg_loglik_grad_ref

__all__ = ["LogregLogLik", "logreg_loglik", "logreg_loglik_grad", "logreg_loglik_grad_ref"]
