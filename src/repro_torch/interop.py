"""Carry the reference package's dataset and LM weights across to the port.

The MCMC pipeline has no weights: what both packages must share to be
compared is the dataset. :func:`from_reference_data` takes ``repro``'s
generated data and generating parameters, passed as numpy arrays, and
returns them as the port's float32 tensors in the form ``generate_data``
returns, which ``Pipeline(spec, data=...)`` accepts.
:func:`from_reference_lm_params` does the same for the LM sidecar's weights.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


def from_reference_data(
    data: Dict[str, np.ndarray],
    theta_true: np.ndarray,
    *,
    device: str | torch.device | None = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``({key: (N, ...) float32}, theta_true float32)`` on ``device``."""
    device = resolve_device(device)

    def put(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    return {k: put(v) for k, v in data.items()}, put(theta_true)


def _weight(a: Any) -> torch.Tensor:
    """A numpy array as a tensor (a copy); ``ml_dtypes.bfloat16``, which
    torch refuses, goes through float32 (exact both ways)."""
    a = np.asarray(a)
    if a.dtype not in (np.float32, np.float64):
        a = a.astype(np.float32)
    return torch.tensor(a)


def from_reference_lm_params(
    params: Dict[str, Any],
    cfg,
    *,
    device: str | torch.device | None = None,
):
    """``repro``'s LM ``init_params`` pytree (numpy leaves) as the port's model.

    The dense family only. The reference stacks the layers of a group on a
    leading axis (``params["g0"]["l0"]["attn"]["w_q"]["w"]`` is (L, d, H·hd)
    for L > 1, see ``layer_groups``); each layer's slice goes to
    ``blocks[i]``. Weights keep the reference's ``x @ w`` layout, (d_in,
    d_out), so nothing is transposed: ``w_q/w_k/w_v/w_o`` (and biases
    ``b_q/b_k/b_v``), ``w_gate/w_up/w_down``, the norms' ``scale``, ``embed``
    (V, d) and, when untied, ``lm_head`` (d, V). Every tensor is cast to
    ``cfg.param_dtype``; the numbers are the reference's.
    """
    from repro_torch.models.lm import model as mdl

    device = resolve_device(device)
    model = mdl.init_params(cfg, device=device)
    targets = {"embed": params["embed"], "final_norm.scale": params["final_norm"]["scale"]}
    if not cfg.tie_embeddings:
        targets["lm_head"] = params["lm_head"]
    layer = 0
    for gi, group in enumerate(mdl.layer_groups(cfg)):
        for r in range(group.repeat):
            for li in range(len(group.specs)):
                p = params[f"g{gi}"][f"l{li}"]

                def take(a):
                    return np.asarray(a)[r] if group.repeat > 1 else a

                prefix = f"blocks.{layer}."
                for name in ("ln1", "ln2"):
                    targets[prefix + f"{name}.scale"] = take(p[name]["scale"])
                for w in ("w_q", "w_k", "w_v", "w_o"):
                    targets[prefix + f"attn.{w}"] = take(p["attn"][w]["w"])
                    if "b" in p["attn"][w]:
                        targets[prefix + f"attn.b_{w[-1]}"] = take(p["attn"][w]["b"])
                for w in ("w_gate", "w_up", "w_down"):
                    targets[prefix + f"mlp.{w}"] = take(p["mlp"][w])
                layer += 1
    state = model.state_dict()
    if set(targets) != set(state):
        raise ValueError(
            f"weights do not map: missing {sorted(set(state) - set(targets))}, "
            f"unexpected {sorted(set(targets) - set(state))}"
        )
    with torch.no_grad():
        for name, a in targets.items():
            w = _weight(a)
            if tuple(w.shape) != tuple(state[name].shape):
                raise ValueError(f"{name}: reference {tuple(w.shape)}, port {tuple(state[name].shape)}")
            state[name].copy_(w.to(state[name].dtype))
    return model
