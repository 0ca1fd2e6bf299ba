"""Placed stand-ins for every (arch × shape) cell, on the meta device.

The counterpart of ``repro/launch/input_specs.py``.
``build_cell(arch, shape_name, mesh)`` returns what the dry run (and a real
launch) needs to run one cell's step under placements:

- ``fn``: the step (``steps.train_step``, ``steps.serve_prefill`` or
  ``steps.serve_decode_step``, the config closed over);
- ``args``: the step's arguments, each tensor a DTensor on ``mesh`` placed
  by the sharding rules (``distributed/sharding.py``); on the meta device
  unless ``device`` is given, so nothing is allocated;
- ``in_specs``: the specs they were placed by (parameters; AdamW state;
  batch, or the decode state's caches);
- ``donate``: the arguments the step updates in place (the reference's
  donated buffers: parameters and optimizer state in training, the decode
  state in serving).

Shape semantics (the reference's): ``train_4k``/``prefill_32k`` run the
batch through ``train_step``/``serve_prefill`` at (global_batch, seq_len);
``decode_32k``/``long_500k`` run ``serve_decode_step``: one new token
against a cache of seq_len positions, written at its last position.
``layers`` cuts the depth and ``batch`` the global batch (0 keeps the
config's); every width stays.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.data.tokens import make_batch_specs
from repro_torch.distributed import sharding as shd
from repro_torch.models.lm import model as mdl
from repro_torch.models.lm import steps
from repro_torch.models.lm.config import ModelConfig
from repro_torch.models.lm.layers import dtype_of
from repro_torch.optim.adamw import adamw_init


class CellPlan(NamedTuple):
    arch: str
    shape: ShapeSpec
    cfg: ModelConfig
    fn: Any
    args: Tuple[Any, ...]
    in_specs: Tuple[Any, ...]
    donate: Tuple[int, ...]


def shape_by_name(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; known: {[s.name for s in SHAPES]}")


def param_specs_only(cfg: ModelConfig, device="meta") -> mdl.LM:
    """The model with zero weights: shapes and dtypes, on the meta device by default."""
    return mdl.init_params(cfg, device=device)


def train_state_specs(cfg: ModelConfig, device="meta") -> Tuple[mdl.LM, Any]:
    """(model, AdamW state), as ``steps.init_train_state`` builds them."""
    model = param_specs_only(cfg, device)
    return model, adamw_init(dict(model.named_parameters()),
                             state_dtype=dtype_of(cfg.opt_state_dtype))


def _batch(cfg: ModelConfig, batch: int, seq: int, *, labels: bool, device) -> Dict:
    specs = make_batch_specs(cfg, batch, seq)
    if not labels:
        specs.pop("labels", None)
    return {k: torch.empty(v.shape, dtype=v.dtype, device=device) for k, v in specs.items()}


def _decode_state(cfg: ModelConfig, batch: int, seq_len: int, device) -> steps.DecodeState:
    dtype = dtype_of(cfg.dtype)
    caches = mdl.init_caches(cfg, batch, seq_len, dtype, device=device)
    memory = None
    if cfg.num_encoder_layers:
        memory = torch.empty((batch, cfg.encoder_seq, cfg.d_model), dtype=dtype, device=device)
    return steps.DecodeState(caches=caches, position=seq_len - 1,
                             last_token=torch.zeros((batch, 1), dtype=torch.int64,
                                                    device=device),
                             logits=None, memory=memory)


def _decode_state_specs(cfg: ModelConfig, mesh, state: steps.DecodeState) -> steps.DecodeState:
    dp = shd.batch_axes(mesh)
    b = state.last_token.shape[0]
    b_ax = shd._norm(dp) if shd._div(b, mesh, dp) else None
    return steps.DecodeState(caches=shd.cache_specs(cfg, mesh, state.caches), position=None,
                             last_token=(b_ax, None), logits=None,
                             memory=None if state.memory is None else (b_ax, None, None))


def input_specs(arch: str, shape_name: str, device="meta"):
    """Stand-ins for every model input of this cell (unplaced): the batch, or
    the decode state."""
    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    if shape.kind == "decode":
        return _decode_state(cfg, shape.global_batch, shape.seq_len, device)
    return _batch(cfg, shape.global_batch, shape.seq_len, labels=shape.kind == "train",
                  device=device)


def build_cell(arch: str, shape_name: str, mesh, *, layers: int = 0, batch: int = 0,
               device="meta") -> CellPlan:
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    shape = shape_by_name(shape_name)
    b, s = batch or shape.global_batch, shape.seq_len

    model = param_specs_only(cfg, device)
    p_spec = shd.param_specs(cfg, mesh, model)
    shd.distribute_model(model, mesh, p_spec)
    if shape.kind == "train":  # AdamW's moments placed as their parameters
        opt = adamw_init(dict(model.named_parameters()),
                         state_dtype=dtype_of(cfg.opt_state_dtype))
        data = _batch(cfg, b, s, labels=True, device=device)
        b_spec = shd.batch_specs(cfg, mesh, data)
        return CellPlan(arch, shape, cfg, functools.partial(_train_fn, cfg=cfg),
                        (model, opt, shd.distribute_tree(data, mesh, b_spec)),
                        (p_spec, shd.opt_specs(cfg, mesh, opt, p_spec), b_spec), (0, 1))
    if shape.kind == "prefill":
        data = _batch(cfg, b, s, labels=False, device=device)
        b_spec = shd.batch_specs(cfg, mesh, data)
        # the vlm's image prefix is put before the prompt: its caches hold it too
        fn = functools.partial(_prefill_fn, max_len=s + cfg.num_image_tokens)
        return CellPlan(arch, shape, cfg, fn, (model, shd.distribute_tree(data, mesh, b_spec)),
                        (p_spec, b_spec), ())

    state = _decode_state(cfg, b, s, device)
    s_spec = _decode_state_specs(cfg, mesh, state)
    placed = shd.distribute_tree(state, mesh, s_spec)
    return CellPlan(arch, shape, cfg, _decode_fn, (model, placed), (p_spec, s_spec), (1,))


# module-level step wrappers (picklable, as the reference's)


def _train_fn(model, opt_state, batch, *, cfg):
    return steps.train_step(model, opt_state, batch, cfg)


def _prefill_fn(model, batch, *, max_len):
    return steps.serve_prefill(model, batch, max_len)


def _decode_fn(model, state):
    return steps.serve_decode_step(model, state)
