"""Sharding policy: parameter name → spec → DTensor placements, for every arch and step kind.

The counterpart of ``repro/distributed/sharding.py``. Axes: ``data`` (+
``pod`` multi-pod) = batch / FSDP / EP-MCMC chains; ``model`` = tensor
parallel (heads / d_ff / experts / vocab).

A **spec** is a tuple with one entry per tensor dimension: ``None``
(replicated), an axis name, or a tuple of axis names (that dimension split
over those axes, the first outermost: ``("pod", "data")`` is pod-major, as
``P(("pod", "data"))``). It is ``PartitionSpec``'s content with every
trailing ``None`` written out. :func:`to_placements` turns it into the
``Shard``/``Replicate`` list of a ``DeviceMesh``; :func:`distribute_model`
and :func:`distribute_tree` (the counterparts of ``to_shardings`` and
``jit``'s ``in_shardings``) place tensors by their specs, each rank taking
its own block with no communication (every rank holds the whole tensor, or
a meta stand-in).

The rules are the reference's path rules (``sharding.py:70-158``), copied
rule for rule and matched against the reference's pytree path of each port
parameter (:func:`repro_torch.interop.reference_lm_leaves`):

- embed (V, d) → (model, fsdp?); lm_head (d, V) → (fsdp?, model); img_proj
  (v, d) → (None, model)
- attn / cross w_q/w_k/w_v (d, o) → (fsdp?, model); biases → (model,); w_o
  → (model, fsdp?)
- MLA w_dq, w_dkv → (fsdp?, None); w_uq, w_uk, w_uv → (None, model); w_o →
  (model, fsdp?)
- mlp w_gate/w_up → (fsdp?, model); w_down → (model, fsdp?)
- MoE experts (E, d, f) → (model, fsdp?, None), w_down (E, f, d) → (model,
  None, fsdp?); shared as the mlp's; router replicated
- Mamba w_z/w_x → (fsdp?, model) iff a model shard holds whole heads, else
  (fsdp?, None); w_B/w_C/w_dt → (fsdp?, None); per-head vectors on model
  when heads divide
- norms and everything else replicated

``fsdp?`` is ``data`` when ``cfg.fsdp`` and the dimension divides. Any
axis that does not divide its dimension falls back to replication. The
reference stacks a group's layers on a leading axis and writes a ``None``
for it; the port's per-layer leaves take the same spec without it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import MeshLike, data_axes, mesh_shape
from repro_torch.models.lm.config import ModelConfig

Axis = Optional[Union[str, Tuple[str, ...]]]
Spec = Tuple[Axis, ...]


def _axes(axis: Axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _norm(axis: Axis) -> Axis:
    """One axis name for a 1-tuple, None for an empty one."""
    axes = _axes(axis)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _size(mesh: MeshLike, axis: Axis) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in _axes(axis))


def _div(n: int, mesh: MeshLike, axis: Axis) -> bool:
    return n % _size(mesh, axis) == 0


def _spec(mesh: MeshLike, shape, *axes) -> Spec:
    """A spec with every axis that does not divide its dimension dropped."""
    return tuple(_norm(ax) if ax is not None and _div(dim, mesh, ax) else None
                 for dim, ax in zip(shape, axes)) + (None,) * (len(shape) - len(axes))


def whole_periods(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with a hybrid's depth rounded up to whole periods (the
    reference's layer groups need them; a layer's path does not depend on
    the depth, so a depth cut to fit one card maps as its first layers)."""
    if cfg.hybrid is None or cfg.num_layers % cfg.hybrid.period == 0:
        return cfg
    p = cfg.hybrid.period
    return dataclasses.replace(cfg, num_layers=-(-cfg.num_layers // p) * p)


@functools.lru_cache(maxsize=None)
def reference_paths(cfg: ModelConfig) -> Dict[str, str]:
    """``{port parameter name: the reference's pytree path, "/"-joined}``."""
    from repro_torch.interop import reference_lm_leaves

    return {name: "/".join(path) for name, path, _ in reference_lm_leaves(whole_periods(cfg))}


def path_spec(cfg: ModelConfig, mesh: MeshLike, path: str, shape: Sequence[int]) -> Spec:
    """The reference's ``param_spec`` on a path and a leaf's shape."""
    rank = len(shape)
    fsdp = "data" if cfg.fsdp else None
    m = "model"
    shape_of = mesh_shape(mesh)

    def lead(n):  # None for leading stack dims (a chain axis here)
        return (None,) * n

    if path.endswith("embed"):
        return _spec(mesh, shape, m, fsdp)
    if path.endswith("lm_head"):
        return _spec(mesh, shape, fsdp, m)
    if path.endswith("img_proj"):
        return _spec(mesh, shape, None, m)

    if "/moe/" in path or path.startswith("moe/"):
        if "router" in path:
            return lead(rank)
        if "experts" in path:
            if path.endswith("w_down"):
                return _spec(mesh, shape, *lead(rank - 3), m, None, fsdp)
            return _spec(mesh, shape, *lead(rank - 3), m, fsdp, None)
        if "shared" in path:
            if path.endswith("w_down"):
                return _spec(mesh, shape, *lead(rank - 2), m, fsdp)
            return _spec(mesh, shape, *lead(rank - 2), fsdp, m)
        return lead(rank)

    if "/mamba/" in path or path.startswith("mamba/"):
        di = cfg.ssm.expand * cfg.d_model
        heads_ok = di % shape_of[m] == 0 and (di // shape_of[m]) % cfg.ssm.head_dim == 0
        inner = m if heads_ok else None
        if path.endswith(("w_z", "w_x")):
            return _spec(mesh, shape, *lead(rank - 2), fsdp, inner)
        if path.endswith("w_out"):
            return _spec(mesh, shape, *lead(rank - 2), inner, fsdp)
        if path.endswith(("conv_x", "conv_bias_x", "norm")):
            return _spec(mesh, shape, *lead(rank - 1), inner)
        if path.endswith(("w_B", "w_C", "w_dt")):
            return _spec(mesh, shape, *lead(rank - 2), fsdp, None)
        if path.endswith(("A_log", "dt_bias", "D")) and heads_ok:
            return _spec(mesh, shape, *lead(rank - 1), m)
        return lead(rank)

    if any(s in path for s in ("/attn/", "/cross/")):
        if path.endswith(("w_q/w", "w_k/w", "w_v/w")):
            return _spec(mesh, shape, *lead(rank - 2), fsdp, m)
        if path.endswith(("w_q/b", "w_k/b", "w_v/b")):
            return _spec(mesh, shape, *lead(rank - 1), m)
        if path.endswith("w_o/w"):
            return _spec(mesh, shape, *lead(rank - 2), m, fsdp)
        if path.endswith(("w_dq", "w_dkv")):
            return _spec(mesh, shape, *lead(rank - 2), fsdp, None)
        if path.endswith(("w_uq", "w_uk", "w_uv")):
            return _spec(mesh, shape, *lead(rank - 2), None, m)
        if path.endswith("w_o"):
            return _spec(mesh, shape, *lead(rank - 2), m, fsdp)
        return lead(rank)

    if "/mlp/" in path or path.startswith("mlp/"):
        if path.endswith("w_down"):
            return _spec(mesh, shape, *lead(rank - 2), m, fsdp)
        return _spec(mesh, shape, *lead(rank - 2), fsdp, m)

    return lead(rank)


def param_spec(cfg: ModelConfig, mesh: MeshLike, name: str, shape: Sequence[int]) -> Spec:
    """The spec of port parameter ``name`` (``blocks.3.attn.w_q``) of ``shape``."""
    return path_spec(cfg, mesh, reference_paths(cfg)[name], tuple(shape))


def param_specs(cfg: ModelConfig, mesh: MeshLike, params) -> Dict[str, Spec]:
    """``{name: spec}`` of a model's parameters (an ``nn.Module`` or a dict)."""
    items = params.named_parameters() if hasattr(params, "named_parameters") else params.items()
    return {name: param_spec(cfg, mesh, name, p.shape) for name, p in items}


def opt_specs(cfg: ModelConfig, mesh: MeshLike, opt_state, pspecs: Dict[str, Spec]):
    """AdamW state: μ and ν take their parameter's spec; the count is replicated."""
    return type(opt_state)(mu=dict(pspecs), nu=dict(pspecs), count=())


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------


def batch_axes(mesh: MeshLike) -> Tuple[str, ...]:
    return data_axes(mesh)


def batch_specs(cfg: ModelConfig, mesh: MeshLike, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, Spec]:
    """Every batch leaf's leading (batch) dimension over the data axes when
    it divides, the rest replicated."""
    dp = batch_axes(mesh)

    def spec(leaf):
        lead = _norm(dp) if _div(leaf.shape[0], mesh, dp) else None
        return (lead,) + (None,) * (leaf.dim() - 1)

    return {k: spec(v) for k, v in batch.items()}


def _cache_spec(mesh: MeshLike, path: str, shape: Sequence[int]) -> Spec:
    """The reference's ``cache_specs`` rule for one cache leaf."""
    dp = batch_axes(mesh)
    rank = len(shape)
    b_ax = lambda b: _norm(dp) if _div(b, mesh, dp) else None  # noqa: E731

    def seq_ax(b, s):
        ax = ("data", "model") if b is None and _div(s, mesh, ("data", "model")) else "model"
        return ax if _div(s, mesh, ax) else None

    if path.endswith(("/k", "/v")) and rank >= 4:
        nl = rank - 4
        b, s, k, _ = shape[nl:]
        if _div(k, mesh, "model"):
            return (None,) * nl + (b_ax(b), None, "model", None)
        return (None,) * nl + (b_ax(b), seq_ax(b_ax(b), s), None, None)
    if path.endswith(("c_kv", "k_rope")) and rank >= 3:
        nl = rank - 3
        b, s, _ = shape[nl:]
        return (None,) * nl + (b_ax(b), seq_ax(b_ax(b), s), None)
    if path.endswith("/h") and rank >= 4:
        nl = rank - 4
        b, h = shape[nl:nl + 2]
        return (None,) * nl + (b_ax(b), "model" if h % mesh_shape(mesh)["model"] == 0 else None,
                               None, None)
    if "/conv/" in path and rank >= 3:
        nl = rank - 3
        return (None,) * nl + (b_ax(shape[nl]), None, None)
    if not rank:
        return ()
    return (b_ax(shape[0]) if shape else None,) + (None,) * (rank - 1)


def cache_specs(cfg: ModelConfig, mesh: MeshLike, caches) -> List[Any]:
    """Decode caches (``models/lm/model.py::init_caches``: one per layer, a
    k/v dict, MLA's latents, or an ``SSMCache``), each leaf specced as the
    reference's ``cache_specs`` does: GQA k/v batch over the data axes when
    it divides, K over model when it divides, else the sequence over model
    (over data and model when the batch cannot shard: ``long_500k``); MLA's
    latents the sequence over model; Mamba's h its heads over model."""
    from repro_torch.interop import reference_cache_leaves

    per_layer: List[Dict[str, Spec]] = [{} for _ in caches]
    for layer, key, path, _ in reference_cache_leaves(whole_periods(cfg)):
        if layer >= len(caches):
            break
        cache = caches[layer]
        leaf = cache[key] if isinstance(cache, dict) else getattr(cache, key)
        per_layer[layer][key] = _cache_spec(mesh, "/".join(path), tuple(leaf.shape))
    return [specs if isinstance(cache, dict) else type(cache)(**specs)
            for cache, specs in zip(caches, per_layer)]


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------


def to_placements(mesh, spec: Spec):
    """The ``Shard``/``Replicate`` list of ``spec`` on ``mesh``: mesh axis a
    shards the tensor dimension whose entry names a. An axis of size 1
    splits nothing and is written ``Replicate`` (DTensor's views refuse a
    sharded dimension of size 1: a batch of one on the host mesh)."""
    from torch.distributed.tensor import Replicate, Shard

    where = {a: dim for dim, ax in enumerate(spec) for a in _axes(ax)}
    return [Shard(where[a]) if a in where and mesh.size(i) > 1 else Replicate()
            for i, a in enumerate(mesh.mesh_dim_names)]


def local_block(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``placements`` (mesh
    dimensions in order, the first outermost): a view, no communication."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            t = t.narrow(p.dim, coord[i] * (t.shape[p.dim] // n), t.shape[p.dim] // n)
    return t


def place(t: torch.Tensor, mesh, spec: Spec):
    """``t`` (whole, on every rank) as a DTensor placed by ``spec``."""
    from torch.distributed.tensor import DTensor

    placements = to_placements(mesh, spec)
    local = local_block(t, mesh, placements).contiguous()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        local = local.clone()  # the block alone, not a view keeping the whole tensor alive
    stride = torch.empty(t.shape, device="meta").stride()  # the whole tensor's, contiguous
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=t.shape,
                              stride=stride)


def distribute_model(model: torch.nn.Module, mesh, specs: Dict[str, Spec]) -> torch.nn.Module:
    """Every parameter of ``model`` replaced, in place, by its DTensor placed by
    ``specs[name]`` (trainable as before); returns the model."""
    from torch import nn

    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, nn.Parameter(place(p.detach(), mesh, specs[name]),
                                        requires_grad=p.requires_grad))
    return model


def distribute_tree(tree, mesh, specs):
    """A dict / list / NamedTuple of tensors placed leaf by leaf by the same
    nesting of specs; leaves that are not tensors pass through."""
    if isinstance(tree, torch.Tensor):
        return place(tree, mesh, specs)
    if isinstance(tree, dict):
        return {k: distribute_tree(v, mesh, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute_tree(v, mesh, s) for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, mesh, s) for v, s in zip(tree, specs))
    return tree
