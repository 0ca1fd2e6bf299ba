"""Carry the reference package's dataset and LM weights across to the port.

The MCMC pipeline has no weights: what both packages must share to be
compared is the dataset. :func:`from_reference_data` takes ``repro``'s
generated data and generating parameters, passed as numpy arrays, and
returns them as the port's float32 tensors in the form ``generate_data``
returns, which ``Pipeline(spec, data=...)`` accepts.
:func:`from_reference_lm_params` does the same for the LM's weights,
:func:`from_reference_epmcmc_state` for the reference's stacked EP-MCMC
training state, and :func:`to_reference_lm_grads` takes the port's
gradients back to the reference's pytree, for comparison leaf by leaf.
:func:`from_reference_lm_params_placed` places the carried model on a
``DeviceMesh`` by the sharding rules, and :func:`reference_cache_leaves`
maps the port's decode caches onto the reference's ``init_caches`` tree.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

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


MAMBA_LEAVES = ("w_z", "w_x", "w_B", "w_C", "w_dt", "conv_x", "conv_B", "conv_C", "conv_bias_x",
                "conv_bias_B", "conv_bias_C", "A_log", "dt_bias", "D", "norm", "w_out")


def _gqa_leaves(cfg, prefix: str, base: Tuple[str, ...], idx: Optional[int]):
    """A GQA (or cross-attention) module's weights, each under a ``"w"`` (and
    bias ``"b"``) level in the reference."""
    out = [(prefix + w, base + (w, "w"), idx) for w in ("w_q", "w_k", "w_v", "w_o")]
    if cfg.qkv_bias:
        out += [(prefix + f"b_{w[-1]}", base + (w, "b"), idx) for w in ("w_q", "w_k", "w_v")]
    return out


def _block_leaves(cfg, spec, prefix: str, base: Tuple[str, ...], idx: Optional[int]):
    """One block's leaves in the port's order: ln1, the mixer, the
    cross-attention and ``ln_cross`` (``spec.cross``), then ``ln2`` and the
    FFN unless ``spec.ffn`` is ``"none"``."""
    out = [(prefix + "ln1.scale", base + ("ln1", "scale"), idx)]
    if spec.mixer == "mamba":  # bare arrays
        out += [(prefix + f"mamba.{w}", base + ("mamba", w), idx) for w in MAMBA_LEAVES]
    elif spec.mixer == "mla":  # bare arrays, no "w" level
        q = ("w_dq", "q_norm", "w_uq") if cfg.mla.q_lora_rank else ("w_q",)
        out += [(prefix + f"attn.{w}", base + ("attn", w), idx)
                for w in q + ("w_dkv", "kv_norm", "w_uk", "w_uv", "w_o")]
    else:
        out += _gqa_leaves(cfg, prefix + "attn.", base + ("attn",), idx)
    if spec.cross:
        out.append((prefix + "ln_cross.scale", base + ("ln_cross", "scale"), idx))
        out += _gqa_leaves(cfg, prefix + "cross.", base + ("cross",), idx)
    if spec.ffn == "none":
        return out
    out.append((prefix + "ln2.scale", base + ("ln2", "scale"), idx))
    if spec.ffn == "moe":
        out.append((prefix + "moe.router", base + ("moe", "router"), idx))
        subtrees = ["experts"] + (["shared"] if cfg.moe.num_shared_experts else [])
        out += [(prefix + f"moe.{sub}.{w}", base + ("moe", sub, w), idx)
                for sub in subtrees for w in ("w_gate", "w_up", "w_down")]
    else:
        out += [(prefix + f"mlp.{w}", base + ("mlp", w), idx)
                for w in ("w_gate", "w_up", "w_down")]
    return out


def reference_lm_leaves(cfg) -> List[Tuple[str, Tuple[str, ...], Optional[int]]]:
    """How ``repro``'s LM pytree maps onto the port's parameter names:
    ``(port name, reference path, layer index into a stacked leaf or None)``
    in the port's ``named_parameters`` order.

    The reference stacks the layers of a group on a leading axis
    (``params["g0"]["l0"]["attn"]["w_q"]["w"]`` is (L, d, H·hd) for L > 1,
    see ``layer_groups``; a hybrid's one group stacks its periods, so layer
    ``r·period + i`` is ``params["g0"][f"l{i}"]``'s slice r); each layer is
    ``blocks[i]``. Weights keep the reference's ``x @ w`` layout, (d_in,
    d_out), so nothing is transposed: ``w_q/w_k/w_v/w_o`` (and biases
    ``b_q/b_k/b_v``), ``w_gate/w_up/w_down``, the norms' ``scale``,
    ``embed`` (V, d) and, when untied, ``lm_head`` (d, V). An MoE layer's
    ``moe.router`` (d, E), ``moe.experts.w_*`` ((E, d, f) and (E, f, d); a
    stacked leaf is (L, E, d, f)) and ``moe.shared.w_*`` take the same paths
    in the reference's ``moe`` subtree. An MLA layer's attention weights are
    bare arrays in the reference (``params["g0"]["l0"]["attn"]["w_dq"]``, no
    ``"w"`` level): ``w_dq``, ``q_norm``, ``w_uq`` (or ``w_q`` when
    ``q_lora_rank`` is 0), ``w_dkv``, ``kv_norm``, ``w_uk``, ``w_uv``,
    ``w_o``, as ``blocks.i.attn.*``. A Mamba-2 layer's mixer keeps bare
    arrays too (``params["g0"]["l0"]["mamba"]["w_z"]``): ``w_z w_x w_B w_C
    w_dt conv_x conv_B conv_C conv_bias_x conv_bias_B conv_bias_C A_log
    dt_bias D norm w_out``, as ``blocks.i.mamba.*``; in the ssm family it has
    no ``ln2`` and no FFN, in the hybrid its ``ln2`` and ``mlp`` or ``moe``
    follow. An encoder–decoder's decoder layer adds ``ln_cross`` and
    ``cross.w_{q,k,v,o}`` (the ``"w"`` level, GQA's); its encoder is
    ``params["encoder"]["l0"][…]``, every leaf stacked (L_enc, …), as
    ``encoder.j.*``, then ``enc_norm``. A vlm's ``img_proj``
    (``VISION_WIDTH``, d) is ``params["img_proj"]``, a bare array.
    """
    from repro_torch.models.lm import model as mdl

    out = [("embed", ("embed",), None)]
    if not cfg.tie_embeddings:
        out.append(("lm_head", ("lm_head",), None))
    if cfg.num_image_tokens:
        out.append(("img_proj", ("img_proj",), None))
    out.append(("final_norm.scale", ("final_norm", "scale"), None))
    layer = 0
    for gi, group in enumerate(mdl.layer_groups(cfg)):
        for r in range(group.repeat):
            for li, spec in enumerate(group.specs):
                out += _block_leaves(cfg, spec, f"blocks.{layer}.", (f"g{gi}", f"l{li}"),
                                     r if group.repeat > 1 else None)
                layer += 1
    for j in range(cfg.num_encoder_layers):
        out += _block_leaves(cfg, mdl.ENCODER, f"encoder.{j}.", ("encoder", "l0"), j)
    if cfg.num_encoder_layers:
        out.append(("enc_norm.scale", ("enc_norm", "scale"), None))
    return out


def reference_cache_leaves(cfg) -> List[Tuple[int, str, Tuple[str, ...], Optional[int]]]:
    """How the port's decode caches (``models/lm/model.py::init_caches``, one
    entry a layer) map onto ``repro``'s ``init_caches`` tree: ``(layer, key
    in the port's entry, reference path, index into a stacked leaf or
    None)``. A GQA layer's ``k``/``v`` are ``g{i}/l{j}/k``; MLA's
    ``c_kv``/``k_rope`` the same level; a Mamba-2 layer's ``SSMCache`` fields
    ``x``, ``B``, ``C`` are ``conv/x``, ``conv/B``, ``conv/C`` and ``h`` is
    ``h``. A group of more than one repeat stacks its layers, as its
    parameters (:func:`reference_lm_leaves`)."""
    from repro_torch.models.lm import model as mdl

    keys = {"attn": ("k", "v"), "mla": ("c_kv", "k_rope"), "mamba": ("x", "B", "C", "h")}
    ref = {"x": ("conv", "x"), "B": ("conv", "B"), "C": ("conv", "C")}
    out = []
    layer = 0
    for gi, group in enumerate(mdl.layer_groups(cfg)):
        for r in range(group.repeat):
            for li, spec in enumerate(group.specs):
                idx = r if group.repeat > 1 else None
                out += [(layer, key, (f"g{gi}", f"l{li}") + ref.get(key, (key,)), idx)
                        for key in keys[spec.mixer]]
                layer += 1
    return out


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def from_reference_lm_tree(tree: Dict[str, Any], cfg, *, lead: int = 0) -> Dict[str, np.ndarray]:
    """A reference LM pytree of numpy leaves (parameters, or anything shaped
    like them: gradients, moments) as ``{port name: array}``. ``lead``
    leading axes (a chain axis: 1) are kept in front of each leaf; the layer
    axis of a stacked leaf follows them."""
    out = {}
    for name, path, idx in reference_lm_leaves(cfg):
        a = np.asarray(_get(tree, path))
        out[name] = a if idx is None else a[(slice(None),) * lead + (idx,)]
    return out


def to_reference_lm_grads(grads: Dict[str, torch.Tensor], cfg) -> Dict[str, Any]:
    """The port's ``{name: gradient}`` as the reference's pytree of numpy
    float32 arrays, a stacked group's layers stacked again, so that the two
    packages' gradients compare leaf by leaf."""
    tree: Dict[str, Any] = {}
    stacked: Dict[Tuple[str, ...], Dict[int, np.ndarray]] = {}
    for name, path, idx in reference_lm_leaves(cfg):
        a = grads[name].detach().float().cpu().numpy()
        if idx is None:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = a
        else:
            stacked.setdefault(path, {})[idx] = a
    for path, by_idx in stacked.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([by_idx[i] for i in sorted(by_idx)])
    return tree


def from_reference_lm_params(
    params: Dict[str, Any],
    cfg,
    *,
    device: str | torch.device | None = None,
):
    """``repro``'s LM ``init_params`` pytree (numpy leaves) as the port's
    model (every family the port runs; the map is
    :func:`reference_lm_leaves`). Every tensor takes its port
    parameter's dtype: ``cfg.param_dtype``, float32 for Mamba-2's ``A_log``,
    ``dt_bias`` and ``D`` (float32 in the reference too); the numbers are
    the reference's."""
    from repro_torch.models.lm import model as mdl

    device = resolve_device(device)
    model = mdl.init_params(cfg, device=device)
    targets = from_reference_lm_tree(params, cfg)
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


def from_reference_lm_params_placed(params: Dict[str, Any], cfg, mesh, *, device=None,
                                    specs=None):
    """:func:`from_reference_lm_params` then
    :func:`repro_torch.distributed.sharding.distribute_model`: the reference's
    weights as a port model whose parameters are DTensors on ``mesh``, placed
    by ``specs`` (default: the sharding rules' ``param_specs``)."""
    from repro_torch.distributed import sharding as shd

    model = from_reference_lm_params(params, cfg, device=device)
    return shd.distribute_model(model, mesh, specs or shd.param_specs(cfg, mesh, model))


def from_reference_epmcmc_state(
    state: Any,
    cfg,
    *,
    seed: int = 0,
    device: str | torch.device | None = None,
):
    """``repro``'s stacked ``EpmcmcState`` (numpy leaves: ``params``, ``v``,
    ``step``, ``key``, ``m_count``, ``m_mean``, ``m_var``) as the port's
    :class:`~repro_torch.distributed.epmcmc.EpmcmcState` on ``device``:
    each parameter in its port parameter's dtype (``cfg.param_dtype``;
    float32 for Mamba-2's ``A_log``, ``dt_bias`` and ``D``), accumulators
    float32. The chains'
    JAX keys do not carry over: the port's chain ``c`` gets a generator
    seeded from ``(seed, c)`` (feed the reference's noise through
    ``epmcmc_step(noise=)`` to compare the two)."""
    from repro_torch.distributed.epmcmc import EpmcmcState, chain_generators
    from repro_torch.models.lm import model as mdl

    device = resolve_device(device)
    pdtype = {n: p.dtype for n, p in mdl.init_params(cfg, device="meta").named_parameters()}

    def tree(t, dtype=None):
        return {n: _weight(a).to(device=device, dtype=dtype or pdtype[n])
                for n, a in from_reference_lm_tree(t, cfg, lead=1).items()}

    m_count = torch.tensor(np.asarray(state.m_count, dtype=np.float32), device=device)
    return EpmcmcState(
        params=tree(state.params),
        v=tree(state.v, torch.float32),
        step=int(np.asarray(state.step)),
        gens=chain_generators(seed, int(m_count.shape[0]), device),
        m_count=m_count,
        m_mean=tree(state.m_mean, torch.float32),
        m_var=tree(state.m_var, torch.float32),
    )
