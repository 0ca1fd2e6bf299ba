"""Mixture-of-Experts FFN: GShard/Switch-style grouped one-hot dispatch.

The counterpart of ``repro/models/lm/moe.py``. The reference computes MoE
outside any Pallas kernel, as one-hot einsums per group of
``cfg.moe.group_size`` tokens; the port runs the same einsums (``bmm`` on
cuBLAS) and keeps every decision of the reference's:

- tokens are flattened, zero rows pad the last group, and the padding
  routes like any token (a zero router input ties every expert, so it takes
  experts 0..k−1 and their capacity before later slots' real tokens) and
  counts in the aux loss's means;
- the router's product runs in the activations' dtype, softmax and top-k in
  float32, the top-k renormalised (``max(·, 1e-9)``) when
  ``router_normalize_topk``;
- top-k ties go to the lower expert index, as ``jax.lax.top_k``'s do: a
  stable descending sort, then its first k (``torch.topk`` promises no
  order among ties on CUDA);
- capacity is filled slot by slot, each slot a cumsum over the group's
  positions plus the counts of the earlier slots, in float32; a token over
  capacity is dropped (its combine weight is 0, the residual carries it);
- ``dispatch`` and ``combine`` stay float32 until the einsums cast them to
  the tokens' dtype;
- the one-hot rows are comparisons against an ``arange``, so that a
  position of −1 or ≥ capacity gives a zero row (``jax.nn.one_hot``'s
  behaviour; ``torch.nn.functional.one_hot`` raises there, and checks its
  range with a device synchronisation);
- the shared experts run on the normed input ``x``.

The Switch aux loss keeps the reference's arithmetic, ``ce`` collapsed to a
scalar by ``mean(axis=0)`` of the per-expert top-1 fractions, so it is
E·Σ me·(1/E) = 1 and its gradient vanishes up to rounding (ROADMAP Queue 3,
"Faults in the reference itself").

Nothing on these paths accumulates with atomics (no ``index_add_`` or
``scatter_add_``): a block recomputed under remat routes and sums as its
first pass did.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.lm.config import ModelConfig
from repro_torch.models.lm import placement
from repro_torch.models.lm.layers import MLP, dtype_of, linear_param, trainable
from repro_torch.models.lm.placement import is_placed


def _expert_param(
    e: int, d_in: int, d_out: int, *, generator: Optional[torch.Generator], device,
    dtype: torch.dtype,
) -> nn.Parameter:
    """An (E, d_in, d_out) stack, N(0, 1)·d_in^-½ drawn in float32 then cast
    (scaled in place: jamba's (16, 8,192, 24,576) is 12.9 GB in float32);
    zeros without a generator."""
    if generator is None:
        return trainable(torch.zeros((e, d_in, d_out), dtype=dtype, device=device))
    w = torch.randn((e, d_in, d_out), generator=generator, device=device, dtype=torch.float32)
    return trainable(w.mul_((1.0 / d_in) ** 0.5).to(dtype))


class Experts(nn.Module):
    """The routed experts' SwiGLU weights: ``w_gate``, ``w_up`` (E, d, f),
    ``w_down`` (E, f, d)."""

    def __init__(self, e: int, d: int, f: int, *, generator=None, dtype: torch.dtype, device=None):
        super().__init__()
        init = dict(generator=generator, device=device, dtype=dtype)
        self.w_gate = _expert_param(e, d, f, **init)
        self.w_up = _expert_param(e, d, f, **init)
        self.w_down = _expert_param(e, f, d, **init)


class MoE(nn.Module):
    """One MoE layer's weights (``init_moe`` in the reference): ``router``
    (d, E), ``experts``, and ``shared`` (a SwiGLU of width
    ``num_shared_experts·d_ff_expert``) when the config has shared experts.
    Random from ``generator`` at the reference's scales (d^-½, and f^-½ for
    ``w_down``), zeros without one."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        m, d = cfg.moe, cfg.d_model
        dtype = dtype_of(cfg.param_dtype)
        init = dict(generator=generator, device=device, dtype=dtype)
        self.router = linear_param(d, m.num_experts, **init)
        self.experts = Experts(m.num_experts, d, m.d_ff_expert, **init)
        self.shared = (MLP(d, m.num_shared_experts * m.d_ff_expert, **init)
                       if m.num_shared_experts else None)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(y, aux) of x (B, S, d): :func:`moe_forward`, as forward and prefill run it."""
        return moe_forward(self, x)

    def decode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(y, aux) of a decode step's x (B, 1, d): :func:`moe_forward` when
        ``cfg.moe_decode_impl`` is ``"dispatch"``, else :func:`moe_forward_gather`."""
        if self.cfg.moe_decode_impl == "dispatch":
            return moe_forward(self, x)
        return moe_forward_gather(self, x)


def _capacity(cfg: ModelConfig, group: int) -> int:
    m = cfg.moe
    c = int(m.capacity_factor * m.top_k * group / m.num_experts) + 1
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot rows; an index outside [0, n) gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.float32)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index (``jax.lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(moe: MoE, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs (..., E), top_vals (..., k), top_idx (..., k)) of ``tokens`` (..., d):
    the router's product in the tokens' dtype, then float32."""
    m = moe.cfg.moe
    logits = (tokens @ moe.router.to(tokens.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = top_k(probs, m.top_k)
    if m.router_normalize_topk:
        top_vals = top_vals / torch.clamp_min(top_vals.sum(-1, keepdim=True), 1e-9)
    return probs, top_vals, top_idx


class Plan(NamedTuple):
    """What :func:`moe_forward` decides before its einsums."""

    tokens: torch.Tensor  # (ng, g, d): the flattened tokens, zero rows padding the last group
    n: int  # the real tokens, the first n rows of tokens.reshape(-1, d)
    top_idx: torch.Tensor  # (ng, g, k) int64
    dispatch: torch.Tensor  # (ng, g, E, C) float32, 1 where a (token, expert) pair holds slot c
    combine: torch.Tensor  # (ng, g, E, C) float32, the pair's top-k weight there
    aux: torch.Tensor  # () float32, the Switch load-balancing loss
    # Σ probs (E,) and the top-1 counts (E,) over every (group, position):
    # the aux loss's terms before their means (a placed MoE reduces them
    # over the data axes before it forms the loss)
    probs_sum: torch.Tensor
    top1_count: torch.Tensor


def plan(moe: MoE, x: torch.Tensor) -> Plan:
    """Grouping, routing, capacity and the aux loss of ``x`` (B, S, d)."""
    m = moe.cfg.moe
    d = x.shape[-1]
    tokens = x.reshape(-1, d)
    n = tokens.shape[0]
    g = min(m.group_size, n)
    pad = (-n) % g
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    ng = tokens.shape[0] // g
    tokens = tokens.reshape(ng, g, d)
    cap = _capacity(moe.cfg, g)
    e = m.num_experts

    probs, top_vals, top_idx = route(moe, tokens)

    # Switch load-balancing aux loss, E·Σ_e f_e·P_e, with the reference's
    # ce: the mean over experts of the top-1 fractions, a scalar (1/E)
    me = probs.mean(dim=(0, 1))
    top1 = _one_hot(top_idx[..., 0], e).sum(dim=(0, 1))
    ce = (top1 / (ng * g)).mean(dim=0)
    aux = e * (me * ce).sum()

    dispatch = torch.zeros((ng, g, e, cap), dtype=torch.float32, device=x.device)
    combine = torch.zeros((ng, g, e, cap), dtype=torch.float32, device=x.device)
    counts = torch.zeros((ng, e), dtype=torch.float32, device=x.device)
    for slot in range(m.top_k):
        onehot = _one_hot(top_idx[..., slot], e)  # (ng, g, E)
        pos = torch.cumsum(onehot, dim=1) - 1.0 + counts[:, None, :]
        keep = onehot * (pos < cap)
        counts = counts + keep.sum(dim=1)
        sel = keep[..., None] * _one_hot(pos.to(torch.int32), cap)  # (ng, g, E, C)
        dispatch = dispatch + sel
        combine = combine + top_vals[..., slot][..., None, None] * sel
    return Plan(tokens, n, top_idx, dispatch, combine, aux, probs.sum(dim=(0, 1)), top1)


def _experts(p: Plan, w_gate, w_up, w_down, dtype) -> torch.Tensor:
    """The routed experts' SwiGLU on the plan's slots, combined: (ng, g, d)."""
    expert_in = torch.einsum("gsec,gsd->egcd", p.dispatch.to(dtype), p.tokens)  # (E, ng, C, d)
    h = F.silu(torch.einsum("egcd,edf->egcf", expert_in, w_gate.to(dtype))) * torch.einsum(
        "egcd,edf->egcf", expert_in, w_up.to(dtype))
    expert_out = torch.einsum("egcf,efd->egcd", h, w_down.to(dtype))
    return torch.einsum("gsec,egcd->gsd", p.combine.to(dtype), expert_out)


def moe_forward(moe: MoE, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (y, aux loss)."""
    if is_placed(x):
        return _moe_forward_placed(moe, x)
    b, s, d = x.shape
    p = plan(moe, x)
    ex = moe.experts
    y = _experts(p, ex.w_gate, ex.w_up, ex.w_down, x.dtype)
    y = y.reshape(-1, d)[:p.n].reshape(b, s, d)
    if moe.shared is not None:
        y = y + moe.shared(x)
    return y, p.aux


def _moe_forward_placed(moe: MoE, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_forward` on placed x, in a ``local_map`` region: each rank
    plans its own tokens' groups (batch over the data axes when its tokens
    fill whole groups, else replicated) over every expert (the router is
    replicated), then runs its own block of experts (over ``model``) and
    gives its share of y, summed over ``model``. The aux loss's sums come out
    summed over the data axes, and the loss is formed from them after."""
    m = moe.cfg.moe
    b, s, d = x.shape
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    ex = moe.experts
    g = min(m.group_size, b * s)
    data = [n for n in names if n in placement.DATA_AXES and placement.shards(x, n, 0)]
    local_b = b // math.prod(mesh.size(names.index(n)) for n in data)
    if (local_b * s) % g:
        data = []  # a group would straddle two ranks' tokens: plan over the whole batch
    model = [n for n in names if n == "model" and placement.shards(ex.w_gate, n, 0)]
    batch_keep = {n: 0 for n in data}
    x_pl = placement.placements(mesh, batch_keep)
    w_pl = placement.placements(mesh, {n: 0 for n in model})
    r_pl = placement.placements(mesh, {})

    def local(xl, router, w_gate, w_up, w_down):
        p = plan(_Router(moe.cfg, router), xl)
        e_loc = w_gate.shape[0]
        lo = mesh.get_local_rank("model") * e_loc if model else 0
        p = p._replace(dispatch=p.dispatch[:, :, lo:lo + e_loc],
                       combine=p.combine[:, :, lo:lo + e_loc])
        y = _experts(p, w_gate, w_up, w_down, xl.dtype)
        y = y.reshape(-1, d)[:p.n].reshape(xl.shape)
        return y, p.probs_sum, p.top1_count

    y, probs_sum, top1 = placement.region(
        local, mesh, (x, moe.router, ex.w_gate, ex.w_up, ex.w_down),
        (x_pl, r_pl, w_pl, w_pl, w_pl),
        (placement.placements(mesh, batch_keep, partial=model),
         placement.placements(mesh, {}, partial=data),
         placement.placements(mesh, {}, partial=data)),
        (placement.placements(mesh, batch_keep, partial=model),
         placement.placements(mesh, {}, partial=data + model),
         placement.placements(mesh, {n: 0 for n in model}, partial=data),
         placement.placements(mesh, {n: 0 for n in model}, partial=data),
         placement.placements(mesh, {n: 0 for n in model}, partial=data)))
    tokens = -(-(b * s) // g) * g  # the groups' rows, padding included
    e = m.num_experts
    aux = e * ((probs_sum / tokens) * (top1 / tokens).mean(dim=0)).sum()
    if moe.shared is not None:
        y = y + moe.shared(x)
    return y, aux


class _Router(NamedTuple):
    """What :func:`plan` reads of an MoE layer: its config and router."""

    cfg: ModelConfig
    router: torch.Tensor


def moe_forward_gather(moe: MoE, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless MoE for decode: each token gathers its top-k experts'
    weights, with no capacity; the aux loss is 0. Placed x runs
    :func:`_gather_placed`."""
    if is_placed(x):
        y = _gather_placed(moe, x)
    else:
        ex = moe.experts
        y = _gather(moe, x, ex.w_gate, ex.w_up, ex.w_down)
    if moe.shared is not None:
        y = y + moe.shared(x)
    return y, placement.like(y, torch.zeros((), dtype=torch.float32, device=x.device))


def _gather(moe, x: torch.Tensor, w_gate, w_up, w_down, lo: int = 0) -> torch.Tensor:
    """The routed experts' sum for x (B, S, d), slot by slot, from the
    expert stacks ``w_*`` that hold experts ``lo`` onwards: all of them
    unplaced; placed, this rank's block, and a token whose slot's expert
    lies outside it adds 0 for that slot."""
    m = moe.cfg.moe
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    _, top_vals, top_idx = route(moe, tokens)
    dtype = x.dtype
    w_gate, w_up, w_down = (w.to(dtype) for w in (w_gate, w_up, w_down))
    e_loc = w_gate.shape[0]
    y = None
    for slot in range(m.top_k):
        idx, weight = top_idx[:, slot], top_vals[:, slot]
        if e_loc != m.num_experts:
            idx = idx - lo
            weight = torch.where((idx >= 0) & (idx < e_loc), weight, 0.0)
            idx = idx.clamp(0, e_loc - 1)
        h = F.silu(torch.einsum("nd,ndf->nf", tokens, w_gate[idx])) * torch.einsum(
            "nd,ndf->nf", tokens, w_up[idx])
        out = torch.einsum("nf,nfd->nd", h, w_down[idx]) * weight[:, None].to(dtype)
        y = out if y is None else y + out
    return y.reshape(b, s, d)


def _gather_placed(moe: MoE, x: torch.Tensor) -> torch.Tensor:
    """:func:`_gather` on placed x in a ``local_map`` region: each rank
    routes its tokens (batch over the data axes where x has it; the router
    replicated) and sums its own block of experts (over ``model``, the
    placement ``distributed/sharding.py`` gives them), each token's slots on
    other ranks' experts adding 0; the shares are summed over ``model``.
    With two slots and two expert ranks that sum is the unplaced one's bit
    for bit; otherwise it adds the same terms in another order."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    ex = moe.experts
    data = {n: 0 for n in names if n in placement.DATA_AXES and placement.shards(x, n, 0)}
    model = [n for n in names if n == "model" and placement.shards(ex.w_gate, n, 0)]
    w_pl = placement.placements(mesh, {n: 0 for n in model})

    def local(xl, router, w_gate, w_up, w_down):
        lo = mesh.get_local_rank("model") * w_gate.shape[0] if model else 0
        return _gather(_Router(moe.cfg, router), xl, w_gate, w_up, w_down, lo)

    return placement.region(
        local, mesh, (x, moe.router, ex.w_gate, ex.w_up, ex.w_down),
        (placement.placements(mesh, data), placement.placements(mesh, {}), w_pl, w_pl, w_pl),
        placement.placements(mesh, data, partial=model))
