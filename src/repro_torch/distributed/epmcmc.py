"""EP-MCMC on the LM, its communication, and the proof that sampling has none.

The port of ``repro/distributed/epmcmc.py``.

The LM-scale training mode (the paper's algorithm on an LM): M independent
pSGLD chains, each on its own token shard, each targeting its subposterior
(paper Eq. 2.1) ``log p_c(θ) = (1/M)·log p(θ) + N_c·(mean token
log-likelihood)`` with an N(0, ``PRIOR_SIGMA``²) prior, no cross-chain
communication during sampling, streaming Welford moments per chain, and a
diagonal parametric (BvM) product at the end:

- :class:`EpmcmcState`, :func:`num_chains`, :func:`init_state`: the state
  stacked on a leading chain axis and keyed by the port's parameter names
  (``blocks.3.attn.w_q``), one explicit ``torch.Generator`` a chain;
- :func:`epmcmc_step`: one pSGLD transition of every chain, chain after
  chain; a chain's transition reads only its own slices and draws its noise
  from its own generator (``noise=`` feeds given draws instead, so a test
  can hand it the reference's); metrics stay per chain, as the reference's
  comment at :237 demands;
- :func:`sgd_baseline_step`: the synchronous strawman (gradients averaged
  over the chains every step);
- :func:`combine_parametric_diag`, :func:`gather_subset_samples`: the
  combination stage.

The reference vmaps the chain axis and lets GSPMD shard it; the port loops
the chains. A chain's model is an ``LM`` whose parameters are views of the
stacked state (:func:`chain_view`), so the transition updates the state in
place. Placed (:func:`chain_axes`, :func:`state_specs`, :func:`batch_spec`;
:func:`place_state`, :func:`place_batch`), the chain axis lies over the
data axes of a ``DeviceMesh`` and each rank steps its own chains, each
tensor-parallel over ``model`` (its parameters DTensors on the model axis);
:func:`num_chains` reads a mesh as the reference's does (pod × data).

The combination and the checks of the MCMC pipeline:

- :func:`combine_gathered` — the final combination of gathered
  ``(M, T, d_sub)`` draws, resolved by registry name;
- :func:`combine_stream` — its streaming counterpart over ``(M, C, d_sub)``
  chunks;
- :func:`stack_subset_history` — per-step ``(C, d_sub)`` snapshots stacked
  into that dense layout;
- :func:`assert_no_cross_chain_collectives` — the paper's "embarrassingly
  parallel" claim, checked (on a placed run from the rank groups of the
  collectives it issued, ``mesh=``). ``repro`` parses the compiled HLO of
  the mesh program for collectives whose device groups span chain groups. PyTorch
  runs no such program: here a :class:`~torch.utils._python_dispatch.
  TorchDispatchMode` watches every operator one eager chunk of each chain
  group dispatches (and every operand a hand-written kernel is handed,
  through :func:`repro_torch.kernels.watch_operands`), and fails on a
  collective (``c10d`` or a functional collective) or on an operand that
  lies on another group's device or in the storage of another group's
  inputs or carry (storage, not device: two groups may share a card).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import resolve_device
from repro_torch.core.gaussian import GaussianMoments, product_moments_diag
from repro_torch.data.tokens import seed_of
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import watch_operands
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.lm.placement import is_placed
from repro_torch.models.lm import model as mdl
from repro_torch.models.lm import steps
from repro_torch.models.lm.config import ModelConfig

Tensors = Dict[str, torch.Tensor]

PRIOR_SIGMA = 1.0  # N(0, σ²) prior over every weight — BvM-regime reference prior


class EpmcmcState(NamedTuple):
    """State of M parallel subposterior pSGLD chains (+ streaming moments)."""

    params: Tensors  # (C, ...) stacked chain parameters, cfg.param_dtype
    v: Tensors  # (C, ...) RMSProp preconditioner accumulators, float32
    step: int
    gens: List[torch.Generator]  # one a chain: its noise
    # streaming diagonal moments of the post-burn-in samples, per chain:
    m_count: torch.Tensor  # (C,) float32
    m_mean: Tensors  # (C, ...) running mean of θ samples, float32
    m_var: Tensors  # (C, ...) running Σ(θ−mean)² (Welford), float32


def num_chains(mesh=(1, 1)) -> int:
    """Chains of a run on ``mesh``: pod × data of a ``DeviceMesh`` or an
    ``{axis: size}`` shape (the reference's rule); the first entry of a
    (data, model) sequence (the port's chain groups)."""
    if isinstance(mesh, (tuple, list)):
        return int(mesh[0])
    shape = mesh_shape(mesh)
    return int(shape.get("pod", 1) * shape.get("data", 1)) if "data" in shape else 1


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------


def chain_axes(mesh) -> Tuple[str, ...]:
    return shd.batch_axes(mesh)  # ('pod','data') / ('data',)


def state_specs(cfg: ModelConfig, mesh, state: EpmcmcState) -> EpmcmcState:
    """Specs of the stacked state: the chain axis over the data axes, each
    chain's tensor-parallel spec inside (the sharding rules on the unstacked
    leaf, FSDP forced off: the data axes belong to the chains). The
    generators are dealt out by chain, as the reference's keys."""
    ca = shd._norm(chain_axes(mesh))
    cfg_tp = dataclasses.replace(cfg, fsdp=False)
    pspec = {name: (ca, *shd.param_spec(cfg_tp, mesh, name, leaf.shape[1:]))
             for name, leaf in state.params.items()}
    return EpmcmcState(params=pspec, v=pspec, step=(), gens=(ca,), m_count=(ca,),
                       m_mean=pspec, m_var=pspec)


def batch_spec(mesh, batch: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    """EP-MCMC batches are (C, b, ...): the chain axis sharded, the rest local."""
    ca = shd._norm(chain_axes(mesh))
    return {k: (ca,) + (None,) * (v.dim() - 1) for k, v in batch.items()}


def chain_generators(seed: int, n_chains: int, device) -> List[torch.Generator]:
    """Chain ``c``'s noise generator, seeded from ``(seed, "noise", c)``."""
    device = torch.device(device)
    return [torch.Generator(device=device).manual_seed(seed_of(seed, "noise", c))
            for c in range(n_chains)]


def init_state(seed: int, cfg: ModelConfig, n_chains: int, *, device=None) -> EpmcmcState:
    """Every chain starts at its own draw of ``init_params`` (overdispersed
    starts), from a generator seeded by ``(seed, "init", c)``; zero
    accumulators and moments. The draws are not the reference's (another
    generator): :func:`repro_torch.interop.from_reference_epmcmc_state`
    carries a reference state over."""
    device = resolve_device(device)
    params: Tensors = {}
    for c in range(n_chains):
        gen = torch.Generator(device=device).manual_seed(seed_of(seed, "init", c))
        model = mdl.init_params(cfg, generator=gen, device=device)
        for name, p in model.named_parameters():
            if c == 0:
                params[name] = torch.empty((n_chains, *p.shape), dtype=p.dtype, device=device)
            params[name][c].copy_(p.detach())
        del model

    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=device)
                for n, p in params.items()}

    return EpmcmcState(params=params, v=zeros(), step=0,
                       gens=chain_generators(seed, n_chains, device),
                       m_count=torch.zeros((n_chains,), dtype=torch.float32, device=device),
                       m_mean=zeros(), m_var=zeros())


def chain_view(cfg: ModelConfig, params: Tensors, c: int) -> mdl.LM:
    """An ``LM`` whose parameters are views of chain ``c``'s slices of the
    stacked ``params``: its gradients are chain ``c``'s, and an in-place
    write to the stack is a write to it."""
    model = mdl.init_params(cfg, device="meta")
    for name, _ in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner) if owner else model, leaf,
                nn.Parameter(params[name][c], requires_grad=True))
    return model


def _neg_logpost_and_grads(
    model: mdl.LM,
    cfg: ModelConfig,
    batch: Dict[str, torch.Tensor],
    *,
    num_shards: int,
    shard_tokens: float,
    chain: Optional["_Chain"] = None,
) -> Tuple[torch.Tensor, Tensors]:
    """−log p_c(θ) up to a constant, for ONE chain (``model`` its view), and
    its gradient by name: the reference's ``_subposterior_neg_logpost`` and
    its gradient. CE is mean/token, so ``shard_tokens × CE`` is −log-lik of
    the whole shard (the N_c/B unbiased scaling); the Gaussian prior enters
    with weight 1/M (paper Eq. 2.1's underweighted prior). The likelihood's
    gradient comes from autograd, the prior's, θ/(σ²·M) in float32 cast to
    the parameter's dtype, in closed form and added in that dtype, as the
    reference's cotangents add: autograd of the prior would keep a float32
    copy of every parameter for the backward (12.8 GB at llama3.2-3b). The
    prior's Σθ² sums the leaves' norms squared."""
    params = dict(model.named_parameters())
    total, _ = steps.loss_fn(model, cfg, batch)
    grads = steps.grads_of(shard_tokens * total, params)
    if is_placed(total):  # a placed chain: its blocks, and the model axis' split leaves
        total = total.to_local()
        grads = {n: g.redistribute(params[n].device_mesh, params[n].placements).to_local()
                 for n, g in grads.items()}
        params = {n: p.to_local() for n, p in params.items()}
    prior = 1.0 / (PRIOR_SIGMA**2 * num_shards)
    norms, out = [], {}
    with torch.no_grad():
        for names in leaf_groups(params):
            p32 = [params[n].float() for n in names]
            norms += torch._foreach_norm(p32)
            scaled = torch._foreach_mul(p32, prior)
            del p32
            out.update(zip(names, torch._foreach_add([grads.pop(n) for n in names],
                                                     [t.to(params[n].dtype)
                                                      for n, t in zip(names, scaled)])))
            del scaled
        sq = _sum_squares(norms, list(params), chain)
        value = shard_tokens * total.detach() + sq / (2.0 * PRIOR_SIGMA**2) / num_shards
    return value, out


def _sum_squares(norms: List[torch.Tensor], names: List[str], chain=None) -> torch.Tensor:
    """Σ norm² over the leaves; on a placed chain the leaves split over the
    model axis add their blocks' sums over that axis (a collective inside
    the chain's model row)."""
    sq = torch.stack(norms).square()
    if chain is None or not chain.split:
        return sq.sum()
    from torch.distributed import _functional_collectives as funcol

    cut = torch.tensor([n in chain.split for n in names], device=sq.device)
    part = funcol.all_reduce(torch.where(cut, sq, 0.0).sum(), "sum", chain.group)
    return torch.where(cut, 0.0, sq).sum() + part


def _chain_batch(batch: Dict[str, torch.Tensor], c: int) -> Dict[str, torch.Tensor]:
    return {k: v[c] for k, v in batch.items()}


# elements a group of leaves holds at most, so that a foreach pass over it
# keeps a few float32 temporaries of 256 MB alive (a larger leaf goes alone)
GROUP_NUMEL = 1 << 26


def leaf_groups(tensors: Tensors, *, lead: int = 0) -> List[List[str]]:
    """The names of ``tensors`` in order, cut into runs of at most
    ``GROUP_NUMEL`` elements (a larger leaf alone; ``lead`` leading axes, a
    chain axis, not counted): the lists the chains' elementwise updates hand
    to one ``torch._foreach_*`` call each, a few launches a run where a loop
    over leaves launches a few a leaf (Mamba-2's 16 leaves a layer made that
    loop the host's largest cost of a step)."""
    groups: List[List[str]] = []
    size = GROUP_NUMEL
    for name, t in tensors.items():
        n = math.prod(t.shape[lead:])
        if size + n > GROUP_NUMEL:
            groups.append([])
            size = 0
        groups[-1].append(name)
        size += n
    return groups


class _Chain(NamedTuple):
    """One chain this rank steps: its global index, its model (parameters
    views of the state, or DTensors over the model axis when placed), and
    the plain tensors the update writes in place (the local blocks when
    placed)."""

    index: int
    model: mdl.LM
    params: Tensors
    v: Tensors
    m_mean: Tensors
    m_var: Tensors
    m_count: torch.Tensor  # () view of the chain's count
    batch: Dict[str, torch.Tensor]
    split: frozenset = frozenset()  # leaves split over the model axis
    group: Any = None  # the model axis' process group
    placements: Optional[Dict[str, list]] = None  # each leaf's on the model axis
    mesh: Any = None  # the chain's model axis


def _chains(state: EpmcmcState, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """The chains this rank holds: all of them unplaced; placed (the chain
    axis over the data axes, each chain tensor-parallel over ``model``), the
    local ones, their models on the model axis alone."""
    first = next(iter(state.params.values()))
    if not is_placed(first):
        for c in range(state.m_count.shape[0]):
            yield _Chain(c, chain_view(cfg, state.params, c),
                         {n: p[c] for n, p in state.params.items()},
                         {n: p[c] for n, p in state.v.items()},
                         {n: p[c] for n, p in state.m_mean.items()},
                         {n: p[c] for n, p in state.m_var.items()}, state.m_count[c],
                         _chain_batch(batch, c))
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = first.device_mesh
    names = mesh.mesh_dim_names
    row = mesh["model"]
    local = {k: {n: t.to_local() for n, t in getattr(state, k).items()}
             for k in ("params", "v", "m_mean", "m_var")}
    counts = state.m_count.to_local()
    per_chain = counts.shape[0]
    first_chain = per_chain * _chain_coordinate(mesh)
    model_at = names.index("model")
    placements = {}
    for n, t in state.params.items():
        p = t.placements[model_at]
        placements[n] = [Shard(p.dim - 1) if isinstance(p, Shard) else Replicate()]
    split = frozenset(n for n, pl in placements.items()
                      if isinstance(pl[0], Shard) and row.size() > 1)
    data = {k: v.to_local() if is_placed(v) else v for k, v in batch.items()}
    for c in range(per_chain):
        model = mdl.init_params(cfg, device="meta")
        for n, _ in list(model.named_parameters()):
            owner, _, leaf = n.rpartition(".")
            whole = state.params[n].shape[1:]
            stride = torch.empty(whole, device="meta").stride()
            view = DTensor.from_local(local["params"][n][c], row, placements[n], run_check=False,
                                      shape=whole, stride=stride)
            setattr(model.get_submodule(owner) if owner else model, leaf,
                    nn.Parameter(view, requires_grad=True))
        chain_data = {k: DTensor.from_local(v[c], row, [Replicate()], run_check=False)
                      for k, v in data.items()}
        yield _Chain(first_chain + c, model, {n: t[c] for n, t in local["params"].items()},
                     {n: t[c] for n, t in local["v"].items()},
                     {n: t[c] for n, t in local["m_mean"].items()},
                     {n: t[c] for n, t in local["m_var"].items()}, counts[c], chain_data,
                     split, row.get_group(), placements, row)


def _chain_coordinate(mesh) -> int:
    """This rank's chain group: its row-major index over the chain axes."""
    coord = mesh.get_coordinate()
    index = 0
    for i, name in enumerate(mesh.mesh_dim_names):
        if name in chain_axes(mesh):
            index = index * mesh.size(i) + coord[i]
    return index


def _noise(chain: _Chain, gen: torch.Generator, name: str, p: torch.Tensor) -> torch.Tensor:
    """ξ for one leaf of the chain, float32: drawn whole (the chain's
    generator, as the unplaced step draws it) and cut to this rank's block."""
    if chain.placements is None:
        return torch.randn(p.shape, generator=gen, dtype=torch.float32, device=p.device)
    whole = torch.randn(chain.model.get_parameter(name).shape, generator=gen,
                        dtype=torch.float32, device=p.device)
    return shd.local_block(whole, chain.mesh, chain.placements[name])


@torch.no_grad()
def _welford(chain: _Chain, take: bool) -> None:
    """Fold the chain's θ into its running moments, in place (a no-op
    before burn-in ends, where the reference adds zeros): per leaf, δ = θ −
    mean, mean += δ / n, var += δ·(θ − mean), by foreach passes."""
    if not take:
        return
    chain.m_count.add_(1.0)
    n = chain.m_count
    for names in leaf_groups(chain.m_mean):
        p32 = [chain.params[k].float() for k in names]
        means = [chain.m_mean[k] for k in names]
        delta = torch._foreach_sub(p32, means)
        torch._foreach_add_(means, torch._foreach_div(delta, n))
        torch._foreach_mul_(delta, torch._foreach_sub(p32, means))
        torch._foreach_add_([chain.m_var[k] for k in names], delta)
        del p32, delta


def epmcmc_step(
    state: EpmcmcState,
    batch: Dict[str, torch.Tensor],  # (C, b, ...) — one sub-batch per chain
    cfg: ModelConfig,
    *,
    num_shards: int,
    shard_tokens: float,
    step_size: float = 1e-6,
    rmsprop_decay: float = 0.99,
    rmsprop_eps: float = 1e-4,
    temperature: float = 1.0,
    burn_in: int = 0,
    noise: Optional[Sequence[Tensors]] = None,
) -> Tuple[EpmcmcState, Dict[str, torch.Tensor]]:
    """One pSGLD transition of all chains + streaming-moment update, in
    place: G = 1/(√v̂ + ε), θ += −(ε/2)·G·∇(−log p_c) + √(ε·G·T)·ξ with v̂
    the RMSProp average of the squared gradient.

    ``temperature=0`` turns the transition into preconditioned SGD *per
    chain* — still embarrassingly parallel, and it draws no noise.
    ``noise[c][name]`` (float32, the leaf's shape) replaces chain ``c``'s
    draws of ξ. Returns ``(state, {"loss_per_chain", "gnorm_per_chain"})``.

    A placed state (:func:`place_state`: the chain axis over the data axes,
    each chain tensor-parallel over ``model``) steps the chains this rank
    holds, their forward and backward placed over the model axis and the
    update on the local blocks; a chain's noise is drawn whole from its
    generator and cut to the block, so the draws are the unplaced step's.
    No collective leaves a chain's model row. The metrics are then placed
    (C,) tensors.
    """
    take = state.step >= burn_in
    losses, gnorms = [], []
    for chain in _chains(state, batch, cfg):
        c = chain.index
        loss, grads = _neg_logpost_and_grads(chain.model, cfg, chain.batch,
                                             num_shards=num_shards, shard_tokens=shard_tokens,
                                             chain=None if chain.placements is None else chain)
        with torch.no_grad():
            norms = []
            for names in leaf_groups(grads):
                ps = [chain.params[n] for n in names]
                vs = [chain.v[n] for n in names]
                g32 = [grads.pop(n).float() for n in names]
                norms += torch._foreach_norm(g32)
                # v = decay·v + (1 − decay)·g²; G = 1/(√v + ε)
                g2 = torch._foreach_mul(g32, g32)
                torch._foreach_mul_(g2, 1 - rmsprop_decay)
                torch._foreach_mul_(vs, rmsprop_decay)
                torch._foreach_add_(vs, g2)
                del g2
                precond = torch._foreach_sqrt(vs)
                torch._foreach_add_(precond, rmsprop_eps)
                torch._foreach_reciprocal_(precond)
                # θ − (ε/2)·G·g, then + √(ε·G·T)·ξ, ξ drawn leaf by leaf
                drift = torch._foreach_mul(precond, 0.5 * step_size)
                torch._foreach_mul_(drift, g32)
                del g32
                new = torch._foreach_sub([p.float() for p in ps], drift)
                del drift
                if temperature:
                    xi = [noise[c][n] if noise is not None else _noise(chain, state.gens[c], n, p)
                          for n, p in zip(names, ps)]
                    if noise is not None and chain.placements is not None:
                        xi = [shd.local_block(x, chain.mesh, chain.placements[n])
                              for n, x in zip(names, xi)]
                    torch._foreach_mul_(precond, step_size)
                    torch._foreach_mul_(precond, temperature)
                    torch._foreach_sqrt_(precond)
                    torch._foreach_mul_(precond, xi)
                    torch._foreach_add_(new, precond)
                    del xi
                torch._foreach_copy_(ps, new)
                del new, precond
            losses.append(loss)
            gnorms.append(_sum_squares(norms, list(chain.params),
                                       None if chain.placements is None else chain).sqrt())
        _welford(chain, take)
        del chain
    # NB: metrics stay PER-CHAIN, as in the reference (no reduction over chains)
    metrics = {"loss_per_chain": torch.stack(losses), "gnorm_per_chain": torch.stack(gnorms)}
    if is_placed(state.m_count):
        metrics = {k: _chain_placed(v, state.m_count) for k, v in metrics.items()}
    return state._replace(step=state.step + 1), metrics


def _chain_placed(local: torch.Tensor, like_count: torch.Tensor) -> torch.Tensor:
    """Per-chain values of this rank's chains as a (C,) DTensor placed as the
    chain counts are."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like_count.device_mesh, like_count.placements,
                              run_check=False, shape=like_count.shape,
                              stride=like_count.stride())


def place_state(state: EpmcmcState, cfg: ModelConfig, mesh) -> EpmcmcState:
    """The whole stacked ``state`` (every rank holds it) placed by
    :func:`state_specs`: each rank keeps its chains' blocks; the step and the
    generators stay as they are."""
    specs = state_specs(cfg, mesh, state)
    return EpmcmcState(
        params={n: shd.place(t, mesh, specs.params[n]) for n, t in state.params.items()},
        v={n: shd.place(t, mesh, specs.v[n]) for n, t in state.v.items()},
        step=state.step, gens=state.gens,
        m_count=shd.place(state.m_count, mesh, specs.m_count),
        m_mean={n: shd.place(t, mesh, specs.m_mean[n]) for n, t in state.m_mean.items()},
        m_var={n: shd.place(t, mesh, specs.m_var[n]) for n, t in state.m_var.items()})


def place_batch(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """A whole (C, b, ...) batch placed by :func:`batch_spec`."""
    specs = batch_spec(mesh, batch)
    return {k: shd.place(v, mesh, specs[k]) for k, v in batch.items()}


def sgd_baseline_step(
    state: EpmcmcState,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    num_shards: int,
    shard_tokens: float,
    step_size: float = 1e-6,
    rmsprop_decay: float = 0.99,
    rmsprop_eps: float = 1e-4,
) -> Tuple[EpmcmcState, Dict[str, torch.Tensor]]:
    """The synchronous strawman: the same per-chain gradient, then *averaged
    across chains* (the data-axis all-reduce EP-MCMC eliminates) and one
    preconditioned step of every chain with the mean, in place. The mean is
    summed in float32 and cast to the parameter's dtype, as the reference's
    ``jnp.mean`` of the stacked gradients gives it.

    A placed state (:func:`place_state`) sums the gradients of the chains
    its rank holds (their local blocks, in chain order) and all-reduces
    those sums over the chain axes (:func:`_sum_over_chains`), each leaf's
    model-axis placement kept: the reference's data-axis all-reduce. The
    sum's order is then the backend's over the ranks' partial sums, not the
    unplaced step's chain order, so the placed step equals the unplaced one
    to float32 rounding of the mean (``tests/test_torch_spmd.py`` states
    the tolerance). The metrics are then placed (C,) tensors."""
    n_chains = state.m_count.shape[0]
    losses, chains, total = [], [], None
    for chain in _chains(state, batch, cfg):
        loss, grads = _neg_logpost_and_grads(chain.model, cfg, chain.batch,
                                             num_shards=num_shards, shard_tokens=shard_tokens,
                                             chain=None if chain.placements is None else chain)
        with torch.no_grad():
            if total is None:
                total = {n: g.float() for n, g in grads.items()}
            else:
                for n, g in grads.items():
                    total[n] += g.float()
        del grads
        losses.append(loss)
        chains.append(chain)
    placed = is_placed(state.m_count)
    if placed:
        total = _sum_over_chains(total, chains[0], state.m_count.device_mesh)
    with torch.no_grad():
        for name, gsum in total.items():
            g32 = (gsum / n_chains).to(chains[0].params[name].dtype).float()
            for chain in chains:
                v, p = chain.v[name], chain.params[name]
                v.mul_(rmsprop_decay).add_((1 - rmsprop_decay) * torch.square(g32))
                precond = 1.0 / (torch.sqrt(v) + rmsprop_eps)
                p.copy_(p.float() - 0.5 * step_size * precond * g32)
    metrics = {"loss_per_chain": torch.stack(losses)}
    if placed:
        metrics = {k: _chain_placed(v, state.m_count) for k, v in metrics.items()}
    return state._replace(step=state.step + 1), metrics


def _sum_over_chains(partial: Tensors, chain: _Chain, mesh) -> Tensors:
    """Each leaf's sum over every rank's chains: this rank's partial sum (a
    local block) all-reduced over the chain axes, the model axis' placement
    kept (a ``Partial`` → ``Replicate`` redistribution on those axes)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    model_at = mesh.mesh_dim_names.index("model")
    out = {}
    for name, t in partial.items():
        on_model = chain.placements[name][0]
        src = [on_model if i == model_at else Partial() for i in range(mesh.ndim)]
        dst = [on_model if i == model_at else Replicate() for i in range(mesh.ndim)]
        out[name] = DTensor.from_local(t, mesh, src, run_check=False).redistribute(
            mesh, dst).to_local()
    return out


# ---------------------------------------------------------------------------
# combination (the single communicating stage)
# ---------------------------------------------------------------------------


@torch.no_grad()
def combine_parametric_diag(state: EpmcmcState) -> GaussianMoments:
    """Full-θ parametric product (Eqs 3.1–3.2, diagonal/BvM form) from the
    streaming moments, leaf by leaf: ``GaussianMoments(mean={name: ...},
    cov={name: ...})`` with each leaf's unstacked shape. The reduce over the
    chain axis is the only cross-chain step of the run."""
    counts = torch.clamp(state.m_count - 1.0, min=1.0)
    means, covs = {}, {}
    for name, mean in state.m_mean.items():
        n_chains = mean.shape[0]
        cshape = (n_chains,) + (1,) * (mean.dim() - 1)
        var = state.m_var[name] / counts.reshape(cshape) + 1e-12
        mom = product_moments_diag(mean.reshape(n_chains, -1), var.reshape(n_chains, -1))
        means[name] = mom.mean.reshape(mean.shape[1:])
        covs[name] = mom.cov.reshape(mean.shape[1:])
    return GaussianMoments(mean=means, cov=covs)


def gather_subset_samples(
    params: Optional[Tensors] = None,
    paths: Optional[Sequence[str]] = None,
    *,
    history: bool = False,
    chunk: Optional[Sequence[Tensors]] = None,
) -> torch.Tensor:
    """Flatten a designated low-dim θ subset per chain → ``(C, d_sub)``
    float32 (a copy).

    Default subset: the final norm's scale (present in every arch);
    ``paths`` are regular expressions searched in the port's parameter names
    (``blocks\\.0\\.ln1``), where the reference searches its pytree paths.
    ``history=True`` returns ``(C, 1, d_sub)``; ``chunk=`` (a window of
    stacked params) returns ``(C, k, d_sub)``, one streaming chunk."""
    if chunk is not None:
        if params is not None:
            raise ValueError(
                "pass either one stacked params dict or chunk= (a window of them), not both"
            )
        if len(chunk) == 0:
            raise ValueError("chunk= needs at least one per-step snapshot")
        return torch.stack([gather_subset_samples(p, paths) for p in chunk], dim=1)
    if params is None:
        raise ValueError("gather_subset_samples needs params (or chunk=)")
    sel = [leaf for name, leaf in params.items()
           if ("final_norm" in name if paths is None else any(re.search(p, name) for p in paths))]
    if not sel:
        raise ValueError("subset selector matched no parameters")
    n_chains = sel[0].shape[0]
    out = torch.cat([s.reshape(n_chains, -1).float() for s in sel], dim=1).clone()
    return out[:, None, :] if history else out

# operator namespaces that move data between processes or devices
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional",
                         "_c10d_functional_autograd", "_dtensor")


def combine_gathered(
    gen: torch.Generator,
    samples: torch.Tensor,  # (M, T, d_sub) gathered subset draws
    n_draws: int,
    *,
    combiner: str = "nonparametric",
    **options,
):
    """Final-stage combination of gathered subset draws, by registry name;
    options the combiner does not declare are dropped (the registry's
    option-forwarding convention)."""
    from repro_torch.core.combiners import filter_options, get_combiner

    if samples.dim() != 3:
        raise ValueError(
            f"combine_gathered needs (M, T, d_sub) samples, got {tuple(samples.shape)}; "
            "gather_subset_samples returns one (C, d_sub) snapshot — pass "
            "history=True there or stack snapshots with stack_subset_history"
        )
    fn = get_combiner(combiner)
    return fn(gen, samples, n_draws, **filter_options(fn, options))


def combine_stream(
    gen: torch.Generator,
    chunks: Iterable[torch.Tensor],
    n_draws: int,
    *,
    combiner: str = "nonparametric",
    **options,
):
    """Fold dense ``(M, C, d_sub)`` chunks through ``combiner``'s streaming
    form and finalize: bitwise :func:`combine_gathered` on the concatenated
    stack for the buffered combiners; ``online`` never holds the stack."""
    from repro_torch.core.combiners import filter_options, get_streaming_combiner

    sc = get_streaming_combiner(combiner)
    state = None
    for ch in chunks:
        if ch.dim() != 3:
            raise ValueError(
                f"combine_stream folds (M, C, d_sub) chunks, got {tuple(ch.shape)}; "
                "use gather_subset_samples(chunk=window) to build them"
            )
        if state is None:
            state = sc.init(ch.shape[0], ch.shape[2], device=ch.device)
        state = sc.update(state, ch)
    if state is None:
        raise ValueError("combine_stream needs at least one chunk")
    return sc.finalize(gen, state, n_draws, **filter_options(sc.finalize, options))


def stack_subset_history(snapshots: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stack per-step ``(C, d_sub)`` snapshots into ``(C, T, d_sub)``, the
    layout :func:`combine_gathered` takes."""
    if len(snapshots) == 0:
        raise ValueError("stack_subset_history needs at least one snapshot")
    return torch.stack([torch.as_tensor(s) for s in snapshots], dim=1)


# ---------------------------------------------------------------------------
# the "embarrassingly parallel" proof
# ---------------------------------------------------------------------------


class ChainGroup(NamedTuple):
    """One chain group as the check sees it: its device, the tensors it owns
    (its inputs and carry, in any nesting of dicts, tuples and lists; no
    other group may read them) and ``run``, which drives one eager chunk of
    it."""

    device: torch.device
    tensors: Any
    run: Callable[[], Any]


class CrossChainError(AssertionError):
    """A chain group communicated: a collective, or another group's data."""


def _storage_key(t: torch.Tensor):
    try:
        return (t.device, t.untyped_storage().data_ptr())
    except (RuntimeError, NotImplementedError):  # no storage (meta, sparse)
        return None


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    if isinstance(tree, (tuple, list)) or hasattr(tree, "__iter__") and not isinstance(tree, str):
        return [t for x in tree for t in _tensors(x)]
    return []


class _GroupWatch(TorchDispatchMode):
    """Fails on a collective, or an operand on a foreign device or in a
    foreign storage; counts the operators it saw."""

    def __init__(self, index: int, device: torch.device, foreign: dict):
        super().__init__()
        self.index, self.device, self.foreign = index, torch.device(device), foreign
        self.ops = 0

    def operand(self, t: torch.Tensor, where: str) -> None:
        same = t.device.type == self.device.type and (
            self.device.index is None or t.device.index in (None, self.device.index))
        if not same and not (t.device.type == "cpu" and t.dim() == 0):  # host scalars
            raise CrossChainError(f"chain group {self.index} on {self.device}: {where} reads a "
                                  f"tensor on {t.device}")
        owner = self.foreign.get(_storage_key(t))
        if owner is not None:
            raise CrossChainError(f"chain group {self.index}: {where} reads the inputs or carry "
                                  f"of chain group {owner}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace in COLLECTIVE_NAMESPACES:
            raise CrossChainError(f"chain group {self.index} issued the collective {func}")
        for t in _tensors(args) + _tensors(kwargs):
            self.operand(t, str(func))
        self.ops += 1
        return func(*args, **kwargs)


def assert_no_cross_chain_collectives(groups, *, mesh=None) -> int:
    """Run one eager chunk of every chain group under watch; raise
    :class:`CrossChainError` on any collective or cross-group read.

    Returns the number of operators checked (the ``collectives_checked`` of
    a mesh run). The operands of hand-written kernels are checked as the
    wrappers hand them over (``check_tensor``); their device code reads only
    those.

    With ``mesh`` (a placed run, the reference's form): ``groups`` are the
    ``(kind, ranks)`` of every collective a rank issued (what
    :class:`repro_torch.launch.op_stats.Tally` records, the counterpart of
    the reference's ``collective_groups`` of the HLO), and the check fails
    when one's ranks span more than one (pod, data) coordinate: ranks are
    row-major over (pod?, data, model), so rank r's chain is r // model.
    Collectives inside a chain's model row pass. Returns how many were
    checked.
    """
    if mesh is not None:
        model = mesh_shape(mesh).get("model", 1)
        for kind, ranks in groups:
            chains = {r // model for r in ranks}
            if len(chains) > 1:
                raise CrossChainError(f"{kind} crosses chain groups {sorted(chains)[:4]}: "
                                      f"ranks {list(ranks)[:8]}")
        return len(groups)
    owners = [{_storage_key(t) for t in _tensors(g.tensors)} - {None} for g in groups]
    checked = 0
    for i, g in enumerate(groups):
        foreign = {key: j for j, keys in enumerate(owners) if j != i for key in keys}
        watch = _GroupWatch(i, g.device, foreign)
        with watch, watch_operands(lambda t, name: watch.operand(t, f"kernel operand {name}")):
            g.run()
        checked += watch.ops
    return checked
