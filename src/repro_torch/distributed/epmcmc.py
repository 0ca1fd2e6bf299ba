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
the chains on one device (``state_specs``, ``batch_spec`` and
``chain_axes`` are sharding, ROADMAP Queue 1 item 11.10). A chain's model is
an ``LM`` whose parameters are views of the stacked state
(:func:`chain_view`), so the transition updates the state in place.

The combination and the checks of the MCMC pipeline:

- :func:`combine_gathered` — the final combination of gathered
  ``(M, T, d_sub)`` draws, resolved by registry name;
- :func:`combine_stream` — its streaming counterpart over ``(M, C, d_sub)``
  chunks;
- :func:`stack_subset_history` — per-step ``(C, d_sub)`` snapshots stacked
  into that dense layout;
- :func:`assert_no_cross_chain_collectives` — the paper's "embarrassingly
  parallel" claim, checked. ``repro`` parses the compiled HLO of the mesh
  program for collectives whose device groups span chain groups. PyTorch
  runs no such program: here a :class:`~torch.utils._python_dispatch.
  TorchDispatchMode` watches every operator one eager chunk of each chain
  group dispatches (and every operand a hand-written kernel is handed,
  through :func:`repro_torch.kernels.watch_operands`), and fails on a
  collective (``c10d`` or a functional collective) or on an operand that
  lies on another group's device or in the storage of another group's
  inputs or carry (storage, not device: two groups may share a card).
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import resolve_device
from repro_torch.core.gaussian import GaussianMoments, product_moments_diag
from repro_torch.data.tokens import seed_of
from repro_torch.kernels import watch_operands
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


def num_chains(mesh_shape: Sequence[int] = (1, 1)) -> int:
    """Chains of a run on ``mesh_shape`` (data, model): one a data index
    (the reference's pod × data axes; the port's host mesh is (1, 1))."""
    return int(mesh_shape[0])


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
        sq = torch.stack(norms).square().sum()
        value = shard_tokens * total.detach() + sq / (2.0 * PRIOR_SIGMA**2) / num_shards
    return value, out


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


@torch.no_grad()
def _welford(state: EpmcmcState, c: int, take: bool) -> None:
    """Fold chain ``c``'s θ into its running moments, in place (a no-op
    before burn-in ends, where the reference adds zeros): per leaf, δ = θ −
    mean, mean += δ / n, var += δ·(θ − mean), by foreach passes."""
    if not take:
        return
    state.m_count[c] += 1.0
    n = state.m_count[c]
    for names in leaf_groups(state.m_mean, lead=1):
        p32 = [state.params[k][c].float() for k in names]
        means = [state.m_mean[k][c] for k in names]
        delta = torch._foreach_sub(p32, means)
        torch._foreach_add_(means, torch._foreach_div(delta, n))
        torch._foreach_mul_(delta, torch._foreach_sub(p32, means))
        torch._foreach_add_([state.m_var[k][c] for k in names], delta)
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
    """
    n_chains = state.m_count.shape[0]
    take = state.step >= burn_in
    losses, gnorms = [], []
    for c in range(n_chains):
        model = chain_view(cfg, state.params, c)
        loss, grads = _neg_logpost_and_grads(model, cfg, _chain_batch(batch, c),
                                             num_shards=num_shards, shard_tokens=shard_tokens)
        del model
        with torch.no_grad():
            norms = []
            for names in leaf_groups(grads):
                ps = [state.params[n][c] for n in names]
                vs = [state.v[n][c] for n in names]
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
                    xi = [noise[c][n] if noise is not None else torch.randn(
                        p.shape, generator=state.gens[c], dtype=torch.float32, device=p.device)
                        for n, p in zip(names, ps)]
                    torch._foreach_mul_(precond, step_size)
                    torch._foreach_mul_(precond, temperature)
                    torch._foreach_sqrt_(precond)
                    torch._foreach_mul_(precond, xi)
                    torch._foreach_add_(new, precond)
                    del xi
                torch._foreach_copy_(ps, new)
                del new, precond
            losses.append(loss)
            gnorms.append(torch.stack(norms).square().sum().sqrt())
        _welford(state, c, take)
    # NB: metrics stay PER-CHAIN, as in the reference (no reduction over chains)
    metrics = {"loss_per_chain": torch.stack(losses), "gnorm_per_chain": torch.stack(gnorms)}
    return state._replace(step=state.step + 1), metrics


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
    ``jnp.mean`` of the stacked gradients gives it."""
    n_chains = state.m_count.shape[0]
    losses, total = [], None
    for c in range(n_chains):
        model = chain_view(cfg, state.params, c)
        loss, grads = _neg_logpost_and_grads(model, cfg, _chain_batch(batch, c),
                                             num_shards=num_shards, shard_tokens=shard_tokens)
        del model
        with torch.no_grad():
            if total is None:
                total = {n: g.float() for n, g in grads.items()}
            else:
                for n, g in grads.items():
                    total[n] += g.float()
        del grads
        losses.append(loss)
    with torch.no_grad():
        for name, gsum in total.items():
            p_all, v_all = state.params[name], state.v[name]
            g32 = (gsum / n_chains).to(p_all.dtype).float()
            for c in range(n_chains):
                v = v_all[c]
                v.mul_(rmsprop_decay).add_((1 - rmsprop_decay) * torch.square(g32))
                precond = 1.0 / (torch.sqrt(v) + rmsprop_eps)
                p_all[c].copy_(p_all[c].float() - 0.5 * step_size * precond * g32)
    return state._replace(step=state.step + 1), {"loss_per_chain": torch.stack(losses)}


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


def assert_no_cross_chain_collectives(groups: Sequence[ChainGroup]) -> int:
    """Run one eager chunk of every chain group under watch; raise
    :class:`CrossChainError` on any collective or cross-group read.

    Returns the number of operators checked (the ``collectives_checked`` of
    a mesh run). The operands of hand-written kernels are checked as the
    wrappers hand them over (``check_tensor``); their device code reads only
    those.
    """
    owners = [{_storage_key(t) for t in _tensors(g.tensors)} - {None} for g in groups]
    checked = 0
    for i, g in enumerate(groups):
        foreign = {key: j for j, keys in enumerate(owners) if j != i for key in keys}
        watch = _GroupWatch(i, g.device, foreign)
        with watch, watch_operands(lambda t, name: watch.operand(t, f"kernel operand {name}")):
            g.run()
        checked += watch.ops
    return checked
