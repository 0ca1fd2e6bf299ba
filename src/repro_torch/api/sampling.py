"""The embarrassingly parallel sampling stage behind ``repro_torch.api``.

The port of ``repro/api/sampling.py``. The reference ``vmap``\\ s one chain
function over the shards; here the M chains are one batch from the start:
positions ``(M, d)`` (or a Gibbs position whose tensors lead with M),
per-chain step sizes ``(M, 1)``, and a kernel built on the stacked shards.
No chain reads another chain's state. :func:`make_shard_kernel` packages a
(model, sampler) pair as a :class:`ShardKernel`: the MH-style samplers on
the subposterior log-density, ``gibbs`` on the model's blocks, ``sgld`` on
minibatch gradients whose rows each chain draws from its own shard's real
rows.

The chain driver comes in two parts, after the reference's chunk backend
(``repro/api/backends.py``, ``_setup_one`` / ``_chunk_one``):
:func:`setup_shard_chains` (init, warmup, burn-in) and :func:`shard_chunk`
(the next n kept draws). Both draw from one generator in order, so a run cut
into chunks of any size draws exactly the numbers of the one-shot run, which
is setup plus one chunk of T.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.subposterior import make_subposterior_logpdf, partition_data
from repro_torch.models.bayes import BayesModel
from repro_torch.samplers import chain_collect, chain_setup, filter_options, sampler_spec
from repro_torch.samplers.base import MCMCKernel, TransitionLoop, tree_leaves, tree_map
from repro_torch.samplers.mala import value_and_grad

Data = Dict[str, torch.Tensor]


class SampleResult(NamedTuple):
    """Output of the parallel sampling stage."""

    theta: torch.Tensor  # (M, T, d)
    accept: torch.Tensor  # (M,) mean acceptance per chain
    counts: torch.Tensor  # (M,) real data rows per shard
    backend: str
    # operators the chain-group check watched (None: no check ran)
    collectives_checked: Optional[int] = None


class ShardKernel(NamedTuple):
    """One (model, sampler) pairing, ready for a batch of shards, in
    ``repro``'s form.

    ``init_position(gen, shards)`` gives the M chains' starting positions;
    ``build(shards, counts, step_size)`` the kernel on those concrete shards
    at a (per-chain) step size; ``extract(positions)`` projects positions to
    the shared θ ``(..., d)`` (a Gibbs state's latents left out).
    """

    init_position: Callable[[torch.Generator, Data], Any]
    build: Callable[[Data, torch.Tensor, Any], MCMCKernel]
    extract: Callable[[Any], torch.Tensor]
    adaptive: bool
    target_accept: float


def _identity(x):
    return x


def _chains(model: BayesModel, shards: Data) -> int:
    keys = model.shard_keys or tuple(shards)
    return int(shards[keys[0]].shape[0])


def make_shard_kernel(
    model: BayesModel,
    num_shards: int,
    sampler: str,
    *,
    sgld_batch: int = 256,
    use_counts: bool = True,
    sampler_options=(),
) -> ShardKernel:
    """Package one registry sampler for one model as a :class:`ShardKernel`.

    ``use_counts=False`` drops the padded-row correction (every row is
    real). ``sampler_options`` is filtered per factory signature; the keys
    this layer owns (the log-density wiring, step size, Gibbs blocks, SGLD
    closures) are dropped.
    """
    spec = sampler_spec(sampler)
    reserved = ("step_size", "block_updates", "grad_logpdf", "batch_fn", "batch_size")
    extra = {
        k: v
        for k, v in filter_options(spec.factory, dict(sampler_options)).items()
        if k not in reserved
    }

    if spec.name == "gibbs":  # alias-safe: spec.name is canonical
        if not model.has_gibbs:
            raise ValueError(
                f"model {model.name!r} supplies no Gibbs blocks (BayesModel.gibbs_blocks)"
            )
        # models declaring gibbs_counts mask the edge-padded rows out of
        # their conditionals; the others see the raw shard
        pass_count = model.gibbs_counts and use_counts

        def build_gibbs(shards, counts, step_size):
            kwargs = {"count": counts} if pass_count else {}
            blocks = model.gibbs_blocks(shards, num_shards, step_size=step_size, **kwargs)
            return spec.factory(None, step_size=step_size, block_updates=blocks, **extra)

        return ShardKernel(
            init_position=model.gibbs_init,
            build=build_gibbs,
            extract=model.gibbs_extract,
            adaptive=False,
            target_accept=spec.target_accept,
        )

    def make_logpdf(shards, counts):
        return make_subposterior_logpdf(
            model.log_prior, model.log_lik, model.prepare_data(shards), num_shards,
            count=counts if use_counts else None, per_datum=model.shard_keys,
        )

    def init_position(gen, shards):
        return model.initial_position(gen, (_chains(model, shards),))

    if spec.name == "sgld":

        def build_sgld(shards, counts, step_size):
            # minibatch subposterior gradients (paper §7), scaled by each
            # shard's real row count so padded rows never bias the estimate
            prepared = model.prepare_data(shards)
            keys = model.shard_keys or tuple(prepared)
            per_datum = {k: prepared[k] for k in keys}
            rest = {k: v for k, v in prepared.items() if k not in keys}
            shard_size = per_datum[keys[0]].shape[1]
            batch_size = min(sgld_batch or shard_size, shard_size)
            n_real = counts if use_counts else torch.full_like(counts, shard_size)
            scale = n_real.to(torch.float32) / float(batch_size)
            inv_m = 1.0 / float(num_shards)
            n_idx = n_real.clamp(min=1).to(torch.float32).unsqueeze(-1)

            def mb_logpdf(theta, batch):
                return inv_m * model.log_prior(theta) + scale * model.log_lik(theta, batch)

            def grad_logpdf(theta, batch):
                return value_and_grad(lambda th: mb_logpdf(th, batch), theta)[1]

            def batch_fn(u, _t):
                # each chain's rows uniform over its own real rows: floor(u·count)
                idx = (u * n_idx).to(torch.int64).clamp(max=shard_size - 1)  # (M, B)
                batch = {}
                for k, v in per_datum.items():
                    j = idx.reshape(idx.shape + (1,) * (v.dim() - 2)).expand(
                        idx.shape + v.shape[2:])
                    batch[k] = torch.gather(v, 1, j)
                return {**rest, **batch}

            return spec.factory(
                make_logpdf(shards, counts), step_size=step_size, grad_logpdf=grad_logpdf,
                batch_fn=batch_fn, batch_size=batch_size, **extra,
            )

        return ShardKernel(
            init_position=init_position,
            build=build_sgld,
            extract=_identity,
            adaptive=False,
            target_accept=spec.target_accept,
        )

    return ShardKernel(
        init_position=init_position,
        build=lambda shards, counts, step_size: spec.factory(
            make_logpdf(shards, counts), step_size=step_size, **extra),
        extract=_identity,
        adaptive=spec.adaptive,
        target_accept=spec.target_accept,
    )


def chain_rows(model: BayesModel, shards: Data, lo: int, hi: int) -> Data:
    """Rows ``[lo, hi)`` of the per-datum leaves of ``shards`` (views); the
    leaves every shard shares (the GMM's weights) whole."""
    keys = model.shard_keys or tuple(shards)
    return {k: (v[lo:hi] if k in keys else v) for k, v in shards.items()}


class _Widened(tuple):
    """A draw's inputs for rows ``[lo, hi)``: views of a full-width draw
    (``full``, drawn for the stand-in position ``wide``) that later draws
    into it refresh in place."""

    full: Any
    wide: Any


def _chain_axes(small: Any, full: Any, n_rows: int, total: int) -> list:
    """The chain axis of every leaf of a draw: the one axis whose size is
    ``n_rows`` at the group's width and ``total`` at the full width."""
    axes = []
    for i, (a, b) in enumerate(zip(tree_leaves(small), tree_leaves(full))):
        diff = [k for k, (p, q) in enumerate(zip(a.shape, b.shape)) if p != q]
        if a.dim() != b.dim() or len(diff) != 1 or (a.shape[diff[0]], b.shape[diff[0]]) != \
                (n_rows, total):
            raise ValueError(
                f"draw input {i} is {tuple(b.shape)} for {total} chains and {tuple(a.shape)} "
                f"for {n_rows}: it has no chain axis, so its rows cannot be split over chain "
                "groups")
        axes.append(diff[0])
    return axes


def _widened_draw(draw: Callable[..., Any], lo: int, hi: int, total: int):
    """``draw`` replayed at the full width of ``total`` chains, keeping the
    rows ``[lo, hi)``: the inputs the batched run of all ``total`` chains
    draws for those chains, from the same generator state, bit for bit."""

    def widened(gen: torch.Generator, position: Any, out=None):
        if isinstance(out, _Widened):
            draw(gen, out.wide, out=out.full)  # the views follow
            return out
        wide = tree_map(lambda x: x.new_empty((total,) + tuple(x.shape[1:])), position)
        full = draw(gen, wide)
        probe = torch.Generator(device=tree_leaves(position)[0].device)
        axes = iter(_chain_axes(draw(probe, position), full, hi - lo, total))
        kept = tree_map(lambda x: x.narrow(next(axes), lo, hi - lo), full)
        parts = _Widened(kept)
        parts.full, parts.wide = full, wide
        return parts

    return widened


def chain_slice_kernel(sk: ShardKernel, model: BayesModel, lo: int, hi: int,
                       total: int) -> ShardKernel:
    """``sk`` for the chains ``[lo, hi)`` of a run of ``total``, drawing what
    the batched run of all ``total`` draws for them.

    Every draw (the initial position and each step's inputs) is replayed at
    the full width from the caller's generator and only the group's rows are
    kept, so a chain's randomness depends on the spec and its index alone,
    never on how the chains are split. The kernel's own work (its data, its
    states) stays at the group's width. The initial position is drawn on
    the group's shards set at their rows of zero-filled full-width ones
    (an init reads its own chain's shard only). Each group draws the
    randoms of ``total / (hi - lo)`` groups and keeps its own.
    """
    if (lo, hi) == (0, total):
        return sk
    keys = model.shard_keys or ()

    def init_position(gen, shards):
        full = {}
        for k, v in shards.items():
            if keys and k not in keys:
                full[k] = v
                continue
            w = v.new_zeros((total,) + tuple(v.shape[1:]))
            w[lo:hi] = v
            full[k] = w
        pos = sk.init_position(gen, full)
        return tree_map(lambda x: x[lo:hi].clone(), pos)

    def build(shards, counts, step_size):
        kernel = sk.build(shards, counts, step_size)
        if kernel.draw is None:
            raise TypeError("a kernel without a draw function cannot run on a chain group")
        return kernel._replace(draw=_widened_draw(kernel.draw, lo, hi, total))

    return sk._replace(init_position=init_position, build=build)


def setup_shard_chains(
    sk: ShardKernel,
    shards: Data,
    counts: torch.Tensor,
    gen: torch.Generator,
    *,
    burn_in: int,
    warmup: int,
    step_size: float,
) -> Tuple[Any, "torch.Tensor | float"]:
    """Init, warmup and burn-in of the chains of ``shards``: ``(kernel
    state, step size)``.

    Adaptive kernels spend ``warmup`` dual-averaging transitions per chain
    and return their adapted ``(M, 1)`` steps; non-adaptive ones treat the
    warmup as extra burn-in and return ``step_size``.
    ``sk.build(shards, counts, step)`` rebuilds the kernel the setup ended with.
    """
    pos0 = sk.init_position(gen, shards)
    if sk.adaptive and warmup > 0:
        _, state, eps = chain_setup(
            gen, lambda e: sk.build(shards, counts, e), pos0,
            burn_in=burn_in, warmup=warmup,
            initial_step_size=step_size, target_accept=sk.target_accept,
        )
    else:
        _, state, eps = chain_setup(
            gen, sk.build(shards, counts, step_size), pos0,
            burn_in=burn_in + (0 if sk.adaptive else warmup), initial_step_size=step_size,
        )
    return state, eps


def shard_chunk(
    kernel: "MCMCKernel | TransitionLoop",
    gen: torch.Generator,
    state: Any,
    n: int,
    extract: Callable[[Any], torch.Tensor] = _identity,
) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """The next ``n`` kept draws of every chain: ``(state, theta (M, n, d),
    accepted (M, n) bool)``; ``kernel`` may be a kept collection loop."""
    state, theta, info = chain_collect(gen, kernel, state, n, extract=extract)
    return state, theta, info.is_accepted


def run_shard_chain(
    sk: ShardKernel,
    shards: Data,
    counts: torch.Tensor,
    gen: torch.Generator,
    *,
    num_samples: int,
    burn_in: int,
    warmup: int,
    step_size: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chains of all shards in one go: ``(theta (M, T, d), mean_accept (M,))``,
    :func:`setup_shard_chains` then one :func:`shard_chunk` of T."""
    state, eps = setup_shard_chains(
        sk, shards, counts, gen, burn_in=burn_in, warmup=warmup, step_size=step_size
    )
    _, theta, accepted = shard_chunk(sk.build(shards, counts, eps), gen, state, num_samples,
                                     sk.extract)
    return theta, accepted.to(torch.float32).mean(dim=-1)


def is_padded(model: BayesModel, shards: Data, counts: torch.Tensor, sampler: str) -> bool:
    """Whether some shard holds edge-padded rows (then the counts correct the
    log-likelihood), and the Gibbs guard: a model whose blocks cannot mask
    padded rows refuses them."""
    keys = model.shard_keys or tuple(shards)
    shard_rows = shards[keys[0]].shape[1]
    padded = bool((counts != shard_rows).any())
    if padded and sampler_spec(sampler).name == "gibbs" and not model.gibbs_counts:
        raise ValueError(
            f"model {model.name!r}'s gibbs block updates operate on the raw shard and "
            "cannot mask padded rows (BayesModel.gibbs_counts is False); choose M "
            f"dividing N (counts={counts.tolist()})"
        )
    return padded


def sample_subposteriors(
    gen: torch.Generator,
    model: BayesModel,
    data: Data,
    num_shards: int,
    num_samples: int,
    *,
    sampler: Optional[str] = None,
    warmup: int = 200,
    burn_in: int = 0,
    step_size: float = 0.1,
    sgld_batch: int = 256,
    sampler_options=(),
    shards: Optional[Data] = None,
    counts: Optional[torch.Tensor] = None,
    mesh_shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence] = None,
    check: bool = True,
) -> SampleResult:
    """M independent subposterior chains, batched on the data's device.

    Partitions ``data`` (edge-padded) unless ``shards``/``counts`` are given.
    A ``mesh_shape`` whose data axis is larger than 1 splits the chains into
    that many groups, one on each of ``devices`` (default: one CUDA device a
    group; :func:`~repro_torch.api.backends.resolve_mesh_devices`), run as
    the one-shot path of :class:`~repro_torch.api.backends.MeshChunkBackend`:
    the same draws as the batched run, bit for bit, gathered back onto the
    data's device. The mesh always watches one eager chunk of every group
    for collectives and cross-group reads; ``check`` (``repro``'s
    signature) says whether the result reports the operators it watched
    (``collectives_checked``; ``None`` without).
    """
    from repro_torch.api.backends import BackendId, MeshChunkBackend, resolve_mesh_devices

    if shards is None or counts is None:
        shards, counts = partition_data(data, num_shards, only=model.shard_keys, pad=True)
    sampler = sampler or model.default_sampler
    sk = make_shard_kernel(
        model, num_shards, sampler, sgld_batch=sgld_batch,
        use_counts=is_padded(model, shards, counts, sampler), sampler_options=sampler_options,
    )
    if mesh_shape is not None and int(mesh_shape[0]) > 1:
        mesh = MeshChunkBackend(
            sk, model, shards, counts,
            devices=resolve_mesh_devices(mesh_shape, devices, counts.device, num_shards),
            burn_in=burn_in, warmup=warmup, step_size=step_size,
        )
        theta, accept_sum = mesh.run_fused(gen, num_samples)
        return SampleResult(theta, accept_sum / max(num_samples, 1), counts, mesh.backend_id(),
                            mesh.collectives_checked if check else None)
    theta, acc = run_shard_chain(
        sk, shards, counts, gen,
        num_samples=num_samples, burn_in=burn_in, warmup=warmup, step_size=step_size,
    )
    return SampleResult(theta, acc, counts, BackendId.batched(counts.device.type))


def groundtruth_chain(
    gen: torch.Generator,
    model: BayesModel,
    data: Data,
    num_samples: int,
    *,
    sampler: Optional[str] = None,
    warmup: int = 200,
    burn_in: int = 0,
    step_size: float = 0.1,
    sgld_batch: int = 256,
    sampler_options=(),
) -> torch.Tensor:
    """Single full-data chain (num_shards=1) → ``(T, d)``."""
    sk = make_shard_kernel(
        model, 1, sampler or model.default_sampler,
        sgld_batch=sgld_batch, use_counts=False, sampler_options=sampler_options,
    )
    keys = model.shard_keys or tuple(data)
    one = {k: (v.unsqueeze(0) if k in keys else v) for k, v in data.items()}
    counts = torch.full((1,), data[keys[0]].shape[0], dtype=torch.int32,
                        device=data[keys[0]].device)
    theta, _ = run_shard_chain(
        sk, one, counts, gen,
        num_samples=num_samples, burn_in=burn_in, warmup=warmup, step_size=step_size,
    )
    return theta[0]
