"""Training driver of the LM — AdamW, EP-MCMC (the paper) or its synchronous baseline.

The port of ``repro/launch/train.py``. Modes:

``--mode adamw``   one model, ``train_step`` (CE + z-loss, AdamW);
``--mode epmcmc``  the paper: M independent subposterior pSGLD chains on
                   disjoint token shards, the 1/M-weighted prior, no
                   cross-chain step during sampling, the diagonal parametric
                   (BvM) combination at the end;
``--mode sgd``     the baseline whose communication the paper deletes: the
                   chains' gradients averaged every step.

``--mesh host`` (the default) runs the chains one after another on one
device, and ``--chains 0`` means one chain. ``--mesh pod`` / ``multipod``
(the reference's) places the run on the production mesh
(``launch/mesh.make_production_mesh``: 256 or 512 ranks, one process a GPU,
the process group started by the launcher, e.g. ``torchrun``; with fewer
ranks it raises and names the count): ``--chains 0`` is then one chain a
(pod, data) coordinate (``epmcmc.num_chains(mesh)``), each chain
tensor-parallel over ``model`` (``epmcmc.place_state``), and adamw's model
and batch placed by the sharding rules; no checkpoints, no ``sgd``. Data is a function of (seed,
shard, step) (:class:`repro_torch.data.TokenStream`), so a restarted run
replays the exact stream. Checkpoints go through the port's async
:class:`~repro_torch.checkpoint.Checkpointer` every ``--ckpt-every`` steps
with the chains' generator states, and ``--resume`` restarts from the
newest one bit for bit (the chain count must be the checkpoint's). Beyond
the reference's flags: ``--device`` (``cuda`` unless ``cpu``) and
``--layers`` (cut the depth, the width unchanged; 0 keeps the config's).
Every family (``check_supported``): ``--arch granite-moe-1b-a400m``, ``--arch
deepseek-v2-236b`` and ``--arch jamba-1.5-large-398b`` (Mamba-2, GQA and MoE
layers; ``--layers 1`` on one card) train with the MoE aux loss in the
total, ``--arch mamba2-130m`` (Mamba-2 blocks) with none; a config with
Mamba-2 layers takes a ``--seq`` that is a multiple of the SSD chunk (256,
jamba's 128) or shorter. ``--arch whisper-base`` trains on tokens alone, as
the reference's driver does: its encoder and cross-attention get zero
gradients, which AdamW's moments and weight decay still step. ``--arch
llava-next-mistral-7b`` trains on tokens alone too, as the reference's
training CLI feeds no images: ``img_proj`` gets a zero gradient (``--layers 16``
on one card).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch llama3_2_3b --reduced --mode epmcmc --steps 30 --batch 4 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --mode adamw \\
        --batch 8 --seq 4096 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-1.5-large-398b --layers 1 \\
        --mode adamw --batch 1 --seq 4096 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch whisper-base \\
        --reduced --mode adamw --steps 3 --batch 2 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch llava-next-mistral-7b \\
        --layers 16 --mode adamw --batch 1 --seq 4096 --steps 3
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import Checkpointer, latest_step, restore
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.distributed import epmcmc
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.lm import mamba2
from repro_torch.models.lm import model as mdl
from repro_torch.models.lm import steps as lm_steps
from repro_torch.models.lm.config import reduced
from repro_torch.models.lm.layers import dtype_of
from repro_torch.models.lm.placement import is_placed
from repro_torch.optim.adamw import AdamWState, adamw_init


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mode", default="epmcmc", choices=["sgd", "epmcmc", "adamw"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="per-chain batch size")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--chains", type=int, default=0, help="0 = one per data-axis index (1)")
    ap.add_argument("--step-size", type=float, default=1e-5)
    ap.add_argument("--burn-in", type=int, default=0)
    ap.add_argument("--shard-tokens", type=float, default=0.0,
                    help="tokens per data shard N_m (0 = batch*seq*100)")
    ap.add_argument("--reduced", action="store_true", help="CPU smoke config")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0 = the config's)")
    ap.add_argument("--mesh", default="host", choices=["host", "pod", "multipod"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor numpy can hold, bit for bit: bfloat16 as int16."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _unbits(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    t = t.view(torch.bfloat16) if like.dtype == torch.bfloat16 else t
    return t.to(device=like.device, dtype=like.dtype)


def epmcmc_tree(state: epmcmc.EpmcmcState) -> dict:
    """The checkpoint tree of an EP-MCMC state (generators as their states)."""
    return {"params": {n: _bits(p) for n, p in state.params.items()}, "v": state.v,
            "m_mean": state.m_mean, "m_var": state.m_var, "m_count": state.m_count,
            "step": state.step, "rng": [g.get_state() for g in state.gens]}


def restore_epmcmc(leaves: Dict[str, np.ndarray], like: epmcmc.EpmcmcState) -> epmcmc.EpmcmcState:
    """``like`` (a fresh state of the same shapes) loaded from a checkpoint."""
    with torch.no_grad():
        for key in ("params", "v", "m_mean", "m_var"):
            for name, t in getattr(like, key).items():
                t.copy_(_unbits(leaves[f"{key}/{name}"], t))
        like.m_count.copy_(torch.from_numpy(leaves["m_count"]))
    for c, g in enumerate(like.gens):
        g.set_state(torch.from_numpy(leaves[f"rng/{c}"]))
    return like._replace(step=int(leaves["step"]))


def adamw_tree(model: mdl.LM, opt: AdamWState) -> dict:
    return {"params": {n: _bits(p.detach()) for n, p in model.named_parameters()},
            "mu": opt.mu, "nu": opt.nu, "count": opt.count}


def restore_adamw(leaves: Dict[str, np.ndarray], model: mdl.LM, opt: AdamWState) -> AdamWState:
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(_unbits(leaves[f"params/{name}"], p))
        for key in ("mu", "nu"):
            for name, t in getattr(opt, key).items():
                t.copy_(_unbits(leaves[f"{key}/{name}"], t))
    return opt._replace(count=int(leaves["count"]))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A placed tensor gathered whole; a plain one as it is."""
    return t.full_tensor() if is_placed(t) else t


def _gathered(state: epmcmc.EpmcmcState) -> epmcmc.EpmcmcState:
    """A placed EP-MCMC state's moments gathered whole for the combination,
    the one communicating stage (the unplaced state as it is)."""
    whole = {k: {n: _whole(t) for n, t in getattr(state, k).items()}
             for k in ("m_mean", "m_var")}
    return state._replace(m_count=_whole(state.m_count), **whole)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI. Returns ``{"loss", "losses", "step_s", "peak_bytes",
    "state"}``: the last step's loss (the chains' mean), every step's loss
    (per chain for epmcmc and sgd), every step's seconds, the device's peak
    allocation (cuda; None on the CPU) and the final state (the model and
    AdamW state, or the EP-MCMC state), plus ``"combined"`` (epmcmc: the
    parametric product's moments)."""
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    mesh = None
    if args.mesh != "host":  # raises unless the process group has the mesh's ranks
        mesh = make_production_mesh(multi_pod=args.mesh == "multipod", device_type=device.type)
        if args.ckpt_dir or args.mode == "sgd":
            raise NotImplementedError(f"--mesh {args.mesh} runs --mode epmcmc and adamw without "
                                      "checkpoints (a placed state is not written)")
    cfg = get_config(args.arch)
    mdl.check_supported(cfg)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if cfg.ssm is not None:
        mamba2.check_seq(cfg, args.seq)
    n_chains = args.chains or max(epmcmc.num_chains(mesh if mesh is not None else (1, 1)), 1)
    shard_tokens = args.shard_tokens or float(args.batch * args.seq * 100)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    resume = bool(ckpt and args.resume and latest_step(args.ckpt_dir) is not None)
    start_step = 0
    losses, step_s = [], []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    if args.mode in ("epmcmc", "sgd"):
        streams = [TokenStream(cfg.vocab_size, args.batch, args.seq, seed=args.seed,
                               shard_index=c, num_shards=n_chains, device=device)
                   for c in range(n_chains)]
        state = epmcmc.init_state(args.seed, cfg, n_chains, device=device)
        if mesh is not None:
            state = epmcmc.place_state(state, cfg, mesh)
        if resume:
            leaves, meta = restore(args.ckpt_dir)
            if meta.get("num_chains") != n_chains:
                raise ValueError(f"the checkpoint holds {meta.get('num_chains')} chains, "
                                 f"--chains asks for {n_chains}")
            state = restore_epmcmc(leaves, state)
            start_step = int(meta["train_step"])
            print(f"resumed from step {start_step}", flush=True)
        kwargs = dict(num_shards=n_chains, shard_tokens=shard_tokens, step_size=args.step_size)
        if args.mode == "epmcmc":
            step_fn = epmcmc.epmcmc_step
            kwargs["burn_in"] = args.burn_in
        else:
            step_fn = epmcmc.sgd_baseline_step
        for step in range(start_step, args.steps):
            batches = [s.batch(step) for s in streams]
            batch = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
            if mesh is not None:
                batch = epmcmc.place_batch(batch, mesh)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch, cfg, **kwargs)
            _sync(device)
            step_s.append(time.perf_counter() - t0)
            losses.append(_whole(metrics["loss_per_chain"]).float().cpu())
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss={float(losses[-1].mean()):.4f} "
                      f"({step_s[-1]:.2f}s/step)", flush=True)
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, epmcmc_tree(state),
                          metadata={"train_step": step + 1, "num_chains": n_chains,
                                    "arch": cfg.name, "mode": args.mode})
        out = {"state": state}
        if args.mode == "epmcmc":
            moments = epmcmc.combine_parametric_diag(_gathered(state))
            out["combined"] = moments
            first = next(iter(moments.mean.values()))
            print("combined posterior (parametric/BvM): "
                  f"{sum(m.numel() for m in moments.mean.values())} parameter dims, "
                  f"mean|μ|={float(first.abs().mean()):.4f}", flush=True)
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        model, opt = lm_steps.init_train_state(gen, cfg, device=device)
        if mesh is not None:
            shd.distribute_model(model, mesh, shd.param_specs(cfg, mesh, model))
            opt = adamw_init(dict(model.named_parameters()),
                             state_dtype=dtype_of(cfg.opt_state_dtype))
        if resume:
            leaves, meta = restore(args.ckpt_dir)
            opt = restore_adamw(leaves, model, opt)
            start_step = int(meta["train_step"])
            print(f"resumed from step {start_step}", flush=True)
        stream = TokenStream(cfg.vocab_size, args.batch, args.seq, seed=args.seed, device=device)
        for step in range(start_step, args.steps):
            batch = stream.batch(step)
            if mesh is not None:
                batch = shd.distribute_tree(batch, mesh, shd.batch_specs(cfg, mesh, batch))
            t0 = time.perf_counter()
            model, opt, metrics = lm_steps.train_step(model, opt, batch, cfg)
            _sync(device)
            step_s.append(time.perf_counter() - t0)
            losses.append(_whole(metrics["loss"]).float().cpu())
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss={float(losses[-1]):.4f} ({step_s[-1]:.2f}s/step)",
                      flush=True)
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, adamw_tree(model, opt), metadata={"train_step": step + 1})
        out = {"state": (model, opt)}
    if ckpt:
        ckpt.close()
    out.update(
        loss=float(losses[-1].mean()) if losses else float("nan"),
        losses=losses, step_s=step_s,
        peak_bytes=torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
    )
    return out


if __name__ == "__main__":
    main()
