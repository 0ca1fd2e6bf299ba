"""End-to-end driver: EP-MCMC posterior sampling over an LM.

The port of ``examples/lm_bayes_sgld.py``, the LM-scale face of the paper:
M independent pSGLD chains, each on a disjoint token shard with the
1/M-weighted prior (Eq. 2.1), no cross-chain step during sampling, streaming
Welford moments per chain and the parametric (BvM, diagonal) combination at
the end, plus checkpoint and restart. It runs the reference's model,
mamba2-130m (Mamba-2 blocks, 24 layers, d 768, 129.0 M parameters a chain),
reduced by default (4 layers, d 128; ``--full-width`` for the real widths,
on the card). On the card unless told otherwise::

    PYTHONPATH=src python -m repro_torch.launch.lm_bayes_sgld --device cpu [--steps 60]
    PYTHONPATH=src python -m repro_torch.launch.lm_bayes_sgld --full-width

After burn-in every step's final-norm vector of each chain
(``gather_subset_samples``) joins a (C, T, d_sub) history that the exact
combiner ``--combiner`` turns into draws through ``combine_draws``.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.api import combine_draws
from repro_torch.checkpoint import Checkpointer, restore
from repro_torch.configs import get_config
from repro_torch.core.combiners import available_combiners
from repro_torch.data.tokens import TokenStream
from repro_torch.distributed import epmcmc
from repro_torch.launch.train import epmcmc_tree, restore_epmcmc
from repro_torch.models.lm.config import reduced


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--burn-in", type=int, default=20)
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--combiner", default="weierstrass", choices=available_combiners(),
                    help="registry name for the exact low-dim combination stage")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("mamba2_130m")
    if not args.full_width:
        cfg = reduced(cfg)
    C = args.chains
    streams = [TokenStream(cfg.vocab_size, args.batch, args.seq, seed=0, shard_index=c,
                           num_shards=C, device=device) for c in range(C)]
    state = epmcmc.init_state(0, cfg, C, device=device)
    n_params = sum(p[0].numel() for p in state.params.values())
    print(f"{cfg.name}: {n_params / 1e6:.1f}M params/chain × {C} chains", flush=True)
    kwargs = dict(num_shards=C, shard_tokens=float(args.batch * args.seq * 200), step_size=2e-5,
                  burn_in=args.burn_in)

    with tempfile.TemporaryDirectory() as ckdir:
        ck = Checkpointer(ckdir, keep=2)
        subset_history = []  # per-step (C, d_sub) gathers for the exact combiners
        for step in range(args.steps):
            batches = [s.batch(step) for s in streams]
            batch = {k: torch.stack([b[k] for b in batches]) for k in ("tokens", "labels")}
            state, metrics = epmcmc.epmcmc_step(state, batch, cfg, **kwargs)
            if step >= args.burn_in:
                subset_history.append(epmcmc.gather_subset_samples(state.params))
            if step % 10 == 0 or step == args.steps - 1:
                losses = metrics["loss_per_chain"]
                print(f"step {step:4d}  -log p_c(θ) per chain: "
                      f"min={float(losses.min()):.0f} max={float(losses.max()):.0f}", flush=True)
            if (step + 1) % 25 == 0:
                ck.save(step + 1, epmcmc_tree(state),
                        metadata={"num_chains": C, "train_step": step + 1})
        ck.close()

        # simulate a preemption: restore and verify the moments survived
        leaves, meta = restore(ckdir)
        restored = restore_epmcmc(leaves, epmcmc.init_state(1, cfg, C, device=device))
        print(f"restart check: restored step-{meta['train_step']} checkpoint, "
              f"{int(restored.m_count[0])} post-burn-in samples folded per chain", flush=True)

    # the single communicating stage: parametric product over chains (Eq 3.1/3.2)
    moments = epmcmc.combine_parametric_diag(state)
    total = sum(m.numel() for m in moments.mean.values())
    mean_sd = torch.sqrt(torch.cat([v.reshape(-1) for v in moments.cov.values()]).mean())
    print(f"combined posterior over {total / 1e6:.1f}M parameter dims; "
          f"mean posterior sd = {float(mean_sd):.2e}", flush=True)

    # exact combiners on a low-dim subset (the final-norm vector): the
    # per-step (C, d_sub) gathers stacked into the (M, T, d_sub) layout
    history = epmcmc.stack_subset_history(subset_history)
    print(f"low-dim subset history for exact combiners: {tuple(history.shape)} "
          "(per-chain final_norm)", flush=True)
    gen = torch.Generator(device=device).manual_seed(7)
    res = combine_draws(gen, history, 64, combiner=args.combiner, rescale=True)
    print(f"{args.combiner}-combined subset draws: {tuple(res.samples.shape)}", flush=True)
    return {"state": state, "restored": restored, "restored_step": int(meta["train_step"]),
            "history": history, "combined": res, "moments": moments}


if __name__ == "__main__":
    main()
