"""AdamW's first step at the reference's rate, in both packages, on the CPU.

Not a pytest module (it takes ~1 minute and ~10 GB): run it as

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_adam_first_step.py [--layers 1] [--seq 64]

llama3.2-3b at full width (d 3,072, vocab 128,256, bf16 weights and
activations, float32 AdamW moments) cut to ``--layers`` layers, batch 1 ×
``--seq`` tokens of the port's token stream (the u⁴ marginal), from the
reference's ``init_params`` carried over by ``interop``. Each package takes
one ``train_step`` at lr 3e-4 (the reference's default) on batch 0, then
evaluates ``loss_fn`` on batch 0 again and on batch 1. Printed: the losses
before and after in each package, their differences, and the largest
parameter difference after the step. Equal losses (within bf16 rounding)
make a rise after the step the reference's arithmetic; a gap would be a
fault of the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models.lm import model as ref_mdl
from repro.models.lm import steps as ref_steps
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.configs import get_config
from repro_torch.data import TokenStream
from repro_torch.interop import from_reference_lm_params, from_reference_lm_tree
from repro_torch.models.lm import steps
from repro_torch.optim import adamw_init


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    args = ap.parse_args(argv)
    arch = "llama3_2_3b"
    ref_cfg = dataclasses.replace(ref_get_config(arch), num_layers=args.layers)
    cfg = dataclasses.replace(get_config(arch), num_layers=args.layers)
    params = jax.tree.map(np.asarray, ref_mdl.init_params(jax.random.PRNGKey(0), ref_cfg))
    model = from_reference_lm_params(params, cfg, device="cpu")
    batches = [TokenStream(cfg.vocab_size, 1, args.seq, seed=0, device="cpu").batch(s)
               for s in (0, 1)]

    ref_loss = jax.jit(lambda p, b: ref_steps.loss_fn(p, ref_cfg, b)[0])
    ref_step = jax.jit(functools.partial(ref_steps.train_step, cfg=ref_cfg, lr=args.lr))
    ref_b = [{k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in b.items()} for b in batches]
    ref_p = jax.tree.map(jnp.asarray, params)
    ref_before = float(ref_loss(ref_p, ref_b[0]))
    ref_p, _, _ = ref_step(ref_p, ref_adamw_init(ref_p), ref_b[0])
    ref_after = [float(ref_loss(ref_p, b)) for b in ref_b]

    with torch.no_grad():
        before = float(steps.loss_fn(model, cfg, batches[0])[0])
    model, _, _ = steps.train_step(model, adamw_init(dict(model.named_parameters())),
                                   batches[0], cfg, lr=args.lr)
    with torch.no_grad():
        after = [float(steps.loss_fn(model, cfg, b)[0]) for b in batches]
    ref_new = from_reference_lm_tree(jax.tree.map(np.asarray, ref_p), cfg)
    diffs = {n: float(np.abs(p.detach().float().numpy() - ref_new[n].astype(np.float32)).max())
             for n, p in model.named_parameters()}
    worst = max(diffs, key=diffs.get)
    out = {"reference": {"before": ref_before, "after_same_batch": ref_after[0],
                         "after_next_batch": ref_after[1]},
           "port": {"before": before, "after_same_batch": after[0], "after_next_batch": after[1]},
           "max_param_diff": diffs[worst], "max_param_diff_leaf": worst}
    print(f"llama3.2-3b full width, {args.layers} layer(s), batch 1 x {args.seq}, bf16, "
          f"lr {args.lr:g}: loss on batch 0 before / after, batch 1 after")
    for who in ("reference", "port"):
        r = out[who]
        print(f"  {who:9s} {r['before']:.6f} -> {r['after_same_batch']:.6f}, "
              f"{r['after_next_batch']:.6f}")
    print(f"  port - reference: before {before - ref_before:+.3e}, after "
          f"{after[0] - ref_after[0]:+.3e} / {after[1] - ref_after[1]:+.3e}; largest parameter "
          f"difference after the step {diffs[worst]:.3e} ({worst})")
    return out


if __name__ == "__main__":
    main()
