"""A card study of AdamW's first step at one layer: which part of the model raises the loss.

    PYTHONPATH=src python -m repro_torch.launch.adam_probe

At ``--layers 1`` the first AdamW step at the reference's fixed rate, 3e-4,
raises the loss of deepseek-v2-236b (and of llama3.2-3b). For each of the two
archs at one layer and full width, batch 1 × 4,096, bf16 (the config's
dtypes), the model and its AdamW state drawn as ``train.main`` draws them
(``--seed 0``), it prints the total loss on the stream's batches 0 and 1
before and after one ``lm_steps.train_step`` on batch 0 at each of the
rates 3e-4, 1e-4, 3e-5 and 1e-5 (:func:`first_step`). At 3e-4 it also
prints batch 1's loss with the step applied to one part of the model alone
(an attention, a norm, an MLP, the embedding, the head), the rest as drawn,
and batch 0's loss after a plain gradient step of length 0.01, 0.1 and 1
along −g/‖g‖ (whether the gradient itself points downhill). Exits 2
without a card.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.models.lm import steps as lm_steps
from repro_torch.models.lm.config import ModelConfig

ARCHS = ("deepseek-v2-236b", "llama3.2-3b")
RATES = (3e-4, 1e-4, 3e-5, 1e-5)
GRADIENT_STEPS = (0.01, 0.1, 1.0)


def _part(name: str) -> str:
    """The part of the model a parameter belongs to: ``blocks.<i>.<module>``
    or its top-level module."""
    bits = name.split(".")
    return ".".join(bits[:3]) if bits[0] == "blocks" else bits[0]


@torch.no_grad()
def _loss(model, cfg: ModelConfig, batch) -> float:
    return float(lm_steps.loss_fn(model, cfg, batch)[0])


def first_step(cfg: ModelConfig, lr: float, *, seed: int = 0, batch: int = 1, seq: int = 4096,
               device: torch.device, parts: bool = False) -> Dict:
    """One AdamW step on batch 0 of ``train.main``'s stream at rate ``lr``,
    on the model and state ``train.main`` draws from ``seed``. Returns
    ``{"before": [b0, b1], "after": [b0, b1]}`` (total losses on batches 0
    and 1); with ``parts``, also ``"parts"`` (batch 1's loss with the step
    applied to one part alone) and ``"gradient"`` (batch 0's loss after a
    step of each length in ``GRADIENT_STEPS`` along −g/‖g‖, and ‖g‖)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model, opt = lm_steps.init_train_state(gen, cfg, device=device)
    stream = TokenStream(cfg.vocab_size, batch, seq, seed=seed, device=device)
    b0, b1 = stream.batch(0), stream.batch(1)
    params = dict(model.named_parameters())
    before = [_loss(model, cfg, b) for b in (b0, b1)]
    drawn = {n: p.detach().clone() for n, p in params.items()} if parts else None
    lm_steps.train_step(model, opt, b0, cfg, lr=lr)
    out = {"before": before, "after": [_loss(model, cfg, b) for b in (b0, b1)]}
    if not parts:
        return out
    stepped = {n: p.detach().clone() for n, p in params.items()}
    out["parts"] = {}
    with torch.no_grad():
        for part in sorted({_part(n) for n in params}):
            for n, p in params.items():
                p.copy_(stepped[n] if _part(n) == part else drawn[n])
            out["parts"][part] = _loss(model, cfg, b1)
        for n, p in params.items():
            p.copy_(drawn[n])
    del stepped
    total = lm_steps.loss_fn(model, cfg, b0)[0]
    grads = list(lm_steps.grads_of(total, params).values())
    norm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
    out["gradient"] = {"norm": norm}
    with torch.no_grad():
        for eps in GRADIENT_STEPS:
            for (n, p), g in zip(params.items(), grads):
                p.copy_(drawn[n].float() - (eps / norm) * g.float())
            out["gradient"][eps] = _loss(model, cfg, b0)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    del argv  # no options
    if not torch.cuda.is_available():
        print("adam_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    for arch in ARCHS:
        cfg = dataclasses.replace(get_config(arch), num_layers=1)
        for lr in RATES:
            r = first_step(cfg, lr, device=dev, parts=lr == RATES[0])
            print(f"{arch} 1 layer lr {lr:g}: loss batch0 {r['before'][0]:.4f} -> "
                  f"{r['after'][0]:.4f}, batch1 {r['before'][1]:.4f} -> {r['after'][1]:.4f}",
                  flush=True)
            for part, loss in r.get("parts", {}).items():
                print(f"   only {part} stepped: batch1 loss {loss:.4f}", flush=True)
            if "gradient" in r:
                g = r["gradient"]
                for eps in GRADIENT_STEPS:
                    print(f"   gradient step {eps:g} along -g/|g| (|g| {g['norm']:.4e}): "
                          f"batch0 loss {r['before'][0]:.4f} -> {g[eps]:.4f}", flush=True)
            del r
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
