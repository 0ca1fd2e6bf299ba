"""Serving CLI of the LM sidecar: batched prefill + greedy decode against the KV caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b --batch 2 \\
        --prompt-len 4096 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --reduced \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b --layers 4 \\
        --batch 2 --prompt-len 4096 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --batch 1 \\
        --prompt-len 524288 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-1.5-large-398b --reduced \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-1.5-large-398b --layers 5 \\
        --batch 2 --prompt-len 4096 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base --batch 2 \\
        --prompt-len 4096 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llava-next-mistral-7b --reduced \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llava-next-mistral-7b --batch 2 \\
        --prompt-len 4096 --gen 16

The port of ``repro/launch/serve.py:25``, with its flags plus ``--device``
(default ``cuda``; with no card visible it raises), ``--dtype`` (the
weights' and activations' dtype, default the config's: bfloat16 at full
width, float32 under ``--reduced``) and ``--layers`` (cut the depth, the
width unchanged, as ``launch/train.py``'s; 0 keeps the config's: a 236 B
deepseek-v2 is served on one card only so cut). Weights are random, drawn from
``--seed`` by a ``torch.Generator`` (other numbers than the reference's
``jax.random`` draws), then the prompt from the same generator;
``max_len = prompt_len + gen`` (+ the image prefix, :func:`cache_len`).
The dense and MoE families, GQA or MLA (see
:mod:`repro_torch.models.lm.model`; ``--arch granite-moe-1b-a400m``, whose
decode runs ``cfg.moe_decode_impl``'s MoE; ``--arch deepseek-v2-236b``,
MLA, whose decode attends over the absorbed latent cache), and the ssm
family (``--arch mamba2-130m``: the chunked SSD in prefill, one recurrent
step a token in decode, no kernel of the port's; the prompt must divide
into SSD chunks, ``mamba2.check_seq``, and ``long_500k``'s 524,288 tokens
do), the hybrid (``--arch jamba-1.5-large-398b``, Mamba-2 and GQA layers with
MLPs and MoEs; the SSD's chunk check too; served on one card with
``--layers 5``, the first five layers of its period, every kind it has) and
the encoder–decoder (``--arch whisper-base``: as the reference's CLI, the
encoder is fed zero frames (B, ``encoder_seq``, d), its memory kept for every
decode step's cross-attention) and the vlm (``--arch llava-next-mistral-7b``:
as the reference's CLI, zero image embeddings (B, ``num_image_tokens``,
``VISION_WIDTH``) go through ``img_proj`` before the prompt, so prefill
runs 576 positions more and decode starts after them). A prompt longer than the config's
``attn_chunk`` (1,024) runs every attention layer's prefill through the
flash kernel (Whisper's encoder at its 1,500 frames too, non-causal);
decode attends over the cache with the einsum path. Each timed stage ends
with ``torch.cuda.synchronize()`` on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs import ALIASES, get_config
from repro_torch.models.lm import mamba2
from repro_torch.models.lm import model as mdl
from repro_torch.models.lm import steps as lm_steps
from repro_torch.models.lm.config import VISION_WIDTH, ModelConfig, reduced
from repro_torch.models.lm.layers import DTYPES


def parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                    help="weights and activations (default: the config's)")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0 = the config's)")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace) -> Tuple[ModelConfig, mdl.LM, torch.Tensor]:
    """(config, model, prompt (B, prompt_len) int64), all from ``args.seed``."""
    device = resolve_device(args.device)
    cfg = get_config(ALIASES.get(args.arch, args.arch))
    if args.reduced:
        cfg = reduced(cfg)
    if args.dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=args.dtype, param_dtype=args.dtype)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if cfg.ssm is not None:
        mamba2.check_seq(cfg, args.prompt_len)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = mdl.init_params(cfg, generator=gen, device=device)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
                           device=device)
    return cfg, model, prompt


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(cfg: ModelConfig, prompt: torch.Tensor,
                enc_frames: Optional[torch.Tensor] = None,
                img_embeds: Optional[torch.Tensor] = None) -> dict:
    """The prefill's batch: the prompt; for an encoder–decoder config
    ``enc_frames``, zeros (B, ``cfg.encoder_seq``, d) unless given; for a
    vlm config ``img_embeds``, zeros (B, ``cfg.num_image_tokens``,
    ``VISION_WIDTH``) unless given (the reference's CLI feeds zeros to both)."""
    batch = {"tokens": prompt}
    if cfg.num_encoder_layers:
        batch["enc_frames"] = enc_frames if enc_frames is not None else torch.zeros(
            (prompt.shape[0], cfg.encoder_seq, cfg.d_model), device=prompt.device)
    if cfg.num_image_tokens:
        batch["img_embeds"] = img_embeds if img_embeds is not None else torch.zeros(
            (prompt.shape[0], cfg.num_image_tokens, VISION_WIDTH), device=prompt.device)
    return batch


def cache_len(cfg: ModelConfig, prompt_len: int, gen: int) -> int:
    """The caches' length for a prompt and ``gen`` tokens: a vlm's image
    prefix (always fed, :func:`serve_batch`) takes ``cfg.num_image_tokens``
    positions before them, as the reference's ``max_len``."""
    return prompt_len + gen + cfg.num_image_tokens


def generate(model: mdl.LM, prompt: torch.Tensor, gen: int, *,
             enc_frames: Optional[torch.Tensor] = None,
             img_embeds: Optional[torch.Tensor] = None) -> dict:
    """Prefill, then ``gen - 1`` greedy decode steps: ``gen`` tokens a row.

    Returns ``tokens`` (B, gen), ``logits`` (B, gen, V) float32 (row t chose
    token t), ``prefill_s``, ``decode_s_per_tok``, ``max_len`` (the caches'
    length, :func:`cache_len`), ``enc_frames`` and ``img_embeds`` (the
    encoder's input and the image prefix, :func:`serve_batch`; None for a
    config without them).
    """
    device = prompt.device
    max_len = cache_len(model.cfg, prompt.shape[1], gen)
    batch = serve_batch(model.cfg, prompt, enc_frames, img_embeds)
    _sync(device)
    t0 = time.perf_counter()
    state = lm_steps.serve_prefill(model, batch, max_len)
    _sync(device)
    t1 = time.perf_counter()
    tokens, logits = [state.last_token], [state.logits]
    for _ in range(gen - 1):
        state, step_logits = lm_steps.serve_decode_step(model, state)
        tokens.append(state.last_token)
        logits.append(step_logits)
    _sync(device)
    t2 = time.perf_counter()
    return {
        "tokens": torch.cat(tokens, dim=1),
        "logits": torch.cat(logits, dim=1).float(),
        "prefill_s": t1 - t0,
        "decode_s_per_tok": (t2 - t1) / max(gen - 1, 1),
        "max_len": max_len,
        "enc_frames": batch.get("enc_frames"),
        "img_embeds": batch.get("img_embeds"),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns :func:`generate`'s dict plus the ``prompt``."""
    args = parse(argv)
    cfg, model, prompt = setup(args)
    out = generate(model, prompt, args.gen)
    tokens = out["tokens"]
    print(f"{cfg.name} on {prompt.device} ({cfg.dtype}): prefill {args.batch}×{args.prompt_len}: "
          f"{out['prefill_s']:.2f}s; decode {args.gen} tokens: "
          f"{out['decode_s_per_tok'] * 1e3:.1f} ms/token")
    print("generated token ids (first row):", tokens[0].tolist())
    if not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError("a generated token lies outside the vocabulary")
    return dict(out, prompt=prompt)


if __name__ == "__main__":
    main()
