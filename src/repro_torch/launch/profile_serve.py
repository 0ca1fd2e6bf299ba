"""Where the device time of the LM sidecar's serving path goes, from torch.profiler.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch llama3.2-3b \\
        --batch 2 --prompt-len 4096 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch mamba2-130m \\
        --batch 2 --prompt-len 4096 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch jamba-1.5-large-398b \\
        --layers 5 --batch 2 --prompt-len 4096 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch whisper-base \\
        --batch 2 --prompt-len 4096 --gen 16

Takes ``repro_torch.launch.serve``'s flags. Builds the model and prompt from
the seed, runs prefill + greedy decode once to warm up, once unprofiled, then
profiles the prefill and the decode steps in two windows (CUDA activity
only), and prints one JSON line: the card, the config, the unprofiled stage
times, and for each window its wall seconds, the device time summed over
kernels, the device's busy and idle shares of the window's wall time, and
the kernels that took the most device time with their launch counts, and
the device time by operator and by the Mamba-2 SSD's ranges from a third
run of each under a profile that records the host's operators too
(``profile_pipeline.by_operator``; its wall is not reported). The prompt
must be longer than the config's ``attn_chunk`` for an attention prefill to
reach the flash kernel. An encoder–decoder config is fed ``serve``'s zero
frames, and its prefill window includes the encoder; a vlm config ``serve``'s
zero image embeddings, the prefix in the caches' length (``serve.cache_len``).
"""

from __future__ import annotations

import json
import sys
from typing import Optional, Sequence

import torch

from repro_torch.launch import serve
from repro_torch.launch.profile_pipeline import by_operator, profiled
from repro_torch.models.lm import steps as lm_steps


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = serve.parse(argv)
    cfg, model, prompt = serve.setup(args)
    if prompt.device.type != "cuda":
        raise RuntimeError("profile_serve measures the card; run it on cuda")
    max_len = serve.cache_len(cfg, args.prompt_len, args.gen)
    batch = serve.serve_batch(cfg, prompt)
    serve.generate(model, prompt, args.gen)  # warm-up: allocator, cuBLAS handles, kernel build
    timed = serve.generate(model, prompt, args.gen)
    state, prefill = profiled(lambda: lm_steps.serve_prefill(model, batch, max_len))

    def decode(state):
        for _ in range(args.gen - 1):
            state, _ = lm_steps.serve_decode_step(model, state)

    _, decode_window = profiled(lambda: decode(state))
    del state
    state, prefill_ops = by_operator(lambda: lm_steps.serve_prefill(model, batch, max_len))
    _, decode_ops = by_operator(lambda: decode(state))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype, "batch": args.batch,
        "prompt_len": args.prompt_len, "gen": args.gen,
        "unprofiled": {"prefill_s": timed["prefill_s"],
                       "decode_s_per_tok": timed["decode_s_per_tok"]},
        "prefill": dict(prefill, **prefill_ops),
        "decode": dict(decode_window, steps=args.gen - 1, **decode_ops),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
