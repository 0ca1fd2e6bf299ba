"""Where the time of an LM training step goes, from torch.profiler.

    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch granite-moe-1b-a400m \\
        --batch 1 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch mamba2-130m \\
        --batch 8 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch jamba-1.5-large-398b \\
        --layers 1 --batch 1 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch whisper-base \\
        --batch 4 --seq 4096

``launch/train.py``'s adamw mode on the card at the config's full depth, or
``--layers`` (random weights and AdamW state from seed 0, the token stream
of seed 0, the config's remat; an encoder–decoder config's batches carry
frames (B, ``encoder_seq``, d) drawn from seed 0, so that its encoder runs,
where ``train.py`` feeds tokens alone),
after the hand-written kernels are built: the first
step timed alone and profiled on the host (it carries the process's first
use of every other kernel, and of each cuBLAS shape; its operators by their
own host time), ``WARM`` more steps, then one step's forward + backward (``loss_fn`` and
its gradients) and its AdamW update profiled apart with device activity
only. Prints one JSON line: the card, the config, the first step's seconds
and its top operators by host time, and for each window its wall seconds,
the device time summed over kernels, the device's busy and idle shares of
the window's wall time and the kernels that took the most device time,
with, for the forward + backward, the device time by operator and by the
Mamba-2 SSD's ranges (``profile_pipeline.by_operator``) from a second
profile that records the host's operators too (which costs host time, so
its wall is not reported).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional, Sequence

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.launch.profile_pipeline import by_operator, profiled
from repro_torch.models.lm import steps as lm_steps
from repro_torch.optim import adamw_update

TOP = 12
WARM = 2  # steps between the first and the profiled one
SEED = 0


def _rows(prof, key: str, device_type):
    rows = [e for e in prof.key_averages() if e.device_type == device_type
            and getattr(e, key) > 0]
    rows.sort(key=lambda e: getattr(e, key), reverse=True)
    return rows[:TOP]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0 = the config's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train measures the card; no CUDA device is visible")
    dev = torch.device("cuda", 0)
    build_s = kernels.build()
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model, opt = lm_steps.init_train_state(gen, cfg, device=dev)
    tokens = TokenStream(cfg.vocab_size, args.batch, args.seq, seed=SEED, device=dev)
    frames = None
    if cfg.num_encoder_layers:
        frames = torch.randn((args.batch, cfg.encoder_seq, cfg.d_model), generator=gen,
                             device=dev)

    def batch_at(step):
        b = tokens.batch(step)
        return b if frames is None else dict(b, enc_frames=frames)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as cold_prof:
        t0 = time.perf_counter()
        model, opt, _ = lm_steps.train_step(model, opt, batch_at(0), cfg)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    cold_ops = [{"name": e.key[:80], "count": e.count, "self_host_ms": e.self_cpu_time_total / 1e3}
                for e in _rows(cold_prof, "self_cpu_time_total", torch.autograd.DeviceType.CPU)]
    for step in range(1, 1 + WARM):
        model, opt, _ = lm_steps.train_step(model, opt, batch_at(step), cfg)
    batch = batch_at(1 + WARM)
    params = dict(model.named_parameters())

    def fwd_bwd():
        total, _ = lm_steps.loss_fn(model, cfg, batch)
        return lm_steps.grads_of(total, params)

    grads, fb_window = profiled(fwd_bwd)
    _, update_window = profiled(lambda: adamw_update(params, grads, opt))
    del grads
    grads, by_op = by_operator(fwd_bwd)
    del grads
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "arch": cfg.name, "layers": cfg.num_layers,
        "dtype": cfg.dtype, "remat": cfg.remat, "batch": args.batch, "seq": args.seq,
        "enc_frames": frames is not None,
        "build_s": build_s, "first_step_s": first_s, "first_step_top_host_ops": cold_ops,
        "forward_backward": dict(fb_window, **by_op),
        "update": update_window,
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
