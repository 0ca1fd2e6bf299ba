"""Where the device time of the paper's pipeline goes, from torch.profiler.

    PYTHONPATH=src python -m repro_torch.launch.profile_pipeline [--combiner all] [--stream-every 120]

Runs ``Pipeline(spec).run()`` (``PAPER_SPEC``, or ``ALL_SPEC`` with
``--combiner all``; the same choices as ``mcmc_run``; with ``--stream-every
N`` the fused ``stream_combine()`` first, then the scoreboard from its
finals) on the card once to warm up, once unprofiled, then once under
``torch.profiler`` (CUDA activity only), and prints one JSON line: the spec,
the wall seconds of both timed runs, the device time summed over kernels,
the device's busy and idle shares of the profiled run's wall time, its stage
times, and the kernels that took the most device time with their launch
counts.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Optional, Sequence, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.api import Pipeline
from repro_torch.launch.mcmc_run import add_combiner_option, spec_for

TOP_KERNELS = 12


def run(spec):
    """The spec's scoreboard; a streaming spec combines while it samples."""
    pipe = Pipeline(spec)
    if spec.stream_every > 0:
        pipe.stream_combine()
    return pipe.run()


def profiled(fn) -> Tuple[Any, dict]:
    """``fn()`` under the profiler: its result, and its wall seconds, the
    device time summed over kernels, the device's busy and idle shares of
    the wall, and the kernels that took the most device time."""
    torch.cuda.synchronize()
    # device activity only: tracing every CPU op would slow a host-bound
    # run and understate the busy share
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side rows only: a CPU op's row also carries the device time of
    # the kernels it launched, which have rows of their own
    rows = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    device_s = sum(e.self_device_time_total for e in rows) / 1e6
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return result, {
        "wall_s": wall,
        "device_kernel_s": device_s,
        "busy_share": device_s / wall,
        "idle_share": 1.0 - device_s / wall,
        "top_kernels": [
            {"name": e.key[:80], "count": e.count, "device_ms": e.self_device_time_total / 1e3}
            for e in rows[:TOP_KERNELS]
        ],
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_combiner_option(ap)
    ap.add_argument("--stream-every", type=int, default=0,
                    help="profile the fused combine-while-sampling run at this cadence")
    args = ap.parse_args(argv)
    spec = dataclasses.replace(spec_for(args.combiner), stream_every=args.stream_every)
    run(spec)  # warm-up: allocator, cuBLAS/cuSOLVER handles, kernel build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(spec)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    board, window = profiled(lambda: run(spec))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "spec": spec.to_json(),
        "wall_s": window["wall_s"],
        "unprofiled_wall_s": plain_wall,
        "device_kernel_s": window["device_kernel_s"],
        "busy_share": window["busy_share"],
        "idle_share": window["idle_share"],
        "timings_s": board.timings,
        "errors": board.errors,
        "top_kernels": window["top_kernels"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
