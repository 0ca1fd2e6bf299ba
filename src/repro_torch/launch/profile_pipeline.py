"""Where the device time of the paper's pipeline goes, from torch.profiler.

    PYTHONPATH=src python -m repro_torch.launch.profile_pipeline

Runs ``Pipeline(PAPER_SPEC).run()`` on the card once to warm up, once
unprofiled, then once under ``torch.profiler`` (CUDA activity only), and
prints one JSON line: the wall seconds of both timed runs, the device time
summed over kernels, the device's busy and idle shares of the profiled run's
wall time, its stage times, and the kernels that took the most device time
with their launch counts.
"""

from __future__ import annotations

import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.api import Pipeline
from repro_torch.launch.mcmc_run import PAPER_SPEC

TOP_KERNELS = 12


def main() -> int:
    Pipeline(PAPER_SPEC).run()  # warm-up: allocator, cuBLAS/cuSOLVER handles, kernel build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Pipeline(PAPER_SPEC).run()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    # device activity only: tracing every CPU op would slow the host-bound
    # run and understate the busy share
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        board = Pipeline(PAPER_SPEC).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side rows only: a CPU op's row also carries the device time of
    # the kernels it launched, which have rows of their own
    rows = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    device_us = sum(e.self_device_time_total for e in rows)
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "wall_s": wall,
        "unprofiled_wall_s": plain_wall,
        "device_kernel_s": device_us / 1e6,
        "busy_share": device_us / 1e6 / wall,
        "idle_share": 1.0 - device_us / 1e6 / wall,
        "timings_s": board.timings,
        "errors": board.errors,
        "top_kernels": [
            {"name": e.key[:80], "count": e.count, "device_ms": e.self_device_time_total / 1e3}
            for e in rows[:TOP_KERNELS]
        ],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
