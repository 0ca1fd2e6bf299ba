"""Where the device time of the paper's pipeline goes, from torch.profiler.

    PYTHONPATH=src python -m repro_torch.launch.profile_pipeline [--combiner all] [--stream-every 120]
        [--mesh-shape 2,1 --devices cuda:0,cuda:0]

Runs ``Pipeline(spec).run()`` (``PAPER_SPEC``, or ``ALL_SPEC`` with
``--combiner all``; the same choices as ``mcmc_run``; with ``--stream-every
N`` the fused ``stream_combine()`` first, then the scoreboard from its
finals) on the card once to warm up, once unprofiled, then once under
``torch.profiler`` (CUDA activity only), and prints one JSON line: the spec,
the wall seconds of both timed runs, the device time summed over kernels,
the device's busy and idle shares of the profiled run's wall time, its stage
times, and the kernels that took the most device time with their launch
counts. With ``--mesh-shape`` the chains run in groups on ``--devices`` (two
groups may share a card, each on its own stream), and the line also gives,
from the trace, each stream's kernels and busy time and the time in which
two or more streams ran kernels at once (``streams``, ``overlap_ms``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Any, Optional, Sequence, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.api import Pipeline
from repro_torch.launch.mcmc_run import add_combiner_option, spec_for

TOP_KERNELS = 12


def run(spec, devices=None):
    """The spec's scoreboard; a streaming spec combines while it samples."""
    pipe = Pipeline(spec, **(dict(devices=devices) if devices else {}))
    if spec.stream_every > 0:
        pipe.stream_combine()
    return pipe.run()


def _union_ms(spans) -> float:
    """The length of the union of ``(start, end)`` spans, in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def stream_overlap(prof) -> dict:
    """Each stream's kernels and busy ms in ``prof``'s trace, and the ms in
    which two or more streams ran kernels at once (the sum of the streams'
    busy times less the busy time of all together)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans: dict = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            key = f"{e['args'].get('device', 0)}:{e['args'].get('stream')}"
            spans.setdefault(key, []).append((e["ts"], e["ts"] + e["dur"]))
    busy = {k: _union_ms(v) for k, v in spans.items()}
    every = _union_ms([s for v in spans.values() for s in v])
    return {
        "streams": {k: {"kernels": len(spans[k]), "busy_ms": busy[k]} for k in sorted(spans)},
        "overlap_ms": sum(busy.values()) - every,
    }


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
        **stream_overlap(prof),
    }


def by_operator(fn) -> Tuple[Any, dict]:
    """``fn()`` under a profile that records the host's operators too (which
    costs host time, so no wall is reported): its result, the device ms of
    the operators that took the most (self time: the kernels each launched
    itself), and of every ``record_function`` range named ``ssd.*``
    (inclusive: every kernel launched inside it; the Mamba-2 SSD's
    ``ssd.decay``, ``ssd.products``, ``ssd.chunk_scan``)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU]
    ops = sorted((e for e in events if e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)[:TOP_KERNELS]
    return result, {
        "device_ms_by_operator": [{"name": e.key[:80], "count": e.count,
                                   "device_ms": e.self_device_time_total / 1e3} for e in ops],
        "device_ms_by_range": {e.key: {"count": e.count, "device_ms": e.device_time_total / 1e3}
                               for e in events if e.key.startswith("ssd.")},
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_combiner_option(ap)
    ap.add_argument("--stream-every", type=int, default=0,
                    help="profile the fused combine-while-sampling run at this cadence")
    ap.add_argument("--mesh-shape", default=None, metavar="NDATA[,NMODEL]",
                    help="run the chains in this many groups")
    ap.add_argument("--devices", default=None,
                    help="the groups' devices, comma-separated (a device may repeat)")
    args = ap.parse_args(argv)
    spec = dataclasses.replace(spec_for(args.combiner), stream_every=args.stream_every)
    if args.mesh_shape:
        spec = dataclasses.replace(
            spec, mesh_shape=tuple(int(x) for x in args.mesh_shape.split(",")))
    devices = tuple(args.devices.split(",")) if args.devices else None
    run(spec, devices)  # warm-up: allocator, cuBLAS/cuSOLVER handles, kernel build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(spec, devices)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    board, window = profiled(lambda: run(spec, devices))
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
        "backend": board.backend,
        "streams": window["streams"],
        "overlap_ms": window["overlap_ms"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
