#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA card (built for an H100: kernels target ``sm_90a``) and
``nvcc``. Phases, each printing its own lines; any failure ends the run with
a non-zero exit:

1. device   — the card's name and power limit (``nvidia-smi``);
2. build    — every CUDA kernel built from ``src/repro_torch/kernels/csrc``,
              with the build seconds and ptxas's register and spill report;
3. check    — each kernel against its plain PyTorch version on the card, at
              the main path's shapes and at ragged ones, within the stated
              tolerances, plus the autograd gradient of the likelihood;
4. main     — the paper's §8.1 logistic-regression pipeline at full width
              through ``repro_torch.api.Pipeline(spec).run()``: every kernel
              must have launched, and every logL2 must be finite and inside
              the band taken from the port's own run on the CPU;
5. timing   — CUDA-event times of each kernel and its plain version at the
              path's shapes, beside the least time the card could take;
6. summary  — one JSON line of the kernels, then the device line last.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and float32 rate
# outside the tensor cores; the bound of a kernel is the larger of
# bytes / HBM_BYTES_PER_S and flops / F32_FLOPS. It bounds the cold-L2 time:
# on the main path the inputs stay in the 50 MB L2 between calls, and the
# data sheet gives no L2 rate to bound that warm time with.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# logL2 band of the main path: the port's full-width run on the CPU
# (python -m repro_torch.launch.mcmc_run --device cpu --seeds 0 1 2) gave,
# per combiner, the seeds' values below; the card's run uses other random
# streams, so it is held to [min - margin, max + margin] over those seeds,
# with margin the seeds' own range.
CPU_LOGL2 = {
    "parametric": (65.08351135253906, 67.77391052246094, 63.4933967590332),
    "nonparametric": (62.122066497802734, 65.59532928466797, 61.72703170776367),
    "semiparametric": (67.17279815673828, 69.8927993774414, 63.936588287353516),
}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check_close(label, got, want, *, rtol, atol):
    """Max abs error of got vs want; raises unless |got−want| ≤ atol + rtol·|want|."""
    import torch

    got, want = got.double(), want.double()
    err = (got - want).abs()
    limit = atol + rtol * want.abs()
    max_err = float(err.max())
    ok = bool(torch.isfinite(got).all()) and bool((err <= limit).all())
    print(f"  {label}: max_abs_err={max_err:.3e} (rtol={rtol:g}, atol={atol:g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain version")
    return max_err


def device_ms(fn, *, iters=50, flush=None):
    """Mean device milliseconds per call of ``fn``, from CUDA events.

    The host needs tens of microseconds to enqueue one call, longer than the
    kernels run, so timing back-to-back calls would time the host. A GPU
    sleep longer than the whole enqueue is queued first: every call is on the
    stream before the device reaches the start event, and the calls run back
    to back. ``iters`` stays small enough that the stream's queue of pending
    launches never fills (a full queue would block the host until the sleep
    ends). With ``flush`` (a 256 MB write, > the 50 MB L2) between calls,
    each call is timed alone with its own events and starts from a cold L2.
    Returns ``(device_ms, host_enqueue_ms)`` per call.
    """
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        if flush is not None:
            flush()
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    # calibrate the sleep: cycles per millisecond on this card, now
    probe = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    probe[0].record()
    torch.cuda._sleep(10_000_000)
    probe[1].record()
    torch.cuda.synchronize()
    cycles = int(10_000_000 / probe[0].elapsed_time(probe[1]) * 3.0 * max(host_ms, 1.0))
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters if flush is not None else 1)]
    torch.cuda._sleep(cycles)  # three times the host's enqueue time
    sleep_done = torch.cuda.Event()
    sleep_done.record()
    if flush is None:
        events[0][0].record()
        for _ in range(iters):
            fn()
        events[0][1].record()
    else:
        for start, end in events:
            flush()
            start.record()
            fn()
            end.record()
    if sleep_done.query():
        raise AssertionError("the GPU sleep ended before the host had enqueued every call")
    torch.cuda.synchronize()
    total = sum(start.elapsed_time(end) for start, end in events)
    return total / iters, host_ms / iters


def main() -> int:
    import torch

    phase("1 device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs only on an "
              "NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}", flush=True)

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import kernels
    from repro_torch.api import Pipeline
    from repro_torch.kernels.img_weights import img_log_weights, img_log_weights_ref
    from repro_torch.kernels.logreg_loglik import (
        logreg_loglik,
        logreg_loglik_grad,
        logreg_loglik_grad_ref,
    )
    from repro_torch.launch.mcmc_run import PAPER_SPEC

    dev = torch.device("cuda", 0)

    phase("2 build")
    seconds = kernels.build()
    print(f"  build: {seconds:.2f} s", flush=True)
    for k in kernels.KERNELS.values():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "built earlier" in line:
                print(f"  {k.source.name}: {line.strip()}", flush=True)

    phase("3 kernel vs plain version on the card")
    gen = torch.Generator(device=dev).manual_seed(1234)

    def logreg_inputs(G, N, d, C):
        X = torch.randn((G, N, d), generator=gen, device=dev)
        y = torch.where(torch.rand((G, N), generator=gen, device=dev) < 0.5, -1.0, 1.0)
        beta = torch.randn((G, d, C), generator=gen, device=dev)  # the data's own β scale
        return X, y, beta

    # ℓ sums up to 50,000 terms of size ~10 in another order than the plain
    # version: float32 relative error ~1e-6, so rtol 1e-5; ∇ℓ entries the same
    # with atol for entries that cancel to ~0.
    errs = {}
    shapes = {"sample": (10, 5000, 50, 1), "groundtruth": (1, 50000, 50, 1),
              "N=1": (1, 1, 50, 1), "N=4999,d=37,C=2": (3, 4999, 37, 2)}
    for label, shape in shapes.items():
        X, y, beta = logreg_inputs(*shape)
        ll, g = logreg_loglik_grad(X, y, beta, scale=0.5)
        torch.cuda.synchronize()
        ll_r, g_r = logreg_loglik_grad_ref(X, y, beta, scale=0.5)
        e1 = check_close(f"logreg_loglik_grad {label} {shape} ll", ll, ll_r, rtol=1e-5, atol=1e-3)
        e2 = check_close(f"logreg_loglik_grad {label} {shape} grad", g, g_r, rtol=1e-4, atol=1e-2)
        errs["logreg_loglik_grad"] = max(errs.get("logreg_loglik_grad", 0.0), e1, e2)
    X, y, beta = logreg_inputs(10, 5000, 50, 1)
    b1 = beta.clone().requires_grad_(True)
    (g_kernel,) = torch.autograd.grad(logreg_loglik(X, y, b1).sum(), b1)
    torch.cuda.synchronize()
    b2 = beta.clone().requires_grad_(True)
    (g_plain,) = torch.autograd.grad(logreg_loglik_grad_ref(X, y, b2)[0].sum(), b2)
    e = check_close("autograd of logreg_loglik vs autograd of the plain ℓ", g_kernel, g_plain,
                    rtol=1e-4, atol=1e-2)
    errs["logreg_loglik_grad"] = max(errs["logreg_loglik_grad"], e)

    # log w ~ −SSE/(2h²) of size ~1e5 at h=0.05: float32 relative error ~1e-6
    for label, (P, M, d, h) in {"sweep": (160, 10, 50, 0.05), "P=161,d=37": (161, 10, 37, 0.3),
                                "P=1,M=1,d=1": (1, 1, 1, 1.0)}.items():
        theta = torch.randn((P, M, d), generator=gen, device=dev)
        h_t = torch.tensor(h, device=dev)
        out = img_log_weights(theta, h_t)
        torch.cuda.synchronize()
        e = check_close(f"img_log_weights {label} {(P, M, d)} h={h}", out,
                        img_log_weights_ref(theta, h_t), rtol=1e-5, atol=1e-3)
        errs["img_log_weights"] = max(errs.get("img_log_weights", 0.0), e)

    phase("4 main path: Pipeline(spec).run() on the card")
    print(f"  spec {PAPER_SPEC.to_json()}", flush=True)
    kernels.reset_launches()
    board = Pipeline(PAPER_SPEC).run()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(board.table(), flush=True)
    print(f"  accept={board.accept:.4f} timings_s={json.dumps(board.timings)}", flush=True)
    print(f"  launches={json.dumps(launches)}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
    for name, err in board.errors.items():
        seeds = CPU_LOGL2[name]
        margin = max(seeds) - min(seeds)
        lo, hi = min(seeds) - margin, max(seeds) + margin
        ok = math.isfinite(err) and lo <= err <= hi
        print(f"  logL2({name}) = {err:.4f}, band [{lo:.4f}, {hi:.4f}] "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"logL2({name}) = {err} outside its band")

    phase("5 timing (CUDA events)")
    flush_buf = torch.empty(256 * 1024 * 1024 // 4, device=dev)  # 256 MB > 50 MB L2

    def flush():
        flush_buf.zero_()

    rows = []
    for label, (G, N, d, C) in {"sample": (10, 5000, 50, 1), "groundtruth": (1, 50000, 50, 1)}.items():
        X, y, beta = logreg_inputs(G, N, d, C)
        nbytes = 4 * (G * N * d + G * N + G * d * C + G * C + G * d * C)
        flops = 4 * G * N * d * C + 10 * G * N * C
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
        bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS else "operations"
        ms, host = device_ms(lambda: logreg_loglik_grad(X, y, beta))
        cold, _ = device_ms(lambda: logreg_loglik_grad(X, y, beta), flush=flush)
        plain, plain_host = device_ms(lambda: logreg_loglik_grad_ref(X, y, beta))
        print(f"  logreg_loglik_grad {label} G={G} N={N} d={d} C={C}: kernel {ms * 1e3:.2f} us "
              f"(cold L2 {cold * 1e3:.2f} us; host enqueue {host * 1e3:.2f} us/call), "
              f"plain {plain * 1e3:.2f} us (host {plain_host * 1e3:.2f} us/call), "
              f"HBM bound {bound * 1e3:.2f} us by {bound_by} (bounds the cold-L2 time)", flush=True)
        if label == "sample":
            rows.append({"name": "logreg_loglik_grad", "ms": ms, "cold_ms": cold, "host_ms": host,
                         "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
                         "shape": f"G={G} N={N} d={d} C={C}"})
    P, M, d = 160, 10, 50
    theta = torch.randn((P, M, d), generator=gen, device=dev)
    h_t = torch.tensor(0.05, device=dev)
    nbytes = 4 * (P * M * d + 1 + P)
    flops = 4 * P * M * d
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS else "operations"
    ms, host = device_ms(lambda: img_log_weights(theta, h_t))
    cold, _ = device_ms(lambda: img_log_weights(theta, h_t), flush=flush)
    plain, plain_host = device_ms(lambda: img_log_weights_ref(theta, h_t))
    print(f"  img_log_weights P={P} M={M} d={d}: kernel {ms * 1e3:.2f} us "
          f"(cold L2 {cold * 1e3:.2f} us; host enqueue {host * 1e3:.2f} us/call), "
          f"plain {plain * 1e3:.2f} us (host {plain_host * 1e3:.2f} us/call), "
          f"HBM bound {bound * 1e3:.3f} us by {bound_by} (bounds the cold-L2 time)", flush=True)
    rows.append({"name": "img_log_weights", "ms": ms, "cold_ms": cold, "host_ms": host,
                 "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
                 "shape": f"P={P} M={M} d={d}"})

    phase("6 summary")
    sources = {"logreg_loglik_grad": "src/repro_torch/kernels/csrc/logreg_loglik.cu",
               "img_log_weights": "src/repro_torch/kernels/csrc/img_weights.cu"}
    out = []
    for r in rows:
        k = kernels.KERNELS[r["name"]]
        out.append({
            "name": r["name"], "route": "cuda", "source": sources[r["name"]],
            "replaces": k.replaces, "launches": launches[r["name"]],
            "max_abs_err": errs[r["name"]], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "cold_ms": r["cold_ms"], "host_ms": r["host_ms"], "shape": r["shape"],
        })
    print(json.dumps({"kernels": out}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
