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
              the main paths' shapes and at ragged ones, within the stated
              tolerances, plus the autograd gradient of the likelihood; the
              KDE kernel also against its plain version in float64;
4. main     — the paper's §8.1 logistic-regression pipeline at full width
              through ``repro_torch.api.Pipeline(PAPER_SPEC).run()``: its
              kernels must have launched, and every logL2 must be finite and
              inside the band taken from the port's own run on the CPU;
4b. all     — the same run scoring every registered combiner
              (``ALL_SPEC``): the KDE kernel must have launched, the eleven
              logL2 values must sit inside their CPU bands and the first
              three must equal phase 4's; per-combiner seconds after it;
5. timing   — CUDA-event times of each kernel and its plain version at the
              paths' shapes, beside the least time the card could take;
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
# the same rule for ALL_SPEC, from
# python -m repro_torch.launch.mcmc_run --device cpu --seeds 0 1 2 --combiner all
CPU_LOGL2_ALL = {
    "consensus": (64.06085968017578, 67.2729721069336, 61.91144561767578),
    "importance_pool": (62.1065559387207, 65.81645965576172, 61.72952651977539),
    "nonparametric": (62.1065559387207, 65.81645965576172, 61.72952651977539),
    "online": (64.88431549072266, 67.75463104248047, 63.52260971069336),
    "parametric": (65.08346557617188, 67.7774658203125, 63.49346923828125),
    "pool": (62.1065559387207, 65.81645965576172, 61.72952651977539),
    "rpt": (62.1065559387207, 65.81645965576172, 61.72952651977539),
    "semiparametric": (67.17279815673828, 69.89285278320312, 63.93661880493164),
    "semiparametric_w": (67.75870513916016, 69.7479248046875, 66.40629577636719),
    "subpost_average": (62.10725784301758, 65.8286361694336, 61.729530334472656),
    "weierstrass": (62.10939025878906, 66.1889419555664, 61.72953414916992),
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


def check_lp(label, got, want, *, rtol, atol):
    """check_close for log densities: −inf (an empty machine) in the same
    places on both sides, no NaN, the finite entries within the tolerance."""
    import torch

    got, want = got.double(), want.double()
    same_inf = bool(torch.equal(torch.isneginf(got), torch.isneginf(want)))
    fin = torch.isfinite(want)
    err = (got - want)[fin].abs()
    max_err = float(err.max()) if err.numel() else 0.0
    ok = (same_inf and not bool(torch.isnan(got).any())
          and bool((err <= atol + rtol * want[fin].abs()).all()))
    print(f"  {label}: max_abs_err={max_err:.3e} (rtol={rtol:g}, atol={atol:.3g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain version")
    return max_err


def check_bands(board, bands):
    """Every logL2 of ``board`` finite and inside [min − r, max + r] of its
    CPU seeds, r their range."""
    if set(board.errors) != set(bands):
        raise AssertionError(f"scoreboard keys {sorted(board.errors)} != {sorted(bands)}")
    for name, err in sorted(board.errors.items()):
        seeds = bands[name]
        margin = max(seeds) - min(seeds)
        lo, hi = min(seeds) - margin, max(seeds) + margin
        ok = math.isfinite(err) and lo <= err <= hi
        print(f"  logL2({name}) = {err:.4f}, band [{lo:.4f}, {hi:.4f}] "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"logL2({name}) = {err} outside its band")


def least_ms(nbytes, flops):
    """(least ms, what bounds it): bytes over the HBM rate or flops over the
    float32 rate, whichever is larger."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops else "operations")


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

    root = os.path.dirname(os.path.realpath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import kernels
    from repro_torch.api import Pipeline
    from repro_torch.api.pipeline import combine_spec_draws
    from repro_torch.core.combiners import masked_silverman
    from repro_torch.kernels.img_weights import img_log_weights, img_log_weights_ref
    from repro_torch.kernels.kde_density import (
        kde_log_density,
        kde_log_density_ref,
        machine_kde_log_density,
        machine_kde_log_density_ref,
    )
    from repro_torch.kernels.logreg_loglik import (
        logreg_loglik,
        logreg_loglik_grad,
        logreg_loglik_grad_ref,
    )
    from repro_torch.launch.mcmc_run import ALL_SPEC, PAPER_SPEC

    dev = torch.device("cuda", 0)

    phase("2 build")
    seconds = kernels.build()
    print(f"  build: {seconds:.2f} s", flush=True)
    for source, k in {k.source.name: k for k in kernels.KERNELS.values()}.items():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "built earlier" in line:
                print(f"  {source}: {line.strip()}", flush=True)

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

    # The KDE kernel forms Σ(q−s)² directly; its plain version mirrors the
    # reference's ‖q‖² + ‖s‖² − 2q·s, which cancels in float32 at the path's
    # scale (draws ~√50 from the origin, spread 0.03, h ~0.025). Against the
    # float32 plain version the tolerance is that cancellation: one log-kernel
    # term is off by up to ~ε·(‖q‖² + ‖s‖²)/2h² per rounding, ε = 2^-23, and
    # a float64 numpy check (d = 50, T = 1,200) found up to 0.072 at spread
    # 0.02, i.e. ~0.2× this per-rounding figure; atol = 16× it (×M for the
    # product over machines), rtol 1e-5. Against the plain version in float64
    # the tolerance is the kernel's own: atol 1e-3 on log p̂ (×M for the
    # product), rtol 1e-5. −inf (an empty machine) must match exactly.
    eps32 = 2.0**-23

    def kde_inputs(Q, M, T, d, *, ragged=False):
        """Draws at the logreg path's scale: a centre ~N(0, I), machine
        offsets and spread 0.03; queries from the pooled valid rows."""
        centre = torch.randn((d,), generator=gen, device=dev)
        s = (centre + 0.03 * torch.randn((M, 1, d), generator=gen, device=dev)
             + 0.03 * torch.randn((M, T, d), generator=gen, device=dev))
        q = s.reshape(M * T, d)[torch.randint(0, M * T, (Q,), generator=gen, device=dev)]
        counts = None
        if ragged:
            counts = torch.randint(2, T + 1, (M,), generator=gen, device=dev).to(torch.int32)
            counts[1], counts[2] = 0, 1  # an empty and a single-row machine
            rows = torch.arange(T, device=dev)[None, :, None]
            s = torch.where(rows < counts[:, None, None], s, float("nan"))
            h = 0.02 + 0.03 * torch.rand((M,), generator=gen, device=dev)
        else:
            h = masked_silverman(s, torch.full((M,), T, dtype=torch.int32, device=dev))
        return q.contiguous(), s.contiguous(), h, counts

    kde_cases = {
        "importance_pool Q=M*T": kde_inputs(12000, 10, 1200, 50),
        "init_pool Q=1000": kde_inputs(1000, 10, 1200, 50),
        "ragged T=1201 d=37": kde_inputs(500, 5, 1201, 37, ragged=True),
        "Q=M=T=d=1": (torch.randn((1, 1), generator=gen, device=dev),
                      torch.randn((1, 1, 1), generator=gen, device=dev),
                      torch.ones((1,), device=dev), None),
    }
    err32 = {}
    for label, (q, s, h, counts) in kde_cases.items():
        s_valid = torch.nan_to_num(s, nan=0.0)
        spread = (float((q * q).sum(-1).max()) + float((s_valid * s_valid).sum(-1).max()))
        term = eps32 * spread / (2.0 * float(h.min()) ** 2)
        M = s.shape[0]
        for reduce in ("none", "product", "mixture", "product_mixture"):
            for weights in ("counts", "uniform"):
                got = machine_kde_log_density(q, s, h, counts, reduce=reduce, mixture_weights=weights)
                torch.cuda.synchronize()
                plain = machine_kde_log_density_ref(q, s, h, counts, reduce=reduce,
                                                    mixture_weights=weights)
                plain64 = machine_kde_log_density_ref(q.double(), s.double(), h.double(), counts,
                                                      reduce=reduce, mixture_weights=weights)
                got, plain, plain64 = (x if isinstance(x, tuple) else (x,)
                                       for x in (got, plain, plain64))
                outs = reduce.split("_")  # "product_mixture" returns (product, mixture)
                for out, g, p32, p64 in zip(outs, got, plain, plain64):
                    scale = M if out == "product" else 1
                    tag = f"machine_kde_log_density {label} {reduce}/{weights} [{out}]"
                    e32 = check_lp(f"{tag} vs float32 plain", g, p32, rtol=1e-5,
                                   atol=16.0 * term * scale)
                    e64 = check_lp(f"{tag} vs float64 plain", g, p64, rtol=1e-5, atol=1e-3 * scale)
                    err32["machine_kde_log_density"] = max(err32.get("machine_kde_log_density", 0.0), e32)
                    errs["machine_kde_log_density"] = max(errs.get("machine_kde_log_density", 0.0), e64)

    # single cloud: the plain version forms distances directly, like the kernel
    for nq, ns, d in ((300, 700, 7), (1, 1, 1)):
        q = torch.randn((nq, d), generator=gen, device=dev)
        c = torch.randn((ns, d), generator=gen, device=dev)
        got = kde_log_density(q, c, 0.5)
        torch.cuda.synchronize()
        e32 = check_close(f"kde_log_density {(nq, ns, d)} h=0.5 vs float32 plain", got,
                          kde_log_density_ref(q, c, 0.5), rtol=1e-5, atol=1e-4)
        plain64 = machine_kde_log_density_ref(q.double(), c.double()[None], 0.5)[0]
        e64 = check_close(f"kde_log_density {(nq, ns, d)} h=0.5 vs float64 plain", got, plain64,
                          rtol=1e-5, atol=1e-3)
        err32["kde_log_density"] = max(err32.get("kde_log_density", 0.0), e32)
        errs["kde_log_density"] = max(errs.get("kde_log_density", 0.0), e64)

    phase("4 main path: Pipeline(PAPER_SPEC).run() on the card")
    print(f"  spec {PAPER_SPEC.to_json()}", flush=True)
    kernels.reset_launches()
    board = Pipeline(PAPER_SPEC).run()
    torch.cuda.synchronize()
    launches_paper = kernels.launch_counts()
    print(board.table(), flush=True)
    print(f"  accept={board.accept:.4f} timings_s={json.dumps(board.timings)}", flush=True)
    print(f"  launches={json.dumps(launches_paper)}", flush=True)
    for name in ("logreg_loglik_grad", "img_log_weights"):
        if launches_paper[name] <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
    check_bands(board, CPU_LOGL2)
    paper_errors = dict(board.errors)

    phase("4b all combiners: Pipeline(ALL_SPEC).run() on the card")
    print(f"  spec {ALL_SPEC.to_json()}", flush=True)
    kernels.reset_launches()
    pipe = Pipeline(ALL_SPEC)
    board = pipe.run()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(board.table(), flush=True)
    print(f"  accept={board.accept:.4f} timings_s={json.dumps(board.timings)}", flush=True)
    print(f"  launches={json.dumps(launches)}", flush=True)
    # the same chains as phase 4 (6,470 likelihood launches); IMG weights
    # once per sweep of a third kernel-scored IMG combiner, semiparametric_w
    # (ceil(T / n_batch) = 75), and once for weierstrass's final states:
    # 150 + 75 + 1 = 226; the KDE kernel once each for importance_pool and
    # weierstrass's init_pool (2)
    options = dict(ALL_SPEC.combiner_options)
    expected = {
        "logreg_loglik_grad": launches_paper["logreg_loglik_grad"],
        "img_log_weights": (launches_paper["img_log_weights"]
                            + -(-ALL_SPEC.T // options["n_batch"]) + 1),
        "machine_kde_log_density": 2,
    }
    for name, n in expected.items():
        if launches[name] <= 0 or launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times on the path, expected {n}")
    check_bands(board, CPU_LOGL2_ALL)
    for name, err in paper_errors.items():
        if abs(board.errors[name] - err) > 1e-4:
            raise AssertionError(f"logL2({name}) = {board.errors[name]} under ALL_SPEC, "
                                 f"{err} under PAPER_SPEC")
    print(f"  parametric/nonparametric/semiparametric equal phase 4's within 1e-4", flush=True)
    theta = pipe.sample().theta
    combine_s = {}
    for name in ALL_SPEC.combiner_names():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = combine_spec_draws(ALL_SPEC, theta, (name,))[name]
        torch.cuda.synchronize()
        combine_s[name] = time.perf_counter() - t0
        if name == "importance_pool":
            print(f"  importance_pool ess={float(res.extras['ess']):.2f} of "
                  f"{theta.shape[0] * theta.shape[1]} pooled draws", flush=True)
    print(f"  combine_s_by_combiner={json.dumps(combine_s)}", flush=True)

    phase("5 timing (CUDA events)")
    flush_buf = torch.empty(256 * 1024 * 1024 // 4, device=dev)  # 256 MB > 50 MB L2

    def flush():
        flush_buf.zero_()

    rows = []
    for label, (G, N, d, C) in {"sample": (10, 5000, 50, 1), "groundtruth": (1, 50000, 50, 1)}.items():
        X, y, beta = logreg_inputs(G, N, d, C)
        nbytes = 4 * (G * N * d + G * N + G * d * C + G * C + G * d * C)
        flops = 4 * G * N * d * C + 10 * G * N * C
        bound, bound_by = least_ms(nbytes, flops)
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
    bound, bound_by = least_ms(nbytes, flops)
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

    # the KDE kernel at its two shapes on the ALL_SPEC path, and its
    # single-cloud form at one machine of that path (no path calls it)
    for name, label, Q, M, T, d, reduce in (
        ("machine_kde_log_density", "importance_pool", 12000, 10, 1200, 50, "product_mixture"),
        ("machine_kde_log_density", "weierstrass init_pool", 1000, 10, 1200, 50, "product"),
        ("kde_log_density", "one machine of the path", 12000, 1, 1200, 50, "none"),
    ):
        q, s, h, _ = kde_inputs(Q, M, T, d)
        n_out = {"none": M, "product": 1, "product_mixture": 2}[reduce]
        nbytes = 4 * (Q * d + M * T * d + 2 * M) + 4 * M * (reduce == "product_mixture") + 4 * n_out * Q
        flops = 2 * Q * M * T * d  # 2·Q·Σcounts·d
        bound, bound_by = least_ms(nbytes, flops)
        if name == "kde_log_density":
            c, hc = s[0], h[0]
            run = lambda: kde_log_density(q, c, hc)  # noqa: E731
            run_plain = lambda: kde_log_density_ref(q, c, hc)  # noqa: E731
        else:
            run = lambda: machine_kde_log_density(  # noqa: E731
                q, s, h, reduce=reduce, mixture_weights="uniform")
            run_plain = lambda: machine_kde_log_density_ref(  # noqa: E731
                q, s, h, reduce=reduce, mixture_weights="uniform")
        ms, host = device_ms(run, iters=20)
        cold, _ = device_ms(run, iters=10, flush=flush)
        # one call queued behind the sleep: the chunked plain version is
        # hundreds of launches, and more would fill the stream's queue
        plain, plain_host = device_ms(run_plain, iters=1)
        print(f"  {name} {label} Q={Q} M={M} T={T} d={d} {reduce}: kernel {ms * 1e3:.2f} us "
              f"(cold L2 {cold * 1e3:.2f} us; host enqueue {host * 1e3:.2f} us/call), "
              f"plain {plain * 1e3:.2f} us (host {plain_host * 1e3:.2f} us/call), "
              f"bound {bound * 1e3:.2f} us by {bound_by}", flush=True)
        if label != "weierstrass init_pool":
            rows.append({"name": name, "ms": ms, "cold_ms": cold, "host_ms": host,
                         "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
                         "shape": f"Q={Q} M={M} T={T} d={d} {reduce}"})

    phase("6 summary")
    out = []
    for r in rows:
        k = kernels.KERNELS[r["name"]]
        entry = {
            "name": r["name"], "route": "cuda", "source": os.path.relpath(k.source, root),
            "replaces": k.replaces, "launches": launches[r["name"]],
            "max_abs_err": errs[r["name"]], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "cold_ms": r["cold_ms"], "host_ms": r["host_ms"], "shape": r["shape"],
            "launches_by_path": {"paper": launches_paper[r["name"]], "all": launches[r["name"]]},
        }
        if r["name"] in err32:
            entry["max_abs_err_float32_plain"] = err32[r["name"]]
        out.append(entry)
    print(json.dumps({"kernels": out}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
