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
4c. stream  — combine-while-sampling, ``Pipeline(STREAM_SPEC)
              .stream_combine()`` (ALL_SPEC folded every 120 draws, fused):
              launch counts derived from the spec (``online_update`` once per
              fold chunk), 50 finite trajectory values, finals equal to 4b's;
              then the subscriber path (bitwise the same finals for the
              buffered combiners, no ``online_update`` launch) and an
              interrupted-then-resumed checkpointed run (bitwise the same θ);
5. timing   — CUDA-event times of each kernel and its plain version at the
              paths' shapes, beside the least time the card could take, and
              the card time of PyTorch's attention at the LM sidecar's shape
              (the yardstick of the one TPU kernel not yet ported);
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
BF16_FLOPS = 989e12  # dense, tensor cores

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


def least_ms(nbytes, flops, peak=F32_FLOPS):
    """(least ms, what bounds it): bytes over the HBM rate or flops over the
    ``peak`` rate (float32 by default), whichever is larger."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
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

    t_start = time.perf_counter()
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
    from repro_torch.kernels.online_update import online_moments_update, online_moments_update_ref
    from repro_torch.launch.mcmc_run import ALL_SPEC, PAPER_SPEC, STREAM_SPEC

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

    # online_update sums the chunk mean and the centred Gram in another order
    # than the plain version. Against the plain version in float64 the
    # tolerance is the kernel's own float32 rounding: count exact, mean within
    # 1e-5·(1 + |mean|), m2 within 1e-5·max|m2| of each machine. Against the
    # float32 plain version, whose rounding adds as much again, 1e-4 (the
    # reference tests' figure). Shapes: the path's fold (M=10, C=120, d=50),
    # ragged counts with NaN beyond them and an empty machine, C = 1, C < 32
    # with d = 65, and M = d = 1.
    def online_inputs(M, C, d, *, ragged=False):
        count = torch.full((M,), 240.0, device=dev)
        mean = torch.randn((M, d), generator=gen, device=dev)
        a = torch.randn((M, 2 * d, d), generator=gen, device=dev)
        chunk = mean[:, None, :] + 0.3 + torch.randn((M, C, d), generator=gen, device=dev)
        counts = None
        if ragged:
            counts = torch.randint(1, C + 1, (M,), generator=gen, device=dev).to(torch.int32)
            counts[0] = 0
            rows = torch.arange(C, device=dev)[None, :, None]
            chunk = torch.where(rows < counts[:, None, None], chunk, float("nan"))
        return count, mean, a.transpose(1, 2) @ a, chunk.contiguous(), counts

    def online_err(label, got, want, rel):
        """Max abs error of the state; raises outside the stated tolerance."""
        (c, mu, m2), (cw, muw, m2w) = got, want
        mu_err = (mu.double() - muw.double()).abs()
        m2_err = (m2.double() - m2w.double()).abs()
        scale = m2w.double().abs().amax(dim=(1, 2), keepdim=True).clamp(min=1e-30)
        ok = (bool(torch.equal(c.double(), cw.double()))
              and bool(torch.isfinite(mu).all()) and bool(torch.isfinite(m2).all())
              and bool((mu_err <= rel * (1.0 + muw.double().abs())).all())
              and bool((m2_err <= rel * scale).all()))
        max_err = max(float(mu_err.max()), float(m2_err.max()))
        print(f"  {label}: max_abs_err={max_err:.3e} (mean rel {rel:g}·(1+|mean|), "
              f"m2 rel {rel:g}·max|m2|, count exact) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{label}: kernel disagrees with its plain version")
        return max_err

    for label, (M, C, d, ragged) in {"path fold": (10, 120, 50, False),
                                     "path fold ragged": (10, 120, 50, True),
                                     "C=1": (3, 1, 50, False), "C=31 d=65 ragged": (4, 31, 65, True),
                                     "M=d=1": (1, 7, 1, False)}.items():
        count, mean, m2, chunk, counts = online_inputs(M, C, d, ragged=ragged)
        got = online_moments_update(count, mean, m2, chunk, counts)
        torch.cuda.synchronize()
        want64 = online_moments_update_ref(count.double(), mean.double(), m2.double(),
                                           chunk.double(), counts)
        e64 = online_err(f"online_update {label} {(M, C, d)} vs float64 plain", got, want64, 1e-5)
        e32 = online_err(f"online_update {label} {(M, C, d)} vs float32 plain", got,
                         online_moments_update_ref(count, mean, m2, chunk, counts), 1e-4)
        errs["online_update"] = max(errs.get("online_update", 0.0), e64)
        err32["online_update"] = max(err32.get("online_update", 0.0), e32)
        if ragged:  # the empty machine comes back as it went in, bit for bit
            if not all(torch.equal(x[0], y[0]) for x, y in zip(got, (count, mean, m2))):
                raise AssertionError("online_update changed a machine whose chunk count is 0")

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
        if name == "online":
            all_online = res.moments  # one plain fold of the whole stack
        if name == "importance_pool":
            print(f"  importance_pool ess={float(res.extras['ess']):.2f} of "
                  f"{theta.shape[0] * theta.shape[1]} pooled draws", flush=True)
    print(f"  combine_s_by_combiner={json.dumps(combine_s)}", flush=True)
    all_errors, all_theta = dict(board.errors), theta

    phase("4c stream: Pipeline(STREAM_SPEC).stream_combine() on the card (fused)")
    print(f"  spec {STREAM_SPEC.to_json()}", flush=True)
    kernels.reset_launches()
    t0 = time.perf_counter()
    pipe = Pipeline(STREAM_SPEC)
    sr = pipe.stream_combine()
    board = pipe.run()  # the stream's finals and groundtruth, scored
    torch.cuda.synchronize()
    stream_wall = time.perf_counter() - t0
    launches_stream = kernels.launch_counts()
    fused = pipe.sample()
    print(f"  backend={fused.backend} wall_s={stream_wall:.3f} "
          f"timings_s={json.dumps(board.timings)}", flush=True)
    print(f"  launches={json.dumps(launches_stream)}", flush=True)
    for row in sr.trajectory:
        print(f"  t={row['t']:5d} {sr.metric}({row['combiner']:15s}) = {row['error']:.4f} "
              f"[{row['elapsed_s']:.3f}s]", flush=True)
    # the same chains and finals as 4b; online_update once per fold chunk
    # (ceil(T / stream_every)); IMG weights once per sweep of every
    # nonparametric estimate (one per boundary, n_estimate draws in batches of
    # max(n_batch, 8)); estimates are taken by the combiners that have one
    every = STREAM_SPEC.stream_every
    n_chunks = -(-STREAM_SPEC.T // every)
    n_batch = max(int(dict(STREAM_SPEC.combiner_options)["n_batch"]), 8)
    from repro_torch.core.combiners import get_streaming_combiner
    estimating = [n for n in STREAM_SPEC.combiner_names()
                  if get_streaming_combiner(n).estimate is not None]
    expected = {
        "logreg_loglik_grad": launches["logreg_loglik_grad"],
        "img_log_weights": launches["img_log_weights"] + n_chunks * -(-sr.n_estimate // n_batch),
        "machine_kde_log_density": launches["machine_kde_log_density"],
        "kde_log_density": 0,
        "online_update": n_chunks,
    }
    for name, n in expected.items():
        if launches_stream[name] != n:
            raise AssertionError(f"{name} launched {launches_stream[name]} times on the stream "
                                 f"path, expected {n}")
    values = [row["error"] for row in sr.trajectory]
    if len(values) != n_chunks * len(estimating) or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"trajectory: {len(values)} rows for {n_chunks} boundaries x "
                             f"{len(estimating)} estimating combiners, finite: "
                             f"{all(math.isfinite(v) for v in values)}")
    if [r["t"] for r in sr.trajectory] != sorted(r["t"] for r in sr.trajectory):
        raise AssertionError("trajectory rows out of boundary order")
    if not torch.equal(fused.theta, all_theta):
        raise AssertionError("the fused stream's draws differ from the one-shot stage's")
    print(f"  {len(values)} finite trajectory values ({n_chunks} boundaries x {estimating}); "
          f"theta bitwise the one-shot stage's", flush=True)
    # online's moments come from the kernel's fold in ten chunks, 4b's from
    # one plain fold of the whole stack, so its logL2 (~66) moves by merge
    # rounding: 6.1e-5 on an H100 (8 float32 spacings of 7.6e-6 at 66).
    # 1e-3 leaves 16x room over that reading and still catches a fault in
    # the moments that moves logL2 by 1.5e-5 of its value; the moment checks
    # below hold the merge itself much tighter. Every other name: same θ,
    # same generator, so within 1e-4 (bitwise in fact).
    ONLINE_LOGL2_TOL = 1e-3
    for name, err in sorted(board.errors.items()):
        tol = ONLINE_LOGL2_TOL if name == "online" else 1e-4
        diff = abs(err - all_errors[name])
        print(f"  final logL2({name}) = {err:.6f}, 4b {all_errors[name]:.6f}, |diff| {diff:.3e} "
              f"(tol {tol:g}) {'ok' if diff <= tol else 'FAIL'}", flush=True)
        if not diff <= tol:
            raise AssertionError(f"stream final logL2({name}) = {err}, 4b gave {all_errors[name]}")

    # the subscriber path: the host folds (online through its plain chunk
    # merge), the same θ; finals bitwise for the buffered combiners
    kernels.reset_launches()
    t0 = time.perf_counter()
    pipe_sub = Pipeline(STREAM_SPEC)
    sub = pipe_sub.stream_combine(fused=False, score=False)
    torch.cuda.synchronize()
    sub_wall = time.perf_counter() - t0
    launches_sub = kernels.launch_counts()
    print(f"  subscriber: backend={pipe_sub.sample().backend} wall_s={sub_wall:.3f} "
          f"launches={json.dumps(launches_sub)}", flush=True)
    if launches_sub["online_update"] != 0:
        raise AssertionError("the subscriber path launched online_update")
    if [(r["t"], r["combiner"]) for r in sub.trajectory] != \
            [(r["t"], r["combiner"]) for r in sr.trajectory]:
        raise AssertionError("subscriber trajectory rows differ from the fused ones")
    for name in STREAM_SPEC.combiner_names():
        if name == "online":
            continue
        if not torch.equal(sub.combined[name].samples, sr.combined[name].samples):
            raise AssertionError(f"subscriber final {name} differs from the fused one")
    # online: the same generator draws from moments that differ by merge
    # rounding. Limits, each from two readings on an H100: the sound gaps
    # (kernel fold against the host's ten-chunk fold: mean 2.1e-6, cov
    # 4.4e-7 of max|cov|) and a planted merge fault (the δδᵀ·n_a·n_b/n term
    # dropped), which the script measures below and must fail. The product
    # mean within 2e-5·(1 + |mean|), the covariance within 1e-5·max|cov|;
    # they bind the kernel fold against the host's ten-chunk fold and against
    # 4b's single plain fold of the whole stack alike.
    from repro_torch.core.combiners.online import (
        OnlineMoments, online_init, online_product, online_update_chunk)

    mf = sr.combined["online"].moments

    def moment_gap(m):
        mean_rel = float(((mf.mean - m.mean).abs() / (1 + m.mean.abs())).max())
        cov_rel = float((mf.cov - m.cov).abs().max() / m.cov.abs().max())
        return mean_rel, cov_rel

    def within(gap):
        return gap[0] <= 2e-5 and gap[1] <= 1e-5

    # the planted fault: each chunk folded alone, the states summed with no
    # between-chunk δδᵀ term
    parts = [online_update_chunk(online_init(STREAM_SPEC.M, fused.theta.shape[-1],
                                             device=dev), fused.theta[:, t:t + every])
             for t in range(0, STREAM_SPEC.T, every)]
    count = sum(q.count for q in parts)
    faulty = online_product(OnlineMoments(
        count, sum(q.count[:, None] * q.mean for q in parts) / count[:, None],
        sum(q.m2 for q in parts)))
    gaps = {"subscriber (host ten-chunk fold)": moment_gap(sub.combined["online"].moments),
            "4b (one plain fold of the stack)": moment_gap(all_online),
            "planted fault (no δδᵀ merge term)": moment_gap(faulty)}
    for label, gap in gaps.items():
        print(f"  online product vs the fused kernel fold, {label}: mean |diff|/(1+|mean|) "
              f"{gap[0]:.3e}, cov |diff|/max|cov| {gap[1]:.3e} (limits 2e-05, 1e-05) "
              f"{'within' if within(gap) else 'outside'}", flush=True)
    *sound, fault = gaps.values()
    if not all(within(g) for g in sound):
        raise AssertionError("online moments outside merge rounding of the fused ones")
    if within(fault):
        raise AssertionError("the online moment limits let a dropped merge term pass")
    print("  subscriber finals bitwise the fused ones for the ten buffered combiners", flush=True)

    # interrupted at 600 draws, then resumed: the same θ, bitwise
    import tempfile
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        part = Pipeline(STREAM_SPEC, checkpoint_dir=ckpt, checkpoint_every=every).stream_combine(
            max_steps=STREAM_SPEC.T // 2, score=False)
        pipe_res = Pipeline(STREAM_SPEC, checkpoint_dir=ckpt, checkpoint_every=every)
        full = pipe_res.stream_combine(score=False)
        torch.cuda.synchronize()
        resumed = pipe_res.sample()
        print(f"  resume: first session {part.t_done}/{part.total} complete={part.complete}, "
              f"second {full.t_done}/{full.total} complete={full.complete} "
              f"backend={resumed.backend} wall_s={time.perf_counter() - t0:.3f}", flush=True)
    if part.complete or part.t_done != STREAM_SPEC.T // 2 or not full.complete:
        raise AssertionError("the interrupted run did not stop at max_steps and then finish")
    if not torch.equal(resumed.theta, fused.theta):
        raise AssertionError("the resumed run's θ differs from the fused run's")
    for name in STREAM_SPEC.combiner_names():
        if not torch.equal(full.combined[name].samples, sub.combined[name].samples):
            raise AssertionError(f"resumed final {name} differs from the uninterrupted one")
    print("  resumed θ bitwise the fused run's; resumed finals bitwise the subscriber run's",
          flush=True)

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

    # online_update at the stream path's fold
    M, C, d = 10, 120, 50
    count, mean, m2, chunk, _ = online_inputs(M, C, d)
    nbytes = 4 * (M * C * d + 2 * (M + M * d + M * d * d))
    flops = 2 * M * C * d * d + 2 * M * C * d + 4 * M * d * d  # Gram, mean + centring, merge
    bound, bound_by = least_ms(nbytes, flops)
    ms, host = device_ms(lambda: online_moments_update(count, mean, m2, chunk))
    cold, _ = device_ms(lambda: online_moments_update(count, mean, m2, chunk), flush=flush)
    # ten calls behind the sleep: the plain version is ~30 launches a call,
    # and more would fill the stream's queue
    plain, plain_host = device_ms(lambda: online_moments_update_ref(count, mean, m2, chunk),
                                  iters=10)
    print(f"  online_update M={M} C={C} d={d}: kernel {ms * 1e3:.2f} us "
          f"(cold L2 {cold * 1e3:.2f} us; host enqueue {host * 1e3:.2f} us/call), "
          f"plain {plain * 1e3:.2f} us (host {plain_host * 1e3:.2f} us/call), "
          f"bound {bound * 1e3:.3f} us by {bound_by}", flush=True)
    rows.append({"name": "online_update", "ms": ms, "cold_ms": cold, "host_ms": host,
                 "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
                 "shape": f"M={M} C={C} d={d}"})

    # flash_attention is not ported (LM sidecar): PyTorch's attention at the
    # attention shape of repro/configs/llama3_2_3b.py (8 KV heads, 3 query
    # heads each, head dim 128, causal, bf16), batch 1, S = T = 4096, as the
    # yardstick of that TPU kernel; causal work = half of 4·S·T·hd per query head
    B, K, G, hd, S = 1, 8, 3, 128, 4096
    q = torch.randn((B, K * G, S, hd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, K, S, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, K, S, hd), generator=gen, device=dev).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        sdpa(q[:, :, :8], k[:, :, :8], v[:, :, :8], is_causal=True, enable_gqa=True)
        run = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
        how = "enable_gqa"
    except TypeError:  # an older PyTorch: repeat the KV heads for it
        k_rep, v_rep = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
        run = lambda: sdpa(q, k_rep, v_rep, is_causal=True)  # noqa: E731
        how = "KV heads repeated"
    nbytes = 2 * (2 * B * K * G * S * hd + 2 * B * K * S * hd)  # q, out; k, v
    flops = 2 * B * K * G * S * S * hd  # causal half of 4·S·T·hd per query head
    att_bound, att_by = least_ms(nbytes, flops, peak=BF16_FLOPS)
    att_ms, att_host = device_ms(run, iters=20)
    print(f"  flash_attention (not ported) yardstick: scaled_dot_product_attention B={B} "
          f"Hq={K * G} Hkv={K} S=T={S} hd={hd} causal bf16 ({how}): {att_ms * 1e3:.2f} us "
          f"(host enqueue {att_host * 1e3:.2f} us/call), bound {att_bound * 1e3:.2f} us by "
          f"{att_by}", flush=True)

    phase("6 summary")
    print(f"  chip_smoke ran {time.perf_counter() - t_start:.1f} s, the build included", flush=True)
    out = []
    for r in rows:
        k = kernels.KERNELS[r["name"]]
        entry = {
            "name": r["name"], "route": "cuda", "source": os.path.relpath(k.source, root),
            "replaces": k.replaces, "launches": launches_stream[r["name"]],
            "max_abs_err": errs[r["name"]], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "cold_ms": r["cold_ms"], "host_ms": r["host_ms"], "shape": r["shape"],
            "launches_by_path": {"paper": launches_paper[r["name"]], "all": launches[r["name"]],
                                 "stream": launches_stream[r["name"]]},
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
