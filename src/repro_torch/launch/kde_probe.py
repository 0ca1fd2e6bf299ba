"""A short card check of the KDE kernel: build, check, time its phases.

    PYTHONPATH=src python -m repro_torch.launch.kde_probe

The quick first call after a change to ``kernels/csrc/kde_density.cu`` or
``tf32x3.cuh`` (``chip_smoke.py`` checks every kernel and path and takes
minutes). A wrong ``wgmma`` descriptor gives wrong numbers, not an error, so
before anything else it runs one block's first tile (128 queries x 128
sample rows, one machine) through the kernel's centring, TF32 split and
three tensor-core passes and holds the raw product q_c·s_cᵀ − ‖s_c‖²/2
(the sample term rides in column d) to float64: within 2^-18 of
Σ_k |q_c,k|·|s_c,k| + ‖s_c‖²/2 per entry, which one TF32 pass (error ~2^-11
of it) or a misplaced operand cannot meet. Then it holds the whole
kernel to its plain version in float64 at the path's shapes (atol 1e-3 on
log p̂, ×M for the product), checks that three launches give the same bits,
and times the kernel and copies of it built with phases cut out
(``KDE_CUT``: the centring pre-pass alone, then the copies, query staging
and turns, the three product passes, the epilogue's scores and max, its
exps; the full kernel adds the merge), at the path's two shapes and at the
posterior server's one-point logpdf, as
the mean of 20 launches captured in one CUDA graph, through the C entry
point with its buffers made beforehand: device time with no host in it.
Exits 1 if a check fails, 2 without a card.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from typing import Optional, Sequence

import torch

from repro_torch import kernels
from repro_torch.core.combiners import masked_silverman
from repro_torch.kernels import device_index, stream_handle
from repro_torch.kernels.kde_density import machine_kde_log_density, machine_kde_log_density_ref
from repro_torch.kernels.kde_density import ops
from repro_torch.kernels.tf32 import tf32_split

M, T, D = 10, 1200, 50
SHAPES = {"importance_pool": 12000, "init_pool": 1000,  # Q on the ALL_SPEC path
          "serve logpdf": 1}  # a probe reader's logpdf on the full draw buffer
CUTS = {1: "the centring pre-pass", 2: "+ copies, query staging and turns",
        3: "+ the three product passes", 4: "+ the epilogue's scores and max",
        5: "+ the exps: all but the merge"}
LAUNCHES = 20
TILE = 128  # the kernel's queries a block and sample rows a tile


def path_inputs(gen, Q, M_, T_, d):
    """Draws at the logreg path's scale (as ``chip_smoke.py``'s kde_inputs):
    a centre ~N(0, I), machine offsets and spread 0.03, queries from the
    pooled rows, Silverman bandwidths."""
    dev = gen.device
    centre = torch.randn((d,), generator=gen, device=dev)
    s = (centre + 0.03 * torch.randn((M_, 1, d), generator=gen, device=dev)
         + 0.03 * torch.randn((M_, T_, d), generator=gen, device=dev))
    q = s.reshape(M_ * T_, d)[torch.randint(0, M_ * T_, (Q,), generator=gen, device=dev)]
    h = masked_silverman(s, torch.full((M_,), T_, dtype=torch.int32, device=dev))
    return q.contiguous(), s.contiguous(), h


def check_tile(gen, d) -> bool:
    """One block's first tile of the product against float64."""
    lib, _ = ops._entry()
    probe = lib.kde_probe_cross_f32
    probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    probe.restype = ctypes.c_int
    dev = gen.device
    q, s, h = path_inputs(gen, TILE, 1, TILE, d)
    counts = torch.full((1,), TILE, dtype=torch.int32, device=dev)
    scratch = torch.empty((lib.kde_scratch_floats(1, TILE, d),), dtype=torch.float32, device=dev)
    cross = torch.full((TILE, TILE), float("nan"), dtype=torch.float32, device=dev)
    err = probe(device_index(dev), q.data_ptr(), s.data_ptr(), h.data_ptr(), counts.data_ptr(),
                scratch.data_ptr(), cross.data_ptr(), TILE, TILE, d, stream_handle(dev))
    if err:
        raise RuntimeError(f"kde_probe_cross_f32: CUDA error {err} "
                           f"({lib.kde_error_string(err).decode()})")
    torch.cuda.synchronize()
    mu = scratch[:d]  # machine 0's centre, as the kernel took it
    q_c, s_c = q.double() - mu.double(), s[0].double() - mu.double()
    # the product carries the sample term in column d: q_c·s_c − ‖s_c‖²/2
    want = q_c @ s_c.T - 0.5 * (s_c * s_c).sum(-1)
    scale = q_c.abs() @ s_c.abs().T + 0.5 * (s_c * s_c).sum(-1)
    kernel_err = (cross.double() - want).abs()
    # the same arithmetic in PyTorch, float32, on the kernel's centred values
    q32, s32 = q - mu, s[0] - mu
    q_aug = torch.cat([q32, torch.ones_like(q32[:, :1])], dim=1)
    s_aug = torch.cat([s32, -0.5 * (s32 * s32).sum(-1, keepdim=True)], dim=1)
    q_hi, q_lo = tf32_split(q_aug)
    s_hi, s_lo = tf32_split(s_aug)
    model = (q_hi @ s_lo.T + q_lo @ s_hi.T) + q_hi @ s_hi.T
    one_pass = q_hi @ s_hi.T
    ok = bool(torch.isfinite(cross).all()) and bool((kernel_err <= 2.0**-18 * scale).all())
    rel = float((kernel_err / scale).max())
    print(f"  one tile d={d}: product vs float64 max_abs_err={float(kernel_err.max()):.3e}, "
          f"max err / scale = {rel:.3e} (limit 2^-18 = {2.0**-18:.3e}); the float32 "
          f"model's {float((model.double() - want).abs().max()):.3e}, one TF32 pass "
          f"{float((one_pass.double() - want).abs().max()):.3e} {'ok' if ok else 'FAIL'}",
          flush=True)
    return ok


def build_cuts(cuts=tuple(CUTS)):
    """The kernel's entry point from libraries built with ``-DKDE_CUT=cut``,
    one ``nvcc`` a cut, all started together."""
    out = {cut: kernels.BUILD_DIR / "probe" / f"kde_cut{cut}.so" for cut in cuts}
    kernels.BUILD_DIR.joinpath("probe").mkdir(parents=True, exist_ok=True)
    procs = {cut: subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DKDE_CUT={cut}",
                                    "-o", str(path), str(ops.MACHINE_KERNEL.source)],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cut, path in out.items()}
    _, port = ops._entry()
    fns = {}
    for cut, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"KDE_CUT={cut} build failed:\n{log}")
        fn = ctypes.CDLL(str(out[cut])).kde_machine_log_density_f32
        fn.argtypes, fn.restype = port.argtypes, port.restype
        fns[cut] = fn
    return fns


def launcher(q, s, h, reduce):
    """``run(fn)``: one launch of entry point ``fn`` (the wrapper's, or a
    cut's) on ``q, s, h`` with dense counts, its buffers made beforehand."""
    lib, _ = ops._entry()
    dev = q.device
    (Q, d), (M_, T_, _) = q.shape, s.shape
    counts = torch.full((M_,), T_, dtype=torch.int32, device=dev)
    logw = torch.full((M_,), -math.log(M_), dtype=torch.float32, device=dev)
    S = lib.kde_machine_splits(Q, M_, T_, ops._num_sms(device_index(dev)))
    part = torch.empty((2, S, M_, Q), dtype=torch.float32, device=dev)
    scratch = torch.empty((lib.kde_scratch_floats(M_, T_, d),), dtype=torch.float32, device=dev)
    lp = torch.empty((M_, Q), dtype=torch.float32, device=dev)
    prod = torch.empty((Q,), dtype=torch.float32, device=dev)
    mix = torch.empty((Q,), dtype=torch.float32, device=dev) if reduce == "product_mixture" else None

    def run(fn):
        err = fn(device_index(dev), q.data_ptr(), s.data_ptr(), h.data_ptr(), counts.data_ptr(),
                 logw.data_ptr(), scratch.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
                 lp.data_ptr(), prod.data_ptr(), None if mix is None else mix.data_ptr(),
                 Q, M_, T_, d, S, stream_handle(dev))
        if err:
            raise RuntimeError(f"kde launch: CUDA error {err}")

    run.splits = S
    return run


def graph_us(launch) -> float:
    """Mean device µs of ``launch`` over LAUNCHES launches in one CUDA graph."""
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(LAUNCHES):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / LAUNCHES


def main(argv: Optional[Sequence[str]] = None) -> int:
    del argv  # no options
    if not torch.cuda.is_available():
        print("kde_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(f"build {kernels.build():.2f} s", flush=True)
    for line in ops.MACHINE_KERNEL.build_log.splitlines():
        if any(w in line for w in ("registers", "spill", "warning", "smem", "C7515", "C7517")) \
                and "(C7519)" not in line:  # ptxas's notes on the arrives it adds before wgmma
            print(f"  {line.strip()}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    failed = 0
    for d in (50, 64, 8, 1):
        failed += not check_tile(gen, d)
    if failed:
        print("kde_probe: the tile's product is wrong; nothing else is run", flush=True)
        return 1

    fns = build_cuts()
    fns[0] = ops._entry()[1]
    for label, Q in SHAPES.items():
        q, s, h = path_inputs(gen, Q, M, T, D)
        reduce = "product_mixture" if label == "importance_pool" else "product"
        got = machine_kde_log_density(q, s, h, reduce=reduce)
        want = machine_kde_log_density_ref(q.double(), s.double(), h.double(), reduce=reduce)
        got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
        for out, g, w in zip(reduce.split("_"), got, want):
            atol = 1e-3 * (M if out == "product" else 1)
            err = (g.double() - w).abs()
            ok = bool(torch.isfinite(g).all()) and bool((err <= atol + 1e-5 * w.abs()).all())
            failed += not ok
            print(f"  {label} Q={Q} [{out}] vs float64 plain: max_abs_err={float(err.max()):.3e} "
                  f"(atol {atol:g}, rtol 1e-5) {'ok' if ok else 'FAIL'}", flush=True)
        again = [machine_kde_log_density(q, s, h, reduce=reduce) for _ in range(3)]
        same = all(torch.equal(a, b) for r in again
                   for a, b in zip(r if isinstance(r, tuple) else (r,), got))
        failed += not same
        print(f"  {label}: three launches the same bits: {same}", flush=True)

        run = launcher(q, s, h, reduce)
        S = run.splits
        print(f"  {label} Q={Q} M={M} T={T} d={D} {reduce}: S={S} row splits, grid "
              f"{-(-Q // TILE)} x {M} x {S}", flush=True)
        for cut, what in CUTS.items():
            print(f"  {label} KDE_CUT={cut} ({what}): {graph_us(lambda: run(fns[cut])):.2f} us "
                  f"a launch", flush=True)
        print(f"  {label} the whole kernel (+ the merge): {graph_us(lambda: run(fns[0])):.2f} us "
              f"a launch", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
