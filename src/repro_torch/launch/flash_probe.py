"""A short card check of the flash kernel's tensor-core routes: build, check, time.

    PYTHONPATH=src python -m repro_torch.launch.flash_probe

The quick first call after a change to ``kernels/csrc/flash_attention.cu``,
``tf32x3.cuh`` or ``pipeline.cuh`` (``chip_smoke.py`` checks every kernel
and path and takes minutes). Builds the kernels and prints the flash
source's build seconds and ptxas report. A wrong ``wgmma`` descriptor or
fragment gives wrong numbers, not an error, so before anything else it runs
one block's first tile of the float32 route (``"tf32x3"``: two slabs of 64
query rows, 32 kv positions, at each of its four head-dim pairs) through the
pre-pass, copies and 3×TF32 products and holds the raw q·kᵀ, then S·v (S
through the TF32 split, as P is), to float64: within 2^-18 of Σ|a|·|b| per
entry, which one TF32 pass (~2^-11 of it) or a misplaced operand cannot
meet. Then it runs each tensor-core route on its cases against the plain
version in float64 (the ``"tf32x3"`` route in float32 within rtol 2e-5 /
atol 2e-5, the card tests' float32 tolerance; the bf16 route within 1e-2),
checks which route's count rose and that three launches give the same
bits, and times the serving shape (B=2, K=8, G=3, S=T=4,096, hd=128,
causal) on the bf16 route, the ``"tf32x3"`` route and the FMA route (float32
q whose base sits 4 bytes off 16, which no tensor map takes) over 10
launches with CUDA events. Last, the ``"tf32x3"`` route's phases: copies of
it built with parts cut out (``FLASH_CUT``: the pre-pass alone, then the
copies, then the products with P taken from the raw scores, then the
softmax; the whole kernel adds the stores), each the mean of 10 launches
captured in one CUDA graph through the C entry point with its buffers made
beforehand. Exits 1 if a check fails, 2 without a card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from typing import Optional, Sequence

import torch

from repro_torch import kernels
from repro_torch.kernels import device_index, stream_handle
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.tf32 import tf32_split

CASES = [  # b, s, t, kh, g, hd, hd_v, causal, kv_len, dtype
    (1, 64, 64, 1, 3, 64, 64, False, None, torch.bfloat16),
    (1, 128, 128, 1, 3, 128, 128, True, None, torch.bfloat16),
    (1, 300, 300, 1, 7, 128, 128, True, None, torch.bfloat16),
    (1, 200, 1000, 2, 3, 128, 128, False, 777, torch.bfloat16),
    (1, 130, 130, 2, 3, 128, 128, True, 0, torch.bfloat16),
    (1, 300, 300, 4, 1, 192, 128, True, None, torch.bfloat16),
    (1, 200, 200, 2, 2, 256, 256, True, None, torch.bfloat16),
    (1, 64, 32, 1, 2, 128, 128, False, None, torch.float32),
    (1, 64, 64, 1, 3, 64, 64, False, None, torch.float32),
    (1, 128, 128, 1, 3, 128, 128, True, None, torch.float32),
    (1, 300, 300, 2, 1, 128, 128, True, None, torch.float32),
    (1, 300, 300, 1, 7, 128, 128, True, None, torch.float32),
    (1, 300, 300, 1, 8, 128, 128, True, None, torch.float32),
    (1, 100, 4096, 2, 3, 128, 128, False, None, torch.float32),
    (1, 200, 1000, 2, 3, 128, 128, False, 777, torch.float32),
    (1, 130, 130, 2, 3, 128, 128, True, 0, torch.float32),
    (2, 200, 200, 2, 3, 64, 128, True, None, torch.float32),
    (2, 200, 200, 2, 3, 128, 64, True, 150, torch.float32),
    (2, 4096, 4096, 8, 3, 128, 128, True, None, torch.float32),
]
CUTS = {1: "the pre-pass", 2: "+ the main kernel's copies", 3: "+ the products (P = raw S)",
        4: "+ the softmax", 5: "everything but the tile copies"}
LAUNCHES = 10
SERVING = (2, 4096, 8, 3, 128)  # B, S = T, K, G, hd


def check_tile(gen, hd, hd_v) -> bool:
    """One block's first tile of the float32 route against float64."""
    lib, _ = ops._entry("tf32x3")
    probe = lib.flash_tf32x3_probe
    probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    probe.restype = ctypes.c_int
    dev = gen.device
    G, S, T = 2, 64, 32  # one slab for each consumer warpgroup
    q = torch.randn((1, S, 1, G, hd), generator=gen, device=dev)
    k = torch.randn((1, T, 1, hd), generator=gen, device=dev)
    v = torch.randn((1, T, 1, hd_v), generator=gen, device=dev)
    scratch = torch.empty((lib.flash_tf32x3_scratch_floats(1, T, 1, hd, hd_v, T),),
                          dtype=torch.float32, device=dev)
    out = torch.full((G * S * T + G * S * hd_v,), float("nan"), dtype=torch.float32, device=dev)
    err = probe(device_index(dev), q.data_ptr(), k.data_ptr(), v.data_ptr(), scratch.data_ptr(),
                out.data_ptr(), G, hd, hd_v, stream_handle(dev))
    if err:
        raise RuntimeError(f"flash_tf32x3_probe: CUDA error {err} "
                           f"({lib.flash_attention_error_string(err).decode()})")
    torch.cuda.synchronize()
    got_s = out[:G * S * T].view(G, S, T)
    got_o = out[G * S * T:].view(G, S, hd_v)
    qg = q[0, :, 0].transpose(0, 1).double()  # (G, S, hd)
    kk, vv = k[0, :, 0].double(), v[0, :, 0].double()
    want_s = qg @ kk.T
    scale_s = qg.abs() @ kk.abs().T
    s_hi, s_lo = tf32_split(got_s)  # the kernel splits its own float32 S
    s32 = (s_hi.double() + s_lo.double())
    want_o = s32 @ vv
    scale_o = s32.abs() @ vv.abs()
    err_s = (got_s.double() - want_s).abs()
    err_o = (got_o.double() - want_o).abs()
    q_hi, _ = tf32_split(q[0, :, 0].transpose(0, 1))
    k_hi, _ = tf32_split(k[0, :, 0])
    one_pass = (q_hi.double() @ k_hi.double().T - want_s).abs()
    ok = (bool(torch.isfinite(out).all()) and bool((err_s <= 2.0**-18 * scale_s).all())
          and bool((err_o <= 2.0**-18 * scale_o).all()))
    print(f"  one tile hd={hd} hd_v={hd_v}: q·kᵀ max err {float(err_s.max()):.3e} "
          f"(/ scale {float((err_s / scale_s).max()):.3e}), S·v max err {float(err_o.max()):.3e} "
          f"(/ scale {float((err_o / scale_o).max()):.3e}); limit 2^-18 = {2.0**-18:.3e}; one "
          f"TF32 pass of q·kᵀ {float(one_pass.max()):.3e} {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def route_of(dtype, hd, hd_v) -> str:
    if dtype == torch.bfloat16:
        return "tensor_core"
    return "tf32x3" if hd in (64, 128) and hd_v in (64, 128) else "fma"


def build_cuts():
    """The float32 route's entry point from libraries built with
    ``-DFLASH_CUT=cut``, one ``nvcc`` a cut, all started together."""
    out = {cut: kernels.BUILD_DIR / "probe" / f"flash_cut{cut}.so" for cut in CUTS}
    kernels.BUILD_DIR.joinpath("probe").mkdir(parents=True, exist_ok=True)
    procs = {cut: subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DFLASH_CUT={cut}",
                                    "-o", str(path), str(ops.KERNEL.source)],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cut, path in out.items()}
    _, port = ops._entry("tf32x3")
    fns = {}
    for cut, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"FLASH_CUT={cut} build failed:\n{log}")
        fn = ctypes.CDLL(str(out[cut])).flash_attention_fwd_tf32x3
        fn.argtypes, fn.restype = port.argtypes, port.restype
        fns[cut] = fn
    return fns


def graph_us(launch) -> float:
    """Mean device µs of ``launch`` over LAUNCHES launches in one CUDA graph."""
    for _ in range(2):
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


def event_ms(fn) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LAUNCHES):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / LAUNCHES


def main(argv: Optional[Sequence[str]] = None) -> int:
    del argv  # no options
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(f"build {kernels.build():.2f} s", flush=True)
    for line in ops.KERNEL.build_log.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill", "warning", "smem")) \
                and "(C7519)" not in line:  # ptxas's notes on the arrives it adds before wgmma
            print(f"  {line.strip()}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    failed = 0
    for hd, hd_v in ((128, 128), (64, 64), (128, 64), (64, 128)):
        failed += not check_tile(gen, hd, hd_v)
    if failed:
        print("flash_probe: the tile's products are wrong; nothing else is run", flush=True)
        return 1

    kernel = ops.KERNEL
    for b, s, t, kh, g, hd, hd_v, causal, kv_len, dtype in CASES:
        q = torch.randn((b, s, kh, g, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, t, kh, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, t, kh, hd_v), generator=gen, device=dev).to(dtype)
        route = route_of(dtype, hd, hd_v)
        before = kernel.route_launches[route]
        out = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
        torch.cuda.synchronize()
        want = flash_attention_ref(q.double(), k.double(), v.double(), causal=causal,
                                   kv_len=kv_len)
        tol = 2e-5 if dtype == torch.float32 else 1e-2
        err = (out.double() - want).abs()
        ok = (kernel.route_launches[route] == before + 1 and bool(torch.isfinite(out).all())
              and not bool((err > tol + tol * want.abs()).any()))
        if kv_len == 0:
            ok = ok and bool((out == 0).all())
        if ok and s == 4096:
            ok = all(torch.equal(out, flash_attention(q, k, v, causal=causal)) for _ in range(3))
        failed += not ok
        print(f"  [{route}] {(b, s, t, kh, g, hd, hd_v)} causal={causal} kv_len={kv_len} "
              f"{str(dtype).split('.')[-1]}: max_abs_err {float(err.max()):.3e} (tol {tol:g})"
              f"{'; three more runs, the same bits' if ok and s == 4096 else ''} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        del q, k, v, out, want, err
    torch.cuda.empty_cache()

    B, S, K, G, hd = SERVING
    for label, dtype in (("bf16 [tensor_core]", torch.bfloat16), ("float32 [tf32x3]", torch.float32),
                         ("float32 [fma]", torch.float32)):
        if label.endswith("[fma]"):  # a base 4 bytes off 16: no tensor map takes it
            flat = torch.randn((B * S * K * G * hd + 1,), generator=gen, device=dev)
            q = flat[1:].view(B, S, K, G, hd)
        else:
            q = torch.randn((B, S, K, G, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, S, K, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, S, K, hd), generator=gen, device=dev).to(dtype)
        print(f"  serving shape B={B} K={K} G={G} S=T={S} hd={hd} causal {label} "
              f"(route {ops._route(q, k, v)}): "
              f"{event_ms(lambda: flash_attention(q, k, v)):.4f} ms a launch", flush=True)
        del q, k, v
    torch.cuda.empty_cache()

    fns = build_cuts()
    fns[0] = ops._entry("tf32x3")[1]
    lib, _ = ops._entry("tf32x3")
    q = torch.randn((B, S, K, G, hd), generator=gen, device=dev)
    k = torch.randn((B, S, K, hd), generator=gen, device=dev)
    v = torch.randn((B, S, K, hd), generator=gen, device=dev)
    out = torch.empty((B, S, K, G, hd), device=dev)
    scratch = torch.empty((lib.flash_tf32x3_scratch_floats(B, S, K, hd, hd, S),), device=dev)

    def run(fn):
        err = fn(0, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                 scratch.data_ptr(),
                 B, S, S, K, G, hd, hd, S, 1, hd ** -0.5, *ops._tma_strides(q),
                 *k.stride()[:3], *v.stride()[:3], stream_handle(dev))
        if err:
            raise RuntimeError(f"flash tf32x3 launch: CUDA error {err}")

    for cut, what in CUTS.items():
        print(f"  [tf32x3] FLASH_CUT={cut} ({what}): {graph_us(lambda: run(fns[cut])):.2f} us "
              f"a launch", flush=True)
    print(f"  [tf32x3] the whole kernel (+ the stores): {graph_us(lambda: run(fns[0])):.2f} us "
          f"a launch", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
