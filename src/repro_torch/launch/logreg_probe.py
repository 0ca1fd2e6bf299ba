"""A short card check of the likelihood kernel: build, check, time its phases.

    PYTHONPATH=src python -m repro_torch.launch.logreg_probe

The quick first call after a change to ``kernels/csrc/logreg_loglik.cu``
(``chip_smoke.py`` checks every kernel and path and takes minutes). Builds
the kernels and prints the likelihood source's ptxas report; holds the
kernel against its plain version at the paths' shapes and ragged ones (ℓ
within rtol 1e-5 / atol 1e-3, ∇ℓ within rtol 1e-4 / atol 1e-2, the card
tests' tolerances) and checks that three runs give the same bits. Then, at
the sampling (G=10, N=5,000, d=50) and groundtruth (G=1, N=50,000) shapes,
times the kernel and copies of it built with phases cut out
(``LOGREG_CUT``: the arithmetic, the ticket and last block's sum, the copies
in, everything) as the mean of 100 launches captured in one CUDA graph:
device time with no host in it, the kernels back to back as in the chains'
graphs. Exits 1 if a check fails, 2 without a card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from typing import Optional, Sequence

import torch

from repro_torch import kernels
from repro_torch.kernels.logreg_loglik import logreg_loglik_grad, logreg_loglik_grad_ref
from repro_torch.kernels.logreg_loglik.ops import _layout, _tickets

CASES = [(10, 5000, 50, 1), (1, 50000, 50, 1), (1, 1, 50, 1), (3, 4999, 37, 2),
         (2, 65, 130, 3), (4, 333, 1, 1), (2, 777, 300, 2), (1, 300, 1024, 1)]
# LOGREG_CUT builds: what each leaves of the kernel
CUTS = {0: "the kernel", 1: "without the arithmetic", 2: "without the ticket and last block",
        3: "copies in and partials only", 4: "without the copies in",
        6: "arithmetic on shared memory and partials only", 7: "launch and partials only",
        8: "an empty launch of its grid"}
LAUNCHES = 100


def build_cut(cut: int) -> ctypes.CDLL:
    """The likelihood source built with ``-DLOGREG_CUT=cut``, loaded."""
    k = kernels.KERNELS["logreg_loglik_grad"]
    out = kernels.BUILD_DIR / "probe" / f"logreg_cut{cut}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DLOGREG_CUT={cut}", "-o",
                    str(out), str(k.source)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.logreg_loglik_grad_f32.argtypes = [I, P, P, P, P, P, P, I, I, I, I, ctypes.c_float, P]
    lib.logreg_loglik_grad_f32.restype = I
    return lib


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
        print("logreg_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(f"build {kernels.build():.2f} s", flush=True)
    for line in kernels.KERNELS["logreg_loglik_grad"].build_log.splitlines():
        if "registers" in line or "spill" in line or "warning" in line:
            print(f"  {line.strip()}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(G, N, d, C):
        X = torch.randn((G, N, d), generator=gen, device=dev)
        y = torch.where(torch.rand((G, N), generator=gen, device=dev) < 0.5, -1.0, 1.0)
        return X, y, torch.randn((G, d, C), generator=gen, device=dev)

    failed = 0
    for shape in CASES:
        X, y, beta = inputs(*shape)
        ll, g = logreg_loglik_grad(X, y, beta, scale=0.5)
        ll_r, g_r = logreg_loglik_grad_ref(X, y, beta, scale=0.5)
        ok = (bool(((ll - ll_r).abs() <= 1e-3 + 1e-5 * ll_r.abs()).all())
              and bool(((g - g_r).abs() <= 1e-2 + 1e-4 * g_r.abs()).all())
              and all(torch.equal(a, b) for _ in range(3)
                      for a, b in zip(logreg_loglik_grad(X, y, beta, scale=0.5), (ll, g))))
        failed += not ok
        print(f"  {shape}: ll max_abs_err {float((ll - ll_r).abs().max()):.3e}, grad "
              f"{float((g - g_r).abs().max()):.3e}, three runs the same bits: "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    libs = {cut: build_cut(cut) for cut in CUTS}
    for G, N, d, C in CASES[:2]:
        X, y, beta = inputs(G, N, d, C)
        nblk, Rp = _layout(N, d, C)
        part = torch.empty((G, nblk, Rp), device=dev)
        out = torch.empty((G, C + d * C), device=dev)
        for cut, what in CUTS.items():
            fn = libs[cut].logreg_loglik_grad_f32

            def launch():
                err = fn(0, X.data_ptr(), y.data_ptr(), beta.data_ptr(), part.data_ptr(),
                         out.data_ptr(), _tickets(dev).data_ptr(), G, N, d, C, 1.0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"LOGREG_CUT={cut}: CUDA error {err}")

            t = graph_us(launch)  # a build without the ticket never takes one
            print(f"  G={G} N={N} d={d} C={C} LOGREG_CUT={cut} ({what}): {t:.2f} us a launch",
                  flush=True)
        print(f"  G={G} N={N} d={d} C={C} port's wrapper: "
              f"{graph_us(lambda: logreg_loglik_grad(X, y, beta)):.2f} us a launch", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
