"""A short card check of the IMG sweep route: build, check, time its phases.

    PYTHONPATH=src python -m repro_torch.launch.img_probe

The quick first call after a change to ``kernels/csrc/img_weights.cu``
(``chip_smoke.py`` checks every kernel and path and takes minutes). Builds
the kernels and prints the source's ptxas report; holds the sweep route
against its plain sweep at the path's shape (B=16 chains, M=10 machines,
T=1,200, d=50) for the w_t and W_t weights (``ops.sweep_agreement``, the
card tests' rule) and checks that three launches give the same bits. Then
times the sweep and copies of it built with phases cut out (``IMG_CUT``:
an empty launch of the grid, the copies in, the single-site weights, the
Gram, the triangular solves) as the mean of 100 launches captured in one
CUDA graph: device time with no host in it. Exits 1 if a check fails, 2
without a card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import unittest.mock
from typing import Optional, Sequence

import torch

from repro_torch import kernels
from repro_torch.core.combiners import img
from repro_torch.core.combiners.api import resolve_schedule
from repro_torch.kernels.img_weights import img_sweep, img_sweep_ref, ops, sweep_agreement

B, M, T, D = 16, 10, 1200, 50
# IMG_CUT builds: where each leaves the sweep kernel
CUTS = {1: "an empty launch of the grid", 2: "after the copies in",
        3: "after the single-site weights", 4: "after the Gram", 5: "after the solves"}
LAUNCHES = 100


def build_cut(cut: int):
    """``ops._entry()``'s triple for the source built with ``-DIMG_CUT=cut``."""
    out = kernels.BUILD_DIR / "probe" / f"img_cut{cut}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DIMG_CUT={cut}", "-o", str(out),
                    str(ops.KERNEL.source)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib_port, generic, sweep = ops._entry()
    fn = lib.img_sweep_f32
    fn.argtypes, fn.restype = sweep.argtypes, sweep.restype
    return lib_port, generic, fn


def graph_us(launch) -> float:
    """Mean device µs of ``launch`` over LAUNCHES launches in one CUDA graph."""
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with kernels.LaunchTally().capturing(), torch.cuda.graph(graph):
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
        print("img_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(f"build {kernels.build():.2f} s", flush=True)
    for line in ops.KERNEL.build_log.splitlines():
        if "registers" in line or "spill" in line or "warning" in line:
            print(f"  {line.strip()}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    centre = torch.randn((D,), generator=gen, device=dev)
    samples = (centre + 0.3 * torch.randn((M, 1, D), generator=gen, device=dev)
               + 0.3 * torch.randn((M, T, D), generator=gen, device=dev))
    counts = torch.full((M,), T, dtype=torch.int32, device=dev)
    h = resolve_schedule(samples, None, False)(10 * B)
    libs = {cut: build_cut(cut) for cut in CUTS}
    failed = 0
    for wt in (False, True):
        form = "W_t" if wt else "w_t"
        model = img.semiparametric_model(samples, counts) if wt else img.nonparametric_model(samples)
        carry = img._init_img_carry(gen, samples, counts, model.aux, B)
        c = img._randint_below(gen, (B, M), counts)
        u = torch.rand((B, M), generator=gen, device=dev)
        term = model.state_term(h) if wt else None

        def run():
            return img_sweep(carry, samples, c, u, h, aux=model.aux, state_term=term)

        got = run()
        want = img_sweep_ref(carry, samples, c, u, h, model.aux,
                             model.extra_logweight(h.expand(B)) if wt else None)
        rep = sweep_agreement(got, want, u)
        same = all(torch.equal(a, b) for _ in range(3) for a, b in zip(run(), got))
        ok = rep["ok"] and same
        failed += not ok
        print(f"  {form} B={B} M={M} T={T} d={D}: {rep}; three launches the same bits: {same} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        for cut, what in CUTS.items():
            if cut == 5 and not wt:
                continue  # w_t has no solves
            with unittest.mock.patch.object(ops, "_entry", lambda: libs[cut]):
                t = graph_us(run)
            print(f"  {form} IMG_CUT={cut} ({what}): {t:.2f} us a launch", flush=True)
        print(f"  {form} the whole sweep: {graph_us(run):.2f} us a launch", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
