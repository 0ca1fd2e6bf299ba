"""A short card check of the online_update kernel: build, check, time its phases.

    PYTHONPATH=src python -m repro_torch.launch.online_probe

The quick first call after a change to ``kernels/csrc/online_update.cu``
(``chip_smoke.py`` checks every kernel and path and takes minutes). Builds
the kernels and prints the source's ptxas report; holds the kernel to its
plain version in float64 on :data:`CASES` (the stream path's fold, the slab
route's shapes, an unaligned slice of a draw buffer; the same inputs as
``chip_smoke.py`` phase 3), checks which route each took, that three
launches give the same bits and that the slab route gives the same bits
too. Then it times each phase of the kernel through the
``online_update_probe`` C entry (cut 0: an empty body, the launch floor; 1:
the copies and their wait; 2: + the chunk mean and the centring; 3: + the
Gram; 4: the whole kernel) as the mean of 20 launches captured in one CUDA
graph, at the path's fold on the whole route and on the slab route, and at
the slab route's two shapes, with the whole route's phases stamped inside the
kernel (cycles and ns from each boundary to the next), from a library of the
source built with ``-DONLINE_PROBE`` (the wrapper's library has only cuts 0
and 4); and the host's microseconds a call of the wrapper and of each of its
parts. Exits 1 if a check fails, 2 without a card.

    python src/repro_torch/launch/online_probe.py --errors

prints only each case's float64 error through the public wrapper of
whichever ``repro_torch`` is first on the path (run with another tree's
``src`` on ``PYTHONPATH`` to read that tree's kernel on the same inputs);
``--times`` prints each case's time a call of that public wrapper instead,
graph-timed as above (launches and allocations, no host).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from typing import Optional, Sequence

import torch

# label: (M, C, d, ragged, the first row of a (M, T, d) buffer the chunk is
# a slice of, or None for a contiguous chunk)
CASES = {
    "path fold": (10, 120, 50, False, None),
    "path fold ragged": (10, 120, 50, True, None),
    "C=1": (3, 1, 50, False, None),
    "C=31 d=65 ragged": (4, 31, 65, True, None),
    "M=d=1": (1, 7, 1, False, None),
    "slab: the draw buffer as one chunk": (10, 1200, 50, False, None),
    "slab: d=300 ragged": (10, 120, 300, True, None),
    "unaligned: d=37 slice from row 121": (10, 120, 37, False, 121),
}
BUFFER_T = 1200  # rows of the draw buffer a slice case cuts
CUTS = {0: "an empty body (the launch floor)", 1: "the copies and their wait",
        2: "+ the chunk mean and the centring", 3: "+ the Gram",
        4: "the whole kernel (+ the merge)"}
STAMPED = 5  # the whole kernel, stamping its phase boundaries
STAMPS = ("start", "copies landed", "column sums", "means", "centred", "Gram", "merged")


def case_inputs(label: str, device: torch.device):
    """A running state after 240 draws and a chunk shifted from it, from a
    generator seeded by the case's place in :data:`CASES`; when ragged, NaN
    beyond each count and an empty machine."""
    M, C, d, ragged, row0 = CASES[label]
    gen = torch.Generator(device=device).manual_seed(20 + list(CASES).index(label))
    count = torch.full((M,), 240.0, device=device)
    mean = torch.randn((M, d), generator=gen, device=device)
    a = torch.randn((M, 2 * d, d), generator=gen, device=device)
    rows = C if row0 is None else BUFFER_T
    chunk = mean[:, None, :] + 0.3 + torch.randn((M, rows, d), generator=gen, device=device)
    counts = None
    if ragged:
        counts = torch.randint(1, C + 1, (M,), generator=gen, device=device).to(torch.int32)
        counts[0] = 0
        r = torch.arange(C, device=device)[None, :, None]
        chunk = torch.where(r < counts[:, None, None], chunk, float("nan"))
    chunk = chunk.contiguous() if row0 is None else chunk[:, row0:row0 + C]
    return count, mean, a.transpose(1, 2) @ a, chunk, counts


def state_error(got, want):
    """(max abs error, within 1e-5 of float64): count exact, mean within
    1e-5·(1 + |mean|), m2 within 1e-5·max|m2| of each machine."""
    (c, mu, m2), (cw, muw, m2w) = got, want
    mu_err = (mu.double() - muw.double()).abs()
    m2_err = (m2.double() - m2w.double()).abs()
    scale = m2w.double().abs().amax(dim=(1, 2), keepdim=True).clamp(min=1e-30)
    ok = (bool(torch.equal(c.double(), cw.double()))
          and bool(torch.isfinite(mu).all()) and bool(torch.isfinite(m2).all())
          and bool((mu_err <= 1e-5 * (1.0 + muw.double().abs())).all())
          and bool((m2_err <= 1e-5 * scale).all()))
    return max(float(mu_err.max()), float(m2_err.max())), ok


def float64_errors(device) -> int:
    """Each case's float64 error through the public wrapper; returns failures."""
    from repro_torch.kernels.online_update import online_moments_update, online_moments_update_ref

    failed = 0
    for label in CASES:
        count, mean, m2, chunk, counts = case_inputs(label, device)
        got = online_moments_update(count, mean, m2, chunk, counts)
        want = online_moments_update_ref(count.double(), mean.double(), m2.double(),
                                         chunk.double(), counts)
        err, ok = state_error(got, want)
        failed += not ok
        print(f"  {label} {tuple(chunk.shape)} vs float64 plain: max_abs_err={err:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    return failed


def wrapper_times(device) -> None:
    """Each case's device µs a call of the public wrapper, graph-timed."""
    from repro_torch.kernels.online_update import online_moments_update
    from repro_torch.launch.kde_probe import graph_us

    for label in CASES:
        count, mean, m2, chunk, counts = case_inputs(label, device)
        us = graph_us(lambda: online_moments_update(count, mean, m2, chunk, counts))
        print(f"  {label} {tuple(chunk.shape)}: {us:.2f} us a call (graph-timed)", flush=True)


def probe_entry(probe_build: bool = False):
    """``online_update_probe`` from the wrapper's library (cuts 0 and 4), or,
    with ``probe_build``, from the source built with ``-DONLINE_PROBE`` (every
    cut) into the build directory's ``probe/``."""
    from repro_torch import kernels
    from repro_torch.kernels.online_update import ops

    lib, port = ops._entry()
    if probe_build:
        out = kernels.BUILD_DIR / "probe" / "online_probe.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        done = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DONLINE_PROBE", "-o",
                               str(out), str(ops.KERNEL.source)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"ONLINE_PROBE build failed:\n{done.stdout}")
        for line in done.stdout.splitlines():
            if any(w in line for w in ("registers", "spill", "warning", "error")):
                print(f"  probe build: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(out))
    fn = lib.online_update_probe
    fn.argtypes = [ctypes.c_int] + port.argtypes[:9] + [ctypes.c_void_p] + port.argtypes[9:]
    fn.restype = ctypes.c_int
    return fn


def probe_launch(fn, cut, route, count, mean, m2, chunk, counts=None):
    """A closure launching the kernel cut at ``cut`` on ``route``, its
    buffers made beforehand; raises on a failed launch."""
    from repro_torch.kernels import device_index, stream_handle
    from repro_torch.kernels.online_update import ops

    M, C, d = chunk.shape
    dev = chunk.device
    outs = (torch.empty_like(count), torch.empty_like(mean), torch.empty_like(m2))
    sink = torch.empty((M * ops._plan(M, C, d).blocks * ops.THREADS,), dtype=torch.float32,
                       device=dev)
    args = (cut, device_index(dev), chunk.data_ptr(), None if counts is None else counts.data_ptr(),
            count.data_ptr(), mean.data_ptr(), m2.data_ptr(), *(o.data_ptr() for o in outs),
            sink.data_ptr(), M, C, d, chunk.stride(0), ops.ROUTES.index(route))

    def run():  # the current stream: a capture's, inside one
        err = fn(*args, stream_handle(dev))
        if err:
            raise RuntimeError(f"online_update_probe cut {cut}: CUDA error {err}")

    run.buffers = (outs, sink)  # kept alive with the closure
    return run


def phase_stamps(fn, count, mean, m2, chunk) -> None:
    """The stamped kernel's phases on the whole route: cycles and ns from each
    boundary to the next, the mean and the largest over blocks, from the last
    of 20 launches; and the SM clock those imply."""
    from repro_torch.kernels.online_update import ops

    run = probe_launch(fn, STAMPED, "whole", count, mean, m2, chunk)
    for _ in range(20):
        run()
    torch.cuda.synchronize()
    blocks = chunk.shape[0] * ops._plan(*chunk.shape).blocks
    t = run.buffers[1].view(torch.int64)[: blocks * 16].view(blocks, 2, 8)[:, :, : len(STAMPS)]
    dt = (t[:, :, 1:] - t[:, :, :-1]).double()  # (blocks, cycles | ns, phase)
    span = (t[:, :, -1] - t[:, :, 0]).double()  # (blocks, cycles | ns)
    ghz = float(span[:, 0].sum() / span[:, 1].sum())
    for k in range(len(STAMPS) - 1):
        cyc, ns = dt[:, 0, k], dt[:, 1, k]
        print(f"    {STAMPS[k]} -> {STAMPS[k + 1]}: {float(cyc.mean()):.0f} cycles (max "
              f"{float(cyc.max()):.0f}), {float(ns.mean()):.0f} ns (max {float(ns.max()):.0f})",
              flush=True)
    first, last = int(t[:, 1, 0].min()), int(t[:, 1, -1].max())
    print(f"    a block start to merged: {float(span[:, 1].mean()):.0f} ns (max "
          f"{float(span[:, 1].max()):.0f}); first start to last merged {last - first} ns; SM clock "
          f"{ghz:.3f} GHz", flush=True)


def host_us(call, n=2000) -> float:
    """Host microseconds a call, over ``n`` calls after 50 to warm up."""
    for _ in range(50):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    us = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    return us


def host_breakdown(dev) -> None:
    """Where the wrapper's host time goes, at the path's fold."""
    from repro_torch.kernels import check_tensor, device_index, stream_handle
    from repro_torch.kernels.online_update import online_moments_update, ops

    count, mean, m2, chunk, _ = case_inputs("path fold", dev)
    counts = torch.full((count.shape[0],), chunk.shape[1], dtype=torch.int32, device=dev)
    lib, fn = ops._entry()
    plan = ops._plan(*chunk.shape)
    outs = (torch.empty_like(count), torch.empty_like(mean), torch.empty_like(m2))
    stream = stream_handle(dev)
    args = (device_index(dev), chunk.data_ptr(), None, count.data_ptr(), mean.data_ptr(),
            m2.data_ptr(), *(o.data_ptr() for o in outs), *chunk.shape, chunk.stride(0),
            ops.ROUTES.index(plan.route), stream)

    def checks():
        check_tensor(count, "count", device=dev, ndim=1)
        check_tensor(mean, "mean", device=dev, ndim=2)
        check_tensor(m2, "m2", device=dev, ndim=3)

    def three_outputs():
        return torch.empty_like(count), torch.empty_like(mean), torch.empty_like(m2)

    def one_output(M, C, d):
        c, mu, s = torch.empty((M * (1 + d + d * d),), dtype=torch.float32,
                               device=dev).split((M, M * d, M * d * d))
        return c, mu.view(M, d), s.view(M, d, d)

    parts = {
        "the wrapper, no counts": lambda: online_moments_update(count, mean, m2, chunk),
        "the wrapper, int32 counts on the card": lambda: online_moments_update(
            count, mean, m2, chunk, counts),
        "three check_tensor": checks,
        "torch.as_tensor(counts).to(int32).contiguous()": lambda: torch.as_tensor(
            counts, device=dev).to(torch.int32).contiguous(),
        "three empty_like": three_outputs,
        "one torch.empty, split in three, two views": lambda: one_output(*chunk.shape),
        "stream_handle": lambda: stream_handle(dev),
        "torch.cuda.current_stream(device).cuda_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "device_index": lambda: device_index(dev),
        "ops._plan (cached)": lambda: ops._plan(*chunk.shape),
        "the C entry with its arguments made (device check + launch)": lambda: fn(*args),
    }
    for label, call in parts.items():
        print(f"  host: {label}: {host_us(call):.2f} us a call", flush=True)
    for name in ("libcudart.so", "/usr/local/cuda/lib64/libcudart.so"):
        try:  # the runtime's cudaSetDevice, which the first design's entry called every call
            cudart = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        print("  host: cudaSetDevice: not measured (no libcudart.so found)", flush=True)
        return
    index = device_index(dev)
    print(f"  host: cudaSetDevice (a second runtime's): "
          f"{host_us(lambda: cudart.cudaSetDevice(index)):.2f} us a call", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not torch.cuda.is_available():
        print("online_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    if argv == ["--errors"]:
        return 1 if float64_errors(dev) else 0
    if argv == ["--times"]:
        wrapper_times(dev)
        return 0

    from repro_torch import kernels
    from repro_torch.kernels.online_update import online_moments_update, ops
    from repro_torch.launch.kde_probe import graph_us

    print(f"build {kernels.build():.2f} s", flush=True)
    for line in ops.KERNEL.build_log.splitlines():
        if any(w in line for w in ("registers", "spill", "warning", "error")):
            print(f"  {line.strip()}", flush=True)
    failed = float64_errors(dev)
    for label in CASES:
        count, mean, m2, chunk, counts = case_inputs(label, dev)
        plan = ops._plan(*chunk.shape)
        before = dict(ops.KERNEL.route_launches)
        got = online_moments_update(count, mean, m2, chunk, counts)
        rose = [r for r, n in ops.KERNEL.route_launches.items() if n != before[r]]
        again = [online_moments_update(count, mean, m2, chunk, counts) for _ in range(3)]
        same = all(torch.equal(a, b) for r in again for a, b in zip(r, got))
        tiles = -(-chunk.shape[2] // ops.TILE)
        alike = all(torch.equal(a, b)
                    for a, b in zip(ops._launch(count, mean, m2, chunk, counts, route="slab"), got))
        symmetric = torch.equal(got[2], got[2].transpose(1, 2))
        ok = rose == [plan.route] and same and alike and symmetric
        failed += not ok
        print(f"  {label}: {plan} ({tiles} tiles a side), route counted {rose}, three launches "
              f"the same bits {same}, the slab route the same bits {alike}, m2 symmetric "
              f"{symmetric} {'ok' if ok else 'FAIL'}", flush=True)
    if failed:
        print("online_probe: a check failed; nothing is timed", flush=True)
        return 1

    fn = probe_entry(probe_build=True)
    for label in ("path fold", "slab: the draw buffer as one chunk", "slab: d=300 ragged"):
        count, mean, m2, chunk, _ = case_inputs(label, dev)
        route = ops._plan(*chunk.shape).route
        for name in (route, "slab") if route == "whole" else (route,):
            smem = ops.smem_bytes(name, *chunk.shape[1:])
            for cut, what in CUTS.items():
                run = probe_launch(fn, cut, name, count, mean, m2, chunk)
                print(f"  {label} {tuple(chunk.shape)} [{name}, {smem} B] cut {cut} ({what}): "
                      f"{graph_us(run):.2f} us a launch", flush=True)
            if name == "whole":
                print(f"  {label} [{name}] phases inside the kernel (thread 0 of each block):",
                      flush=True)
                phase_stamps(fn, count, mean, m2, chunk)
    host_breakdown(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
