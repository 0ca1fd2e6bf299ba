"""A short card check of the flash backward kernels and the forward's lse: build, check, time.

    PYTHONPATH=src python -m repro_torch.launch.flash_bwd_probe

The quick first call after a change to ``kernels/csrc/flash_attention_bwd.cu``
or to the forward's lse epilogues in ``flash_attention.cu`` (``chip_smoke.py``
runs the same checks as part of phase 3, and times the backward in phase 5).
Builds the kernels and prints the backward source's ptxas report (registers,
spills, shared memory) and the count of ``HGMMA`` instructions in each of its
kernels (``cuobjdump -sass``). Then, on each case of :data:`CASES` (the
training paths' shapes, llama3.2-3b's, granite-moe-1b-a400m's,
deepseek-v2-236b's MLA (hd 192, hd_v 128, K = H = 128, G = 1),
jamba-1.5-large-398b's layer 4 (G = 8), whisper-base's encoder
(non-causal, S = T = 1,500), the last two in float32 too, and
llava-next-mistral-7b's (G = 4, S = T = 576 + 4,096 = 4,672: a causal tail
tile), the MLA
dims at K 4, S = T = 1,000 too, float32,
head dims 64 / 192 with hd_v 128 / 256, G of 1, 3, 8 and 64, non-causal,
ragged S and T, ``kv_len < T`` and ``kv_len = 0``), the forward kernel's ``out`` and ``lse`` go into the backward on every
route that takes the case (the ``fma`` route takes all; ``tensor_core`` the
bf16 cases at (hd, hd_v) in ``ops.BWD_TC_HEAD_DIMS``, ``ops._route_bwd``), whose dq, dk and dv
are held to the plain version on the same inputs in float64 and in their
own dtype and, where both routes ran, to each other (:func:`check_case`,
tolerances there; the plain versions a slice of heads at a time,
:func:`plain_by_heads`); a ``kv_len = 0`` case must give exactly zero gradients.
Three more runs of each training shape give the same bits. Every forward
route's lse is held to the float64 plain lse (:func:`check_lse`). Last, the
backward at llama3.2-3b's and deepseek-v2-236b's training shapes on each
route over 10 launches with CUDA events, and the split of its device time
between the dq and dkdv kernels from ``torch.profiler``. Exits 1 if a check fails, 2 without a card.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from repro_torch.kernels.flash_attention import ops

BF16, F32 = torch.bfloat16, torch.float32
TRAINING = (1, 4096, 4096, 8, 3, 128, 128, True, None, BF16)  # llama3.2-3b, train_4k
MOE_TRAINING = (1, 4096, 4096, 8, 2, 64, 64, True, None, BF16)  # granite-moe-1b-a400m
MLA_TRAINING = (1, 4096, 4096, 128, 1, 192, 128, True, None, BF16)  # deepseek-v2-236b's MLA
HYBRID_TRAINING = (1, 4096, 4096, 8, 8, 128, 128, True, None, BF16)  # jamba's layer 4
ENCODER_TRAINING = (2, 1500, 1500, 8, 1, 64, 64, False, None, BF16)  # whisper-base's encoder
# llava-next-mistral-7b: 576 image positions + 4,096 tokens, a causal tail tile of 64 rows
VLM_TRAINING = (1, 4672, 4672, 8, 4, 128, 128, True, None, BF16)
PATHS = (TRAINING, MOE_TRAINING, MLA_TRAINING, HYBRID_TRAINING, ENCODER_TRAINING, VLM_TRAINING)
CASES: Dict[str, Tuple] = {  # label: (b, s, t, kh, g, hd, hd_v, causal, kv_len, dtype)
    "training path": TRAINING,
    "granite training path": MOE_TRAINING,
    "deepseek training path": MLA_TRAINING,
    "jamba training path": HYBRID_TRAINING,
    "jamba training path float32": HYBRID_TRAINING[:-1] + (F32,),
    "whisper encoder training path": ENCODER_TRAINING,
    "whisper encoder training path float32": ENCODER_TRAINING[:-1] + (F32,),
    "G=4 S=T=4672 causal": VLM_TRAINING,
    "deepseek MLA training path": (1, 1000, 1000, 4, 1, 192, 128, True, None, BF16),
    "float32 S=T=1000": (1, 1000, 1000, 2, 3, 128, 128, True, None, F32),
    "hd=64": (2, 200, 200, 2, 3, 64, 64, True, None, BF16),
    "hd=256": (1, 300, 300, 2, 2, 256, 256, True, None, BF16),
    "float32 hd=256": (1, 300, 300, 2, 2, 256, 256, True, None, F32),
    "hd=192 hd_v=128": (1, 300, 300, 4, 1, 192, 128, True, None, BF16),
    "G=1": (1, 300, 300, 2, 1, 128, 128, True, None, BF16),
    "G=8": (1, 300, 300, 1, 8, 128, 128, True, None, BF16),
    "G=64 hd=32": (1, 70, 70, 1, 64, 32, 32, True, None, F32),
    "non-causal ragged S=100 T=160": (1, 100, 160, 1, 4, 16, 16, False, None, F32),
    "non-causal S=100 T=4096": (1, 100, 4096, 2, 3, 128, 128, False, None, BF16),
    "non-causal kv_len=777 T=1000": (1, 200, 1000, 2, 3, 128, 128, False, 777, BF16),
    "causal ragged S=T=1000": (1, 1000, 1000, 2, 3, 128, 128, True, None, BF16),
    "kv_len=17 hd=36 hd_v=20": (2, 70, 90, 2, 3, 36, 20, True, 17, F32),
    "kv_len=0": (1, 130, 130, 2, 3, 128, 128, True, 0, BF16),
    "float32 kv_len=0": (1, 65, 65, 1, 5, 8, 8, True, 0, F32),
}
LAUNCHES = 10
# score entries (B·K·G·S·T) a plain call holds at once: 4.3 GB a tensor in float64
PLAIN_ELEMENTS = 1 << 29

# Tolerances, each against the plain version on the same inputs (the kernel
# forward's out and lse included), as |got − want| ≤ tol·max|want| + tol·|want|
# per entry: the kernel sums in float32 in another order (rows of up to 4,096
# terms). Float32: 2e-4 against float64 and against float32 plain. bfloat16:
# P and dS are rounded to bf16 in the kernel and in the bf16 plain version
# (2^-8 relative) but not in float64, and a flipped rounding moves a sum by
# about that much of one term, so 2e-2 against either.
TOL = {F32: 2e-4, BF16: 2e-2}


def operands(gen: torch.Generator, b, s, t, kh, g, hd, hd_v, dtype):
    dev = gen.device
    q = torch.randn((b, s, kh, g, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, t, kh, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, t, kh, hd_v), generator=gen, device=dev).to(dtype)
    dout = torch.randn((b, s, kh, g, hd_v), generator=gen, device=dev).to(dtype)
    return q, k, v, dout


def _close(got: torch.Tensor, want: torch.Tensor, tol: float) -> Tuple[float, bool]:
    got, want = got.double(), want.double()
    err = (got - want).abs()
    limit = tol * float(want.abs().max()) + tol * want.abs()
    return float(err.max()) if err.numel() else 0.0, bool(torch.isfinite(got).all()) and bool(
        (err <= limit).all())


def plain_by_heads(fn: Callable, *xs: torch.Tensor, **kw):
    """``fn``, a plain version, on ``xs`` a slice of kv heads at a time (axis 2
    of every operand), its results joined on that axis: the same values, as
    heads do not mix, in the card's memory at deepseek's 128 heads, where
    one (B, K, G, S, T) float64 score tensor at B = 2, S = T = 4,096 is 34 GB."""
    b, s, kh, g = xs[0].shape[:4]
    step = max(1, PLAIN_ELEMENTS // (b * g * s * xs[1].shape[1]))
    if step >= kh:
        return fn(*xs, **kw)
    parts = [fn(*(x[:, :, i:i + step] for x in xs), **kw) for i in range(0, kh, step)]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=2)
    return tuple(torch.cat(p, dim=2) for p in zip(*parts))


def routes_of(q, k, v, out, dout) -> Tuple[str, ...]:
    """The backward routes that take a call: the one ``_route_bwd`` picks
    first, and the ``fma`` route, which takes every call, beside it."""
    picked = ops._route_bwd(q, k, v, out, dout)
    return (picked,) if picked == "fma" else (picked, "fma")


def run_route(route: str, q, k, v, out, lse, dout, causal=True, kv_len=None):
    """The backward on ``route``: the public call where the rule picks it,
    else the wrapper's launch with the route named."""
    if route == ops._route_bwd(q, k, v, out, dout):
        return flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, kv_len=kv_len)
    return ops._launch_bwd(q, k, v, out, lse, dout, causal, ops._kv_len(k, kv_len), route=route)


def check_case(gen: torch.Generator, label: str, case: Tuple,
               log: Callable[[str], None] = print,
               by_route: Optional[Dict[str, float]] = None) -> Tuple[float, float, bool]:
    """One case: the backward on every route that takes it, on the forward
    kernel's out and lse, against the plain version in float64 and in the
    case's dtype, and the routes against each other; one launch a call,
    counted on its route. Returns (float64 error, same-dtype error, ok): the
    largest absolute error over dq, dk, dv and the routes; ``by_route``
    gets each route's float64 error."""
    b, s, t, kh, g, hd, hd_v, causal, kv_len, dtype = case
    q, k, v, dout = operands(gen, b, s, t, kh, g, hd, hd_v, dtype)
    out, lse = flash_attention(q, k, v, causal=causal, kv_len=kv_len, return_lse=True)
    want64 = plain_by_heads(flash_attention_bwd_ref,
                            *(x.double() for x in (q, k, v, out, lse, dout)),
                            causal=causal, kv_len=kv_len)
    want = plain_by_heads(flash_attention_bwd_ref, q, k, v, out, lse, dout, causal=causal,
                          kv_len=kv_len)
    tol, name = TOL[dtype], str(dtype).split('.')[-1]
    e64 = e32 = 0.0
    all_ok, results = True, {}
    for route in routes_of(q, k, v, out, dout):
        launches, before = ops.KERNEL_BWD.launches, dict(ops.KERNEL_BWD.route_launches)
        got = run_route(route, q, k, v, out, lse, dout, causal, kv_len)
        torch.cuda.synchronize()
        ok = (ops.KERNEL_BWD.launches == launches + 1
              and ops.KERNEL_BWD.route_launches == dict(before, **{route: before[route] + 1}))
        r64 = r32 = 0.0
        for a, w64, w in zip(got, want64, want):
            err64, ok64 = _close(a, w64, tol)
            err32, ok32 = _close(a, w, tol)
            r64, r32, ok = max(r64, err64), max(r32, err32), ok and ok64 and ok32
            if kv_len == 0:
                ok = ok and bool((a == 0).all())
        log(f"  flash_attention_bwd [{route}] {label} {(b, s, t, kh, g, hd, hd_v)} "
            f"causal={causal} kv_len={kv_len} {name}: vs float64 plain max_abs_err={r64:.3e}, "
            f"vs {name} plain {r32:.3e} (tol {tol:g} of max|want| + {tol:g}·|want|)"
            f"{' zero gradients' if kv_len == 0 else ''}; one launch on the route "
            f"{'ok' if ok else 'FAIL'}")
        if by_route is not None:
            by_route[route] = max(by_route.get(route, 0.0), r64)
        e64, e32, all_ok, results[route] = max(e64, r64), max(e32, r32), all_ok and ok, got
    del want64, want
    if len(results) == 2:  # the two routes within the same tolerance of each other
        tc, fma = results["tensor_core"], results["fma"]
        worst, ok = 0.0, True
        for a, w in zip(tc, fma):
            err, close = _close(a, w, tol)
            worst, ok = max(worst, err), ok and close
        all_ok = all_ok and ok
        log(f"  flash_attention_bwd {label}: tensor_core vs fma max_abs_err={worst:.3e} "
            f"{'ok' if ok else 'FAIL'}")
    if all_ok and case in PATHS:  # deterministic: no float atomics
        got = results[routes_of(q, k, v, out, dout)[0]]
        again = [flash_attention_bwd(q, k, v, out, lse, dout, causal=causal) for _ in range(3)]
        all_ok = all(torch.equal(x, y) for run in again for x, y in zip(run, got))
        log(f"  flash_attention_bwd {label}: three more runs, "
            f"{'the same bits' if all_ok else 'OTHER BITS'}")
    return e64, e32, all_ok


LSE_CASES = {  # route: (b, s, t, kh, g, hd, hd_v, causal, kv_len, dtype)
    "tensor_core": (1, 1000, 1000, 2, 3, 128, 128, True, None, BF16),
    "tf32x3": (1, 1000, 1000, 2, 3, 128, 128, True, None, F32),
    "fma": (2, 70, 90, 2, 3, 36, 20, True, 17, F32),
    "tensor_core kv_len=0": (1, 130, 130, 2, 3, 128, 128, True, 0, BF16),
    "tf32x3 kv_len=0": (1, 130, 130, 2, 3, 128, 128, True, 0, F32),
    "fma kv_len=0": (1, 65, 65, 1, 5, 8, 8, True, 0, F32),
}


def check_lse(gen: torch.Generator, log: Callable[[str], None] = print) -> Tuple[float, bool]:
    """Every forward route's lse against the float64 plain lse (within 1e-4
    + 1e-5·|lse|: float32 scores and sums of up to 1,000 terms); a row with
    nothing visible +inf on every route; out the same with and without lse.
    Returns (largest error, ok)."""
    worst, all_ok = 0.0, True
    for label, (b, s, t, kh, g, hd, hd_v, causal, kv_len, dtype) in LSE_CASES.items():
        route = label.split()[0]
        q, k, v, _ = operands(gen, b, s, t, kh, g, hd, hd_v, dtype)
        before = dict(ops.KERNEL.route_launches)
        out, lse = flash_attention(q, k, v, causal=causal, kv_len=kv_len, return_lse=True)
        plain = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
        torch.cuda.synchronize()
        ok = ops.KERNEL.route_launches[route] == before[route] + 2 and torch.equal(out, plain)
        _, want = flash_attention_ref(q.double(), k.double(), v.double(), causal=causal,
                                      kv_len=kv_len, return_lse=True)
        inf = torch.isinf(want)
        ok = ok and torch.equal(torch.isinf(lse), inf) and bool((lse[inf] > 0).all())
        err = float((lse[~inf].double() - want[~inf]).abs().max()) if bool((~inf).any()) else 0.0
        ok = ok and bool(((lse[~inf].double() - want[~inf]).abs()
                          <= 1e-4 + 1e-5 * want[~inf].abs()).all())
        worst, all_ok = max(worst, err), all_ok and ok
        log(f"  flash_attention lse [{route}] {label} {(b, s, t, kh, g, hd, hd_v)}: max_abs_err "
            f"{err:.3e} (tol 1e-4 + 1e-5·|lse|), {int(inf.sum())} rows +inf, out the same "
            f"bits without lse {'ok' if ok else 'FAIL'}")
    return worst, all_ok


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


def kernel_split_ms(fn, n: int = LAUNCHES) -> Dict[str, float]:
    """Device milliseconds a call of ``fn`` spends in each kernel, by
    kernel name, from ``torch.profiler`` over ``n`` calls after two warm
    ones."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split: Dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            split[e.key] = split.get(e.key, 0.0) + e.self_device_time_total / 1e3 / n
    return split


def bwd_part(kernel_name: str) -> str:
    """The part of the backward a kernel's (mangled) name is: "dq", "dkdv"
    or ""."""
    for part in ("dkdv", "dq"):
        if f"flash_bwd_{part}_" in kernel_name:
            return part
    return ""


def hgmma_counts() -> Dict[str, int]:
    """``HGMMA`` instructions in each kernel of the backward's library, from
    ``cuobjdump -sass`` (empty without the tool)."""
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(ops.KERNEL_BWD.library_path())],
                              capture_output=True, text=True, timeout=120).stdout
    except OSError:
        return {}
    counts: Dict[str, int] = {}
    name = ""
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
        elif "HGMMA" in line and name:
            counts[name] = counts.get(name, 0) + 1
    return counts


def time_training_shape(gen: torch.Generator, log: Callable[[str], None] = print,
                        shape: Tuple = TRAINING) -> Dict:
    """The backward at a training shape (``TRAINING`` or ``MLA_TRAINING``)
    on each route: ms a launch from CUDA events, and the dq / dkdv split
    from the profiler."""
    b, s, t, kh, g, hd, hd_v, causal, _, dtype = shape
    q, k, v, dout = operands(gen, b, s, t, kh, g, hd, hd_v, dtype)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    timed = {}
    for route in routes_of(q, k, v, out, dout):
        run = lambda: run_route(route, q, k, v, out, lse, dout)  # noqa: E731
        ms = event_ms(run)
        split = {"dq": 0.0, "dkdv": 0.0}
        for key, part_ms in kernel_split_ms(run).items():
            if bwd_part(key):
                split[bwd_part(key)] += part_ms
        timed[route] = {"ms": ms, **{f"{part}_ms": x for part, x in split.items()}}
        log(f"  training shape {(b, s, t, kh, g, hd, hd_v)} [{route}]: backward {ms:.4f} ms a launch (events); profiler: "
            f"dq kernel {split['dq']:.4f} ms, dkdv kernel {split['dkdv']:.4f} ms")
    timed["forward_lse_ms"] = event_ms(lambda: flash_attention(q, k, v, return_lse=True))
    timed["forward_ms"] = event_ms(lambda: flash_attention(q, k, v))
    log(f"  training shape: forward with lse {timed['forward_lse_ms']:.4f} ms, without "
        f"{timed['forward_ms']:.4f} ms a launch")
    return timed


def main(argv: Optional[Sequence[str]] = None) -> int:
    del argv  # no options
    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(f"build {kernels.build():.2f} s", flush=True)
    log = lambda m: print(m, flush=True)  # noqa: E731
    for line in ops.KERNEL_BWD.build_log.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill", "warning", "error")):
            log(f"  {line.strip()}")
    for name, n in sorted(hgmma_counts().items()):
        log(f"  cuobjdump -sass: {n} HGMMA in {name}")
    gen = torch.Generator(device=dev).manual_seed(0)
    failed = 0
    _, ok = check_lse(gen, log)
    failed += not ok
    for label, case in CASES.items():
        failed += not check_case(gen, label, case, log)[2]
        torch.cuda.empty_cache()
    for shape in (TRAINING, MLA_TRAINING):
        time_training_shape(gen, log, shape)
        torch.cuda.empty_cache()
    print(f"flash_bwd_probe: {'FAIL' if failed else 'ok'}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
