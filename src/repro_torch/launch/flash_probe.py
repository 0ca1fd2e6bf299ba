"""A short card check of the flash kernel's tensor-core route: build, check, time.

    PYTHONPATH=src python -m repro_torch.launch.flash_probe

The quick first call after a change to ``kernels/csrc/flash_attention.cu``
(``chip_smoke.py`` checks every kernel and path and takes minutes). Builds
the kernels and prints the flash source's build seconds and ptxas report,
runs the tensor-core route on a dozen bf16 cases (G = 1, 3, 7; hd 64 to 256
and MLA's 192/128; causal and not; kv_len < T and kv_len = 0; the serving
path's prefill shape) against the plain version in float64 within 1e-2
(rtol and atol, the bf16 tolerance of the card tests), then times the
serving shape (B=2, K=8, G=3, S=T=4,096, hd=128, causal) over 20 launches
with CUDA events. Exits 1 if a case fails, 2 without a card.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

CASES = [  # b, s, t, kh, g, hd, hd_v, causal, kv_len
    (1, 64, 64, 1, 3, 64, 64, False, None),
    (1, 64, 64, 1, 3, 128, 128, False, None),
    (1, 128, 128, 1, 3, 128, 128, True, None),
    (1, 300, 300, 2, 1, 128, 128, True, None),
    (1, 300, 300, 1, 7, 128, 128, True, None),
    (1, 100, 4096, 2, 3, 128, 128, False, None),
    (1, 200, 1000, 2, 3, 128, 128, False, 777),
    (1, 130, 130, 2, 3, 128, 128, True, 0),
    (1, 300, 300, 4, 1, 192, 128, True, None),
    (1, 200, 200, 2, 2, 256, 256, True, None),
    (1, 200, 200, 2, 2, 64, 192, True, None),
    (2, 4096, 4096, 8, 3, 128, 128, True, None),
]


def main(argv: Optional[Sequence[str]] = None) -> int:
    del argv  # no options
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(f"build {kernels.build():.2f} s", flush=True)
    for line in kernels.KERNELS["flash_attention"].build_log.splitlines():
        if "registers" in line or "spill" in line or "warning" in line:
            print(f"  {line.strip()}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    kernel = kernels.KERNELS["flash_attention"]
    failed = 0
    for b, s, t, kh, g, hd, hd_v, causal, kv_len in CASES:
        q = torch.randn((b, s, kh, g, hd), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, t, kh, hd), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, t, kh, hd_v), generator=gen, device=dev).bfloat16()
        before = kernel.route_launches["tensor_core"]
        out = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
        torch.cuda.synchronize()
        want = flash_attention_ref(q.double(), k.double(), v.double(), causal=causal,
                                   kv_len=kv_len)
        err = (out.double() - want).abs()
        ok = (kernel.route_launches["tensor_core"] == before + 1
              and not bool((err > 1e-2 + 1e-2 * want.abs()).any()))
        failed += not ok
        print(f"  {(b, s, t, kh, g, hd, hd_v)} causal={causal} kv_len={kv_len}: "
              f"max_abs_err {float(err.max()):.3e} {'ok' if ok else 'FAIL'}", flush=True)
    q = torch.randn((2, 4096, 8, 3, 128), generator=gen, device=dev).bfloat16()
    k = torch.randn((2, 4096, 8, 128), generator=gen, device=dev).bfloat16()
    v = torch.randn((2, 4096, 8, 128), generator=gen, device=dev).bfloat16()
    for _ in range(3):
        flash_attention(q, k, v)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        flash_attention(q, k, v)
    end.record()
    torch.cuda.synchronize()
    print(f"serving shape B=2 K=8 G=3 S=T=4096 hd=128 causal bf16: "
          f"{start.elapsed_time(end) / 20:.4f} ms a launch", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
