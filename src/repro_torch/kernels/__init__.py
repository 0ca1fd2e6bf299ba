"""Hand-written CUDA kernels of the port: build, load, dispatch rule, launch counts.

One subpackage per kernel, as in :mod:`repro.kernels`: ``ref.py`` is the
plain PyTorch version and ``ops.py`` the public wrapper. The CUDA C++ sources
live in ``csrc/``, one file per kernel, each with a plain C entry point that
returns its ``cudaError_t``.

Dispatch rule, the same for every wrapper: a CUDA tensor launches the
hand-written kernel, or the wrapper raises; a CPU tensor takes the plain
version. There is no environment override, no size threshold and no fallback
after a failed launch.

Build: at the first kernel call (or an explicit :func:`build`), every source
is compiled by its own ``nvcc`` for ``sm_90a``, all started together, into a
shared library under ``kernels/build/`` whose name carries a hash of the
source and the flags, and is loaded with :mod:`ctypes`. A library already
built from the same source and flags is loaded as it is.

Each :class:`Kernel` keeps ``launches``, a plain count that its wrapper raises
by one where it launches the kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Kernel:
    """One hand-written kernel: its source, its loaded library, its launches."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = CSRC / source
        self.replaces = replaces  # file:line of the TPU kernel it ports
        self.launches = 0
        self.build_log = ""  # nvcc's -Xptxas -v report of the last build
        self._lib: Optional[ctypes.CDLL] = None

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{digest.hexdigest()[:16]}.so"

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            build()
        return self._lib


KERNELS: Dict[str, Kernel] = {
    "logreg_loglik_grad": Kernel(
        "logreg_loglik_grad", "logreg_loglik.cu",
        replaces="src/repro/kernels/logreg_loglik/kernel.py:62",
    ),
    "img_log_weights": Kernel(
        "img_log_weights", "img_weights.cu",
        replaces="src/repro/kernels/img_weights/kernel.py:54",
    ),
}

_BUILD_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (neither on PATH nor at /usr/local/cuda/bin); "
            "the port's CUDA kernels are built with it at first use"
        )
    return found


def build() -> float:
    """Build (or load) every kernel's library; returns the seconds it took.

    One ``nvcc`` per source, all running at once. Raises with the compiler's
    output when one fails.
    """
    with _BUILD_LOCK:
        t0 = time.perf_counter()
        pending = [k for k in KERNELS.values() if k._lib is None]
        if not pending:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for k in pending:
            out = k.library_path()
            if out.exists():
                k.build_log = f"{out.name}: built earlier from the same source"
                continue
            tmp = out.with_suffix(f".tmp{id(k)}.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(k.source)]
            procs[k.name] = (k, tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failed = []
        for k, tmp, out, proc in procs.values():
            log, _ = proc.communicate()
            k.build_log = log
            if proc.returncode != 0:
                failed.append(f"{k.source.name} (nvcc exit {proc.returncode}):\n{log}")
            else:
                tmp.replace(out)  # atomic: a reader never sees half a library
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for k in pending:
            k._lib = ctypes.CDLL(str(k.library_path()))
        return time.perf_counter() - t0


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def check_error(kernel: Kernel, err: int, error_string) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = error_string(err)
        raise RuntimeError(
            f"{kernel.name}: CUDA error {err} "
            f"({msg.decode() if msg else 'unknown'}) at launch"
        )


def check_tensor(
    t: torch.Tensor, name: str, *, device: torch.device, ndim: int
) -> None:
    """What every CUDA launch requires of an operand; raises otherwise."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, for a C entry point."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()
