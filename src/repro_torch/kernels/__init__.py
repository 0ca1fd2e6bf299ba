"""Hand-written CUDA kernels of the port: build, load, dispatch rule, launch counts.

One subpackage per kernel, as in :mod:`repro.kernels`: ``ref.py`` is the
plain PyTorch version and ``ops.py`` the public wrapper (the flash
backward, which ports no Pallas kernel, lives beside its forward). The CUDA C++ sources
live in ``csrc/``, one file per kernel, each with a plain C entry point that
returns its ``cudaError_t``.

Dispatch rule, the same for every wrapper: a CUDA tensor launches the
hand-written kernel, or the wrapper raises; a CPU tensor takes the plain
version. There is no environment override, no size threshold and no fallback
after a failed launch.

Build: at the first kernel call (or an explicit :func:`build`), every source
is compiled by its own ``nvcc`` for ``sm_90a``, all started together, into a
shared library under ``kernels/build/`` whose name carries a hash of the
source, the headers it includes from ``csrc/`` and the flags, and is loaded
with :mod:`ctypes`. Kernels that share a source (the machine KDE and its
single-cloud form) share one build and one library. A library already built
from the same source, headers and flags is loaded as it is.

Each :class:`Kernel` keeps ``launches``, a plain count that its wrapper raises
by one (:meth:`Kernel.count_launch`) where it launches the kernel and nowhere
else. A kernel with more than one route (``flash_attention``: bf16 tensor
cores, float32 tensor cores or FMAs) also keeps ``route_launches``, the same
launches counted by route. The counts are shared by every thread (the
posterior server launches kernels from its sampler, folder and reader
threads at once), so a count is raised under one lock. A wrapper called while
its thread captures a CUDA graph launches nothing until the graph is
replayed: :class:`LaunchTally` keeps that thread's counts apart during the
capture and adds them at every replay, while other threads' launches count
as they happen.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_sources(source: Path) -> List[Path]:
    """``source`` and every header it includes by a quoted ``#include``, found
    beside it, recursively, in the order first met: what a build depends on
    beyond the toolkit's headers."""
    seen, todo = [], [source]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            header = path.parent / name
            if header.exists():
                todo.append(header)
    return seen


class Kernel:
    """One hand-written kernel: its source, its loaded library, its launches."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = CSRC / source
        self.replaces = replaces  # file:line of the TPU kernel it ports
        self.launches = 0
        self.route_launches: Dict[str, int] = {}  # filled by a wrapper with routes
        self.build_log = ""  # nvcc's -Xptxas -v report of the last build
        self._lib: Optional[ctypes.CDLL] = None

    def library_path(self) -> Path:
        digest = hashlib.sha256()
        for path in local_sources(self.source):
            digest.update(path.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{digest.hexdigest()[:16]}.so"

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            build()
        return self._lib

    def count_launch(self, route: Optional[str] = None) -> None:
        """One launch (of ``route``): into the capture tally of this thread
        while it captures a graph, else into the shared counts."""
        tally = getattr(_CAPTURING, "tally", None)
        if tally is not None:
            tally.add(self.name, route)
            return
        with _COUNT_LOCK:
            self.launches += 1
            if route is not None:
                self.route_launches[route] = self.route_launches.get(route, 0) + 1


KERNELS: Dict[str, Kernel] = {
    "logreg_loglik_grad": Kernel(
        "logreg_loglik_grad", "logreg_loglik.cu",
        replaces="src/repro/kernels/logreg_loglik/kernel.py:62",
    ),
    "img_log_weights": Kernel(
        "img_log_weights", "img_weights.cu",
        replaces="src/repro/kernels/img_weights/kernel.py:54",
    ),
    "machine_kde_log_density": Kernel(
        "machine_kde_log_density", "kde_density.cu",
        replaces="src/repro/kernels/kde_density/kernel.py:166",
    ),
    "kde_log_density": Kernel(
        "kde_log_density", "kde_density.cu",
        replaces="src/repro/kernels/kde_density/kernel.py:239",
    ),
    "online_update": Kernel(
        "online_update", "online_update.cu",
        replaces="src/repro/kernels/online_update/kernel.py:69",
    ),
    "flash_attention": Kernel(
        "flash_attention", "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:113",
    ),
    # no Pallas kernel: the port of the reference's pure-JAX backward
    "flash_attention_bwd": Kernel(
        "flash_attention_bwd", "flash_attention_bwd.cu",
        replaces="src/repro/models/lm/flash.py:122",
    ),
}

_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()  # guards every kernel's counts
_CAPTURING = threading.local()  # .tally: the LaunchTally of this thread's capture
_OPERANDS = threading.local()  # .watch: called on every operand check_tensor passes


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

    One ``nvcc`` per distinct library, all running at once. Raises with the
    compiler's output when one fails.
    """
    with _BUILD_LOCK:
        t0 = time.perf_counter()
        pending: Dict[Path, list] = {}
        for k in KERNELS.values():
            if k._lib is None:
                pending.setdefault(k.library_path(), []).append(k)
        if not pending:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for out, ks in pending.items():
            if out.exists():
                for k in ks:
                    k.build_log = f"{out.name}: built earlier from the same source"
                continue
            # the pid too: processes that build at once (the ranks of one
            # launch) can compute the same id()
            tmp = out.with_suffix(f".tmp{os.getpid()}-{id(ks[0])}.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(ks[0].source)]
            procs.append((ks, tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failed = []
        for ks, tmp, out, proc in procs:
            log, _ = proc.communicate()
            for k in ks:
                k.build_log = log
            if proc.returncode != 0:
                failed.append(f"{ks[0].source.name} (nvcc exit {proc.returncode}):\n{log}")
            else:
                tmp.replace(out)  # atomic: a reader never sees half a library
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for out, ks in pending.items():
            lib = ctypes.CDLL(str(out))
            for k in ks:
                k._lib = lib
        return time.perf_counter() - t0


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in KERNELS.values():
            k.launches = 0
            for route in k.route_launches:
                k.route_launches[route] = 0


def launch_counts() -> Dict[str, int]:
    with _COUNT_LOCK:
        return {name: k.launches for name, k in KERNELS.items()}


class LaunchTally:
    """The kernel launches of one captured CUDA graph, for the counts.

    ``with tally.capturing():`` around a capture routes the launches that
    wrappers count on this thread into the tally (launches and launches by
    route) instead of the shared counts: capture records launches without
    running them. Launches on other threads meanwhile count as usual.
    :meth:`replay` adds the tally's counts, once per replay of the graph.
    ``kernels`` (by name) are the counts it adds to, :data:`KERNELS` by default.
    ``capturing(stream=)`` names the raw stream the graph will replay on,
    which :func:`launch_stream` reports to the wrappers during the capture.
    """

    def __init__(self, kernels: Optional[Dict[str, Kernel]] = None):
        self.kernels = KERNELS if kernels is None else kernels
        self.launches: Dict[str, int] = {}
        self.route_launches: Dict[str, Dict[str, int]] = {}
        self.stream: Optional[int] = None

    def add(self, name: str, route: Optional[str]) -> None:
        self.launches[name] = self.launches.get(name, 0) + 1
        routes = self.route_launches.setdefault(name, {})
        if route is not None:
            routes[route] = routes.get(route, 0) + 1

    @contextlib.contextmanager
    def capturing(self, stream: Optional[int] = None):
        if getattr(_CAPTURING, "tally", None) is not None:
            raise RuntimeError("a capture is already being tallied on this thread")
        _CAPTURING.tally = self
        self.stream = stream
        try:
            yield self
        finally:
            _CAPTURING.tally = None

    def replay(self) -> None:
        with _COUNT_LOCK:
            for name, n in self.launches.items():
                k = self.kernels[name]
                k.launches += n
                for route, r in self.route_launches.get(name, {}).items():
                    k.route_launches[route] = k.route_launches.get(route, 0) + r


def check_error(kernel: Kernel, err: int, error_string) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = error_string(err)
        raise RuntimeError(
            f"{kernel.name}: CUDA error {err} "
            f"({msg.decode() if msg else 'unknown'}) at launch"
        )


def launch_stream(device: torch.device) -> int:
    """The raw handle of the stream a launch made now runs on: the current
    stream; while this thread captures a graph, the stream the graph replays
    on, as the capture's :class:`LaunchTally` names it, else the device's
    default stream."""
    tally = getattr(_CAPTURING, "tally", None)
    if tally is not None and tally.stream is not None:
        return tally.stream
    if torch.cuda.is_current_stream_capturing():
        return torch.cuda.default_stream(device).cuda_stream
    return torch._C._cuda_getCurrentRawStream(device_index(device))


@contextlib.contextmanager
def watch_operands(fn: Callable[[torch.Tensor, str], None]):
    """Call ``fn(tensor, name)`` on every operand :func:`check_tensor` passes
    on this thread meanwhile: the tensors a hand-written kernel reads and
    writes through their pointers, which no dispatch mode sees."""
    if getattr(_OPERANDS, "watch", None) is not None:
        raise RuntimeError("operands are already watched on this thread")
    _OPERANDS.watch = fn
    try:
        yield
    finally:
        _OPERANDS.watch = None


def check_tensor(
    t: torch.Tensor, name: str, *, device: torch.device, ndim: int
) -> None:
    """What every CUDA launch requires of an operand; raises otherwise."""
    watch = getattr(_OPERANDS, "watch", None)
    if watch is not None:
        watch(t, name)
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, for a C entry point, as the raw
    handle PyTorch keeps (a tenth of the host time of building a
    ``torch.cuda.Stream`` a call, as ``torch.cuda.current_stream`` does)."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(device_index(device)))


def device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()
