"""torch's intra-op threads under a parallel pytest run, and the rule's tests.

Every ``tests/test_torch_*.py`` calls :func:`pin_torch_threads` before it
runs torch. Under pytest-xdist each worker then takes its share of the
cores, ``max(1, cores // workers)``, instead of torch's default of every
core: six workers at eight threads each on eight cores oversubscribe them,
and the port's full-width CPU runs then slow down many times over. Without
xdist torch keeps its default. Under ``--dist loadfile`` each worker imports
every test module at collection, so the setting holds for the whole worker.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def torch_threads(cores: int, workers: Optional[int]) -> Optional[int]:
    """The intra-op thread count a pytest worker takes: ``max(1, cores //
    workers)`` under xdist, ``None`` (torch's default) without it."""
    if not workers:
        return None
    return max(1, cores // workers)


def pin_torch_threads() -> None:
    """Apply :func:`torch_threads` to this process, from the affinity mask and
    ``PYTEST_XDIST_WORKER_COUNT``."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    n = torch_threads(len(os.sched_getaffinity(0)), int(workers) if workers else None)
    if n is not None:
        torch.set_num_threads(n)


pin_torch_threads()


def test_worker_takes_its_share_of_the_cores():
    assert torch_threads(8, 6) == 1
    assert torch_threads(8, 4) == 2
    assert torch_threads(64, 6) == 10
    assert torch_threads(4, 6) == 1  # never fewer than one


def test_without_xdist_torch_keeps_its_default():
    assert torch_threads(8, None) is None
    assert torch_threads(8, 0) is None


def test_this_process_runs_at_the_pinned_count():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        assert torch.get_num_threads() == torch_threads(len(os.sched_getaffinity(0)), int(workers))
