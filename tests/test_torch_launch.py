"""The port's multi-process launch (``python -m repro_torch.api.launch``).

Real processes on the CPU: a single-process run, then two processes that
meet at a ``torch.distributed.TCPStore`` on a free local port, each sampling
half of the chains. Only the ``online`` moments and the acceptance rates
cross processes, so rank 0's record must reproduce the single-process run's
combined samples and means bit for bit (every chain draws what the full-width
run draws for it, and the merge concatenates per-chain moments in rank
order). The properties of ``tests/test_launch_distributed.py``: rank-count
invariance, the spec id, the backend strings, and the refusals (only
moments-backed combiners; a coordinator is required). Every process and the
store carry their own timeout, so a stuck rank fails its test.
"""

import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import repro_torch
from repro_torch.api import RunSpec
from repro_torch.api.launch import LAUNCHABLE_COMBINERS, main, run_launch
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

SPECS = {
    "poisson_gibbs": ["--model", "poisson", "--sampler", "gibbs", "--M", "4", "--T", "60",
                      "--warmup", "0", "--n", "512", "--stream-every", "20"],
    "logreg_mala": ["--model", "logreg", "--sampler", "mala", "--M", "4", "--T", "40",
                    "--warmup", "20", "--n", "400", "--stream-every", "20"],
}
TIMEOUT_S = 240  # each process; the store waits a quarter of it


def _env():
    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    return dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1")


def _cmd(args, extra):
    return [sys.executable, "-m", "repro_torch.api.launch", "--device", "cpu", *args,
            "--timeout", str(TIMEOUT_S // 4), *extra]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(args, tmp_path, tag):
    one = tmp_path / f"{tag}_one.json"
    proc = subprocess.run(_cmd(args, ["--json", str(one)]), capture_output=True, text=True,
                          env=_env(), timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    coord = ["--coordinator", f"localhost:{_free_port()}", "--num-processes", "2"]
    files = [tmp_path / f"{tag}_two{r}.json" for r in range(2)]
    rank1 = subprocess.Popen(_cmd(args, [*coord, "--process-id", "1", "--json", str(files[1])]),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=_env())
    try:
        rank0 = subprocess.run(_cmd(args, [*coord, "--process-id", "0", "--json",
                                           str(files[0])]),
                               capture_output=True, text=True, env=_env(), timeout=TIMEOUT_S)
        _, err1 = rank1.communicate(timeout=TIMEOUT_S)
    finally:
        if rank1.poll() is None:
            rank1.kill()
            rank1.communicate()
    assert rank0.returncode == 0, rank0.stderr[-4000:]
    assert rank1.returncode == 0, err1[-4000:]
    assert json.loads(rank0.stdout)["process_id"] == 0  # rank 0 prints its record
    return [json.loads(p.read_text()) for p in (one, *files)]


@pytest.fixture(scope="module", params=sorted(SPECS))
def records(request, tmp_path_factory):
    return request.param, _launch(SPECS[request.param], tmp_path_factory.mktemp("launch"),
                                  request.param)


def test_two_processes_reproduce_one_bitwise(records):
    _, (single, rank0, rank1) = records
    for double in (rank0, rank1):
        got, want = double["combined"]["online"], single["combined"]["online"]
        assert got["samples"] == want["samples"]
        assert got["mean"] == want["mean"] and got["std"] == want["std"]
        assert double["accept"] == single["accept"]


def test_record_identity_and_backend(records):
    name, (single, rank0, rank1) = records
    assert single["spec_id"] == rank0["spec_id"] == rank1["spec_id"]
    assert single["backend"] == "torch.distributed(1 processes)"
    assert rank0["backend"] == rank1["backend"] == "torch.distributed(2 processes)"
    assert (rank0["process_id"], rank1["process_id"]) == (0, 1)
    assert rank0["device"] == "cpu" and single["num_processes"] == 1
    samples = single["combined"]["online"]["samples"]
    assert len(samples) == single["T"]
    assert single["store_bytes"] == 0  # nothing crosses in one process


def test_only_moments_cross_the_store(records):
    """Each rank's bytes are its (count, mean, m2) and acceptance rates:
    O(M·d²), never its O(M·T·d) draws, and the same for both ranks."""
    _, (single, rank0, rank1) = records
    per = single["M"] // 2
    d = len(single["combined"]["online"]["mean"])

    def npz(*shapes):
        buf = io.BytesIO()
        np.savez(buf, **{f"a{i:03d}": np.zeros(s, np.float32) for i, s in enumerate(shapes)})
        return len(buf.getvalue())

    # no shape here holds T
    want = npz((per,), (per, d), (per, d, d)) + npz((per,))
    assert rank0["store_bytes"] == rank1["store_bytes"] == want


def test_launch_refusals():
    with pytest.raises(ValueError, match="moments-backed"):
        run_launch(RunSpec(model="poisson", combiner="pool", M=4, T=10, n=64), device="cpu")
    with pytest.raises(ValueError, match="divide evenly"):
        run_launch(RunSpec(model="poisson", combiner="online", M=3, T=10, n=64),
                   num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="belongs to repro_torch.api.Pipeline"):
        run_launch(RunSpec(model="poisson", combiner="online", M=4, T=10, n=64,
                           mesh_shape=(2, 1)), device="cpu")
    with pytest.raises(ValueError, match="store"):
        run_launch(RunSpec(model="poisson", combiner="online", M=4, T=10, n=64),
                   num_processes=2, device="cpu")
    with pytest.raises(SystemExit, match="coordinator"):
        main(["--device", "cpu", "--num-processes", "2", "--process-id", "1"])
    assert LAUNCHABLE_COMBINERS == ("online",)


def test_cli_without_a_coordinator_exits_non_zero():
    proc = subprocess.run(_cmd(SPECS["poisson_gibbs"], ["--num-processes", "2"]),
                          capture_output=True, text=True, env=_env(), timeout=TIMEOUT_S)
    assert proc.returncode != 0 and "coordinator" in proc.stderr
