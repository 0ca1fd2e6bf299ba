"""The port's placed steps on 8 gloo ranks: a (data 4, model 2) mesh on the CPU.

The counterpart of ``tests/test_multidevice.py::
test_epmcmc_step_on_8_devices_executes_and_isolates``: eight processes
(``tests/torch_spmd_worker.py``, one a rank, ``torch.distributed`` over
``gloo`` on a free local port) run the same reduced configs from the same
seeds. Each computes the unplaced port step on the whole problem and the
placed step on its shards; rank 0 reports, and this file holds:

- the placed ``epmcmc_step`` (4 chains over ``data``, each tensor-parallel
  over ``model``) equal to the unplaced one on a reduced GQA config with S =
  32 > ``attn_chunk`` = 16 (flash's plain version on each rank's KV head)
  and on reduced Mamba-2 (the SSD on each rank's heads): per-chain loss
  within 1e-6 of its size, gradient norm within 1e-4 of its size (sums
  over the model axis in another order), θ, the Welford mean within 1e-5
  and v within 1e-4 of its size (float32; ε_rms = 1 so that the
  preconditioner does not amplify a near-zero gradient's rounding);
- chain isolation: chain 1's batch changed moves chain 1's θ alone;
- the collective check (``epmcmc.assert_no_cross_chain_collectives`` with
  ``mesh=``) passes on every collective of the placed step (all inside a
  chain's model row) and fails on a hand-made all-reduce over ``data``;
- a placed ``train_step`` on an FSDP config (reduced deepseek-coder-33b,
  ``fsdp`` on): loss within 1e-6 of its size, every gradient within 1e-5 of
  the largest, θ after the AdamW step within 1e-4 (a third of the rate: the
  first Adam step is lr·g/(|g| + ε), so a gradient entry near 0 turns its
  rounding into a visible move).
"""

import json
import os
import socket
import subprocess
import sys

import pytest

from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

WORLD = 8
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("spmd"))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_spmd_worker.py"),
                               str(r), str(WORLD), str(port), out], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(p.returncode for p in procs):
        bad = next(i for i, p in enumerate(procs) if p.returncode)
        raise AssertionError(f"rank {bad} failed:\n{logs[bad][-4000:]}")
    with open(os.path.join(out, "result.json")) as f:
        return json.load(f)


ARCHS = ["llama3_2_3b", "mamba2_130m"]


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_epmcmc_step_equals_unplaced(result, arch):
    r = result["epmcmc"][arch]
    assert r["loss"] <= 1e-6 * r["loss_scale"]
    assert r["gnorm"] <= 1e-4 * r["gnorm_scale"]
    assert r["params"] <= 1e-5 and r["m_mean"] <= 1e-5
    assert r["v"] <= 1e-4 * r["gnorm_scale"] ** 2
    assert r["m_var"] == 0.0 and r["m_count"] == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_chain_data_moves_only_its_chain(result, arch):
    assert result["epmcmc"][arch]["moved"] == [1]


@pytest.mark.parametrize("arch", ARCHS)
def test_collective_check_passes_on_the_placed_step(result, arch):
    r = result["epmcmc"][arch]
    assert r["check"] == "passed"
    assert r["collectives"] > 0 and r["checked"] == r["collectives"]


def test_collective_check_fails_on_a_cross_chain_all_reduce(result):
    assert result["cross_chain"].startswith("failed: all-reduce crosses chain groups")


def test_placed_fsdp_train_step_equals_unplaced(result):
    r = result["train"]["deepseek_coder_33b"]
    assert r["fsdp_leaves"] > 0  # the data axis splits some weights
    assert r["loss"] <= 1e-6 * 10.0
    assert r["grad"] <= 1e-5 * r["grad_scale"]
    assert r["params"] <= 1e-4
