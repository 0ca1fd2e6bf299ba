"""The port's dry run on the CPU: placed steps on the meta device over a fake group.

``python -m repro_torch.launch.dryrun`` runs in a subprocess (it joins a
``"fake"`` process group of 256 ranks, which must not leak into this
worker) on llama3.2-3b at full width cut to one layer, on the pod mesh
(data 16, model 16): one cell per step kind, ``train_4k`` (``train_step``),
``prefill_32k`` (``serve_prefill``) and ``decode_32k``
(``serve_decode_step``), and ``long_500k``, which the reference skips for
full attention. Held:

- each record's keys (the reference's, with ``op_stats`` in place of
  ``hlo``) and the skip's reason;
- the per-device argument bytes equal to what the placements give: each
  parameter (and AdamW's two float32 moments) over the product of its
  spec's axes, the batch over the data axis;
- flops × 256 against ``model_flops`` (6·N·D, 2·N·D, 2·N·B): the useful
  ratio inside [0.2, 1.05] for train and prefill and [0.01, 1.05] for
  decode. Below 1 the step does more than the formula counts: remat's
  second forward, attention (llama's 24 heads do not divide 16, so every
  model rank computes all of them, as GSPMD's layout does) and, in decode,
  attention over the 32,768-position cache;
- the roofline's terms from the spec-sheet constants;
- on a host mesh (1 × 1, a gloo group of one) the same plan issues no
  collective.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest

from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
KEYS = {"arch", "shape", "mesh", "chips", "layers", "status", "build_s", "run_s", "memory",
        "op_stats", "roofline", "model_flops", "useful_flops_ratio"}


def _env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "llama3.2-3b", "--mesh", "pod", "--layers", "1", "--results",
                           str(out)], env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return {p.stem.split("--")[1]: json.loads(p.read_text())
            for p in (out / "pod").glob("*.json")}


def _expected_argument_bytes(shape_name):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import input_specs, mesh
    from repro_torch.models.lm import model as mdl

    cfg = dataclasses.replace(get_config("llama3_2_3b"), num_layers=1)
    pod = mesh.production_shape()
    model = mdl.init_params(cfg, device="meta")
    specs = shd.param_specs(cfg, pod, model)

    def local(numel, itemsize, spec):
        return numel * itemsize // math.prod(shd._size(pod, ax) for ax in spec)

    params = sum(local(p.numel(), p.element_size(), specs[n])
                 for n, p in model.named_parameters())
    cell = input_specs.shape_by_name(shape_name)
    if cell.kind == "decode":  # one layer's k/v cache and the (B, 1) int64 last tokens
        caches = mdl.init_caches(cfg, cell.global_batch, cell.seq_len, torch.bfloat16,
                                 device="meta")
        cspecs = shd.cache_specs(cfg, pod, caches)
        return params + sum(local(t.numel(), t.element_size(), cspecs[0][k])
                            for k, t in caches[0].items()) + cell.global_batch * 8 // 16
    batch = input_specs.input_specs("llama3_2_3b", shape_name)
    data = sum(local(t.numel(), t.element_size(), s)
               for t, s in zip(batch.values(), shd.batch_specs(cfg, pod, batch).values()))
    if cell.kind == "train":
        params += sum(2 * local(p.numel(), 4, specs[n]) for n, p in model.named_parameters())
    return params + data


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k"])
def test_cell_record(records, shape_name):
    rec = records[shape_name]
    assert rec["status"] == "ok", rec.get("error")
    assert set(rec) == KEYS
    assert rec["chips"] == 256 and rec["layers"] == 1
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["argument_bytes"] == _expected_argument_bytes(shape_name)
    stats = rec["op_stats"]
    assert stats["flops_per_device"] > 0 and stats["bytes_per_device"] > 0
    assert stats["collective_bytes_per_device"] == sum(stats["collective_bytes_by_kind"].values())
    low = 0.01 if shape_name == "decode_32k" else 0.2
    assert low <= rec["useful_flops_ratio"] <= 1.05
    assert math.isclose(rec["useful_flops_ratio"],
                        rec["model_flops"] / (stats["flops_per_device"] * 256), rel_tol=1e-12)
    roof = rec["roofline"]
    assert math.isclose(roof["compute_s"], stats["flops_per_device"] / 989e12, rel_tol=1e-12)
    assert math.isclose(roof["memory_s"], stats["bytes_per_device"] / 3.35e12, rel_tol=1e-12)
    assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"], roof["collective_s"])


def test_long_500k_is_skipped_with_the_reference_reason(records):
    rec = records["long_500k"]
    assert rec["status"] == "skip"
    assert rec["reason"].startswith("long_500k requires sub-quadratic attention")


def test_no_collective_on_a_host_mesh():
    code = (
        "from repro_torch.launch import mesh, op_stats\n"
        "from repro_torch.launch.input_specs import build_cell\n"
        "m = mesh.make_host_mesh('cpu')\n"
        "for shape in ('train_4k', 'prefill_32k', 'decode_32k'):\n"
        "    plan = build_cell('llama3_2_3b', shape, m, layers=1, batch=2)\n"
        "    _, st = op_stats.analyze(plan.fn, *plan.args)\n"
        "    assert st.flops > 0 and st.collective_count == {}, (shape, st.collective_count)\n"
        "print('none')\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "none", proc.stderr[-3000:]


def test_train_cli_takes_the_pod_mesh():
    """``launch.train --mesh pod``: without a process group of 256 ranks it
    raises and names the count; over the fake group it runs one placed
    EP-MCMC step with one chain a data index (16) and one placed AdamW step
    (a smoke of the path: the fake group moves no data, so the numbers are
    not checked)."""
    code = (
        "import logging\n"
        "logging.getLogger('torch.distributed.tensor._redistribute').setLevel(logging.ERROR)\n"
        "from repro_torch.launch import dryrun, train\n"
        "base = ['--device', 'cpu', '--arch', 'llama3_2_3b', '--reduced', '--steps', '1',\n"
        "        '--seq', '32', '--mesh', 'pod', '--log-every', '1']\n"
        "try:\n"
        "    train.main(base + ['--mode', 'epmcmc', '--batch', '1'])\n"
        "    raise SystemExit('no error without a process group')\n"
        "except RuntimeError as e:\n"
        "    assert 'needs a process group of 256 ranks; found no process group' in str(e)\n"
        "dryrun.fake_group(256)\n"
        "out = train.main(base + ['--mode', 'epmcmc', '--batch', '1'])\n"
        "assert tuple(out['losses'][0].shape) == (16,), out['losses'][0].shape\n"
        "out = train.main(base + ['--mode', 'adamw', '--batch', '16'])\n"
        "assert len(out['losses']) == 1\n"
        "print('placed')\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("placed"), (
        proc.stdout[-2000:] + proc.stderr[-3000:])


def test_reroofline_recomputes_the_saved_blocks(records, tmp_path):
    """``launch.reroofline`` rebuilds every ok record's roofline from its
    op_stats: the same block the run wrote."""
    from repro_torch.launch import reroofline

    pod = tmp_path / "pod"
    pod.mkdir()
    for shape, rec in records.items():
        broken = dict(rec, roofline={"dominant": "stale"}) if rec["status"] == "ok" else rec
        (pod / f"llama3_2_3b--{shape}.json").write_text(json.dumps(broken))
    assert reroofline.main(["--results", str(tmp_path)]) == 3
    for shape, rec in records.items():
        again = json.loads((pod / f"llama3_2_3b--{shape}.json").read_text())
        assert again.get("roofline") == rec.get("roofline"), shape


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_meta_branch_gives_shapes_and_tallies_the_work(causal):
    """Flash on the meta device (the dry run): the output (B, S, K, G, hd_v)
    in q's dtype and a float32 lse, nothing computed, and the kernel's work
    added to ``META_WORK``: 2·(hd + hd_v) flop a visible pair forward, 2.5
    times that backward."""
    import torch

    from repro_torch.kernels.flash_attention import ops

    b, s, kh, g, hd, hd_v = 2, 48, 2, 3, 64, 32
    q = torch.empty((b, s, kh, g, hd), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, s, kh, hd), dtype=torch.bfloat16, device="meta")
    v = torch.empty((b, s, kh, hd_v), dtype=torch.bfloat16, device="meta")
    pairs = s * (s + 1) // 2 if causal else s * s
    assert ops.visible_pairs(s, s, causal, s) == pairs
    flops0 = ops.META_WORK["flops"]
    out, lse = ops.flash_attention(q, k, v, causal=causal, return_lse=True)
    assert out.device.type == "meta" and out.shape == (b, s, kh, g, hd_v)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32 and lse.shape == (b, s, kh, g)
    fwd = 2.0 * (hd + hd_v) * b * kh * g * pairs
    assert ops.META_WORK["flops"] - flops0 == fwd
    dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, lse, out, causal=causal)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert ops.META_WORK["flops"] - flops0 == fwd * 3.5


def test_op_stats_holds_a_placed_mlp_to_its_hand_count():
    """One SwiGLU layer placed as the pod mesh's rules place it (x's batch
    over data, w_gate and w_up's d_ff and w_down's rows over model): each
    device's flops are its three local products, 3·2·(B/16)·S·d·(d_ff/16),
    exactly; and the peak cannot exceed the arguments plus every operator's
    bytes, which DTensor's global-shape propagation would break if the tally
    counted it."""
    code = (
        "import torch\n"
        "from repro_torch.distributed import sharding as shd\n"
        "from repro_torch.launch import dryrun, mesh, op_stats\n"
        "from repro_torch.models.lm.layers import MLP\n"
        "dryrun.fake_group(256)\n"
        "m = mesh.make_production_mesh(device_type='cuda')\n"
        "b, s, d, ff = 32, 64, 256, 1024\n"
        "mlp = MLP(d, ff, dtype=torch.bfloat16, device='meta')\n"
        "shd.distribute_model(mlp, m, {'w_gate': (None, 'model'), 'w_up': (None, 'model'),\n"
        "                              'w_down': ('model', None)})\n"
        "x = torch.empty((b, s, d), dtype=torch.bfloat16, device='meta')\n"
        "_, st = op_stats.analyze(mlp, shd.place(x, m, ('data', None, None)))\n"
        "assert st.flops == 3 * 2 * (b // 16) * s * d * (ff // 16), st.flops\n"
        "assert st.argument_bytes == (b // 16) * s * d * 2, st.argument_bytes\n"
        "assert st.peak_bytes <= st.argument_bytes + st.bytes_accessed, st\n"
        "print('counted')\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "counted", (
        proc.stdout[-2000:] + proc.stderr[-3000:])


def test_op_stats_raises_without_the_propagation_hooks(monkeypatch):
    """A torch whose DTensor lacks a sharding-propagation method the tally
    pauses in: the tally raises rather than count global-shape stand-ins."""
    from repro_torch.launch import op_stats

    monkeypatch.setattr(op_stats, "PROPAGATION", op_stats.PROPAGATION + ("_no_such_method",))
    with pytest.raises(RuntimeError, match="_no_such_method"):
        op_stats.analyze(lambda: None)
