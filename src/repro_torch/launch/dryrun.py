"""Multi-pod dry run: every (arch × shape × mesh) cell's step, placed, on the meta device.

The counterpart of ``repro/launch/dryrun.py``. The reference lowers and
compiles each cell's step on 512 forced host devices. Here one process
joins a ``"fake"`` process group of 256 (pod) or 512 (multipod) ranks
(``torch.testing``'s ``FakeStore``: collectives return at once and move
nothing), builds the production ``DeviceMesh`` over it, places the cell's
arguments on meta tensors (``launch/input_specs.build_cell``) and runs the
step as rank 0 under :mod:`repro_torch.launch.op_stats`. That proves the
placements compose (every operator of the step has a sharding rule, or a
stated ``local_map`` region) without a device, and tallies per device:

- ``memory``: argument, output and peak live bytes (op_stats' model of
  allocations and frees; ``temp_bytes`` is peak − arguments);
- ``op_stats``: flops, bytes (every operator's operands and outputs: it
  overcounts a fused step), collective bytes and counts by kind;
- ``roofline``: the three terms against an NVIDIA H100 80GB HBM3 at 700 W,
  **spec-sheet values, not measurements**: 989 TFLOP/s bf16 dense, 3.35
  TB/s HBM3, and for a collective 450 GB/s a direction (NVLink 4) when its
  ranks lie within one node of 8 consecutive ranks, else 50 GB/s (one
  400 Gb/s NDR NIC a GPU);
- ``model_flops`` (6·N·D train, 2·N·D prefill, 2·N·B decode, the reference's
  formula) and ``useful_flops_ratio`` = model_flops / (flops × chips).

Cells skipped by ``configs.all_cells()`` (``long_500k`` on full attention)
are recorded with the reference's reason. Records go to
``results/dryrun_torch/<mesh>/<arch>--<shape>.json``; a sweep resumes where
it stopped (``--force`` reruns). ``--layers N`` cuts every cell's depth.

Usage:
  python -m repro_torch.launch.dryrun                      # everything, resumable
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --list               # cells and skips
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import pathlib
import sys
import time
import traceback
from typing import Optional, Sequence

import torch

from repro_torch.configs import ALIASES, ARCH_IDS, SHAPES, all_cells, get_config
from repro_torch.launch import op_stats
from repro_torch.launch.input_specs import build_cell
from repro_torch.launch.mesh import make_production_mesh, production_shape

# NVIDIA H100 80GB HBM3 (SXM, 700 W) data-sheet figures, not measurements
PEAK_FLOPS = 989e12  # bf16 dense, per GPU
HBM_BW = 3.35e12  # bytes/s per GPU
NVLINK_BW = 450e9  # bytes/s a direction, NVLink 4, within a node
NODE_RANKS = 8  # GPUs a node: ranks r and s share one when r // 8 == s // 8
NIC_BW = 50e9  # bytes/s, one 400 Gb/s NDR NIC a GPU, across nodes

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) per step; decode D=B·1."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens  # forward only
    return 2.0 * n * shape.global_batch  # one token / sequence, forward only


def link_rate(ranks: Sequence[int]) -> float:
    """The spec-sheet rate of a collective over ``ranks``."""
    return NVLINK_BW if len({r // NODE_RANKS for r in ranks}) <= 1 else NIC_BW


def roofline(stats: dict) -> dict:
    """The three terms of a record's ``op_stats`` block (:func:`stats_record`)."""
    link = stats["collective_bytes_by_link"]
    terms = {
        "compute_s": stats["flops_per_device"] / PEAK_FLOPS,
        "memory_s": stats["bytes_per_device"] / HBM_BW,
        "collective_s": link["nvlink"] / NVLINK_BW + link["nic"] / NIC_BW,
    }
    dominant = max(terms, key=terms.get)
    return {**{k: float(v) for k, v in terms.items()}, "dominant": dominant,
            "bound_s": float(max(terms.values()))}


def stats_record(stats: op_stats.OpStats) -> dict:
    return {
        "flops_per_device": stats.flops,
        "bytes_per_device": stats.bytes_accessed,
        "collective_bytes_per_device": stats.collective_bytes,
        "collective_bytes_by_kind": stats.collective_bytes_by_kind,
        "collective_count": stats.collective_count,
        "collective_bytes_by_link": {
            "nvlink": sum(b for _, r, b in stats.groups if link_rate(r) == NVLINK_BW),
            "nic": sum(b for _, r, b in stats.groups if link_rate(r) != NVLINK_BW)},
        "ops": stats.ops,
    }


def fake_group(world: int) -> None:
    """This process as rank 0 of a ``"fake"`` group of ``world`` ranks (the one
    before it, if any, destroyed)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, force: bool = False,
             layers: int = 0, results: Optional[pathlib.Path] = None) -> dict:
    out_dir = (results or RESULTS_DIR) / mesh_kind
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch}--{shape_name}.json"
    if out_path.exists() and not force:
        rec = json.loads(out_path.read_text())
        if rec.get("status") in ("ok", "skip"):
            print(f"[cached] {mesh_kind} {arch} {shape_name}: {rec['status']}")
            return rec

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    for cell in all_cells():
        if cell.arch == arch and cell.shape.name == shape_name and cell.skip:
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": "skip",
                   "reason": cell.skip}
            out_path.write_text(json.dumps(rec, indent=2))
            print(f"[skip]   {mesh_kind} {arch} {shape_name}: {cell.skip}")
            return rec

    multi = mesh_kind == "multipod"
    chips = 1
    for n in production_shape(multi_pod=multi).values():
        chips *= n
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "chips": chips}
    if layers:
        rec["layers"] = layers
    try:
        fake_group(chips)
        mesh = make_production_mesh(multi_pod=multi, device_type="cuda")
        plan = build_cell(arch, shape_name, mesh, layers=layers)
        t_build = time.time()
        _, stats = op_stats.analyze(plan.fn, *plan.args)
        del plan
        t_run = time.time()
        mf = model_flops(cfg, next(s for s in SHAPES if s.name == shape_name))
        rec.update(
            status="ok",
            build_s=round(t_build - t0, 1),
            run_s=round(t_run - t_build, 1),
            memory={"argument_bytes": stats.argument_bytes, "output_bytes": stats.output_bytes,
                    "temp_bytes": stats.peak_bytes - stats.argument_bytes,
                    "peak_bytes": stats.peak_bytes},
            op_stats=stats_record(stats),
            roofline=roofline(stats_record(stats)),
            model_flops=mf,
            useful_flops_ratio=(mf / (stats.flops * chips)) if stats.flops else None,
        )
        r = rec["roofline"]
        print(f"[ok]     {mesh_kind} {arch} {shape_name}: compute={r['compute_s']*1e3:.2f}ms "
              f"memory={r['memory_s']*1e3:.2f}ms collective={r['collective_s']*1e3:.2f}ms "
              f"dominant={r['dominant']} peak={stats.peak_bytes / 2**30:.2f} GiB "
              f"(build {rec['build_s']}s run {rec['run_s']}s)", flush=True)
    except Exception as e:  # a failure here is a fault of the placements
        rec.update(status="error", error=f"{type(e).__name__}: {e}"[:2000],
                   traceback=traceback.format_exc()[-4000:])
        print(f"[ERROR]  {mesh_kind} {arch} {shape_name}: {type(e).__name__}: {e}"[:600],
              file=sys.stderr, flush=True)
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape name (default: all)")
    ap.add_argument("--mesh", default="both", choices=["pod", "multipod", "both"])
    ap.add_argument("--layers", type=int, default=0, help="cut every cell's depth (0 = full)")
    ap.add_argument("--results", default=None, help=f"records' root (default {RESULTS_DIR})")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for cell in all_cells():
            status = f"SKIP: {cell.skip}" if cell.skip else "run"
            print(f"{cell.arch:24s} {cell.shape.name:12s} {status}")
        return

    # DTensor warns at every sequential reduction over two mesh axes
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    torch.set_grad_enabled(True)
    archs = [ALIASES.get(args.arch, args.arch)] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else [s.name for s in SHAPES]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    results = pathlib.Path(args.results) if args.results else None

    n_err = 0
    t0 = time.time()
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mesh_kind, force=args.force, layers=args.layers,
                               results=results)
                n_err += rec.get("status") == "error"
    print(f"sweep took {time.time() - t0:.1f} s of CPU wall", flush=True)
    if n_err:
        sys.exit(f"{n_err} cells FAILED")
    print("all requested cells passed")


if __name__ == "__main__":
    main()
