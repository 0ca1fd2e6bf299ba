"""Atomic step checkpoints of tensor trees, written with numpy.

The port of ``save``, ``latest_step`` and ``restore`` of
``repro/checkpoint/checkpointer.py``, in the same layout::

    <root>/step_000000100/
        MANIFEST.json        # per-leaf path/shape/dtype/file, metadata
        host_00000/
            leaf_00000.npy   # one .npy per leaf
    <root>/step_000000100.tmp/   # staging directory; atomic os.replace on commit

The manifest is written last, so its presence is the commit record (readers
ignore step directories without one), and ``os.replace`` of the staging
directory makes the commit atomic on POSIX. A tree is a nested ``dict``
(keys in sorted order), ``tuple``/``list``/``NamedTuple`` of leaves; a leaf
is a tensor (any device), a numpy array or a Python scalar. ``restore``
gives the leaves back as numpy arrays keyed by their ``/``-joined path.
``Checkpointer(async_io=)`` and ``restore_elastic_chains`` are not ported.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Tree = Any

_STEP_RE = re.compile(r"^step_(\d{9})$")
_HOST_DIR = "host_00000"  # the reference's per-host directory; the port runs on one


def _step_dir(root: pathlib.Path, step: int) -> pathlib.Path:
    return root / f"step_{step:09d}"


def _flatten(tree: Tree, path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in tree order; paths join keys, field names and
    indices with ``/``."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f, v in zip(tree._fields, tree) for kv in _flatten(v, path + (f,))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, path + (str(i),))]
    return [("/".join(path), tree)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(
    root: str | os.PathLike,
    step: int,
    tree: Tree,
    *,
    metadata: Optional[Dict[str, Any]] = None,
    keep: int = 3,
) -> pathlib.Path:
    """Write one checkpoint synchronously; returns the committed directory.
    ``keep`` newest steps survive (0 keeps all)."""
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = _step_dir(root, step)
    tmp = final.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)  # litter of a writer that crashed
    host_dir = tmp / _HOST_DIR
    host_dir.mkdir(parents=True)
    leaves = []
    for i, (path, leaf) in enumerate(_flatten(tree)):
        arr = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(host_dir / fname, arr)
        leaves.append({
            "index": i, "path": path, "shape": list(arr.shape), "dtype": str(arr.dtype),
            "file": f"{_HOST_DIR}/{fname}",
        })
    manifest = {"step": step, "format": 1, "num_hosts": 1, "leaves": leaves,
                "metadata": metadata or {}}
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=1))  # last: the commit
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    _apply_retention(root, keep)
    return final


def _apply_retention(root: pathlib.Path, keep: int) -> None:
    steps = sorted(int(m.group(1)) for p in root.iterdir() if (m := _STEP_RE.match(p.name)))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(root, s), ignore_errors=True)


def latest_step(root: str | os.PathLike) -> Optional[int]:
    """The newest committed step under ``root``, or None."""
    root = pathlib.Path(root)
    if not root.exists():
        return None
    steps = [
        int(m.group(1))
        for p in root.iterdir()
        if (m := _STEP_RE.match(p.name)) and (p / "MANIFEST.json").exists()
    ]
    return max(steps) if steps else None


def restore(
    root: str | os.PathLike, *, step: Optional[int] = None
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Load a checkpoint (the newest if ``step`` is None):
    ``({path: numpy array}, metadata)``."""
    root = pathlib.Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints under {root}")
    d = _step_dir(root, step)
    manifest = json.loads((d / "MANIFEST.json").read_text())
    leaves = {leaf["path"]: np.load(d / leaf["file"]) for leaf in manifest["leaves"]}
    return leaves, manifest["metadata"]
