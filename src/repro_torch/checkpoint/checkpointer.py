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

Async: ``Checkpointer(async_io=True)`` moves serialization and IO to a
worker thread; the caller blocks on the previous write only when it starts a
new one (double buffering). The host copy of every leaf is taken before the
write is submitted, by a blocking copy: the sampler goes on mutating its
tensors while the write runs.

Elastic EP-MCMC restore (:func:`restore_elastic_chains`): chain-stacked
state ``(C_old, ...)`` re-partitioned to ``C_new`` chains. Shrink keeps the
first ``C_new`` chains; grow tiles existing chains. As in the reference, a
tiled leaf whose name contains ``key`` (a per-chain RNG key) is bumped by a
multiple of ``rng_bump`` per tile, so a checkpoint written by ``repro``
restores to the same arrays. A carry of the port's chunk driver keeps one
generator state (``rng``) for all chains, not one a chain, so the rule never
fires on it.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

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
    write: Optional[Callable[[pathlib.Path, Any], Tuple[tuple, str]]] = None,
) -> pathlib.Path:
    """Write one checkpoint synchronously; returns the committed directory.
    ``keep`` newest steps survive (0 keeps all). ``write(file, leaf) ->
    (shape, dtype)``, if given, writes each leaf's ``.npy`` itself."""
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
        fname = f"leaf_{i:05d}.npy"
        if write is None:
            arr = _to_numpy(leaf)
            np.save(host_dir / fname, arr)
            shape, dtype = arr.shape, str(arr.dtype)
        else:
            shape, dtype = write(host_dir / fname, leaf)
        leaves.append({
            "index": i, "path": path, "shape": list(shape), "dtype": dtype,
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
    root: str | os.PathLike, *, step: Optional[int] = None, mmap: bool = False
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Load a checkpoint (the newest if ``step`` is None):
    ``({path: numpy array}, metadata)``; ``mmap`` maps the files read-only
    instead, so a reader takes only the parts it indexes."""
    root = pathlib.Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints under {root}")
    d = _step_dir(root, step)
    manifest = json.loads((d / "MANIFEST.json").read_text())
    mode = "r" if mmap else None
    leaves = {leaf["path"]: np.load(d / leaf["file"], mmap_mode=mode)
              for leaf in manifest["leaves"]}
    return leaves, manifest["metadata"]


def _tree_map(fn, tree: Tree, path: Tuple[str, ...] = ()) -> Tree:
    """``fn(path, leaf)`` over the leaves of a tree, keeping its structure;
    ``path`` is the leaf's ``/``-joined path, as :func:`_flatten` gives it."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v, path + (f,)) for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _host_copy(leaf) -> np.ndarray:
    """A numpy copy of a leaf that later writes to the leaf leave alone: a
    blocking device-to-host copy for a card tensor, a copy otherwise."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()
    return np.array(leaf, copy=True)


def restore_elastic_chains(
    root: str | os.PathLike,
    template: Tree,
    new_num_chains: int,
    *,
    step: Optional[int] = None,
    chain_axis: int = 0,
    rng_bump: int = 104729,
) -> Tuple[Tree, Dict[str, Any]]:
    """Restore chain-stacked EP-MCMC state onto a different chain count.

    Every leaf whose dim ``chain_axis`` equals the checkpointed chain count
    (metadata ``num_chains``) is re-partitioned: shrink → slice, grow →
    wrap-around tile. Other leaves pass through. Leaves take the template
    leaf's dtype (and device, for a tensor). The caller owns re-partitioning
    the data and using the new 1/M in the step function.
    """
    by_path, meta = restore(root, step=step)
    old_c = meta.get("num_chains")
    if old_c is None:
        raise ValueError("checkpoint metadata lacks 'num_chains'")
    def one(key, t_leaf):
        if key not in by_path:
            raise KeyError(f"leaf {key!r} missing from checkpoint")
        arr = by_path[key]
        if arr.ndim > chain_axis and arr.shape[chain_axis] == old_c != new_num_chains:
            if new_num_chains < old_c:
                arr = np.take(arr, np.arange(new_num_chains), axis=chain_axis)
            else:
                arr = np.take(arr, np.arange(new_num_chains) % old_c, axis=chain_axis)
                if "key" in key.split("/")[-1]:  # de-duplicate RNG streams
                    bump = (np.arange(new_num_chains) // old_c).astype(arr.dtype)
                    arr = arr + (bump * rng_bump)[(...,) + (None,) * (arr.ndim - 1)].swapaxes(
                        0, chain_axis)
        if isinstance(t_leaf, torch.Tensor):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(device=t_leaf.device,
                                                                  dtype=t_leaf.dtype)
        return np.asarray(arr, dtype=getattr(t_leaf, "dtype", None))

    out = _tree_map(one, template)
    return out, dict(meta, num_chains=new_num_chains, elastic_from=old_c)


class Checkpointer:
    """Double-buffered async wrapper around :func:`save`."""

    def __init__(self, root: str | os.PathLike, *, keep: int = 3, async_io: bool = True):
        self.root = pathlib.Path(root)
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1) if async_io else None
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()

    def save(self, step: int, tree: Tree, *, metadata: Optional[Dict[str, Any]] = None) -> None:
        # the host copy NOW: the caller's tensors change after this returns
        host_tree = _tree_map(lambda _, leaf: _host_copy(leaf), tree)
        if self._pool is None:
            save(self.root, step, host_tree, metadata=metadata, keep=self.keep)
            return
        with self._lock:
            if self._pending is not None:
                self._pending.result()  # block on the previous write only
            self._pending = self._pool.submit(
                save, self.root, step, host_tree, metadata=metadata, keep=self.keep
            )

    def wait(self) -> None:
        with self._lock:
            if self._pending is not None:
                self._pending.result()
                self._pending = None

    def close(self) -> None:
        self.wait()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
