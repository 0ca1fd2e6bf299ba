"""Production meshes: ``torch.distributed`` device meshes and their device-free shapes.

The counterpart of ``repro/launch/mesh.py``. Everything is a function, so
importing this module builds nothing and touches no process group.

- :func:`production_shape` / :func:`host_shape`: the ordered ``{axis:
  size}`` the sharding rules read (``repro``'s ``_div`` reads only
  ``mesh.shape``), with no process group: (data 16, model 16), (pod 2, data
  16, model 16), (data 1, model 1).
- :func:`make_production_mesh`: the 256- or 512-rank
  :class:`~torch.distributed.device_mesh.DeviceMesh` over the process group
  that is already initialized (real ranks, or the ``"fake"`` group of the
  dry run); it raises with the world size it found otherwise.
- :func:`make_host_mesh`: the 1 × 1 mesh of one process, which starts a
  world-1 group (``gloo`` on the CPU, ``nccl`` on a card) when none is up.
- :func:`mesh_shape`, :func:`data_axes`, :func:`model_axis`: read either
  form.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import torch

MeshLike = Union["torch.distributed.device_mesh.DeviceMesh", Dict[str, int]]


def production_shape(*, multi_pod: bool = False) -> Dict[str, int]:
    """Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2,
    data=16, model=16) = 512 ranks."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def host_shape() -> Dict[str, int]:
    return {"data": 1, "model": 1}


def mesh_shape(mesh: MeshLike) -> Dict[str, int]:
    """``{axis: size}`` in the mesh's order, from a ``DeviceMesh`` or a shape."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_axes(mesh: MeshLike) -> Tuple[str, ...]:
    """The batch/chain axes: ('pod', 'data') on multi-pod, ('data',) otherwise."""
    return tuple(a for a in mesh_shape(mesh) if a in ("pod", "data"))


def model_axis(mesh: MeshLike) -> str:
    return "model"


def _mesh(device_type: str, shape: Dict[str, int]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    need = math.prod(shape.values())
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != need:
        found = "no process group" if world is None else f"world size {world}"
        raise RuntimeError(
            f"a {' x '.join(f'{a} {n}' for a, n in shape.items())} mesh needs a process group "
            f"of {need} ranks; found {found}. Start one (torch.distributed.init_process_group, "
            "or the 'fake' group for a device-free run) first"
        )
    return init_device_mesh(device_type, tuple(shape.values()), mesh_dim_names=tuple(shape))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production ``DeviceMesh`` over the initialized process group."""
    return _mesh(device_type, production_shape(multi_pod=multi_pod))


def make_host_mesh(device: str | torch.device = "cuda"):
    """A 1 × 1 (data, model) mesh of this process alone: lets every
    mesh-aware path (placements, the chain check) run unchanged on one
    device. Starts a world-1 group over a ``HashStore`` when none is up."""
    import torch.distributed as dist

    device_type = torch.device(device).type
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return _mesh(device_type, host_shape())
