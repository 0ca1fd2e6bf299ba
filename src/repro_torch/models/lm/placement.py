"""The LM under DTensor placements: what the model's code needs beyond DTensor's own propagation.

A model is *placed* when its parameters are ``DTensor``s
(:func:`repro_torch.distributed.sharding.distribute_model`); its inputs are
then placed too. Most of a step goes through DTensor's sharding
propagation as written. This module holds the rest:

- :func:`like`: a tensor the code builds itself (positions, RoPE
  frequencies, masks, iotas, zero scalars) as a replicated ``DTensor`` on
  the mesh of the tensor it meets, so that no operator mixes a plain
  tensor with a DTensor. The port builds them so rather than switching on
  ``implicit_replication()``: that switch is thread-local, and the
  backward of a CUDA graph runs on autograd's device thread, where it is
  off.
- :func:`region`: a ``local_map`` region with stated placements, for the
  parts that run on local shards: the flash kernels (batch over the data
  axes, KV heads over ``model``), the SSD (heads over ``model``) and the
  MoE plan and experts (experts over ``model``). Inputs are redistributed to
  the stated placements first (a collective the dry run sees and counts),
  never gathered quietly.

On an unplaced model every helper is the identity and nothing here runs.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

DATA_AXES = ("pod", "data")


def is_placed(t) -> bool:
    if t is None or not isinstance(t, torch.Tensor) or type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def like(ref: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` as a replicated DTensor on ``ref``'s mesh when ``ref`` is placed
    (every rank computes the same ``t``); ``t`` itself otherwise, or when it
    is placed already."""
    if not is_placed(ref) or is_placed(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def settle(t: torch.Tensor) -> torch.Tensor:
    """Placed ``t`` with every pending reduction (a ``Partial``) done: those
    mesh axes become ``Replicate``, its shards stay."""
    from torch.distributed.tensor import Replicate, Shard

    if all(isinstance(p, (Shard, Replicate)) for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [p if isinstance(p, (Shard, Replicate)) else Replicate()
                                          for p in t.placements])


def rows(t: torch.Tensor) -> torch.Tensor:
    """Placed ``t`` with its batch (dimension 0) over the data axes where it
    has it and everything else replicated: the residual stream's layout,
    which a block's output is brought back to (an all-reduce of the partial
    sums over ``model``, as tensor parallelism does). ``t`` itself when
    unplaced."""
    if not is_placed(t):
        return t
    mesh = t.device_mesh
    keep = {n: 0 for n in mesh.mesh_dim_names if n in DATA_AXES and shards(t, n, 0)}
    target = placements(mesh, keep)
    return t if tuple(t.placements) == tuple(target) else t.redistribute(mesh, target)


def fence(t: torch.Tensor) -> torch.Tensor:
    """Placed ``t`` itself, whose gradient arrives settled: any pending sum
    of it is reduced here, before it flows back into the operator that made
    ``t`` (DTensor cannot turn a summed gradient into the masked partial of
    a vocab-parallel lookup)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t.to_local(grad_placements=t.placements), t.device_mesh,
                              t.placements, run_check=False, shape=t.shape, stride=t.stride())


def split(t: torch.Tensor, dim: int, sizes: Sequence[int]) -> torch.Tensor:
    """``t`` with dimension ``dim`` reshaped to ``sizes`` (a head split). A
    placed ``t`` whose ``dim`` is sharded over n ranks where ``sizes[0]`` does
    not divide by n is gathered on ``dim`` first: the split would cut a head
    in two (llama's 24 heads over 16)."""
    dim = dim % t.dim()
    shape = tuple(t.shape[:dim]) + tuple(sizes) + tuple(t.shape[dim + 1:])
    if is_placed(t):
        from torch.distributed.tensor import Replicate, Shard

        cut = [i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == dim]
        n = 1
        for i in cut:
            n *= t.device_mesh.size(i)
        if sizes[0] % n:
            t = t.redistribute(t.device_mesh, [Replicate() if i in cut else p
                                               for i, p in enumerate(t.placements)])
    return t.reshape(shape)


def merge(t: torch.Tensor, start: int) -> torch.Tensor:
    """``t`` with dimensions ``start`` onwards flattened into one (heads back
    into a model width). Placed, its gradient comes back in the merged
    tensor's own layout (:func:`fence`), so that the split in the backward
    never cuts a head."""
    out = t.flatten(start)
    return fence(out) if is_placed(out) else out


def shards(t: torch.Tensor, name: str, dim: int) -> bool:
    """Whether mesh axis ``name`` shards dimension ``dim`` of placed ``t``."""
    from torch.distributed.tensor import Shard

    names = t.device_mesh.mesh_dim_names
    if name not in names:
        return False
    p = t.placements[names.index(name)]
    return isinstance(p, Shard) and p.dim == dim % t.dim()


def placements(mesh, keep: dict, *, partial: Sequence[str] = ()):
    """A placement list over ``mesh``: ``Shard(keep[axis])`` for the axes in
    ``keep``, ``Partial()`` (a sum) for those in ``partial``, the rest
    ``Replicate()``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        if name in keep:
            out.append(Shard(keep[name]))
        elif name in partial:
            out.append(Partial())
        else:
            out.append(Replicate())
    return out


def region(fn: Callable, mesh, args: Sequence, in_placements: Sequence,
           out_placements, grad_placements: Optional[Sequence] = None):
    """``fn`` on the local shards of ``args``, each redistributed first to
    its ``in_placements`` entry (None for a non-tensor), the gradients
    coming back with ``grad_placements`` (default: the inputs'); the
    outputs are DTensors of ``out_placements``."""
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out_placements, in_placements=tuple(in_placements),
                     in_grad_placements=tuple(grad_placements or in_placements),
                     device_mesh=mesh, redistribute_inputs=True)(*args)
