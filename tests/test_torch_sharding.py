"""The port's sharding rules on the CPU against ``repro``'s, every config × mesh.

``repro_torch.distributed.sharding`` against ``repro/distributed/sharding.py``
and ``repro_torch.distributed.epmcmc``'s ``state_specs``/``batch_spec``
against ``repro/distributed/epmcmc.py``, for the ten configs at full size
on the host (1, 1), pod (16, 16) and multipod (2, 16, 16) meshes. Neither
side needs a device: the reference's rules run on a
``jax.sharding.AbstractMesh`` over ``jax.eval_shape`` leaves, the port's on
an ``{axis: size}`` shape over meta tensors. A reference leaf maps to a port
name through ``interop.reference_lm_leaves`` (caches:
``interop.reference_cache_leaves``); a stacked leaf's spec loses its
leading entries (the layer axis) before the comparison. Specs are compared
exactly, entry by entry, a one-axis tuple read as that axis. One
parametrised test per face: parameters, AdamW state, the batch of
``make_batch_specs``, the caches at ``decode_32k`` and ``long_500k``, and
the EP-MCMC state and batch. ``to_placements`` is held to the spec on a
1 × 1 gloo mesh.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_get_config
from repro.data.tokens import make_batch_specs as ref_make_batch_specs
from repro.distributed import epmcmc as ref_ep
from repro.distributed import sharding as ref_shd
from repro.launch import input_specs as ref_inputs
from repro.models.lm import model as ref_mdl
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.data import make_batch_specs
from repro_torch.distributed import epmcmc
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.lm import model as mdl
from repro_torch.optim import adamw_init
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

MESHES = {
    "host": mesh_lib.host_shape(),
    "pod": mesh_lib.production_shape(),
    "multipod": mesh_lib.production_shape(multi_pod=True),
}


def abstract(shape):
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def norm(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


def ref_entries(spec, rank):
    out = [norm(e) for e in tuple(spec)]
    return out + [None] * (rank - len(out))


def stripped(spec, ref_rank, rank):
    """The reference's spec of a stacked leaf without its leading entries."""
    return tuple(ref_entries(spec, ref_rank)[ref_rank - rank:])


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    return ref_inputs.param_specs_only(ref_get_config(arch))


@functools.lru_cache(maxsize=None)
def port_params(arch):
    return {n: tuple(p.shape) for n, p in
            mdl.init_params(get_config(arch), device="meta").named_parameters()}


def get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def check_tree(cfg, ref_specs, ref_leaves, port_specs, port_shapes):
    bad = []
    for name, path, _ in interop.reference_lm_leaves(cfg):
        want = stripped(get(ref_specs, path), len(get(ref_leaves, path).shape),
                        len(port_shapes[name]))
        if tuple(port_specs[name]) != want:
            bad.append(f"{name}: port {port_specs[name]}, reference {want}")
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh_name):
    shape = MESHES[mesh_name]
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    leaves = ref_params(arch)
    ref_specs = ref_shd.param_specs(ref_cfg, abstract(shape), leaves)
    port = port_params(arch)
    specs = shd.param_specs(cfg, shape, {n: torch.empty(s, device="meta")
                                         for n, s in port.items()})
    check_tree(cfg, ref_specs, leaves, specs, port)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_specs_match_reference(arch, mesh_name):
    shape = MESHES[mesh_name]
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    params, opt = ref_inputs.train_state_specs(ref_cfg)
    amesh = abstract(shape)
    ref_o = ref_shd.opt_specs(ref_cfg, amesh, opt, ref_shd.param_specs(ref_cfg, amesh, params))
    port = port_params(arch)
    meta = {n: torch.empty(s, device="meta") for n, s in port.items()}
    state = adamw_init(meta)
    o = shd.opt_specs(cfg, shape, state, shd.param_specs(cfg, shape, meta))
    check_tree(cfg, ref_o.mu, opt.mu, o.mu, port)
    check_tree(cfg, ref_o.nu, opt.nu, o.nu, port)
    assert o.count == () and tuple(ref_o.count) == ()


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_match_reference(arch, mesh_name):
    shape = MESHES[mesh_name]
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for batch in (256, 1):  # train_4k's batch, and one that cannot shard
        ref_b = ref_make_batch_specs(ref_cfg, batch, 4096)
        want = ref_shd.batch_specs(ref_cfg, abstract(shape), ref_b)
        got = shd.batch_specs(cfg, shape, make_batch_specs(cfg, batch, 4096))
        assert set(got) == set(want)
        for k in got:
            assert got[k] == tuple(ref_entries(want[k], len(ref_b[k].shape))), (k, batch)


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch, mesh_name, shape_name):
    shape = MESHES[mesh_name]
    cell = next(s for s in SHAPES if s.name == shape_name)
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    dtype = jnp.dtype(ref_cfg.dtype)
    ref_c = jax.eval_shape(lambda: ref_mdl.init_caches(ref_cfg, cell.global_batch,
                                                       cell.seq_len, dtype))
    want = ref_shd.cache_specs(ref_cfg, abstract(shape), ref_c)
    caches = mdl.init_caches(cfg, cell.global_batch, cell.seq_len, torch.bfloat16,
                             device="meta")
    got = shd.cache_specs(cfg, shape, caches)
    leaves = interop.reference_cache_leaves(cfg)
    assert len({layer for layer, *_ in leaves}) == len(caches)
    for layer, key, path, _ in leaves:
        entry = got[layer]
        spec = entry[key] if isinstance(entry, dict) else getattr(entry, key)
        cache = caches[layer]
        leaf = cache[key] if isinstance(cache, dict) else getattr(cache, key)
        ref_leaf = get(ref_c, path)
        assert tuple(ref_leaf.shape[len(ref_leaf.shape) - leaf.dim():]) == tuple(leaf.shape)
        assert spec == stripped(get(want, path), len(ref_leaf.shape), leaf.dim()), (layer, key)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_epmcmc_state_and_batch_specs_match_reference(arch, mesh_name):
    shape = MESHES[mesh_name]
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    amesh = abstract(shape)
    n = epmcmc.num_chains(shape)
    assert n == ref_ep.num_chains(amesh)
    ref_state = jax.eval_shape(lambda k: ref_ep.init_state(k, ref_cfg, n),
                               jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = ref_ep.state_specs(ref_cfg, amesh, ref_state)
    port = port_params(arch)
    stacked = {name: torch.empty((n, *s), device="meta") for name, s in port.items()}
    state = epmcmc.EpmcmcState(params=stacked, v=stacked, step=0, gens=[],
                               m_count=torch.empty((n,), device="meta"), m_mean=stacked,
                               m_var=stacked)
    got = epmcmc.state_specs(cfg, shape, state)
    ca = norm(epmcmc.chain_axes(shape))
    for field in ("params", "v", "m_mean", "m_var"):
        ref_tree, ref_leaves = getattr(want, field), getattr(ref_state, field)
        for name, path, idx in interop.reference_lm_leaves(cfg):
            spec = get(ref_tree, path)
            entries = ref_entries(spec, len(get(ref_leaves, path).shape))
            # the reference's stacked per-chain leaf: (C, [L,] ...): chain axis, layer axis
            want_spec = (entries[0],) + tuple(entries[1:][len(entries) - 1 - len(port[name]):])
            assert getattr(got, field)[name] == want_spec, (field, name)
            assert want_spec[0] == ca
    assert got.m_count == tuple(ref_entries(want.m_count, 1)) == (ca,)
    assert tuple(want.step) == got.step == ()
    batch = {"tokens": torch.empty((n, 2, 64), dtype=torch.int64, device="meta")}
    ref_batch = {"tokens": jax.ShapeDtypeStruct((n, 2, 64), jnp.int32)}
    assert epmcmc.batch_spec(shape, batch)["tokens"] == tuple(
        ref_entries(ref_ep.batch_spec(amesh, ref_batch)["tokens"], 3))


def test_to_placements_and_distribute_on_a_host_mesh():
    """A 1 × 1 gloo mesh: every spec places whole tensors; ``distribute_model``
    keeps every value; the placements name the spec's axes."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    mesh = mesh_lib.make_host_mesh("cpu")
    try:
        assert mesh_lib.mesh_shape(mesh) == {"data": 1, "model": 1}
        # axes of size 1 split nothing: every placement on the host mesh replicates
        assert shd.to_placements(mesh, ("model", "data")) == [Replicate(), Replicate()]
        assert shd.to_placements(mesh, (None, "model")) == [Replicate(), Replicate()]
        cfg = dataclasses.replace(get_config("llama3_2_3b"), num_layers=1, d_model=64,
                                  num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                                  vocab_size=256)
        gen = torch.Generator().manual_seed(0)
        model = mdl.init_params(cfg, generator=gen, device="cpu")
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        shd.distribute_model(model, mesh, shd.param_specs(cfg, mesh, model))
        for name, p in model.named_parameters():
            assert isinstance(p, DTensor) and p.requires_grad
            assert torch.equal(p.full_tensor(), before[name])
    finally:
        dist.destroy_process_group()


def test_production_mesh_needs_its_ranks():
    """Without a process group of 256 ranks the production mesh raises and
    names the world size it found."""
    with pytest.raises(RuntimeError, match="256 ranks; found no process group"):
        mesh_lib.make_production_mesh(device_type="cpu")
