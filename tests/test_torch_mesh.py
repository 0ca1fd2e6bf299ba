"""repro_torch's chains split over devices: MeshChunkBackend, the one-shot and
chunked mesh paths, run_matrix(backend="mesh_fanout") and the chain-group
check, on the CPU with explicit device lists (``("cpu",) * n``, the
counterpart of repro's forced host device count).

repro's own mesh tests (``tests/test_mesh_stream.py``) fail on this tree, so
the port's mesh is held to the port's batched backend, which is what repro's
mesh is contracted to equal: the mesh's θ is the batched θ bit for bit, for
logreg/MALA, poisson/Gibbs, linear/HMC and linear/SGLD, at 2 and 4 groups,
one-shot and chunked. The scorecard of repro's test is reproduced on its
Poisson/Gibbs spec: equal stream-combine finals, trajectory and scoreboard
errors, a bitwise checkpoint resume, and fan-out rows equal to the batched
sweep's. The check is shown to raise on a planted cross-group read and a
planted all_reduce.
"""

import dataclasses
import math

import pytest
import torch

from repro_torch.api import Pipeline, RunSpec, run_matrix
from repro_torch.api.backends import (
    BackendId,
    BatchedChunkBackend,
    Grouped,
    MeshChunkBackend,
    get_chunk_backend,
    resolve_mesh_devices,
)
from repro_torch.api.pipeline import combine_draws, combine_spec_draws, stream_generator
from repro_torch.api.sampling import make_shard_kernel, sample_subposteriors
from repro_torch.core.subposterior import partition_data
from repro_torch.distributed.epmcmc import (
    ChainGroup,
    CrossChainError,
    assert_no_cross_chain_collectives,
)
from repro_torch.models.bayes import get_model
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

PAIRS = {
    "logreg/mala": dict(model="logreg", sampler="mala", n=800, warmup=20),
    "poisson/gibbs": dict(model="poisson", sampler="gibbs", n=400, warmup=0),
    "linear/hmc": dict(model="linear", sampler="hmc", n=400, warmup=20),
    "linear/sgld": dict(model="linear", sampler="sgld", n=403, warmup=20, sgld_batch=32,
                        step_size=0.001),
}


def _spec(pair, **over):
    return RunSpec(**{**dict(M=4, T=40, seed=1, groundtruth_T=60, combiner="parametric",
                             score_metric="logl2"), **PAIRS[pair], **over})


def _cpus(n):
    return ("cpu",) * n


@pytest.mark.parametrize("chunked", [False, True], ids=["one_shot", "chunked"])
@pytest.mark.parametrize("ndata", [2, 4])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_mesh_theta_is_the_batched_theta_bitwise(pair, ndata, chunked):
    extra = dict(stream_every=10) if chunked else {}
    subs = (lambda ev: None,) if chunked else ()
    base = _spec(pair, **extra)
    batched = Pipeline(base, device="cpu").sample(on_chunk=subs)
    mesh = Pipeline(dataclasses.replace(base, mesh_shape=(ndata, 1)), device="cpu",
                    devices=_cpus(ndata)).sample(on_chunk=subs)
    mode = "chunked" if chunked else None
    assert batched.backend == BackendId.batched("cpu", mode)
    assert mesh.backend == BackendId.mesh("cpu", ndata, mode) == (
        f"mesh[cpu{',chunked' if chunked else ''}]({ndata} devices)")
    assert mesh.collectives_checked is not None and mesh.collectives_checked > 0
    assert torch.equal(mesh.theta, batched.theta), (pair, ndata, chunked)
    if chunked:  # both accept_sum / T (the one-shot batched path takes a mean)
        assert torch.equal(mesh.accept, batched.accept)


@pytest.mark.parametrize("chunked", [False, True], ids=["one_shot", "chunked"])
def test_model_axis_mesh_equals_the_data_axis_mesh_bitwise(chunked):
    """``mesh_shape=(2, 2)`` on four named devices (cpu, repeated): each chain
    group replicates over its model row, so θ is the (2, 1) mesh's bit for
    bit, as the reference's (ndata, nmodel) mesh equals its (ndata,) one."""
    extra = dict(stream_every=10) if chunked else {}
    subs = (lambda ev: None,) if chunked else ()
    base = _spec("logreg/mala", **extra)
    rows = Pipeline(dataclasses.replace(base, mesh_shape=(2, 1)), device="cpu",
                    devices=_cpus(2)).sample(on_chunk=subs)
    pipe = Pipeline(dataclasses.replace(base, mesh_shape=(2, 2)), device="cpu",
                    devices=_cpus(4))
    assert pipe.devices == (torch.device("cpu"),) * 2 and pipe.mesh_shape == (2, 1)
    grid = pipe.sample(on_chunk=subs)
    assert grid.backend == rows.backend
    assert torch.equal(grid.theta, rows.theta)
    assert resolve_mesh_devices((2, 2), ("cpu:0", "cpu:1", "cpu:2", "cpu:3"), "cpu") == (
        torch.device("cpu", 0), torch.device("cpu", 2))


@pytest.mark.parametrize("check", [True, False])
def test_one_shot_mesh_reports_its_check_when_asked(check):
    """``sample_subposteriors(check=)`` keeps ``repro``'s signature: the mesh
    always runs the chain-group check, and ``check`` says whether the result
    reports it; the draws are the batched draws either way."""
    model = get_model("linear")
    data, _ = model.generate_data(torch.Generator().manual_seed(0), 256)
    kw = dict(sampler="mala", warmup=5, burn_in=5, step_size=0.1)
    batched = sample_subposteriors(torch.Generator().manual_seed(3), model, data, 4, 20, **kw)
    mesh = sample_subposteriors(torch.Generator().manual_seed(3), model, data, 4, 20, **kw,
                                mesh_shape=(2, 1), devices=_cpus(2), check=check)
    assert mesh.backend == "mesh[cpu](2 devices)"
    assert (mesh.collectives_checked > 0) if check else (mesh.collectives_checked is None)
    assert torch.equal(mesh.theta, batched.theta)


# -- repro's scorecard (tests/test_mesh_stream.py), on the port -------------

SCORE_FIELDS = dict(model="poisson", sampler="gibbs", combiner=("parametric", "online"), M=4,
                    T=60, warmup=0, n=512, seed=0, groundtruth_T=120, stream_every=20,
                    score_metric="logl2")


@pytest.fixture(scope="module")
def scorecard():
    spec_b = RunSpec(**SCORE_FIELDS, mesh_shape=(1, 1))  # (1, 1) is the batched backend
    spec_m = RunSpec(**SCORE_FIELDS, mesh_shape=(4, 1))
    pb, pm = Pipeline(spec_b, device="cpu"), Pipeline(spec_m, device="cpu", devices=_cpus(4))
    rb, rm = pb.stream_combine(fused=False), pm.stream_combine(fused=False)
    fb = Pipeline(spec_b, device="cpu").run()
    pf = Pipeline(spec_m, device="cpu", devices=_cpus(4))
    fm = pf.run()
    return dict(pb=pb, pm=pm, rb=rb, rm=rm, fb=fb, fm=fm, pf=pf, spec_m=spec_m)


def test_mesh_subscriber_stream_matches_batched(scorecard):
    pb, pm, rb, rm = (scorecard[k] for k in ("pb", "pm", "rb", "rm"))
    assert pb.sample().backend == "batched[cpu,chunked]"
    assert pm.sample().backend == "mesh[cpu,chunked](4 devices)"
    assert torch.equal(pb.sample().theta, pm.sample().theta)
    for name in ("parametric", "online"):
        assert torch.equal(rb.combined[name].samples, rm.combined[name].samples), name
    assert len(rb.trajectory) == len(rm.trajectory) > 0
    assert [(r["t"], r["combiner"], r["error"]) for r in rb.trajectory] == \
        [(r["t"], r["combiner"], r["error"]) for r in rm.trajectory]
    assert pb.score().errors == pm.score().errors


def test_fused_mesh_board_is_scored_and_checked(scorecard):
    fb, fm = scorecard["fb"], scorecard["fm"]
    assert fb.backend == "batched[cpu,fused]" and fm.backend == "mesh[cpu,fused](4 devices)"
    assert fb.collectives_checked is None
    assert fm.collectives_checked > 0
    assert fm.errors == fb.errors
    assert all(math.isfinite(v) for v in fm.errors.values())
    assert fm.spec_id != fb.spec_id  # the mesh shape is part of the spec


def test_mesh_checkpoint_resume_bitwise(scorecard, tmp_path):
    spec_m = scorecard["spec_m"]
    d1, d2 = tmp_path / "a", tmp_path / "b"
    partial = Pipeline(spec_m, device="cpu", devices=_cpus(4), checkpoint_dir=d1,
                       checkpoint_every=20).sample(max_steps=40)
    assert (partial.t_done, partial.complete) == (40, False)
    resumed = Pipeline(spec_m, device="cpu", devices=_cpus(4), checkpoint_dir=d1,
                       checkpoint_every=20).sample()
    straight = Pipeline(spec_m, device="cpu", devices=_cpus(4), checkpoint_dir=d2,
                        checkpoint_every=20).sample()
    assert resumed.backend == "mesh[cpu,resumable](4 devices)"
    assert torch.equal(resumed.theta, straight.theta)
    assert torch.equal(resumed.theta, scorecard["pb"].sample().theta)


def test_mesh_fanout_matrix_reproduces_the_batched_sweep():
    """Three cells over two devices: the last is repeated to fill the fan."""
    cells = [RunSpec(model="linear", sampler="mala", combiner="parametric", M=4, T=100,
                     warmup=20, n=512, seed=s, groundtruth_T=200, score_metric="logl2")
             for s in range(3)]
    res_b = run_matrix(cells, device="cpu")
    res_f = run_matrix(cells, device="cpu", backend="mesh_fanout", devices=_cpus(2))
    assert res_f.backend == "mesh_fanout[cpu](2 devices)" == BackendId.mesh_fanout("cpu", 2)
    assert res_f.n_executables == 1 and res_f.collectives_checked > 0
    assert res_b.collectives_checked is None
    assert len(res_f.rows) == len(res_b.rows) == 3
    for a, b in zip(res_b.rows, res_f.rows):
        assert (a["spec_id"], a["error"], a["accept"]) == (b["spec_id"], b["error"], b["accept"])
        assert math.isfinite(a["error"])


# -- the chain-group check ---------------------------------------------------


def _mesh_backend(ndata=2):
    model = get_model("linear")
    data, _ = model.generate_data(torch.Generator().manual_seed(0), 256)
    shards, counts = partition_data(data, 4, only=model.shard_keys, pad=True)
    sk = make_shard_kernel(model, 4, "mala", use_counts=False)
    return MeshChunkBackend(sk, model, shards, counts, devices=_cpus(ndata), burn_in=5,
                            warmup=5, step_size=0.1)


def test_check_raises_on_a_planted_cross_group_read():
    mesh = _mesh_backend()
    states, eps = mesh.setup(torch.Generator().manual_seed(0))
    n = mesh.check_groups(states, eps)
    assert n > 0 and mesh.collectives_checked == n
    other = mesh.groups[0].shards["x"]
    g1 = mesh.groups[1]
    kernel = g1._kernel
    planted = kernel._replace(
        step=lambda gen, st, *ins: (other.sum(), kernel.step(gen, st, *ins))[1])
    g1._kernel = planted
    with pytest.raises(CrossChainError, match="inputs or carry of chain group 0"):
        mesh.check_groups(states, eps)


def test_check_raises_on_a_planted_all_reduce_and_foreign_storage():
    a, b = torch.ones(3), torch.zeros(3)

    def reduce():
        torch.ops._c10d_functional.all_reduce(a, "sum", "0")

    with pytest.raises(CrossChainError, match="collective"):
        assert_no_cross_chain_collectives([ChainGroup(torch.device("cpu"), [a], reduce),
                                           ChainGroup(torch.device("cpu"), [b], lambda: b + 1)])
    with pytest.raises(CrossChainError, match="chain group 1"):
        assert_no_cross_chain_collectives([ChainGroup(torch.device("cpu"), [a], lambda: b * 2),
                                           ChainGroup(torch.device("cpu"), [b], lambda: b + 1)])
    # a view of a foreign tensor is the same storage
    with pytest.raises(CrossChainError):
        assert_no_cross_chain_collectives([ChainGroup(torch.device("cpu"), [a],
                                                      lambda: b[1:].sum()),
                                           ChainGroup(torch.device("cpu"), [b], lambda: None)])
    clean = assert_no_cross_chain_collectives([
        ChainGroup(torch.device("cpu"), [a], lambda: (a * 2).sum()),
        ChainGroup(torch.device("cpu"), [b], lambda: b + 1)])
    assert clean == 3


# -- layout and refusals ------------------------------------------------------


def test_localize_and_put_carry_round_trip_a_gibbs_state():
    model = get_model("poisson")
    data, _ = model.generate_data(torch.Generator().manual_seed(0), 200)
    shards, counts = partition_data(data, 4, only=model.shard_keys, pad=True)
    sk = make_shard_kernel(model, 4, "gibbs", use_counts=False)
    mesh = MeshChunkBackend(sk, model, shards, counts, devices=_cpus(2), burn_in=2, warmup=0,
                            step_size=0.1)
    states, eps = mesh.setup(torch.Generator().manual_seed(0))
    assert isinstance(states, Grouped) and len(states) == 2
    full = mesh.localize({"state": states, "eps": eps, "n": 3})
    assert full["n"] == 3 and full["state"].position.q.shape[0] == 4
    assert full["state"].unresolved.dim() == 0  # a count, summed
    back = mesh.put_carry(full)
    for g in range(2):
        for x, y in zip(back["state"][g].position, states[g].position):
            assert torch.equal(x, y)


def test_mesh_refusals():
    model = get_model("linear")
    data, _ = model.generate_data(torch.Generator().manual_seed(0), 256)
    shards, counts = partition_data(data, 4, only=model.shard_keys, pad=True)
    with pytest.raises(ValueError, match="on the cpu name them"):
        resolve_mesh_devices((2, 1), None, "cpu")
    with pytest.raises(ValueError, match="needs 4 CUDA devices and 0 visible"):
        resolve_mesh_devices((4, 1), None, "cuda")
    with pytest.raises(ValueError, match="has 4 devices .* names 2"):
        resolve_mesh_devices((2, 2), _cpus(2), "cpu")
    with pytest.raises(ValueError, match="must divide M=4"):
        resolve_mesh_devices((3, 1), _cpus(3), "cpu", 4)
    with pytest.raises(ValueError, match="names 3"):
        resolve_mesh_devices((2, 1), _cpus(3), "cpu")
    with pytest.raises(ValueError, match="must divide M=4"):
        RunSpec(model="linear", M=4, mesh_shape=(3, 1)).validate()
    with pytest.raises(ValueError, match="needs a spec whose mesh_shape"):
        Pipeline(RunSpec(model="linear", M=4), device="cpu", devices=_cpus(2))
    with pytest.raises(ValueError, match="on the cpu name them"):
        Pipeline(RunSpec(model="linear", M=4, mesh_shape=(2, 1)), device="cpu")
    with pytest.raises(ValueError, match=">= 2 devices"):
        run_matrix([RunSpec(model="linear", M=4)], device="cpu", backend="mesh_fanout")
    mesh = get_chunk_backend(model, 4, "mala", shards=shards, counts=counts,
                             mesh_shape=(2, 1), devices=_cpus(2))
    assert isinstance(mesh, MeshChunkBackend) and mesh.backend_id() == "mesh[cpu](2 devices)"
    assert isinstance(get_chunk_backend(model, 4, "mala", shards=shards, counts=counts,
                                        mesh_shape=(1, 1)), BatchedChunkBackend)


def test_combine_draws_forwards_to_combine_gathered():
    theta = torch.randn(3, 50, 2, generator=torch.Generator().manual_seed(0))
    spec = RunSpec(model="poisson", M=3, T=50, combiner="parametric")
    stage = combine_spec_draws(spec, theta)["parametric"]
    got = combine_draws(stream_generator(spec.seed, "combine", "cpu", "parametric"), theta, 50,
                        combiner="parametric", rescale=True, n_batch=1, unknown_option=1)
    assert torch.equal(got.samples, stage.samples)  # the combine stage's backend
    with pytest.raises(ValueError, match=r"needs \(M, T, d_sub\)"):
        combine_draws(torch.Generator(), theta[0], 50)
