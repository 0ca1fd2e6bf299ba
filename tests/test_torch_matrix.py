"""repro_torch.api.matrix: the scenario sweep with one set of chain loops a
signature, and the RunSpec grammar it rests on, held to repro's.

Mirrors ``tests/test_api.py``'s matrix cases (a mesh spec refused; eight
specs in two signatures building two sets of loops; a cell equal to a
standalone Pipeline) and ``tests/test_streaming.py``'s sweep cases. The
port's cells are compared with the port's Pipeline bit for bit (the same
generators and arithmetic), and ``executable_signature``,
``groundtruth_signature`` and ``sweep`` with ``repro``'s for the same fields.
"""

import dataclasses
import math

import numpy as np
import pytest

import repro.api as rapi
from repro_torch.api import Pipeline, RunSpec, run_matrix
from repro_torch.api.matrix import ExecutableCache, MatrixResult, main
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

SPEC = RunSpec(
    model="linear", sampler="mala", M=4, T=60, warmup=30, n=512, seed=3,
    groundtruth_T=120, combiner=("parametric", "pool"), score_metric="logl2",
)


def _matrix_specs():
    return [
        RunSpec(model=m, sampler="mala", combiner="parametric", M=4, T=40,
                warmup=30, n=256, seed=seed, step_size=step,
                groundtruth_T=80, score_metric="logl2")
        for m in ("linear", "poisson")
        for seed in (0, 1)
        for step in (0.1, 0.2)
    ]


def _same(a, b):
    return a == b or (math.isnan(a) and math.isnan(b))


def test_run_matrix_rejects_mesh_specs_and_the_fanout_backend():
    """A mesh spec is refused; the fan-out needs two devices, which the CPU
    never infers (tests/test_torch_mesh.py runs it on an explicit list)."""
    spec = RunSpec(**{**SPEC.to_dict(), "mesh_shape": (4, 1)})
    with pytest.raises(ValueError, match="vmap backend only"):
        run_matrix([spec], device="cpu")
    with pytest.raises(ValueError, match="needs >= 2 devices and 0 cpu devices"):
        run_matrix([SPEC], device="cpu", backend="mesh_fanout")
    with pytest.raises(ValueError, match="needs backend='mesh_fanout'"):
        run_matrix([SPEC], device="cpu", devices=("cpu", "cpu"))
    with pytest.raises(ValueError, match="unknown run_matrix backend"):
        run_matrix([SPEC], device="cpu", backend="nope")


def test_run_matrix_compiles_once_per_signature(tmp_path):
    """8 specs spanning 2 signatures (2 models × 2 seeds × 2 step sizes)
    build exactly 2 sets of sampling loops (and 2 groundtruth ones): seeds
    and step sizes are runtime inputs. Each cell's scoreboard is a
    standalone Pipeline's, bit for bit (NaN where the Pipeline's is NaN:
    at seed 1 the Poisson groundtruth chain of this tiny spec never moves
    after its 30 warmup steps, so its KDE has no spread, in both)."""
    specs = _matrix_specs()
    assert len({s.executable_signature() for s in specs}) == 2
    res = run_matrix(specs, json_path=str(tmp_path / "matrix.json"), device="cpu")
    assert isinstance(res, MatrixResult)
    assert res.n_specs == 8
    assert res.n_executables == 2
    assert res.n_groundtruth_executables == 2
    assert res.n_graphs == 0  # no CUDA graph off the card
    assert len(res.rows) == 8
    assert all(math.isfinite(r["error"]) for r in res.rows if r["model"] == "linear")
    assert (tmp_path / "matrix.json").exists()
    assert "8 cells on batched[cpu], 2 sampling executables" in res.table()
    for spec in specs:
        board = Pipeline(spec, device="cpu").run().errors
        rows = {r["combiner"]: r["error"] for r in res.rows if r["spec_id"] == spec.spec_id}
        assert set(rows) == set(board)
        assert all(_same(rows[n], board[n]) for n in board), (spec.model, spec.seed,
                                                              spec.step_size, rows, board)


def test_run_matrix_agrees_with_pipeline():
    """A matrix cell and a standalone Pipeline over the same spec share the
    RNG discipline end to end: the same scoreboard, bit for bit."""
    res = run_matrix([SPEC], device="cpu")
    matrix_errors = {r["combiner"]: r["error"] for r in res.rows}
    board = Pipeline(SPEC, device="cpu").score().errors
    assert matrix_errors == board


def test_fixed_step_cells_key_their_loops_on_the_step():
    """A fixed-step kernel reads its step as a number: gibbs cells at two
    step sizes build two sets of loops, each cell still its Pipeline's."""
    base = dataclasses.replace(SPEC, sampler="gibbs", combiner="parametric", T=30,
                               groundtruth_T=60)
    specs = base.sweep(step_size=[0.1, 0.2], seed=[0, 1])
    res = run_matrix(specs, device="cpu")
    assert res.n_executables == 2
    for spec in specs:
        board = Pipeline(spec, device="cpu").run().errors
        rows = {r["combiner"]: r["error"] for r in res.rows if r["spec_id"] == spec.spec_id}
        assert rows == board


@pytest.mark.parametrize("fields", [
    {},
    {"sampler": "gibbs", "T": 100, "stream_every": 20},
    {"model": "poisson", "warmup": 0, "burn_in": 7, "n": 300},
    {"sampler_options": {"num_integration_steps": 3}, "sampler": "hmc", "sgld_batch": 32},
    {"groundtruth_T": 999, "seed": 4, "step_size": 0.3, "combiner": "all"},
])
def test_signatures_match_reference(fields):
    spec = dataclasses.replace(SPEC, **fields)
    ref = rapi.RunSpec(**spec.to_dict())
    assert spec.spec_id == ref.spec_id
    assert spec.executable_signature() == ref.executable_signature()
    assert spec.groundtruth_signature() == ref.groundtruth_signature()


def test_sweep_cells_match_reference():
    axes = dict(seed=range(2), combiner=[["parametric"], ["pool", "online"]],
                step_size=[0.1, 0.3])
    cells = SPEC.sweep(**axes)
    ref = rapi.RunSpec(**SPEC.to_dict()).sweep(**axes)
    assert [c.to_dict() for c in cells] == [r.to_dict() for r in ref]
    assert [c.spec_id for c in cells] == [r.spec_id for r in ref]


def test_sweep_validates_axes():
    base = RunSpec(model="linear")
    assert base.sweep() == [base]
    with pytest.raises(ValueError, match="not a RunSpec field"):
        base.sweep(bogus=[1])
    with pytest.raises(TypeError, match="iterable of field values"):
        base.sweep(combiner="parametric")
    with pytest.raises(ValueError, match="empty"):
        base.sweep(seed=[])
    with pytest.raises(KeyError, match="unknown model"):
        base.sweep(model=["linear", "nope"])


def test_sweep_feeds_run_matrix(tmp_path):
    specs = RunSpec(
        model="linear", sampler="mala", combiner="parametric", M=4, T=30,
        warmup=10, n=256, groundtruth_T=60, score_metric="logl2",
    ).sweep(seed=range(2))
    res = run_matrix(specs, json_path=str(tmp_path / "sweep.json"), device="cpu")
    assert res.n_specs == 2
    assert res.n_executables == 1
    # repro's test asserts finite errors. Here the groundtruth chain (10
    # warmup steps) never moves; its spread, in repro's form, is the mean's
    # rounding residual, so seed 0's logL2 is finite (171.33, as in the
    # Pipeline). Seed 1's is NaN for another reason: its 30 draws a chain
    # hold fewer than d + 1 = 11 distinct points, and the parametric
    # product's covariance has no float32 Cholesky factor in the port
    # (repro's random stream and factor differ). Each row is held to the
    # standalone Pipeline's.
    for spec in specs:
        board = Pipeline(spec, device="cpu").run().errors
        row = [r["error"] for r in res.rows if r["spec_id"] == spec.spec_id]
        assert len(row) == 1 and _same(row[0], board["parametric"])
        if spec.seed == 0:
            assert math.isfinite(row[0])


def test_constant_chain_log_l2_is_finite_where_the_reference_is():
    """The sweep spec's groundtruth chain never moves (seeds 0 and 1). On the
    same draws, the port's logL2 against a moving cloud is finite wherever
    repro's is: Silverman's spread is taken in ``jnp.std``'s form."""
    import jax.numpy as jnp

    from repro.core import metrics as jax_metrics
    from repro_torch.core import metrics

    for seed in (0, 1):
        spec = RunSpec(model="linear", sampler="mala", combiner="parametric", M=4, T=30,
                       warmup=10, n=256, groundtruth_T=60, score_metric="logl2", seed=seed)
        pipe = Pipeline(spec, device="cpu")
        gt, cloud = pipe.groundtruth(), pipe.sample().theta[0]
        assert float(gt.std(dim=0).max()) == 0.0  # the chain never moved
        for p, q in ((gt, cloud), (cloud, gt)):
            want = float(jax_metrics.log_l2_distance(jnp.asarray(p.numpy()),
                                                     jnp.asarray(q.numpy())))
            got = float(metrics.log_l2_distance(p, q))
            assert math.isfinite(want) and math.isfinite(got), (seed, want, got)


def test_executable_cache_reloads_one_backend_per_signature():
    """The cache's backend owns its inputs: a second cell of the signature
    loads its shards into them, and the kernels read the new data."""
    from repro_torch.api.matrix import _partitioned
    from repro_torch.api.sampling import is_padded
    from repro_torch.models.bayes import get_model

    cache, parts = ExecutableCache(), {}
    model = get_model("linear")
    backends = []
    for seed in (0, 1):
        spec = dataclasses.replace(SPEC, seed=seed)
        _, shards, counts = _partitioned(spec, model, "cpu", parts)
        backends.append(cache.sample_backend(spec, model,
                                             is_padded(model, shards, counts, "mala"),
                                             shards, counts))
        assert all(np.array_equal(backends[-1].shards[k], v) for k, v in shards.items())
    assert backends[0] is backends[1] and len(cache.sample) == 1


def test_matrix_cli_on_cpu(capsys):
    res = main(["--device", "cpu", "--models", "linear", "--samplers", "mala",
                "--combiners", "parametric", "--seeds", "0,1", "--M", "2", "--T", "20",
                "--warmup", "10", "--n", "128", "--gt-T", "40"])
    assert res.n_specs == 2 and res.n_executables == 1
    assert "2 cells on batched[cpu]" in capsys.readouterr().out
