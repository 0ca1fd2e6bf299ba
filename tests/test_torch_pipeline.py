"""The slice end to end: repro_torch's Pipeline against repro's on the same data.

Both packages run the paper's logreg pipeline (partition → MALA chains with
dual-averaging warmup → groundtruth chain → combine → logL2 score) at a small
size, on the dataset repro generates for the seed, carried across as numpy.
With ``weight_eval="kernel"`` and ``n_batch=16`` the IMG sweeps score
B·M = 64 candidates, so repro goes through its Pallas kernel in interpret
mode and the port through its kernel wrapper's plain version.

The chains and combiners draw from different random streams, so the
scoreboards are held within a band: for each combiner, the spread (max − min)
of repro's own logL2 over seeds 0–4 at this spec, each seed on its own data,
measured by ``python tests/test_torch_pipeline.py``:

    parametric      38.0134  36.4657  38.0902  35.3983  36.9372  → band 2.6918
    nonparametric   21.3784  20.9516  25.9967  20.9830  24.9011  → band 5.0451
    semiparametric  34.5665  34.5942  38.2168  30.2717  36.8065  → band 7.9452

(the port's logL2 on the same five datasets: 37.785 / 21.428 / 36.527 for
seed 0, and within these ranges for the others.)
"""

import jax
import numpy as np
import pytest

from repro.api import Pipeline as JaxPipeline
from repro.api import RunSpec as JaxRunSpec
from repro.models.bayes import get_model as jax_get_model
from repro_torch.api import Pipeline, RunSpec, combine_spec_draws
from repro_torch.interop import from_reference_data
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

FIELDS = dict(
    model="logreg", sampler="mala", M=4, T=200, warmup=200, n=2000, groundtruth_T=1000, seed=0,
    combiner=("parametric", "nonparametric", "semiparametric"),
    combiner_options={"weight_eval": "kernel", "n_batch": 16},
)
BAND = {"parametric": 2.6918, "nonparametric": 5.0451, "semiparametric": 7.9452}


def _reference_data(seed, n):
    data, beta = jax_get_model("logreg").generate_data(jax.random.PRNGKey(seed), n)
    return {k: np.asarray(v) for k, v in data.items()}, np.asarray(beta)


@pytest.fixture(scope="module")
def boards():
    jspec, tspec = JaxRunSpec(**FIELDS), RunSpec(**FIELDS)
    jboard = JaxPipeline(jspec).run()
    data = from_reference_data(*_reference_data(FIELDS["seed"], FIELDS["n"]), device="cpu")
    pipe = Pipeline(tspec, data=data, device="cpu")
    return jboard, pipe.run(), pipe


def test_scoreboard_within_reference_seed_spread(boards):
    jboard, tboard, _ = boards
    assert tboard.spec_id == jboard.spec_id
    assert tboard.metric == jboard.metric == "logL2"
    assert set(tboard.errors) == set(jboard.errors) == set(BAND)
    for name, band in BAND.items():
        got, want = tboard.errors[name], jboard.errors[name]
        assert np.isfinite(got)
        assert abs(got - want) <= band, (name, got, want, band)
    # MALA's warmup targets 0.55; the averaged step lands higher, as in repro
    assert abs(tboard.accept - jboard.accept) < 0.1, (tboard.accept, jboard.accept)


def test_pipeline_artifacts(boards):
    _, tboard, pipe = boards
    draws = pipe.sample()
    assert draws.theta.shape == (4, 200, 50) and draws.counts.tolist() == [500] * 4
    assert pipe.groundtruth().shape == (1000, 50)
    assert {r.samples.shape for r in pipe.combine().values()} == {(200, 50)}
    assert set(tboard.timings) >= {"partition_s", "sample_s", "groundtruth_s", "combine_s", "score_s"}
    assert tboard.backend == "batched[cpu]"


def test_fixed_seed_is_bitwise_and_combiner_streams_are_independent(boards):
    """A second run of the same spec on the same data gives the same draws;
    each combiner's stream is keyed by its name, not by which others run."""
    _, _, pipe = boards
    spec = RunSpec(**dict(FIELDS, T=60, groundtruth_T=60, warmup=20))
    data = from_reference_data(*_reference_data(0, FIELDS["n"]), device="cpu")
    a = Pipeline(spec, data=data, device="cpu").sample().theta
    b = Pipeline(spec, data=data, device="cpu").sample().theta
    assert a.eq(b).all()
    theta = pipe.sample().theta
    alone = combine_spec_draws(RunSpec(**FIELDS), theta, ("nonparametric",))
    assert alone["nonparametric"].samples.equal(pipe.combine()["nonparametric"].samples)


def test_generated_data_follows_the_model_in_distribution():
    """The port's own generate_data (torch Generator): y ~ Bern(σ(Xβ)) with X,
    β standard normal. At n=20,000 the label mean and the X moments sit within
    ~5 standard errors of their population values."""
    pipe = Pipeline(RunSpec(model="logreg", n=20000, M=4, T=10), device="cpu")
    sharded = pipe.partition()
    x, y, beta = sharded.data["x"], sharded.data["y"], sharded.theta_true
    assert x.shape == (20000, 50) and beta.shape == (50,)
    assert abs(float(x.mean())) < 5 / np.sqrt(x.numel())
    assert abs(float(x.std()) - 1.0) < 0.01
    p = float(((x @ beta).sigmoid()).mean())
    assert abs(float(y.mean()) - p) < 5 * np.sqrt(0.25 / 20000)


if __name__ == "__main__":
    # repro's own seed-to-seed spread behind BAND
    runs = {}
    for seed in range(5):
        board = JaxPipeline(JaxRunSpec(**dict(FIELDS, seed=seed))).run()
        for name, err in board.errors.items():
            runs.setdefault(name, []).append(err)
    for name, errs in runs.items():
        print(f"{name:15s}", "  ".join(f"{e:.4f}" for e in errs),
              f"  → band {max(errs) - min(errs):.4f}")
