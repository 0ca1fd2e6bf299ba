"""Combine-while-sampling against repro's on the same data.

Both packages run ``Pipeline(spec).stream_combine()`` on the logreg spec of
``tests/test_torch_pipeline.py`` with a cadence of T/2, on the dataset repro
generates for the seed, carried across as numpy. The chains draw from
different random streams, so the trajectories are held by their rows (the
same ``(t, combiner)`` sequence, finite values) and the finals by the band
method of ``tests/test_torch_pipeline.py``: within the spread of repro's own
logL2 over seeds 0–4 at that spec. ``online``'s final is the moment product
of the same draws as ``parametric``'s (to merge rounding), so it is held to
parametric's band.
"""

import math

import jax
import numpy as np
import pytest

from repro.api import Pipeline as JaxPipeline
from repro.api import RunSpec as JaxRunSpec
from repro.models.bayes import get_model as jax_get_model
from repro_torch.api import Pipeline, RunSpec
from repro_torch.interop import from_reference_data
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

FIELDS = dict(
    model="logreg", sampler="mala", M=4, T=200, warmup=200, n=2000, groundtruth_T=1000, seed=0,
    combiner=("parametric", "online", "pool"), stream_every=100,
    combiner_options={"weight_eval": "kernel", "n_batch": 16},
)
BAND = {"parametric": 2.6918, "online": 2.6918}  # tests/test_torch_pipeline.py


@pytest.fixture(scope="module")
def streams():
    data, beta = jax_get_model("logreg").generate_data(jax.random.PRNGKey(FIELDS["seed"]),
                                                       FIELDS["n"])
    tdata = from_reference_data({k: np.asarray(v) for k, v in data.items()}, np.asarray(beta),
                                device="cpu")
    jpipe = JaxPipeline(JaxRunSpec(**FIELDS))
    tpipe = Pipeline(RunSpec(**FIELDS), data=tdata, device="cpu")
    return jpipe, jpipe.stream_combine(n_estimate=64), tpipe, tpipe.stream_combine(n_estimate=64)


def test_trajectory_rows_match_reference(streams):
    _, jsr, _, tsr = streams
    assert [(r["t"], r["combiner"]) for r in tsr.trajectory] == \
        [(r["t"], r["combiner"]) for r in jsr.trajectory]
    assert tsr.metric == jsr.metric == "logL2"
    assert all(math.isfinite(r["error"]) for r in tsr.trajectory)
    assert (tsr.t_done, tsr.total, tsr.complete) == (jsr.t_done, jsr.total, jsr.complete)


def test_stream_finals_within_reference_seed_spread(streams):
    jpipe, _, tpipe, _ = streams
    jboard, tboard = jpipe.run(), tpipe.run()
    assert tboard.spec_id == jboard.spec_id
    assert set(tboard.errors) == set(jboard.errors)
    for name, band in BAND.items():
        got, want = tboard.errors[name], jboard.errors[name]
        assert abs(got - want) <= band, (name, got, want, band)
    assert math.isfinite(tboard.errors["pool"])
