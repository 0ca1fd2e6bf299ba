"""``combiner="all"`` end to end: the port scores the same eleven combiners as repro.

Both packages run the logreg pipeline at a small size with ``combiner="all"``
on the dataset repro generates for the seed. The chains and combiners draw
from different random streams, so the scoreboards are held by their keys,
their ``spec_id`` and finiteness; the values of the first slice's combiners
are held to themselves under the wider spec.
"""

import jax
import numpy as np
import pytest

from repro.api import Pipeline as JaxPipeline
from repro.api import RunSpec as JaxRunSpec
from repro.models.bayes import get_model as jax_get_model
from repro_torch.api import Pipeline, RunSpec
from repro_torch.interop import from_reference_data
from repro_torch.launch.mcmc_run import ALL_SPEC, PAPER_SPEC, spec_for
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

FIELDS = dict(
    model="logreg", sampler="mala", M=4, T=120, warmup=30, n=1000, groundtruth_T=200, seed=0,
    combiner="all",
    combiner_options={"weight_eval": "kernel", "n_batch": 16, "init_pool": 100},
)
PAPER_NAMES = ("parametric", "nonparametric", "semiparametric")


@pytest.fixture(scope="module")
def data():
    d, beta = jax_get_model("logreg").generate_data(jax.random.PRNGKey(FIELDS["seed"]), FIELDS["n"])
    return from_reference_data({k: np.asarray(v) for k, v in d.items()}, np.asarray(beta),
                               device="cpu")


def test_default_combiner_names_match_reference():
    assert RunSpec(model="logreg").combiner_names() == JaxRunSpec(model="logreg").combiner_names()
    assert len(RunSpec(model="logreg").combiner_names()) == 11


def test_all_scoreboard_keys_match_reference(data):
    jboard = JaxPipeline(JaxRunSpec(**FIELDS)).run()
    tboard = Pipeline(RunSpec(**FIELDS), data=data, device="cpu").run()
    assert tboard.spec_id == jboard.spec_id
    assert tboard.metric == jboard.metric == "logL2"
    assert sorted(tboard.errors) == sorted(jboard.errors)
    assert all(np.isfinite(v) for v in tboard.errors.values()), tboard.errors


def test_paper_combiners_unchanged_under_the_wider_spec(data):
    """Each combiner draws from its own stream and ``init_pool`` reaches only
    weierstrass, so the first slice's three logL2 values are the same bits
    whether the spec asks for three combiners or for all eleven."""
    small = RunSpec(**dict(FIELDS, combiner=PAPER_NAMES))
    wide = Pipeline(RunSpec(**FIELDS), data=data, device="cpu").run().errors
    narrow = Pipeline(small, data=data, device="cpu").run().errors
    assert set(narrow) == set(PAPER_NAMES)
    for name in PAPER_NAMES:
        assert wide[name] == narrow[name], name


def test_launcher_specs():
    assert spec_for(None) is PAPER_SPEC
    assert spec_for(["all"]) is ALL_SPEC
    assert ALL_SPEC.combiner_names() == JaxRunSpec(model="logreg").combiner_names()
    named = spec_for(["pool", "rpt"])
    assert named.combiner == ("pool", "rpt")
    assert named.combiner_options == ALL_SPEC.combiner_options
    # ALL_SPEC is PAPER_SPEC widened: same run, more combiners, one more option
    for field in ("model", "sampler", "M", "T", "seed", "n", "warmup", "groundtruth_T"):
        assert getattr(ALL_SPEC, field) == getattr(PAPER_SPEC, field)
    assert dict(ALL_SPEC.combiner_options) == dict(PAPER_SPEC.combiner_options, init_pool=1000)
