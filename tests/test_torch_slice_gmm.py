"""The GMM experiment (§8.2) end to end: the port's Pipeline against repro's.

The port runs ``RunSpec(model="gmm")`` under its default ``rwmh`` at a small
size, on the dataset repro generates for seed 0 (only ``x`` is per datum;
the weights and component std go to every shard whole), carried across as
numpy. It is scored in logL2, as ``GMM_SPEC`` is: the subposteriors are so
concentrated that the raw L2 overflows float32 at d = 20 (inf or NaN in both
packages). repro's logL2 over seeds 0–4 at the same spec, measured by
``python tests/test_torch_slice_gmm.py``:

    repro rwmh  parametric      19.5707  nan      nan      nan      nan
    repro rwmh  nonparametric    8.9165  6.7978   6.8169   9.2288   8.4653
    repro rwmh  semiparametric  18.2687  nan      nan      nan      nan

The random walk accepts 1–8 % of its moves at this concentration in both
packages (repro 2.7 % at GMM_SPEC's full width, seed 0), so a chain's draws
repeat: where one holds fewer than d + 1 distinct points its sample
covariance has no float32 Cholesky factor, the factor is NaN in both
packages (``tests/test_torch_core_maths.py``), and so is the Gaussian
product behind parametric and semiparametric, as in repro at four seeds of
five.

The score is set by the groundtruth chain more than by anything the port
computes. That full-data random walk also repeats its draws (seeds 0–7:
repro's chain holds 7–501 distinct points of 833, the port's 7–285), and
at d = 20 log d₂ follows its spread through the Silverman bandwidth's
h^(−d). On the same subposterior draws the two packages' combines score
within 0.16 of each other against either chain, but the port's combine of
its own draws scores 8.92, 6.80, 6.51, 9.24 against repro's chains at
seeds 0–3 and 1.83, 1.40, 4.02, 17.47 against its own (CPU). So one port
seed's full pipeline against its own chain lands anywhere in 0.5–17.5
(``python tests/test_torch_slice_gmm.py`` prints both packages' seeds),
and the band is applied where the reference's numbers were measured,
against repro's own groundtruth chain of seed 0:

- the port's combine and score stages on repro's own subposterior draws:
  each of the three errors inside [min − r, max + r] of repro's five (r
  their range); parametric and semiparametric, finite only at seed 0 in
  repro, inside that seed's value widened by the nonparametric range;
- the port's whole sampling and combine on repro's data: its
  nonparametric error inside the same band;
- the port's whole pipeline, groundtruth chain included: every error finite.

``gmm`` has no Gibbs blocks, so a Gibbs spec is refused at ``validate()``,
as repro refuses it.
"""

import numpy as np
import pytest
import torch

from repro.api import Pipeline as JaxPipeline
from repro.api import RunSpec as JaxRunSpec
from repro_torch.api import Pipeline, RunSpec
from repro_torch.api.pipeline import combine_spec_draws, resolve_metric
from repro_torch.interop import from_reference_data
from test_torch_slice_poisson import _reference_data, seed_spread
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

FIELDS = dict(
    model="gmm", M=4, T=300, warmup=100, n=2000, groundtruth_T=1000, seed=0, score_metric="logl2",
    combiner=("parametric", "nonparametric", "semiparametric"),
    combiner_options={"weight_eval": "kernel", "n_batch": 16},
)
NONPARAMETRIC = (8.9165, 6.7978, 6.8169, 9.2288, 8.4653)  # repro, seeds 0–4
SEED0 = {"parametric": 19.5707, "semiparametric": 18.2687}  # repro, seed 0 (NaN at 1–4)


def test_scoreboard_within_reference_seed_spread():
    r = max(NONPARAMETRIC) - min(NONPARAMETRIC)
    bands = {"nonparametric": (min(NONPARAMETRIC) - r, max(NONPARAMETRIC) + r),
             # one seed has no range of its own: widened by the nonparametric one
             **{name: (v - r / 2, v + r / 2) for name, v in SEED0.items()}}
    fields = dict(FIELDS, sampler="rwmh")
    spec = RunSpec(**fields)
    assert spec.spec_id == JaxRunSpec(**fields).spec_id
    data = from_reference_data(*_reference_data("gmm", fields["seed"], fields["n"]),
                               device="cpu")
    port = Pipeline(spec, data=data, device="cpu")
    board = port.run()
    assert board.metric == "logL2" and all(np.isfinite(v) for v in board.errors.values())

    ref = JaxPipeline(JaxRunSpec(**fields))
    gt = torch.from_numpy(np.array(ref.groundtruth()))
    dist, _ = resolve_metric(spec, gt.shape[-1])
    ref_draws = torch.from_numpy(np.array(ref.sample().theta))
    for name, res in combine_spec_draws(spec, ref_draws).items():
        got = float(dist(gt, res.samples))
        assert bands[name][0] <= got <= bands[name][1], (name, got, bands[name])
    port_draws = port.sample().theta
    got = float(dist(gt, combine_spec_draws(spec, port_draws, ("nonparametric",))
                     ["nonparametric"].samples))
    assert bands["nonparametric"][0] <= got <= bands["nonparametric"][1], got


def test_gibbs_is_refused_at_validate():
    for spec in (RunSpec(model="gmm", sampler="gibbs"), JaxRunSpec(model="gmm", sampler="gibbs")):
        with pytest.raises(ValueError, match="Gibbs"):
            spec.validate()


if __name__ == "__main__":
    seed_spread(FIELDS, ("rwmh",))
