"""The paper's §8.2 and §8.3 experiments (``launch/gmm_multimodal.py``,
``launch/hierarchical_poisson.py``) on the CPU at small T.

The reference's examples (``examples/gmm_multimodal.py`` with its shards
edge-padded, since its own split of 20,000 rows into 6 raises, and
``examples/hierarchical_poisson.py``), run with JAX on the CPU at their full
sizes for seeds 0–4 (§8.2) and 0–2 (§8.3), printed:

- §8.2, every seed: pool 4/4 modes, nonparametric 1/4, semiparametric 1/4,
  parametric 0/4, subpostAvg 0/4;
- §8.3: acceptance RWMH 0.26–0.27, MALA 0.99–1.00.

The driver's IMG combines run one index chain, as the example's do. The
chain count decides the table (``launch/gmm_multimodal.py``'s docstring):
16 chains cover all 4 modes in both packages. At the tests' T = 150 the
reference's combines (the example's call: incremental, one chain) given
the port's draws of seeds 0–4 cover nonparametric 1–2 modes and
semiparametric 0–1; the port's own combines on the same draws cover 1 and
0–1. Those are the bands: nonparametric 1–2, semiparametric 0–1, the pool
all four, parametric and subpostAvg none (the reference's five seeds at
full size), each held for both packages' combines of one set of draws.
§8.3's acceptance within 0.1 of the reference's range (T = 60 a chain
here: the acceptance's Monte Carlo error). The GMM chains' acceptance has
no reference figure (the example prints none, and its permutation is
applied outside the MH step, where the port's proposal permutes and
jitters in one move): the band [0.05, 0.45] is the port's own CPU runs
(seeds 0–2 at T = 150 and 300: 0.13–0.30) widened.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.combiners import get_combiner as jax_get_combiner
from repro_torch.launch import gmm_multimodal, hierarchical_poisson
from repro_torch.models.bayes import gmm
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run


# modes covered at T = 150 (see the module docstring)
MODES = {"pool": (4, 4), "nonparametric": (1, 2), "semiparametric": (0, 1),
         "parametric": (0, 0), "subpost_average": (0, 0)}


def test_gmm_multimodal_keeps_modes_the_parametric_combine_loses(capsys):
    out = gmm_multimodal.main(["--device", "cpu", "--T", "150"])
    printed = capsys.readouterr().out
    sub = out["samples"]
    assert tuple(sub.shape) == (gmm_multimodal.M, 150, 2 * gmm_multimodal.K)
    assert all(0.05 <= float(a) <= 0.45 for a in out["accept"]), out["accept"]
    modes = out["modes"]
    assert all(lo <= modes[name] <= hi for name, (lo, hi) in MODES.items()), modes
    assert modes["parametric"] < modes["nonparametric"]
    for label in ("groundtruth-ish pool", "nonparametric (§3.2)", "semiparametric (§3.3)",
                  "parametric (biased)", "subpostAvg (biased)"):
        assert f"{label}" in printed and "modes covered" in printed
    # on the CPU the IMG combines take the kernel's plain version: no launch
    assert sum(out["img_routes"].values()) == 0

    # the reference's combines, as its example calls them, on the same draws
    _, true_means = gmm.generate_data(torch.Generator().manual_seed(0), gmm_multimodal.N,
                                      gmm_multimodal.K)
    draws = jnp.asarray(sub.numpy())
    for name in ("nonparametric", "semiparametric"):
        res = jax_get_combiner(name)(jax.random.PRNGKey(0), draws, 150, rescale=True)
        got, _ = gmm_multimodal.describe(name, torch.from_numpy(np.array(res.samples)),
                                         true_means)
        assert MODES[name][0] <= got <= MODES[name][1], (name, got)


def test_hierarchical_poisson_mixes_samplers_and_scores_every_combiner(capsys):
    out = hierarchical_poisson.main(["--device", "cpu", "--T", "60"])
    printed = capsys.readouterr().out
    rwmh, mala = out["accept"]
    assert 0.16 <= rwmh <= 0.37 and 0.89 <= mala <= 1.0, out["accept"]
    assert set(out["d2"]) == {"parametric", "nonparametric", "semiparametric", "subpostAvg"}
    assert all(math.isfinite(v) and v >= 0 for v in out["d2"].values())
    for name, mean in out["means"].items():
        # every combined mean near the groundtruth chain's (log a, log b):
        # within 0.5, loose at T = 60
        assert bool(torch.isfinite(mean).all()), name
        assert float((mean - out["groundtruth_mean"]).abs().max()) < 0.5, name
    assert "machines 0-4: RWMH" in printed and "machines 5-9: MALA" in printed
