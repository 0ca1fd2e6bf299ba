"""The Poisson–gamma experiment (§8.3) end to end: the port's Pipeline against repro's.

The port runs ``RunSpec(model="poisson")`` under ``gibbs`` (latent q_i,
conjugate b, MH on log a) and under ``rwmh`` (the marginal negative-binomial
likelihood) at a small size, on the dataset repro generates for seed 0,
carried across as numpy. The chains draw from other random streams than
repro's, so each combiner's L2 is held to repro's own L2 over seeds 0–4 at
the same spec (each seed on its own data): inside [min − r, max + r], r the
seeds' range (``chip_smoke.py``'s rule for its CPU bands). Measured by
``python tests/test_torch_slice_poisson.py`` (repro, then the port on each
seed's repro data):

    repro gibbs parametric      1.4659  2.3174  4.8698  4.3956  2.7029
    repro gibbs nonparametric   2.7696  3.7101  4.3856  2.9365  4.7918
    repro gibbs semiparametric  2.8103  4.6110  5.8653  3.0768  3.8323
    repro rwmh  parametric      2.1712  4.8162  2.6075  4.7123  3.0288
    repro rwmh  nonparametric   2.0915  3.9973  3.1459  4.1929  3.1113
    repro rwmh  semiparametric  2.9039  5.9942  4.6693  5.6827  2.4344
    port  gibbs parametric      5.6701  1.6849  3.4846  6.9159  4.7525
    port  gibbs nonparametric   4.7744  3.7860  3.3108  7.6131  4.7542
    port  gibbs semiparametric  6.9723  4.0865  5.8293  10.0518 8.6271
    port  rwmh  parametric      2.3047  2.5023  2.2034  2.5641  1.8667
    port  rwmh  nonparametric   2.6818  4.3010  3.8962  3.6354  2.7665
    port  rwmh  semiparametric  3.3462  3.6787  2.4892  5.8015  1.1411

At these five seeds the port's Gibbs L2 sits above repro's on average, and
seed 3's semiparametric (10.05) lies outside the band, so the band alone
cannot say whether that gap is noise. Two things here do:

- ``test_gibbs_subposterior_moments_match_quadrature`` holds both packages'
  Gibbs chains on one shard to the exact moments of the target their blocks
  leave invariant (quadrature, no sampling): each pooled mean and second
  moment lies within 4 Monte Carlo errors, so the port's Gibbs sampler
  targets the right subposterior;
- over seeds 0–19 (``python tests/test_torch_slice_poisson.py 20 gibbs``)
  the mean Gibbs L2, repro against the port, is 4.565 / 4.787
  (parametric), 4.284 / 4.727 (nonparametric) and 5.503 / 6.178
  (semiparametric); the mean paired difference is 0.22 ± 0.62, 0.44 ± 0.55
  and 0.67 ± 0.75 (± its standard error); on seeds 5–19 alone the port's
  mean is the lower one for parametric and semiparametric.

The Gibbs chains mix slowly (an ESS of 21–67 in 4,000 draws per
subposterior chain in both packages, on repro's seed-0 data), so at T = 300
each L2 rests on a handful of effective draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Pipeline as JaxPipeline
from repro.api import RunSpec as JaxRunSpec
from repro.api.sampling import make_shard_kernel as jax_make_shard_kernel
from repro.api.sampling import run_shard_chain as jax_run_shard_chain
from repro.models.bayes import get_model as jax_get_model
from repro_torch.api import Pipeline, RunSpec
from repro_torch.api.sampling import sample_subposteriors
from repro_torch.core.metrics import moment_z_scores
from repro_torch.core.subposterior import partition_data
from repro_torch.interop import from_reference_data
from repro_torch.models.bayes import get_model
from repro_torch.models.bayes.poisson_gamma import gibbs_subposterior_moments
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

FIELDS = dict(
    model="poisson", M=4, T=300, warmup=100, n=2000, groundtruth_T=1000, seed=0,
    combiner=("parametric", "nonparametric", "semiparametric"),
    combiner_options={"weight_eval": "kernel", "n_batch": 16},
)
# repro's L2 over seeds 0–4 at FIELDS (see the module docstring)
REFERENCE = {
    "gibbs": {"parametric": (1.4659, 2.3174, 4.8698, 4.3956, 2.7029),
              "nonparametric": (2.7696, 3.7101, 4.3856, 2.9365, 4.7918),
              "semiparametric": (2.8103, 4.6110, 5.8653, 3.0768, 3.8323)},
    "rwmh": {"parametric": (2.1712, 4.8162, 2.6075, 4.7123, 3.0288),
             "nonparametric": (2.0915, 3.9973, 3.1459, 4.1929, 3.1113),
             "semiparametric": (2.9039, 5.9942, 4.6693, 5.6827, 2.4344)},
}
REFERENCE_ACCEPT = {"gibbs": 1.0, "rwmh": 0.2975}  # repro at FIELDS, seed 0, mean over chains


def _reference_data(model, seed, n):
    data, theta = jax_get_model(model).generate_data(jax.random.PRNGKey(seed), n)
    return {k: np.asarray(v) for k, v in data.items()}, np.asarray(theta)


def board_within_reference(fields, reference):
    """The port's scoreboard on repro's seed data: the spec_id of repro's
    spec, every error finite and inside [min − r, max + r] of repro's seeds."""
    tspec = RunSpec(**fields)
    assert tspec.spec_id == JaxRunSpec(**fields).spec_id
    data = from_reference_data(*_reference_data(fields["model"], fields["seed"], fields["n"]),
                               device="cpu")
    tboard = Pipeline(tspec, data=data, device="cpu").run()
    assert set(tboard.errors) == set(reference)
    for name, seeds in reference.items():
        r = max(seeds) - min(seeds)
        got = tboard.errors[name]
        assert np.isfinite(got) and min(seeds) - r <= got <= max(seeds) + r, (name, got, seeds)
    return tboard


@pytest.mark.parametrize("sampler", ["gibbs", "rwmh"])
def test_scoreboard_within_reference_seed_spread(sampler):
    tboard = board_within_reference(dict(FIELDS, sampler=sampler), REFERENCE[sampler])
    assert tboard.metric == "L2" and tboard.sampler == sampler
    # gibbs always accepts; random-walk MH adapts each chain toward 0.35
    assert abs(tboard.accept - REFERENCE_ACCEPT[sampler]) < 0.1, tboard.accept


def test_gibbs_subposterior_moments_match_quadrature():
    """Both packages' Gibbs chains on one shard (C independent chains, the
    shard repeated) against the exact moments of the target the blocks leave
    invariant (``gibbs_subposterior_moments``, quadrature in float64): each
    pooled mean and second moment within 4 Monte Carlo errors. This is what
    separates a wrong Gibbs sampler from the noise of the L2 bands above."""
    M, C, burn, T = 4, 32, 300, 500
    data, theta = _reference_data("poisson", 0, FIELDS["n"])
    shards, _ = partition_data(from_reference_data(data, theta, device="cpu")[0], M, pad=True)
    shard = {k: v[0] for k, v in shards.items()}
    mean, std = gibbs_subposterior_moments(shard, M)
    rows = int(shard["x"].shape[0])
    many = {k: v.unsqueeze(0).expand((C,) + v.shape).contiguous() for k, v in shard.items()}
    port = sample_subposteriors(
        torch.Generator().manual_seed(1), get_model("poisson"), many, M, T, sampler="gibbs",
        warmup=burn, shards=many, counts=torch.full((C,), rows, dtype=torch.int32)).theta
    sk = jax_make_shard_kernel(jax_get_model("poisson"), M, "gibbs", use_counts=False)
    jshard = {k: jnp.broadcast_to(jnp.asarray(v.numpy()), (C, rows)) for k, v in shard.items()}
    ref = jax.jit(jax.vmap(lambda key, s: jax_run_shard_chain(
        sk, s, jnp.asarray(rows), key, num_samples=T, burn_in=0, warmup=burn,
        step_size=0.1)[0]))(jax.random.split(jax.random.PRNGKey(1), C), jshard)
    for name, chains in (("port", port), ("repro", torch.from_numpy(np.asarray(ref)))):
        z_mean, z_var = moment_z_scores(chains, mean, std)
        assert bool((z_mean.abs() <= 4.0).all() and (z_var.abs() <= 4.0).all()), (
            name, z_mean, z_var, mean, std)


def seed_spread(fields, samplers, seeds=range(5)):
    """repro's own errors over ``seeds`` (behind REFERENCE), then the port's
    on each seed's repro data, printed."""
    for package in ("repro", "port"):
        for sampler in samplers:
            runs = {}
            for seed in seeds:
                f = dict(fields, sampler=sampler, seed=seed)
                if package == "repro":
                    board = JaxPipeline(JaxRunSpec(**f)).run()
                else:
                    data = from_reference_data(*_reference_data(f["model"], seed, f["n"]),
                                               device="cpu")
                    board = Pipeline(RunSpec(**f), data=data, device="cpu").run()
                for name, err in board.errors.items():
                    runs.setdefault(name, []).append(err)
            for name, errs in runs.items():
                print(f"{package:5s} {sampler:5s} {name:15s}", "  ".join(f"{e:.4f}" for e in errs),
                      flush=True)


if __name__ == "__main__":
    import sys

    # python tests/test_torch_slice_poisson.py [seeds] [sampler ...]
    seed_spread(FIELDS, tuple(sys.argv[2:]) or ("gibbs", "rwmh"),
                seeds=range(int(sys.argv[1]) if len(sys.argv) > 1 else 5))
