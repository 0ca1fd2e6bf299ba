"""The slice's paths end to end on the CPU: linear-Gaussian, Gibbs runs, SGLD.

- ``linear`` under ``mala`` and ``gibbs``: the parametric combiner's mean
  against the closed-form posterior mean, within 5 times its Monte Carlo
  error (each chain's ESS per coordinate from ``effective_sample_size``).
- A Gibbs spec's θ is bitwise the same one-shot, chunked (subscriber and
  fused) and interrupted-then-resumed from a checkpoint, for ``linear`` (a
  flat position) and ``poisson`` (θ with the shard's latents).
- Ragged shards under ``gibbs``: the edge-padded rows stay inert (perturbing
  them changes no bit of θ); SGLD's minibatches read only each chain's real
  rows (NaN padded rows leave θ finite).
- ``RunSpec.validate()`` succeeds or raises where repro's does, for every
  model and canonical sampler; ``groundtruth_step_size`` equals repro's
  (ε/M for ``sgld``).
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.api import RunSpec as JaxRunSpec
from repro.api.pipeline import groundtruth_step_size as jax_groundtruth_step_size
from repro.models.bayes import get_model as jax_get_model
from repro.samplers import canonical_samplers as jax_canonical_samplers
from repro_torch.api import Pipeline, RunSpec
from repro_torch.api.pipeline import groundtruth_step_size
from repro_torch.api.sampling import make_shard_kernel, run_shard_chain
from repro_torch.core import metrics
from repro_torch.core.subposterior import partition_data
from repro_torch.interop import from_reference_data
from repro_torch.models.bayes import get_model
from repro_torch.models.bayes import linear_gaussian as tlin
from repro_torch.samplers import canonical_samplers
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

FIELDS = dict(
    model="linear", M=4, T=300, warmup=100, n=2000, groundtruth_T=600, seed=0,
    combiner=("parametric", "nonparametric", "semiparametric"),
    combiner_options={"weight_eval": "kernel", "n_batch": 16},
)


def _reference_data(model, n, seed=0):
    data, theta = jax_get_model(model).generate_data(jax.random.PRNGKey(seed), n)
    return from_reference_data({k: np.asarray(v) for k, v in data.items()}, np.asarray(theta),
                               device="cpu")


@pytest.mark.parametrize("sampler", ["mala", "gibbs"])
def test_linear_parametric_mean_matches_closed_form(sampler):
    spec = RunSpec(**dict(FIELDS, sampler=sampler, combiner="parametric"))
    data = _reference_data("linear", spec.n)
    pipe = Pipeline(spec, data=data, device="cpu")
    theta = pipe.sample().theta  # (M, T, d)
    res = pipe.combine()["parametric"]
    exact = tlin.posterior_moments(data[0])
    M, T, d = theta.shape
    ess = torch.stack([torch.stack([metrics.effective_sample_size(theta[m, :, j])
                                    for j in range(d)]) for m in range(M)])  # (M, d)
    # the product's mean error ≈ Σ*·mean_m(1/ESS_m) per coordinate, plus the
    # T combined draws' own sampling error Σ*/T
    var = exact.cov.diagonal() * ((1.0 / ess).mean(dim=0) + 1.0 / T)
    err = (res.samples.mean(dim=0) - exact.mean).abs()
    assert bool((err <= 5.0 * var.sqrt()).all()), (err / var.sqrt()).tolist()
    assert float(ess.min()) > 10.0


def _sample_variants(spec, data, tmp_path):
    """θ of the one-shot stage, the chunked subscriber stream, the fused
    stream and a checkpointed run stopped halfway and resumed."""
    one = Pipeline(spec, data=data, device="cpu").sample()
    chunked = dataclasses.replace(spec, stream_every=spec.T // 4)
    sub = Pipeline(chunked, data=data, device="cpu").sample(on_chunk=(lambda ev: None,))
    from repro_torch.api.streaming import stream_sample

    pipe = Pipeline(chunked, data=data, device="cpu")
    sharded = pipe.partition()
    fused = stream_sample(
        pipe._stream("sample"), pipe._model, sharded.data, spec.M, spec.T,
        sampler=spec.sampler, warmup=spec.warmup, burn_in=spec.resolved_burn_in(),
        step_size=spec.step_size, shards=sharded.shards, counts=sharded.counts,
        chunk_size=chunked.stream_every)
    ckpt = str(tmp_path / "ckpt")
    first = Pipeline(chunked, data=data, device="cpu", checkpoint_dir=ckpt,
                     checkpoint_every=chunked.stream_every).sample(max_steps=spec.T // 2)
    resumed = Pipeline(chunked, data=data, device="cpu", checkpoint_dir=ckpt,
                       checkpoint_every=chunked.stream_every).sample()
    assert not first.complete and first.t_done == spec.T // 2 and resumed.complete
    assert sub.backend == "batched[cpu,chunked]" and resumed.backend == "batched[cpu,resumable]"
    assert fused.result.backend == "batched[cpu,fused]"
    return one.theta, sub.theta, fused.result.theta, resumed.theta


@pytest.mark.parametrize("model,n", [("linear", 1203), ("poisson", 603)])
def test_gibbs_theta_bitwise_one_shot_chunked_fused_and_resumed(model, n, tmp_path):
    spec = RunSpec(model=model, sampler="gibbs", M=4, T=80, warmup=10, n=n, seed=3,
                   combiner="parametric")
    data = _reference_data(model, n)
    one, sub, fused, resumed = _sample_variants(spec, data, tmp_path)
    assert one.shape == (4, 80, get_model(model).d) and torch.isfinite(one).all()
    for other in (sub, fused, resumed):
        assert torch.equal(one, other)


@pytest.mark.parametrize("model", ["linear", "poisson"])
def test_ragged_gibbs_padded_rows_stay_inert(model):
    """n = 1,003 over M = 4 (counts 251, 251, 251, 250): the last shard's
    padded row perturbed (+1,000 on every per-datum value) changes no bit of
    θ; the Gibbs blocks see the counts."""
    tm = get_model(model)
    data, _ = _reference_data(model, 1003)
    shards, counts = partition_data(data, 4, only=tm.shard_keys, pad=True)
    assert counts.tolist() == [251, 251, 251, 250]
    sk = make_shard_kernel(tm, 4, "gibbs", use_counts=True)

    def run(sh):
        return run_shard_chain(sk, sh, counts, torch.Generator().manual_seed(0), num_samples=60,
                               burn_in=10, warmup=10, step_size=0.1)[0]

    perturbed = {k: v.clone() for k, v in shards.items()}
    for v in perturbed.values():
        v[3, 250:] += 1000.0
    base = run(shards)
    assert torch.isfinite(base).all() and torch.equal(base, run(perturbed))
    # without the counts the padded row would enter the conditionals
    unmasked = make_shard_kernel(tm, 4, "gibbs", use_counts=False)
    moved = run_shard_chain(unmasked, perturbed, counts, torch.Generator().manual_seed(0),
                            num_samples=60, burn_in=10, warmup=10, step_size=0.1)[0]
    assert not torch.equal(base, moved)


def test_sgld_minibatches_read_only_real_rows():
    """Ragged linear shards with NaN in every padded row: SGLD's batches
    (uniforms scaled by each chain's count) never reach them, so θ stays
    finite, and the sgld pipeline runs (groundtruth at ε/M)."""
    tm = get_model("linear")
    data, _ = _reference_data("linear", 1003)
    shards, counts = partition_data(data, 4, pad=True)
    for v in shards.values():
        v[3, 250:] = float("nan")
    sk = make_shard_kernel(tm, 4, "sgld", sgld_batch=32, use_counts=True)
    theta, acc = run_shard_chain(sk, shards, counts, torch.Generator().manual_seed(0),
                                 num_samples=200, burn_in=20, warmup=0, step_size=1e-4)
    assert torch.isfinite(theta).all() and acc.tolist() == [1.0] * 4
    spec = RunSpec(model="linear", sampler="sgld", M=4, T=100, warmup=20, n=1003,
                   groundtruth_T=100, step_size=1e-4, sgld_batch=64, combiner="parametric")
    board = Pipeline(spec, device="cpu").run()
    assert np.isfinite(board.errors["parametric"])


def test_validate_agrees_with_reference_for_every_model_and_sampler():
    assert canonical_samplers() == jax_canonical_samplers()
    for model in ("logreg", "linear", "poisson", "gmm"):
        for sampler in canonical_samplers():
            outcomes = []
            for cls in (RunSpec, JaxRunSpec):
                try:
                    cls(model=model, sampler=sampler).validate()
                    outcomes.append("ok")
                except ValueError as e:
                    outcomes.append(type(e).__name__)
            assert outcomes[0] == outcomes[1], (model, sampler, outcomes)
            assert (outcomes[0] == "ok") == (sampler != "gibbs" or model in ("linear", "poisson"))


@pytest.mark.parametrize("sampler", ["sgld", "gibbs", "rwmh", "mala", "hmc"])
@pytest.mark.parametrize("warmup", [0, 200])
def test_groundtruth_step_size_matches_reference(sampler, warmup):
    fields = dict(model="linear", sampler=sampler, M=10, step_size=0.1, warmup=warmup)
    got = groundtruth_step_size(RunSpec(**fields))
    want = jax_groundtruth_step_size(JaxRunSpec(**fields))
    assert got == pytest.approx(float(want), rel=1e-12)
    if sampler == "sgld":
        assert got == pytest.approx(0.1 / 10)


def test_cli_model_sampler_and_n_resolve_to_the_specs(monkeypatch):
    """``--model`` picks the model's spec (repro's defaults: linear under
    mala, poisson under gibbs, gmm under rwmh scored in logL2), ``--sampler``
    and ``--n`` override it, as repro's CLI flags do; without ``--model`` the
    logreg specs are unchanged."""
    from repro_torch.launch import mcmc_run

    assert mcmc_run.spec_for(None, "poisson") == mcmc_run.POISSON_SPEC
    assert mcmc_run.spec_for(None, "linear_gaussian") == mcmc_run.LINEAR_SPEC
    assert mcmc_run.spec_for(None, "gmm") == mcmc_run.GMM_SPEC
    assert mcmc_run.spec_for(None, None) is mcmc_run.PAPER_SPEC
    assert mcmc_run.GMM_SPEC.score_metric == "logl2"
    for spec, model, sampler in ((mcmc_run.LINEAR_SPEC, "linear", "mala"),
                                 (mcmc_run.POISSON_SPEC, "poisson", "gibbs"),
                                 (mcmc_run.GMM_SPEC, "gmm", "rwmh")):
        assert (spec.model, spec.resolved_sampler(), spec.resolved_n()) == (
            model, sampler, jax_get_model(model).default_n)
        assert (spec.M, spec.T, spec.warmup, spec.groundtruth_T) == (10, 1200, 200, 4000)
        assert spec.combiner == mcmc_run.PAPER_SPEC.combiner
    seen = []

    class Recorder:
        def __init__(self, spec, **_kw):
            seen.append(spec)

        def run(self):
            return Pipeline(RunSpec(model="linear", M=2, T=4, n=40, groundtruth_T=4, warmup=2,
                                    combiner="parametric"), device="cpu").run()

    monkeypatch.setattr(mcmc_run, "Pipeline", Recorder)
    mcmc_run.main(["--device", "cpu", "--model", "poisson", "--sampler", "rwmh", "--n", "2000"])
    assert seen[-1] == dataclasses.replace(mcmc_run.POISSON_SPEC, sampler="rwmh", n=2000)


def test_quickstart_on_cpu(capsys):
    """``python -m repro_torch.launch.quickstart --device cpu`` at a small T:
    the four combiners graded against the closed-form posterior mean (each
    within 0.2 of it; 0.01–0.05 at this seed), then the scoreboard."""
    from repro_torch.launch import quickstart

    out = quickstart.main(["--device", "cpu", "--T", "200"])
    assert set(out["mean_errors"]) == set(quickstart.SPEC.combiner_names())
    assert all(err < 0.2 for err in out["mean_errors"].values()), out
    assert all(math.isfinite(err) for err in out["errors"].values()), out
    text = capsys.readouterr().out
    assert "true posterior mean" in text and "logL2(parametric" in text
