"""Combine-while-sampling in the port: the chunk driver, the fused and the
subscriber streams, checkpoints, and the CLI, on a small logreg spec.

Within the port the draws are bitwise: one-shot, chunked at any cadence,
fused, and interrupted-then-resumed runs draw the same θ from the same
generator, and the buffered combiners' stream finals are bitwise their batch
results. ``online`` folds in chunks and agrees with its batch face to merge
rounding (mean rtol 1e-4 / atol 1e-5, as ``tests/test_streaming.py``).
"""

import dataclasses
import json
import math

import numpy as np

import pytest
import torch

from repro_torch.api import Pipeline, RunSpec, combine_spec_draws
from repro_torch.api.backends import BackendId
from repro_torch.api.resumable import sample_subposteriors_resumable
from repro_torch.api.sampling import sample_subposteriors
from repro_torch.api.streaming import stream_sample
from repro_torch.core.gaussian import fit_moments
from repro_torch.launch import mcmc_run
from repro_torch.models.bayes import get_model
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

NAMES = ("parametric", "online", "pool", "nonparametric", "consensus")
# 64 draws per chunk > d = 50, yet a MALA chain repeats the draws it rejects:
# here one chain's first 64 span fewer than d dimensions, its covariance has
# no Cholesky factor, and the Gaussian products (parametric, online) are NaN
# at that boundary, as the reference's are on the same draws
SPEC = RunSpec(model="logreg", sampler="mala", M=4, T=192, warmup=20, n=800, groundtruth_T=100,
               seed=0, combiner=NAMES, stream_every=64,
               combiner_options={"weight_eval": "kernel", "n_batch": 16})
RAGGED = dataclasses.replace(SPEC, T=200)  # a ragged tail of 8 draws


def _pipe(spec=SPEC, **kw):
    return Pipeline(spec, device="cpu", **kw)


@pytest.fixture(scope="module")
def streamed():
    pipe = _pipe()
    return pipe, pipe.stream_combine(n_estimate=32)


@pytest.fixture(scope="module")
def data():
    return _pipe().partition()


def _one_shot(spec, sharded):
    return sample_subposteriors(
        torch.Generator().manual_seed(11), get_model("logreg"), sharded.data, spec.M, spec.T,
        warmup=spec.warmup, burn_in=spec.resolved_burn_in(), shards=sharded.shards,
        counts=sharded.counts)


@pytest.mark.parametrize("T,chunk", [(64, 16), (64, 7), (64, 64), (70, 16), (70, 1), (200, 64)])
def test_stream_sample_at_any_cadence_is_bitwise_one_shot(data, T, chunk):
    spec = dataclasses.replace(SPEC, T=T)
    one = _one_shot(spec, data)
    seen = []
    ss = stream_sample(
        torch.Generator().manual_seed(11), get_model("logreg"), data.data, spec.M, spec.T,
        warmup=spec.warmup, burn_in=spec.resolved_burn_in(), shards=data.shards,
        counts=data.counts, chunk_size=chunk, on_chunk=(lambda ev: seen.append((ev.t0, ev.t1)),))
    assert torch.equal(ss.result.theta, one.theta)
    assert torch.equal(ss.result.accept, one.accept)
    assert seen == [(t, min(t + chunk, T)) for t in range(0, T, chunk)]
    fused = stream_sample(
        torch.Generator().manual_seed(11), get_model("logreg"), data.data, spec.M, spec.T,
        warmup=spec.warmup, burn_in=spec.resolved_burn_in(), shards=data.shards,
        counts=data.counts, chunk_size=chunk)
    assert torch.equal(fused.result.theta, one.theta)


def test_backend_tags_are_pinned(tmp_path):
    assert BackendId.batched("cuda") == "batched[cuda]"
    assert BackendId.batched("cpu") == "batched[cpu]"
    assert BackendId.batched("cuda", "fused") == "batched[cuda,fused]"
    assert BackendId.batched("cuda", "chunked") == "batched[cuda,chunked]"
    assert BackendId.batched("cuda", "resumable") == "batched[cuda,resumable]"
    with pytest.raises(ValueError, match="unknown backend mode"):
        BackendId.batched("cuda", "mesh")
    assert _pipe(dataclasses.replace(SPEC, stream_every=0)).sample().backend == "batched[cpu]"
    assert _pipe().sample().backend == "batched[cpu,fused]"
    assert _pipe().sample(on_chunk=(lambda ev: None,)).backend == "batched[cpu,chunked]"
    assert _pipe(checkpoint_dir=tmp_path).sample().backend == "batched[cpu,resumable]"


def test_fused_and_subscriber_streams_agree(streamed):
    pipe, sf = streamed
    sub_pipe = _pipe()
    su = sub_pipe.stream_combine(n_estimate=32, fused=False)
    assert torch.equal(pipe.sample().theta, sub_pipe.sample().theta)
    assert [(r["t"], r["combiner"]) for r in sf.trajectory] == \
        [(r["t"], r["combiner"]) for r in su.trajectory]
    for name in NAMES:
        if name == "online":
            torch.testing.assert_close(sf.combined[name].moments.mean,
                                       su.combined[name].moments.mean, rtol=1e-4, atol=1e-5)
        else:
            assert torch.equal(sf.combined[name].samples, su.combined[name].samples), name


def test_stream_finals_equal_the_batch_combine(streamed):
    pipe, sr = streamed
    batch = combine_spec_draws(SPEC, pipe.sample().theta)
    for name in NAMES:
        if name == "online":
            torch.testing.assert_close(sr.combined[name].moments.mean, batch[name].moments.mean,
                                       rtol=1e-4, atol=1e-5)
        else:
            assert torch.equal(sr.combined[name].samples, batch[name].samples), name
    assert pipe.combine() is not batch and set(pipe.combine()) == set(NAMES)
    board = pipe.run()
    assert set(board.errors) == set(NAMES) and "stream_combine_s" in board.timings


def _errors(rows):
    """A trajectory's errors as an array (NaN compares equal to NaN in
    ``np.testing.assert_array_equal``, bit for bit otherwise)."""
    return np.array([r["error"] for r in rows], dtype=np.float64)


def test_trajectory_rows_per_boundary_and_monotone(streamed):
    pipe, sr = streamed
    estimating = ("nonparametric", "online", "parametric", "pool")  # consensus only finalizes
    want = [(t, n) for t in (64, 128, 192) for n in NAMES if n in estimating]
    assert [(r["t"], r["combiner"]) for r in sr.trajectory] == want
    assert sr.metric == "logL2" and sr.complete and sr.t_done == 192
    # the reference's rule: a Gaussian product is NaN exactly when some
    # chain's covariance of the draws so far has no Cholesky factor; every
    # other estimate is finite
    theta = pipe.sample().theta
    for r in sr.trajectory:
        no_factor = bool((torch.linalg.cholesky_ex(fit_moments(theta[:, :r["t"]]).cov).info
                          != 0).any())
        if r["combiner"] in ("parametric", "online") and no_factor:
            assert math.isnan(r["error"]), r
        else:
            assert math.isfinite(r["error"]), r
    stamps = [r["elapsed_s"] for r in sr.trajectory]
    assert stamps == sorted(stamps) and stamps[0] >= 0


def test_ragged_tail_boundary():
    sr = _pipe(RAGGED).stream_combine(names=("pool", "online"), n_estimate=8, score=False)
    assert [r["t"] for r in sr.trajectory] == [64, 64, 128, 128, 192, 192, 200, 200]
    assert all(r["error"] is None for r in sr.trajectory)


def test_stream_combine_needs_a_cadence():
    with pytest.raises(ValueError, match="stream_every"):
        _pipe(dataclasses.replace(SPEC, stream_every=0)).stream_combine()
    with pytest.raises(ValueError, match="stream_every"):
        RunSpec(model="logreg", stream_every=-1)
    assert RunSpec(model="logreg", stream_every=0).validate().stream_every == 0


def test_stream_combine_after_sample_replays_cached_draws(streamed):
    _, sr = streamed
    pipe = _pipe()
    pipe.sample()
    again = pipe.stream_combine(n_estimate=32)
    np.testing.assert_array_equal(_errors(again.trajectory), _errors(sr.trajectory))


def test_fused_true_raises_when_the_run_needs_subscribers(tmp_path):
    with pytest.raises(ValueError, match="fused"):
        _pipe(checkpoint_dir=tmp_path).stream_combine(n_estimate=8, score=False, fused=True)


def test_interrupt_then_resume_is_bitwise_uninterrupted(tmp_path, streamed):
    pipe, ref = streamed
    first = _pipe(checkpoint_dir=tmp_path, checkpoint_every=64).stream_combine(
        n_estimate=32, max_steps=100)
    assert not first.complete and first.t_done == 64 and first.combined == {}
    resumed_pipe = _pipe(checkpoint_dir=tmp_path, checkpoint_every=64)
    full = resumed_pipe.stream_combine(n_estimate=32)
    assert full.complete
    assert torch.equal(resumed_pipe.sample().theta, pipe.sample().theta)
    # the subscriber path's rows and finals: the resumed run is one
    sub = _pipe().stream_combine(n_estimate=32, fused=False)
    assert [(r["t"], r["combiner"]) for r in full.trajectory] == \
        [(r["t"], r["combiner"]) for r in sub.trajectory]
    np.testing.assert_array_equal(_errors(full.trajectory), _errors(sub.trajectory))
    for name in NAMES:
        assert torch.equal(full.combined[name].samples, sub.combined[name].samples), name
    for name in NAMES:
        if name != "online":
            assert torch.equal(full.combined[name].samples, ref.combined[name].samples), name


def test_completed_checkpoint_short_circuits(tmp_path, data):
    kw = dict(warmup=SPEC.warmup, burn_in=SPEC.resolved_burn_in(), shards=data.shards,
              counts=data.counts, checkpoint_dir=str(tmp_path), checkpoint_every=32,
              spec_id="abc")
    model = get_model("logreg")
    first = sample_subposteriors_resumable(torch.Generator().manual_seed(11), model, data.data,
                                           SPEC.M, SPEC.T, **kw)
    assert first.complete and first.resumed_from == 0
    again = sample_subposteriors_resumable(torch.Generator().manual_seed(99), model, data.data,
                                           SPEC.M, SPEC.T, **kw)
    assert again.resumed_from == SPEC.T and again.complete
    assert torch.equal(again.result.theta, first.result.theta)
    assert torch.equal(first.result.theta, _one_shot(SPEC, data).theta)


def test_checkpoints_are_cadence_and_spec_locked(tmp_path, data):
    model = get_model("logreg")

    def run(spec_id, every, max_steps=None):
        return sample_subposteriors_resumable(
            torch.Generator().manual_seed(11), model, data.data, SPEC.M, SPEC.T,
            warmup=SPEC.warmup, shards=data.shards, counts=data.counts,
            checkpoint_dir=str(tmp_path), checkpoint_every=every, spec_id=spec_id,
            max_steps=max_steps)

    part = run("abc", 16, max_steps=20)
    assert part.t_done == 16 and not part.complete
    with pytest.raises(ValueError, match="checkpoint_every"):
        run("abc", 32)
    with pytest.raises(ValueError, match="refusing to resume"):
        run("other", 16)
    with pytest.raises(ValueError, match="durable"):
        run("abc", 16, max_steps=8)
    with pytest.raises(ValueError, match="multiple"):
        stream_sample(torch.Generator(), model, data.data, SPEC.M, SPEC.T, shards=data.shards,
                      counts=data.counts, chunk_size=16, checkpoint_dir=str(tmp_path),
                      checkpoint_every=24)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _pipe().sample(max_steps=16)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _pipe(checkpoint_every=16)


def test_cli_streams_on_the_cpu(capsys):
    """``--stream-every`` prints the trajectory, then the scoreboard line (the
    full-width spec, two cheap combiners, one chunk boundary at 600)."""
    assert mcmc_run.main(["--device", "cpu", "--combiner", "parametric", "online",
                          "--stream-every", "600"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("streaming: first logL2 estimate (parametric, t=600)")
    assert [line.split("(")[1].split()[0] for line in out[1:5]] == [
        "parametric", "online", "parametric", "online"]
    board = json.loads(out[-1])
    assert board["backend"] == "batched[cpu,fused]" and set(board["errors"]) == {
        "online", "parametric"}
    assert mcmc_run.STREAM_SPEC == dataclasses.replace(mcmc_run.ALL_SPEC, stream_every=120)


def test_cli_refuses_one_checkpoint_dir_for_several_seeds(tmp_path, capsys):
    """A checkpoint belongs to one spec (the seed is part of it), so the CLI
    refuses to share one directory between seeds before sampling anything."""
    with pytest.raises(SystemExit) as exc:
        mcmc_run.main(["--device", "cpu", "--seeds", "0", "1", "--stream-every", "120",
                       "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "120"])
    assert exc.value.code == 2
    assert "--checkpoint-dir takes one seed" in capsys.readouterr().err
    assert not (tmp_path / "ck").exists()


def test_checkpoint_layout_round_trip_and_retention(tmp_path):
    """The reference's layout (step_XXXXXXXXX/MANIFEST.json, one .npy per
    leaf), restored as a path-keyed dict of exact leaves, NamedTuples and the
    generator's uint8 state included; ``keep`` prunes old steps and a
    directory without a manifest is not a checkpoint."""
    from repro_torch.checkpoint import latest_step, restore, save
    from repro_torch.samplers.mala import MALAState

    gen = torch.Generator().manual_seed(3)
    trees = {}
    for step in (16, 32, 48):
        trees[step] = {
            "state": MALAState(torch.randn(4, 3), torch.randn(4), torch.randn(4, 3)),
            "eps": torch.rand(4, 1), "rng": gen.get_state(),
        }
        torch.randn(1, generator=gen)  # a later step holds a later generator state
        save(tmp_path, step, trees[step], metadata={"t_done": step}, keep=2)
    (tmp_path / "step_000000064").mkdir()  # uncommitted: no manifest
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000032", "step_000000048", "step_000000064"]
    assert latest_step(tmp_path) == 48
    assert (tmp_path / "step_000000048" / "host_00000" / "leaf_00000.npy").exists()
    by_path, meta = restore(tmp_path)
    assert meta == {"t_done": 48}
    assert sorted(by_path) == ["eps", "rng", "state/grad", "state/log_density", "state/position"]
    for step in (32, 48):
        back, meta = restore(tmp_path, step=step)
        tree = trees[step]
        assert meta == {"t_done": step}
        for f in MALAState._fields:
            assert torch.equal(torch.from_numpy(back[f"state/{f}"]), getattr(tree["state"], f))
        assert torch.equal(torch.from_numpy(back["eps"]), tree["eps"])
        assert back["rng"].dtype == np.uint8
        assert torch.equal(torch.from_numpy(back["rng"]), tree["rng"])
    assert not torch.equal(trees[32]["rng"], trees[48]["rng"])
    with pytest.raises(FileNotFoundError):
        restore(tmp_path / "empty")
