"""repro_torch.serve: posterior-as-a-service on the port's chunk stream.

The thirteen contracts of ``tests/test_serve.py`` within the port, at its
``SPEC`` (linear, M = 4, T = 60, ``stream_every=20``): the state's folds are
``stream_combine``'s engine (refreshed estimates score bitwise as the
trajectory rows), restart from a checkpoint rebuilds bitwise with replayed
chunks counted apart, the query surface's answers and typed 503/400s, and
the asyncio server end to end over TCP. Then the port against ``repro``:
``answer`` of both packages on the same host snapshot and draw buffer (a
stub state each), the staleness keys and ``serve_pipeline``'s summary keys,
and the CLI's ``--serve`` on the CPU.
"""

import asyncio
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.serve as rserve
from repro.api.streaming import StreamChunk as RStreamChunk
from repro.core.combiners import EstimateUnavailable as REstimateUnavailable
from repro_torch.api import Pipeline, RunSpec
from repro_torch.api.pipeline import resolve_metric
from repro_torch.api.streaming import StreamChunk
from repro_torch.core.combiners import EstimateUnavailable
from repro_torch.serve import (
    PosteriorServer,
    ServeClient,
    ServeError,
    ServeState,
    answer,
    serve_pipeline,
)
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

SPEC = RunSpec(
    model="linear", M=4, T=60, warmup=30, n=512, seed=3,
    groundtruth_T=120, combiner=("parametric", "pool", "online"),
    score_metric="logl2", stream_every=20,
)
CPU = "cpu"


def _pipe(spec, **kw):
    return Pipeline(spec, device=CPU, **kw)


def _serve_state(pipe, names=None, **kw):
    kw.setdefault("n_estimate", 32)
    return ServeState(
        pipe.stream_setup(names), spec_id=pipe.spec.spec_id, seed=pipe.spec.seed,
        total_draws=pipe.spec.T, **kw,
    )


def _folding_subscriber(state):
    """fold + refresh every chunk — the deterministic (refresh='every')
    folder the bitwise tests drive without an event loop."""

    def on_chunk(ev):
        state.fold(ev)
        state.refresh()

    return on_chunk


# ---------------------------------------------------------------------------
# state: the deterministic core
# ---------------------------------------------------------------------------


def test_serve_state_estimates_are_stream_combine_rows():
    """An estimate refreshed at boundary t scores exactly as the
    stream_combine trajectory row at t: same streaming state, same
    generator, bitwise the same draw cloud."""
    spec = dataclasses.replace(SPEC, combiner=("parametric", "pool"))
    pipe = _pipe(spec)
    state = _serve_state(pipe, track_history=True)
    pipe.sample(on_chunk=(_folding_subscriber(state),))

    ref_pipe = _pipe(spec)
    sr = ref_pipe.stream_combine(n_estimate=32, fused=False)
    gt = ref_pipe.groundtruth()
    dist, _ = resolve_metric(spec, ref_pipe._model.d)

    by_row = {(t, name): samples for t, name, samples in state.history}
    assert len(by_row) == len(sr.trajectory)
    for row in sr.trajectory:
        served = by_row[(row["t"], row["combiner"])]
        assert float(dist(gt, torch.from_numpy(served))) == row["error"], (row["t"],
                                                                            row["combiner"])


def test_serve_state_staleness_counters():
    pipe = _pipe(SPEC)
    state = _serve_state(pipe)
    seen = []

    def on_chunk(ev):
        state.fold(ev)
        seen.append(dict(state.staleness("parametric")))

    pipe.sample(on_chunk=(on_chunk,))
    state.refresh()

    assert [s["draws_seen"] for s in seen] == [20, 40, 60]
    assert [s["chunks_folded"] for s in seen] == [1, 2, 3]
    assert all(s["chunks_replayed"] == 0 for s in seen)
    assert not seen[0]["complete"] and seen[-1]["complete"]
    stamps = [s["last_fold_monotonic_s"] for s in seen]
    assert stamps == sorted(stamps)  # honest per-chunk landed clock
    final = state.staleness("parametric")
    assert final["spec_id"] == SPEC.spec_id
    assert final["estimate_draws_seen"] == 60
    assert final["estimate_age_draws"] == 0


def test_serve_restart_from_checkpoint_is_bitwise(tmp_path):
    """Kill the serving fold mid-stream, restart from the checkpoint dir:
    replayed chunks are marked, counted separately, never double-folded, and
    every post-restart estimate is bitwise the uninterrupted run's."""
    spec = dataclasses.replace(SPEC, combiner=("parametric", "pool", "online"))

    ref_pipe = _pipe(spec, checkpoint_dir=tmp_path / "ref", checkpoint_every=20)
    ref = _serve_state(ref_pipe, track_history=True)
    ref_pipe.sample(on_chunk=(_folding_subscriber(ref),))
    assert ref.staleness()["complete"]

    p1 = _pipe(spec, checkpoint_dir=tmp_path / "run", checkpoint_every=20)
    s1 = _serve_state(p1, track_history=True)
    p1.sample(max_steps=20, on_chunk=(_folding_subscriber(s1),))
    st1 = s1.staleness()
    assert st1["draws_seen"] == 20 and not st1["complete"]

    p2 = _pipe(spec, checkpoint_dir=tmp_path / "run", checkpoint_every=20)
    s2 = _serve_state(p2, track_history=True)
    p2.sample(on_chunk=(_folding_subscriber(s2),))

    st2 = s2.staleness()
    assert st2["complete"] and st2["draws_seen"] == spec.T
    assert st2["chunks_replayed"] == 1  # the restored 1-chunk prefix
    assert st2["chunks_folded"] == spec.T // spec.stream_every  # no double-fold
    assert [(t, n) for t, n, _ in s2.history] == [(t, n) for t, n, _ in ref.history]
    for (t, name, got), (_, _, want) in zip(s2.history, ref.history):
        np.testing.assert_array_equal(got, want, err_msg=f"{name}@{t}")
    for name in spec.combiner_names():
        np.testing.assert_array_equal(s2.snapshot(name).samples, ref.snapshot(name).samples,
                                      err_msg=name)


# ---------------------------------------------------------------------------
# handlers: the query surface
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def folded_state():
    spec = dataclasses.replace(SPEC, combiner=("parametric", "pool", "consensus"))
    pipe = _pipe(spec)
    state = _serve_state(pipe)
    pipe.sample(on_chunk=(_folding_subscriber(state),))
    return state


def test_answer_mean_cov_quantiles_draws(folded_state):
    d = folded_state.snapshot("parametric").samples.shape[1]
    for name in ("parametric", "pool"):
        r = answer(folded_state, {"op": "mean_cov", "combiner": name})
        assert r["ok"], r
        assert len(r["result"]["mean"]) == d
        assert len(r["result"]["cov"]) == d and len(r["result"]["cov"][0]) == d
        assert r["staleness"]["draws_seen"] == SPEC.T
        assert r["staleness"]["spec_id"] == folded_state.spec_id

    q = answer(folded_state, {"op": "quantiles", "probs": [0.1, 0.5, 0.9]})
    assert q["ok"] and np.asarray(q["result"]["quantiles"]).shape == (3, d)
    lo, med, hi = np.asarray(q["result"]["quantiles"])
    assert np.all(lo <= med) and np.all(med <= hi)

    d1 = answer(folded_state, {"op": "draws", "n": 5, "seed": 7})
    d2 = answer(folded_state, {"op": "draws", "n": 5, "seed": 7})
    assert d1["result"]["draws"] == d2["result"]["draws"]  # deterministic
    assert np.asarray(d1["result"]["draws"]).shape == (5, d)
    assert answer(folded_state, {"op": "predictive", "n": 3})["ok"]  # an alias


def test_answer_logpdf_matches_direct_scoring(folded_state):
    from repro_torch.core.combiners import counts_or_full
    from repro_torch.core.combiners.density import machine_kde_scores, masked_silverman

    snap = folded_state.snapshot("parametric")
    pts = [snap.mean.tolist(), (snap.mean + 1.0).tolist()]
    r = answer(folded_state, {"op": "logpdf", "points": pts})
    assert r["ok"], r
    got = np.asarray(r["result"]["log_density"])
    assert got.shape == (2,) and np.all(np.isfinite(got))
    assert got[0] > got[1]  # the posterior mean outscores an offset point

    theta, counts = folded_state.logpdf_inputs()
    h = masked_silverman(theta, counts_or_full(theta, counts))
    want = machine_kde_scores(torch.tensor(pts, dtype=torch.float32), theta, counts, h,
                              reduce="product")
    np.testing.assert_array_equal(got, want.numpy())
    assert r["result"]["normalized"] is False


def test_answer_maps_estimate_unavailable_to_503(folded_state):
    r = answer(folded_state, {"op": "mean_cov", "combiner": "consensus"})
    assert not r["ok"]
    assert r["error"]["code"] == 503
    assert "estimate" in r["error"]["reason"]
    assert r["staleness"]["draws_seen"] == SPEC.T  # 503s still say where we are


def test_answer_rejects_malformed_requests(folded_state):
    assert answer(folded_state, {"op": "nope"})["error"]["code"] == 400
    assert answer(folded_state, {"op": "mean_cov", "combiner": "no_such"})["error"]["code"] == 400
    assert answer(folded_state, {"op": "logpdf"})["error"]["code"] == 400
    assert answer(folded_state, {"op": "quantiles", "probs": [1.5]})["error"]["code"] == 400
    assert answer(folded_state, {"op": "draws", "n": 0})["error"]["code"] == 400


def test_answer_before_any_fold_is_503_with_position():
    state = _serve_state(_pipe(SPEC))
    r = answer(state, {"op": "mean_cov"})
    assert not r["ok"] and r["error"]["code"] == 503
    assert r["staleness"]["draws_seen"] == 0 and not r["staleness"]["complete"]
    assert answer(state, {"op": "status"})["ok"]  # status needs no estimate


def test_serve_state_typed_unavailability():
    state = _serve_state(_pipe(dataclasses.replace(SPEC, combiner=("consensus",))),
                         keep_draws=False)
    with pytest.raises(EstimateUnavailable):
        state.snapshot("consensus")
    with pytest.raises(EstimateUnavailable, match="keep_draws"):
        state.logpdf_inputs()
    with pytest.raises(KeyError, match="not served"):
        state.snapshot("parametric")


# ---------------------------------------------------------------------------
# server: the asyncio loop
# ---------------------------------------------------------------------------


def test_server_concurrent_queries_during_sampling():
    """All four posterior query types answered over TCP while the chains
    extend, staleness on every response and monotone per connection."""
    spec = dataclasses.replace(SPEC, combiner=("parametric", "online"))

    async def main():
        server = PosteriorServer(_pipe(spec), refresh="every", queue_depth=2)
        await server.start()

        async def reader(idx):
            client = await ServeClient.connect(server.host, server.port)
            ops = (
                {"op": "mean_cov", "combiner": "online"},
                {"op": "quantiles"},
                {"op": "draws", "n": 4},
                {"op": "logpdf", "points": [[0.0] * 10]},
            )
            last, answered = (-1, -1), 0
            try:
                while not server._complete.is_set():
                    resp = await client.request(**ops[(answered + idx) % len(ops)])
                    st = resp["staleness"]
                    now = (st["chunks_folded"], st["draws_seen"])
                    assert now >= last, (last, now)
                    last = now
                    if resp["ok"]:
                        answered += 1
                    else:
                        assert resp["error"]["code"] == 503, resp
            finally:
                await client.close()
            return answered

        readers = [asyncio.create_task(reader(i)) for i in range(6)]
        await server.wait_complete()
        answered = sum(await asyncio.gather(*readers))
        for op in ("mean_cov", "quantiles", "draws", "logpdf", "status"):
            params = {"points": [[0.0] * 10]} if op == "logpdf" else {}
            resp = await server.query(op, **params)
            assert resp["ok"], resp
            assert resp["staleness"]["complete"]
        st = server.state.staleness()
        await server.stop()
        return answered, st

    answered, st = asyncio.run(main())
    assert st["chunks_folded"] == spec.T // spec.stream_every  # never dropped
    assert st["draws_seen"] == spec.T and st["complete"]
    assert answered >= 0  # mid-stream answers are timing-dependent; 503s ok


def test_serve_pipeline_summary_and_backpressure():
    """The sync driver: probes assert monotone staleness internally; chunks
    are never dropped even at queue_depth=1 with refresh coalescing; the
    final snapshot is fresh."""
    spec = dataclasses.replace(SPEC, combiner=("parametric",))
    summary = serve_pipeline(_pipe(spec), probe_readers=3, queue_depth=1,
                             probe_logpdf=True, log=lambda *_: None)
    st = summary["staleness"]
    assert st["chunks_folded"] == spec.T // spec.stream_every
    assert st["draws_seen"] == spec.T and st["complete"]
    assert st["refreshes_dropped"] >= 0
    assert st["estimate_draws_seen"] == spec.T  # final refresh always lands
    assert summary["queries"] > 0
    assert summary["probe_errors"] == []
    for op in ("mean_cov", "quantiles", "draws", "status", "logpdf"):
        assert summary["final"][op]["ok"], op


def test_server_requires_stream_cadence_and_valid_options():
    with pytest.raises(ValueError, match="stream_every"):
        PosteriorServer(_pipe(dataclasses.replace(SPEC, stream_every=0)))
    with pytest.raises(ValueError, match="refresh"):
        PosteriorServer(_pipe(SPEC), refresh="sometimes")
    with pytest.raises(ValueError, match="queue_depth"):
        PosteriorServer(_pipe(SPEC), queue_depth=0)


def test_client_ask_raises_typed_serve_error():
    spec = dataclasses.replace(SPEC, combiner=("parametric", "consensus"))

    async def main():
        server = PosteriorServer(_pipe(spec), refresh="every")
        await server.start()
        await server.wait_complete()
        client = await ServeClient.connect(server.host, server.port)
        try:
            result = await client.ask("mean_cov", combiner="parametric")
            assert len(result["mean"]) == 10
            with pytest.raises(ServeError) as exc:
                await client.ask("mean_cov", combiner="consensus")
            assert exc.value.code == 503
            assert exc.value.staleness["complete"]
        finally:
            await client.close()
            await server.stop()

    asyncio.run(main())


def test_server_raises_a_folder_failure_instead_of_completing():
    """A fault in the folder (here a fold that raises) reaches the caller of
    serve_pipeline; the session never reports a complete posterior."""
    pipe = _pipe(SPEC)
    server = PosteriorServer(pipe, queue_depth=1)

    def broken(ev):
        raise RuntimeError("fold failed")

    server.state.fold = broken
    from repro_torch.serve import serve_session

    with pytest.raises(RuntimeError, match="folder"):
        serve_session(server, probe_readers=1, log=lambda *_: None)
    assert not server.state.staleness()["complete"]


# ---------------------------------------------------------------------------
# the port against repro
# ---------------------------------------------------------------------------


D = 3
SNAP_SAMPLES = np.random.default_rng(11).normal(size=(32, D)).astype(np.float32)
BUFFER = (0.3 * np.random.default_rng(12).normal(size=(4, 60, D))).astype(np.float32)


class _Stub:
    """What the handlers read of a state: ``setup.names``, ``snapshot``,
    ``logpdf_inputs``, ``staleness`` (and the port's logpdf counter), on one
    host snapshot and one draw buffer, in either package's types."""

    def __init__(self, unavailable, to_array, snapshot_cls):
        self.setup = types.SimpleNamespace(names=("parametric", "consensus"))
        self.n_estimate = SNAP_SAMPLES.shape[0]
        self._unavailable, self._to_array = unavailable, to_array
        self._snap = snapshot_cls(
            samples=SNAP_SAMPLES, mean=SNAP_SAMPLES.mean(axis=0),
            cov=np.cov(SNAP_SAMPLES, rowvar=False).reshape(D, D), draws_seen=60,
            refreshed_monotonic_s=1.0,
        )

    def snapshot(self, name):
        if name not in self.setup.names:
            raise KeyError(f"combiner {name!r} not served")
        if name == "consensus":
            raise self._unavailable(name, "no cheap mid-stream estimate")
        return self._snap

    def logpdf_inputs(self):
        return self._to_array(BUFFER), None

    def staleness(self, name=None):
        return {"draws_seen": 60, "combiner": name}

    def note_logpdf(self):
        pass


def _stubs():
    from repro.serve.state import EstimateSnapshot as RSnap
    from repro_torch.serve import EstimateSnapshot

    return (_Stub(EstimateUnavailable, torch.from_numpy, EstimateSnapshot),
            _Stub(REstimateUnavailable, jnp.asarray, RSnap))


EXACT_REQUESTS = [
    {"op": "mean_cov"},
    {"op": "mean_cov", "combiner": "consensus"},
    {"op": "quantiles"},
    {"op": "quantiles", "probs": [0.0, 0.3, 1.0], "combiner": "parametric"},
    {"op": "draws", "n": 5, "seed": 7},
    {"op": "predictive", "n": 40, "seed": 2, "id": 9},
    {"op": "status"},
    {"op": "nope"},
    {"op": "mean_cov", "combiner": "no_such"},
    {"op": "quantiles", "probs": [1.5]},
    {"op": "draws", "n": 0},
    {"op": "logpdf"},
    {"op": "logpdf", "points": [[0.0, 1.0]]},
    {"op": "logpdf", "points": [[[0.0]]]},
    {"op": "logpdf", "points": [[0.0] * D], "reduce": "sum"},
]


@pytest.mark.parametrize("request_", EXACT_REQUESTS, ids=lambda r: "-".join(map(str, r.values())))
def test_answer_matches_reference_exactly(request_):
    """mean_cov, quantiles, draws and status answers and the 400/503 codes:
    the same numpy code on the same host snapshot, so identical responses."""
    port_stub, ref_stub = _stubs()
    got, want = answer(port_stub, dict(request_)), rserve.answer(ref_stub, dict(request_))
    if not want["ok"]:  # the reasons' wording comes from each package's checks
        assert got["error"]["code"] == want["error"]["code"]
        got, want = ({k: v for k, v in r.items() if k != "error"} for r in (got, want))
    assert got == want


@pytest.mark.parametrize("reduce", ["product", "mixture"])
@pytest.mark.parametrize("n_points", [1, 7])
def test_answer_logpdf_matches_reference(reduce, n_points):
    """logpdf on the same buffer and points: within tests/test_torch_kde.py's
    tolerance (rtol 1e-5, atol 5e-4: float32 sums in another order)."""
    port_stub, ref_stub = _stubs()
    pts = (BUFFER.reshape(-1, D)[:: 37][:n_points] + 0.05).tolist()
    req = {"op": "logpdf", "points": pts, "reduce": reduce}
    got, want = answer(port_stub, dict(req)), rserve.answer(ref_stub, dict(req))
    assert got["ok"] and want["ok"]
    np.testing.assert_allclose(got["result"]["log_density"], want["result"]["log_density"],
                               rtol=1e-5, atol=5e-4)
    assert {k: v for k, v in got["result"].items() if k != "log_density"} == \
        {k: v for k, v in want["result"].items() if k != "log_density"}


def test_staleness_keys_match_reference():
    """The same keys, no more and no fewer, before a fold and after a fold
    and refresh, with and without a combiner named."""
    theta = 0.3 * np.random.default_rng(5).normal(size=(SPEC.M, 20, 10)).astype(np.float32)
    ref_pipe = rapi.Pipeline(rapi.RunSpec(**SPEC.to_dict()))
    ref = rserve.ServeState(ref_pipe.stream_setup(("parametric",)), spec_id=SPEC.spec_id,
                            total_draws=SPEC.T, n_estimate=8)
    port = _serve_state(_pipe(SPEC), ("parametric",), n_estimate=8)
    before = [(sorted(ref.staleness(n)), sorted(port.staleness(n))) for n in (None, "parametric")]
    ref.fold(RStreamChunk(jnp.asarray(theta), jnp.zeros(SPEC.M), 0, 20, SPEC.T, {}))
    port.fold(StreamChunk(torch.from_numpy(theta), torch.zeros(SPEC.M), 0, 20, SPEC.T, {}))
    ref.refresh()
    port.refresh()
    after = [(sorted(ref.staleness(n)), sorted(port.staleness(n))) for n in (None, "parametric")]
    for want, got in before + after:
        assert got == want
    assert "estimate_age_draws" in after[1][0]


def test_serve_pipeline_summary_keys_match_reference():
    spec = dataclasses.replace(SPEC, T=40, combiner=("parametric",))
    got = serve_pipeline(_pipe(spec), probe_readers=1, log=lambda *_: None)
    want = rserve.serve_pipeline(rapi.Pipeline(rapi.RunSpec(**spec.to_dict())),
                                 probe_readers=1, log=lambda *_: None)
    assert sorted(got) == sorted(want)
    assert sorted(got["staleness"]) == sorted(want["staleness"])
    assert sorted(got["final"]) == sorted(want["final"])


def test_mcmc_run_serve_cli_on_cpu(capsys):
    """``mcmc_run --serve --serve-readers 2 --device cpu`` at a small spec:
    the server's summary line, then the scoreboard over the served draws."""
    import json

    from repro_torch.launch import mcmc_run

    assert mcmc_run.main(["--device", "cpu", "--model", "linear", "--n", "1000",
                          "--combiner", "parametric", "pool", "--stream-every", "300",
                          "--serve", "--serve-readers", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    served = [line for line in out if line.startswith("serve: ") and "queries answered" in line]
    assert served and "complete=True" in served[0] and "folding 4 chunks / 1200 draws" in served[0]
    board = json.loads(out[-1])
    assert board["backend"] == "batched[cpu,chunked]"
    assert set(board["errors"]) == {"parametric", "pool"}
    assert all(np.isfinite(v) for v in board["errors"].values())
    with pytest.raises(SystemExit):
        mcmc_run.main(["--device", "cpu", "--serve"])  # no cadence
