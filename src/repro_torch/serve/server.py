"""Posterior-as-a-service: the asyncio request loop over the chunk stream.

The port of ``repro/serve/server.py``. :class:`PosteriorServer` wires three
actors around one :class:`~repro_torch.serve.state.ServeState`:

- the **sampler** runs ``Pipeline.sample(on_chunk=...)`` in an executor
  thread (the chunk-emitting driver, checkpoint subscriber and all; on the
  card its chain loops are captured CUDA graphs). Each landed chunk is
  pushed onto a *bounded* asyncio queue from the sampler thread; the push
  only blocks when the folder has fallen a full ``queue_depth`` chunks
  behind, which bounds how stale a reader's view can get;
- the **folder task** drains the queue: every chunk is folded (chunks are
  never dropped), but estimate refreshes are coalesced under backpressure:
  when more chunks are already queued, the refresh is skipped and counted in
  ``refreshes_dropped``;
- **readers** — newline-delimited-JSON TCP connections (and the in-process
  :meth:`~PosteriorServer.query`) — answer from the freshest
  :class:`~repro_torch.serve.state.EstimateSnapshot`. Handler work runs in
  the executor, so a heavy query never blocks the event loop.

Threads on one card: the sampler, the folder's folds and refreshes and the
readers' ``logpdf`` all launch on the card's default stream, in the order
their threads issue them. A chunk's draws are a tensor the chain loop does
not reuse, so a queued chunk stays as it landed while the sampler runs on.
A CUDA graph capture in the sampler thread (a restart builds the collection
loop while the replayed prefix is being folded) and any device work of the
other threads exclude each other through
:data:`~repro_torch.samplers.base.CAPTURE_LOCK`, and the kernels' launch
counts are kept per capture thread (:class:`~repro_torch.kernels.LaunchTally`),
so they stay exact. A failure in the sampler or the folder is raised from
:meth:`~PosteriorServer.wait_complete` / :meth:`~PosteriorServer.stop`, never
turned into a complete posterior.

Degradation on restart: construct the Pipeline with its ``checkpoint_dir``
and the server resumes from the last checkpoint — the stream driver re-emits
the restored prefix as ``replayed=True`` chunks, the folder rebuilds combine
state bitwise from them, and the staleness counters keep replays out of the
double-counting.

:func:`serve_pipeline` is the synchronous driver behind ``mcmc_run --serve``:
start the server, optionally hammer it with concurrent probe readers while
sampling runs, assert staleness counters monotone, and return a
latency/throughput summary (:func:`serve_session` runs the same session on a
server built by the caller).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.api.pipeline import Pipeline
from repro_torch.api.streaming import StreamChunk
from repro_torch.serve import handlers
from repro_torch.serve.state import ServeState


class PosteriorServer:
    """Serve posterior queries from a live (or resuming) sampling run.

    Lifecycle: ``await start()`` → queries via TCP or :meth:`query` →
    ``await wait_complete()`` (sampling done, final refresh folded) →
    ``await stop()``. ``refresh="every"`` disables coalescing (every fold
    refreshes — the deterministic mode tests use); the default
    ``"coalesce"`` drops refreshes under backpressure, never chunks.
    """

    def __init__(
        self,
        pipeline: Pipeline,
        names: Optional[Tuple[str, ...]] = None,
        *,
        n_estimate: int = 128,
        queue_depth: int = 8,
        host: str = "127.0.0.1",
        port: int = 0,
        refresh: str = "coalesce",
        max_steps: Optional[int] = None,
        keep_draws: bool = True,
    ):
        if pipeline.spec.stream_every <= 0:
            raise ValueError(
                "PosteriorServer needs RunSpec.stream_every > 0 — with no "
                "chunk cadence the whole run lands as one chunk and there "
                "is nothing to serve mid-stream"
            )
        if refresh not in ("coalesce", "every"):
            raise ValueError(f"refresh must be 'coalesce' or 'every', got {refresh!r}")
        if queue_depth <= 0:
            raise ValueError(f"queue_depth must be positive, got {queue_depth}")
        self.pipeline = pipeline
        self.host = host
        self.port = int(port)  # replaced by the bound port after start()
        self.refresh = refresh
        self.max_steps = max_steps
        self.state = ServeState(
            pipeline.stream_setup(names),
            spec_id=pipeline.spec.spec_id,
            seed=pipeline.spec.seed,
            total_draws=pipeline.spec.T,
            n_estimate=n_estimate,
            keep_draws=keep_draws,
        )
        self._queue_depth = int(queue_depth)
        self._queue: Optional[asyncio.Queue] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._tcp: Optional[asyncio.base_events.Server] = None
        self._folder: Optional[asyncio.Task] = None
        self._sampler: Optional[asyncio.Future] = None
        self._complete = asyncio.Event()
        self._folder_error: Optional[BaseException] = None
        self.sample_s: Optional[float] = None  # sampler wall time (throughput)
        self.fold_s: List[float] = []  # host seconds of each chunk's fold
        self.refresh_s: List[float] = []  # seconds of each refresh (ends on the host)

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._queue = asyncio.Queue(maxsize=self._queue_depth)
        self._tcp = await asyncio.start_server(self._handle_conn, self.host, self.port)
        self.port = self._tcp.sockets[0].getsockname()[1]
        self._folder = asyncio.create_task(self._fold_loop())
        self._sampler = self._loop.run_in_executor(None, self._run_sampler)

    async def wait_complete(self) -> None:
        """Block until sampling finished AND the folder drained the queue
        (including the final refresh); raises what made the folder stop."""
        await self._complete.wait()
        if self._folder_error is not None:
            raise RuntimeError("the posterior server's folder failed") from self._folder_error

    async def stop(self) -> None:
        """Wait for the sampler and the folder, close the listener; raises a
        failure of either."""
        try:
            if self._sampler is not None:
                await self._sampler  # the executor thread cannot be cancelled
            if self._folder is not None:
                await self._complete.wait()
                self._folder.cancel()
                try:
                    await self._folder
                except asyncio.CancelledError:
                    pass
        finally:
            if self._tcp is not None:
                self._tcp.close()
                await self._tcp.wait_closed()
        if self._folder_error is not None:
            raise RuntimeError("the posterior server's folder failed") from self._folder_error

    # -- sampler thread → queue (backpressure boundary) ----------------------

    def _put(self, item) -> None:
        """Push from the sampler thread; block while the queue is full, and
        give up (raising) if the folder has failed meanwhile."""
        fut = asyncio.run_coroutine_threadsafe(self._queue.put(item), self._loop)
        while True:
            try:
                return fut.result(timeout=0.5)
            except concurrent.futures.TimeoutError:
                if self._folder_error is not None:
                    fut.cancel()
                    raise RuntimeError("the folder failed; sampling stops") from None

    def _run_sampler(self) -> None:
        t0 = time.monotonic()
        try:
            self.pipeline.sample(max_steps=self.max_steps, on_chunk=(self._enqueue_chunk,))
        finally:
            self.sample_s = time.monotonic() - t0
            if self._folder_error is None:
                self._put(None)

    def _enqueue_chunk(self, ev: StreamChunk) -> None:
        # runs on the sampler thread: block only when the folder is a full
        # queue_depth of chunks behind — the server's staleness horizon
        self._put(ev)

    # -- folder task ---------------------------------------------------------

    def _fold(self, ev: StreamChunk) -> None:
        t0 = time.perf_counter()
        self.state.fold(ev)
        self.fold_s.append(time.perf_counter() - t0)

    def _refresh(self) -> None:
        t0 = time.perf_counter()
        self.state.refresh()
        self.refresh_s.append(time.perf_counter() - t0)

    async def _fold_loop(self) -> None:
        try:
            while True:
                ev = await self._queue.get()
                if ev is None:  # sampler done (this session)
                    # final refresh: readers see the completed (or budgeted)
                    # posterior even if every mid-stream refresh was coalesced
                    await self._loop.run_in_executor(None, self._refresh)
                    self._complete.set()
                    self._queue.task_done()
                    continue
                await self._loop.run_in_executor(None, self._fold, ev)
                if self.refresh == "every" or self._queue.empty():
                    await self._loop.run_in_executor(None, self._refresh)
                else:
                    self.state.note_dropped_refresh()
                self._queue.task_done()
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # surfaced by wait_complete()/stop()
            self._folder_error = exc
            self._complete.set()
            raise

    # -- readers -------------------------------------------------------------

    async def query(self, op: str, **params: Any) -> Dict[str, Any]:
        """In-process reader: same handlers, same staleness contract."""
        req = {"op": op, **params}
        return await self._loop.run_in_executor(None, handlers.answer, self.state, req)

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    req = json.loads(line)
                    if not isinstance(req, dict):
                        raise ValueError("request must be a JSON object")
                except ValueError as exc:
                    resp: Dict[str, Any] = {
                        "ok": False,
                        "error": {"code": 400, "reason": f"bad request: {exc}"},
                        "staleness": self.state.staleness(),
                    }
                else:
                    resp = await self._loop.run_in_executor(
                        None, handlers.answer, self.state, req
                    )
                writer.write(json.dumps(resp).encode() + b"\n")
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError, asyncio.CancelledError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass


# ---------------------------------------------------------------------------
# synchronous driver (mcmc_run --serve)
# ---------------------------------------------------------------------------


def _percentile(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return float("nan")
    i = min(len(sorted_vals) - 1, int(round(p * (len(sorted_vals) - 1))))
    return sorted_vals[i]


PROBE_OPS: Tuple[Dict[str, Any], ...] = (
    {"op": "mean_cov"},
    {"op": "quantiles"},
    {"op": "draws", "n": 8},
    {"op": "status"},
)


def serve_session(
    server: PosteriorServer,
    *,
    probe_readers: int = 0,
    probe_logpdf: bool = True,
    probe_interval_s: float = 0.0,
    log=print,
) -> Dict[str, Any]:
    """Run one serving session of ``server`` synchronously; return the
    summary :func:`serve_pipeline` returns (see there)."""
    from repro_torch.serve.client import ServeClient

    ops = list(PROBE_OPS)
    if probe_logpdf:
        d = server.pipeline._model.d
        ops.append({"op": "logpdf", "points": [[0.0] * d]})

    async def _probe(latencies: List[float], errors: List[str], idx: int) -> int:
        client = await ServeClient.connect(server.host, server.port)
        served = 0
        last = (-1, -1)  # (chunks_folded, draws_seen) must be monotone
        try:
            while not server._complete.is_set():
                req = ops[(served + idx) % len(ops)]
                t0 = time.monotonic()
                resp = await client.request(**req)
                latencies.append(time.monotonic() - t0)
                served += 1
                st = resp.get("staleness", {})
                seen = (st.get("chunks_folded", 0), st.get("draws_seen", 0))
                if seen < last:
                    raise AssertionError(f"staleness went backwards: {last} -> {seen}")
                last = seen
                if not resp.get("ok") and resp.get("error", {}).get("code") != 503:
                    errors.append(str(resp.get("error")))
                if probe_interval_s > 0:
                    await asyncio.sleep(probe_interval_s)
        finally:
            await client.close()
        return served

    async def _main() -> Dict[str, Any]:
        await server.start()
        log(f"serve: listening on {server.host}:{server.port} "
            f"(combiners: {', '.join(server.state.setup.names)})")
        latencies: List[float] = []
        errors: List[str] = []
        probes = [asyncio.create_task(_probe(latencies, errors, i))
                  for i in range(probe_readers)]
        try:
            await server.wait_complete()
            served = sum(await asyncio.gather(*probes)) if probes else 0
            # one last full round against the completed posterior
            final = {str(req["op"]): await server.query(**req) for req in ops}
            staleness = server.state.staleness(server.state.setup.names[0])
        finally:
            for task in probes:
                task.cancel()
            await asyncio.gather(*probes, return_exceptions=True)
            await server.stop()
        lat = sorted(latencies)
        return {
            "port": server.port,
            "queries": served + len(ops),
            "reader_p50_s": _percentile(lat, 0.50),
            "reader_p99_s": _percentile(lat, 0.99),
            "sample_s": server.sample_s,
            "staleness": staleness,
            "probe_errors": errors,
            "final": final,
        }

    summary = asyncio.run(_main())
    if summary["probe_errors"]:
        raise RuntimeError(f"serve probe saw non-503 errors: {summary['probe_errors'][:3]}")
    st = summary["staleness"]
    log(
        f"serve: {summary['queries']} queries answered "
        f"(p50 {summary['reader_p50_s'] * 1e3:.1f} ms, "
        f"p99 {summary['reader_p99_s'] * 1e3:.1f} ms) while folding "
        f"{st['chunks_folded']} chunks / {st['draws_seen']} draws "
        f"(replayed {st['chunks_replayed']}, "
        f"refreshes dropped {st['refreshes_dropped']}, "
        f"complete={st['complete']})"
    )
    return summary


def serve_pipeline(
    pipeline: Pipeline,
    *,
    names: Optional[Tuple[str, ...]] = None,
    port: int = 0,
    probe_readers: int = 0,
    n_estimate: int = 128,
    queue_depth: int = 8,
    refresh: str = "coalesce",
    max_steps: Optional[int] = None,
    probe_logpdf: bool = True,
    probe_interval_s: float = 0.0,
    log=print,
) -> Dict[str, Any]:
    """Run a full serving session synchronously and return a summary.

    Starts a :class:`PosteriorServer` for ``pipeline``, optionally spawns
    ``probe_readers`` concurrent TCP readers that cycle posterior queries
    for as long as sampling runs (every reader asserts the staleness
    counters it observes are monotone), waits for completion, and returns
    ``{"port", "queries", "reader_p50_s", "reader_p99_s", "sample_s",
    "staleness", "probe_errors", "final"}``. ``probe_interval_s > 0`` paces
    each reader to one request per interval instead of a closed loop.
    """
    server = PosteriorServer(
        pipeline, names, n_estimate=n_estimate, queue_depth=queue_depth,
        port=port, refresh=refresh, max_steps=max_steps,
    )
    return serve_session(server, probe_readers=probe_readers, probe_logpdf=probe_logpdf,
                         probe_interval_s=probe_interval_s, log=log)
