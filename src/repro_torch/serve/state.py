"""Deterministic serving state: per-combiner folds + staleness accounting.

The port of ``repro/serve/state.py``. :class:`ServeState` is the synchronous
core of the posterior server: it folds
:class:`~repro_torch.api.streaming.StreamChunk` events into per-combiner
:class:`~repro_torch.core.combiners.api.StreamingCombiner` state and
refreshes cheap ``estimate`` snapshots that readers answer from. It is built
on a :class:`~repro_torch.api.pipeline.StreamSetup` (the same resolved
combiners and merged options ``Pipeline.stream_combine`` uses) and refreshes
from :func:`~repro_torch.api.pipeline.estimate_generator` at the draw
boundary, the trajectory's generator, so an estimate refreshed at boundary
``t`` is **bitwise** the estimate ``stream_combine`` (subscriber path) records
at ``t``.

Snapshots are host numpy (the samples, their mean and ``np.cov``), taken
once a refresh, so the ``mean_cov``, ``quantiles`` and ``draws`` queries
never touch the device; only ``logpdf`` does, on the shared draw buffer.

Device work from several threads: the folder's folds and refreshes and the
readers' ``logpdf`` may run while the sampler thread captures a chain loop
(on a restart, the replayed prefix is folded while the collection loop is
built), and a capture fails if another thread launches meanwhile. Each of
them holds :data:`~repro_torch.samplers.base.CAPTURE_LOCK` around its
device work.

Staleness model (Terenin et al., *Asynchronous Gibbs Sampling*): readers may
consume stale combine state without a barrier, provided every response says
how stale it is. :meth:`ServeState.staleness` is that contract:
``chunks_folded`` / ``draws_seen`` / ``last_fold_monotonic_s`` on every
response, with replayed (post-restart) chunks counted separately and never
double-folded (``draws_seen`` tracks the stream position ``t1``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.pipeline import StreamSetup, estimate_generator
from repro_torch.api.streaming import StreamChunk
from repro_torch.core.combiners import (
    BufferState,
    EstimateUnavailable,
    buffer_append,
    buffer_batch_args,
    buffer_init,
    filter_options,
    streaming_estimate,
)
from repro_torch.samplers.base import CAPTURE_LOCK


class EstimateSnapshot(NamedTuple):
    """One refreshed posterior estimate, host-resident (what readers see).

    ``samples`` is the ``(n_estimate, d)`` draw cloud the handlers reduce;
    ``draws_seen`` is the stream position the estimate reflects.
    """

    samples: np.ndarray  # (n_estimate, d)
    mean: np.ndarray  # (d,)
    cov: np.ndarray  # (d, d)
    draws_seen: int  # stream position (t1) this estimate reflects
    refreshed_monotonic_s: float


class ServeState:
    """Fold chunks, refresh estimates, answer staleness — thread-safe.

    ``fold`` is called by exactly one folder; ``snapshot`` / ``staleness`` /
    ``logpdf_inputs`` may be called concurrently from reader threads. One
    lock guards the counters and the snapshot map. ``seed`` is the spec's
    (the refresh generators derive from it); ``keep_draws=False`` drops the
    shared draw buffer (no log-density queries); ``track_history=True``
    records every refreshed estimate.
    """

    def __init__(
        self,
        setup: StreamSetup,
        *,
        spec_id: str,
        seed: int,
        total_draws: int,
        n_estimate: int = 128,
        keep_draws: bool = True,
        track_history: bool = False,
    ):
        self.setup = setup
        self.spec_id = spec_id
        self.seed = int(seed)
        self.device = next(iter(setup.generators.values())).device
        self.total_draws = int(total_draws)
        self.n_estimate = int(n_estimate)
        self.keep_draws = keep_draws
        self.track_history = track_history
        self.history: List[Tuple[int, str, np.ndarray]] = []
        self.refreshes = 0  # refresh calls that estimated (the folder's device work)
        self.logpdf_answered = 0  # logpdf queries scored (one KDE launch each)

        self._lock = threading.Lock()
        self._states: Dict[str, Any] = {name: None for name in setup.names}
        self._buffer: Optional[BufferState] = None
        self._snapshots: Dict[str, EstimateSnapshot] = {}
        self._chunks_folded = 0
        self._chunks_replayed = 0
        self._draws_seen = 0
        self._last_fold_monotonic_s: Optional[float] = None
        self._refreshes_dropped = 0

    # -- folding (one writer) ------------------------------------------------

    def fold(self, ev: StreamChunk) -> None:
        """Fold one landed chunk into every combiner state (+ draw buffer).

        Replayed chunks fold too (that is how post-restart state is rebuilt
        bitwise), but ``draws_seen`` is the stream position ``ev.t1``, so
        replays never double-count; they are tallied in ``chunks_replayed``.
        """
        M, _, d = ev.theta.shape
        with CAPTURE_LOCK:
            for name in self.setup.names:
                sc = self.setup.combiners[name]
                if self._states[name] is None:
                    self._states[name] = sc.init(M, d, device=ev.theta.device)
                self._states[name] = sc.update(self._states[name], ev.theta)
            if self.keep_draws:
                if self._buffer is None:
                    self._buffer = buffer_init(M, d, device=ev.theta.device)
                self._buffer = buffer_append(self._buffer, ev.theta)
        landed = ev.landed_s if ev.landed_s is not None else time.monotonic()
        with self._lock:
            self._chunks_folded += 1
            if ev.replayed:
                self._chunks_replayed += 1
            self._draws_seen = int(ev.t1)
            self._last_fold_monotonic_s = landed

    def refresh(self, names: Optional[Tuple[str, ...]] = None) -> None:
        """Recompute the snapshot for each named combiner (default: all that
        can), from the trajectory's generator at ``draws_seen``, so refreshed
        estimates are bitwise ``stream_combine``'s rows at the same boundary.
        Names without a cheap ``estimate`` are skipped (queries on them raise
        the typed failure instead)."""
        with self._lock:
            t1 = self._draws_seen
        if t1 <= 0:
            return
        for name in names if names is not None else self.setup.names:
            est_fn = self.setup.combiners[name].estimate
            if est_fn is None:
                continue
            with CAPTURE_LOCK:
                est = est_fn(
                    estimate_generator(self.seed, self.device, name, t1), self._states[name],
                    self.n_estimate, **filter_options(est_fn, self.setup.options),
                )
                samples = est.samples.cpu().numpy()
            snap = EstimateSnapshot(
                samples=samples,
                mean=samples.mean(axis=0),
                cov=np.cov(samples, rowvar=False).reshape(samples.shape[1], samples.shape[1]),
                draws_seen=t1,
                refreshed_monotonic_s=time.monotonic(),
            )
            with self._lock:
                self._snapshots[name] = snap
            if self.track_history:
                self.history.append((t1, name, samples))
        with self._lock:
            self.refreshes += 1

    def note_dropped_refresh(self) -> None:
        """Backpressure accounting: the folder skipped a refresh because
        chunks were queued behind it (chunks are never dropped)."""
        with self._lock:
            self._refreshes_dropped += 1

    # -- reading (many readers) ----------------------------------------------

    def snapshot(self, name: str) -> EstimateSnapshot:
        """The freshest estimate for ``name``; raises the typed
        :class:`EstimateUnavailable` when the combiner cannot estimate or
        nothing has been folded/refreshed yet."""
        if name not in self.setup.names:
            raise KeyError(f"combiner {name!r} not served; serving: {self.setup.names}")
        streaming_estimate(name)  # typed EstimateUnavailable for finalize-only
        with self._lock:
            snap = self._snapshots.get(name)
        if snap is None:
            raise EstimateUnavailable(name, "no estimate refreshed yet — no chunks have landed")
        return snap

    def logpdf_inputs(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(theta, counts)`` of the shared draw buffer for KDE scoring
        (``counts=None`` when dense, the batch combiners' convention). Reads
        ``counts`` on the host: call it holding ``CAPTURE_LOCK``."""
        buffer = self._buffer
        if not self.keep_draws or buffer is None:
            raise EstimateUnavailable(
                "logpdf",
                "no draw buffer — nothing folded yet" if self.keep_draws
                else "server started with keep_draws=False",
            )
        return buffer_batch_args(buffer)

    def note_logpdf(self) -> None:
        with self._lock:
            self.logpdf_answered += 1

    def staleness(self, name: Optional[str] = None) -> Dict[str, Any]:
        """The metadata every response carries (see module docstring)."""
        with self._lock:
            out: Dict[str, Any] = {
                "spec_id": self.spec_id,
                "chunks_folded": self._chunks_folded,
                "chunks_replayed": self._chunks_replayed,
                "draws_seen": self._draws_seen,
                "total_draws": self.total_draws,
                "complete": self._draws_seen >= self.total_draws,
                "last_fold_monotonic_s": self._last_fold_monotonic_s,
                "refreshes_dropped": self._refreshes_dropped,
            }
            snap = self._snapshots.get(name) if name is not None else None
        if name is not None:
            out["combiner"] = name
            if snap is not None:
                out["estimate_draws_seen"] = snap.draws_seen
                out["estimate_age_draws"] = out["draws_seen"] - snap.draws_seen
        return out
