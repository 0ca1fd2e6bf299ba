"""Staged, resumable execution of one :class:`RunSpec`: partition → sample → combine → score.

The port of ``repro/api/pipeline.py``:

    ``partition()   -> ShardedData``              (M shards + valid-row counts)
    ``sample()      -> SubposteriorDraws``        ((M, T, d) θ + acceptance)
    ``groundtruth() -> (groundtruth_T, d)``       (one full-data chain)
    ``combine()     -> dict[str, CombineResult]`` (one per requested combiner)
    ``score()       -> Scoreboard``               (distance to the groundtruth)

Stages are lazy and cached; ``Pipeline(spec).run()`` is the whole paper.
RNG discipline, as in the reference: independent streams for the data, the
sampling stage, the groundtruth chain, and each combiner (keyed by the crc32
of its name, so a combiner's result does not depend on which others run).
Each stream is a :class:`torch.Generator` seeded from ``(seed, stage,
crc32)``. Stage times end with a device synchronisation.

With ``spec.stream_every > 0``, a ``checkpoint_dir`` or ``on_chunk``
subscribers, the sampling stage runs the chunk-emitting driver of
:mod:`repro_torch.api.streaming` (the same draws, bitwise, as the one-shot
stage), and :meth:`Pipeline.stream_combine` combines while sampling: it
folds every chunk into the streaming combiners, records a per-chunk
trajectory, and finalizes results that are bitwise the batch combine's for
the buffered combiners.
"""

from __future__ import annotations

import hashlib
import math
import time
import zlib
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.api.backends import resolve_mesh_devices
from repro_torch.api.sampling import groundtruth_chain, sample_subposteriors
from repro_torch.api.spec import RunSpec
from repro_torch.api.streaming import (
    StreamChunk,
    chunk_boundaries,
    fused_fold,
    record_event,
    stream_sample,
    synchronize,
    wait_for,
)
from repro_torch.core import metrics
from repro_torch.core.combiners import (
    BufferState,
    CombineResult,
    StreamingCombiner,
    filter_options,
    get_combiner,
    get_scan_face,
    get_streaming_combiner,
)
from repro_torch.core.subposterior import partition_data
from repro_torch.models.bayes import get_model
from repro_torch.samplers import sampler_spec

Data = Dict[str, torch.Tensor]

# models at or above this θ-dimension are scored in log space (raw L2
# overflows float32 there)
LOG_L2_DIM = 40
COMBINE_DEFAULTS = {"rescale": True, "n_batch": 1}


def stream_generator(
    seed: int, stage: str, device: torch.device, name: Optional[str] = None
) -> torch.Generator:
    """The generator of one RNG stream: ``(seed, stage[, crc32(name)])``."""
    tag = f"{seed}/{stage}" + ("" if name is None else f"/{zlib.crc32(name.encode())}")
    s = int.from_bytes(hashlib.sha256(tag.encode()).digest()[:8], "little") >> 1
    return torch.Generator(device=device).manual_seed(s)


def estimate_generator(
    seed: int, device: torch.device, name: str, t: int
) -> torch.Generator:
    """The generator of ``name``'s trajectory estimate at draw ``t``: the
    same in the fused and the subscriber stream."""
    return stream_generator(seed, f"combine@{t}", device, name)


def groundtruth_step_size(spec: RunSpec) -> float:
    """Full-chain step compensation. The full posterior is ~√M narrower than
    a subposterior and its gradient M× larger: warmup absorbs that for
    adaptive kernels; fixed-step ones take ε/M for Langevin time steps
    (``sgld``) and ε/√M for proposal scales."""
    sp = sampler_spec(spec.resolved_sampler())
    if sp.name == "sgld":
        return spec.step_size / spec.M
    if not (sp.adaptive and spec.warmup > 0):
        return spec.step_size / math.sqrt(spec.M)
    return spec.step_size


def combine_spec_draws(
    spec: RunSpec,
    theta: torch.Tensor,
    names: Optional[Tuple[str, ...]] = None,
) -> Dict[str, CombineResult]:
    """The combine stage for one spec: one independent stream per combiner;
    ``spec.combiner_options`` over the driver defaults, filtered per combiner."""
    options = dict(COMBINE_DEFAULTS, **dict(spec.combiner_options))
    out: Dict[str, CombineResult] = {}
    for name in names if names is not None else spec.combiner_names():
        fn = get_combiner(name)
        gen = stream_generator(spec.seed, "combine", theta.device, name)
        out[name] = fn(gen, theta, spec.T, **filter_options(fn, options))
    return out


def resolve_metric(spec: RunSpec, d: int):
    """``(distance_fn, label)``: ``score_metric`` override or the dimension rule."""
    use_log = spec.score_metric == "logl2" or (
        spec.score_metric == "auto" and d >= LOG_L2_DIM
    )
    if use_log:
        return metrics.log_l2_distance, "logL2"
    return metrics.l2_distance, "L2"


class ShardedData(NamedTuple):
    """Partition-stage artifact: the paper's M "machines" worth of data."""

    shards: Data  # per-datum leaves carry a leading (M, ...) axis
    counts: torch.Tensor  # (M,) real rows per shard
    data: Data  # the full dataset (groundtruth input)
    theta_true: torch.Tensor


class SubposteriorDraws(NamedTuple):
    """Sampling-stage artifact: M independent subposterior chains."""

    theta: torch.Tensor  # (M, t_done, d)
    accept: torch.Tensor  # (M,)
    counts: torch.Tensor  # (M,)
    backend: str  # a repro_torch.api.backends.BackendId string
    # operators the chain-group check watched on a mesh (None: one device)
    collectives_checked: Optional[int]
    t_done: int  # draws collected so far (== T unless interrupted)
    complete: bool


class StreamResult(NamedTuple):
    """Artifact of :meth:`Pipeline.stream_combine` (combine-while-sampling).

    ``trajectory`` rows are ``{"t", "combiner", "error", "elapsed_s"}``: one
    per (chunk boundary, combiner with an ``estimate``), in landing order;
    ``elapsed_s`` is the wall time since the stream started, read once that
    row's estimate exists on the device (monotone in landing order). On the
    fused path the estimates come out of one fold, so consecutive stamps may
    be close together. ``combined`` holds the finalized results (empty while
    ``complete`` is False).
    """

    combined: Dict[str, CombineResult]
    trajectory: List[Dict[str, Any]]
    t_done: int
    total: int
    complete: bool
    metric: str  # "L2" | "logL2" | "" when unscored
    stream_every: int
    n_estimate: int


class StreamSetup(NamedTuple):
    """Resolved combine-while-sampling surfaces for one stream consumer: the
    streaming combiners, one fresh generator per name from the batch combine
    stage's streams (so stream finals are the batch results), and the merged
    options."""

    names: Tuple[str, ...]
    combiners: Dict[str, StreamingCombiner]
    generators: Dict[str, torch.Generator]
    options: Dict[str, Any]


class Scoreboard(NamedTuple):
    """Score-stage artifact: the paper's error table for one scenario."""

    spec_id: str
    model: str
    sampler: str
    M: int
    T: int
    metric: str  # "L2" | "logL2"
    errors: Dict[str, float]
    accept: float
    backend: str
    collectives_checked: Optional[int]
    timings: Dict[str, float]  # stage -> seconds

    def table(self) -> str:
        lines = [
            f"model={self.model} M={self.M} T={self.T} sampler={self.sampler} "
            f"acc={self.accept:.2f} backend={self.backend}"
        ]
        for name, err in sorted(self.errors.items(), key=lambda kv: kv[1]):
            lines.append(f"  {self.metric}({name:15s}) = {err:.4f}")
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._asdict())


class Pipeline:
    """Run one :class:`RunSpec` stage by stage (see module docstring).

    ``device``: ``cuda`` unless given (raises without a card). ``data``: a
    ``(data, theta_true)`` pair as ``generate_data`` returns it, e.g. from
    :func:`repro_torch.interop.from_reference_data`, in place of generating
    one from the seed; it must lie on ``device`` and hold the spec's n rows.
    ``checkpoint_dir`` / ``checkpoint_every``: persist the sampling stage
    every ``checkpoint_every`` draws (0: at the end) and resume it from there.

    Devices: ``spec.mesh_shape = (ndata, 1)`` with ndata > 1 splits the chains
    into ndata groups, one on each of ``devices`` (default: one CUDA device a
    group; an explicit list may name a device twice), through
    :class:`~repro_torch.api.backends.MeshChunkBackend`: the same draws as
    the batched run, bit for bit. ``(ndata, nmodel)`` takes ndata × nmodel
    devices, each group replicated over its model row (a Bayes θ has nothing
    to shard; :func:`~repro_torch.api.backends.resolve_mesh_devices`): the
    (ndata, 1) mesh's draws. ``(1, 1)`` is the batched backend. With no
    ``mesh_shape``, more than one visible CUDA device and M divisible by
    their count, the chains are split over all of them. One host thread
    queues every group's transitions, so while a transition's host work
    outweighs its device work (the paper's cells on an H100), n groups take
    about n times one group's sampling time.
    """

    def __init__(
        self,
        spec: RunSpec,
        *,
        data: Optional[Tuple[Data, torch.Tensor]] = None,
        device: str | torch.device | None = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        devices: Optional[Sequence] = None,
    ):
        self.device = resolve_device(device)
        self.spec = spec.validate()
        mesh_shape = spec.mesh_shape
        if mesh_shape is None and devices is None and self.device.type == "cuda":
            count = torch.cuda.device_count()
            if count > 1 and spec.M % count == 0:
                mesh_shape = (count, 1)  # the automatic mesh
        if mesh_shape is not None and mesh_shape[0] > 1:
            self.devices = resolve_mesh_devices(mesh_shape, devices, self.device, spec.M)
            # one device a chain group (a model row's first): the chains' mesh
            self.mesh_shape: Optional[Tuple[int, ...]] = (int(mesh_shape[0]), 1)
        elif devices is not None:
            raise ValueError("devices= places chain groups: it needs a spec whose mesh_shape "
                             "has a data axis above 1")
        else:
            self.mesh_shape, self.devices = None, None
        self.checkpoint_dir = str(checkpoint_dir) if checkpoint_dir else None
        if checkpoint_every > 0 and self.checkpoint_dir is None:
            raise ValueError(
                "checkpoint_every > 0 without a checkpoint_dir would persist nothing; "
                "pass checkpoint_dir (or drop the cadence)"
            )
        self.checkpoint_every = checkpoint_every
        self._model = get_model(spec.model)
        if data is not None:
            self._check_data(data)
        self._data = data
        self.timings: Dict[str, float] = {}
        self._sharded: Optional[ShardedData] = None
        self._draws: Optional[SubposteriorDraws] = None
        self._groundtruth: Optional[torch.Tensor] = None
        self._combined: Optional[Dict[str, CombineResult]] = None
        self._board: Optional[Scoreboard] = None

    def _check_data(self, data) -> None:
        leaves, theta_true = data
        n = self.spec.resolved_n()
        for k, v in leaves.items():
            if v.device.type != self.device.type:
                raise ValueError(f"data[{k!r}] is on {v.device}, the pipeline on {self.device}")
        keys = self._model.shard_keys or tuple(leaves)
        if leaves[keys[0]].shape[0] != n:
            raise ValueError(
                f"data has {leaves[keys[0]].shape[0]} rows, the spec asks for n={n}"
            )
        if theta_true.numel() != self._model.d:  # gmm's is the (K, 2) means
            raise ValueError(
                f"theta_true has {theta_true.numel()} entries, model d={self._model.d}")

    def _stream(self, stage: str) -> torch.Generator:
        return stream_generator(self.spec.seed, stage, self.device)

    def _timed(self, stage: str, t0: float, *, add: bool = False) -> None:
        synchronize(self.device)
        self.timings[stage] = (self.timings.get(stage, 0.0) if add else 0.0) + (
            time.perf_counter() - t0
        )

    def partition(self) -> ShardedData:
        if self._sharded is None:
            t0 = time.perf_counter()
            model, spec = self._model, self.spec
            if self._data is None:
                self._data = model.generate_data(self._stream("data"), spec.resolved_n())
            data, theta_true = self._data
            shards, counts = partition_data(data, spec.M, only=model.shard_keys, pad=True)
            self._sharded = ShardedData(shards, counts, data, theta_true)
            self._timed("partition_s", t0)
        return self._sharded

    def sample(
        self,
        max_steps: Optional[int] = None,
        on_chunk: Sequence[Callable[[StreamChunk], None]] = (),
    ) -> SubposteriorDraws:
        """Run (or resume) the M subposterior chains.

        With no cadence, checkpoint or subscriber: one batch of T draws
        (``batched[<device>]``, or ``mesh[<device>](n devices)`` on a mesh).
        Otherwise the chunk stream of
        :func:`~repro_torch.api.streaming.stream_sample` (on the mesh's
        groups when there is one): ``max_steps``
        bounds the draws of this call (checkpointed runs only; a partial
        artifact has ``complete=False`` and the next call continues), and
        ``on_chunk`` subscribers see every landed chunk in order, restored
        prefixes included.
        """
        if self._draws is not None and self._draws.complete:
            return self._draws
        spec = self.spec
        if max_steps is not None and self.checkpoint_dir is None:
            raise ValueError(
                "max_steps needs a checkpoint_dir: a partial sampling stage is only "
                "useful if it can be resumed"
            )
        sharded = self.partition()
        t0 = time.perf_counter()
        common = dict(
            sampler=spec.sampler, warmup=spec.warmup, burn_in=spec.resolved_burn_in(),
            step_size=spec.step_size, sgld_batch=spec.sgld_batch,
            sampler_options=spec.sampler_options, shards=sharded.shards, counts=sharded.counts,
            mesh_shape=self.mesh_shape, devices=self.devices,
        )
        if spec.stream_every > 0 or self.checkpoint_dir is not None or on_chunk:
            ss = stream_sample(
                self._stream("sample"), self._model, sharded.data, spec.M, spec.T,
                chunk_size=spec.stream_every, max_steps=max_steps,
                checkpoint_dir=self.checkpoint_dir, checkpoint_every=self.checkpoint_every,
                spec_id=spec.spec_id, on_chunk=on_chunk, **common,
            )
            res, t_done = ss.result, ss.t_done
        else:
            res = sample_subposteriors(
                self._stream("sample"), self._model, sharded.data, spec.M, spec.T, **common
            )
            t_done = spec.T
        self._timed("sample_s", t0, add=True)
        self._draws = SubposteriorDraws(
            res.theta, res.accept, res.counts, res.backend, res.collectives_checked, t_done,
            t_done >= spec.T,
        )
        return self._draws

    def groundtruth(self) -> torch.Tensor:
        """Long full-data chain at the compensated step size."""
        if self._groundtruth is None:
            spec = self.spec
            data = self.partition().data
            t0 = time.perf_counter()
            self._groundtruth = groundtruth_chain(
                self._stream("groundtruth"), self._model, data, spec.groundtruth_T,
                sampler=spec.sampler, warmup=spec.warmup,
                burn_in=spec.groundtruth_T // 6, step_size=groundtruth_step_size(spec),
                sgld_batch=spec.sgld_batch, sampler_options=spec.sampler_options,
            )
            self._timed("groundtruth_s", t0)
        return self._groundtruth

    # -- combine-while-sampling ------------------------------------------------

    def stream_setup(self, names: Optional[Tuple[str, ...]] = None) -> StreamSetup:
        """The streaming surfaces for ``names`` (default: the spec's
        combiners); fails fast on unknown names."""
        spec = self.spec
        names = spec.combiner_names() if names is None else tuple(names)
        scs = {name: get_streaming_combiner(name) for name in names}
        gens = {
            name: stream_generator(spec.seed, "combine", self.device, name) for name in names
        }
        options = dict(COMBINE_DEFAULTS, **dict(spec.combiner_options))
        return StreamSetup(names, scs, gens, options)

    def stream_combine(
        self,
        names: Optional[Tuple[str, ...]] = None,
        *,
        n_estimate: int = 128,
        max_steps: Optional[int] = None,
        score: bool = True,
        fused: Optional[bool] = None,
    ) -> StreamResult:
        """Fold each landed sampling chunk into the streaming combiners.

        Needs ``spec.stream_every > 0``. At every chunk boundary each
        combiner with an ``estimate`` gives ``n_estimate`` draws (the
        trajectory); the buffered fallbacks fold every chunk but only
        finalize. When sampling completes, each state is finalized with the
        batch combine stage's generator and options, so the finals are
        bitwise the batch results for the buffered combiners and within
        merge rounding for ``online``; :meth:`score` then reuses them.

        ``fused``: ``None`` (default) fuses when every combiner has a scan
        face and nothing needs the host between chunks (no checkpoint, no
        ``max_steps``): the chains run all T draws with no host
        synchronisation, then :func:`~repro_torch.api.streaming.fused_fold` folds the scan faces
        over the draws (``online``'s through the ``online_update`` kernel).
        ``False`` forces the subscriber path; ``True`` raises when the run
        needs it. The two paths draw the same θ and give bitwise the same
        finals for the buffered combiners.

        ``score=False`` skips the groundtruth chain and leaves trajectory
        errors ``None``; ``max_steps`` bounds this session (checkpointed runs;
        a later call replays the restored prefix and reproduces the
        uninterrupted trajectory).
        """
        spec = self.spec
        if spec.stream_every <= 0:
            raise ValueError(
                "stream_combine needs RunSpec.stream_every > 0: with no chunk cadence "
                "there is nothing to fold mid-run (set e.g. stream_every=T//10, or use "
                "combine())"
            )
        setup = self.stream_setup(names)
        names, scs, options = setup.names, setup.combiners, setup.options
        faces = {name: get_scan_face(name) for name in names}
        can_fuse = (
            fused is not False
            and self.checkpoint_dir is None
            and max_steps is None
            and all(faces[name] is not None for name in names)
        )
        if fused is True and not can_fuse:
            blockers = [n for n in names if faces[n] is None]
            raise ValueError(
                "fused=True but this run needs the subscriber path: "
                + (f"combiners without a scan face: {blockers}" if blockers
                   else "checkpointing/max_steps need per-chunk host subscribers")
            )
        if can_fuse:
            return self._stream_combine_fused(setup, faces, n_estimate, score)

        states: Dict[str, Any] = {name: None for name in names}
        rows: List[Dict[str, Any]] = []
        estimates: List[torch.Tensor] = []
        t_start = time.perf_counter()

        def fold(ev: StreamChunk) -> None:
            M, _, d = ev.theta.shape
            for name in names:
                if states[name] is None:
                    states[name] = scs[name].init(M, d, device=ev.theta.device)
                states[name] = scs[name].update(states[name], ev.theta)
            for name in names:
                est_fn = scs[name].estimate
                if est_fn is None:
                    continue  # no cheap mid-stream estimate: finalize only
                est = est_fn(
                    estimate_generator(spec.seed, self.device, name, ev.t1), states[name],
                    n_estimate, **filter_options(est_fn, options),
                )
                synchronize(self.device)  # an honest elapsed_s
                estimates.append(est.samples)
                rows.append({"t": ev.t1, "combiner": name, "error": None,
                             "elapsed_s": time.perf_counter() - t_start})

        if self._draws is not None and self._draws.complete:
            # sampling already ran: replay the cached draws at the cadence
            theta = self._draws.theta
            zeros = torch.zeros((spec.M,), dtype=torch.float32, device=self.device)
            for r0 in range(0, spec.T, spec.stream_every):
                r1 = min(r0 + spec.stream_every, spec.T)
                fold(StreamChunk(theta[:, r0:r1].contiguous(), zeros, r0, r1, spec.T, {},
                                 replayed=True))
            draws = self._draws
        else:
            draws = self.sample(max_steps=max_steps, on_chunk=(fold,))

        final: Dict[str, CombineResult] = {}
        if draws.complete:
            t0 = time.perf_counter()
            for name in names:
                fn = scs[name].finalize
                final[name] = fn(setup.generators[name], states[name], spec.T,
                                 **filter_options(fn, options))
            self._finish_stream(names, final, t0)
        return self._stream_result(final, rows, estimates, draws, n_estimate, score)

    def _stream_combine_fused(
        self, setup: StreamSetup, faces: Dict[str, Any], n_estimate: int, score: bool
    ) -> StreamResult:
        """The fused mode of :meth:`stream_combine`: the chains in one chunk
        of T (the plain stage's path: the same θ), then one fold of every scan
        face over the device-resident draws.

        Rows land for the combiners the subscriber path would estimate, in
        its order and from its generators: from the fold for faces with an
        ``estimate`` (``parametric``, ``online``), from the host estimate on
        the buffered prefix for the rest (``pool``, ``nonparametric``, ...).
        """
        spec = self.spec
        names, scs, options = setup.names, setup.combiners, setup.options
        t_start = time.perf_counter()
        draws = self.sample()
        theta = draws.theta
        t0 = time.perf_counter()
        boundaries = chunk_boundaries(spec.T, spec.stream_every)
        est_gens = {
            name: [estimate_generator(spec.seed, self.device, name, t1) for t1 in boundaries]
            for name in names
            if faces[name].estimate is not None and scs[name].estimate is not None
        }
        ff = fused_fold(theta, {n: faces[n] for n in names}, est_gens, n_estimate,
                        spec.stream_every, options)

        rows: List[Dict[str, Any]] = []
        estimates: List[torch.Tensor] = []
        ready = []
        for i, t1 in enumerate(ff.boundaries):
            for name in names:
                est_fn = scs[name].estimate
                if est_fn is None:
                    continue  # no row on the subscriber path either
                if name in est_gens:
                    samples, event = ff.est_draws[name][i], ff.ready[i]
                else:
                    prefix = BufferState(
                        theta[:, :t1].contiguous(),
                        torch.full((spec.M,), t1, dtype=torch.int32, device=self.device),
                    )
                    samples = est_fn(
                        estimate_generator(spec.seed, self.device, name, t1), prefix,
                        n_estimate, **filter_options(est_fn, options),
                    ).samples
                    event = record_event(self.device)
                estimates.append(samples)
                ready.append(event)
                rows.append({"t": t1, "combiner": name, "error": None, "elapsed_s": None})
        # each row is stamped once the device has run the work queued up to
        # its estimate: the row's own availability instant
        for row, event in zip(rows, ready):
            wait_for(event)
            row["elapsed_s"] = time.perf_counter() - t_start

        counts_T = torch.full((spec.M,), spec.T, dtype=torch.int32, device=self.device)
        final: Dict[str, CombineResult] = {}
        for name in names:
            fn = scs[name].finalize
            host_state = faces[name].to_state(ff.states[name], theta, counts_T)
            final[name] = fn(setup.generators[name], host_state, spec.T,
                             **filter_options(fn, options))
        self._finish_stream(names, final, t0)
        return self._stream_result(final, rows, estimates, draws, n_estimate, score)

    def _finish_stream(self, names, final: Dict[str, CombineResult], t0: float) -> None:
        """Time the stream's combine work; the finals are the combine stage's
        results when the stream covered the spec's combiners."""
        self._timed("stream_combine_s", t0)
        if self._combined is None and set(names) == set(self.spec.combiner_names()):
            self._combined = dict(final)
            self.timings.setdefault("combine_s", self.timings["stream_combine_s"])

    def _stream_result(self, final, rows, estimates, draws, n_estimate, score) -> StreamResult:
        label = ""
        if score:
            gt = self.groundtruth()
            dist, label = resolve_metric(self.spec, self._model.d)
            for row, samples in zip(rows, estimates):
                row["error"] = float(dist(gt, samples))
        return StreamResult(
            combined=final, trajectory=rows, t_done=draws.t_done, total=self.spec.T,
            complete=draws.complete, metric=label, stream_every=self.spec.stream_every,
            n_estimate=n_estimate,
        )

    # -- combine ---------------------------------------------------------------

    def combine(self) -> Dict[str, CombineResult]:
        if self._combined is None:
            draws = self.sample()
            if not draws.complete:
                raise RuntimeError(
                    f"sampling stage incomplete ({draws.t_done}/{self.spec.T} draws): "
                    "call sample() until complete before combine()"
                )
            t0 = time.perf_counter()
            self._combined = combine_spec_draws(self.spec, draws.theta)
            self._timed("combine_s", t0)
        return self._combined

    def score(self) -> Scoreboard:
        if self._board is None:
            spec = self.spec
            combined = self.combine()
            gt = self.groundtruth()
            t0 = time.perf_counter()
            dist, label = resolve_metric(spec, self._model.d)
            errors = {name: float(dist(gt, res.samples)) for name, res in combined.items()}
            self._timed("score_s", t0)
            draws = self._draws
            self._board = Scoreboard(
                spec_id=spec.spec_id,
                model=spec.model,
                sampler=spec.resolved_sampler(),
                M=spec.M,
                T=spec.T,
                metric=label,
                errors=errors,
                accept=float(draws.accept.mean()),
                backend=draws.backend,
                collectives_checked=draws.collectives_checked,
                timings=dict(self.timings),
            )
        return self._board

    def run(self) -> Scoreboard:
        """All stages."""
        return self.score()


def combine_draws(
    gen: torch.Generator,
    samples: torch.Tensor,
    n_draws: int,
    *,
    combiner: str = "nonparametric",
    **options,
) -> CombineResult:
    """Registry-dispatched combination of a dense ``(M, T, d)`` stack, for
    callers that already hold subposterior draws: the combine stage's
    backend (:func:`repro_torch.distributed.epmcmc.combine_gathered`)."""
    from repro_torch.distributed.epmcmc import combine_gathered

    return combine_gathered(gen, samples, n_draws, combiner=combiner, **options)
