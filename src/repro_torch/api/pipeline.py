"""Staged execution of one :class:`RunSpec`: partition → sample → combine → score.

The port of the batch stages of ``repro/api/pipeline.py``:

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
"""

from __future__ import annotations

import hashlib
import math
import time
import zlib
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.api.sampling import groundtruth_chain, sample_subposteriors
from repro_torch.api.spec import RunSpec
from repro_torch.core import metrics
from repro_torch.core.combiners import CombineResult, filter_options, get_combiner
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


def groundtruth_step_size(spec: RunSpec) -> float:
    """Full-chain step compensation: warmup absorbs it for adaptive kernels;
    fixed-step ones take ε/√M."""
    sp = sampler_spec(spec.resolved_sampler())
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

    theta: torch.Tensor  # (M, T, d)
    accept: torch.Tensor  # (M,)
    counts: torch.Tensor  # (M,)
    backend: str


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
    """

    def __init__(
        self,
        spec: RunSpec,
        *,
        data: Optional[Tuple[Data, torch.Tensor]] = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.spec = spec.validate()
        if spec.stream_every or spec.mesh_shape is not None:
            raise NotImplementedError(
                "repro_torch runs the batch pipeline on one device; "
                "stream_every and mesh_shape are not ported yet"
            )
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
        if theta_true.shape[-1] != self._model.d:
            raise ValueError(f"theta_true has d={theta_true.shape[-1]}, model d={self._model.d}")

    def _stream(self, stage: str) -> torch.Generator:
        return stream_generator(self.spec.seed, stage, self.device)

    def _timed(self, stage: str, t0: float) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings[stage] = time.perf_counter() - t0

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

    def sample(self) -> SubposteriorDraws:
        if self._draws is None:
            spec = self.spec
            sharded = self.partition()
            t0 = time.perf_counter()
            res = sample_subposteriors(
                self._stream("sample"), self._model, sharded.data, spec.M, spec.T,
                sampler=spec.sampler, warmup=spec.warmup,
                burn_in=spec.resolved_burn_in(), step_size=spec.step_size,
                sampler_options=spec.sampler_options,
                shards=sharded.shards, counts=sharded.counts,
            )
            self._timed("sample_s", t0)
            self._draws = SubposteriorDraws(res.theta, res.accept, res.counts, res.backend)
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
                sampler_options=spec.sampler_options,
            )
            self._timed("groundtruth_s", t0)
        return self._groundtruth

    def combine(self) -> Dict[str, CombineResult]:
        if self._combined is None:
            theta = self.sample().theta
            t0 = time.perf_counter()
            self._combined = combine_spec_draws(self.spec, theta)
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
                collectives_checked=None,
                timings=dict(self.timings),
            )
        return self._board

    def run(self) -> Scoreboard:
        """All stages."""
        return self.score()
