"""The one chunk-emitting sampling driver of the port, and the fused fold.

The port of ``repro/api/streaming.py``, on one device or on the chain
groups of a mesh (``mesh_shape``; chunks and checkpoints leave the groups
through the backend's ``localize``, a restored carry returns to them through
``put_carry``). One generator
(:meth:`ShardChainStream.chunks`) advances all M chains in global chunks and
yields each landed ``(M, C, d)`` slice; everything else subscribes:
checkpoint persistence (:mod:`repro_torch.api.resumable`), combine-while-
sampling (``Pipeline.stream_combine``), and the plain sampling stage.

Bitwise resume rests on three things, as in the reference: the chains draw
from one :class:`torch.Generator` in the same order whatever the chunking
(so chunked, fused and one-shot runs give the same draws); chunk boundaries
are global multiples of the cadence; and a checkpoint carries the
generator's state, so a resumed run continues the same random stream.

Fused mode: when nobody subscribes (no checkpoint, no ``on_chunk``, no
budget) the chains run the whole T in one go
(:meth:`ShardChainStream.fused_sample`), with no host synchronisation, and
:func:`fused_fold` then folds the requested combiners' scan faces chunk by
chunk over the device-resident draws. The subscriber loop synchronises the device
before it stamps each chunk's ``landed_s``. On the card the chains' loop
replays one captured CUDA graph of the transition (the backend keeps it
across chunks); capturing the fold loop is later work.
"""

from __future__ import annotations

import importlib
import time
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.api.backends import (
    CHUNKED,
    FUSED,
    RESUMABLE,
    BatchedChunkBackend,
    MeshChunkBackend,
    resolve_mesh_devices,
    slice_backend,
)
from repro_torch.api.sampling import SampleResult, is_padded, make_shard_kernel
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.core.subposterior import partition_data
from repro_torch.models.bayes import BayesModel
from repro_torch.utils.options import filter_kwargs

Carry = Dict[str, Any]


class StreamChunk(NamedTuple):
    """One landed chunk of subposterior draws (what subscribers consume).

    On a resumed run the restored prefix is emitted again with
    ``replayed=True``: ``theta``/``t0``/``t1`` are faithful, but ``carry``
    holds the restored (latest) state and ``accept`` is zeros. ``landed_s``
    is the ``time.monotonic()`` instant of emission, after the device has
    finished the chunk; metadata, not part of the bitwise-resume contract.
    """

    theta: torch.Tensor  # (M, C, d)
    accept: torch.Tensor  # (M,) accepted count in the chunk (zeros if replayed)
    t0: int
    t1: int
    total: int
    carry: Carry
    replayed: bool = False
    landed_s: Optional[float] = None


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for off the card)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def chunk_boundaries(total: int, chunk: int) -> tuple:
    """The global draw indices a run of ``total`` draws lands at in chunks of
    ``chunk``: every multiple of ``chunk`` below ``total``, then ``total``."""
    return tuple(range(chunk, total, chunk)) + (total,)


def record_event(device: torch.device) -> Optional["torch.cuda.Event"]:
    """A CUDA event recorded now on the current stream (None off the card):
    ``wait_for`` it to know that the work queued so far has run."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def wait_for(event: Optional["torch.cuda.Event"]) -> None:
    if event is not None:
        event.synchronize()


class ShardChainStream:
    """M parallel subposterior chains, advanced in global chunks.

    ``gen`` is the sampling stage's generator; every chunk draws from it in
    the one-shot driver's order. ``chains = (lo, hi)`` drives only those
    chains of the M, drawing what the whole run draws for them (a launch's
    rank: :func:`~repro_torch.api.backends.slice_backend`).
    """

    def __init__(
        self,
        gen: torch.Generator,
        model: BayesModel,
        num_shards: int,
        num_samples: int,
        *,
        sampler: Optional[str] = None,
        warmup: int = 200,
        burn_in: int = 0,
        step_size: float = 0.1,
        sgld_batch: int = 256,
        sampler_options=(),
        shards,
        counts: torch.Tensor,
        use_counts: bool,
        mesh_shape: Optional[Sequence[int]] = None,
        devices: Optional[Sequence] = None,
        chains: Optional[Tuple[int, int]] = None,
    ):
        self.gen = gen
        self.model = model
        self.num_shards = num_shards
        self.num_samples = num_samples
        sk = make_shard_kernel(
            model, num_shards, sampler or model.default_sampler, sgld_batch=sgld_batch,
            use_counts=use_counts, sampler_options=sampler_options,
        )
        options = dict(burn_in=burn_in, warmup=warmup, step_size=step_size)
        if mesh_shape is not None and int(mesh_shape[0]) > 1:
            if chains is not None:
                raise ValueError("chains= drives one slice of the chains on one device; a "
                                 "mesh splits them all")
            self.backend = MeshChunkBackend(
                sk, model, shards, counts,
                devices=resolve_mesh_devices(mesh_shape, devices, counts.device, num_shards),
                **options)
        elif chains is not None:
            self.backend = slice_backend(sk, model, shards, counts, *chains, **options)
        else:
            self.backend = BatchedChunkBackend(sk, shards, counts, **options)
        self.device = counts.device
        self.n_chains = self.backend.n_chains

    def fresh_carry(self) -> Carry:
        """Setup (init, warmup, burn-in) and the empty draw buffer."""
        state, eps = self.backend.setup(self.gen)
        return {
            "state": state,
            "eps": eps,
            "theta": torch.zeros((self.n_chains, 0, self.model.d), dtype=torch.float32,
                                 device=self.device),
            "accept_sum": torch.zeros((self.n_chains,), dtype=torch.float32,
                                      device=self.device),
            "rng": self.gen.get_state(),
        }

    def fused_sample(self):
        """The whole run with no host synchronisation (setup and one chunk of
        T): ``(theta (M, T, d), accept_sum (M,))``."""
        return self.backend.run_fused(self.gen, self.num_samples)

    def chunks(
        self, carry: Carry, t_done: int, chunk_size: int, stop: Optional[int] = None
    ) -> Iterator[StreamChunk]:
        """Yield whole chunks from ``t_done`` until ``stop`` (default T).

        Boundaries are global multiples of ``chunk_size`` (and the final T),
        so where a session starts changes no chunk. A ``stop`` that a whole
        chunk would overshoot ends the iteration early.
        """
        T = self.num_samples
        chunk = chunk_size if chunk_size > 0 else T
        stop = T if stop is None else min(stop, T)
        while t_done < stop:
            t1 = min(t_done + chunk, T)
            if t1 > stop:
                break  # a ragged chunk here would shift the later boundaries
            state, theta_c, acc_c = self.backend.next_chunk(
                self.gen, carry["eps"], carry["state"], t1 - t_done
            )
            # chunks leave the backend's layout (the mesh's groups) first
            theta_c, acc_c = self.backend.localize(theta_c), self.backend.localize(acc_c)
            carry = {
                "state": state,
                "eps": carry["eps"],
                "theta": torch.cat([carry["theta"], theta_c], dim=1),
                "accept_sum": carry["accept_sum"] + acc_c,
                "rng": self.gen.get_state(),
            }
            t0, t_done = t_done, t1
            synchronize(self.device)  # an honest landed_s: the draws exist
            yield StreamChunk(theta_c, acc_c, t0, t1, T, carry, landed_s=time.monotonic())


class StreamedSample(NamedTuple):
    """Outcome of :func:`stream_sample`."""

    result: SampleResult
    t_done: int
    total: int
    resumed_from: int  # 0 on a fresh run, else the restored draw count

    @property
    def complete(self) -> bool:
        return self.t_done >= self.total


def _state_type(state):
    """The NamedTuple classes of a chain state, nested as the state is:
    ``{"type": "module:Class", "fields": {field: <the same> | None}}``."""
    cls = type(state)
    return {"type": f"{cls.__module__}:{cls.__qualname__}",
            "fields": {f: (_state_type(v) if hasattr(v, "_fields") else None)
                       for f, v in zip(cls._fields, state)}}


def _rebuild_state(spec, leaves, path: str, put):
    """The chain state saved under ``path``, rebuilt from its classes' spec."""
    module, name = spec["type"].split(":")
    cls = getattr(importlib.import_module(module), name)
    return cls(*(put(leaves[f"{path}/{f}"]) if sub is None
                 else _rebuild_state(sub, leaves, f"{path}/{f}", put)
                 for f, sub in spec["fields"].items()))


def _restore_carry(checkpoint_dir, step: int, device: torch.device):
    """The carry of a checkpoint, on ``device``, and its metadata."""
    leaves, meta = restore(checkpoint_dir, step=step)

    def put(a):
        return torch.from_numpy(a).to(device)

    carry = {
        "state": _rebuild_state(meta["state_type"], leaves, "state", put),
        "eps": put(leaves["eps"]),
        "theta": put(leaves["theta"]),
        "accept_sum": put(leaves["accept_sum"]),
        "rng": torch.from_numpy(leaves["rng"]),
    }
    return carry, meta


def stream_sample(
    gen: torch.Generator,
    model: BayesModel,
    data,
    num_shards: int,
    num_samples: int,
    *,
    sampler: Optional[str] = None,
    warmup: int = 200,
    burn_in: int = 0,
    step_size: float = 0.1,
    sgld_batch: int = 256,
    sampler_options=(),
    shards=None,
    counts: Optional[torch.Tensor] = None,
    chunk_size: int = 0,
    max_steps: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    spec_id: str = "",
    on_chunk: Sequence[Callable[[StreamChunk], None]] = (),
    mesh_shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence] = None,
    chains: Optional[Tuple[int, int]] = None,
) -> StreamedSample:
    """Run (or resume) the parallel sampling stage as one chunked stream.

    ``chunk_size`` is the emission cadence (0 ⇒ ``checkpoint_every``, else
    one T-sized chunk); ``on_chunk`` subscribers see every chunk in order,
    including, on a resumed run, the restored prefix emitted again as
    ``replayed=True`` chunks at the original boundaries. With
    ``checkpoint_dir`` the carry (chain state, ε, draws so far, accept sums
    and the generator's state) is saved at every ``checkpoint_every``
    boundary (a multiple of the cadence) and a later call resumes mid-chain
    bitwise; ``max_steps`` bounds the draws of this call and ends on a save
    boundary. With no subscriber, checkpoint or budget and a cadence below
    T, the fused path runs instead: all T draws with no host synchronisation.
    A ``mesh_shape`` whose data axis is above 1 runs every chunk on the
    chain groups of :class:`~repro_torch.api.backends.MeshChunkBackend`
    (on ``devices``), the same draws, with the chain-group check: its
    chunks and checkpoints are gathered onto the data's device first, and a
    restored carry is split over the groups again. ``chains = (lo, hi)``
    runs only those chains of the ``num_shards`` (:class:`ShardChainStream`):
    the result holds their rows.
    """
    chunk = chunk_size if chunk_size > 0 else checkpoint_every
    if checkpoint_every > 0 and chunk_size > 0 and checkpoint_every % chunk_size:
        raise ValueError(
            f"checkpoint_every={checkpoint_every} must be a multiple of the stream "
            f"chunk cadence {chunk_size}: saves land on chunk boundaries"
        )
    if max_steps is not None and (
        checkpoint_dir is None or checkpoint_every <= 0 or max_steps < checkpoint_every
    ):
        raise ValueError(
            f"max_steps={max_steps} cannot make durable progress: saves land on "
            "checkpoint boundaries, so it needs a checkpoint_dir, checkpoint_every > 0 "
            f"and max_steps >= checkpoint_every (got checkpoint_every={checkpoint_every})"
        )
    if shards is None or counts is None:
        shards, counts = partition_data(data, num_shards, only=model.shard_keys, pad=True)
    sampler = sampler or model.default_sampler
    stream = ShardChainStream(
        gen, model, num_shards, num_samples,
        sampler=sampler, warmup=warmup, burn_in=burn_in, step_size=step_size,
        sgld_batch=sgld_batch, sampler_options=sampler_options, shards=shards, counts=counts,
        use_counts=is_padded(model, shards, counts, sampler), mesh_shape=mesh_shape,
        devices=devices, chains=chains,
    )
    backend = stream.backend
    if chains is not None:
        counts = counts[chains[0]:chains[1]]

    # fused: nobody subscribes and nothing persists (a cadence of 0 or T
    # keeps the one-chunk loop)
    if checkpoint_dir is None and not on_chunk and max_steps is None and 0 < chunk < num_samples:
        theta, accept_sum = stream.fused_sample()
        return StreamedSample(
            SampleResult(theta, accept_sum / max(num_samples, 1), counts,
                         backend.backend_id(FUSED), backend.collectives_checked),
            t_done=num_samples, total=num_samples, resumed_from=0,
        )

    step = latest_step(checkpoint_dir) if checkpoint_dir is not None else None
    if step is not None:
        carry, meta = _restore_carry(checkpoint_dir, step, stream.device)
        if meta.get("spec_id") != spec_id or meta.get("T") != num_samples:
            raise ValueError(
                f"checkpoint at {checkpoint_dir} belongs to spec {meta.get('spec_id')!r} "
                f"(T={meta.get('T')}), not {spec_id!r} (T={num_samples}); refusing to resume"
            )
        t_done = int(meta["t_done"])
        # bitwise resume rests on global chunk boundaries: an unfinished run
        # must keep its cadence (a finished one has no tail to replay)
        if t_done < num_samples:
            if meta.get("checkpoint_every") != checkpoint_every:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir} was written with checkpoint_every="
                    f"{meta.get('checkpoint_every')}; resuming mid-run with checkpoint_every="
                    f"{checkpoint_every} would shift chunk boundaries and void the "
                    "bitwise-resume guarantee; pass the original cadence"
                )
            if meta.get("chunk") != chunk:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir} streamed in chunks of {meta.get('chunk')}; "
                    f"resuming mid-run at cadence {chunk} would shift chunk boundaries and "
                    "void the bitwise-resume guarantee; pass the original cadence"
                )
        stream.gen.set_state(carry["rng"])
        carry = backend.put_carry(carry)
        resumed_from = t_done
        # replay the restored prefix at the original boundaries, so a
        # subscriber's state matches an uninterrupted run's
        if on_chunk and t_done > 0:
            replay_chunk = chunk if chunk > 0 else num_samples
            zeros = torch.zeros((stream.n_chains,), dtype=torch.float32, device=stream.device)
            for r0 in range(0, t_done, replay_chunk):
                r1 = min(r0 + replay_chunk, t_done)
                ev = StreamChunk(
                    carry["theta"][:, r0:r1].contiguous(), zeros, r0, r1, num_samples, carry,
                    replayed=True, landed_s=time.monotonic(),
                )
                for sub in on_chunk:
                    sub(ev)
    else:
        carry = stream.fresh_carry()
        t_done = resumed_from = 0

    stop = num_samples if max_steps is None else min(num_samples, t_done + max_steps)
    if stop < num_samples and checkpoint_every > 0:
        # a budgeted session ends on a save boundary: chunks past the last
        # save would be computed and lost
        stop = (stop // checkpoint_every) * checkpoint_every
    for ev in stream.chunks(carry, t_done, chunk, stop):
        carry, t_done = ev.carry, ev.t1
        for sub in on_chunk:
            sub(ev)
        at_boundary = (checkpoint_every > 0 and t_done % checkpoint_every == 0) or (
            t_done == num_samples
        )
        if checkpoint_dir is not None and at_boundary:
            full = backend.localize(carry)  # a mesh's groups gathered: one layout on disk
            save(
                checkpoint_dir, t_done, full,
                metadata={
                    "spec_id": spec_id, "t_done": t_done, "T": num_samples,
                    "checkpoint_every": checkpoint_every, "chunk": chunk,
                    "state_type": _state_type(full["state"]),
                },
                keep=2,
            )

    accept = carry["accept_sum"] / max(t_done, 1)
    mode = RESUMABLE if checkpoint_dir is not None else CHUNKED
    return StreamedSample(
        SampleResult(carry["theta"], accept, counts, backend.backend_id(mode),
                     backend.collectives_checked),
        t_done=t_done, total=num_samples, resumed_from=resumed_from,
    )


# ---------------------------------------------------------------------------
# the fused combine fold
# ---------------------------------------------------------------------------


class FusedFold(NamedTuple):
    """Artifact of :func:`fused_fold`.

    ``states``: final scan state per combiner (through the face's
    ``to_state`` before the host ``finalize``). ``est_draws``: stacked
    ``(n_boundaries, n_estimate, d)`` trajectory draws of the faces that
    estimate. ``boundaries``: the global draw indices folded up to.
    ``ready``: on the card, one CUDA event per boundary, recorded after that
    boundary's folds and estimates were queued (None on the CPU).
    """

    states: Dict[str, Any]
    est_draws: Dict[str, torch.Tensor]
    boundaries: tuple
    ready: tuple


def fused_fold(
    theta: torch.Tensor,
    faces: Dict[str, Any],  # name -> ScanStreamingFace, in order
    est_gens: Dict[str, Sequence[torch.Generator]],  # name -> one generator per boundary
    n_estimate: int,
    chunk: int,
    options: Dict[str, Any],
) -> FusedFold:
    """Fold the device-resident draws through every scan face.

    Walks the ``(M, chunk, d)`` slices of ``theta`` (views, no copies; the
    ragged tail last), folds each face's ``update`` and takes its
    ``estimate`` at every boundary from that boundary's generator. Nothing
    here waits for the device.
    """
    M, T, d = theta.shape
    names = tuple(faces)
    est_names = tuple(n for n in names if n in est_gens)
    boundaries = chunk_boundaries(T, chunk)
    est_fns = {
        n: (faces[n].estimate, filter_kwargs(faces[n].estimate, options)) for n in est_names
    }
    states = {n: faces[n].init(M, d, device=theta.device) for n in names}
    ests: Dict[str, List[torch.Tensor]] = {n: [] for n in est_names}
    ready = []
    t0 = 0
    for i, t1 in enumerate(boundaries):
        th_c = theta[:, t0:t1]
        states = {n: faces[n].update(states[n], th_c) for n in names}
        for n in est_names:
            fn, kw = est_fns[n]
            ests[n].append(fn(est_gens[n][i], states[n], n_estimate, **kw))
        ready.append(record_event(theta.device))
        t0 = t1
    est_draws = {n: torch.stack(v) for n, v in ests.items()}
    return FusedFold(states, est_draws, boundaries, tuple(ready))
