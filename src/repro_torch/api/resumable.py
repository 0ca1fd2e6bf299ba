"""Chunked, checkpointable subposterior sampling: resume mid-chain.

The port of ``repro/api/resumable.py``, a thin wrapper over
:func:`repro_torch.api.streaming.stream_sample`, where checkpoint
persistence is one subscriber of the chunk stream. What it pins down:

- the chains draw from one generator in the one-shot order, and the
  checkpoint carries that generator's state, so a resumed run continues the
  same random stream;
- the kernel is rebuilt on resume from the checkpointed per-chain step sizes
  ε (the adapted kernel is ``factory(ε)``, so the rebuild is the original);
- chunk boundaries are global (k·checkpoint_every) and sessions advance in
  whole chunks, so a resumed run replays exactly the chunks of a run that
  never stopped.

Checkpoint layout (one :mod:`repro_torch.checkpoint` step per boundary, step
number = draws collected): the kernel state, ε, the draws so far, the accept
sums and the generator's state; the metadata records the owning
``spec_id`` and the checkpoint and chunk cadences.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from repro_torch.api.sampling import SampleResult
from repro_torch.api.streaming import StreamChunk, stream_sample
from repro_torch.models.bayes import BayesModel


class ResumableSample(NamedTuple):
    """Sampling-stage artifact that may be mid-flight: ``result.theta`` holds
    the first ``t_done`` draws per chain."""

    result: SampleResult
    t_done: int
    total: int
    resumed_from: int  # 0 on a fresh run, else the checkpointed draw count

    @property
    def complete(self) -> bool:
        return self.t_done >= self.total


def sample_subposteriors_resumable(
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
    checkpoint_dir: str,
    checkpoint_every: int = 0,
    spec_id: str = "",
    max_steps: Optional[int] = None,
    shards=None,
    counts: Optional[torch.Tensor] = None,
    chunk_size: int = 0,
    on_chunk: Sequence[Callable[[StreamChunk], None]] = (),
) -> ResumableSample:
    """Run (or resume) the parallel sampling stage with chunked persistence.

    ``checkpoint_every`` draws per saved boundary (0 ⇒ one chunk, saved at
    the end); ``chunk_size`` emits finer chunks between saves
    (``checkpoint_every`` must then be a multiple of it); ``max_steps`` stops
    this session after that many draws, on a save boundary. A later call
    with the same ``checkpoint_dir`` and ``spec_id`` continues; a directory
    of another ``spec_id`` raises.
    """
    ss = stream_sample(
        gen, model, data, num_shards, num_samples,
        sampler=sampler, warmup=warmup, burn_in=burn_in, step_size=step_size,
        sgld_batch=sgld_batch, sampler_options=sampler_options, shards=shards, counts=counts,
        chunk_size=chunk_size, max_steps=max_steps, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, spec_id=spec_id, on_chunk=on_chunk,
    )
    return ResumableSample(ss.result, ss.t_done, ss.total, ss.resumed_from)
