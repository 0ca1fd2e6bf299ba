"""repro_torch.serve — posterior-as-a-service on the streaming combine engine.

The port of ``repro.serve``: the layer that **serves** the evolving
posterior while the chains still run (the paper's §4, combine while
sampling, as users meet it):

- :class:`~repro_torch.serve.state.ServeState` — the deterministic core:
  folds :class:`~repro_torch.api.streaming.StreamChunk` events through the
  same :class:`~repro_torch.api.pipeline.StreamSetup` surfaces
  ``stream_combine`` uses, refreshes cheap per-combiner estimates from the
  trajectory's generators (bitwise ``stream_combine``'s rows), and owns the
  staleness counters every response carries;
- :mod:`~repro_torch.serve.handlers` — the query surface (``mean_cov``,
  ``quantiles``, ``draws`` on host snapshots; ``logpdf`` through the
  machine-KDE kernel; ``status``), typed 503s for combiners that cannot
  estimate;
- :class:`~repro_torch.serve.server.PosteriorServer` — the asyncio loop:
  sampler in an executor thread (its chain loops CUDA graphs on the card)
  feeding a bounded chunk queue, a folder task that never drops chunks but
  coalesces estimate refreshes under backpressure, and TCP/in-process
  readers answering from the freshest snapshot;
- :class:`~repro_torch.serve.client.ServeClient` — the matching
  newline-delimited-JSON client.

Every response reports ``chunks_folded`` / ``draws_seen`` /
``last_fold_monotonic_s`` / ``spec_id``. Restart degrades gracefully to the
last checkpoint: build the Pipeline with its ``checkpoint_dir`` and the
server rebuilds state from replayed (``replayed=True``) chunks without
double-counting.

Quickstart (also ``python -m repro_torch.launch.mcmc_run ... --serve``)::

    from repro_torch.api import Pipeline, RunSpec
    from repro_torch.serve import serve_pipeline

    spec = RunSpec(model="linear", sampler="mala", M=4, T=2000,
                   stream_every=100, combiner=("parametric", "online"))
    serve_pipeline(Pipeline(spec), probe_readers=8)     # on the card
    serve_pipeline(Pipeline(spec, device="cpu"), probe_readers=8)

Not to be confused with :mod:`repro_torch.launch.serve`, the LM sidecar's
prefill/decode driver: this package serves *posteriors*, not tokens.
"""

from repro_torch.serve.client import ServeClient, ServeError  # noqa: F401
from repro_torch.serve.handlers import HANDLERS, answer  # noqa: F401
from repro_torch.serve.server import (  # noqa: F401
    PosteriorServer,
    serve_pipeline,
    serve_session,
)
from repro_torch.serve.state import EstimateSnapshot, ServeState  # noqa: F401

__all__ = [
    "EstimateSnapshot",
    "HANDLERS",
    "PosteriorServer",
    "ServeClient",
    "ServeError",
    "ServeState",
    "answer",
    "serve_pipeline",
]
