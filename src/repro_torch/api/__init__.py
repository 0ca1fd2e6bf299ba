"""repro_torch.api — the experiment layer of the port.

:class:`RunSpec` (same fields and ``spec_id`` as ``repro``'s) and
:class:`Pipeline` (partition → sample → groundtruth → combine → score)::

    from repro_torch.api import Pipeline, RunSpec

    spec = RunSpec(model="logreg", M=10, T=1200,
                   combiner=("parametric", "nonparametric"),
                   combiner_options={"weight_eval": "kernel", "n_batch": 16})
    print(Pipeline(spec).run().table())          # on the card
    print(Pipeline(spec, device="cpu").run().table())

Combine while sampling (``RunSpec.stream_every > 0``)::

    sr = Pipeline(dataclasses.replace(spec, stream_every=120)).stream_combine()
    sr.trajectory   # one row per (chunk boundary, combiner with an estimate)
    sr.combined     # the finals, bitwise the batch combine's for buffered combiners

A sweep of specs (:func:`run_matrix`, one set of chain loops a signature)::

    res = run_matrix(spec.sweep(seed=range(4)), device="cpu")
    print(res.table())

Chains split over devices (``mesh_shape``; one CUDA device a group unless
``devices`` names them, a device may repeat), the same draws bit for bit::

    Pipeline(dataclasses.replace(spec, mesh_shape=(2, 1)), devices=("cuda:0", "cuda:1")).run()

and over processes, ``python -m repro_torch.api.launch`` (:func:`run_launch`).

Every name of ``repro.api``'s ``__all__`` is here but two, which the port
does not port: ``make_shard_sampler`` returns a pure one-shard function
for ``vmap`` or ``shard_map`` to drive, and ``VmapChunkBackend`` is the
vmapped chunk program. The port batches the chains by construction: the
counterparts are :func:`make_shard_kernel` with :func:`run_shard_chain`, and
``BatchedChunkBackend`` (:func:`get_chunk_backend`'s default).
"""

from repro_torch.api.backends import (  # noqa: F401
    BackendId,
    ChunkBackend,
    MeshChunkBackend,
    get_chunk_backend,
    resolve_mesh_devices,
)
from repro_torch.api.pipeline import (  # noqa: F401
    LOG_L2_DIM,
    Pipeline,
    Scoreboard,
    ShardedData,
    StreamResult,
    StreamSetup,
    SubposteriorDraws,
    combine_draws,
    combine_spec_draws,
)
from repro_torch.api.resumable import (  # noqa: F401
    ResumableSample,
    sample_subposteriors_resumable,
)
from repro_torch.api.streaming import (  # noqa: F401
    FusedFold,
    ShardChainStream,
    StreamChunk,
    StreamedSample,
    fused_fold,
    stream_sample,
)
from repro_torch.api.sampling import (  # noqa: F401
    SampleResult,
    ShardKernel,
    groundtruth_chain,
    make_shard_kernel,
    run_shard_chain,
    sample_subposteriors,
)
from repro_torch.api.spec import RunSpec  # noqa: F401

NOT_PORTED = ("make_shard_sampler", "VmapChunkBackend")  # see the module docstring


def __getattr__(name):
    # lazy: `python -m repro_torch.api.matrix` first imports this package, and
    # an eager import of the submodule here would run matrix.py twice
    if name in ("MatrixResult", "run_matrix", "ExecutableCache"):
        from repro_torch.api import matrix

        return getattr(matrix, name)
    if name in ("run_launch", "LAUNCHABLE_COMBINERS"):
        from repro_torch.api import launch

        return getattr(launch, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
