"""Sampler protocol + chain drivers, batched over chains by construction.

The port of ``repro/samplers/base.py``. A kernel is ``MCMCKernel(init, step, draw, check)``:

- ``init(position) -> state``                 (``state.position`` exists)
- ``step(gen, state, *inputs) -> (state, StepInfo)``   (one transition)
- ``draw(gen, position, out=None) -> inputs`` (the step's random inputs)
- ``check(state)``                            (reads the state on the host
  after a run of transitions and raises on a fault the step could only count)

Positions are tensors ``(..., d)``, or a NamedTuple of tensors that share
those leading axes (a Gibbs state with shard-local latents); every leading
axis is an independent chain (the reference ``vmap``\\ s :func:`run_chain`;
here the batch axis is written out). States are NamedTuples of tensors and
such positions. Randomness comes from an explicit :class:`torch.Generator`:
``step(gen, state)`` draws its own inputs, and ``step(gen, state,
*draw(gen, state.position))`` is the same transition, bit for bit.

The reference runs each chain loop (warmup, burn-in, collection) as one
``lax.scan`` inside ``jit``. Here a loop is a :class:`TransitionLoop`: on the
CPU a Python loop of eager steps, on the card the replays of one captured
CUDA graph of the transition, with the random inputs drawn outside the graph
in the eager order, so both give the eager loop's draws.
"""

from __future__ import annotations

import gc
import threading
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import LaunchTally, device_index

LogDensityFn = Callable[[torch.Tensor], torch.Tensor]

# Held by every capture of a transition. A CUDA graph capture fails, or
# breaks another thread's launch, if another thread issues device work on
# the default stream meanwhile; a thread that launches while another may be
# capturing (the posterior server's folder and readers, beside its sampler
# thread) holds this lock around its device work.
CAPTURE_LOCK = threading.RLock()


class MCMCKernel(NamedTuple):
    init: Callable[[Any], Any]
    step: Callable[..., Tuple[Any, "StepInfo"]]
    # the step's random inputs, drawn apart from it; a kernel without one
    # runs only on the CPU (its step would draw inside a captured graph)
    draw: Optional[Callable[..., Tuple[Any, ...]]] = None
    # run on the host after a run of transitions (it may wait for the device)
    check: Optional[Callable[[Any], None]] = None


def tree_map(fn: Callable[..., torch.Tensor], tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensors of a tensor, tuple or NamedTuple tree (and the
    matching leaves of ``rest``), keeping the tree's structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    parts = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


def tree_leaves(tree: Any) -> list:
    """The tensors of a tree, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for x in tree for leaf in tree_leaves(x)]


def tree_copy_(dst: Any, src: Any) -> None:
    """Copy every tensor of ``src`` into the matching tensor of ``dst``."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(s)


def tree_where(pred: torch.Tensor, x: Any, y: Any) -> Any:
    """``x`` where ``pred`` (one flag per chain), else ``y``, leaf by leaf:
    ``pred`` gains trailing axes to each leaf's rank."""
    def where(a, b):
        return torch.where(pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim())), a, b)

    return tree_map(where, x, y)


class StepInfo(NamedTuple):
    """Uniform per-step diagnostics, one entry per chain."""

    accept_prob: torch.Tensor
    is_accepted: torch.Tensor
    log_density: torch.Tensor


class TransitionLoop:
    """Transitions of one kernel on tensors the loop owns: a chain loop.

    The loop keeps its own copy of the chain state and the buffers of the
    step's random inputs. :meth:`step` draws the inputs from the caller's
    generator, outside any graph and in the order ``kernel.step`` would
    draw them, then runs the transition, which writes the new state into the
    loop's tensors. ``inner(info)``, if given, runs inside the transition
    after the step (the warmup's step-size update).

    On the CPU every transition runs eagerly. On the card the first one runs
    eagerly on a side stream, as PyTorch asks before a capture: it is a real
    step of the chain, and it warms the allocator and autograd. The second
    is captured into one CUDA graph, and it and every later transition are
    replays of that graph. A capture or replay error is raised; nothing
    falls back to eager steps. :class:`~repro_torch.kernels.LaunchTally`
    keeps the kernels' launch counts exact across capture and replays, and
    the capture holds :data:`CAPTURE_LOCK` with the garbage collector off.
    The graph is captured for the
    stream current at its capture (a chain group's own stream, on the mesh)
    and replays only there: a kernel that keeps scratch a stream
    (``logreg_loglik_grad``'s tickets) takes that stream's during the capture.
    """

    def __init__(
        self,
        kernel: MCMCKernel,
        state: Any,
        inner: Optional[Callable[[StepInfo], None]] = None,
    ):
        device = tree_leaves(state.position)[0].device
        if device.type == "cuda" and kernel.draw is None:
            raise TypeError("a kernel runs on the card only with a draw function: its "
                            "random inputs are drawn outside the captured transition")
        self.kernel, self.inner = kernel, inner
        self.state = tree_map(torch.clone, state)
        self.graphed = device.type == "cuda"
        self.draws: Optional[Tuple[torch.Tensor, ...]] = None
        self.info: Optional[StepInfo] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.tally = LaunchTally()
        self.device = device

    def load(self, state: Any) -> None:
        """Continue from ``state``: copy it into the loop's tensors."""
        tree_copy_(self.state, state)

    def snapshot(self) -> Any:
        """A copy of the current state that later transitions leave alone."""
        return tree_map(torch.clone, self.state)

    def _transition(self, gen: torch.Generator) -> None:
        # a kernel without draw (CPU only) draws inside its step
        new, info = self.kernel.step(gen, self.state, *(self.draws or ()))
        tree_copy_(self.state, new)
        if self.inner is not None:
            self.inner(info)
        self.info = info

    def step(self, gen: torch.Generator) -> StepInfo:
        """One transition; returns its info (on the card the graph's own
        tensors, which the next transition overwrites)."""
        draw = self.kernel.draw
        if draw is not None and self.draws is None:
            self.draws = draw(gen, self.state.position)
        elif draw is not None:
            draw(gen, self.state.position, out=self.draws)
        if not self.graphed:
            self._transition(gen)
        elif self.graph is not None:
            if _raw_stream(self.device) != self.tally.stream:
                raise RuntimeError("a chain loop replays its graph on the stream it was "
                                   "captured for (a kernel's scratch belongs to that stream)")
            self.graph.replay()
            self.tally.replay()
        elif self.info is None:  # the warm-up: a real step, eager, on a side stream
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._transition(gen)
            torch.cuda.current_stream().wait_stream(side)
        else:
            graph = torch.cuda.CUDAGraph()
            # no garbage collection during the capture: a collection there can
            # destroy an old loop's graph (a loop and its warmup hold each
            # other), and a CUDA call of that kind voids the capture
            collecting = gc.isenabled()
            gc.disable()
            try:
                with CAPTURE_LOCK, self.tally.capturing(_raw_stream(self.device)), \
                        torch.cuda.graph(graph, stream=_capture_stream(self.device)):
                    self._transition(gen)
            finally:
                if collecting:
                    gc.enable()
            self.graph = graph
            graph.replay()
            self.tally.replay()
        return self.info


def _raw_stream(device: torch.device) -> int:
    return torch._C._cuda_getCurrentRawStream(device_index(device))


_CAPTURE_STREAMS: dict = {}  # device index -> the side stream captures run on


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """A side stream of ``device`` to capture on: ``torch.cuda.graph``'s own
    default is one stream, of whichever device made it first, and a chain
    group on another card must not capture there."""
    index = device_index(device)
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(device=index)
    return _CAPTURE_STREAMS[index]


def chain_setup(
    gen: torch.Generator,
    kernel: "MCMCKernel | Callable[[torch.Tensor], MCMCKernel]",
    position: torch.Tensor,
    *,
    burn_in: int = 0,
    warmup: int = 0,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
) -> Tuple[MCMCKernel, Any, "torch.Tensor | float"]:
    """Warmup and burn-in of the chains in ``position (..., d)``:
    ``(kernel, state, step_size)``, ready for :func:`chain_collect`.

    ``kernel`` may be a factory ``step_size -> MCMCKernel``; ``warmup > 0``
    requires one: ``warmup`` dual-averaging transitions adapt each chain's
    step size toward ``target_accept`` from ``initial_step_size``, and the
    kernel returned is frozen at the adapted ``(..., 1)`` steps (the returned
    ``step_size``; ``initial_step_size`` otherwise). Warmup and burn-in
    transitions are discarded.
    """
    step_size: "torch.Tensor | float" = initial_step_size
    if warmup > 0:
        from repro_torch.samplers import adaptation

        if isinstance(kernel, MCMCKernel) or not callable(kernel):
            raise TypeError(
                "warmup needs a kernel factory (step_size -> MCMCKernel); "
                "got a built kernel whose step size cannot be adapted"
            )
        kernel, position, step_size = adaptation.warmup_chain(
            gen, kernel, position, warmup,
            initial_step_size=initial_step_size, target_accept=target_accept,
        )
    elif not isinstance(kernel, MCMCKernel) and callable(kernel):
        kernel = kernel(initial_step_size)
    state = kernel.init(position)
    if burn_in > 0:
        loop = TransitionLoop(kernel, state)
        for _ in range(burn_in):
            loop.step(gen)
        state = loop.snapshot()
    if kernel.check is not None:
        kernel.check(state)
    return kernel, state, step_size


def chain_collect(
    gen: torch.Generator,
    kernel: "MCMCKernel | TransitionLoop",
    state: Any,
    num_samples: int,
    *,
    thin: int = 1,
    extract: Optional[Callable[[Any], torch.Tensor]] = None,
) -> Tuple[Any, torch.Tensor, StepInfo]:
    """``num_samples`` kept draws from a live state: ``(state, (..., T, d),
    info (..., T))``; ``thin`` keeps every thin-th transition.

    ``kernel`` may be a :class:`TransitionLoop` kept from an earlier call
    (so a run in chunks captures its transition once); it continues from
    ``state``. ``extract(position) -> (..., d)`` is what a kept draw records
    (the position itself by default; a Gibbs state's shared θ, its latents
    left out). Each kept draw and its info are copied out of the loop's
    tensors, and the state returned is a copy. The kernel's ``check`` reads
    the state once the draws are made.
    """
    if isinstance(kernel, TransitionLoop):
        loop = kernel
        loop.load(state)
    else:
        loop = TransitionLoop(kernel, state)
    if extract is None:
        extract = _identity
    theta = extract(loop.state.position)
    batch = tuple(theta.shape[:-1])
    like = dict(dtype=theta.dtype, device=theta.device)
    out = torch.empty((num_samples,) + tuple(theta.shape), **like)
    fields = StepInfo(torch.empty((num_samples,) + batch, **like),
                      torch.empty((num_samples,) + batch, dtype=torch.bool, device=theta.device),
                      torch.empty((num_samples,) + batch, **like))
    for t in range(num_samples):
        for _ in range(thin):
            info = loop.step(gen)
        out[t].copy_(extract(loop.state.position))
        for buf, f in zip(fields, info):
            buf[t].copy_(f)
    stacked = StepInfo(*(f.movedim(0, -1).contiguous() for f in fields))
    if loop.kernel.check is not None:
        loop.kernel.check(loop.state)
    return loop.snapshot(), out.movedim(0, len(batch)).contiguous(), stacked


def _identity(x):
    return x


def run_chain(
    gen: torch.Generator,
    kernel: "MCMCKernel | Callable[[torch.Tensor], MCMCKernel]",
    position: torch.Tensor,
    num_samples: int,
    *,
    burn_in: int = 0,
    thin: int = 1,
    warmup: int = 0,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
) -> Tuple[torch.Tensor, StepInfo]:
    """Drive the chains of ``position (..., d)``; returns ``(..., T, d)`` + info ``(..., T)``.

    :func:`chain_setup` (warmup, burn-in) then :func:`chain_collect`, which
    draw from ``gen`` in that order.
    """
    kernel, state, _ = chain_setup(
        gen, kernel, position, burn_in=burn_in, warmup=warmup,
        initial_step_size=initial_step_size, target_accept=target_accept,
    )
    _, out, info = chain_collect(gen, kernel, state, num_samples, thin=thin)
    return out, info


def run_chains(
    gen: torch.Generator,
    kernel: "MCMCKernel | Callable[[torch.Tensor], MCMCKernel]",
    positions: torch.Tensor,
    num_samples: int,
    **options,
) -> Tuple[torch.Tensor, StepInfo]:
    """:func:`run_chain` over a leading chain axis: ``(C, d)`` → ``(C, T, d)``.

    Every chain adapts its own step size under warmup; no chain reads
    another's state.
    """
    if positions.dim() < 2:
        raise ValueError(f"positions need a leading chain axis, got {tuple(positions.shape)}")
    return run_chain(gen, kernel, positions, num_samples, **options)
