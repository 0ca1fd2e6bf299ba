"""The chunk-emitting execution backend of the sampling stage, and its names.

The port of ``repro/api/backends.py`` for one device. :class:`BackendId` is
the one constructor of the ``SampleResult.backend`` strings; the one-shot
batch path keeps ``"batched[cuda]"`` / ``"batched[cpu]"``, and the chunk
modes add a tag after the device: ``"batched[cuda,chunked]"`` (the
subscriber-driven chunk loop), ``"batched[cuda,fused]"`` (all T draws with
no host synchronisation, folded in chunks afterwards) and ``"batched[cuda,resumable]"`` (checkpointed).

:class:`BatchedChunkBackend` drives the M chains, batched on the device, in
chunks: ``setup`` (init, warmup, burn-in), ``next_chunk`` (the next n
draws), ``localize`` (a no-op on one device) and ``run_fused`` (setup and
one chunk of T, with no host synchronisation). Every method
draws from the caller's generator in the order of the one-shot driver, so
any chunking gives the same draws bitwise. The backend keeps the collection
loop (:class:`~repro_torch.samplers.base.TransitionLoop`) of its first chunk,
so on the card every chunk replays one captured transition. A kept draw is
the shared θ (``ShardKernel.extract``: a Gibbs state's latents stay in the
chain state, out of the draws). The reference's
``MeshChunkBackend`` (chains split over devices) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.api.sampling import ShardKernel, setup_shard_chains, shard_chunk
from repro_torch.samplers.base import TransitionLoop

# execution modes a chunk backend can report (BackendId tags)
CHUNKED = "chunked"
FUSED = "fused"
RESUMABLE = "resumable"
_MODES = (None, CHUNKED, FUSED, RESUMABLE)


class BackendId:
    """The one constructor for sampling-backend identifier strings."""

    @staticmethod
    def batched(device_type: str, mode: Optional[str] = None) -> str:
        """``"batched[<device>]"`` or ``"batched[<device>,<mode>]"``."""
        if mode not in _MODES:
            raise ValueError(
                f"unknown backend mode {mode!r} (choices: {', '.join(map(repr, _MODES))})"
            )
        return f"batched[{device_type}]" if mode is None else f"batched[{device_type},{mode}]"


class BatchedChunkBackend:
    """M chains batched on one device, advanced in chunks of any size."""

    kind = "batched"

    def __init__(
        self,
        sk: ShardKernel,
        shards,
        counts: torch.Tensor,
        *,
        burn_in: int,
        warmup: int,
        step_size: float,
    ):
        self.sk, self.shards, self.counts = sk, shards, counts
        self.n_chains = int(counts.shape[0])
        self.device = counts.device
        self.burn_in, self.warmup, self.step_size = burn_in, warmup, step_size
        # adapted kernels run at the per-chain steps in the carry; fixed-step
        # ones at the spec's float, as the one-shot driver does
        self.adapts = sk.adaptive and warmup > 0
        self._loop: Optional[TransitionLoop] = None  # built by the first chunk
        self._eps: Optional[torch.Tensor] = None  # the loop kernel's step sizes

    def backend_id(self, mode: Optional[str] = None) -> str:
        return BackendId.batched(self.device.type, mode)

    def setup(self, gen: torch.Generator) -> Tuple[Any, torch.Tensor]:
        """Init, warmup and burn-in: ``(state, eps (M, 1))``."""
        state, eps = setup_shard_chains(
            self.sk, self.shards, self.counts, gen,
            burn_in=self.burn_in, warmup=self.warmup, step_size=self.step_size,
        )
        if not isinstance(eps, torch.Tensor):
            eps = torch.full((self.n_chains, 1), eps, dtype=torch.float32, device=self.device)
        return state, eps

    def loop(self, eps: torch.Tensor, state: Any) -> TransitionLoop:
        """The collection loop, built at the first chunk and kept: later
        chunks copy ``eps`` into its kernel's step sizes."""
        if self._loop is None:
            self._eps = eps.clone() if self.adapts else None
            kernel = self.sk.build(self.shards, self.counts,
                                   self._eps if self.adapts else self.step_size)
            self._loop = TransitionLoop(kernel, state)
        elif self.adapts:
            self._eps.copy_(eps)
        return self._loop

    def next_chunk(
        self, gen: torch.Generator, eps: torch.Tensor, state: Any, n: int
    ) -> Tuple[Any, torch.Tensor, torch.Tensor]:
        """``(state, theta (M, n, d), accepted count (M,) float32)``."""
        state, theta, accepted = shard_chunk(self.loop(eps, state), gen, state, n,
                                             self.sk.extract)
        return state, theta, accepted.to(torch.float32).sum(dim=-1)

    def localize(self, tree):
        """Chunks already live on the one device."""
        return tree

    def run_fused(
        self, gen: torch.Generator, num_samples: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The whole run with no host synchronisation: setup and one chunk
        of T, the one-shot driver's path. ``(theta (M, T, d), accept_sum (M,))``."""
        state, eps = self.setup(gen)
        _, theta, accept_sum = self.next_chunk(gen, eps, state, num_samples)
        return theta, accept_sum
