"""EP-MCMC's communication, and the proof that sampling has none.

The port of the part of ``repro/distributed/epmcmc.py`` that is not the LM:

- :func:`combine_gathered` — the final combination of gathered
  ``(M, T, d_sub)`` draws, resolved by registry name;
- :func:`combine_stream` — its streaming counterpart over ``(M, C, d_sub)``
  chunks;
- :func:`stack_subset_history` — per-step ``(C, d_sub)`` snapshots stacked
  into that dense layout;
- :func:`assert_no_cross_chain_collectives` — the paper's "embarrassingly
  parallel" claim, checked. ``repro`` parses the compiled HLO of the mesh
  program for collectives whose device groups span chain groups. PyTorch
  runs no such program: here a :class:`~torch.utils._python_dispatch.
  TorchDispatchMode` watches every operator one eager chunk of each chain
  group dispatches (and every operand a hand-written kernel is handed,
  through :func:`repro_torch.kernels.watch_operands`), and fails on a
  collective (``c10d`` or a functional collective) or on an operand that
  lies on another group's device or in the storage of another group's
  inputs or carry (storage, not device: two groups may share a card).

Left for ROADMAP Queue 1 item 11.1 (the LM's SGLD EP-MCMC training mode):
``init_state``, ``epmcmc_step``, ``sgd_baseline_step``, ``state_specs``,
``gather_subset_samples`` (it selects LM parameters by path) and the
diagonal parametric combine of the LM's per-chain moments.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, NamedTuple, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import watch_operands

# operator namespaces that move data between processes or devices
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional",
                         "_c10d_functional_autograd", "_dtensor")


def combine_gathered(
    gen: torch.Generator,
    samples: torch.Tensor,  # (M, T, d_sub) gathered subset draws
    n_draws: int,
    *,
    combiner: str = "nonparametric",
    **options,
):
    """Final-stage combination of gathered subset draws, by registry name;
    options the combiner does not declare are dropped (the registry's
    option-forwarding convention)."""
    from repro_torch.core.combiners import filter_options, get_combiner

    if samples.dim() != 3:
        raise ValueError(
            f"combine_gathered needs (M, T, d_sub) samples, got {tuple(samples.shape)}; "
            "gather_subset_samples returns one (C, d_sub) snapshot — pass "
            "history=True there or stack snapshots with stack_subset_history"
        )
    fn = get_combiner(combiner)
    return fn(gen, samples, n_draws, **filter_options(fn, options))


def combine_stream(
    gen: torch.Generator,
    chunks: Iterable[torch.Tensor],
    n_draws: int,
    *,
    combiner: str = "nonparametric",
    **options,
):
    """Fold dense ``(M, C, d_sub)`` chunks through ``combiner``'s streaming
    form and finalize: bitwise :func:`combine_gathered` on the concatenated
    stack for the buffered combiners; ``online`` never holds the stack."""
    from repro_torch.core.combiners import filter_options, get_streaming_combiner

    sc = get_streaming_combiner(combiner)
    state = None
    for ch in chunks:
        if ch.dim() != 3:
            raise ValueError(
                f"combine_stream folds (M, C, d_sub) chunks, got {tuple(ch.shape)}; "
                "use gather_subset_samples(chunk=window) to build them"
            )
        if state is None:
            state = sc.init(ch.shape[0], ch.shape[2], device=ch.device)
        state = sc.update(state, ch)
    if state is None:
        raise ValueError("combine_stream needs at least one chunk")
    return sc.finalize(gen, state, n_draws, **filter_options(sc.finalize, options))


def stack_subset_history(snapshots: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stack per-step ``(C, d_sub)`` snapshots into ``(C, T, d_sub)``, the
    layout :func:`combine_gathered` takes."""
    if len(snapshots) == 0:
        raise ValueError("stack_subset_history needs at least one snapshot")
    return torch.stack([torch.as_tensor(s) for s in snapshots], dim=1)


# ---------------------------------------------------------------------------
# the "embarrassingly parallel" proof
# ---------------------------------------------------------------------------


class ChainGroup(NamedTuple):
    """One chain group as the check sees it: its device, the tensors it owns
    (its inputs and carry, in any nesting of dicts, tuples and lists; no
    other group may read them) and ``run``, which drives one eager chunk of
    it."""

    device: torch.device
    tensors: Any
    run: Callable[[], Any]


class CrossChainError(AssertionError):
    """A chain group communicated: a collective, or another group's data."""


def _storage_key(t: torch.Tensor):
    try:
        return (t.device, t.untyped_storage().data_ptr())
    except (RuntimeError, NotImplementedError):  # no storage (meta, sparse)
        return None


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    if isinstance(tree, (tuple, list)) or hasattr(tree, "__iter__") and not isinstance(tree, str):
        return [t for x in tree for t in _tensors(x)]
    return []


class _GroupWatch(TorchDispatchMode):
    """Fails on a collective, or an operand on a foreign device or in a
    foreign storage; counts the operators it saw."""

    def __init__(self, index: int, device: torch.device, foreign: dict):
        super().__init__()
        self.index, self.device, self.foreign = index, torch.device(device), foreign
        self.ops = 0

    def operand(self, t: torch.Tensor, where: str) -> None:
        same = t.device.type == self.device.type and (
            self.device.index is None or t.device.index in (None, self.device.index))
        if not same and not (t.device.type == "cpu" and t.dim() == 0):  # host scalars
            raise CrossChainError(f"chain group {self.index} on {self.device}: {where} reads a "
                                  f"tensor on {t.device}")
        owner = self.foreign.get(_storage_key(t))
        if owner is not None:
            raise CrossChainError(f"chain group {self.index}: {where} reads the inputs or carry "
                                  f"of chain group {owner}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace in COLLECTIVE_NAMESPACES:
            raise CrossChainError(f"chain group {self.index} issued the collective {func}")
        for t in _tensors(args) + _tensors(kwargs):
            self.operand(t, str(func))
        self.ops += 1
        return func(*args, **kwargs)


def assert_no_cross_chain_collectives(groups: Sequence[ChainGroup]) -> int:
    """Run one eager chunk of every chain group under watch; raise
    :class:`CrossChainError` on any collective or cross-group read.

    Returns the number of operators checked (the ``collectives_checked`` of
    a mesh run). The operands of hand-written kernels are checked as the
    wrappers hand them over (``check_tensor``); their device code reads only
    those.
    """
    owners = [{_storage_key(t) for t in _tensors(g.tensors)} - {None} for g in groups]
    checked = 0
    for i, g in enumerate(groups):
        foreign = {key: j for j, keys in enumerate(owners) if j != i for key in keys}
        watch = _GroupWatch(i, g.device, foreign)
        with watch, watch_operands(lambda t, name: watch.operand(t, f"kernel operand {name}")):
            g.run()
        checked += watch.ops
    return checked
