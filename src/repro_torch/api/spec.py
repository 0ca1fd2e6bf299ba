"""Declarative run specification: one EP-MCMC scenario as a value.

The port of ``repro/api/spec.py``: the same fields, the same defaults and the
same canonical JSON, so a spec's :attr:`RunSpec.spec_id` (sha256 of that
JSON) is byte-identical to ``repro``'s and a port scoreboard row keys to its
reference row. Names are validated against the port's own registries.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple, Union

Options = Union[Mapping[str, Any], Iterable[Tuple[str, Any]]]


def _freeze_options(options: Options) -> Tuple[Tuple[str, Any], ...]:
    """Canonicalize an option mapping to a sorted, hashable tuple of pairs."""
    items = list(options.items()) if isinstance(options, Mapping) else list(options)
    frozen = []
    for k, v in sorted(items):
        if isinstance(v, list):
            v = tuple(v)
        frozen.append((str(k), v))
    return tuple(frozen)


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One model × sampler × combiner scenario, as data.

    Zero values mean "use the registry/paper default" (``sampler=None`` →
    the model's ``default_sampler``, ``burn_in=0`` → T/6, ``n=0`` → the
    model's ``default_n``). ``combiner`` may be ``"all"``, one name, or a
    tuple of names. ``stream_every``, ``mesh_shape`` and ``sgld_batch`` are
    kept for the shared ``spec_id``; the port does not run those paths yet.
    """

    model: str
    sampler: Optional[str] = None
    combiner: Union[str, Tuple[str, ...]] = "all"
    M: int = 10
    T: int = 2000
    warmup: int = 200
    burn_in: int = 0
    step_size: float = 0.1
    sgld_batch: int = 256
    n: int = 0
    seed: int = 0
    groundtruth_T: int = 4000
    score_metric: str = "auto"  # "auto" (logL2 iff d >= 40) | "l2" | "logl2"
    stream_every: int = 0
    mesh_shape: Optional[Tuple[int, int]] = None
    sampler_options: Tuple[Tuple[str, Any], ...] = ()
    combiner_options: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        set_ = object.__setattr__
        if isinstance(self.combiner, list):
            set_(self, "combiner", tuple(self.combiner))
        if self.mesh_shape is not None:
            set_(self, "mesh_shape", tuple(int(x) for x in self.mesh_shape))
        set_(self, "sampler_options", _freeze_options(self.sampler_options))
        set_(self, "combiner_options", _freeze_options(self.combiner_options))
        for field, lo in (("M", 1), ("T", 1), ("warmup", 0), ("burn_in", 0),
                          ("n", 0), ("groundtruth_T", 1), ("sgld_batch", 0),
                          ("stream_every", 0)):
            if int(getattr(self, field)) < lo:
                raise ValueError(f"RunSpec.{field} must be >= {lo}")
        if not self.step_size > 0:
            raise ValueError("RunSpec.step_size must be positive")
        if self.score_metric not in ("auto", "l2", "logl2"):
            raise ValueError(
                f"RunSpec.score_metric must be auto|l2|logl2, got {self.score_metric!r}"
            )

    def resolved_sampler(self) -> str:
        """Canonical sampler name (the model's default when ``sampler=None``)."""
        from repro_torch.models.bayes import get_model
        from repro_torch.samplers import sampler_spec

        name = self.sampler or get_model(self.model).default_sampler
        return sampler_spec(name).name

    def resolved_n(self) -> int:
        from repro_torch.models.bayes import get_model

        return self.n or get_model(self.model).default_n

    def resolved_burn_in(self) -> int:
        """Paper §8: discard the first 1/6 of the chain unless overridden."""
        return self.burn_in or self.T // 6

    def combiner_names(self) -> Tuple[str, ...]:
        from repro_torch.core.combiners import canonical_combiners

        if self.combiner == "all":
            return canonical_combiners()
        if isinstance(self.combiner, str):
            return (self.combiner,)
        return tuple(self.combiner)

    def validate(self) -> "RunSpec":
        """Resolve every name against the port's registries; raise on a mismatch."""
        from repro_torch.core.combiners import get_combiner
        from repro_torch.models.bayes import get_model

        get_model(self.model)
        self.resolved_sampler()
        for name in self.combiner_names():
            get_combiner(name)
        return self

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["sampler_options"] = dict(self.sampler_options)
        d["combiner_options"] = dict(self.combiner_options)
        if isinstance(self.combiner, tuple):
            d["combiner"] = list(self.combiner)
        if self.mesh_shape is not None:
            d["mesh_shape"] = list(self.mesh_shape)
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "RunSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown RunSpec fields: {sorted(unknown)}")
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "RunSpec":
        return cls.from_dict(json.loads(s))

    @property
    def spec_id(self) -> str:
        """Canonical content hash, equal to ``repro``'s for the same fields."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:12]
