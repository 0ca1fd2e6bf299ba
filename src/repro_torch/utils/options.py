"""Shared option-forwarding helper for the name registries.

The port's copy of ``repro/utils/options.py``. Both registries
(``repro_torch.core.combiners``, ``repro_torch.samplers``) let callers
broadcast ONE option dict over many implementations; each implementation must
only see the options its signature declares:

- ``**options`` (no underscore) in a signature marks a *passthrough* wrapper
  that forwards to an inner implementation — it receives the full dict;
- ``**_ignored`` marks tolerated-but-unused keywords — unknown keys are
  dropped here rather than silently swallowed there.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict


def filter_kwargs(fn: Callable, options: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only the keyword-only options ``fn``'s signature declares."""
    params = inspect.signature(fn).parameters.values()
    passthrough = any(
        p.kind is inspect.Parameter.VAR_KEYWORD and not p.name.startswith("_")
        for p in params
    )
    if passthrough:
        return dict(options)
    known = {p.name for p in params if p.kind is inspect.Parameter.KEYWORD_ONLY}
    return {k: v for k, v in options.items() if k in known}
