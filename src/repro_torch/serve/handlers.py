"""Posterior query handlers: request dict in, response dict out.

The port of ``repro/serve/handlers.py``. Every handler is a function of a
:class:`~repro_torch.serve.state.ServeState` plus the request parameters, so
the query surface is testable synchronously and the server's TCP loop is a
thin line-framing shell around :func:`answer`.

Query surface (``op`` field):

``mean_cov``
    Posterior mean and covariance of the current estimate cloud (plus the
    per-dimension marginal std).
``quantiles``
    Marginal quantiles per dimension at ``probs`` (default
    ``0.05/0.25/0.5/0.75/0.95``).
``draws`` (alias ``predictive``)
    ``n`` predictive draws from the estimate cloud: a seeded subsample, so
    the same request against the same snapshot returns the same draws.
``logpdf``
    Unnormalized log posterior density at ``points`` via the batched
    machine-KDE scorer (one launch of the hand-written kernel on the card):
    Σ_m log p̂_m on the accumulated draw buffer (``reduce="product"``; also
    ``"mixture"``).
``status``
    Staleness metadata only (no estimate required).

``mean_cov``, ``quantiles`` and ``draws`` are the reference's numpy code on
the host snapshot, so they give its answers on the same snapshot and never
touch the device. Responses are ``{"ok": True, "op", "combiner", "result",
"staleness"}`` or ``{"ok": False, "error": {"code", "reason", ...},
"staleness"}``: the typed :class:`~repro_torch.core.combiners.api.EstimateUnavailable`
maps to ``code=503``, unknown ops/combiners/bad params to ``code=400``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.combiners import EstimateUnavailable, counts_or_full
from repro_torch.core.combiners.density import machine_kde_scores, masked_silverman
from repro_torch.samplers.base import CAPTURE_LOCK
from repro_torch.serve.state import ServeState

DEFAULT_PROBS = (0.05, 0.25, 0.5, 0.75, 0.95)


def handle_mean_cov(state: ServeState, name: str, params: Dict[str, Any]):
    snap = state.snapshot(name)
    return {
        "mean": snap.mean.tolist(),
        "cov": snap.cov.tolist(),
        "std": np.sqrt(np.clip(np.diag(snap.cov), 0.0, None)).tolist(),
        "n_estimate": int(snap.samples.shape[0]),
    }


def handle_quantiles(state: ServeState, name: str, params: Dict[str, Any]):
    probs = [float(p) for p in params.get("probs", DEFAULT_PROBS)]
    if not probs or any(not (0.0 <= p <= 1.0) for p in probs):
        raise ValueError(f"probs must lie in [0, 1], got {probs}")
    snap = state.snapshot(name)
    q = np.quantile(snap.samples, probs, axis=0)  # (P, d)
    return {"probs": probs, "quantiles": q.tolist()}


def handle_draws(state: ServeState, name: str, params: Dict[str, Any]):
    n = int(params.get("n", 16))
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")
    seed = int(params.get("seed", 0))
    snap = state.snapshot(name)
    # deterministic per (snapshot, seed): same request, same draws
    idx = np.random.default_rng(seed).integers(0, snap.samples.shape[0], size=n)
    return {"draws": snap.samples[idx].tolist(), "seed": seed}


def handle_logpdf(state: ServeState, name: str, params: Dict[str, Any]):
    if "points" not in params:
        raise ValueError("logpdf needs 'points': one d-vector or a list of them")
    pts = np.asarray(params["points"], dtype=np.float32)
    if pts.ndim == 1:
        pts = pts[None, :]
    if pts.ndim != 2:
        raise ValueError(f"points must be (d,) or (Q, d), got shape {pts.shape}")
    reduce = str(params.get("reduce", "product"))
    if reduce not in ("product", "mixture"):
        raise ValueError(f"reduce must be 'product' or 'mixture', got {reduce!r}")
    with CAPTURE_LOCK:
        theta, counts = state.logpdf_inputs()
        if pts.shape[1] != theta.shape[-1]:
            raise ValueError(
                f"points are {pts.shape[1]}-dimensional, posterior is "
                f"{theta.shape[-1]}-dimensional"
            )
        h = masked_silverman(theta, counts_or_full(theta, counts))
        scores = machine_kde_scores(
            torch.from_numpy(pts).to(theta.device), theta, counts, h, reduce=reduce
        )
        log_density = scores.cpu().numpy()
    state.note_logpdf()
    return {
        "log_density": log_density.tolist(),
        "reduce": reduce,
        "normalized": False,  # Σ_m log p̂_m is the unnormalized product score
    }


def handle_status(state: ServeState, name: str, params: Dict[str, Any]):
    return {
        "combiners": list(state.setup.names),
        "ops": sorted(HANDLERS),
        "n_estimate": state.n_estimate,
    }


HANDLERS = {
    "mean_cov": handle_mean_cov,
    "quantiles": handle_quantiles,
    "draws": handle_draws,
    "predictive": handle_draws,  # alias
    "logpdf": handle_logpdf,
    "status": handle_status,
}


def answer(state: ServeState, request: Dict[str, Any]) -> Dict[str, Any]:
    """Dispatch one request dict; never raises for a bad request — failures
    become typed ``{"ok": False, "error": ...}`` responses (still carrying
    staleness, so even a 503 tells the reader where the stream is)."""
    op = request.get("op")
    name: Optional[str] = request.get("combiner") or (
        state.setup.names[0] if state.setup.names else None
    )
    base: Dict[str, Any] = {"op": op, "combiner": name}
    if "id" in request:
        base["id"] = request["id"]
    try:
        handler = HANDLERS.get(op)
        if handler is None:
            raise KeyError(f"unknown op {op!r}; available: {sorted(HANDLERS)}")
        result = handler(state, name, request)
        return {"ok": True, **base, "result": result, "staleness": state.staleness(name)}
    except EstimateUnavailable as exc:
        return {
            "ok": False, **base,
            "error": {"code": 503, "reason": exc.reason, "combiner": exc.combiner},
            "staleness": state.staleness(name),
        }
    except (KeyError, ValueError, TypeError) as exc:
        return {
            "ok": False, **base,
            "error": {"code": 400, "reason": str(exc)},
            "staleness": state.staleness(name if name in state.setup.names else None),
        }
