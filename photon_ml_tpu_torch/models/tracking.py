"""Per-update optimizer summaries for model metadata (port of
photon_ml_tpu/models/tracking.py: _reason_names / _stats :188-197,
summarize_update_tracker :200, summarize_trackers :222).

The training driver writes these into ``optimizationTrackers`` of
``model-metadata.json``: per coordinate and update, how many solves ran,
why they stopped, and the iteration and final-objective distributions
(the reference's ml/optimization/game/*Tracker.scala summaries). The
trackers are the port's per-update solver results: one OptimizerResult
for a fixed effect, one per bucket for a random effect, and one
FactoredUpdate per MF alternation for a factored effect, summarized by
its refit of B as the JAX package's factored tracker is. ModelTracker and
CoefficientSummary come with the GLM driver (ROADMAP queue A2).
"""

from __future__ import annotations

import numpy as np

from photon_ml_tpu_torch.optimization.convergence import ConvergenceReason


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _reason_names(reasons: np.ndarray) -> dict:
    vals, counts = np.unique(reasons, return_counts=True)
    return {ConvergenceReason(int(v)).name: int(c)
            for v, c in zip(vals, counts)}


def _stats(a: np.ndarray) -> dict:
    a = np.asarray(a, np.float64).ravel()
    return {"mean": float(a.mean()), "min": float(a.min()),
            "max": float(a.max())}


def summarize_update_tracker(tracker) -> dict:
    """Aggregate one coordinate update's result(s): a single result, or a
    list of per-bucket (or per-alternation) results whose fields carry one
    entry per entity."""
    results = tracker if isinstance(tracker, (list, tuple)) else [tracker]
    results = [getattr(r, "refit", r) for r in results]
    reasons = np.concatenate([_host(r.reason).ravel() for r in results])
    iters = np.concatenate([_host(r.iterations).ravel() for r in results])
    values = np.concatenate([_host(r.value).ravel() for r in results])
    return {
        "numSolves": int(reasons.size),
        "convergenceReasons": _reason_names(reasons),
        "iterations": _stats(iters),
        "finalValue": _stats(values),
    }


def summarize_trackers(trackers: dict) -> dict:
    """coordinate name -> per-update aggregate summaries, JSON-ready."""
    return {name: [summarize_update_tracker(t) for t in per_update]
            for name, per_update in trackers.items()}
