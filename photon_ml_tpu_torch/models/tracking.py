"""Per-iteration model tracking, coefficient summaries and per-update
optimizer summaries (port of photon_ml_tpu/models/tracking.py:
OptimizerState :35, ModelTracker :49-113, CoefficientSummary :116-183,
_reason_names / _stats :188-197, summarize_update_tracker :200,
summarize_trackers :222, summarize_coefficients :233).

- ``ModelTracker`` (ml/supervised/model/ModelTracker.scala) pairs a GLM
  solve's per-iteration states (value, gradient norm) with the model at
  each iteration, built from ``OptimizerResult``'s histories (the port's
  solvers stack them once at the end of a solve; ``coef_history`` when
  the solve ran with ``track_coefficients``). States are host floats;
  models hold host (CPU) coefficient tensors in the original space.
- ``CoefficientSummary`` (ml/supervised/model/CoefficientSummary.scala):
  one coefficient's distribution across models (bootstrap replicates),
  host numpy with the reference's sorted-index quartiles.
- ``summarize_trackers``: the training driver writes these into
  ``optimizationTrackers`` of ``model-metadata.json``: per coordinate and
  update, how many solves ran, why they stopped, and the iteration and
  final-objective distributions (the reference's
  ml/optimization/game/*Tracker.scala summaries). The trackers are the
  port's per-update solver results: one OptimizerResult for a fixed
  effect, one per bucket for a random effect, and one FactoredUpdate per
  MF alternation for a factored effect, summarized by its refit of B as
  the JAX package's factored tracker is.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.data.normalization import NormalizationContext
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import (
    GeneralizedLinearModel,
    model_for_task,
)
from photon_ml_tpu_torch.optimization.convergence import (
    ConvergenceReason,
    OptimizerResult,
)
from photon_ml_tpu_torch.types import TaskType


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass(frozen=True)
class OptimizerState:
    """One optimizer iteration: (iteration, objective value, gradient
    norm). The reference's OptimizerState also carries the coefficients
    (ml/optimization/OptimizerState.scala); here they live in
    ``ModelTracker.models``."""

    iteration: int
    value: float
    grad_norm: float


@dataclasses.dataclass(frozen=True)
class ModelTracker:
    """Optimization states + the model produced at each iteration, from
    an ``OptimizerResult`` (models are empty unless the solve ran with
    ``track_coefficients=True``)."""

    states: List[OptimizerState]
    models: List[GeneralizedLinearModel]
    convergence_reason: ConvergenceReason

    @classmethod
    def from_result(
        cls,
        result: OptimizerResult,
        task: TaskType,
        normalization: Optional[NormalizationContext] = None,
    ) -> "ModelTracker":
        if result.value_history is None or result.grad_norm_history is None:
            # The batched entity solver records no per-iteration history.
            raise ValueError(
                "ModelTracker.from_result needs per-iteration histories; "
                "this OptimizerResult carries none (the batched entity "
                "solver does not record them)")
        iters = int(result.iterations)
        values = _host(result.value_history)[: iters + 1]
        gnorms = _host(result.grad_norm_history)[: iters + 1]
        states = [OptimizerState(k, float(values[k]), float(gnorms[k]))
                  for k in range(iters + 1)]
        models: List[GeneralizedLinearModel] = []
        if result.coef_history is not None:
            glm_cls = model_for_task(task)
            for row in result.coef_history[: iters + 1]:
                w = row
                if normalization is not None:
                    w = normalization.model_to_original_space(row)
                models.append(glm_cls(Coefficients(w.detach().cpu())))
        return cls(states, models, result.reason_enum())

    @property
    def num_iterations(self) -> int:
        return len(self.states) - 1 if self.states else 0


class CoefficientSummary:
    """Streaming summary of one coefficient's distribution across models.

    The single canonical implementation (also re-exported by
    photon_ml_tpu_torch.diagnostics for the bootstrap CI aggregates,
    ml/BootstrapTraining.scala). Assumes a modest number of samples
    (bootstrap replicates, λ-grid points) — quantiles keep all values, like
    the reference.
    """

    def __init__(self) -> None:
        self._values: List[float] = []

    def accumulate(self, x: float) -> None:
        self._values.append(float(x))

    @classmethod
    def of(cls, values: Sequence[float]) -> "CoefficientSummary":
        s = cls()
        for v in values:
            s.accumulate(v)
        return s

    @property
    def count(self) -> int:
        return len(self._values)

    @property
    def mean(self) -> float:
        return float(np.mean(self._values)) if self._values else float("nan")

    @property
    def min(self) -> float:
        return float(np.min(self._values)) if self._values else float("nan")

    @property
    def max(self) -> float:
        return float(np.max(self._values)) if self._values else float("nan")

    @property
    def variance(self) -> float:
        # Sample variance (ddof=1), matching commons-math
        # SummaryStatistics semantics.
        if len(self._values) < 2:
            return 0.0 if self._values else float("nan")
        return float(np.var(self._values, ddof=1))

    @property
    def std_dev(self) -> float:
        if len(self._values) < 2:
            return 0.0 if self._values else float("nan")
        return float(np.std(self._values, ddof=1))

    def _quantile_index(self, q: int) -> float:
        # Reference estimator: sorted[q * n / 4] (integer division).
        if not self._values:
            return float("nan")
        s = sorted(self._values)
        return s[min(q * len(s) // 4, len(s) - 1)]

    def first_quartile(self) -> float:
        return self._quantile_index(1)

    def median(self) -> float:
        return self._quantile_index(2)

    def third_quartile(self) -> float:
        return self._quantile_index(3)

    def to_dict(self) -> dict:
        return {"count": self.count, "mean": self.mean, "min": self.min,
                "max": self.max, "stdDev": self.std_dev}

    def __str__(self) -> str:
        return (
            f"Range: [Min: {self.min:.03f}, Q1: {self.first_quartile():.03f},"
            f" Med: {self.median():.03f}, Q3: {self.third_quartile():.03f},"
            f" Max: {self.max:.03f}) Mean: [{self.mean:.03f}],"
            f" Std. Dev.[{self.std_dev:.03f}], # samples = [{self.count}]"
        )


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


def summarize_coefficients(
    models: Sequence[GeneralizedLinearModel],
) -> List[CoefficientSummary]:
    """Per-coordinate CoefficientSummary across a collection of models
    (the reference builds these from bootstrap replicates,
    ml/BootstrapTraining.scala)."""
    if not models:
        return []
    mats = np.stack([_host(m.coefficients.means) for m in models])  # [k, d]
    return [CoefficientSummary.of(mats[:, j]) for j in range(mats.shape[1])]
