"""Best-model selection over a λ grid (a copy of
photon_ml_tpu/estimators/model_selection.py:1-42, host numpy in both
packages; reference: ml/ModelSelection.scala:28-84):
classifiers -> max AUC; linear regression -> min RMSE; Poisson -> min loss."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from photon_ml_tpu_torch.evaluation.evaluators import (
    AreaUnderROCCurveEvaluator,
    PoissonLossEvaluator,
    RMSEEvaluator,
)
from photon_ml_tpu_torch.types import TaskType


def selection_evaluator(task: TaskType):
    if task.is_classification:
        return AreaUnderROCCurveEvaluator()
    if task == TaskType.POISSON_REGRESSION:
        return PoissonLossEvaluator()
    return RMSEEvaluator()


def select_best_model(
    task: TaskType,
    scored: Dict[float, np.ndarray],  # reg weight -> validation scores
    labels,
    offsets=None,
    weights=None,
) -> Tuple[float, Dict[float, float]]:
    """Returns (best reg weight, metric per reg weight)."""
    ev = selection_evaluator(task)
    metrics = {
        lam: ev.evaluate(s, labels, offsets, weights)
        for lam, s in scored.items()}
    best = None
    for lam, m in metrics.items():
        if best is None or ev.better_than(m, metrics[best]):
            best = lam
    return best, metrics
