"""Full GLM validation metric map (a copy of
photon_ml_tpu/evaluation/validation.py:1-101, host numpy in both
packages; reference: ml/Evaluation.scala:31-194 — the Spark-MLlib-backed
metric bundle the GLM driver logs per λ). ``StreamedEvalAccumulator``
(:104-148) comes with streamed training (ROADMAP queue A4)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from photon_ml_tpu_torch.constants import POSITIVE_RESPONSE_THRESHOLD
from photon_ml_tpu_torch.evaluation.evaluators import (
    area_under_precision_recall,
    area_under_roc_curve,
    peak_f1_score,
)
from photon_ml_tpu_torch.types import TaskType


def _sigmoid(z):
    return 1 / (1 + np.exp(-np.clip(z, -500, 500)))


def evaluate_glm(task: TaskType, scores, labels, offsets=None, weights=None,
                 num_coefficients: int | None = None) -> Dict[str, float]:
    """Metric map for one model's validation scores (margins, no offset)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, np.float64)
    n = len(scores)
    offsets = np.zeros(n) if offsets is None else np.asarray(offsets)
    weights = np.ones(n) if weights is None else np.asarray(weights)
    z = scores + offsets
    out: Dict[str, float] = {}

    if task == TaskType.LOGISTIC_REGRESSION:
        p = _sigmoid(z)
        eps = 1e-15
        log_lik = float(np.sum(
            weights * (labels * np.log(np.maximum(p, eps))
                       + (1 - labels) * np.log(np.maximum(1 - p, eps)))))
        pred = (p >= POSITIVE_RESPONSE_THRESHOLD).astype(float)
        tp = float(weights[(pred == 1) & (labels == 1)].sum())
        fp = float(weights[(pred == 1) & (labels == 0)].sum())
        fn = float(weights[(pred == 0) & (labels == 1)].sum())
        precision = tp / (tp + fp) if tp + fp > 0 else 0.0
        recall = tp / (tp + fn) if tp + fn > 0 else 0.0
        out.update({
            "AUC": area_under_roc_curve(z, labels, weights),
            "PR_AUC": area_under_precision_recall(z, labels, weights),
            "PEAK_F1": peak_f1_score(z, labels, weights),
            "ACCURACY": float(np.average(pred == labels, weights=weights)),
            "PRECISION": precision,
            "RECALL": recall,
            "F1": (2 * precision * recall / (precision + recall)
                   if precision + recall > 0 else 0.0),
            "LOG_LIKELIHOOD": log_lik,
        })
    elif task == TaskType.LINEAR_REGRESSION:
        resid = z - labels
        mse = float(np.average(resid**2, weights=weights))
        var = float(np.average(
            (labels - np.average(labels, weights=weights))**2,
            weights=weights))
        # Gaussian log-likelihood at sigma^2 = mse.
        log_lik = float(-0.5 * weights.sum()
                        * (np.log(2 * np.pi * max(mse, 1e-300)) + 1))
        out.update({
            "RMSE": float(np.sqrt(mse)),
            "MSE": mse,
            "MAE": float(np.average(np.abs(resid), weights=weights)),
            "R2": 1.0 - mse / var if var > 0 else float("nan"),
            "LOG_LIKELIHOOD": log_lik,
        })
    elif task == TaskType.POISSON_REGRESSION:
        from scipy.special import gammaln

        mu = np.exp(np.clip(z, -500, 30))
        log_lik = float(np.sum(
            weights * (labels * z - mu - gammaln(labels + 1))))
        out.update({
            "POISSON_LOSS": float(np.sum(weights * (mu - labels * z))),
            "RMSE": float(np.sqrt(np.average((mu - labels)**2,
                                             weights=weights))),
            "LOG_LIKELIHOOD": log_lik,
        })
    else:  # smoothed hinge SVM
        t = (2 * labels - 1) * z
        loss = np.where(t <= 0, 0.5 - t,
                        np.where(t < 1, 0.5 * (1 - t)**2, 0.0))
        pred = (z >= 0).astype(float)
        out.update({
            "AUC": area_under_roc_curve(z, labels, weights),
            "PR_AUC": area_under_precision_recall(z, labels, weights),
            "PEAK_F1": peak_f1_score(z, labels, weights),
            "ACCURACY": float(np.average(pred == labels, weights=weights)),
            "SMOOTHED_HINGE_LOSS": float(np.sum(weights * loss)),
        })

    if "LOG_LIKELIHOOD" in out and num_coefficients is not None:
        # AIC = 2k - 2 ln L (ml/Evaluation.scala AIC computation).
        out["AIC"] = 2.0 * num_coefficients - 2.0 * out["LOG_LIKELIHOOD"]
    return out

