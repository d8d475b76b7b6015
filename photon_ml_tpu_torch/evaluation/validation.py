"""Full GLM validation metric map (a copy of
photon_ml_tpu/evaluation/validation.py:1-101, host numpy in both
packages; reference: ml/Evaluation.scala:31-194 — the Spark-MLlib-backed
metric bundle the GLM driver logs per λ), and StreamedEvalAccumulator
:104-148, the streamed validation of ``--stream-train``."""

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



class StreamedEvalAccumulator:
    """Bounded-memory evaluation over a streamed scoring pipeline: per
    scored batch, retain ONLY the evaluation columns (scores, labels,
    offsets, weights, and the entity-id names the requested id types
    need) — never features — then evaluate once at the end."""

    def __init__(self, id_types=()):
        self.id_types = tuple(id_types)
        self._scores: list = []
        self._responses: list = []
        self._offsets: list = []
        self._weights: list = []
        self._ids = {t: [] for t in self.id_types}
        self.rows = 0

    def add(self, dataset, scores) -> None:
        self._scores.append(np.asarray(scores))
        self._responses.append(dataset.responses)
        self._offsets.append(dataset.offsets)
        self._weights.append(dataset.weights)
        for t in self.id_types:
            col = dataset.id_columns[t]
            self._ids[t].append(col.vocabulary[col.codes])
        self.rows += dataset.num_rows

    def metrics(self, evaluators) -> Dict[str, float]:
        """Metric map from the accumulated columns; {} when the stream
        yielded no rows (an empty validation input degrades to empty
        metrics, not a crash after a long training run)."""
        if not evaluators or not self._responses:
            return {}
        from photon_ml_tpu_torch.data.game_data import GameDataset

        eval_data = GameDataset.build(
            responses=np.concatenate(self._responses),
            feature_shards={},
            ids={t: np.concatenate(v) for t, v in self._ids.items()},
            offsets=np.concatenate(self._offsets),
            weights=np.concatenate(self._weights))
        scores_all = np.concatenate(self._scores)
        return {ev.name: ev.evaluate_dataset(scores_all, eval_data)
                for ev in evaluators}
