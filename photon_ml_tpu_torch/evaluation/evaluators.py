"""Evaluators: one scalar metric over (scores, labels, offsets, weights)
(a copy of photon_ml_tpu/evaluation/evaluators.py:1-403, host numpy in
both packages; ``_as_np`` also takes torch tensors, moved to the host).

Reference: ml/evaluation/Evaluator.scala:24-78 and the concrete evaluators in
ml/evaluation/. Scores arrive as dense vectors aligned with the dataset's row
order (no joins). ``better_than`` encodes per-metric ordering exactly as the
reference does (higher-is-better for AUC/precision, lower for losses).

Sharded evaluators group rows by an id column and average the local metric
over groups (ml/evaluation/ShardedAreaUnderROCCurveEvaluator.scala,
ShardedPrecisionAtKEvaluator.scala).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np


def _as_np(a):
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


@dataclasses.dataclass(frozen=True)
class MetricMetadata:
    """Metadata about a metric (reference: ml/metric/MetricMetadata.scala).

    ``higher_is_better`` plays the role of the reference's
    worstToBestOrdering; ``value_range`` its rangeOption.
    """

    name: str
    description: str
    higher_is_better: bool
    value_range: Optional[tuple] = None  # (min, max)

    def to_dict(self) -> dict:
        return {"description": self.description,
                "higherIsBetter": self.higher_is_better,
                "range": self.value_range}


# Registry covering every metric emitted by evaluate_glm and the evaluator
# family. Drivers attach these to their metric reports (the reference binds
# MetricMetadata to each logged metric in ml/Evaluation.scala).
METRIC_METADATA = {
    m.name: m for m in [
        MetricMetadata("AUC", "area under the ROC curve", True, (0.0, 1.0)),
        MetricMetadata("ACCURACY", "weighted classification accuracy", True,
                       (0.0, 1.0)),
        MetricMetadata("PRECISION", "precision at the response threshold",
                       True, (0.0, 1.0)),
        MetricMetadata("RECALL", "recall at the response threshold", True,
                       (0.0, 1.0)),
        MetricMetadata("F1", "harmonic mean of precision and recall", True,
                       (0.0, 1.0)),
        MetricMetadata("PR_AUC", "area under the precision/recall curve",
                       True, (0.0, 1.0)),
        MetricMetadata("PEAK_F1", "max F1 over score thresholds", True,
                       (0.0, 1.0)),
        MetricMetadata("LOG_LIKELIHOOD", "data log-likelihood", True),
        MetricMetadata("AIC", "Akaike information criterion", False),
        MetricMetadata("RMSE", "root mean squared error", False),
        MetricMetadata("MSE", "mean squared error", False),
        MetricMetadata("MAE", "mean absolute error", False),
        MetricMetadata("R2", "coefficient of determination", True),
        MetricMetadata("POISSON_LOSS", "Poisson negative log-likelihood",
                       False),
        MetricMetadata("LOGISTIC_LOSS", "logistic loss", False),
        MetricMetadata("SQUARED_LOSS", "squared loss", False),
        MetricMetadata("SMOOTHED_HINGE_LOSS", "Rennie smoothed hinge loss",
                       False),
    ]
}


def metadata_for(evaluator: "Evaluator") -> MetricMetadata:
    """MetricMetadata for an evaluator (sharded evaluators inherit the base
    metric's metadata; PRECISION@k is synthesized)."""
    base = evaluator.name.split(":")[0].upper()
    if base in METRIC_METADATA:
        meta = METRIC_METADATA[base]
        return dataclasses.replace(meta, name=evaluator.name)
    if base.startswith("PRECISION@"):
        return MetricMetadata(evaluator.name, "precision in the top k",
                              True, (0.0, 1.0))
    return MetricMetadata(
        name=evaluator.name,
        description=evaluator.name,
        higher_is_better=evaluator.higher_is_better,
    )


@dataclasses.dataclass(frozen=True)
class Evaluator:
    name: str

    def evaluate(self, scores, labels, offsets=None, weights=None,
                 data=None) -> float:
        scores = _as_np(scores)
        n = len(scores)
        labels = _as_np(labels)
        offsets = np.zeros(n) if offsets is None else _as_np(offsets)
        weights = np.ones(n) if weights is None else _as_np(weights)
        return self._evaluate(scores + offsets, labels, weights, data)

    def evaluate_dataset(self, scores, data) -> float:
        return self.evaluate(scores, data.responses, data.offsets,
                             data.weights, data=data)

    def _evaluate(self, pred, labels, weights, data) -> float:
        raise NotImplementedError

    def better_than(self, a: float, b: Optional[float]) -> bool:
        if b is None:
            return True
        return a > b if self.higher_is_better else a < b

    @property
    def higher_is_better(self) -> bool:
        return False


def area_under_roc_curve(scores, labels, weights=None) -> float:
    """Weighted AUC via the Mann-Whitney statistic with midrank ties
    (equivalent to MLlib BinaryClassificationMetrics' trapezoidal ROC)."""
    scores = _as_np(scores)
    labels = _as_np(labels)
    w = np.ones(len(scores)) if weights is None else _as_np(weights)
    pos = labels >= 0.5
    w_pos = w[pos].sum()
    w_neg = w[~pos].sum()
    if w_pos == 0 or w_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    s = scores[order]
    ww = w[order]
    # Weighted midranks with ties, vectorized: rank = cum-weight strictly
    # below the tie block + half the block's weight (reduceat over tie-block
    # starts replaces the per-block python loop).
    cw_excl = np.cumsum(ww) - ww
    new_block = np.r_[True, s[1:] != s[:-1]]
    bstart = np.flatnonzero(new_block)
    bid = np.cumsum(new_block) - 1
    bw = np.add.reduceat(ww, bstart)
    ranks = cw_excl[bstart][bid] + bw[bid] / 2.0
    r = np.empty(len(s))
    r[order] = ranks
    u = (w[pos] * r[pos]).sum() - w_pos * w_pos / 2.0
    return float(u / (w_pos * w_neg))


def _pr_curve(scores, labels, weights=None):
    """Weighted precision/recall points at each distinct-score threshold,
    ordered by increasing recall (MLlib BinaryClassificationMetrics
    convention: the curve is prepended with (0, p_first))."""
    scores = _as_np(scores)
    labels = _as_np(labels)
    w = np.ones(len(scores)) if weights is None else _as_np(weights)
    pos = (labels >= 0.5).astype(np.float64)
    total_pos = (w * pos).sum()
    if total_pos == 0:
        return None
    order = np.argsort(-scores, kind="mergesort")
    s = scores[order]
    tp = np.cumsum(w[order] * pos[order])
    pred = np.cumsum(w[order])
    # Collapse tie blocks: keep the LAST index of each distinct score.
    last = np.r_[s[1:] != s[:-1], True]
    tp, pred = tp[last], pred[last]
    precision = tp / pred
    recall = tp / total_pos
    return precision, recall


def area_under_precision_recall(scores, labels, weights=None) -> float:
    """Weighted PR-AUC (trapezoidal; curve starts at (0, p_first) like
    MLlib areaUnderPR — reference metric AREA_UNDER_PRECISION_RECALL,
    ml/Evaluation.scala:81)."""
    curve = _pr_curve(scores, labels, weights)
    if curve is None:
        return float("nan")
    precision, recall = curve
    p = np.r_[precision[0], precision]
    r = np.r_[0.0, recall]
    # np.trapezoid is NumPy >= 2.0; np.trapz is its pre-2.0 name.
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return float(trapezoid(p, r))


def peak_f1_score(scores, labels, weights=None) -> float:
    """Max F1 over score thresholds (reference PEAK_F1_SCORE,
    ml/Evaluation.scala:83)."""
    curve = _pr_curve(scores, labels, weights)
    if curve is None:
        return float("nan")
    precision, recall = curve
    denom = precision + recall
    f1 = np.where(denom > 0, 2 * precision * recall / np.maximum(denom, 1e-300), 0.0)
    return float(f1.max())


@dataclasses.dataclass(frozen=True)
class AreaUnderROCCurveEvaluator(Evaluator):
    name: str = "AUC"

    @property
    def higher_is_better(self) -> bool:
        return True

    def _evaluate(self, pred, labels, weights, data) -> float:
        return area_under_roc_curve(pred, labels, weights)


@dataclasses.dataclass(frozen=True)
class RMSEEvaluator(Evaluator):
    name: str = "RMSE"

    def _evaluate(self, pred, labels, weights, data) -> float:
        return float(np.sqrt(
            np.sum(weights * (pred - labels) ** 2) / np.sum(weights)))


def _logistic_loss_np(z, y):
    return np.log1p(np.exp(-np.abs(z))) + np.maximum(z, 0) - y * z


@dataclasses.dataclass(frozen=True)
class LogisticLossEvaluator(Evaluator):
    name: str = "LOGISTIC_LOSS"

    def _evaluate(self, pred, labels, weights, data) -> float:
        return float(np.sum(weights * _logistic_loss_np(pred, labels)))


@dataclasses.dataclass(frozen=True)
class PoissonLossEvaluator(Evaluator):
    name: str = "POISSON_LOSS"

    def _evaluate(self, pred, labels, weights, data) -> float:
        return float(np.sum(weights * (np.exp(pred) - labels * pred)))


@dataclasses.dataclass(frozen=True)
class SquaredLossEvaluator(Evaluator):
    name: str = "SQUARED_LOSS"

    def _evaluate(self, pred, labels, weights, data) -> float:
        return float(np.sum(weights * 0.5 * (pred - labels) ** 2))


@dataclasses.dataclass(frozen=True)
class SmoothedHingeLossEvaluator(Evaluator):
    name: str = "SMOOTHED_HINGE_LOSS"

    def _evaluate(self, pred, labels, weights, data) -> float:
        t = (2 * labels - 1) * pred
        loss = np.where(t <= 0, 0.5 - t,
                        np.where(t < 1, 0.5 * (1 - t) ** 2, 0.0))
        return float(np.sum(weights * loss))


class _ShardedEvaluator(Evaluator):
    """Group rows by an id column; average the local metric over groups.

    Both sharded metrics are computed SORT-ONCE + segmented (np.lexsort +
    reduceat over group/tie-block starts) — one pass for any number of
    groups, replacing per-group python loops that dominated validation
    wallclock at 5k-1M groups (reference per-group path:
    ml/evaluation/ShardedAreaUnderROCCurveEvaluator.scala +
    AreaUnderROCCurveLocalEvaluator.scala)."""

    id_type: str

    def _codes(self, data) -> np.ndarray:
        return data.id_columns[self.id_type].codes


def sharded_auc(pred, labels, weights, codes) -> float:
    """Mean of per-group weighted AUCs (midrank ties), vectorized.

    Groups with a single class are skipped, matching the per-group NaN
    filter of the reference's sharded evaluator."""
    order = np.lexsort((pred, codes))
    g = np.asarray(codes)[order]
    s = np.asarray(pred)[order]
    w = np.asarray(weights, np.float64)[order]
    pos = np.asarray(labels)[order] >= 0.5
    if len(g) == 0:
        return float("nan")

    new_group = np.r_[True, g[1:] != g[:-1]]
    gstart = np.flatnonzero(new_group)
    gid = np.cumsum(new_group) - 1
    # Within-group cum weight strictly below each row.
    cw = np.cumsum(w)
    cw_excl = cw - w
    rel_excl = cw_excl - cw_excl[gstart][gid]
    # Tie blocks: same group AND same score.
    new_block = np.r_[True, (g[1:] != g[:-1]) | (s[1:] != s[:-1])]
    bstart = np.flatnonzero(new_block)
    bid = np.cumsum(new_block) - 1
    bw = np.add.reduceat(w, bstart)
    rank = rel_excl[bstart][bid] + bw[bid] / 2.0

    w_pos = np.add.reduceat(np.where(pos, w, 0.0), gstart)
    w_neg = np.add.reduceat(np.where(pos, 0.0, w), gstart)
    u = np.add.reduceat(np.where(pos, w * rank, 0.0), gstart) \
        - w_pos * w_pos / 2.0
    valid = (w_pos > 0) & (w_neg > 0)
    if not valid.any():
        return float("nan")
    return float(np.mean(u[valid] / (w_pos[valid] * w_neg[valid])))


def sharded_precision_at_k(pred, labels, codes, k: int) -> float:
    """Mean of per-group precision@k (stable descending score order),
    vectorized: one lexsort + positional mask + segmented sums."""
    pred = np.asarray(pred)
    codes = np.asarray(codes)
    order = np.lexsort((-pred, codes))
    g = codes[order]
    hit = (np.asarray(labels)[order] >= 0.5).astype(np.float64)
    n = len(g)
    if n == 0:
        return float("nan")
    new_group = np.r_[True, g[1:] != g[:-1]]
    gstart = np.flatnonzero(new_group)
    gid = np.cumsum(new_group) - 1
    in_top = (np.arange(n) - gstart[gid]) < k
    hits = np.add.reduceat(np.where(in_top, hit, 0.0), gstart)
    sizes = np.diff(np.r_[gstart, n])
    return float(np.mean(hits / np.minimum(k, sizes)))


@dataclasses.dataclass(frozen=True)
class ShardedAreaUnderROCCurveEvaluator(_ShardedEvaluator):
    id_type: str = ""
    name: str = ""

    def __post_init__(self):
        if not self.name:
            object.__setattr__(self, "name", f"AUC:{self.id_type}")

    @property
    def higher_is_better(self) -> bool:
        return True

    def _evaluate(self, pred, labels, weights, data) -> float:
        if data is None:
            raise ValueError("sharded evaluators need the dataset (id columns)")
        return sharded_auc(pred, labels, weights, self._codes(data))


@dataclasses.dataclass(frozen=True)
class ShardedPrecisionAtKEvaluator(_ShardedEvaluator):
    k: int = 1
    id_type: str = ""
    name: str = ""

    def __post_init__(self):
        if not self.name:
            object.__setattr__(self, "name", f"PRECISION@{self.k}:{self.id_type}")

    @property
    def higher_is_better(self) -> bool:
        return True

    def _evaluate(self, pred, labels, weights, data) -> float:
        if data is None:
            raise ValueError("sharded evaluators need the dataset (id columns)")
        return sharded_precision_at_k(pred, labels, self._codes(data), self.k)


_PLAIN = {
    "AUC": AreaUnderROCCurveEvaluator,
    "RMSE": RMSEEvaluator,
    "LOGISTIC_LOSS": LogisticLossEvaluator,
    "POISSON_LOSS": PoissonLossEvaluator,
    "SQUARED_LOSS": SquaredLossEvaluator,
    "SMOOTHED_HINGE_LOSS": SmoothedHingeLossEvaluator,
}


def build_evaluator(spec: str) -> Evaluator:
    """Parse an evaluator spec (reference: Evaluator.buildEvaluator +
    EvaluatorType/ShardedEvaluatorType parsing):
      'AUC' | 'RMSE' | '<LOSS>' | 'AUC:idType' | 'PRECISION@k:idType'
    """
    s = spec.strip()
    up = s.upper()
    if up in _PLAIN:
        return _PLAIN[up]()
    m = re.fullmatch(r"AUC:(\w+)", s, re.IGNORECASE)
    if m:
        return ShardedAreaUnderROCCurveEvaluator(id_type=m.group(1))
    m = re.fullmatch(r"PRECISION@(\d+):(\w+)", s, re.IGNORECASE)
    if m:
        return ShardedPrecisionAtKEvaluator(k=int(m.group(1)),
                                            id_type=m.group(2))
    raise ValueError(f"unknown evaluator spec {spec!r}")
