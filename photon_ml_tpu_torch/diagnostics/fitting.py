"""Learning-curve fitting diagnostic (a copy of
photon_ml_tpu/diagnostics/fitting.py:1-102; reference:
ml/diagnostics/fitting/FittingDiagnostic.scala — rows tagged uniformly into
10 partitions, the last held out; models re-trained on cumulative
fractions with warm starts, train/holdout metrics recorded per fraction).

Each fraction's re-fit is one more train_glm_models call; only the batch
contents change.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np

NUM_TRAINING_PARTITIONS = 10
MIN_SAMPLES_PER_PARTITION_PER_DIMENSION = 10

TrainFn = Callable[[np.ndarray, np.ndarray, Mapping[float, object]],
                   List[Tuple[float, object, Dict[str, float]]]]


@dataclasses.dataclass
class FittingReport:
    """Per-λ learning curves: metric name -> (data portions %, train metric
    values, holdout metric values), portions ascending
    (ml/diagnostics/fitting/FittingReport.scala)."""

    metrics: Dict[str, Tuple[List[float], List[float], List[float]]]
    message: str = ""

    def to_dict(self) -> Dict:
        return {
            "message": self.message,
            "metrics": {
                name: {"dataPortions": p, "train": tr, "holdout": te}
                for name, (p, tr, te) in self.metrics.items()
            },
        }


def fitting_diagnostic(
    num_rows: int,
    num_dimensions: int,
    train_fn: TrainFn,
    warm_start: Mapping[float, object] | None = None,
    seed: int = 0,
) -> Dict[float, FittingReport]:
    """Returns λ -> FittingReport, or {} when the dataset is too small for
    meaningful curves (total rows ≤ 10·dim — the reference's guard,
    FittingDiagnostic.scala `numSamples > dimension *
    MIN_SAMPLES_PER_PARTITION_PER_DIMENSION`, which despite the constant's
    name bounds the total row count).

    train_fn(train_idx, holdout_idx, warm_start) returns either
    [(λ, model, train_metrics, holdout_metrics)] or
    [(λ, model, holdout_metrics)] (train curves left NaN)."""
    min_samples = num_dimensions * MIN_SAMPLES_PER_PARTITION_PER_DIMENSION
    if num_rows <= min_samples:
        return {}

    rng = np.random.default_rng(seed)
    tags = rng.integers(0, NUM_TRAINING_PARTITIONS, num_rows)
    holdout_idx = np.flatnonzero(tags == NUM_TRAINING_PARTITIONS - 1)

    warm = dict(warm_start or {})
    # λ -> metric -> (portions, train values, holdout values)
    curves: Dict[float, Dict[str, Tuple[List[float], List[float],
                                        List[float]]]] = {}
    for max_tag in range(NUM_TRAINING_PARTITIONS - 1):
        train_idx = np.flatnonzero(tags <= max_tag)
        portion = 100.0 * len(train_idx) / num_rows
        for lam, model, train_metrics, holdout_metrics in _train_both(
                train_fn, train_idx, holdout_idx, warm):
            warm[lam] = model
            by_metric = curves.setdefault(lam, {})
            for name, test_value in holdout_metrics.items():
                p, tr, te = by_metric.setdefault(name, ([], [], []))
                p.append(portion)
                tr.append(train_metrics.get(name, float("nan")))
                te.append(test_value)

    return {lam: FittingReport(metrics=by_metric)
            for lam, by_metric in curves.items()}


def _train_both(train_fn, train_idx, holdout_idx, warm):
    """One fraction's λ-grid fit, evaluated on both splits. The trainer is
    called once per eval split but re-fits only once when it caches by
    (train split, warm start); our driver-side trainer evaluates both
    splits in one call by returning metrics keyed by split."""
    results = train_fn(train_idx, holdout_idx, warm)
    out = []
    for item in results:
        if len(item) == 4:
            lam, model, train_metrics, holdout_metrics = item
        else:
            lam, model, holdout_metrics = item
            train_metrics = {}
        out.append((lam, model, train_metrics, holdout_metrics))
    return out
