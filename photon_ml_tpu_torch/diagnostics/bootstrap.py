"""Bootstrap training and coefficient/metric confidence intervals
(a copy of photon_ml_tpu/diagnostics/bootstrap.py:1-122; reference:
ml/BootstrapTraining.scala:28-180 and
ml/supervised/model/CoefficientSummary.scala).

The reference tags rows into 1000 splits, shuffles split ids per bootstrap
draw, and re-trains a λ-grid on each draw; aggregates are per-coefficient
and per-metric streaming summaries. Here each draw is a row-index subset fed
back through the λ-grid solve (train_glm_models) on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np

# A trainer maps (train_indices, holdout_indices, warm_start by λ) to
# [(λ, model, holdout_metrics)]. The driver curries train_glm_models +
# evaluate_glm into this shape, the analog of the reference's curried
# trainModel closure plus Evaluation.evaluate on the holdout
# (ml/BootstrapTraining.scala:132-140,158-161).
TrainFn = Callable[[np.ndarray, np.ndarray, Mapping[float, object]],
                   List[Tuple[float, object, Dict[str, float]]]]

# Never use more than 90% of the splits for training, matching the
# reference's guard (ml/BootstrapTraining.scala:146-149).
_NUM_SPLITS = 1000
_MAX_TRAIN_SPLITS = 900


# The canonical CoefficientSummary lives with the model-tracking surface
# (ml/supervised/model/CoefficientSummary.scala); re-exported here for the
# bootstrap CI aggregates.
from photon_ml_tpu_torch.models.tracking import (  # noqa: E402
    CoefficientSummary,
    summarize_coefficients,
)


def aggregate_coefficient_confidence_intervals(
    models_and_metrics: Sequence[Tuple[object, Dict[str, float]]],
) -> List[CoefficientSummary]:
    """Per-coefficient summaries across bootstrap models, 1:1 with the
    coefficient vector (ml/BootstrapTraining.scala:46-70)."""
    return summarize_coefficients([m for m, _ in models_and_metrics])


def aggregate_metrics_confidence_intervals(
    models_and_metrics: Sequence[Tuple[object, Dict[str, float]]],
) -> Dict[str, CoefficientSummary]:
    """Per-metric summaries across bootstrap holdout evaluations
    (ml/BootstrapTraining.scala:90-99)."""
    out: Dict[str, CoefficientSummary] = {}
    for _, metrics in models_and_metrics:
        for name, value in metrics.items():
            out.setdefault(name, CoefficientSummary()).accumulate(value)
    return out


@dataclasses.dataclass
class BootstrapReport:
    """Aggregates for one λ."""

    coefficient_intervals: List[CoefficientSummary]
    metric_intervals: Dict[str, CoefficientSummary]
    num_models: int

    def to_dict(self) -> Dict:
        return {
            "numModels": self.num_models,
            "metricIntervals": {k: v.to_dict()
                                for k, v in self.metric_intervals.items()},
            "coefficientIntervals": [s.to_dict()
                                     for s in self.coefficient_intervals],
        }


def bootstrap_training(
    num_rows: int,
    train_fn: TrainFn,
    num_bootstrap_samples: int = 4,
    population_portion: float = 0.9,
    warm_start: Mapping[float, object] | None = None,
    seed: int = 0,
) -> Dict[float, BootstrapReport]:
    """Draw bootstrap train/holdout splits, re-train the λ grid per draw,
    and aggregate coefficient + metric confidence intervals per λ
    (ml/BootstrapTraining.scala:120-180). Split mechanics follow the
    reference: rows tagged into 1000 uniform splits once; each draw
    shuffles split ids and takes min(900, portion·1000) of them."""
    if num_bootstrap_samples <= 1:
        raise ValueError(
            f"need >1 bootstrap samples, got {num_bootstrap_samples}")
    if not 0.0 < population_portion <= 1.0:
        raise ValueError(
            f"population portion must be in (0, 1], got {population_portion}")

    rng = np.random.default_rng(seed)
    tags = rng.integers(0, _NUM_SPLITS, num_rows)
    target_splits = min(_MAX_TRAIN_SPLITS,
                        int(population_portion * _NUM_SPLITS))
    warm = dict(warm_start or {})

    per_lambda: Dict[float, List[Tuple[object, Dict[str, float]]]] = {}
    for _ in range(num_bootstrap_samples):
        shuffled = rng.permutation(_NUM_SPLITS)
        train_mask = np.isin(tags, shuffled[:target_splits])
        train_idx = np.flatnonzero(train_mask)
        holdout_idx = np.flatnonzero(~train_mask)
        for lam, model, metrics in train_fn(train_idx, holdout_idx, warm):
            per_lambda.setdefault(lam, []).append((model, metrics))

    return {
        lam: BootstrapReport(
            coefficient_intervals=
            aggregate_coefficient_confidence_intervals(mm),
            metric_intervals=aggregate_metrics_confidence_intervals(mm),
            num_models=len(mm))
        for lam, mm in per_lambda.items()
    }
