"""Input sanity checks (a copy of photon_ml_tpu/data/validators.py:1-62;
reference: ml/data/DataValidators.scala:1-140).

VALIDATE_FULL checks every row; VALIDATE_SAMPLE checks a deterministic ~10%
subsample; VALIDATE_DISABLED skips. Raises ValueError listing every failed
check (the reference aggregates failures the same way before aborting).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import scipy.sparse as sp

from photon_ml_tpu_torch.types import DataValidationType, TaskType


def validate_data(
    task: TaskType,
    features: sp.spmatrix | np.ndarray,
    labels: np.ndarray,
    offsets: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    validation_type: DataValidationType = DataValidationType.VALIDATE_FULL,
) -> None:
    if validation_type == DataValidationType.VALIDATE_DISABLED:
        return
    n = len(labels)
    if validation_type == DataValidationType.VALIDATE_SAMPLE:
        rows = np.arange(0, n, 10)
    else:
        rows = np.arange(n)

    y = np.asarray(labels)[rows]
    errors: List[str] = []

    if not np.all(np.isfinite(y)):
        errors.append("labels contain non-finite values")
    if task == TaskType.LOGISTIC_REGRESSION or \
            task == TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM:
        if not np.all(np.isin(y[np.isfinite(y)], (0.0, 1.0))):
            errors.append(f"{task.value} requires binary 0/1 labels")
    if task == TaskType.POISSON_REGRESSION:
        if np.any(y[np.isfinite(y)] < 0):
            errors.append("POISSON_REGRESSION requires non-negative labels")

    f = features[rows] if sp.issparse(features) else \
        np.asarray(features)[rows]
    fdata = f.data if sp.issparse(f) else f
    if not np.all(np.isfinite(fdata)):
        errors.append("features contain non-finite values")

    if offsets is not None and not np.all(
            np.isfinite(np.asarray(offsets)[rows])):
        errors.append("offsets contain non-finite values")
    if weights is not None:
        w = np.asarray(weights)[rows]
        if not np.all(np.isfinite(w)) or np.any(w < 0):
            errors.append("weights must be finite and non-negative")

    if errors:
        raise ValueError("input validation failed: " + "; ".join(errors))
