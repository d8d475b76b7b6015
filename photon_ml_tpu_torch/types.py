"""Common enums (port of photon_ml_tpu/types.py:12-45).

Mirrors the task-type vocabulary of the reference
(photon-ml/src/main/scala/com/linkedin/photon/ml/TaskType.scala).
"""

from __future__ import annotations

import enum


class TaskType(str, enum.Enum):
    """Supported training task types."""

    LOGISTIC_REGRESSION = "LOGISTIC_REGRESSION"
    LINEAR_REGRESSION = "LINEAR_REGRESSION"
    POISSON_REGRESSION = "POISSON_REGRESSION"
    SMOOTHED_HINGE_LOSS_LINEAR_SVM = "SMOOTHED_HINGE_LOSS_LINEAR_SVM"

    @property
    def is_classification(self) -> bool:
        return self in (
            TaskType.LOGISTIC_REGRESSION,
            TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
        )


class NormalizationType(str, enum.Enum):
    """Feature normalization flavors.

    Reference: ml/normalization/NormalizationType.java:25-40.
    """

    NONE = "NONE"
    SCALE_WITH_STANDARD_DEVIATION = "SCALE_WITH_STANDARD_DEVIATION"
    SCALE_WITH_MAX_MAGNITUDE = "SCALE_WITH_MAX_MAGNITUDE"
    STANDARDIZATION = "STANDARDIZATION"


class DataValidationType(str, enum.Enum):
    """How much input validation to run (reference: ml/DataValidationType.scala)."""

    VALIDATE_FULL = "VALIDATE_FULL"
    VALIDATE_SAMPLE = "VALIDATE_SAMPLE"
    VALIDATE_DISABLED = "VALIDATE_DISABLED"
