"""Evaluators for validation metrics (a copy of
photon_ml_tpu/evaluation/__init__.py)."""

from photon_ml_tpu_torch.evaluation.evaluators import (
    Evaluator,
    METRIC_METADATA,
    MetricMetadata,
    metadata_for,
    AreaUnderROCCurveEvaluator,
    RMSEEvaluator,
    LogisticLossEvaluator,
    PoissonLossEvaluator,
    SquaredLossEvaluator,
    SmoothedHingeLossEvaluator,
    ShardedAreaUnderROCCurveEvaluator,
    ShardedPrecisionAtKEvaluator,
    build_evaluator,
)

__all__ = [
    "Evaluator",
    "METRIC_METADATA",
    "MetricMetadata",
    "metadata_for",
    "AreaUnderROCCurveEvaluator",
    "RMSEEvaluator",
    "LogisticLossEvaluator",
    "PoissonLossEvaluator",
    "SquaredLossEvaluator",
    "SmoothedHingeLossEvaluator",
    "ShardedAreaUnderROCCurveEvaluator",
    "ShardedPrecisionAtKEvaluator",
    "build_evaluator",
]
