"""Feature-importance diagnostics (a copy of
photon_ml_tpu/diagnostics/feature_importance.py:1-119; reference:
ml/diagnostics/featureimportance/AbstractFeatureImportanceDiagnostic.scala,
ExpectedMagnitudeFeatureImportanceDiagnostic.scala,
VarianceFeatureImportanceDiagnostic.scala).

Importance of feature j:
  expected-magnitude: |coef_j · E|x_j||   (meanAbs from the data summary)
  variance:           |coef_j · Var x_j|
Without a summary both fall back to |coef_j| (summary factor 1.0), exactly
as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary

MAX_RANKED_FEATURES = 50
NUM_IMPORTANCE_FRACTILES = 100


@dataclasses.dataclass
class FeatureImportanceReport:
    """Ranked importances (reference: featureimportance/FeatureImportanceReport.scala)."""

    importance_type: str
    importance_description: str
    # (feature key, index, importance, human description), descending.
    ranked_features: List[Tuple[str, int, float, str]]
    # fractile (0..100) -> importance at that rank fractile.
    rank_to_importance: Dict[float, float]

    def to_dict(self) -> Dict:
        return {
            "importanceType": self.importance_type,
            "importanceDescription": self.importance_description,
            "rankedFeatures": [
                {"feature": k, "index": i, "importance": imp,
                 "description": desc}
                for k, i, imp, desc in self.ranked_features],
            "rankToImportance": self.rank_to_importance,
        }


def _build_report(
    importance_type: str,
    description: str,
    importances: np.ndarray,
    coefficients: np.ndarray,
    feature_names: Optional[List[str]],
    summary: Optional[BasicStatisticalSummary],
) -> FeatureImportanceReport:
    order = np.argsort(-importances, kind="stable")
    n = len(order)

    # Importance at evenly spaced rank fractiles
    # (AbstractFeatureImportanceDiagnostic.scala getRankToImportance; the
    # reference divides by MAX_RANKED_FEATURES there, flat-lining the upper
    # half of the curve — corrected here to true fractiles).
    rank_to_importance = {}
    for f in range(NUM_IMPORTANCE_FRACTILES + 1):
        idx = min(n - 1, f * n // NUM_IMPORTANCE_FRACTILES)
        rank_to_importance[100.0 * f / NUM_IMPORTANCE_FRACTILES] = \
            float(importances[order[idx]])

    ranked = []
    for idx in order[:MAX_RANKED_FEATURES]:
        idx = int(idx)
        key = feature_names[idx] if feature_names else str(idx)
        desc = (f"Feature [{key}] importance = "
                f"[{importances[idx]:.3f}], coefficient = "
                f"[{coefficients[idx]:.6g}]")
        if summary is not None:
            desc += (f" min=[{summary.min[idx]}], mean=[{summary.mean[idx]}],"
                     f" max=[{summary.max[idx]}],"
                     f" variance=[{summary.variance[idx]}]")
        ranked.append((key, idx, float(importances[idx]), desc))

    return FeatureImportanceReport(
        importance_type=importance_type,
        importance_description=description,
        ranked_features=ranked,
        rank_to_importance=rank_to_importance)


def expected_magnitude_importance(
    coefficients,
    summary: Optional[BasicStatisticalSummary] = None,
    feature_names: Optional[List[str]] = None,
) -> FeatureImportanceReport:
    """|coef · meanAbs| per feature
    (ExpectedMagnitudeFeatureImportanceDiagnostic.scala:42-57)."""
    coef = np.asarray(coefficients, np.float64)
    factor = summary.mean_abs if summary is not None else 1.0
    return _build_report(
        "Inner product expectation",
        "Expected magnitude of inner product contribution"
        if summary is not None else "Magnitude of feature coefficient",
        np.abs(coef * factor), coef, feature_names, summary)


def variance_importance(
    coefficients,
    summary: Optional[BasicStatisticalSummary] = None,
    feature_names: Optional[List[str]] = None,
) -> FeatureImportanceReport:
    """|coef · Var x| per feature
    (VarianceFeatureImportanceDiagnostic.scala:42-56)."""
    coef = np.asarray(coefficients, np.float64)
    factor = summary.variance if summary is not None else 1.0
    return _build_report(
        "Inner product variance",
        "Expected inner product variance contribution"
        if summary is not None else "Magnitude of feature coefficient",
        np.abs(coef * factor), coef, feature_names, summary)
