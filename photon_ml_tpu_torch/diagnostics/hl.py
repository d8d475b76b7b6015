"""Hosmer-Lemeshow goodness-of-fit test for logistic regression
(a copy of photon_ml_tpu/diagnostics/hl.py:1-154; reference:
ml/diagnostics/hl/HosmerLemeshowDiagnostic.scala,
DefaultPredictedProbabilityVersusObservedFrequencyBinner.scala,
PredictedProbabilityVersusObservedFrequencyHistogramBin.scala).

Uniform-width probability bins; expected positives per bin use the bin
midpoint (ceil(total · midpoint)); χ² over pos+neg deviations with
dof = bins − 2.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
from scipy.stats import chi2

MINIMUM_EXPECTED_IN_BUCKET = 5
STANDARD_CONFIDENCE_LEVELS = (
    0.000001, 0.01, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5,
    0.6, 0.7, 0.8, 0.9, 0.95, 0.99, 0.999999)
# Heuristic factor for the data-driven bin-count estimate. The reference
# declares separate A/B factors but applies A to both terms
# (DefaultPredictedProbabilityVersusObservedFrequencyBinner.scala:50-53);
# behavior is matched here.
_DATA_HEURISTIC_FACTOR = 0.9


@dataclasses.dataclass
class HistogramBin:
    lower_bound: float
    upper_bound: float
    observed_pos: int = 0
    observed_neg: int = 0

    @property
    def total(self) -> int:
        return self.observed_pos + self.observed_neg

    @property
    def expected_pos(self) -> int:
        midpoint = 0.5 * (self.lower_bound + self.upper_bound)
        return int(np.ceil(self.total * midpoint))

    @property
    def expected_neg(self) -> int:
        return self.total - self.expected_pos

    def to_dict(self) -> Dict:
        return {
            "lowerBound": self.lower_bound, "upperBound": self.upper_bound,
            "observedPos": self.observed_pos,
            "observedNeg": self.observed_neg,
            "expectedPos": self.expected_pos,
            "expectedNeg": self.expected_neg,
        }


def default_bin_count(num_items: int, num_dimensions: int) -> int:
    """min(dim-driven, data-driven) uniform bins, ≥2
    (DefaultPredictedProbabilityVersusObservedFrequencyBinner.scala:30-53)."""
    from_dims = num_dimensions + 2
    from_data = int(_DATA_HEURISTIC_FACTOR * np.sqrt(num_items)
                    + _DATA_HEURISTIC_FACTOR * np.log1p(num_items))
    return max(2, min(from_dims, from_data))


@dataclasses.dataclass
class HosmerLemeshowReport:
    """χ² score + context (hl/HosmerLemeshowReport.scala)."""

    chi_square: float
    degrees_of_freedom: int
    prob_at_chi_square: float
    cutoffs: List[Tuple[float, float]]
    bins: List[HistogramBin]
    binning_message: str = ""
    chi_square_message: str = ""

    @property
    def p_value(self) -> float:
        """P(χ² ≥ observed) under H0: the model fits."""
        return 1.0 - self.prob_at_chi_square

    def to_dict(self) -> Dict:
        return {
            "chiSquare": self.chi_square,
            "degreesOfFreedom": self.degrees_of_freedom,
            "probAtChiSquare": self.prob_at_chi_square,
            "pValue": self.p_value,
            "cutoffs": [{"confidence": c, "chiSquare": x}
                        for c, x in self.cutoffs],
            "bins": [b.to_dict() for b in self.bins],
            "binningMessage": self.binning_message,
            "chiSquareMessage": self.chi_square_message,
        }


def hosmer_lemeshow_diagnostic(
    labels,
    predicted_probabilities,
    num_dimensions: int,
    num_bins: int | None = None,
) -> HosmerLemeshowReport:
    """HL χ² test from (label ∈ {0,1}, predicted probability) pairs
    (HosmerLemeshowDiagnostic.scala:47-90)."""
    labels = np.asarray(labels, np.float64)
    probs = np.asarray(predicted_probabilities, np.float64)
    n = len(labels)
    if num_bins is None:
        num_bins = default_bin_count(n, num_dimensions)

    edges = np.linspace(0.0, 1.0, num_bins + 1)
    # Rightmost bin is inclusive of 1.0.
    which = np.clip(np.digitize(probs, edges[1:-1]), 0, num_bins - 1)
    pos = labels >= 0.5

    bins: List[HistogramBin] = []
    messages: List[str] = []
    chi_square = 0.0
    for i in range(num_bins):
        in_bin = which == i
        b = HistogramBin(
            lower_bound=float(edges[i]), upper_bound=float(edges[i + 1]),
            observed_pos=int(np.sum(in_bin & pos)),
            observed_neg=int(np.sum(in_bin & ~pos)))
        bins.append(b)
        if b.expected_pos > 0:
            chi_square += ((b.observed_pos - b.expected_pos) ** 2
                           / b.expected_pos)
        if b.expected_pos < MINIMUM_EXPECTED_IN_BUCKET:
            messages.append(
                f"Bin [{b.lower_bound:.3f}, {b.upper_bound:.3f}): expected "
                "positive count too small for a sound chi^2 estimate")
        if b.expected_neg > 0:
            chi_square += ((b.observed_neg - b.expected_neg) ** 2
                           / b.expected_neg)
        if b.expected_neg < MINIMUM_EXPECTED_IN_BUCKET:
            messages.append(
                f"Bin [{b.lower_bound:.3f}, {b.upper_bound:.3f}): expected "
                "negative count too small for a sound chi^2 estimate")

    dof = max(1, num_bins - 2)
    dist = chi2(dof)
    cutoffs = [(c, float(dist.ppf(c))) for c in STANDARD_CONFIDENCE_LEVELS]
    prob = float(dist.cdf(chi_square))

    return HosmerLemeshowReport(
        chi_square=float(chi_square), degrees_of_freedom=dof,
        prob_at_chi_square=prob, cutoffs=cutoffs, bins=bins,
        binning_message=f"{num_bins} uniform bins over [0, 1] "
                        f"({n} samples, {num_dimensions} dimensions)",
        chi_square_message="\n".join(messages))
