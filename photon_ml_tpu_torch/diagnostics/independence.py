"""Prediction-error independence diagnostic (a copy of
photon_ml_tpu/diagnostics/independence.py:1-145; reference:
ml/diagnostics/independence/PredictionErrorIndependenceDiagnostic.scala,
KendallTauAnalysis.scala — Kendall rank correlation between predictions
and residuals; under a well-specified model they should be independent).

The O(n²) concordant/discordant pair count is vectorized over a ≤5000-row
sample (the reference's MAXIMUM_SAMPLE_SIZE) instead of a Spark cartesian.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
from scipy.stats import norm

MAXIMUM_SAMPLE_SIZE = 5000


@dataclasses.dataclass
class KendallTauReport:
    """Counts + tau statistics (independence/KendallTauReport.scala)."""

    num_concordant: int
    num_discordant: int
    num_items: int
    num_pairs: int
    effective_pairs: int
    tau_alpha: float
    tau_beta: float
    z_alpha: float
    # Two-sided p-value of z under H0 (independence): small => dependence.
    p_value: float
    # P(|Z| <= |z|) — the quantity the reference serializes as "pValue"
    # (KendallTauAnalysis.scala): large => dependence. Kept for parity,
    # under a name that says what it is.
    confidence: float
    message: str = ""

    def to_dict(self) -> Dict:
        return {
            "numConcordant": self.num_concordant,
            "numDiscordant": self.num_discordant,
            "numItems": self.num_items,
            "numPairs": self.num_pairs,
            "effectivePairs": self.effective_pairs,
            "tauAlpha": self.tau_alpha,
            "tauBeta": self.tau_beta,
            "zAlpha": self.z_alpha,
            "pValue": self.p_value,
            "confidence": self.confidence,
            "message": self.message,
        }


def kendall_tau_analysis(a, b) -> KendallTauReport:
    """Tau-alpha/tau-beta with tie accounting, matching
    KendallTauAnalysis.analyze (concordance rules at
    KendallTauAnalysis.scala checkConcordance: ties in the first variable
    count as TIES_A regardless of the second)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n = len(a)

    # Pairwise sign comparison over the strict upper triangle, in row
    # blocks: O(block·n) peak memory instead of the O(n²) dense matrices a
    # full outer difference would allocate (~1 GB at the 5000-row cap).
    ties_a = ties_b = concordant = discordant = 0
    block = 256
    for start in range(0, n, block):
        rows = slice(start, min(start + block, n))
        sa = np.sign(a[rows, None] - a[None, :])
        sb = np.sign(b[rows, None] - b[None, :])
        # Keep only strict-upper-triangle pairs (j > i).
        mask = np.arange(n)[None, :] > np.arange(start, rows.stop)[:, None]
        sa_ne = (sa != 0) & mask
        ties_a += int(np.sum((sa == 0) & mask))
        ties_b += int(np.sum(sa_ne & (sb == 0)))
        concordant += int(np.sum(sa_ne & (sa == sb)))
        discordant += int(np.sum(sa_ne & (sb != 0) & (sa != sb)))

    num_pairs = n * (n - 1) // 2
    effective = concordant + discordant
    tau_alpha = ((concordant - discordant) / effective
                 if effective > 0 else 0.0)
    no_ties_a = num_pairs - ties_a
    no_ties_b = num_pairs - ties_b
    tau_beta = ((concordant - discordant)
                / np.sqrt(float(no_ties_a) * float(no_ties_b))
                if no_ties_a > 0 and no_ties_b > 0 else 0.0)

    # z ~ N(0,1) under independence: tau / sqrt(2(2n+5) / (9n(n-1))).
    denom = 9.0 * n * (n - 1)
    d = np.sqrt(2.0 * (2.0 * n + 5.0) / denom) if denom > 0 else 1.0
    z_alpha = tau_alpha / d
    confidence = float(norm.cdf(abs(z_alpha)) - norm.cdf(-abs(z_alpha)))
    p_value = 1.0 - confidence

    message = ""
    if ties_a + ties_b > 0:
        message = (f"Detected ties (first variable: {ties_a}, second "
                   f"variable: {ties_b}); the tau-alpha z-score "
                   "over-estimates independence.")

    return KendallTauReport(
        num_concordant=concordant, num_discordant=discordant, num_items=n,
        num_pairs=num_pairs, effective_pairs=effective,
        tau_alpha=float(tau_alpha), tau_beta=float(tau_beta),
        z_alpha=float(z_alpha), p_value=p_value, confidence=confidence,
        message=message)


@dataclasses.dataclass
class PredictionErrorIndependenceReport:
    predictions: np.ndarray
    errors: np.ndarray
    kendall_tau: KendallTauReport

    def to_dict(self) -> Dict:
        return {
            "sampleSize": int(len(self.predictions)),
            "kendallTau": self.kendall_tau.to_dict(),
        }


def prediction_error_independence(
    labels, predictions, seed: int = 0,
) -> PredictionErrorIndependenceReport:
    """Sample ≤5000 (prediction, label − prediction) points without
    replacement and run the Kendall-tau analysis
    (PredictionErrorIndependenceDiagnostic.scala:36-50)."""
    labels = np.asarray(labels, np.float64)
    predictions = np.asarray(predictions, np.float64)
    errors = labels - predictions

    n = len(predictions)
    if n > MAXIMUM_SAMPLE_SIZE:
        idx = np.random.default_rng(seed).choice(
            n, MAXIMUM_SAMPLE_SIZE, replace=False)
        predictions, errors = predictions[idx], errors[idx]

    return PredictionErrorIndependenceReport(
        predictions=predictions, errors=errors,
        kendall_tau=kendall_tau_analysis(predictions, errors))
