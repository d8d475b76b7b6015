"""Model/training diagnostics (a copy of photon_ml_tpu/diagnostics/
__init__.py:1-65; every module here is a copy of its JAX namesake, numpy
and scipy only; reference: ml/diagnostics/, 78 files —
fitting, bootstrap, feature importance, prediction-error independence,
Hosmer-Lemeshow, and the report-generation framework feeding
model-diagnostic.html from ml/Driver.scala:524-551,617-637).

Training-heavy diagnostics (fitting curves, bootstrap) reuse the GLM
solve path — a subset re-fit is one more train_glm_models call on the
device, not a new Spark job. The statistics themselves are
host-side numpy/scipy (they are O(n) postprocessing, not device work).
Reports render to JSON + a small self-contained HTML page whose charts
(learning curves, bootstrap CI whiskers, Hosmer-Lemeshow calibration,
feature importance) are dependency-free inline SVG (svg_charts.py) —
the vector replacement for the reference's xchart raster plots.
"""

from photon_ml_tpu_torch.diagnostics.bootstrap import (
    BootstrapReport,
    CoefficientSummary,
    aggregate_coefficient_confidence_intervals,
    aggregate_metrics_confidence_intervals,
    bootstrap_training,
)
from photon_ml_tpu_torch.diagnostics.feature_importance import (
    FeatureImportanceReport,
    expected_magnitude_importance,
    variance_importance,
)
from photon_ml_tpu_torch.diagnostics.fitting import FittingReport, fitting_diagnostic
from photon_ml_tpu_torch.diagnostics.hl import (
    HosmerLemeshowReport,
    hosmer_lemeshow_diagnostic,
)
from photon_ml_tpu_torch.diagnostics.independence import (
    KendallTauReport,
    kendall_tau_analysis,
    prediction_error_independence,
)
from photon_ml_tpu_torch.diagnostics.reporting import (
    DiagnosticMode,
    DiagnosticReport,
    render_html_report,
    write_report,
)

__all__ = [
    "BootstrapReport",
    "CoefficientSummary",
    "DiagnosticMode",
    "DiagnosticReport",
    "FeatureImportanceReport",
    "FittingReport",
    "HosmerLemeshowReport",
    "KendallTauReport",
    "aggregate_coefficient_confidence_intervals",
    "aggregate_metrics_confidence_intervals",
    "bootstrap_training",
    "expected_magnitude_importance",
    "fitting_diagnostic",
    "hosmer_lemeshow_diagnostic",
    "kendall_tau_analysis",
    "prediction_error_independence",
    "render_html_report",
    "variance_importance",
    "write_report",
]
