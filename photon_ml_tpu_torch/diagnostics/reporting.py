"""Diagnostic report assembly and rendering (a copy of
photon_ml_tpu/diagnostics/reporting.py:1-219; reference:
ml/diagnostics/DiagnosticMode.scala and the reporting framework under
ml/diagnostics/reporting/{base,html,text,reports}/ — logical chapters and
sections rendered to model-diagnostic.html via ml/Driver.scala:617-637).

Every plot the reference renders via xchart (learning curves, bootstrap
confidence intervals, Hosmer-Lemeshow calibration — photon-ml/build.gradle:61,
ml/diagnostics/reporting/html/) is rendered here as dependency-free inline
SVG (diagnostics/svg_charts.py) alongside the data tables, and the full data
behind every chart also lands in model-diagnostic.json ("notebook-friendly
JSON", SURVEY §2.11).
"""

from __future__ import annotations

import dataclasses
import enum
import html
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

from photon_ml_tpu_torch.diagnostics import svg_charts


class DiagnosticMode(str, enum.Enum):
    """Which diagnostics run (ml/diagnostics/DiagnosticMode.scala)."""

    NONE = "NONE"
    TRAIN = "TRAIN"
    VALIDATE = "VALIDATE"
    ALL = "ALL"

    @property
    def train_enabled(self) -> bool:
        return self in (DiagnosticMode.TRAIN, DiagnosticMode.ALL)

    @property
    def validate_enabled(self) -> bool:
        return self in (DiagnosticMode.VALIDATE, DiagnosticMode.ALL)


@dataclasses.dataclass
class ModelDiagnosticReport:
    """Per-model (per-λ) chapter
    (reporting/reports/model/ModelDiagnosticReport.scala)."""

    model_description: str
    reg_weight: float
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    feature_importance: List[Dict] = dataclasses.field(default_factory=list)
    fitting: Optional[Dict] = None
    bootstrap: Optional[Dict] = None
    hosmer_lemeshow: Optional[Dict] = None
    prediction_error_independence: Optional[Dict] = None

    def to_dict(self) -> Dict:
        out: Dict[str, Any] = {
            "modelDescription": self.model_description,
            "lambda": self.reg_weight,
            "metrics": self.metrics,
        }
        if self.feature_importance:
            out["featureImportance"] = self.feature_importance
        for key, value in (
                ("fitting", self.fitting),
                ("bootstrap", self.bootstrap),
                ("hosmerLemeshow", self.hosmer_lemeshow),
                ("predictionErrorIndependence",
                 self.prediction_error_independence)):
            if value is not None:
                out[key] = value
        return out


@dataclasses.dataclass
class DiagnosticReport:
    """Whole-job document: system chapter + one chapter per model
    (reporting/reports/combined/DiagnosticReport.scala)."""

    system: Dict[str, Any] = dataclasses.field(default_factory=dict)
    models: List[ModelDiagnosticReport] = dataclasses.field(
        default_factory=list)

    def to_dict(self) -> Dict:
        return {"system": self.system,
                "models": [m.to_dict() for m in self.models]}


def _feature_label(key: Any) -> str:
    """Human-readable 'name' / 'name:term' from a \\x01-delimited key."""
    from photon_ml_tpu_torch.data.index_map import split_key

    name, term = split_key(str(key))
    return f"{name}:{term}" if term else name


def _render_value(value: Any) -> str:
    if isinstance(value, float):
        return f"{value:.6g}"
    return html.escape(str(value))


def _render_table(rows: List[Dict[str, Any]]) -> str:
    if not rows:
        return ""
    cols = list(rows[0].keys())
    head = "".join(f"<th>{html.escape(str(c))}</th>" for c in cols)
    body = "".join(
        "<tr>" + "".join(
            f"<td>{_render_value(r.get(c, ''))}</td>" for c in cols)
        + "</tr>"
        for r in rows)
    return f"<table><tr>{head}</tr>{body}</table>"


def _render_kv(d: Dict[str, Any]) -> str:
    rows = "".join(
        f"<tr><th>{html.escape(str(k))}</th>"
        f"<td>{_render_value(v)}</td></tr>"
        for k, v in d.items() if not isinstance(v, (dict, list)))
    return f"<table>{rows}</table>" if rows else ""


def render_html_report(report: DiagnosticReport, title: str =
                       "Photon-ML-TPU model diagnostics") -> str:
    parts = [
        "<!DOCTYPE html><html><head><meta charset='utf-8'>",
        f"<title>{html.escape(title)}</title>",
        "<style>body{font-family:sans-serif;margin:2em;}"
        "table{border-collapse:collapse;margin:0.5em 0;}"
        "td,th{border:1px solid #999;padding:2px 8px;text-align:left;}"
        "h2{border-bottom:1px solid #ccc;}</style></head><body>",
        f"<h1>{html.escape(title)}</h1>",
        "<h2>System</h2>", _render_kv(report.system),
    ]
    for chapter in report.models:
        parts.append(f"<h2>{html.escape(chapter.model_description)} "
                     f"(&lambda;={chapter.reg_weight:g})</h2>")
        if chapter.metrics:
            parts.append("<h3>Metrics</h3>")
            parts.append(_render_kv(chapter.metrics))
        for fi in chapter.feature_importance:
            parts.append(
                f"<h3>Feature importance: "
                f"{html.escape(fi.get('importanceType', ''))}</h3>")
            ranked = fi.get("rankedFeatures", [])[:20]
            bars = [(_feature_label(r.get("name", r.get("feature", i)))[:12],
                     float(r.get("importance", 0.0)))
                    for i, r in enumerate(ranked)]
            parts.append(svg_charts.bar_chart(
                bars, ylabel="importance"))
            parts.append(_render_table(ranked))
        if chapter.fitting:
            parts.append("<h3>Learning curves</h3>")
            for metric, curve in chapter.fitting.get("metrics", {}).items():
                parts.append(f"<h4>{html.escape(metric)}</h4>")
                # The fitting-diagnostic plot (reference:
                # ml/diagnostics/fitting/FittingDiagnostic + xchart).
                parts.append(svg_charts.line_chart(
                    {"train": (curve["dataPortions"], curve["train"]),
                     "holdout": (curve["dataPortions"], curve["holdout"])},
                    xlabel="training data portion", ylabel=metric))
                parts.append(_render_table([
                    {"data %": p, "train": tr, "holdout": te}
                    for p, tr, te in zip(curve["dataPortions"],
                                         curve["train"],
                                         curve["holdout"])]))
        if chapter.bootstrap:
            parts.append("<h3>Bootstrap metric confidence intervals</h3>")
            intervals = chapter.bootstrap.get("metricIntervals", {})
            # Whisker plot over the bootstrap-replicate distribution:
            # whiskers span min..max across replicates, dot = mean (the
            # fields CoefficientSummary.to_dict emits; reference chapter:
            # BootstrapReport + xchart).
            parts.append(svg_charts.interval_chart(
                [(name, float(s["min"]), float(s["mean"]), float(s["max"]))
                 for name, s in intervals.items()
                 if all(k in s for k in ("min", "mean", "max"))],
                ylabel="metric (min / mean / max over replicates)"))
            parts.append(_render_table([
                {"metric": name, **summary}
                for name, summary in intervals.items()]))
        if chapter.hosmer_lemeshow:
            hl = chapter.hosmer_lemeshow
            parts.append("<h3>Hosmer-Lemeshow goodness of fit</h3>")
            parts.append(_render_kv({
                "chiSquare": hl["chiSquare"],
                "degreesOfFreedom": hl["degreesOfFreedom"],
                "pValue": hl["pValue"]}))
            bins = hl.get("bins", [])
            if bins:
                # Calibration bars: expected vs observed positives per
                # score decile (reference: ml/diagnostics/hl/ + xchart).
                parts.append(svg_charts.grouped_bar_chart(
                    [str(i + 1) for i in range(len(bins))],
                    {"expected": [float(b.get("expectedPos", 0.0))
                                  for b in bins],
                     "observed": [float(b.get("observedPos", 0.0))
                                  for b in bins]},
                    xlabel="score decile", ylabel="positives"))
            parts.append(_render_table(bins))
        if chapter.prediction_error_independence:
            parts.append("<h3>Prediction/error independence "
                         "(Kendall tau)</h3>")
            parts.append(_render_kv(
                chapter.prediction_error_independence["kendallTau"]))
    parts.append("</body></html>")
    return "".join(parts)


def write_report(report: DiagnosticReport, output_dir) -> None:
    """Writes model-diagnostic.json + model-diagnostic.html (the latter is
    the analog of the reference's HTML document at ml/Driver.scala:617-637)."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "model-diagnostic.json").write_text(
        json.dumps(report.to_dict(), indent=2, default=float))
    (out / "model-diagnostic.html").write_text(render_html_report(report))
