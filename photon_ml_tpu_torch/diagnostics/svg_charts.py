"""Self-contained inline-SVG charts for the diagnostics HTML report
(a copy of photon_ml_tpu/diagnostics/svg_charts.py:1-226).

The reference renders its diagnostic plots with xchart rasters embedded in
model-diagnostic.html (ml/diagnostics/reporting/html/, dependency at
photon-ml/build.gradle:61 — learning curves from FittingDiagnostic,
bootstrap confidence intervals, Hosmer-Lemeshow calibration). This module
reproduces those as dependency-free inline SVG: the charts live inside the
single HTML document, scale losslessly, and need no plotting library.

Only stdlib + string formatting — no numpy required at render time.
"""

from __future__ import annotations

import html
import math
from typing import Dict, List, Sequence, Tuple

_W, _H = 560, 320
_ML, _MR, _MT, _MB = 64, 16, 20, 46  # margins: left/right/top/bottom
_COLORS = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e", "#8c564b"]


def _nice_ticks(lo: float, hi: float, n: int = 5) -> List[float]:
    if not (math.isfinite(lo) and math.isfinite(hi)):
        return []
    if hi <= lo:
        hi = lo + (abs(lo) or 1.0) * 1e-3
    span = hi - lo
    step = 10 ** math.floor(math.log10(span / max(1, n)))
    for mult in (1, 2, 5, 10):
        if span / (step * mult) <= n:
            step *= mult
            break
    start = math.ceil(lo / step) * step
    ticks = []
    t = start
    while t <= hi + 1e-12 * span:
        ticks.append(round(t, 12))
        t += step
    return ticks


def _fmt(v: float) -> str:
    return f"{v:.4g}"


def _esc(s: str) -> str:
    """XML-escape AND drop control characters (feature keys carry the
    reference's \\x01 name/term delimiter, which is invalid in XML)."""
    return html.escape("".join(ch for ch in str(s) if ch >= " "))


class _Frame:
    """Maps data coordinates onto the SVG plot rectangle."""

    def __init__(self, xlo, xhi, ylo, yhi):
        if xhi <= xlo:
            xhi = xlo + 1.0
        if yhi <= ylo:
            pad = (abs(ylo) or 1.0) * 0.05
            ylo, yhi = ylo - pad, yhi + pad
        self.xlo, self.xhi, self.ylo, self.yhi = xlo, xhi, ylo, yhi

    def x(self, v: float) -> float:
        return _ML + (v - self.xlo) / (self.xhi - self.xlo) * (_W - _ML - _MR)

    def y(self, v: float) -> float:
        return (_H - _MB) - (v - self.ylo) / (self.yhi - self.ylo) * (
            _H - _MT - _MB)


def _axes(fr: _Frame, xlabel: str, ylabel: str,
          x_ticks: Sequence[float] | None = None,
          x_tick_labels: Sequence[str] | None = None) -> List[str]:
    parts = [
        f"<rect x='{_ML}' y='{_MT}' width='{_W - _ML - _MR}' "
        f"height='{_H - _MT - _MB}' fill='none' stroke='#888'/>"]
    for t in _nice_ticks(fr.ylo, fr.yhi):
        y = fr.y(t)
        parts.append(f"<line x1='{_ML}' y1='{y:.1f}' x2='{_W - _MR}' "
                     f"y2='{y:.1f}' stroke='#ddd'/>")
        parts.append(f"<text x='{_ML - 6}' y='{y + 4:.1f}' "
                     f"text-anchor='end' font-size='11'>{_fmt(t)}</text>")
    xs = list(x_ticks) if x_ticks is not None else _nice_ticks(fr.xlo, fr.xhi)
    labels = (list(x_tick_labels) if x_tick_labels is not None
              else [_fmt(t) for t in xs])
    for t, lab in zip(xs, labels):
        x = fr.x(t)
        parts.append(f"<line x1='{x:.1f}' y1='{_H - _MB}' x2='{x:.1f}' "
                     f"y2='{_H - _MB + 4}' stroke='#888'/>")
        parts.append(f"<text x='{x:.1f}' y='{_H - _MB + 17}' "
                     f"text-anchor='middle' font-size='11'>"
                     f"{_esc(lab)}</text>")
    parts.append(f"<text x='{(_ML + _W - _MR) / 2:.0f}' y='{_H - 8}' "
                 f"text-anchor='middle' font-size='12'>"
                 f"{_esc(xlabel)}</text>")
    parts.append(f"<text x='14' y='{(_MT + _H - _MB) / 2:.0f}' "
                 f"text-anchor='middle' font-size='12' "
                 f"transform='rotate(-90 14 {(_MT + _H - _MB) / 2:.0f})'>"
                 f"{_esc(ylabel)}</text>")
    return parts


def _legend(names: Sequence[str]) -> List[str]:
    parts = []
    x = _ML + 10
    for i, name in enumerate(names):
        c = _COLORS[i % len(_COLORS)]
        parts.append(f"<rect x='{x}' y='{_MT + 6 + i * 16}' width='12' "
                     f"height='4' fill='{c}'/>")
        parts.append(f"<text x='{x + 18}' y='{_MT + 11 + i * 16}' "
                     f"font-size='11'>{_esc(name)}</text>")
    return parts


def line_chart(series: Dict[str, Tuple[Sequence[float], Sequence[float]]],
               xlabel: str = "", ylabel: str = "") -> str:
    """Multi-series line chart (the learning-curve shape): name ->
    (xs, ys). NaNs break the line."""
    pts = [(x, y) for xs, ys in series.values()
           for x, y in zip(xs, ys) if math.isfinite(y)]
    if not pts:
        return ""
    xlo, xhi = min(p[0] for p in pts), max(p[0] for p in pts)
    ylo, yhi = min(p[1] for p in pts), max(p[1] for p in pts)
    pad = (yhi - ylo or abs(ylo) or 1.0) * 0.08
    fr = _Frame(xlo, xhi, ylo - pad, yhi + pad)
    parts = [f"<svg viewBox='0 0 {_W} {_H}' width='{_W}' height='{_H}' "
             f"xmlns='http://www.w3.org/2000/svg'>"]
    parts += _axes(fr, xlabel, ylabel)
    for i, (name, (xs, ys)) in enumerate(series.items()):
        c = _COLORS[i % len(_COLORS)]
        # Split at non-finite points so gaps render as gaps, never as a
        # fabricated bridging segment.
        segments: List[List[str]] = [[]]
        for x, y in zip(xs, ys):
            if math.isfinite(y):
                segments[-1].append(f"{fr.x(x):.1f},{fr.y(y):.1f}")
            elif segments[-1]:
                segments.append([])
        for seg in segments:
            if len(seg) > 1:
                parts.append(f"<polyline points='{' '.join(seg)}' "
                             f"fill='none' stroke='{c}' stroke-width='2'/>")
            for p in seg:
                cx, cy = p.split(",")
                parts.append(
                    f"<circle cx='{cx}' cy='{cy}' r='3' fill='{c}'/>")
    parts += _legend(list(series))
    parts.append("</svg>")
    return "".join(parts)


def interval_chart(items: Sequence[Tuple[str, float, float, float]],
                   ylabel: str = "") -> str:
    """Whisker chart for bootstrap confidence intervals:
    (label, lo, mid, hi) per category."""
    items = [it for it in items
             if all(math.isfinite(v) for v in it[1:])]
    if not items:
        return ""
    ylo = min(it[1] for it in items)
    yhi = max(it[3] for it in items)
    pad = (yhi - ylo or abs(ylo) or 1.0) * 0.1
    fr = _Frame(-0.5, len(items) - 0.5, ylo - pad, yhi + pad)
    parts = [f"<svg viewBox='0 0 {_W} {_H}' width='{_W}' height='{_H}' "
             f"xmlns='http://www.w3.org/2000/svg'>"]
    parts += _axes(fr, "", ylabel, x_ticks=range(len(items)),
                   x_tick_labels=[it[0] for it in items])
    for i, (_, lo, mid, hi) in enumerate(items):
        x = fr.x(i)
        c = _COLORS[0]
        parts.append(f"<line x1='{x:.1f}' y1='{fr.y(lo):.1f}' x2='{x:.1f}' "
                     f"y2='{fr.y(hi):.1f}' stroke='{c}' stroke-width='2'/>")
        for v in (lo, hi):
            parts.append(f"<line x1='{x - 6:.1f}' y1='{fr.y(v):.1f}' "
                         f"x2='{x + 6:.1f}' y2='{fr.y(v):.1f}' "
                         f"stroke='{c}' stroke-width='2'/>")
        parts.append(f"<circle cx='{x:.1f}' cy='{fr.y(mid):.1f}' r='4' "
                     f"fill='{_COLORS[1]}'/>")
    parts.append("</svg>")
    return "".join(parts)


def grouped_bar_chart(labels: Sequence[str],
                      groups: Dict[str, Sequence[float]],
                      xlabel: str = "", ylabel: str = "") -> str:
    """Grouped bars (the Hosmer-Lemeshow calibration shape): per x-label,
    one bar per group (e.g. expected vs observed positives per decile)."""
    vals = [v for vs in groups.values() for v in vs if math.isfinite(v)]
    if not vals or not labels:
        return ""
    yhi = max(vals + [0.0])
    ylo = min(vals + [0.0])
    fr = _Frame(-0.5, len(labels) - 0.5, ylo, yhi * 1.08 or 1.0)
    parts = [f"<svg viewBox='0 0 {_W} {_H}' width='{_W}' height='{_H}' "
             f"xmlns='http://www.w3.org/2000/svg'>"]
    parts += _axes(fr, xlabel, ylabel, x_ticks=range(len(labels)),
                   x_tick_labels=list(labels))
    n_groups = len(groups)
    slot = (_W - _ML - _MR) / len(labels)
    bar_w = min(24.0, slot * 0.8 / max(1, n_groups))
    y0 = fr.y(0.0)
    for gi, (name, vs) in enumerate(groups.items()):
        c = _COLORS[gi % len(_COLORS)]
        for i, v in enumerate(vs):
            if not math.isfinite(v):
                continue
            x = fr.x(i) + (gi - n_groups / 2) * bar_w
            y = fr.y(v)
            top, hgt = (y, y0 - y) if v >= 0 else (y0, y - y0)
            parts.append(f"<rect x='{x:.1f}' y='{top:.1f}' "
                         f"width='{bar_w:.1f}' height='{max(hgt, 0):.1f}' "
                         f"fill='{c}' fill-opacity='0.85'/>")
    parts += _legend(list(groups))
    parts.append("</svg>")
    return "".join(parts)


def bar_chart(items: Sequence[Tuple[str, float]],
              xlabel: str = "", ylabel: str = "") -> str:
    """Simple horizontal-label bar chart (feature-importance shape)."""
    labels = [k for k, _ in items]
    return grouped_bar_chart(labels, {"": [v for _, v in items]},
                             xlabel=xlabel, ylabel=ylabel)
