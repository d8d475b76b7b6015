"""SLO declarations and burn-rate tracking over the metrics registry
(port of photon_ml_tpu/telemetry/slo.py:1-325: parse_slo, the latency,
ratio and value objectives, measure_objective, evaluate_specs and
SLOTracker with its registry twins; standard library only).

Objectives are declared AGAINST existing metrics — no new
instrumentation: a latency objective reads a registry histogram (e.g.
the front-end's end-to-end ``serving.frontend.request_latency_seconds``)
and an availability/ratio objective reads counters (e.g. shed rate =
``rejected / (admitted + rejected)``).

Burn-rate semantics (the number ``evaluate()`` maintains):

- A latency objective "P<q> <= T" is equivalently the availability
  statement "at most ``1 - q`` of requests may exceed ``T``". The
  histogram's ``le`` buckets give the actual fraction over ``T``
  (linear interpolation inside the bucket containing ``T``; exact when
  ``T`` sits on a bucket bound — pick thresholds inside the configured
  bucket range), and ``burn_rate = frac_over / (1 - q)``: the rate the
  error budget is being consumed relative to the rate the objective
  allows. ``burn_rate <= 1`` is compliant; 2 means burning budget twice
  as fast as allowed.
- A ratio objective "num/den <= R" has ``burn_rate = ratio / R``.

Each objective maintains registry twins (surfaced in ``/metrics``,
``/statusz`` and metrics.json): counters ``slo.<name>.evaluations`` and
``slo.<name>.violations`` (evaluations observed with ``burn_rate > 1``)
and gauge ``slo.<name>.burn_rate``. The tracker also keeps plain-int
locals so its report stays live even while telemetry is disabled.

Declaration syntax (CLI ``--slo``):

- ``[name=]p99:serving.frontend.request_latency_seconds<=50ms``
  (quantile ``p50``/``p95``/``p99``/``p99.9``...; duration suffix
  ``us``/``ms``/``s``, bare numbers are seconds)
- ``[name=]ratio:serving.frontend.rejected/serving.frontend.admitted+``
  ``serving.frontend.rejected<=0.02`` (denominator counters sum)
- ``[name=]value:serving.model.default.score_drift_psi<=0.25`` (a
  registry GAUGE must stay <= the bound; ``burn_rate = value / max``).
  This is what makes COMPUTED gauges — the ``--distmon`` drift scores,
  refreshed by scrape hooks before every evaluation — SLO-able with no
  new alerting code: the same burn/violation counters, /statusz block
  and metrics.json ``slo`` entry as the latency/ratio kinds. A gauge
  that was never set burns nothing (no traffic to judge).

An explicit ``name=`` prefix names the objective's metric family;
otherwise a snake_case name is derived from the spec.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib
import re
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

# Submodule via importlib — the package shadows ``registry`` with the
# accessor function (see spans.py).
_reg = importlib.import_module("photon_ml_tpu_torch.telemetry.registry")

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_DURATION_RE = re.compile(r"^([0-9]*\.?[0-9]+)(us|ms|s)?$")


@dataclasses.dataclass(frozen=True)
class LatencyObjective:
    """``quantile`` of histogram ``histogram`` must be <= ``threshold_s``
    — tracked in its availability form (fraction over threshold vs the
    ``1 - quantile`` budget)."""

    name: str
    histogram: str
    quantile: float
    threshold_s: float

    def describe(self) -> str:
        return (f"p{self.quantile * 100:g}({self.histogram}) "
                f"<= {self.threshold_s:g}s")


@dataclasses.dataclass(frozen=True)
class RatioObjective:
    """``numerator / sum(denominators)`` (registry counters) must be
    <= ``max_ratio`` (e.g. shed-rate <= 2%)."""

    name: str
    numerator: str
    denominators: Tuple[str, ...]
    max_ratio: float

    def describe(self) -> str:
        return (f"{self.numerator} / "
                f"{' + '.join(self.denominators)} <= {self.max_ratio:g}")


@dataclasses.dataclass(frozen=True)
class ValueObjective:
    """Registry gauge ``gauge`` must stay <= ``max_value`` (e.g. a
    drift score <= 0.25); ``burn_rate = value / max_value``. Judged
    only once the gauge has been set at least once."""

    name: str
    gauge: str
    max_value: float

    def describe(self) -> str:
        return f"{self.gauge} <= {self.max_value:g}"


Objective = Union[LatencyObjective, RatioObjective, ValueObjective]


def _parse_duration_s(text: str) -> float:
    m = _DURATION_RE.match(text.strip())
    if not m:
        raise ValueError(f"bad duration {text!r} "
                         "(expected e.g. 50ms, 200us, 1.5s, 0.05)")
    v = float(m.group(1))
    return v * {"us": 1e-6, "ms": 1e-3, "s": 1.0, None: 1.0}[m.group(2)]


def parse_slo(spec: str) -> Objective:
    """Parse one ``--slo`` declaration (module docstring syntax)."""
    spec = spec.strip()
    name = None
    if "=" in spec.split(":", 1)[0]:
        name, _, spec = spec.partition("=")
        name = name.strip()
        if not _NAME_RE.match(name):
            raise ValueError(
                f"bad SLO name {name!r} (snake_case, [a-z0-9_])")
    kind, sep, rest = spec.partition(":")
    if not sep:
        raise ValueError(f"bad SLO spec {spec!r}: expected "
                         "'p<q>:<histogram><=<duration>' or "
                         "'ratio:<num>/<den>[+<den>...]<=<frac>'")
    lhs, le, rhs = rest.partition("<=")
    if not le:
        raise ValueError(f"bad SLO spec {spec!r}: missing '<='")
    lhs, rhs = lhs.strip(), rhs.strip()
    if kind.startswith("p"):
        try:
            q = float(kind[1:]) / 100.0
        except ValueError:
            raise ValueError(f"bad SLO quantile {kind!r} (e.g. p99)")
        if not 0.0 < q < 1.0:
            raise ValueError(f"SLO quantile must be in (0, 1), got {q}")
        return LatencyObjective(
            name=name or f"p{kind[1:].replace('.', '_')}_"
                         f"{lhs.replace('.', '_')}",
            histogram=lhs, quantile=q,
            threshold_s=_parse_duration_s(rhs))
    if kind == "ratio":
        num, slash, dens = lhs.partition("/")
        if not slash or not dens:
            raise ValueError(
                f"bad ratio SLO {spec!r}: expected num/den[+den...]")
        return RatioObjective(
            name=name or f"ratio_{num.strip().replace('.', '_')}",
            numerator=num.strip(),
            denominators=tuple(d.strip() for d in dens.split("+")),
            max_ratio=float(rhs))
    if kind == "value":
        if not lhs:
            raise ValueError(
                f"bad value SLO {spec!r}: expected value:<gauge><=X")
        return ValueObjective(
            name=name or f"value_{lhs.replace('.', '_')}",
            gauge=lhs, max_value=float(rhs))
    raise ValueError(f"unknown SLO kind {kind!r} (p<q>, ratio or value)")


def _frac_over_threshold(hist: _reg.Histogram,
                         threshold: float) -> Optional[float]:
    """Fraction of observations > ``threshold`` from the histogram's
    cumulative ``le`` buckets (interpolated inside the containing
    bucket; exact at bucket bounds). ``None`` while empty. A threshold
    past the top bound counts the whole overflow bucket as bad — the
    conservative reading, since overflow samples' values are unknown."""
    bounds, cum, count, _ = hist.exposition_state()
    if count == 0:
        return None
    i = bisect.bisect_left(bounds, threshold)
    if i >= len(bounds):
        good = cum[-1]
    else:
        lo = bounds[i - 1] if i > 0 else 0.0
        prev = cum[i - 1] if i > 0 else 0
        in_bucket = cum[i] - prev
        frac = ((threshold - lo) / (bounds[i] - lo)
                if bounds[i] > lo else 1.0)
        good = prev + frac * in_bucket
    return max(0.0, min(1.0, 1.0 - good / count))


def measure_objective(o: Objective, reg) -> Tuple[Optional[float],
                                                  Optional[float]]:
    """(current value, burn rate) of one objective against ``reg`` — any
    registry-shaped object (``counter``/``gauge``/``histogram``
    accessors), so federation can point it at a merged fleet view. Burn
    is ``None`` while the objective has no traffic to judge (no
    observations / zero denominator / never-set gauge): no traffic
    burns no budget."""
    if isinstance(o, LatencyObjective):
        hist = reg.histogram(o.histogram)
        frac_over = _frac_over_threshold(hist, o.threshold_s)
        if frac_over is None:
            return None, None
        return (hist.quantile(o.quantile),
                frac_over / (1.0 - o.quantile))
    if isinstance(o, ValueObjective):
        g = reg.gauge(o.gauge)
        if g.calls == 0:
            return None, None  # never set: nothing to judge
        v = g.value
        return v, (v / o.max_value if o.max_value > 0
                   else float("inf"))
    den = sum(reg.counter(d).value for d in o.denominators)
    if den <= 0:
        return None, None
    ratio = reg.counter(o.numerator).value / den
    return ratio, (ratio / o.max_ratio if o.max_ratio > 0
                   else float("inf"))


def evaluate_specs(specs: Sequence[Union[Objective, str]],
                   reg) -> Dict[str, dict]:
    """Statelessly evaluate SLO specs against an arbitrary registry —
    no registry-twin counters, no evaluation history. This is how the
    fleet aggregator re-judges every peer-declared objective against
    the MERGED registry: because counters sum and histogram buckets add
    exactly, the fleet burn rate is the true whole-fleet number, not an
    average of per-process burns."""
    out = {}
    for spec in specs:
        o = parse_slo(spec) if isinstance(spec, str) else spec
        current, burn = measure_objective(o, reg)
        entry = {
            "kind": ("latency" if isinstance(o, LatencyObjective)
                     else "value" if isinstance(o, ValueObjective)
                     else "ratio"),
            "objective": o.describe(),
            "current": current,
            "burn_rate": burn,
            "compliant": burn is None or burn <= 1.0,
        }
        if isinstance(o, LatencyObjective):
            entry["quantile"] = o.quantile
            entry["threshold_s"] = o.threshold_s
        elif isinstance(o, ValueObjective):
            entry["max_value"] = o.max_value
        else:
            entry["max_ratio"] = o.max_ratio
        out[o.name] = entry
    return out


class SLOTracker:
    """Evaluates a fixed set of objectives against the process registry
    and maintains their burn-rate counters. ``evaluate()`` is called by
    the observability server's ``/statusz`` route and heartbeat, by the
    drivers when writing metrics.json — each call is
    one observation of every objective."""

    def __init__(self, objectives: Sequence[Union[Objective, str]]):
        objs = [parse_slo(o) if isinstance(o, str) else o
                for o in objectives]
        names = [o.name for o in objs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {sorted(names)}")
        self.objectives: Tuple[Objective, ...] = tuple(objs)
        reg = _reg.registry()
        self._handles = {}
        self._local: Dict[str, Dict[str, int]] = {}
        # evaluate() is called from several threads at once (heartbeat
        # ticker + concurrent /statusz handlers + the driver's finish);
        # the registry twins have their own locks, but the plain-int
        # locals need this one so the two published counts agree.
        self._lock = threading.Lock()
        for o in self.objectives:
            pre = f"slo.{o.name}."
            self._handles[o.name] = (reg.counter(pre + "evaluations"),
                                     reg.counter(pre + "violations"),
                                     reg.gauge(pre + "burn_rate"))
            self._local[o.name] = {"evaluations": 0, "violations": 0}

    def _measure(self, o: Objective):
        return measure_objective(o, _reg.registry())

    def evaluate(self) -> Dict[str, dict]:
        out = {}
        for o in self.objectives:
            current, burn = self._measure(o)
            compliant = burn is None or burn <= 1.0
            evals, violations, burn_gauge = self._handles[o.name]
            with self._lock:
                local = self._local[o.name]
                local["evaluations"] += 1
                if not compliant:
                    local["violations"] += 1
                n_evals, n_viol = (local["evaluations"],
                                   local["violations"])
            evals.inc()
            if not compliant:
                violations.inc()
            burn_gauge.set(0.0 if burn is None else burn)
            entry = {
                "kind": ("latency" if isinstance(o, LatencyObjective)
                         else "value" if isinstance(o, ValueObjective)
                         else "ratio"),
                "objective": o.describe(),
                "current": current,
                "burn_rate": burn,
                "compliant": compliant,
                "evaluations": n_evals,
                "violations": n_viol,
            }
            if isinstance(o, LatencyObjective):
                entry["quantile"] = o.quantile
                entry["threshold_s"] = o.threshold_s
            elif isinstance(o, ValueObjective):
                entry["max_value"] = o.max_value
            else:
                entry["max_ratio"] = o.max_ratio
            out[o.name] = entry
        return out
