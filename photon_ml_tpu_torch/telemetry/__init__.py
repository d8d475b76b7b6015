"""Telemetry: metrics registry, pipeline spans, Chrome trace export,
request-scoped trace contexts, the flight recorder, the executable
profiler, and the observability plane: Prometheus exposition and the
``ObservabilityServer``, SLOs, mergeable sketches and fleet federation
(port of photon_ml_tpu/telemetry/__init__.py:1-190).

Quick tour::

    from photon_ml_tpu_torch import telemetry
    from photon_ml_tpu_torch.telemetry import span

    telemetry.enable(trace=True)            # drivers only; default off
    reqs = telemetry.counter("serving.requests")
    lat = telemetry.histogram("serving.request_latency_seconds")
    with span("decode"):                    # nestable, thread-aware
        ...
    lat.observe(0.0013); reqs.inc()
    telemetry.snapshot()                    # snake_case metrics dict
    telemetry.export_chrome_trace("trace.json")   # load in Perfetto

Disabled (the default) every mutation and ``span()`` is a no-op fast
path (one branch, no allocation), so library code stays instrumented
unconditionally. Telemetry reads only host clocks at synchronizations
the code already has: it adds no device synchronization and moves no
model bit.
"""

from __future__ import annotations

from photon_ml_tpu_torch.telemetry import registry as _registry_mod
from photon_ml_tpu_torch.telemetry.registry import (
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    enabled,
    registry,
)
from photon_ml_tpu_torch.telemetry.spans import (
    Tracer,
    attribution_summary,
    export_chrome_trace,
    span,
    stage_attribution,
    timed_span,
    tracer,
)
from photon_ml_tpu_torch.telemetry.exposition import (
    ObservabilityServer,
    prometheus_name,
    render_prometheus,
)
from photon_ml_tpu_torch.telemetry.recorder import (
    FlightRecorder,
    install_sigterm_dump,
)
from photon_ml_tpu_torch.telemetry.slo import (
    LatencyObjective,
    RatioObjective,
    SLOTracker,
    ValueObjective,
    evaluate_specs,
    parse_slo,
)
from photon_ml_tpu_torch.telemetry.federation import (
    SNAPSHOT_SCHEMA,
    FleetAggregator,
    FleetView,
    MergedRegistry,
    gauge_merge_policy,
    merge_snapshots,
    read_obs_descriptor,
    registry_snapshot,
    write_obs_descriptor,
)
from photon_ml_tpu_torch.telemetry.sketches import (
    MomentsSketch,
    QuantileSketch,
    TopKSketch,
    sketch_from_state,
)
from photon_ml_tpu_torch.telemetry import tracectx as _tracectx_mod
from photon_ml_tpu_torch.telemetry.tracectx import (
    NOOP_CONTEXT,
    TraceContext,
    TraceTail,
    mint,
    trace_tail,
)
from photon_ml_tpu_torch.telemetry.profiler import ExecutableProfiler


def enable(trace: bool = False, sampling: bool = True) -> None:
    """Turn telemetry on for this process; ``trace=True`` additionally
    records raw span events for Chrome-trace export (aggregation is
    always on while enabled). ``sampling`` (default on) arms
    request-scoped trace contexts and tail sampling (tracectx.py)."""
    tracer().record_events = bool(trace)
    _registry_mod.enable()
    if sampling:
        _tracectx_mod.enable()
    else:
        _tracectx_mod.disable()


def disable() -> None:
    """Turn the whole layer off: metric mutations, span recording, and
    trace-context sampling all return to their no-op fast paths."""
    _registry_mod.disable()
    _tracectx_mod.disable()


def reset() -> None:
    """Zero all metrics (in place: module-level handles stay live), drop
    recorded spans and sampled traces; re-binds the tracer's main thread
    to the caller. Drivers call this at startup so a process that runs
    several in sequence reports per-run telemetry."""
    registry().reset()
    tracer().reset()
    trace_tail().reset()


def counter(name: str) -> Counter:
    return registry().counter(name)


def gauge(name: str) -> Gauge:
    return registry().gauge(name)


def histogram(name: str, buckets=None,
              exemplars: bool = False) -> Histogram:
    return registry().histogram(name, buckets, exemplars=exemplars)


def snapshot() -> dict:
    return registry().snapshot()


__all__ = [
    "DEFAULT_LATENCY_BUCKETS",
    "Counter",
    "ExecutableProfiler",
    "FleetAggregator",
    "FleetView",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "LatencyObjective",
    "MergedRegistry",
    "MetricsRegistry",
    "MomentsSketch",
    "NOOP_CONTEXT",
    "ObservabilityServer",
    "QuantileSketch",
    "RatioObjective",
    "SLOTracker",
    "SNAPSHOT_SCHEMA",
    "TopKSketch",
    "TraceContext",
    "TraceTail",
    "Tracer",
    "ValueObjective",
    "attribution_summary",
    "counter",
    "disable",
    "enable",
    "enabled",
    "evaluate_specs",
    "export_chrome_trace",
    "gauge",
    "gauge_merge_policy",
    "merge_snapshots",
    "histogram",
    "install_sigterm_dump",
    "mint",
    "parse_slo",
    "prometheus_name",
    "read_obs_descriptor",
    "registry",
    "registry_snapshot",
    "render_prometheus",
    "reset",
    "sketch_from_state",
    "snapshot",
    "span",
    "stage_attribution",
    "timed_span",
    "trace_tail",
    "tracer",
    "write_obs_descriptor",
]
