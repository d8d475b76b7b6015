"""Span-based pipeline tracing: nestable, thread-aware wall-time stage
attribution, exportable as Chrome trace-event JSON (Perfetto-loadable)
(port of photon_ml_tpu/telemetry/spans.py:1-280).

``span("decode")`` opens a named stage on the CURRENT thread's span
stack; nesting subtracts child time from the parent, so
``stage_attribution()`` reports both total and SELF (exclusive) seconds
per stage name. Each thread has its own stack (a decode span on the
prefetch thread never nests into the consumer's spans), so a Chrome
trace shows one track per thread.

RULE: device work is attributed at a synchronization the code already
has. CUDA launches are asynchronous, so a span around a launch measures
the enqueue only. The device number is the span around an EXISTING
host sync (a solver's ``.item()``, ``InFlightWindow``'s event wait: the
``device_wait`` stage); no sync is ever added to time something.

Disabled mode (the default) returns one shared no-op context manager:
no allocation, one branch.
"""

from __future__ import annotations

import importlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

# The registry MODULE (not the ``telemetry.registry()`` accessor the
# package re-exports under the same name) — imported via importlib so
# the binding can't be shadowed by the package attribute.
_reg = importlib.import_module("photon_ml_tpu_torch.telemetry.registry")

#: Raw trace events kept when trace recording is on; aggregation
#: (stage_attribution) is exact regardless — beyond the cap only the raw
#: Perfetto events drop (counted in ``dropped_events``).
MAX_TRACE_EVENTS = 200_000


class _NoopSpan:
    """Shared do-nothing context manager — THE disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NOOP = _NoopSpan()


class Tracer:
    """Aggregates span stage attribution; optionally records raw
    Chrome-trace events. One per process (module singleton below)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.record_events = False
        # Optional FlightRecorder (telemetry/recorder.py) fed every
        # completed span. Deliberately NOT cleared by reset(): drivers
        # reset telemetry at startup and install the recorder after —
        # the recorder's lifetime is the driver run's, not the
        # aggregation window's.
        self.flight = None
        self.reset()

    def reset(self) -> None:
        with self._lock:
            # name -> [count, total_s, self_s]
            self._agg: Dict[str, List[float]] = {}
            self._main_agg: Dict[str, List[float]] = {}
            self.events: List[dict] = []
            self.dropped_events = 0
            self.epoch = time.perf_counter()
            self.main_tid = threading.get_ident()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _record(self, name: str, t0: float, t1: float,
                child_s: float, tid: int) -> None:
        dur = t1 - t0
        self_s = max(0.0, dur - child_s)
        with self._lock:
            for agg in ((self._agg, self._main_agg)
                        if tid == self.main_tid else (self._agg,)):
                slot = agg.get(name)
                if slot is None:
                    slot = agg[name] = [0, 0.0, 0.0]
                slot[0] += 1
                slot[1] += dur
                slot[2] += self_s
            if self.record_events:
                if len(self.events) < MAX_TRACE_EVENTS:
                    self.events.append({
                        "name": name, "tid": tid,
                        "ts": (t0 - self.epoch) * 1e6,
                        "dur": dur * 1e6})
                else:
                    self.dropped_events += 1
        # Flight ring rides OUTSIDE the aggregation lock (it has its
        # own); one attribute load + None check when no recorder is
        # installed, nothing at all while telemetry is disabled (span()
        # never reaches _record then).
        fl = self.flight
        if fl is not None:
            fl.record_span(name, t0, t1, tid)

    # -- reporting ---------------------------------------------------------

    def stage_attribution(self) -> Dict[str, Dict[str, float]]:
        """Per span name: count, total wall seconds, and SELF seconds
        (total minus time inside nested spans) across all threads."""
        with self._lock:
            return {name: {"count": c, "total_s": t, "self_s": s}
                    for name, (c, t, s) in sorted(self._agg.items())}

    def main_thread_covered_seconds(self) -> float:
        """Sum of SELF seconds recorded on the tracer's main thread —
        disjoint by construction (per-thread stack), so dividing by the
        driver's wall time gives the attributed-wall fraction."""
        with self._lock:
            return sum(s for _, _, s in self._main_agg.values())

    def export_chrome_trace(self, path) -> None:
        """Write Chrome trace-event JSON (load in Perfetto / about:tracing
        ). One track per thread; the main
        thread is named so the driver phases are on top."""
        with self._lock:
            events = list(self.events)
            main_tid = self.main_tid
        pid = os.getpid()
        tid_ix, out = thread_track_metadata(
            {e["tid"] for e in events}, main_tid, pid)
        for e in events:
            out.append({"name": e["name"], "ph": "X", "cat": "photon",
                        "pid": pid, "tid": tid_ix[e["tid"]],
                        "ts": e["ts"], "dur": e["dur"]})
        with open(path, "w") as f:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)


def thread_track_metadata(tids, main_tid: int, pid: int):
    """Chrome-trace thread tracks shared by ``export_chrome_trace`` and
    the flight recorder's dump (telemetry/recorder.py), so the two
    artifacts always line up in Perfetto: raw thread idents map to
    dense track indices (``tid_ix``) and the returned event list opens
    with one ``thread_name`` metadata record per track (the tracer's
    main thread is ``driver``, others ``worker-<ix>``)."""
    ordered = sorted(tids)
    tid_ix = {t: i for i, t in enumerate(ordered)}
    out = [{"name": "thread_name", "ph": "M", "pid": pid,
            "tid": tid_ix[t],
            "args": {"name": ("driver" if t == main_tid
                              else f"worker-{tid_ix[t]}")}}
           for t in ordered]
    return tid_ix, out


_TRACER = Tracer()


def tracer() -> Tracer:
    return _TRACER


class _Span:
    """One live span: pushed on the current thread's stack at enter,
    recorded (and its duration charged to the parent's child time) at
    exit."""

    __slots__ = ("name", "t0", "child_s")

    def __init__(self, name: str):
        self.name = name
        self.child_s = 0.0

    def __enter__(self):
        _TRACER._stack().append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        stack = _TRACER._stack()
        # Tolerate out-of-order exits (generator spans closed by GC):
        # unwind to this span rather than corrupting the stack.
        while stack and stack[-1] is not self:
            stack.pop()
        if stack:
            stack.pop()
        if stack:
            stack[-1].child_s += t1 - self.t0
        _TRACER._record(self.name, self.t0, t1, self.child_s,
                        threading.get_ident())
        return None


def span(name: str):
    """Open a named pipeline stage (context manager). Nestable and
    thread-aware; a shared no-op when telemetry is disabled. NEVER open
    one inside a CUDA graph capture: it would time the capture once."""
    if not _reg._enabled:
        return _NOOP
    return _Span(name)


class _TimedSpan:
    __slots__ = ("_span", "_hist", "_counter")

    def __init__(self, name, hist, counter):
        self._span = _Span(name)
        self._hist = hist
        self._counter = counter

    def __enter__(self):
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        s = self._span
        s.__exit__(*exc)
        if self._hist is not None:
            self._hist.observe(time.perf_counter() - s.t0)
        if self._counter is not None:
            self._counter.inc()
        return None


def timed_span(name: str, histogram=None, counter=None):
    """``span(name)`` that additionally observes its wall duration into
    ``histogram`` and bumps ``counter`` on exit (e.g. per-iteration
    solver timing). Same no-op fast path as ``span`` when disabled."""
    if not _reg._enabled:
        return _NOOP
    return _TimedSpan(name, histogram, counter)


def stage_attribution() -> Dict[str, Dict[str, float]]:
    return _TRACER.stage_attribution()


def export_chrome_trace(path) -> None:
    _TRACER.export_chrome_trace(path)


def attribution_summary(wall_seconds: Optional[float] = None) -> Dict:
    """The metrics.json ``telemetry`` block: registry snapshot + stage
    attribution (+ attributed-wall fraction when the caller's wall time
    is given — driver phase spans partition the run, so the fraction is
    the share of end-to-end wall time the stages explain)."""
    out = {
        "metrics": _reg.registry().snapshot(),
        "stage_attribution": stage_attribution(),
        "dropped_trace_events": _TRACER.dropped_events,
    }
    if wall_seconds is not None:
        covered = _TRACER.main_thread_covered_seconds()
        out["wall_seconds"] = wall_seconds
        out["attributed_wall_seconds"] = covered
        out["attributed_wall_frac"] = (covered / wall_seconds
                                       if wall_seconds > 0 else 0.0)
    return out
