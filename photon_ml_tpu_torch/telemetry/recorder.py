"""Flight recorder: a bounded ring of recent span events and periodic
registry deltas, dumpable as a Perfetto-compatible ``flight.json`` at
fault time (port of photon_ml_tpu/telemetry/recorder.py:1-233).

``--trace-out`` records EVERY span event for a post-mortem you planned;
the flight recorder is for the fault you did not: the ring holds the
most recent ``max_events`` completed spans (oldest evicted, eviction
counted) plus a registry-counter delta every ``snapshot_interval_s``.

When telemetry is disabled nothing reaches the recorder (``span()``
returns the shared no-op); when it is enabled but no recorder is
installed, the cost is one attribute load and a ``None`` check per
completed span (``Tracer._record``). Installation is a driver decision
(``--flight-events``), never a library one.

Dump triggers (all write the same Chrome-trace JSON as ``--trace-out``):

- **on unhandled driver fault**: both GAME drivers dump
  ``<output-dir>/flight.json`` before re-raising;
- **on SIGTERM**: :func:`install_sigterm_dump` (main thread only;
  elsewhere a no-op) dumps, then exits 143 through ``SystemExit`` so
  ``finally`` blocks still run;
- **on demand**: the observability server's ``/debugz/dump`` route, or
  :meth:`FlightRecorder.dump`.
"""

from __future__ import annotations

import importlib
import json
import os
import signal
import threading
import time
from collections import deque
from typing import Dict

# Submodules via importlib — the package shadows ``registry`` with the
# accessor function (see spans.py).
_reg = importlib.import_module("photon_ml_tpu_torch.telemetry.registry")
_spans = importlib.import_module("photon_ml_tpu_torch.telemetry.spans")
_tracectx = importlib.import_module("photon_ml_tpu_torch.telemetry.tracectx")


class FlightRecorder:
    """Bounded in-memory recorder of recent telemetry activity.

    ``record_span`` is called by the tracer for every COMPLETED span
    while installed (install()); appends take one short lock (the same
    cost class as a registry counter inc — spans are per-stage, never
    per-row). Registry deltas piggyback on span completions and on the
    observability server's heartbeat ``tick()``: at most one capture per
    ``snapshot_interval_s``, storing only the counters/gauges whose
    value changed since the previous capture.
    """

    def __init__(self, max_events: int = 4096,
                 snapshot_interval_s: float = 5.0):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.max_events = int(max_events)
        self.snapshot_interval_s = float(snapshot_interval_s)
        self._ring: deque = deque(maxlen=self.max_events)
        self._lock = threading.Lock()
        self._appended = 0
        self._last_delta = 0.0
        self._prev_values: Dict[str, float] = {}
        self._delta_lock = threading.Lock()
        self.dumps = 0

    # -- recording ---------------------------------------------------------

    def record_span(self, name: str, t0: float, t1: float,
                    tid: int) -> None:
        with self._lock:
            self._ring.append(("span", name, t0, t1, tid))
            self._appended += 1
        if t1 - self._last_delta >= self.snapshot_interval_s:
            self._capture_delta(t1)

    def tick(self) -> None:
        """Heartbeat hook: capture a registry delta if one is due even
        while no spans are closing (an idle-but-alive process still
        leaves a counter trail)."""
        now = time.perf_counter()
        if now - self._last_delta >= self.snapshot_interval_s:
            self._capture_delta(now)

    def _capture_delta(self, now: float) -> None:
        # Non-blocking: if another thread is mid-capture, this span's
        # delta is simply the next one's job.
        if not self._delta_lock.acquire(blocking=False):
            return
        try:
            if now - self._last_delta < self.snapshot_interval_s:
                return
            self._last_delta = now
            counters, gauges, _ = _reg.registry().metrics()
            cur = {name: float(c.value) for name, c in counters.items()}
            cur.update({name: float(g.value)
                        for name, g in gauges.items()})
            changed = {k: v for k, v in cur.items()
                       if self._prev_values.get(k) != v}
            self._prev_values = cur
            if changed:
                with self._lock:
                    self._ring.append(("metrics", now, changed))
                    self._appended += 1
        finally:
            self._delta_lock.release()

    # -- installation ------------------------------------------------------

    def install(self) -> "FlightRecorder":
        """Attach to the process tracer: every completed span (while
        telemetry is enabled) lands in the ring."""
        _spans.tracer().flight = self
        return self

    def uninstall(self) -> None:
        tr = _spans.tracer()
        if tr.flight is self:
            tr.flight = None

    # -- dumping -----------------------------------------------------------

    def dump(self, path=None, reason: str = "manual",
             trace_id: str = None) -> dict:
        """Build (and optionally write) the flight dump: Chrome
        trace-event JSON (``traceEvents``: the ring's spans as ``ph: X``
        slices on per-thread tracks, registry deltas as ``ph: C``
        counter samples — Perfetto renders both) plus a ``flight`` block
        carrying the final registry snapshot, stage attribution, and the
        tail-sampled trace timelines (telemetry/tracectx.py — the dump
        carries the same per-request/per-solve evidence as a live
        trace-tail snapshot). ``trace_id`` tags the dump with the
        request/solve the fault belongs to (e.g. a diverged solve's
        context — ``flight.trace_id``). Timestamps share the tracer's
        epoch, so a flight dump and a ``--trace-out`` trace of the same
        run line up."""
        tr = _spans.tracer()
        with self._lock:
            events = list(self._ring)
            appended = self._appended
        pid = os.getpid()
        tid_ix, out = _spans.thread_track_metadata(
            {e[4] for e in events if e[0] == "span"}, tr.main_tid, pid)
        for e in events:
            if e[0] == "span":
                _, name, t0, t1, tid = e
                out.append({"name": name, "ph": "X", "cat": "flight",
                            "pid": pid, "tid": tid_ix[tid],
                            "ts": (t0 - tr.epoch) * 1e6,
                            "dur": (t1 - t0) * 1e6})
            else:
                _, t, changed = e
                out.append({"name": "registry", "ph": "C", "cat": "flight",
                            "pid": pid, "tid": 0,
                            "ts": (t - tr.epoch) * 1e6,
                            "args": changed})
        dump = {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "flight": {
                "reason": reason,
                "events_in_ring": len(events),
                "events_seen": appended,
                "events_evicted": appended - len(events),
                "ring_capacity": self.max_events,
                "snapshot_interval_s": self.snapshot_interval_s,
                "final_metrics": _reg.registry().snapshot(),
                "stage_attribution": _spans.stage_attribution(),
                "trace_id": trace_id,
                "traces": _tracectx.trace_tail().snapshot(),
            },
        }
        if path is not None:
            with open(path, "w") as f:
                json.dump(dump, f)
        self.dumps += 1
        return dump

    def stats(self) -> dict:
        with self._lock:
            n, appended = len(self._ring), self._appended
        return {
            "events_in_ring": n,
            "events_seen": appended,
            "events_evicted": appended - n,
            "ring_capacity": self.max_events,
            "snapshot_interval_s": self.snapshot_interval_s,
            "dumps": self.dumps,
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._appended = 0
        self._prev_values = {}
        self._last_delta = 0.0


def install_sigterm_dump(recorder: FlightRecorder, path):
    """Dump flight evidence when the process is terminated: installs a
    SIGTERM handler that writes ``path`` then raises ``SystemExit(143)``
    (the conventional 128+SIGTERM code) so the driver's ``finally``
    blocks still run. Returns a zero-arg restore callable. Signal
    handlers can only live on the main thread — elsewhere (a driver run
    inside a worker thread, e.g. under test) this degrades to a no-op
    and returns a no-op restorer."""
    if threading.current_thread() is not threading.main_thread():
        return lambda: None
    prev = signal.getsignal(signal.SIGTERM)

    def _handler(signum, frame):
        try:
            recorder.dump(path, reason="SIGTERM")
        finally:
            raise SystemExit(143)

    signal.signal(signal.SIGTERM, _handler)

    def restore():
        signal.signal(signal.SIGTERM, prev)

    return restore
