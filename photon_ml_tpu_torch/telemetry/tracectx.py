"""Request-scoped trace context with tail-based sampling (port of
photon_ml_tpu/telemetry/tracectx.py:1-409).

The per-thread span stacks (spans.py) answer "what is this THREAD
doing"; they cannot follow one request across the hops the serving
front-end makes (event loop -> coalesce group -> dispatch thread ->
scatter-back). A :class:`TraceContext` is that identity: minted at
``ServingFrontend`` admission (and once per λ in the streamed training
driver), it carries a process-unique ``trace_id`` and a monotonic event
timeline that survives every thread hop because the context object
travels with the request.

**Tail-based sampling** (:class:`TraceTail`) keeps, in bounded rings:

- every trace that finished with a non-``ok`` outcome (sheds, errors,
  cancellations, solver divergence),
- the **slowest decile**: duration >= the P90 of a sliding window of
  recent completions (recomputed every ``_THRESHOLD_REFRESH`` records),
- a small **uniform floor** (every ``floor_every``-th trace).

Kept traces are stamped into flight-recorder dumps, and their
``trace_id``s ride as exemplars on latency-histogram buckets.

Sampling is DISABLED by default; ``mint()`` returns one shared no-op
context until a driver enables it. The serving hot path DEFERS
materialization: the front-end's scatter settles a whole coalesced
group through :meth:`TraceTail.settle_batch` under one lock, so an
unsampled request costs a deque append, and only KEPT traces build a
timeline or mint an id. Explicit :class:`TraceContext` objects
(``score(..., trace=ctx)``, the solvers' ``trace_ctx=``) take the full
per-request path.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

# Sampling switch — independent of the metrics flag so a caller can
# price it separately, but drivers turn both on together
# (telemetry.enable()).
_enabled = False


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


# Process-unique trace ids: a pid-derived prefix plus a counter. The
# formatting is lazy (``TraceContext.trace_id`` property) so unsampled
# requests never pay for the f-string.
_SEQ = itertools.count(1)
_ID_PREFIX = f"t{os.getpid():x}"


class TraceContext:
    """One request's (or one solve's) identity and timeline.

    ``event(stage)`` appends ``(stage, now)`` — list appends are atomic
    under the GIL, so events may arrive from any thread (the dispatch
    executor stamps ``dispatch`` while the event loop owns the object).
    ``finish(outcome)`` closes the timeline and hands the context to the
    process :class:`TraceTail` for the keep/drop decision. Group-shared
    stages (a coalesced group forms and dispatches at ONE instant) can
    be stamped in bulk via ``finish``'s ``stages`` argument — one call
    per request instead of one per stage, which is what keeps the
    sampled hot path under the overhead gate.
    """

    __slots__ = ("_seq", "_id", "kind", "t0", "start_unix", "events",
                 "annotations", "outcome", "duration_s", "kept")

    #: Timeline cap — a runaway outer loop must not grow one context
    #: without bound; beyond this, events drop (count preserved in the
    #: serialized timeline via ``events_dropped``).
    MAX_EVENTS = 256

    def __init__(self, kind: str):
        self._seq = next(_SEQ)
        self._id = None
        self.kind = kind
        self.t0 = time.perf_counter()
        self.start_unix = time.time()
        self.events: List[Tuple[str, float]] = []
        self.annotations: Optional[dict] = None
        self.outcome: Optional[str] = None
        self.duration_s: Optional[float] = None
        self.kept = False

    @property
    def trace_id(self) -> str:
        tid = self._id
        if tid is None:
            tid = self._id = f"{_ID_PREFIX}-{self._seq:08x}"
        return tid

    def event(self, stage: str) -> None:
        """Append a named timeline point (any thread)."""
        if len(self.events) < self.MAX_EVENTS:
            self.events.append((stage, time.perf_counter()))

    def annotate(self, **kw) -> None:
        """Attach key/value context (model name, rows, λ, ...)."""
        if self.annotations is None:
            self.annotations = {}
        self.annotations.update(kw)

    def finish(self, outcome: str = "ok",
               stages: Optional[Dict[str, float]] = None) -> None:
        """Close the timeline and offer it to the tail sampler.

        ``stages`` merges group-shared ``{stage: perf_counter}`` points
        recorded once per coalesced group (coalesce/dispatch/settle —
        identical for every window-mate) into this request's timeline
        without per-request ``event()`` calls. Idempotent: only the
        first finish records. Sets ``self.kept`` to the tail's verdict
        — exemplar wiring reads it so only resolvable ids are ever
        stamped on a histogram bucket."""
        if self.outcome is not None:
            return
        now = time.perf_counter()
        self.outcome = outcome
        self.duration_s = now - self.t0
        if stages:
            self.events.extend(stages.items())
        self.kept = _TAIL.record(self)

    def snapshot(self) -> dict:
        """Serialized timeline (built only for KEPT traces): stage
        offsets in seconds from mint, sorted by time."""
        events = sorted(self.events, key=lambda e: e[1])
        out = {
            "trace_id": self.trace_id,
            "kind": self.kind,
            "outcome": self.outcome,
            "start_unix": self.start_unix,
            "duration_s": self.duration_s,
            "events": [{"stage": s, "t_s": round(t - self.t0, 9)}
                       for s, t in events],
        }
        if len(self.events) >= self.MAX_EVENTS:
            out["events_dropped"] = True
        if self.annotations:
            out["annotations"] = dict(self.annotations)
        return out


class _NoopTraceContext:
    """Shared do-nothing context — THE disabled fast path. Its
    ``trace_id`` is None so exemplar plumbing short-circuits too."""

    __slots__ = ()
    trace_id = None
    kind = "noop"
    outcome = None
    duration_s = None
    annotations = None
    kept = False
    events: List = []

    def event(self, stage: str) -> None:
        return None

    def annotate(self, **kw) -> None:
        return None

    def finish(self, outcome: str = "ok", stages=None) -> None:
        return None

    def snapshot(self) -> dict:
        return {}


NOOP_CONTEXT = _NoopTraceContext()


def mint(kind: str = "request"):
    """New :class:`TraceContext` (the shared no-op while sampling is
    disabled — zero allocation, same discipline as ``span()``)."""
    if not _enabled:
        return NOOP_CONTEXT
    return TraceContext(kind)


class TraceTail:
    """Bounded tail sampler of finished trace contexts.

    Three keep classes, each a bounded ring (oldest evicted):

    - ``error`` — every non-``ok`` outcome (shed/error/cancelled/...),
    - ``slow`` — duration >= the cached P90 of the last ``window``
      completion durations (the slowest decile; with fewer than
      ``_MIN_WINDOW`` samples everything qualifies, so early traces are
      visible immediately),
    - ``floor`` — every ``floor_every``-th finish regardless (the
      uniform baseline).

    A trace lands in exactly one ring (error > slow > floor priority).
    ``record`` is O(1) amortized: the decile threshold recomputes every
    ``_THRESHOLD_REFRESH`` records from the duration window, not per
    record, and timeline serialization happens only for kept traces.

    ``settle_batch`` is the front-end's hot path: a coalesced group
    settles every deferred request under ONE lock acquisition, and an
    unsampled request's whole cost is a deque append — no context
    object, no per-request lock, no id formatting (ids mint only for
    KEPT traces, which also makes every exemplar resolvable by
    construction).
    """

    _MIN_WINDOW = 20
    _THRESHOLD_REFRESH = 64

    def __init__(self, slow_capacity: int = 64, error_capacity: int = 64,
                 floor_capacity: int = 32, floor_every: int = 64,
                 window: int = 512):
        self.floor_every = max(1, int(floor_every))
        self._window_n = int(window)
        self._lock = threading.Lock()
        self._slow: deque = deque(maxlen=slow_capacity)
        self._error: deque = deque(maxlen=error_capacity)
        self._floor: deque = deque(maxlen=floor_capacity)
        self._durations: deque = deque(maxlen=self._window_n)
        self._threshold: Optional[float] = None
        self._since_refresh = 0
        self._seen = 0
        self._kept = {"error": 0, "slow": 0, "floor": 0}

    def _refresh_threshold(self) -> None:
        # P90 by sort of the (bounded) window — runs every
        # _THRESHOLD_REFRESH records, so the amortized per-finish cost
        # is O(window log window / refresh) ~ a few hundred ns.
        durs = sorted(self._durations)
        self._threshold = durs[int(0.9 * (len(durs) - 1))]
        self._since_refresh = 0

    def _classify(self, d: float, outcome: str):
        """Keep/drop decision (caller holds the lock): updates the
        duration window + cached decile threshold, returns
        ``(ring, class)`` or ``(None, None)`` for a drop."""
        self._seen += 1
        if outcome != "ok":
            # Non-ok finishes keep unconditionally AND stay out of the
            # duration window: a shed finishes microseconds after mint,
            # so under heavy overload its ~0s durations would drag the
            # "P90 of completions" below normal completion latency and
            # classify every ok request slow — the threshold must track
            # COMPLETIONS only.
            return self._error, "error"
        self._durations.append(d)
        self._since_refresh += 1
        enough = len(self._durations) >= self._MIN_WINDOW
        if enough and (self._threshold is None
                       or self._since_refresh
                       >= self._THRESHOLD_REFRESH):
            self._refresh_threshold()
        if not enough or d >= self._threshold:
            return self._slow, "slow"
        if self._seen % self.floor_every == 0:
            return self._floor, "floor"
        return None, None

    def record(self, ctx: TraceContext) -> bool:
        """Classify one finished context; True when its timeline was
        kept (so its trace_id resolves through ``find``)."""
        with self._lock:
            ring, cls = self._classify(ctx.duration_s or 0.0,
                                       ctx.outcome)
            if ring is None:
                return False
            # Serialize INSIDE the keep decision: dropped traces never
            # pay for dict building.
            ring.append(ctx.snapshot())
            self._kept[cls] += 1
            return True

    def settle_batch(self, entries, stages: Dict[str, float],
                     kind: str = "request") -> Dict[int, str]:
        """Batched deferred settle — the serving scatter path. Each
        entry is ``(t_admit, duration_s, outcome, error_name, slot)``
        for a request that never materialized a context; the whole
        group classifies under one lock, and ONLY kept entries build a
        timeline (admission at offset 0 plus the group-shared
        ``stages``) and mint a trace_id. Returns ``{slot: trace_id}``
        for kept ``ok`` entries, which the caller stamps as latency
        exemplars — so an exemplar always resolves through ``find``.
        """
        out: Dict[int, str] = {}
        kept = []
        with self._lock:
            for t_admit, d, outcome, err, slot in entries:
                ring, cls = self._classify(d, outcome)
                if ring is None:
                    continue
                tid = f"{_ID_PREFIX}-{next(_SEQ):08x}"
                events = [{"stage": "admit", "t_s": 0.0}]
                events += sorted(
                    ({"stage": s, "t_s": round(t - t_admit, 9)}
                     for s, t in stages.items()),
                    key=lambda e: e["t_s"])
                snap = {
                    "trace_id": tid,
                    "kind": kind,
                    "outcome": outcome,
                    "start_unix": None,  # filled below, outside the lock
                    "duration_s": d,
                    "events": events,
                }
                if err is not None:
                    snap["annotations"] = {"error": err}
                ring.append(snap)
                self._kept[cls] += 1
                kept.append((snap, t_admit))
                if outcome == "ok" and slot is not None:
                    out[slot] = tid
        if kept:
            # Wall-clock anchor for the kept few, off the lock: unix
            # start ~ now_unix - (now_perf - t_admit).
            now_unix = time.time()
            now_perf = time.perf_counter()
            for snap, t_admit in kept:
                snap["start_unix"] = now_unix - (now_perf - t_admit)
        return out

    def counters(self) -> dict:
        """Just the bookkeeping scalars (seen/kept/threshold) — the
        metrics.json form; ``snapshot()`` deep-copies every kept
        timeline, which a counters-only reader should not pay for."""
        with self._lock:
            return {
                "seen": self._seen,
                "kept": dict(self._kept),
                "slow_threshold_s": self._threshold,
            }

    def find(self, trace_id: str) -> Optional[dict]:
        """Resolve a trace_id (e.g. from a latency exemplar) to its
        kept timeline, or None if it was dropped/evicted."""
        with self._lock:
            for ring in (self._error, self._slow, self._floor):
                for snap in ring:
                    if snap.get("trace_id") == trace_id:
                        return dict(snap)
        return None

    def snapshot(self) -> dict:
        """The kept-trace payload: sampler config + counters + the kept
        timelines per class (newest last)."""
        with self._lock:
            return {
                "sampling_enabled": _enabled,
                "seen": self._seen,
                "kept": dict(self._kept),
                "slow_threshold_s": self._threshold,
                "window": len(self._durations),
                "floor_every": self.floor_every,
                "traces": {
                    "error": [dict(s) for s in self._error],
                    "slow": [dict(s) for s in self._slow],
                    "floor": [dict(s) for s in self._floor],
                },
            }

    def reset(self) -> None:
        with self._lock:
            self._slow.clear()
            self._error.clear()
            self._floor.clear()
            self._durations.clear()
            self._threshold = None
            self._since_refresh = 0
            self._seen = 0
            self._kept = {"error": 0, "slow": 0, "floor": 0}


_TAIL = TraceTail()


def trace_tail() -> TraceTail:
    """The process-wide tail sampler (fed by every
    ``TraceContext.finish``; dumped by the flight recorder)."""
    return _TAIL
