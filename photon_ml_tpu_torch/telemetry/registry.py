"""Process-wide metrics registry: counters, gauges, fixed-bucket latency
histograms with interpolated P50/P95/P99 (port of
photon_ml_tpu/telemetry/registry.py:1-437, with the exposition state of
Prometheus scrapes and SLO math, :261-279).

Components keep their per-instance ``stats()`` dicts for local
introspection and mirror into named registry metrics; drivers snapshot
the registry into the ``telemetry.metrics`` block of metrics.json.

Telemetry is DISABLED by default: every mutation (``inc``/``set``/
``observe``) first checks one module-global flag and returns (no lock,
no allocation), so instrumented hot paths cost a function call and a
branch when nobody is looking. CLI drivers enable it for their process;
libraries never toggle it. ``reset()`` zeroes metric objects in place,
so module-level handles stay live across driver runs in one process.

Metric names are dotted snake_case namespaces (``serving.requests``,
``data.shard_cache.hits``), as in the JAX package.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# One switch for the whole telemetry layer (metrics AND spans — spans.py
# imports this module's accessors). Mutations early-return when off.
_enabled = False


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


#: Default latency buckets: geometric, 10 µs .. 100 s, 5 per decade —
#: ~17% relative resolution, 36 buckets, covering a single bucket
#: dispatch (~100 µs) through a full streamed epoch.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    round(10.0 ** (-5 + k / 5.0), 10) for k in range(36))


class Counter:
    """Monotonic counter. ``inc`` is a no-op while telemetry is off.
    ``calls`` counts inc() invocations (not the summed value) — what the
    disabled-overhead estimate multiplies by the no-op cost."""

    __slots__ = ("name", "_value", "_calls", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._calls = 0
        self._lock = threading.Lock()

    def inc(self, amount: int = 1) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value += amount
            self._calls += 1

    @property
    def value(self) -> int:
        return self._value

    @property
    def calls(self) -> int:
        return self._calls

    def reset(self) -> None:
        with self._lock:
            self._value = 0
            self._calls = 0


class Gauge:
    """Last-write-wins instantaneous value (e.g. resident device bytes)."""

    __slots__ = ("name", "_value", "_calls")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._calls = 0

    def set(self, value) -> None:
        if not _enabled:
            return
        self._value = float(value)
        self._calls += 1

    @property
    def value(self) -> float:
        return self._value

    @property
    def calls(self) -> int:
        return self._calls

    def reset(self) -> None:
        self._value = 0.0
        self._calls = 0


class Histogram:
    """Fixed-bucket histogram with interpolated quantiles.

    Buckets are upper-edge-inclusive (a sample equal to a boundary lands
    in the bucket that boundary closes — Prometheus ``le`` semantics),
    with implicit underflow/overflow buckets beyond the configured
    boundaries. ``quantile(q)`` linearly interpolates inside the bucket
    containing rank ``q * count`` and clamps to the observed [min, max]
    — so a single-sample histogram returns that sample EXACTLY for every
    q, and a histogram whose samples all share one value is exact too;
    otherwise the error is bounded by the bucket width (~17% relative at
    the default buckets). Empty histograms return None.
    """

    __slots__ = ("name", "_bounds", "_bounds_arr", "_counts", "_count",
                 "_sum", "_min", "_max", "_lock", "_exemplars",
                 "exemplars_declared")

    def __init__(self, name: str,
                 buckets: Optional[Sequence[float]] = None,
                 exemplars: bool = False):
        self.name = name
        bounds = tuple(sorted(buckets if buckets is not None
                              else DEFAULT_LATENCY_BUCKETS))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._bounds = bounds
        self._bounds_arr = np.asarray(bounds, dtype=float)
        # counts[i] covers (bounds[i-1], bounds[i]]; counts[len(bounds)]
        # is the overflow bucket (bounds[-1], +inf).
        self._counts = [0] * (len(bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._lock = threading.Lock()
        # Last exemplar per bucket: (trace_id, value, unix_ts) or None.
        # Declared histograms (``exemplars=True`` — lint-checked to end
        # in ``_seconds`` by dev_scripts/metric_names.py) preallocate;
        # undeclared ones allocate lazily on the first exemplar, so the
        # common exemplar-free histogram stays two words lighter.
        self.exemplars_declared = bool(exemplars)
        self._exemplars = ([None] * (len(bounds) + 1)
                           if exemplars else None)

    def _set_exemplar(self, i: int, trace_id, v: float) -> None:
        # Caller holds self._lock. trace_id None = no exemplar (the
        # tracectx no-op context's id), so call sites stay branch-free.
        if trace_id is None:
            return
        ex = self._exemplars
        if ex is None:
            ex = self._exemplars = [None] * len(self._counts)
        ex[i] = (trace_id, v, time.time())

    def observe(self, value, n: int = 1, exemplar=None) -> None:
        """Record ``value`` (``n`` times — a coalesced dispatch settles a
        whole group at one latency, so the serving hot path takes the
        lock once per GROUP, not once per request). ``exemplar`` (a
        trace_id string, or None) stamps the landing bucket's exemplar
        slot — the link from a latency bucket to a kept trace timeline."""
        if not _enabled:
            return
        v = float(value)
        with self._lock:
            i = bisect.bisect_left(self._bounds, v)
            self._counts[i] += n
            self._count += n
            self._sum += v * n
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            if exemplar is not None:
                self._set_exemplar(i, exemplar, v)

    def observe_many(self, values, exemplars=None) -> None:
        """Vectorized ``observe`` for per-request samples that DIFFER
        within a settled group (queue waits, end-to-end latencies): one
        searchsorted + one lock acquisition for the whole batch instead
        of a locked bisect per sample. ``exemplars`` (optional, aligned
        with ``values``; entries may be None) stamps the LAST sample per
        bucket as that bucket's exemplar."""
        if not _enabled:
            return
        v = np.asarray(values, dtype=float).ravel()
        if v.size == 0:
            return
        idx = np.searchsorted(self._bounds_arr, v, side="left")
        binned = np.bincount(idx, minlength=len(self._counts))
        lo, hi = float(v.min()), float(v.max())
        with self._lock:
            for i in np.nonzero(binned)[0]:
                self._counts[i] += int(binned[i])
            self._count += int(v.size)
            self._sum += float(v.sum())
            if self._min is None or lo < self._min:
                self._min = lo
            if self._max is None or hi > self._max:
                self._max = hi
            if exemplars is not None:
                for i, val, tid in zip(idx, v, exemplars):
                    if tid is not None:
                        self._set_exemplar(int(i), tid, float(val))

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> Optional[float]:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self._count == 0:
                return None
            target = q * self._count  # rank in [0, count]
            cum = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                if cum + c >= target:
                    lo = self._bounds[i - 1] if i > 0 else self._min
                    hi = (self._bounds[i] if i < len(self._bounds)
                          else self._max)
                    frac = (target - cum) / c
                    val = lo + frac * (hi - lo)
                    return min(max(val, self._min), self._max)
                cum += c
            return self._max  # q == 1 with float round-off

    def percentiles(self) -> Dict[str, Optional[float]]:
        return {"p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def snapshot(self) -> Dict:
        with self._lock:
            count, total = self._count, self._sum
            mn, mx = self._min, self._max
        out = {"count": count, "sum": total,
               "mean": (total / count if count else None),
               "min": mn, "max": mx}
        out.update(self.percentiles())
        # Exemplars ride only when stamped (conditional key: the
        # exemplar-free histogram snapshot schema is unchanged).
        ex = self.exemplars()
        if ex:
            out["exemplars"] = {
                str(b): {"trace_id": t, "value": v, "unix_ts": ts}
                for b, (t, v, ts) in ex.items()}
        return out

    def bucket_counts(self) -> Dict:
        """(upper-edge -> count) including the +inf overflow bucket."""
        with self._lock:
            out = {b: c for b, c in zip(self._bounds, self._counts)}
            out["+inf"] = self._counts[-1]
        return out

    def exposition_state(self) -> Tuple[Tuple[float, ...], list, int, float]:
        """Atomic ``(bounds, cumulative_counts, count, sum)`` for
        Prometheus exposition and SLO math: ``cumulative_counts[i]`` is
        the number of samples ``<= bounds[i]`` (``le`` semantics — the
        bucket layout already matches, so the mapping is a running sum,
        not a re-bin), and the implicit ``+Inf`` bucket equals
        ``count``. One lock acquisition, so a scrape racing ``observe``
        sees a consistent histogram (cumulative counts monotone,
        ``sum``/``count`` from the same instant)."""
        with self._lock:
            counts = list(self._counts)
            count, total = self._count, self._sum
        cum = []
        c = 0
        for v in counts[:-1]:
            c += v
            cum.append(c)
        return self._bounds, cum, count, total

    def exemplars(self) -> Dict:
        """(upper-edge or "+inf") -> (trace_id, value, unix_ts) for
        buckets that have one. Empty dict when none were ever stamped.
        Advisory data — read under the lock so a concurrent observe
        can't tear a tuple, but a reader pairs these with bucket
        counts from a separate read (an exemplar is a POINTER into
        the trace tail, not part of the histogram's consistency contract)."""
        with self._lock:
            ex = self._exemplars
            if ex is None:
                return {}
            out = {b: e for b, e in zip(self._bounds, ex)
                   if e is not None}
            if ex[-1] is not None:
                out["+inf"] = ex[-1]
        return out

    def state(self) -> Dict:
        """Full raw state (the form a later merge across processes reads): the
        per-bucket RAW counts (not cumulative — bucket-wise addition
        across processes is exact because every process shares the
        fixed ladder), the exact scalars, and per-bucket exemplars
        keyed by bucket INDEX (JSON-stable; the +inf overflow bucket is
        the last index). One lock acquisition, so the exported state is
        internally consistent under concurrent observation."""
        with self._lock:
            ex = {}
            if self._exemplars is not None:
                ex = {str(i): list(e)
                      for i, e in enumerate(self._exemplars)
                      if e is not None}
            return {
                "bounds": list(self._bounds),
                "counts": list(self._counts),
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
                "exemplars": ex,
            }

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self._bounds) + 1)
            self._count = 0
            self._sum = 0.0
            self._min = self._max = None
            if self._exemplars is not None:
                self._exemplars = [None] * len(self._counts)


class MetricsRegistry:
    """Name -> metric store. ``counter``/``gauge``/``histogram`` are
    get-or-create (so module-level handles and late lookups share the
    same object); ``snapshot`` renders the whole registry as the plain
    snake_case dict that lands in metrics.json / BENCH output."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            m = self._counters.get(name)
            if m is None:
                m = self._counters[name] = Counter(name)
            return m

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            m = self._gauges.get(name)
            if m is None:
                m = self._gauges[name] = Gauge(name)
            return m

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None,
                  exemplars: bool = False) -> Histogram:
        with self._lock:
            m = self._histograms.get(name)
            if m is None:
                m = self._histograms[name] = Histogram(
                    name, buckets, exemplars=exemplars)
            return m

    def metrics(self) -> Tuple[Dict[str, Counter], Dict[str, Gauge],
                               Dict[str, Histogram]]:
        """Shallow copies of the three name->metric maps (the
        renderer and flight recorder iterate metric OBJECTS, not the
        plain-value snapshot)."""
        with self._lock:
            return (dict(self._counters), dict(self._gauges),
                    dict(self._histograms))

    def snapshot(self) -> Dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: v.value for k, v in sorted(counters.items())},
            "gauges": {k: v.value for k, v in sorted(gauges.items())},
            "histograms": {k: v.snapshot()
                           for k, v in sorted(histograms.items())},
        }

    def mutation_calls(self) -> int:
        """Total inc()/set()/observe() invocations since the last reset
        — the disabled fast path executes this many no-op calls, so the
        caller multiplies it by the measured no-op cost to bound the
        disabled-telemetry overhead."""
        with self._lock:
            return (sum(c.calls for c in self._counters.values())
                    + sum(g.calls for g in self._gauges.values())
                    + sum(h.count for h in self._histograms.values()))

    def reset(self) -> None:
        """Zero every metric (objects and handles stay valid)."""
        with self._lock:
            metrics = (list(self._counters.values())
                       + list(self._gauges.values())
                       + list(self._histograms.values()))
        for m in metrics:
            m.reset()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry instance."""
    return _REGISTRY
