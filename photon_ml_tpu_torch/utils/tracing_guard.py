"""Build-count guard for the serving engine's bucket executables and the
coordinate updates' graphs (port of photon_ml_tpu/utils/tracing_guard.py:
RetraceError :38, assert_max_retraces :57-68, TracingGuard :70-145).

JAX's guard reads each jitted callable's compile-cache size. A bucket
executable of the port has no jit cache: on the card it is a captured
CUDA graph, on the CPU the eager bucket function. It counts its own
builds in an integer attribute ``traces`` (CUDA graph captures on the
card, builds of the eager function on the CPU), and the guard reads that
count, so "how many times was this bucket built?" is an assertable
invariant, as in JAX.

    guard = TracingGuard()
    guard.track("bucket", executable)     # or via ExecutableCache(guard=g)
    ... serve ...
    guard.assert_max_retraces(per_fn=1)   # every bucket built once

Names are cumulative: tracking a replacement under a taken name adds a
generation suffix, so an evicted-and-rebuilt bucket stays in the totals.
An executable that holds device state (a bucket's graph, buffers and
parameters) hands the guard its :class:`BuildCount` (``builds``) in its
place, so being tracked never keeps it alive: a swapped-out model's
buckets are freed while their builds stay counted.
Coordinate descent tracks each coordinate's update graph as
``fused:{name}`` and asserts one capture each at a run's end. The
training drivers' ``trace_budgets`` keys are ROADMAP A7.
"""

from __future__ import annotations

from typing import Dict, Optional


class RetraceError(AssertionError):
    """A bucket executable was built more often than its budget."""


class BuildCount:
    """A build counter (``traces``) that stands for its executable in a
    guard."""

    __slots__ = ("traces",)

    def __init__(self):
        self.traces = 0


def trace_count(fn) -> int:
    """The builds of a tracked executable (its ``traces``; 0 for an
    object without the attribute, e.g. a test double)."""
    return int(getattr(fn, "traces", 0))


def assert_max_retraces(fn, max_traces: int, name: str = "") -> None:
    """Assert that one tracked executable was built at most
    ``max_traces`` times (its total, first build included)."""
    n = trace_count(fn)
    if n > max_traces:
        label = name or getattr(fn, "__name__", repr(fn))
        raise RetraceError(
            f"{label}: traced {n} times, budget {max_traces} — something "
            "rebuilds it (a key that does not pin its shapes, or an "
            "executable built per call)")


class TracingGuard:
    """Registry of bucket executables with assertable build budgets.

    ``track(name, fn)`` is cumulative and name-unique; it keeps ``fn``'s
    ``builds`` where it has one, else ``fn``. Per-name budgets given at
    track time are checked by :meth:`verify`."""

    def __init__(self):
        self._fns: Dict[str, object] = {}
        self._budgets: Dict[str, int] = {}
        self.total_budget: Optional[int] = None

    def track(self, name: str, fn, max_traces: Optional[int] = None):
        base, n = name, 2
        while name in self._fns:
            name = f"{base}#{n}"
            n += 1
        self._fns[name] = getattr(fn, "builds", fn)
        if max_traces is not None:
            self._budgets[name] = max_traces
        return fn

    def __len__(self) -> int:
        return len(self._fns)

    def counts(self) -> Dict[str, int]:
        """name -> build count."""
        return {name: trace_count(fn) for name, fn in self._fns.items()}

    def total_traces(self) -> int:
        return sum(self.counts().values())

    def set_budget(self, max_total: int) -> None:
        """Total-build budget checked by :meth:`verify`."""
        self.total_budget = max_total

    def assert_max_retraces(self, max_total: Optional[int] = None,
                            per_fn: Optional[int] = None) -> None:
        """``max_total``: bound on the sum of build counts; ``per_fn``:
        bound on every tracked executable (1 = each built once)."""
        counts = self.counts()
        if max_total is not None and sum(counts.values()) > max_total:
            worst = sorted(counts.items(), key=lambda kv: -kv[1])[:8]
            raise RetraceError(
                f"total traces {sum(counts.values())} exceed budget "
                f"{max_total} across {len(counts)} tracked callables "
                f"(worst: {worst}) — a bucket/cache key is not pinning "
                "what it should, or entries are evicted and rebuilt")
        if per_fn is not None:
            over = {k: v for k, v in counts.items() if v > per_fn}
            if over:
                raise RetraceError(
                    f"callables over the per-fn trace budget {per_fn}: "
                    f"{over}")

    def verify(self) -> None:
        """Check every budget declared via track(..., max_traces=...) and
        set_budget(). No-op when none was declared."""
        counts = self.counts()
        over = {k: (counts.get(k, 0), b)
                for k, b in self._budgets.items() if counts.get(k, 0) > b}
        if over:
            raise RetraceError(
                "tracked callables exceeded their declared trace "
                f"budgets: {over}")
        if self.total_budget is not None:
            self.assert_max_retraces(max_total=self.total_budget)
