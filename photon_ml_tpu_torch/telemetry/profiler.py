"""Build and dispatch profiler for the serving engine's bucket executables
(port of photon_ml_tpu/telemetry/profiler.py:1-182).

An ``ExecutableCache`` knows every bucket the process built; this
profiler records, per cache key:

- **build wall time and a static cost** at build: ``lower_s`` is the
  wall time of the bucket's eager run plus its CUDA graph capture (JAX
  times ``fn.lower``; a capture already synchronizes the card on entry,
  so timing it adds none). JAX reads FLOPs and bytes from XLA's cost
  analysis (:45-62); the port has no compiler, so the engine reckons
  them from the bucket's padded shapes, each row-9 product at the count
  ``chip_smoke.py``'s ``spmv_entry`` uses for row 9's bound (2 nnz
  operations; values and column ids, the row pointers, the vector and
  the result read or written once), and passes them in;
- **first-call wall time**: the first replay's wall time (the graph's
  upload and launch), timed at the dispatch site with no added sync;
- **per-bucket dispatch wall**: dispatch-to-settle seconds observed
  where ``InFlightWindow`` already waits on the dispatch's event (never
  a new sync), per rows bucket, mirrored into registry histograms
  ``serving.bucket.r<rows>.dispatch_seconds`` and kept in always-live
  local accumulators. With pipeline depth > 1 the settle may lag the
  device finishing, so the number is an upper bound on device time.

``table()`` renders per key the build economics (``lower_s``,
``first_call_s``, ``flops``, ``bytes_accessed``) next to per rows bucket
the dispatch statistics (count, mean/min/max seconds, and
``est_flops_per_sec``: the static FLOP count over the mean dispatch
wall, a lower bound on the rate).
"""

from __future__ import annotations

import importlib
import threading
from typing import Dict, Optional

_reg = importlib.import_module("photon_ml_tpu_torch.telemetry.registry")


class ExecutableProfiler:
    """Per-key build economics and per-bucket dispatch timing for the
    engines that share it (a front-end's tenants share one, so their
    whole bucket population lands in one table). All local state is
    plain dicts under one lock, live even while telemetry is disabled,
    like the engines' ``_stats``; only the registry histogram mirrors
    go quiet."""

    def __init__(self):
        self._lock = threading.Lock()
        self._builds: Dict[str, dict] = {}
        self._dispatch: Dict[int, dict] = {}
        self._hists: Dict[int, object] = {}

    # -- build-time profiling ----------------------------------------------

    def profile_build(self, key, seconds: float,
                      flops: Optional[float] = None,
                      bytes_accessed: Optional[float] = None,
                      rows_bucket: Optional[int] = None) -> None:
        """Record one cache build: its wall time (eager run and capture)
        and its static cost. ``rows_bucket`` is the key's rows component,
        passed structurally so ``table()`` can join builds onto dispatch
        rows without parsing key reprs."""
        entry = {"lower_s": float(seconds), "first_call_s": None,
                 "rows_bucket": (int(rows_bucket)
                                 if rows_bucket is not None else None)}
        if flops is not None:
            entry["flops"] = float(flops)
        if bytes_accessed is not None:
            entry["bytes_accessed"] = float(bytes_accessed)
        with self._lock:
            self._builds[repr(key)] = entry

    def record_first_call(self, key, seconds: float) -> None:
        """First-dispatch wall time (the first replay), timed at the
        dispatch site with no added sync."""
        with self._lock:
            entry = self._builds.setdefault(
                repr(key), {"lower_s": None, "first_call_s": None,
                            "rows_bucket": None})
            entry["first_call_s"] = float(seconds)

    # -- dispatch-time profiling -------------------------------------------

    def record_dispatch(self, rows_bucket: int, seconds: float,
                        rows: int) -> None:
        """One dispatch-to-settle observation for ``rows_bucket``,
        measured at the existing ``InFlightWindow`` settle."""
        rb = int(rows_bucket)
        s = float(seconds)
        with self._lock:
            d = self._dispatch.get(rb)
            if d is None:
                d = self._dispatch[rb] = {
                    "count": 0, "sum_s": 0.0, "min_s": s, "max_s": s,
                    "rows": 0}
                self._hists[rb] = _reg.registry().histogram(
                    f"serving.bucket.r{rb}.dispatch_seconds")
            d["count"] += 1
            d["sum_s"] += s
            d["min_s"] = min(d["min_s"], s)
            d["max_s"] = max(d["max_s"], s)
            d["rows"] += int(rows)
            hist = self._hists[rb]
        hist.observe(s)

    # -- reporting ---------------------------------------------------------

    def table(self) -> dict:
        """``builds`` (per cache key) and ``dispatch`` (per rows bucket,
        with ``est_flops_per_sec`` where a build of that rows bucket
        reported FLOPs: static FLOPs over the mean dispatch-to-settle
        wall, an upper-bound denominator and so a lower-bound rate)."""
        with self._lock:
            builds = {k: dict(v) for k, v in self._builds.items()}
            dispatch = {k: dict(v) for k, v in self._dispatch.items()}
        # Several nnz buckets share a rows bucket: take the widest.
        flops_by_rb: Dict[int, float] = {}
        for b in builds.values():
            fl = b.get("flops")
            rb = b.get("rows_bucket")
            if fl is None or rb is None:
                continue
            flops_by_rb[rb] = max(flops_by_rb.get(rb, 0.0), fl)
        out_dispatch = {}
        for rb, d in sorted(dispatch.items()):
            mean_s = d["sum_s"] / d["count"] if d["count"] else None
            row = {
                "rows_bucket": rb,
                "dispatches": d["count"],
                "rows": d["rows"],
                "mean_s": mean_s,
                "min_s": d["min_s"],
                "max_s": d["max_s"],
            }
            fl = flops_by_rb.get(rb)
            if fl is not None and mean_s:
                row["est_flops_per_sec"] = fl / mean_s
            out_dispatch[f"r{rb}"] = row
        return {"builds": builds, "dispatch": out_dispatch}

    def reset(self) -> None:
        with self._lock:
            self._builds.clear()
            self._dispatch.clear()
            self._hists.clear()
