"""Fleet observability federation: one pane of glass over N processes.

Port of photon_ml_tpu/telemetry/federation.py:1-967 (standard library
only). The live plane (exposition.py) is per process, but training
children and serving replicas run as several processes. This module
merges their planes:

- :func:`registry_snapshot` serializes one process's registry into the
  canonical ``photon.obs.snapshot.v1`` schema served on ``/snapshotz``:
  counters, gauges (value + call count), FULL raw histogram bucket
  states with exemplars (:meth:`Histogram.state`), sketch states, SLO
  spec strings, tail-sampled traces, stage attribution, and process
  metadata (pid / role / start_unix / labels).
- :func:`merge_snapshots` folds any number of snapshots into a
  :class:`FleetView` with deterministic semantics: counters SUM;
  histograms add bucket-wise — EXACT, never a re-bin, because every
  process shares the fixed ladder (registry.py); gauges merge by the
  declared per-family policy (:data:`GAUGE_MERGE_POLICIES`, the JAX
  package's table, so a fleet view merges alike in both); sketches merge via their existing
  deterministic merges (sketches.py) in sorted-peer order, so the
  result is independent of scrape arrival order; trace tails union with
  per-process attribution; SLOs are re-evaluated STATELESSLY against
  the merged registry (slo.evaluate_specs) — because counters sum and
  buckets add exactly, the fleet burn rate is the true whole-fleet
  number, not an average of per-process burns.
- :class:`FleetAggregator` discovers peers from explicit URLs and/or
  ``obs_port`` descriptor files (see :func:`read_obs_descriptor`),
  pulls ``/snapshotz`` on an interval, tracks staleness (a dead child
  is marked stale, its LAST snapshot is retained, and the fleet plane
  degrades rather than crashes), and serves merged ``/metrics``,
  ``/statusz``, ``/tracez``, ``/distz`` — plus its own ``/snapshotz``
  in the same schema, so aggregators compose hierarchically.

The ``fleet.`` metric prefix is RESERVED for this module (peers may not
emit it). The aggregator's own
``fleet.*`` series come from plain internal state synthesized into a
pseudo-peer snapshot, never from the process-global registry: the
aggregator can ride inside a harness or driver process without polluting
that process's plane or depending on the telemetry enable flag.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import re
import socket
import threading
import time
import urllib.request
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_reg = importlib.import_module("photon_ml_tpu_torch.telemetry.registry")
_spans = importlib.import_module("photon_ml_tpu_torch.telemetry.spans")
_tracectx = importlib.import_module("photon_ml_tpu_torch.telemetry.tracectx")
_sketches = importlib.import_module("photon_ml_tpu_torch.telemetry.sketches")
_slo = importlib.import_module("photon_ml_tpu_torch.telemetry.slo")
_expo = importlib.import_module("photon_ml_tpu_torch.telemetry.exposition")

SNAPSHOT_SCHEMA = "photon.obs.snapshot.v1"

#: How many traces each merged tail ring retains (newest first): the
#: fleet view is a debugging aid, not an archive.
MERGED_TRACE_RING = 128

# ---------------------------------------------------------------------------
# Gauge merge policies
# ---------------------------------------------------------------------------

#: Per-family gauge merge policy. Counters and histograms have ONE
#: correct merge (sum / bucket-wise add); gauges do not — "bytes held"
#: sums across processes, "uptime" does not. Keys are exact dotted
#: names, ``prefix.`` entries (trailing dot, matched by startswith) or
#: ``.suffix`` entries (leading dot, matched by endswith); resolution
#: is exact > longest suffix > longest prefix > default ``last``.
#: The table is the JAX package's, entry for entry (its serving.net
#: and training.mesh entries name families of later queue items).
#:
#: ``last`` = the value from the peer with the newest snapshot_unix
#: among peers that ever set the gauge (tie → greatest peer id) —
#: deterministic, not arrival-order "last write wins".
GAUGE_MERGE_POLICIES: Dict[str, str] = {
    # Process lifetime gauges: fleet uptime is the OLDEST process.
    "process.uptime_seconds": "max",
    "process.heartbeat_unix_time": "max",
    # Training-data distribution headline gauges (data/distmon.py):
    # volumes sum, statistical headlines (means/percentiles) keep the
    # newest writer — cross-process means need the sketches, which the
    # fleet merges exactly on /distz.
    "data.dist.rows": "sum",
    "data.dist.batches": "sum",
    "data.dist.": "last",
    # Cache/residency byte counts are per-process holdings: sum.
    "data.factor_cache.": "sum",
    "data.shard_cache.": "sum",
    # Aggregator-reserved namespace (pseudo-peer snapshots only).
    "fleet.": "last",
    # SLO burn + drift scores: the fleet is as burnt as its worst
    # member (alerts must not average away a bad replica).
    ".burn_rate": "max",
    ".score_drift_psi": "max",
    ".score_drift_ks": "max",
    ".score_dist_rows": "sum",
    # Batched λ-grid: in-flight grid points sum across processes (the
    # fleet-wide count of λ points still iterating).
    "training.grid.active_points": "sum",
    # 2-D mesh extents (ops/sharded_objective.py): each process trains
    # on its own mesh; the fleet view keeps the newest writer rather
    # than summing axis extents into a meaningless total. (The
    # training.mesh.*_transfer_bytes series are counters and sum.)
    "training.mesh.": "last",
    # Network front door (serving/netserver.py): connections held open
    # are per-process holdings — the fleet has the sum. (Everything
    # else under serving.net.* is a counter; a counter.)
    "serving.net.open_connections": "sum",
    # SLO-adaptive admission controller state (serving/adaptive.py):
    # each replica steers its own knobs; the merged view keeps the
    # newest writer (burn_rate maxes via the .burn_rate entry above —
    # the fleet is as burnt as its worst member).
    "serving.adaptive.": "last",
}

_VALID_POLICIES = ("sum", "max", "last")


def gauge_merge_policy(name: str) -> str:
    """Resolve the merge policy for gauge family ``name`` (docstring of
    :data:`GAUGE_MERGE_POLICIES` for precedence)."""
    hit = GAUGE_MERGE_POLICIES.get(name)
    if hit is not None:
        return hit
    best = None
    for key, pol in GAUGE_MERGE_POLICIES.items():
        if key.startswith(".") and name.endswith(key):
            if best is None or len(key) > len(best[0]):
                best = (key, pol)
    if best is not None:
        return best[1]
    for key, pol in GAUGE_MERGE_POLICIES.items():
        if key.endswith(".") and name.startswith(key):
            if best is None or len(key) > len(best[0]):
                best = (key, pol)
    return best[1] if best is not None else "last"


# ---------------------------------------------------------------------------
# Snapshot serialization
# ---------------------------------------------------------------------------

def registry_snapshot(role: str = "process",
                      labels: Optional[Dict[str, str]] = None,
                      slo_specs: Optional[Sequence[str]] = None,
                      sketch_providers: Optional[
                          Dict[str, Callable[[], dict]]] = None,
                      start_unix: Optional[float] = None,
                      registry=None) -> dict:
    """Serialize the registry (default: the process-global one) into
    the canonical snapshot schema. Histograms export their RAW
    per-bucket counts (:meth:`Histogram.state`) so the fleet merge is
    bucket-wise addition, exact by construction. Sketch providers
    (``{key: state_dict}`` callables) contribute under ``sketches``; a
    provider that raises reports its error inline — a snapshot must
    never fail because one sketch source is mid-teardown."""
    reg = registry if registry is not None else _reg.registry()
    counters, gauges, histograms = reg.metrics()
    sketches: Dict[str, dict] = {}
    sketch_errors: Dict[str, str] = {}
    for pname, fn in sorted((sketch_providers or {}).items()):
        try:
            sketches[pname] = {str(k): v for k, v in fn().items()}
        except Exception as e:  # noqa: BLE001 — report, don't fail
            sketch_errors[pname] = f"{type(e).__name__}: {e}"
    snap = {
        "schema": SNAPSHOT_SCHEMA,
        "process": {
            "pid": os.getpid(),
            "role": role,
            "host": socket.gethostname(),
            "start_unix": start_unix,
            "snapshot_unix": time.time(),
            "labels": dict(labels or {}),
        },
        "counters": {n: c.value for n, c in sorted(counters.items())},
        "gauges": {n: {"value": g.value, "calls": g.calls}
                   for n, g in sorted(gauges.items())},
        "histograms": {n: h.state()
                       for n, h in sorted(histograms.items())},
        "sketches": sketches,
        "slo_specs": [str(s) for s in (slo_specs or [])],
        "traces": _tracectx.trace_tail().snapshot(),
        "stages": _spans.stage_attribution(),
    }
    if sketch_errors:
        snap["sketch_errors"] = sketch_errors
    return snap


# ---------------------------------------------------------------------------
# Merged registry (duck-typed read-only twins)
# ---------------------------------------------------------------------------

class _MergedCounter:
    """Read-only counter twin: quacks like registry.Counter for the
    exposition renderer and SLO math."""

    __slots__ = ("name", "value", "calls")

    def __init__(self, name: str, value=0):
        self.name = name
        self.value = value
        self.calls = 0


class _MergedGauge:
    __slots__ = ("name", "value", "calls", "policy")

    def __init__(self, name: str, value=0.0, calls=0, policy="last"):
        self.name = name
        self.value = value
        self.calls = calls
        self.policy = policy


class _MergedHistogram:
    """Read-only histogram twin rebuilt from merged raw-bucket state;
    implements the read surface consumers use (exposition_state,
    exemplars, quantile, snapshot, state)."""

    def __init__(self, name: str, state: dict):
        self.name = name
        self._bounds = tuple(float(b) for b in state["bounds"])
        self._counts = [int(c) for c in state["counts"]]
        self._count = int(state["count"])
        self._sum = float(state["sum"])
        self._min = state["min"]
        self._max = state["max"]
        self._ex = {int(i): tuple(e)
                    for i, e in (state.get("exemplars") or {}).items()}

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def exposition_state(self):
        cum, c = [], 0
        for v in self._counts[:-1]:
            c += v
            cum.append(c)
        return self._bounds, cum, self._count, self._sum

    def exemplars(self) -> dict:
        out = {}
        for i, e in self._ex.items():
            key = (self._bounds[i] if i < len(self._bounds) else "+inf")
            out[key] = e
        return out

    def quantile(self, q: float):
        # Same interpolation as registry.Histogram.quantile, over the
        # merged raw buckets and the fleet-wide min/max.
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self._count == 0:
            return None
        target = q * self._count
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
        return self._max

    def percentiles(self):
        return {"p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def snapshot(self) -> dict:
        out = {"count": self._count, "sum": self._sum,
               "mean": (self._sum / self._count if self._count
                        else None),
               "min": self._min, "max": self._max}
        out.update(self.percentiles())
        ex = self.exemplars()
        if ex:
            out["exemplars"] = {
                str(b): {"trace_id": t, "value": v, "unix_ts": ts}
                for b, (t, v, ts) in ex.items()}
        return out

    def state(self) -> dict:
        return {"bounds": list(self._bounds),
                "counts": list(self._counts),
                "count": self._count, "sum": self._sum,
                "min": self._min, "max": self._max,
                "exemplars": {str(i): list(e)
                              for i, e in sorted(self._ex.items())}}


class MergedRegistry:
    """Read-only registry twin over merged metric maps: the exposition
    renderer (``render_prometheus(registry=...)``), the stateless SLO
    evaluator and /statusz all consume it through the same duck-typed
    surface as the live registry. Lookups of names no peer reported
    return zero-valued twins (get-or-observe-nothing), mirroring the
    live registry's get-or-create so SLO specs over quiet metrics judge
    "no traffic" instead of raising."""

    def __init__(self, counters: Dict[str, _MergedCounter],
                 gauges: Dict[str, _MergedGauge],
                 histograms: Dict[str, _MergedHistogram]):
        self._counters = counters
        self._gauges = gauges
        self._histograms = histograms

    def counter(self, name: str) -> _MergedCounter:
        return self._counters.get(name) or _MergedCounter(name)

    def gauge(self, name: str) -> _MergedGauge:
        return self._gauges.get(name) or _MergedGauge(name)

    def histogram(self, name: str, buckets=None, exemplars=False):
        h = self._histograms.get(name)
        if h is None:
            h = _MergedHistogram(name, {
                "bounds": list(_reg.DEFAULT_LATENCY_BUCKETS),
                "counts": [0] * (len(_reg.DEFAULT_LATENCY_BUCKETS) + 1),
                "count": 0, "sum": 0.0, "min": None, "max": None})
        return h

    def metrics(self):
        return (dict(self._counters), dict(self._gauges),
                dict(self._histograms))

    def snapshot(self) -> dict:
        return {
            "counters": {k: v.value
                         for k, v in sorted(self._counters.items())},
            "gauges": {k: v.value
                       for k, v in sorted(self._gauges.items())},
            "histograms": {k: v.snapshot()
                           for k, v in sorted(self._histograms.items())},
        }


# ---------------------------------------------------------------------------
# Merge
# ---------------------------------------------------------------------------

def _merge_exemplars(ex_a: Dict[int, tuple],
                     ex_b: Dict[int, tuple]) -> Dict[int, tuple]:
    """Per-bucket: keep the NEWEST exemplar (greatest unix ts); ties
    break toward the smallest trace_id so merge order cannot leak in."""
    out = dict(ex_a)
    for i, e in ex_b.items():
        prev = out.get(i)
        if prev is None or (e[2], prev[0]) > (prev[2], e[0]):
            out[i] = tuple(e)
    return out


def _merge_histogram_states(a: dict, b: dict,
                            name: str, notes: List[str]) -> dict:
    """Bucket-wise addition of two raw histogram states. Exact because
    both sides share the fixed ladder; a ladder mismatch (custom-bucket
    drift between versions) keeps the first state and records a note —
    re-binning would silently fabricate counts."""
    if list(a["bounds"]) != list(b["bounds"]):
        notes.append(f"histogram {name!r}: bucket ladder mismatch, "
                     f"kept first peer's state")
        return a
    mins = [m for m in (a["min"], b["min"]) if m is not None]
    maxs = [m for m in (a["max"], b["max"]) if m is not None]
    ex = _merge_exemplars(
        {int(i): tuple(e) for i, e in (a.get("exemplars") or {}).items()},
        {int(i): tuple(e) for i, e in (b.get("exemplars") or {}).items()})
    return {
        "bounds": list(a["bounds"]),
        "counts": [int(x) + int(y)
                   for x, y in zip(a["counts"], b["counts"])],
        "count": int(a["count"]) + int(b["count"]),
        "sum": float(a["sum"]) + float(b["sum"]),
        "min": min(mins) if mins else None,
        "max": max(maxs) if maxs else None,
        "exemplars": {str(i): list(e) for i, e in sorted(ex.items())},
    }


def _merge_traces(snaps: List[Tuple[str, dict]]) -> dict:
    """Union the peers' tail-sampled trace rings, tagging every trace
    with its peer id (the per-process attribution /tracez promises).
    Rings are sorted newest-first by (start_unix, trace_id) — a total
    order, so the merged tail is peer-order independent — and capped at
    :data:`MERGED_TRACE_RING`."""
    out = {"sampling_enabled": False, "seen": 0, "kept": {},
           "peers": {}, "traces": {}}
    rings: Dict[str, list] = {}
    for peer_id, tr in snaps:
        if not isinstance(tr, dict):
            continue
        out["sampling_enabled"] = (out["sampling_enabled"]
                                   or bool(tr.get("sampling_enabled")))
        out["seen"] += int(tr.get("seen", 0))
        for ring, n in (tr.get("kept") or {}).items():
            out["kept"][ring] = out["kept"].get(ring, 0) + int(n)
        out["peers"][peer_id] = {"seen": tr.get("seen", 0),
                                 "kept": tr.get("kept", {})}
        for ring, traces in (tr.get("traces") or {}).items():
            for t in traces:
                tagged = dict(t)
                tagged["peer"] = peer_id
                rings.setdefault(ring, []).append(tagged)
    for ring, traces in rings.items():
        traces.sort(key=lambda t: (-float(t.get("start_unix") or 0.0),
                                   str(t.get("trace_id"))))
        out["traces"][ring] = traces[:MERGED_TRACE_RING]
    return out


def _merge_sketch_maps(snaps: List[Tuple[str, dict]],
                       notes: List[str]) -> dict:
    """Merge ``{provider: {key: state}}`` maps across peers via the
    sketches' own deterministic merges, folding in SORTED peer order:
    quantile/moments merges are fully associative+commutative (bitwise
    order-independent), and the weighted Misra-Gries TopK — whose
    combine is order-dependent by nature — becomes deterministic under
    the fixed fold order."""
    merged: Dict[str, Dict[str, object]] = {}
    for peer_id, sketches in snaps:  # caller passes sorted peers
        for provider, states in (sketches or {}).items():
            slot = merged.setdefault(provider, {})
            for key, state in states.items():
                try:
                    sk = _sketches.sketch_from_state(state)
                    if key in slot:
                        slot[key].merge(sk)
                    else:
                        slot[key] = sk
                except Exception as e:  # noqa: BLE001 — keep merging
                    notes.append(f"sketch {provider}/{key} from "
                                 f"{peer_id}: {type(e).__name__}: {e}")
    return {provider: {key: sk.state()
                       for key, sk in sorted(slot.items())}
            for provider, slot in sorted(merged.items())}


@dataclasses.dataclass
class FleetView:
    """One merged, self-consistent view of the fleet at merge time."""

    registry: MergedRegistry
    sketches: dict
    traces: dict
    slo_specs: List[str]
    slo: dict
    peers: Dict[str, dict]
    notes: List[str]

    def snapshot(self, role: str = "aggregator",
                 labels: Optional[Dict[str, str]] = None,
                 start_unix: Optional[float] = None) -> dict:
        """The merged view re-serialized in the SAME v1 schema — the
        merge is closed under serialization, so aggregators stack."""
        counters, gauges, histograms = self.registry.metrics()
        return {
            "schema": SNAPSHOT_SCHEMA,
            "process": {
                "pid": os.getpid(),
                "role": role,
                "host": socket.gethostname(),
                "start_unix": start_unix,
                "snapshot_unix": time.time(),
                "labels": dict(labels or {}),
                "merged_peers": sorted(self.peers),
            },
            "counters": {n: c.value
                         for n, c in sorted(counters.items())},
            "gauges": {n: {"value": g.value, "calls": g.calls}
                       for n, g in sorted(gauges.items())},
            "histograms": {n: h.state()
                           for n, h in sorted(histograms.items())},
            "sketches": self.sketches,
            "slo_specs": list(self.slo_specs),
            "traces": self.traces,
            "stages": {},
        }


def merge_snapshots(snapshots: Dict[str, dict]) -> FleetView:
    """Fold ``{peer_id: snapshot}`` into a :class:`FleetView`.

    Peers are processed in sorted peer-id order, which together with
    the per-type semantics (associative counter/bucket sums, total-
    order gauge/exemplar tie-breaks, fixed sketch fold order) makes the
    result a pure function of the snapshot SET — permuting arrival
    order cannot change a byte of the merged output."""
    notes: List[str] = []
    counters: Dict[str, _MergedCounter] = {}
    gauge_obs: Dict[str, list] = {}
    hist_states: Dict[str, dict] = {}
    peers: Dict[str, dict] = {}
    specs: List[str] = []
    ordered = sorted(snapshots.items())
    for peer_id, snap in ordered:
        if snap.get("schema") != SNAPSHOT_SCHEMA:
            notes.append(f"peer {peer_id}: unknown schema "
                         f"{snap.get('schema')!r}, skipped")
            continue
        proc = snap.get("process") or {}
        peers[peer_id] = proc
        snap_unix = float(proc.get("snapshot_unix") or 0.0)
        for name, value in (snap.get("counters") or {}).items():
            c = counters.get(name)
            if c is None:
                c = counters[name] = _MergedCounter(name)
            c.value += value
        for name, g in (snap.get("gauges") or {}).items():
            gauge_obs.setdefault(name, []).append(
                (peer_id, snap_unix, g["value"], int(g.get("calls", 0))))
        for name, state in (snap.get("histograms") or {}).items():
            prev = hist_states.get(name)
            hist_states[name] = (dict(state) if prev is None else
                                 _merge_histogram_states(
                                     prev, state, name, notes))
        for s in snap.get("slo_specs") or []:
            if s not in specs:
                specs.append(s)
    gauges: Dict[str, _MergedGauge] = {}
    for name, obs in gauge_obs.items():
        policy = gauge_merge_policy(name)
        set_obs = [o for o in obs if o[3] > 0]
        calls = sum(o[3] for o in obs)
        if not set_obs:
            gauges[name] = _MergedGauge(name, 0.0, calls, policy)
        elif policy == "sum":
            gauges[name] = _MergedGauge(
                name, sum(o[2] for o in set_obs), calls, policy)
        elif policy == "max":
            gauges[name] = _MergedGauge(
                name, max(o[2] for o in set_obs), calls, policy)
        else:  # "last": newest snapshot wins; tie → greatest peer id
            winner = max(set_obs, key=lambda o: (o[1], o[0]))
            gauges[name] = _MergedGauge(name, winner[2], calls, policy)
    histograms = {name: _MergedHistogram(name, st)
                  for name, st in hist_states.items()}
    reg = MergedRegistry(counters, gauges, histograms)
    sketches = _merge_sketch_maps(
        [(pid, s.get("sketches")) for pid, s in ordered
         if pid in peers], notes)
    traces = _merge_traces(
        [(pid, s.get("traces")) for pid, s in ordered if pid in peers])
    slo = {}
    if specs:
        try:
            slo = _slo.evaluate_specs(specs, reg)
        except Exception as e:  # noqa: BLE001 — view must still build
            notes.append(f"slo re-evaluation failed: "
                         f"{type(e).__name__}: {e}")
    return FleetView(registry=reg, sketches=sketches, traces=traces,
                     slo_specs=specs, slo=slo, peers=peers, notes=notes)


# ---------------------------------------------------------------------------
# Peer discovery: obs_port descriptor files
# ---------------------------------------------------------------------------

def write_obs_descriptor(path, port: int, role: str = "process",
                         pid: Optional[int] = None,
                         start_unix: Optional[float] = None) -> dict:
    """Write the ``<out>/obs_port`` announcement as a JSON descriptor
    ``{port, pid, role, start_unix}`` (one line). Replaces the older
    plain-int file; :func:`read_obs_descriptor` still parses both."""
    desc = {"port": int(port),
            "pid": int(pid if pid is not None else os.getpid()),
            "role": role,
            "start_unix": (time.time() if start_unix is None
                           else float(start_unix))}
    Path(path).write_text(json.dumps(desc) + "\n")
    return desc


def read_obs_descriptor(path) -> dict:
    """Parse an ``obs_port`` announcement file. JSON descriptors return
    as-is (``port`` coerced int); legacy plain-int files return a
    minimal ``{"port": N}`` so pre-descriptor children stay
    discoverable."""
    text = Path(path).read_text().strip()
    try:
        desc = json.loads(text)
    except (ValueError, TypeError):
        desc = None
    if isinstance(desc, dict) and "port" in desc:
        desc["port"] = int(desc["port"])
        return desc
    return {"port": int(text)}


def discover_peers(peer_dirs: Sequence) -> Dict[str, dict]:
    """Scan output directories for ``obs_port`` descriptors: each dir
    itself, plus one level of subdirectories (the replica-harness
    layout — one parent dir, one child dir per replica). Returns
    ``{peer_id: descriptor + url}``; unreadable files are skipped (a
    child racing its own startup writes atomically-enough for JSON one-
    liners, but a garbled read just means "try next interval")."""
    found: Dict[str, dict] = {}
    for d in peer_dirs:
        d = Path(d)
        candidates = [d / "obs_port"]
        if d.is_dir():
            candidates += sorted(c / "obs_port" for c in d.iterdir()
                                 if c.is_dir())
        for f in candidates:
            if not f.is_file():
                continue
            try:
                desc = read_obs_descriptor(f)
            except (OSError, ValueError):
                continue
            desc["url"] = f"http://127.0.0.1:{desc['port']}"
            peer_id = (f"{desc.get('role', 'process')}"
                       f"-{desc.get('pid', f.parent.name)}"
                       f"@{desc['port']}")
            found[peer_id] = desc
    return found


# ---------------------------------------------------------------------------
# Aggregator
# ---------------------------------------------------------------------------

class _PeerState:
    __slots__ = ("peer_id", "url", "snapshot", "last_success_unix",
                 "last_attempt_unix", "last_error", "scrapes", "errors")

    def __init__(self, peer_id: str, url: str):
        self.peer_id = peer_id
        self.url = url
        self.snapshot: Optional[dict] = None
        self.last_success_unix: Optional[float] = None
        self.last_attempt_unix: Optional[float] = None
        self.last_error: Optional[str] = None
        self.scrapes = 0
        self.errors = 0


def _peer_metric_label(peer_id: str) -> str:
    """Sanitize a peer id into a legal dotted-name PART for the
    ``fleet.peer.<label>.*`` gauges (lowercase [a-z0-9_])."""
    out = re.sub(r"[^a-z0-9_]+", "_", peer_id.lower()).strip("_")
    return out or "peer"


class FleetAggregator:
    """Polls peers' ``/snapshotz`` and serves the merged plane.

    - ``peers``: explicit base URLs (``http://127.0.0.1:9100``).
    - ``peer_dirs``: directories re-scanned every poll for ``obs_port``
      descriptors, so children that boot late are picked up.
    - staleness: a peer whose last successful scrape is older than
      ``stale_after_s`` (default 3 poll intervals) is STALE — its last
      snapshot is retained in the merge (final counts of a finished
      child stay in the fleet totals) and ``fleet.peer.<id>.stale`` /
      ``.staleness_seconds`` flag it on the merged ``/metrics``. A dead
      child therefore degrades the fleet plane; it never crashes it.
    - readiness: the aggregator's ``/readyz`` requires >= 1 FRESH peer.

    The aggregator owns a plain :class:`ObservabilityServer` whose
    /metrics, /statusz, /tracez, /distz and /snapshotz routes are
    overridden with merged views (per-process breakdown rides in
    /statusz ``peers``, /distz ``peers`` and trace ``peer`` tags); its
    own ``fleet.*`` telemetry is synthesized as a pseudo-peer snapshot
    from plain internal state — see the module docstring.
    """

    SELF_PEER_ID = "~aggregator-self"  # sorts after peer ids

    def __init__(self, peers: Sequence[str] = (),
                 peer_dirs: Sequence = (),
                 interval_s: float = 2.0,
                 stale_after_s: Optional[float] = None,
                 port: int = 0, host: str = "127.0.0.1",
                 timeout_s: float = 2.0,
                 labels: Optional[Dict[str, str]] = None):
        self.interval_s = float(interval_s)
        self.stale_after_s = (float(stale_after_s)
                              if stale_after_s is not None
                              else 3.0 * self.interval_s)
        self.timeout_s = float(timeout_s)
        self.peer_dirs = [Path(d) for d in peer_dirs]
        self.labels = dict(labels or {})
        self._static_urls = list(peers)
        self._peers: Dict[str, _PeerState] = {}
        self._lock = threading.Lock()
        self._view: Optional[FleetView] = None
        self._scrapes = 0
        self._scrape_errors = 0
        self._start_unix = time.time()
        self._poll_stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        self.server = _expo.ObservabilityServer(
            port=port, host=host, role="aggregator", labels=self.labels)
        self.server.add_route("/metrics", self._metrics)
        self.server.add_route("/statusz", self._statusz)
        self.server.add_route("/tracez", self._tracez)
        self.server.add_route("/distz", self._distz)
        self.server.add_route("/snapshotz", self._snapshotz)
        self.server.add_route("/healthz", self._healthz)
        self.server.set_ready_check(self._readiness)
        for url in self._static_urls:
            url = url.rstrip("/")
            self._peers[f"peer@{url}"] = _PeerState(f"peer@{url}", url)

    # -- scraping ----------------------------------------------------------

    def _fetch_snapshot(self, url: str) -> dict:
        with urllib.request.urlopen(url + "/snapshotz",
                                    timeout=self.timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def poll_once(self) -> None:
        """One discovery + scrape pass over every known peer."""
        discovered = discover_peers(self.peer_dirs)
        with self._lock:
            for peer_id, desc in discovered.items():
                if peer_id not in self._peers:
                    self._peers[peer_id] = _PeerState(
                        peer_id, desc["url"])
            states = list(self._peers.values())
        for st in states:
            st.last_attempt_unix = time.time()
            try:
                snap = self._fetch_snapshot(st.url)
            except Exception as e:  # noqa: BLE001 — dead peer degrades
                st.errors += 1
                st.last_error = f"{type(e).__name__}: {e}"
                self._scrape_errors += 1
                continue
            st.scrapes += 1
            st.snapshot = snap
            st.last_success_unix = time.time()
            st.last_error = None
        self._scrapes += 1
        self._rebuild_view()

    def peer_staleness(self) -> Dict[str, dict]:
        """Per-peer freshness: ``stale`` plus seconds since the last
        successful scrape (None before the first one)."""
        now = time.time()
        out = {}
        with self._lock:
            for peer_id, st in sorted(self._peers.items()):
                if st.last_success_unix is None:
                    staleness, stale = None, True
                else:
                    staleness = now - st.last_success_unix
                    stale = staleness > self.stale_after_s
                out[peer_id] = {
                    "url": st.url, "stale": stale,
                    "staleness_seconds": staleness,
                    "scrapes": st.scrapes, "errors": st.errors,
                    "last_error": st.last_error,
                    "has_snapshot": st.snapshot is not None,
                }
        return out

    def _self_snapshot(self) -> dict:
        """The aggregator's own ``fleet.*`` series as a pseudo-peer
        snapshot built from plain state — reserved-prefix telemetry
        without touching the process-global registry (no other
        module writes ``fleet.``)."""
        staleness = self.peer_staleness()
        fresh = sum(1 for s in staleness.values() if not s["stale"])
        gauges = {
            "fleet.peers": {"value": len(staleness), "calls": 1},
            "fleet.peers_fresh": {"value": fresh, "calls": 1},
            "fleet.peers_stale": {"value": len(staleness) - fresh,
                                  "calls": 1},
        }
        for peer_id, s in staleness.items():
            pre = f"fleet.peer.{_peer_metric_label(peer_id)}."
            gauges[pre + "stale"] = {"value": 1.0 if s["stale"] else 0.0,
                                     "calls": 1}
            gauges[pre + "staleness_seconds"] = {
                "value": (s["staleness_seconds"]
                          if s["staleness_seconds"] is not None
                          else -1.0),
                "calls": 1}
        return {
            "schema": SNAPSHOT_SCHEMA,
            "process": {
                "pid": os.getpid(), "role": "aggregator",
                "host": socket.gethostname(),
                "start_unix": self._start_unix,
                "snapshot_unix": time.time(),
                "labels": dict(self.labels),
            },
            "counters": {"fleet.scrape_passes": self._scrapes,
                         "fleet.scrape_errors": self._scrape_errors},
            "gauges": gauges,
            "histograms": {},
            "sketches": {},
            "slo_specs": [],
            "traces": {"sampling_enabled": False, "seen": 0,
                       "kept": {}, "traces": {}},
            "stages": {},
        }

    def _rebuild_view(self) -> None:
        with self._lock:
            snaps = {pid: st.snapshot
                     for pid, st in self._peers.items()
                     if st.snapshot is not None}
        snaps[self.SELF_PEER_ID] = self._self_snapshot()
        view = merge_snapshots(snaps)
        with self._lock:
            self._view = view

    def view(self) -> FleetView:
        """The latest merged view (building one on demand before the
        first poll completes)."""
        with self._lock:
            v = self._view
        if v is None:
            self._rebuild_view()
            with self._lock:
                v = self._view
        return v

    def _readiness(self):
        staleness = self.peer_staleness()
        fresh = sum(1 for s in staleness.values() if not s["stale"])
        return (fresh >= 1,
                f"{fresh}/{len(staleness)} peers fresh")

    # -- merged routes -----------------------------------------------------

    def _metrics(self, accept: str = ""):
        view = self.view()
        if "openmetrics" in accept:
            return (_expo.render_prometheus(registry=view.registry,
                                            include_exemplars=True)
                    + "# EOF\n",
                    "application/openmetrics-text; version=1.0.0; "
                    "charset=utf-8")
        return (_expo.render_prometheus(registry=view.registry),
                "text/plain; version=0.0.4; charset=utf-8")

    def _healthz(self, accept: str = ""):
        ready, reason = self._readiness()
        staleness = self.peer_staleness()
        return (json.dumps({
            "status": "ok",   # liveness: the aggregator itself is up
            "ready": ready,
            "ready_reason": reason,
            "role": "aggregator",
            "peers": len(staleness),
            "peers_stale": sum(1 for s in staleness.values()
                               if s["stale"]),
        }) + "\n", "application/json")

    def _statusz(self, accept: str = ""):
        view = self.view()
        body = {
            "role": "aggregator",
            "interval_s": self.interval_s,
            "stale_after_s": self.stale_after_s,
            "scrape_passes": self._scrapes,
            "scrape_errors": self._scrape_errors,
            "peers": self.peer_staleness(),
            "peer_processes": view.peers,
            "metrics": view.registry.snapshot(),
            "slo": view.slo or None,
            "slo_specs": view.slo_specs,
            "merge_notes": view.notes,
        }
        return (json.dumps(body, indent=2,
                           default=_expo._json_default) + "\n",
                "application/json")

    def _tracez(self, accept: str = ""):
        return (json.dumps(self.view().traces, indent=2,
                           default=_expo._json_default) + "\n",
                "application/json")

    def _distz(self, accept: str = ""):
        view = self.view()
        with self._lock:
            per_peer = {
                pid: st.snapshot.get("sketches")
                for pid, st in sorted(self._peers.items())
                if st.snapshot is not None
                and st.snapshot.get("sketches")}
        body = {"fleet": view.sketches, "peers": per_peer}
        return (json.dumps(body, indent=2,
                           default=_expo._json_default) + "\n",
                "application/json")

    def _snapshotz(self, accept: str = ""):
        snap = self.view().snapshot(role="aggregator",
                                    labels=self.labels,
                                    start_unix=self._start_unix)
        return (json.dumps(snap, default=_expo._json_default) + "\n",
                "application/json")

    # -- lifecycle ---------------------------------------------------------

    def _poll_loop(self) -> None:
        while not self._poll_stop.is_set():
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the poller must survive
                self._scrape_errors += 1
            self._poll_stop.wait(self.interval_s)

    def start(self) -> "FleetAggregator":
        self.server.start()
        self._poll_stop.clear()
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name="fleet-poll", daemon=True)
        self._poll_thread.start()
        return self

    def stop(self) -> None:
        self._poll_stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5)
            self._poll_thread = None
        self.server.stop()

    def __enter__(self) -> "FleetAggregator":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def port(self) -> Optional[int]:
        return self.server.port

    def summary(self) -> dict:
        staleness = self.peer_staleness()
        return {
            "port": self.port,
            "interval_s": self.interval_s,
            "stale_after_s": self.stale_after_s,
            "scrape_passes": self._scrapes,
            "scrape_errors": self._scrape_errors,
            "peers": {pid: {"stale": s["stale"],
                            "scrapes": s["scrapes"],
                            "errors": s["errors"]}
                      for pid, s in staleness.items()},
        }
