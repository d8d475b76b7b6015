"""Streaming distribution monitoring: per-batch data and model
statistics piggybacked on the decode passes the pipeline already pays
for (port of photon_ml_tpu/data/distmon.py:1-491; numpy only, as in JAX,
on the deterministic sketches of telemetry/sketches.py).

- :class:`StreamingDistributionMonitor`: the ``--stream-train
  --distmon`` accumulator: label/offset/weight moments and quantiles,
  per-feature-shard value sketches over the CSR nonzeros the decoder
  produced (no extra feature pass), bounded top-K heavy hitters per
  entity-id column, and per-λ solver convergence rings. Batches are
  observed as the stream yields them (:class:`MonitoredStream`), before
  the shard cache picks a storage type, so the state is fixed by the
  shard order and the same, byte for byte (``serialize()`` /
  ``state_sha256``), whatever the residency, feeder or prefetch depth.
  Lock-guarded, so a live /distz scrape reads mid-ingest.
- :class:`MonitoredStream`: a transparent iterator wrapper that observes
  each yielded batch and delegates every other attribute to the wrapped
  stream. With prefetch the observation runs on the producer thread.
- :class:`ScoreDistributionMonitor`: the serving-side score sketch, one
  per resident model, fed at the engine's settle with the host scores
  the settle already copied (one buffered append per settled group),
  with PSI/KS drift against the model's embedded reference computed on
  scrape and published as ``serving.model.<label>.score_drift_psi`` /
  ``_ks`` gauges, which an ``--slo`` value objective can alert on.
  Engines carry ``score_monitor = None`` by default and skip the call.

No method reads a device value: every input is a host numpy array, and
no lock is held across a device copy. None of it runs unless a driver
built a monitor (``--distmon``).
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.telemetry.sketches import (
    MomentsSketch,
    QuantileSketch,
    TopKSketch,
    _canonical_json,
    ks,
    psi,
)

#: Reference-snapshot schema version stamped into model artifacts
#: (model-metadata.json ``referenceDistributions``).
REFERENCE_VERSION = 1


class _ColumnSketch:
    """Moments + quantiles over one scalar column."""

    def __init__(self, relative_accuracy: float):
        self.moments = MomentsSketch()
        self.quantiles = QuantileSketch(relative_accuracy)

    def update(self, values) -> None:
        self.moments.update(values)
        self.quantiles.update(values)

    def summary(self) -> dict:
        return {"moments": self.moments.summary(),
                "quantiles": self.quantiles.summary()}

    def state(self) -> dict:
        return {"moments": self.moments.state(),
                "quantiles": self.quantiles.state()}


class StreamingDistributionMonitor:
    """Training-side distribution accumulator (module docstring).

    ``feature_shards`` may be empty: shard names are adopted (sorted)
    from the first observed batch. ``top_k`` bounds the per-id-type
    heavy-hitter summaries. One instance per driver run; all methods are
    thread-safe (decode thread writes, scrape threads read)."""

    def __init__(self, feature_shards: Sequence[str] = (),
                 id_types: Sequence[str] = (),
                 relative_accuracy: float = 0.01, top_k: int = 16):
        self.relative_accuracy = float(relative_accuracy)
        self.top_k = int(top_k)
        self.rows = 0
        self.batches = 0
        self._lock = threading.Lock()
        self._columns = {name: _ColumnSketch(self.relative_accuracy)
                         for name in ("label", "offset", "weight")}
        self._shards: Dict[str, _ColumnSketch] = {
            s: _ColumnSketch(self.relative_accuracy)
            for s in sorted(feature_shards)}
        self._entities: Dict[str, TopKSketch] = {
            t: TopKSketch(self.top_k) for t in sorted(id_types)}
        self._scores: Dict[str, _ColumnSketch] = {}
        self._rings: Dict[str, object] = {}
        # Headline gauges, mirrored to /metrics on publish_gauges()
        # (scrape-hook refreshed; data.dist.* is a gauge-only family).
        self._g_rows = telemetry.gauge("data.dist.rows")
        self._g_batches = telemetry.gauge("data.dist.batches")
        self._g_label_mean = telemetry.gauge("data.dist.label_mean")
        self._g_label_p50 = telemetry.gauge("data.dist.label_p50")
        self._g_label_p99 = telemetry.gauge("data.dist.label_p99")
        self._g_weight_mean = telemetry.gauge("data.dist.weight_mean")
        self._g_offset_mean = telemetry.gauge("data.dist.offset_mean")

    # -- ingest-side observation -------------------------------------------

    def observe_batch(self, ds) -> None:
        """Fold one decoded GameDataset batch in (called per batch by
        :class:`MonitoredStream` — on the prefetch thread when the
        feeder prefetches). Vectorized numpy over columns the decode
        already materialized; never touches the feature matrices beyond
        their existing ``.data`` nonzeros."""
        n = int(ds.num_rows)
        if n == 0:
            return
        with self._lock:
            self.rows += n
            self.batches += 1
            self._columns["label"].update(ds.responses)
            self._columns["offset"].update(ds.offsets)
            self._columns["weight"].update(ds.weights)
            if not self._shards:
                self._shards = {
                    s: _ColumnSketch(self.relative_accuracy)
                    for s in sorted(ds.feature_shards)}
            for name, sk in self._shards.items():
                mat = ds.feature_shards.get(name)
                if mat is not None and mat.nnz:
                    sk.update(mat.data)
            for etype, col in sorted(ds.id_columns.items()):
                tk = self._entities.get(etype)
                if tk is None:
                    tk = self._entities[etype] = TopKSketch(self.top_k)
                codes, counts = np.unique(col.codes, return_counts=True)
                tk.update(col.vocabulary[codes], counts)

    def observe_scores(self, label: str, values) -> None:
        """Fold a training-score vector (model margins, offsets
        excluded) for one λ-grid point — fed from the solver's final
        margins (optimization/glm_lbfgs.py ``margins_out``), so it
        costs no feature pass."""
        v = np.asarray(values, np.float64).ravel()
        v = v[np.isfinite(v)]
        with self._lock:
            sk = self._scores.get(label)
            if sk is None:
                sk = self._scores[label] = _ColumnSketch(
                    self.relative_accuracy)
            sk.update(v)

    def add_ring(self, label: str, ring) -> None:
        """Attach a per-λ :class:`ConvergenceRing`
        (optimization/convergence.py) so /distz and the metrics.json
        ``data_quality`` block carry the solve's loss/grad-norm/step
        tail."""
        with self._lock:
            self._rings[label] = ring

    def ring_from_history(self, label: str, values, grad_norms) -> None:
        """Append one solve's ``value_history``/``grad_norm_history``
        to the label's ring, get-or-create (the in-core solvers
        keep padded histories and no live ring).
        APPENDING — not replacing — keeps the post-hoc path structurally
        identical to the live streamed-solver rings under
        ``--num-iterations > 1``: every warm-started re-solve's entries
        land in one ring, iteration indexes restarting at each solve
        boundary (warm restarts really do restart the count)."""
        from photon_ml_tpu_torch.optimization.convergence import ConvergenceRing

        with self._lock:
            ring = self._rings.get(label)
            if ring is None:
                ring = self._rings[label] = ConvergenceRing()
        vs = np.asarray(values, np.float64)
        gs = np.asarray(grad_norms, np.float64)
        for i, (v, g) in enumerate(zip(vs, gs)):
            if np.isnan(v) and np.isnan(g):
                break  # histories are NaN-padded past `iterations`
            ring.append(i, v, g, None)

    # -- views -------------------------------------------------------------

    def snapshot(self) -> dict:
        """Full human-readable view (the /distz training payload)."""
        with self._lock:
            return {
                "rows": self.rows,
                "batches": self.batches,
                "relative_accuracy": self.relative_accuracy,
                "columns": {k: v.summary()
                            for k, v in sorted(self._columns.items())},
                "feature_shards": {k: v.summary()
                                   for k, v in sorted(self._shards.items())},
                "entities": {k: v.summary()
                             for k, v in sorted(self._entities.items())},
                "training_scores": {k: v.summary()
                                    for k, v in sorted(self._scores.items())},
                "convergence": {k: r.snapshot()
                                for k, r in sorted(self._rings.items())},
            }

    def serialize(self) -> bytes:
        """Canonical bytes of the STREAM-observed state only (columns,
        feature shards, entities, row/batch counts). Deliberately
        excludes training-score sketches and convergence rings: those
        derive from the SOLVE (resident vs spill paths legitimately
        differ in float detail), while the stream-observed state is the
        residency/feeder/prefetch-independence contract the CLI tests
        pin bitwise."""
        with self._lock:
            return _canonical_json({
                "rows": self.rows,
                "batches": self.batches,
                "relative_accuracy": self.relative_accuracy,
                "columns": {k: v.state()
                            for k, v in sorted(self._columns.items())},
                "feature_shards": {k: v.state()
                                   for k, v in sorted(self._shards.items())},
                "entities": {k: v.state()
                             for k, v in sorted(self._entities.items())},
            })

    def state_sha256(self) -> str:
        return hashlib.sha256(self.serialize()).hexdigest()

    def sketch_states(self) -> dict:
        """Flat ``{key: sketch_state}`` map for /snapshotz federation
        (telemetry/federation.py): dotted keys like
        ``columns.label.quantiles`` / ``entities.<type>``, each value a
        ``sketch_from_state``-reconstructible state dict, so the fleet
        aggregator merges equal keys across training children with the
        sketches' own deterministic merges."""
        with self._lock:
            out = {}
            for name, col in sorted(self._columns.items()):
                out[f"columns.{name}.moments"] = col.moments.state()
                out[f"columns.{name}.quantiles"] = col.quantiles.state()
            for name, col in sorted(self._shards.items()):
                out[f"feature_shards.{name}.moments"] = \
                    col.moments.state()
                out[f"feature_shards.{name}.quantiles"] = \
                    col.quantiles.state()
            for name, sk in sorted(self._entities.items()):
                out[f"entities.{name}"] = sk.state()
            return out

    def data_quality_block(self) -> dict:
        """The metrics.json ``data_quality`` block: sketch summaries +
        per-λ convergence tails + the canonical state hash (the
        residency-independence witness)."""
        out = self.snapshot()
        out["state_sha256"] = self.state_sha256()
        return out

    def reference(self, score_label: Optional[str] = None) -> dict:
        """The reference-distribution snapshot stamped into the model
        artifact (label quantiles + the chosen λ's training-score
        quantiles when available) — what serving drift-scores against."""
        with self._lock:
            ref = {
                "version": REFERENCE_VERSION,
                "relative_accuracy": self.relative_accuracy,
                "rows": self.rows,
                "label": self._columns["label"].quantiles.state(),
                "label_summary":
                    self._columns["label"].quantiles.summary(),
            }
            sk = self._scores.get(score_label) if score_label else None
            if sk is not None:
                ref["score"] = sk.quantiles.state()
                ref["score_summary"] = sk.quantiles.summary()
                ref["score_label"] = score_label
            return ref

    def publish_gauges(self) -> None:
        """Refresh the headline ``data.dist.*`` gauges (scrape hook /
        driver-finish)."""
        with self._lock:
            label = self._columns["label"]
            weight = self._columns["weight"]
            offset = self._columns["offset"]
            self._g_rows.set(self.rows)
            self._g_batches.set(self.batches)
            if label.moments.count:
                self._g_label_mean.set(label.moments.mean)
                self._g_label_p50.set(label.quantiles.quantile(0.5))
                self._g_label_p99.set(label.quantiles.quantile(0.99))
            if weight.moments.count:
                self._g_weight_mean.set(weight.moments.mean)
            if offset.moments.count:
                self._g_offset_mean.set(offset.moments.mean)


class MonitoredStream:
    """Iterator wrapper observing each yielded batch into a
    :class:`StreamingDistributionMonitor`; every other attribute
    delegates to the wrapped stream, so cache/assembler consumers
    (``DeviceShardCache.from_stream``, ``assemble_fixed_effect_batch``)
    see the stream contract unchanged — zero extra decode or feature
    passes, observation rides the pass that was already happening.

    ``max_passes`` bounds how many full iterations are OBSERVED (later
    passes yield untouched): the streamed-MF path re-decodes the same
    container once per feature pass, and every pass replays identical
    bytes — so one observed pass is the distribution, counted once.
    None (default) observes every pass (the fixed-effect ingest
    iterates exactly once anyway)."""

    def __init__(self, stream, monitor: StreamingDistributionMonitor,
                 max_passes: Optional[int] = None):
        self._stream = stream
        self._monitor = monitor
        self._max_passes = max_passes
        self._passes = 0

    def __iter__(self):
        observe = (self._max_passes is None
                   or self._passes < self._max_passes)
        self._passes += 1
        if not observe:
            yield from self._stream
            return
        for ds in self._stream:
            self._monitor.observe_batch(ds)
            yield ds

    def __getattr__(self, name):
        return getattr(self._stream, name)


class ScoreDistributionMonitor:
    """Per-model serving score distribution + drift vs the model's
    embedded reference (module docstring).

    ``reference`` is the ``referenceDistributions`` block of
    model-metadata.json (or None — the sketch still accumulates, drift
    reads None). The current-score sketch uses the REFERENCE's
    relative accuracy when one is embedded, so the two CDFs share a
    bucket grid."""

    def __init__(self, label: str, reference: Optional[dict] = None,
                 relative_accuracy: float = 0.01):
        self.label = label
        self.reference = reference
        acc = relative_accuracy
        self._ref_sketch = None
        if reference is not None and reference.get("score") is not None:
            self._ref_sketch = QuantileSketch.from_state(
                reference["score"])
            acc = self._ref_sketch.relative_accuracy
        self._lock = threading.Lock()
        self._sketch = _ColumnSketch(acc)
        self.non_finite = 0
        # Deferred-settle buffer: the engine settle
        # only APPENDS the group's score vector under the lock; sketch
        # folding happens in one vectorized update per ~flush_rows rows
        # (and before any read), so per-group hot-path cost is a copy +
        # a list append regardless of group size, and the fold
        # amortizes to the large-batch sketch rate. Serving moments are
        # therefore flush-granular rather than group-granular — live
        # traffic has no bit-stability contract (training does, and
        # the training monitor never buffers). 64k f64 buffered rows =
        # 512 KB bounded host memory per model.
        self.flush_rows = 65536
        self._buffer: List[np.ndarray] = []
        self._buffered = 0
        pre = f"serving.model.{label}."
        self._g_psi = telemetry.gauge(pre + "score_drift_psi")
        self._g_ks = telemetry.gauge(pre + "score_drift_ks")
        self._g_rows = telemetry.gauge(pre + "score_dist_rows")

    def observe(self, scores) -> None:
        """Buffer one settled group's score vector (one lock + one
        small copy per GROUP — called from the engine settle). Folding
        into the sketches is deferred to the flush threshold / the next
        read. Non-finite scores are counted at flush, not raised: a
        corrupt score must not poison the serving path that produced
        it."""
        v = np.asarray(scores, np.float64).ravel()
        if v.size == 0:
            return
        with self._lock:
            self._buffer.append(v.copy())
            self._buffered += v.size
            if self._buffered >= self.flush_rows:
                self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._buffer:
            return
        v = (self._buffer[0] if len(self._buffer) == 1
             else np.concatenate(self._buffer))
        self._buffer = []
        self._buffered = 0
        finite = np.isfinite(v)
        bad = int(v.size - finite.sum())
        if bad:
            self.non_finite += bad
            v = v[finite]
        if v.size:
            self._sketch.update(v)

    def _drift_locked(self) -> Optional[dict]:
        # Caller holds self._lock and has flushed. One lock scope per
        # published view, so drift/scores/rows in a payload always
        # describe the SAME flushed state (a concurrent settle cannot
        # land between them).
        if self._ref_sketch is None:
            return None
        cur = self._sketch.quantiles
        if cur.count == 0:
            return None
        return {
            "psi": psi(self._ref_sketch, cur),
            "ks": ks(self._ref_sketch, cur),
            "rows": cur.count,
            "reference_rows": self._ref_sketch.count,
            "reference_label": (self.reference or {}).get(
                "score_label"),
        }

    def drift(self) -> Optional[dict]:
        """PSI + KS of the live score sketch against the embedded
        reference; None without a reference or before any scores."""
        with self._lock:
            self._flush_locked()
            return self._drift_locked()

    def publish_gauges(self) -> None:
        """Refresh the drift gauges (registered as a scrape hook, so
        drift is computed against the CURRENT sketch on every /metrics,
        /statusz, /distz scrape and heartbeat tick — which is what lets
        an ``--slo`` value objective burn on drift)."""
        with self._lock:
            self._flush_locked()
            d = self._drift_locked()
            rows = self._sketch.quantiles.count
        self._g_rows.set(rows)
        if d is not None:
            self._g_psi.set(d["psi"])
            self._g_ks.set(d["ks"])

    def sketch_states(self) -> dict:
        """Flat ``{key: sketch_state}`` map for /snapshotz federation:
        the live score sketch of this model, keyed under its label so
        the aggregator merges same-model replicas and keeps different
        models apart."""
        with self._lock:
            self._flush_locked()
            return {
                f"{self.label}.scores.moments":
                    self._sketch.moments.state(),
                f"{self.label}.scores.quantiles":
                    self._sketch.quantiles.state(),
            }

    def snapshot(self) -> dict:
        """The /distz serving payload for this model (scores, counters
        and drift all read under ONE lock scope — mutually
        consistent)."""
        with self._lock:
            self._flush_locked()
            return {
                "label": self.label,
                "scores": self._sketch.summary(),
                "non_finite_scores": self.non_finite,
                "reference": ((self.reference or {}).get("score_summary")
                              if self.reference else None),
                "drift": self._drift_locked(),
            }


__all__: List[str] = [
    "MonitoredStream",
    "REFERENCE_VERSION",
    "ScoreDistributionMonitor",
    "StreamingDistributionMonitor",
]
