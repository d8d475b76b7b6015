"""The port's telemetry core (photon_ml_tpu_torch/telemetry/) against the
JAX package's (photon_ml_tpu/telemetry/), on the CPU: the cases of
tests/test_telemetry.py, each run through both, plus what the port adds
around them.

- The same observation sequence gives equal histogram snapshots,
  bucket counts, raw states, percentiles and exemplars (trace id and
  value; the stamp is the wall clock's).
- The same span tree, with both modules' clocks patched to the same
  times, gives the same stage names, self/total split, main-thread
  coverage and, exported, the same Chrome trace byte for byte; a flight
  recorder fed the same spans dumps the same structure.
- The disabled path returns the shared no-op and counts zero mutations.
- The SIGTERM dump runs in this process: the installed handler is
  called, not signalled.
- Telemetry moves no bit: a GAME fit and a streamed solve over a
  spilling shard cache give the same bytes with it on and off, and so
  does a served group.
- No module of the telemetry package, nor the distribution monitor,
  reads a device value: an AST scan finds no ``.item``, ``.cpu``,
  ``.tolist`` or ``synchronize`` call.
- A driver fault leaves ``flight.json``.
"""

import ast
import gc
import itertools
import json
import signal
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu import telemetry as jtel
from photon_ml_tpu.telemetry import recorder as jrecorder
from photon_ml_tpu.telemetry import spans as jspans
from photon_ml_tpu_torch import telemetry as tel
from photon_ml_tpu_torch.telemetry import recorder as trecorder
from photon_ml_tpu_torch.telemetry import spans as tspans
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
BOTH = (tel, jtel)


def _clean():
    for t in BOTH:
        t.disable()
        t.reset()
        t.tracer().record_events = False
        t.tracer().flight = None


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Telemetry is process-global in both packages: every test starts
    reset and disabled and leaves them so."""
    _clean()
    yield
    _clean()


def _on(**kw):
    for t in BOTH:
        t.enable(**kw)


class _Clock:
    """perf_counter stand-in: every call advances by the next step."""

    def __init__(self, steps):
        self._steps = itertools.cycle(steps)
        self.now = 100.0

    def perf_counter(self):
        self.now += next(self._steps)
        return self.now


@pytest.fixture
def same_clock(monkeypatch):
    """Both span modules read one scripted clock each, advancing by the
    same steps, so the same span tree takes the same times in both."""
    for mod in (tspans, jspans):
        fake = types.SimpleNamespace(
            perf_counter=_Clock([0.001, 0.003, 0.002, 0.005]).perf_counter)
        monkeypatch.setattr(mod, "time", fake)
    for t in BOTH:
        t.tracer().reset()


def _ours(snap, *names):
    """A test's own metrics of a registry snapshot: each package's
    registry also holds what its modules (and earlier tests) made."""
    return {group: {k: v for k, v in metrics.items() if k in names}
            for group, metrics in snap.items()}


def _exemplars(h):
    return {b: (tid, v) for b, (tid, v, _) in h.exemplars().items()}


def _hist_pair(name, buckets=None, exemplars=False):
    return (tel.Histogram(name, buckets, exemplars=exemplars),
            jtel.Histogram(name, buckets, exemplars=exemplars))


def _same_histograms(h, j):
    def snap(x):  # an exemplar's wall-clock stamp is its own
        return {k: v for k, v in x.snapshot().items() if k != "exemplars"}

    assert snap(h) == snap(j)
    assert set(h.snapshot()) == set(j.snapshot())
    assert h.bucket_counts() == j.bucket_counts()
    assert h.percentiles() == j.percentiles()
    assert _exemplars(h) == _exemplars(j)
    hs, js = h.state(), j.state()
    for k in ("bounds", "counts", "count", "sum", "min", "max"):
        assert hs[k] == js[k], k


# ---------------------------------------------------------------------------
# Histogram percentile math
# ---------------------------------------------------------------------------


def test_histogram_empty_returns_none():
    h, j = _hist_pair("t.empty")
    assert h.quantile(0.5) is None
    snap = h.snapshot()
    assert snap["count"] == 0
    assert snap["p50"] is None and snap["p99"] is None
    assert snap["mean"] is None
    _same_histograms(h, j)


def test_histogram_single_sample_exact_for_every_quantile():
    _on()
    h, j = _hist_pair("t.single", buckets=[1.0, 10.0, 100.0])
    for x in (h, j):
        x.observe(3.7)
    for q in (0.0, 0.25, 0.5, 0.95, 0.99, 1.0):
        assert h.quantile(q) == pytest.approx(3.7) == j.quantile(q)
    _same_histograms(h, j)


def test_histogram_all_equal_samples_exact():
    _on()
    h, j = _hist_pair("t.equal", buckets=[1.0, 2.0, 4.0])
    for x in (h, j):
        for _ in range(17):
            x.observe(2.0)
    assert h.quantile(0.5) == pytest.approx(2.0)
    assert h.quantile(0.99) == pytest.approx(2.0)
    _same_histograms(h, j)


def test_histogram_bucket_boundary_le_semantics():
    # A sample equal to a boundary lands in the bucket that boundary
    # closes (Prometheus `le`), not the one it opens.
    _on()
    h, j = _hist_pair("t.bound", buckets=[1.0, 2.0, 4.0])
    for x in (h, j):
        for v in (1.0, 2.0, 4.0, 5.0):  # 5.0: overflow
            x.observe(v)
    counts = h.bucket_counts()
    assert counts[1.0] == counts[2.0] == counts[4.0] == counts["+inf"] == 1
    _same_histograms(h, j)


def test_histogram_interpolation_within_bucket():
    _on()
    h, j = _hist_pair("t.interp", buckets=[10.0])
    for x in (h, j):
        for v in (2.0, 4.0, 6.0, 8.0):
            x.observe(v)
    # rank 2 of 4 in the bucket (min .. 10]: 2 + 0.5 * (10 - 2) = 6.
    assert h.quantile(0.5) == pytest.approx(6.0)
    assert h.quantile(0.0) == pytest.approx(2.0)  # clamps to min
    assert h.quantile(1.0) == pytest.approx(8.0)  # clamps to max
    _same_histograms(h, j)


def test_histogram_percentiles_bounded_by_bucket_width():
    _on()
    h, j = _hist_pair("t.width")  # default latency buckets, ~17%
    samples = np.random.default_rng(3).uniform(1e-4, 1e-1, size=500)
    for x in (h, j):
        for v in samples:
            x.observe(float(v))
    for q in (0.5, 0.95, 0.99):
        assert h.quantile(q) == pytest.approx(
            float(np.quantile(samples, q)), rel=0.25)
    assert h.count == 500
    assert h.sum == pytest.approx(float(samples.sum()))
    assert h.quantile(0.5) <= h.quantile(0.95) <= h.quantile(0.99)
    _same_histograms(h, j)


def test_histogram_batched_observe_matches_individual():
    """observe(v, n=k) and observe_many(values) give the state of the
    individual observes; exemplars stamp the last sample a bucket."""
    _on()
    values = [0.3, 1.0, 1.0, 2.5, 7.0, 7.0, 7.0, 40.0, 0.05]
    ids = [None, "a", None, "b", None, None, "c", None, "d"]
    pairs = {}
    for style in ("ref", "many", "n"):
        pairs[style] = _hist_pair(f"t.batch.{style}", [1.0, 10.0, 100.0],
                                  exemplars=True)
        for x in pairs[style]:
            if style == "ref":
                for v, tid in zip(values, ids):
                    x.observe(v, exemplar=tid)
            elif style == "many":
                x.observe_many(values, exemplars=ids)
            else:
                for v, n in ((0.3, 1), (1.0, 2), (2.5, 1), (7.0, 3),
                             (40.0, 1), (0.05, 1)):
                    x.observe(v, n=n)
    ref, many, n_style = (pairs[k][0] for k in ("ref", "many", "n"))
    assert many._counts == ref._counts == n_style._counts
    assert _exemplars(many) == _exemplars(ref)
    for k in ("count", "sum", "min", "max", "p50", "p95", "p99"):
        assert many.snapshot()[k] == ref.snapshot()[k] \
            == n_style.snapshot()[k], k
    for style in pairs:
        _same_histograms(*pairs[style])
    many.observe_many([])
    tel.disable()
    many.observe_many([1.0, 2.0])
    many.observe(1.0, n=5)
    assert many.count == ref.count


def test_histogram_quantile_validates_range():
    for x in _hist_pair("t.range"):
        with pytest.raises(ValueError):
            x.quantile(1.5)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def test_registry_get_or_create_and_snapshot_schema():
    _on()
    for t in BOTH:
        c = t.counter("t.counter")
        assert t.counter("t.counter") is c
        c.inc()
        c.inc(5)
        t.gauge("t.gauge").set(3.5)
        t.histogram("t.hist").observe(0.01)
    names = ("t.counter", "t.gauge", "t.hist")
    snap = _ours(tel.snapshot(), *names)
    assert snap == _ours(jtel.snapshot(), *names)
    assert snap["counters"]["t.counter"] == 6
    assert snap["gauges"]["t.gauge"] == 3.5
    assert set(snap["histograms"]["t.hist"]) == {
        "count", "sum", "mean", "min", "max", "p50", "p95", "p99"}
    for group in snap.values():
        for name in group:
            assert name == name.lower() and " " not in name


def test_registry_mutation_calls_counts_calls_not_values():
    _on()
    for t in BOTH:
        t.counter("t.calls").inc(1000)  # one call, value 1000
        t.histogram("t.calls_h").observe(1.0)
    assert tel.registry().mutation_calls() == 2 \
        == jtel.registry().mutation_calls()


def test_registry_reset_zeroes_but_keeps_handles():
    """reset() zeroes a metric in place: a module-level handle made at
    import stays the live one across driver runs in one process."""
    _on()
    from photon_ml_tpu_torch.data import shard_cache

    c = tel.counter("t.reset")
    c.inc()
    shard_cache._M_HITS.inc(3)
    tel.reset()
    assert c.value == 0 and shard_cache._M_HITS.value == 0
    assert tel.counter("t.reset") is c
    assert tel.counter("data.shard_cache.hits") is shard_cache._M_HITS
    shard_cache._M_HITS.inc()
    assert tel.snapshot()["counters"]["data.shard_cache.hits"] == 1


# ---------------------------------------------------------------------------
# Disabled fast path
# ---------------------------------------------------------------------------


def test_disabled_mutations_are_noops():
    for t in BOTH:
        c, h, g = t.counter("t.off"), t.histogram("t.offh"), t.gauge("t.offg")
        c.inc()
        h.observe(1.0)
        g.set(2.0)
        assert c.value == 0 and h.count == 0 and g.value == 0.0
    assert tel.registry().mutation_calls() == 0 \
        == jtel.registry().mutation_calls()


def test_disabled_span_is_shared_noop_singleton():
    assert tel.span("a") is tspans._NOOP
    assert tel.span("b") is tspans._NOOP
    assert tel.timed_span("c") is tspans._NOOP
    assert tel.mint("request") is tel.NOOP_CONTEXT
    assert jtel.span("a") is jspans._NOOP


def test_disabled_fast_path_zero_allocation_and_cheap():
    c = tel.counter("t.zero")
    h = tel.histogram("t.zeroh")

    def loop(n):
        for _ in range(n):
            with tel.span("x"):
                pass
            c.inc()
            h.observe(1.0)

    loop(2000)  # warm up allocators and method caches
    gc.disable()
    try:
        before = sys.getallocatedblocks()
        loop(2000)
        after = sys.getallocatedblocks()
    finally:
        gc.enable()
    assert after - before <= 8  # loop bookkeeping only, nothing per op
    n = 20_000
    t0 = time.perf_counter()
    loop(n)
    assert (time.perf_counter() - t0) / n * 1e6 < 25.0
    assert tel.registry().mutation_calls() == 0


# ---------------------------------------------------------------------------
# Spans: nesting, threads, attribution, export
# ---------------------------------------------------------------------------


def _span_tree(t):
    with t.span("outer"):
        with t.span("inner"):
            with t.timed_span("step", histogram=t.histogram("t.iter"),
                              counter=t.counter("t.iters")):
                pass
        with t.span("inner"):
            pass


def test_span_nesting_self_time(same_clock):
    _on()
    for t in BOTH:
        _span_tree(t)
    att = tel.stage_attribution()
    assert att == jtel.stage_attribution()
    assert att["outer"]["count"] == 1 and att["inner"]["count"] == 2
    assert att["outer"]["self_s"] == pytest.approx(
        att["outer"]["total_s"] - att["inner"]["total_s"])
    assert tel.tracer().main_thread_covered_seconds() == \
        jtel.tracer().main_thread_covered_seconds()
    names = ("t.iter", "t.iters")
    assert _ours(tel.snapshot(), *names) == _ours(jtel.snapshot(), *names)


def test_span_thread_isolation():
    _on()

    def worker(t):
        with t.span("worker_stage"):
            time.sleep(0.02)

    for t in BOTH:
        with t.span("main_stage"):
            th = threading.Thread(target=worker, args=(t,))
            th.start()
            th.join()
    for t in BOTH:
        att = t.stage_attribution()
        # The worker ran inside main_stage's window but is not its child.
        assert att["main_stage"]["self_s"] == pytest.approx(
            att["main_stage"]["total_s"], abs=5e-3)
        assert att["worker_stage"]["total_s"] >= 0.02
        assert t.tracer().main_thread_covered_seconds() == pytest.approx(
            att["main_stage"]["self_s"], abs=5e-3)
    assert set(tel.stage_attribution()) == set(jtel.stage_attribution())


def test_chrome_trace_export_is_perfetto_loadable_json(tmp_path,
                                                       same_clock):
    """The same spans on the same threads at the same times: the two
    exports are the same JSON."""
    _on(trace=True)

    def worker():
        for t in BOTH:
            with t.span("decode"):
                pass

    # One worker thread for both: the tracks come from thread idents.
    with tel.span("score"), jtel.span("score"):
        th = threading.Thread(target=worker)
        th.start()
        th.join()
    docs = []
    for t, name in ((tel, "port.json"), (jtel, "jax.json")):
        t.export_chrome_trace(tmp_path / name)
        docs.append(json.loads((tmp_path / name).read_text()))
    assert docs[0] == docs[1]
    events = docs[0]["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"score", "decode"}
    for e in xs:
        assert set(e) >= {"name", "ph", "pid", "tid", "ts", "dur"}
        assert e["dur"] > 0
    assert len({e["tid"] for e in xs}) == 2
    assert any(e["args"]["name"] == "driver" for e in events
               if e["ph"] == "M")


def test_trace_events_not_recorded_without_trace_flag():
    _on(trace=False)
    for t in BOTH:
        with t.span("quiet"):
            pass
        assert t.tracer().events == []
        assert "quiet" in t.stage_attribution()


def test_timed_span_observes_histogram_and_counter(same_clock):
    _on()
    for t in BOTH:
        h, c = t.histogram("t.iter"), t.counter("t.iters")
        with t.timed_span("step", histogram=h, counter=c):
            pass
        assert h.count == 1 and c.value == 1
        assert "step" in t.stage_attribution()
    names = ("t.iter", "t.iters")
    assert _ours(tel.snapshot(), *names) == _ours(jtel.snapshot(), *names)


def test_attribution_summary_fraction(same_clock):
    _on()
    for t in BOTH:
        with t.span("phase_a"):
            pass
        with t.span("phase_b"):
            pass
    # The wall time of the two phases back to back on the fake clock.
    wall = sum(v["total_s"] for v in tel.stage_attribution().values())
    mine, theirs = (t.attribution_summary(wall) for t in BOTH)
    assert set(mine) == set(theirs)
    assert set(mine.pop("metrics")) == set(theirs.pop("metrics"))
    assert mine == theirs
    assert mine["attributed_wall_frac"] > 0.9
    assert mine["attributed_wall_seconds"] <= mine["wall_seconds"] * 1.01


def test_flight_dump_has_jax_structure(tmp_path, same_clock):
    """A flight recorder fed the same spans dumps what JAX's dumps: the
    same Chrome events, the same flight block but for the trace tail's
    sampling flag."""
    _on()
    dumps = []
    for t, rec_mod in ((tel, trecorder), (jtel, jrecorder)):
        rec = rec_mod.FlightRecorder(max_events=3,
                                     snapshot_interval_s=1e9).install()
        try:
            for i in range(5):
                with t.span(f"s{i}"):
                    pass
            dumps.append(rec.dump(tmp_path / f"{t.__name__}.json",
                                  reason="manual", trace_id="t-1"))
            assert rec.stats()["events_evicted"] == 2
        finally:
            rec.uninstall()
    mine, theirs = dumps
    assert mine["traceEvents"] == theirs["traceEvents"]
    assert set(mine["flight"]) == set(theirs["flight"])
    for k in ("reason", "events_in_ring", "events_seen", "events_evicted",
              "ring_capacity", "trace_id", "stage_attribution"):
        assert mine["flight"][k] == theirs["flight"][k], k
    assert set(mine["flight"]["final_metrics"]) == set(
        theirs["flight"]["final_metrics"])
    assert [e["name"] for e in mine["traceEvents"] if e["ph"] == "X"] == [
        "s2", "s3", "s4"]
    on_disk = json.loads((tmp_path / f"{tel.__name__}.json").read_text())
    assert on_disk["flight"]["reason"] == "manual"


def test_sigterm_dump_in_process(tmp_path):
    """install_sigterm_dump on the main thread: its handler (called here,
    not signalled) dumps and exits 143 through SystemExit; restore puts
    the previous handler back; off the main thread it installs
    nothing."""
    _on()
    rec = trecorder.FlightRecorder(max_events=8).install()
    path = tmp_path / "flight.json"
    before = signal.getsignal(signal.SIGTERM)
    try:
        with tel.span("working"):
            pass
        if threading.current_thread() is threading.main_thread():
            restore = tel.install_sigterm_dump(rec, path)
            handler = signal.getsignal(signal.SIGTERM)
            assert handler is not before
            with pytest.raises(SystemExit) as exc:
                handler(signal.SIGTERM, None)
            assert exc.value.code == 143
            restore()
            assert signal.getsignal(signal.SIGTERM) is before
            dump = json.loads(path.read_text())
            assert dump["flight"]["reason"] == "SIGTERM"
            assert [e["name"] for e in dump["traceEvents"]
                    if e["ph"] == "X"] == ["working"]
        out = []
        th = threading.Thread(target=lambda: out.append(
            tel.install_sigterm_dump(rec, path)))
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
        assert signal.getsignal(signal.SIGTERM) is before
        out[0]()  # the no-op restorer
    finally:
        rec.uninstall()
        signal.signal(signal.SIGTERM, before)


# ---------------------------------------------------------------------------
# Adoption: spans flow out of the port's pipeline pieces
# ---------------------------------------------------------------------------


def test_prefetcher_and_window_report_wait_stages():
    import jax.numpy as jnp

    from photon_ml_tpu.data import device_feed as jfeed
    from photon_ml_tpu_torch.data import device_feed as tfeed

    _on()
    for feed, arr in ((tfeed, torch.tensor), (jfeed, jnp.asarray)):
        items = list(range(5))
        assert list(feed.HostPrefetcher(iter(items), depth=2)) == items
        win = feed.InFlightWindow(depth=1)
        done = []
        for i in range(3):
            d = win.push(arr([i]))
            if d is not None:
                done.append(d)
        done.extend(win.drain())
        assert len(done) == 3
    for t in BOTH:
        att = t.stage_attribution()
        assert att["prefetch_wait"]["count"] >= 5
        assert att["device_wait"]["count"] >= 3
    mine, theirs = tel.stage_attribution(), jtel.stage_attribution()
    assert {k: v["count"] for k, v in mine.items()} == {
        k: v["count"] for k, v in theirs.items()}


def test_block_stream_decode_seconds_accumulates(tmp_path):
    from photon_ml_tpu_torch.data.block_stream import BlockGameStream
    from photon_ml_tpu_torch.data.index_map import IndexMap, feature_key
    from photon_ml_tpu_torch.io import schemas
    from photon_ml_tpu_torch.io.avro_codec import write_container

    _on()
    recs = [{"uid": str(i), "label": float(i % 2), "offset": 0.0,
             "weight": 1.0,
             "features": [{"name": "f0", "term": "", "value": 1.0}],
             "metadataMap": None}
            for i in range(10)]
    path = tmp_path / "in.avro"
    write_container(path, schemas.TRAINING_EXAMPLE, recs)
    maps = {"global": IndexMap({feature_key("f0"): 0})}
    stream = BlockGameStream(str(path), id_types=[],
                             feature_shard_maps=maps, batch_rows=4,
                             feeder="python", prefetch_depth=0)
    assert sum(ds.num_rows for ds in stream) == 10
    st = stream.stats()
    assert st["decode_seconds"] > 0.0
    assert st["batches"] == 3
    # One decode span a batch, and the end-of-stream probe.
    assert tel.stage_attribution()["decode"]["count"] == 4


# ---------------------------------------------------------------------------
# The port's own guarantees
# ---------------------------------------------------------------------------


def test_telemetry_core_reads_no_device_value():
    """A span sits at a sync the code already has: nothing in the
    telemetry package (the observability plane's sketches, SLOs,
    exposition and federation included), the profiler wrapper or the
    distribution monitor may read a device value."""
    files = sorted((REPO / "photon_ml_tpu_torch" / "telemetry").glob("*.py"))
    files.append(REPO / "photon_ml_tpu_torch" / "utils" / "profiling.py")
    files.append(REPO / "photon_ml_tpu_torch" / "data" / "distmon.py")
    assert {p.name for p in files} >= {
        "sketches.py", "slo.py", "exposition.py", "federation.py",
        "distmon.py"}
    assert len(files) == 12
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and node.func.attr in (
                        "item", "synchronize", "cpu", "tolist"):
                bad.append(f"{path.name}:{node.lineno} .{node.func.attr}")
    assert not bad, bad


def _game_data(rng, n=160, d=5, users=12):
    from photon_ml_tpu_torch.data.game_data import GameDataset

    x = rng.normal(0, 1, (n, d))
    x[:, 0] = 1.0
    w = rng.normal(0, 1, d)
    y = (rng.random(n) < 1 / (1 + np.exp(-x @ w))).astype(float)
    return GameDataset.build(
        responses=y, feature_shards={"g": sp.csr_matrix(x)},
        ids={"u": rng.integers(0, users, n).astype(str)})


def _fit_bytes(data):
    """A GAME fit (fixed and per-user effect, 2 iterations) and a
    streamed L-BFGS solve over a shard cache that spills: every
    coefficient's bytes."""
    from photon_ml_tpu_torch.algorithm.coordinates import (
        StreamingFixedEffectCoordinate,
    )
    from photon_ml_tpu_torch.data.random_effect import (
        RandomEffectDataConfiguration,
    )
    from photon_ml_tpu_torch.data.shard_cache import DeviceShardCache
    from photon_ml_tpu_torch.estimators.game_estimator import (
        FixedEffectSpec,
        GameEstimator,
        RandomEffectSpec,
    )
    from photon_ml_tpu_torch.optimization.config import (
        GLMOptimizationConfiguration,
    )
    from photon_ml_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    cfg = GLMOptimizationConfiguration.parse("20,1e-7,1.0,1.0,LBFGS,L2")
    est = GameEstimator(task, [
        FixedEffectSpec("fixed", "g", [cfg]),
        RandomEffectSpec("perUser", RandomEffectDataConfiguration("u", "g"),
                         [cfg], intercept_col=0)],
        num_iterations=2, dtype=torch.float64, device="cpu")
    (_, result), = est.fit(data)
    out = [result.model.models["fixed"].glm.coefficients.means.numpy()
           .tobytes()]
    out += [c.numpy().tobytes()
            for c in result.model.models["perUser"].local_coefs]
    out.append(np.asarray(result.objective_history).tobytes())

    class Batches(list):
        def stats(self):
            return {"decode_path": "memory", "batches": len(self)}

    batches = Batches(data.subset(np.arange(a, min(a + 40, data.num_rows)))
                      for a in range(0, data.num_rows, 40))
    cache = DeviceShardCache.from_stream(
        batches, "g", dtype=torch.float64, hbm_budget_bytes=2000,
        device="cpu")
    coord = StreamingFixedEffectCoordinate(
        name="fixed", cache=cache, feature_shard_id="g", task_type=task,
        config=cfg, dtype=torch.float64)
    model, res = coord.solve(trace_ctx=tel.mint("solve"))
    assert cache.stats()["evictions"] > 0
    out.append(model.glm.coefficients.means.numpy().tobytes())
    out.append(res.value_history.numpy().tobytes())
    return out


def test_game_fit_bytes_do_not_depend_on_telemetry():
    data = _game_data(np.random.default_rng(11))
    off = _fit_bytes(data)
    tel.enable(trace=True)
    rec = trecorder.FlightRecorder(max_events=64).install()
    try:
        on = _fit_bytes(data)
    finally:
        rec.uninstall()
    assert on == off
    att = tel.stage_attribution()
    assert {"h2d", "accumulate", "solver_step", "shard_reupload"} <= set(att)
    counters = tel.snapshot()["counters"]
    assert counters["training.solver_iterations"] > 0
    assert counters["data.shard_cache.misses"] > 0


def test_served_group_bytes_do_not_depend_on_telemetry():
    """One coalesced group through the front-end, telemetry off and on
    (both scored on the front-end's dispatch thread): the same bytes."""
    from tests import test_torch_serving_frontend as fe_t

    ref = fe_t.Ref()
    reqs = fe_t.singles(900, 12, n=2)
    outs = []
    for on in (False, True):
        if on:
            tel.enable(trace=True)
        fe = fe_t.frontend({"default": ref.model().t}, window=0.05)
        results, info = fe_t.replay(fe, [r.t for r in reqs],
                                    concurrency=12)
        assert info["shed"] == info["errors"] == 0
        outs.append([r.tobytes() for r in results])
        if on:
            st = fe.stats()
            assert st["request_latency_seconds"]["count"] == len(reqs)
            assert sum(r["dispatches"] for r in
                       st["cache"]["profiler"]["dispatch"].values()) \
                == st["engines"]["default"]["dispatches"]
    assert outs[0] == outs[1]


def test_driver_fault_leaves_flight_json(tmp_path):
    """An unhandled driver fault dumps the flight ring to
    <output-dir>/flight.json (tagged with the fault's type) before it
    re-raises; an intentional SystemExit dumps nothing."""
    from photon_ml_tpu_torch.cli import game_scoring_driver

    out = tmp_path / "out"
    with pytest.raises(FileNotFoundError):
        game_scoring_driver.run(
            ["--input-dirs", str(tmp_path / "none"),
             "--game-model-input-dir", str(tmp_path / "no-model"),
             "--output-dir", str(out)], device="cpu")
    dump = json.loads((out / "flight.json").read_text())
    assert dump["flight"]["reason"] == "fault:FileNotFoundError"
    names = [e["name"] for e in dump["traceEvents"] if e["ph"] == "X"]
    assert names[-2:] == ["load_model", "driver"]
    out2 = tmp_path / "out2"
    with pytest.raises(SystemExit):
        game_scoring_driver.run(
            ["--input-dirs", str(tmp_path / "none"),
             "--game-model-input-dir", str(tmp_path / "no-model"),
             "--output-dir", str(out2), "--stream", "--serve"],
            device="cpu")
    assert not (out2 / "flight.json").exists()
    assert not tel.enabled()
