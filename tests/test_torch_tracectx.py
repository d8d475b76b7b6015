"""Request-scoped tracing in the port (photon_ml_tpu_torch/telemetry/
tracectx.py), its exemplars, the executable profiler and the divergence
watchdog, against the JAX package's, on the CPU: the cases of
tests/test_tracectx.py.

- Trace contexts and the tail sampler run through both packages with
  both id counters restarted: the same durations and outcomes keep the
  same trace ids in the same rings.
- The front-end cases run the port's ServingFrontend (float64, the
  models and requests of tests/test_torch_serving_frontend.py); where
  JAX's front-end is run beside it, the timelines' stage sequences are
  the same.
- The concurrent case reads the tail and the exemplars directly while
  threads observe and finish traces (the HTTP routes that serve them,
  ``/tracez`` and ``/metrics``, are held against JAX's in
  tests/test_torch_slo_exposition.py).
- The watchdog case is JAX's recipe: a NaN feature under
  ``--stream-train`` diverges the streamed solve in both drivers, and
  the port's flight dump is tagged with the solve's trace id.
"""

import asyncio
import itertools
import json
import threading
import time

import numpy as np
import pytest
import scipy.sparse as sp

from photon_ml_tpu import telemetry as jtel
from photon_ml_tpu.optimization.convergence import (
    SolverDivergedError as JaxDiverged,
)
from photon_ml_tpu.optimization.convergence import (
    check_solver_finite as jax_check,
)
from photon_ml_tpu.serving import BucketLadder as JaxLadder
from photon_ml_tpu.serving import FrontendConfig as JaxConfig
from photon_ml_tpu.serving import ServingFrontend as JaxFrontend
from photon_ml_tpu.telemetry import tracectx as jtracectx
from photon_ml_tpu_torch import telemetry as tel
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.optimization.convergence import (
    SolverDivergedError,
    check_solver_finite,
)
from photon_ml_tpu_torch.serving import FrontendConfig, RequestRejected
from photon_ml_tpu_torch.telemetry import tracectx as ttracectx
from tests import test_torch_serving as ts
from tests import test_torch_serving_frontend as fe_t
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

BOTH = ((tel, ttracectx), (jtel, jtracectx))


@pytest.fixture
def sampling(monkeypatch):
    """Telemetry and trace sampling on in both packages, both trace-id
    counters restarted, everything clean before and after."""
    for mod in (ttracectx, jtracectx):
        monkeypatch.setattr(mod, "_SEQ", itertools.count(1))
    for t, _ in BOTH:
        t.reset()
        t.enable()
    try:
        yield
    finally:
        for t, _ in BOTH:
            t.disable()
            t.reset()


@pytest.fixture(scope="module")
def ref():
    return fe_t.Ref()


@pytest.fixture
def traced_frontend(ref, sampling):
    fe = fe_t.frontend({"default": ref.model().t}, window=0.05)
    return fe, ref


def _jax_frontend(ref):
    return JaxFrontend({"default": ref.model().j}, dtype=ts.JDT,
                       ladder=JaxLadder(**ts.LADDER),
                       config=JaxConfig(coalesce_window_s=0.05,
                                        max_pending=256))


def _stages(ctx):
    return [s for s, _ in sorted(ctx.events, key=lambda e: e[1])]


# -- context and tail semantics ---------------------------------------------


def test_mint_disabled_returns_shared_noop():
    for t, _ in BOTH:
        # An earlier file's driver run on this worker may have left
        # traces in the process-wide tail: start from an empty one.
        t.reset()
        t.disable()
        ctx = t.mint("request")
        assert ctx is t.NOOP_CONTEXT and ctx is t.mint("solve")
        assert ctx.trace_id is None
        ctx.event("x")
        ctx.annotate(a=1)
        ctx.finish("error")  # must not reach the tail
        assert t.trace_tail().snapshot()["seen"] == 0


def test_context_timeline_and_tail_classes(sampling):
    """Error outcomes always keep, with ordered timelines and
    annotations; group-shared stages merge in time order; a second
    finish records nothing. Both packages keep the same ids."""
    kept = []
    for t, _ in BOTH:
        tail = t.TraceTail(floor_every=4, slow_capacity=8, error_capacity=8,
                           floor_capacity=8)
        ctx = t.mint("request")
        ctx.event("admit")
        ctx.annotate(model="m")
        ctx.finish("shed")
        assert ctx.outcome == "shed" and ctx.duration_s >= 0
        tail.record(ctx)
        snap = tail.snapshot()
        assert snap["kept"]["error"] == 1
        first = snap["traces"]["error"][0]
        assert first["trace_id"] == ctx.trace_id
        assert first["annotations"] == {"model": "m"}
        assert [e["stage"] for e in first["events"]] == ["admit"]
        ctx2 = t.mint("request")
        ctx2.event("admit")
        t_co = time.perf_counter()
        ctx2.finish("ok", stages={"coalesce": t_co,
                                  "settle": time.perf_counter()})
        found = t.trace_tail().find(ctx2.trace_id)
        assert [e["stage"] for e in found["events"]] == [
            "admit", "coalesce", "settle"]
        seen = t.trace_tail().snapshot()["seen"]
        ctx2.finish("error")
        assert t.trace_tail().snapshot()["seen"] == seen
        kept.append((first["trace_id"], found["trace_id"], found["kind"]))
    assert kept[0] == kept[1]


def test_tail_slow_decile_and_floor(sampling):
    """The same durations and outcomes through both tails: the same
    threshold, the same rings, the same kept ids."""
    rng = np.random.default_rng(0)
    durations = [1.0 if i % 50 == 49 else 0.001 * (1 + rng.random())
                 for i in range(200)]
    snaps = []
    for t, _ in BOTH:
        tail = t.TraceTail(floor_every=10, window=200)
        for i, d in enumerate(durations + [0.0001]):
            ctx = t.TraceContext("request")
            ctx.outcome = "error" if i == len(durations) else "ok"
            ctx.duration_s = d
            tail.record(ctx)
        snaps.append(tail.snapshot())
    mine, theirs = snaps
    assert mine["slow_threshold_s"] == theirs["slow_threshold_s"] <= 1.0
    assert mine["kept"] == theirs["kept"]
    assert mine["kept"]["floor"] >= 1 and mine["kept"]["error"] == 1
    for ring in ("error", "slow", "floor"):
        assert [(x["trace_id"], x["duration_s"])
                for x in mine["traces"][ring]] == [
            (x["trace_id"], x["duration_s"])
            for x in theirs["traces"][ring]], ring
    assert 1.0 in [x["duration_s"] for x in mine["traces"]["slow"]]
    assert all(x["duration_s"] <= mine["slow_threshold_s"]
               for x in mine["traces"]["floor"])


def test_event_cap_bounds_runaway_timelines(sampling):
    for t, _ in BOTH:
        ctx = t.mint("solve")
        for _ in range(2 * ctx.MAX_EVENTS):
            ctx.event("solver_step")
        assert len(ctx.events) == ctx.MAX_EVENTS
        ctx.finish("ok")
        found = t.trace_tail().find(ctx.trace_id)
        assert found is not None  # the first traces always qualify slow
        assert found["events_dropped"] is True


# -- front-end propagation ----------------------------------------------------


def test_request_timeline_spans_admission_to_settle(traced_frontend):
    """One coalesced window: each request's context crosses the event
    loop, the dispatch thread and the scatter with JAX's timeline
    (admit, coalesce, dispatch, settle), and the latency histogram's
    buckets carry this run's trace ids."""
    fe, ref = traced_frontend
    reqs = fe_t.singles(500, 8)
    stages = []
    for frontend, side in ((fe, "t"), (_jax_frontend(ref), "j")):
        ctxs = [(tel if side == "t" else jtel).mint("request")
                for _ in reqs]

        async def go():
            async with frontend:
                return await asyncio.gather(
                    *[frontend.score(getattr(r, side), trace=c)
                      for r, c in zip(reqs, ctxs)])

        outs = fe_t.run(go())
        assert all(c.outcome == "ok" for c in ctxs)
        stages.append([_stages(c) for c in ctxs])
        if side == "t":
            fe_t.assert_all(outs, ref.scores(reqs))
            ex = tel.histogram(
                "serving.frontend.request_latency_seconds").exemplars()
            assert {c.trace_id for c in ctxs} & {
                tid for tid, _, _ in ex.values()}
    assert stages[0] == stages[1]
    assert stages[0][0] == ["admit", "coalesce", "dispatch", "settle"]


def test_solo_retry_keeps_original_trace_id(traced_frontend):
    """A poisoned window re-scores per request: each retried request
    keeps its original context, with the retry_solo hop; the offender's
    context finishes as an error and is kept."""
    fe, ref = traced_frontend
    good = [r.t for r in fe_t.singles(600, 4)]
    bad = GameDataset.build(
        responses=np.zeros(1),
        feature_shards={"global": sp.csr_matrix(np.ones((1, 6)))},
        ids={})  # no 'user' shard and no id columns
    ctxs = [tel.mint("request") for _ in range(5)]

    async def go():
        async with fe:
            return await asyncio.gather(
                *[fe.score(r, trace=c)
                  for r, c in zip(good[:2] + [bad] + good[2:], ctxs)],
                return_exceptions=True)

    out = fe_t.run(go())
    assert isinstance(out[2], KeyError)
    assert fe.stats()["isolation_splits"] == 1
    for ctx in ctxs[:2] + ctxs[3:]:
        assert ctx.outcome == "ok"
        assert {"retry_solo", "admit"} <= set(_stages(ctx))
    bad_ctx = ctxs[2]
    assert bad_ctx.outcome == "error"
    assert bad_ctx.annotations["error"] == "KeyError"
    found = tel.trace_tail().find(bad_ctx.trace_id)
    assert found["outcome"] == "error"
    assert "retry_solo" in [e["stage"] for e in found["events"]]


def test_shed_keeps_timeline_and_tags_rejection(traced_frontend):
    fe, _ = traced_frontend
    fe.config = FrontendConfig(coalesce_window_s=0.2, max_pending=1)
    reqs = [r.t for r in fe_t.singles(700, 3)]

    async def go():
        async with fe:
            return await asyncio.gather(*[fe.score(r) for r in reqs],
                                        return_exceptions=True)

    sheds = [e for e in fe_t.run(go()) if isinstance(e, RequestRejected)]
    assert sheds
    for e in sheds:
        found = tel.trace_tail().find(e.trace_id)
        assert found["outcome"] == "shed"
        assert found["annotations"]["scope"] == "process"
    assert tel.snapshot()["counters"]["serving.frontend.rejected"] == len(
        sheds)


def test_deferred_path_keeps_timelines_and_resolvable_exemplars(
        traced_frontend):
    """The default path (no trace=) defers each trace to the group's
    settle: every request is seen, kept timelines run admit to settle,
    and every latency exemplar resolves to a kept timeline."""
    fe, _ = traced_frontend
    reqs = [r.t for r in fe_t.singles(900, 24)]
    _, info = fe_t.replay(fe, reqs, concurrency=8)
    assert info["shed"] == 0 and info["errors"] == 0
    snap = tel.trace_tail().snapshot()
    assert snap["seen"] == len(reqs)
    kept = snap["traces"]["slow"] + snap["traces"]["floor"]
    assert kept
    for tr in kept:
        stages = [e["stage"] for e in tr["events"]]
        assert stages[0] == "admit" and stages[-1] == "settle"
        assert {"coalesce", "dispatch"} <= set(stages)
        assert tr["start_unix"] is not None
    ex = tel.histogram(
        "serving.frontend.request_latency_seconds").exemplars()
    assert ex
    for tid, _, _ in ex.values():
        assert tel.trace_tail().find(tid) is not None


def test_tracez_and_exemplars_under_concurrent_scrape(sampling):
    """Worker threads observe and finish traces while the main thread
    reads the tail and the exemplars: every read is well formed, and
    errors are kept."""
    h = tel.histogram("load.request_latency_seconds", exemplars=True)
    stop = threading.Event()

    def worker(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            ctx = tel.mint("request")
            ctx.event("admit")
            h.observe(float(rng.random() * 0.01), exemplar=ctx.trace_id)
            ctx.finish("ok" if rng.random() > 0.1 else "error")

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(3)]
    for t in threads:
        t.start()
    try:
        for _ in range(50):
            state = h.state()
            assert sum(state["counts"]) == state["count"]
            for tid, v, _ in h.exemplars().values():
                assert tid.startswith("t") and 0 <= v <= 0.01
            tz = tel.trace_tail().snapshot()
            for ring in tz["traces"].values():
                for tr in ring:
                    assert tr["trace_id"].startswith("t")
                    assert tr["outcome"] in ("ok", "error")
                    assert tr["duration_s"] >= 0
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    snap = tel.trace_tail().snapshot()
    assert snap["seen"] > 0 and snap["kept"]["error"] > 0


# -- divergence watchdog -------------------------------------------------------


def test_check_solver_finite_passes_and_raises(sampling):
    errors = []
    for (t, _), check, err in ((BOTH[0], check_solver_finite,
                                SolverDivergedError),
                               (BOTH[1], jax_check, JaxDiverged)):
        check("streaming-lbfgs", 3, 1.0, 0.5, None)
        ctx = t.mint("solve")
        with pytest.raises(err) as ei:
            check("streaming-lbfgs", 7, float("nan"), 1.0, ctx)
        e = ei.value
        assert e.solver == "streaming-lbfgs" and e.iteration == 7
        assert e.trace_id == ctx.trace_id
        found = t.trace_tail().find(ctx.trace_id)
        assert found["outcome"] == "diverged"
        assert found["annotations"]["iteration"] == 7
        with pytest.raises(err):
            check("streaming-tron", 1, 0.0, float("inf"))
        errors.append(e)
    assert str(errors[0]) == str(errors[1])


def test_watchdog_triggers_trace_tagged_flight_dump(tmp_path):
    """A NaN feature value diverges the streamed solve: both drivers
    raise the typed fault at the same solver and iteration, and the
    port's flight dump carries the solve's trace id and timeline."""
    from photon_ml_tpu.cli import game_training_driver as jax_training
    from photon_ml_tpu_torch.cli import game_training_driver
    from photon_ml_tpu_torch.io import schemas
    from photon_ml_tpu_torch.io.avro_codec import write_container

    rng = np.random.default_rng(20260811)
    train = tmp_path / "train"
    train.mkdir(parents=True)
    records = []
    for i in range(96):
        vals = rng.normal(0, 1, 3)
        records.append({
            "uid": f"u{i}", "label": float(i % 2),
            "features": [{"name": f"f{j}", "term": None,
                          "value": (float("nan") if i == 17 and j == 0
                                    else float(v))}
                         for j, v in enumerate(vals)],
            "weight": None, "offset": None, "metadataMap": None})
    write_container(train / "part-00000.avro", schemas.TRAINING_EXAMPLE,
                    records)
    argv = ["--train-input-dirs", str(train),
            "--task-type", "LOGISTIC_REGRESSION",
            "--fixed-effect-data-configurations", "fixed:global",
            "--fixed-effect-optimization-configurations",
            "fixed:10,1e-7,1.0,1.0,LBFGS,L2",
            "--updating-sequence", "fixed",
            "--stream-train", "--batch-rows", "32",
            "--hbm-budget", "64M", "--feeder", "python"]
    with pytest.raises(SolverDivergedError) as ei:
        game_training_driver.run(
            [*argv, "--output-dir", str(tmp_path / "port")], device="cpu")
    with pytest.raises(JaxDiverged) as jei:
        jax_training.run([*argv, "--output-dir", str(tmp_path / "jax")])
    e = ei.value
    assert (e.solver, e.iteration) == (jei.value.solver, jei.value.iteration)
    assert e.solver == "streaming-lbfgs" and e.trace_id is not None
    fl = json.loads((tmp_path / "port" / "flight.json").read_text())
    jfl = json.loads((tmp_path / "jax" / "flight.json").read_text())
    assert set(fl["flight"]) == set(jfl["flight"])
    fl = fl["flight"]
    assert fl["reason"] == jfl["flight"]["reason"] \
        == "fault:SolverDivergedError"
    assert fl["trace_id"] == e.trace_id
    (diverged,) = [t for t in fl["traces"]["traces"]["error"]
                   if t["trace_id"] == e.trace_id]
    assert diverged["outcome"] == "diverged"
    assert diverged["annotations"]["coordinate"] == "fixed"
    assert diverged["annotations"]["solver"] == "streaming-lbfgs"
    assert not tel.enabled()


# -- executable profiler ---------------------------------------------------------


def test_profiler_build_and_dispatch_table(traced_frontend):
    """Per build the wall time of the eager build and the first run and
    the static cost; per rows bucket the dispatches with their
    dispatch-to-settle times, mirrored into the registry; the table's
    keys are JAX's. The guard still counts one build a bucket."""
    fe, ref = traced_frontend
    reqs = fe_t.singles(800, 12)
    _, info = fe_t.replay(fe, [r.t for r in reqs], concurrency=4)
    assert info["errors"] == 0
    table = fe.stats()["cache"]["profiler"]
    jfe = _jax_frontend(ref)
    jfe.replay([r.j for r in reqs], concurrency=4)
    jtable = jfe.stats()["cache"]["profiler"]
    assert set(table) == set(jtable)
    assert table["builds"]
    for entry, jentry in zip(table["builds"].values(),
                             jtable["builds"].values()):
        assert set(entry) == set(jentry)
        assert entry["lower_s"] > 0 and entry["first_call_s"] is not None
        assert entry["flops"] > 0 and entry["bytes_accessed"] > 0
    assert table["dispatch"]
    for row in table["dispatch"].values():
        assert set(row) == set(next(iter(jtable["dispatch"].values())))
        assert row["dispatches"] >= 1 and row["mean_s"] > 0
        assert row["min_s"] <= row["mean_s"] <= row["max_s"]
    snap = tel.snapshot()["histograms"]
    bucket = [k for k in snap if k.startswith("serving.bucket.r")
              and k.endswith(".dispatch_seconds")]
    assert bucket
    assert sum(snap[k]["count"] for k in bucket) == sum(
        r["dispatches"] for r in table["dispatch"].values()) == \
        fe.stats()["engines"]["default"]["dispatches"]
    fe.guard.assert_max_retraces(per_fn=1)
    assert fe.guard.total_traces() == len(table["builds"])
