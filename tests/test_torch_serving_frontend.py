"""The port's async serving front-end (photon_ml_tpu_torch/serving/
frontend.py) on the CPU at float64: the cases of
tests/test_serving_frontend.py, every score compared with the JAX
package's engine or front-end on the same numpy-seeded model and
requests (allclose 1e-12), and the front-end's counters with JAX's
where they are not telemetry.

Every event loop runs under ``asyncio.wait_for`` with its own timeout,
and every test checks that the front-end's dispatch thread was joined.

Tenancy: a captured CUDA graph holds its engine's parameter addresses,
so each of the port's engines keeps its own bucket cache and the
front-end shares one TracingGuard among them (JAX's same-structure
engines share one executable cache; ROADMAP §C). A swapped-out or
removed engine is freed once its admitted requests settle.

torch's CPU thread settings are per thread, so a reference engine that
a score is held to byte for byte runs on a thread of its own, as the
front-end's groups run on its dispatch thread.
"""

import asyncio
import concurrent.futures
import gc
import threading
import weakref

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.serving import BucketLadder as JaxLadder
from photon_ml_tpu.serving import ExecutableCache as JaxCache
from photon_ml_tpu.serving import FrontendConfig as JaxConfig
from photon_ml_tpu.serving import ServingFrontend as JaxFrontend
from photon_ml_tpu.serving import StreamingGameScorer as JaxScorer
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.serving import (
    BucketLadder,
    FrontendConfig,
    FrontendError,
    RequestRejected,
    ServingFrontend,
    StreamingGameScorer,
    UnknownModelError,
)
from photon_ml_tpu_torch.utils.tracing_guard import TracingGuard
from tests import test_torch_serving as ts
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

LADDER = ts.LADDER
TIMEOUT_S = 120.0
DT = torch.float64


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT_S))


def replay(fe, requests, model="default", concurrency=16, arrivals=None):
    """``fe.replay`` (its body, ``_replay``) under a timeout."""
    return run(fe._replay(requests, model, concurrency, arrivals))


def on_a_thread(fn):
    """``fn()`` on a thread of its own, joined (a dispatch thread's
    torch settings)."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(fn).result(timeout=TIMEOUT_S)


@pytest.fixture(autouse=True)
def _dispatch_threads_joined():
    yield
    for t in threading.enumerate():
        if t.name.startswith("serving-dispatch"):
            t.join(timeout=10)
            assert not t.is_alive(), "a dispatch thread was left running"


class Ref:
    """JAX engines sharing one executable cache (same-structure models
    share JAX's compiled buckets), one per weight variant."""

    def __init__(self):
        self.models = ts.Models(np.random.default_rng(20260729))
        self.cache = JaxCache()
        self._engines = {}

    def model(self, factor=1.0):
        m = ts.Models.__new__(ts.Models)
        m.j = self.models.j if factor == 1.0 else _jax_variant(
            self.models.j, factor)
        m.t = ts.to_port(m.j)
        return m

    def engine(self, factor=1.0):
        if factor not in self._engines:
            self._engines[factor] = JaxScorer(
                self.model(factor).j, dtype=ts.JDT,
                ladder=JaxLadder(**LADDER), cache=self.cache)
        return self._engines[factor]

    def scores(self, pairs, factor=1.0):
        return [np.asarray(s) for s in
                self.engine(factor).score_many([p.j for p in pairs])]


def _jax_variant(model, factor):
    """tests/test_serving_frontend.py's _variant: the fixed effect's
    weights scaled."""
    from photon_ml_tpu.models import Coefficients, FixedEffectModel

    fe = model.models["fixed"]
    glm = type(fe.glm)(Coefficients(
        np.asarray(fe.glm.coefficients.means) * factor))
    return model.update_model("fixed", FixedEffectModel(
        glm, fe.feature_shard_id))


@pytest.fixture(scope="module")
def ref():
    return Ref()


def frontend(models, window=0.001, max_pending=256, **kw):
    return ServingFrontend(
        models, dtype=DT, ladder=BucketLadder(**LADDER), device="cpu",
        config=FrontendConfig(coalesce_window_s=window,
                              max_pending=max_pending,
                              max_pending_per_model=kw.pop("quota", None)),
        **kw)


def singles(seed0, k, n=1):
    return [ts.dataset(seed0 + i, n=n) for i in range(k)]


def assert_all(outs, want):
    assert len(outs) == len(want)
    for o, w in zip(outs, want):
        np.testing.assert_allclose(o, w, rtol=ts.RTOL, atol=ts.ATOL)


def bad_request():
    return GameDataset.build(
        responses=np.zeros(1),
        feature_shards={"global": sp.csr_matrix(np.ones((1, 6)))},
        ids={})  # missing the 'user' shard and the id columns


# -- coalescing parity -----------------------------------------------------

def test_concurrent_singles_coalesce_and_match_jax(ref):
    fe = frontend({"default": ref.model().t})
    reqs = singles(100, 40)
    results, info = replay(fe, [r.t for r in reqs], concurrency=8)
    assert info["shed"] == 0 and info["errors"] == 0
    assert_all(results, ref.scores(reqs))
    st = fe.stats()
    assert st["engines"]["default"]["dispatches"] < len(reqs)
    assert st["engines"]["default"]["requests"] == len(reqs)
    assert st["completed"] == len(reqs) and st["admitted"] == len(reqs)


def test_full_window_coalesces_to_one_dispatch(ref):
    """All requests inside one window and under max_rows share ONE
    dispatch, the JAX engine's score_many of the same requests, with
    its counters."""
    fe = frontend({"default": ref.model().t}, window=0.25)
    reqs = singles(200, 16)
    results, _ = replay(fe, [r.t for r in reqs], arrivals=[0.0] * len(reqs))
    jeng = JaxScorer(ref.model().j, dtype=ts.JDT, ladder=JaxLadder(**LADDER),
                     cache=JaxCache())
    assert_all(results, [np.asarray(s) for s in
                         jeng.score_many([r.j for r in reqs])])
    st = fe.stats()
    assert st["engines"]["default"]["dispatches"] == 1
    assert st["coalesced_groups"] == 1
    mine = st["engines"]["default"]
    theirs = jeng.stats()
    for key in ("dispatches", "requests", "rows_scored", "rows_padded",
                "nnz_scored", "nnz_padded", "padding_waste_rows",
                "padding_waste_nnz", "compilations", "bucket_shapes"):
        assert mine[key] == theirs[key], key


def test_zero_row_and_oversized_requests(ref):
    fe = frontend({"default": ref.model().t})
    big = ts.dataset(7, n=150)  # > max_rows=64
    zero = ts.dataset(8, n=20).subset(np.arange(0))
    results, info = replay(fe, [big.t, zero.t], concurrency=2)
    assert info["shed"] == 0 and info["errors"] == 0
    assert_all(results[:1], [np.asarray(ref.engine().score(big.j))])
    assert results[1].shape == (0,)


def test_bad_request_is_isolated_from_its_window(ref):
    fe = frontend({"default": ref.model().t}, window=0.25)
    good = singles(300, 6)

    async def go():
        async with fe:
            tasks = [asyncio.ensure_future(fe.score(r))
                     for r in [g.t for g in good[:3]] + [bad_request()]
                     + [g.t for g in good[3:]]]
            return await asyncio.gather(*tasks, return_exceptions=True)

    out = run(go())
    assert isinstance(out[3], KeyError)
    assert_all(out[:3] + out[4:], ref.scores(good))
    assert fe.stats()["isolation_splits"] == 1
    assert fe.stats()["failed"] == 1


# -- admission control -----------------------------------------------------

def test_queue_full_rejection_contract(ref):
    fe = frontend({"default": ref.model().t}, window=0.1, max_pending=4)
    reqs = singles(400, 32)
    results, info = replay(fe, [r.t for r in reqs],
                           arrivals=[0.0] * len(reqs))
    assert info["completed"] == 4 and info["shed"] == 28
    st = fe.stats()
    assert st["rejected"] == 28 and st["admitted"] == 4
    done = [(r, o) for r, o in zip(reqs, results) if o is not None]
    assert len(done) == 4
    assert_all([o for _, o in done], ref.scores([r for r, _ in done]))

    async def one_reject():
        async with fe:
            tasks = [asyncio.ensure_future(fe.score(r.t)) for r in reqs[:4]]
            await asyncio.sleep(0)  # admit the four
            with pytest.raises(RequestRejected) as ei:
                await fe.score(reqs[4].t)
            assert ei.value.model == "default"
            assert ei.value.pending == 4 and ei.value.limit == 4
            assert ei.value.scope == "process"
            return await asyncio.gather(*tasks)

    assert_all(run(one_reject()), ref.scores(reqs[:4]))


def test_per_model_quota_protects_quiet_tenant(ref):
    fe = frontend({"hot": ref.model().t, "quiet": ref.model(2.0).t},
                  window=0.2, max_pending=64, quota=2)
    reqs = singles(900, 8)

    async def go():
        async with fe:
            hot = [asyncio.ensure_future(fe.score(r.t, model="hot"))
                   for r in reqs[:2]]
            await asyncio.sleep(0)  # admit the hot pair
            assert fe.stats()["pending_by_model"]["hot"] == 2
            with pytest.raises(RequestRejected) as ei:
                await fe.score(reqs[2].t, model="hot")
            assert ei.value.scope == "model"
            assert ei.value.model == "hot"
            assert ei.value.pending == 2 and ei.value.limit == 2
            quiet = await fe.score(reqs[3].t, model="quiet")
            return await asyncio.gather(*hot), quiet

    hot_out, quiet_out = run(go())
    assert_all(hot_out, ref.scores(reqs[:2]))
    assert_all([quiet_out], ref.scores(reqs[3:4], factor=2.0))
    st = fe.stats()
    assert st["rejected"] == 1
    assert st["rejected_by_model"] == {"hot": 1}
    assert st["completed"] == 3 and st["admitted"] == 3


def test_unknown_model_and_not_started(ref):
    fe = frontend({"default": ref.model().t})
    req = ts.dataset(500, n=1).t

    async def unknown():
        async with fe:
            with pytest.raises(UnknownModelError):
                await fe.score(req, model="nope")

    run(unknown())
    with pytest.raises(FrontendError, match="not started"):
        run(fe.score(req))


def test_score_during_close_is_refused_not_hung(ref):
    fe = frontend({"default": ref.model().t})
    req = ts.dataset(500, n=1)

    async def go():
        await fe.start()
        first = await fe.score(req.t)
        closer = asyncio.ensure_future(fe.close())
        await asyncio.sleep(0)  # close() sets _closing, starts draining
        with pytest.raises(FrontendError, match="closing"):
            await fe.score(req.t)
        await closer
        return first

    assert_all([run(go())], ref.scores([req]))


def test_isolation_retry_does_not_overcount(ref):
    """A window whose score_many spans several dispatch groups fails on
    a late group: the rollback leaves the engine counting the requests it
    served (3, 90 rows), and admitted == completed + failed."""
    fe = frontend({"default": ref.model().t}, window=0.25)
    goods = [ts.dataset(800 + i, n=30) for i in range(3)]
    results, info = replay(fe, [g.t for g in goods] + [bad_request()],
                           arrivals=[0.0] * 4)
    assert info["errors"] == 1 and info["shed"] == 0
    assert_all(results[:3], ref.scores(goods))
    st = fe.stats()
    assert st["isolation_splits"] == 1
    eng = st["engines"]["default"]
    assert eng["requests"] == 3
    assert eng["rows_scored"] == 90
    assert st["admitted"] == st["completed"] + st["failed"] == 4


# -- multi-model tenancy ---------------------------------------------------

def test_tenancy_routes_models_and_shares_one_cache(ref):
    """Two same-structure models resident: requests route to the right
    weights, and both engines' builds count in ONE guard, each bucket
    built once (the port's count: each engine builds its own buckets in
    its own cache)."""
    guard = TracingGuard()
    fe = frontend({"a": ref.model().t, "b": ref.model(3.0).t}, window=0.002,
                  tracing_guard=guard)
    sizes = [1, 3, 9, 17, 33, 2, 5]
    reqs = [ts.dataset(600 + i, n=k) for i, k in enumerate(sizes)]

    async def go():
        async with fe:
            ta = [asyncio.ensure_future(fe.score(r.t, model="a"))
                  for r in reqs]
            tb = [asyncio.ensure_future(fe.score(r.t, model="b"))
                  for r in reqs]
            return (await asyncio.gather(*ta), await asyncio.gather(*tb))

    outs_a, outs_b = run(go())
    assert_all(outs_a, ref.scores(reqs))
    assert_all(outs_b, ref.scores(reqs, factor=3.0))
    for oa, ob in zip(outs_a, outs_b):
        assert not np.allclose(oa, ob)
    eng_a, eng_b = fe.engine("a"), fe.engine("b")
    assert eng_a.cache is not eng_b.cache
    assert eng_a.cache.guard is eng_b.cache.guard is fe.guard is guard
    built = len(eng_a.buckets()) + len(eng_b.buckets())
    assert eng_a.cache.compilations + eng_b.cache.compilations == built
    assert len(guard) == built
    guard.assert_max_retraces(max_total=built, per_fn=1)
    assert guard.total_traces() == built
    for eng in (eng_a, eng_b):
        shapes = set(eng.buckets())
        assert eng.stats()["dispatches"] >= len(shapes) >= 1
    cache = fe.stats()["cache"]
    assert {k: cache[k] for k in ("entries", "compilations", "traces")} == {
        "entries": built, "compilations": built, "traces": built}
    # The engines' shared profiler saw each build once, under its model.
    builds = cache["profiler"]["builds"]
    assert len(builds) == built
    assert {name.split(":")[1] for name in builds} == {"a", "b"}


def test_per_model_stats_do_not_cross_contaminate(ref):
    fe = frontend({"a": ref.model().t, "b": ref.model(2.0).t}, window=0.002)
    reqs = singles(700, 6)
    replay(fe, [r.t for r in reqs[:4]], model="a", concurrency=2)
    replay(fe, [r.t for r in reqs[4:]], model="b", concurrency=2)
    st = fe.stats()
    assert st["engines"]["a"]["metrics_label"] == "a"
    assert st["engines"]["a"]["requests"] == 4
    assert st["engines"]["b"]["requests"] == 2
    assert st["completed"] == st["admitted"] == 6


# -- hot swap --------------------------------------------------------------

def test_hot_swap_never_drops_and_pins_old_weights(ref):
    """Requests admitted before the swap complete on the old weights,
    byte-identical to a reference engine at the same ladder scoring the
    same requests (alone, and the three admitted during the swap as the
    one group they coalesce into); requests after it on the new weights;
    nothing drops or errors."""
    ma, mb = ref.model(), ref.model(5.0)
    req = ts.dataset(42, n=3)
    ref_a, ref_b = (StreamingGameScorer(m.t, dtype=DT,
                                        ladder=BucketLadder(**LADDER),
                                        device="cpu") for m in (ma, mb))
    bytes_a, bytes_b, group_a = on_a_thread(lambda: (
        ref_a.score(req.t).tobytes(), ref_b.score(req.t).tobytes(),
        [s.tobytes() for s in ref_a.score_many([req.t] * 3)]))
    assert bytes_a != bytes_b
    for got, factor in ((bytes_a, 1.0), (bytes_b, 5.0)):
        np.testing.assert_allclose(np.frombuffer(got),
                                   ref.scores([req], factor=factor)[0],
                                   rtol=ts.RTOL, atol=ts.ATOL)
    fe = frontend({"m": ma.t}, window=0.0)

    async def go():
        async with fe:
            pre = await fe.score(req.t, model="m")
            inflight = [asyncio.ensure_future(fe.score(req.t, model="m"))
                        for _ in range(3)]
            await asyncio.sleep(0)  # admitted; not yet dispatched
            old = fe.swap_model("m", mb.t)
            during = await asyncio.gather(*inflight)
            post = await fe.score(req.t, model="m")
            return pre, during, post, old

    pre, during, post, old = run(go())
    assert pre.tobytes() == bytes_a
    assert [d.tobytes() for d in during] == group_a
    assert post.tobytes() == bytes_b
    st = fe.stats()
    assert st["model_swaps"] == 1
    assert st["admitted"] == st["completed"] == 5
    assert st["failed"] == 0
    assert old.stats()["requests"] == 4


def test_swapped_out_and_removed_engines_are_freed(ref):
    """Once its admitted requests settle, nothing holds a swapped-out or
    removed engine: it and its bucket executables (with their parameters,
    buffers and, on the card, graphs) are freed, while the guard still
    counts their builds."""
    fe = frontend({"m": ref.model().t, "x": ref.model(2.0).t}, window=0.0)
    new = ref.model(5.0).t
    req = ts.dataset(43, n=3)

    async def go():
        async with fe:
            await fe.score(req.t, model="m")
            await fe.score(req.t, model="x")
            inflight = [asyncio.ensure_future(fe.score(req.t, model="m"))
                        for _ in range(3)]
            await asyncio.sleep(0)  # admitted on the old engine
            old = fe.swap_model("m", new)
            held = [weakref.ref(old), *(weakref.ref(ex)
                                        for ex in old.buckets().values())]
            del old
            await asyncio.gather(*inflight)
            held.append(weakref.ref(fe.engine("x")))
            fe.remove_model("x")
            await fe.score(req.t, model="m")
            return held

    held = run(go())
    gc.collect()
    assert len(held) >= 3 and all(r() is None for r in held)
    st = fe.stats()["cache"]
    assert st["entries"] == len(fe.engine("m").buckets())
    assert st["compilations"] == st["traces"] > st["entries"]
    fe.guard.assert_max_retraces(per_fn=1)


def test_swap_unknown_model_and_duplicate_add(ref):
    gm = ref.model().t
    fe = frontend({"default": gm})
    with pytest.raises(UnknownModelError):
        fe.swap_model("ghost", gm)
    with pytest.raises(FrontendError, match="already resident"):
        fe.add_model("default", gm)
    fe.remove_model("default")
    assert fe.models == ()
    with pytest.raises(UnknownModelError):
        fe.remove_model("default")


def test_stats_keys_are_jax_keys_but_telemetry(ref):
    """The port's stats() has every key of JAX's front-end, the
    telemetry histograms and the cache's profiler included since the
    telemetry core (ROADMAP A5b): the histograms' snapshots and the
    profiler's table carry JAX's keys too. The process-wide histograms
    snapshot an ``exemplars`` key once a kept trace stamped one, which an
    earlier test file in the same process may have done, so both
    packages' start from reset histograms."""
    from photon_ml_tpu import telemetry as jax_telemetry
    from photon_ml_tpu_torch import telemetry as port_telemetry

    for reg in (jax_telemetry.registry(), port_telemetry.registry()):
        for name in ("queue_wait_seconds", "request_latency_seconds",
                     "coalesce_group_requests"):
            reg.histogram(f"serving.frontend.{name}").reset()
    fe = frontend({"default": ref.model().t})
    jfe = JaxFrontend({"default": ref.model().j}, dtype=ts.JDT,
                      ladder=JaxLadder(**LADDER),
                      config=JaxConfig(coalesce_window_s=0.001,
                                       max_pending=256))
    mine, theirs = fe.stats(), jfe.stats()
    telemetry = {"queue_wait_seconds", "request_latency_seconds",
                 "coalesce_group_requests"}
    assert set(mine) == set(theirs)
    assert set(mine["cache"]) == set(theirs["cache"])
    assert set(mine["cache"]["profiler"]) == set(
        theirs["cache"]["profiler"])
    for key in telemetry:
        assert set(mine[key]) == set(theirs[key]), key
    for key in set(mine) - {"cache", "engines"} - telemetry:
        assert mine[key] == theirs[key], key
