"""The serving engine on the card: every bucket's CUDA graph replay equal
to its eager scoring function bit for bit, for each bucket kind (fixed
effect only, random effect, RANDOM-projected, factored, loaded snapshot,
MF); two in-flight dispatches of one bucket each keeping its own result;
graphs captured == distinct bucket shapes, each captured once, with
row 9's launches counted at replay and none at capture; a served row's bits
independent of its bucket-mates and of the bucket's shape; captures
while another thread allocates pinned and device memory and launches
work, and while a ``BlockGameStream`` prefetch thread decodes; the
front-end's executor thread capturing and replaying; device memory
back where it was after hot swaps, the swapped-out engines' parameters,
buffers and graphs freed.

Marked ``cuda``: skips without a GPU. This file imports neither jax nor
the JAX package, so it runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_serving_cuda.py
"""

import asyncio
import gc
import threading
import weakref

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.convert import (
    FactoredRandomEffectArrays,
    FixedEffectArrays,
    MatrixFactorizationArrays,
    RandomEffectArrays,
    game_model_from_numpy,
)
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.index_map import IndexMap, feature_key
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro_codec import write_container
from photon_ml_tpu_torch.models.game_model import GameModel
from photon_ml_tpu_torch.serving import (
    BucketLadder,
    FrontendConfig,
    ServingFrontend,
    StreamingGameScorer,
)
from photon_ml_tpu_torch.ops import spmv
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

D_FIXED, D_USER, N_USERS, N_ITEMS, K = 13, 6, 30, 20, 3
LADDER = BucketLadder(min_rows=16, max_rows=256)
# float32 scores against the float64 host scoring of the same model:
# a few ulps of sums of ~20 terms of size ~1.
HOST_ATOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs run only on the card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _threads_joined():
    yield
    for t in threading.enumerate():
        if t.name.startswith(("serving-dispatch", "host-prefetch")):
            t.join(timeout=10)
            assert not t.is_alive(), f"thread {t.name} was left running"


def _columns(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, D_FIXED))
    x[:, -1] = 1.0
    xu = sp.random(n, D_USER, density=0.5, random_state=rng, format="csr")
    xu.data[:] = rng.normal(0, 1, xu.nnz)
    return dict(
        responses=(rng.random(n) < 0.5).astype(float),
        feature_shards={"global": sp.csr_matrix(x), "user": xu},
        ids={"userId": np.asarray([f"u{k}" for k in
                                   rng.integers(0, N_USERS + 4, n)]),
             "itemId": np.asarray([f"i{k}" for k in
                                   rng.integers(0, N_ITEMS + 2, n)])})


def request(seed, n):
    return GameDataset.build(**_columns(seed, n))


def _re_arrays(rng, latent=False) -> RandomEffectArrays:
    codes = np.arange(N_USERS)
    d = K if latent else D_USER
    return RandomEffectArrays(
        "userId", "user", [rng.normal(0, 1, (N_USERS, d))],
        [np.tile(np.arange(d, dtype=np.int32), (N_USERS, 1))], [codes],
        np.asarray([f"u{k}" for k in codes]), D_USER,
        projection=rng.normal(0, 1, (K, D_USER)) if latent else None)


class _Snapshot:
    """A loaded random effect (io/model_io.RandomEffectModelSnapshot's
    duck type)."""

    def __init__(self, rng):
        self.random_effect_type = "userId"
        self.feature_shard_id = "user"
        self.vocabulary = np.asarray([f"u{k}" for k in range(N_USERS)])
        self.matrix = sp.csr_matrix(rng.normal(0, 1, (N_USERS, D_USER)))


KINDS = ["fixed", "random", "projected", "factored", "snapshot", "mf"]


def model(kind, seed=0):
    rng = np.random.default_rng(seed)
    subs = {"fixed": FixedEffectArrays("global",
                                       rng.normal(0, 0.5, D_FIXED))}
    if kind == "random":
        subs["perUser"] = _re_arrays(rng)
    elif kind == "projected":
        subs["perUser"] = _re_arrays(rng, latent=True)
    elif kind == "factored":
        subs["perUser"] = FactoredRandomEffectArrays(
            _re_arrays(rng, latent=True), 1, K)
    elif kind in ("mf", "all"):
        if kind == "all":
            subs["perUser"] = _re_arrays(rng)
        subs["mf"] = MatrixFactorizationArrays(
            "userId", "itemId", rng.normal(0, 1, (N_USERS, K)),
            rng.normal(0, 1, (N_ITEMS, K)),
            np.asarray([f"u{k}" for k in range(N_USERS)]),
            np.asarray([f"i{k}" for k in range(N_ITEMS)]))
    gm = game_model_from_numpy(TaskType.LOGISTIC_REGRESSION, subs,
                               dtype=torch.float32, device="cuda")
    if kind == "snapshot":
        gm = GameModel({**gm.models, "perUser": _Snapshot(rng)},
                       TaskType.LOGISTIC_REGRESSION)
    return gm


def engine(gm, **kw):
    kw.setdefault("ladder", LADDER)
    return StreamingGameScorer(gm, dtype=torch.float32, device="cuda", **kw)


def assert_replays_equal_eager(eng):
    """Every bucket of ``eng``: its graph replayed on the inputs staged
    last equals its eager function on the same inputs, bit for bit."""
    buckets = eng.buckets()
    assert buckets
    for shape, ex in buckets.items():
        assert ex.graph is not None and ex.traces == 1, shape
        host, ev = ex.run()
        ev.synchronize()
        eager = ex.eager().cpu()
        assert torch.equal(host, eager), shape


def _host_scores(gm, ds):
    if any(isinstance(m, _Snapshot) for m in gm.models.values()):
        snap = gm.models["perUser"]
        rows = np.asarray([{v: k for k, v in enumerate(snap.vocabulary)}
                           .get(u, -1) for u in ds.id_columns["userId"]
                           .vocabulary[ds.id_columns["userId"].codes]])
        dense = np.vstack([snap.matrix.toarray(), np.zeros(D_USER)])
        re = np.asarray(ds.feature_shards["user"].multiply(
            dense[rows]).sum(axis=1)).ravel()
        fixed = GameModel({"fixed": gm.models["fixed"]},
                          TaskType.LOGISTIC_REGRESSION)
        return fixed.score(ds) + re
    return gm.score(ds)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_graph_replay_equals_eager_bit_for_bit(cuda_device, kind):
    gm = model(kind)
    eng = engine(gm)
    for i, n in enumerate([1, 20, 100, 256, 300, 17]):
        ds = request(10 + i, n)
        got = eng.score(ds)
        assert got.shape == (n,) and got.dtype == np.float32
        np.testing.assert_allclose(got, _host_scores(gm, ds), rtol=0,
                                   atol=HOST_ATOL)
    assert_replays_equal_eager(eng)


@pytest.mark.cuda
def test_in_flight_dispatches_of_one_bucket_keep_their_results(cuda_device):
    """Back-to-back dispatches of one bucket with two in flight: each
    result is the one that request gets scored alone."""
    eng = engine(model("all"), pipeline_depth=2)
    reqs = [request(100 + i, 50) for i in range(8)]
    streamed = list(eng.score_stream(reqs))
    assert len(eng.buckets()) == 1  # every dispatch replayed one graph
    ex = next(iter(eng.buckets().values()))
    assert ex.replays == 8
    for r, s in zip(reqs, streamed):
        alone = eng.score(r)
        assert alone.tobytes() == s.tobytes()
    many = eng.score_many(reqs[:2] + reqs[2:4])
    for r, s in zip(reqs[:4], many):
        assert s.tobytes() == eng.score(r).tobytes()


@pytest.mark.cuda
def test_captures_equal_distinct_bucket_shapes(cuda_device):
    eng = engine(model("all"))
    spmv.reset_launch_counts()
    sizes = np.random.default_rng(0).integers(1, 257, 30)
    reqs = [request(200 + i, int(n)) for i, n in enumerate(sizes)]
    for r in reqs:
        eng.score(r)
    shapes = {LADDER.bucket_shape(r.num_rows, tuple(
        int(r.feature_shards[s].nnz) for s in eng.shard_order))
        for r in reqs}
    assert eng.cache.compilations == len(shapes) == len(eng.buckets())
    assert set(eng.buckets()) == shapes
    eng.cache.assert_max_retraces(max_total=len(shapes), per_fn=1)
    buckets = eng.buckets().values()
    assert all(ex.launches_per_replay == 2 for ex in buckets)  # fixed, RE
    assert spmv.csr_matvec.recorded == 2 * len(shapes)
    # each build's eager run before its capture, then the replays
    assert spmv.csr_matvec.launches == 2 * len(shapes) + sum(
        2 * ex.replays for ex in buckets)
    assert sum(ex.replays for ex in buckets) == len(reqs)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["all", "factored", "snapshot"])
def test_a_served_rows_bits_do_not_depend_on_its_bucket_mates(cuda_device,
                                                              kind):
    gm = model(kind)
    eng = engine(gm)
    other = engine(gm, ladder=BucketLadder(min_rows=1, max_rows=4096))
    pool = request(300, 240)
    alone = [eng.score(pool.subset(np.arange(i, i + 1)))[0]
             for i in range(0, 240, 7)]
    whole = eng.score(pool)
    wide = other.score(pool)
    shuffled_rows = np.random.default_rng(1).permutation(240)
    shuffled = eng.score(pool.subset(shuffled_rows))
    back = np.empty_like(shuffled)
    back[shuffled_rows] = shuffled
    groups = eng.score_many([pool.subset(np.arange(a, a + 30))
                             for a in range(0, 240, 30)])
    for k, i in enumerate(range(0, 240, 7)):
        assert whole[i].tobytes() == alone[k].tobytes()
    assert whole.tobytes() == wide.tobytes() == back.tobytes()
    assert np.concatenate(groups).tobytes() == whole.tobytes()


def _hammer(stop: threading.Event, errors: list):
    """Another thread's CUDA work: pinned and device allocations and
    kernels on its own stream, until ``stop``."""
    try:
        side = torch.cuda.Stream()
        while not stop.is_set():
            pinned = torch.empty(1 << 16, pin_memory=True)
            with torch.cuda.stream(side):
                dev = torch.empty(1 << 18, device="cuda")
                dev.copy_(torch.ones(1 << 18).pin_memory(),
                          non_blocking=True)
                (dev * 2).sum()
            side.synchronize()
            del pinned, dev
    except Exception as e:  # noqa: BLE001 — reported by the test
        errors.append(e)


def _write_avro(path, seed, n):
    """``_columns(seed, n)`` as TrainingExampleAvro (features g0..g12 and
    v0..v5, the ids in metadataMap) and its two index maps."""
    cols = _columns(seed, n)
    x, xu = cols["feature_shards"]["global"].toarray(), \
        cols["feature_shards"]["user"].toarray()
    records = [{
        "uid": f"r{i}", "label": float(cols["responses"][i]),
        "features": ([{"name": f"g{j}", "term": None,
                       "value": float(x[i, j])}
                      for j in range(D_FIXED)]
                     + [{"name": f"v{j}", "term": None,
                         "value": float(xu[i, j])}
                        for j in range(D_USER) if xu[i, j] != 0]),
        "weight": None, "offset": None,
        "metadataMap": {"userId": str(cols["ids"]["userId"][i]),
                        "itemId": str(cols["ids"]["itemId"][i])}}
        for i in range(n)]
    path.mkdir()
    write_container(path / "part-00000.avro", schemas.TRAINING_EXAMPLE,
                    records)
    maps = {"global": IndexMap({feature_key(f"g{j}"): j
                                for j in range(D_FIXED)}),
            "user": IndexMap({feature_key(f"v{j}"): j
                              for j in range(D_USER)})}
    return maps


@pytest.mark.cuda
def test_capture_while_other_threads_touch_cuda(cuda_device, tmp_path):
    """Streamed scoring (its prefetch thread decoding) and a front-end
    (its executor thread capturing) while a third thread allocates
    pinned and device memory and launches kernels: every capture holds,
    and every bucket's replay equals its eager function."""
    maps = _write_avro(tmp_path / "data", 7, 1500)
    gm = model("all")
    stop, errors = threading.Event(), []
    hammer = threading.Thread(target=_hammer, args=(stop, errors),
                              name="hammer")
    hammer.start()
    try:
        eng = engine(gm)
        scored = eng.score_container_stream(
            tmp_path / "data", id_types=["itemId", "userId"],
            feature_shard_maps=maps, batch_rows=200, add_intercept=False,
            prefetch_depth=2)
        pairs = list(scored)
        fe = ServingFrontend({"default": gm}, dtype=torch.float32,
                             ladder=LADDER, device="cuda",
                             config=FrontendConfig(coalesce_window_s=0.001))
        reqs = [ds.subset(np.arange(a, min(a + 5, ds.num_rows)))
                for ds, _ in pairs[:2] for a in range(0, ds.num_rows, 5)]
        served, info = asyncio.run(asyncio.wait_for(
            fe._replay(reqs, "default", 8, None), 120))
    finally:
        stop.set()
        hammer.join(timeout=30)
    assert not hammer.is_alive() and not errors, errors
    assert scored.stream.prefetch_depth == 2 and scored.stream.rows == 1500
    assert sum(ds.num_rows for ds, _ in pairs) == 1500
    for ds, s in pairs:
        np.testing.assert_allclose(s, gm.score(ds), rtol=0, atol=HOST_ATOL)
    assert info["errors"] == 0 and info["shed"] == 0
    flat = np.concatenate([s for _, s in pairs[:2]])
    assert np.concatenate(served).tobytes() == flat.tobytes()
    assert_replays_equal_eager(eng)
    assert_replays_equal_eager(fe.engine("default"))


@pytest.mark.cuda
def test_hot_swaps_free_the_displaced_engines(cuda_device):
    """Four hot swaps, each followed by traffic: once its requests have
    settled, a swapped-out engine is gone and the device memory it held
    (parameters, bucket buffers, graphs and their pools) is free again,
    so the allocated bytes after a swap to a model are no more than
    after the previous swap to the same model."""
    models = [model("all"), model("mf")]
    reqs = [request(500 + i, 40) for i in range(12)]
    fe = ServingFrontend({"m": models[0]}, dtype=torch.float32,
                         ladder=LADDER, device="cuda",
                         config=FrontendConfig(coalesce_window_s=0.001))
    gone, allocated = [], []

    async def go():
        async with fe:
            await asyncio.gather(*[fe.score(r, "m") for r in reqs])
            for k in range(4):
                inflight = [asyncio.ensure_future(fe.score(r, "m"))
                            for r in reqs]
                await asyncio.sleep(0)
                gone.append(weakref.ref(fe.swap_model("m", models[k % 2])))
                await asyncio.gather(*inflight)
                await asyncio.gather(*[fe.score(r, "m") for r in reqs])
                del inflight
                gc.collect()
                torch.cuda.synchronize()
                allocated.append(torch.cuda.memory_allocated())

    asyncio.run(asyncio.wait_for(go(), 120))
    assert all(ref() is None for ref in gone)
    assert allocated[2] <= allocated[0] and allocated[3] <= allocated[1], \
        allocated
    assert fe.stats()["cache"]["compilations"] >= 5


@pytest.mark.cuda
def test_profiler_rows_count_the_replays(cuda_device):
    """The executable profiler's row of each rows bucket counts that
    bucket's graph replays (one a dispatch), builds record their static
    cost, and dispatch-to-settle times are positive."""
    eng = engine(model("all"))
    sizes = [3, 3, 40, 7, 120, 40, 3]
    for i, n in enumerate(sizes):
        eng.score(request(700 + i, n))
    table = eng.stats()["profiler"]
    replays = {}
    for (rows_b, _), ex in eng.buckets().items():
        replays[rows_b] = replays.get(rows_b, 0) + ex.replays
    assert {int(k[1:]): r["dispatches"]
            for k, r in table["dispatch"].items()} == replays
    assert sum(replays.values()) == len(sizes) == eng.stats()["dispatches"]
    assert len(table["builds"]) == len(eng.buckets())
    for b in table["builds"].values():
        assert b["lower_s"] > 0 and b["first_call_s"] > 0
        assert b["flops"] > 0 and b["bytes_accessed"] > 0
    for r in table["dispatch"].values():
        assert 0 < r["min_s"] <= r["mean_s"] <= r["max_s"]
        assert r["est_flops_per_sec"] > 0
