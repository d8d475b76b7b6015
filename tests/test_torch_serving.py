"""The port's serving engine (photon_ml_tpu_torch/serving/engine.py)
against the JAX package's, float64 on the CPU: the cases of
tests/test_serving.py, each run through both engines on the same
numpy-seeded model and requests.

Scores agree to allclose 1e-12 (rtol and atol). For the same request
sequence the counters that are not telemetry (dispatches, requests,
rows_scored, rows_padded, nnz_scored, nnz_padded, padding waste,
entries, compilations, traces, bucket_shapes) equal JAX's. Also held
against JAX: the bucket ladder, ``padded_csr_arrays`` bit for bit and
``SortedVocab.codes_of``. On the CPU a bucket executable runs its eager
function; its graph twin is tested on the card
(tests/test_torch_serving_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.data.game_data import GameDataset as JaxGameDataset
from photon_ml_tpu.data.random_effect import (
    RandomEffectDataConfiguration,
    build_random_effect_dataset,
)
from photon_ml_tpu.evaluation import build_evaluator as jax_evaluator
from photon_ml_tpu.models import (
    Coefficients,
    FixedEffectModel,
    GameModel as JaxGameModel,
    LogisticRegressionModel,
    MatrixFactorizationModel,
    RandomEffectModel,
)
from photon_ml_tpu.ops.features import (
    padded_csr_arrays as jax_padded_csr_arrays,
)
from photon_ml_tpu.serving import BucketLadder as JaxLadder
from photon_ml_tpu.serving import ExecutableCache as JaxCache
from photon_ml_tpu.serving import StreamingGameScorer as JaxScorer
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu.utils.vocab import SortedVocab as JaxSortedVocab
from photon_ml_tpu_torch.convert import (
    FactoredRandomEffectArrays,
    FixedEffectArrays,
    MatrixFactorizationArrays,
    RandomEffectArrays,
    game_model_from_numpy,
)
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.evaluation import build_evaluator
from photon_ml_tpu_torch.models.game_model import GameModel
from photon_ml_tpu_torch.ops.features import padded_csr, padded_csr_arrays
from photon_ml_tpu_torch.serving import (
    BucketLadder,
    ExecutableCache,
    StreamingGameScorer,
)
from photon_ml_tpu_torch.serving import kernels
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils.tracing_guard import RetraceError, TracingGuard
from photon_ml_tpu_torch.utils.vocab import SortedVocab, vocab_code_lookup
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

JDT, DT = jnp.float64, torch.float64
LADDER = dict(min_rows=8, max_rows=64)
RTOL = ATOL = 1e-12


def _columns(rng, n=60, d=6, n_users=7, n_items=5, user_names=None):
    """tests/test_serving.py's _dataset draws, as raw columns."""
    x = rng.normal(0, 1, (n, d))
    x[:, -1] = 1.0
    if user_names is None:
        users = rng.integers(0, n_users, n).astype(str)
    else:
        users = np.asarray(user_names)
    items = rng.integers(0, n_items, n).astype(str)
    user_x = sp.csr_matrix(np.hstack(
        [rng.normal(0, 1, (n, 2)), np.ones((n, 1))]))
    return dict(responses=(rng.random(n) < 0.5).astype(float),
                feature_shards={"global": sp.csr_matrix(x), "user": user_x},
                ids={"userId": users, "itemId": items})


class Pair:
    """One request as the JAX (``.j``) and the port (``.t``) dataset."""

    def __init__(self, cols=None, j=None, t=None):
        self.j = j if j is not None else JaxGameDataset.build(**cols)
        self.t = t if t is not None else GameDataset.build(**cols)

    @property
    def num_rows(self):
        return self.t.num_rows

    def subset(self, rows):
        return Pair(j=self.j.subset(rows), t=self.t.subset(rows))


def dataset(seed_or_rng, n=60, **kw):
    rng = (seed_or_rng if isinstance(seed_or_rng, np.random.Generator)
           else np.random.default_rng(seed_or_rng))
    return Pair(_columns(rng, n=n, **kw))


def _jax_model(rng, train):
    """tests/test_serving.py's _game_model."""
    ds = build_random_effect_dataset(
        train, RandomEffectDataConfiguration("userId", "user"),
        intercept_col=2)
    re = RandomEffectModel.zeros_like_dataset(ds, dtype=JDT)
    re = re.with_coefs([jnp.asarray(rng.normal(0, 1, np.asarray(c).shape))
                        for c in re.local_coefs])
    fe = FixedEffectModel(
        LogisticRegressionModel(Coefficients(
            jnp.asarray(rng.normal(0, 1, 6)))), "global")
    mf = MatrixFactorizationModel(
        "userId", "itemId",
        jnp.asarray(rng.normal(0, 1, (7, 3))),
        jnp.asarray(rng.normal(0, 1, (5, 3))),
        np.unique(train.id_columns["userId"].vocabulary),
        np.unique(train.id_columns["itemId"].vocabulary))
    return JaxGameModel({"fixed": fe, "perUser": re, "mf": mf},
                        JaxTaskType.LOGISTIC_REGRESSION)


def _re_arrays(re) -> RandomEffectArrays:
    return RandomEffectArrays(
        re.random_effect_type, re.feature_shard_id,
        [np.asarray(c) for c in re.local_coefs],
        [np.asarray(f) for f in re.feat_idx],
        [np.asarray(c) for c in re.entity_codes],
        np.asarray(re.vocabulary), re.num_global_features)


def to_port(jm) -> "object":
    """The port's GameModel with the JAX model's parameters."""
    subs = {}
    for name, m in jm.models.items():
        if isinstance(m, FixedEffectModel):
            subs[name] = FixedEffectArrays(
                m.feature_shard_id, np.asarray(m.glm.coefficients.means))
        elif isinstance(m, RandomEffectModel):
            subs[name] = _re_arrays(m)
        else:
            subs[name] = MatrixFactorizationArrays(
                m.row_effect_type, m.col_effect_type,
                np.asarray(m.row_factors), np.asarray(m.col_factors),
                np.asarray(m.row_vocabulary), np.asarray(m.col_vocabulary))
    return game_model_from_numpy(TaskType.LOGISTIC_REGRESSION, subs,
                                 dtype=DT, device="cpu")


class Models:
    def __init__(self, rng):
        train = dataset(rng, n=80)
        self.train = train
        self.j = _jax_model(rng, train.j)
        self.t = to_port(self.j)


def engines(models, shared=False, **kw):
    """(JAX engine, port engine) on ``models``. ``shared``: the JAX
    engine keeps its compiled buckets in the module's one cache (the
    same model every time, so tests that compare only scores compile
    each JAX bucket once); else both engines start from empty caches,
    for tests that compare their counters."""
    jcache = _JAX_CACHE if shared else None
    return (JaxScorer(models.j, dtype=JDT, ladder=JaxLadder(**LADDER),
                      cache=jcache),
            StreamingGameScorer(models.t, dtype=DT,
                                ladder=BucketLadder(**LADDER), device="cpu",
                                **kw))


_JAX_CACHE = JaxCache()


def assert_scores(got, jax_got, pair=None, models=None):
    """The port's scores against the JAX engine's and, given the request,
    against the port's host scoring of the same model."""
    np.testing.assert_allclose(got, np.asarray(jax_got), rtol=RTOL,
                               atol=ATOL)
    if pair is not None:
        np.testing.assert_allclose(got, models.t.score(pair.t), rtol=RTOL,
                                   atol=ATOL)


CACHE_KEYS = {"entries", "compilations", "traces", "bucket_shapes"}
# The stats() keys telemetry fills: the process-wide histogram and the
# per-run profiler, compared by their own keys.
TELEMETRY_KEYS = {"request_latency_seconds", "profiler"}


def assert_same_counters(eng, jeng):
    """JAX's stats() keys in full, equal counters (the cache's only when
    the JAX engine has a cache of its own), and the telemetry keys' own
    keys: the latency histogram's snapshot and the profiler's table."""
    mine, theirs = eng.stats(), jeng.stats()
    assert set(mine) == set(theirs)
    own_cache = jeng.cache is not _JAX_CACHE
    for key in set(mine) - TELEMETRY_KEYS:
        if own_cache or key not in CACHE_KEYS:
            assert mine[key] == theirs[key], key
    assert set(mine["request_latency_seconds"]) == set(
        theirs["request_latency_seconds"])
    if "profiler" in mine:
        assert set(mine["profiler"]) == set(theirs["profiler"])


@pytest.fixture(scope="module")
def models():
    """tests/test_serving.py's model (its ``rng`` fixture's seed)."""
    return Models(np.random.default_rng(20260729))


# -- parity ----------------------------------------------------------------

def test_engine_matches_jax_engine(models):
    jeng, eng = engines(models)
    req = dataset(5, n=37)
    assert_scores(eng.score(req.t), jeng.score(req.j), req, models)
    assert_same_counters(eng, jeng)


def test_engine_splits_oversized_requests(models):
    jeng, eng = engines(models)
    req = dataset(7, n=150)  # > max_rows=64
    assert_scores(eng.score(req.t), jeng.score(req.j), req, models)
    assert_same_counters(eng, jeng)


def test_engine_micro_batch_scatters_per_request(models):
    jeng, eng = engines(models)
    reqs = [dataset(i, n=k) for i, k in enumerate([5, 9, 17, 3, 70, 1])]
    outs = eng.score_many([r.t for r in reqs])
    jouts = jeng.score_many([r.j for r in reqs])
    assert len(outs) == len(reqs)
    for r, o, jo in zip(reqs, outs, jouts):
        assert len(o) == r.num_rows
        assert_scores(o, jo, r, models)
    assert eng.stats()["dispatches"] < len(reqs) + 1
    assert_same_counters(eng, jeng)


def test_engine_stream_order_and_parity(models):
    jeng, eng = engines(models, shared=True)
    reqs = [dataset(10 + i, n=k) for i, k in enumerate([12, 33, 64, 2, 150])]
    outs = list(eng.score_stream(iter(r.t for r in reqs)))
    jouts = list(jeng.score_stream(iter(r.j for r in reqs)))
    assert len(outs) == len(reqs)
    for r, o, jo in zip(reqs, outs, jouts):
        assert_scores(o, jo, r, models)
    assert_same_counters(eng, jeng)


# -- edge cases ------------------------------------------------------------

def test_all_unknown_entities_score_re_and_mf_zero(models):
    cut = Models.__new__(Models)
    cut.j = JaxGameModel({k: v for k, v in models.j.models.items()
                          if k != "fixed"}, JaxTaskType.LOGISTIC_REGRESSION)
    cut.t = to_port(cut.j)
    jeng, eng = engines(cut)
    cols = _columns(np.random.default_rng(3), n=20,
                    user_names=["zz_unknown"] * 20)
    cols["ids"] = {"userId": np.asarray(["zz_unknown"] * 20),
                   "itemId": np.asarray(["qq_missing"] * 20)}
    req = Pair(cols)
    got = eng.score(req.t)
    np.testing.assert_array_equal(got, 0.0)
    np.testing.assert_array_equal(np.asarray(jeng.score(req.j)), 0.0)


def test_zero_nnz_batch_scores_zero_fixed(models):
    jeng, eng = engines(models)
    n = 11
    req = Pair(dict(responses=np.zeros(n),
                    feature_shards={"global": sp.csr_matrix((n, 6)),
                                    "user": sp.csr_matrix((n, 3))},
                    ids={"userId": np.asarray(["zz"] * n),
                         "itemId": np.asarray(["qq"] * n)}))
    np.testing.assert_array_equal(eng.score(req.t), 0.0)
    np.testing.assert_array_equal(np.asarray(jeng.score(req.j)), 0.0)
    assert_same_counters(eng, jeng)


def test_empty_request_returns_empty_without_dispatch(models):
    _, eng = engines(models)
    empty = GameDataset.build(
        responses=np.zeros(0),
        feature_shards={"global": sp.csr_matrix((0, 6)),
                        "user": sp.csr_matrix((0, 3))},
        ids={"userId": np.asarray([], str), "itemId": np.asarray([], str)})
    before = eng.stats()["dispatches"]
    assert len(eng.score(empty)) == 0
    assert eng.stats()["dispatches"] == before
    outs = list(eng.score_stream([empty]))
    assert len(outs) == 1 and len(outs[0]) == 0


def test_bucket_boundary_padding_does_not_leak(models):
    """Requests at an exact bucket size and one row over score as JAX's
    engine row for row; the AUC of streamed scores is the full batch's
    (padded rows never reach scores or metrics)."""
    jeng, eng = engines(models, shared=True)
    for n in (8, 9, 16, 17, 64):
        req = dataset(n, n=n)
        got = eng.score(req.t)
        assert got.shape == (n,)
        assert_scores(got, jeng.score(req.j), req, models)
    req = dataset(77, n=50)
    parts = [np.arange(0, 13), np.arange(13, 45), np.arange(45, 50)]
    streamed = np.concatenate(list(eng.score_stream(
        [req.t.subset(p) for p in parts])))
    jstreamed = np.concatenate([np.asarray(s) for s in jeng.score_stream(
        [req.j.subset(p) for p in parts])])
    assert_scores(streamed, jstreamed)
    auc = build_evaluator("AUC").evaluate_dataset(streamed, req.t)
    assert auc == pytest.approx(jax_evaluator("AUC").evaluate_dataset(
        models.j.score(req.j), req.j), abs=1e-12)
    assert_same_counters(eng, jeng)


# -- build-count discipline -------------------------------------------------

def test_executable_cache_counts_builds():
    cache = ExecutableCache()
    built = []
    for key in ["a", "b", "a", "a", "b", "c"]:
        cache.get_or_build(key, lambda k=key: built.append(k) or (lambda: k))
    assert cache.compilations == 3
    assert len(cache) == 3
    assert built == ["a", "b", "c"]


def test_build_count_bounded_by_bucket_ladder(models):
    """50 random-size requests build one executable per distinct bucket,
    each once, and JAX's engine compiles the same buckets: the counters
    and bucket shapes are equal; re-scoring builds nothing new."""
    guard = TracingGuard()
    jeng, eng = engines(models, tracing_guard=guard)
    ladder = eng.ladder
    sizes = np.random.default_rng(0).integers(1, 65, 50)
    reqs = [dataset(100 + i, n=int(n)) for i, n in enumerate(sizes)]
    for r in reqs:
        assert_scores(eng.score(r.t), jeng.score(r.j))
    expected_keys = set()
    for r in reqs:
        nnz = tuple(int(r.t.feature_shards[s].nnz)
                    for s in ("global", "user"))
        expected_keys.add(ladder.bucket_shape(r.num_rows, nnz))
    eng.cache.assert_max_retraces(max_total=len(expected_keys) + 1,
                                  per_fn=1)
    assert eng.cache.compilations == len(expected_keys)
    assert eng.cache.total_traces() == eng.cache.compilations
    assert eng.stats()["traces"] == eng.stats()["compilations"]
    assert eng.stats()["entries"] == eng.cache.compilations
    assert set(eng.cache_info()["bucket_shapes"]) == expected_keys
    assert_same_counters(eng, jeng)
    before = eng.cache.total_traces()
    for r in reqs[:10]:
        eng.score(r.t)
    assert eng.cache.total_traces() == before
    guard.set_budget(len(expected_keys) + 1)
    guard.verify()


def test_tracing_guard_trips_on_per_call_bucket_eviction(models):
    """Evicting the bucket entry before every dispatch rebuilds it each
    time; the guard keeps every evicted generation in its totals, so
    assert_max_retraces trips though the cache holds one entry."""
    guard = TracingGuard()
    _, eng = engines(models, tracing_guard=guard)
    orig = eng.cache.get_or_build

    def evict_then_build(key, build):
        eng.cache._entries.clear()
        return orig(key, build)

    eng.cache.get_or_build = evict_then_build
    req = dataset(11, n=16)
    for _ in range(6):
        eng.score(req.t)
    assert len(guard) == 6
    with pytest.raises(RetraceError, match="exceed budget"):
        eng.cache.assert_max_retraces(max_total=2)
    with pytest.raises(RetraceError):
        guard.assert_max_retraces(max_total=2)


@pytest.mark.parametrize("bounds", [(16, 4096), (8, 64), (1, 1), (3, 100)])
def test_bucket_ladder_matches_jax(bounds):
    mine, theirs = BucketLadder(*bounds), JaxLadder(*bounds)
    assert mine.num_row_buckets() == theirs.num_row_buckets()
    for n in range(0, bounds[1] + 1):
        assert mine.rows_bucket(n) == theirs.rows_bucket(n)
        for nnz in (0, 1, n, 3 * n + 1, 37 * n + 5):
            assert (mine.bucket_shape(n, (nnz, 2 * nnz))
                    == theirs.bucket_shape(n, (nnz, 2 * nnz)))
    with pytest.raises(ValueError):
        mine.rows_bucket(bounds[1] + 1)
    with pytest.raises(ValueError):
        BucketLadder(bounds[1] + 1, bounds[1])


# -- host payload -----------------------------------------------------------

@pytest.mark.parametrize("n,nnz_pad", [(0, 16), (5, 64), (16, 32), (9, 200)])
def test_padded_csr_arrays_match_jax_bit_for_bit(n, nnz_pad):
    rng = np.random.default_rng(n + nnz_pad)
    mat = sp.random(n, 7, density=0.3, format="csr", random_state=rng)
    if mat.nnz > nnz_pad:
        mat = mat[:, :2]
    for dt in (np.float32, np.float64):
        mine = padded_csr_arrays(mat, 16, nnz_pad, value_dtype=dt)
        theirs = jax_padded_csr_arrays(mat, 16, nnz_pad, value_dtype=dt)
        for a, b in zip(mine, theirs):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="n_rows_pad"):
        padded_csr_arrays(sp.csr_matrix((17, 3)), 16, 16)
    with pytest.raises(ValueError, match="nnz"):
        padded_csr(sp.csr_matrix(np.ones((2, 3))), 16, 5)


def test_padded_csr_keeps_pads_out_of_every_row():
    """The row-9 CSR: the same product as the matrix, every padded row
    empty, nothing past crow[rows] read, pads zero."""
    rng = np.random.default_rng(4)
    mat = sp.random(11, 9, density=0.4, format="csr", random_state=rng)
    crow, col, val = padded_csr(mat, 16, 64)
    assert crow.dtype == col.dtype == np.int32 and val.dtype == np.float32
    assert len(crow) == 17 and len(col) == len(val) == 64
    np.testing.assert_array_equal(crow[:12], mat.indptr)
    assert (crow[11:] == mat.nnz).all()
    assert (val[mat.nnz:] == 0).all() and (col[mat.nnz:] == 0).all()
    x = rng.normal(size=9)
    got = sp.csr_matrix((val.astype(np.float64), col, crow),
                        shape=(16, 9)) @ x
    np.testing.assert_allclose(got[:11], mat @ x, rtol=1e-6)
    assert (got[11:] == 0).all()


def test_sorted_vocab_matches_jax(rng):
    vocab = np.unique([f"ent{int(i)}" for i in rng.integers(0, 500, 200)])
    rng.shuffle(vocab)
    queries = np.asarray([f"ent{int(i)}" for i in rng.integers(0, 1000, 300)])
    idx = {str(n): i for i, n in enumerate(vocab)}
    want = np.asarray([idx.get(str(n), -1) for n in queries], np.int64)
    sv, jsv = SortedVocab.build(vocab), JaxSortedVocab.build(vocab)
    np.testing.assert_array_equal(sv.sorted_names, jsv.sorted_names)
    np.testing.assert_array_equal(sv.order, jsv.order)
    np.testing.assert_array_equal(sv.codes_of(queries), jsv.codes_of(queries))
    np.testing.assert_array_equal(sv.codes_of(queries), want)
    np.testing.assert_array_equal(vocab_code_lookup(vocab, queries), want)
    assert (want == -1).any()
    assert vocab_code_lookup(vocab, np.asarray([], str)).size == 0
    assert (vocab_code_lookup(np.asarray([], str), queries) == -1).all()
    assert SortedVocab.build(np.arange(5)).codes_of([3, 7]).tolist() == [3, -1]


# -- construction --------------------------------------------------------------

def test_snapshot_densify_ceiling_rejects_at_construction():
    class Snap:  # duck-typed io.model_io.RandomEffectModelSnapshot
        random_effect_type = "userId"
        feature_shard_id = "global"
        vocabulary = np.arange(3_000_000)
        matrix = sp.csr_matrix((3_000_000, 200_000))

    assert kernels.is_re_snapshot(Snap())
    gm = GameModel({"perUser": Snap()}, TaskType.LOGISTIC_REGRESSION)
    with pytest.raises(TypeError, match="densification ceiling"):
        StreamingGameScorer(gm, dtype=DT, device="cpu")


def test_snapshot_scores_as_its_assembled_matrix(models):
    """A loaded snapshot (the scoring driver's random effects) scores as
    the engine's assembled matrix of the same coefficients."""
    re = models.t.models["perUser"]

    class Snap:
        random_effect_type = "userId"
        feature_shard_id = "user"
        vocabulary = re.vocabulary
        matrix = re.model_matrix()

    snap_model = GameModel({"fixed": models.t.models["fixed"],
                            "perUser": Snap()}, TaskType.LOGISTIC_REGRESSION)
    eng = StreamingGameScorer(snap_model, dtype=DT, device="cpu",
                              ladder=BucketLadder(**LADDER))
    jcut = JaxGameModel({k: models.j.models[k] for k in ("fixed", "perUser")},
                        JaxTaskType.LOGISTIC_REGRESSION)
    req = dataset(21, n=30)
    assert_scores(eng.score(req.t), jcut.score(req.j))


def test_engine_rejects_unsupported_submodel():
    class Exotic:
        pass

    gm = GameModel({"weird": Exotic()}, TaskType.LOGISTIC_REGRESSION)
    with pytest.raises(kernels.UnsupportedSubModelError,
                       match="cannot device-score"):
        StreamingGameScorer(gm, device="cpu")


def test_engine_rejects_missing_shard_and_wrong_width(models):
    _, eng = engines(models)
    n = 4
    base = dict(responses=np.zeros(n),
                ids={"userId": np.asarray(["a"] * n),
                     "itemId": np.asarray(["b"] * n)})
    with pytest.raises(KeyError, match="missing feature shard"):
        eng.score(GameDataset.build(
            feature_shards={"global": sp.csr_matrix((n, 6))}, **base))
    with pytest.raises(ValueError, match="model expects"):
        eng.score(GameDataset.build(
            feature_shards={"global": sp.csr_matrix((n, 6)),
                            "user": sp.csr_matrix((n, 99))}, **base))


def test_factored_effect_scores_as_the_host_model(models):
    """A factored random effect (latent gamma, projection B) through the
    engine equals the port's host scoring of the same model."""
    re = _re_arrays(models.j.models["perUser"])
    rng = np.random.default_rng(9)
    k = 2
    latent = RandomEffectArrays(
        re.random_effect_type, re.feature_shard_id,
        [rng.normal(0, 1, (len(c), k)) for c in re.entity_codes],
        [np.tile(np.arange(k, dtype=np.int32), (len(c), 1))
         for c in re.entity_codes],
        re.entity_codes, re.vocabulary, re.num_global_features,
        projection=rng.normal(0, 1, (k, re.num_global_features)))
    gm = game_model_from_numpy(
        TaskType.LOGISTIC_REGRESSION,
        {"factored": FactoredRandomEffectArrays(latent, 1, k)},
        dtype=DT, device="cpu")
    eng = StreamingGameScorer(gm, dtype=DT, device="cpu",
                              ladder=BucketLadder(**LADDER))
    req = dataset(31, n=40)
    np.testing.assert_allclose(eng.score(req.t), gm.score(req.t),
                               rtol=RTOL, atol=ATOL)


def test_stats_checkpoint_and_rollback(models):
    _, eng = engines(models)
    eng.score(dataset(1, n=5).t)
    ckpt = eng.stats_checkpoint()
    eng.score(dataset(2, n=9).t)
    dispatches = eng.stats()["dispatches"]
    eng.rollback_stats(ckpt)
    st = eng.stats()
    assert {k: st[k] for k in ckpt} == ckpt
    assert st["dispatches"] == dispatches == 2
