"""Streamed matrix factorization of the port (the cases of
tests/test_factor_cache.py and tests/test_mf_alternating.py) on the CPU at
float64, held against the JAX package's ``StreamedMFObjective``,
``DeviceFactorCache`` and ``StreamingFactoredRandomEffectCoordinate`` on
the same seeded data.

The JAX streamed MF computes in float32 wherever it names a type
(``np.float32`` and ``jnp.float32`` in ops/mf_alternating.py,
data/factor_cache.py and algorithm/coordinates.py); ``jax_float64``
widens those names to float64 while a JAX run lasts, as
tests/test_torch_stream_driver.py widens the JAX driver's float32
defaults, so both sides compute in float64. Tolerances:

- ``plan_factors`` and ``count_stream_entities`` give JAX's plan and
  counts exactly; the cache's hits, misses, evictions and byte counts
  equal JAX's over the same writes and reads (float32 tables, whose
  bytes JAX counts); the bf16 spill codec rounds as JAX's;
- the normal equations built through row 10's plain version equal JAX's
  ``gamma_kernel`` within rtol 1e-12;
- the γ pass's factors, the objective value and the B gradient agree
  with JAX's within rtol 1e-10; the coordinate's factors and B within
  1e-8 relative;
- in the port, factors and B are the same bits across f32 residency,
  the redecode tier and the stream's producer, and bf16 spill is as
  deterministic and within the JAX package's bound (max |ΔB| <= 0.05
  max |B|);
- the GAME training driver's ``--stream-train`` of the factored
  coordinate (``--task-type LINEAR_REGRESSION``) against the JAX
  driver's ``_stream_train_mf``: the same ``bestConfigs``, objective
  histories and decoded model records within 1e-8 relative; the
  port's records the same across budgets, the redecode tier, the
  python feeder and prefetch 0; streamed validation of the factored
  model (which the JAX driver cannot run) gives finite metrics.
"""

import contextlib
import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import photon_ml_tpu.algorithm.coordinates as jax_coords
import photon_ml_tpu.data.factor_cache as jax_fc
import photon_ml_tpu.ops.mf_alternating as jax_mf
import photon_ml_tpu.serving as jax_serving
from photon_ml_tpu.cli import game_training_driver as jax_training
from photon_ml_tpu.data.game_data import GameDataset as JaxGameDataset
from photon_ml_tpu.optimization import config as jax_config
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.algorithm.coordinates import (
    StreamingFactoredRandomEffectCoordinate,
)
from photon_ml_tpu_torch.cli import game_training_driver
from photon_ml_tpu_torch.data import factor_cache as fc
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro_codec import read_container, write_container
from photon_ml_tpu_torch.optimization.config import (
    GLMOptimizationConfiguration,
    MFOptimizationConfiguration,
)
from photon_ml_tpu_torch.optimization.convergence import (
    SolverDivergedError,
)
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

F64 = torch.float64
REPO = Path(__file__).resolve().parents[1]
CFG = "25,1e-8,1e-3,1.0,LBFGS,L2"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The products here are small: one intra-op thread each, so the
    parallel test workers do not oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Float64Names:
    """numpy with ``float32`` naming float64."""

    def __getattr__(self, name):
        return np.float64 if name == "float32" else getattr(np, name)


@contextlib.contextmanager
def jax_float64():
    saved = (jax_mf.np, jax_fc.np, jax_coords.np, jnp.float32)
    jax_mf.np = jax_fc.np = jax_coords.np = _Float64Names()
    jnp.float32 = jnp.float64
    try:
        yield
    finally:
        jax_mf.np, jax_fc.np, jax_coords.np, jnp.float32 = saved


@pytest.fixture(scope="module")
def problem():
    """tests/test_mf_alternating.py's problem: 400 x 10, 12 users, rank 2."""
    rng = np.random.default_rng(43)
    n, d, n_users = 400, 10, 12
    x = rng.normal(0, 1, (n, d))
    users = rng.integers(0, n_users, n)
    coefs = rng.normal(0, 1.0, (n_users, 2)) @ rng.normal(0, 1, (2, d))
    y = np.einsum("nd,nd->n", x, coefs[users]) + rng.normal(0, 0.05, n)
    return x, y, np.asarray([f"u{u:02d}" for u in users])


def _batches(problem, build=GameDataset.build, rows=96):
    x, y, names = problem
    return [build(responses=y[a:a + rows],
                  feature_shards={"s": sp.csr_matrix(x[a:a + rows])},
                  ids={"userId": names[a:a + rows]})
            for a in range(0, len(y), rows)]


def _coord(problem, **kw):
    batches = _batches(problem)
    args = dict(
        name="mf", make_stream=lambda: iter(batches), feature_shard_id="s",
        random_effect_type="userId", task_type=TaskType.LINEAR_REGRESSION,
        config=GLMOptimizationConfiguration.parse(CFG),
        latent_config=GLMOptimizationConfiguration.parse(CFG),
        mf_config=MFOptimizationConfiguration(max_iterations=2,
                                              num_factors=2),
        entities_per_shard=5, dtype=F64, device="cpu")
    args.update(kw)
    return StreamingFactoredRandomEffectCoordinate(**args)


def _jax_coord(problem):
    batches = _batches(problem, JaxGameDataset.build)
    cfg = jax_config.GLMOptimizationConfiguration.parse(CFG)
    return jax_coords.StreamingFactoredRandomEffectCoordinate(
        name="mf", make_stream=lambda: iter(batches), feature_shard_id="s",
        random_effect_type="userId",
        task_type=JaxTaskType.LINEAR_REGRESSION, config=cfg,
        latent_config=cfg,
        mf_config=jax_config.MFOptimizationConfiguration(
            max_iterations=2, num_factors=2),
        entities_per_shard=5)


def _bits(model):
    return (b"".join(c.numpy().tobytes() for c in model.latent.local_coefs)
            + model.projection_matrix.numpy().tobytes())


@pytest.fixture(scope="module")
def solved(problem):
    out = {}
    with jax_float64():
        jc = _jax_coord(problem)
        out["jax"] = jc.solve()
    base = _coord(problem)
    out["base"] = base.solve()
    for tag, kw in (("tight", dict(hbm_budget_bytes=96)),
                    ("tiny", dict(hbm_budget_bytes=1)),
                    ("redecode", dict(hbm_budget_bytes=96,
                                      spill_source="redecode")),
                    ("bf16", dict(hbm_budget_bytes=10 ** 9,
                                  spill_dtype="bf16")),
                    ("bf16-tight", dict(hbm_budget_bytes=96,
                                        spill_dtype="bf16"))):
        coord = _coord(problem, **kw)
        out[tag] = coord.solve()
        out[tag + "-stats"] = coord.cache.stats()
    return out


def test_plan_and_counts_match_jax(problem):
    mine = fc.count_stream_entities(iter(_batches(problem)), "userId")
    want = jax_fc.count_stream_entities(
        iter(_batches(problem, JaxGameDataset.build)), "userId")
    assert list(mine[0]) == list(want[0])
    assert mine[1].tolist() == want[1].tolist() and mine[2:] == want[2:]
    counts = np.asarray([0, 1, 2, 3, 4, 5, 8, 9, 17, 1, 1, 2, 33, 7])
    vocab = np.asarray([f"e{i:02d}" for i in range(len(counts))])
    for per in (1, 2, 3, 512):
        p = fc.plan_factors(vocab, counts, entities_per_shard=per)
        q = jax_fc.plan_factors(vocab, counts, entities_per_shard=per)
        assert [(s.index, s.obs_bucket, s.codes.tolist(), s.e_pad)
                for s in p.shards] == [
            (s.index, s.obs_bucket, s.codes.tolist(), s.e_pad)
            for s in q.shards]
        assert p.shard_of_code.tolist() == q.shard_of_code.tolist()
        assert p.slot_of_code.tolist() == q.slot_of_code.tolist()
        assert p.obs_bucket_histogram() == q.obs_bucket_histogram()
        names = np.asarray(["e03", "zz", "e00", "e13"])
        assert p.codes_of(names).tolist() == q.codes_of(names).tolist()
    with pytest.raises(ValueError):
        fc.plan_factors(vocab, counts[:-1])
    with pytest.raises(ValueError):
        fc.plan_factors(vocab, counts, entities_per_shard=0)


@pytest.mark.parametrize("spill_dtype,spill_source", [
    ("f32", "buffer"), ("bf16", "buffer"), ("f32", "redecode")])
def test_cache_counts_match_jax(spill_dtype, spill_source):
    """The same writes and reads through both caches (float32 tables):
    the same hits, misses, evictions, bytes; the same table bits."""
    counts = np.asarray([1, 2, 3, 5, 9, 17, 33, 2, 1, 4])
    vocab = np.asarray([f"e{i}" for i in range(len(counts))])
    plan = fc.plan_factors(vocab, counts, entities_per_shard=2)
    jplan = jax_fc.plan_factors(vocab, counts, entities_per_shard=2)
    rng = np.random.default_rng(1)
    tables = [rng.normal(0, 1, (s.e_pad, 3)).astype(np.float32)
              for s in plan.shards]
    budget = 2 * 4 * 8 * 3
    mine = fc.DeviceFactorCache(plan, 3, budget, spill_dtype, spill_source,
                                dtype=torch.float32, device="cpu")
    want = jax_fc.DeviceFactorCache(jplan, 3, budget, spill_dtype,
                                    spill_source)
    if spill_source == "redecode":
        mine.set_redecode(lambda i: torch.as_tensor(tables[i]))
        want.set_redecode(lambda i: tables[i])
    for i, t in enumerate(tables):
        a = mine.write(i, torch.as_tensor(t))
        b = want.write(i, t)
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    for _ in range(2):
        for i in range(len(tables)):
            a, b = mine.ensure(i), want.ensure(i)
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
    keys = ("hits", "misses", "evictions", "bytes_reuploaded",
            "spill_bytes_written", "redecodes", "device_bytes",
            "peak_device_bytes", "spill_bytes_host", "resident_shards",
            "shards", "entities", "e_pad_buckets", "obs_bucket_histogram")
    ms, ws = mine.stats(), want.stats()
    assert {k: ms[k] for k in keys} == {k: ws[k] for k in keys}
    assert ms["evictions"] > 0


def test_cache_guards():
    plan = fc.plan_factors(np.asarray(["a", "b"]), np.asarray([1, 2]))
    with pytest.raises(ValueError, match="pick one"):
        fc.DeviceFactorCache(plan, 2, 8, "bf16", "redecode", device="cpu")
    cache = fc.DeviceFactorCache(plan, 2, 1, device="cpu")
    with pytest.raises(RuntimeError, match="never written"):
        cache.ensure(0)
    with pytest.raises(ValueError, match="shape"):
        cache.write(0, torch.zeros(3, 2))


def test_normal_equations_match_jax_gamma_kernel(problem):
    """One batch's [u, k, k] and [u, k] partials: the entity x row CSR
    times the w v vᵀ | w t v panel, against JAX's segment sums."""
    coord = _coord(problem)
    obj = coord.mf_objective
    obj._ensure_built()
    rng = np.random.default_rng(3)
    B = rng.normal(0, 1, (2, 10))
    geom, block = next(obj._feature_pass())
    a_u, b_u = obj._normals(geom, block, geom.offsets_raw,
                            torch.as_tensor(B))
    with jax_float64():
        jobj = _jax_coord(problem).mf_objective
        jgeom, jfeats = next(jobj._feature_pass())
        ja, jb = jobj._kit["gamma"](
            jfeats, jgeom.labels, jgeom.offsets_raw, jgeom.weights,
            jgeom.seg_ids, jnp.asarray(B), u=jgeom.u_bucket)
    n = geom.n_uniq
    assert n == jgeom.n_uniq
    np.testing.assert_allclose(a_u.numpy(), np.asarray(ja)[:n], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(b_u.numpy(), np.asarray(jb)[:n], rtol=1e-12,
                               atol=1e-12)


def test_gamma_pass_value_and_gradient_match_jax(problem):
    rng = np.random.default_rng(4)
    B = rng.normal(0, 1, (2, 10))
    coef = rng.normal(0, 1, 20)
    obj = _coord(problem).mf_objective
    obj.gamma_pass(torch.as_tensor(B), 1e-3)
    _, f, g = obj.margins_value_grad(torch.as_tensor(coef), 0.5)
    zp = obj.margin_direction_list(torch.as_tensor(coef[::-1].copy()))
    with jax_float64():
        jobj = _jax_coord(problem).mf_objective
        jobj.gamma_pass(B, 1e-3)
        _, jf, jg = jobj.margins_value_grad(jnp.asarray(coef),
                                            jnp.asarray(0.5))
        jzp = jobj.margin_direction_list(jnp.asarray(coef[::-1].copy()))
        jtables = [np.asarray(t) for t in jobj.factor_tables()]
    for t, jt in zip(obj.factor_tables(), jtables):
        np.testing.assert_allclose(t.numpy(), jt, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(f.item(), float(jf), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-12)
    for a, b, geom in zip(zp, jzp, obj._geoms):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:geom.n_rows],
                                   rtol=1e-10, atol=1e-12)


def test_coordinate_matches_jax(solved):
    (mine, m_tr), (want, w_tr) = solved["base"], solved["jax"]
    assert [int(t.iterations) for t in m_tr] == \
        [int(t.iterations) for t in w_tr]
    b, jb = mine.projection_matrix.numpy(), np.asarray(want.projection_matrix)
    assert np.max(np.abs(b - jb)) <= 1e-8 * np.max(np.abs(jb))
    g = np.concatenate([c.numpy() for c in mine.latent.local_coefs])
    jg = np.concatenate([np.asarray(c) for c in want.latent.local_coefs])
    assert np.max(np.abs(g - jg)) <= 1e-8 * np.max(np.abs(jg))


def test_factors_identical_across_residency_and_redecode(solved):
    ref = _bits(solved["base"][0])
    for tag in ("tight", "tiny", "redecode"):
        assert _bits(solved[tag][0]) == ref, tag
    assert solved["tight-stats"]["evictions"] > 0
    assert solved["tight-stats"]["misses"] > 0
    rd = solved["redecode-stats"]
    assert rd["redecodes"] > 0 and rd["spill_bytes_host"] == 0


def test_bf16_deterministic_and_within_bound(solved):
    assert solved["bf16-stats"]["evictions"] == 0
    assert solved["bf16-tight-stats"]["evictions"] > 0
    assert _bits(solved["bf16"][0]) == _bits(solved["bf16-tight"][0])
    assert _bits(solved["bf16"][0]) != _bits(solved["base"][0])
    b = solved["base"][0].projection_matrix.numpy()
    b_bf = solved["bf16"][0].projection_matrix.numpy()
    assert np.max(np.abs(b_bf - b)) <= 0.05 * np.max(np.abs(b))


def test_stream_producer_residual_and_scoring(problem, solved):
    batches = _batches(problem)

    def generator_stream():
        yield from batches

    coord = _coord(problem, make_stream=generator_stream)
    model, _ = coord.solve()
    assert _bits(model) == _bits(solved["base"][0])
    scores = coord.score(model).numpy()
    x, y, _ = problem
    assert np.mean((scores - y) ** 2) < 0.1 * np.mean(y ** 2)
    res = np.linspace(-2.0, 2.0, len(y))
    shifted, _ = coord.solve(residual_scores=res)
    assert _bits(shifted) != _bits(model)
    again, _ = coord.solve(residual_scores=None)
    assert _bits(again) == _bits(model)


def test_divergence_and_scope(problem):
    x, y, names = problem
    y_bad = y.copy()
    y_bad[7] = np.nan
    with pytest.raises(SolverDivergedError):
        _coord((x, y_bad, names)).solve()
    with pytest.raises(ValueError, match="LINEAR_REGRESSION"):
        _coord(problem, task_type=TaskType.LOGISTIC_REGRESSION)
    with pytest.raises(ValueError, match="positive gamma L2"):
        _coord(problem, config=GLMOptimizationConfiguration.parse(
            "25,1e-8,0.0,1.0,LBFGS,L2"))
    with pytest.raises(ValueError, match="LBFGS"):
        _coord(problem, latent_config=GLMOptimizationConfiguration.parse(
            "25,1e-8,1e-3,1.0,TRON,L2"))
    base = _coord(problem)
    with pytest.raises(ValueError, match="num_factors"):
        _coord(problem, mf_config=MFOptimizationConfiguration(
            max_iterations=2, num_factors=3), mf_objective=base.mf_objective)
    calls = {"n": 0}

    def unstable():
        calls["n"] += 1
        return iter(_batches(problem, rows=96 if calls["n"] <= 2 else 64))

    with pytest.raises(RuntimeError, match="changed under"):
        _coord(problem, make_stream=unstable).solve()


# -- the driver --------------------------------------------------------------

MF_FLAGS = [
    "--task-type", "LINEAR_REGRESSION",
    "--factored-random-effect-data-configurations",
    "mf:userId,global,4,-1,-1,-1,IDENTITY",
    "--factored-random-effect-optimization-configurations",
    "mf:20,1e-7,1.0,1.0,LBFGS,L2;20,1e-7,1.0,1.0,LBFGS,L2;2,2|"
    "20,1e-7,10.0,1.0,LBFGS,L2;20,1e-7,1.0,1.0,LBFGS,L2;2,2",
    "--updating-sequence", "mf", "--evaluators", "RMSE",
    "--stream-train", "--batch-rows", "64",
]


def _generator():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "generate_example_data", REPO / "examples" / "generate_example_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _records(out: Path):
    return [list(read_container(f))
            for f in sorted((out / "best").rglob("*.avro"))]


def _values(out: Path):
    vals = []
    for recs in _records(out):
        for rec in recs:
            for key in ("means", "coefficients"):
                for m in rec.get(key) or []:
                    vals.append(m["value"])
            for m in rec.get("latentFactor") or []:
                vals.append(m)
    return np.asarray(vals, dtype=float)


@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    gen = _generator()
    rng = np.random.default_rng(19)
    w, bias = rng.normal(0, 1, 5), rng.normal(0, 1.5, 24)
    root = tmp_path_factory.mktemp("mf_driver")
    data = []
    for part, n in (("train", 300), ("validate", 150)):
        (root / part).mkdir()
        write_container(root / part / "part-00000.avro",
                        schemas.TRAINING_EXAMPLE,
                        gen.game_records(rng, n, w, bias),
                        sync_interval=2048)
        data += [f"--{part}-input-dirs", str(root / part)]
    runs = {"root": root}
    # The JAX driver's streamed validation of a factored model fails
    # (its validation stream reads no entity column; ROADMAP §C): the
    # runs held against it train without validation data.
    runs["validated"] = game_training_driver.run(
        [*data, *MF_FLAGS, "--output-dir", str(root / "validated")],
        device="cpu")
    data = data[:2]
    for tag, extra in (("none", []), ("tight", ["--hbm-budget", "100"]),
                       ("redecode", ["--hbm-budget", "100",
                                     "--spill-source", "redecode"]),
                       ("python", ["--hbm-budget", "100", "--feeder",
                                   "python", "--prefetch-batches", "0"])):
        runs[tag] = game_training_driver.run(
            [*data, *MF_FLAGS, *extra, "--output-dir", str(root / tag)],
            device="cpu")
    scorer = jax_serving.StreamingGameScorer
    with pytest.MonkeyPatch.context() as mp, jax_float64():
        mp.setattr(jax_serving, "StreamingGameScorer",
                   functools.partial(scorer, dtype=jnp.float64))
        runs["jax"] = jax_training.run(
            [*data, *MF_FLAGS, "--output-dir", str(root / "jax")])
    return runs


def test_driver_mf_matches_jax(driver_runs):
    mine, jax = driver_runs["none"], driver_runs["jax"]
    assert mine["bestConfigs"] == jax["bestConfigs"]
    assert mine["numRows"] == jax["numRows"] == 300
    np.testing.assert_allclose(mine["objectiveHistory"],
                               jax["objectiveHistory"], rtol=1e-8)
    got, want = _values(driver_runs["root"] / "none"), _values(
        driver_runs["root"] / "jax")
    assert got.shape == want.shape and got.size > 0
    assert np.max(np.abs(got - want)) <= 1e-8 * np.max(np.abs(want))
    info, jinfo = mine["stream_train"], jax["stream_train"]
    assert info["mode"] == jinfo["mode"] == "mf-stream"
    assert set(info) == set(jinfo) - {"trace_budgets", "trace_counts"}
    assert info["plan"] == jinfo["plan"]


def test_driver_mf_identical_across_residency_and_feeder(driver_runs):
    ref = _records(driver_runs["root"] / "none")
    for tag in ("tight", "redecode", "python"):
        assert _records(driver_runs["root"] / tag) == ref, tag
    assert driver_runs["tight"]["stream_train"]["cache"]["evictions"] > 0
    rd = driver_runs["redecode"]["stream_train"]
    assert rd["cache"]["redecodes"] > 0
    assert rd["redecode"]["decode_path"] == "native"


def test_driver_mf_validates_streamed(driver_runs):
    """Streamed validation reads the model's entity column and scores
    every grid point; the unvalidated run trains the same factors."""
    v = driver_runs["validated"]
    assert len(v["validationHistory"]) == 1
    assert np.isfinite(v["validationHistory"][0]["RMSE"])
    assert v["numCombos"] == 2
