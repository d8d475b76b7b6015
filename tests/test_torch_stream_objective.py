"""The port's sharded objective and streaming solvers on the CPU at
float64 (the cases of tests/test_sharded_objective.py), held against the
JAX package's ShardedGLMObjective and streaming L-BFGS/TRON over the same
shard decomposition of the same seeded data:

- value, gradient and TRON H v equal the JAX package's within rtol 1e-12;
- a single unpadded shard equals the port's one-shot GLMObjective bit for
  bit (plain and normalized), and the single-shard streaming solvers
  equal the port's in-core solvers bit for bit;
- the streaming solvers give JAX's iterations and stop reasons exactly,
  coefficients within atol 1e-9;
- the model is bit-identical across residency: resident,
  eviction-forced, redecode, prefetch 0 and 2; bf16 spill is as
  deterministic, and within the JAX package's bf16 bound (rtol 0.1,
  atol 5e-3 a coefficient, tests/test_cli_drivers.py:826-828) of the
  f32-spill model.

Every prefetch thread a test starts is joined with a timeout of its own
(the autouse fixture).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.data import shard_cache as jax_cache
from photon_ml_tpu.data.game_data import GameDataset as JaxGameDataset
from photon_ml_tpu.ops import glm_objective as jax_glm
from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.ops import sharded_objective as jax_sharded
from photon_ml_tpu.optimization import glm_lbfgs as jax_lbfgs
from photon_ml_tpu.optimization import tron as jax_tron
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.algorithm.coordinates import (
    StreamingFixedEffectCoordinate,
)
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.normalization import NormalizationContext
from photon_ml_tpu_torch.data.shard_cache import DeviceShardCache
from photon_ml_tpu_torch.ops.glm_objective import GLMObjective
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.sharded_objective import ShardedGLMObjective
from photon_ml_tpu_torch.parallel import make_mesh, mesh_device_list
from photon_ml_tpu_torch.optimization.config import (
    GLMOptimizationConfiguration,
)
from photon_ml_tpu_torch.optimization.convergence import (
    SolverDivergedError,
)
from photon_ml_tpu_torch.optimization.glm_lbfgs import (
    minimize_lbfgs_glm,
    minimize_lbfgs_glm_streaming,
)
from photon_ml_tpu_torch.optimization.tron import (
    minimize_tron,
    minimize_tron_streaming,
)
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

F64 = torch.float64
L2 = 0.7
RTOL, ATOL_COEF = 1e-12, 1e-9
TASK = TaskType.LOGISTIC_REGRESSION


@pytest.fixture(autouse=True)
def _join_prefetch_threads():
    yield
    for t in threading.enumerate():
        if t.name == "host-prefetch":
            t.join(timeout=10)
            assert not t.is_alive(), "a prefetch thread did not end"


class FakeStream:
    """Batches of one host matrix, for either package's GameDataset."""

    def __init__(self, problem, batch_rows, build=GameDataset.build):
        self.X, self.y, self.off, self.w = problem
        self.batch_rows, self.build = batch_rows, build

    def __iter__(self):
        n = self.X.shape[0]
        for s in range(0, n, self.batch_rows):
            e = min(n, s + self.batch_rows)
            yield self.build(responses=self.y[s:e],
                             feature_shards={"g": self.X[s:e]},
                             offsets=self.off[s:e], weights=self.w[s:e])

    def stats(self):
        return {"decode_path": "fake"}


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(23)
    n, d = 403, 29
    X = sp.random(n, d, density=0.12, random_state=7, format="csr")
    X.data[:] = rng.normal(0, 1, X.nnz)
    X = sp.hstack([X, np.ones((n, 1))], format="csr")  # an intercept
    X.sort_indices()
    w_true = rng.normal(0, 1, d + 1)
    p = 1 / (1 + np.exp(-(X @ w_true)))
    return (X, (rng.random(n) < p).astype(float), rng.normal(0, 0.2, n),
            rng.gamma(2.0, 0.5, n))


def _fetch(problem):
    X, y, off, w = problem

    def fetch(row_start, n_rows):
        s = slice(row_start, row_start + n_rows)
        return GameDataset.build(responses=y[s], feature_shards={"g": X[s]},
                                 offsets=off[s], weights=w[s])

    return fetch


def _cache(problem, batch_rows=64, **kw):
    if kw.get("spill_source") == "redecode":
        kw["redecode_fetch"] = _fetch(problem)
    return DeviceShardCache.from_stream(FakeStream(problem, batch_rows), "g",
                                        dtype=F64, device="cpu", **kw)


def _sobj(problem, batch_rows=64, normalization=None, **kw):
    return ShardedGLMObjective(
        GLMObjective(loss_for_task(TASK), normalization),
        _cache(problem, batch_rows, **kw))


def _jax_sobj(problem, batch_rows=64):
    cache = jax_cache.DeviceShardCache.from_stream(
        FakeStream(problem, batch_rows, JaxGameDataset.build), "g",
        dtype=np.float64)
    return jax_sharded.ShardedGLMObjective(
        jax_glm.GLMObjective(jax_losses.loss_for_task(
            JaxTaskType.LOGISTIC_REGRESSION)), cache)


def _one_shot(problem, normalization=None):
    X, y, off, w = problem
    batch = GameDataset.build(responses=y, feature_shards={"g": X},
                              offsets=off, weights=w).fixed_effect_batch(
        "g", dtype=F64, device="cpu")
    return GLMObjective(loss_for_task(TASK), normalization), batch


def _coef(problem, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).normal(
        0, 0.3, problem[0].shape[1]), dtype=F64)


def _norm(problem):
    d = problem[0].shape[1]
    rng = np.random.default_rng(3)
    shifts = torch.as_tensor(rng.normal(0, 0.1, d), dtype=F64)
    shifts[-1] = 0.0
    factors = torch.as_tensor(rng.uniform(0.5, 2.0, d), dtype=F64)
    factors[-1] = 1.0
    return NormalizationContext(factors=factors, shifts=shifts)


@pytest.mark.parametrize("normalized", [False, True])
def test_single_shard_value_grad_bitwise(problem, normalized):
    norm = _norm(problem) if normalized else None
    obj, batch = _one_shot(problem, norm)
    sobj = _sobj(problem, batch_rows=problem[0].shape[0],
                 normalization=norm)
    coef = _coef(problem)
    f_ref, g_ref = obj.value_and_grad(coef, batch, L2)
    f, g = sobj.value_and_grad(coef, L2)
    assert torch.equal(f, f_ref) and torch.equal(g, g_ref)


def test_hvp_single_shard_bitwise(problem):
    obj, batch = _one_shot(problem)
    sobj = _sobj(problem, batch_rows=problem[0].shape[0])
    coef, vec = _coef(problem), _coef(problem, 1)
    want = obj.make_tron_hvp(coef, batch, L2)(vec)
    z_list, _, _ = sobj.margins_value_grad(coef, L2)
    got = sobj.hessian_vector(vec, sobj.curvature_list(z_list), L2)
    assert torch.equal(got, want)


def test_value_grad_hvp_match_jax(problem):
    """Multi-shard (64-row shards, the last partial) against JAX's
    sharded objective over the same decomposition."""
    sobj, jobj = _sobj(problem), _jax_sobj(problem)
    coef, vec = _coef(problem), _coef(problem, 1)
    z_list, f, g = sobj.margins_value_grad(coef, L2)
    jz, jf, jg = jobj.margins_value_grad(jnp.asarray(coef.numpy()),
                                         jnp.asarray(L2))
    np.testing.assert_allclose(f.item(), float(jf), rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=1e-14)
    hv = sobj.hessian_vector(vec, sobj.curvature_list(z_list), L2)
    jhv = jobj.hessian_vector(jnp.asarray(vec.numpy()),
                              jobj.curvature_list(jz), jnp.asarray(L2))
    np.testing.assert_allclose(hv.numpy(), np.asarray(jhv), rtol=RTOL,
                               atol=1e-14)
    np.testing.assert_allclose(
        torch.cat(z_list).numpy(),
        np.concatenate([np.asarray(z)[:e.n_rows]
                        for z, e in zip(jz, jobj.cache.entries)]),
        rtol=RTOL, atol=1e-14)


def test_multi_shard_close_and_deterministic(problem):
    obj, batch = _one_shot(problem)
    sobj = _sobj(problem, batch_rows=37)
    coef = _coef(problem)
    f_ref, g_ref = obj.value_and_grad(coef, batch, L2)
    f, g = sobj.value_and_grad(coef, L2)
    np.testing.assert_allclose(f.item(), f_ref.item(), rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=RTOL,
                               atol=1e-14)
    f2, g2 = sobj.value_and_grad(coef, L2)
    assert torch.equal(f, f2) and torch.equal(g, g2)


RESIDENCIES = [
    dict(),
    dict(hbm_budget_bytes=1, prefetch_depth=0),
    dict(hbm_budget_bytes=1, prefetch_depth=2),
    dict(hbm_budget_bytes=6000, prefetch_depth=2),
    dict(hbm_budget_bytes=6000, spill_source="redecode"),
]


def test_partials_independent_of_residency(problem):
    coef, vec = _coef(problem), _coef(problem, 1)
    outs = []
    for kw in RESIDENCIES:
        sobj = _sobj(problem, **kw)
        z_list, f, g = sobj.margins_value_grad(coef, L2)
        hv = sobj.hessian_vector(vec, sobj.curvature_list(z_list), L2)
        outs.append((f, g, hv, torch.cat(z_list)))
        if kw.get("hbm_budget_bytes"):
            assert sobj.cache.stats()["misses"] > 0
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))


def test_streaming_lbfgs_single_shard_bitwise(problem):
    obj, batch = _one_shot(problem)
    sobj = _sobj(problem, batch_rows=problem[0].shape[0])
    x0 = torch.zeros(problem[0].shape[1], dtype=F64)
    ref = minimize_lbfgs_glm(obj, batch, x0, L2, max_iter=60, tol=1e-10)
    got = minimize_lbfgs_glm_streaming(sobj, x0, L2, max_iter=60, tol=1e-10)
    assert int(got.iterations) == int(ref.iterations)
    assert int(got.reason) == int(ref.reason)
    assert torch.equal(got.x, ref.x) and torch.equal(got.value, ref.value)


def test_streaming_tron_single_shard_bitwise(problem):
    obj, batch = _one_shot(problem)
    sobj = _sobj(problem, batch_rows=problem[0].shape[0])
    x0 = torch.zeros(problem[0].shape[1], dtype=F64)
    ref = minimize_tron(lambda x: obj.value_and_grad(x, batch, L2), x0,
                        make_hvp=lambda x: obj.make_tron_hvp(x, batch, L2),
                        max_iter=15, tol=1e-8)
    got = minimize_tron_streaming(sobj, x0, L2, max_iter=15, tol=1e-8)
    assert (int(got.iterations), int(got.reason)) == (int(ref.iterations),
                                                      int(ref.reason))
    assert (got.outer_steps, got.cg_steps) == (ref.outer_steps,
                                               ref.cg_steps)
    assert torch.equal(got.x, ref.x)


@pytest.mark.parametrize("solver", ["lbfgs", "tron"])
def test_streaming_solvers_match_jax(problem, solver):
    sobj, jobj = _sobj(problem), _jax_sobj(problem)
    d = problem[0].shape[1]
    if solver == "lbfgs":
        got = minimize_lbfgs_glm_streaming(sobj, torch.zeros(d, dtype=F64),
                                           L2, max_iter=60, tol=1e-9)
        want = jax_lbfgs.minimize_lbfgs_glm_streaming(
            jobj, jnp.zeros(d, jnp.float64), L2, max_iter=60, tol=1e-9)
    else:
        got = minimize_tron_streaming(sobj, torch.zeros(d, dtype=F64), L2,
                                      max_iter=15, tol=1e-8)
        want = jax_tron.minimize_tron_streaming(
            jobj, jnp.zeros(d, jnp.float64), L2, max_iter=15, tol=1e-8)
    assert int(got.iterations) == int(want.iterations) > 1
    assert int(got.reason) == int(want.reason)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=ATOL_COEF)
    np.testing.assert_allclose(got.value_history.numpy(),
                               np.asarray(want.value_history), rtol=RTOL)


@pytest.mark.parametrize("solver", ["lbfgs", "tron"])
def test_streaming_model_independent_of_residency(problem, solver):
    d = problem[0].shape[1]
    run = (minimize_lbfgs_glm_streaming if solver == "lbfgs"
           else minimize_tron_streaming)
    xs = [run(_sobj(problem, batch_rows=128, **kw),
              torch.zeros(d, dtype=F64), L2, max_iter=8, tol=1e-9).x
          for kw in RESIDENCIES]
    assert all(torch.equal(x, xs[0]) for x in xs[1:])


def test_bf16_model_deterministic_and_within_bound(problem):
    d = problem[0].shape[1]

    def solve(**kw):
        return minimize_lbfgs_glm_streaming(
            _sobj(problem, batch_rows=128, **kw), torch.zeros(d, dtype=F64),
            L2, max_iter=20, tol=1e-9).x

    f32 = solve(hbm_budget_bytes=6000)
    small = solve(hbm_budget_bytes=1, spill_dtype="bf16")
    big = solve(hbm_budget_bytes=60000, spill_dtype="bf16",
                prefetch_depth=0)
    assert torch.equal(small, big)
    assert not torch.equal(small, f32)
    np.testing.assert_allclose(small.numpy(), f32.numpy(), rtol=0.1,
                               atol=5e-3)


def test_streaming_coordinate_matches_solver_and_scope_errors(problem):
    cache = _cache(problem, batch_rows=128, hbm_budget_bytes=6000)
    cfg = GLMOptimizationConfiguration.parse("15,1e-9,0.7,1.0,LBFGS,L2")
    coord = StreamingFixedEffectCoordinate(
        name="fixed", cache=cache, feature_shard_id="g", task_type=TASK,
        config=cfg, dtype=F64)
    model, res = coord.solve()
    want = minimize_lbfgs_glm_streaming(
        coord.sharded_objective, torch.zeros(cache.n_features, dtype=F64),
        cfg.l2_weight, max_iter=15, tol=1e-9)
    assert torch.equal(model.glm.coefficients.means, want.x)
    other = StreamingFixedEffectCoordinate(
        name="fixed", cache=cache, feature_shard_id="g", task_type=TASK,
        config=GLMOptimizationConfiguration.parse(
            "5,1e-9,7.0,1.0,TRON,L2"), dtype=F64,
        sharded_objective=coord.sharded_objective)
    assert other.sharded_objective is coord.sharded_objective
    other.solve(model)
    for bad, match in (("30,1e-9,1.0,1.0,LBFGS,L1", "L2 only"),
                       ("30,1e-9,1.0,0.5,LBFGS,L2", "down-sampling")):
        with pytest.raises(ValueError, match=match):
            StreamingFixedEffectCoordinate(
                name="fixed", cache=cache, feature_shard_id="g",
                task_type=TASK, config=GLMOptimizationConfiguration.parse(
                    bad))
    # mesh= folds over a 1-D mesh of slots (ROADMAP A6a); anything but
    # a parallel.Mesh is refused by type.
    with pytest.raises(TypeError, match="Mesh"):
        StreamingFixedEffectCoordinate(
            name="fixed", cache=cache, feature_shard_id="g", task_type=TASK,
            config=cfg, mesh=object())
    with pytest.raises(ValueError, match="same cache"):
        StreamingFixedEffectCoordinate(
            name="fixed", cache=_cache(problem), feature_shard_id="g",
            task_type=TASK, config=cfg,
            sharded_objective=coord.sharded_objective)
    with pytest.raises(TypeError, match="Mesh"):
        ShardedGLMObjective(GLMObjective(loss_for_task(TASK)), cache,
                            mesh=object())
    # A real 1-D mesh runs: two slots over a cache placed on them give
    # the single-device fold's solve, bit for bit.
    mesh = make_mesh(2, device="cpu")
    two = _cache(problem, devices=mesh_device_list(mesh))
    meshed = StreamingFixedEffectCoordinate(
        name="fixed", cache=two, feature_shard_id="g", task_type=TASK,
        config=cfg, dtype=F64, mesh=mesh)
    got, _ = meshed.solve(model)
    want, _ = StreamingFixedEffectCoordinate(
        name="fixed", cache=_cache(problem), feature_shard_id="g",
        task_type=TASK, config=cfg, dtype=F64).solve(model)
    assert torch.equal(got.glm.coefficients.means,
                       want.glm.coefficients.means)


def test_restore_dtype_contract_rejects_leaked_bf16(problem):
    sobj = _sobj(problem)
    e = sobj.cache.entries[0]
    feats = e.feats
    object.__setattr__(feats, "values", feats.values.to(torch.bfloat16))
    with pytest.raises(TypeError, match="restore_spilled_features"):
        sobj.value_and_grad(_coef(problem), L2)


def test_divergence_watchdog_raises(problem):
    X, y, off, w = problem
    bad = X.copy()
    bad.data[3] = np.nan
    cache = DeviceShardCache.from_stream(
        FakeStream((bad, y, off, w), 64), "g", dtype=F64, device="cpu")
    sobj = ShardedGLMObjective(GLMObjective(loss_for_task(TASK)), cache)
    for run in (minimize_lbfgs_glm_streaming, minimize_tron_streaming):
        with pytest.raises(SolverDivergedError, match="diverged at outer "
                                                      "iteration 0"):
            run(sobj, torch.zeros(X.shape[1], dtype=F64), L2)
