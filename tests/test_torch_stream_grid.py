"""The batched λ grid of the port (the cases of tests/test_grid_batched.py)
on the CPU at float64, held against the JAX package's grid solvers
(``minimize_lbfgs_glm_grid_streaming``, ``minimize_tron_grid_streaming``)
over the same shard decomposition of the same seeded data, and against
the port's own sequential sweep:

- the grid partials (value, gradient, Hessian-vector) equal JAX's grid
  kernels within rtol 1e-12;
- both grid solvers give JAX's grid iterations, stop reasons and
  per-row value and gradient-norm histories (rtol 1e-9) exactly, and
  coefficients within atol 1e-9;
- G = 1 is the port's scalar streamed solve, bit for bit;
- against the port's sequential sweep, the JAX test's own rule:
  the same iterations and reasons for L-BFGS, coefficients within rtol
  2e-3 / atol 1e-4 (TRON 1e-3 / 1e-3), and the same selected model;
- frozen rows keep their margins and coefficients bit for bit; a
  poisoned λ diverges alone, naming its row; feature passes do not
  depend on G; ``grid_batchable`` answers as JAX's does;
- row 10's plain version (torch.sparse.mm) agrees with row 9's
  (torch.mv) column by column within rtol 1e-13.

- the GAME training driver's ``--stream-train --hbm-budget 8K`` with
  ``--grid-batched on`` and ``auto`` on a 3-point grid, in the process,
  against the JAX driver at float64 (wrapped as
  tests/test_torch_stream_driver.py wraps it): the same ``bestConfigs``,
  objective histories within 1e-8 relative and coefficient records
  within 1e-8 relative (atol 1e-12); metrics.json says the sweep was
  batched; a 1-point ``on`` run writes the ``off`` run's records.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.algorithm import coordinates as jax_coords
from photon_ml_tpu.data import normalization as jax_norm
from photon_ml_tpu.data import shard_cache as jax_cache
from photon_ml_tpu.data.game_data import GameDataset as JaxGameDataset
from photon_ml_tpu.ops import glm_objective as jax_glm
from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.ops import sharded_objective as jax_sharded
from photon_ml_tpu.optimization import config as jax_config
from photon_ml_tpu.optimization import glm_lbfgs as jax_lbfgs
from photon_ml_tpu.optimization import tron as jax_tron
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.algorithm.coordinates import (
    StreamingFixedEffectCoordinate,
    grid_batchable,
    solve_fixed_effect_grid,
)
from photon_ml_tpu_torch.data.normalization import NormalizationContext
from photon_ml_tpu_torch.data.shard_cache import DeviceShardCache
from photon_ml_tpu_torch.ops import spmv
from photon_ml_tpu_torch.ops.glm_objective import GLMObjective
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.sharded_objective import ShardedGLMObjective
from photon_ml_tpu_torch.optimization.config import (
    GLMOptimizationConfiguration,
)
from photon_ml_tpu_torch.optimization.convergence import (
    ConvergenceReason,
    SolverDivergedError,
)
from photon_ml_tpu_torch.optimization.glm_lbfgs import (
    minimize_lbfgs_glm_grid_streaming,
    minimize_lbfgs_glm_streaming,
)
from photon_ml_tpu_torch.optimization.tron import (
    minimize_tron_grid_streaming,
    minimize_tron_streaming,
)
from photon_ml_tpu_torch.types import TaskType

from photon_ml_tpu_torch.cli import game_training_driver
from tests import test_torch_stream_driver as sd
from tests.test_torch_stream_objective import FakeStream
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The products here are small: one intra-op thread each, so the
    parallel test workers do not oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    """tests/test_grid_batched.py's problem shape: 403 x 23 at 15%."""
    rng = np.random.default_rng(31)
    n, d = 403, 23
    X = sp.random(n, d, density=0.15, random_state=7, format="csr")
    X.data[:] = rng.normal(0, 1, X.nnz)
    y = (rng.random(n) < 0.5).astype(float)
    return X, y, rng.normal(0, 0.1, n), rng.gamma(1.0, 1.0, n)


def _norm(d, port=True):
    """Factors and shifts, the last column the intercept."""
    rng = np.random.default_rng(3)
    shifts, factors = rng.normal(0, 0.1, d), rng.uniform(0.5, 2.0, d)
    shifts[-1], factors[-1] = 0.0, 1.0
    if port:
        return NormalizationContext(factors=torch.as_tensor(factors),
                                    shifts=torch.as_tensor(shifts),
                                    intercept_id=d - 1)
    return jax_norm.NormalizationContext(
        factors=jnp.asarray(factors), shifts=jnp.asarray(shifts),
        intercept_id=d - 1)


def _sobj(problem, batch_rows=96, budget=None, normalized=False):
    cache = DeviceShardCache.from_stream(
        FakeStream(problem, batch_rows), "g", dtype=F64, device="cpu",
        hbm_budget_bytes=budget)
    norm = _norm(problem[0].shape[1]) if normalized else None
    return ShardedGLMObjective(
        GLMObjective(loss_for_task(TaskType.LOGISTIC_REGRESSION), norm),
        cache)


def _jax_sobj(problem, batch_rows=96, normalized=False):
    cache = jax_cache.DeviceShardCache.from_stream(
        FakeStream(problem, batch_rows, JaxGameDataset.build), "g",
        dtype=np.float64)
    norm = _norm(problem[0].shape[1], port=False) if normalized else None
    return jax_sharded.ShardedGLMObjective(
        jax_glm.GLMObjective(jax_losses.loss_for_task(
            JaxTaskType.LOGISTIC_REGRESSION), norm), cache)


def _x0s(G, d):
    return torch.zeros((G, d), dtype=F64)


def _bits(t):
    return t.detach().cpu().numpy().tobytes()


@pytest.mark.parametrize("normalized", [False, True])
def test_grid_partials_match_jax_grid_kernels(problem, normalized):
    sobj = _sobj(problem, normalized=normalized)
    jobj = _jax_sobj(problem, normalized=normalized)
    d = problem[0].shape[1]
    rng = np.random.default_rng(5)
    coefs, vecs = rng.normal(0, 0.3, (3, d)), rng.normal(0, 1, (3, d))
    l2s = np.asarray([0.3, 3.0, 30.0])
    z, f, g = sobj.grid_margins_value_grad(torch.as_tensor(coefs),
                                           torch.as_tensor(l2s))
    jz, jf, jg = jobj.grid_margins_value_grad(jnp.asarray(coefs),
                                              jnp.asarray(l2s))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-12,
                               atol=1e-13)
    for a, b, e in zip(z, jz, sobj.cache.entries):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:, :e.n_rows],
                                   rtol=1e-12, atol=1e-14)
    hv = sobj.grid_hessian_vector(torch.as_tensor(vecs),
                                  sobj.grid_curvature_list(z),
                                  torch.as_tensor(l2s))
    jhv = jobj.grid_hessian_vector(jnp.asarray(vecs),
                                   jobj.grid_curvature_list(jz),
                                   jnp.asarray(l2s))
    np.testing.assert_allclose(hv.numpy(), np.asarray(jhv), rtol=1e-12,
                               atol=1e-13)


@pytest.mark.parametrize("solver", ["lbfgs", "tron"])
def test_grid_solvers_match_jax_grid(problem, solver):
    """At float64 the port's grid gives JAX's grid iterations, reasons
    and histories: the same masked schedule on the same numbers."""
    d = problem[0].shape[1]
    l2s = np.asarray([0.3, 3.0, 30.0]) if solver == "lbfgs" \
        else np.asarray([0.3, 3.0])
    kw = dict(max_iter=25) if solver == "lbfgs" else dict(max_iter=10)
    port_fn = (minimize_lbfgs_glm_grid_streaming if solver == "lbfgs"
               else minimize_tron_grid_streaming)
    jax_fn = (jax_lbfgs.minimize_lbfgs_glm_grid_streaming
              if solver == "lbfgs" else jax_tron.minimize_tron_grid_streaming)
    mine = port_fn(_sobj(problem), _x0s(len(l2s), d), l2s, **kw)
    want = jax_fn(_jax_sobj(problem), jnp.zeros((len(l2s), d)), l2s, **kw)
    for gi, (a, b) in enumerate(zip(mine, want)):
        assert int(a.iterations) == int(b.iterations), gi
        assert int(a.reason) == int(b.reason), gi
        np.testing.assert_allclose(a.x.numpy(), np.asarray(b.x), rtol=0,
                                   atol=1e-9, err_msg=str(gi))
        for h, jh in ((a.value_history, b.value_history),
                      (a.grad_norm_history, b.grad_norm_history)):
            np.testing.assert_allclose(h.numpy(), np.asarray(jh),
                                       rtol=1e-9, err_msg=str(gi))


@pytest.mark.parametrize("grid_fn,scalar_fn", [
    (minimize_lbfgs_glm_grid_streaming, minimize_lbfgs_glm_streaming),
    (minimize_tron_grid_streaming, minimize_tron_streaming),
])
def test_g1_batched_bitwise_identical(problem, grid_fn, scalar_fn):
    sobj = _sobj(problem)
    d = problem[0].shape[1]
    ref = scalar_fn(sobj, torch.zeros(d, dtype=F64), 0.7, max_iter=12)
    holder = []
    [res] = grid_fn(sobj, _x0s(1, d), [0.7], max_iter=12,
                    margins_out=holder)
    assert _bits(res.x) == _bits(ref.x)
    assert _bits(res.value) == _bits(ref.value)
    assert res.iterations == ref.iterations and res.reason == ref.reason
    assert all(z.dim() == 2 and z.shape[0] == 1 for z in holder)


def test_grid_lbfgs_matches_sequential_and_selects_same(problem):
    sobj = _sobj(problem)
    d = problem[0].shape[1]
    l2s = [0.3, 3.0, 30.0]
    seq = [minimize_lbfgs_glm_streaming(sobj, torch.zeros(d, dtype=F64),
                                        l2, max_iter=25) for l2 in l2s]
    grid = minimize_lbfgs_glm_grid_streaming(sobj, _x0s(3, d), l2s,
                                             max_iter=25)
    for gi, (s, g) in enumerate(zip(seq, grid)):
        assert g.iterations == s.iterations, gi
        assert g.reason == s.reason, gi
        np.testing.assert_allclose(g.x.numpy(), s.x.numpy(), rtol=2e-3,
                                   atol=1e-4)
    assert int(np.argmin([float(r.value) for r in grid])) == \
        int(np.argmin([float(r.value) for r in seq]))


def test_grid_tron_parity_bounds(problem):
    sobj = _sobj(problem)
    d = problem[0].shape[1]
    l2s = [0.3, 3.0]
    seq = [minimize_tron_streaming(sobj, torch.zeros(d, dtype=F64), l2,
                                   max_iter=10) for l2 in l2s]
    grid = minimize_tron_grid_streaming(sobj, _x0s(2, d), l2s, max_iter=10)
    for gi, (s, g) in enumerate(zip(seq, grid)):
        np.testing.assert_allclose(g.x.numpy(), s.x.numpy(), rtol=1e-3,
                                   atol=1e-3, err_msg=str(gi))
    assert int(np.argmin([float(r.value) for r in grid])) == \
        int(np.argmin([float(r.value) for r in seq]))


def test_all_rows_identical_lambda_converge_together(problem):
    sobj = _sobj(problem)
    res = minimize_lbfgs_glm_grid_streaming(
        sobj, _x0s(3, problem[0].shape[1]), [2.0, 2.0, 2.0], max_iter=20)
    assert len({int(r.iterations) for r in res}) == 1
    assert len({int(r.reason) for r in res}) == 1
    assert _bits(res[0].x) == _bits(res[1].x) == _bits(res[2].x)


def test_max_iters_row_rides_along_frozen(problem):
    sobj = _sobj(problem)
    d = problem[0].shape[1]
    l2s = [1e-4, 50.0]
    res = minimize_lbfgs_glm_grid_streaming(sobj, _x0s(2, d), l2s,
                                            max_iter=4, tol=1e-9)
    assert res[0].reason == int(ConvergenceReason.MAX_ITERATIONS)
    assert res[0].iterations == 4
    for gi, l2 in enumerate(l2s):
        s = minimize_lbfgs_glm_streaming(sobj, torch.zeros(d, dtype=F64),
                                         l2, max_iter=4, tol=1e-9)
        assert res[gi].iterations == s.iterations, gi
        np.testing.assert_allclose(res[gi].x.numpy(), s.x.numpy(),
                                   rtol=2e-3, atol=1e-4)


def test_frozen_rows_keep_their_bits(problem):
    """t == 0 rows keep margins bit for bit, -0.0 and against a
    non-finite direction too."""
    sobj = _sobj(problem)
    z = [torch.tensor([[-0.0, 1.5, 2.0], [3.0, -0.0, 4.0]], dtype=F64)]
    zp = [torch.tensor([[1.0, 2.0, 3.0], [float("nan"), 1.0,
                                          float("inf")]], dtype=F64)]
    out = sobj.grid_update_margins(z, torch.tensor([0.5, 0.0], dtype=F64),
                                   zp)[0]
    assert _bits(out[1]) == _bits(z[0][1])
    assert torch.equal(out[0], z[0][0] + 0.5 * zp[0][0])


def test_poisoned_lambda_diverges_row_isolated(problem):
    sobj = _sobj(problem)
    with pytest.raises(SolverDivergedError) as exc:
        minimize_lbfgs_glm_grid_streaming(
            sobj, _x0s(3, problem[0].shape[1]), [0.5, float("nan"), 2.0],
            max_iter=10)
    err = exc.value
    assert err.grid_row == 1 and np.isnan(err.lam)
    assert "grid row 1" in str(err)


def test_feature_passes_independent_of_grid_width(problem):
    d = problem[0].shape[1]
    epochs, passes = {}, {}
    for G in (2, 4):
        sobj = _sobj(problem, budget=8_000)
        base = sobj.cache.stats()["epochs"]
        minimize_lbfgs_glm_grid_streaming(
            sobj, _x0s(G, d), np.geomspace(0.5, 50.0, G), max_iter=8,
            tol=0.0)
        epochs[G] = sobj.cache.stats()["epochs"] - base
        passes[G] = sobj.grid_passes
        assert sobj.cache.stats()["evictions"] > 0
    assert epochs[2] == epochs[4] == passes[2] == passes[4] > 0


def _cfg(l2, optimizer="LBFGS", max_iterations=12, reg="L2"):
    return f"{max_iterations},1e-7,{l2},1.0,{optimizer},{reg}"


def test_solve_fixed_effect_grid_matches_sequential_coordinate(problem):
    cache = DeviceShardCache.from_stream(FakeStream(problem, 96), "g",
                                         dtype=F64, device="cpu")
    configs = [GLMOptimizationConfiguration.parse(_cfg(l2))
               for l2 in (0.5, 5.0)]
    holder = []
    coord = StreamingFixedEffectCoordinate(
        name="fixed", cache=cache, feature_shard_id="g",
        task_type=TaskType.LOGISTIC_REGRESSION, config=configs[0],
        dtype=F64)
    pairs = solve_fixed_effect_grid(coord, configs, margins_out=holder)
    shared = coord.sharded_objective
    for gi, cfg in enumerate(configs):
        seq = StreamingFixedEffectCoordinate(
            name="fixed", cache=cache, feature_shard_id="g",
            task_type=TaskType.LOGISTIC_REGRESSION, config=cfg, dtype=F64,
            sharded_objective=shared)
        seq_holder = []
        _, seq_res = seq.solve(None, margins_out=seq_holder)
        model, res = pairs[gi]
        np.testing.assert_allclose(model.glm.coefficients.means.numpy(),
                                   seq_res.x.numpy(), rtol=2e-3, atol=1e-4)
        assert res.iterations == seq_res.iterations
        for zr, zs in zip(shared.grid_row_margins(holder, gi), seq_holder):
            np.testing.assert_allclose(zr.numpy(), zs.numpy(), rtol=2e-3,
                                       atol=1e-3)
        np.testing.assert_allclose(
            shared.host_scores_from_margins(
                shared.grid_row_margins(holder, gi)),
            shared.host_scores_from_margins(seq_holder), rtol=2e-3,
            atol=1e-3)


@pytest.mark.parametrize("grid", [
    [], [_cfg(0.5), _cfg(5.0)], [_cfg(0.5), _cfg(5.0, optimizer="TRON")],
    [_cfg(0.5), _cfg(5.0, max_iterations=30)], [_cfg(0.5, reg="L1")],
    ["12,1e-7,0.5,0.5,LBFGS,L2"], [_cfg(0.5), _cfg(0.5)],
    [_cfg(1.0, optimizer="TRON"), _cfg(2.0, optimizer="TRON")]])
def test_grid_batchable_answers_as_jax(grid):
    mine = grid_batchable([GLMOptimizationConfiguration.parse(c)
                           for c in grid])
    want = jax_coords.grid_batchable(
        [jax_config.GLMOptimizationConfiguration.parse(c) for c in grid])
    assert mine == want


@pytest.mark.parametrize("n", [1, 4, 8])
def test_csr_matmul_plain_against_row9_plain(problem, n):
    X = problem[0]
    crow = torch.as_tensor(X.indptr, dtype=torch.int32)
    col = torch.as_tensor(X.indices, dtype=torch.int32)
    val = torch.as_tensor(X.data)
    x = torch.as_tensor(np.random.default_rng(n).normal(size=(X.shape[1],
                                                              n)))
    got = spmv.csr_matmul(crow, col, val, x, X.shape[1])
    assert torch.equal(got, spmv.csr_matmul_plain(crow, col, val, x,
                                                  X.shape[1]))
    for j in range(n):
        np.testing.assert_allclose(
            got[:, j].numpy(),
            spmv.csr_matvec_plain(crow, col, val, x[:, j].contiguous(),
                                  X.shape[1]).numpy(), rtol=1e-13,
            atol=1e-15)
    np.testing.assert_allclose(got.numpy(), X @ x.numpy(), rtol=1e-13,
                               atol=1e-15)


@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    gen = sd._generator()
    rng = np.random.default_rng(17)
    w, bias = rng.normal(0, 1, 5), rng.normal(0, 1.5, 24)
    root = tmp_path_factory.mktemp("grid_driver")
    train = sd._write(root / "train", gen.game_records(rng, 300, w, bias))
    valid = sd._write(root / "validate", gen.game_records(rng, 150, w, bias))
    data = ["--train-input-dirs", str(train),
            "--validate-input-dirs", str(valid)]
    base = [a for a in sd.BASE if a not in ("--grid-batched", "off")]
    one = [a if a != sd.GRID else "fixed:50,1e-7,1.0,1.0,LBFGS,L2"
           for a in base]
    runs = {"root": root}
    for tag, argv in (("on", [*base, "--grid-batched", "on"]),
                      ("auto", base),
                      ("one-on", [*one, "--grid-batched", "on"]),
                      ("one-off", [*one, "--grid-batched", "off"])):
        runs[tag] = game_training_driver.run(
            [*data, *argv, *sd.SPILL, "--output-dir", str(root / tag)],
            device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        runs["jax-on"] = sd._jax_run(
            [*data, *base, "--grid-batched", "on", *sd.SPILL,
             "--output-dir", str(root / "jax-on")], mp)
    return runs


@pytest.mark.parametrize("mode", ["on", "auto"])
def test_driver_grid_batched_matches_jax(driver_runs, mode):
    mine, jax = driver_runs[mode], driver_runs["jax-on"]
    assert mine["stream_train"]["grid_batched"] is True
    assert jax["stream_train"]["grid_batched"] is True
    assert mine["stream_train"]["grid_points"] == 3
    assert mine["bestConfigs"] == jax["bestConfigs"]
    np.testing.assert_allclose(mine["objectiveHistory"],
                               jax["objectiveHistory"], rtol=1e-8)
    got = sd._means(driver_runs["root"] / mode)
    want = sd._means(driver_runs["root"] / "jax-on")
    assert set(got) == set(want)
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys],
                               [want[k] for k in keys], rtol=1e-8,
                               atol=1e-12)


def test_driver_one_point_grid_is_the_sequential_model(driver_runs):
    assert driver_runs["one-on"]["stream_train"]["grid_batched"] is True
    assert driver_runs["one-off"]["stream_train"]["grid_batched"] is False
    assert sd._records(driver_runs["root"] / "one-on") == sd._records(
        driver_runs["root"] / "one-off")
