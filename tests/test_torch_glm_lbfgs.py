"""Parity: the port's fixed-effect solver (``solve_glm`` -> the
margin-cached GLM L-BFGS) against the JAX ``solve_glm`` on a dense
logistic batch, float64. Same iterations and stop reason; value rtol
1e-10; coefficients atol 1e-8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops.features import DenseFeatures as JaxDense
from photon_ml_tpu.ops.glm_objective import (
    GLMObjective as JaxObjective,
    make_batch as jax_make_batch,
)
from photon_ml_tpu.ops.losses import LogisticLoss as JaxLogistic
from photon_ml_tpu.optimization import config as jax_config
from photon_ml_tpu.optimization.solver import solve_glm as jax_solve_glm
from photon_ml_tpu_torch.ops.features import DenseFeatures, features_to_device
from photon_ml_tpu_torch.ops.glm_objective import GLMObjective, make_batch
from photon_ml_tpu_torch.ops.losses import LogisticLoss
from photon_ml_tpu_torch.optimization import config
from photon_ml_tpu_torch.optimization.lbfgs import (
    LBFGSHistory,
    compact_direction,
    two_loop_direction,
)
from photon_ml_tpu_torch.optimization.solver import solve_glm
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


def _problem(seed=5, n=400, d=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d))
    x[:, -1] = 1.0
    w = rng.normal(0, 0.7, d)
    y = (rng.random(n) < 1 / (1 + np.exp(-x @ w))).astype(np.float64)
    off = rng.normal(0, 0.2, n)
    return x, y, off


def _configs(max_iter, tol, lam):
    ours = config.GLMOptimizationConfiguration(
        max_iterations=max_iter, tolerance=tol, regularization_weight=lam,
        regularization_context=config.RegularizationContext(
            config.RegularizationType.L2))
    ref = jax_config.GLMOptimizationConfiguration.parse(ours.to_string())
    return ours, ref


@pytest.mark.parametrize("max_iter,tol,lam", [(50, 1e-7, 1.0),
                                              (8, 1e-9, 0.1)])
def test_solve_glm_matches_jax(max_iter, tol, lam):
    x, y, off = _problem()
    cfg, jcfg = _configs(max_iter, tol, lam)
    res = solve_glm(GLMObjective(LogisticLoss),
                    make_batch(DenseFeatures(torch.as_tensor(x)),
                               torch.as_tensor(y), torch.as_tensor(off)),
                    cfg, torch.zeros(x.shape[1], dtype=torch.float64))
    ref = jax_solve_glm(JaxObjective(JaxLogistic),
                        jax_make_batch(JaxDense(jnp.asarray(x)),
                                       jnp.asarray(y), jnp.asarray(off)),
                        jcfg, jnp.zeros(x.shape[1]))
    assert int(res.iterations) == int(ref.iterations)
    assert int(res.reason) == int(ref.reason)
    np.testing.assert_allclose(float(res.value), float(ref.value),
                               rtol=1e-10)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-8)
    k = int(res.iterations) + 1
    np.testing.assert_allclose(res.value_history.numpy()[:k],
                               np.asarray(ref.value_history)[:k],
                               rtol=1e-10)


def test_csr_features_match_dense():
    import scipy.sparse as sp

    x, y, off = _problem(seed=6)
    x[np.abs(x) < 1.2] = 0.0  # ~20% dense: below the dense threshold
    feats = features_to_device(sp.csr_matrix(x), torch.float64, "cpu",
                               dense_threshold=0.5)
    assert not isinstance(feats, DenseFeatures)
    v = torch.linspace(-1, 1, x.shape[1], dtype=torch.float64)
    u = torch.as_tensor(y)
    np.testing.assert_allclose(feats.matvec(v).numpy(), x @ v.numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(feats.rmatvec(u).numpy(), x.T @ y,
                               rtol=1e-12, atol=1e-12)


def test_two_loop_equals_compact_direction():
    rng = np.random.default_rng(7)
    m, d = 4, 6
    s = torch.as_tensor(rng.normal(0, 1, (m, d)))
    yv = s + 0.1 * torch.as_tensor(rng.normal(0, 1, (m, d)))
    rho = 1.0 / torch.sum(s * yv, dim=-1)
    rho[0] = 0.0
    s[0], yv[0] = 0.0, 0.0
    hist = LBFGSHistory(s, yv, rho, torch.tensor(m - 1, dtype=torch.int32))
    g = torch.as_tensor(rng.normal(0, 1, d))
    np.testing.assert_allclose(two_loop_direction(g, hist).numpy(),
                               compact_direction(g, hist).numpy(),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("spec", ["TRON", "OWLQN"])
def test_unported_solvers_raise(spec):
    """Box constraints with an L1 weight raise ValueError, whether TRON
    (which takes no L1) or OWL-QN (which takes no bounds) was asked for,
    as the JAX solve_glm raises (tests/test_torch_owlqn_tron.py holds the
    bounded TRON and L-BFGS solves to JAX)."""
    x, y, off = _problem(n=20, d=3)
    reg = config.RegularizationType.L1
    cfg = config.GLMOptimizationConfiguration(
        max_iterations=5, tolerance=1e-6, regularization_weight=1.0,
        optimizer_type=(config.OptimizerType.TRON if spec == "TRON"
                        else config.OptimizerType.LBFGS),
        regularization_context=config.RegularizationContext(reg))
    bound = torch.full((3,), 5.0, dtype=torch.float64)
    with pytest.raises(ValueError, match="L1"):
        solve_glm(GLMObjective(LogisticLoss),
                  make_batch(DenseFeatures(torch.as_tensor(x)),
                             torch.as_tensor(y)),
                  cfg, torch.zeros(3, dtype=torch.float64),
                  upper_bounds=bound)


def test_config_string_round_trip():
    s = "20,1e-06,1.0,1.0,LBFGS,L2"
    cfg = config.GLMOptimizationConfiguration.parse(s)
    assert cfg.to_string() == jax_config.GLMOptimizationConfiguration.parse(
        s).to_string()
    assert cfg.l2_weight == 1.0 and cfg.l1_weight == 0.0
