"""Parity: the port's ``solve_glm`` routes to OWL-QN and TRON as the JAX
``solve_glm`` does, and both solvers match the JAX ones on a dense batch,
float64: equal iterations and stop reason, value rtol 1e-10,
coefficients atol 1e-8, and for OWL-QN equal exact-zero sets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data.normalization import (
    build_normalization_context as jax_build_context,
)
from photon_ml_tpu.data.stats import (
    BasicStatisticalSummary as JaxSummary,
)
from photon_ml_tpu.ops.features import DenseFeatures as JaxDense
from photon_ml_tpu.ops.glm_objective import (
    GLMObjective as JaxObjective,
    make_batch as jax_make_batch,
)
from photon_ml_tpu.ops.losses import loss_for_task as jax_loss_for_task
from photon_ml_tpu.optimization import config as jax_config
from photon_ml_tpu.optimization.solver import solve_glm as jax_solve_glm
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.data.normalization import build_normalization_context
from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary
from photon_ml_tpu_torch.ops.features import DenseFeatures
from photon_ml_tpu_torch.ops.glm_objective import GLMObjective, make_batch
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.optimization import config
from photon_ml_tpu_torch.optimization.solver import solve_glm
from photon_ml_tpu_torch.types import TaskType


def _problem(task, seed, n=300, d=10, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, scale, (n, d))
    x[:, -1] = 1.0
    z = x @ rng.normal(0, 0.4, d) / max(scale, 1.0)
    if task == TaskType.POISSON_REGRESSION:
        y = rng.poisson(np.exp(np.clip(z, -3, 2))).astype(np.float64)
    else:
        y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return x, y, rng.normal(0, 0.1, n)


def _solve_both(task, x, y, off, cfg_string, normalized=False):
    cfg = config.GLMOptimizationConfiguration.parse(cfg_string)
    jcfg = jax_config.GLMOptimizationConfiguration.parse(cfg_string)
    norm = jnorm = None
    if normalized:
        norm = build_normalization_context(
            "STANDARDIZATION", BasicStatisticalSummary.compute(x),
            intercept_id=x.shape[1] - 1, device="cpu").to("cpu",
                                                          torch.float64)
        jnorm = jax_build_context("STANDARDIZATION", JaxSummary.compute(x),
                                  intercept_id=x.shape[1] - 1)
    res = solve_glm(GLMObjective(loss_for_task(task), norm),
                    make_batch(DenseFeatures(torch.as_tensor(x)),
                               torch.as_tensor(y), torch.as_tensor(off)),
                    cfg, torch.zeros(x.shape[1], dtype=torch.float64))
    ref = jax_solve_glm(
        JaxObjective(jax_loss_for_task(JaxTaskType(task.value)), jnorm),
        jax_make_batch(JaxDense(jnp.asarray(x)), jnp.asarray(y),
                       jnp.asarray(off)),
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
    return res, ref


def test_elastic_net_owlqn_matches_jax_with_equal_zero_sets():
    x, y, off = _problem(TaskType.LOGISTIC_REGRESSION, seed=21)
    res, ref = _solve_both(TaskType.LOGISTIC_REGRESSION, x, y, off,
                           "60,1e-9,12.0,1.0,LBFGS,ELASTIC_NET,0.5")
    zeros = res.x.numpy() == 0.0
    assert zeros.any() and not zeros.all()
    np.testing.assert_array_equal(zeros, np.asarray(ref.x) == 0.0)


@pytest.mark.parametrize("task", [TaskType.LOGISTIC_REGRESSION,
                                  TaskType.POISSON_REGRESSION])
def test_tron_matches_jax(task):
    x, y, off = _problem(task, seed=22)
    res, _ = _solve_both(task, x, y, off, "15,1e-7,1.0,1.0,TRON,L2")
    assert res.outer_steps >= int(res.iterations) >= 2
    assert res.cg_steps >= res.outer_steps


def test_tron_on_a_normalized_objective_matches_jax():
    """Badly scaled features, STANDARDIZATION with the intercept last: the
    margins, gradient and Hessian products all take the normalization
    algebra."""
    x, y, off = _problem(TaskType.LOGISTIC_REGRESSION, seed=23, scale=7.0)
    _solve_both(TaskType.LOGISTIC_REGRESSION, x, y, off,
                "15,1e-5,1.0,1.0,TRON,L2", normalized=True)


@pytest.mark.parametrize("cfg,error", [
    ("10,1e-6,1.0,1.0,TRON,ELASTIC_NET,0.5", ValueError),
    ("10,1e-6,1.0,1.0,TRON,L2", ValueError),
])
def test_tron_rejects_what_jax_rejects(cfg, error):
    """TRON refuses L1 and a loss that is not twice differentiable (the
    smoothed hinge), as the JAX solve_glm does."""
    x, y, off = _problem(TaskType.LOGISTIC_REGRESSION, seed=24, n=20, d=3)
    task = (TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM if "L2" in cfg
            else TaskType.LOGISTIC_REGRESSION)
    with pytest.raises(error):
        solve_glm(GLMObjective(loss_for_task(task)),
                  make_batch(DenseFeatures(torch.as_tensor(x)),
                             torch.as_tensor(y)),
                  config.GLMOptimizationConfiguration.parse(cfg),
                  torch.zeros(3, dtype=torch.float64))
