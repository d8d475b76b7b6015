"""Parity: the port's ``solve_glm`` routes to OWL-QN, TRON and, with box
constraints, bounded TRON and the projected L-BFGS as the JAX
``solve_glm`` does, and every solver matches the JAX one on a dense
batch, float64: equal iterations and stop reason, value rtol 1e-10,
coefficients atol 1e-8, for OWL-QN equal exact-zero sets and with bounds
equal sets of coefficients at a bound. The box-constraint helpers
(``parse_constraint_string``, ``constraint_arrays``) give exactly the
JAX package's results."""

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
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


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


def _solve_both(task, x, y, off, cfg_string, normalized=False,
                bounds=(None, None)):
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
    opt = lambda a, f: None if a is None else f(a)
    res = solve_glm(GLMObjective(loss_for_task(task), norm),
                    make_batch(DenseFeatures(torch.as_tensor(x)),
                               torch.as_tensor(y), torch.as_tensor(off)),
                    cfg, torch.zeros(x.shape[1], dtype=torch.float64),
                    *(opt(b, torch.as_tensor) for b in bounds))
    ref = jax_solve_glm(
        JaxObjective(jax_loss_for_task(JaxTaskType(task.value)), jnorm),
        jax_make_batch(JaxDense(jnp.asarray(x)), jnp.asarray(y),
                       jnp.asarray(off)),
        jcfg, jnp.zeros(x.shape[1]),
        *(opt(b, jnp.asarray) for b in bounds))
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


def _box(d, seed):
    rng = np.random.default_rng(seed)
    lo, hi = -rng.uniform(0.05, 0.2, d), rng.uniform(0.05, 0.2, d)
    lo[-1], hi[-1] = -np.inf, np.inf  # the intercept is free
    return lo, hi


@pytest.mark.parametrize("cfg", ["15,1e-7,1.0,1.0,TRON,L2",
                                 "60,1e-9,1.0,1.0,LBFGS,L2"])
@pytest.mark.parametrize("sides", ["both", "upper"])
def test_bounded_solves_match_jax(cfg, sides):
    """Bounded TRON (active-set CG, projected trial, model on the realized
    step) and the projected L-BFGS (minimize_lbfgs), with a box on both
    sides or only an upper bound."""
    x, y, off = _problem(TaskType.LOGISTIC_REGRESSION, seed=25)
    lo, hi = _box(x.shape[1], seed=26)
    if sides == "upper":
        lo = None
    res, ref = _solve_both(TaskType.LOGISTIC_REGRESSION, x, y, off, cfg,
                           bounds=(lo, hi))
    c, jc = res.x.numpy(), np.asarray(ref.x)
    lo_ = -np.inf if lo is None else lo
    assert ((c >= lo_) & (c <= hi)).all()
    pinned = (c == lo_) | (c == hi)
    assert pinned.any()
    np.testing.assert_array_equal(pinned, (jc == lo_) | (jc == hi))
    if "TRON" in cfg:
        assert res.outer_steps >= int(res.iterations) >= 2


def test_bounded_tron_on_a_normalized_objective_matches_jax():
    """The bounds clamp the normalized iterate as they are."""
    x, y, off = _problem(TaskType.LOGISTIC_REGRESSION, seed=27, scale=7.0)
    _solve_both(TaskType.LOGISTIC_REGRESSION, x, y, off,
                "15,1e-5,1.0,1.0,TRON,L2", normalized=True,
                bounds=_box(x.shape[1], seed=28))


CONSTRAINTS = [
    # an exact (name, term) entry, a missing term, a one-sided bound and
    # a key the index map lacks
    [{"name": "age", "term": "", "lowerBound": -1.0, "upperBound": 2.0},
     {"name": "city", "term": "sf", "upperBound": 0.5},
     {"name": "nope", "term": "x", "lowerBound": 0.0, "upperBound": 1.0}],
    # name and term wildcards, then {"*", "*"} for every other feature
    [{"name": "city", "term": "*", "lowerBound": -0.3, "upperBound": 0.3},
     {"name": "*", "term": "b", "lowerBound": -2.0, "upperBound": -1.0},
     {"name": "*", "term": "*", "lowerBound": -0.1, "upperBound": 0.1}],
    [],
]


@pytest.mark.parametrize("spec", CONSTRAINTS)
def test_constraint_helpers_match_jax(spec):
    import json

    from photon_ml_tpu.data.index_map import IndexMap, INTERCEPT_KEY

    pairs = [("age", ""), ("city", "sf"), ("city", "nyc"), ("tag", "b"),
             ("tag", "c")]
    jmap = IndexMap.from_name_terms(pairs, add_intercept=True)
    index_map = dict(jmap.items())  # {(name, term): index}
    assert len(index_map) == len(pairs) + 1
    text = json.dumps(spec)
    got = config.parse_constraint_string(text, index_map)
    want = jax_config.parse_constraint_string(text, jmap)
    assert got == want
    intercept = jmap.get_index(INTERCEPT_KEY)
    lo, hi = config.constraint_arrays(got, len(index_map), intercept)
    jlo, jhi = jax_config.constraint_arrays(want, len(index_map), intercept)
    if not spec:
        assert lo is None and hi is None and jlo is None and jhi is None
        return
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    assert lo[intercept] == -np.inf and hi[intercept] == np.inf


def test_constraint_string_rejects_an_empty_box():
    spec = '[{"name": "a", "term": "", "lowerBound": 1, "upperBound": 0}]'
    with pytest.raises(ValueError, match="lowerBound"):
        config.parse_constraint_string(spec, {("a", ""): 0})
