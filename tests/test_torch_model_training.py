"""The port's GLM λ-grid training (estimators/model_training.py) and what
it reaches, against the JAX package, float64 on the CPU:

- ``train_glm_models`` for each solver route (L-BFGS, TRON, OWL-QN with
  an elastic net, projected L-BFGS with boxes), warm-started over a
  descending grid with STANDARDIZATION and variances: equal iterations and
  reasons per λ, values rtol 1e-10, means and variances atol 1e-8;
- ``hessian_diagonal`` and ``coefficient_variances`` on dense and CSR
  features, with and without a normalization context: rtol 1e-12;
- ``track_models``: ModelTracker states and per-iteration models equal
  to JAX's (rtol 1e-10 / atol 1e-8), and tracking on or off giving the
  same solve bit for bit, for every solver;
- bfloat16 dense storage against JAX's at float64 accumulation: the
  products rtol 1e-12, and the grid's values rtol 1e-10;
- ``sparse_layout`` names accepted (each builds CSR) and a typo rejected;
- ``CoefficientSummary`` and ``summarize_coefficients``.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.data.normalization import (
    build_normalization_context as jax_build_norm,
)
from photon_ml_tpu.data.stats import BasicStatisticalSummary as JaxSummary
from photon_ml_tpu.estimators import model_training as jax_mt
from photon_ml_tpu.models import tracking as jax_tracking
from photon_ml_tpu.ops import features as jax_features
from photon_ml_tpu.ops.glm_objective import (
    GLMObjective as JaxObjective,
    make_batch as jax_make_batch,
)
from photon_ml_tpu.ops.losses import LogisticLoss as JaxLogistic
from photon_ml_tpu.optimization import config as jax_config
from photon_ml_tpu_torch.data.normalization import build_normalization_context
from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary
from photon_ml_tpu_torch.estimators import model_training
from photon_ml_tpu_torch.models import tracking
from photon_ml_tpu_torch.ops import features
from photon_ml_tpu_torch.ops.glm_objective import GLMObjective, make_batch
from photon_ml_tpu_torch.ops.losses import LogisticLoss
from photon_ml_tpu_torch.optimization import config
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

LAMBDAS = [10.0, 0.1, 1.0]  # not sorted: results come back in this order


def _problem(seed=3, n=240, d=7, sparse=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.4, 1.3, (n, d))
    if sparse:
        x[rng.random((n, d)) < 0.97] = 0.0
    x[:, -1] = 1.0
    w = rng.normal(0, 0.8, d)
    y = (rng.random(n) < 1 / (1 + np.exp(-x @ w))).astype(np.float64)
    off = rng.normal(0, 0.2, n)
    wt = rng.uniform(0.5, 1.5, n)
    return (sp.csr_matrix(x) if sparse else x), y, off, wt


def _norms(x, kind="STANDARDIZATION", intercept=-1):
    port = build_normalization_context(
        kind, BasicStatisticalSummary.compute(x), intercept, device="cpu")
    ref = jax_build_norm(kind, JaxSummary.compute(x), intercept)
    return port, ref


ROUTES = {
    "lbfgs": dict(optimizer="LBFGS", reg="L2", bounds=False),
    "tron": dict(optimizer="TRON", reg="L2", bounds=False),
    "owlqn": dict(optimizer="LBFGS", reg="ELASTIC_NET", bounds=False),
    "bounded-lbfgs": dict(optimizer="LBFGS", reg="L2", bounds=True),
}


def _train_both(route, track=False, storage=False, with_jax=True):
    """The port's λ grid and JAX's (None with ``with_jax=False``)."""
    spec = ROUTES[route]
    x, y, off, wt = _problem()
    d = x.shape[1]
    norm, jnorm = _norms(x, intercept=d - 1)
    lb = ub = None
    if spec["bounds"]:
        lb, ub = np.full(d, -0.4), np.full(d, 0.4)
        lb[-1], ub[-1] = -np.inf, np.inf
    alpha = 0.5 if spec["reg"] == "ELASTIC_NET" else None
    common = dict(
        regularization_weights=LAMBDAS, max_iterations=40, tolerance=1e-7,
        offsets=off, weights=wt, lower_bounds=lb, upper_bounds=ub,
        compute_variances=True, track_models=track)
    port = model_training.train_glm_models(
        x, y, TaskType.LOGISTIC_REGRESSION,
        regularization_context=config.RegularizationContext(
            config.RegularizationType(spec["reg"]), alpha),
        optimizer_type=config.OptimizerType(spec["optimizer"]),
        normalization=norm, dtype=torch.float64,
        storage_dtype=torch.bfloat16 if storage else None, device="cpu",
        **common)
    if not with_jax:
        return port, None
    ref = jax_mt.train_glm_models(
        x, y, jax_mt.TaskType.LOGISTIC_REGRESSION,
        regularization_context=jax_config.RegularizationContext(
            jax_config.RegularizationType(spec["reg"]), alpha),
        optimizer_type=jax_config.OptimizerType(spec["optimizer"]),
        normalization=jnorm, dtype=jnp.float64,
        storage_dtype=jnp.bfloat16 if storage else None, **common)
    return port, ref


def _assert_grid_equal(port, ref, value_rtol=1e-10):
    assert [t.reg_weight for t in port] == LAMBDAS
    assert [t.reg_weight for t in ref] == LAMBDAS
    for p, r in zip(port, ref):
        lam = p.reg_weight
        assert int(p.result.iterations) == int(r.result.iterations), lam
        assert p.result.reason_enum().name == r.result.reason_enum().name
        np.testing.assert_allclose(float(p.result.value),
                                   float(r.result.value), rtol=value_rtol,
                                   err_msg=str(lam))
        pm, pv = p.model.coefficients.to_numpy()
        rm, rv = r.model.coefficients.to_numpy()
        np.testing.assert_allclose(pm, rm, rtol=0, atol=1e-8,
                                   err_msg=str(lam))
        np.testing.assert_allclose(pv, rv, rtol=0, atol=1e-8,
                                   err_msg=str(lam))
        assert p.model.model_class_name == type(r.model).__name__


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_train_glm_models_matches_jax(route):
    port, ref = _train_both(route)
    _assert_grid_equal(port, ref)
    assert all(t.tracker is None for t in port)
    if route == "owlqn":
        zeros = [int((t.result.x == 0).sum()) for t in port]
        assert zeros == [int((np.asarray(t.result.x) == 0).sum())
                         for t in ref]
        assert max(zeros) > 0


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_tracked_models_match_jax_and_leave_the_solve_alone(route):
    port, ref = _train_both(route, track=True)
    _assert_grid_equal(port, ref)
    for p, r in zip(port, ref):
        pt, rt = p.tracker, r.tracker
        assert pt.convergence_reason.name == rt.convergence_reason.name
        assert [s.iteration for s in pt.states] == \
            [s.iteration for s in rt.states]
        np.testing.assert_allclose([s.value for s in pt.states],
                                   [s.value for s in rt.states], rtol=1e-10)
        np.testing.assert_allclose([s.grad_norm for s in pt.states],
                                   [s.grad_norm for s in rt.states],
                                   rtol=1e-8, atol=1e-10)
        assert len(pt.models) == len(rt.models) == pt.num_iterations + 1
        np.testing.assert_allclose(
            np.stack([m.coefficients.to_numpy()[0] for m in pt.models]),
            np.stack([np.asarray(m.coefficients.means) for m in rt.models]),
            rtol=0, atol=1e-8)
        hist = p.result.coef_history
        assert hist.shape == (41, 7)
        assert torch.isnan(hist[pt.num_iterations + 1:]).all()
        assert torch.equal(hist[pt.num_iterations], p.result.x)
    # The same solve with tracking off, bit for bit.
    untracked, _ = _train_both(route, with_jax=False)
    for p, u in zip(port, untracked):
        assert torch.equal(p.result.x, u.result.x)
        assert torch.equal(p.result.value, u.result.value)
        for name in ("value_history", "grad_norm_history"):
            torch.testing.assert_close(
                getattr(p.result, name), getattr(u.result, name), rtol=0,
                atol=0, equal_nan=True)
        assert int(p.result.iterations) == int(u.result.iterations)
        assert int(p.result.reason) == int(u.result.reason)
        assert u.result.coef_history is None


def _objectives(x, sparse, normalized):
    _, y, off, wt = _problem(sparse=sparse)
    d = x.shape[1]
    norm = jnorm = None
    if normalized:
        norm, jnorm = _norms(x, intercept=d - 1)
        norm = norm.to("cpu", torch.float64)
    if sparse:
        feats = features.csr_from_scipy(x, torch.float64, device="cpu")
        jfeats = jax_features.csr_from_scipy(x, dtype=jnp.float64)
    else:
        feats = features.DenseFeatures(torch.as_tensor(x))
        jfeats = jax_features.DenseFeatures(jnp.asarray(x))
    batch = make_batch(feats, torch.as_tensor(y), torch.as_tensor(off),
                       torch.as_tensor(wt))
    jbatch = jax_make_batch(jfeats, jnp.asarray(y), jnp.asarray(off),
                            jnp.asarray(wt))
    return (GLMObjective(LogisticLoss, norm), batch,
            JaxObjective(JaxLogistic, jnorm), jbatch)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
@pytest.mark.parametrize("normalized", [False, True],
                         ids=["raw", "standardized"])
def test_hessian_diagonal_and_variances_match_jax(sparse, normalized):
    x = _problem(sparse=sparse)[0]
    obj, batch, jobj, jbatch = _objectives(x, sparse, normalized)
    coef = np.random.default_rng(9).normal(0, 0.5, x.shape[1])
    for l2 in (0.0, 1.5):
        got = obj.hessian_diagonal(torch.as_tensor(coef), batch, l2)
        want = jobj.hessian_diagonal(jnp.asarray(coef), jbatch, l2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12)
        got = obj.coefficient_variances(torch.as_tensor(coef), batch, l2)
        want = jobj.coefficient_variances(jnp.asarray(coef), jbatch, l2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12)
    u = np.random.default_rng(4).normal(size=x.shape[0])
    feats = batch.features
    np.testing.assert_allclose(
        feats.row_sq_matvec(torch.as_tensor(coef)).numpy(),
        np.asarray(jbatch.features.row_sq_matvec(jnp.asarray(coef))),
        rtol=1e-12)
    np.testing.assert_allclose(
        feats.sq_rmatvec(torch.as_tensor(u)).numpy(),
        np.asarray(jbatch.features.sq_rmatvec(jnp.asarray(u))), rtol=1e-12)


def test_bf16_storage_matches_jax_at_float64_accumulation(monkeypatch):
    x = _problem()[0]
    port = features.features_to_device(x, torch.float64, "cpu",
                                       storage_dtype=torch.bfloat16)
    ref = jax_features.features_to_device(x, jnp.float64,
                                          storage_dtype=jnp.bfloat16)
    assert port.x.dtype == torch.bfloat16
    assert np.array_equal(port.x.float().numpy(),
                          np.asarray(ref.x).astype(np.float32))
    assert np.array_equal(port.x.float().numpy(),
                          x.astype(ml_dtypes.bfloat16).astype(np.float32))
    rng = np.random.default_rng(2)
    v, u = rng.normal(size=x.shape[1]), rng.normal(size=x.shape[0])
    # Small chunks, so the widening runs over several row chunks.
    monkeypatch.setattr(features, "UPCAST_CHUNK_ELEMENTS", 7 * 50)
    for name, arg in (("matvec", v), ("rmatvec", u), ("row_sq_matvec", v),
                      ("sq_rmatvec", u)):
        got = getattr(port, name)(torch.as_tensor(arg))
        assert got.dtype == torch.float64, name
        np.testing.assert_allclose(
            got.numpy(), np.asarray(getattr(ref, name)(jnp.asarray(arg))),
            rtol=1e-12, err_msg=name)
    grid, ref_grid = _train_both("lbfgs", storage=True)
    _assert_grid_equal(grid, ref_grid)


@pytest.mark.parametrize("layout", ["csr", "bucketed_ell",
                                    "sort_permute_ell"])
def test_sparse_layout_names_build_csr(layout):
    x = _problem(sparse=True)[0]
    batch = model_training.device_batch(x, np.ones(x.shape[0]),
                                        dtype=torch.float64,
                                        sparse_layout=layout, device="cpu")
    assert isinstance(batch.features, features.CSRFeatures)
    v = torch.linspace(-1, 1, x.shape[1], dtype=torch.float64)
    np.testing.assert_allclose(batch.features.matvec(v).numpy(),
                               x @ v.numpy(), rtol=1e-12)


def test_sparse_layout_typo_is_rejected_like_jax():
    x = _problem()[0]  # dense: the name is checked all the same
    with pytest.raises(ValueError) as port_err:
        model_training.device_batch(x, np.ones(x.shape[0]),
                                    sparse_layout="bucketed-ell",
                                    device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jax_mt.device_batch(x, np.ones(x.shape[0]),
                            sparse_layout="bucketed-ell")
    assert str(port_err.value) == str(jax_err.value)


def test_coefficient_summaries_match_jax():
    rng = np.random.default_rng(8)
    samples = rng.normal(0, 2, (7, 5))
    for column in samples.T:
        got = tracking.CoefficientSummary.of(column)
        want = jax_tracking.CoefficientSummary.of(column)
        assert got.to_dict() == want.to_dict()
        assert str(got) == str(want)
        assert (got.first_quartile(), got.median(), got.third_quartile(),
                got.variance) == (want.first_quartile(), want.median(),
                                  want.third_quartile(), want.variance)
    from photon_ml_tpu.models.coefficients import Coefficients as JaxCoef
    from photon_ml_tpu.models.glm import LogisticRegressionModel as JaxLR
    from photon_ml_tpu_torch.models.coefficients import Coefficients
    from photon_ml_tpu_torch.models.glm import LogisticRegressionModel

    got = tracking.summarize_coefficients(
        [LogisticRegressionModel(Coefficients(torch.as_tensor(r)))
         for r in samples])
    want = jax_tracking.summarize_coefficients(
        [JaxLR(JaxCoef(jnp.asarray(r))) for r in samples])
    assert [s.to_dict() for s in got] == [s.to_dict() for s in want]
    assert tracking.summarize_coefficients([]) == []
    assert tracking.CoefficientSummary().count == 0
