"""Parity: feature statistics, normalization contexts, the gathered
per-entity transforms and the normalized GLM objective against the JAX
package, float64. Statistics and contexts exactly equal; gathers and
space round trips rtol 1e-12; objective value, gradient and TRON
Hessian-vector products rtol 1e-10 on dense and CSR features."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.data import normalization as jnorm
from photon_ml_tpu.data.stats import (
    BasicStatisticalSummary as JaxSummary,
    EmptyDatasetError as JaxEmptyDatasetError,
)
from photon_ml_tpu.ops.features import (
    DenseFeatures as JaxDense,
    features_to_device as jax_features_to_device,
)
from photon_ml_tpu.ops.glm_objective import (
    GLMObjective as JaxObjective,
    make_batch as jax_make_batch,
)
from photon_ml_tpu.ops.losses import loss_for_task as jax_loss_for_task
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.data import normalization as norm
from photon_ml_tpu_torch.data.stats import (
    BasicStatisticalSummary,
    EmptyDatasetError,
)
from photon_ml_tpu_torch.ops.features import DenseFeatures, features_to_device
from photon_ml_tpu_torch.ops.glm_objective import GLMObjective, make_batch
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.types import NormalizationType, TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


def _matrix(seed=31, n=60, d=7, sparse=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 3.0, (n, d))
    x[:, 2] = 4.0  # a constant column: std 0 -> factor 1
    x[:, -1] = 1.0  # the intercept
    if sparse:
        x[np.abs(x) < 2.5] = 0.0
        return sp.csr_matrix(x)
    return x


@pytest.mark.parametrize("sparse", [False, True])
def test_summary_matches_jax_exactly(sparse):
    x = _matrix(sparse=sparse)
    got, want = BasicStatisticalSummary.compute(x), JaxSummary.compute(x)
    for field in ("mean", "variance", "num_nonzeros", "max", "min",
                  "norm_l1", "norm_l2", "mean_abs"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert got.count == want.count
    with pytest.raises(EmptyDatasetError):
        BasicStatisticalSummary.compute(np.zeros((0, 3)))
    with pytest.raises(JaxEmptyDatasetError):
        JaxSummary.compute(np.zeros((0, 3)))


@pytest.mark.parametrize("kind", list(NormalizationType))
def test_context_matches_jax_exactly(kind):
    x = _matrix()
    icpt = x.shape[1] - 1
    got = norm.build_normalization_context(
        kind, BasicStatisticalSummary.compute(x), icpt, device="cpu")
    want = jnorm.build_normalization_context(
        kind.value, JaxSummary.compute(x), icpt)
    assert got.intercept_id == want.intercept_id
    for a, b in ((got.factors, want.factors), (got.shifts, want.shifts)):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == torch.float32 and b.dtype == jnp.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="intercept"):
        norm.build_normalization_context(
            "STANDARDIZATION", BasicStatisticalSummary.compute(x), -1,
            device="cpu")


def _contexts(x):
    icpt = x.shape[1] - 1
    summary = BasicStatisticalSummary.compute(x)
    return (norm.build_normalization_context("STANDARDIZATION", summary,
                                             icpt, device="cpu"),
            jnorm.build_normalization_context("STANDARDIZATION",
                                              JaxSummary.compute(x), icpt))


def test_gathers_and_space_round_trips_match_jax():
    x = _matrix()
    ctx, jctx = _contexts(x)
    d_global = x.shape[1]
    rng = np.random.default_rng(32)
    feat_idx = np.full((5, 4), -1, np.int32)
    for e in range(5):  # each entity: some columns plus the intercept
        cols = np.sort(np.append(rng.choice(d_global - 1, e % 3 + 1,
                                            replace=False), d_global - 1))
        feat_idx[e, :len(cols)] = cols
    feat_idx[4] = -1  # an all-padding entity is exempt
    got = norm.gather_normalization(ctx, torch.as_tensor(feat_idx))
    want = jnorm.gather_normalization(jctx, jnp.asarray(feat_idx))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got[0].numpy()[feat_idx < 0], 1.0)
    np.testing.assert_array_equal(got[1].numpy()[feat_idx < 0], 0.0)

    coef = rng.normal(0, 1, (5, 4))
    t_arrays = [a.to(torch.float64) for a in got]
    j_arrays = [jnp.asarray(a, jnp.float64) for a in want]
    for to_norm in (True, False):
        fn = (norm.gathered_to_normalized_space if to_norm
              else norm.gathered_to_original_space)
        jfn = (jnorm.gathered_to_normalized_space if to_norm
               else jnorm.gathered_to_original_space)
        np.testing.assert_allclose(
            fn(torch.as_tensor(coef), *t_arrays).numpy(),
            np.asarray(jfn(jnp.asarray(coef), *j_arrays)), rtol=1e-12)
    back = norm.gathered_to_original_space(
        norm.gathered_to_normalized_space(torch.as_tensor(coef), *t_arrays),
        *t_arrays)
    np.testing.assert_allclose(back.numpy(), coef, rtol=1e-12, atol=1e-14)

    c = torch.as_tensor(rng.normal(0, 1, d_global))
    ctx64 = ctx.to("cpu", torch.float64)
    for name in ("model_to_normalized_space", "model_to_original_space"):
        np.testing.assert_allclose(
            getattr(ctx64, name)(c).numpy(),
            np.asarray(getattr(jctx, name)(jnp.asarray(c.numpy()))),
            rtol=1e-12)
    bad = feat_idx.copy()
    bad[0, :] = [0, 1, -1, -1]  # no intercept column
    with pytest.raises(ValueError, match="intercept"):
        norm.gather_normalization(ctx, torch.as_tensor(bad))


@pytest.mark.parametrize("features", ["dense", "csr"])
@pytest.mark.parametrize("task", [TaskType.LOGISTIC_REGRESSION,
                                  TaskType.POISSON_REGRESSION])
def test_normalized_objective_matches_jax(features, task):
    x = _matrix(seed=33, n=80, sparse=features == "csr")
    dense = x.toarray() if sp.issparse(x) else x
    ctx, jctx = _contexts(dense)
    rng = np.random.default_rng(34)
    y = (rng.poisson(1.0, dense.shape[0]) if task == TaskType.POISSON_REGRESSION
         else rng.random(dense.shape[0]) < 0.4).astype(np.float64)
    off = rng.normal(0, 0.1, dense.shape[0])
    if features == "csr":
        feats = features_to_device(x, torch.float64, "cpu",
                                   dense_threshold=1.0)
        jfeats = jax_features_to_device(x, jnp.float64, dense_threshold=1.0)
        assert not isinstance(feats, DenseFeatures)
    else:
        feats, jfeats = DenseFeatures(torch.as_tensor(x)), JaxDense(
            jnp.asarray(x))
    obj = GLMObjective(loss_for_task(task), ctx.to("cpu", torch.float64))
    jobj = JaxObjective(jax_loss_for_task(JaxTaskType(task.value)), jctx)
    batch = make_batch(feats, torch.as_tensor(y), torch.as_tensor(off))
    jbatch = jax_make_batch(jfeats, jnp.asarray(y), jnp.asarray(off))
    coef = rng.normal(0, 0.2, dense.shape[1])
    vec = rng.normal(0, 1, dense.shape[1])
    c, jc = torch.as_tensor(coef), jnp.asarray(coef)
    f, g = obj.value_and_grad(c, batch, 0.7)
    jf, jg = jobj.value_and_grad(jc, jbatch, 0.7)
    np.testing.assert_allclose(float(f), float(jf), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-12)
    hv = obj.make_tron_hvp(c, batch, 0.7)(torch.as_tensor(vec))
    jhv = jobj.make_tron_hvp(jc, jbatch, 0.7)(jnp.asarray(vec))
    np.testing.assert_allclose(hv.numpy(), np.asarray(jhv), rtol=1e-10,
                               atol=1e-12)
    # The normalized objective is the plain one on x' = (x - shift) factor.
    xn = (dense - ctx.shifts.double().numpy()) * ctx.factors.double().numpy()
    plain = GLMObjective(loss_for_task(task)).value(
        c, make_batch(DenseFeatures(torch.as_tensor(xn)),
                      torch.as_tensor(y), torch.as_tensor(off)), 0.7)
    np.testing.assert_allclose(float(f), float(plain), rtol=1e-10)
