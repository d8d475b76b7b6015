"""Parity: the port's per-entity solver (its plain PyTorch version,
which the wrapper runs for CPU tensors) against the JAX package's Pallas
kernel run in interpreter mode, as tests/test_pallas_entity_solver.py
runs it: L-BFGS and OWL-QN, with and without the normalization fold
(TRON and box constraints: test_torch_entity_tron.py).
Float64 on both sides; iterations, stop reasons and exact-zero sets must
be equal, values within rtol 1e-10 and coefficients within atol 1e-8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops.losses import loss_for_task as jax_loss_for_task
from photon_ml_tpu.ops.pallas_entity_solver import pallas_entity_lbfgs
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.ops import entity_solver
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


def _bucket(rng, e, r, d):
    x = rng.normal(0, 1, (e, r, d))
    x[:, :, 0] = 1.0
    w_true = rng.normal(0, 0.5, (e, d))
    z = np.einsum("erd,ed->er", x, w_true)
    y = (rng.random((e, r)) < 1 / (1 + np.exp(-z))).astype(np.float64)
    off = rng.normal(0, 0.1, (e, r))
    w = np.ones((e, r))
    return x, y, off, w


def _both(task, x, y, off, w, coef0, l2, max_iter, tol):
    res_j = pallas_entity_lbfgs(
        jax_loss_for_task(JaxTaskType(task.value)), jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(off), jnp.asarray(w), jnp.asarray(coef0),
        l2, max_iter=max_iter, tol=tol, interpret=True)
    res_t = entity_solver.entity_lbfgs(
        loss_for_task(task), *(torch.as_tensor(a) for a in
                               (x, y, off, w, coef0)),
        l2, max_iter=max_iter, tol=tol)
    return res_j, res_t


def _assert_parity(res_j, res_t):
    np.testing.assert_array_equal(res_t.iterations.numpy(),
                                  np.asarray(res_j.iterations))
    np.testing.assert_array_equal(res_t.reason.numpy(),
                                  np.asarray(res_j.reason))
    np.testing.assert_allclose(res_t.value.numpy(), np.asarray(res_j.value),
                               rtol=1e-10)
    np.testing.assert_allclose(res_t.grad_norm.numpy(),
                               np.asarray(res_j.grad_norm), rtol=1e-6,
                               atol=1e-10)
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x),
                               atol=1e-8)


@pytest.mark.parametrize("task", [TaskType.LOGISTIC_REGRESSION,
                                  TaskType.POISSON_REGRESSION])
def test_plain_solver_matches_pallas_kernel(task):
    rng = np.random.default_rng(11)
    e, r, d = 37, 6, 5
    x, y, off, w = _bucket(rng, e, r, d)
    if task == TaskType.POISSON_REGRESSION:
        y = rng.poisson(2.0, (e, r)).astype(np.float64)
    res_j, res_t = _both(task, x, y, off, w, np.zeros((e, d)), 0.7, 40, 1e-8)
    _assert_parity(res_j, res_t)
    assert res_t.x.shape == (e, d) and res_t.x.dtype == torch.float64


def test_zero_weight_entity_stays_at_coef0():
    rng = np.random.default_rng(12)
    e, r, d = 5, 4, 3
    x, y, off, w = _bucket(rng, e, r, d)
    w[2] = 0.0
    coef0 = rng.normal(0, 0.1, (e, d))
    coef0[2] = 0.0
    res_j, res_t = _both(TaskType.LOGISTIC_REGRESSION, x, y, off, w, coef0,
                         0.5, 20, 1e-7)
    _assert_parity(res_j, res_t)
    assert int(res_t.iterations[2]) == 0
    np.testing.assert_array_equal(res_t.x[2].numpy(), 0.0)


def test_deep_backtracking_tail():
    """Large-scale Poisson features overflow exp in the early trials, so
    the accepted step sits past the first 8 candidates."""
    rng = np.random.default_rng(13)
    e, r, d = 9, 8, 3
    x = rng.normal(0, 1, (e, r, d)) * 30.0
    y = rng.poisson(3.0, (e, r)).astype(np.float64)
    off, w = np.zeros((e, r)), np.ones((e, r))
    res_j, res_t = _both(TaskType.POISSON_REGRESSION, x, y, off, w,
                         np.zeros((e, d)), 0.1, 30, 1e-8)
    _assert_parity(res_j, res_t)


def test_cpu_tensors_do_not_launch_the_kernel():
    rng = np.random.default_rng(14)
    x, y, off, w = (torch.as_tensor(a) for a in _bucket(rng, 4, 5, 3))
    before = entity_solver.entity_lbfgs.launches
    entity_solver.entity_lbfgs(loss_for_task(TaskType.LOGISTIC_REGRESSION),
                               x, y, off, w, torch.zeros((4, 3),
                                                         dtype=x.dtype), 1.0)
    assert entity_solver.entity_lbfgs.launches == before


@pytest.mark.parametrize("dtype,device,error", [
    (torch.float16, "cpu", TypeError),
    (torch.int32, "cpu", TypeError),
    (torch.float32, "meta", ValueError),
])
def test_unsupported_input_raises(dtype, device, error):
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    x = torch.zeros((2, 4, 3), dtype=dtype, device=device)
    rows = torch.zeros((2, 4), dtype=dtype, device=device)
    coef0 = torch.zeros((2, 3), dtype=dtype, device=device)
    before = entity_solver.entity_lbfgs.launches
    with pytest.raises(error):
        entity_solver.entity_lbfgs(loss, x, rows, rows, rows, coef0, 1.0)
    assert entity_solver.entity_lbfgs.launches == before


def test_shape_mismatch_raises():
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    x = torch.zeros((2, 4, 3), dtype=torch.float64)
    rows = torch.zeros((2, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="coef0"):
        entity_solver.entity_lbfgs(loss, x, rows, rows, rows,
                                   torch.zeros((2, 4), dtype=torch.float64),
                                   1.0)


def test_float32_compute():
    """compute_dtype=float32 solves in float32 and returns the input's
    dtype, close to the float64 solve on a well-conditioned bucket."""
    rng = np.random.default_rng(15)
    e, r, d = 6, 20, 4
    x, y, off, w = (torch.as_tensor(a) for a in _bucket(rng, e, r, d))
    args = (loss_for_task(TaskType.LOGISTIC_REGRESSION), x, y, off, w,
            torch.zeros((e, d), dtype=x.dtype), 1.0)
    res64 = entity_solver.entity_lbfgs(*args, max_iter=30, tol=1e-6)
    res32 = entity_solver.entity_lbfgs(*args, max_iter=30, tol=1e-6,
                                       compute_dtype=torch.float32)
    assert res32.x.dtype == torch.float64
    np.testing.assert_allclose(res32.value.numpy(), res64.value.numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(res32.x.numpy(), res64.x.numpy(), atol=1e-3)


def test_unsupported_compute_dtype_raises():
    rng = np.random.default_rng(16)
    x, y, off, w = (torch.as_tensor(a) for a in _bucket(rng, 2, 4, 3))
    with pytest.raises(TypeError, match="compute_dtype"):
        entity_solver.entity_lbfgs(
            loss_for_task(TaskType.LOGISTIC_REGRESSION), x, y, off, w,
            torch.zeros((2, 3), dtype=x.dtype), 1.0,
            compute_dtype=torch.float16)


@pytest.fixture(scope="module")
def elastic_net_bucket():
    """One bucket with per-entity normalization, solved by the JAX kernel
    in three variants (the interpreter is slow, so once per module)."""
    rng = np.random.default_rng(17)
    e, r, d = 16, 8, 4
    x, y, off, w = _bucket(rng, e, r, d)
    x[:, :, 1:] = x[:, :, 1:] * 3.0 + 1.0
    fac = rng.uniform(0.3, 1.0, (e, d))
    sh = rng.normal(1.0, 0.3, (e, d))
    fac[:, 0], sh[:, 0] = 1.0, 0.0
    loss = jax_loss_for_task(JaxTaskType.LOGISTIC_REGRESSION)
    args = [jnp.asarray(a) for a in (x, y, off, w)]
    ref = {}
    for mode, normalized in (("owlqn", False), ("owlqn", True),
                             ("lbfgs", True)):
        extra = ((jnp.asarray(fac), jnp.asarray(sh)) if normalized
                 else (None, None))
        ref[mode, normalized] = pallas_entity_lbfgs(
            loss, *args, jnp.zeros((e, d)), 0.4, 0.4, *extra, max_iter=40,
            tol=1e-9, mode=mode, interpret=True)
    return dict(inputs=(x, y, off, w, np.zeros((e, d))), fac=fac, sh=sh,
                ref=ref)


@pytest.mark.parametrize("mode,normalized", [("owlqn", False),
                                             ("owlqn", True),
                                             ("lbfgs", True)])
def test_owlqn_and_normalized_modes_match_pallas_kernel(
        elastic_net_bucket, mode, normalized):
    b = elastic_net_bucket
    extra = ((torch.as_tensor(b["fac"]), torch.as_tensor(b["sh"]))
             if normalized else (None, None))
    res_t = entity_solver.entity_lbfgs(
        loss_for_task(TaskType.LOGISTIC_REGRESSION),
        *(torch.as_tensor(a) for a in b["inputs"]), 0.4, 0.4, *extra,
        max_iter=40, tol=1e-9, mode=mode)
    res_j = b["ref"][mode, normalized]
    _assert_parity(res_j, res_t)
    zeros = res_t.x.numpy() == 0.0
    np.testing.assert_array_equal(zeros, np.asarray(res_j.x) == 0.0)
    assert zeros.any() == (mode == "owlqn")
    assert bool((res_t.trials >= res_t.iterations).all())


@pytest.mark.parametrize("kind", ["tron", "bounds"])
def test_unported_variants_raise(kind):
    """What the entity solver refuses, as solve_glm refuses it: TRON on
    the once-differentiable smoothed hinge, and bounds with OWL-QN; the
    JAX kernel refuses the second too."""
    rng = np.random.default_rng(18)
    x, y, off, w = (torch.as_tensor(a) for a in _bucket(rng, 3, 4, 2))
    c0 = torch.zeros((3, 2), dtype=x.dtype)
    loss = loss_for_task(TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM
                         if kind == "tron"
                         else TaskType.LOGISTIC_REGRESSION)
    for fn in (entity_solver.entity_lbfgs, entity_solver.entity_lbfgs_plain):
        with pytest.raises(ValueError):
            if kind == "tron":
                fn(loss, x, y, off, w, c0, 1.0, mode="tron")
            else:
                fn(loss, x, y, off, w, c0, 1.0, 0.5, lower=c0 - 1.0,
                   mode="owlqn")
    if kind == "bounds":
        with pytest.raises(ValueError):
            pallas_entity_lbfgs(
                jax_loss_for_task(JaxTaskType.LOGISTIC_REGRESSION),
                *(jnp.asarray(a.numpy()) for a in (x, y, off, w, c0)), 1.0,
                0.5, lower=jnp.asarray(c0.numpy()) - 1.0, mode="owlqn",
                interpret=True)
