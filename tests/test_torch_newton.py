"""Parity: the port's damped exact Newton (optimization/newton.py) against
the JAX package's, float64, on the cases of JAX's tests/test_newton.py
(:34-124): equal iterations and stop reasons, coefficients within 1e-10
(absolute), value and gradient-norm histories within 1e-10 (relative) with
NaN past the last iteration in the same places. A [B, d] batch equals
JAX's ``vmap`` of the solo solve and the port's solo solves (iterations,
reasons, histories; coefficients within 1e-12 of the solo solves). The
port differentiates with ``torch.func``, JAX with ``jax.hessian``: the
two derivatives agree to rounding, not bit for bit, hence the bounds.
The Poisson case states its own (its docstring: one ulp decides its
last step)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

from photon_ml_tpu.ops import DenseFeatures as JaxDense
from photon_ml_tpu.ops import GLMObjective as JaxObjective
from photon_ml_tpu.ops.glm_objective import make_batch as jax_make_batch
from photon_ml_tpu.ops.losses import LogisticLoss as JaxLogistic
from photon_ml_tpu.ops.losses import PoissonLoss as JaxPoisson
from photon_ml_tpu.optimization import minimize_newton as jax_newton
from photon_ml_tpu_torch.ops import DenseFeatures, GLMObjective
from photon_ml_tpu_torch.ops.glm_objective import make_batch
from photon_ml_tpu_torch.ops.losses import LogisticLoss, PoissonLoss
from photon_ml_tpu_torch.optimization import (
    ConvergenceReason,
    minimize_newton,
    minimize_tron,
)
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

CENTER = np.asarray([1.0, -2.0, 3.0, 0.5, -0.25])
SCALES = np.asarray([1.0, 2.0, 0.5, 4.0, 1.5])
COEF_ATOL = 1e-10
HIST_RTOL = 1e-10
# One JAX objective for the logistic cases: its bound ``value`` is a
# static argument of JAX's jitted solve, so the cases share one compile.
JAX_LOGISTIC = JaxObjective(JaxLogistic)


def quad(x, scale):
    d = x - torch.as_tensor(CENTER, dtype=x.dtype)
    return torch.sum(scale * d * d)


def jax_quad(x, scale):
    d = x - jnp.asarray(CENTER, x.dtype)
    return jnp.sum(scale * d * d)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def assert_same_solve(res, ref, x_atol=COEF_ATOL):
    """``ref`` may have tracked its coefficients where ``res`` did not
    (the same solve: one JAX compile serves both)."""
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(res.reason.numpy(), np.asarray(ref.reason))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=x_atol)
    for got, want in ((res.value_history, ref.value_history),
                      (res.grad_norm_history, ref.grad_norm_history),
                      (res.coef_history, ref.coef_history)):
        if want is None or got is None:
            assert got is None
            continue
        want = np.asarray(want)
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
        np.testing.assert_allclose(got.numpy(), want, rtol=HIST_RTOL,
                                   atol=1e-12)


@pytest.fixture(scope="module")
def jax_quad_ref():
    return jax_newton(jax_quad, jnp.zeros(5), args=(jnp.asarray(SCALES),),
                      tol=1e-12, track_coefficients=True)


def test_quadratic_one_newton_step(jax_quad_ref):
    res = minimize_newton(quad, torch.zeros(5, dtype=torch.float64),
                          args=(_t(SCALES),), tol=1e-12)
    assert_same_solve(res, jax_quad_ref)
    np.testing.assert_allclose(res.x.numpy(), CENTER, atol=1e-8)
    assert int(res.iterations) <= 3
    assert res.reason_enum() in (
        ConvergenceReason.GRADIENT_CONVERGED,
        ConvergenceReason.FUNCTION_VALUES_CONVERGED)


def _logistic_problem(n=300, d=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x[:, -1] = 1.0
    w = rng.normal(size=d)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ w)))).astype(float)
    return x, y


def _batches(x, y):
    return (make_batch(DenseFeatures(_t(x)), _t(y)),
            jax_make_batch(JaxDense(jnp.asarray(x)), jnp.asarray(y)))


def test_matches_jax_and_scipy_on_logistic():
    x, y = _logistic_problem()
    batch, jbatch = _batches(x, y)
    l2 = 0.5
    res = minimize_newton(GLMObjective(LogisticLoss).value,
                          torch.zeros(6, dtype=torch.float64),
                          args=(batch, l2), tol=1e-10, max_iter=50)
    ref = jax_newton(JAX_LOGISTIC.value, jnp.zeros(6),
                     args=(jbatch, l2), tol=1e-10, max_iter=50)
    assert_same_solve(res, ref)

    def f_np(w):
        z = x @ w
        return float(np.sum(np.logaddexp(0.0, z) - y * z)
                     + 0.5 * l2 * w @ w)

    opt = scipy.optimize.minimize(f_np, np.zeros(6), method="Nelder-Mead",
                                  options={"xatol": 1e-8, "fatol": 1e-12,
                                           "maxiter": 5000})
    assert float(res.value) <= opt.fun + 1e-6


def test_matches_tron_solution():
    x, y = _logistic_problem(seed=3)
    batch, jbatch = _batches(x, y)
    obj = GLMObjective(LogisticLoss)
    rn = minimize_newton(obj.value, torch.zeros(6, dtype=torch.float64),
                         args=(batch, 0.3), tol=1e-10, max_iter=50)
    ref = jax_newton(JAX_LOGISTIC.value, jnp.zeros(6),
                     args=(jbatch, 0.3), tol=1e-10, max_iter=50)
    assert_same_solve(rn, ref)
    rt = minimize_tron(obj.value_and_grad,
                       torch.zeros(6, dtype=torch.float64),
                       args=(batch, 0.3), tol=1e-10, max_iter=50,
                       make_hvp=obj.make_tron_hvp)
    np.testing.assert_allclose(rn.x.numpy(), rt.x.numpy(), atol=1e-5)


def test_box_constraints_projection():
    lb = np.asarray([0.0, -1.0, 0.0, 0.0, -1.0])
    ub = np.asarray([0.5, 0.0, 10.0, 0.1, 0.0])
    res = minimize_newton(quad, torch.zeros(5, dtype=torch.float64),
                          args=(_t(SCALES),), tol=1e-12,
                          lower_bounds=_t(lb), upper_bounds=_t(ub))
    ref = jax_newton(jax_quad, jnp.zeros(5), args=(jnp.asarray(SCALES),),
                     tol=1e-12, lower_bounds=jnp.asarray(lb),
                     upper_bounds=jnp.asarray(ub))
    assert_same_solve(res, ref)
    np.testing.assert_allclose(res.x.numpy(), np.clip(CENTER, lb, ub),
                               atol=1e-6)


E, N, D = 5, 40, 4


@pytest.fixture(scope="module")
def entity_problems():
    """(xs, ys, JAX's vmap of the solo solve, coefficients tracked)."""
    rng = np.random.default_rng(7)
    xs = rng.normal(size=(E, N, D))
    ws = rng.normal(size=(E, D))
    ys = (rng.random((E, N)) < 1 / (1 + np.exp(
        -np.einsum("end,ed->en", xs, ws)))).astype(float)
    jobj = JaxObjective(JaxLogistic)

    def jax_fit(x, y):
        return jax_newton(jobj.value, jnp.zeros(D, x.dtype),
                          args=(jax_make_batch(JaxDense(x), y), 0.5),
                          tol=1e-10, track_coefficients=True)

    return xs, ys, jax.vmap(jax_fit)(jnp.asarray(xs), jnp.asarray(ys))


@pytest.mark.parametrize("track", [False, True])
def test_batch_matches_jax_vmap_and_solo_solves(entity_problems, track):
    """The mode that matters: entity solves as one batched loop agree
    with JAX's vmap and with the port's per-problem solves."""
    xs, ys, ref = entity_problems
    obj, d = GLMObjective(LogisticLoss), D

    def fit(x, y):
        return minimize_newton(
            obj.value, torch.zeros(x.shape[:-2] + (d,), dtype=torch.float64),
            args=(make_batch(DenseFeatures(x), y), 0.5), tol=1e-10,
            track_coefficients=track)

    batched = fit(_t(xs), _t(ys))
    assert_same_solve(batched, ref)
    # JAX stops its problems at different iterations: the mask matters.
    assert len(set(np.asarray(ref.iterations).tolist())) > 1
    for e in range(E):
        single = fit(_t(xs[e]), _t(ys[e]))
        assert int(single.iterations) == int(batched.iterations[e])
        assert int(single.reason) == int(batched.reason[e])
        np.testing.assert_allclose(batched.x[e].numpy(), single.x.numpy(),
                                   rtol=0, atol=1e-12)
        np.testing.assert_array_equal(
            np.isnan(batched.value_history[e].numpy()),
            np.isnan(single.value_history.numpy()))


def test_batch_refuses_an_arg_without_the_leading_dimension():
    x = torch.zeros((3, 4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="leading 3"):
        minimize_newton(
            GLMObjective(LogisticLoss).value,
            torch.zeros((3, 2), dtype=torch.float64),
            args=(make_batch(DenseFeatures(x),
                             torch.zeros(4, dtype=torch.float64)), 0.5))


def test_coef_history_tracking(jax_quad_ref):
    res = minimize_newton(quad, torch.zeros(5, dtype=torch.float64),
                          args=(_t(SCALES),), tol=1e-12,
                          track_coefficients=True)
    assert_same_solve(res, jax_quad_ref)
    hist = res.coef_history.numpy()
    iters = int(res.iterations)
    np.testing.assert_allclose(hist[iters], res.x.numpy(), atol=0)
    assert np.all(np.isnan(hist[iters + 1:]))


def test_poisson_newton():
    """Equal iterations, coefficients within 1e-8. The last step here
    lowers f by one ulp in JAX and by none in the port (the two sums
    round the same value differently), so JAX accepts it and the port
    rejects it and accepts a heavily damped one: both stop converged
    after 6 iterations, JAX on the gradient, the port on the function
    values, 5e-10 apart in the coefficients. So this case holds the
    reasons to a converged one, and the gradient as JAX's test does."""
    rng = np.random.default_rng(2)
    n, d = 200, 5
    x = rng.normal(0, 0.4, size=(n, d))
    x[:, -1] = 1.0
    w = rng.normal(0, 0.5, size=d)
    y = rng.poisson(np.exp(x @ w)).astype(float)
    batch, jbatch = _batches(x, y)
    obj = GLMObjective(PoissonLoss)
    res = minimize_newton(obj.value, torch.zeros(d, dtype=torch.float64),
                          args=(batch, 0.1), tol=1e-10, max_iter=50)
    ref = jax_newton(JaxObjective(JaxPoisson).value, jnp.zeros(d),
                     args=(jbatch, 0.1), tol=1e-10, max_iter=50)
    assert int(res.iterations) == int(ref.iterations)
    converged = {ConvergenceReason.GRADIENT_CONVERGED,
                 ConvergenceReason.FUNCTION_VALUES_CONVERGED}
    assert res.reason_enum() in converged
    assert ConvergenceReason(int(ref.reason)) in converged
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(res.value_history.numpy(),
                               np.asarray(ref.value_history),
                               rtol=HIST_RTOL)
    _, g = obj.value_and_grad(res.x, batch, 0.1)
    assert float(torch.linalg.norm(g)) < 1e-4


def test_singular_system_is_rejected_not_raised():
    """A zero Hessian at damping 0 would be singular: solve_ex reports it
    and the step is rejected (JAX's solve gives non-finite entries)."""
    def flat(x):
        return torch.sum(x) * 0.0 + torch.sum(x ** 4)

    res = minimize_newton(flat, torch.zeros(3, dtype=torch.float64),
                          max_iter=5)
    assert res.reason_enum() == ConvergenceReason.GRADIENT_CONVERGED
    res = minimize_newton(flat, torch.ones(3, dtype=torch.float64),
                          max_iter=5)
    ref = jax_newton(lambda x: jnp.sum(x) * 0.0 + jnp.sum(x ** 4),
                     jnp.ones(3), max_iter=5)
    assert_same_solve(res, ref)
