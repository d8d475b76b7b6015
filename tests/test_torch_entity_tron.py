"""Parity: the port's per-entity solver (its plain PyTorch version, which
the wrapper runs for CPU tensors) in TRON mode and with box constraints,
against the JAX package's Pallas kernel run in interpreter mode, as
tests/test_pallas_entity_solver.py runs it: TRON for the logistic,
Poisson and squared losses (the Poisson bucket's last entities at a
feature scale of 30, where exp overflows in rejected trials), TRON with
the normalization fold, with bounds and with both, and bounded L-BFGS.
Float64 on both sides; iterations, stop reasons and the sets of
coefficients at a bound must be equal, values within rtol 1e-10 and
coefficients within atol 1e-8. The port's bounded coefficients sit
exactly on their bound; the Pallas kernel's may sit up to an ulp off it,
because it keeps the accepted trial with the arithmetic select
b + 1 * (a - b) (pallas_entity_solver.py:158), so its pinned set is read
within 1e-12 of the bound. Each kernel variant is interpreted once per
module (a few seconds each); bounded L-BFGS prices at most 8 trials
(max_line_search 7), which spares interpreting the kernel's 23-trial
tail sweep (test_torch_entity_solver.py covers that tail)."""

import functools

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

E, R, D = 8, 6, 4
CASES = {
    # name: (task, mode, normalized, bounded)
    "tron-logistic": (TaskType.LOGISTIC_REGRESSION, "tron", False, False),
    "tron-poisson": (TaskType.POISSON_REGRESSION, "tron", False, False),
    "tron-squared": (TaskType.LINEAR_REGRESSION, "tron", False, False),
    "tron-fold": (TaskType.LOGISTIC_REGRESSION, "tron", True, False),
    "tron-bounds": (TaskType.LOGISTIC_REGRESSION, "tron", False, True),
    "tron-fold-bounds": (TaskType.LOGISTIC_REGRESSION, "tron", True, True),
    "lbfgs-bounds": (TaskType.LOGISTIC_REGRESSION, "lbfgs", False, True),
}


def _case_inputs(name):
    task, _, normalized, bounded = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 40)
    x = rng.normal(0, 1, (E, R, D))
    x[:, :, 0] = 1.0
    z = np.einsum("erd,ed->er", x, rng.normal(0, 0.5, (E, D)))
    if task == TaskType.POISSON_REGRESSION:
        y = rng.poisson(np.exp(np.clip(z, -3, 2))).astype(np.float64)
        x[E // 2:] *= 30.0
    elif task == TaskType.LINEAR_REGRESSION:
        y = z + rng.normal(0, 0.5, (E, R))
    else:
        y = (rng.random((E, R)) < 1 / (1 + np.exp(-z))).astype(np.float64)
    off = rng.normal(0, 0.1, (E, R))
    w = rng.uniform(0.5, 1.5, (E, R))
    fac = sh = lo = hi = None
    if normalized:
        x[:, :, 1:] = x[:, :, 1:] * 3.0 + 1.0
        fac = rng.uniform(0.3, 1.0, (E, D))
        sh = rng.normal(1.0, 0.3, (E, D))
        fac[:, 0], sh[:, 0] = 1.0, 0.0
    if bounded:
        lo = -rng.uniform(0.05, 0.3, (E, D))
        hi = rng.uniform(0.05, 0.3, (E, D))
        lo[:, 0], hi[:, 0] = -np.inf, np.inf
    l2 = 0.1 if task == TaskType.POISSON_REGRESSION else 0.5
    kw = dict(max_iter=15, tol=1e-7, mode=CASES[name][1])
    if kw["mode"] == "lbfgs":
        kw["max_line_search"] = 7
    return dict(task=task, arrays=(x, y, off, w, np.zeros((E, D))),
                extra=(fac, sh, lo, hi), l2=l2, kw=kw)


@functools.lru_cache(maxsize=None)
def _solved(name):
    """The case solved by the interpreted Pallas kernel and by the port."""
    inp = _case_inputs(name)
    opt = lambda a: None if a is None else jnp.asarray(a)
    ref = pallas_entity_lbfgs(
        jax_loss_for_task(JaxTaskType(inp["task"].value)),
        *(jnp.asarray(a) for a in inp["arrays"]), inp["l2"], 0.0,
        *(opt(a) for a in inp["extra"]), interpret=True, **inp["kw"])
    opt_t = lambda a: None if a is None else torch.as_tensor(a)
    res = entity_solver.entity_lbfgs(
        loss_for_task(inp["task"]),
        *(torch.as_tensor(a) for a in inp["arrays"]), inp["l2"], 0.0,
        *(opt_t(a) for a in inp["extra"]), **inp["kw"])
    return dict(mode=inp["kw"]["mode"], ref=ref, res=res, inputs=inp)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_pallas_kernel(name):
    case = _solved(name)
    res, ref = case["res"], case["ref"]
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(res.reason.numpy(), np.asarray(ref.reason))
    np.testing.assert_allclose(res.value.numpy(), np.asarray(ref.value),
                               rtol=1e-10)
    np.testing.assert_allclose(res.grad_norm.numpy(),
                               np.asarray(ref.grad_norm), rtol=1e-6,
                               atol=1e-10)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-8)
    assert res.x.dtype == torch.float64 and res.x.shape == (E, D)
    if case["mode"] == "tron":
        # Accepted steps are counted apart from trips and CG steps.
        assert bool((res.outer_steps >= res.iterations).all())
        assert bool((res.cg_steps >= 0).all()) and res.trials is None
    else:
        assert bool((res.trials >= res.iterations).all())


@pytest.mark.parametrize("name", sorted(n for n in CASES if CASES[n][3]))
def test_bounded_solves_pin_the_same_coefficients(name):
    case = _solved(name)
    _, _, lo, hi = case["inputs"]["extra"]
    x, ref_x = case["res"].x.numpy(), np.asarray(case["ref"].x)
    assert ((x >= lo) & (x <= hi)).all()
    pinned = (x == lo) | (x == hi)
    near = (np.abs(ref_x - lo) <= 1e-12) | (np.abs(ref_x - hi) <= 1e-12)
    np.testing.assert_array_equal(pinned, near)
    assert pinned.any() and not pinned[:, 0].any()
