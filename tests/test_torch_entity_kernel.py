"""The entity-solver CUDA kernel against its plain PyTorch version on the
card, for all four losses and shapes that exercise the kernel's edges:
rows and coordinates beyond one warp's 32 lanes, a ragged last block of
warps, non-zero starting coefficients and zero-weight entities; in
L-BFGS, OWL-QN and TRON mode, with and without the normalization fold
and box constraints, and in the layouts that keep x in device memory.
Iterations, stop reasons, trial counts (TRON: trips and CG steps),
exact-zero sets and the sets of coefficients at a bound must be equal.

Marked ``cuda``: skips without a GPU. This file imports neither jax nor
the JAX package, so it runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_entity_kernel.py
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.ops import entity_solver
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.optimization.convergence import ConvergenceReason
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _normalization(e, d, seed):
    """Per-entity factors and shifts with an inert intercept column 0."""
    rng = np.random.default_rng(seed)
    fac = rng.uniform(0.5, 2.0, (e, d))
    sh = rng.normal(0, 0.3, (e, d))
    fac[:, 0], sh[:, 0] = 1.0, 0.0
    return [np.asarray(a, np.float32) for a in (fac, sh)]


def _assert_same_solve(res_k, res_p):
    assert torch.equal(res_k.iterations, res_p.iterations)
    assert torch.equal(res_k.reason, res_p.reason)
    assert torch.equal(res_k.trials, res_p.trials)
    assert torch.equal(res_k.x == 0, res_p.x == 0)
    torch.testing.assert_close(res_k.value, res_p.value, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(res_k.x, res_p.x, rtol=0, atol=1e-6)


def _inputs(task, e, r, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (e, r, d))
    x[:, :, 0] = 1.0
    x[:, r - 3:, :] = 0.0  # padding rows
    z = np.einsum("erd,ed->er", x, rng.normal(0, 0.4, (e, d)))
    if task == TaskType.POISSON_REGRESSION:
        y = rng.poisson(np.exp(np.clip(z, -3, 2)))
    elif task == TaskType.LINEAR_REGRESSION:
        y = z + rng.normal(0, 0.5, (e, r))
    else:
        y = rng.random((e, r)) < 1 / (1 + np.exp(-z))
    w = rng.uniform(0.5, 1.5, (e, r))
    w[:, r - 3:] = 0.0
    off = rng.normal(0, 0.1, (e, r))
    c0 = rng.normal(0, 0.05, (e, d))
    if e > 1:
        w[1], c0[1] = 0.0, 0.0  # no data, zero start: a zero gradient
    return [np.asarray(a, np.float32) for a in (x, y, off, w, c0)]


@pytest.mark.cuda
@pytest.mark.parametrize("task", list(TaskType))
@pytest.mark.parametrize("e,r,d", [(257, 12, 7), (66, 45, 37)])
def test_kernel_matches_plain_version(cuda_device, task, e, r, d):
    loss = loss_for_task(task)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in _inputs(task, e, r, d, seed=e + r + d)]
    kw = dict(max_iter=25, tol=1e-7)
    before = entity_solver.entity_lbfgs.launches
    res_k = entity_solver.entity_lbfgs(loss, *args, 0.3, **kw)
    torch.cuda.synchronize()
    assert entity_solver.entity_lbfgs.launches == before + 1
    res_p = entity_solver.entity_lbfgs_plain(loss, *args, 0.3, **kw)
    # Both compute in float64 from the same float32 inputs.
    assert torch.equal(res_k.iterations, res_p.iterations)
    assert torch.equal(res_k.reason, res_p.reason)
    torch.testing.assert_close(res_k.value, res_p.value, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(res_k.x, res_p.x, rtol=0, atol=1e-6)
    assert int(res_k.iterations[1]) == 0
    assert torch.equal(res_k.x[1], args[4][1])


@pytest.mark.cuda
def test_kernel_rejects_float64(cuda_device):
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    args = [torch.as_tensor(a, dtype=torch.float64, device=cuda_device)
            for a in _inputs(TaskType.LOGISTIC_REGRESSION, 4, 5, 3, 0)]
    with pytest.raises(TypeError, match="float32"):
        entity_solver.entity_lbfgs(loss, *args, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("e,r,d", [(3, 4096, 8), (2, 8192, 8)])
def test_tall_bucket_launches_the_kernel(cuda_device, e, r, d):
    """An entity too tall for shared memory: at r = 4096 the x tile is read
    from device memory, at r = 8192 the working set goes to the
    workspace too. The bucket still goes through the kernel."""
    from photon_ml_tpu_torch.algorithm.coordinates import _solve_block
    from photon_ml_tpu_torch.data.random_effect import EntityBlock
    from photon_ml_tpu_torch.ops.glm_objective import GLMObjective
    from photon_ml_tpu_torch.optimization.config import (
        GLMOptimizationConfiguration,
    )

    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    x, y, off, w, c0 = (torch.as_tensor(a, device=cuda_device) for a in
                        _inputs(TaskType.LOGISTIC_REGRESSION, e, r, d, 5))
    block = EntityBlock(
        x=x, labels=y, offsets=off, weights=w,
        row_ids=torch.zeros((e, r), dtype=torch.int32, device=cuda_device),
        feat_idx=torch.zeros((e, d), dtype=torch.int32, device=cuda_device))
    cfg = GLMOptimizationConfiguration.parse("10,1e-6,1.0,1.0,LBFGS,L2")
    assert entity_solver.kernel_layout(r, d) == (1 if r == 4096 else 2)
    launches = entity_solver.entity_lbfgs.launches
    res_k = _solve_block(GLMObjective(loss), cfg, block, None, c0)
    torch.cuda.synchronize()
    assert entity_solver.entity_lbfgs.launches == launches + 1
    res_p = entity_solver.entity_lbfgs_plain(loss, x, y, off, w, c0, 1.0,
                                             max_iter=10, tol=1e-6)
    assert torch.equal(res_k.iterations, res_p.iterations)
    assert torch.equal(res_k.reason, res_p.reason)
    torch.testing.assert_close(res_k.value, res_p.value, rtol=1e-6, atol=0)
    torch.testing.assert_close(res_k.x, res_p.x, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [45, 4096])
def test_float32_compute_matches_plain_float32(cuda_device, r):
    """The float32-compute kernel against the float32 plain version, at
    the f32 floors of tests/test_pallas_entity_solver.py (sums run in
    different orders, so iterations may differ by one)."""
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in _inputs(TaskType.LOGISTIC_REGRESSION, 40, r, 9, r)]
    kw = dict(max_iter=25, tol=1e-6, compute_dtype=torch.float32)
    launches = entity_solver.entity_lbfgs.launches
    res_k = entity_solver.entity_lbfgs(loss, *args, 1.0, **kw)
    torch.cuda.synchronize()
    assert entity_solver.entity_lbfgs.launches == launches + 1
    res_p = entity_solver.entity_lbfgs_plain(loss, *args, 1.0, **kw)
    torch.testing.assert_close(res_k.value, res_p.value, rtol=1e-4, atol=0)
    torch.testing.assert_close(res_k.x, res_p.x, rtol=0, atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("task", list(TaskType))
@pytest.mark.parametrize("e,r,d", [(257, 12, 7), (66, 45, 37)])
def test_owlqn_kernel_matches_plain_version(cuda_device, task, e, r, d):
    loss = loss_for_task(task)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in _inputs(task, e, r, d, seed=e + r + d)]
    kw = dict(max_iter=25, tol=1e-7, mode="owlqn")
    before = entity_solver.entity_lbfgs.variants["owlqn"]
    res_k = entity_solver.entity_lbfgs(loss, *args, 0.2, 0.3, **kw)
    torch.cuda.synchronize()
    assert entity_solver.entity_lbfgs.variants["owlqn"] == before + 1
    res_p = entity_solver.entity_lbfgs_plain(loss, *args, 0.2, 0.3, **kw)
    _assert_same_solve(res_k, res_p)
    assert bool((res_k.x == 0).any())  # the l1 weight gives exact zeros
    assert int(res_k.iterations[1]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lbfgs", "owlqn"])
@pytest.mark.parametrize("r", [12, 4096])
def test_normalized_kernel_matches_plain_version(cuda_device, mode, r):
    """The fold at tile load (r = 12) and on every read from device
    memory (r = 4,096)."""
    from photon_ml_tpu_torch.ops.entity_solver import variant

    e, d = (70, 9) if r < 100 else (3, 8)
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in _inputs(TaskType.LOGISTIC_REGRESSION, e, r, d, seed=r)]
    fac, sh = (torch.as_tensor(a, device=cuda_device)
               for a in _normalization(e, d, seed=r + 1))
    kw = dict(max_iter=20, tol=1e-7, mode=mode)
    name = variant(mode, True)
    assert entity_solver.kernel_layout(r, d) == (0 if r < 100 else 1)
    before = entity_solver.entity_lbfgs.variants[name]
    res_k = entity_solver.entity_lbfgs(loss, *args, 0.5, 0.2, fac, sh, **kw)
    torch.cuda.synchronize()
    assert entity_solver.entity_lbfgs.variants[name] == before + 1
    res_p = entity_solver.entity_lbfgs_plain(loss, *args, 0.5, 0.2, fac, sh,
                                             **kw)
    _assert_same_solve(res_k, res_p)
    raw = entity_solver.entity_lbfgs(loss, *args, 0.5, 0.2, **kw)
    assert not torch.equal(raw.x, res_k.x)  # the fold changed the solve


def _bounds(e, d, seed):
    """A box that pins many coefficients, the intercept column 0 free."""
    rng = np.random.default_rng(seed)
    lo = -rng.uniform(0.05, 0.2, (e, d))
    hi = rng.uniform(0.05, 0.2, (e, d))
    lo[:, 0], hi[:, 0] = -np.inf, np.inf
    return [np.asarray(a, np.float32) for a in (lo, hi)]


def _assert_same_steps(res_k, res_p, mode):
    if mode == "tron":
        assert torch.equal(res_k.outer_steps, res_p.outer_steps)
        assert torch.equal(res_k.cg_steps, res_p.cg_steps)
    else:
        assert torch.equal(res_k.trials, res_p.trials)


@pytest.mark.cuda
@pytest.mark.parametrize("task", [TaskType.LOGISTIC_REGRESSION,
                                  TaskType.LINEAR_REGRESSION,
                                  TaskType.POISSON_REGRESSION])
@pytest.mark.parametrize("e,r,d", [(257, 12, 7), (66, 45, 37)])
def test_tron_kernel_matches_plain_version(cuda_device, task, e, r, d):
    """L2 3: at 0.3 the Poisson entities of (66, 45, 37) run CG to its cap
    on every trip, and moving the offsets by 2e-16 changes 12 of 66 of
    their stops in the plain version alone; at 3 no stop of these inputs
    moves under such perturbations, so kernel and plain version must
    agree exactly."""
    loss = loss_for_task(task)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in _inputs(task, e, r, d, seed=e + r + d)]
    kw = dict(max_iter=15, tol=1e-7, mode="tron")
    before = entity_solver.entity_lbfgs.variants["tron"]
    res_k = entity_solver.entity_lbfgs(loss, *args, 3.0, **kw)
    torch.cuda.synchronize()
    assert entity_solver.entity_lbfgs.variants["tron"] == before + 1
    res_p = entity_solver.entity_lbfgs_plain(loss, *args, 3.0, **kw)
    assert torch.equal(res_k.iterations, res_p.iterations)
    assert torch.equal(res_k.reason, res_p.reason)
    _assert_same_steps(res_k, res_p, "tron")
    torch.testing.assert_close(res_k.value, res_p.value, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(res_k.x, res_p.x, rtol=0, atol=1e-6)
    assert int(res_k.iterations[1]) == 0 and int(res_k.outer_steps[1]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode,normalized,bounded", [
    ("lbfgs", False, True), ("lbfgs", True, True), ("tron", True, False),
    ("tron", False, True), ("tron", True, True)])
@pytest.mark.parametrize("r", [12, 4096, 8192])
def test_new_variants_match_plain_version_in_every_layout(
        cuda_device, mode, normalized, bounded, r):
    """Bounded L-BFGS and TRON with the fold and the box, with the x tile
    in shared memory (r = 12), x read from device memory (r = 4,096) and
    the working set in the workspace too (r = 8,192)."""
    from photon_ml_tpu_torch.ops.entity_solver import variant

    e, d = (70, 9) if r < 100 else (3, 8)
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in _inputs(TaskType.LOGISTIC_REGRESSION, e, r, d, seed=r)]
    fold = ([torch.as_tensor(a, device=cuda_device)
             for a in _normalization(e, d, seed=r + 1)] if normalized
            else [None, None])
    box = ([torch.as_tensor(a, device=cuda_device)
            for a in _bounds(e, d, seed=r + 2)] if bounded else [None, None])
    kw = dict(max_iter=15, tol=1e-7, mode=mode)
    name = variant(mode, normalized, bounded)
    assert entity_solver.kernel_layout(r, d, mode=mode) == (
        0 if r < 100 else 1 if r == 4096 else 2)
    before = entity_solver.entity_lbfgs.variants[name]
    res_k = entity_solver.entity_lbfgs(loss, *args, 0.5, 0.0, *fold, *box,
                                       **kw)
    torch.cuda.synchronize()
    assert entity_solver.entity_lbfgs.variants[name] == before + 1
    res_p = entity_solver.entity_lbfgs_plain(loss, *args, 0.5, 0.0, *fold,
                                             *box, **kw)
    assert torch.equal(res_k.iterations, res_p.iterations)
    assert torch.equal(res_k.reason, res_p.reason)
    _assert_same_steps(res_k, res_p, mode)
    torch.testing.assert_close(res_k.value, res_p.value, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(res_k.x, res_p.x, rtol=0, atol=1e-6)
    if bounded:
        lo, hi = box
        assert bool(((res_k.x >= lo) & (res_k.x <= hi)).all())
        pinned_k = (res_k.x == lo) | (res_k.x == hi)
        assert torch.equal(pinned_k, (res_p.x == lo) | (res_p.x == hi))
        assert bool(pinned_k.any())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tron", "bounds"])
def test_kernel_raises_for_unported_variants(cuda_device, kind):
    """What the solver refuses on the CPU it refuses on the card, before
    any launch: TRON on the once-differentiable smoothed hinge, and
    bounds with OWL-QN."""
    task = (TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM if kind == "tron"
            else TaskType.LOGISTIC_REGRESSION)
    loss = loss_for_task(task)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in _inputs(task, 4, 5, 3, 0)]
    before = entity_solver.entity_lbfgs.launches
    with pytest.raises(ValueError):
        if kind == "tron":
            entity_solver.entity_lbfgs(loss, *args, 1.0, mode="tron")
        else:
            entity_solver.entity_lbfgs(loss, *args, 1.0, 0.5, lower=args[4],
                                       mode="owlqn")
    assert entity_solver.entity_lbfgs.launches == before


# The variants of the L-BFGS modes and of TRON: (mode, normalized,
# bounded).
VARIANTS = [("lbfgs", False, False), ("lbfgs", True, False),
            ("lbfgs", False, True), ("owlqn", False, False),
            ("tron", False, False), ("tron", True, False),
            ("tron", False, True)]


def _work_fields(mode):
    """The result fields that count an entity's work in ``mode``."""
    return ("outer_steps", "cg_steps") if mode == "tron" else ("trials",)


def _variant_args(cuda_device, e, r, d, normalized, bounded, seed):
    args = [torch.as_tensor(a, device=cuda_device) for a in
            _inputs(TaskType.LOGISTIC_REGRESSION, e, r, d, seed)]
    fold = ([torch.as_tensor(a, device=cuda_device)
             for a in _normalization(e, d, seed + 1)] if normalized
            else [None, None])
    box = ([torch.as_tensor(a, device=cuda_device)
            for a in _bounds(e, d, seed + 2)] if bounded else [None, None])
    return args, fold, box


def _assert_close_solve(res_k, res_p, compute_dtype, mode, bounded=False):
    """float64: equal iterations, reasons, work (trials, or TRON's trips
    and CG steps) and zero sets, rtol and atol 1e-6. With bounds in the
    L-BFGS modes, an entity whose last trials project back onto its
    iterate passes or fails their Armijo test at float64 rounding, so it
    may stop FUNCTION_VALUES_CONVERGED in one and OBJECTIVE_NOT_IMPROVING
    in the other, or after other trial counts, with the same iterations
    and bit-equal coefficients (ROADMAP.md section C); bounded TRON has no
    such allowance. float32 (kernel and plain version sum in other orders):
    an entity may stop at another iteration (about 2% at chip_smoke.py's
    headline buckets), so at least half must stop alike, those at the
    value floor of tests/test_pallas_entity_solver.py (rtol 1e-4), and
    every coefficient within its coefficient floor (atol 5e-3)."""
    if compute_dtype == torch.float64:
        differ = res_k.reason != res_p.reason
        for field in _work_fields(mode):
            differ |= getattr(res_k, field) != getattr(res_p, field)
        moved = differ | (res_k.iterations != res_p.iterations)
        stops = (f"{int(moved.sum())} of {moved.numel()} entities stop "
                 "otherwise than the plain version")
        assert torch.equal(res_k.iterations, res_p.iterations), stops
        if bounded and mode != "tron":
            fvc_oni = {int(ConvergenceReason.FUNCTION_VALUES_CONVERGED),
                       int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING)}
            assert set(res_k.reason[differ].tolist()) <= fvc_oni
            assert set(res_p.reason[differ].tolist()) <= fvc_oni
            assert torch.equal(res_k.x[differ], res_p.x[differ])
        else:
            assert not bool(differ.any()), stops
        if mode == "owlqn":
            assert torch.equal(res_k.x == 0, res_p.x == 0)
        torch.testing.assert_close(res_k.value, res_p.value, rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(res_k.x, res_p.x, rtol=0, atol=1e-6)
    else:
        alike = ((res_k.iterations == res_p.iterations)
                 & (res_k.reason == res_p.reason))
        assert float(alike.float().mean()) >= 0.5
        torch.testing.assert_close(res_k.value[alike], res_p.value[alike],
                                   rtol=1e-4, atol=0)
        torch.testing.assert_close(res_k.x, res_p.x, rtol=0, atol=5e-3)


def _assert_same_bits(a, b, mode):
    for field in ("x", "value", "grad_norm", "iterations", "reason",
                  *_work_fields(mode)):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


@pytest.mark.cuda
@pytest.mark.parametrize("mode,normalized,bounded", VARIANTS)
@pytest.mark.parametrize("d", [1, 3, 4, 5, 8, 9, 16, 17, 25, 32, 33])
def test_coordinate_lanes_across_widths(cuda_device, mode, normalized,
                                        bounded, d):
    """d on both sides of the power-of-two boundaries and past 32, so
    every instance's C (the smallest power of two >= d, at least 4, lanes
    over the coordinates) runs, in the L-BFGS modes and in TRON: against
    the plain version in both compute types."""
    e, r = 70, 19
    args, fold, box = _variant_args(cuda_device, e, r, d, normalized,
                                    bounded, seed=d)
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    name = entity_solver.variant(mode, normalized, bounded)
    for dt in (torch.float64, torch.float32):
        plan = entity_solver.kernel_plan(r, d, compute_dtype=dt, mode=mode)
        assert plan["coord_lanes"] == (
            max(4, 1 << (d - 1).bit_length()) if d <= 32 else 32)
        kw = dict(max_iter=20, tol=1e-7, mode=mode, compute_dtype=dt)
        before = entity_solver.entity_lbfgs.variants[name]
        res_k = entity_solver.entity_lbfgs(loss, *args, 0.4, 0.2, *fold,
                                           *box, **kw)
        torch.cuda.synchronize()
        assert entity_solver.entity_lbfgs.variants[name] == before + 1
        res_p = entity_solver.entity_lbfgs_plain(loss, *args, 0.4, 0.2,
                                                 *fold, *box, **kw)
        _assert_close_solve(res_k, res_p, dt, mode, bounded)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,normalized,bounded", VARIANTS)
@pytest.mark.parametrize("e", [1, 7, 20_000])
def test_persistent_queue_walks_every_entity(cuda_device, mode, normalized,
                                             bounded, e):
    """E = 1 and 7 fill less than one block; E = 20,000 is more than the
    card holds resident, so warps take entities from the queue after their
    first one stops. In both compute types two launches in a row give the
    same bits (the counter is back at 0 after each), and at E = 20,000 so
    do four launches of 5,000 (no entity's result depends on the warp
    that took it). Against the plain version in float64 (float32's is
    test_coordinate_lanes_across_widths')."""
    r, d = 24, 9
    args, fold, box = _variant_args(cuda_device, e, r, d, normalized,
                                    bounded, seed=e)
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    for dt in (torch.float64, torch.float32):
        kw = dict(max_iter=20, tol=1e-7, mode=mode, compute_dtype=dt)
        first = entity_solver.entity_lbfgs(loss, *args, 0.4, 0.2, *fold,
                                           *box, **kw)
        again = entity_solver.entity_lbfgs(loss, *args, 0.4, 0.2, *fold,
                                           *box, **kw)
        torch.cuda.synchronize()
        _assert_same_bits(first, again, mode)
        if e == 20_000:
            plan = entity_solver.kernel_plan(r, d, compute_dtype=dt,
                                             mode=mode)
            assert plan["resident"] < e
            parts = [entity_solver.entity_lbfgs(
                loss, *(a[k:k + 5_000] for a in args), 0.4, 0.2,
                *(None if t is None else t[k:k + 5_000]
                  for t in fold + box), **kw)
                for k in range(0, e, 5_000)]
            torch.cuda.synchronize()
            for field in ("x", "value", "grad_norm", "iterations", "reason",
                          *_work_fields(mode)):
                assert torch.equal(getattr(first, field), torch.cat(
                    [getattr(p, field) for p in parts])), field
        if dt == torch.float64:
            res_p = entity_solver.entity_lbfgs_plain(loss, *args, 0.4, 0.2,
                                                     *fold, *box, **kw)
            _assert_close_solve(first, res_p, dt, mode, bounded)
        assert int(first.iterations.min()) >= (0 if e > 1 else 1)
