"""The entity-solver CUDA kernel against its plain PyTorch version on the
card, for all four losses and shapes that exercise the kernel's edges:
rows and coordinates beyond one warp's 32 lanes, a ragged last block of
warps, non-zero starting coefficients and zero-weight entities; in
L-BFGS and OWL-QN mode, with and without the normalization fold, and in
the layouts that keep x in device memory. Iterations, stop reasons,
trial counts and exact-zero sets must be equal.

Marked ``cuda``: skips without a GPU. This file imports neither jax nor
the JAX package, so it runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_entity_kernel.py
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.ops import entity_solver
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.types import TaskType


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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tron", "bounds"])
def test_kernel_raises_for_unported_variants(cuda_device, kind):
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in _inputs(TaskType.LOGISTIC_REGRESSION, 4, 5, 3, 0)]
    before = entity_solver.entity_lbfgs.launches
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if kind == "tron":
            entity_solver.entity_lbfgs(loss, *args, 1.0, mode="tron")
        else:
            entity_solver.entity_lbfgs(loss, *args, 1.0, lower=args[4])
    assert entity_solver.entity_lbfgs.launches == before
