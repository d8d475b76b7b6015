"""Damped Newton (optimization/newton.py) on the card: a [B, d] batch of
logistic problems in float64 (Newton's default tolerance) gives the
CPU's iterations and reasons for every problem and its coefficients
within 1e-9; a solve captured into a
CUDA graph (its loop a WHILE node) gives the eager solve's bits; and an
objective that reaches row 9's ctypes kernel (CSRFeatures on the card)
raises a TypeError naming it instead of differentiating nothing.

Marked ``cuda``: skips without a GPU. This file imports neither jax nor
the JAX package, so it runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_newton_cuda.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.ops import DenseFeatures, GLMObjective, LogisticLoss
from photon_ml_tpu_torch.ops.features import csr_from_scipy
from photon_ml_tpu_torch.ops.glm_objective import make_batch
from photon_ml_tpu_torch.optimization import minimize_newton
from photon_ml_tpu_torch.utils.device_loop import CapturedGraph
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the solve runs on the card")
    return torch.device("cuda")


def _problems(e=64, n=24, d=8, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(e, n, d))
    y = (rng.random((e, n)) < 1 / (1 + np.exp(
        -np.einsum("end,ed->en", x, rng.normal(size=(e, d)))))).astype(float)
    w = np.ones((e, n))
    w[:, n - 4:] = 0.0  # padding rows, as an entity bucket has
    return x, y, w


def _batch(device, x, y, w):
    t = [torch.as_tensor(a, dtype=torch.float64, device=device)
         for a in (x, y, w)]
    return make_batch(DenseFeatures(t[0]), t[1], weights=t[2])


def _newton(batch, **kw):
    e, _, d = batch.features.x.shape
    return minimize_newton(GLMObjective(LogisticLoss).value, torch.zeros(
        (e, d), dtype=torch.float64, device=batch.labels.device),
        args=(batch, 0.5), **kw)


def _solve(device, x, y, w, **kw):
    return _newton(_batch(device, x, y, w), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("track", [False, True])
def test_batch_on_the_card_equals_the_cpu(cuda_device, track):
    x, y, w = _problems()
    got = _solve(cuda_device, x, y, w, track_coefficients=track)
    want = _solve("cpu", x, y, w, track_coefficients=track)
    assert torch.equal(got.iterations.cpu(), want.iterations)
    assert torch.equal(got.reason.cpu(), want.reason)
    assert float((got.x.cpu() - want.x).abs().max()) <= 1e-9
    assert torch.equal(torch.isnan(got.value_history.cpu()),
                       torch.isnan(want.value_history))
    if track:
        assert torch.equal(torch.isnan(got.coef_history.cpu()),
                           torch.isnan(want.coef_history))


@pytest.mark.cuda
def test_captured_solve_equals_the_eager_one(cuda_device):
    batch = _batch(cuda_device, *_problems(e=16))
    eager = _newton(batch)  # also makes the solver's handles
    graph = CapturedGraph(lambda: _newton(batch), cuda_device)
    graph.replay()
    torch.cuda.synchronize()
    res = graph.outputs
    assert graph.stats["loops"] == 1
    assert torch.equal(res.x, eager.x)
    assert torch.equal(res.iterations, eager.iterations)
    assert torch.equal(res.reason, eager.reason)
    graph.close()


@pytest.mark.cuda
def test_csr_objective_on_the_card_raises(cuda_device):
    x = sp.random(40, 6, density=0.5, random_state=1, format="csr")
    feats = csr_from_scipy(x, dtype=torch.float64, device=cuda_device)
    y = torch.zeros(40, dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError, match="ctypes"):
        minimize_newton(GLMObjective(LogisticLoss).value,
                        torch.zeros(6, dtype=torch.float64,
                                    device=cuda_device),
                        args=(make_batch(feats, y), 0.5))
