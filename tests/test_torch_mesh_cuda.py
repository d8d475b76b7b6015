"""The 1-D mesh on the card: two slots of ``cuda:0``
(``make_mesh(2, device="cuda:0")``) run the checks that
tests/test_torch_mesh.py and test_torch_mesh_fold.py run on the CPU.

- the streamed value, gradient and Hvp, and a streaming L-BFGS solve
  under a per-slot budget, are the bits of the unmeshed fold (rows 9 and
  10 per slot);
- a random-effect update over two slots launches the entity kernel once
  a slot of each bucket, gives the unsharded update's coefficients,
  reasons and iterations bit for bit, and brings the padding entities
  back zero; the factored coordinate's latent solves too;
- the entity kernel's queue counter belongs to a (device, stream) pair:
  two launches on two streams of one card, in flight together, each
  walk every one of their entities.

Marked ``cuda``: skips without a GPU. This file imports neither jax nor
the JAX package, so it runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_mesh_cuda.py
"""

import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.algorithm.coordinates import (
    FactoredRandomEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.random_effect import (
    RandomEffectDataConfiguration,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.data.shard_cache import DeviceShardCache
from photon_ml_tpu_torch.estimators.game_estimator import (
    FactoredRandomEffectSpec,
    spec_dataset,
)
from photon_ml_tpu_torch.ops import entity_solver, spmv
from photon_ml_tpu_torch.ops.glm_objective import GLMObjective
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.sharded_objective import ShardedGLMObjective
from photon_ml_tpu_torch.optimization.config import (
    FactoredRandomEffectOptimizationConfiguration,
    GLMOptimizationConfiguration,
)
from photon_ml_tpu_torch.optimization.glm_lbfgs import (
    minimize_lbfgs_glm_streaming,
)
from photon_ml_tpu_torch.parallel import make_mesh, mesh_device_list
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

TASK = TaskType.LOGISTIC_REGRESSION
RE_CFG = "20,1e-6,1.0,1.0,LBFGS,L2"


@pytest.fixture
def mesh2():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return make_mesh(2, device="cuda:0")


@pytest.fixture(autouse=True)
def _join_prefetch_threads():
    yield
    for t in threading.enumerate():
        if t.name == "host-prefetch":
            t.join(timeout=10)
            assert not t.is_alive(), "a prefetch thread did not end"


class _Stream(list):
    def stats(self):
        return {"decode_path": "memory"}


def _problem(n=3000, d=60, seed=0):
    rng = np.random.default_rng(seed)
    X = sp.random(n, d, density=0.2, random_state=seed, format="csr")
    X.data[:] = rng.normal(0, 1, X.nnz)
    y = (rng.random(n) < 0.5).astype(float)
    return X, y


def _sobj(X, y, mesh=None, **kw):
    rows = 256
    stream = _Stream(GameDataset.build(responses=y[s:s + rows],
                                       feature_shards={"g": X[s:s + rows]})
                     for s in range(0, X.shape[0], rows))
    cache = DeviceShardCache.from_stream(
        stream, "g", devices=None if mesh is None else mesh_device_list(mesh),
        device="cuda:0", **kw)
    return ShardedGLMObjective(GLMObjective(loss_for_task(TASK)), cache,
                               mesh=mesh)


@pytest.mark.cuda
def test_streamed_fold_over_two_slots_is_the_unmeshed_bits(mesh2):
    X, y = _problem()
    d = X.shape[1]
    g = torch.Generator().manual_seed(0)
    coef = torch.randn(d, generator=g).to("cuda:0")
    vec = torch.randn(d, generator=g).to("cuda:0")

    def passes(sobj):
        z, f, grad = sobj.margins_value_grad(coef, 0.7)
        return f, grad, sobj.hessian_vector(vec, sobj.curvature_list(z), 0.7)

    spmv.reset_launch_counts()
    want = passes(_sobj(X, y))
    got = passes(_sobj(X, y, mesh2))
    assert spmv.csr_matvec.launches > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    solve = [minimize_lbfgs_glm_streaming(
        s, torch.zeros(d, device="cuda:0"), 0.7, max_iter=10, tol=1e-7).x
        for s in (_sobj(X, y), _sobj(X, y, mesh2, hbm_budget_bytes=200_000))]
    assert torch.equal(solve[0], solve[1])


def _re_dataset(seed=3, n=4000, n_users=301, d=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d))
    x[:, 0] = 1.0
    data = GameDataset.build(
        responses=(rng.random(n) < 0.5).astype(float),
        feature_shards={"u": sp.csr_matrix(x)},
        ids={"userId": rng.integers(0, n_users, n).astype(str),
             "itemId": rng.integers(0, 37, n).astype(str)})
    ds = build_random_effect_dataset(
        data, RandomEffectDataConfiguration("userId", "u"), intercept_col=0,
        device="cuda:0")
    return data, ds


@pytest.mark.cuda
def test_entity_kernel_launches_once_a_slot_with_the_unsharded_bits(mesh2):
    data, ds = _re_dataset()
    cfg = GLMOptimizationConfiguration.parse(RE_CFG)

    def update(mesh):
        coord = RandomEffectCoordinate("re", ds, TASK, cfg, mesh=mesh)
        entity_solver.reset_launch_counts()
        out = coord.update_model(coord.initialize_model(), None)
        torch.cuda.synchronize()
        return out, entity_solver.entity_lbfgs.launches

    (one, one_res), n_one = update(None)
    (two, two_res), n_two = update(mesh2)
    assert n_one == len(ds.blocks) and n_two == 2 * len(ds.blocks)
    for c, c1, r, r1 in zip(two.local_coefs, one.local_coefs, two_res,
                            one_res):
        e = c1.shape[0]
        assert torch.equal(c, c1)
        assert torch.equal(r.reason[:e], r1.reason)
        assert torch.equal(r.iterations[:e], r1.iterations)
        assert torch.all(r.x[e:] == 0)


@pytest.mark.cuda
def test_factored_latent_solves_over_two_slots(mesh2):
    data, _ = _re_dataset(seed=4, n=3000)
    spec = FactoredRandomEffectSpec(
        "mf", RandomEffectDataConfiguration("itemId", "u"),
        [FactoredRandomEffectOptimizationConfiguration.parse(
            f"{RE_CFG};{RE_CFG};2,1")])
    cfg = spec.configs[0]
    ds = spec_dataset(data, spec, device="cuda:0")
    models = []
    for mesh in (None, mesh2):
        coord = FactoredRandomEffectCoordinate(
            "mf", ds, TASK, cfg.random_effect, cfg.latent_factor, cfg.mf,
            seed=0, mesh=mesh)
        models.append(coord.update_model(coord.initialize_model(), None)[0])
    for g, g1 in zip(models[1].latent.local_coefs,
                     models[0].latent.local_coefs):
        assert torch.equal(g, g1)
    assert torch.equal(models[1].projection_matrix,
                       models[0].projection_matrix)


@pytest.mark.cuda
def test_queue_counter_is_per_stream(mesh2):
    _, ds = _re_dataset(seed=5, n=20000, n_users=4000)
    block = max(ds.blocks, key=lambda b: b.num_entities)
    loss = loss_for_task(TASK)
    args = (loss, block.x, block.labels, block.offsets, block.weights,
            torch.zeros((block.num_entities, block.d_pad),
                        device="cuda:0"), 1.0)
    want = entity_solver.entity_lbfgs(*args, max_iter=20, tol=1e-6)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(device="cuda:0") for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            outs.append(entity_solver.entity_lbfgs(*args, max_iter=20,
                                                   tol=1e-6))
    torch.cuda.synchronize()
    for got in outs:
        assert torch.equal(got.x, want.x)
        assert torch.equal(got.iterations, want.iterations)
        assert torch.equal(got.reason, want.reason)
