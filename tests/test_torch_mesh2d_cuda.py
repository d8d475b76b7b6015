"""The 2-D (data x model) mesh on the card: R x C slots of ``cuda:0``
(``make_mesh_2d(R, C, device="cuda:0")``) run the checks that
tests/test_torch_mesh2d.py runs on the CPU, here bit for bit in every
shape (rows 9 and 10 keep their order contract, csrc/csr_order.cuh):

- the product stream's margins are ``spmv.csr_order_reference``'s bits
  of the unblocked rows, in row 9 and row 10 and with squared values;
- the streamed value, gradient, Hvp and direction margins, plain and
  under factors and shifts normalization, and the streaming L-BFGS and
  TRON solves, scalar and grid, spilled per slot, are the unmeshed
  fold's bits at 1x2 and 2x2;
- a random-effect update over 2 x 2 launches the entity kernel once a
  data row of each bucket and gives the unsharded update's bits;
- ``BlockedCSRFeatures``' four products are ``CSRFeatures``' bits;
- a world of one process joins on nccl and leaves.

Marked ``cuda``: skips without a GPU. This file imports neither jax nor
the JAX package, so it runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_mesh2d_cuda.py
"""

import socket
import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.algorithm.coordinates import RandomEffectCoordinate
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.normalization import NormalizationContext
from photon_ml_tpu_torch.data.random_effect import (
    RandomEffectDataConfiguration,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.data.shard_cache import DeviceShardCache
from photon_ml_tpu_torch.ops import entity_solver, spmv
from photon_ml_tpu_torch.ops.features import (
    blocked_csr_from_scipy,
    csr_from_scipy,
)
from photon_ml_tpu_torch.ops.glm_objective import GLMObjective
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.sharded_objective import ShardedGLMObjective
from photon_ml_tpu_torch.optimization.config import (
    GLMOptimizationConfiguration,
)
from photon_ml_tpu_torch.optimization.glm_lbfgs import (
    minimize_lbfgs_glm_grid_streaming,
    minimize_lbfgs_glm_streaming,
)
from photon_ml_tpu_torch.optimization.tron import (
    minimize_tron_grid_streaming,
    minimize_tron_streaming,
)
from photon_ml_tpu_torch.parallel import (
    initialize_multihost,
    is_primary_host,
    make_mesh_2d,
    mesh_fold_devices,
)
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

TASK = TaskType.LOGISTIC_REGRESSION
RE_CFG = "20,1e-6,1.0,1.0,LBFGS,L2"
DEV = "cuda:0"
ROWS = 256


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device(DEV)


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


def _problem(n=3000, d=61, seed=0):
    rng = np.random.default_rng(seed)
    X = sp.random(n, d, density=0.2, random_state=seed, format="csr")
    X.data[:] = rng.normal(0, 1, X.nnz)
    X.sort_indices()
    y = (rng.random(n) < 0.5).astype(float)
    return X, y


def _sobj(X, y, shape=None, norm=None, **kw):
    mesh, devices, cols = None, None, 1
    if shape is not None:
        mesh = make_mesh_2d(*shape, device=DEV)
        devices, cols = mesh_fold_devices(mesh), shape[1]
    stream = _Stream(GameDataset.build(responses=y[s:s + ROWS],
                                       feature_shards={"g": X[s:s + ROWS]})
                     for s in range(0, X.shape[0], ROWS))
    cache = DeviceShardCache.from_stream(stream, "g", devices=devices,
                                         col_blocks=cols, device=DEV, **kw)
    return ShardedGLMObjective(GLMObjective(loss_for_task(TASK), norm),
                               cache, mesh=mesh)


def _norm(d, mode):
    if mode is None:
        return None
    factors = torch.linspace(0.5, 1.5, d, device=DEV)
    shifts = None
    if mode == "shifts":
        shifts = torch.linspace(-0.2, 0.3, d, device=DEV)
        shifts[d - 1] = 0.0
    return NormalizationContext(factors, shifts, d - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 3)])
def test_product_stream_is_the_reference_bits(card, shape):
    X, y = _problem()
    X = X.astype(np.float32)
    cache = _sobj(X, y, shape).cache
    chunk = spmv.chunk_entries()
    rng = np.random.default_rng(1)
    width = cache.col_blocks * cache.col_block_size
    for x, square in ((rng.normal(size=width), False),
                      (rng.normal(size=(width, 5)), False),
                      (rng.normal(size=width), True)):
        x = x.astype(np.float32)
        xt = torch.as_tensor(x, device=DEV)
        for e in cache.blocks():
            full = X[e.index * ROWS:e.index * ROWS + e.n_rows]
            bs = cache.col_block_size
            parts = [spmv.entry_products(b, xt[c * bs:(c + 1) * bs], square)
                     for c, b in enumerate(e.cols)]
            got = (e.stream.matvec(parts) if x.ndim == 1
                   else e.stream.matmat(parts)).cpu().numpy()
            vals = full.data * full.data if square else full.data
            want = spmv.csr_order_reference(
                full.indptr, full.indices, vals.astype(np.float32),
                x[:X.shape[1]], chunk)
            assert np.array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("norm", [None, "factors", "shifts"])
def test_streamed_passes_are_the_unmeshed_bits(card, norm):
    X, y = _problem()
    d = X.shape[1]
    g = torch.Generator().manual_seed(0)
    coef = torch.randn(d, generator=g).to(DEV)
    vec = torch.randn(d, generator=g).to(DEV)
    coefs = torch.randn((3, d), generator=g).to(DEV)
    l2s = torch.tensor([0.1, 0.7, 5.0], device=DEV)

    def passes(sobj):
        z, f, grad = sobj.margins_value_grad(coef, 0.7)
        out = [f, grad, sobj.hessian_vector(vec, sobj.curvature_list(z),
                                            0.7),
               *sobj.margin_direction_list(vec),
               sobj.grad_from_margins_list(coef, z, 0.7)]
        zg, fg, gg = sobj.grid_margins_value_grad(coefs, l2s)
        return out + [fg, gg, *zg, sobj.grid_hessian_vector(
            coefs, sobj.grid_curvature_list(zg), l2s)]

    want = passes(_sobj(X, y, norm=_norm(d, norm)))
    for shape in ((1, 2), (2, 2)):
        got = passes(_sobj(X, y, shape, _norm(d, norm),
                           hbm_budget_bytes=60_000))
        for a, b in zip(got, want):
            assert torch.equal(a, b), shape


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["lbfgs", "tron", "lbfgs-grid",
                                    "tron-grid"])
def test_streamed_solves_are_the_unmeshed_bits(card, solver):
    X, y = _problem(seed=2)
    d = X.shape[1]
    grid = solver.endswith("grid")
    run = {"lbfgs": minimize_lbfgs_glm_streaming,
           "tron": minimize_tron_streaming,
           "lbfgs-grid": minimize_lbfgs_glm_grid_streaming,
           "tron-grid": minimize_tron_grid_streaming}[solver]
    x0 = torch.zeros((3, d) if grid else d, device=DEV)
    lam = [0.1, 1.0, 10.0] if grid else 0.7

    def solve(sobj):
        out = run(sobj, x0, lam, max_iter=8, tol=1e-7)
        return [r.x for r in out] if grid else [out.x]

    want = solve(_sobj(X, y))
    for shape in ((1, 2), (2, 2)):
        sobj = _sobj(X, y, shape, hbm_budget_bytes=60_000)
        for a, b in zip(solve(sobj), want):
            assert torch.equal(a, b), shape
        assert sobj.cache.stats()["evictions"] > 0


@pytest.mark.cuda
def test_entity_update_launches_once_a_data_row(card):
    rng = np.random.default_rng(3)
    n, d = 4000, 5
    x = rng.normal(0, 1, (n, d))
    x[:, 0] = 1.0
    data = GameDataset.build(
        responses=(rng.random(n) < 0.5).astype(float),
        feature_shards={"u": sp.csr_matrix(x)},
        ids={"userId": rng.integers(0, 301, n).astype(str)})
    ds = build_random_effect_dataset(
        data, RandomEffectDataConfiguration("userId", "u"), intercept_col=0,
        device=DEV)
    cfg = GLMOptimizationConfiguration.parse(RE_CFG)

    def update(mesh):
        coord = RandomEffectCoordinate("re", ds, TASK, cfg, mesh=mesh)
        entity_solver.reset_launch_counts()
        out = coord.update_model(coord.initialize_model(), None)
        torch.cuda.synchronize()
        return out, entity_solver.entity_lbfgs.launches

    (one, one_res), n_one = update(None)
    (two, two_res), n_two = update(make_mesh_2d(2, 2, device=DEV))
    assert n_one == len(ds.blocks) and n_two == 2 * len(ds.blocks)
    for c, c1, r, r1 in zip(two.local_coefs, one.local_coefs, two_res,
                            one_res):
        e = c1.shape[0]
        assert torch.equal(c, c1)
        assert torch.equal(r.reason[:e], r1.reason)
        assert torch.equal(r.iterations[:e], r1.iterations)
        assert torch.all(r.x[e:] == 0)


@pytest.mark.cuda
def test_blocked_csr_products_are_the_csr_bits(card):
    X, _ = _problem(n=700, seed=4)
    plain = csr_from_scipy(X, device=DEV)
    blocked = blocked_csr_from_scipy(X, 3, device=DEV)
    d_pad = blocked.n_features
    g = torch.Generator().manual_seed(5)
    v = torch.randn(X.shape[1], generator=g).to(DEV)
    vp = torch.nn.functional.pad(v, (0, d_pad - X.shape[1]))
    u = torch.randn(X.shape[0], generator=g).to(DEV)
    assert torch.equal(blocked.matvec(vp), plain.matvec(v))
    assert torch.equal(blocked.row_sq_matvec(vp), plain.row_sq_matvec(v))
    assert torch.equal(blocked.rmatvec(u)[:X.shape[1]], plain.rmatvec(u))
    assert torch.equal(blocked.sq_rmatvec(u)[:X.shape[1]],
                       plain.sq_rmatvec(u))


@pytest.mark.cuda
def test_world_of_one_on_nccl(card):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    try:
        assert initialize_multihost(f"127.0.0.1:{port}", 1, 0, device=DEV,
                                    timeout=60)
        assert is_primary_host()
        t = torch.ones(3, device=DEV)
        torch.distributed.all_reduce(t)
        assert t.tolist() == [1.0, 1.0, 1.0]
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    assert not torch.distributed.is_initialized()
