"""The 2-D (data x model) mesh on the CPU, float64 (parallel/distributed.py
``make_mesh_2d`` and the feature-dimension sharding, data/shard_cache.py
``col_blocks=``, ops/sharded_objective.py's 2-D passes, the feature-
sharded FixedEffectCoordinate, DeviceFactorCache ``devices=``,
parallel/multihost.py, the training driver's ``--mesh-shape RxC``): the
port's counterpart of tests/test_mesh2d.py and the 2-D cases of
tests/test_distributed.py.

JAX runs on its harness's virtual CPU devices, the port on R x C CPU
slots. What is held, and how tightly:

- ``split_csr_columns``, ``shard_batch_feature_dim``,
  ``shard_batch_csr_feature_dim``, ``shard_coef`` and ``unpad_coef``
  give JAX's arrays, at d = 41, which C = 2 does not divide;
- the product stream's identity (ops/spmv.py ``EntryStream``) bit for
  bit through ``spmv.csr_order_reference``, the numpy specification of
  the kernels' order: the 2-D margins are the unblocked rows' bits in
  row 9 and row 10 (the card's tests, tests/test_torch_mesh2d_cuda.py,
  hold the kernels themselves);
- given the same margins, the gradient and the Hvp are the 1-D run's
  bits (each column slice's transposed product is that slice of the
  unblocked one's);
- across {none, 1x1, 2x1, 1x2, 2x2}: the meshes without a model axis
  are the unmeshed bits; with one, value, gradient and Hvp within
  float64 rtol 1e-12, and the streamed L-BFGS and TRON solves, scalar
  and grid, within atol 1e-10 of the coefficients. The CPU's plain
  product (``torch.mv`` on a sparse CSR) keeps no order of additions,
  so the stream's margins may round otherwise than the unblocked
  product's there. Resident, spilled and re-decoded replays of one
  shape are the same bits;
- the 2-D streamed run against JAX's at the parity tolerances of
  tests/test_torch_stream_objective.py (value rtol 1e-12, coefficients
  atol 1e-9): JAX's own bitwise 2-D checks fail on this tree, so JAX's
  bits are no reference;
- the feature-sharded fixed effect, dense over 2 x 2 and CSR over two
  slots, with shifts normalization and bounds, against JAX's and the
  unsharded update at tests/test_distributed.py's tolerances (value
  rtol 1e-10, coefficients atol 1e-7);
- ``DeviceFactorCache(devices=)`` places and restores as JAX's test;
- the validation errors; multi-host's no-op and a world of one on gloo;
- the training driver at ``--mesh-shape`` 1x2 and 2x2 writes the model
  of the run without the flag (coefficients within 1e-10), in the
  process (the counterpart of tests/test_mesh2d.py:513).
"""

import socket
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.algorithm import coordinates as jax_coords
from photon_ml_tpu.data import shard_cache as jax_cache
from photon_ml_tpu.data.game_data import GameDataset as JaxGameDataset
from photon_ml_tpu.data.normalization import (
    NormalizationContext as JaxNorm,
)
from photon_ml_tpu.ops import glm_objective as jax_glm
from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.ops import sharded_objective as jax_sharded
from photon_ml_tpu.ops.features import DenseFeatures as JaxDense
from photon_ml_tpu.ops.features import csr_from_scipy as jax_csr
from photon_ml_tpu.optimization import config as jax_config
from photon_ml_tpu.optimization import glm_lbfgs as jax_lbfgs
from photon_ml_tpu.parallel import distributed as jax_dist
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.algorithm.coordinates import (
    FixedEffectCoordinate,
    StreamingFixedEffectCoordinate,
)
from photon_ml_tpu_torch.cli import game_training_driver
from photon_ml_tpu_torch.data.factor_cache import (
    DeviceFactorCache,
    plan_factors,
)
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.normalization import NormalizationContext
from photon_ml_tpu_torch.data.shard_cache import DeviceShardCache
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro_codec import read_container, write_container
from photon_ml_tpu_torch.ops import spmv
from photon_ml_tpu_torch.ops.features import (
    BlockedCSRFeatures,
    DenseFeatures,
    csr_from_scipy,
)
from photon_ml_tpu_torch.ops.glm_objective import GLMObjective, make_batch
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
    make_mesh,
    make_mesh_2d,
    mesh_fold_devices,
    mesh_grid_2d,
    shard_batch_csr_feature_dim,
    shard_batch_feature_dim,
    shard_coef,
    shard_block,
    split_csr_columns,
    unpad_coef,
)
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

F64 = torch.float64
L2 = 0.7
TASK = TaskType.LOGISTIC_REGRESSION
SHAPES = (None, (1, 1), (2, 1), (1, 2), (2, 2))
CPU_RTOL = 1e-12  # value, gradient, Hvp across shapes with a model axis
SOLVE_ATOL = 1e-10  # solved coefficients across shapes with a model axis


@pytest.fixture(autouse=True)
def _join_prefetch_threads():
    yield
    for t in threading.enumerate():
        if t.name == "host-prefetch":
            t.join(timeout=10)
            assert not t.is_alive(), "a prefetch thread did not end"


class FakeStream:
    """Batches of one host matrix, for either package's GameDataset."""

    def __init__(self, problem, batch_rows, build=GameDataset.build):
        self.X, self.y, self.off, self.w = problem
        self.batch_rows, self.build = batch_rows, build

    def __iter__(self):
        n = self.X.shape[0]
        for s in range(0, n, self.batch_rows):
            e = min(n, s + self.batch_rows)
            yield self.build(responses=self.y[s:e],
                             feature_shards={"g": self.X[s:e]},
                             offsets=self.off[s:e], weights=self.w[s:e])

    def stats(self):
        return {"decode_path": "fake"}


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(19)
    n, d = 1003, 41
    X = sp.random(n, d, density=0.1, random_state=19, format="csr")
    X.data[:] = rng.normal(0, 1, X.nnz)
    X.sort_indices()
    y = (rng.random(n) < 0.5).astype(float)
    return X, y, rng.normal(0, 0.1, n), rng.gamma(1.0, 1.0, n)


def _fetch(problem):
    X, y, off, w = problem

    def fetch(row_start, n_rows):
        s = slice(row_start, row_start + n_rows)
        return GameDataset.build(responses=y[s], feature_shards={"g": X[s]},
                                 offsets=off[s], weights=w[s])

    return fetch


def _norm(d, mode):
    if mode is None:
        return None
    factors = torch.linspace(0.5, 1.5, d, dtype=F64)
    shifts = None
    if mode == "shifts":
        shifts = torch.linspace(-0.2, 0.3, d, dtype=F64)
        shifts[d - 1] = 0.0
    return NormalizationContext(factors, shifts, d - 1)


def _sobj(problem, shape=None, norm=None, batch_rows=128, dtype=F64, **kw):
    mesh, devices, cols = None, None, 1
    if shape is not None:
        mesh = make_mesh_2d(*shape, device="cpu")
        devices, cols = mesh_fold_devices(mesh), shape[1]
    if kw.get("spill_source") == "redecode":
        kw["redecode_fetch"] = _fetch(problem)
    cache = DeviceShardCache.from_stream(
        FakeStream(problem, batch_rows), "g", dtype=dtype, device="cpu",
        devices=devices, col_blocks=cols, **kw)
    return ShardedGLMObjective(GLMObjective(loss_for_task(TASK), norm),
                               cache, mesh=mesh)


def _vec(d, seed, shape=()):
    return torch.as_tensor(np.random.default_rng(seed).normal(
        0, 0.3, (*shape, d)), dtype=F64)


def _passes(sobj, coef, vec):
    z, f, g = sobj.margins_value_grad(coef, L2)
    hv = sobj.hessian_vector(vec, sobj.curvature_list(z), L2)
    return [f, g, hv, *sobj.margin_direction_list(vec)]


def _same_or_close(got, want, exact):
    for a, b in zip(got, want):
        if exact:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=CPU_RTOL, atol=CPU_RTOL)


# -- the layout functions against JAX's arrays --------------------------------


@pytest.mark.parametrize("blocks", [2, 3])
def test_split_and_csr_feature_dim_give_jax_arrays(problem, blocks):
    X = problem[0]
    bs, subs = split_csr_columns(X, blocks)
    jbs, jsubs = jax_dist.split_csr_columns(X, blocks)
    assert bs == jbs == -(-X.shape[1] // blocks)
    for a, b in zip(subs, jsubs):
        for k in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    # The CSR's column blocks on a 1-D mesh (JAX: BlockedCSRFeatures).
    y = problem[1]
    got = shard_batch_csr_feature_dim(
        make_batch(csr_from_scipy(X, F64, "cpu"), torch.as_tensor(y)),
        make_mesh(blocks, device="cpu"))
    want = jax_dist.shard_batch_csr_feature_dim(
        jax_glm.make_batch(jax_csr(X, dtype=jnp.float64), y),
        jax_dist.make_mesh(blocks)).features
    feats = got.features
    assert isinstance(feats, BlockedCSRFeatures)
    assert (feats.num_blocks, feats.block_size, feats.n_features) == (
        want.num_blocks, want.block_size, want.n_features)
    for c, blk in enumerate(feats.blocks):
        n = blk.nnz
        rows = np.repeat(np.arange(X.shape[0]), np.diff(blk.crow.numpy()))
        np.testing.assert_array_equal(blk.values.numpy(),
                                      np.asarray(want.values)[c, :n])
        np.testing.assert_array_equal(blk.col.numpy(),
                                      np.asarray(want.col_local)[c, :n])
        np.testing.assert_array_equal(rows, np.asarray(want.row_ids)[c, :n])
        assert not np.asarray(want.values)[c, n:].any()
    with pytest.raises(ValueError, match="column blocks"):
        shard_batch_csr_feature_dim(got, make_mesh(blocks + 1, device="cpu"))


def test_dense_feature_dim_and_coef_give_jax_arrays(problem):
    X, y = problem[0][:101].toarray(), problem[1][:101]
    mesh = make_mesh_2d(2, 2, device="cpu")
    jmesh = jax_dist.make_mesh_2d(2, 2)
    got = shard_batch_feature_dim(
        make_batch(DenseFeatures(torch.as_tensor(X)), torch.as_tensor(y)),
        mesh, col_axis="model", row_axis="data")
    want = jax_dist.shard_batch_feature_dim(
        jax_glm.make_batch(JaxDense(jnp.asarray(X)), y), jmesh,
        col_axis="model", row_axis="data")
    feats = got.features
    assert feats.num_features == 42 and feats.rows_per_slot == 51
    full = torch.cat([torch.cat([b.x for b in row], 1)
                      for row in feats.blocks])
    np.testing.assert_array_equal(full.numpy(), np.asarray(want.features.x))
    for k in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
    assert [[str(d) for d in row] for row in feats.devices] == [
        ["cpu"] * 2] * 2
    coef = np.random.default_rng(0).normal(size=41)
    parts = shard_coef(torch.as_tensor(coef), mesh, axis="model")
    jcoef = jax_dist.shard_coef(jnp.asarray(coef), jmesh, axis="model")
    assert [p.shape[0] for p in parts] == [21, 21]
    np.testing.assert_array_equal(torch.cat(parts).numpy(),
                                  np.asarray(jcoef))
    np.testing.assert_array_equal(
        unpad_coef(parts, 41).numpy(),
        np.asarray(jax_dist.unpad_coef(jcoef, 41)))
    # The grid accessors, as JAX reads a 2-D mesh.
    r, c, grid = mesh_grid_2d(mesh)
    assert (r, c) == (2, 2) and [d for row in grid for d in row] == \
        mesh_fold_devices(mesh)
    assert mesh_grid_2d(make_mesh(3, device="cpu"))[:2] == (3, 1)


# -- the product stream: the unblocked rows' bits, by the specification ------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 3)])
def test_product_stream_is_the_unblocked_product(problem, dtype, shape):
    X = problem[0].astype(dtype)
    chunk = 16  # small, so rows and transposes cut into chunks
    sobj = _sobj((X, *problem[1:]), shape, batch_rows=256,
                 dtype=torch.float32 if dtype == np.float32 else F64)
    cache = sobj.cache
    rng = np.random.default_rng(5)
    w = rng.normal(size=cache.col_blocks * cache.col_block_size).astype(
        dtype)
    W = rng.normal(size=(w.shape[0], 3)).astype(dtype)
    for e in cache.blocks():
        full = X[e.index * 256:e.index * 256 + e.n_rows]
        op = e.stream.op
        for x, square in ((w, False), (W, False), (w, True)):
            parts = [spmv.entry_products(
                b, torch.as_tensor(x[c * cache.col_block_size:
                                     (c + 1) * cache.col_block_size]),
                square) for c, b in enumerate(e.cols)]
            got = spmv.csr_order_reference(
                op.crow.numpy(), op.col.numpy(), op.val.numpy(),
                torch.cat(parts).numpy(), chunk)
            vals = full.data * full.data if square else full.data
            want = spmv.csr_order_reference(full.indptr, full.indices,
                                            vals.astype(dtype),
                                            x[:X.shape[1]], chunk)
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_same_margins_give_the_1d_gradient_and_hvp_bits(problem):
    d = problem[0].shape[1]
    coef, vec = _vec(d, 0), _vec(d, 1)
    ref = _sobj(problem, (2, 1))
    z, _, _ = ref.margins_value_grad(coef, L2)
    dirs = ref.margin_direction_list(vec)
    d2 = ref.curvature_list(z)
    want = (ref.grad_from_margins_list(coef, z, L2),
            ref.hessian_vector(vec, d2, L2))
    for shape in ((1, 2), (2, 2)):
        s = _sobj(problem, shape)
        by_index = {e.index: m for e, m in zip(s.cache.entries, dirs)}
        # The direction margins the 1-D run formed, in place of the
        # stream's: what remains is the transposed products and folds.
        s._margins_2d = lambda e, w_r, shift: by_index[e.index] + e.offsets
        got = (s.grad_from_margins_list(coef, z, L2),
               s.hessian_vector(vec, d2, L2))
        for a, b in zip(got, want):
            assert torch.equal(a, b), shape


@pytest.mark.parametrize("norm", [None, "factors", "shifts"])
def test_value_grad_hvp_across_shapes(problem, norm):
    d = problem[0].shape[1]
    coef, vec = _vec(d, 2), _vec(d, 3)
    want = _passes(_sobj(problem, norm=_norm(d, norm)), coef, vec)
    for shape in SHAPES[1:]:
        got = _passes(_sobj(problem, shape, _norm(d, norm)), coef, vec)
        _same_or_close(got, want, exact=shape[1] == 1)


def test_grid_passes_across_shapes(problem):
    d = problem[0].shape[1]
    coefs, vecs = _vec(d, 4, (3,)), _vec(d, 5, (3,))
    l2s = torch.tensor([0.1, 0.7, 5.0], dtype=F64)

    def passes(s):
        z, f, g = s.grid_margins_value_grad(coefs, l2s)
        hv = s.grid_hessian_vector(vecs, s.grid_curvature_list(z), l2s)
        return [f, g, hv, *s.grid_margin_direction_list(vecs)]

    want = passes(_sobj(problem))
    for shape in ((2, 1), (1, 2), (2, 2)):
        got = passes(_sobj(problem, shape))
        _same_or_close(got, want, exact=shape[1] == 1)
        # The gradient and Hvp panels keep the unmeshed layout, so the
        # solvers' reductions over them keep their order on the card.
        assert [t.stride() for t in got[:3]] == [t.stride()
                                                for t in want[:3]]


RESIDENCIES = [dict(), dict(hbm_budget_bytes=6000),
               dict(hbm_budget_bytes=6000, prefetch_depth=0),
               dict(hbm_budget_bytes=6000, spill_source="redecode"),
               dict(hbm_budget_bytes=6000, spill_dtype="bf16")]


@pytest.mark.parametrize("solver", ["lbfgs", "tron", "lbfgs-grid",
                                    "tron-grid"])
def test_streamed_solves_across_shapes_and_residency(problem, solver):
    d = problem[0].shape[1]
    grid = solver.endswith("grid")
    run = {"lbfgs": minimize_lbfgs_glm_streaming,
           "tron": minimize_tron_streaming,
           "lbfgs-grid": minimize_lbfgs_glm_grid_streaming,
           "tron-grid": minimize_tron_grid_streaming}[solver]
    x0 = torch.zeros((3, d) if grid else d, dtype=F64)
    lam = [0.1, 1.0, 10.0] if grid else L2

    def solve(shape, **kw):
        out = run(_sobj(problem, shape, **kw), x0, lam, max_iter=6,
                  tol=1e-9)
        return [r.x for r in out] if grid else [out.x]

    want = solve(None)
    resident = solve((2, 2))
    for a, b in zip(resident, want):
        torch.testing.assert_close(a, b, rtol=0, atol=SOLVE_ATOL)
    for a, b in zip(solve((1, 2), hbm_budget_bytes=6000), want):
        torch.testing.assert_close(a, b, rtol=0, atol=SOLVE_ATOL)
    # One shape: every residency gives the resident replay's bits (bf16
    # its own, deterministic ones, within bf16's rounding of the rest).
    for kw in RESIDENCIES[1:]:
        sobj_got = solve((2, 2), **kw)
        for a, b in zip(sobj_got, resident):
            if kw.get("spill_dtype") == "bf16":
                torch.testing.assert_close(a, b, rtol=0, atol=1e-2)
            else:
                assert torch.equal(a, b), kw


def test_budget_binds_per_slot_and_slices_place_on_the_grid(problem):
    budget = 4000
    sobj = _sobj(problem, (2, 2), hbm_budget_bytes=budget)
    cache = sobj.cache
    for e in cache.entries:
        r = e.index % 2
        assert e.slot == 2 * r + 1
        assert [u.slot for u in e.cols] == [2 * r, 2 * r + 1]
        assert e.cols[-1].feature_bytes > e.cols[-1].spill_bytes
    for _ in cache.blocks():
        pass
    st = cache.stats()
    assert st["col_blocks"] == 2 and st["col_block_size"] == 21
    assert st["evictions"] > 0 and len(st["per_device_bytes"]) == 4
    unit = max(u.feature_bytes for e in cache.entries for u in e.cols)
    assert max(st["per_device_bytes"]) <= budget + unit
    assert sum(st["per_device_bytes"]) == st["device_bytes"]
    held = [sum(1 for e in cache.entries for u in e.cols if u.slot == s)
            for s in range(4)]
    assert all(r < h for r, h in zip(st["per_device_resident_shards"],
                                     held))


# -- against JAX's 2-D streamed run -------------------------------------------


def test_2d_streamed_run_holds_against_jax(problem):
    d = problem[0].shape[1]
    coef = _vec(d, 6)
    jmesh = jax_dist.make_mesh_2d(2, 2)
    jcache = jax_cache.DeviceShardCache.from_stream(
        FakeStream(problem, 256, JaxGameDataset.build), "g",
        dtype=np.float64, devices=jax_dist.mesh_fold_devices(jmesh),
        col_blocks=2)
    jobj = jax_sharded.ShardedGLMObjective(
        jax_glm.GLMObjective(jax_losses.loss_for_task(
            JaxTaskType.LOGISTIC_REGRESSION)), jcache, mesh=jmesh)
    sobj = _sobj(problem, (2, 2), batch_rows=256)
    f, g = sobj.value_and_grad(coef, L2)
    jf, jg = jobj.value_and_grad(jnp.asarray(coef.numpy()), L2)
    np.testing.assert_allclose(float(f), float(jf), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-12,
                               atol=1e-12)
    got = minimize_lbfgs_glm_streaming(sobj, torch.zeros(d, dtype=F64), L2,
                                       max_iter=8, tol=1e-9)
    want = jax_lbfgs.minimize_lbfgs_glm_streaming(
        jobj, jnp.zeros(d), L2, max_iter=8, tol=1e-9)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-9)
    assert int(got.iterations) == int(want.iterations)


# -- the in-core feature-sharded fixed effect ---------------------------------


def _fe_data(rng, sparse):
    n, d = 90, 7
    x = rng.normal(0, 1.0, (n, d))
    if sparse:
        x[rng.random((n, d)) < 0.85] = 0.0
    x[:, d - 1] = 1.0
    y = (rng.random(n) < 0.5).astype(np.float64)
    shifts = x.mean(axis=0)
    shifts[d - 1] = 0.0
    factors = 1.0 / (x.std(axis=0) + 0.5)
    factors[d - 1] = 1.0
    return dict(responses=y, feature_shards={"g": sp.csr_matrix(x)}), \
        factors, shifts


@pytest.mark.parametrize("layout", ["dense-2x2", "csr-2"])
def test_feature_sharded_fixed_effect(layout):
    rng = np.random.default_rng(23)
    cols, factors, shifts = _fe_data(rng, layout.startswith("csr"))
    d = factors.shape[0]
    cfg = "40,1e-9,0.5,1.0,LBFGS,L2"
    lower = np.full(d, -0.8)
    upper = np.full(d, 0.9)
    mesh = (make_mesh_2d(2, 2, device="cpu") if layout == "dense-2x2"
            else make_mesh(2, device="cpu"))
    jmesh = (jax_dist.make_mesh_2d(2, 2) if layout == "dense-2x2"
             else jax_dist.make_mesh(2))

    def port(m, sharding):
        fe = FixedEffectCoordinate(
            "fixed", GameDataset.build(**cols), "g", TASK,
            GLMOptimizationConfiguration.parse(cfg),
            normalization=NormalizationContext(
                torch.as_tensor(factors), torch.as_tensor(shifts), d - 1),
            dtype=F64, device="cpu", lower_bounds=lower, upper_bounds=upper,
            mesh=m, feature_sharding=sharding)
        model, res = fe.update_model(fe.initialize_model(), None)
        return fe, model, res

    fe, model, res = port(mesh, True)
    assert fe._d_pad == 8 and res.x.shape == (8,)
    assert float(res.x[d:].abs().max()) == 0.0  # padding stays 0
    _, one, one_res = port(None, False)
    jfe = jax_coords.FixedEffectCoordinate(
        name="fixed", data=JaxGameDataset.build(**cols),
        feature_shard_id="g", task_type=JaxTaskType.LOGISTIC_REGRESSION,
        config=jax_config.GLMOptimizationConfiguration.parse(cfg),
        lower_bounds=jnp.asarray(lower), upper_bounds=jnp.asarray(upper),
        normalization=JaxNorm(jnp.asarray(factors), jnp.asarray(shifts),
                              d - 1),
        dtype=jnp.float64, mesh=jmesh, feature_sharding=True)
    import jax

    jmodel, jres = jfe.update_model(jfe.initialize_model(), None,
                                    jax.random.PRNGKey(0))
    got = model.glm.coefficients.means.numpy()
    for ref, ref_val in ((np.asarray(jmodel.glm.coefficients.means),
                          float(jres.value)),
                         (one.glm.coefficients.means.numpy(),
                          float(one_res.value))):
        np.testing.assert_allclose(float(res.value), ref_val, rtol=1e-10)
        np.testing.assert_allclose(got, ref, atol=1e-7)
    assert float(np.abs(got).max()) > 1e-3
    torch.testing.assert_close(fe.score(model), fe.score(one), rtol=0,
                               atol=1e-7)
    if layout == "dense-2x2":
        # A CSR cannot shard rows and columns at once, as in JAX.
        x = sp.csr_matrix(np.eye(4))
        with pytest.raises(ValueError, match="only available for dense"):
            shard_batch_feature_dim(
                make_batch(csr_from_scipy(x, F64, "cpu"),
                           torch.zeros(4, dtype=F64)), mesh,
                col_axis="model", row_axis="data")


def test_entities_shard_over_the_data_rows(rng):
    from photon_ml_tpu_torch.data.random_effect import (
        RandomEffectDataConfiguration,
        build_random_effect_dataset,
    )

    n = 60
    ds = build_random_effect_dataset(
        GameDataset.build(responses=(rng.random(n) < 0.5).astype(float),
                          feature_shards={"u": sp.csr_matrix(
                              rng.normal(0, 1, (n, 3)))},
                          ids={"userId": (np.arange(n) % 7).astype(str)}),
        RandomEffectDataConfiguration("userId", "u"), dtype=F64,
        device="cpu")
    mesh = make_mesh_2d(2, 3, device="cpu")
    for b in ds.blocks:
        slots = shard_block(b, mesh, n)
        # One range a data row (R = 2), not one a slot (R x C = 6).
        assert len(slots) == 2
        assert sum(s.x.shape[0] for s in slots) == -(-b.x.shape[0] // 2) * 2


# -- the factor cache's placement ---------------------------------------------


def test_factor_cache_device_placement(rng):
    vocab = np.asarray([f"e{i}" for i in range(24)])
    counts = rng.integers(0, 9, size=24)
    plan = plan_factors(vocab, counts, entities_per_shard=4)
    k = 3
    tables = [torch.as_tensor(rng.normal(0, 1, (s.e_pad, k)))
              for s in plan.shards]
    devs = [torch.device("cpu")] * 2
    placed = DeviceFactorCache(plan, k, dtype=F64, device="cpu",
                               devices=devs)
    plain = DeviceFactorCache(plan, k, dtype=F64, device="cpu")
    for i, t in enumerate(tables):
        assert torch.equal(placed.write(i, t), plain.write(i, t))
        assert placed.shard_device(i) == devs[i % 2]
    assert plain.shard_device(0) is None
    assert placed.stats()["devices"] == 2
    assert plain.stats()["devices"] is None
    one = plan.shards[0].e_pad * k * 8
    tight = DeviceFactorCache(plan, k, hbm_budget_bytes=one + 1, dtype=F64,
                              device="cpu", devices=devs)
    for i, t in enumerate(tables):
        tight.write(i, t)
    assert tight.stats()["evictions"] > 0
    for i in range(len(tables)):
        g = tight.ensure(i)
        assert torch.equal(g, plain.ensure(i)) and g.device == devs[i % 2]


# -- validation, multi-host ---------------------------------------------------


def test_validation_errors(problem):
    obj = GLMObjective(loss_for_task(TASK))
    mesh = make_mesh_2d(2, 2, device="cpu")
    devices = mesh_fold_devices(mesh)
    one_col = DeviceShardCache.from_stream(
        FakeStream(problem, 200), "g", dtype=F64, device="cpu",
        devices=devices, col_blocks=1)
    with pytest.raises(ValueError, match="col_blocks"):
        ShardedGLMObjective(obj, one_col, mesh=mesh)
    two_col = DeviceShardCache.from_stream(
        FakeStream(problem, 200), "g", dtype=F64, device="cpu",
        devices=devices, col_blocks=2)
    with pytest.raises(ValueError, match="model axis"):
        ShardedGLMObjective(obj, two_col, mesh=mesh, combine="local")
    with pytest.raises(ValueError, match="multiple of col_blocks"):
        DeviceShardCache.from_stream(
            FakeStream(problem, 200), "g", dtype=F64, device="cpu",
            devices=devices[:3], col_blocks=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh_2d(2, 2)  # "cuda" on a host without a card
    with pytest.raises(ValueError, match="extents"):
        make_mesh_2d(0, 2, device="cpu")
    with pytest.raises(ValueError, match="1-D mesh"):
        from photon_ml_tpu_torch.parallel import mesh_device_list

        mesh_device_list(mesh)
    # The streaming coordinate over the 2-D mesh writes the unmeshed
    # model within the CPU's tolerance.
    cfg = GLMOptimizationConfiguration.parse("5,1e-6,1.0,1.0,LBFGS,L2")

    def solve(cache, m):
        coord = StreamingFixedEffectCoordinate(
            name="fe", cache=cache, feature_shard_id="g", task_type=TASK,
            config=cfg, dtype=F64, mesh=m)
        return coord.solve()[0].glm.coefficients.means

    flat = DeviceShardCache.from_stream(FakeStream(problem, 200), "g",
                                        dtype=F64, device="cpu")
    torch.testing.assert_close(solve(two_col, mesh), solve(flat, None),
                               rtol=0, atol=SOLVE_ATOL)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_multihost_noop_and_world_of_one(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_multihost() is False
    assert is_primary_host() is True
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("NUM_PROCESSES", "1")
    monkeypatch.setenv("PROCESS_ID", "0")
    try:
        assert initialize_multihost(device="cpu", timeout=30) is True
        assert is_primary_host() is True
        t = torch.ones(3)
        torch.distributed.all_reduce(t)
        assert t.tolist() == [1.0, 1.0, 1.0]
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="NUM_PROCESSES"):
        monkeypatch.delenv("NUM_PROCESSES")
        initialize_multihost(device="cpu", timeout=5)


# -- the driver: --mesh-shape RxC writes the unmeshed model -------------------


def _records(out):
    return list(read_container(out / "best" / "fixed-effect" / "fixed"
                               / "coefficients" / "part-00000.avro"))


def test_driver_mesh_shape_writes_the_unmeshed_model(tmp_path):
    from test_torch_mesh_fold import _generator

    gen = _generator()
    rng = np.random.default_rng(43)
    train = tmp_path / "train"
    train.mkdir()
    write_container(train / "part-00000.avro", schemas.TRAINING_EXAMPLE,
                    gen.game_records(rng, 300, rng.normal(0, 1, 5),
                                     rng.normal(0, 1.5, 24)),
                    sync_interval=2048)
    base = ["--train-input-dirs", str(train),
            "--task-type", "LOGISTIC_REGRESSION",
            "--fixed-effect-data-configurations", "fixed:global",
            "--fixed-effect-optimization-configurations",
            "fixed:30,1e-7,0.5,1.0,LBFGS,L2",
            "--updating-sequence", "fixed", "--stream-train",
            "--batch-rows", "48", "--hbm-budget", "4K"]
    game_training_driver.run([*base, "--output-dir", str(tmp_path / "no")],
                             device="cpu")
    want = _records(tmp_path / "no")
    for shape in ("1x2", "2x2"):
        out = tmp_path / shape
        info = game_training_driver.run(
            [*base, "--mesh-shape", shape, "--output-dir", str(out)],
            device="cpu")["stream_train"]
        r, c = (int(v) for v in shape.split("x"))
        assert list(info["mesh_shape"]) == [r, c]
        assert info["cache"]["col_blocks"] == c
        assert info["cache"]["evictions"] > 0
        got = _records(out)
        assert [(m["name"], m["term"]) for m in got[0]["means"]] == [
            (m["name"], m["term"]) for m in want[0]["means"]]
        np.testing.assert_allclose(
            [m["value"] for m in got[0]["means"]],
            [m["value"] for m in want[0]["means"]], rtol=0,
            atol=SOLVE_ATOL)
