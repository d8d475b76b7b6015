"""The streamed solve over a 1-D mesh of slots (ops/sharded_objective.py
``mesh=``/``combine=``, data/shard_cache.py ``devices=``, the training
driver's ``--mesh-devices``) on the CPU, float64: the port's counterpart
of tests/test_mesh_fold.py.

- value, gradient and Hvp are the same bits over 1, 2 and 4 slots and
  without a mesh (the ordered fold adds the partials in shard order);
  so are the streaming L-BFGS and TRON solves, scalar and λ grid, and
  resident, spilled and re-decoded replays under a mesh;
- ``combine="local"`` stays within |Δ| <= (S - 1) eps sum_i |p_i| of the
  ordered fold (sharded_objective.py:69-75) and IS the ordered fold at
  one slot;
- the budget binds per slot and blocks place round-robin;
- the validation errors and the coordinate/objective mesh mismatch;
- each result holds against JAX's mesh run (its harness's virtual CPU
  devices) at tests/test_torch_stream_objective.py's tolerances (value
  rtol 1e-12, coefficients atol 1e-9), not its bits: JAX's own bitwise
  mesh checks fail on this tree;
- the training driver at ``--mesh-devices`` 1, 2 and 4 writes the model
  of the run without the flag, bit for bit (the counterpart of
  tests/test_mesh_fold.py:407, in the process).
"""

import importlib.util
import threading
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.data import shard_cache as jax_cache
from photon_ml_tpu.data.game_data import GameDataset as JaxGameDataset
from photon_ml_tpu.ops import glm_objective as jax_glm
from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.ops import sharded_objective as jax_sharded
from photon_ml_tpu.optimization import glm_lbfgs as jax_lbfgs
from photon_ml_tpu.parallel import make_mesh as jax_mesh
from photon_ml_tpu.parallel import mesh_device_list as jax_devices
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.algorithm.coordinates import (
    StreamingFixedEffectCoordinate,
)
from photon_ml_tpu_torch.cli import game_training_driver
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.shard_cache import DeviceShardCache
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro_codec import read_container, write_container
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
from photon_ml_tpu_torch.parallel import make_mesh, mesh_device_list
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

F64 = torch.float64
L2 = 0.7
TASK = TaskType.LOGISTIC_REGRESSION
REPO = Path(__file__).resolve().parents[1]
EPS64 = float(np.finfo(np.float64).eps)


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
    rng = np.random.default_rng(31)
    n, d = 1003, 41
    X = sp.random(n, d, density=0.1, random_state=11, format="csr")
    X.data[:] = rng.normal(0, 1, X.nnz)
    X = sp.hstack([X, np.ones((n, 1))], format="csr")
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


def _sobj(problem, slots=None, combine="ordered", batch_rows=128, **kw):
    mesh = None if slots is None else make_mesh(slots, device="cpu")
    if kw.get("spill_source") == "redecode":
        kw["redecode_fetch"] = _fetch(problem)
    cache = DeviceShardCache.from_stream(
        FakeStream(problem, batch_rows), "g", dtype=F64, device="cpu",
        devices=None if mesh is None else mesh_device_list(mesh), **kw)
    return ShardedGLMObjective(GLMObjective(loss_for_task(TASK)), cache,
                               mesh=mesh, combine=combine)


def _vec(problem, seed):
    return torch.as_tensor(np.random.default_rng(seed).normal(
        0, 0.3, problem[0].shape[1]), dtype=F64)


def _passes(sobj, coef, vec):
    z, f, g = sobj.margins_value_grad(coef, L2)
    hv = sobj.hessian_vector(vec, sobj.curvature_list(z), L2)
    return f, g, hv


SLOT_COUNTS = [None, 1, 2, 4]


def test_value_grad_hvp_bitwise_across_slot_counts(problem):
    coef, vec = _vec(problem, 0), _vec(problem, 1)
    want = _passes(_sobj(problem), coef, vec)
    for slots in SLOT_COUNTS[1:]:
        got = _passes(_sobj(problem, slots), coef, vec)
        for a, b in zip(got, want):
            assert torch.equal(a, b), slots


RESIDENCIES = [dict(), dict(hbm_budget_bytes=6000),
               dict(hbm_budget_bytes=6000, prefetch_depth=0),
               dict(hbm_budget_bytes=6000, spill_source="redecode")]


@pytest.mark.parametrize("solver", ["lbfgs", "tron"])
def test_streaming_solves_bitwise_across_slots_and_residency(problem,
                                                             solver):
    run = (minimize_lbfgs_glm_streaming if solver == "lbfgs"
           else minimize_tron_streaming)
    d = problem[0].shape[1]
    want = run(_sobj(problem), torch.zeros(d, dtype=F64), L2, max_iter=8,
               tol=1e-9)
    for slots in (2, 4):
        for kw in RESIDENCIES:
            sobj = _sobj(problem, slots, **kw)
            got = run(sobj, torch.zeros(d, dtype=F64), L2, max_iter=8,
                      tol=1e-9)
            assert torch.equal(got.x, want.x), (slots, kw)
            assert int(got.iterations) == int(want.iterations)
            if kw:
                assert sobj.cache.stats()["evictions"] > 0


@pytest.mark.parametrize("solver", ["lbfgs", "tron"])
def test_grid_solves_bitwise_across_slots(problem, solver):
    run = (minimize_lbfgs_glm_grid_streaming if solver == "lbfgs"
           else minimize_tron_grid_streaming)
    d = problem[0].shape[1]
    x0 = torch.zeros((3, d), dtype=F64)
    want = run(_sobj(problem), x0, [0.1, 1.0, 10.0], max_iter=6, tol=1e-9)
    for slots in (2, 4):
        got = run(_sobj(problem, slots, hbm_budget_bytes=6000), x0,
                  [0.1, 1.0, 10.0], max_iter=6, tol=1e-9)
        for a, b in zip(got, want):
            assert torch.equal(a.x, b.x), slots
            assert int(a.iterations) == int(b.iterations)


def test_local_combine_within_its_bound(problem):
    coef, vec = _vec(problem, 2), _vec(problem, 3)
    ordered = _sobj(problem, 4)
    f_o, g_o, h_o = _passes(ordered, coef, vec)
    f_l, g_l, h_l = _passes(_sobj(problem, 4, "local"), coef, vec)
    # |p_i| summed over the S per-shard partials of each quantity.
    abs_val = abs_g = 0
    for e in ordered.cache.blocks():
        _, (val, g_raw, _) = ordered._init(e, coef)
        abs_val = abs_val + abs(val)
        abs_g = abs_g + g_raw.abs()
    s = ordered.cache.n_shards
    assert s >= 8
    assert float(abs(f_l - f_o)) <= (s - 1) * EPS64 * float(abs_val)
    assert torch.all((g_l - g_o).abs() <= (s - 1) * EPS64 * abs_g
                     + 1e-300)
    torch.testing.assert_close(h_l, h_o, rtol=1e-12, atol=1e-12)
    # One slot: the local fold is the ordered fold.
    one = _passes(_sobj(problem, 1, "local"), coef, vec)
    for a, b in zip(one, _passes(_sobj(problem), coef, vec)):
        assert torch.equal(a, b)


def test_per_slot_budget_and_round_robin_placement(problem):
    budget = 6000
    sobj = _sobj(problem, 2, hbm_budget_bytes=budget)
    cache = sobj.cache
    assert [e.slot for e in cache.entries] == [
        i % 2 for i in range(cache.n_shards)]
    for _ in cache.blocks():
        pass
    st = cache.stats()
    assert st["mesh_devices"] == 2 and len(st["per_device_bytes"]) == 2
    block = max(e.feature_bytes for e in cache.entries)
    assert max(st["per_device_bytes"]) <= budget + block
    assert sum(st["per_device_bytes"]) == st["device_bytes"]
    assert st["evictions"] > 0
    # The budget binds each slot: two slots hold more than one would.
    one = _sobj(problem, None, hbm_budget_bytes=budget).cache
    assert st["device_bytes"] > one.stats()["device_bytes"]


def test_mesh_validation_errors(problem):
    obj = GLMObjective(loss_for_task(TASK))
    mesh2 = make_mesh(2, device="cpu")
    flat = _sobj(problem).cache
    placed = _sobj(problem, 2).cache
    with pytest.raises(ValueError, match="same devices"):
        ShardedGLMObjective(obj, flat, mesh=mesh2)
    with pytest.raises(ValueError, match="without a mesh"):
        ShardedGLMObjective(obj, placed)
    with pytest.raises(ValueError, match="same devices"):
        ShardedGLMObjective(obj, placed, mesh=make_mesh(4, device="cpu"))
    with pytest.raises(ValueError, match="combine must be"):
        ShardedGLMObjective(obj, placed, mesh=mesh2, combine="tree")
    with pytest.raises(TypeError, match="Mesh"):
        ShardedGLMObjective(obj, placed, mesh=object())
    # col_blocks=2 (which raised naming A6b) builds a column-blocked
    # cache, which a 1-D mesh's objective refuses.
    blocked = DeviceShardCache.from_stream(
        FakeStream(problem, 128), "g", dtype=F64, device="cpu",
        devices=["cpu", "cpu"], col_blocks=2)
    assert blocked.stats()["col_blocks"] == 2
    with pytest.raises(ValueError, match="col_blocks=2"):
        ShardedGLMObjective(obj, blocked, mesh=mesh2)


def test_streaming_coordinate_mesh_mismatch(problem):
    cfg = GLMOptimizationConfiguration.parse("10,1e-9,0.7,1.0,LBFGS,L2")
    sobj = _sobj(problem, 2)
    coord = StreamingFixedEffectCoordinate(
        name="fixed", cache=sobj.cache, feature_shard_id="g", task_type=TASK,
        config=cfg, dtype=F64, sharded_objective=sobj,
        mesh=make_mesh(2, device="cpu"))
    assert coord.sharded_objective is sobj
    with pytest.raises(ValueError, match="same mesh"):
        StreamingFixedEffectCoordinate(
            name="fixed", cache=sobj.cache, feature_shard_id="g",
            task_type=TASK, config=cfg, dtype=F64, sharded_objective=sobj)


def test_fold_spans_and_mesh_metrics(problem):
    telemetry.reset()
    telemetry.enable()
    try:
        sobj = _sobj(problem, 2, "local")
        sobj.value_and_grad(_vec(problem, 0), L2)
        names = set(telemetry.stage_attribution())
        snap = telemetry.registry().snapshot()
    finally:
        telemetry.disable()
        telemetry.reset()
    assert {"accumulate", "device_fold:d0", "device_fold:d1",
            "cross_device_combine"} <= names
    assert snap["gauges"]["training.mesh.data_axis_devices"] == 2
    # Slots of one device move no partial between devices.
    assert snap["counters"].get(
        "training.mesh.data_axis_transfer_bytes", 0) == 0


def _jax_sobj(problem, n):
    mesh = jax_mesh(n)
    cache = jax_cache.DeviceShardCache.from_stream(
        FakeStream(problem, 128, JaxGameDataset.build), "g",
        dtype=np.float64, devices=jax_devices(mesh))
    return jax_sharded.ShardedGLMObjective(
        jax_glm.GLMObjective(jax_losses.loss_for_task(
            JaxTaskType.LOGISTIC_REGRESSION)), cache, mesh=mesh)


@pytest.mark.parametrize("n_slots", [2])
def test_mesh_solve_holds_against_jax_mesh_run(problem, n_slots):
    import jax.numpy as jnp

    d = problem[0].shape[1]
    coef = _vec(problem, 5)
    sobj = _sobj(problem, n_slots)
    jobj = _jax_sobj(problem, n_slots)
    f, g = sobj.value_and_grad(coef, L2)
    jf, jg = jobj.value_and_grad(jnp.asarray(coef.numpy()), L2)
    np.testing.assert_allclose(float(f), float(jf), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-12,
                               atol=1e-12)
    got = minimize_lbfgs_glm_streaming(sobj, torch.zeros(d, dtype=F64), L2,
                                       max_iter=10, tol=1e-9)
    want = jax_lbfgs.minimize_lbfgs_glm_streaming(
        jobj, jnp.zeros(d), L2, max_iter=10, tol=1e-9)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-9)
    assert int(got.iterations) == int(want.iterations)
    assert int(got.reason) == int(want.reason)


# -- the driver: --mesh-devices N writes the unmeshed model -------------------


def _generator():
    spec = importlib.util.spec_from_file_location(
        "generate_example_data",
        REPO / "examples" / "generate_example_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _records(out: Path):
    return list(read_container(out / "best" / "fixed-effect" / "fixed"
                               / "coefficients" / "part-00000.avro"))


def test_driver_model_bytes_independent_of_slot_count(tmp_path):
    gen = _generator()
    rng = np.random.default_rng(41)
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
            "fixed:30,1e-7,0.5,1.0,LBFGS,L2|30,1e-7,5.0,1.0,LBFGS,L2",
            "--updating-sequence", "fixed", "--stream-train",
            "--batch-rows", "48", "--hbm-budget", "4K"]
    game_training_driver.run([*base, "--output-dir", str(tmp_path / "no")],
                             device="cpu")
    want = _records(tmp_path / "no")
    for n in (1, 2, 4):
        out = tmp_path / f"n{n}"
        summary = game_training_driver.run(
            [*base, "--mesh-devices", str(n), "--output-dir", str(out)],
            device="cpu")
        assert _records(out) == want, n
        info = summary["stream_train"]
        assert info["mesh_devices"] == n
        assert info["cache"]["mesh_devices"] == (n if n > 1 else None)
        assert info["grid_batched"] is True
