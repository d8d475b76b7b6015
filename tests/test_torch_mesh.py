"""The in-core 1-D mesh against the JAX package (parallel/distributed.py,
the coordinates' and GameEstimator's ``mesh=``), float64 on the CPU.

JAX runs on its harness's 8 virtual CPU devices (``make_mesh(N)``), the
port on N CPU slots (``make_mesh(N, device="cpu")``), N = 2 and 4 (the
entity updates and the fit against JAX at N = 2, whose compiles are the
file's largest cost):

- ``shard_batch`` and ``shard_block`` give JAX's padded arrays (rows,
  entities) at sizes that do not divide N: 101 rows, 13 and 9 entities;
- the sharded dense L-BFGS and CSR TRON solves hold against JAX's mesh
  run and the port's one-device solve at JAX's own tolerances
  (tests/test_distributed.py:38-76: value rtol 1e-10 dense and 1e-9
  CSR, coefficients atol 1e-7);
- a sharded random-effect coordinate's update holds against JAX's mesh
  update (coefficients atol 1e-7, equal iterations and reasons, padding
  entities included) and the port's unsharded update (equal iterations
  and reasons, coefficients within 1e-14: the plain version's batched
  products may round by the batch's entity count on the CPU, where the
  card's kernel solves each entity in a warp of its own and
  tests/test_torch_mesh_cuda.py holds the bits); under shifts
  normalization its padding entities do not trip the intercept check
  (tests/test_kernel_norm_bounds.py:455-490);
- each slot owns a copy of its own range (of a sharded bucket, of a
  sharded dense batch), and a coordinate sharded once keeps no unsharded
  copy;
- GameEstimator's coordinate-descent objective history is the same
  across 1, 2 and 4 slots within rtol 1e-5 (JAX's CD tolerance,
  tests/test_coordinate_descent.py:149-187) and agrees with JAX's mesh
  fit at N = 2 at the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.algorithm import coordinates as jax_coords
from photon_ml_tpu.data.game_data import GameDataset as JaxGameDataset
from photon_ml_tpu.data.normalization import (
    NormalizationContext as JaxNorm,
)
from photon_ml_tpu.data.random_effect import (
    RandomEffectDataConfiguration as JaxREConfig,
    build_random_effect_dataset as jax_build_re,
)
from photon_ml_tpu.estimators import game_estimator as jax_est
from photon_ml_tpu.ops import DenseFeatures as JaxDense
from photon_ml_tpu.ops import GLMObjective as JaxObjective
from photon_ml_tpu.ops import LogisticLoss as JaxLogistic
from photon_ml_tpu.ops.features import csr_from_scipy as jax_csr
from photon_ml_tpu.ops.glm_objective import make_batch as jax_batch
from photon_ml_tpu.optimization import config as jax_config
from photon_ml_tpu.optimization import minimize_lbfgs as jax_lbfgs
from photon_ml_tpu.optimization import minimize_tron as jax_tron
from photon_ml_tpu.parallel import make_mesh as jax_mesh
from photon_ml_tpu.parallel import replicate as jax_replicate
from photon_ml_tpu.parallel import shard_batch as jax_shard_batch
from photon_ml_tpu.parallel import shard_block as jax_shard_block
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.algorithm.coordinates import (
    FactoredRandomEffectCoordinate,
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.normalization import NormalizationContext
from photon_ml_tpu_torch.data.random_effect import (
    RandomEffectDataConfiguration,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.estimators import game_estimator as est
from photon_ml_tpu_torch.ops.features import DenseFeatures, csr_from_scipy
from photon_ml_tpu_torch.ops.glm_objective import GLMObjective, make_batch
from photon_ml_tpu_torch.ops.losses import LogisticLoss
from photon_ml_tpu_torch.optimization.config import (
    FactoredRandomEffectOptimizationConfiguration,
    GLMOptimizationConfiguration,
)
from photon_ml_tpu_torch.optimization.lbfgs import minimize_lbfgs
from photon_ml_tpu_torch.optimization.tron import minimize_tron
from photon_ml_tpu_torch.parallel import (
    Mesh,
    make_mesh,
    make_mesh_2d,
    mesh_device_list,
    replicate,
    shard_batch,
    shard_block,
    shard_coef,
    split_csr_columns,
)
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

F64 = torch.float64
SLOTS = [2, 4]
RE_CFG = "20,1e-6,1.0,1.0,LBFGS,L2"


def _mesh(n):
    return make_mesh(n, device="cpu")


def _np(t):
    return t.detach().cpu().numpy()


def _logistic(rng, n=101, d=6):
    x = rng.normal(0, 1, (n, d))
    x[:, -1] = 1.0
    y = (rng.random(n) < 0.5).astype(np.float64)
    return x, y


# -- the mesh itself ----------------------------------------------------------


def test_slot_rule_and_two_d_names_raise():
    m = make_mesh(3, device="cpu")
    assert m.shape == {"data": 3} and m.size == 3
    assert m.distinct_devices == 1
    assert "3 slots on 1 distinct device" in m.describe()
    assert mesh_device_list(m) == [torch.device("cpu")] * 3
    assert make_mesh(device="cpu").size == 1
    with pytest.raises(ValueError, match="at least one slot"):
        make_mesh(0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(2)  # "cuda" on a host without a card
    with pytest.raises(TypeError, match="Mesh"):
        mesh_device_list(object())
    # The four calls that raised naming A6b build the 2-D mesh and its
    # arrays now (tests/test_torch_mesh2d.py holds them against JAX's).
    m2 = make_mesh_2d(2, 2, device="cpu")
    assert m2.shape == {"data": 2, "model": 2} and m2.size == 4
    assert "2 x 2 slots on 1 distinct device" in m2.describe()
    bs, subs = split_csr_columns(sp.eye(3, format="csr"), 2)
    assert bs == 2 and [s_.shape for s_ in subs] == [(3, 2), (3, 1)]
    assert [s_.nnz for s_ in subs] == [2, 1]
    parts = shard_coef(torch.arange(3.0), m)
    assert [p.tolist() for p in parts] == [[0.0], [1.0], [2.0]]
    grid = Mesh((torch.device("cpu"),) * 4, ("data", "model"), (2, 2))
    assert grid.shape == m2.shape and grid.devices == m2.devices
    with pytest.raises(ValueError, match="needs dims"):
        Mesh((torch.device("cpu"),) * 4, ("data", "model"))
    x = torch.arange(3.0)
    assert all(r is x for r in replicate(x, m))


# -- shard_batch / shard_block against JAX's arrays ---------------------------


@pytest.mark.parametrize("n_slots", SLOTS)
def test_shard_batch_dense_and_csr_arrays_equal_jax(rng, n_slots):
    x, y = _logistic(rng)
    off = rng.normal(0, 0.1, len(y))
    jm = jax_mesh(n_slots)
    mesh = _mesh(n_slots)
    # dense
    want = jax_shard_batch(jax_batch(JaxDense(jnp.asarray(x)), y, off),
                           jm)
    got = shard_batch(make_batch(DenseFeatures(torch.as_tensor(x)),
                                 torch.as_tensor(y), torch.as_tensor(off)),
                      mesh)
    n_pad = -(-len(y) // n_slots) * n_slots
    assert got.labels.shape[0] == want.labels.shape[0] == n_pad
    for a, b in ((got.labels, want.labels), (got.offsets, want.offsets),
                 (got.weights, want.weights)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    slots = got.features.slots
    assert len(slots) == n_slots
    assert {s.x.shape[0] for s in slots} == {n_pad // n_slots}
    np.testing.assert_array_equal(
        np.concatenate([_np(s.x) for s in slots]),
        np.asarray(want.features.x))
    # CSR: JAX pads the nnz stream with zeros at (0, 0); the port cuts
    # rows. Both hold the padded matrix.
    mat = sp.random(len(y), 9, density=0.3, random_state=3, format="csr")
    want = jax_shard_batch(jax_batch(jax_csr(mat, dtype=jnp.float64), y),
                           jm)
    got = shard_batch(make_batch(csr_from_scipy(mat, F64, "cpu"),
                                 torch.as_tensor(y)), mesh)
    jf = want.features
    dense_want = sp.coo_matrix(
        (np.asarray(jf.values), (np.asarray(jf.row_ids),
                                 np.asarray(jf.col_ids))),
        shape=(n_pad, 9)).toarray()
    dense_got = np.concatenate([
        _np(s.csr.to_dense()) for s in got.features.slots])
    np.testing.assert_array_equal(dense_got, dense_want)
    np.testing.assert_array_equal(_np(got.weights), np.asarray(want.weights))


def _re_data(rng, n=120, n_users=13, d=3):
    # Every user holds n // n_users or one more rows: one or two buckets,
    # so the JAX side compiles few shapes.
    users = rng.permutation(np.arange(n) % n_users)
    return dict(
        responses=(rng.random(n) < 0.4).astype(float),
        feature_shards={"u": sp.csr_matrix(rng.normal(0, 1, (n, d)))},
        ids={"userId": users.astype(str)})


@pytest.mark.parametrize("n_slots", SLOTS)
@pytest.mark.parametrize("n_users", [13, 9])
def test_shard_block_arrays_equal_jax(rng, n_slots, n_users):
    cols = _re_data(rng, n_users=n_users)
    jds = jax_build_re(JaxGameDataset.build(**cols),
                       JaxREConfig("userId", "u"), intercept_col=0)
    ds = build_random_effect_dataset(
        GameDataset.build(**cols), RandomEffectDataConfiguration(
            "userId", "u"), intercept_col=0, dtype=F64, device="cpu")
    jm, mesh = jax_mesh(n_slots), _mesh(n_slots)
    for jb, b in zip(jds.blocks, ds.blocks):
        want = jax_shard_block(jb, jm, sentinel_row=jds.n_rows)
        got = shard_block(b, mesh, ds.n_rows)
        assert len(got) == n_slots
        assert want.num_entities % n_slots == 0
        assert {s.num_entities for s in got} == {
            want.num_entities // n_slots}
        for name in ("x", "labels", "offsets", "weights", "row_ids",
                     "feat_idx"):
            np.testing.assert_array_equal(
                np.concatenate([_np(getattr(s, name)) for s in got]),
                np.asarray(getattr(want, name)), err_msg=name)


# -- the sharded solves against JAX's mesh run --------------------------------


@pytest.mark.parametrize("n_slots", SLOTS)
def test_sharded_dense_solve_matches_jax_and_single_device(rng, n_slots):
    x, y = _logistic(rng)
    jobj = JaxObjective(JaxLogistic)
    jm = jax_mesh(n_slots)
    jplain = jax_batch(JaxDense(jnp.asarray(x)), y)
    jres = jax_lbfgs(lambda w, b: jobj.value(w, b, 0.3),
                     jax_replicate(jnp.zeros(6), jm),
                     args=(jax_shard_batch(jplain, jm),), tol=1e-10)
    obj = GLMObjective(LogisticLoss)
    plain = make_batch(DenseFeatures(torch.as_tensor(x)), torch.as_tensor(y))
    one = minimize_lbfgs(obj.value_and_grad, torch.zeros(6, dtype=F64),
                         args=(plain, 0.3), tol=1e-10)
    got = minimize_lbfgs(obj.value_and_grad, torch.zeros(6, dtype=F64),
                         args=(shard_batch(plain, _mesh(n_slots)), 0.3),
                         tol=1e-10)
    for ref_val, ref_x in ((float(jres.value), np.asarray(jres.x)),
                           (float(one.value), _np(one.x))):
        np.testing.assert_allclose(float(got.value), ref_val, rtol=1e-10)
        np.testing.assert_allclose(_np(got.x), ref_x, atol=1e-7)


@pytest.mark.parametrize("n_slots", SLOTS)
def test_sharded_csr_tron_solve_matches_jax_and_single_device(rng, n_slots):
    n, d = 121, 10
    mat = sp.random(n, d, density=0.3, random_state=11, format="csr")
    y = (rng.random(n) < 0.5).astype(np.float64)
    jobj = JaxObjective(JaxLogistic)
    jm = jax_mesh(n_slots)
    jres = jax_tron(lambda w, b: jobj.value(w, b, 0.1),
                    jax_replicate(jnp.zeros(d), jm),
                    args=(jax_shard_batch(jax_batch(
                        jax_csr(mat, dtype=jnp.float64), y), jm),), tol=1e-8)
    obj = GLMObjective(LogisticLoss)
    plain = make_batch(csr_from_scipy(mat, F64, "cpu"), torch.as_tensor(y))

    def tron(batch):
        return minimize_tron(obj.value_and_grad, torch.zeros(d, dtype=F64),
                             args=(batch, 0.1), tol=1e-8,
                             make_hvp=obj.make_tron_hvp)

    one, got = tron(plain), tron(shard_batch(plain, _mesh(n_slots)))
    for ref in (float(jres.value), float(one.value)):
        np.testing.assert_allclose(float(got.value), ref, rtol=1e-9)
    np.testing.assert_allclose(_np(got.x), np.asarray(jres.x), atol=1e-7)


def _jax_re_update(cols, n_slots, norm=None):
    jds = jax_build_re(JaxGameDataset.build(**cols),
                       JaxREConfig("userId", "u"), intercept_col=0,
                       dtype=jnp.float64)
    coord = jax_coords.RandomEffectCoordinate(
        name="re", dataset=jds, task_type=JaxTaskType.LOGISTIC_REGRESSION,
        config=jax_config.GLMOptimizationConfiguration.parse(RE_CFG),
        mesh=jax_mesh(n_slots), normalization=norm)
    return coord.update_model(coord.initialize_model(), None,
                              jax.random.PRNGKey(0))


def _port_re_update(cols, mesh=None, norm=None):
    ds = build_random_effect_dataset(
        GameDataset.build(**cols), RandomEffectDataConfiguration(
            "userId", "u"), intercept_col=0, dtype=F64, device="cpu")
    coord = RandomEffectCoordinate(
        "re", ds, TaskType.LOGISTIC_REGRESSION,
        GLMOptimizationConfiguration.parse(RE_CFG), normalization=norm,
        mesh=mesh)
    return coord.update_model(coord.initialize_model(), None), coord


@pytest.mark.parametrize("n_slots", SLOTS)
def test_sharded_entity_update_matches_jax_and_unsharded(rng, n_slots):
    cols = _re_data(rng, n=150, n_users=13)
    # JAX's mesh update at two slots (its compile is this file's largest
    # cost); four slots hold against the port's unsharded update.
    jmodel, jres = (_jax_re_update(cols, n_slots) if n_slots == 2
                    else (None, None))
    (one, one_res), _ = _port_re_update(cols)
    (got, got_res), coord = _port_re_update(cols, _mesh(n_slots))
    for i, (c, c1, r, r1, b) in enumerate(zip(
            got.local_coefs, one.local_coefs, got_res, one_res,
            coord.dataset.blocks)):
        e = b.num_entities
        torch.testing.assert_close(c, c1, rtol=0, atol=1e-14)
        # The tracker keeps every entity, padding last: zero
        # coefficients, and JAX's iterations and reasons.
        assert r.x.shape[0] == -(-e // n_slots) * n_slots
        assert torch.all(r.x[e:] == 0)
        assert torch.equal(r.iterations[:e], r1.iterations)
        assert torch.equal(r.reason[:e], r1.reason)
        if jres is None:
            continue
        jr = jres[i]
        np.testing.assert_allclose(_np(c), np.asarray(
            jmodel.local_coefs[i])[:e], atol=1e-7)
        assert np.asarray(jr.x).shape[0] == r.x.shape[0]
        np.testing.assert_array_equal(_np(r.iterations),
                                      np.asarray(jr.iterations))
        np.testing.assert_array_equal(_np(r.reason), np.asarray(jr.reason))
    # Scores scatter through the sentinel: the unsharded scores.
    (_, _), plain = _port_re_update(cols)
    torch.testing.assert_close(coord.score(got), plain.score(got),
                               rtol=0, atol=1e-14)


@pytest.mark.parametrize("n_slots", [2])
def test_sharded_entities_under_shift_normalization(rng, n_slots):
    n, d = 90, 5
    x = rng.normal(0, 1.0, (n, d))
    x[:, 0] = 1.0
    cols = dict(responses=(rng.random(n) < 0.5).astype(np.float64),
                feature_shards={"u": sp.csr_matrix(x)},
                ids={"userId": np.asarray([f"u{i % 9}" for i in range(n)])})
    shifts = x.mean(axis=0)
    shifts[0] = 0.0
    jnorm = JaxNorm(jnp.ones((d,)), jnp.asarray(shifts), intercept_id=0)
    norm = NormalizationContext(torch.ones(d, dtype=F64),
                                torch.as_tensor(shifts), intercept_id=0)
    jmodel, jres = _jax_re_update(cols, n_slots, jnorm)
    (got, res), _ = _port_re_update(cols, _mesh(n_slots), norm)
    (one, _), _ = _port_re_update(cols, None, norm)
    assert any(float(c.abs().max()) > 1e-5 for c in got.local_coefs)
    for c, c1, jc, r, jr in zip(got.local_coefs, one.local_coefs,
                                jmodel.local_coefs, res, jres):
        torch.testing.assert_close(c, c1, rtol=0, atol=1e-14)
        np.testing.assert_allclose(_np(c), np.asarray(jc)[:c.shape[0]],
                                   atol=1e-7)
        assert torch.all(r.x[c.shape[0]:] == 0)
        np.testing.assert_array_equal(_np(r.reason), np.asarray(jr.reason))
        np.testing.assert_array_equal(_np(r.iterations),
                                      np.asarray(jr.iterations))


def test_coordinate_mesh_must_start_on_its_device(rng):
    cols = _re_data(rng)
    ds = build_random_effect_dataset(
        GameDataset.build(**cols), RandomEffectDataConfiguration(
            "userId", "u"), dtype=F64, device="cpu")
    bad = Mesh((torch.device("meta"), torch.device("cpu")))
    with pytest.raises(ValueError, match="first slot"):
        RandomEffectCoordinate("re", ds, TaskType.LOGISTIC_REGRESSION,
                               GLMOptimizationConfiguration.parse(RE_CFG),
                               mesh=bad)
    # feature_sharding (which raised naming A6b) builds: over two slots
    # the 3 columns pad to 4 and the model keeps 3.
    fe = FixedEffectCoordinate(
        "fixed", GameDataset.build(**cols), "u",
        TaskType.LOGISTIC_REGRESSION,
        GLMOptimizationConfiguration.parse(RE_CFG), dtype=F64,
        device="cpu", feature_sharding=True, mesh=_mesh(2))
    assert (fe._d, fe._d_pad) == (3, 4)
    model, _ = fe.update_model(fe.initialize_model(), None)
    assert model.glm.coefficients.means.shape == (3,)


def _owns_only_itself(t):
    return t.untyped_storage().nbytes() == t.numel() * t.element_size()


@pytest.mark.parametrize("n_slots", SLOTS)
def test_slots_hold_only_their_own_range(rng, n_slots):
    """A slot's arrays are copies of its own range, not views of the
    unsharded tensor, and a meshed coordinate keeps no unsharded copy:
    slot 0 keeps nothing of the other slots' data alive."""
    mesh = _mesh(n_slots)
    cols = _re_data(rng, n=150, n_users=13)
    (_, _), coord = _port_re_update(cols, mesh)
    buckets = coord.dataset.blocks + [
        b for b in coord.dataset.passive_blocks if b is not None]
    assert buckets
    for b in buckets:
        assert len(b.slots) == n_slots
        for sb in b.slots:
            for name in ("x", "labels", "offsets", "weights", "row_ids",
                         "feat_idx"):
                assert _owns_only_itself(getattr(sb, name)), name
    # Sharded once: a coordinate on the sharded dataset keeps its blocks,
    # and without the mesh it refuses them.
    again = RandomEffectCoordinate(
        "re", coord.dataset, TaskType.LOGISTIC_REGRESSION,
        GLMOptimizationConfiguration.parse(RE_CFG), mesh=mesh)
    assert all(a is b for a, b in zip(again.dataset.blocks,
                                      coord.dataset.blocks))
    with pytest.raises(ValueError, match="sharded over"):
        RandomEffectCoordinate(
            "re", coord.dataset, TaskType.LOGISTIC_REGRESSION,
            GLMOptimizationConfiguration.parse(RE_CFG))
    x, y = _logistic(rng)
    batch = shard_batch(make_batch(DenseFeatures(torch.as_tensor(x)),
                                   torch.as_tensor(y)), mesh)
    for s in batch.features.slots:
        assert s.x.shape[0] == batch.features.rows_per_slot
        assert _owns_only_itself(s.x)
    fixed = FixedEffectCoordinate(
        "fixed", GameDataset.build(**cols), "u",
        TaskType.LOGISTIC_REGRESSION,
        GLMOptimizationConfiguration.parse(RE_CFG), dtype=F64,
        device="cpu", mesh=mesh)
    feats = fixed._batch.features
    assert len(feats.slots) == n_slots
    for s in feats.slots:  # dense: three columns
        assert s.x.shape[0] == feats.rows_per_slot
        assert _owns_only_itself(s.x)


# -- coordinate descent over the mesh -----------------------------------------


def _game_columns(seed=5, n=400, n_users=13, n_items=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 5))
    x[:, -1] = 1.0
    xu = rng.normal(0, 1, (n, 3))
    xu[:, 0] = 1.0
    users = rng.permutation(np.arange(n) % n_users)
    items = rng.integers(0, n_items, n)
    z = x @ rng.normal(0, 0.5, 5) + rng.normal(0, 0.5, n_users)[users]
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return dict(responses=y,
                feature_shards={"global": sp.csr_matrix(x),
                                "user": sp.csr_matrix(xu)},
                ids={"userId": users.astype(str),
                     "itemId": items.astype(str)})


def _port_fit(cols, mesh):
    specs = [
        est.FixedEffectSpec("fixed", "global", [
            GLMOptimizationConfiguration.parse("30,1e-8,1.0,1.0,LBFGS,L2")]),
        est.RandomEffectSpec(
            "perUser", RandomEffectDataConfiguration("userId", "user"),
            [GLMOptimizationConfiguration.parse(RE_CFG)], intercept_col=0)]
    (_, res), = est.GameEstimator(
        TaskType.LOGISTIC_REGRESSION, specs, num_iterations=2, dtype=F64,
        device="cpu", mesh=mesh).fit(GameDataset.build(**cols))
    return res


@pytest.fixture(scope="module")
def fits():
    cols = _game_columns()
    out = {n: _port_fit(cols, None if n is None else _mesh(n))
           for n in (None, 1, 2, 4)}
    jspecs = [
        jax_est.FixedEffectSpec("fixed", "global", [
            jax_config.GLMOptimizationConfiguration.parse(
                "30,1e-8,1.0,1.0,LBFGS,L2")]),
        jax_est.RandomEffectSpec(
            "perUser", JaxREConfig("userId", "user"),
            [jax_config.GLMOptimizationConfiguration.parse(RE_CFG)],
            intercept_col=0)]
    (_, out["jax"]), = jax_est.GameEstimator(
        JaxTaskType.LOGISTIC_REGRESSION, jspecs, num_iterations=2,
        dtype=jnp.float64, mesh=jax_mesh(2)).fit(
            JaxGameDataset.build(**cols))
    return out


@pytest.mark.parametrize("n_slots", [1, 2, 4])
def test_cd_objective_history_invariant_across_slots(fits, n_slots):
    base = np.asarray(fits[None].objective_history)
    got = np.asarray(fits[n_slots].objective_history)
    assert len(got) == len(base) == 4
    np.testing.assert_allclose(got, base, rtol=1e-5)
    if n_slots == 1:  # one slot is the unsharded fit
        np.testing.assert_array_equal(got, base)


def test_cd_objective_history_matches_jax_mesh_fit(fits):
    np.testing.assert_allclose(fits[2].objective_history,
                               fits["jax"].objective_history, rtol=1e-5)
    np.testing.assert_allclose(
        _np(fits[2].model.models["fixed"].glm.coefficients.means),
        np.asarray(fits["jax"].model.models["fixed"].glm.coefficients.means),
        atol=1e-6)


@pytest.mark.parametrize("n_slots", SLOTS)
def test_factored_latent_solves_per_slot_equal_unsharded(n_slots):
    cols = _game_columns(seed=9, n=240)
    data = GameDataset.build(**cols)
    spec = est.FactoredRandomEffectSpec(
        "mf", RandomEffectDataConfiguration("itemId", "user"),
        [FactoredRandomEffectOptimizationConfiguration.parse(
            f"{RE_CFG};{RE_CFG};2,2")])

    def update(mesh):
        cfg = spec.configs[0]
        coord = FactoredRandomEffectCoordinate(
            "mf", est.spec_dataset(data, spec, dtype=F64, device="cpu"),
            TaskType.LOGISTIC_REGRESSION, cfg.random_effect,
            cfg.latent_factor, cfg.mf, seed=0, mesh=mesh)
        model, trk = coord.update_model(coord.initialize_model(), None)
        return coord, model, trk

    c1, m1, t1 = update(None)
    cn, mn, tn = update(_mesh(n_slots))
    for g, g1 in zip(mn.latent.local_coefs, m1.latent.local_coefs):
        torch.testing.assert_close(g, g1, rtol=0, atol=1e-12)
    torch.testing.assert_close(mn.projection_matrix, m1.projection_matrix,
                               rtol=0, atol=1e-12)
    for upd, upd1 in zip(tn, t1):
        for r, r1 in zip(upd.latent, upd1.latent):
            e = r1.x.shape[0]
            assert torch.equal(r.reason[:e], r1.reason)
            assert torch.equal(r.iterations[:e], r1.iterations)
            assert torch.all(r.x[e:] == 0)
    torch.testing.assert_close(cn.score(mn), c1.score(m1), rtol=0,
                               atol=1e-12)
