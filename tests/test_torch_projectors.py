"""The port's projectors, RANDOM-projected random effects, Kronecker
features and matrix-factorization scoring against the JAX package,
float64 on the CPU.

- ``ProjectionMatrix.gaussian`` bit-equal (both draw with numpy);
- RANDOM=<k> blocks exactly equal to JAX's build_random_effect_dataset;
- ``KroneckerFeatures``' four products within rtol 1e-12;
- a fixed effect and a RANDOM=3-projected per-user effect trained by both
  packages (JAX's buckets through the Pallas kernel in interpreter mode):
  objective history rtol 1e-8, coefficients atol 1e-6, AUC 1e-9, equal
  iterations and stop reasons, carried-across scores atol 1e-10;
- a matrix-factorization model carried across scores within 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.data.game_data import GameDataset as JaxGameDataset
from photon_ml_tpu.data.random_effect import (
    RandomEffectDataConfiguration as JaxREConfig,
)
from photon_ml_tpu.data.random_effect import (
    build_random_effect_dataset as jax_build_re,
)
from photon_ml_tpu.estimators import game_estimator as jax_est
from photon_ml_tpu.evaluation.evaluators import (
    AreaUnderROCCurveEvaluator as JaxAUC,
)
from photon_ml_tpu.models.device_scoring import (
    DeviceGameScorer as JaxScorer,
)
from photon_ml_tpu.models.game_model import GameModel as JaxGameModel
from photon_ml_tpu.models.matrix_factorization import (
    MatrixFactorizationModel as JaxMF,
)
from photon_ml_tpu.ops.features import KroneckerFeatures as JaxKronecker
from photon_ml_tpu.optimization import config as jax_config
from photon_ml_tpu.projector import projectors as jax_projectors
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.convert import (
    FixedEffectArrays,
    MatrixFactorizationArrays,
    RandomEffectArrays,
    game_model_from_numpy,
)
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.random_effect import (
    RandomEffectDataConfiguration,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.estimators import game_estimator as est
from photon_ml_tpu_torch.evaluation.evaluators import (
    AreaUnderROCCurveEvaluator,
)
from photon_ml_tpu_torch.models.device_scoring import DeviceGameScorer
from photon_ml_tpu_torch.ops.features import KroneckerFeatures
from photon_ml_tpu_torch.optimization import config
from photon_ml_tpu_torch.projector import projectors
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

FE_CFG = "50,1e-7,1.0,1.0,LBFGS,L2"
RE_CFG = "20,1e-6,1.0,1.0,LBFGS,L2"
D, D_USER = 5, 9


@pytest.mark.parametrize("k,d,intercept,seed", [
    (4, 16, None, 0), (3, 9, 0, 7), (5, 40, 39, 123)])
def test_gaussian_projection_bit_equal(k, d, intercept, seed):
    ours = projectors.ProjectionMatrix.gaussian(k, d, intercept, seed)
    ref = jax_projectors.ProjectionMatrix.gaussian(k, d, intercept, seed)
    np.testing.assert_array_equal(ours.matrix, ref.matrix)
    assert ours.matrix.dtype == ref.matrix.dtype
    x = np.random.default_rng(seed).normal(0, 1, (6, d))
    np.testing.assert_array_equal(ours.project_features(sp.csr_matrix(x)),
                                  ref.project_features(sp.csr_matrix(x)))
    gamma = np.arange(ours.projected_space_dimension, dtype=float)
    np.testing.assert_array_equal(ours.project_coefficients(gamma),
                                  ref.project_coefficients(gamma))


def test_index_map_projector_and_selection_match_jax():
    cols = np.array([0, 3, 7])
    ours = projectors.IndexMapProjector(cols, 9)
    ref = jax_projectors.IndexMapProjector(cols, 9)
    x = np.random.default_rng(2).normal(0, 1, (4, 9))
    np.testing.assert_array_equal(ours.project_features(x),
                                  ref.project_features(x))
    np.testing.assert_array_equal(ours.project_coefficients([1., 2., 3.]),
                                  ref.project_coefficients([1., 2., 3.]))
    for t in ("INDEX_MAP", "IDENTITY"):
        assert projectors.build_random_effect_projector(t, 9) is None
    np.testing.assert_array_equal(
        projectors.build_random_effect_projector("random_3", 9, 0, 4).matrix,
        jax_projectors.build_random_effect_projector("random_3", 9, 0,
                                                     4).matrix)
    with pytest.raises(ValueError, match="unknown projector"):
        projectors.build_random_effect_projector("RANDOM", 9)


def _block_columns(seed=21, n=300, d=12, n_users=23):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d))
    x[rng.random((n, d)) < 0.5] = 0.0
    x[:, 0] = 1.0
    users = rng.zipf(1.6, n) % n_users
    return dict(responses=(rng.random(n) < 0.4).astype(np.float64),
                feature_shards={"user": sp.csr_matrix(x)},
                ids={"userId": users.astype(str)},
                offsets=rng.normal(0, 0.3, n), weights=rng.uniform(0.5, 2, n))


@pytest.mark.parametrize("extra", [
    dict(projector_type="RANDOM=4"),
    dict(projector_type="RANDOM=3", num_active_data_points=10,
         num_passive_data_points_lower_bound=3,
         num_features_to_samples_ratio=0.5)])
def test_random_projected_blocks_identical_to_jax(extra):
    cols = _block_columns()
    ours = build_random_effect_dataset(
        GameDataset.build(**cols),
        RandomEffectDataConfiguration("userId", "user", **extra), seed=3,
        intercept_col=0, dtype=torch.float64, device="cpu")
    ref = jax_build_re(JaxGameDataset.build(**cols),
                       JaxREConfig("userId", "user", **extra), seed=3,
                       intercept_col=0, dtype=jnp.float64)
    np.testing.assert_array_equal(ours.projection.matrix,
                                  ref.projection.matrix)
    pairs = list(zip(ours.blocks, ref.blocks)) + [
        (p, q) for p, q in zip(ours.passive_blocks, ref.passive_blocks)
        if p is not None or q is not None]
    assert len(ours.blocks) == len(ref.blocks) > 1
    for a, b in pairs:
        for f in ("x", "labels", "offsets", "weights", "row_ids",
                  "feat_idx"):
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)), f)
    for c, jc in zip(ours.entity_codes, ref.entity_codes):
        np.testing.assert_array_equal(c, jc)


def test_kronecker_products_match_jax():
    rng = np.random.default_rng(4)
    n, d, k = 40, 7, 3
    x, g = rng.normal(0, 1, (n, d)), rng.normal(0, 1, (n, k))
    v, u = rng.normal(0, 1, k * d), rng.normal(0, 1, n)
    ours = KroneckerFeatures(torch.as_tensor(x), torch.as_tensor(g))
    ref = JaxKronecker(jnp.asarray(x), jnp.asarray(g))
    assert ours.num_features == ref.num_features == k * d
    assert ours.shape == ref.shape
    for name, arg in (("matvec", v), ("rmatvec", u), ("row_sq_matvec", v),
                      ("sq_rmatvec", u)):
        np.testing.assert_allclose(
            getattr(ours, name)(torch.as_tensor(arg)).numpy(),
            np.asarray(getattr(ref, name)(jnp.asarray(arg))), rtol=1e-12,
            atol=0, err_msg=name)


def _game_columns(seed=9, n_users=60):
    """480 training rows, 8 per user (one bucket), then 120 hold-out rows."""
    rng = np.random.default_rng(seed)
    n_train = 8 * n_users
    n = n_train * 5 // 4
    x = rng.normal(0, 1, (n, D))
    x[:, -1] = 1.0
    xu = rng.normal(0, 1, (n, D_USER))
    xu[:, 0] = 1.0
    users = np.concatenate([rng.permutation(np.repeat(np.arange(n_users), 8)),
                            rng.integers(0, n_users, n - n_train)])
    z = (x @ rng.normal(0, 0.5, D)
         + np.einsum("nd,nd->n", xu,
                     rng.normal(0, 0.4, (n_users, D_USER))[users]))
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return dict(responses=y,
                feature_shards={"global": sp.csr_matrix(x),
                                "user": sp.csr_matrix(xu)},
                ids={"userId": users.astype(str)})


def _specs(side):
    m = jax_est if side == "jax" else est
    c = jax_config if side == "jax" else config
    re_config = JaxREConfig if side == "jax" else RandomEffectDataConfiguration
    return [m.FixedEffectSpec("fixed", "global",
                              [c.GLMOptimizationConfiguration.parse(FE_CFG)]),
            m.RandomEffectSpec(
                "perUser", re_config("userId", "user",
                                     projector_type="RANDOM=3"),
                [c.GLMOptimizationConfiguration.parse(RE_CFG)],
                intercept_col=0)]


@pytest.fixture(scope="module")
def projected_run():
    cols = _game_columns()
    n = len(cols["responses"])
    cut = int(0.8 * n)
    mp = pytest.MonkeyPatch()
    mp.setenv("PHOTON_ML_TPU_PALLAS_INTERPRET", "1")
    try:
        jdata = JaxGameDataset.build(**cols)
        jtrain, jval = (jdata.subset(np.arange(cut)),
                        jdata.subset(np.arange(cut, n)))
        jfit = jax_est.GameEstimator(
            JaxTaskType.LOGISTIC_REGRESSION, _specs("jax"),
            num_iterations=2, validation_evaluators=[JaxAUC()],
            dtype=jnp.float64).fit(jtrain, jval)
    finally:
        mp.undo()
    data = GameDataset.build(**cols)
    train, val = data.subset(np.arange(cut)), data.subset(np.arange(cut, n))
    fit = est.GameEstimator(
        TaskType.LOGISTIC_REGRESSION, _specs("port"), num_iterations=2,
        validation_evaluators=[AreaUnderROCCurveEvaluator()],
        dtype=torch.float64, device="cpu").fit(train, val)
    return dict(jax=jfit[0][1], port=fit[0][1], val=val, jval=jval)


def test_random_projected_effect_matches_jax(projected_run):
    port, ref = projected_run["port"], projected_run["jax"]
    np.testing.assert_allclose(port.objective_history, ref.objective_history,
                               rtol=1e-8)
    np.testing.assert_allclose(
        [m["AUC"] for m in port.validation_history],
        [m["AUC"] for m in ref.validation_history], atol=1e-9, rtol=0)
    re_port, re_ref = port.model.models["perUser"], ref.model.models["perUser"]
    np.testing.assert_array_equal(re_port.projection.numpy(),
                                  re_ref.projection.matrix)
    assert len(re_port.local_coefs) == len(re_ref.local_coefs) == 1
    for c, jc in zip(re_port.local_coefs, re_ref.local_coefs):
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(re_port.model_matrix().toarray(),
                               re_ref.model_matrix().toarray(), atol=1e-6)
    for upd, jupd in zip(port.trackers["perUser"], ref.trackers["perUser"]):
        for a, b in zip(upd, jupd, strict=True):
            np.testing.assert_array_equal(a.iterations.numpy(),
                                          np.asarray(b.iterations))
            np.testing.assert_array_equal(a.reason.numpy(),
                                          np.asarray(b.reason))


def test_projected_model_carried_across_scores_the_same(projected_run):
    ref_model = projected_run["jax"].model
    val, jval = projected_run["val"], projected_run["jval"]
    fe, re = ref_model.models["fixed"], ref_model.models["perUser"]
    model = game_model_from_numpy(
        TaskType.LOGISTIC_REGRESSION,
        {"fixed": FixedEffectArrays(
            fe.feature_shard_id, np.asarray(fe.glm.coefficients.means)),
         "perUser": RandomEffectArrays(
             re.random_effect_type, re.feature_shard_id,
             [np.asarray(c) for c in re.local_coefs],
             [np.asarray(f) for f in re.feat_idx],
             [np.asarray(c) for c in re.entity_codes],
             np.asarray(re.vocabulary), re.num_global_features,
             re.projection.matrix)},
        dtype=torch.float64, device="cpu")
    got = DeviceGameScorer(model, val, dtype=torch.float64,
                           device="cpu").score(model)
    want = np.asarray(JaxScorer(ref_model, jval, dtype=jnp.float64)
                      .score(ref_model))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10, rtol=0)
    np.testing.assert_allclose(model.score(val), ref_model.score(jval),
                               atol=1e-10, rtol=0)


def test_matrix_factorization_scores_carried_across():
    """A JAX MF model (jax.random factors, so carried across through
    convert) scores the same in both packages, unknown entities 0."""
    cols = _block_columns()
    rng = np.random.default_rng(5)
    n = len(cols["responses"])
    cols["ids"]["itemId"] = rng.integers(0, 9, n).astype(str)
    users = np.unique(cols["ids"]["userId"])[:-2]  # two users unknown
    items = np.unique(cols["ids"]["itemId"])
    ref = JaxMF.random("userId", "itemId", users, items, num_factors=3,
                       seed=4, dtype=jnp.float64)
    jdata = JaxGameDataset.build(**cols)
    data = GameDataset.build(**cols)
    model = game_model_from_numpy(
        TaskType.LOGISTIC_REGRESSION,
        {"mf": MatrixFactorizationArrays(
            "userId", "itemId", np.asarray(ref.row_factors),
            np.asarray(ref.col_factors), users, items)},
        dtype=torch.float64, device="cpu")
    want = np.asarray(ref.score(jdata))
    assert (want == 0).any() and (want != 0).any()
    mf = model.models["mf"]
    assert mf.num_latent_factors == 3
    np.testing.assert_allclose(mf.score_numpy(data), want, atol=1e-10,
                               rtol=0)
    got = DeviceGameScorer(model, data, dtype=torch.float64,
                           device="cpu").score(model)
    jref = JaxGameModel({"mf": ref}, JaxTaskType.LOGISTIC_REGRESSION)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JaxScorer(jref, jdata,
                                          dtype=jnp.float64).score(jref)),
        atol=1e-10, rtol=0)
