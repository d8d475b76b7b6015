"""The GAME slice's path 5, the factored random effect, end to end against
the JAX package, float64 on the CPU: a fixed effect and a per-user random
effect (L-BFGS/L2, bench.py's configurations) and a factored per-item
coordinate (latent solves and refit of B both "20,1e-6,1.0", k = 2, two
MF alternations per update), 2 coordinate-descent iterations with
validation AUC.

The JAX run routes its per-user buckets and its latent buckets through
the Pallas kernel in interpreter mode (PHOTON_ML_TPU_PALLAS_INTERPRET=1),
the port through the plain version of its kernel; the refit of B is the
host L-BFGS over the lazy Kronecker features on both sides. Tolerances:
objective history rtol 1e-8, gamma and B atol 1e-6, AUC 1e-9, equal
iterations and stop reasons for every latent bucket solve and every
refit, carried-across scores atol 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.algorithm import coordinates as jax_coords
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
from photon_ml_tpu.ops.features import KroneckerFeatures as JaxKronecker
from photon_ml_tpu.ops.glm_objective import GLMBatch as JaxBatch
from photon_ml_tpu.optimization import config as jax_config
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.algorithm.coordinates import (
    FactoredRandomEffectCoordinate,
)
from photon_ml_tpu_torch.convert import (
    FactoredRandomEffectArrays,
    FixedEffectArrays,
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
from photon_ml_tpu_torch.optimization import config
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

FE_CFG = "50,1e-7,1.0,1.0,LBFGS,L2"
RE_CFG = "20,1e-6,1.0,1.0,LBFGS,L2"
K, MF_ITERATIONS = 2, 2
D, D_USER, D_ITEM = 6, 4, 3


def _columns(seed=3, n_users=60, n_items=40):
    """480 training rows, in which every user has 8 rows and every item
    12 (one bucket per coordinate), then 120 hold-out rows; the items'
    effects have rank 2."""
    rng = np.random.default_rng(seed)
    n_train = 8 * n_users
    assert n_train == 12 * n_items
    n = n_train * 5 // 4
    x = rng.normal(0, 1, (n, D))
    x[:, -1] = 1.0
    xu = rng.normal(0, 1, (n, D_USER))
    xu[:, 0] = 1.0
    xi = rng.normal(0, 1, (n, D_ITEM))
    xi[:, 0] = 1.0
    users = np.concatenate([rng.permutation(np.repeat(np.arange(n_users), 8)),
                            rng.integers(0, n_users, n - n_train)])
    items = np.concatenate([rng.permutation(np.repeat(np.arange(n_items), 12)),
                            rng.integers(0, n_items, n - n_train)])
    item_coefs = (rng.normal(0, 0.6, (n_items, 2))
                  @ rng.normal(0, 0.6, (2, D_ITEM)))
    z = (x @ rng.normal(0, 0.5, D)
         + np.einsum("nd,nd->n", xu,
                     rng.normal(0, 0.4, (n_users, D_USER))[users])
         + np.einsum("nd,nd->n", xi, item_coefs[items]))
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return dict(responses=y,
                feature_shards={"global": sp.csr_matrix(x),
                                "user": sp.csr_matrix(xu),
                                "item": sp.csr_matrix(xi)},
                ids={"userId": users.astype(str), "itemId": items.astype(str)})


def _configs(side):
    c = jax_config if side == "jax" else config
    re = c.GLMOptimizationConfiguration.parse(RE_CFG)
    return (c.GLMOptimizationConfiguration.parse(FE_CFG), re,
            c.FactoredRandomEffectOptimizationConfiguration(
                re, re, c.MFOptimizationConfiguration(MF_ITERATIONS, K)))


def _specs(side):
    m = jax_est if side == "jax" else est
    re_config = JaxREConfig if side == "jax" else RandomEffectDataConfiguration
    fe, re, fac = _configs(side)
    return [m.FixedEffectSpec("fixed", "global", [fe]),
            m.RandomEffectSpec("perUser", re_config("userId", "user"), [re],
                               intercept_col=0),
            m.FactoredRandomEffectSpec("itemFactors",
                                       re_config("itemId", "item"), [fac])]


def _residual(n):
    return np.random.default_rng(11).normal(0, 0.5, n)


def _jax_alternations(jtrain):
    """One factored update by hand from JAX's own functions, as
    FactoredRandomEffectCoordinate.pure_update runs it, keeping what it
    drops: each alternation's latent bucket results beside its refit."""
    _, re, fac = _configs("jax")
    ds = jax_build_re(jtrain, JaxREConfig("itemId", "item",
                                          projector_type="IDENTITY"),
                      dtype=jnp.float64)
    coord = jax_coords.FactoredRandomEffectCoordinate(
        "itemFactors", ds, JaxTaskType.LOGISTIC_REGRESSION, re, re, fac.mf,
        seed=0)
    gammas, B = coord.params_of(coord.initialize_model())
    gammas = list(gammas)
    d = ds.num_global_features
    residual = jnp.asarray(_residual(jtrain.num_rows))
    extras = [jax_coords._gather_residual(residual, b) for b in ds.blocks]
    static = jax_coords._flatten_factored_static(ds.blocks, extras, d)
    out = []
    for _ in range(MF_ITERATIONS):
        latent = [jax_coords._solve_factored_block(
            coord._objective, re, b, B, extra, g0, d)
            for b, extra, g0 in zip(ds.blocks, extras, gammas)]
        gammas = [r.x for r in latent]
        batch = JaxBatch(JaxKronecker(
            static[0], jax_coords._flatten_gammas(ds.blocks, gammas)),
            *static[1:])
        refit = jax_coords._solve_latent_matrix(coord._objective, re, batch,
                                                B.reshape(-1))
        B = refit.x.reshape(B.shape)
        out.append((latent, refit))
    return out, gammas, B


def _run():
    cols = _columns()
    n = len(cols["responses"])
    cut = int(0.8 * n)
    mp = pytest.MonkeyPatch()
    mp.setenv("PHOTON_ML_TPU_PALLAS_INTERPRET", "1")
    try:
        jdata = JaxGameDataset.build(**cols)
        jtrain, jval = jdata.subset(np.arange(cut)), jdata.subset(
            np.arange(cut, n))
        jfit = jax_est.GameEstimator(
            JaxTaskType.LOGISTIC_REGRESSION, _specs("jax"),
            num_iterations=2, validation_evaluators=[JaxAUC()],
            dtype=jnp.float64).fit(jtrain, jval)
        jalt = _jax_alternations(jtrain)
    finally:
        mp.undo()
    data = GameDataset.build(**cols)
    train, val = data.subset(np.arange(cut)), data.subset(np.arange(cut, n))
    fit = est.GameEstimator(
        TaskType.LOGISTIC_REGRESSION, _specs("port"), num_iterations=2,
        validation_evaluators=[AreaUnderROCCurveEvaluator()],
        dtype=torch.float64, device="cpu").fit(train, val)
    return dict(jax=jfit[0][1], port=fit[0][1], jalt=jalt, train=train,
                val=val, jval=jval)


@pytest.fixture(scope="module")
def run():
    return _run()


def test_objectives_and_auc_match_jax(run):
    got, want = run["port"].objective_history, run["jax"].objective_history
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, rtol=1e-8)
    assert got[-1] < got[0]
    np.testing.assert_allclose(
        [m["AUC"] for m in run["port"].validation_history],
        [m["AUC"] for m in run["jax"].validation_history], atol=1e-9, rtol=0)


def test_gamma_and_projection_match_jax(run):
    port = run["port"].model.models["itemFactors"]
    ref = run["jax"].model.models["itemFactors"]
    assert tuple(port.projection_matrix.shape) == (K, D_ITEM)
    np.testing.assert_allclose(port.projection_matrix.numpy(),
                               np.asarray(ref.projection_matrix), atol=1e-6)
    assert len(port.latent.local_coefs) == len(ref.latent.local_coefs) == 1
    for g, jg in zip(port.latent.local_coefs, ref.latent.local_coefs):
        assert tuple(g.shape) == (40, K)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(
        run["port"].model.models["perUser"].local_coefs[0].numpy(),
        np.asarray(run["jax"].model.models["perUser"].local_coefs[0]),
        atol=1e-6)


def test_refits_stop_alike(run):
    """Per update and alternation, the refit of B stops after the same
    iterations for the same reason as JAX's."""
    port, ref = run["port"].trackers, run["jax"].trackers
    assert len(port["itemFactors"]) == len(ref["itemFactors"]) == 2
    for upd, jupd in zip(port["itemFactors"], ref["itemFactors"]):
        assert len(upd) == len(jupd) == MF_ITERATIONS
        for alt, jrefit in zip(upd, jupd):
            assert int(alt.refit.iterations) == int(jrefit.iterations) >= 1
            assert int(alt.refit.reason) == int(jrefit.reason)
            assert len(alt.latent) == 1


def test_latent_solves_and_refits_match_jax_alternations(run):
    """One factored update on a fixed residual: every alternation's
    latent bucket solves and refit against JAX's, run by hand from its
    own functions (its coordinate keeps only the refits)."""
    train = run["train"]
    ds = build_random_effect_dataset(
        train, RandomEffectDataConfiguration("itemId", "item",
                                             projector_type="IDENTITY"),
        dtype=torch.float64, device="cpu")
    _, re, fac = _configs("port")
    coord = FactoredRandomEffectCoordinate(
        "itemFactors", ds, TaskType.LOGISTIC_REGRESSION, re, re, fac.mf,
        seed=0)
    model, trackers = coord.update_model(
        coord.initialize_model(), torch.as_tensor(_residual(train.num_rows)))
    jalt, jgammas, jB = run["jalt"]
    assert len(trackers) == len(jalt) == MF_ITERATIONS
    for alt, (jlatent, jrefit) in zip(trackers, jalt):
        for a, b in zip(alt.latent, jlatent, strict=True):
            np.testing.assert_array_equal(a.iterations.numpy(),
                                          np.asarray(b.iterations))
            np.testing.assert_array_equal(a.reason.numpy(),
                                          np.asarray(b.reason))
            np.testing.assert_allclose(a.x.numpy(), np.asarray(b.x),
                                       atol=1e-6)
        assert int(alt.refit.iterations) == int(jrefit.iterations) >= 1
        assert int(alt.refit.reason) == int(jrefit.reason)
    np.testing.assert_allclose(model.projection_matrix.numpy(),
                               np.asarray(jB), atol=1e-6)
    np.testing.assert_allclose(model.latent.local_coefs[0].numpy(),
                               np.asarray(jgammas[0]), atol=1e-6)


def test_jax_model_carried_across_scores_the_same(run):
    ref_model, jval, val = run["jax"].model, run["jval"], run["val"]
    fe = ref_model.models["fixed"]
    re, fac = ref_model.models["perUser"], ref_model.models["itemFactors"]

    def arrays(m, projection=None):
        return RandomEffectArrays(
            m.random_effect_type, m.feature_shard_id,
            [np.asarray(c) for c in m.local_coefs],
            [np.asarray(f) for f in m.feat_idx],
            [np.asarray(c) for c in m.entity_codes],
            np.asarray(m.vocabulary), m.num_global_features, projection)

    model = game_model_from_numpy(
        TaskType.LOGISTIC_REGRESSION,
        {"fixed": FixedEffectArrays(
            fe.feature_shard_id, np.asarray(fe.glm.coefficients.means)),
         "perUser": arrays(re),
         "itemFactors": FactoredRandomEffectArrays(
             arrays(fac.latent, np.asarray(fac.projection_matrix)),
             fac.mf_config.max_iterations, fac.mf_config.num_factors)},
        dtype=torch.float64, device="cpu")
    got = DeviceGameScorer(model, val, dtype=torch.float64,
                           device="cpu").score(model)
    want = np.asarray(JaxScorer(ref_model, jval, dtype=jnp.float64)
                      .score(ref_model))
    assert got.shape == want.shape == (val.num_rows,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10, rtol=0)
    np.testing.assert_allclose(model.score(val), ref_model.score(jval),
                               atol=1e-10, rtol=0)


def test_factored_spec_ignores_the_configured_projector(run):
    """The estimator builds a factored dataset with the IDENTITY projector
    and no Pearson trim whatever the spec's data configuration says, as
    the JAX package does; a coordinate over a projected dataset is
    refused."""
    train, val = run["train"], run["val"]
    specs = _specs("port")
    specs[2].data_config = RandomEffectDataConfiguration(
        "itemId", "item", num_features_to_samples_ratio=0.1,
        projector_type="RANDOM=2")
    fit = est.GameEstimator(
        TaskType.LOGISTIC_REGRESSION, specs, num_iterations=2,
        validation_evaluators=[AreaUnderROCCurveEvaluator()],
        dtype=torch.float64, device="cpu").fit(train, val)
    assert fit[0][1].objective_history == run["port"].objective_history
    ds = build_random_effect_dataset(train, specs[2].data_config,
                                     dtype=torch.float64, device="cpu")
    _, re, fac = _configs("port")
    with pytest.raises(ValueError, match="IDENTITY"):
        FactoredRandomEffectCoordinate(
            "itemFactors", ds, TaskType.LOGISTIC_REGRESSION, re, re, fac.mf)
