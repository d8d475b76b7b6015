"""The GLMix slice end to end against the JAX package, float64 on the CPU,
2 coordinate-descent iterations with validation AUC, on two paths:

- fixed effect + per-user random effect, logistic, L-BFGS/L2. The JAX
  run routes its random-effect buckets through the Pallas kernel in
  interpreter mode (PHOTON_ML_TPU_PALLAS_INTERPRET=1), the port through
  the plain version of its kernel. Tolerances: objective history rtol
  1e-8, coefficients atol 1e-6, AUC 1e-9, carried-across scores 1e-10.
- run_game_full.sh's fixed TRON/L2 and per-user elastic net (OWL-QN),
  both under STANDARDIZATION. The interpreted kernel is too slow here at
  this size, so the JAX run takes its CPU default path (vmapped
  solve_glm -> minimize_owlqn, compact L-BFGS directions where the port
  runs the two-loop recursion). The two still agree to rounding, so the
  tolerances are the first path's, with equal iterations and stop
  reasons per solve (looser than JAX's own kernel-vs-vmapped ones,
  tests/test_pallas_entity_solver.py:319-323, are not needed).
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
from photon_ml_tpu.estimators import game_estimator as jax_est
from photon_ml_tpu.evaluation.evaluators import (
    AreaUnderROCCurveEvaluator as JaxAUC,
)
from photon_ml_tpu.models.device_scoring import (
    DeviceGameScorer as JaxScorer,
)
from photon_ml_tpu.optimization import config as jax_config
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.convert import (
    FixedEffectArrays,
    RandomEffectArrays,
    game_model_from_numpy,
)
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.random_effect import (
    RandomEffectDataConfiguration,
)
from photon_ml_tpu_torch.estimators import game_estimator as est
from photon_ml_tpu_torch.evaluation.evaluators import (
    AreaUnderROCCurveEvaluator,
)
from photon_ml_tpu_torch.models.device_scoring import DeviceGameScorer
from photon_ml_tpu_torch.optimization.config import (
    GLMOptimizationConfiguration,
)
from photon_ml_tpu_torch.ops import entity_solver
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

FE_CFG = "50,1e-7,1.0,1.0,LBFGS,L2"
RE_CFG = "20,1e-6,1.0,1.0,LBFGS,L2"
# examples/run_game_full.sh:36-38
FE_TRON_CFG = "15,1e-5,1.0,1.0,TRON,L2"
RE_ENET_CFG = "30,1e-6,0.5,1.0,LBFGS,ELASTIC_NET,0.5"


def _columns(seed=3, n=1500, d=8, n_users=40, d_user=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d))
    x[:, -1] = 1.0
    xu = rng.normal(0, 1, (n, d_user))
    xu[:, 0] = 1.0
    users = rng.integers(0, n_users, n)
    z = (x @ rng.normal(0, 0.5, d)
         + np.einsum("nd,nd->n", xu, rng.normal(0, 0.3, (n_users, d_user))
                     [users]))
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return dict(responses=y,
                feature_shards={"global": sp.csr_matrix(x),
                                "user": sp.csr_matrix(xu)},
                ids={"userId": users.astype(str)})


def _split(ds, n):
    cut = int(0.8 * n)
    return ds.subset(np.arange(cut)), ds.subset(np.arange(cut, n))


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    mp.setenv("PHOTON_ML_TPU_PALLAS_INTERPRET", "1")
    try:
        cols = _columns()
        n = len(cols["responses"])
        jtrain, jval = _split(JaxGameDataset.build(**cols), n)
        jfit = jax_est.GameEstimator(
            JaxTaskType.LOGISTIC_REGRESSION,
            [jax_est.FixedEffectSpec(
                "fixed", "global",
                [jax_config.GLMOptimizationConfiguration.parse(FE_CFG)]),
             jax_est.RandomEffectSpec(
                 "perUser", JaxREConfig("userId", "user"),
                 [jax_config.GLMOptimizationConfiguration.parse(RE_CFG)],
                 intercept_col=0)],
            num_iterations=2, validation_evaluators=[JaxAUC()],
            dtype=jnp.float64).fit(jtrain, jval)
    finally:
        mp.undo()

    train, val = _split(GameDataset.build(**cols), n)
    before = entity_solver.entity_lbfgs.launches
    fit = est.GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        [est.FixedEffectSpec(
            "fixed", "global",
            [GLMOptimizationConfiguration.parse(FE_CFG)]),
         est.RandomEffectSpec(
             "perUser", RandomEffectDataConfiguration("userId", "user"),
             [GLMOptimizationConfiguration.parse(RE_CFG)],
             intercept_col=0)],
        num_iterations=2, validation_evaluators=[AreaUnderROCCurveEvaluator()],
        dtype=torch.float64, device="cpu").fit(train, val)
    assert entity_solver.entity_lbfgs.launches == before  # CPU: plain path
    return dict(jax=jfit[0][1], port=fit[0][1], jval=jval, val=val)


def test_objective_history_matches(runs):
    got, want = runs["port"].objective_history, runs["jax"].objective_history
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-8)
    assert got[-1] < got[0]


def test_validation_auc_matches(runs):
    got = [m["AUC"] for m in runs["port"].validation_history]
    want = [m["AUC"] for m in runs["jax"].validation_history]
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
    assert runs["port"].best_metric == pytest.approx(
        runs["jax"].best_metric, abs=1e-9)


def test_coefficients_match(runs):
    port, ref = runs["port"].model, runs["jax"].model
    np.testing.assert_allclose(
        port.models["fixed"].glm.coefficients.means.numpy(),
        np.asarray(ref.models["fixed"].glm.coefficients.means), atol=1e-6)
    re_port, re_ref = port.models["perUser"], ref.models["perUser"]
    assert len(re_port.local_coefs) == len(re_ref.local_coefs) >= 2
    for c, jc, f, jf in zip(re_port.local_coefs, re_ref.local_coefs,
                            re_port.feat_idx, re_ref.feat_idx):
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)


def test_solver_trackers_match(runs):
    """Per update: the fixed-effect solve and every bucket's entity solve
    stop after the same iterations for the same reasons."""
    port, ref = runs["port"].trackers, runs["jax"].trackers
    for a, b in zip(port["fixed"], ref["fixed"]):
        assert int(a.iterations) == int(b.iterations)
        assert int(a.reason) == int(b.reason)
    for upd, jupd in zip(port["perUser"], ref["perUser"]):
        for a, b in zip(upd, jupd):
            np.testing.assert_array_equal(a.iterations.numpy(),
                                          np.asarray(b.iterations))
            np.testing.assert_array_equal(a.reason.numpy(),
                                          np.asarray(b.reason))


def _carried_across_scores(runs):
    ref_model, jval, val = runs["jax"].model, runs["jval"], runs["val"]
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
             np.asarray(re.vocabulary), re.num_global_features)},
        dtype=torch.float64, device="cpu")
    got = DeviceGameScorer(model, val, dtype=torch.float64,
                           device="cpu").score(model)
    want = np.asarray(JaxScorer(ref_model, jval, dtype=jnp.float64)
                      .score(ref_model))
    assert got.shape == want.shape == (val.num_rows,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10, rtol=0)
    np.testing.assert_allclose(model.score(val), ref_model.score(jval),
                               atol=1e-10, rtol=0)


def test_jax_model_carried_across_scores_the_same(runs):
    _carried_across_scores(runs)


def _contexts(cols, jax_side):
    """STANDARDIZATION contexts of the two shards: the fixed effect's
    intercept is its last column, the per-user one's its first."""
    if jax_side:
        from photon_ml_tpu.data.normalization import (
            build_normalization_context,
        )
        from photon_ml_tpu.data.stats import BasicStatisticalSummary
        kw = {}
    else:
        from photon_ml_tpu_torch.data.normalization import (
            build_normalization_context,
        )
        from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary
        kw = dict(device="cpu")
    g, u = cols["feature_shards"]["global"], cols["feature_shards"]["user"]
    return (build_normalization_context(
                "STANDARDIZATION", BasicStatisticalSummary.compute(g),
                g.shape[1] - 1, **kw),
            build_normalization_context(
                "STANDARDIZATION", BasicStatisticalSummary.compute(u), 0,
                **kw))


@pytest.fixture(scope="module")
def normalized_runs():
    cols = _columns(seed=4)
    # Badly scaled columns, so that the normalization matters.
    for shard, scale in (("global", 5.0), ("user", 3.0)):
        m = cols["feature_shards"][shard].toarray()
        skip = m.shape[1] - 1 if shard == "global" else 0
        keep = np.arange(m.shape[1]) != skip
        m[:, keep] = m[:, keep] * scale + 1.0
        cols["feature_shards"][shard] = sp.csr_matrix(m)
    n = len(cols["responses"])
    jfe, jre = _contexts(cols, jax_side=True)
    jtrain, jval = _split(JaxGameDataset.build(**cols), n)
    jfit = jax_est.GameEstimator(
        JaxTaskType.LOGISTIC_REGRESSION,
        [jax_est.FixedEffectSpec(
            "fixed", "global",
            [jax_config.GLMOptimizationConfiguration.parse(FE_TRON_CFG)],
            normalization=jfe),
         jax_est.RandomEffectSpec(
             "perUser", JaxREConfig("userId", "user"),
             [jax_config.GLMOptimizationConfiguration.parse(RE_ENET_CFG)],
             intercept_col=0, normalization=jre)],
        num_iterations=2, validation_evaluators=[JaxAUC()],
        dtype=jnp.float64).fit(jtrain, jval)

    fe, re = _contexts(cols, jax_side=False)
    train, val = _split(GameDataset.build(**cols), n)
    fit = est.GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        [est.FixedEffectSpec(
            "fixed", "global",
            [GLMOptimizationConfiguration.parse(FE_TRON_CFG)],
            normalization=fe),
         est.RandomEffectSpec(
             "perUser", RandomEffectDataConfiguration("userId", "user"),
             [GLMOptimizationConfiguration.parse(RE_ENET_CFG)],
             intercept_col=0, normalization=re)],
        num_iterations=2, validation_evaluators=[AreaUnderROCCurveEvaluator()],
        dtype=torch.float64, device="cpu").fit(train, val)
    return dict(jax=jfit[0][1], port=fit[0][1], jval=jval, val=val)


def test_normalized_tron_elastic_net_path_matches_jax(normalized_runs):
    port, ref = normalized_runs["port"], normalized_runs["jax"]
    got, want = port.objective_history, ref.objective_history
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-8)
    assert got[-1] < got[0]
    np.testing.assert_allclose(
        [m["AUC"] for m in port.validation_history],
        [m["AUC"] for m in ref.validation_history], atol=1e-9, rtol=0)
    for a, b in zip(port.trackers["fixed"], ref.trackers["fixed"]):
        assert int(a.reason) == int(b.reason)
        assert int(a.iterations) == int(b.iterations) >= 2
    for upd, jupd in zip(port.trackers["perUser"], ref.trackers["perUser"]):
        for a, b in zip(upd, jupd):
            np.testing.assert_array_equal(a.iterations.numpy(),
                                          np.asarray(b.iterations))
            np.testing.assert_array_equal(a.reason.numpy(),
                                          np.asarray(b.reason))


def test_normalized_tron_elastic_net_coefficients_match_jax(
        normalized_runs):
    port = normalized_runs["port"].model
    ref = normalized_runs["jax"].model
    np.testing.assert_allclose(
        port.models["fixed"].glm.coefficients.means.numpy(),
        np.asarray(ref.models["fixed"].glm.coefficients.means), atol=1e-6)
    re_port, re_ref = port.models["perUser"], ref.models["perUser"]
    assert len(re_port.local_coefs) == len(re_ref.local_coefs) >= 2
    zeros = 0
    for c, jc, f in zip(re_port.local_coefs, re_ref.local_coefs,
                        re_port.feat_idx):
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
        real = f.numpy() >= 0  # the elastic net's exact zeros agree
        np.testing.assert_array_equal(c.numpy()[real] == 0,
                                      np.asarray(jc)[real] == 0)
        zeros += int((c.numpy()[real] == 0).sum())
    assert zeros > 0


def test_normalized_jax_model_carried_across_scores_the_same(
        normalized_runs):
    _carried_across_scores(normalized_runs)
