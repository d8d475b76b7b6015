"""The GAME slice's path 3, per-entity TRON, end to end against the JAX
package, float64 on the CPU, 2 coordinate-descent iterations with
validation AUC, over a fixed effect, a per-user and a per-item random
effect (the coordinates of bench.py's config 5 without its factored
one), every one TRON/L2 "15,1e-5,1.0,1.0"; fixed and per-user under
STANDARDIZATION, per-item not normalized.

The JAX run routes its random-effect buckets through the Pallas kernel
in interpreter mode (PHOTON_ML_TPU_PALLAS_INTERPRET=1), the port through
the plain version of its kernel; the fixed effects are the host solvers
on both sides. Tolerances: objective history rtol 1e-8, coefficients
atol 1e-6, AUC 1e-9, equal iterations and stop reasons per solve.
tests/test_torch_game_bounds.py drives path 4 on the same data layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.data.game_data import GameDataset as JaxGameDataset
from photon_ml_tpu.data.normalization import (
    build_normalization_context as jax_build_context,
)
from photon_ml_tpu.data.random_effect import (
    RandomEffectDataConfiguration as JaxREConfig,
)
from photon_ml_tpu.data.stats import BasicStatisticalSummary as JaxSummary
from photon_ml_tpu.estimators import game_estimator as jax_est
from photon_ml_tpu.evaluation.evaluators import (
    AreaUnderROCCurveEvaluator as JaxAUC,
)
from photon_ml_tpu.optimization import config as jax_config
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.normalization import build_normalization_context
from photon_ml_tpu_torch.data.random_effect import (
    RandomEffectDataConfiguration,
)
from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary
from photon_ml_tpu_torch.estimators import game_estimator as est
from photon_ml_tpu_torch.evaluation.evaluators import (
    AreaUnderROCCurveEvaluator,
)
from photon_ml_tpu_torch.optimization import config
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

TRON_CFG = "15,1e-5,1.0,1.0,TRON,L2"
D, D_USER, D_ITEM = 6, 4, 3


def _columns(seed=5, n_users=60, n_items=40):
    """480 training rows, in which every user has 8 rows and every item
    12 (one bucket per coordinate, which keeps the interpreted kernel's
    compilations few), then 120 hold-out rows."""
    rng = np.random.default_rng(seed)
    n_train = 8 * n_users
    assert n_train == 12 * n_items
    n = n_train * 5 // 4
    x = rng.normal(0, 1, (n, D)) * 2.0 + 0.5
    x[:, -1] = 1.0
    xu = rng.normal(0, 1, (n, D_USER))
    xu[:, 0] = 1.0
    xi = rng.normal(0, 1, (n, D_ITEM))
    xi[:, 0] = 1.0
    users = np.concatenate([rng.permutation(np.repeat(np.arange(n_users), 8)),
                            rng.integers(0, n_users, n - n_train)])
    items = np.concatenate([rng.permutation(np.repeat(np.arange(n_items), 12)),
                            rng.integers(0, n_items, n - n_train)])
    z = (x @ rng.normal(0, 0.5, D)
         + np.einsum("nd,nd->n", xu,
                     rng.normal(0, 0.4, (n_users, D_USER))[users])
         + np.einsum("nd,nd->n", xi,
                     rng.normal(0, 0.4, (n_items, D_ITEM))[items]))
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return dict(responses=y,
                feature_shards={"global": sp.csr_matrix(x),
                                "user": sp.csr_matrix(xu),
                                "item": sp.csr_matrix(xi)},
                ids={"userId": users.astype(str), "itemId": items.astype(str)})


def _split(ds, n):
    cut = int(0.8 * n)
    return ds.subset(np.arange(cut)), ds.subset(np.arange(cut, n))


def _specs(side, cols):
    """The path's coordinate specs for the JAX package or the port."""
    m = jax_est if side == "jax" else est
    parse = (jax_config if side == "jax" else config
             ).GLMOptimizationConfiguration.parse
    re_config = JaxREConfig if side == "jax" else RandomEffectDataConfiguration
    if side == "jax":
        ctx = [jax_build_context(
            "STANDARDIZATION", JaxSummary.compute(cols["feature_shards"][s]),
            i) for s, i in (("global", D - 1), ("user", 0))]
    else:
        ctx = [build_normalization_context(
            "STANDARDIZATION",
            BasicStatisticalSummary.compute(cols["feature_shards"][s]), i,
            device="cpu") for s, i in (("global", D - 1), ("user", 0))]
    tron = [parse(TRON_CFG)]
    return [m.FixedEffectSpec("fixed", "global", tron, normalization=ctx[0]),
            m.RandomEffectSpec("perUser", re_config("userId", "user"), tron,
                               intercept_col=0, normalization=ctx[1]),
            m.RandomEffectSpec("perItem", re_config("itemId", "item"), tron,
                               intercept_col=0)]


def _run():
    cols = _columns(seed=3)
    n = len(cols["responses"])
    mp = pytest.MonkeyPatch()
    mp.setenv("PHOTON_ML_TPU_PALLAS_INTERPRET", "1")
    try:
        jtrain, jval = _split(JaxGameDataset.build(**cols), n)
        jfit = jax_est.GameEstimator(
            JaxTaskType.LOGISTIC_REGRESSION, _specs("jax", cols),
            num_iterations=2, validation_evaluators=[JaxAUC()],
            dtype=jnp.float64).fit(jtrain, jval)
    finally:
        mp.undo()
    train, val = _split(GameDataset.build(**cols), n)
    fit = est.GameEstimator(
        TaskType.LOGISTIC_REGRESSION, _specs("port", cols),
        num_iterations=2, validation_evaluators=[AreaUnderROCCurveEvaluator()],
        dtype=torch.float64, device="cpu").fit(train, val)
    return dict(jax=jfit[0][1], port=fit[0][1])


@pytest.fixture(scope="module")
def run():
    return _run()


def test_objectives_and_auc_match_jax(run):
    r = run
    got, want = r["port"].objective_history, r["jax"].objective_history
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, rtol=1e-8)
    assert got[-1] < got[0]
    np.testing.assert_allclose(
        [m["AUC"] for m in r["port"].validation_history],
        [m["AUC"] for m in r["jax"].validation_history], atol=1e-9, rtol=0)


def test_solves_stop_alike(run):
    """Per update: the fixed-effect solve and every bucket's entity solve
    stop after the same iterations for the same reasons."""
    r = run
    port, ref = r["port"].trackers, r["jax"].trackers
    for a, b in zip(port["fixed"], ref["fixed"]):
        assert int(a.iterations) == int(b.iterations) >= 1
        assert int(a.reason) == int(b.reason)
    for name in ("perUser", "perItem"):
        assert len(port[name]) == len(ref[name]) == 2
        for upd, jupd in zip(port[name], ref[name]):
            assert len(upd) == len(jupd) >= 1
            for a, b in zip(upd, jupd):
                np.testing.assert_array_equal(a.iterations.numpy(),
                                              np.asarray(b.iterations))
                np.testing.assert_array_equal(a.reason.numpy(),
                                              np.asarray(b.reason))


def test_coefficients_match_jax(run):
    port, ref = run["port"].model, run["jax"].model
    np.testing.assert_allclose(
        port.models["fixed"].glm.coefficients.means.numpy(),
        np.asarray(ref.models["fixed"].glm.coefficients.means), atol=1e-6)
    for name in ("perUser", "perItem"):
        re_port, re_ref = port.models[name], ref.models[name]
        assert len(re_port.local_coefs) == len(re_ref.local_coefs) == 1
        for c, jc in zip(re_port.local_coefs, re_ref.local_coefs):
            np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
