"""The GAME slice's path 4, box constraints, end to end against the JAX
package, float64 on the CPU, 2 coordinate-descent iterations with
validation AUC, over a fixed effect, a per-user and a per-item random
effect (the coordinates of bench.py's config 5 without its factored
one): fixed and per-user L-BFGS/L2, per-item TRON/L2, every coordinate
with a coefficient box from ``constraint_arrays`` (intercepts free), so
the fixed effect runs the projected L-BFGS, the per-user buckets bounded
L-BFGS and the per-item buckets bounded TRON.

The JAX run routes its random-effect buckets through the Pallas kernel
in interpreter mode (PHOTON_ML_TPU_PALLAS_INTERPRET=1), the port through
the plain version of its kernel. Tolerances: objective history rtol
1e-8, coefficients atol 1e-6, AUC 1e-9, equal iterations per solve and
equal stop reasons, every coefficient in its box and some at a bound in
every coordinate. One exception to equal reasons is allowed, at equal
iterations: a bounded L-BFGS entity whose last Armijo test sits on a
rounding borderline at convergence may stop with
FUNCTION_VALUES_CONVERGED on one side and OBJECTIVE_NOT_IMPROVING on the
other, because the Pallas kernel keeps its iterate with an arithmetic
select that can move it by an ulp (ROADMAP §C, "Selects").
"""

import json

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
from photon_ml_tpu.optimization import config as jax_config
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.random_effect import (
    RandomEffectDataConfiguration,
)
from photon_ml_tpu_torch.estimators import game_estimator as est
from photon_ml_tpu_torch.evaluation.evaluators import (
    AreaUnderROCCurveEvaluator,
)
from photon_ml_tpu_torch.optimization import config
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

TRON_CFG = "15,1e-5,1.0,1.0,TRON,L2"
FE_CFG = "50,1e-7,1.0,1.0,LBFGS,L2"
RE_CFG = "20,1e-6,1.0,1.0,LBFGS,L2"
D, D_USER, D_ITEM = 6, 4, 3
BOXES = {"fixed": (0.3, D - 1), "perUser": (0.2, 0), "perItem": (0.1, 0)}


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


def _box(name, d):
    bound, intercept = BOXES[name]
    spec = json.dumps([{"name": "*", "term": "*", "lowerBound": -bound,
                        "upperBound": bound}])
    index_map = {(f"f{j}", ""): j for j in range(d)}
    return config.constraint_arrays(
        config.parse_constraint_string(spec, index_map), d, intercept)


def _specs(side):
    """The path's coordinate specs for the JAX package or the port."""
    m = jax_est if side == "jax" else est
    parse = (jax_config if side == "jax" else config
             ).GLMOptimizationConfiguration.parse
    re_config = JaxREConfig if side == "jax" else RandomEffectDataConfiguration
    arr = jnp.asarray if side == "jax" else (lambda a: a)

    def box(name, d):
        lo, hi = _box(name, d)
        return dict(lower_bounds=arr(lo), upper_bounds=arr(hi))

    return [m.FixedEffectSpec("fixed", "global", [parse(FE_CFG)],
                              **box("fixed", D)),
            m.RandomEffectSpec("perUser", re_config("userId", "user"),
                               [parse(RE_CFG)], intercept_col=0,
                               **box("perUser", D_USER)),
            m.RandomEffectSpec("perItem", re_config("itemId", "item"),
                               [parse(TRON_CFG)], intercept_col=0,
                               **box("perItem", D_ITEM))]


def _run():
    cols = _columns(seed=4)
    n = len(cols["responses"])
    mp = pytest.MonkeyPatch()
    mp.setenv("PHOTON_ML_TPU_PALLAS_INTERPRET", "1")
    try:
        jtrain, jval = _split(JaxGameDataset.build(**cols), n)
        jfit = jax_est.GameEstimator(
            JaxTaskType.LOGISTIC_REGRESSION, _specs("jax"),
            num_iterations=2, validation_evaluators=[JaxAUC()],
            dtype=jnp.float64).fit(jtrain, jval)
    finally:
        mp.undo()
    train, val = _split(GameDataset.build(**cols), n)
    fit = est.GameEstimator(
        TaskType.LOGISTIC_REGRESSION, _specs("port"),
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
    stop after the same iterations for the same reasons (but for the
    borderline described above)."""
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
                got, want = a.reason.numpy(), np.asarray(b.reason)
                swapped = got != want
                assert set(got[swapped]) | set(want[swapped]) <= {2, 4}
                assert swapped.mean() <= 0.02, (got, want)


def test_coefficients_match_jax_inside_their_boxes(run):
    port, ref = run["port"].model, run["jax"].model
    fe = port.models["fixed"].glm.coefficients.means.numpy()
    np.testing.assert_allclose(
        fe, np.asarray(ref.models["fixed"].glm.coefficients.means),
        atol=1e-6)
    lo, hi = _box("fixed", D)
    assert ((fe >= lo) & (fe <= hi)).all()
    pinned = {"fixed": int(((fe == lo) | (fe == hi)).sum())}
    for name, d in (("perUser", D_USER), ("perItem", D_ITEM)):
        re_port, re_ref = port.models[name], ref.models[name]
        assert len(re_port.local_coefs) == len(re_ref.local_coefs) == 1
        pinned[name] = 0
        for c, jc, f in zip(re_port.local_coefs, re_ref.local_coefs,
                            re_port.feat_idx):
            c, f = c.numpy(), f.numpy()
            np.testing.assert_allclose(c, np.asarray(jc), atol=1e-6)
            lo, hi = (a[np.maximum(f, 0)] for a in _box(name, d))
            real = f >= 0
            assert ((c >= lo) & (c <= hi))[real].all()
            pinned[name] += int((((c == lo) | (c == hi)) & real).sum())
    assert min(pinned.values()) > 0, pinned
