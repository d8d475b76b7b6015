"""The fused coordinate update on the card (algorithm/coordinate_descent.py,
utils/device_loop.py, csrc/device_loop.cu): each coordinate's update is
one replay of a CUDA graph captured once a run, its solver loops WHILE
nodes. Held against the eager plain loop (``fused=False``) on the same
card:

- every fixed-effect solver (L-BFGS, bounded L-BFGS, OWL-QN, TRON and
  bounded TRON), with and without normalization, on CSR features (so
  row 9 runs inside the loop bodies), and every random-effect mode with
  the fold and with boxes, and the factored coordinate: coefficients,
  objective histories, every tracker tensor (values, iterations, stop
  reasons, histories, work), row-1 and row-9 launches, bit for bit;
- a model taken at a sync point is unchanged by later replays;
- one capture per coordinate per run, with its graph's figures.

Marked ``cuda``: skips without a GPU. This file imports neither jax nor
the JAX package, so it runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_fused_update_cuda.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.algorithm import coordinate_descent as cd_mod
from photon_ml_tpu_torch.algorithm.coordinates import (
    FactoredRandomEffectCoordinate,
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.normalization import (
    build_normalization_context,
)
from photon_ml_tpu_torch.data.random_effect import (
    RandomEffectDataConfiguration,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary
from photon_ml_tpu_torch.evaluation.evaluators import (
    AreaUnderROCCurveEvaluator,
)
from photon_ml_tpu_torch.ops import entity_solver, spmv
from photon_ml_tpu_torch.optimization.config import (
    GLMOptimizationConfiguration,
    MFOptimizationConfiguration,
)
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

TASK = TaskType.LOGISTIC_REGRESSION
FE = {"lbfgs": "30,1e-7,1.0,1.0,LBFGS,L2",
      "owlqn": "30,1e-7,0.5,1.0,LBFGS,ELASTIC_NET,0.5",
      "tron": "10,1e-5,1.0,1.0,TRON,L2"}
RE = {"lbfgs": "15,1e-6,1.0,1.0,LBFGS,L2",
      "owlqn": "15,1e-6,0.5,1.0,LBFGS,ELASTIC_NET,0.5",
      "tron": "10,1e-5,1.0,1.0,TRON,L2"}
BOX = 0.3


@pytest.fixture(scope="module")
def data():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs run only on the card")
    rng = np.random.default_rng(4)
    n, d, n_users, d_user, n_items = 4000, 40, 60, 5, 30
    x = sp.random(n, d, density=0.15, random_state=4, format="csr")
    x.data[:] = rng.normal(0, 1, x.nnz)
    x = sp.hstack([x, np.ones((n, 1))], format="csr")
    xu = rng.normal(0, 1, (n, d_user))
    xu[:, 0] = 1.0
    users = rng.integers(0, n_users, n)
    items = rng.integers(0, n_items, n)
    z = (x @ rng.normal(0, 0.5, d + 1)
         + np.einsum("nd,nd->n", xu, rng.normal(0, 0.3, (n_users, d_user))
                     [users]))
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    ds = GameDataset.build(
        responses=y, feature_shards={"global": x, "user": sp.csr_matrix(xu)},
        ids={"userId": users.astype(str), "itemId": items.astype(str)})
    cut = int(0.8 * n)
    return ds.subset(np.arange(cut)), ds.subset(np.arange(cut, n))


def _norm(train, shard, intercept):
    return build_normalization_context(
        "STANDARDIZATION",
        BasicStatisticalSummary.compute(train.feature_shards[shard]),
        intercept)


def _box(d):
    return np.full(d, -BOX), np.full(d, BOX)


def _fixed(train, solver, normalized=False, bounded=False):
    d = train.feature_shards["global"].shape[1]
    lo, hi = _box(d) if bounded else (None, None)
    return FixedEffectCoordinate(
        "fixed", train, "global", TASK,
        GLMOptimizationConfiguration.parse(FE[solver]),
        normalization=_norm(train, "global", d - 1) if normalized else None,
        lower_bounds=lo, upper_bounds=hi)


def _random(train, mode, normalized=False, bounded=False):
    user = build_random_effect_dataset(
        train, RandomEffectDataConfiguration("userId", "user"), seed=0,
        intercept_col=0)
    lo, hi = _box(5) if bounded else (None, None)
    return RandomEffectCoordinate(
        "perUser", user, TASK, GLMOptimizationConfiguration.parse(RE[mode]),
        normalization=_norm(train, "user", 0) if normalized else None,
        lower_bounds=lo, upper_bounds=hi)


def _factored(train):
    items = build_random_effect_dataset(
        train, RandomEffectDataConfiguration(
            "itemId", "user", projector_type="IDENTITY"), seed=0)
    cfg = GLMOptimizationConfiguration.parse(RE["lbfgs"])
    return FactoredRandomEffectCoordinate(
        "itemFactors", items, TASK, cfg, cfg, MFOptimizationConfiguration(
            1, 2), seed=0)


def _tensors(obj):
    out = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            out.append(o)
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
        elif hasattr(o, "__dataclass_fields__"):
            for f in o.__dataclass_fields__:
                walk(getattr(o, f))

    walk(obj)
    return out


def _run(make, fused, val=None, iterations=2):
    cd = cd_mod.CoordinateDescent(
        make(), TASK, validation_data=val,
        validation_evaluators=[AreaUnderROCCurveEvaluator()] if val else (),
        fused=fused)
    entity_solver.reset_launch_counts()
    spmv.reset_launch_counts()
    result = cd.run(iterations, seed=1)
    torch.cuda.synchronize()
    return (cd, result, dict(entity_solver.entity_lbfgs.variants),
            spmv.csr_matvec.launches)


def _same(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb) > 0
    for x, y in zip(ta, tb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert bool(((x == y) | (x.isnan() & y.isnan())).all())


def _assert_graph_is_eager(make, val=None):
    cd, fused, launches_f, row9_f = _run(make, True, val)
    _, eager, launches_e, row9_e = _run(make, False, val)
    assert fused.objective_history == eager.objective_history
    assert fused.validation_history == eager.validation_history
    _same(list(fused.model.models.values()),
          list(eager.model.models.values()))
    for name in eager.trackers:
        _same(fused.trackers[name], eager.trackers[name])
    assert (launches_f, row9_f) == (launches_e, row9_e)
    assert cd.tracing_guard.counts() == {f"fused:{n}": 1
                                         for n in cd.coordinates}
    for name in cd.coordinates:
        assert fused.graphs[name]["nodes"] > 0
    assert eager.graphs == {}
    return fused, launches_f, row9_f


@pytest.mark.cuda
@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("solver,bounded", [("lbfgs", False),
                                            ("lbfgs", True),
                                            ("owlqn", False),
                                            ("tron", False),
                                            ("tron", True)])
def test_fixed_effect_graph_is_the_eager_loop(data, solver, bounded,
                                              normalized):
    train, _ = data
    fused, _, row9 = _assert_graph_is_eager(
        lambda: {"fixed": _fixed(train, solver, normalized, bounded)})
    assert row9 > 0
    assert fused.graphs["fixed"]["loops"] >= 1
    assert int(fused.trackers["fixed"][0].iterations) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode,normalized,bounded", [
    ("lbfgs", False, False), ("lbfgs", True, False), ("lbfgs", False, True),
    ("owlqn", True, False), ("tron", False, False), ("tron", True, False),
    ("tron", False, True)])
def test_random_effect_graph_is_the_eager_loop(data, mode, normalized,
                                               bounded):
    train, val = data
    _, launches, _ = _assert_graph_is_eager(lambda: {
        "fixed": _fixed(train, "lbfgs"),
        "perUser": _random(train, mode, normalized, bounded)}, val)
    variant = entity_solver.variant(mode, normalized, bounded)
    assert set(launches) == {variant} and launches[variant] > 0


@pytest.mark.cuda
def test_factored_graph_is_the_eager_loop(data):
    train, val = data
    _assert_graph_is_eager(lambda: {
        "fixed": _fixed(train, "lbfgs"), "perUser": _random(train, "lbfgs"),
        "itemFactors": _factored(train)}, val)


@pytest.mark.cuda
def test_models_at_sync_points_outlive_later_replays(data, monkeypatch):
    """The model validated after iteration 0 keeps its bits while
    iterations 1-2 replay the graphs."""
    train, val = data
    seen = []
    original = cd_mod.CoordinateDescent._validate

    def record(self, game_model):
        seen.append((game_model, [t.clone() for t in _tensors(
            list(game_model.models.values()))]))
        return original(self, game_model)

    monkeypatch.setattr(cd_mod.CoordinateDescent, "_validate", record)
    _, result, _, _ = _run(lambda: {"fixed": _fixed(train, "lbfgs"),
                                    "perUser": _random(train, "lbfgs")},
                           True, val, iterations=3)
    assert len(seen) == 3
    for game_model, snapshot in seen:
        for t, s in zip(_tensors(list(game_model.models.values())),
                        snapshot):
            assert torch.equal(t, s)
    first = _tensors(list(seen[0][0].models.values()))
    last = _tensors(list(result.model.models.values()))
    assert any(not torch.equal(a, b) for a, b in zip(first, last))
