"""Checkpoints and random-effect-only models, float64 on the CPU.

- A coordinate-descent run (fixed effect with down-sampling rate 0.5, so
  every update draws from its generator; a per-user effect; a factored
  per-item effect; validation) interrupted after a checkpoint and
  resumed from it equals the uninterrupted run bit for bit: objective
  and validation histories, every coefficient of the final and the best
  model, and the trackers' lengths. Each update's generator is seeded
  from (seed, step), as the JAX package's fold_in(base, step) makes its
  key. A checkpoint of another configuration is refused, and the
  training driver's --checkpoint-dir resumes a finished run to the same
  metrics.
- A per-user-only GAME (a random effect first, so coordinate descent
  takes its rows from the blocks) against the JAX package's estimator at
  float64, which takes its vmapped CPU solves: objective history rtol
  1e-8, validation AUC within 1e-9, coefficients atol 1e-6, equal
  iterations and stop reasons.
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
from photon_ml_tpu.optimization import config as jax_config
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.algorithm import coordinates
from photon_ml_tpu_torch.cli import game_training_driver
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.random_effect import (
    RandomEffectDataConfiguration,
)
from photon_ml_tpu_torch.estimators import game_estimator as est
from photon_ml_tpu_torch.evaluation.evaluators import (
    AreaUnderROCCurveEvaluator,
)
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro_codec import write_container
from photon_ml_tpu_torch.optimization.config import (
    FactoredRandomEffectOptimizationConfiguration,
    GLMOptimizationConfiguration,
)
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import checkpoint as ckpt
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

FE_CFG = "30,1e-7,1.0,0.5,LBFGS,L2"  # down-sampling rate 0.5
RE_CFG = "20,1e-6,1.0,1.0,LBFGS,L2"
FAC_CFG = f"{RE_CFG};{RE_CFG};1,2"


def _columns(seed=4, n=500, d=5, n_users=25, n_items=12, d_re=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d))
    x[:, -1] = 1.0
    xu = rng.normal(0, 1, (n, d_re))
    xu[:, 0] = 1.0
    users = rng.integers(0, n_users, n)
    items = rng.integers(0, n_items, n)
    z = (x @ rng.normal(0, 0.5, d)
         + np.einsum("nd,nd->n", xu, rng.normal(0, 0.4, (n_users, d_re))
                     [users]) + rng.normal(0, 0.5, n_items)[items])
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return dict(responses=y,
                feature_shards={"global": sp.csr_matrix(x),
                                "user": sp.csr_matrix(xu),
                                "item": sp.csr_matrix(xu[:, :2])},
                ids={"userId": users.astype(str),
                     "itemId": items.astype(str)})


@pytest.fixture(scope="module")
def data():
    full = GameDataset.build(**_columns())
    return full.subset(np.arange(400)), full.subset(np.arange(400, 500))


def _estimator(sequence=("fixed", "perUser", "itemFactors")):
    specs = {
        "fixed": est.FixedEffectSpec(
            "fixed", "global", [GLMOptimizationConfiguration.parse(FE_CFG)]),
        "perUser": est.RandomEffectSpec(
            "perUser", RandomEffectDataConfiguration("userId", "user"),
            [GLMOptimizationConfiguration.parse(RE_CFG)], intercept_col=0),
        "itemFactors": est.FactoredRandomEffectSpec(
            "itemFactors", RandomEffectDataConfiguration("itemId", "item"),
            [FactoredRandomEffectOptimizationConfiguration.parse(FAC_CFG)]),
    }
    return est.GameEstimator(
        TaskType.LOGISTIC_REGRESSION, [specs[n] for n in sequence],
        num_iterations=3,
        validation_evaluators=[AreaUnderROCCurveEvaluator()],
        dtype=torch.float64, device="cpu")


def _tensors(game_model):
    """Every tensor of a GameModel, in a fixed order."""
    out = []

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            out.append(obj)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v)
        elif hasattr(obj, "__dataclass_fields__"):
            for f in obj.__dataclass_fields__:
                walk(getattr(obj, f))

    for m in game_model.models.values():
        walk(m)
    return out


def _assert_identical(a, b):
    assert a.objective_history == b.objective_history
    assert a.validation_history == b.validation_history
    assert a.best_metric == b.best_metric
    for ma, mb in ((a.model, b.model), (a.best_model, b.best_model)):
        ta, tb = _tensors(ma), _tensors(mb)
        assert len(ta) == len(tb) > 0
        for x, y in zip(ta, tb):
            assert torch.equal(x, y)
    assert {n: len(t) for n, t in a.trackers.items()} == {
        n: len(t) for n, t in b.trackers.items()}
    assert [(u["iteration"], u["coordinate"], u["objective"])
            for u in a.updates] == [(u["iteration"], u["coordinate"],
                                     u["objective"]) for u in b.updates]
    assert set(a.timings) == set(b.timings)


@pytest.fixture(scope="module")
def uninterrupted(data):
    train, val = data
    (_, result), = _estimator().fit(train, val, seed=3)
    return result


class _Interrupt(Exception):
    pass


@pytest.mark.parametrize("interval,stop_after", [(1, 4), (1, 6), (2, 5),
                                                 (3, 7), (4, 3)])
def test_resumed_run_is_bit_identical(data, uninterrupted, tmp_path,
                                      monkeypatch, interval, stop_after):
    """Killed after ``stop_after`` updates (mid-iteration or at its end),
    then rerun on the same checkpoint directory."""
    train, val = data
    calls = {"n": 0}
    originals = {cls: cls.update_model for cls in (
        coordinates.FixedEffectCoordinate,
        coordinates.RandomEffectCoordinate,
        coordinates.FactoredRandomEffectCoordinate)}

    def counting(original):
        def update(self, *args, **kwargs):
            if calls["n"] == stop_after:
                raise _Interrupt
            calls["n"] += 1
            return original(self, *args, **kwargs)
        return update

    for cls, original in originals.items():
        monkeypatch.setattr(cls, "update_model", counting(original))
    with pytest.raises(_Interrupt):
        _estimator().fit(train, val, seed=3, checkpoint_dir=tmp_path,
                         checkpoint_interval=interval)
    saved = ckpt.all_checkpoint_steps(tmp_path / "combo-0")
    assert saved and max(saved) <= stop_after
    for cls, original in originals.items():
        monkeypatch.setattr(cls, "update_model", original)
    (_, resumed), = _estimator().fit(train, val, seed=3,
                                     checkpoint_dir=tmp_path,
                                     checkpoint_interval=interval)
    _assert_identical(resumed, uninterrupted)
    assert ckpt.latest_checkpoint(tmp_path / "combo-0").name \
        == "ckpt-00000009.pkl"


def test_checkpoint_of_another_configuration_is_refused(data, tmp_path):
    train, val = data
    _estimator().fit(train, val, seed=3, checkpoint_dir=tmp_path)
    with pytest.raises(ValueError, match="different configuration"):
        _estimator().fit(train, val, seed=4, checkpoint_dir=tmp_path)


def test_step_generator_depends_on_seed_and_step_only():
    def draw(seed, step):
        return torch.rand(4, generator=ckpt.step_generator(seed, step,
                                                           "cpu"))

    assert torch.equal(draw(3, 5), draw(3, 5))
    assert not torch.equal(draw(3, 5), draw(3, 6))
    assert not torch.equal(draw(3, 5), draw(4, 5))


def test_training_driver_resumes_from_its_checkpoints(tmp_path):
    """--checkpoint-dir: a rerun of a finished run resumes at its last
    step and writes the same metrics."""
    cols = _columns(seed=9, n=200)
    rows = [{"uid": f"r{i}", "label": float(cols["responses"][i]),
             "features": [{"name": f"x{j}", "term": None, "value": float(v)}
                          for j, v in enumerate(
                              cols["feature_shards"]["global"][i]
                              .toarray().ravel()[:-1])],
             "weight": None, "offset": None,
             "metadataMap": {"userId": str(cols["ids"]["userId"][i])}}
            for i in range(200)]
    (tmp_path / "train").mkdir()
    write_container(tmp_path / "train" / "part-00000.avro",
                    schemas.TRAINING_EXAMPLE, rows)
    argv = ["--train-input-dirs", str(tmp_path / "train"),
            "--task-type", "LOGISTIC_REGRESSION",
            "--fixed-effect-data-configurations", "fixed:global",
            "--fixed-effect-optimization-configurations", f"fixed:{FE_CFG}",
            "--random-effect-data-configurations",
            "perUser:userId,global,1,-1,-1,-1",
            "--random-effect-optimization-configurations",
            f"perUser:{RE_CFG}", "--updating-sequence", "fixed,perUser",
            "--num-iterations", "2", "--checkpoint-interval", "3",
            "--checkpoint-dir", str(tmp_path / "ckpt")]
    first = game_training_driver.run(
        [*argv, "--output-dir", str(tmp_path / "a")], device="cpu")
    assert ckpt.all_checkpoint_steps(tmp_path / "ckpt" / "combo-0") == [3]
    again = game_training_driver.run(
        [*argv, "--output-dir", str(tmp_path / "b")], device="cpu")
    assert again["objectiveHistory"] == first["objectiveHistory"]
    assert len(first["objectiveHistory"]) == 4


def test_random_effect_only_model_matches_jax(data):
    """The per-user coordinate alone: the rows come from its blocks."""
    train, val = data
    cols = _columns()
    jfull = JaxGameDataset.build(**cols)
    jtrain, jval = jfull.subset(np.arange(400)), jfull.subset(
        np.arange(400, 500))
    (_, mine), = _estimator(("perUser",)).fit(train, val)
    jspec = jax_est.RandomEffectSpec(
        "perUser", JaxREConfig("userId", "user"),
        [jax_config.GLMOptimizationConfiguration.parse(RE_CFG)],
        intercept_col=0)
    (_, theirs), = jax_est.GameEstimator(
        JaxTaskType.LOGISTIC_REGRESSION, [jspec], num_iterations=3,
        validation_evaluators=[JaxAUC()], dtype=jnp.float64).fit(
            jtrain, jval)
    np.testing.assert_allclose(mine.objective_history,
                               theirs.objective_history, rtol=1e-8, atol=0)
    assert len(mine.objective_history) == 3
    for a, b in zip(mine.validation_history, theirs.validation_history):
        assert abs(a["AUC"] - b["AUC"]) <= 1e-9
    m, t = mine.model.models["perUser"], theirs.model.models["perUser"]
    for c, jc in zip(m.local_coefs, t.local_coefs):
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6,
                                   rtol=0)
    for tr, jtr in zip(mine.trackers["perUser"], theirs.trackers["perUser"]):
        for r, jr in zip(tr, jtr):
            np.testing.assert_array_equal(r.iterations.numpy(),
                                          np.asarray(jr.iterations))
            np.testing.assert_array_equal(r.reason.numpy(),
                                          np.asarray(jr.reason))
