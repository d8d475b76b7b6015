"""The fused coordinate update on the CPU (algorithm/coordinate_descent.py,
utils/device_loop.py; JAX coordinate_descent.py:41-92, :124-235,
:323-555, utils/tracing_guard.py:57-68), float64:

- every body the card would capture (one update of each coordinate
  kind, each solver loop run as its WHILE node records it: the predicate,
  one body, the predicate) under a dispatch mode that raises on a host
  read (``_local_scalar_dense``, ``nonzero``, boolean-mask indexing, a
  constant copied from the host); the entity kernel's plain version
  stands for the kernel and runs outside the mode;
- the run's sync spans against the JAX run's ("iterations a-b dispatched
  as one device block" lines), with no validation, with validation (span
  1), checkpoints every n_coords updates and every 3 (the per-step
  path); the objective history and coefficients against JAX's at the
  GAME tests' tolerances (rtol 1e-8, atol 1e-6), and a run resumed
  mid-iteration against the uninterrupted port run bit for bit;
- LazyTrackers: it fills on first access, and its entries equal an
  eager run's trackers;
- the guard: each ``fused:{name}`` counted once after a run, and the
  module-level ``assert_max_retraces`` raising as JAX's does
  (tests/test_tracing_guard.py:35-41);
- ``uncounted()``: a timing capture's launches count nowhere, and the
  tally around it is back after it.
"""

import logging
import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from photon_ml_tpu.algorithm import coordinate_descent as jax_cd
from photon_ml_tpu.algorithm import coordinates as jax_coords
from photon_ml_tpu.data.game_data import GameDataset as JaxGameDataset
from photon_ml_tpu.data.random_effect import (
    RandomEffectDataConfiguration as JaxREConfig,
)
from photon_ml_tpu.data.random_effect import (
    build_random_effect_dataset as jax_build_re,
)
from photon_ml_tpu.evaluation.evaluators import (
    AreaUnderROCCurveEvaluator as JaxAUC,
)
from photon_ml_tpu.optimization import config as jax_config
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.algorithm import coordinate_descent as cd_mod
from photon_ml_tpu_torch.algorithm import coordinates
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.random_effect import (
    RandomEffectDataConfiguration,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.evaluation.evaluators import (
    AreaUnderROCCurveEvaluator,
)
from photon_ml_tpu_torch.optimization import glm_lbfgs, lbfgs, owlqn, tron
from photon_ml_tpu_torch.optimization.config import (
    GLMOptimizationConfiguration,
    MFOptimizationConfiguration,
)
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import device_loop
from photon_ml_tpu_torch.utils.tracing_guard import (
    RetraceError,
    assert_max_retraces,
)
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

F64 = torch.float64
TASK = TaskType.LOGISTIC_REGRESSION
FE_CFG = "20,1e-7,1.0,1.0,LBFGS,L2"
RE_CFG = "10,1e-6,1.0,1.0,LBFGS,L2"
ITERATIONS = 2


def _columns(seed=5, n=500, d=6, n_users=12, d_user=3, n_items=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d))
    x[:, -1] = 1.0
    xu = rng.normal(0, 1, (n, d_user))
    xu[:, 0] = 1.0
    users = rng.integers(0, n_users, n)
    items = rng.integers(0, n_items, n)
    z = (x @ rng.normal(0, 0.5, d)
         + np.einsum("nd,nd->n", xu, rng.normal(0, 0.3, (n_users, d_user))
                     [users]))
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return dict(responses=y,
                feature_shards={"global": sp.csr_matrix(x),
                                "user": sp.csr_matrix(xu)},
                ids={"userId": users.astype(str), "itemId": items.astype(str)})


def _split(ds):
    cut = int(0.8 * ds.num_rows)
    return ds.subset(np.arange(cut)), ds.subset(np.arange(cut, ds.num_rows))


@pytest.fixture(scope="module")
def data():
    cols = _columns()
    return (_split(GameDataset.build(**cols)),
            _split(JaxGameDataset.build(**cols)))


def _port_cd(train, val=None, fused=True, fe_cfg=FE_CFG, re_cfg=RE_CFG):
    user = build_random_effect_dataset(
        train, RandomEffectDataConfiguration("userId", "user"), seed=0,
        intercept_col=0, dtype=F64, device="cpu")
    coords = {
        "fixed": coordinates.FixedEffectCoordinate(
            "fixed", train, "global", TASK,
            GLMOptimizationConfiguration.parse(fe_cfg), dtype=F64,
            device="cpu"),
        "perUser": coordinates.RandomEffectCoordinate(
            "perUser", user, TASK, GLMOptimizationConfiguration.parse(re_cfg))}
    return cd_mod.CoordinateDescent(
        coords, TASK, validation_data=val,
        validation_evaluators=[AreaUnderROCCurveEvaluator()] if val else (),
        dtype=F64, device="cpu", fused=fused)


def _jax_cd(train):
    user = jax_build_re(train, JaxREConfig("userId", "user"), seed=0,
                        intercept_col=0, dtype=jnp.float64)
    parse = jax_config.GLMOptimizationConfiguration.parse
    coords = {
        "fixed": jax_coords.FixedEffectCoordinate(
            name="fixed", data=train, feature_shard_id="global",
            task_type=JaxTaskType.LOGISTIC_REGRESSION, config=parse(FE_CFG),
            dtype=jnp.float64),
        "perUser": jax_coords.RandomEffectCoordinate(
            name="perUser", dataset=user,
            task_type=JaxTaskType.LOGISTIC_REGRESSION, config=parse(RE_CFG))}
    return jax_cd.CoordinateDescent(coords, JaxTaskType.LOGISTIC_REGRESSION)


_SPAN = re.compile(r"iterations (\d+)-(\d+) dispatched as one device block")
_LOGGERS = ("photon_ml_tpu.algorithm.coordinate_descent",
            "photon_ml_tpu_torch.algorithm.coordinate_descent")


# (validating, checkpoint interval): no validation (the rest of the
# run), validation (span 1), interval n_coords (a span an iteration),
# interval 3 (not a multiple of the coordinates: the per-step path, no
# blocks).
SPAN_CASES = [(False, None), (True, None), (False, 2), (False, 3)]


@pytest.fixture(scope="module")
def span_runs(data, tmp_path_factory):
    (train, val), (jtrain, jval) = data
    handler = _Collect()
    levels = {name: logging.getLogger(name).level for name in _LOGGERS}
    for name in _LOGGERS:
        lg = logging.getLogger(name)
        lg.addHandler(handler)
        lg.setLevel(logging.INFO)
    # One JAX run object for every case, validating or not, so its
    # compiled blocks are shared.
    jax_run = _jax_cd(jtrain)
    out = {}
    try:
        for validating, interval in SPAN_CASES:
            runs = {}
            for side in ("port", "jax"):
                handler.records.clear()
                ck = (None if interval is None else tmp_path_factory.mktemp(
                    f"{side}-{validating}-{interval}"))
                kw = dict(seed=1, checkpoint_dir=ck,
                          checkpoint_interval=interval or 1)
                if side == "port":
                    res = _port_cd(train, val if validating else None).run(
                        ITERATIONS, **kw)
                else:
                    jax_run.validation_data = jval if validating else None
                    jax_run.validation_evaluators = (
                        [JaxAUC()] if validating else [])
                    res = jax_run.run(ITERATIONS, **kw)
                runs[side] = (res, [
                    tuple(map(int, m.groups())) for r in handler.records
                    for m in [_SPAN.search(r.getMessage())] if m])
            out[validating, interval] = runs
    finally:
        for name in _LOGGERS:
            logging.getLogger(name).removeHandler(handler)
            logging.getLogger(name).setLevel(levels[name])
    return out


class _Collect(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.mark.parametrize("case", SPAN_CASES)
def test_sync_spans_match_jax(span_runs, case):
    (port, port_spans), (ref, ref_spans) = (span_runs[case]["port"],
                                            span_runs[case]["jax"])
    assert port_spans == ref_spans
    validating, interval = case
    if interval is not None and interval % 2:
        assert port_spans == []  # the per-step path
    elif validating or interval is not None:
        assert port_spans == [(0, 0), (1, 1)]
    else:
        assert port_spans == [(0, 1)]
    np.testing.assert_allclose(port.objective_history,
                               ref.objective_history, rtol=1e-8)
    assert len(port.objective_history) == 2 * ITERATIONS
    np.testing.assert_allclose(
        port.model.models["fixed"].glm.coefficients.means.numpy(),
        np.asarray(ref.model.get_model("fixed").glm.coefficients.means),
        atol=1e-6)
    if validating:
        np.testing.assert_allclose(
            [m["AUC"] for m in port.validation_history],
            [m["AUC"] for m in ref.validation_history], atol=1e-9)


def test_sync_spans_change_no_bits(span_runs):
    """Every span layout gives the uninterrupted run's bits."""
    base = span_runs[False, None]["port"][0]
    for case in SPAN_CASES[1:]:
        got = span_runs[case]["port"][0]
        assert got.objective_history == base.objective_history
        assert torch.equal(got.model.models["fixed"].glm.coefficients.means,
                           base.model.models["fixed"].glm.coefficients.means)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("interval,stop_after", [(1, 1), (3, 3)])
def test_mid_iteration_resume_is_bit_identical(data, span_runs, tmp_path,
                                               monkeypatch, interval,
                                               stop_after):
    """Killed after ``stop_after`` updates (mid-iteration), then resumed:
    the per-step path finishes the iteration, blocks the rest."""
    (train, _), _ = data
    calls = {"n": 0}
    original = coordinates.Coordinate.update_model

    def counting(self, *args, **kwargs):
        if calls["n"] == stop_after:
            raise _Stop
        calls["n"] += 1
        return original(self, *args, **kwargs)

    for cls in (coordinates.FixedEffectCoordinate,
                coordinates.RandomEffectCoordinate):
        monkeypatch.setattr(cls, "update_model", counting)
    with pytest.raises(_Stop):
        _port_cd(train).run(ITERATIONS, seed=1, checkpoint_dir=tmp_path,
                            checkpoint_interval=interval)
    monkeypatch.undo()
    resumed = _port_cd(train).run(ITERATIONS, seed=1,
                                  checkpoint_dir=tmp_path,
                                  checkpoint_interval=interval)
    base = span_runs[False, None]["port"][0]
    assert resumed.objective_history == base.objective_history
    for n in ("fixed", "perUser"):
        a, b = resumed.model.models[n], base.model.models[n]
        ta = ([a.glm.coefficients.means] if n == "fixed"
              else a.local_coefs)
        tb = ([b.glm.coefficients.means] if n == "fixed"
              else b.local_coefs)
        assert all(torch.equal(x, y) for x, y in zip(ta, tb))


def test_lazy_trackers_fill_on_first_access(data):
    (train, _), _ = data
    res = _port_cd(train).run(2, seed=1)
    trackers = res.trackers
    assert isinstance(trackers, cd_mod.LazyTrackers)
    assert trackers._pending and not any(trackers._base.values())
    assert len(trackers["fixed"]) == 2 and not trackers._pending
    eager = _port_cd(train, fused=False).run(2, seed=1).trackers
    for n in ("fixed", "perUser"):
        for a, b in zip(trackers[n], eager[n]):
            results = a if isinstance(a, list) else [a]
            ref = b if isinstance(b, list) else [b]
            for ra, rb in zip(results, ref):
                assert torch.equal(ra.x, rb.x)
                assert torch.equal(ra.iterations, rb.iterations)
                assert torch.equal(ra.reason, rb.reason)
    assert dict(trackers).keys() == {"fixed", "perUser"}


def test_guard_counts_one_build_per_coordinate(data):
    (train, _), _ = data
    cd = _port_cd(train)
    cd.run(1)
    assert cd.tracing_guard.counts() == {"fused:fixed": 1,
                                         "fused:perUser": 1}
    cd.run(1)  # a second run builds its own executables
    assert set(cd.tracing_guard.counts().values()) == {1}


def test_module_assert_max_retraces():
    class Built:
        traces = 3

    assert_max_retraces(Built(), 3)
    with pytest.raises(RetraceError, match="traced 3 times, budget 2"):
        assert_max_retraces(Built(), 2, name="step")


# ---- no host read in a captured body ----

_aten = torch.ops.aten
_FORBIDDEN = {_aten._local_scalar_dense.default, _aten.nonzero.default,
              _aten.masked_select.default, _aten.lift_fresh.default,
              _aten.equal.default, _aten.is_nonzero.default}


class _NoHostRead(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _FORBIDDEN:
            raise AssertionError(f"host read in a captured body: {func}")
        if func is _aten.index.Tensor and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            raise AssertionError("boolean-mask indexing in a captured body")
        return func(*args, **(kwargs or {}))


def _as_recorded(state, step, active):
    """A WHILE node as it is recorded: the predicate, one body, the
    predicate; nothing read on the host."""
    active(state)
    device_loop._assign(state, step(state))
    active(state)
    return state


def _entity_outside_mode(real):
    def run(*args, **kwargs):
        from torch.utils._python_dispatch import _disable_current_modes

        with _disable_current_modes():
            return real(*args, **kwargs)
    return run


BOX = (-0.3, 0.3)


def _kind_coordinate(train, kind):
    """A coordinate of a kind the card captures."""
    def dataset(*args, **kw):
        return build_random_effect_dataset(
            train, RandomEffectDataConfiguration(*args, **kw), seed=0,
            intercept_col=0 if kind == "random" else None, dtype=F64,
            device="cpu")

    d = train.feature_shards["global"].shape[1]
    lo, hi = np.full(d, BOX[0]), np.full(d, BOX[1])
    parse = GLMOptimizationConfiguration.parse

    def fe(cfg, **kw):
        return coordinates.FixedEffectCoordinate(
            "fixed", train, "global", TASK, parse(cfg), dtype=F64,
            device="cpu", **kw)

    return {
        "lbfgs": lambda: fe(FE_CFG),
        "bounded lbfgs": lambda: fe(FE_CFG, lower_bounds=lo,
                                    upper_bounds=hi),
        "owlqn": lambda: fe("20,1e-7,0.5,1.0,LBFGS,ELASTIC_NET,0.5"),
        "tron": lambda: fe("8,1e-5,1.0,1.0,TRON,L2"),
        "bounded tron": lambda: fe("8,1e-5,1.0,1.0,TRON,L2",
                                   lower_bounds=lo, upper_bounds=hi),
        "random": lambda: coordinates.RandomEffectCoordinate(
            "perUser", dataset("userId", "user"), TASK, parse(RE_CFG)),
        "factored": lambda: coordinates.FactoredRandomEffectCoordinate(
            "itemFactors", dataset("itemId", "user",
                                   projector_type="IDENTITY"),
            TASK, parse(RE_CFG), parse(RE_CFG),
            MFOptimizationConfiguration(1, 2))}[kind]()


@pytest.mark.parametrize("kind", ["lbfgs", "bounded lbfgs", "owlqn", "tron",
                                  "bounded tron", "random", "factored"])
def test_captured_bodies_read_nothing_back(data, monkeypatch, kind):
    (train, _), _ = data
    for mod in (glm_lbfgs, lbfgs, owlqn, tron):
        monkeypatch.setattr(mod, "while_loop", _as_recorded)
    monkeypatch.setattr(coordinates, "entity_lbfgs",
                        _entity_outside_mode(coordinates.entity_lbfgs))
    coord = _kind_coordinate(train, kind)
    cd = cd_mod.CoordinateDescent({coord.name: coord}, TASK, dtype=F64,
                                  device="cpu")
    models = {coord.name: coord.initialize_model()}
    params = {coord.name: [t.clone() for t in coord.params_of(
        models[coord.name])]}
    scores = {coord.name: coord.pure_score(params[coord.name])}
    hist = torch.zeros(4, dtype=F64)
    step_idx = torch.zeros((), dtype=torch.int64)
    update = cd._update_fn(coord.name, models, params, scores, {},
                           cd._training_rows(), hist, step_idx)
    with _NoHostRead():
        update()
    assert int(step_idx) == 1 and torch.isfinite(hist[0])


def test_mode_catches_host_reads():
    t = torch.ones(3)
    for read in (lambda: bool(t.sum() > 0), lambda: float(t.sum()),
                 lambda: int(t.argmax()), lambda: t[t > 0],
                 lambda: torch.tensor(1.0)):
        with pytest.raises(AssertionError):
            with _NoHostRead():
                read()


def test_uncounted_counts_nothing_and_restores_the_tally():
    tally = device_loop.LaunchTally("cpu")
    with tally.recording():
        with device_loop.uncounted():
            device_loop.active_tally().count(("entity_lbfgs", "lbfgs"))
        assert device_loop.active_tally() is tally
    assert device_loop.active_tally() is None
    assert tally.keys == [] and int(tally.counts.sum()) == 0
