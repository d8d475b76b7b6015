"""``--stream-train`` through the port's and the JAX package's GAME
training drivers, in the process, at float64 on the CPU, on data from
examples/generate_example_data.py's record functions (300 training and
150 validation rows, 64-row batches), with examples/run_game_training.sh's
fixed-effect configuration on a 3-point λ grid swept one λ at a time
(``--grid-batched off``).

The JAX driver computes its streamed paths at float32 on every platform
(its shard cache, streaming coordinate, assembly and validation scorer
default to float32, and its estimator is built at float32); here each
of those names is wrapped to build at float64, as
tests/test_torch_drivers.py wraps the estimator, so both sides compute
in float64. The port runs through ``run(argv, device="cpu")``.

Tolerances: equal ``bestConfigs``; decoded coefficient records within
1e-8 relative (atol 1e-12); streamed validation metrics within 1e-10.
Within the port, exactly: the resident model equals the one-shot
driver's records, and the spill models are the same records across
budgets, the redecode tier, prefetch depths and both feeders; bf16 spill
is as deterministic and within the JAX package's bf16 bound (rtol 0.1,
atol 5e-3 a coefficient). Every still-unported flag raises naming its
item. Every prefetch thread is joined with a timeout of its own.
"""

import functools
import json
import importlib.util
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.algorithm.coordinates as jax_coords
import photon_ml_tpu.data.shard_cache as jax_cache
import photon_ml_tpu.serving as jax_serving
from photon_ml_tpu.cli import game_training_driver as jax_training
from photon_ml_tpu.estimators.game_estimator import GameEstimator as JaxGE
from photon_ml_tpu_torch.cli import game_training_driver
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro_codec import read_container, write_container
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
GRID = ("fixed:50,1e-7,0.1,1.0,LBFGS,L2|50,1e-7,1.0,1.0,LBFGS,L2|"
        "50,1e-7,10.0,1.0,LBFGS,L2")
BASE = [
    "--task-type", "LOGISTIC_REGRESSION",
    "--fixed-effect-data-configurations", "fixed:global",
    "--fixed-effect-optimization-configurations", GRID,
    "--updating-sequence", "fixed",
    "--evaluators", "AUC,LOGISTIC_LOSS",
    "--stream-train", "--batch-rows", "64", "--grid-batched", "off",
]
SPILL = ["--hbm-budget", "8K"]


@pytest.fixture(autouse=True)
def _join_prefetch_threads():
    yield
    for t in threading.enumerate():
        if t.name == "host-prefetch":
            t.join(timeout=10)
            assert not t.is_alive(), "a prefetch thread did not end"


def _generator():
    spec = importlib.util.spec_from_file_location(
        "generate_example_data", REPO / "examples" / "generate_example_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write(path: Path, records) -> Path:
    path.mkdir(parents=True)
    write_container(path / "part-00000.avro", schemas.TRAINING_EXAMPLE,
                    records, sync_interval=2048)
    return path


def _records(out: Path):
    return list(read_container(out / "best" / "fixed-effect" / "fixed"
                               / "coefficients" / "part-00000.avro"))


def _means(out: Path) -> dict:
    return {(m["name"], m["term"]): m["value"]
            for rec in _records(out) for m in rec["means"]}


_FROM_STREAM = jax_cache.DeviceShardCache.from_stream.__func__
_ASSEMBLE = jax_cache.assemble_fixed_effect_batch
_COORDINATE = jax_coords.StreamingFixedEffectCoordinate
_SCORER = jax_serving.StreamingGameScorer


def _jax_run(argv, mp):
    """The JAX driver with every streamed-path float32 default widened to
    float64."""
    mp.setattr(jax_training, "GameEstimator",
               functools.partial(JaxGE, dtype=jnp.float64))
    mp.setattr(jax_cache.DeviceShardCache, "from_stream", classmethod(
        lambda cls, *a, **k: _FROM_STREAM(cls, *a, dtype=np.float64, **k)))
    mp.setattr(jax_cache, "assemble_fixed_effect_batch", functools.partial(
        _ASSEMBLE, dtype=np.float64))
    mp.setattr(jax_coords, "StreamingFixedEffectCoordinate",
               functools.partial(_COORDINATE, dtype=jnp.float64))
    mp.setattr(jax_serving, "StreamingGameScorer",
               functools.partial(_SCORER, dtype=jnp.float64))
    return jax_training.run(argv)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    gen = _generator()
    rng = np.random.default_rng(17)
    w = rng.normal(0, 1, 5)
    bias = rng.normal(0, 1.5, 24)
    root = tmp_path_factory.mktemp("stream_driver")
    train = _write(root / "train", gen.game_records(rng, 300, w, bias))
    valid = _write(root / "validate", gen.game_records(rng, 150, w, bias))
    data = ["--train-input-dirs", str(train),
            "--validate-input-dirs", str(valid)]
    out = {"root": root, "data": data}

    def port(tag, *extra):
        out[tag] = game_training_driver.run(
            [*data, *BASE, *extra, "--output-dir", str(root / tag)],
            device="cpu")

    port("resident")
    port("spill", *SPILL)
    with pytest.MonkeyPatch.context() as mp:
        out["jax-resident"] = _jax_run(
            [*data, *BASE, "--output-dir", str(root / "jax-resident")], mp)
        out["jax-spill"] = _jax_run(
            [*data, *BASE, *SPILL, "--output-dir", str(root / "jax-spill")],
            mp)
    one_shot = [a for a in BASE if a not in (
        "--stream-train", "--batch-rows", "64", "--grid-batched", "off")]
    out["oneshot"] = game_training_driver.run(
        [*data, *one_shot, "--output-dir", str(root / "oneshot")],
        device="cpu")
    port("spill-big", "--hbm-budget", "1G")
    port("spill-redecode", *SPILL, "--spill-source", "redecode")
    port("spill-python", *SPILL, "--feeder", "python",
         "--prefetch-batches", "0")
    port("spill-bf16", *SPILL, "--spill-dtype", "bf16")
    port("spill-bf16-big", "--hbm-budget", "1G", "--spill-dtype", "bf16",
         "--prefetch-batches", "1")
    return out


@pytest.mark.parametrize("mode", ["resident", "spill"])
def test_stream_train_matches_jax(runs, mode):
    mine, jax = runs[mode], runs[f"jax-{mode}"]
    assert mine["bestConfigs"] == jax["bestConfigs"]
    assert mine["numRows"] == jax["numRows"] == 300
    assert len(mine["validationHistory"]) == len(jax["validationHistory"])
    for a, b in zip(mine["validationHistory"], jax["validationHistory"]):
        assert set(a) == set(b)
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-10 * max(1.0, abs(b[k])), k
    np.testing.assert_allclose(mine["objectiveHistory"],
                               jax["objectiveHistory"], rtol=1e-8)
    got = _means(runs["root"] / mode)
    want = _means(runs["root"] / f"jax-{mode}")
    assert set(got) == set(want)
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys],
                               [want[k] for k in keys], rtol=1e-8,
                               atol=1e-12)


def test_resident_model_equals_one_shot_driver(runs):
    assert _records(runs["root"] / "resident") == _records(
        runs["root"] / "oneshot")
    info = runs["resident"]["stream_train"]
    assert info["mode"] == "resident-assembled"
    assert info["feeder"]["decode_path"] == "native"
    assert info["feeder"]["rows"] == 300 and info["feeder"]["batches"] == 5


def test_spill_models_identical_across_residency_feeder_prefetch(runs):
    ref = _records(runs["root"] / "spill")
    for tag in ("spill-big", "spill-redecode", "spill-python"):
        assert _records(runs["root"] / tag) == ref, tag
    caches = {tag: runs[tag]["stream_train"]["cache"] for tag in (
        "spill", "spill-big", "spill-redecode", "spill-python")}
    assert caches["spill-big"]["evictions"] == 0
    for tag, c in caches.items():
        assert c["hits"] + c["misses"] == c["epochs"] * c["shards"], tag
    assert caches["spill"]["evictions"] > 0
    assert runs["spill-python"]["stream_train"]["feeder"][
        "decode_path"] == "python"
    redecode = runs["spill-redecode"]["stream_train"]
    assert redecode["cache"]["spill_bytes_host"] == 0
    assert redecode["redecode"]["decode_path"] == "native"
    assert redecode["cache"]["redecodes"] == redecode["cache"]["misses"] > 0


def test_bf16_spill_deterministic_and_within_bound(runs):
    root = runs["root"]
    assert _records(root / "spill-bf16") == _records(root / "spill-bf16-big")
    c_bf, c_f32 = (runs[t]["stream_train"]["cache"]
                   for t in ("spill-bf16", "spill"))
    assert c_bf["evictions"] > 0 and c_bf["spill_dtype"] == "bf16"
    assert c_bf["spill_bytes_host"] * 4 == c_f32["spill_bytes_host"]
    ref, got = _means(root / "spill"), _means(root / "spill-bf16")
    keys = sorted(ref)
    np.testing.assert_allclose([got[k] for k in keys],
                               [ref[k] for k in keys], rtol=0.1, atol=5e-3)


def test_metrics_stream_train_block_has_jax_keys(runs):
    for mode in ("resident", "spill"):
        mine = runs[mode]["stream_train"]
        jax = runs[f"jax-{mode}"]["stream_train"]
        # The JAX TracingGuard's budgets and counts are ROADMAP A7.
        assert set(mine) == set(jax) - {"trace_budgets", "trace_counts"}
        assert set(runs[mode]) == set(runs[f"jax-{mode}"])
        assert set(runs[mode]["telemetry"]) == set(
            runs[f"jax-{mode}"]["telemetry"])
        for key in ("mode", "batch_rows", "hbm_budget_bytes", "spill_dtype",
                    "spill_source", "grid_batched", "grid_points"):
            assert mine[key] == jax[key], key
    assert set(runs["spill"]["stream_train"]["cache"]) == set(
        runs["jax-spill"]["stream_train"]["cache"])


# The batched grid and streamed MF run (tests/test_torch_stream_grid.py,
# test_torch_stream_mf.py), and so does the 1-D mesh (ROADMAP A6a,
# tests/test_torch_mesh.py). The ids are the names these cases had while
# the grid and streamed MF themselves raised naming A4b, kept so that
# each case's record goes on under one name; --distmon runs since the
# observability plane came (ROADMAP A5c), and so does the 2-D mesh
# (A6b). What a case asserts now: a 2-slot ``--mesh-devices 2`` trains,
# the sequential sweep writing the unmeshed spill run's records bit for
# bit; the batched grid trains over a 2 x 2 mesh (``--mesh-shape
# 2x2``); a 2 x 2 mesh without ``--hbm-budget`` ends with JAX's message
# before anything is written.
@pytest.mark.parametrize("extra,named,item", [
    (["--grid-batched", "on", *SPILL, "--distmon", "--mesh-shape", "2x2"],
     "--mesh-shape", "run"),
    (["--grid-batched", "auto", *SPILL, "--mesh-devices", "2"],
     "--mesh-devices", "run"),
    (["--distmon", "--mesh-shape", "2x2"], "--hbm-budget", "raise"),
    ([*SPILL, "--mesh-devices", "2"], "--mesh-devices", "run"),
], ids=["extra0---grid-batched on-A4b", "extra1---grid-batched auto-A4b",
        "extra3---distmon-A5", "extra4---mesh-devices-A6"])
def test_unported_stream_flags_raise_naming_item(runs, tmp_path, extra,
                                                 named, item):
    argv = [*runs["data"], *BASE, *extra, "--output-dir",
            str(tmp_path / "out")]
    if item == "run":
        info = game_training_driver.run(argv, device="cpu")["stream_train"]
        two_d = named == "--mesh-shape"
        assert info["mesh_devices"] == (None if two_d else 2)
        assert list(info["mesh_shape"]) == ([2, 2] if two_d else [2, 1])
        assert info["cache"]["mesh_devices"] == (4 if two_d else 2)
        assert info["cache"]["col_blocks"] == (2 if two_d else 1)
        batched = "on" in extra or "auto" in extra
        assert info["grid_batched"] is batched
        if not batched:
            assert _records(tmp_path / "out") == _records(
                runs["root"] / "spill")
        return
    with pytest.raises(ValueError, match="a mesh of > 1 device requires "
                       f"{named}"):
        game_training_driver.run(argv, device="cpu")
    assert not (tmp_path / "out").exists()


def test_streamed_mf_trace_out_runs(runs, tmp_path):
    """Streamed matrix factorization with --trace-out (the case that
    raised naming the item until the telemetry core): the trace holds
    the MF spans, and each λ minted a kept solve trace."""
    out = tmp_path / "out"
    summary = game_training_driver.run(
        [*runs["data"], *BASE,
         "--factored-random-effect-data-configurations",
         "mf:userId,global,1,-1,-1,-1,IDENTITY",
         "--factored-random-effect-optimization-configurations",
         "mf:20,1e-6,1.0,1.0,LBFGS,L2;20,1e-6,1.0,1.0,LBFGS,L2;1,2",
         "--updating-sequence", "mf", "--task-type", "LINEAR_REGRESSION",
         "--trace-out", str(tmp_path / "t.json"), "--output-dir",
         str(out)], device="cpu")
    doc = json.loads((tmp_path / "t.json").read_text())
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"driver", "solve", "factor_plan", "accumulate", "factor_solve",
            "solver_step", "decode"} <= names
    tail = summary["observability"]["trace_tail"]
    assert tail["seen"] >= 2  # the λ's solve and its sweep
    assert summary["telemetry"]["attributed_wall_frac"] >= 0.9


def test_jax_checks_of_spill_flags_and_no_cpu_fallback(runs, tmp_path,
                                                       monkeypatch):
    argv = [*runs["data"], *BASE, "--output-dir", str(tmp_path / "o")]
    with pytest.raises(ValueError, match="--spill-dtype applies"):
        game_training_driver.run([*argv, "--spill-dtype", "bf16"],
                                 device="cpu")
    with pytest.raises(ValueError, match="pick one"):
        game_training_driver.run([*argv, *SPILL, "--spill-dtype", "bf16",
                                  "--spill-source", "redecode"],
                                 device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        game_training_driver.run([*argv, *SPILL])
