"""The port's GAME training and batch scoring drivers against the JAX
package's, float64 on the CPU, on data from
examples/generate_example_data.py's record functions (a few hundred
rows), with the flags of the two example scripts:

- examples/run_game_training.sh: L-BFGS/L2 fixed effect and per-user
  effect;
- examples/run_game_full.sh: TRON fixed effect, elastic-net (OWL-QN)
  per-user effect, factored per-movie effect, over PalDB feature-index
  stores written by the JAX package's feature-indexing CLI (plus
  --save-all-models true, so all/0 is compared too).

The JAX training driver builds its GameEstimator at float32 on every
platform (photon_ml_tpu/cli/game_training_driver.py:598); here the
driver module's ``GameEstimator`` name is wrapped to build it at float64,
so both sides compute in float64. Otherwise the JAX drivers run as the
JAX package's own driver tests run on the CPU: the random effects take
the vmapped solves, not the Pallas kernel. The port runs through
``run(argv, device="cpu")``.

Tolerances (PERF.md §6): objectiveHistory rtol 1e-8, validation AUC
within 1e-9, equal bestConfigs and convergence summaries, decoded
coefficient records atol 1e-6; cross-scoring (each driver scores both
trained models): scores atol 1e-10, AUC 1e-9; --stream and --serve
(each driver scoring the port-trained models): scores allclose 1e-12,
the same metrics, equal shared summary keys. Every summary has JAX's
full key set, ``telemetry`` and ``observability`` included; the
training runs take --trace-out, and their stage names, the metrics they
moved and their trace's span names are JAX's. The telemetry flags
(--trace-out, --profile-output-dir, --flight-events) run and leave
their output, and so do the observability flags (--distmon, --obs-port,
--slo); the flags of later queue items raise an error naming the item,
and the ported flags, each with a flag of a later item, raise naming
that item.
"""

import functools
import importlib.util
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from photon_ml_tpu.cli import feature_indexing as jax_indexing
from photon_ml_tpu.cli import game_scoring_driver as jax_scoring
from photon_ml_tpu.cli import game_training_driver as jax_training
from photon_ml_tpu.estimators.game_estimator import GameEstimator as JaxGE
from photon_ml_tpu.io.avro_codec import read_container as jax_read_container
from photon_ml_tpu_torch.cli import game_scoring_driver, game_training_driver
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro_codec import read_container, write_container
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

TRAINING_FLAGS = [  # examples/run_game_training.sh
    "--task-type", "LOGISTIC_REGRESSION",
    "--fixed-effect-data-configurations", "fixed:global",
    "--fixed-effect-optimization-configurations",
    "fixed:50,1e-7,1.0,1.0,LBFGS,L2",
    "--random-effect-data-configurations",
    "perUser:userId,global,4,-1,-1,-1",
    "--random-effect-optimization-configurations",
    "perUser:30,1e-7,1.0,1.0,LBFGS,L2",
    "--updating-sequence", "fixed,perUser",
    "--num-iterations", "3",
    "--evaluators", "AUC,LOGISTIC_LOSS",
]
FULL_FLAGS = [  # examples/run_game_full.sh
    "--task-type", "LOGISTIC_REGRESSION",
    "--fixed-effect-data-configurations", "fixed:global",
    "--fixed-effect-optimization-configurations",
    "fixed:15,1e-5,1.0,1.0,TRON,L2",
    "--random-effect-data-configurations",
    "perUser:userId,global,4,-1,-1,-1",
    "--random-effect-optimization-configurations",
    "perUser:30,1e-6,0.5,1.0,LBFGS,ELASTIC_NET,0.5",
    "--factored-random-effect-data-configurations",
    "perMovie:movieId,global,4,-1,-1,-1,IDENTITY",
    "--factored-random-effect-optimization-configurations",
    "perMovie:20,1e-6,1.0,1.0,LBFGS,L2;20,1e-6,1.0,1.0,LBFGS,L2;2,2",
    "--updating-sequence", "fixed,perUser,perMovie",
    "--num-iterations", "3",
    "--evaluators", "AUC,LOGISTIC_LOSS",
    "--save-all-models", "true",
]


def _generator():
    spec = importlib.util.spec_from_file_location(
        "generate_example_data", REPO / "examples" / "generate_example_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write(path: Path, records) -> Path:
    path.mkdir(parents=True)
    write_container(path / "part-00000.avro", schemas.TRAINING_EXAMPLE,
                    records)
    return path


def _train_both(root: Path, flags):
    """Both training drivers on the same command line, each writing its
    --trace-out beside its output directory; the JAX one with its
    estimator at float64."""
    summaries = {"port": game_training_driver.run(
        [*flags, "--output-dir", str(root / "port"),
         "--trace-out", str(root / "port-trace.json")], device="cpu")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_training, "GameEstimator",
                   functools.partial(JaxGE, dtype=jnp.float64))
        summaries["jax"] = jax_training.run(
            [*flags, "--output-dir", str(root / "jax"),
             "--trace-out", str(root / "jax-trace.json")])
    return summaries


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both examples trained by both drivers."""
    gen = _generator()
    rng = np.random.default_rng(17)
    n_users = 24
    w = rng.normal(0, 1, 5)
    bias = rng.normal(0, 1.5, n_users)
    uvecs = rng.normal(0, 0.7, (n_users, 2))
    ivecs = rng.normal(0, 0.7, (12, 2))
    out = {}

    root = tmp_path_factory.mktemp("game")
    train = _write(root / "train", gen.game_records(rng, 300, w, bias))
    valid = _write(root / "validate", gen.game_records(rng, 150, w, bias))
    flags = ["--train-input-dirs", str(train),
             "--validate-input-dirs", str(valid), *TRAINING_FLAGS]
    out["training"] = dict(root=root, valid=valid,
                           summary=_train_both(root, flags))

    root = tmp_path_factory.mktemp("game_full")
    train = _write(root / "train", gen.game_full_records(
        rng, 400, w, bias, uvecs, ivecs))
    valid = _write(root / "validate", gen.game_full_records(
        rng, 150, w, bias, uvecs, ivecs))
    jax_indexing.run(["--data-path", str(train), "--output-dir",
                      str(root / "feature-index"), "--format", "paldb",
                      "--partition-num", "2", "--shard-name", "global"])
    flags = ["--train-input-dirs", str(train),
             "--validate-input-dirs", str(valid),
             "--feature-index-dir", str(root / "feature-index"),
             *FULL_FLAGS]
    out["full"] = dict(root=root, valid=valid,
                       summary=_train_both(root, flags))
    return out


EXAMPLES = ["training", "full"]


def _moved(tel: dict) -> set:
    """The registry metrics a run moved (counters and gauges off zero,
    histograms observed)."""
    m = tel["metrics"]
    return ({k for k, v in m["counters"].items() if v}
            | {k for k, v in m["gauges"].items() if v}
            | {k for k, h in m["histograms"].items() if h["count"]})


def _span_names(trace: Path) -> set:
    return {e["name"] for e in json.loads(trace.read_text())["traceEvents"]
            if e["ph"] == "X"}


# The port's one-shot read decodes through the C block decoder (a
# ``decode`` span) at a size where the JAX driver's "auto" ingest takes
# its fast_ingest path, which opens none (data/parallel_ingest.py).
ONE_SHOT_DECODE = {"decode"}


@pytest.mark.parametrize("example", EXAMPLES)
def test_metrics_json_matches_jax(runs, example):
    run = runs[example]
    port, jax = run["summary"]["port"], run["summary"]["jax"]
    on_disk = json.loads((run["root"] / "port" / "metrics.json").read_text())
    assert on_disk == port
    assert set(port) == set(jax)
    mine, theirs = port["telemetry"], jax["telemetry"]
    assert set(mine) == set(theirs)
    assert set(mine["stage_attribution"]) - ONE_SHOT_DECODE == set(
        theirs["stage_attribution"]) - ONE_SHOT_DECODE
    assert {"driver", "ingest", "solve", "finalize"} <= set(
        mine["stage_attribution"])
    assert _moved(mine) == _moved(theirs)
    assert mine["attributed_wall_frac"] >= 0.9
    root = run["root"]
    assert _span_names(root / "port-trace.json") - ONE_SHOT_DECODE == (
        _span_names(root / "jax-trace.json") - ONE_SHOT_DECODE)
    obs, jobs = port["observability"], jax["observability"]
    assert set(obs) == set(jobs)
    assert obs["server"] is jobs["server"] is None
    assert obs["flight_path"] is jobs["flight_path"] is None
    assert set(obs["flight_recorder"]) == set(jobs["flight_recorder"])
    assert obs["trace_tail"] == jobs["trace_tail"]
    for key in ("taskType", "numRows", "num_rows", "updatingSequence",
                "numCombos", "bestConfigs"):
        assert port[key] == jax[key], key
    assert set(port["coordinateSeconds"]) == set(jax["coordinateSeconds"])
    np.testing.assert_allclose(port["objectiveHistory"],
                               jax["objectiveHistory"], rtol=1e-8, atol=0)
    assert len(port["validationHistory"]) == 3
    for mine, theirs in zip(port["validationHistory"],
                            jax["validationHistory"]):
        assert set(mine) == set(theirs) == {"AUC", "LOGISTIC_LOSS"}
        assert abs(mine["AUC"] - theirs["AUC"]) <= 1e-9
        np.testing.assert_allclose(mine["LOGISTIC_LOSS"],
                                   theirs["LOGISTIC_LOSS"], rtol=1e-8)
    assert port["validationHistory"][-1]["AUC"] > 0.7


def _tree(d: Path):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*")
                  if p.name != "log-message.txt")


@pytest.mark.parametrize("example", EXAMPLES)
def test_model_directory_matches_jax(runs, example):
    """The same files, the same model-metadata.json (convergence
    summaries equal, final values rtol 1e-8) and feature indexes."""
    root = runs[example]["root"]
    assert _tree(root / "port") == _tree(root / "jax")
    assert (root / "port" / "best" / "feature-indexes" / "global.json"
            ).is_file()
    if example == "full":
        assert (root / "port" / "all" / "0" / "model-metadata.json"
                ).is_file()
    for meta_path in (root / "port").rglob("model-metadata.json"):
        rel = meta_path.relative_to(root / "port")
        mine = json.loads(meta_path.read_text())
        theirs = json.loads((root / "jax" / rel).read_text())
        assert set(mine) == set(theirs)
        trackers = mine.pop("optimizationTrackers", {})
        jtrackers = theirs.pop("optimizationTrackers", {})
        assert mine == theirs
        assert set(trackers) == set(jtrackers)
        for name, updates in trackers.items():
            for a, b in zip(updates, jtrackers[name], strict=True):
                assert a["numSolves"] == b["numSolves"]
                assert a["convergenceReasons"] == b["convergenceReasons"]
                assert a["iterations"] == b["iterations"]
                for k in ("mean", "min", "max"):
                    np.testing.assert_allclose(a["finalValue"][k],
                                               b["finalValue"][k], rtol=1e-8)
    for index in (root / "port" / "best" / "feature-indexes").iterdir():
        assert json.loads(index.read_text()) == json.loads(
            (root / "jax" / "best" / "feature-indexes" / index.name)
            .read_text())


def _values(path: Path) -> dict:
    """Decoded records as {(modelId or effectId, name, term): value}."""
    out = {}
    for rec in jax_read_container(path):
        if "latentFactor" in rec:
            for j, v in enumerate(rec["latentFactor"]):
                out[(rec["effectId"], j, None)] = v
            continue
        assert rec["variances"] is None
        for m in rec["means"]:
            out[(rec["modelId"], m["name"], m["term"])] = m["value"]
    return out


@pytest.mark.parametrize("example", EXAMPLES)
def test_decoded_coefficient_records_match_jax(runs, example):
    root = runs[example]["root"]
    files = sorted((root / "port").rglob("*.avro"))
    assert files
    for path in files:
        mine = _values(path)
        theirs = _values(root / "jax" / path.relative_to(root / "port"))
        assert set(mine) == set(theirs), path  # equal zero sets
        keys = sorted(mine, key=str)
        np.testing.assert_allclose([mine[k] for k in keys],
                                   [theirs[k] for k in keys], atol=1e-6,
                                   rtol=0, err_msg=str(path))


@pytest.mark.parametrize("example", EXAMPLES)
def test_cross_scoring(runs, example):
    """Each scoring driver scores both trained models: per model, the two
    drivers' scores agree to 1e-10 and their AUCs to 1e-9, and the port
    scores on the device path."""
    run = runs[example]
    root, valid = run["root"], run["valid"]
    for trained in ("port", "jax"):
        argv = ["--input-dirs", str(valid),
                "--game-model-input-dir", str(root / trained / "best"),
                "--evaluators", "AUC"]
        mine = game_scoring_driver.run(
            [*argv, "--output-dir", str(root / f"scored-{trained}-by-port")],
            device="cpu")
        theirs = jax_scoring.run(
            [*argv, "--output-dir", str(root / f"scored-{trained}-by-jax")])
        assert mine["scoring_path"] == mine["scoringPath"] == "device"
        assert mine["num_rows"] == theirs["num_rows"] == 150
        assert set(mine) == set(theirs)
        assert set(mine["observability"]) == set(theirs["observability"])
        assert abs(mine["metrics"]["AUC"] - theirs["metrics"]["AUC"]) <= 1e-9
        recs = [list(read_container(root / f"scored-{trained}-by-{who}"
                                    / "scores" / "part-00000.avro"))
                for who in ("port", "jax")]
        assert [r["uid"] for r in recs[0]] == [r["uid"] for r in recs[1]]
        assert [r["label"] for r in recs[0]] == [r["label"] for r in recs[1]]
        np.testing.assert_allclose(
            [r["predictionScore"] for r in recs[0]],
            [r["predictionScore"] for r in recs[1]], atol=1e-10, rtol=0)
        if trained == "port":
            # Scoring the validation data gives the training-time AUC.
            best = max(m["AUC"] for m in run["summary"]["port"]
                       ["validationHistory"])
            assert abs(mine["metrics"]["AUC"] - best) <= 1e-9


# --stream-train and its flags are ported (streamed ingest and training,
# the batched λ grid and streamed matrix factorization, ROADMAP A4 and
# A4b), and so are the 1-D mesh (A6a) and the 2-D mesh (A6b). Each entry
# keeps its flags and id; its second field says how it ends now: "run"
# trains one iteration over a 2-slot CPU mesh, "run2d" over a 2 x 2 CPU
# mesh, "raise" ends with JAX's own message (the third field) before
# anything is written.
_STREAM_FE = ["--stream-train", "--random-effect-data-configurations",
              "--updating-sequence", "fixed"]
_GRID2 = ["--fixed-effect-optimization-configurations",
          "fixed:50,1e-7,1.0,1.0,LBFGS,L2|50,1e-7,10.0,1.0,LBFGS,L2"]
TRAINING_LATER = [
    (["--stream-train", "--factored-random-effect-data-configurations",
      "mf:userId,global,4,-1,-1,-1,IDENTITY",
      "--factored-random-effect-optimization-configurations",
      "mf:20,1e-6,1.0,1.0,LBFGS,L2;20,1e-6,1.0,1.0,LBFGS,L2;1,2",
      "--random-effect-data-configurations", "--updating-sequence", "mf",
      "--mesh-devices", "2"], "raise",
     "a mesh of > 1 device requires --hbm-budget"),
    (["--hbm-budget", "8K", *_STREAM_FE, *_GRID2, "--mesh-devices", "2"],
     "run", None),
    (["--grid-batched", "off", "--hbm-budget", "8K", *_STREAM_FE,
      "--mesh-devices", "2"], "run", None),
    (["--spill-dtype", "bf16", "--hbm-budget", "8K", *_STREAM_FE,
      "--mesh-shape", "2x2"], "run2d", None),
    (["--spill-source", "redecode", "--hbm-budget", "8K", *_STREAM_FE,
      "--mesh-shape", "2x2"], "run2d", None),
    (["--distmon", "--mesh-devices", "2"], "raise",
     "--mesh-devices/--mesh-shape apply to the --stream-train solve"),
    (["--obs-port", "0", "--mesh-shape", "2x2"], "raise",
     "--mesh-devices/--mesh-shape apply to the --stream-train solve"),
    (["--slo", "p99:x<=1ms", "--mesh-devices", "2"], "raise",
     "--mesh-devices/--mesh-shape apply to the --stream-train solve"),
    (["--mesh-devices", "2"], "raise",
     "--mesh-devices/--mesh-shape apply to the --stream-train solve"),
    (["--mesh-shape", "2x2"], "raise",
     "--mesh-devices/--mesh-shape apply to the --stream-train solve")]
# The scoring flags that named ROADMAP A5d, ported with network serving:
# each case now serves and drains ("serve") or ends with the JAX
# driver's own SystemExit (game_scoring_driver.py:284-300).
SCORING_LATER = [
    (["--listen", "0"], "serve", None),
    (["--adaptive-admission"], "exit",
     "--adaptive-admission retunes a live network front door; pass "
     "--listen"),
    (["--distmon", "--stream", "--listen", "0"], "exit",
     "--stream and --serve are mutually exclusive"),
    (["--obs-port", "0", "--adaptive-admission"], "exit",
     "--adaptive-admission retunes a live network front door; pass "
     "--listen"),
    (["--slo", "p99:x<=1ms", "--listen", "0"], "serve", None),
    (["--listen", "0", "--adaptive-admission"], "exit",
     "--adaptive-admission steers on the declared --slo objectives; "
     "pass at least one --slo")]
# The observability flags, ported here (ROADMAP A5c): each case of the
# lists above that named one now also runs without the later item's flag
# (one coordinate-descent iteration), its output checked (what, below).
TRAINING_OBSERVABILITY = [
    (["--stream-train", "--factored-random-effect-data-configurations",
      "mf:userId,global,4,-1,-1,-1,IDENTITY",
      "--factored-random-effect-optimization-configurations",
      "mf:20,1e-6,1.0,1.0,LBFGS,L2;20,1e-6,1.0,1.0,LBFGS,L2;1,2",
      "--random-effect-data-configurations", "--updating-sequence", "mf",
      "--task-type", "LINEAR_REGRESSION", "--distmon"], "distmon"),
    (["--spill-dtype", "bf16", "--hbm-budget", "8K", *_STREAM_FE,
      "--distmon"], "distmon"),
    (["--distmon", *_STREAM_FE], "distmon"),
    (["--obs-port", "0"], "obs_port"),
    (["--slo", "p99:x<=1ms"], "slo")]
SCORING_OBSERVABILITY = [
    (["--distmon", "--stream", "--batch-rows", "64"], "distmon"),
    (["--obs-port", "0"], "obs_port"),
    (["--slo", "p99:x<=1ms"], "slo")]
# The telemetry flags, ported here (ROADMAP A5b): the cases of the lists
# above that named them, each now run (one coordinate-descent iteration)
# with its output checked (what, below).
TRAINING_TELEMETRY = [
    (["--grid-batched", "on", "--hbm-budget", "8K", *_STREAM_FE,
      "--trace-out", "t.json"], "trace"),
    (["--feeder", "python", *_STREAM_FE, "--trace-out", "t.json"],
     "trace"),
    (["--prefetch-batches", "0", *_STREAM_FE, "--profile-output-dir",
      "prof"], "profile"),
    (["--trace-out", "t.json"], "trace"),
    (["--profile-output-dir", "prof"], "profile"),
    (["--flight-events", "16"], "flight")]
SCORING_TELEMETRY = [(["--trace-out", "t.json"], "trace"),
                     (["--flight-events", "16"], "flight")]


def _check_telemetry_output(summary: dict, argv, what: str):
    """A telemetry flag's output: the Chrome trace parses with its
    driver track; the profile directory holds a host trace of the run;
    the flight recorder's ring has the asked capacity."""
    if what == "trace":
        doc = json.loads(Path(argv[argv.index("--trace-out") + 1])
                         .read_text())
        names = {e["args"]["name"] for e in doc["traceEvents"]
                 if e["ph"] == "M"}
        assert "driver" in names
        assert "driver" in {e["name"] for e in doc["traceEvents"]
                            if e["ph"] == "X"}
    elif what == "profile":
        prof = Path(argv[argv.index("--profile-output-dir") + 1])
        (trace,) = prof.glob("torch_trace_*.json")
        events = json.loads(trace.read_text())["traceEvents"]
        assert any(e.get("cat") == "cpu_op" for e in events)
    else:
        assert summary["observability"]["flight_recorder"][
            "ring_capacity"] == 16
    assert "driver" in summary["telemetry"]["stage_attribution"]


@pytest.mark.parametrize("extra,outcome,expect", TRAINING_LATER,
                         ids=[e[0] for e, _, _ in TRAINING_LATER])
def test_training_flags_of_later_items_raise(runs, tmp_path, extra, outcome,
                                             expect):
    """The ten mesh-flag cases that once raised naming ROADMAP A6: the
    spill runs train over a 2-slot CPU mesh or a 2 x 2 one (the cases
    that raised naming A6b), the rest end with JAX's message."""
    if outcome in ("run", "run2d"):
        argv = ["--train-input-dirs", str(runs["training"]["root"] / "train"),
                "--output-dir", str(tmp_path / "out"), *TRAINING_FLAGS,
                *extra, "--num-iterations", "1", "--batch-rows", "64"]
        summary = game_training_driver.run(argv, device="cpu")
        info = summary["stream_train"]
        slots, shape = (2, [2, 1]) if outcome == "run" else (4, [2, 2])
        assert info["mode"] == "spill"
        assert info["mesh_devices"] == (2 if outcome == "run" else None)
        assert list(info["mesh_shape"]) == shape
        cache = info["cache"]
        assert cache["mesh_devices"] == slots and cache["shards"] == 5
        assert cache["col_blocks"] == shape[1]
        assert len(cache["per_device_bytes"]) == slots
        assert sum(cache["per_device_bytes"]) == cache["device_bytes"]
        assert (tmp_path / "out" / "best" / "fixed-effect").is_dir()
        return
    argv = ["--train-input-dirs", str(tmp_path / "none"), "--output-dir",
            str(tmp_path / "out"), *TRAINING_FLAGS, *extra]
    with pytest.raises(ValueError, match=re.escape(expect)):
        game_training_driver.run(argv, device="cpu")
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("extra,what,message", SCORING_LATER,
                         ids=[e[0] if i < 5 else "--listen-adaptive"
                              for i, (e, _, _) in enumerate(SCORING_LATER)])
def test_scoring_flags_of_later_items_raise(runs, tmp_path, extra, what,
                                            message):
    """The five flag cases that once raised naming ROADMAP A5d (and the
    third of JAX's --adaptive-admission checks): a --listen run serves a
    request in each framing and drains; a contradiction ends the run with
    JAX's SystemExit before the model loads."""
    run = runs["training"]
    argv = ["--input-dirs", str(run["valid"]), "--game-model-input-dir",
            str(run["root"] / "port" / "best"), "--output-dir",
            str(tmp_path / "out"), *extra]
    if what == "exit":
        with pytest.raises(SystemExit) as ei:
            game_scoring_driver.run(argv, device="cpu")
        assert str(ei.value).startswith(message)
        return
    summary, replies = _listen(argv, tmp_path / "out", run)
    (binary, http), want = replies
    assert binary.tobytes() == http.tobytes()
    np.testing.assert_allclose(binary, want, rtol=1e-12, atol=1e-12)
    net = summary["net"]
    assert net["responses"] == net["requests_binary"] + net[
        "requests_http"] == 2
    assert net["wire_errors"] == {} and net["open_connections"] == 0
    assert summary["scoring_path"] == "netserver"
    assert summary["listen"] == "127.0.0.1:0"
    if "--slo" in extra:
        (slo,) = summary["slo"].values()
        assert slo["objective"] == "p99(x) <= 0.001s"


LISTEN_SECONDS = 2.0


def _listen(argv, out: Path, run, client=None):
    """Run the scoring driver's --listen (argv) in this process on a
    thread for LISTEN_SECONDS, wait for <out>/net_port, and score the
    first four validation rows over the wire: ``client(port, data)`` (a
    coroutine function) or one request in each framing. Returns the
    summary and ``(client's result, the rows' host scores)``, the host
    scores the port model's own ``score``."""
    import asyncio
    import threading
    import time

    from photon_ml_tpu_torch.data.avro_reader import read_game_dataset
    from photon_ml_tpu_torch.data.paldb import load_feature_index_maps
    from photon_ml_tpu_torch.io.model_io import load_game_model
    from photon_ml_tpu_torch.serving.netserver import NetClient

    model_dir = run["root"] / "port" / "best"
    maps = load_feature_index_maps(model_dir / "feature-indexes")
    model = load_game_model(model_dir, maps)
    data, _ = read_game_dataset(run["valid"], ["userId"], maps)
    data = data.subset(np.arange(4))
    want = model.score(data)

    async def both_framings(port, ds):
        got = []
        for framing in ("binary", "http"):
            async with NetClient("127.0.0.1", port, framing=framing) as c:
                got.append(await c.score(ds))
        return got

    result = {}

    def serve():
        try:
            result["summary"] = game_scoring_driver.run(
                [*argv, "--serve-seconds", str(LISTEN_SECONDS)],
                device="cpu")
        except BaseException as e:  # noqa: BLE001 — re-raised below
            result["error"] = e

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    try:
        deadline = time.monotonic() + 60
        while not (out / "net_port").exists() and "error" not in result:
            assert time.monotonic() < deadline, "no net_port"
            time.sleep(0.01)
        if "error" not in result:
            port = int((out / "net_port").read_text())
            replies = asyncio.run(asyncio.wait_for(
                (client or both_framings)(port, data), 30))
    finally:
        thread.join(timeout=60)
    assert not thread.is_alive(), "the --listen run did not drain"
    if "error" in result:
        raise result["error"]
    summary = result["summary"]
    assert json.loads((out / "metrics.json").read_text())[
        "scoring_path"] == "netserver"
    return summary, (replies, want)


def test_listen_serves_adaptive_admission_and_the_plane(runs, tmp_path):
    """--listen with --adaptive-admission, an SLO and --obs-port: eight
    pipelined binary frames and a /statusz scrape while it serves; the
    controller ticked and reported, the netserver and controller status
    providers were live, /readyz said "serving", and metrics.json holds
    JAX's --listen keys."""
    import asyncio
    import urllib.request

    from photon_ml_tpu_torch.serving import netserver

    run = runs["training"]
    out = tmp_path / "out"
    argv = ["--input-dirs", str(run["valid"]), "--game-model-input-dir",
            str(run["root"] / "port" / "best"), "--output-dir", str(out),
            "--listen", "127.0.0.1:0", "--adaptive-admission", "--slo",
            "p99:serving.frontend.request_latency_seconds<=250ms",
            "--obs-port", "0", "--coalesce-ms", "1"]

    async def pipelined(port, ds):
        rows = [ds.subset(np.asarray([i % ds.num_rows])) for i in range(8)]
        r, w = await asyncio.open_connection("127.0.0.1", port)
        try:
            w.write(b"".join(netserver.encode_request(x) for x in rows))
            await w.drain()
            got = [await netserver.read_binary_response(r) for _ in rows]
        finally:
            w.close()
        obs = json.loads((out / "obs_port").read_text())["port"]

        def scrape(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{obs}{path}", timeout=10) as resp:
                return json.loads(resp.read())

        loop = asyncio.get_running_loop()
        status = await loop.run_in_executor(None, scrape, "/statusz")
        ready = await loop.run_in_executor(None, scrape, "/readyz")
        return got, status, ready

    summary, ((got, status, ready), want) = _listen(argv, out, run,
                                                    client=pipelined)
    for i, s in enumerate(got):
        np.testing.assert_allclose(s, want[[i % 4]], rtol=1e-12,
                                   atol=1e-12)
    assert {"netserver", "adaptive_admission", "frontend"} <= set(
        status["status"])
    assert status["status"]["netserver"]["requests_binary"] == 8
    assert ready["reason"] == "serving"
    assert set(summary) >= {"num_rows", "metrics", "scoring_path", "listen",
                            "net", "adaptive_admission", "frontend",
                            "kernel_launches", "slo", "observability",
                            "telemetry", "total_seconds"}
    ctl = summary["adaptive_admission"]
    assert ctl["ticks"] >= 1 and ctl["apply"] is True
    assert ctl["base_max_pending"] == 1024 and ctl["base_window_s"] == 0.001
    assert summary["net"]["responses"] == 8
    assert summary["frontend"]["completed"] == 8
    assert summary["kernel_launches"] == {"csr_matvec": 0}  # the CPU's


@pytest.mark.parametrize("extra,what", TRAINING_TELEMETRY,
                         ids=[e[0] for e, _ in TRAINING_TELEMETRY])
def test_training_telemetry_flags_run(runs, tmp_path, extra, what):
    root = runs["training"]["root"]
    out = tmp_path / "out"
    rel = [str(out / a) if a in ("t.json", "prof") else a for a in extra]
    summary = game_training_driver.run(
        ["--train-input-dirs", str(root / "train"), "--output-dir",
         str(out), *TRAINING_FLAGS, "--num-iterations", "1", *rel],
        device="cpu")
    _check_telemetry_output(summary, rel, what)


@pytest.mark.parametrize("extra,what", SCORING_TELEMETRY,
                         ids=[e[0] for e, _ in SCORING_TELEMETRY])
def test_scoring_telemetry_flags_run(runs, tmp_path, extra, what):
    root = runs["training"]["root"]
    out = tmp_path / "out"
    rel = [str(out / a) if a == "t.json" else a for a in extra]
    summary = game_scoring_driver.run(
        ["--input-dirs", str(runs["training"]["valid"]),
         "--game-model-input-dir", str(root / "port" / "best"),
         "--output-dir", str(out), *rel], device="cpu")
    _check_telemetry_output(summary, rel, what)



def _check_observability_output(summary: dict, out: Path, what: str):
    """An observability flag's output: --distmon's data_quality or
    distributions block counts the rows; --obs-port's server announced
    its bound port in <out>/obs_port and reported it; --slo's objective
    was judged into the slo block."""
    if what == "distmon":
        if "data_quality" in summary:
            dq = summary["data_quality"]
            assert dq["rows"] == summary["num_rows"] > 0
            assert len(dq["state_sha256"]) == 64
        else:
            dist = summary["distributions"]["default"]
            assert dist["scores"]["moments"]["count"] \
                == summary["num_rows"] > 0
    elif what == "obs_port":
        server = summary["observability"]["server"]
        desc = json.loads((out / "obs_port").read_text())
        assert desc["port"] == server["port"] > 0
        assert server["ready"] and "/metrics" in server["routes"]
    else:
        (slo,) = summary["slo"].values()
        assert slo["compliant"] and slo["objective"] == "p99(x) <= 0.001s"


@pytest.mark.parametrize("extra,what", TRAINING_OBSERVABILITY,
                         ids=[e[0] for e, _ in TRAINING_OBSERVABILITY])
def test_training_observability_flags_run(runs, tmp_path, extra, what):
    root = runs["training"]["root"]
    out = tmp_path / "out"
    summary = game_training_driver.run(
        ["--train-input-dirs", str(root / "train"), "--output-dir",
         str(out), *TRAINING_FLAGS, "--num-iterations", "1", *extra],
        device="cpu")
    _check_observability_output(summary, out, what)


@pytest.mark.parametrize("extra,what", SCORING_OBSERVABILITY,
                         ids=[e[0] for e, _ in SCORING_OBSERVABILITY])
def test_scoring_observability_flags_run(runs, tmp_path, extra, what):
    root = runs["training"]["root"]
    out = tmp_path / "out"
    summary = game_scoring_driver.run(
        ["--input-dirs", str(runs["training"]["valid"]),
         "--game-model-input-dir", str(root / "port" / "best"),
         "--output-dir", str(out), *extra], device="cpu")
    _check_observability_output(summary, out, what)

STREAMED = {"stream": ["--stream", "--batch-rows", "64"],
            "serve": ["--serve", "--request-rows", "3", "--batch-rows", "64",
                      "--coalesce-ms", "1"]}
# metrics.json keys of each path whose values are the same in both
# drivers (nested: the sub-keys compared).
SHARED = {
    "stream": {"num_rows": None, "scoring_path": None, "num_batches": None,
               "batch_rows": None,
               "feeder": ("decode_path", "prefetch_depth", "batches",
                          "rows"),
               "engine": ("dispatches", "requests", "rows_scored",
                          "rows_padded", "nnz_scored", "nnz_padded",
                          "padding_waste_rows", "padding_waste_nnz",
                          "entries", "compilations", "traces",
                          "bucket_shapes")},
    "serve": {"num_rows": None, "scoring_path": None, "num_requests": None,
              "request_rows": None, "coalesce_window_ms": None,
              "concurrency": None,
              "frontend": ("models", "admitted", "rejected", "completed",
                           "failed", "cancelled", "model_swaps",
                           "isolation_splits", "pending", "max_pending",
                           "max_pending_per_model", "coalesce_window_s",
                           "max_group_rows")},
}


def _scores(path: Path):
    return [(r["uid"], r["label"], r["predictionScore"])
            for r in read_container(path / "scores" / "part-00000.avro")]


@pytest.mark.parametrize("mode", list(STREAMED))
@pytest.mark.parametrize("example", EXAMPLES)
def test_streamed_and_served_scoring_match_jax(runs, example, mode):
    """--stream and --serve through both scoring drivers on the port's
    trained model: the records' scores allclose 1e-12 and in the batch
    order, the same metrics, the shared summary keys equal; and the
    scores are the batch path's (test_cross_scoring) within 1e-12."""
    run = runs[example]
    root = run["root"]
    argv = ["--input-dirs", str(run["valid"]),
            "--game-model-input-dir", str(root / "port" / "best"),
            "--evaluators", "AUC", *STREAMED[mode]]
    mine = game_scoring_driver.run(
        [*argv, "--output-dir", str(root / f"{mode}-by-port")],
        device="cpu")
    theirs = jax_scoring.run(
        [*argv, "--output-dir", str(root / f"{mode}-by-jax")])
    assert set(mine) == set(theirs)
    block = "engine" if mode == "stream" else "frontend"
    assert set(mine[block]) == set(theirs[block])
    assert _moved(mine["telemetry"]) == _moved(theirs["telemetry"])
    assert mine["num_rows"] == 150
    assert abs(mine["metrics"]["AUC"] - theirs["metrics"]["AUC"]) <= 1e-12
    for key, sub in SHARED[mode].items():
        if sub is None:
            assert mine[key] == theirs[key], key
        else:
            for k in sub:
                assert mine[key][k] == theirs[key][k], (key, k)
    recs = [_scores(root / f"{mode}-by-{who}") for who in ("port", "jax")]
    assert [r[:2] for r in recs[0]] == [r[:2] for r in recs[1]]
    np.testing.assert_allclose([r[2] for r in recs[0]],
                               [r[2] for r in recs[1]], rtol=1e-12,
                               atol=1e-12)
    batch = root / "port-batch-scores"
    if not batch.exists():
        game_scoring_driver.run(
            ["--input-dirs", str(run["valid"]), "--game-model-input-dir",
             str(root / "port" / "best"), "--output-dir", str(batch)],
            device="cpu")
    np.testing.assert_allclose([r[2] for r in recs[0]],
                               [r[2] for r in _scores(batch)], rtol=1e-12,
                               atol=1e-12)
    if mode == "serve":
        fe = mine["frontend"]
        assert fe["admitted"] == fe["completed"] == mine["num_requests"]
        assert fe["engines"]["default"]["requests"] == mine["num_requests"]


def test_stream_and_serve_are_exclusive(tmp_path):
    argv = ["--input-dirs", str(tmp_path / "none"), "--game-model-input-dir",
            str(tmp_path / "model"), "--output-dir", str(tmp_path / "out"),
            "--stream", "--serve"]
    with pytest.raises(SystemExit, match="mutually exclusive"):
        game_scoring_driver.run(argv, device="cpu")


@pytest.mark.parametrize("mode", list(STREAMED))
def test_unscorable_model_ends_streamed_runs(runs, monkeypatch, tmp_path,
                                             mode):
    """A sub-model the engine cannot score ends --stream and --serve with
    SystemExit, as JAX's --stream does: no host fallback."""
    from photon_ml_tpu_torch.models.game_model import GameModel
    from photon_ml_tpu_torch.types import TaskType

    class Exotic:
        pass

    monkeypatch.setattr(
        game_scoring_driver, "load_game_model",
        lambda *a, **k: GameModel({"weird": Exotic()},
                                  TaskType.LOGISTIC_REGRESSION))
    run = runs["training"]
    argv = ["--input-dirs", str(run["valid"]), "--game-model-input-dir",
            str(run["root"] / "port" / "best"), "--output-dir",
            str(tmp_path / "out"), *STREAMED[mode]]
    with pytest.raises(SystemExit, match="device-scorable model"):
        game_scoring_driver.run(argv, device="cpu")
