"""Distribution monitoring in the port (photon_ml_tpu_torch/data/
distmon.py and the --distmon, --obs-port and --slo wiring of the GAME
drivers) against the JAX package's, on the CPU, on a small fixed-effect
Avro set (300 rows of 4 features; JAX's tests/test_distmon.py writer)
and its shifted copy (the same rows, values x4).

One module fixture trains the port's three --stream-train --distmon
runs (resident, --hbm-budget 8K, and 8K with --feeder python
--prefetch-batches 0) and the JAX driver's 8K run once; the resident
model, which carries the reference distributions, serves every scoring
case.

- The stream-observed state (label/offset/weight/feature sketches, row
  and batch counts) is the same bytes in all three port runs and in
  JAX's: ``state_sha256`` equal. Both packages feed ``observe_batch``
  the decoder's float64 columns.
- The training-score sketches count the same rows as JAX's; their
  medians agree within 5% (JAX trains at float32, the port here at
  float64, and the resident surface is one product where the spill
  surface is the solver's margins: JAX's own tolerance between the two,
  tests/test_distmon.py:378-389).
- The port's versions of JAX's test_serve_drift_acceptance and
  test_stream_train_mf_distmon_counts_rows_once pass.
- Live plane: a --serve --distmon --obs-port 0 run is scraped from a
  thread of this process while it serves (/readyz, /metrics, /distz),
  and an in-process FleetAggregator over it (/snapshotz) ends with the
  run's serving counters and its score sketch. Every thread is joined
  under a timeout.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from photon_ml_tpu.cli import game_training_driver as jax_training
from photon_ml_tpu_torch import telemetry as tel
from photon_ml_tpu_torch.cli import game_scoring_driver, game_training_driver
from photon_ml_tpu_torch.telemetry.federation import FleetAggregator
from photon_ml_tpu_torch.telemetry.sketches import QuantileSketch
from tests.test_cli_drivers import _MF_STREAM_BASE, _write_mf_avro
from tests.test_distmon import _write_scaled_fe_avro
from tests.test_exposition import parse_prometheus
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

ROWS = 300
BASE = [
    "--task-type", "LOGISTIC_REGRESSION",
    "--fixed-effect-data-configurations", "fixed:global",
    "--fixed-effect-optimization-configurations",
    "fixed:25,1e-7,1.0,1.0,LBFGS,L2",
    "--updating-sequence", "fixed",
    "--stream-train", "--batch-rows", "64", "--distmon",
]
RUNS = {
    "resident": [],
    "spill": ["--hbm-budget", "8K"],
    "spill_py_nopf": ["--hbm-budget", "8K", "--feeder", "python",
                      "--prefetch-batches", "0"],
}
DRIFT_SLO = "drift=value:serving.model.default.score_drift_psi<=0.25"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("distmon")
    _write_scaled_fe_avro(root / "train", n=ROWS)
    _write_scaled_fe_avro(root / "shifted", scale=4.0, n=ROWS)
    data = ["--train-input-dirs", str(root / "train")]
    summaries = {tag: game_training_driver.run(
        [*data, *BASE, *extra, "--output-dir", str(root / tag)],
        device="cpu") for tag, extra in RUNS.items()}
    summaries["jax"] = jax_training.run(
        [*data, *BASE, *RUNS["spill"], "--output-dir", str(root / "jax")])
    return {"root": root, "summaries": summaries,
            "model": root / "resident" / "best"}


def _meta(path):
    return json.loads((path / "model-metadata.json").read_text())


def test_stream_state_equal_across_residency_feeder_prefetch_and_jax(
        trained):
    s = trained["summaries"]
    hashes = {tag: v["data_quality"]["state_sha256"] for tag, v in s.items()}
    assert len(set(hashes.values())) == 1, hashes
    mine, theirs = s["spill"]["data_quality"], s["jax"]["data_quality"]
    for key in ("rows", "batches", "relative_accuracy", "columns",
                "feature_shards", "entities"):
        assert mine[key] == theirs[key], key
    assert mine["rows"] == ROWS
    # 4 features a row plus the intercept the ingest adds.
    assert mine["feature_shards"]["global"]["moments"]["count"] == 5 * ROWS
    gauges = s["spill"]["telemetry"]["metrics"]["gauges"]
    assert gauges["data.dist.rows"] == ROWS
    assert gauges["data.dist.label_mean"] == pytest.approx(
        mine["columns"]["label"]["moments"]["mean"])


def test_training_scores_rings_and_reference(trained):
    s = trained["summaries"]
    medians = {}
    for tag in ("resident", "spill", "spill_py_nopf", "jax"):
        dq = s[tag]["data_quality"]
        (label,) = dq["training_scores"]
        assert label == "fixed:l2=1"
        assert dq["training_scores"][label]["quantiles"]["count"] == ROWS
        (ring,) = dq["convergence"].values()
        assert ring["recorded"] >= 2
        steps = [e["step"] for e in ring["tail"]]
        if tag == "resident":
            assert steps == [None] * len(steps)  # filled from history
        else:
            assert steps[0] is None and all(x is not None
                                            for x in steps[1:])
        root = trained["root"] / tag / "best"
        ref = _meta(root)["referenceDistributions"]
        assert ref["version"] == 1 and ref["rows"] == ROWS
        assert QuantileSketch.from_state(ref["label"]).count == ROWS
        score = QuantileSketch.from_state(ref["score"])
        assert score.count == ROWS
        medians[tag] = score.quantile(0.5)
    # The two spill runs solve alike: the same score sketch.
    assert s["spill"]["data_quality"]["training_scores"] \
        == s["spill_py_nopf"]["data_quality"]["training_scores"]
    for tag in ("resident", "jax"):
        assert abs(medians[tag] - medians["spill"]) <= 0.05 * abs(
            medians["spill"]), medians


def _serve(trained, inp, out, *extra):
    return game_scoring_driver.run([
        "--input-dirs", str(inp),
        "--game-model-input-dir", str(trained["model"]),
        "--output-dir", str(out), *extra], device="cpu")


def test_serve_drift_acceptance(trained, tmp_path):
    root = trained["root"]
    serve = ["--serve", "--distmon", "--request-rows", "4",
             "--serve-concurrency", "8", "--slo", DRIFT_SLO]
    same = _serve(trained, root / "train", tmp_path / "same", *serve)
    moved = _serve(trained, root / "shifted", tmp_path / "moved", *serve)
    d_same = same["distributions"]["default"]["drift"]
    d_moved = moved["distributions"]["default"]["drift"]
    assert d_same["psi"] < 0.1 < 0.25 < d_moved["psi"]
    assert d_same["rows"] == d_moved["rows"] == ROWS
    assert same["slo"]["drift"]["compliant"] is True
    assert moved["slo"]["drift"]["compliant"] is False
    assert moved["slo"]["drift"]["violations"] >= 1
    eng = moved["frontend"]["engines"]["default"]
    assert eng["score_distribution"]["scores"]["moments"]["count"] == ROWS
    gauges = moved["telemetry"]["metrics"]["gauges"]
    assert gauges["serving.model.default.score_drift_psi"] \
        == d_moved["psi"]
    st = _serve(trained, root / "shifted", tmp_path / "st", "--stream",
                "--batch-rows", "64", "--distmon")
    assert st["distributions"]["default"]["drift"]["psi"] > 0.25
    assert st["distributions"]["default"]["scores"]["moments"]["count"] \
        == ROWS
    with pytest.raises(SystemExit, match="--distmon"):
        _serve(trained, root / "train", tmp_path / "bad", "--distmon")


def test_distmon_needs_stream_train_and_is_off_by_default(trained,
                                                          tmp_path):
    data = ["--train-input-dirs", str(trained["root"] / "train")]
    with pytest.raises(ValueError, match="--distmon"):
        game_training_driver.run(
            [*data, *BASE[:-4], "--distmon", "--output-dir",
             str(tmp_path / "o")], device="cpu")
    plain = game_training_driver.run(
        [*data, *BASE[:-1], "--output-dir", str(tmp_path / "plain")],
        device="cpu")
    assert "data_quality" not in plain
    assert "referenceDistributions" not in _meta(tmp_path / "plain" /
                                                 "best")


def test_stream_train_mf_distmon_counts_rows_once(tmp_path):
    train = tmp_path / "train"
    _write_mf_avro(train, np.random.default_rng(0), n=240)
    s = game_training_driver.run(
        ["--train-input-dirs", str(train), *_MF_STREAM_BASE,
         "--output-dir", str(tmp_path / "o"), "--stream-train",
         "--batch-rows", "64", "--distmon"], device="cpu")
    dq = s["data_quality"]
    assert dq["rows"] == 240
    assert dq["columns"]["label"]["moments"]["count"] == 240
    (etype,) = dq["entities"]
    assert dq["entities"][etype]["total"] == 240
    ref = _meta(tmp_path / "o" / "best")["referenceDistributions"]
    assert "score" not in ref and ref["rows"] == 240


def _watch(out_dir, results, stop):
    """Scraper and aggregator over a live driver: wait for its obs_port
    descriptor, then poll the routes and a FleetAggregator until the
    driver's server goes away (or ``stop`` is set)."""
    port_file = out_dir / "obs_port"
    deadline = time.monotonic() + 60
    while not port_file.exists():
        if stop.is_set() or time.monotonic() > deadline:
            results["error"] = "obs_port never appeared"
            return
        time.sleep(0.005)
    port = tel.read_obs_descriptor(port_file)["port"]
    agg = FleetAggregator(peer_dirs=[out_dir], interval_s=0.05,
                          timeout_s=5.0)
    try:
        while not stop.is_set():
            try:
                for route in ("/readyz", "/metrics", "/distz"):
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}{route}",
                            timeout=5) as r:
                        results[route] = r.read().decode()
                results["scrapes"] = results.get("scrapes", 0) + 1
                rows = json.loads(results["/distz"])["serving"][
                    "default"]["scores"]["moments"]["count"]
                results["max_live_rows"] = max(
                    rows, results.get("max_live_rows", 0))
            except (urllib.error.URLError, ConnectionError, OSError):
                return  # the driver's plane went away: done
            # The aggregator alone reads /snapshotz, so the driver's
            # final-scrape handshake waits for its last poll.
            agg.poll_once()
            view = agg.view()
            results["fleet"] = view.registry.snapshot()
            results["fleet_sketches"] = view.sketches
            time.sleep(0.01)
    finally:
        agg.stop()


def test_live_plane_during_serve(trained, tmp_path):
    out = tmp_path / "live"
    out.mkdir()
    results, stop = {}, threading.Event()
    watcher = threading.Thread(target=_watch, args=(out, results, stop),
                               daemon=True)
    watcher.start()
    try:
        summary = _serve(
            trained, trained["root"] / "shifted", out, "--serve",
            "--distmon", "--request-rows", "1", "--serve-concurrency", "4",
            "--obs-port", "0", "--slo", DRIFT_SLO)
    finally:
        stop.set()
        watcher.join(timeout=30)
    assert not watcher.is_alive()
    assert "error" not in results and results["scrapes"] >= 1
    assert json.loads(results["/readyz"])["ready"] is True
    fams = parse_prometheus(results["/metrics"])
    assert "serving_frontend_admitted_total" in fams
    assert "slo_drift_burn_rate" in fams
    assert results["max_live_rows"] > 0
    assert "default.scores.quantiles" in results["fleet_sketches"][
        "serving"]
    assert summary["observability"]["server"]["port"] \
        == json.loads((out / "obs_port").read_text())["port"]
    fleet = results["fleet"]["counters"]
    mine = summary["telemetry"]["metrics"]["counters"]
    # The aggregator's last poll came after the run's final counters
    # (finish holds the plane for one more /snapshotz render).
    for name in ("serving.frontend.admitted", "serving.frontend.completed"):
        assert fleet[name] == mine[name] == ROWS
