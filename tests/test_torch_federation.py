"""The port's fleet federation (photon_ml_tpu_torch/telemetry/
federation.py, cli/obs_aggregate.py) against the JAX package's, on the
CPU.

- ``merge_snapshots`` over the same snapshot dicts, made by the JAX
  package (its ``registry_snapshot`` over registries filled from a seed,
  and hand-built peers with sketches, gauges of every merge policy,
  exemplars, traces and SLO specs), gives the same FleetView: the same
  re-serialized JSON (but the aggregator's own pid, host and clock), the
  same SLO block, notes and Prometheus text. The port's own snapshots
  merge to the same view in JAX.
- Peer discovery reads the JAX descriptor format, and both write it
  alike.
- Live: an aggregator in this process scrapes a peer server thread,
  serves the merged routes, and degrades (stale peer, last snapshot
  kept, /readyz 503) when that peer is stopped between scrapes; the
  ``obs_aggregate`` command runs over a live peer. No subprocess: peers
  are servers on port 0 in threads, each stopped and joined under a
  timeout, and every request has one.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from photon_ml_tpu import telemetry as jtel
from photon_ml_tpu.telemetry import federation as jfed
from photon_ml_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from photon_ml_tpu_torch import telemetry as tel
from photon_ml_tpu_torch.cli import obs_aggregate
from photon_ml_tpu_torch.telemetry import federation as tfed
from photon_ml_tpu_torch.telemetry.registry import MetricsRegistry
from tests.test_exposition import parse_prometheus
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _enabled():
    for t in (tel, jtel):
        t.disable()
        t.reset()
        t.enable()
    yield
    for t in (tel, jtel):
        t.disable()
        t.reset()


def _fill(reg, rng):
    reg.counter("serving.frontend.admitted").inc(int(rng.integers(1, 9)))
    reg.counter("serving.frontend.rejected").inc(int(rng.integers(0, 3)))
    reg.gauge("data.shard_cache.device_bytes").set(float(
        rng.integers(1, 1 << 20)))
    reg.gauge("process.uptime_seconds").set(float(rng.uniform(1, 100)))
    reg.gauge("serving.model.default.score_drift_psi").set(
        float(rng.uniform(0, 0.5)))
    reg.gauge("data.dist.label_mean").set(float(rng.uniform(0, 1)))
    h = reg.histogram("serving.frontend.request_latency_seconds",
                      exemplars=True)
    for i, v in enumerate(rng.lognormal(-6, 1.5, 40)):
        h.observe(float(v), exemplar=f"t{i:04d}")


def _sketches(rng):
    q, m, t = (jtel.QuantileSketch(), jtel.MomentsSketch(),
               jtel.TopKSketch(k=4))
    v = rng.normal(0, 2, 300)
    q.update(v)
    m.update(v)
    t.update(rng.integers(0, 9, 300).astype(str))
    return {"serving": {"default.scores.quantiles": q.state(),
                        "default.scores.moments": m.state()},
            "training": {"entities.userId": t.state()}}


def _trace(tid, start):
    return {"trace_id": tid, "kind": "request", "outcome": "ok",
            "start_unix": start, "duration_s": 0.01, "events": []}


def _jax_snapshots(seed=0, n=3):
    """Peer snapshots as the JAX package makes them: registry_snapshot
    over registries filled from a seed, with fixed clocks, sketches,
    SLO specs and trace tails."""
    rng = np.random.default_rng(seed)
    snaps = {}
    for i in range(n):
        reg = JaxRegistry()
        _fill(reg, rng)
        snap = jfed.registry_snapshot(
            role="replica", registry=reg, start_unix=900.0 + i,
            slo_specs=["p99:serving.frontend.request_latency_seconds"
                       "<=50ms",
                       "drift=value:serving.model.default."
                       "score_drift_psi<=0.25"])
        snap["process"].update(pid=100 + i, host="h",
                               snapshot_unix=1000.0 + (i % 2))
        snap["sketches"] = _sketches(rng)
        snap["traces"] = {
            "sampling_enabled": True, "seen": 10 + i, "kept": {"slow": 2},
            "traces": {"slow": [_trace(f"p{i}a", 10.0 * i),
                                _trace(f"p{i}b", 10.0 * i + 1)]}}
        snaps[f"replica-{i}@{9000 + i}"] = json.loads(json.dumps(snap))
    # An unknown schema is skipped with a note.
    snaps["zz-bad"] = {"schema": "other.v0"}
    return snaps


def _view_json(view):
    snap = view.snapshot(role="aggregator", start_unix=1.0)
    for k in ("pid", "host", "snapshot_unix"):
        snap["process"].pop(k)
    return json.dumps(snap, sort_keys=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_of_jax_snapshots_gives_jax_fleet_view(seed):
    snaps = _jax_snapshots(seed)
    mine, theirs = tfed.merge_snapshots(snaps), jfed.merge_snapshots(snaps)
    assert _view_json(mine) == _view_json(theirs)
    assert mine.slo == theirs.slo and mine.notes == theirs.notes
    assert mine.peers == theirs.peers
    text = tel.render_prometheus(registry=mine.registry)
    assert text == jtel.render_prometheus(registry=theirs.registry)
    fams = parse_prometheus(text)
    assert fams["serving_frontend_admitted_total"]["samples"][0][2] == sum(
        s["counters"]["serving.frontend.admitted"]
        for s in snaps.values() if "counters" in s)
    # Arrival order does not move a byte.
    rev = dict(reversed(list(snaps.items())))
    assert _view_json(tfed.merge_snapshots(rev)) == _view_json(mine)


def test_port_snapshots_merge_alike_in_both_packages():
    rng = np.random.default_rng(3)
    snaps = {}
    for i in range(2):
        reg = MetricsRegistry()
        _fill(reg, rng)
        snap = tfed.registry_snapshot(
            role="training", registry=reg, start_unix=5.0,
            sketch_providers={"training": lambda: _sketches(
                np.random.default_rng(9))["training"]})
        snap["process"].update(pid=7 + i, snapshot_unix=50.0 + i)
        snaps[f"training-{i}@1"] = json.loads(json.dumps(snap))
    assert _view_json(tfed.merge_snapshots(snaps)) \
        == _view_json(jfed.merge_snapshots(snaps))


def test_gauge_merge_policies_alike():
    for name in ("process.uptime_seconds", "data.dist.rows",
                 "data.dist.label_mean", "data.shard_cache.device_bytes",
                 "serving.model.a.score_drift_psi",
                 "slo.x.burn_rate", "fleet.peers", "unknown.gauge"):
        assert tfed.gauge_merge_policy(name) == jfed.gauge_merge_policy(name)


def test_descriptors_and_discovery_alike(tmp_path):
    for d in "abc":
        (tmp_path / d).mkdir()
    tfed.write_obs_descriptor(tmp_path / "a" / "obs_port", 9001,
                              role="scoring", pid=11, start_unix=3.0)
    jfed.write_obs_descriptor(tmp_path / "b" / "obs_port", 9002,
                              role="training", pid=12, start_unix=4.0)
    (tmp_path / "c" / "obs_port").write_text("9003\n")  # legacy int
    assert tfed.discover_peers([tmp_path]) == jfed.discover_peers(
        [tmp_path])
    assert tfed.read_obs_descriptor(tmp_path / "b" / "obs_port") \
        == jfed.read_obs_descriptor(tmp_path / "b" / "obs_port")


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _joined(srv):
    srv.stop()
    assert srv._thread is None and srv._hb_thread is None


def test_peer_stopped_mid_scrape_degrades_not_crashes(tmp_path):
    """JAX kills a replica subprocess between scrapes; here the peer is
    a server thread of this process, stopped between scrapes."""
    tel.counter("serving.frontend.admitted").inc(7)
    peer = tel.ObservabilityServer(port=0, role="replica").start()
    try:
        tfed.write_obs_descriptor(tmp_path / "obs_port", peer.port,
                                  role="replica")
        agg = tfed.FleetAggregator(peer_dirs=[tmp_path], interval_s=0.2,
                                   stale_after_s=0.3, timeout_s=2.0)
        agg.server.start()
        try:
            agg.poll_once()
            (peer_id,) = agg.peer_staleness()
            assert not agg.peer_staleness()[peer_id]["stale"]
            assert agg._readiness()[0] is True
            code, body = _get(agg.server.port, "/metrics")
            fams = parse_prometheus(body)
            assert fams["serving_frontend_admitted_total"][
                "samples"][0][2] == 7
            label = tfed._peer_metric_label(peer_id)
            assert fams[f"fleet_peer_{label}_stale"]["samples"][0][2] == 0

            _joined(peer)  # the peer goes away between scrapes
            time.sleep(0.4)  # > stale_after_s
            agg.poll_once()  # must not raise
            st = agg.peer_staleness()[peer_id]
            assert st["stale"] and st["errors"] >= 1 and st["last_error"]
            code, body = _get(agg.server.port, "/metrics")
            assert code == 200
            fams = parse_prometheus(body)
            # The last snapshot stays in the fleet totals.
            assert fams["serving_frontend_admitted_total"][
                "samples"][0][2] == 7
            assert fams[f"fleet_peer_{label}_stale"]["samples"][0][2] == 1
            code, body = _get(agg.server.port, "/healthz")
            assert code == 200 and json.loads(body)["ready"] is False
            assert _get(agg.server.port, "/readyz")[0] == 503
            sz = json.loads(_get(agg.server.port, "/statusz")[1])
            assert sz["peers"][peer_id]["stale"] is True
            code, body = _get(agg.server.port, "/snapshotz")
            assert json.loads(body)["schema"] == tfed.SNAPSHOT_SCHEMA
        finally:
            agg.stop()
            _joined(agg.server)
    finally:
        peer.stop()
    assert not any(t.name.startswith("obs-") and t.is_alive()
                   for t in threading.enumerate())


def test_obs_aggregate_command_over_live_peer(tmp_path):
    with pytest.raises(SystemExit):
        obs_aggregate.run(["--duration", "0.1"])
    peer_dir = tmp_path / "peer"
    peer_dir.mkdir()
    srv = tel.ObservabilityServer(port=0, role="scoring").start()
    try:
        tfed.write_obs_descriptor(peer_dir / "obs_port", srv.port,
                                  role="scoring")
        out = tmp_path / "fleet"
        summary = obs_aggregate.run([
            "--peer-dirs", str(peer_dir), "--interval", "0.1",
            "--duration", "0.6", "--output-dir", str(out)])
    finally:
        _joined(srv)
    assert summary["scrape_passes"] >= 1
    (peer_id,) = summary["peers"]
    assert peer_id.startswith("scoring-")
    assert tfed.read_obs_descriptor(out / "obs_port")["role"] \
        == "aggregator"
    saved = json.loads((out / "fleet_summary.json").read_text())
    assert saved["scrape_passes"] == summary["scrape_passes"]
