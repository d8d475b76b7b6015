"""The port's SLOs, Prometheus exposition and observability server
(photon_ml_tpu_torch/telemetry/{slo,exposition}.py, cli/obs.py) against
the JAX package's, on the CPU.

- Registries filled alike (counters, gauges, histograms on default and
  custom ladders, names that need sanitizing, a sanitizing collision)
  render the same Prometheus text 0.0.4 in both packages, and the text
  parses under tests/test_exposition.py's strict reader.
- ``parse_slo`` reads every spec kind alike; ``SLOTracker.evaluate``
  and ``evaluate_specs`` give equal burn rates, currents, compliance and
  evaluation/violation counts over registries filled alike.
- The server answers every route on port 0 from its own thread: the
  readiness split, providers (a raising one reported inline and kept in
  ``failures()``), scrape hooks, ``/distz``, ``/snapshotz``,
  ``/debugz/dump``; the heartbeat refreshes liveness gauges, recorder
  deltas and SLO burn. Every server is stopped, its threads joined under
  a timeout; every request has a timeout.
- ``DriverObservability.finish`` raises when a live scrape failed
  during the run (no failure is swallowed).
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from photon_ml_tpu import telemetry as jtel
from photon_ml_tpu.telemetry import slo as jslo
from photon_ml_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from photon_ml_tpu_torch import telemetry as tel
from photon_ml_tpu_torch.cli.obs import DriverObservability
from photon_ml_tpu_torch.telemetry import slo as tslo
from photon_ml_tpu_torch.telemetry.registry import MetricsRegistry
from tests.test_exposition import parse_prometheus
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

BOTH = (tel, jtel)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for t in BOTH:
        t.disable()
        t.reset()
        t.enable()
    yield
    for t in BOTH:
        t.disable()
        t.reset()


def _fill(reg):
    """The same mutations, in the same order, on one registry."""
    reg.counter("serving.frontend.admitted").inc(7)
    reg.counter("serving.frontend.rejected").inc(2)
    reg.counter("9lives.odd-name").inc()
    reg.gauge("data.dist.label_mean").set(0.4375)
    reg.gauge("process.uptime_seconds").set(12.0)
    reg.gauge("weird gauge/with:chars").set(-1.5e-9)
    h = reg.histogram("serving.frontend.request_latency_seconds")
    for v in (0.0004, 0.002, 0.002, 0.03, 0.2, 1.7, 40.0):
        h.observe(v)
    c = reg.histogram("slo.custom_seconds", buckets=[0.01, 0.1, 1.0])
    for v in (0.05,) * 9 + (0.5,):
        c.observe(v)
    reg.histogram("empty.latency_seconds")
    # Two dotted names that sanitize to one Prometheus name: the first
    # wins and the collision is a comment.
    reg.counter("a.b").inc()
    reg.counter("a_b").inc(3)


def _get(port, route, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}",
                                 headers=headers or {})
    return urllib.request.urlopen(req, timeout=10)


def test_render_prometheus_equal_for_registries_filled_alike():
    mine, theirs = MetricsRegistry(), JaxRegistry()
    _fill(mine)
    _fill(theirs)
    text = tel.render_prometheus(registry=mine)
    assert text == jtel.render_prometheus(registry=theirs)
    fams = parse_prometheus(text)
    assert fams["serving_frontend_admitted_total"]["samples"][0][2] == 7
    assert "# collision: 'a_b' also sanitizes to 'a_b_total'" in text
    for name in ("9lives.odd-name", "weird gauge/with:chars",
                 "serving.frontend.request_latency_seconds"):
        assert tel.prometheus_name(name) == jtel.prometheus_name(name)


SPECS = [
    "p99:serving.frontend.request_latency_seconds<=50ms",
    "tail=p99.9:serving.frontend.request_latency_seconds<=200us",
    "p90:slo.custom_seconds<=100ms",
    "p50:slo.custom_seconds<=1.5",
    "shed=ratio:serving.frontend.rejected/serving.frontend.admitted+"
    "serving.frontend.rejected<=0.02",
    "drift=value:data.dist.label_mean<=0.25",
    "quiet=value:never.set_gauge<=1",
]


def test_parse_slo_alike():
    for spec in SPECS:
        a, b = tslo.parse_slo(spec), jslo.parse_slo(spec)
        assert type(a).__name__ == type(b).__name__
        assert a.name == b.name and a.describe() == b.describe()
    for bad in ("p99:x.y", "p200:x.y<=1s", "ratio:x<=0.5",
                "nope:x.y<=1s", "Bad Name=p99:x.y<=1s",
                "p99:x.y<=50parsecs"):
        with pytest.raises(ValueError):
            tslo.parse_slo(bad)
    with pytest.raises(ValueError, match="duplicate"):
        tel.SLOTracker(["p99:a.b<=1s", "p99:a.b<=2s"])


def test_slo_burn_rates_equal():
    trackers = [t.SLOTracker(SPECS) for t in BOTH]
    # No traffic yet, then the same traffic twice.
    evals = [[tr.evaluate() for tr in trackers]]
    for _ in range(2):
        for t in BOTH:
            _fill(t.registry())
        evals.append([tr.evaluate() for tr in trackers])
    for mine, theirs in evals:
        assert mine == theirs
    last = evals[-1][0]
    assert last["p90_slo_custom_seconds"]["burn_rate"] == pytest.approx(1.0)
    assert last["shed"]["compliant"] is False
    assert last["drift"]["burn_rate"] == pytest.approx(0.4375 / 0.25)
    assert last["quiet"]["burn_rate"] is None
    # The registries also hold what earlier tests in this process made
    # (reset() zeroes metrics in place): compare this tracker's twins.
    ours = tuple(f"slo.{o.name}." for o in trackers[0].objectives)
    snaps = [t.snapshot() for t in BOTH]
    for kind in ("counters", "gauges"):
        mine, theirs = ({k: v for k, v in s[kind].items()
                         if k.startswith(ours)} for s in snaps)
        per_spec = 2 if kind == "counters" else 1  # evaluations, violations
        assert mine == theirs and len(mine) == per_spec * len(SPECS)
    # The stateless form over a registry of one's own.
    regs = [MetricsRegistry(), JaxRegistry()]
    for r in regs:
        _fill(r)
    assert tslo.evaluate_specs(SPECS, regs[0]) \
        == jslo.evaluate_specs(SPECS, regs[1])


def _stop_and_check_joined(srv):
    srv.stop()
    assert srv._thread is None and srv._hb_thread is None
    assert not any(t.name in ("obs-server", "obs-heartbeat")
                   and t.is_alive() for t in threading.enumerate())


def test_server_routes(tmp_path):
    rec = tel.FlightRecorder(max_events=64).install()
    tracker = tel.SLOTracker(
        ["p99:serving.frontend.request_latency_seconds<=50ms"])
    hooks = []
    try:
        tel.counter("serving.frontend.admitted").inc(2)
        with tel.span("solve"):
            pass
        srv = tel.ObservabilityServer(
            port=0, recorder=rec, slo_tracker=tracker,
            status_providers={"demo": lambda: {"x": 1},
                              "broken": lambda: 1 / 0},
            dump_path=tmp_path / "flight.json", role="scoring",
            slo_specs=[
                "p99:serving.frontend.request_latency_seconds<=50ms"])
        srv.add_distribution_provider("training", lambda: {"rows": 5})
        srv.add_scrape_hook("count", lambda: hooks.append(1))
        srv.add_sketch_provider("serving", lambda: {
            "default.scores.quantiles": tel.QuantileSketch().state()})
        srv.start()
        try:
            port = srv.port
            assert port > 0
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(port, "/readyz")
            assert ei.value.code == 503
            srv.set_ready(True, "model_loaded")
            assert json.loads(_get(port, "/readyz").read())["ready"]
            hz = json.loads(_get(port, "/healthz").read())
            assert hz["status"] == "ok" and hz["role"] == "scoring"
            resp = _get(port, "/metrics")
            assert resp.headers["Content-Type"].startswith("text/plain")
            fams = parse_prometheus(resp.read().decode())
            assert fams["serving_frontend_admitted_total"][
                "samples"][0][2] == 2
            om = _get(port, "/metrics",
                      {"Accept": "application/openmetrics-text"}).read()
            assert om.decode().endswith("# EOF\n")
            sz = json.loads(_get(port, "/statusz").read())
            assert sz["status"]["demo"] == {"x": 1}
            assert "ZeroDivisionError" in sz["status"]["broken"]["error"]
            assert sz["failing_providers"] == ["broken"]
            assert "solve" in sz["stage_attribution"]
            assert "p99_serving_frontend_request_latency_seconds" \
                in sz["slo"]
            assert json.loads(_get(port, "/distz").read()) == {
                "training": {"rows": 5}}
            snap = json.loads(_get(port, "/snapshotz").read())
            assert snap["schema"] == tel.SNAPSHOT_SCHEMA
            assert snap["process"]["role"] == "scoring"
            assert "serving" in snap["sketches"]
            assert json.loads(_get(port, "/tracez").read())["seen"] == 0
            dz = json.loads(_get(port, "/debugz/dump").read())
            assert any(e.get("name") == "solve" for e in dz["traceEvents"])
            assert (tmp_path / "flight.json").exists()
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(port, "/nope")
            assert ei.value.code == 404
            # Hooks ran before both /metrics, /statusz, /distz and
            # /snapshotz.
            assert len(hooks) == 5
            assert srv.failures() == {"providers": {"broken": 1}}
        finally:
            _stop_and_check_joined(srv)
        assert srv.summary()["port"] == port and srv.scrapes == 2
    finally:
        rec.uninstall()


def test_server_heartbeat_refreshes_gauges_deltas_and_burn():
    rec = tel.FlightRecorder(max_events=64, snapshot_interval_s=0.0)
    tracker = tel.SLOTracker(["drift=value:hb.drift<=0.25"])
    g = tel.gauge("hb.drift")
    srv = tel.ObservabilityServer(port=0, recorder=rec, heartbeat_s=0.02,
                                  slo_tracker=tracker)
    srv.add_scrape_hook("drift", lambda: g.set(0.5))
    srv.start()
    try:
        tel.counter("hb.work").inc(5)  # no span closes: only ticks
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if tel.counter("slo.drift.violations").value >= 1 and any(
                    e[0] == "metrics" for e in list(rec._ring)):
                break
            time.sleep(0.01)
    finally:
        _stop_and_check_joined(srv)
    assert tel.gauge("process.heartbeat_unix_time").value > 0
    assert tel.counter("slo.drift.violations").value >= 1
    deltas = [e for e in list(rec._ring) if e[0] == "metrics"]
    assert any("hb.work" in e[2] for e in deltas)


def _args(**kw):
    base = {"obs_port": 0, "flight_events": 16, "slo": None}
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_driver_observability_announces_port_and_raises_on_failures(
        tmp_path):
    obs = DriverObservability(_args(slo=["v=value:t.g<=1"]), tmp_path,
                              role="training").start()
    try:
        desc = tel.read_obs_descriptor(tmp_path / "obs_port")
        assert desc["port"] == obs.server.port and desc["role"] == \
            "training"
        obs.add_scrape_hook("g", lambda: tel.gauge("t.g").set(0.5))
        obs.mark_ready("solve_complete")
        summary = obs.finish({})
        assert summary["slo"]["v"]["current"] == 0.5
        assert summary["observability"]["server"]["ready"] is True
        # A provider that raises during a live scrape fails the run.
        obs.add_status_provider("broken", lambda: 1 / 0)
        _get(obs.server.port, "/statusz").read()
        with pytest.raises(RuntimeError, match="scrapes failed"):
            obs.finish({})
    finally:
        obs.stop()
    _stop_and_check_joined(obs.server)
    # A scrape hook that raises is not skipped at finish either.
    quiet = DriverObservability(_args(obs_port=None), tmp_path)
    quiet.add_scrape_hook("bad", lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        quiet.finish({})
