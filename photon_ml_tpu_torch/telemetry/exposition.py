"""Live metrics exposition: Prometheus text rendering of the registry
and a stdlib-only HTTP observability server.

Port of photon_ml_tpu/telemetry/exposition.py:1-648 (standard library
only): a live ``--serve`` process, or a long ``--stream-train``, gets a
plane a scraper can poll, a load balancer can health-check and an
operator can hit at fault time, instead of metrics.json at the end.

Two pieces, both dependency-free:

- :func:`render_prometheus` maps the :class:`MetricsRegistry` snapshot
  onto Prometheus text format 0.0.4. The mapping is faithful by
  construction: registry histograms already use upper-edge-inclusive
  buckets (``le`` semantics), so exposition is a running sum — never a
  re-bin — with the implicit overflow bucket rendered as ``+Inf``.
  Dotted snake_case registry names (``serving.frontend.admitted``)
  become legal Prometheus names by replacing every character outside
  ``[a-zA-Z0-9_:]`` with ``_``; counters gain the conventional
  ``_total`` suffix. The original dotted name rides in the ``# HELP``
  line, so dashboards can be built against either spelling.
- :class:`ObservabilityServer` serves ``/metrics`` (Prometheus text),
  ``/healthz`` (liveness JSON), ``/statusz`` (full JSON status:
  registry snapshot, stage attribution, registered status providers —
  the serving front-end plugs its ``stats()`` in here, which carries
  per-model serving stats and the executable cache's tracing-guard
  counts — and the SLO block) and ``/debugz/dump`` (flight-recorder
  dump, telemetry/recorder.py), ``/readyz``, ``/tracez``, ``/distz`` and
  ``/snapshotz`` from a background daemon thread on
  ``http.server``. Request handling only READS telemetry state (every
  structure is lock-guarded or copied), so a scrape can never corrupt a
  hot path.

The server is wired in by the CLI drivers (``--obs-port``; 0 binds an
ephemeral port, reported in metrics.json) — libraries never start one,
the same discipline as the telemetry enable flag.
"""

from __future__ import annotations

import http.server
import importlib
import json
import re
import threading
import time
from typing import Callable, Dict, Optional

# Submodules via importlib: the package re-exports ``registry`` (the
# accessor FUNCTION) under the same name as this module, so a plain
# ``from photon_ml_tpu_torch.telemetry import registry`` would bind the
# function — same discipline as spans.py.
_reg = importlib.import_module("photon_ml_tpu_torch.telemetry.registry")
_spans = importlib.import_module("photon_ml_tpu_torch.telemetry.spans")
_tracectx = importlib.import_module("photon_ml_tpu_torch.telemetry.tracectx")

_INVALID_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


def prometheus_name(name: str) -> str:
    """Registry dotted snake_case -> legal Prometheus metric name:
    every character outside ``[a-zA-Z0-9_:]`` becomes ``_`` (dots
    included — ``serving.frontend.admitted`` ->
    ``serving_frontend_admitted``) and a leading digit gains a ``_``
    prefix. Label-free by design: the registry encodes dimensions in
    the dotted namespace (``serving.model.<label>.requests``), so the
    whole name sanitizes as one unit."""
    out = _INVALID_CHARS.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _fmt_value(v) -> str:
    """One sample value in Prometheus text syntax (Go-parseable float;
    integral values render bare so counters stay exact)."""
    f = float(v)
    if f != f:
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f == int(f) and abs(f) < 2 ** 53:
        return str(int(f))
    return repr(f)


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def render_prometheus(registry: Optional[_reg.MetricsRegistry] = None,
                      include_exemplars: bool = False) -> str:
    """Render the registry in Prometheus text exposition format 0.0.4.

    Per metric family: ``# HELP`` (carrying the original dotted registry
    name), ``# TYPE``, then samples. Histograms emit cumulative
    ``_bucket{le="..."}`` series (one per configured bound, plus
    ``le="+Inf"`` == observation count), ``_sum`` and ``_count`` — each
    histogram's series come from ONE locked read
    (:meth:`Histogram.exposition_state`), so they are mutually
    consistent even under concurrent observation. In the (schema-
    violating) event two dotted names sanitize to one Prometheus name,
    the first wins and the collision is reported as a comment rather
    than emitting an invalid duplicate family.

    ``include_exemplars`` appends each bucket's last trace_id in
    OpenMetrics exemplar syntax. That syntax is ILLEGAL in text 0.0.4
    (a mid-line ``#`` fails a strict 0.0.4 parser, losing the whole
    scrape), so it is opt-in: the observability server enables it only
    when the scraper's ``Accept`` header negotiates OpenMetrics, and
    serves the matching content type + ``# EOF`` terminator."""
    reg = registry if registry is not None else _reg.registry()
    counters, gauges, histograms = reg.metrics()
    out = []
    seen: Dict[str, str] = {}

    def claim(pname: str, dotted: str) -> bool:
        prev = seen.get(pname)
        if prev is not None and prev != dotted:
            out.append(f"# collision: {dotted!r} also sanitizes to "
                       f"{pname!r} (kept {prev!r})")
            return False
        seen[pname] = dotted
        return True

    for name in sorted(counters):
        pname = prometheus_name(name) + "_total"
        if not claim(pname, name):
            continue
        out.append(f"# HELP {pname} "
                   f"{_escape_help('registry counter ' + name)}")
        out.append(f"# TYPE {pname} counter")
        out.append(f"{pname} {_fmt_value(counters[name].value)}")
    for name in sorted(gauges):
        pname = prometheus_name(name)
        if not claim(pname, name):
            continue
        out.append(f"# HELP {pname} "
                   f"{_escape_help('registry gauge ' + name)}")
        out.append(f"# TYPE {pname} gauge")
        out.append(f"{pname} {_fmt_value(gauges[name].value)}")
    for name in sorted(histograms):
        pname = prometheus_name(name)
        if not claim(pname, name):
            continue
        hist = histograms[name]
        bounds, cum, count, total = hist.exposition_state()
        # Exemplars (last trace_id per bucket) — only on negotiated
        # OpenMetrics renders (see docstring). Read once, outside the
        # bucket loop; advisory data (see Histogram.exemplars()).
        exemplars = hist.exemplars() if include_exemplars else {}
        out.append(f"# HELP {pname} "
                   f"{_escape_help('registry histogram ' + name)}")
        out.append(f"# TYPE {pname} histogram")
        for b, c in zip(bounds, cum):
            line = f'{pname}_bucket{{le="{_fmt_value(b)}"}} {c}'
            out.append(line + _fmt_exemplar(exemplars.get(b)))
        out.append(f'{pname}_bucket{{le="+Inf"}} {count}'
                   + _fmt_exemplar(exemplars.get("+inf")))
        out.append(f"{pname}_sum {_fmt_value(total)}")
        out.append(f"{pname}_count {count}")
    return "\n".join(out) + "\n"


def _fmt_exemplar(ex) -> str:
    """OpenMetrics exemplar suffix for a bucket sample line:
    `` # {trace_id="..."} <value> <unix_ts>`` — empty when the bucket
    has none."""
    if ex is None:
        return ""
    trace_id, value, ts = ex
    return (f' # {{trace_id="{trace_id}"}} {_fmt_value(value)} '
            f"{_fmt_value(round(ts, 3))}")


def _json_default(o):
    """metrics/stats blocks can carry numpy scalars and tuples of
    non-JSON types; render numbers as numbers and everything else as
    its string form rather than failing a live scrape."""
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


class _ObsHTTPServer(http.server.ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    obs: "ObservabilityServer" = None


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "photon-obs/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args) -> None:
        pass  # stay silent: the obs plane must not spam driver stderr

    def _send(self, status: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802 — http.server contract
        obs = self.server.obs
        path = self.path.split("?", 1)[0]
        try:
            route = obs._routes.get(path)
            if route is None:
                self._send(404, json.dumps(
                    {"error": f"no route {path!r}",
                     "routes": sorted(obs._routes)}) + "\n",
                    "application/json")
                return
            result = route(self.headers.get("Accept", ""))
            # Routes return (body, ctype), or (status, body, ctype)
            # when they need a non-200 (readiness probes speak HTTP
            # status codes — a load balancer never parses JSON).
            if len(result) == 3:
                status, body, ctype = result
            else:
                body, ctype = result
                status = 200
            self._send(status, body, ctype)
        except BrokenPipeError:
            pass  # scraper went away mid-response
        except Exception as e:  # noqa: BLE001 — a scrape must not crash
            # The scraper gets a 500; the run learns of it through
            # failures(), which the drivers' finish() turns into a raise.
            with obs._scrape_cv:
                obs._route_errors[path] = obs._route_errors.get(path, 0) + 1
            try:
                self._send(500, json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}) + "\n",
                    "application/json")
            except Exception:  # noqa: BLE001 — socket already gone
                pass


class ObservabilityServer:
    """Background-thread HTTP server exposing the live telemetry plane.

    Routes: ``/metrics`` (Prometheus text), ``/healthz``, ``/statusz``,
    ``/tracez``, ``/distz`` (distribution providers — data/distmon.py),
    ``/debugz/dump``. ``port=0`` binds an ephemeral port; read ``.port``
    after :meth:`start`. Optional collaborators:

    - ``recorder``: a :class:`FlightRecorder` — enables ``/debugz/dump``
      (dump returned as the response body and, when ``dump_path`` is
      set, also written there).
    - ``slo_tracker``: an :class:`SLOTracker` — its evaluation rides in
      ``/statusz`` under ``slo`` (and advances burn counters).
    - ``status_providers``: ``{name: zero-arg callable -> dict}`` merged
      into ``/statusz`` under ``status`` (the serving front-end
      registers its ``stats()`` here; a provider that raises reports
      its error inline instead of failing the whole page).
    - ``heartbeat_s``: period of a liveness ticker that refreshes the
      ``process.uptime_seconds`` / ``process.heartbeat_unix_time``
      gauges, lets the flight recorder capture periodic registry deltas
      even while no spans are closing, and re-evaluates the SLO tracker
      — the opt-in training-driver heartbeat.

    Usable as a context manager; :meth:`stop` is idempotent.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 recorder=None, slo_tracker=None,
                 status_providers: Optional[
                     Dict[str, Callable[[], dict]]] = None,
                 heartbeat_s: Optional[float] = None,
                 dump_path=None, role: str = "process",
                 labels: Optional[Dict[str, str]] = None,
                 slo_specs=None):
        self._host = host
        self._requested_port = int(port)
        self.recorder = recorder
        self.slo_tracker = slo_tracker
        self.heartbeat_s = heartbeat_s
        self.dump_path = dump_path
        # Process identity for /snapshotz (telemetry/federation.py):
        # the aggregator attributes every merged series back to
        # role/pid, and re-evaluates the declared SLO spec STRINGS
        # against the merged registry.
        self.role = role
        self.labels = dict(labels or {})
        self.slo_specs = [str(s) for s in (slo_specs or [])]
        # Liveness vs readiness: /healthz answers "is the process up"
        # from the moment the server starts; /readyz answers "can it
        # serve" and flips only when the driver calls set_ready()
        # (model loaded / first solve done). A just-booted process is
        # alive but NOT ready — a load balancer must not route to it.
        self._ready = False
        self._ready_reason = "starting"
        self._ready_check: Optional[Callable[[], tuple]] = None
        self.scrapes = 0  # plain int: live even with telemetry disabled
        self._m_scrapes = _reg.registry().counter("observability.scrapes")
        # /snapshotz scrape handshake (federation): the count increments
        # AFTER the snapshot body is built, so a waiter that saw count k
        # and wakes at k+1 knows one FULL snapshot was rendered after it
        # started waiting — DriverObservability.finish() uses this to
        # hold a short run's plane up until the aggregator's final poll
        # has seen the settled end-of-run state.
        self._snapshot_scrapes = 0
        self._scrape_cv = threading.Condition()
        # A /statusz provider that raises is isolated (its error reports
        # inline) — but silent isolation hid broken providers for a
        # whole run. Count them (registry counter + always-live local
        # twin) and surface the failing names in the payload.
        self._m_provider_errors = _reg.registry().counter(
            "obs.provider_errors")
        self._provider_errors: Dict[str, int] = {}
        self._providers: Dict[str, Callable[[], dict]] = dict(
            status_providers or {})
        # /distz distribution providers (data/distmon.py) + pre-scrape
        # hooks. Hooks run at the top of every scrape route AND each
        # heartbeat tick: they refresh gauges that are COMPUTED rather
        # than event-driven (drift scores, distribution headline
        # gauges), so a /metrics scrape — and the heartbeat's SLO
        # evaluation — always reads current values with no polling
        # thread of their own. Hook errors are isolated and counted
        # like provider errors.
        self._dist_providers: Dict[str, Callable[[], dict]] = {}
        self._scrape_hooks: Dict[str, Callable[[], None]] = {}
        self._hook_errors: Dict[str, int] = {}
        self._route_errors: Dict[str, int] = {}
        self._m_hook_errors = _reg.registry().counter(
            "obs.scrape_hook_errors")
        self._httpd: Optional[_ObsHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        self._t0 = time.monotonic()
        self._start_unix = time.time()
        self._sketch_providers: Dict[str, Callable[[], dict]] = {}
        self._routes = {
            "/metrics": self._metrics,
            "/healthz": self._healthz,
            "/readyz": self._readyz,
            "/statusz": self._statusz,
            "/debugz/dump": self._debugz_dump,
            "/tracez": self._tracez,
            "/distz": self._distz,
            "/snapshotz": self._snapshotz,
        }

    # -- routes ------------------------------------------------------------

    def _run_scrape_hooks(self) -> None:
        for name, fn in sorted(self._scrape_hooks.items()):
            try:
                fn()
            except Exception:  # noqa: BLE001 — a hook must not fail a scrape
                self._hook_errors[name] = \
                    self._hook_errors.get(name, 0) + 1
                self._m_hook_errors.inc()

    def _metrics(self, accept: str = ""):
        self.scrapes += 1
        self._m_scrapes.inc()
        self._run_scrape_hooks()
        # Content negotiation: exemplar syntax is only legal under
        # OpenMetrics, so a plain scraper gets clean text 0.0.4 (no
        # exemplars — a mid-line '#' would fail its whole scrape) and
        # an Accept: application/openmetrics-text scraper gets the
        # exemplar-bearing render + '# EOF' terminator. The OpenMetrics
        # render reuses the 0.0.4 family layout (counters keep _total
        # in their TYPE line — a documented simplification consumers
        # like Grafana's agent accept).
        if "openmetrics" in accept:
            return (render_prometheus(include_exemplars=True)
                    + "# EOF\n",
                    "application/openmetrics-text; version=1.0.0; "
                    "charset=utf-8")
        return (render_prometheus(),
                "text/plain; version=0.0.4; charset=utf-8")

    def _healthz(self, accept: str = ""):
        """Liveness: 200 as long as the process is up. Carries the
        readiness flag informationally — probes that care about
        routability must use /readyz, which speaks HTTP status."""
        ready, reason = self.readiness()
        return (json.dumps({
            "status": "ok",
            "ready": ready,
            "ready_reason": reason,
            "role": self.role,
            "uptime_seconds": round(time.monotonic() - self._t0, 3),
        }) + "\n", "application/json")

    def _readyz(self, accept: str = ""):
        """Readiness: 200 once the driver marked the process able to
        serve (or the installed ready_check passes), 503 before — the
        split /healthz used to blur: a just-booted process scraped
        healthy before it could serve."""
        ready, reason = self.readiness()
        body = json.dumps({"ready": ready, "reason": reason}) + "\n"
        return (200 if ready else 503, body, "application/json")

    def _snapshotz(self, accept: str = ""):
        """Canonical registry snapshot for federation — full raw
        histogram bucket states (not cumulative), sketch states, SLO
        spec strings and process metadata, in the
        ``photon.obs.snapshot.v1`` schema that
        telemetry/federation.py merges across processes. Imported
        lazily: federation imports this module for the aggregator's
        server."""
        self._run_scrape_hooks()
        fed = importlib.import_module(
            "photon_ml_tpu_torch.telemetry.federation")
        snap = fed.registry_snapshot(
            role=self.role, labels=self.labels,
            slo_specs=self.slo_specs,
            sketch_providers=self._sketch_providers,
            start_unix=self._start_unix)
        for name in snap.get("sketch_errors", {}):
            # Reported inline to the scraper, and kept for failures().
            with self._scrape_cv:
                self._provider_errors[name] = \
                    self._provider_errors.get(name, 0) + 1
            self._m_provider_errors.inc()
        body = json.dumps(snap, default=_json_default) + "\n"
        # Bump-and-notify AFTER the body is built: a finish() waiter
        # woken by this scrape is guaranteed the snapshot carries
        # everything written before it started waiting.
        with self._scrape_cv:
            self._snapshot_scrapes += 1
            self._scrape_cv.notify_all()
        return (body, "application/json")

    def _statusz(self, accept: str = ""):
        self._run_scrape_hooks()
        status = {}
        failing = []
        for name, fn in sorted(self._providers.items()):
            try:
                status[name] = fn()
            except Exception as e:  # noqa: BLE001 — report, don't 500
                status[name] = {"provider": name,
                                "error": f"{type(e).__name__}: {e}"}
                failing.append(name)
                self._provider_errors[name] = \
                    self._provider_errors.get(name, 0) + 1
                self._m_provider_errors.inc()
        body = {
            "uptime_seconds": round(time.monotonic() - self._t0, 3),
            "scrapes": self.scrapes,
            "telemetry_enabled": _reg.enabled(),
            "metrics": _reg.registry().snapshot(),
            "stage_attribution": _spans.stage_attribution(),
            "status": status,
            "failing_providers": failing,
            "provider_errors": dict(self._provider_errors),
            "scrape_hook_errors": dict(self._hook_errors),
            "slo": (self.slo_tracker.evaluate()
                    if self.slo_tracker is not None else None),
            "flight_recorder": (self.recorder.stats()
                                if self.recorder is not None else None),
        }
        return (json.dumps(body, indent=2, default=_json_default) + "\n",
                "application/json")

    def _tracez(self, accept: str = ""):
        """Tail-sampled trace timelines (telemetry/tracectx.py): every
        shed/error/cancellation, the slowest decile, and a uniform
        floor — the per-request view the aggregate routes cannot
        give."""
        return (json.dumps(_tracectx.trace_tail().snapshot(), indent=2,
                           default=_json_default) + "\n",
                "application/json")

    def _distz(self, accept: str = ""):
        """Live distribution observability (data/distmon.py): training
        label/weight/offset/feature sketches + convergence tails, and
        per-model serving score sketches + drift — whatever providers
        the driver registered. Provider errors report inline, mirroring
        /statusz."""
        self._run_scrape_hooks()
        body = {}
        for name, fn in sorted(self._dist_providers.items()):
            try:
                body[name] = fn()
            except Exception as e:  # noqa: BLE001 — report, don't 500
                body[name] = {"provider": name,
                              "error": f"{type(e).__name__}: {e}"}
                self._provider_errors[name] = \
                    self._provider_errors.get(name, 0) + 1
                self._m_provider_errors.inc()
        return (json.dumps(body, indent=2, default=_json_default) + "\n",
                "application/json")

    def _debugz_dump(self, accept: str = ""):
        if self.recorder is None:
            return (json.dumps({"error": "no flight recorder installed "
                                         "(driver --flight-events 0?)"})
                    + "\n", "application/json")
        dump = self.recorder.dump(path=self.dump_path, reason="debugz")
        return (json.dumps(dump, default=_json_default) + "\n",
                "application/json")

    # -- lifecycle ---------------------------------------------------------

    def add_status_provider(self, name: str,
                            fn: Callable[[], dict]) -> None:
        self._providers[name] = fn

    def add_distribution_provider(self, name: str,
                                  fn: Callable[[], dict]) -> None:
        """Expose a distribution snapshot provider under /distz."""
        self._dist_providers[name] = fn

    def add_scrape_hook(self, name: str,
                        fn: Callable[[], None]) -> None:
        """Register a pre-scrape refresh hook (run before /metrics,
        /statusz and /distz render, and on each heartbeat tick)."""
        self._scrape_hooks[name] = fn

    def add_sketch_provider(self, name: str,
                            fn: Callable[[], dict]) -> None:
        """Register a sketch-state provider for /snapshotz: a zero-arg
        callable returning ``{key: sketch_state_dict}`` (the
        ``serialize()`` form telemetry/sketches.py reconstructs via
        ``sketch_from_state``). Federation merges equal keys across
        peers with the sketches' deterministic merges."""
        self._sketch_providers[name] = fn

    def await_final_scrape(self, timeout_s: float = 2.0) -> bool:
        """Final-scrape handshake: block until one more FULL /snapshotz
        render completes, or ``timeout_s`` elapses. Returns immediately
        (False) when no federation scraper ever polled this server —
        zero snapshotz scrapes means nobody is watching and a plain run
        must not pay an exit delay. Used by the drivers' finish() so a
        short run cannot tear the plane down between an aggregator's
        last poll and the settled end-of-run counters (trace tail, final
        gauge refresh)."""
        with self._scrape_cv:
            seen = self._snapshot_scrapes
            if seen == 0:
                return False
            deadline = time.monotonic() + timeout_s
            while self._snapshot_scrapes <= seen:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    return False
                self._scrape_cv.wait(remain)
            return True

    def failures(self) -> Dict[str, Dict[str, int]]:
        """Every scrape failure of the run so far, by kind and name:
        providers and scrape hooks that raised (reported inline to the
        scraper) and routes that answered 500. Empty when none did."""
        with self._scrape_cv:
            out = {"providers": dict(self._provider_errors),
                   "scrape_hooks": dict(self._hook_errors),
                   "routes": dict(self._route_errors)}
        return {k: v for k, v in out.items() if v}

    def add_route(self, path: str, fn) -> None:
        """Install or override a route. ``fn(accept)`` returns
        ``(body, ctype)`` or ``(status, body, ctype)``. The fleet
        aggregator uses this to replace the per-process /metrics,
        /statusz, /tracez, /distz and /snapshotz with merged views
        while keeping the server plumbing."""
        self._routes[path] = fn

    def set_ready(self, ready: bool = True,
                  reason: str = "ready") -> None:
        """Flip the readiness flag (drivers call this after model load
        / first successful solve)."""
        self._ready = bool(ready)
        self._ready_reason = reason

    def set_ready_check(self, fn: Callable[[], tuple]) -> None:
        """Install a dynamic readiness predicate returning
        ``(ready, reason)`` — evaluated on every probe, overriding the
        static flag. The aggregator's check requires >= 1 fresh peer,
        which can flip back to not-ready when the fleet goes stale."""
        self._ready_check = fn

    def readiness(self) -> tuple:
        """(ready, reason) — the dynamic check when installed, else
        the static set_ready flag."""
        if self._ready_check is not None:
            try:
                ready, reason = self._ready_check()
                return bool(ready), str(reason)
            except Exception as e:  # noqa: BLE001 — probe must answer
                return False, f"ready_check error: {type(e).__name__}: {e}"
        return self._ready, self._ready_reason

    @property
    def port(self) -> Optional[int]:
        """Bound port (survives stop(), so a driver can report it in
        metrics.json after tearing the server down)."""
        return self._bound_port

    _bound_port: Optional[int] = None

    def start(self) -> "ObservabilityServer":
        if self._httpd is not None:
            raise RuntimeError("observability server already started")
        self._t0 = time.monotonic()
        self._start_unix = time.time()
        self._httpd = _ObsHTTPServer((self._host, self._requested_port),
                                     _Handler)
        self._httpd.obs = self
        self._bound_port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="obs-server", daemon=True)
        self._thread.start()
        if self.heartbeat_s:
            self._hb_stop.clear()
            self._hb_thread = threading.Thread(
                target=self._heartbeat, name="obs-heartbeat", daemon=True)
            self._hb_thread.start()
        return self

    def _heartbeat(self) -> None:
        uptime = _reg.registry().gauge("process.uptime_seconds")
        beat = _reg.registry().gauge("process.heartbeat_unix_time")
        while not self._hb_stop.wait(self.heartbeat_s):
            uptime.set(time.monotonic() - self._t0)
            beat.set(time.time())
            if self.recorder is not None:
                self.recorder.tick()
            # Hooks BEFORE SLO evaluation: a value objective over a
            # computed gauge (drift) must judge a fresh value.
            self._run_scrape_hooks()
            if self.slo_tracker is not None:
                self.slo_tracker.evaluate()

    def stop(self) -> None:
        if self._hb_thread is not None:
            self._hb_stop.set()
            self._hb_thread.join(timeout=5)
            self._hb_thread = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "ObservabilityServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def summary(self) -> dict:
        """The metrics.json ``observability`` block."""
        ready, reason = self.readiness()
        return {
            "port": self.port,
            "host": self._host,
            "role": self.role,
            "ready": ready,
            "ready_reason": reason,
            "scrapes": self.scrapes,
            "heartbeat_s": self.heartbeat_s,
            "routes": sorted(self._routes),
        }
