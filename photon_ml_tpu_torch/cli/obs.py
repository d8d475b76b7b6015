"""Driver-side wiring of the live observability plane, shared by the GAME
training and scoring drivers (port of photon_ml_tpu/cli/obs.py:1-250:
the observability flags :46-80 and DriverObservability :83-250).

- ``--obs-port P`` starts an :class:`ObservabilityServer` on
  ``127.0.0.1:P`` (0 = ephemeral) for the run: ``/metrics``
  (Prometheus text), ``/healthz``, ``/readyz``, ``/statusz``,
  ``/tracez``, ``/distz``, ``/snapshotz`` and ``/debugz/dump``. The
  bound port is announced in ``<output-dir>/obs_port`` as a JSON
  descriptor (``{port, pid, role, start_unix}``) as soon as the server
  is up, and reported in metrics.json under ``observability.server``.
- ``--flight-events N`` (default 4096; 0 disables) installs a
  :class:`FlightRecorder`: the last N completed spans and periodic
  registry deltas, dumped to ``<output-dir>/flight.json`` on an
  unhandled driver fault, on SIGTERM and through ``/debugz/dump``.
- ``--slo SPEC`` (repeatable) declares objectives over existing
  registry metrics (telemetry/slo.py syntax); burn-rate counters ride
  in ``/metrics``, the evaluation in ``/statusz`` and metrics.json's
  ``slo`` block.

No failure is swallowed: where JAX's ``finish()`` skips a scrape hook
that raises, here it propagates, and a run whose server answered a
scrape with a provider, hook or route error raises at ``finish()``
instead of writing metrics.json.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional

from photon_ml_tpu_torch.telemetry import (
    FlightRecorder,
    ObservabilityServer,
    SLOTracker,
    install_sigterm_dump,
    trace_tail,
    write_obs_descriptor,
)


def add_observability_args(p) -> None:
    """Attach the shared observability flags to a driver parser."""
    p.add_argument("--obs-port", type=int, default=None, metavar="PORT",
                   help="serve the live observability plane on "
                        "127.0.0.1:PORT for the run: /metrics "
                        "(Prometheus text; exemplars on OpenMetrics-"
                        "negotiated scrapes), /healthz, /readyz, "
                        "/statusz, /tracez, /distz (with --distmon), "
                        "/snapshotz, /debugz/dump. 0 binds an ephemeral "
                        "port, written to <output-dir>/obs_port and "
                        "reported in metrics.json")
    p.add_argument("--flight-events", type=int, default=4096, metavar="N",
                   help="flight-recorder ring size: the last N completed "
                        "spans + periodic registry deltas, dumped to "
                        "<output-dir>/flight.json on an unhandled driver "
                        "fault, on SIGTERM and via /debugz/dump "
                        "(Perfetto-loadable). 0 disables the recorder")
    p.add_argument("--slo", action="append", default=None, metavar="SPEC",
                   help="declare an objective over existing metrics, e.g. "
                        "'p99:serving.frontend.request_latency_seconds"
                        "<=50ms', 'shed=ratio:serving.frontend.rejected"
                        "/serving.frontend.admitted+serving.frontend."
                        "rejected<=0.02' or 'drift=value:serving.model."
                        "default.score_drift_psi<=0.25'; repeatable. Burn "
                        "rates surface in /metrics, /statusz and "
                        "metrics.json slo")


class DriverObservability:
    """One driver run's observability plane: recorder, SLO tracker and
    HTTP server, built from the parsed args. Lifecycle::

        obs = DriverObservability(args, out_dir).start()
        try:
            ...  # the run; obs.add_status_provider() as components come up
            obs.finish(summary)      # slo/observability metrics.json blocks
        except BaseException as e:
            obs.dump_fault(e)        # flight.json evidence, then re-raise
            raise
        finally:
            obs.stop()

    ``heartbeat_s`` (the training driver passes 1.0) keeps liveness
    gauges, registry deltas and SLO evaluation ticking between scrapes;
    the scoring driver leaves it None.
    """

    def __init__(self, args, out_dir: Path,
                 heartbeat_s: Optional[float] = None,
                 role: str = "process"):
        self.out_dir = Path(out_dir)
        self.role = role
        self.flight_path = self.out_dir / "flight.json"
        self.recorder: Optional[FlightRecorder] = (
            FlightRecorder(max_events=args.flight_events)
            if args.flight_events > 0 else None)
        self.slo_tracker: Optional[SLOTracker] = (
            SLOTracker(args.slo) if args.slo else None)
        self.server: Optional[ObservabilityServer] = None
        if args.obs_port is not None:
            self.server = ObservabilityServer(
                port=args.obs_port, recorder=self.recorder,
                slo_tracker=self.slo_tracker, heartbeat_s=heartbeat_s,
                dump_path=self.flight_path, role=role,
                slo_specs=args.slo or [])
        self._restore_sigterm: Optional[Callable[[], None]] = None
        self._fault_dumped = False
        # Computed-gauge refreshers (--distmon): kept here so finish()
        # refreshes them before the final SLO evaluation with or without
        # a server, and registered with the server so live scrapes and
        # heartbeat ticks refresh them too.
        self._scrape_hooks: Dict[str, Callable[[], None]] = {}

    def start(self) -> "DriverObservability":
        if self.recorder is not None:
            self.recorder.install()
            self._restore_sigterm = install_sigterm_dump(
                self.recorder, self.flight_path)
        if self.server is not None:
            self.server.start()
            # Announce the bound port the moment it exists, so a harness
            # that launched this driver scrapes the live run.
            write_obs_descriptor(self.out_dir / "obs_port",
                                 self.server.port, role=self.role)
        return self

    def mark_ready(self, reason: str = "ready") -> None:
        """Flip the /readyz probe true (after model load, or after the
        solve succeeded). No-op without a server."""
        if self.server is not None:
            self.server.set_ready(True, reason)

    def add_sketch_provider(self, name: str,
                            fn: Callable[[], dict]) -> None:
        """Expose mergeable sketch states under /snapshotz for the fleet
        aggregator (no-op without a server)."""
        if self.server is not None:
            self.server.add_sketch_provider(name, fn)

    def add_status_provider(self, name: str,
                            fn: Callable[[], dict]) -> None:
        """Expose a component's stats() under /statusz (no-op without a
        server)."""
        if self.server is not None:
            self.server.add_status_provider(name, fn)

    def add_dist_provider(self, name: str,
                          fn: Callable[[], dict]) -> None:
        """Expose a distribution snapshot under /distz (no-op without a
        server; metrics.json carries the final snapshot either way)."""
        if self.server is not None:
            self.server.add_distribution_provider(name, fn)

    def add_scrape_hook(self, name: str,
                        fn: Callable[[], None]) -> None:
        """Register a computed-gauge refresher: it runs before every live
        scrape and heartbeat tick (when a server is up) and once in
        :meth:`finish` before the final SLO evaluation."""
        self._scrape_hooks[name] = fn
        if self.server is not None:
            self.server.add_scrape_hook(name, fn)

    def dump_fault(self, exc: BaseException, logger=None) -> None:
        """Unhandled-fault hook: leave flight.json evidence. SystemExit
        is an intentional CLI exit, so it dumps nothing; everything else
        (KeyboardInterrupt included) dumps. A fault carrying a
        ``trace_id`` (the divergence watchdog's SolverDivergedError) tags
        the dump with it."""
        if (self.recorder is None or self._fault_dumped
                or isinstance(exc, SystemExit)):
            return
        try:
            self.recorder.dump(self.flight_path,
                               reason=f"fault:{type(exc).__name__}",
                               trace_id=getattr(exc, "trace_id", None))
            self._fault_dumped = True
            if logger is not None:
                logger.error("flight recorder dumped to %s (%s)",
                             self.flight_path, type(exc).__name__)
        except OSError:  # evidence is best-effort; the fault re-raises
            pass

    def finish(self, summary: Dict) -> Dict:
        """Attach the ``slo`` and ``observability`` metrics.json blocks.
        Raises RuntimeError when any live scrape failed during the run."""
        for fn in self._scrape_hooks.values():
            fn()  # final refresh: the slo block judges fresh gauges
        if self.slo_tracker is not None:
            summary["slo"] = self.slo_tracker.evaluate()
        if self.server is not None:
            # Final-scrape handshake: if a fleet aggregator has been
            # polling /snapshotz, hold the plane up (bounded) until one
            # more full snapshot renders after the refresh above.
            self.server.await_final_scrape(timeout_s=2.0)
            failures = self.server.failures()
            if failures:
                raise RuntimeError(
                    f"observability scrapes failed during the run: "
                    f"{failures}")
        if self.server is not None or self.recorder is not None:
            summary["observability"] = {
                "server": (self.server.summary()
                           if self.server is not None else None),
                "flight_recorder": (self.recorder.stats()
                                    if self.recorder is not None else None),
                "flight_path": (str(self.flight_path)
                                if self.recorder is not None
                                and self.recorder.dumps > 0 else None),
                "trace_tail": trace_tail().counters(),
            }
        return summary

    def stop(self) -> None:
        """Idempotent teardown: restore SIGTERM, stop the server, detach
        the recorder from the process tracer."""
        if self._restore_sigterm is not None:
            self._restore_sigterm()
            self._restore_sigterm = None
        if self.server is not None:
            self.server.stop()
        if self.recorder is not None:
            self.recorder.uninstall()
