"""Driver-side wiring of the flight recorder, shared by the GAME training
and scoring drivers (port of photon_ml_tpu/cli/obs.py: the observability
flags :46-80 and the part of DriverObservability :83-250 that needs no
server).

- ``--flight-events N`` (default 4096; 0 disables) installs a
  :class:`FlightRecorder`: the last N completed spans and periodic
  registry deltas, dumped to ``<output-dir>/flight.json`` on an
  unhandled driver fault and on SIGTERM. It is on by default: it exists
  for the fault nobody armed ``--trace-out`` for, and its per-span cost
  is one short-lock append on stage-granularity events.
- ``--obs-port`` (the live HTTP plane) and ``--slo`` (objectives and
  burn rates) are ROADMAP A5c and raise; metrics.json's
  ``observability`` block carries ``server`` None.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional

from photon_ml_tpu_torch.telemetry import (
    FlightRecorder,
    install_sigterm_dump,
    trace_tail,
)


def add_observability_args(p) -> None:
    """Attach the shared observability flags to a driver parser."""
    p.add_argument("--obs-port", type=int, default=None, metavar="PORT",
                   help="live observability plane (ROADMAP A5c; raises)")
    p.add_argument("--flight-events", type=int, default=4096, metavar="N",
                   help="flight-recorder ring size: the last N completed "
                        "spans + periodic registry deltas, dumped to "
                        "<output-dir>/flight.json on an unhandled driver "
                        "fault and on SIGTERM (Perfetto-loadable). 0 "
                        "disables the recorder")
    p.add_argument("--slo", action="append", default=None, metavar="SPEC",
                   help="latency/availability objective (ROADMAP A5c; "
                        "raises)")


#: dest -> (flag, default, ROADMAP queue item) of the observability flags
#: that still raise (cli/__init__.reject_later_flags).
OBSERVABILITY_FLAGS = {
    "obs_port": ("--obs-port", None, "A5c"),
    "slo": ("--slo", None, "A5c"),
}


class DriverObservability:
    """One driver run's flight recorder, built from the parsed args.
    Lifecycle::

        obs = DriverObservability(args, out_dir).start()
        try:
            ...  # the run
            obs.finish(summary)      # the observability metrics.json block
        except BaseException as e:
            obs.dump_fault(e)        # flight.json evidence, then re-raise
            raise
        finally:
            obs.stop()
    """

    def __init__(self, args, out_dir: Path):
        self.out_dir = Path(out_dir)
        self.flight_path = self.out_dir / "flight.json"
        self.recorder: Optional[FlightRecorder] = (
            FlightRecorder(max_events=args.flight_events)
            if args.flight_events > 0 else None)
        self._restore_sigterm: Optional[Callable[[], None]] = None
        self._fault_dumped = False

    def start(self) -> "DriverObservability":
        if self.recorder is not None:
            self.recorder.install()
            self._restore_sigterm = install_sigterm_dump(
                self.recorder, self.flight_path)
        return self

    def dump_fault(self, exc: BaseException, logger=None) -> None:
        """Unhandled-fault hook: leave flight.json evidence. SystemExit
        is an intentional CLI exit, so it dumps nothing; everything else
        (KeyboardInterrupt included) dumps. The span context managers
        have already unwound through the failing stage, so the ring's
        last events cover it. A fault carrying a ``trace_id`` (the
        divergence watchdog's SolverDivergedError) tags the dump with
        it; the dump's ``flight.traces`` block holds that solve's
        tail-kept timeline."""
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
        """Attach the ``observability`` metrics.json block."""
        if self.recorder is not None:
            summary["observability"] = {
                "server": None,
                "flight_recorder": self.recorder.stats(),
                "flight_path": (str(self.flight_path)
                                if self.recorder.dumps > 0 else None),
                "trace_tail": trace_tail().counters(),
            }
        return summary

    def stop(self) -> None:
        """Idempotent teardown: restore SIGTERM, detach the recorder from
        the process tracer."""
        if self._restore_sigterm is not None:
            self._restore_sigterm()
            self._restore_sigterm = None
        if self.recorder is not None:
            self.recorder.uninstall()
