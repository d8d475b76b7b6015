"""Run a fleet observability aggregator (port of
photon_ml_tpu/cli/obs_aggregate.py:1-113; ``python -m
photon_ml_tpu_torch.cli.obs_aggregate``).

Discovers peer processes (training children, serving replicas) via
explicit ``--peers`` URLs and/or ``--peer-dirs`` output directories
containing ``obs_port`` descriptors, polls their ``/snapshotz`` on an
interval, and serves the MERGED ``/metrics``, ``/statusz``, ``/tracez``,
``/distz`` and ``/snapshotz`` (telemetry/federation.py semantics:
counters sum, histogram buckets add exactly, gauges by declared policy,
sketches via their deterministic merges, SLOs re-judged fleet-wide).

A dead peer degrades the plane (marked stale, last snapshot retained,
``fleet.peer.<id>.stale`` on ``/metrics``); ``/readyz`` answers 503
until at least one peer is fresh. ``Ctrl-C`` or ``--duration`` ends the
run; a final fleet summary JSON is written to ``--output-dir``.

Examples::

    python -m photon_ml_tpu_torch.cli.obs_aggregate \
        --peer-dirs out/replicas --port 9009
    python -m photon_ml_tpu_torch.cli.obs_aggregate \
        --peers http://127.0.0.1:9100 \
        --peers http://127.0.0.1:9101 --interval 1 --duration 30
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from photon_ml_tpu_torch.telemetry import write_obs_descriptor
from photon_ml_tpu_torch.telemetry.federation import FleetAggregator


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon-obs-aggregate",
        description="Fleet observability aggregator: merge the live "
                    "planes of N peer processes into one pane of "
                    "glass")
    p.add_argument("--peers", action="append", default=[],
                   metavar="URL",
                   help="peer base URL (e.g. http://127.0.0.1:9100); "
                        "repeatable")
    p.add_argument("--peer-dirs", action="append", default=[],
                   metavar="DIR",
                   help="directory scanned (itself + one level of "
                        "subdirectories) every poll for obs_port "
                        "descriptor files; repeatable — late-booting "
                        "children are picked up automatically")
    p.add_argument("--port", type=int, default=0, metavar="PORT",
                   help="serve the merged plane on 127.0.0.1:PORT "
                        "(default 0 = ephemeral, announced in "
                        "<output-dir>/obs_port)")
    p.add_argument("--interval", type=float, default=2.0, metavar="S",
                   help="seconds between snapshot polls (default 2)")
    p.add_argument("--stale-after", type=float, default=None,
                   metavar="S",
                   help="seconds without a successful scrape before a "
                        "peer is stale (default 3x --interval)")
    p.add_argument("--timeout", type=float, default=2.0, metavar="S",
                   help="per-peer scrape timeout (default 2)")
    p.add_argument("--duration", type=float, default=None, metavar="S",
                   help="exit after S seconds (default: run until "
                        "interrupted)")
    p.add_argument("--output-dir", type=Path, default=Path("obs_fleet"),
                   metavar="DIR",
                   help="where obs_port and the final fleet summary "
                        "land (default ./obs_fleet)")
    return p


def run(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if not args.peers and not args.peer_dirs:
        build_parser().error("need at least one --peers URL or "
                             "--peer-dirs directory")
    args.output_dir.mkdir(parents=True, exist_ok=True)
    agg = FleetAggregator(
        peers=args.peers, peer_dirs=args.peer_dirs,
        interval_s=args.interval, stale_after_s=args.stale_after,
        port=args.port, timeout_s=args.timeout)
    agg.start()
    write_obs_descriptor(args.output_dir / "obs_port", agg.port,
                         role="aggregator")
    print(f"fleet aggregator on http://127.0.0.1:{agg.port} "
          f"(interval {args.interval:g}s; merged /metrics /statusz "
          f"/tracez /distz /snapshotz)", file=sys.stderr)
    t_end = (time.monotonic() + args.duration
             if args.duration is not None else None)
    try:
        while t_end is None or time.monotonic() < t_end:
            time.sleep(min(args.interval,
                           1.0 if t_end is None
                           else max(0.0, t_end - time.monotonic())))
    except KeyboardInterrupt:
        pass
    finally:
        summary = agg.summary()
        agg.stop()
        out = args.output_dir / "fleet_summary.json"
        out.write_text(json.dumps(summary, indent=2) + "\n")
        print(f"fleet summary written to {out}", file=sys.stderr)
    return summary


def main() -> None:
    run()


if __name__ == "__main__":
    main()
