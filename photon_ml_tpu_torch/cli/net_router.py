"""Replica-fleet router CLI: the binary-framing front over N scoring
processes started with ``--listen`` (port of
photon_ml_tpu/cli/net_router.py:1-98; serving/router.py: least-pending
request spreading, pure passthrough).

    python -m photon_ml_tpu_torch.cli.net_router \\
        --listen :7001 --backend 127.0.0.1:7002 --backend 127.0.0.1:7003

The router process imports asyncio, struct, numpy and the port's wire
codec and telemetry registry, never torch, so it holds no CUDA context
while the replicas behind it each hold theirs. ``--port-file`` writes
the bound port (a plain integer) as soon as the listener is up, the
handshake the scoring driver's ``net_port`` file gives a harness. The
router serves until ``--serve-seconds`` run out or SIGINT arrives, then
drains (every forwarded frame is answered) and prints its stats as one
JSON line.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from pathlib import Path
from typing import List, Tuple


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="photon-net-router")
    p.add_argument("--listen", default=":0", metavar="ADDR",
                   help="PORT, :PORT or HOST:PORT (0 = ephemeral; see "
                        "--port-file)")
    p.add_argument("--backend", action="append", required=True,
                   metavar="HOST:PORT",
                   help="a replica's binary-framing address (repeatable; "
                        "at least one)")
    p.add_argument("--policy", choices=["least_pending", "round_robin"],
                   default="least_pending",
                   help="request spreading policy (least_pending breaks "
                        "ties round-robin)")
    p.add_argument("--port-file", default=None, metavar="PATH",
                   help="write the bound port here (plain int) once "
                        "listening")
    p.add_argument("--serve-seconds", type=float, default=None,
                   metavar="S",
                   help="serve for S seconds then drain (default: until "
                        "SIGINT)")
    return p


def _parse_addr(addr: str, flag: str) -> Tuple[str, int]:
    addr = addr.strip()
    if ":" in addr:
        host, _, port = addr.rpartition(":")
        host = host or "127.0.0.1"
    else:
        host, port = "127.0.0.1", addr
    try:
        return host, int(port)
    except ValueError:
        raise SystemExit(f"bad {flag} address {addr!r} "
                         "(PORT, :PORT or HOST:PORT)") from None


def run(argv=None) -> dict:
    """Serve until ``--serve-seconds`` run out or SIGINT; returns the
    router's final stats."""
    from photon_ml_tpu_torch.serving.router import (
        ReplicaRouter,
        RouterConfig,
    )

    args = build_parser().parse_args(argv)
    host, port = _parse_addr(args.listen, "--listen")
    backends: List[Tuple[str, int]] = [
        _parse_addr(b, "--backend") for b in args.backend]
    report = {}

    async def serve() -> None:
        router = await ReplicaRouter(
            backends, RouterConfig(host=host, port=port,
                                   policy=args.policy)).start()
        try:
            if args.port_file:
                Path(args.port_file).write_text(str(router.port))
            if args.serve_seconds is not None:
                await asyncio.sleep(args.serve_seconds)
            else:
                while True:
                    await asyncio.sleep(3600)
        finally:
            await router.close()
            report["router"] = router.stats()

    try:
        asyncio.run(serve())
    except KeyboardInterrupt:
        pass  # SIGINT: serve() drained the router in its finally
    return report.get("router", {})


def main() -> None:
    print(json.dumps(run(sys.argv[1:])), flush=True)


if __name__ == "__main__":
    main()
