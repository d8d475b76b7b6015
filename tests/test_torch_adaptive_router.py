"""The port's SLO-adaptive admission (photon_ml_tpu_torch/serving/
adaptive.py) and replica router (serving/router.py, cli/net_router.py)
on the CPU, against the JAX package's:

- adaptive parity: one burn sequence, fed through the ``burn_fn`` seam
  into JAX's and the port's controllers over the same fake knobs, gives
  the same ``(max_pending, coalesce_window_s)`` after every tick and the
  same ``stats()``, for JAX's config and two others; the same latency
  observations and counter increments in both registries give the same
  per-tick ``WindowedBurn`` values; the dry run and the config checks
  behave as in JAX; the background loop ticks and stops;
- the router: byte-transparent against a direct connection to a port
  ``NetServer`` (requests one at a time, each scored alone in a bucket
  of its own on either replica) and within 1e-10 of JAX's scores when
  pipelined across both replicas; one connection per backend however
  many clients race a cold router (a JAX test of this hangs on Python
  3.12); a dying backend answered with typed ``internal`` errors and
  reconnected; malformed magic and oversized frames rejected; the CLI
  with JAX's flags, address parsing and SystemExit messages, on a
  thread; and the router's process imports no torch.

Every event loop runs under ``asyncio.wait_for`` with its own timeout,
every thread is joined under one, and every server, connection and
subprocess is closed or awaited.
"""

import asyncio
import importlib
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from photon_ml_tpu import telemetry as jax_telemetry
from photon_ml_tpu.cli import net_router as jax_net_router
from photon_ml_tpu.serving import AdaptiveAdmission as JaxAdaptive
from photon_ml_tpu.serving import AdaptiveAdmissionConfig as JaxConfig
from photon_ml_tpu.serving import WindowedBurn as JaxBurn
from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.cli import net_router
from photon_ml_tpu_torch.serving import (
    AdaptiveAdmission,
    AdaptiveAdmissionConfig,
    NetServer,
    ReplicaRouter,
    RouterConfig,
    ServerError,
    WindowedBurn,
)
from photon_ml_tpu_torch.serving import netserver as net
from photon_ml_tpu_torch.serving import wire
from tests import test_torch_netserver as tn
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 60.0
_U4 = wire._U4
run = tn.run


# -- SLO-adaptive admission --------------------------------------------------


class _Knobs:
    """The two attributes the controller actuates."""

    def __init__(self, max_pending=64, window=0.002):
        self.max_pending = max_pending
        self.coalesce_window_s = window


#: tests/test_netserver.py's burn sequence (tighten twice, dead band,
#: quiet streaks broken and completed, relax to the baseline, quiet at
#: the baseline, sustained overload to the floors and caps).
BURNS = [2.0, 1.5, 0.7, 0.1, 0.1, 0.1, 0.1,
         0.1, 0.1, 0.1, 0.7, 0.1, 0.1, 0.1, 0.1,
         *([None] * 40), *([0.0] * 8), *([5.0] * 12),
         0.6, *([None] * 10), 1.0, 0.5, 0.49, 3.0]


@pytest.mark.parametrize("knobs,cfg", [
    ((64, 0.002), {}),
    ((1000, 0.0), dict(relax_ticks=2, tighten_factor=0.25)),
    ((7, 0.01), dict(high_burn=2.0, low_burn=1.0, window_cap_s=0.02,
                     relax_factor=2.0, min_pending=3)),
], ids=["jax", "drain-window", "custom"])
def test_adaptive_trajectory_equals_jax(knobs, cfg):
    mine_k, theirs_k = _Knobs(*knobs), _Knobs(*knobs)
    seq = iter(BURNS)
    burns = []

    def next_burn():
        burns.append(next(seq))
        return burns[-1]

    mine = AdaptiveAdmission(mine_k, burn_fn=next_burn,
                             config=AdaptiveAdmissionConfig(**cfg))
    theirs = JaxAdaptive(theirs_k, burn_fn=lambda: burns[-1],
                         config=JaxConfig(**cfg))
    for _ in BURNS:
        assert mine.tick() == theirs.tick()
        assert (mine_k.max_pending, mine_k.coalesce_window_s) == \
            (theirs_k.max_pending, theirs_k.coalesce_window_s)
        assert mine.stats() == theirs.stats()
    st = mine.stats()
    assert st["ticks"] == len(BURNS)
    assert st["tightens"] > 0 and st["relaxes"] > 0


def test_adaptive_law_as_jax_states_it():
    """tests/test_netserver.py's own checkpoints of the law, on the
    port."""
    burns = []
    fe = _Knobs()
    ctl = AdaptiveAdmission(fe, burn_fn=lambda: burns.pop(0))

    def feed(*seq):
        burns.extend(seq)
        while burns:
            ctl.tick()

    feed(2.0)
    assert fe.max_pending == 32
    assert fe.coalesce_window_s == pytest.approx(0.003)
    feed(1.5, 0.7, 0.1, 0.1, 0.1)
    assert fe.max_pending == 16 and ctl.stats()["relaxes"] == 0
    feed(0.1)
    assert fe.max_pending == 20
    feed(*([None] * 40))
    assert (fe.max_pending, fe.coalesce_window_s) == (64, 0.002)
    feed(*([5.0] * 12))
    assert fe.max_pending == 1
    assert fe.coalesce_window_s == pytest.approx(0.05)


def test_adaptive_dry_run_and_validation():
    fe = _Knobs()
    ctl = AdaptiveAdmission(fe, burn_fn=lambda: 9.9,
                            config=AdaptiveAdmissionConfig(apply=False))
    jfe = _Knobs()
    jctl = JaxAdaptive(jfe, burn_fn=lambda: 9.9,
                       config=JaxConfig(apply=False))
    for _ in range(5):
        ctl.tick()
        jctl.tick()
    st = ctl.stats()
    assert st == jctl.stats()
    assert st["ticks"] == 5 and st["tightens"] == 5
    assert st["apply"] is False and st["last_burn"] == 9.9
    assert (fe.max_pending, fe.coalesce_window_s) == (64, 0.002)
    for cls in (AdaptiveAdmission, JaxAdaptive):
        with pytest.raises(ValueError, match="needs slo_specs"):
            cls(_Knobs())
        with pytest.raises(ValueError, match="needs slo_specs"):
            cls(_Knobs(), slo_specs=[])
    assert [f.name for f in AdaptiveAdmissionConfig.__dataclass_fields__
            .values()] == [f.name for f in
                           JaxConfig.__dataclass_fields__.values()]
    assert AdaptiveAdmissionConfig() == AdaptiveAdmissionConfig(
        **JaxConfig().__dict__)


def test_windowed_burn_equals_jax():
    """Per-tick burn over a latency, a ratio and a value objective, the
    same observations fed to both registries: equal every tick, and
    only this tick's traffic counts."""
    specs = ["p99:adaptive.t.lat_seconds<=10ms",
             "ratio:adaptive.t.rej/adaptive.t.adm<=0.1",
             "value:adaptive.t.psi<=2"]
    ticks = [
        [("lat", 0.001, 100)], [], [("lat", 1.0, 50)],
        [("adm", 100), ("rej", 50)], [("adm", 100)],
        [("lat", 0.004, 30), ("lat", 0.02, 3), ("adm", 10), ("rej", 1)],
        [("psi", 5.0)], [("psi", 1.0), ("lat", 0.0099, 7)], []]
    mods = (telemetry, jax_telemetry)
    for m in mods:
        m.reset()
        m.enable()
    try:
        mine, theirs = WindowedBurn(specs), JaxBurn(specs)
        got = []
        for events in ticks:
            for m in mods:
                for ev in events:
                    if ev[0] == "lat":
                        m.histogram("adaptive.t.lat_seconds").observe(
                            ev[1], n=ev[2])
                    elif ev[0] == "psi":
                        m.gauge("adaptive.t.psi").set(ev[1])
                    else:
                        m.counter(f"adaptive.t.{ev[0]}").inc(ev[1])
            got.append((mine.measure(), theirs.measure()))
    finally:
        for m in mods:
            m.disable()
            m.reset()
    assert [a for a, _ in got] == [b for _, b in got]
    assert got[1][0] is None and got[3][0] == pytest.approx(5.0)
    assert got[2][0] > 1.0 and got[6][0] == pytest.approx(2.5)


def test_adaptive_loop_ticks_and_stops():
    """start() ticks on the loop until stop(); a tick that raises fails
    stop() with its error (nothing swallowed)."""

    async def main():
        fe = _Knobs()
        ctl = await AdaptiveAdmission(
            fe, burn_fn=lambda: 3.0,
            config=AdaptiveAdmissionConfig(interval_s=0.005)).start()
        with pytest.raises(RuntimeError, match="already started"):
            await ctl.start()
        while ctl.stats()["ticks"] < 3:
            await asyncio.sleep(0.005)
        await ctl.stop()
        await ctl.stop()
        ticks = ctl.stats()["ticks"]
        await asyncio.sleep(0.03)
        assert ctl.stats()["ticks"] == ticks and fe.max_pending < 64

        def boom():
            raise ValueError("burn source failed")

        bad = await AdaptiveAdmission(
            _Knobs(), burn_fn=boom,
            config=AdaptiveAdmissionConfig(interval_s=0.005)).start()
        await asyncio.sleep(0.05)
        with pytest.raises(ValueError, match="burn source failed"):
            await bad.stop()

    run(main())


# -- replica router ----------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    return tn.Model()


async def _raw_response(reader) -> bytes:
    head = await reader.readexactly(8)
    (n,) = _U4.unpack(head[4:])
    return head + await reader.readexactly(n)


def test_router_is_byte_transparent(model):
    """Through the router, a request's response frame is the bytes a
    direct connection to a replica gets, and pipelined frames spread
    over both replicas, come back in request order and score as JAX's
    GameModel within 1e-10."""
    fes = [model.frontend(), model.frontend()]
    reqs = tn.singles(900, 10)

    async def main():
        async with fes[0], fes[1]:
            servers = [await NetServer(f).start() for f in fes]
            router = await ReplicaRouter(
                [("127.0.0.1", s.port) for s in servers]).start()
            try:
                conns = [await asyncio.open_connection("127.0.0.1", port)
                         for port in (servers[0].port, router.port)]
                direct, routed = [], []
                for r in reqs:
                    frame = net.encode_request(r.t)
                    for (rd, wr), out in zip(conns, (direct, routed)):
                        wr.write(frame)
                        await wr.drain()
                        out.append(await _raw_response(rd))
                rd, wr = conns[1]
                wr.write(b"".join(net.encode_request(r.t) for r in reqs))
                await wr.drain()
                piped = [await wire.read_binary_response(rd) for _ in reqs]
                for _, wr in conns:
                    wr.close()
            finally:
                await router.close()
                for s in servers:
                    await s.close()
            return direct, routed, piped, router.stats()

    direct, routed, piped, st = run(main())
    assert routed == direct
    for s, j in zip(piped, model.jax_scores(reqs)):
        np.testing.assert_allclose(s, j, rtol=1e-10, atol=1e-10)
    assert st["forwarded"] == st["returned"] == 20
    assert st["backend_errors"] == 0 and st["malformed"] == 0
    spread = [b["forwarded"] for b in st["backends"]]
    assert all(n > 0 for n in spread) and sum(spread) == 20


def _counting_backend(counts, idx, ok):
    async def handle(reader, writer):
        counts[idx] += 1
        try:
            while True:
                head = await reader.readexactly(8)
                (n,) = _U4.unpack(head[4:])
                await reader.readexactly(n)
                writer.write(ok)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()
    return handle


def test_router_cold_start_one_connection_per_backend():
    """Clients racing a cold router open one connection to each backend:
    duplicate connects would start duplicate pumps that tear one
    reader's framing."""

    async def main():
        counts = [0, 0]
        ok = wire.encode_response(np.ones(1, dtype=np.float64))
        backends = [await asyncio.start_server(
            _counting_backend(counts, i, ok), host="127.0.0.1", port=0)
            for i in range(2)]
        router = await ReplicaRouter(
            [("127.0.0.1", s.sockets[0].getsockname()[1])
             for s in backends]).start()
        frame = wire.REQUEST_MAGIC + _U4.pack(4) + b"xxxx"
        per = 25

        async def client():
            r, w = await asyncio.open_connection("127.0.0.1", router.port)
            try:
                w.write(frame * per)
                await w.drain()
                return [await wire.read_binary_response(r)
                        for _ in range(per)]
            finally:
                w.close()

        try:
            results = await asyncio.gather(*[client() for _ in range(8)])
            st = router.stats()
        finally:
            await asyncio.wait_for(router.close(), 10.0)
            for s in backends:
                s.close()
                await asyncio.wait_for(s.wait_closed(), 10.0)
        return results, st, counts

    results, st, counts = run(main())
    assert [len(g) for g in results] == [25] * 8
    assert st["backend_errors"] == 0
    assert st["forwarded"] == st["returned"] == 200
    assert counts == [1, 1]


def test_router_backend_death_is_typed_internal_error():
    async def main():
        async def eat_and_close(reader, writer):
            head = await reader.readexactly(8)
            (n,) = _U4.unpack(head[4:])
            await reader.readexactly(n)
            writer.close()  # dies without answering

        backend = await asyncio.start_server(eat_and_close,
                                             host="127.0.0.1", port=0)
        router = await ReplicaRouter(
            [("127.0.0.1", backend.sockets[0].getsockname()[1])]).start()
        try:
            frame = wire.REQUEST_MAGIC + _U4.pack(4) + b"xxxx"
            errs = []
            r, w = await asyncio.open_connection("127.0.0.1", router.port)
            for _ in range(2):  # the second request reconnects
                w.write(frame)
                await w.drain()
                with pytest.raises(ServerError) as ei:
                    await wire.read_binary_response(r)
                errs.append(ei.value)
            w.close()
            return errs, router.stats()
        finally:
            await router.close()
            backend.close()
            await backend.wait_closed()

    errs, st = run(main())
    assert [e.kind for e in errs] == ["internal", "internal"]
    assert "backend connection lost" in errs[0].message
    assert st["backend_errors"] == 2 and st["forwarded"] == 2


def test_router_rejects_malformed_magic_and_oversized_frames():
    async def main():
        async def never_called(reader, writer):
            writer.close()

        backend = await asyncio.start_server(never_called,
                                             host="127.0.0.1", port=0)
        router = await ReplicaRouter(
            [("127.0.0.1", backend.sockets[0].getsockname()[1])],
            RouterConfig(max_body_bytes=1024)).start()
        try:
            r, w = await asyncio.open_connection("127.0.0.1", router.port)
            w.write(b"GET /score HTTP/1.1\r\n\r\n")  # HTTP at the router
            await w.drain()
            with pytest.raises(ServerError) as ei:
                await wire.read_binary_response(r)
            assert ei.value.kind == "malformed"
            assert await r.read() == b""
            w.close()
            r, w = await asyncio.open_connection("127.0.0.1", router.port)
            w.write(wire.REQUEST_MAGIC + _U4.pack(1 << 20))
            await w.drain()
            with pytest.raises(ServerError) as ei:
                await wire.read_binary_response(r)
            assert ei.value.kind == "too_large"
            w.close()
            return router.stats()
        finally:
            await router.close()
            backend.close()
            await backend.wait_closed()

    st = run(main())
    assert st["malformed"] == 2 and st["forwarded"] == 0
    with pytest.raises(ValueError, match="at least one backend"):
        ReplicaRouter([])
    with pytest.raises(ValueError, match="unknown policy"):
        ReplicaRouter([("h", 1)], RouterConfig(policy="random"))


def test_net_router_cli_on_a_thread(tmp_path):
    """The CLI with JAX's flags: --port-file announces the port, frames
    pass through to the backend, --serve-seconds ends the run with its
    stats; addresses parse as JAX's do, with JAX's SystemExit."""
    for addr in ("7001", ":7001", "h:7001", "a:b:7001", " 9 "):
        for flag in ("--listen", "--backend"):
            assert net_router._parse_addr(addr, flag) == \
                jax_net_router._parse_addr(addr, flag)
    for bad in ("x", "h:", "h:p"):
        with pytest.raises(SystemExit) as mine:
            net_router._parse_addr(bad, "--backend")
        with pytest.raises(SystemExit) as theirs:
            jax_net_router._parse_addr(bad, "--backend")
        assert str(mine.value) == str(theirs.value)
    port_file = tmp_path / "router_port"
    result = {}

    async def main():
        counts = [0]
        ok = wire.encode_response(np.arange(3, dtype=np.float32))
        backend = await asyncio.start_server(
            _counting_backend(counts, 0, ok), host="127.0.0.1", port=0)
        port = backend.sockets[0].getsockname()[1]

        def serve():
            result["stats"] = net_router.run(
                ["--listen", "127.0.0.1:0", "--backend", f":{port}",
                 "--policy", "round_robin", "--port-file", str(port_file),
                 "--serve-seconds", "1.0"])

        thread = threading.Thread(target=serve, daemon=True)
        thread.start()
        try:
            deadline = time.monotonic() + 20
            while not (port_file.exists() and port_file.read_text()):
                assert time.monotonic() < deadline, "no --port-file"
                await asyncio.sleep(0.01)
            r, w = await asyncio.open_connection(
                "127.0.0.1", int(port_file.read_text()))
            w.write((wire.REQUEST_MAGIC + _U4.pack(2) + b"ab") * 3)
            await w.drain()
            got = [await wire.read_binary_response(r) for _ in range(3)]
            w.close()
        finally:
            await asyncio.get_running_loop().run_in_executor(
                None, thread.join, 20)
            backend.close()
            await backend.wait_closed()
        assert not thread.is_alive()
        return got, counts

    got, counts = run(main())
    assert all(g.tobytes() == np.arange(3, dtype=np.float32).tobytes()
               for g in got)
    assert counts == [1]
    st = result["stats"]
    assert st["forwarded"] == st["returned"] == 3
    assert st["policy"] == "round_robin" and st["port"] is None


def test_router_process_imports_no_torch():
    code = ("import sys\n"
            "import photon_ml_tpu_torch.cli.net_router\n"
            "import photon_ml_tpu_torch.serving.router\n"
            "from photon_ml_tpu_torch.serving import ReplicaRouter\n"
            "print(sorted(m for m in ('torch', 'scipy', 'jax')"
            " if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_router_metric_names_equal_jax():
    importlib.import_module("photon_ml_tpu.serving.router")  # registers

    def names(reg):
        return {n for n in reg.snapshot()["counters"]
                if n.startswith("serving.router.")}

    assert names(telemetry.registry()) == names(
        jax_telemetry.registry()) == {
        "serving.router.forwarded", "serving.router.returned",
        "serving.router.backend_errors"}
