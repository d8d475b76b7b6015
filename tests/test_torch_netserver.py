"""The port's network front door (photon_ml_tpu_torch/serving/
netserver.py and wire.py) on the CPU at float64, against the JAX
package's (photon_ml_tpu/serving/netserver.py):

- codec parity: the same numpy-seeded datasets give the same request
  frame bytes, response frame bytes and JSON payloads in both packages,
  each package decodes the other's frames to equal datasets, and
  malformed payloads raise the same error classes with the same
  messages;
- wire against in-process: scores over either framing are the same
  bytes as the port front-end's own ``score`` of the same request (its
  dispatch thread scores both, so torch's per-thread settings match),
  and within 1e-10 of JAX's ``GameModel.score`` (JAX's tolerance,
  tests/test_netserver.py:524-525);
- every edge case of tests/test_netserver.py on the port: malformed
  frames never poison window-mates, bad magic is fatal, oversized frames
  and bodies, slowloris in both framings, a disconnect mid-request, shed
  and unknown model typed in both framings, HTTP keep-alive and
  ``Connection: close``, and ``close`` draining an in-flight request and
  then sending EOF (the JAX test of that hangs on Python 3.12: its close
  awaits ``wait_closed()`` before it wakes the readers).

The model and data are JAX's ``_game_model`` and ``_dataset``
(tests/test_netserver.py:71-104), carried to the port by its converter.
Every test's event loop runs under ``asyncio.wait_for`` with a timeout
of its own, and every server and connection it opens is closed.
"""

import asyncio
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu import telemetry as jax_telemetry
from photon_ml_tpu.data.game_data import GameDataset as JaxGameDataset
from photon_ml_tpu.serving import netserver as jnet
from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.serving import (
    BucketLadder,
    FrontendConfig,
    NetClient,
    NetServer,
    NetServerConfig,
    ServerError,
    ServingFrontend,
)
from photon_ml_tpu_torch.serving import netserver as net
from photon_ml_tpu_torch.serving import wire
from tests import test_torch_serving as ts
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

TIMEOUT_S = 60.0
LADDER = dict(min_rows=8, max_rows=64)
_U4 = wire._U4


def run(coro, timeout=TIMEOUT_S):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class Model:
    """JAX's _game_model on a 60-row _dataset (seed 20260729, the rng
    fixture's), as the JAX model (``j``) and the port's (``t``)."""

    def __init__(self):
        rng = np.random.default_rng(20260729)
        train = ts.dataset(rng, n=60)
        self.j = ts._jax_model(rng, train.j)
        self.t = ts.to_port(self.j)

    def frontend(self, **cfg):
        return ServingFrontend(
            {"default": self.t}, dtype=torch.float64,
            ladder=BucketLadder(**LADDER), device="cpu",
            config=FrontendConfig(**{"coalesce_window_s": 0.001,
                                     "max_pending": 256, **cfg}))

    def jax_scores(self, pairs):
        """JAX's GameModel.score of the requests, in one call on their
        rows stacked (one shape to compile)."""
        rows = np.cumsum([0] + [p.num_rows for p in pairs])
        cols = _stack(pairs)
        got = np.asarray(self.j.score(JaxGameDataset.build(**cols)))
        return [got[a:b] for a, b in zip(rows[:-1], rows[1:])]


def _stack(pairs):
    """The raw columns of the port datasets of ``pairs``, stacked."""
    ds = [p.t for p in pairs]
    return dict(
        responses=np.concatenate([d.responses for d in ds]),
        feature_shards={k: sp.vstack([d.feature_shards[k] for d in ds])
                        for k in ds[0].feature_shards},
        ids={k: np.concatenate([np.asarray(d.id_columns[k].vocabulary)[
            d.id_columns[k].codes] for d in ds])
            for k in ds[0].id_columns})


@pytest.fixture(scope="module")
def model():
    return Model()


def singles(seed0, k, n=1):
    return [ts.dataset(seed0 + i, n=n) for i in range(k)]


def _assert_same_dataset(a, b):
    """Two datasets (either package's) hold the same columns, bit for
    bit."""
    assert a.num_rows == b.num_rows
    assert sorted(a.feature_shards) == sorted(b.feature_shards)
    for name in a.feature_shards:
        x, y = a.feature_shards[name].tocsr(), b.feature_shards[name].tocsr()
        assert x.shape == y.shape
        np.testing.assert_array_equal(x.indptr, y.indptr)
        np.testing.assert_array_equal(x.indices, y.indices)
        assert np.asarray(x.data, np.float64).tobytes() == \
            np.asarray(y.data, np.float64).tobytes()
    assert sorted(a.id_columns) == sorted(b.id_columns)
    for name in a.id_columns:
        x, y = a.id_columns[name], b.id_columns[name]
        np.testing.assert_array_equal(x.codes, y.codes)
        assert list(x.vocabulary) == list(y.vocabulary)
    for field in ("responses", "offsets", "weights"):
        assert np.asarray(getattr(a, field)).tobytes() == \
            np.asarray(getattr(b, field)).tobytes()


# -- codec parity with JAX ---------------------------------------------------


def _case(kind):
    """(JAX dataset, port dataset) of one codec case: 23 rows with the
    extras; the same without offsets and weights; a shard with no entry;
    and several vocabularies (multi-byte, long and repeated ids)."""
    pair = ts.dataset(np.random.default_rng(41), n=23)
    cols = _stack([pair])
    if kind == "empty_shard":
        cols["feature_shards"]["user"] = sp.csr_matrix((23, 3))
    if kind == "vocabularies":
        rng = np.random.default_rng(42)
        names = np.asarray(["ü-ser", "x" * 300, "7", "", "用户", "a b"])
        cols["ids"] = {"userId": names[rng.integers(0, 6, 23)],
                       "itemId": names[rng.integers(2, 4, 23)],
                       "third": np.asarray(["only"] * 23)}
    j, t = JaxGameDataset.build(**cols), GameDataset.build(**cols)
    if kind == "no_extras":
        j.offsets = j.weights = t.offsets = t.weights = None
    return j, t


CASES = ["extras", "no_extras", "empty_shard", "vocabularies"]


@pytest.mark.parametrize("kind", CASES)
def test_request_frames_and_json_equal_jax(kind):
    j, t = _case(kind)
    frame = net.encode_request(t, model="tenant-a")
    assert frame == jnet.encode_request(j, model="tenant-a")
    assert frame[:4] == wire.REQUEST_MAGIC
    (n,) = _U4.unpack(frame[4:8])
    assert len(frame) == 8 + n
    # Each package decodes the other's frame to the same dataset.
    mine, m1 = net.decode_request(jnet.encode_request(j, "m")[8:])
    theirs, m2 = jnet.decode_request(frame[8:])
    assert m1 == "m" and m2 == "tenant-a"
    _assert_same_dataset(mine, theirs)
    if kind != "no_extras":
        _assert_same_dataset(mine, t)
    body = net.json_payload(t, model="m")
    assert body == jnet.json_payload(j, model="m")
    text = json.dumps(body)
    (a, ma), (b, mb) = (net.dataset_from_json(json.loads(text)),
                        jnet.dataset_from_json(json.loads(text)))
    assert ma == mb == "m"
    _assert_same_dataset(a, b)


def test_response_frames_equal_jax():
    for dt in ("<f8", "<f4"):
        scores = np.arange(5, dtype=np.dtype(dt)) * 0.25
        frame = wire.encode_response(scores)
        assert frame == jnet.encode_response(scores)
        for dec in (wire.decode_response, jnet.decode_response):
            out = dec(frame[8:])
            assert out.dtype == np.dtype(dt)
            assert out.tobytes() == scores.tobytes()
    for kind in list(wire._KIND_CODES) + ["not_a_kind"]:
        err = (kind, "queue full", "t-123")
        frame = wire.encode_response(None, err)
        assert frame == jnet.encode_response(None, err)
        for dec, cls in ((wire.decode_response, ServerError),
                         (jnet.decode_response, jnet.ServerError)):
            with pytest.raises(cls) as ei:
                dec(frame[8:])
            assert ei.value.kind == (kind if kind in wire._KIND_CODES
                                     else "internal")
            assert (ei.value.message, ei.value.trace_id) == \
                ("queue full", "t-123")
    assert wire._KIND_HTTP == jnet._KIND_HTTP


def _bad_payloads():
    good = net.encode_request(ts.dataset(43, n=9).t)[8:]
    meta = json.dumps({"model": "m"}).encode()
    bad_meta = json.dumps({"model": "m", "rows": 5,
                           "shards": [["global", 6, 10]],
                           "ids": [], "extras": []}).encode()
    neg = json.dumps({"model": "m", "rows": -1, "shards": [], "ids": [],
                      "extras": []}).encode()
    extra = json.dumps({"model": "m", "rows": 0, "shards": [], "ids": [],
                        "extras": ["labels"]}).encode()
    spec = json.dumps({"model": "m", "rows": 0, "shards": [["g"]],
                       "ids": [], "extras": []}).encode()
    return [good[:len(good) // 2], good + b"\x00\x00",
            _U4.pack(7) + b"notjson", _U4.pack(len(meta)) + meta,
            _U4.pack(len(bad_meta)) + bad_meta, _U4.pack(len(neg)) + neg,
            _U4.pack(len(extra)) + extra, _U4.pack(len(spec)) + spec,
            b"\x01"]


def _outcome(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return type(e).__name__, str(e)
    return None


def test_malformed_inputs_raise_the_same_errors():
    bodies = [{}, {"rows": 2, "shards": {"g": {"cols": 1}}},
              {"rows": "x"}, {"rows": 3, "ids": {"u": ["a"]}},
              {"rows": 1, "responses": [0.0, 1.0]}]
    for payload in _bad_payloads():
        mine = _outcome(net.decode_request, payload)
        assert mine is not None and mine[0] == "MalformedFrame"
        assert mine == _outcome(jnet.decode_request, payload)
    for body in bodies:
        mine = _outcome(net.dataset_from_json, body)
        assert mine is not None and mine[0] == "MalformedFrame"
        assert mine == _outcome(jnet.dataset_from_json, body)
    for blob, count in ((b"\x05\x00ab", 1), (b"\x01\x00a\x00", 1),
                        (b"\x01", 1)):
        assert _outcome(wire._unpack_str_array, blob, count) == \
            _outcome(jnet._unpack_str_array, blob, count)
    assert _outcome(wire.decode_response, b"\x03not json") == \
        _outcome(jnet.decode_response, b"\x03not json")


# -- wire against in-process -------------------------------------------------


def test_wire_scores_byte_identical_both_framings(model):
    """A framed request gives the same bytes as the front-end's own
    ``score`` of it, over binary (raw array bytes) and HTTP (JSON float
    repr round-trips doubles), and JAX's GameModel.score within 1e-10."""
    fe = model.frontend()
    reqs = singles(300, 5) + [ts.dataset(399, n=20)]

    async def main():
        async with fe:
            want = [np.asarray(await fe.score(r.t)) for r in reqs]
            server = await NetServer(fe).start()
            try:
                async with NetClient("127.0.0.1", server.port) as c:
                    got_bin = [await c.score(r.t) for r in reqs]
                async with NetClient("127.0.0.1", server.port,
                                     framing="http") as c:
                    got_http = [await c.score(r.t) for r in reqs]
            finally:
                await server.close()
            return want, got_bin, got_http, server.stats()

    want, got_bin, got_http, st = run(main())
    for w, b, h, j in zip(want, got_bin, got_http, model.jax_scores(reqs)):
        assert w.dtype == b.dtype == h.dtype == np.float64
        assert w.tobytes() == b.tobytes() == h.tobytes()
        np.testing.assert_allclose(b, j, rtol=1e-10, atol=1e-10)
    assert st["requests_binary"] == 6 and st["requests_http"] == 6
    assert st["responses"] == 12 and st["wire_errors"] == {}
    assert st["open_connections"] == 0 and st["port"] is None


# -- the edge cases of tests/test_netserver.py -------------------------------


def test_malformed_frame_never_poisons_window_mates(model):
    """One pipelined connection puts a malformed payload (honest length,
    garbage meta) between good frames while a second connection scores
    at the same time: the bad frame gets a typed in-order error, every
    good frame on both connections scores, and each counter (local and
    in the registry) ticks as in JAX."""
    fe = model.frontend(coalesce_window_s=0.02)
    goods = singles(500, 5)
    other = ts.dataset(599, n=1)
    bad_payload = _U4.pack(7) + b"badmeta"
    bad_frame = wire.REQUEST_MAGIC + _U4.pack(len(bad_payload)) + bad_payload

    async def main():
        async with fe:
            server = await NetServer(fe).start()
            try:
                r, w = await asyncio.open_connection("127.0.0.1",
                                                     server.port)
                frames = [net.encode_request(d.t) for d in goods[:3]] \
                    + [bad_frame] \
                    + [net.encode_request(d.t) for d in goods[3:]]
                w.write(b"".join(frames))
                await w.drain()

                async def mate():
                    async with NetClient("127.0.0.1", server.port) as c:
                        return await c.score(other.t)

                mate_task = asyncio.ensure_future(mate())
                got = []
                for i in range(6):
                    if i == 3:
                        with pytest.raises(ServerError) as ei:
                            await wire.read_binary_response(r)
                        assert ei.value.kind == "malformed"
                    else:
                        got.append(await wire.read_binary_response(r))
                w.close()
                mate_scores = await mate_task
            finally:
                await server.close()
            return got, mate_scores, server.stats()

    telemetry.reset()
    telemetry.enable()
    try:
        got, mate_scores, st = run(main())
        snap = telemetry.snapshot()["counters"]
    finally:
        telemetry.disable()
        telemetry.reset()
    for s, j in zip(got + [mate_scores],
                    model.jax_scores(goods + [other])):
        np.testing.assert_allclose(s, j, rtol=1e-10, atol=1e-10)
    assert st["wire_errors"] == {"malformed": 1}
    assert st["requests_binary"] == 7  # 5 good, 1 bad, the window-mate
    assert st["responses"] == 6
    assert snap["serving.net.requests_binary"] == 7
    assert snap["serving.net.wire_errors"] == 1
    assert snap["serving.net.errors.malformed"] == 1
    assert snap["serving.net.responses"] == 6
    assert snap["serving.net.connections_opened"] == 2
    assert snap["serving.net.connections_closed"] == 2


def test_binary_bad_magic_is_fatal(model):
    """Garbage where a frame magic should be: the server answers a typed
    malformed frame and closes."""
    fe = model.frontend()

    async def main():
        async with fe:
            server = await NetServer(fe).start()
            try:
                r, w = await asyncio.open_connection("127.0.0.1",
                                                     server.port)
                w.write(wire.REQUEST_MAGIC + _U4.pack(4) + b"\x00" * 4)
                await w.drain()
                with pytest.raises(ServerError) as ei:
                    await wire.read_binary_response(r)
                assert ei.value.kind == "malformed"
                w.write(b"ZZZZ" + _U4.pack(0))
                await w.drain()
                with pytest.raises(ServerError) as ei:
                    await wire.read_binary_response(r)
                assert ei.value.kind == "malformed"
                assert await r.read() == b""  # the server closed
                w.close()
            finally:
                await server.close()
            return server.stats()

    st = run(main())
    assert st["wire_errors"] == {"malformed": 2}
    assert st["open_connections"] == 0


def test_oversized_frame_and_body_rejected(model):
    fe = model.frontend()

    async def main():
        async with fe:
            server = await NetServer(
                fe, NetServerConfig(max_body_bytes=4096)).start()
            try:
                # binary: a declared length over the bound gets a typed
                # too_large and the connection closes unread.
                r, w = await asyncio.open_connection("127.0.0.1",
                                                     server.port)
                w.write(wire.REQUEST_MAGIC + _U4.pack(1 << 20))
                await w.drain()
                with pytest.raises(ServerError) as ei:
                    await wire.read_binary_response(r)
                assert ei.value.kind == "too_large"
                assert await r.read() == b""
                w.close()
                # HTTP: a Content-Length over the bound gets 413, closed.
                r, w = await asyncio.open_connection("127.0.0.1",
                                                     server.port)
                w.write(b"POST /score HTTP/1.1\r\n"
                        b"Content-Length: 1048576\r\n\r\n")
                await w.drain()
                status, body = await wire.read_http_response(r)
                assert status == 413
                assert json.loads(body)["error"] == "too_large"
                assert await r.read() == b""
                w.close()
            finally:
                await server.close()
            return server.stats()

    assert run(main())["wire_errors"] == {"too_large": 2}


def test_slowloris_header_timeout_both_framings(model):
    fe = model.frontend()

    async def main():
        async with fe:
            server = await NetServer(
                fe, NetServerConfig(header_timeout_s=0.15)).start()
            try:
                # binary: the magic arrives, the length head never does.
                r, w = await asyncio.open_connection("127.0.0.1",
                                                     server.port)
                w.write(wire.REQUEST_MAGIC)
                await w.drain()
                with pytest.raises(ServerError) as ei:
                    await wire.read_binary_response(r)
                assert ei.value.kind == "timeout"
                assert await r.read() == b""
                w.close()
                # HTTP: a first byte, then the header stalls.
                r, w = await asyncio.open_connection("127.0.0.1",
                                                     server.port)
                w.write(b"POST /sco")
                await w.drain()
                status, body = await wire.read_http_response(r)
                assert status == 408
                assert json.loads(body)["error"] == "timeout"
                assert await r.read() == b""
                w.close()
            finally:
                await server.close()
            return server.stats()

    assert run(main())["wire_errors"] == {"timeout": 2}


def test_mid_request_disconnect_counted_server_stays_up(model):
    fe = model.frontend()

    async def main():
        async with fe:
            server = await NetServer(fe).start()
            try:
                r, w = await asyncio.open_connection("127.0.0.1",
                                                     server.port)
                # The head promises 100 bytes; 10 arrive, then hang-up.
                w.write(wire.REQUEST_MAGIC + _U4.pack(100) + b"x" * 10)
                await w.drain()
                w.close()
                for _ in range(500):
                    if server.stats()["wire_errors"].get("disconnect"):
                        break
                    await asyncio.sleep(0.01)
                r2, w2 = await asyncio.open_connection("127.0.0.1",
                                                       server.port)
                w2.write(b"GET /healthz HTTP/1.1\r\n"
                         b"Connection: close\r\n\r\n")
                await w2.drain()
                status, body = await wire.read_http_response(r2)
                w2.close()
            finally:
                await server.close()
            return status, json.loads(body), server.stats()

    status, body, st = run(main())
    assert status == 200 and body["status"] == "ok"
    assert body["models"] == ["default"]
    assert st["wire_errors"] == {"disconnect": 1}
    assert st["open_connections"] == 0


def test_shed_and_unknown_model_typed_both_framings(model):
    """Sheds and unknown tenants are typed wire errors (status byte, HTTP
    status), the shed carrying the front-end's trace id; neither closes
    the connection."""
    fe = model.frontend()
    fe.max_pending = 0  # every request sheds at admission
    req = ts.dataset(700, n=1).t

    async def main():
        async with fe:
            server = await NetServer(fe).start()
            errs = []
            try:
                for framing in ("binary", "http"):
                    async with NetClient("127.0.0.1", server.port,
                                         framing=framing) as c:
                        for name in ("default", "nope"):
                            with pytest.raises(ServerError) as ei:
                                await c.score(req, model=name)
                            errs.append(ei.value)
            finally:
                await server.close()
            return errs, server.stats()

    telemetry.reset()
    telemetry.enable(trace=True)  # tracing stamps the shed's trace id
    try:
        (shed_b, unk_b, shed_h, unk_h), st = run(main())
    finally:
        telemetry.disable()
        telemetry.reset()
    assert shed_b.kind == shed_h.kind == "shed"
    assert shed_b.trace_id and shed_h.trace_id
    assert unk_b.kind == unk_h.kind == "unknown_model"
    assert "nope" in unk_b.message and "nope" in unk_h.message
    assert st["wire_errors"] == {"shed": 2, "unknown_model": 2}
    assert st["requests_binary"] == 2 and st["requests_http"] == 2


def test_close_drains_inflight_request_then_eof(model):
    """The drain contract: a request already read off the socket when
    ``close()`` starts settles through the front-end, its response
    reaches the client, then EOF, and close() returns while the client
    still holds its connection."""
    fe = model.frontend(coalesce_window_s=0.25)
    req = ts.dataset(800, n=1)

    async def main():
        async with fe:
            server = await NetServer(fe).start()
            r, w = await asyncio.open_connection("127.0.0.1", server.port)
            idle_r, idle_w = await asyncio.open_connection("127.0.0.1",
                                                           server.port)
            try:
                w.write(net.encode_request(req.t))
                await w.drain()
                await asyncio.sleep(0.05)  # frame read; window still open
                await asyncio.wait_for(server.close(), 10.0)
                scores = await wire.read_binary_response(r)
                assert await r.read() == b""  # then EOF
                assert await idle_r.read() == b""
            finally:
                w.close()
                idle_w.close()
            return scores, server.stats()

    scores, st = run(main())
    (want,) = model.jax_scores([req])
    np.testing.assert_allclose(scores, want, rtol=1e-10, atol=1e-10)
    assert st["responses"] == 1 and st["wire_errors"] == {}
    assert st["open_connections"] == 0 and st["connections_closed"] == 2


def test_http_keepalive_and_connection_close(model):
    fe = model.frontend()

    async def main():
        async with fe:
            server = await NetServer(fe).start()
            try:
                r, w = await asyncio.open_connection("127.0.0.1",
                                                     server.port)
                for _ in range(2):  # keep-alive: two requests, one conn
                    w.write(b"GET /statz HTTP/1.1\r\n\r\n")
                    await w.drain()
                    status, body = await wire.read_http_response(r)
                    assert status == 200
                assert json.loads(body)["net"]["requests_http"] == 2
                assert server.stats()["connections_opened"] == 1
                w.write(b"GET /healthz HTTP/1.1\r\n"
                        b"Connection: close\r\n\r\n")
                await w.drain()
                status, _ = await wire.read_http_response(r)
                assert status == 200
                assert await r.read() == b""  # the server honoured close
                w.close()
                # An unknown path is a 404 and the connection stays.
                r, w = await asyncio.open_connection("127.0.0.1",
                                                     server.port)
                w.write(b"GET /nope HTTP/1.1\r\n\r\n")
                await w.drain()
                status, _ = await wire.read_http_response(r)
                assert status == 404
                w.write(b"GET /healthz HTTP/1.1\r\n\r\n")
                await w.drain()
                status, _ = await wire.read_http_response(r)
                assert status == 200
                w.close()
            finally:
                await server.close()
            return server.stats()

    st = run(main())
    assert st["requests_http"] == 5 and st["open_connections"] == 0


def test_jax_client_against_port_server(model):
    """The JAX package's own client, both framings, against the port's
    server: the wire is one protocol."""
    fe = model.frontend()
    reqs = singles(900, 3)

    async def main():
        async with fe:
            want = [np.asarray(await fe.score(r.t)) for r in reqs]
            server = await NetServer(fe).start()
            got = []
            try:
                for framing in ("binary", "http"):
                    async with jnet.NetClient("127.0.0.1", server.port,
                                              framing=framing) as c:
                        got.append([await c.score(r.j) for r in reqs])
            finally:
                await server.close()
            return want, got

    want, got = run(main())
    for scores in got:
        assert [s.tobytes() for s in scores] == [w.tobytes() for w in want]


def test_net_metric_names_equal_jax():
    """The ``serving.net.*`` names the port registers at import are
    JAX's (the per-kind ``serving.net.errors.<kind>`` counters come with
    a first error)."""

    def names(reg):
        return {n for n in reg.snapshot()["counters"]
                if n.startswith("serving.net.")
                and not n.startswith("serving.net.errors.")}

    mine, theirs = names(telemetry.registry()), names(
        jax_telemetry.registry())
    assert mine == theirs == {
        "serving.net.connections_opened", "serving.net.connections_closed",
        "serving.net.requests_http", "serving.net.requests_binary",
        "serving.net.responses", "serving.net.bytes_read",
        "serving.net.bytes_written", "serving.net.wire_errors"}
