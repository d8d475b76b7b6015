"""Network front door for the async serving front-end: one asyncio
listener speaking two framings into the same admission path (port of
photon_ml_tpu/serving/netserver.py: the ``serving.net.*`` metrics
:155-165, encode_request/decode_request :203-339, json_payload/
dataset_from_json :394-448, NetServerConfig :454-466, _Conn :469-485,
NetServer :488-904, NetClient :910-964; the dataset-free codec half,
:67-200 and :342-391 with the response readers :967-990, lives in
wire.py and is re-exported here).

- **HTTP/1.1** (``POST /score``): JSON request -> ``frontend.score()``
  -> JSON response, keep-alive, bounded header and body sizes.
- **length-prefixed binary** (magic ``PNB1``): a small JSON meta header
  (model name, shapes, never feature data) followed by raw little-endian
  numpy buffers (CSR triplets, entity codes, vocabulary blob); scores
  come back as the engine's own array bytes.

Both framings are detected on one port from the first four bytes of a
connection and decode into the same admission path: every request enters
``ServingFrontend.score`` and gets the same coalescing, shed, tenancy
and tracing as an in-process caller. Frames are JAX's bytes.

Wire failures are typed (the ``WireError`` hierarchy) and counted
(``serving.net.errors.<kind>``): a malformed frame, an oversized body, a
stalled header or a mid-request disconnect each give an error on the
offending connection only; a frame that fails to decode never reaches
admission, so its window-mates are never poisoned.

Per-connection backpressure: the binary reader admits at most
``max_inflight_per_connection`` frames before it stops reading the
socket, and every response write awaits ``drain()``. HTTP connections
are strictly sequential (read -> score -> respond).

Nothing blocking runs on the event loop: decode is numpy slicing, and
scoring awaits the front-end's executor hop, on whose thread the bucket
graphs replay and the scores are copied to the host.

``close()`` keeps JAX's drain contract in another order. On Python 3.12
``asyncio.Server.wait_closed()`` waits for every open connection, so
JAX's close (wait_closed first, then EOF to the readers) never returns
while a client holds its connection. The port stops accepting, wakes
the readers with EOF, lets every request already read settle and write
its response, and only then awaits ``wait_closed()``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.data.game_data import EntityIdColumn, GameDataset
from photon_ml_tpu_torch.serving.frontend import (
    RequestRejected,
    ServingFrontend,
    UnknownModelError,
)
from photon_ml_tpu_torch.serving.wire import (  # noqa: F401 (re-exports)
    _HOST_F8,
    _KIND_CODES,
    _KIND_HTTP,
    _U2,
    _U4,
    REQUEST_MAGIC,
    RESPONSE_MAGIC,
    ClientDisconnect,
    FrameTooLarge,
    HeaderTimeout,
    MalformedFrame,
    ServerError,
    WireError,
    _Cursor,
    _pack_str_array,
    _unpack_str_array,
    decode_response,
    encode_response,
    read_binary_response,
    read_http_response,
)

# Process-wide metrics (no-ops while telemetry is off).
_M_CONN_OPENED = telemetry.counter("serving.net.connections_opened")
_M_CONN_CLOSED = telemetry.counter("serving.net.connections_closed")
_M_REQ_HTTP = telemetry.counter("serving.net.requests_http")
_M_REQ_BINARY = telemetry.counter("serving.net.requests_binary")
_M_RESPONSES = telemetry.counter("serving.net.responses")
_M_BYTES_READ = telemetry.counter("serving.net.bytes_read")
_M_BYTES_WRITTEN = telemetry.counter("serving.net.bytes_written")
_M_WIRE_ERRORS = telemetry.counter("serving.net.wire_errors")
_G_OPEN_CONNS = telemetry.gauge("serving.net.open_connections")

#: extras travel as float64 rows-length arrays in this fixed order.
_EXTRA_FIELDS = ("responses", "offsets", "weights")


# -- binary codec ------------------------------------------------------------


def encode_request(data: GameDataset, model: str = "default") -> bytes:
    """One request dataset -> one binary frame. The meta header is small
    JSON (names and counts, never feature data); every numeric column
    rides as raw little-endian bytes in a canonical order."""
    shards = []
    arrays: List[bytes] = []
    for name in sorted(data.feature_shards):
        csr = data.feature_shards[name].tocsr()
        shards.append([name, int(csr.shape[1]), int(csr.nnz)])
        arrays.append(np.ascontiguousarray(csr.data, dtype="<f8").tobytes())
        arrays.append(np.ascontiguousarray(csr.indices,
                                           dtype="<i4").tobytes())
        arrays.append(np.ascontiguousarray(csr.indptr,
                                           dtype="<i4").tobytes())
    ids = []
    for name in sorted(data.id_columns):
        col = data.id_columns[name]
        vocab_blob = _pack_str_array(col.vocabulary)
        ids.append([name, int(len(col.vocabulary)), len(vocab_blob)])
        arrays.append(np.ascontiguousarray(col.codes, dtype="<i4").tobytes())
        arrays.append(vocab_blob)
    extras = []
    for field in _EXTRA_FIELDS:
        arr = getattr(data, field)
        if arr is not None:
            extras.append(field)
            arrays.append(np.ascontiguousarray(arr, dtype="<f8").tobytes())
    meta = json.dumps({
        "model": model,
        "rows": int(data.num_rows),
        "shards": shards,
        "ids": ids,
        "extras": extras,
    }).encode("utf-8")
    payload = b"".join([_U4.pack(len(meta)), meta, *arrays])
    return b"".join([REQUEST_MAGIC, _U4.pack(len(payload)), payload])


def decode_request(payload: bytes) -> Tuple[GameDataset, str]:
    """Inverse of :func:`encode_request` (payload = the frame body after
    magic and length). Raises :class:`MalformedFrame` on anything that
    does not decode into a structurally valid dataset."""
    cur = _Cursor(payload)
    (meta_len,) = _U4.unpack(cur.take(4))
    try:
        meta = json.loads(cur.take(meta_len).decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise MalformedFrame(f"meta is not valid JSON: {e}") from e
    try:
        model = str(meta["model"])
        rows = int(meta["rows"])
        shard_specs = list(meta["shards"])
        id_specs = list(meta["ids"])
        extras = list(meta["extras"])
    except (KeyError, TypeError, ValueError) as e:
        raise MalformedFrame(f"meta schema: {e}") from e
    if rows < 0:
        raise MalformedFrame(f"negative row count {rows}")
    shards: Dict[str, sp.csr_matrix] = {}
    for spec in shard_specs:
        try:
            name, cols, nnz = str(spec[0]), int(spec[1]), int(spec[2])
        except (IndexError, TypeError, ValueError) as e:
            raise MalformedFrame(f"shard spec {spec!r}: {e}") from e
        vals = cur.array("<f8", nnz)
        idx = cur.array("<i4", nnz)
        ptr = cur.array("<i4", rows + 1)
        try:
            shards[name] = sp.csr_matrix((vals, idx, ptr),
                                         shape=(rows, cols))
        except (ValueError, IndexError) as e:
            raise MalformedFrame(f"shard {name!r}: {e}") from e
    id_columns: Dict[str, EntityIdColumn] = {}
    for spec in id_specs:
        try:
            name, n_vocab, blob_len = (str(spec[0]), int(spec[1]),
                                       int(spec[2]))
        except (IndexError, TypeError, ValueError) as e:
            raise MalformedFrame(f"id spec {spec!r}: {e}") from e
        codes = cur.array("<i4", rows)
        vocab = _unpack_str_array(cur.take(blob_len), n_vocab)
        id_columns[name] = EntityIdColumn(
            codes=np.ascontiguousarray(codes, np.int32), vocabulary=vocab)
    fields = {"responses": None, "offsets": None, "weights": None}
    for field in extras:
        if field not in fields:
            raise MalformedFrame(f"unknown extra field {field!r}")
        fields[field] = np.ascontiguousarray(cur.array("<f8", rows),
                                             _HOST_F8)
    cur.done()
    try:
        data = GameDataset(
            responses=(fields["responses"] if fields["responses"]
                       is not None else np.zeros(rows)),
            offsets=(fields["offsets"] if fields["offsets"]
                     is not None else np.zeros(rows)),
            weights=(fields["weights"] if fields["weights"]
                     is not None else np.ones(rows)),
            feature_shards=shards, id_columns=id_columns)
    except ValueError as e:
        raise MalformedFrame(str(e)) from e
    return data, model


# -- JSON (HTTP) codec -------------------------------------------------------


def json_payload(data: GameDataset, model: str = "default") -> dict:
    """Dataset -> the ``POST /score`` JSON body. Entity ids travel as
    per-row strings (the server re-codes them). Floats round-trip
    exactly: Python's repr gives the shortest digits that parse back to
    the same double."""
    shards = {}
    for name, mat in sorted(data.feature_shards.items()):
        csr = mat.tocsr()
        shards[name] = {"cols": int(csr.shape[1]),
                        "data": np.asarray(csr.data, _HOST_F8).tolist(),
                        "indices": csr.indices.tolist(),
                        "indptr": csr.indptr.tolist()}
    ids = {name: np.asarray(col.vocabulary)[col.codes].tolist()
           for name, col in sorted(data.id_columns.items())}
    body = {"model": model, "rows": int(data.num_rows),
            "shards": shards, "ids": ids}
    for field in _EXTRA_FIELDS:
        arr = getattr(data, field)
        if arr is not None:
            body[field] = np.asarray(arr, _HOST_F8).tolist()
    return body


def dataset_from_json(body: dict) -> Tuple[GameDataset, str]:
    """Inverse of :func:`json_payload`; :class:`MalformedFrame` (not
    fatal: the HTTP framing was fine) on a schema violation."""
    try:
        model = str(body.get("model", "default"))
        rows = int(body["rows"])
        shards = {}
        for name, s in dict(body.get("shards", {})).items():
            shards[str(name)] = sp.csr_matrix(
                (np.asarray(s["data"], _HOST_F8),
                 np.asarray(s["indices"], np.int32),
                 np.asarray(s["indptr"], np.int32)),
                shape=(rows, int(s["cols"])))
        ids = {str(k): np.asarray(v)
               for k, v in dict(body.get("ids", {})).items()}
        data = GameDataset.build(
            responses=np.asarray(body.get("responses", np.zeros(rows)),
                                 _HOST_F8),
            feature_shards=shards, ids=ids,
            offsets=body.get("offsets"), weights=body.get("weights"))
    except Exception as e:  # noqa: BLE001 — any schema failure is typed
        raise MalformedFrame(f"request body: {type(e).__name__}: {e}") \
            from e
    if data.num_rows != rows:
        raise MalformedFrame(f"rows={rows} but columns have "
                             f"{data.num_rows}")
    return data, model


# -- server ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NetServerConfig:
    """Listener knobs. Sizes bound what an unauthenticated peer can make
    the process buffer; timeouts bound how long a stalled peer can hold
    a reader (slowloris)."""

    host: str = "127.0.0.1"
    port: int = 0  # 0 = ephemeral; read NetServer.port after start()
    max_header_bytes: int = 16 * 1024
    max_body_bytes: int = 8 * 1024 * 1024
    header_timeout_s: float = 5.0
    body_timeout_s: float = 30.0
    max_inflight_per_connection: int = 32


class _Conn:
    """Per-connection state: the handler task (awaited by close), the
    in-order response queue and the inflight semaphore (binary
    pipelining backpressure)."""

    __slots__ = ("reader", "writer", "task", "queue", "sem")

    def __init__(self, reader, writer, max_inflight: int):
        self.reader = reader
        self.writer = writer
        self.task = asyncio.current_task()
        self.queue: asyncio.Queue = asyncio.Queue()
        self.sem = asyncio.Semaphore(max_inflight)


def _end_of_stream(conn: _Conn) -> None:
    """EOF from within, for close(): the socket is read no further and the
    reader sees the end of its stream, so a reader waiting for the next
    request ends cleanly and one mid-request finishes what it holds."""
    conn.writer.transport.pause_reading()
    conn.reader.feed_eof()


class NetServer:
    """Protocol front door over a started :class:`ServingFrontend` (same
    event loop)::

        async with frontend:
            server = await NetServer(frontend, cfg).start()
            ...
            await server.close()   # drains in-flight requests, then closes

    The server never owns the front-end: close() drains its own
    connections (every request already read settles and its response is
    written) and leaves the front-end running."""

    def __init__(self, frontend: ServingFrontend,
                 config: Optional[NetServerConfig] = None):
        self.frontend = frontend
        self.config = config if config is not None else NetServerConfig()
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()
        self._closing = False
        self._stats = {
            "connections_opened": 0, "connections_closed": 0,
            "requests_http": 0, "requests_binary": 0, "responses": 0,
            "bytes_read": 0, "bytes_written": 0,
        }
        self._wire_errors: Dict[str, int] = {}
        self._m_errors: Dict[str, object] = {}

    # -- lifecycle ---------------------------------------------------------

    @property
    def port(self) -> Optional[int]:
        if self._server is None or not self._server.sockets:
            return None
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> "NetServer":
        if self._server is not None:
            raise RuntimeError("netserver already started")
        self._closing = False
        self._server = await asyncio.start_server(
            self._on_conn, host=self.config.host, port=self.config.port,
            limit=max(self.config.max_header_bytes, 64 * 1024))
        return self

    async def close(self) -> None:
        """Stop accepting, then drain: every request already read off a
        socket settles through the front-end and its response is written
        before its connection closes; readers waiting between requests
        wake with a clean end of stream. ``wait_closed()`` comes last, once
        no connection is left open (module docstring)."""
        if self._server is None:
            return
        self._closing = True
        self._server.close()
        while self._conns:
            conns = list(self._conns)
            for conn in conns:
                _end_of_stream(conn)
            await asyncio.gather(*[c.task for c in conns],
                                 return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    # -- accounting --------------------------------------------------------

    def _count_wire_error(self, kind: str) -> None:
        self._wire_errors[kind] = self._wire_errors.get(kind, 0) + 1
        _M_WIRE_ERRORS.inc()
        m = self._m_errors.get(kind)
        if m is None:
            m = self._m_errors[kind] = telemetry.counter(
                f"serving.net.errors.{kind}")
        m.inc()

    def _wrote(self, n: int) -> None:
        self._stats["bytes_written"] += n
        _M_BYTES_WRITTEN.inc(n)

    def _read_bytes(self, n: int) -> None:
        self._stats["bytes_read"] += n
        _M_BYTES_READ.inc(n)

    def stats(self) -> dict:
        """Always-live local counters (their registry twins under
        ``serving.net.*`` count while telemetry is enabled)."""
        return {
            **dict(self._stats),
            "open_connections": len(self._conns),
            "wire_errors": dict(sorted(self._wire_errors.items())),
            "port": self.port,
        }

    # -- connection handling -----------------------------------------------

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        conn = _Conn(reader, writer,
                     self.config.max_inflight_per_connection)
        self._conns.add(conn)
        if self._closing:
            # Accepted just before close(): no request of it was read,
            # so it ends at once.
            _end_of_stream(conn)
        self._stats["connections_opened"] += 1
        _M_CONN_OPENED.inc()
        _G_OPEN_CONNS.set(len(self._conns))
        try:
            try:
                first = await reader.readexactly(4)
            except (asyncio.IncompleteReadError, ConnectionError):
                return  # opened and closed without a request
            self._read_bytes(4)
            if first == REQUEST_MAGIC:
                await self._binary_conn(conn, first_consumed=True)
            else:
                await self._http_conn(conn, first)
        except ConnectionError:
            self._count_wire_error("disconnect")
        finally:
            self._conns.discard(conn)
            self._stats["connections_closed"] += 1
            _M_CONN_CLOSED.inc()
            _G_OPEN_CONNS.set(len(self._conns))
            writer.close()

    async def _score_request(self, data: GameDataset, model: str):
        """One request through the shared admission path:
        ``(scores, error tuple)``, the error tuple the typed wire view of
        a shed, an unknown model or a failed request (counted here, once
        a request, for both framings)."""
        try:
            scores = await self.frontend.score(data, model=model)
            self._stats["responses"] += 1
            _M_RESPONSES.inc()
            return scores, None
        except RequestRejected as e:
            self._count_wire_error("shed")
            return None, ("shed", str(e), e.trace_id)
        except UnknownModelError as e:
            self._count_wire_error("unknown_model")
            return None, ("unknown_model", str(e), None)
        except Exception as e:  # noqa: BLE001 — typed per-request verdict
            # The front-end's fault isolation routed an engine failure to
            # this request alone: it was well framed but unservable, and
            # its window-mates settled.
            self._count_wire_error("request_error")
            return None, ("request_error", f"{type(e).__name__}: {e}", None)

    # -- binary framing ----------------------------------------------------

    async def _binary_conn(self, conn: _Conn, first_consumed: bool) -> None:
        writer_task = asyncio.get_running_loop().create_task(
            self._binary_writer(conn))
        try:
            await self._binary_reader(conn, first_consumed)
        finally:
            await conn.queue.put(None)  # sentinel: drain, then stop
            await writer_task

    async def _binary_reader(self, conn: _Conn,
                             first_consumed: bool) -> None:
        cfg = self.config
        while True:
            if not first_consumed:
                try:
                    magic = await conn.reader.readexactly(4)
                except asyncio.IncompleteReadError as e:
                    if e.partial:
                        self._count_wire_error("disconnect")
                    return  # clean close between frames
                self._read_bytes(4)
                if magic != REQUEST_MAGIC:
                    self._count_wire_error("malformed")
                    await conn.queue.put(encode_response(
                        None, ("malformed", f"bad frame magic {magic!r}",
                               None)))
                    return
            first_consumed = False
            try:
                head = await asyncio.wait_for(
                    conn.reader.readexactly(4), cfg.header_timeout_s)
            except asyncio.TimeoutError:
                self._count_wire_error("timeout")
                await conn.queue.put(encode_response(
                    None, ("timeout", "frame header stalled", None)))
                return
            except asyncio.IncompleteReadError:
                self._count_wire_error("disconnect")
                return
            self._read_bytes(4)
            (payload_len,) = _U4.unpack(head)
            if payload_len > cfg.max_body_bytes:
                self._count_wire_error("too_large")
                await conn.queue.put(encode_response(
                    None, ("too_large",
                           f"frame of {payload_len} bytes exceeds "
                           f"max_body_bytes={cfg.max_body_bytes}", None)))
                return
            try:
                payload = await asyncio.wait_for(
                    conn.reader.readexactly(payload_len),
                    cfg.body_timeout_s)
            except asyncio.TimeoutError:
                self._count_wire_error("timeout")
                await conn.queue.put(encode_response(
                    None, ("timeout", "frame body stalled", None)))
                return
            except asyncio.IncompleteReadError:
                self._count_wire_error("disconnect")
                return
            self._read_bytes(payload_len)
            self._stats["requests_binary"] += 1
            _M_REQ_BINARY.inc()
            try:
                data, model = decode_request(payload)
            except MalformedFrame as e:
                # The frame length was honest (the payload was read in
                # full), so the stream is still in sync: a typed error,
                # and the connection stays usable.
                self._count_wire_error("malformed")
                await conn.queue.put(encode_response(
                    None, ("malformed", e.message, None)))
                continue
            # Backpressure: stop reading once max_inflight frames are
            # unanswered; TCP pushes back on the sender.
            await conn.sem.acquire()
            task = asyncio.get_running_loop().create_task(
                self._score_request(data, model))
            await conn.queue.put(task)

    async def _binary_writer(self, conn: _Conn) -> None:
        """In-order response pump: queue items are ready bytes (decode
        errors) or in-flight scoring tasks (awaited, then encoded)."""
        while True:
            item = await conn.queue.get()
            if item is None:
                return
            if isinstance(item, bytes):
                frame = item
            else:
                scores, err = await item
                conn.sem.release()
                frame = encode_response(scores, err)
            conn.writer.write(frame)
            self._wrote(len(frame))
            try:
                await conn.writer.drain()
            except ConnectionError:
                self._count_wire_error("disconnect")
                return

    # -- HTTP framing ------------------------------------------------------

    async def _http_conn(self, conn: _Conn, head0: Optional[bytes]) -> None:
        cfg = self.config
        while True:
            if head0 is None:
                # Idle keep-alive wait: unbounded until the first byte of
                # the next request; then the slowloris clock runs.
                try:
                    head0 = await conn.reader.readexactly(1)
                except (asyncio.IncompleteReadError, ConnectionError):
                    return  # clean close between requests
                self._read_bytes(1)
            try:
                rest = await asyncio.wait_for(
                    conn.reader.readuntil(b"\r\n\r\n"),
                    cfg.header_timeout_s)
            except asyncio.TimeoutError:
                self._count_wire_error("timeout")
                await self._http_error(conn, HeaderTimeout(
                    "request header stalled"), keep=False, counted=True)
                return
            except asyncio.LimitOverrunError:
                self._count_wire_error("too_large")
                await self._http_error(conn, FrameTooLarge(
                    f"header exceeds {cfg.max_header_bytes} bytes"),
                    keep=False, counted=True)
                return
            except (asyncio.IncompleteReadError, ConnectionError):
                self._count_wire_error("disconnect")
                return
            self._read_bytes(len(rest))
            head = head0 + rest
            head0 = None
            if len(head) > cfg.max_header_bytes:
                self._count_wire_error("too_large")
                await self._http_error(conn, FrameTooLarge(
                    f"header of {len(head)} bytes exceeds "
                    f"max_header_bytes={cfg.max_header_bytes}"),
                    keep=False, counted=True)
                return
            keep = await self._http_request(conn, head)
            if not keep:
                return

    async def _http_request(self, conn: _Conn, head: bytes) -> bool:
        """Parse one request head, read its body, score, respond. Returns
        whether the connection stays open (keep-alive)."""
        cfg = self.config
        try:
            lines = head.decode("latin-1").split("\r\n")
            method, path, version = lines[0].split(" ", 2)
            headers = {}
            for ln in lines[1:]:
                if not ln:
                    continue
                k, _, v = ln.partition(":")
                headers[k.strip().lower()] = v.strip()
        except ValueError:
            self._count_wire_error("malformed")
            await self._http_error(conn, MalformedFrame(
                "bad request line", fatal=True), keep=False, counted=True)
            return False
        keep = headers.get("connection", "").lower() != "close" \
            and version.strip().upper() == "HTTP/1.1"
        self._stats["requests_http"] += 1
        _M_REQ_HTTP.inc()
        if method == "GET":
            if path in ("/healthz", "/statz"):
                body = json.dumps({
                    "status": "ok",
                    "models": list(self.frontend.models),
                    "net": self.stats()}) + "\n"
                await self._http_respond(conn, 200, body, keep)
            else:
                await self._http_respond(conn, 404, json.dumps(
                    {"error": "not_found", "message": path}) + "\n", keep)
            return keep
        if method != "POST" or path.split("?", 1)[0] != "/score":
            await self._http_respond(conn, 404, json.dumps(
                {"error": "not_found",
                 "message": f"{method} {path}"}) + "\n", keep)
            return keep
        try:
            length = int(headers.get("content-length", ""))
        except ValueError:
            self._count_wire_error("malformed")
            await self._http_error(conn, MalformedFrame(
                "POST /score requires Content-Length", fatal=True),
                keep=False, counted=True)
            return False
        if length > cfg.max_body_bytes:
            self._count_wire_error("too_large")
            await self._http_error(conn, FrameTooLarge(
                f"body of {length} bytes exceeds "
                f"max_body_bytes={cfg.max_body_bytes}"),
                keep=False, counted=True)
            return False
        try:
            raw = await asyncio.wait_for(
                conn.reader.readexactly(length), cfg.body_timeout_s)
        except asyncio.TimeoutError:
            self._count_wire_error("timeout")
            await self._http_error(conn, HeaderTimeout(
                "request body stalled"), keep=False, counted=True)
            return False
        except (asyncio.IncompleteReadError, ConnectionError):
            self._count_wire_error("disconnect")
            return False
        self._read_bytes(length)
        try:
            data, model = dataset_from_json(json.loads(raw))
        except (ValueError, MalformedFrame) as e:
            msg = e.message if isinstance(e, MalformedFrame) else str(e)
            self._count_wire_error("malformed")
            await self._http_error(conn, MalformedFrame(msg),
                                   keep=keep, counted=True)
            return keep
        scores, err = await self._score_request(data, model)
        if err is not None:
            kind, message, trace_id = err
            body = json.dumps({"error": kind, "message": message,
                               "trace_id": trace_id}) + "\n"
            await self._http_respond(conn, _KIND_HTTP[kind], body, keep)
            return keep
        arr = np.ascontiguousarray(scores)
        body = json.dumps({
            "scores": np.asarray(arr, _HOST_F8).tolist(),
            "dtype": arr.dtype.newbyteorder("<").str,
            "rows": int(arr.shape[0])}) + "\n"
        await self._http_respond(conn, 200, body, keep)
        return keep

    async def _http_error(self, conn: _Conn, err: WireError,
                          keep: bool, counted: bool = False) -> None:
        if not counted:
            self._count_wire_error(err.kind)
        body = json.dumps({"error": err.kind,
                           "message": err.message}) + "\n"
        await self._http_respond(conn, _KIND_HTTP.get(err.kind, 500),
                                 body, keep)

    _HTTP_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
                     408: "Request Timeout", 413: "Payload Too Large",
                     429: "Too Many Requests",
                     500: "Internal Server Error"}

    async def _http_respond(self, conn: _Conn, status: int, body: str,
                            keep: bool) -> None:
        data = body.encode("utf-8")
        head = (f"HTTP/1.1 {status} "
                f"{self._HTTP_REASONS.get(status, 'Error')}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(data)}\r\n"
                f"Connection: {'keep-alive' if keep else 'close'}\r\n"
                f"\r\n").encode("latin-1")
        conn.writer.write(head + data)
        self._wrote(len(head) + len(data))
        try:
            await conn.writer.drain()
        except ConnectionError:
            self._count_wire_error("disconnect")


# -- client ------------------------------------------------------------------


class NetClient:
    """Small asyncio client for both framings. One request in flight per
    client; a pipelined caller composes its own frames with
    :func:`encode_request` and :func:`read_binary_response`."""

    def __init__(self, host: str, port: int, framing: str = "binary"):
        if framing not in ("binary", "http"):
            raise ValueError(f"framing must be binary|http, "
                             f"got {framing!r}")
        self.host = host
        self.port = int(port)
        self.framing = framing
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None

    async def __aenter__(self) -> "NetClient":
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
            self._reader = None

    async def score(self, data: GameDataset,
                    model: str = "default") -> np.ndarray:
        if self._writer is None:
            raise RuntimeError("client not connected "
                               "(use 'async with NetClient(...)')")
        if self.framing == "binary":
            self._writer.write(encode_request(data, model))
            await self._writer.drain()
            return await read_binary_response(self._reader)
        body = json.dumps(json_payload(data, model)).encode("utf-8")
        req = (f"POST /score HTTP/1.1\r\n"
               f"Host: {self.host}\r\n"
               f"Content-Type: application/json\r\n"
               f"Content-Length: {len(body)}\r\n"
               f"\r\n").encode("latin-1") + body
        self._writer.write(req)
        await self._writer.drain()
        status, payload = await read_http_response(self._reader)
        obj = json.loads(payload)
        if status != 200:
            raise ServerError(str(obj.get("error", "internal")),
                              str(obj.get("message")), obj.get("trace_id"))
        return np.asarray(obj["scores"], _HOST_F8).astype(
            np.dtype(obj.get("dtype", "<f8")), copy=False)
