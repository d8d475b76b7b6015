"""Replica fleet router: a thin asyncio front over N netserver replicas,
speaking the binary framing as pure passthrough (port of
photon_ml_tpu/serving/router.py: the metrics :54-56, RouterConfig
:59-64, _Backend :67-95, _BACKEND_LOST :98-101, ReplicaRouter
:104-327, _done_future :330-335).

One serving process is one replica; the fleet is N replicas (each its
own process and CUDA context) behind a router that spreads requests,
not connections: every frame is routed on its own, so one pipelined
client reaches the whole fleet.

- **Never decode payloads.** The router reads the 8-byte frame head
  (magic and length) of each request, forwards the frame bytes as they
  are, and pairs response frames back by FIFO order per backend
  connection (the netserver writes responses in request order; that
  order is the correlation, with no request ids on the wire).
- **Least-pending routing** with a round-robin tie-break: a backend's
  in-flight count is the router's own bookkeeping. A backend that slows
  gathers in-flight requests and stops being picked; one that dies fails
  its in-flight requests with a typed ``internal`` error frame and is
  reconnected on the next pick.
- **Per-client response order**: responses go back in request order per
  client connection, whatever backends served them.

The router imports the wire codec (wire.py: numpy and the standard
library), never torch, so its process holds no CUDA context. It is
binary only, as in JAX.

``close()`` stops accepting, cancels the client connections (each
writes the responses of the frames it forwarded before it ends), then
stops the backend pumps, and awaits ``wait_closed()`` last: on Python
3.12 ``wait_closed()`` waits for every open connection, so JAX's order
(wait_closed first) never returns while a client holds its connection.
"""

from __future__ import annotations

import asyncio
import dataclasses
from collections import deque
from typing import Optional, Sequence, Tuple

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.serving.wire import (
    _U4,
    REQUEST_MAGIC,
    RESPONSE_MAGIC,
    encode_response,
)

_M_FORWARDED = telemetry.counter("serving.router.forwarded")
_M_RETURNED = telemetry.counter("serving.router.returned")
_M_ERRORS = telemetry.counter("serving.router.backend_errors")


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    host: str = "127.0.0.1"
    port: int = 0
    max_body_bytes: int = 8 * 1024 * 1024
    policy: str = "least_pending"  # or "round_robin"


class _Backend:
    """One replica: a lazy persistent connection, the FIFO of its
    in-flight futures and a response pump pairing frames back in
    order."""

    __slots__ = ("host", "port", "reader", "writer", "inflight",
                 "pump", "forwarded", "errors", "connect_lock")

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = int(port)
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.inflight: deque = deque()
        self.pump: Optional[asyncio.Task] = None
        self.forwarded = 0
        self.errors = 0
        # Serializes connects: without it, client handlers racing a cold
        # router each see writer None and open a connection and a pump
        # to the same backend, and the pumps tear one reader's framing.
        self.connect_lock = asyncio.Lock()

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"


#: the error frame a client gets for a request that was in flight on a
#: backend connection that died (typed: a client never hangs).
_BACKEND_LOST = encode_response(
    None, ("internal", "backend connection lost", None))


class ReplicaRouter:
    """``await ReplicaRouter(backends, cfg).start()``, then :meth:`close`
    (every forwarded frame gets its response or a typed error before the
    listener goes away)."""

    def __init__(self, backends: Sequence[Tuple[str, int]],
                 config: Optional[RouterConfig] = None):
        if not backends:
            raise ValueError("router needs at least one backend")
        self.config = config if config is not None else RouterConfig()
        if self.config.policy not in ("least_pending", "round_robin"):
            raise ValueError(f"unknown policy {self.config.policy!r}")
        self.backends = [_Backend(h, p) for h, p in backends]
        self._rr = 0
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()
        self._stats = {"connections": 0, "forwarded": 0, "returned": 0,
                       "backend_errors": 0, "malformed": 0}

    @property
    def port(self) -> Optional[int]:
        if self._server is None or not self._server.sockets:
            return None
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> "ReplicaRouter":
        if self._server is not None:
            raise RuntimeError("router already started")
        self._server = await asyncio.start_server(
            self._on_conn, host=self.config.host, port=self.config.port)
        return self

    async def close(self) -> None:
        if self._server is None:
            return
        self._server.close()
        while self._conns:
            tasks = list(self._conns)
            for task in tasks:
                task.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
        for b in self.backends:
            if b.pump is not None:
                pump, b.pump = b.pump, None
                pump.cancel()
                await asyncio.gather(pump, return_exceptions=True)
            if b.writer is not None:
                b.writer.close()
                b.reader = b.writer = None
        await self._server.wait_closed()
        self._server = None

    # -- backend side ------------------------------------------------------

    def _fail_inflight(self, b: _Backend) -> None:
        while b.inflight:
            fut = b.inflight.popleft()
            if not fut.done():
                fut.set_result(_BACKEND_LOST)
            b.errors += 1
            self._stats["backend_errors"] += 1
            _M_ERRORS.inc()

    async def _pump(self, b: _Backend, reader: asyncio.StreamReader,
                    writer: asyncio.StreamWriter) -> None:
        """Read response frames off one backend connection and resolve
        the FIFO futures in order. The pump owns the (reader, writer) pair
        it was started with; on exit it tears down the backend's shared
        state only if that pair is still the backend's connection."""
        try:
            while True:
                head = await reader.readexactly(8)
                if head[:4] != RESPONSE_MAGIC:
                    raise ConnectionError(
                        f"backend {b.addr} broke framing ({head[:4]!r})")
                (n,) = _U4.unpack(head[4:])
                payload = await reader.readexactly(n)
                if not b.inflight:
                    raise ConnectionError(
                        f"backend {b.addr} sent an unpaired response")
                fut = b.inflight.popleft()
                if not fut.done():
                    fut.set_result(head + payload)
                self._stats["returned"] += 1
                _M_RETURNED.inc()
        except (asyncio.IncompleteReadError, OSError):
            # A lost backend: its in-flight requests get typed errors
            # below and are counted in backend_errors.
            pass
        finally:
            writer.close()
            if b.reader is reader:
                self._fail_inflight(b)
                b.reader = b.writer = None
                b.pump = None

    async def _ensure_connected(self, b: _Backend) -> bool:
        if b.writer is not None:
            return True
        async with b.connect_lock:
            if b.writer is not None:  # another handler connected first
                return True
            try:
                reader, writer = await asyncio.open_connection(b.host,
                                                               b.port)
            except OSError:
                return False
            b.reader, b.writer = reader, writer
            b.pump = asyncio.get_running_loop().create_task(
                self._pump(b, reader, writer))
            return True

    async def _pick(self) -> Optional[_Backend]:
        """Least pending with a round-robin tie-break (pure round robin
        under ``policy="round_robin"``); reconnects lazily, skipping
        backends that refuse. None: the whole fleet is unreachable."""
        n = len(self.backends)
        order = [self.backends[(self._rr + i) % n] for i in range(n)]
        self._rr = (self._rr + 1) % n
        if self.config.policy == "least_pending":
            order.sort(key=lambda b: len(b.inflight))
        for b in order:
            if await self._ensure_connected(b):
                return b
        return None

    # -- client side -------------------------------------------------------

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        self._stats["connections"] += 1
        # Per-client in-order response writer (requests may fan out across
        # backends; the client sees request order).
        queue: asyncio.Queue = asyncio.Queue()

        async def respond() -> None:
            while True:
                fut = await queue.get()
                if fut is None:
                    return
                frame = await fut
                writer.write(frame)
                try:
                    await writer.drain()
                except ConnectionError:
                    return

        responder = asyncio.get_running_loop().create_task(respond())
        try:
            while True:
                try:
                    head = await reader.readexactly(8)
                except (asyncio.IncompleteReadError, ConnectionError):
                    return  # the client is done
                if head[:4] != REQUEST_MAGIC:
                    self._stats["malformed"] += 1
                    await queue.put(_done_future(encode_response(
                        None, ("malformed",
                               f"bad frame magic {head[:4]!r}", None))))
                    return
                (n,) = _U4.unpack(head[4:])
                if n > self.config.max_body_bytes:
                    self._stats["malformed"] += 1
                    await queue.put(_done_future(encode_response(
                        None, ("too_large",
                               f"frame of {n} bytes exceeds router bound",
                               None))))
                    return
                try:
                    payload = await reader.readexactly(n)
                except (asyncio.IncompleteReadError, ConnectionError):
                    return  # disconnect mid-frame: nothing to answer
                # _pick awaits (reconnects), so a backend it returns can
                # lose its connection before the write: take the writer
                # while it is live, and pick again if the pump tore it
                # down meanwhile.
                for _ in range(len(self.backends) + 1):
                    b = await self._pick()
                    bw = None if b is None else b.writer
                    if b is None or bw is not None:
                        break
                if b is None or bw is None:
                    await queue.put(_done_future(_BACKEND_LOST))
                    continue
                fut = asyncio.get_running_loop().create_future()
                b.inflight.append(fut)
                b.forwarded += 1
                self._stats["forwarded"] += 1
                _M_FORWARDED.inc()
                bw.write(head + payload)
                await queue.put(fut)
                try:
                    await bw.drain()
                except OSError:
                    pass  # the pump sees the loss and fails the FIFO
        finally:
            # Drain: the responses of every frame forwarded so far are
            # written before the connection closes (close() cancels
            # here).
            self._conns.discard(task)
            queue.put_nowait(None)
            try:
                await responder
            finally:
                writer.close()

    def stats(self) -> dict:
        return {
            **dict(self._stats),
            "port": self.port,
            "policy": self.config.policy,
            "backends": [{"addr": b.addr,
                          "connected": b.writer is not None,
                          "inflight": len(b.inflight),
                          "forwarded": b.forwarded,
                          "errors": b.errors}
                         for b in self.backends],
        }


def _done_future(frame: bytes) -> asyncio.Future:
    fut = asyncio.get_running_loop().create_future()
    fut.set_result(frame)
    return fut
