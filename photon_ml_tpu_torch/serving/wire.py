"""The network front door's wire codec that needs no dataset: frame
magics, typed wire errors, the vocabulary blob, response frames and the
client-side response readers (port of photon_ml_tpu/serving/
netserver.py: the magics :67-79, the error kinds and the WireError
hierarchy :81-153, _pack_str_array/_unpack_str_array :171-200, _Cursor
:248-272, encode_response/decode_response :342-380, ServerError :383-391,
read_binary_response/read_http_response :967-990).

JAX keeps all of this in netserver.py, which imports the front-end. The
port splits it out so the replica router (router.py, cli/net_router.py),
which reads only frame heads and writes only error frames, loads numpy
and the standard library and never torch. ``netserver.py`` re-exports
every name here, so the JAX import paths hold.

Frames are JAX's bytes: a request frame is ``PNB1`` + u4 payload length
+ payload, a response frame ``PNR1`` + u4 length + status byte + body
(the raw score array with its dtype string, or a JSON error object).
"""

from __future__ import annotations

import asyncio
import json
import struct
from typing import List, Optional, Tuple

import numpy as np

#: Request / response frame magics (4 bytes, never a valid HTTP method
#: prefix: framing detection reads exactly these four bytes).
REQUEST_MAGIC = b"PNB1"
RESPONSE_MAGIC = b"PNR1"

_U4 = struct.Struct("<I")
_U2 = struct.Struct("<H")

#: Host dtype of GameDataset numeric columns (data/game_data.py builds
#: float64 host columns whatever the engine's device dtype): the wire
#: pins the same, so a decoded frame rebuilds the exact dataset an
#: in-process caller would have handed the front-end.
_HOST_F8 = np.float64

#: Status byte of a binary response, and the HTTP status, of each error
#: kind.
_STATUS_OK = 0
_KIND_CODES = {
    "shed": 1,
    "unknown_model": 2,
    "malformed": 3,
    "too_large": 4,
    "timeout": 5,
    "request_error": 6,
    "internal": 7,
}
_CODE_KINDS = {v: k for k, v in _KIND_CODES.items()}
_KIND_HTTP = {
    "shed": 429,
    "unknown_model": 404,
    "malformed": 400,
    "too_large": 413,
    "timeout": 408,
    "request_error": 400,
    "internal": 500,
}


class WireError(RuntimeError):
    """Base of the typed wire-protocol failures. ``kind`` keys the
    ``serving.net.errors.<kind>`` counter, the binary status byte and the
    HTTP status; ``fatal`` marks kinds after which the byte stream cannot
    be trusted (the connection closes after the error response)."""

    kind = "internal"
    fatal = True

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


class MalformedFrame(WireError):
    """A frame or request that does not decode (bad magic, meta JSON,
    array bounds, HTTP syntax). Fatal only when the framing itself is
    broken: a well-framed payload that fails validation keeps the
    connection (the stream is still in sync)."""

    kind = "malformed"

    def __init__(self, message: str, fatal: bool = False):
        super().__init__(message)
        self.fatal = fatal


class FrameTooLarge(WireError):
    """A declared frame or body size beyond the configured bound. Always
    fatal: the oversized payload is never read, so the stream position is
    unusable."""

    kind = "too_large"


class HeaderTimeout(WireError):
    """Slowloris guard: a request's header or frame head did not complete
    within ``header_timeout_s`` of its first byte."""

    kind = "timeout"


class ClientDisconnect(WireError):
    """The peer hung up mid-request (counted; nothing to respond to)."""

    kind = "disconnect"


class ServerError(RuntimeError):
    """Client-side view of a typed server error response."""

    def __init__(self, kind: str, message: str,
                 trace_id: Optional[str] = None):
        super().__init__(f"{kind}: {message}")
        self.kind = kind
        self.message = message
        self.trace_id = trace_id


def _pack_str_array(values) -> bytes:
    """Length-prefixed utf-8 string blob (u2 length per entry), the
    vocabulary's wire form: entity ids are arbitrary strings, so a
    separator-based encoding could not be injective."""
    parts = []
    for v in np.asarray(values).tolist():
        b = str(v).encode("utf-8")
        if len(b) > 0xFFFF:
            raise ValueError(f"vocab entry longer than 65535 bytes "
                             f"({len(b)})")
        parts.append(_U2.pack(len(b)))
        parts.append(b)
    return b"".join(parts)


def _unpack_str_array(blob: bytes, count: int) -> np.ndarray:
    out: List[str] = []
    off = 0
    for _ in range(count):
        if off + 2 > len(blob):
            raise MalformedFrame("vocab blob truncated")
        (n,) = _U2.unpack_from(blob, off)
        off += 2
        if off + n > len(blob):
            raise MalformedFrame("vocab blob truncated")
        out.append(blob[off:off + n].decode("utf-8"))
        off += n
    if off != len(blob):
        raise MalformedFrame("vocab blob has trailing bytes")
    return np.asarray(out)


class _Cursor:
    """Bounds-checked reader over one frame payload: every slice failure
    is a typed :class:`MalformedFrame`, never an IndexError."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.off + n > len(self.buf):
            raise MalformedFrame(
                f"frame truncated: need {n} bytes at offset {self.off}, "
                f"payload is {len(self.buf)}")
        out = self.buf[self.off:self.off + n]
        self.off += n
        return out

    def array(self, dtype: str, count: int) -> np.ndarray:
        item = np.dtype(dtype).itemsize
        return np.frombuffer(self.take(item * int(count)), dtype=dtype)

    def done(self) -> None:
        if self.off != len(self.buf):
            raise MalformedFrame(
                f"frame has {len(self.buf) - self.off} trailing bytes")


def encode_response(scores: Optional[np.ndarray],
                    error: Optional[Tuple[str, str, Optional[str]]] = None,
                    ) -> bytes:
    """OK frame (the raw score bytes, the engine's own dtype and bytes)
    or error frame (status byte + JSON ``{error, message, trace_id}``)."""
    if error is None:
        arr = np.ascontiguousarray(scores)
        dt = arr.dtype.newbyteorder("<").str.encode("ascii")
        payload = b"".join([
            bytes([_STATUS_OK]), bytes([len(dt)]), dt,
            _U4.pack(arr.shape[0]), arr.astype(dt.decode(), copy=False)
            .tobytes()])
    else:
        kind, message, trace_id = error
        body = json.dumps({"error": kind, "message": message,
                           "trace_id": trace_id}).encode("utf-8")
        payload = bytes([_KIND_CODES.get(kind, _KIND_CODES["internal"])]) \
            + body
    return b"".join([RESPONSE_MAGIC, _U4.pack(len(payload)), payload])


def decode_response(payload: bytes) -> np.ndarray:
    """The scores of an OK frame's payload; raises :class:`ServerError`
    carrying the typed error the server sent."""
    cur = _Cursor(payload)
    status = cur.take(1)[0]
    if status == _STATUS_OK:
        dt_len = cur.take(1)[0]
        dt = cur.take(dt_len).decode("ascii")
        (count,) = _U4.unpack(cur.take(4))
        arr = cur.array(dt, count)
        cur.done()
        return arr
    try:
        body = json.loads(cur.buf[cur.off:].decode("utf-8"))
    except ValueError as e:
        raise MalformedFrame(f"error body is not JSON: {e}") from e
    raise ServerError(_CODE_KINDS.get(status, "internal"),
                      str(body.get("message")), body.get("trace_id"))


async def read_binary_response(reader: asyncio.StreamReader) -> np.ndarray:
    """Read and decode one response frame. Raises :class:`ServerError`
    on a typed server error, :class:`MalformedFrame` on a framing
    violation."""
    magic = await reader.readexactly(4)
    if magic != RESPONSE_MAGIC:
        raise MalformedFrame(f"bad response magic {magic!r}")
    (n,) = _U4.unpack(await reader.readexactly(4))
    return decode_response(await reader.readexactly(n))


async def read_http_response(reader: asyncio.StreamReader
                             ) -> Tuple[int, bytes]:
    """Read one HTTP/1.1 response (Content-Length framing):
    ``(status, body bytes)``."""
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split(" ", 2)[1])
    length = 0
    for ln in lines[1:]:
        if ln.lower().startswith("content-length:"):
            length = int(ln.split(":", 1)[1])
    return status, await reader.readexactly(length)
