"""Minimal Avro: binary encoding + object container files (a copy of
photon_ml_tpu/io/avro_codec.py: Schema, write_datum/read_datum :1-247,
the native hook :251-356 — compile_schema_program, which flattens a
schema into the C decoder's opcode program, and _native_decoder — and
the container files :359-478 with iter_raw_blocks :426).

``read_container`` decodes each block with the C decoder
(native/_avro_native.c ``decode_block``) when the schema compiles to a
program, as the JAX package does, and with the pure-Python
``read_datum`` when it does not or when the caller passes
``native=False`` (the ``--feeder python`` route). The C decoder is
built at first use; a failed build raises, it never quietly falls back.

The runtime image has no avro/fastavro; the reference's entire IO surface is
Avro (photon-avro-schemas/src/main/avro/*.avsc, ml/avro/AvroIOUtils.scala),
so this module implements the subset of the Avro 1.x spec those schemas use:

  primitives (null, boolean, int, long, float, double, bytes, string),
  records, arrays, maps, unions, fixed — with zigzag-varint ints/longs,
  object container files (magic 'Obj\\x01', metadata map, sync markers,
  null/deflate codecs).

Datum values are plain dicts/lists/scalars (generic records). Schemas are
the standard JSON forms. Readers use the writer schema embedded in the file
(no schema-resolution/evolution — the framework reads files it wrote plus
reference-layout training data).
"""

from __future__ import annotations

import io
import json
import os
import struct
import sys
import zlib
from typing import Any, Dict, Iterable, Iterator, List, Optional

MAGIC = b"Obj\x01"
DEFAULT_SYNC_INTERVAL = 16 * 1024


# ---------------------------------------------------------------------------
# Schema handling
# ---------------------------------------------------------------------------


class Schema:
    """Parsed schema with named-type registry (records can self-reference)."""

    def __init__(self, schema_json: Any):
        self.names: Dict[str, Any] = {}
        self.root = self._resolve(schema_json)

    def _resolve(self, s: Any) -> Any:
        if isinstance(s, str):
            if s in self.names:
                return self.names[s]
            return s  # primitive name
        if isinstance(s, list):
            return [self._resolve(b) for b in s]
        if isinstance(s, dict):
            t = s.get("type")
            if t in ("record", "enum", "fixed"):
                full = s["name"] if "." in s.get("name", "") else (
                    (s.get("namespace", "") + "." + s["name"]).lstrip("."))
                self.names[s["name"]] = s
                self.names[full] = s
                if t == "record":
                    s = dict(s)
                    s["fields"] = [
                        dict(f, type=self._resolve(f["type"]))
                        for f in s["fields"]]
                    self.names[s["name"]] = s
                    self.names[full] = s
                return s
            if t == "array":
                return dict(s, items=self._resolve(s["items"]))
            if t == "map":
                return dict(s, values=self._resolve(s["values"]))
            return s
        raise ValueError(f"bad schema node: {s!r}")


# ---------------------------------------------------------------------------
# Binary encoder / decoder
# ---------------------------------------------------------------------------


def _write_long(buf: io.BytesIO, n: int) -> None:
    n = (n << 1) ^ (n >> 63)  # zigzag
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.write(bytes([b | 0x80]))
        else:
            buf.write(bytes([b]))
            break


def _read_long(src: io.BytesIO) -> int:
    shift = 0
    acc = 0
    while True:
        byte = src.read(1)
        if not byte:
            raise EOFError("truncated varint")
        b = byte[0]
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)  # un-zigzag


def _union_branch_index(schema: List, datum: Any) -> int:
    def matches(branch, d):
        b = branch if isinstance(branch, str) else branch.get("type")
        if b == "null":
            return d is None
        if b == "boolean":
            return isinstance(d, bool)
        if b in ("int", "long"):
            return isinstance(d, int) and not isinstance(d, bool)
        if b in ("float", "double"):
            return isinstance(d, (int, float)) and not isinstance(d, bool)
        if b == "string":
            return isinstance(d, str)
        if b in ("bytes", "fixed"):
            return isinstance(d, (bytes, bytearray))
        if b == "array":
            return isinstance(d, list)
        if b in ("map", "record"):
            return isinstance(d, dict)
        if b == "enum":
            return isinstance(d, str)
        return False

    for i, branch in enumerate(schema):
        if matches(branch, datum):
            return i
    raise ValueError(f"datum {datum!r} matches no union branch in {schema}")


def write_datum(buf: io.BytesIO, schema: Any, datum: Any) -> None:
    t = schema if isinstance(schema, str) else (
        schema.get("type") if isinstance(schema, dict) else None)
    if isinstance(schema, list):
        idx = _union_branch_index(schema, datum)
        _write_long(buf, idx)
        write_datum(buf, schema[idx], datum)
    elif t == "null":
        pass
    elif t == "boolean":
        buf.write(b"\x01" if datum else b"\x00")
    elif t in ("int", "long"):
        _write_long(buf, int(datum))
    elif t == "float":
        buf.write(struct.pack("<f", float(datum)))
    elif t == "double":
        buf.write(struct.pack("<d", float(datum)))
    elif t == "bytes":
        _write_long(buf, len(datum))
        buf.write(bytes(datum))
    elif t == "string":
        raw = datum.encode("utf-8")
        _write_long(buf, len(raw))
        buf.write(raw)
    elif t == "fixed":
        if len(datum) != schema["size"]:
            raise ValueError("fixed size mismatch")
        buf.write(bytes(datum))
    elif t == "enum":
        _write_long(buf, schema["symbols"].index(datum))
    elif t == "array":
        if datum:
            _write_long(buf, len(datum))
            for item in datum:
                write_datum(buf, schema["items"], item)
        _write_long(buf, 0)
    elif t == "map":
        if datum:
            _write_long(buf, len(datum))
            for k, v in datum.items():
                write_datum(buf, "string", k)
                write_datum(buf, schema["values"], v)
        _write_long(buf, 0)
    elif t == "record":
        for f in schema["fields"]:
            name = f["name"]
            if name in datum:
                value = datum[name]
            elif "default" in f:
                value = f["default"]
            else:
                raise ValueError(
                    f"record {schema.get('name')}: missing field {name!r}")
            try:
                write_datum(buf, f["type"], value)
            except ValueError as e:
                raise ValueError(f"field {name!r}: {e}") from e
    else:
        raise ValueError(f"unsupported schema {schema!r}")


def read_datum(src: io.BytesIO, schema: Any) -> Any:
    t = schema if isinstance(schema, str) else (
        schema.get("type") if isinstance(schema, dict) else None)
    if isinstance(schema, list):
        idx = _read_long(src)
        return read_datum(src, schema[idx])
    if t == "null":
        return None
    if t == "boolean":
        return src.read(1) == b"\x01"
    if t in ("int", "long"):
        return _read_long(src)
    if t == "float":
        return struct.unpack("<f", src.read(4))[0]
    if t == "double":
        return struct.unpack("<d", src.read(8))[0]
    if t == "bytes":
        return src.read(_read_long(src))
    if t == "string":
        return src.read(_read_long(src)).decode("utf-8")
    if t == "fixed":
        return src.read(schema["size"])
    if t == "enum":
        return schema["symbols"][_read_long(src)]
    if t == "array":
        out: List[Any] = []
        while True:
            n = _read_long(src)
            if n == 0:
                return out
            if n < 0:
                _read_long(src)  # block byte size, unused
                n = -n
            for _ in range(n):
                out.append(read_datum(src, schema["items"]))
    if t == "map":
        res: Dict[str, Any] = {}
        while True:
            n = _read_long(src)
            if n == 0:
                return res
            if n < 0:
                _read_long(src)
                n = -n
            for _ in range(n):
                k = read_datum(src, "string")
                res[k] = read_datum(src, schema["values"])
    if t == "record":
        return {f["name"]: read_datum(src, f["type"])
                for f in schema["fields"]}
    raise ValueError(f"unsupported schema {schema!r}")



# ---------------------------------------------------------------------------
# Native fast path: schema -> flat int64 program for the C decoder
# (native/_avro_native.c). Recursive records have no program; their
# containers decode with read_datum.
# ---------------------------------------------------------------------------

_PRIMITIVE_OPS = {"null": 0, "boolean": 1, "int": 2, "long": 2,
                  "float": 3, "double": 4, "bytes": 5, "string": 6}


class _SchemaProgram:
    def __init__(self, prog, root: int, strings: tuple):
        self.prog = prog.tobytes()  # int64 array buffer
        self.root = root
        self.strings = strings


def compile_schema_program(schema: Any) -> Optional[_SchemaProgram]:
    """Flatten a resolved schema into the C decoder's opcode array.
    Returns None for shapes the native decoder doesn't handle (recursive
    records) — callers then use the pure-python path."""
    from array import array

    prog = array("q")
    strings: List[str] = []
    string_ids: Dict[str, int] = {}
    in_progress: set = set()

    def intern(s: str) -> int:
        if s not in string_ids:
            string_ids[s] = len(strings)
            strings.append(sys.intern(s))
        return string_ids[s]

    def emit(node: Any) -> Optional[int]:
        t = node if isinstance(node, str) else (
            node.get("type") if isinstance(node, dict) else None)
        if isinstance(node, list):
            children = [emit(b) for b in node]
            if any(c is None for c in children):
                return None
            idx = len(prog)
            prog.append(9)
            prog.append(len(children))
            prog.extend(children)
            return idx
        if isinstance(t, str) and t in _PRIMITIVE_OPS and (
                isinstance(node, str) or set(node) <= {"type", "logicalType",
                                                       "name", "namespace"}):
            idx = len(prog)
            prog.append(_PRIMITIVE_OPS[t])
            return idx
        if not isinstance(node, dict):
            return None
        if t == "fixed":
            idx = len(prog)
            prog.extend([7, int(node["size"])])
            return idx
        if t == "enum":
            syms = [intern(s) for s in node["symbols"]]
            idx = len(prog)
            prog.extend([8, len(syms)])
            prog.extend(syms)
            return idx
        if t == "array":
            child = emit(node["items"])
            if child is None:
                return None
            idx = len(prog)
            prog.extend([10, child])
            return idx
        if t == "map":
            child = emit(node["values"])
            if child is None:
                return None
            idx = len(prog)
            prog.extend([11, child])
            return idx
        if t == "record":
            key = id(node)
            if key in in_progress:
                return None  # recursive schema: native path unsupported
            in_progress.add(key)
            fields = []
            for f in node["fields"]:
                child = emit(f["type"])
                if child is None:
                    in_progress.discard(key)
                    return None
                fields.append((intern(f["name"]), child))
            in_progress.discard(key)
            idx = len(prog)
            prog.extend([12, len(fields)])
            for name_id, child in fields:
                prog.extend([name_id, child])
            return idx
        return None

    root = emit(schema)
    if root is None:
        return None
    return _SchemaProgram(prog, root, tuple(strings))


def _native_decoder():
    from photon_ml_tpu_torch.native import load_avro_native

    return load_avro_native()


# ---------------------------------------------------------------------------
# Object container files
# ---------------------------------------------------------------------------

_META_SCHEMA = {"type": "map", "values": "bytes"}


def write_container(
    path: str | os.PathLike,
    schema_json: Any,
    records: Iterable[Any],
    codec: str = "deflate",
    sync_interval: int = DEFAULT_SYNC_INTERVAL,
) -> None:
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported codec {codec!r}")
    schema = Schema(schema_json)
    sync = os.urandom(16)
    with open(path, "wb") as f:
        f.write(MAGIC)
        head = io.BytesIO()
        write_datum(head, _META_SCHEMA, {
            "avro.schema": json.dumps(schema_json).encode(),
            "avro.codec": codec.encode(),
        })
        f.write(head.getvalue())
        f.write(sync)

        block = io.BytesIO()
        count = 0

        def flush():
            nonlocal block, count
            if count == 0:
                return
            payload = block.getvalue()
            if codec == "deflate":
                payload = zlib.compress(payload)[2:-4]  # raw deflate
            hdr = io.BytesIO()
            _write_long(hdr, count)
            _write_long(hdr, len(payload))
            f.write(hdr.getvalue())
            f.write(payload)
            f.write(sync)
            block = io.BytesIO()
            count = 0

        for rec in records:
            write_datum(block, schema.root, rec)
            count += 1
            if block.tell() >= sync_interval:
                flush()
        flush()


def _read_header(f, path):
    if f.read(4) != MAGIC:
        raise ValueError(f"{path}: not an Avro container file")
    meta = read_datum(f, _META_SCHEMA)  # type: ignore[arg-type]
    schema = Schema(json.loads(meta["avro.schema"].decode()))
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported codec {codec!r}")
    sync = f.read(16)
    return schema, codec, sync


def iter_raw_blocks(path: str | os.PathLike):
    """Yield (schema, decompressed_payload, record_count) per block — the
    entry point for block-level native decoders (data/fast_ingest.py)."""
    with open(path, "rb") as f:
        schema, codec, sync = _read_header(f, path)
        while True:
            first = f.read(1)
            if not first:
                return
            f.seek(-1, 1)
            count = _read_long(f)  # type: ignore[arg-type]
            size = _read_long(f)  # type: ignore[arg-type]
            payload = f.read(size)
            if codec == "deflate":
                payload = zlib.decompress(payload, -15)
            yield schema, payload, count
            if f.read(16) != sync:
                raise ValueError(f"{path}: sync marker mismatch")


def read_container(path: str | os.PathLike,
                   native: bool = True) -> Iterator[Any]:
    """The container's records, decoded by the C decoder (``native``,
    when the schema compiles to a program) or by ``read_datum``."""
    with open(path, "rb") as f:
        schema, codec, sync = _read_header(f, path)
        program = compile_schema_program(schema.root) if native else None
        decoder = _native_decoder() if program is not None else None
        while True:
            first = f.read(1)
            if not first:
                return
            f.seek(-1, 1)
            count = _read_long(f)  # type: ignore[arg-type]
            size = _read_long(f)  # type: ignore[arg-type]
            payload = f.read(size)
            if codec == "deflate":
                payload = zlib.decompress(payload, -15)
            if decoder is not None:
                yield from decoder.decode_block(
                    payload, count, program.prog, program.root,
                    program.strings)
            else:
                src = io.BytesIO(payload)
                for _ in range(count):
                    yield read_datum(src, schema.root)
            if f.read(16) != sync:
                raise ValueError(f"{path}: sync marker mismatch")


def container_schema(path: str | os.PathLike) -> Any:
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path}: not an Avro container file")
        meta = read_datum(f, _META_SCHEMA)  # type: ignore[arg-type]
    return json.loads(meta["avro.schema"].decode())
