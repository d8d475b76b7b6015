"""Block index of Avro container files (port of
photon_ml_tpu/data/shard_planner.py: BlockSpan :37, FileBlockIndex :48,
scan_container_blocks :90, read_block :147, scan_paths :234).

An Avro object container file is a header followed by independent blocks
(count varint, byte-size varint, payload, 16-byte sync marker). Blocks are
self-contained — a reader that knows the file's codec, sync marker and a
block's byte offset can decode it without touching the header — so the
natural decode unit is a block. Scanning the block index reads only the
two varints per block (payloads are seeked over), so it costs O(blocks)
seeks, not O(bytes).

``data/block_stream.py`` walks the index in order, cutting decoded rows
into bounded batches, and fetches row ranges from it at random. The JAX
module's planning half (IngestShard, plan_shards: byte-balanced block
runs for a process pool) comes with parallel ingest (ROADMAP A4b).
"""

from __future__ import annotations

import dataclasses
import json
import zlib
from pathlib import Path
from typing import Any, List, Sequence

from photon_ml_tpu_torch.io.avro_codec import MAGIC, _read_long, read_datum


@dataclasses.dataclass(frozen=True)
class BlockSpan:
    """One container block: ``offset`` is the file position of its count
    varint; ``payload_bytes`` the (possibly compressed) payload size;
    ``count`` the records it holds."""

    offset: int
    payload_bytes: int
    count: int


@dataclasses.dataclass(frozen=True)
class FileBlockIndex:
    """Everything a worker needs to decode any block run of one file."""

    path: str
    codec: str  # "null" | "deflate"
    sync: bytes  # 16-byte sync marker
    schema_json: Any  # writer schema (parsed JSON), for layout compilation
    blocks: List[BlockSpan]


def scan_container_blocks(path) -> FileBlockIndex:
    """Index one container file's blocks without decompressing payloads.

    Raises ValueError naming the file and offset on any structural damage
    (truncated varint/payload, sync mismatch) — the same failures a decode
    would hit, surfaced before any worker pool spins up.
    """
    path = str(path)
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path}: not an Avro container file")
        meta = read_datum(f, {"type": "map", "values": "bytes"})
        schema_json = json.loads(meta["avro.schema"].decode())
        codec = meta.get("avro.codec", b"null").decode()
        if codec not in ("null", "deflate"):
            raise ValueError(f"{path}: unsupported codec {codec!r}")
        sync = f.read(16)
        if len(sync) != 16:
            raise ValueError(f"{path}: truncated header sync marker")

        blocks: List[BlockSpan] = []
        while True:
            offset = f.tell()
            first = f.read(1)
            if not first:
                break
            f.seek(-1, 1)
            try:
                count = _read_long(f)
                size = _read_long(f)
            except EOFError as e:
                raise ValueError(
                    f"{path}: truncated block header at offset {offset}: "
                    f"{e}") from e
            if count < 0 or size < 0:
                raise ValueError(
                    f"{path}: negative block header at offset {offset} "
                    f"(count={count}, size={size})")
            f.seek(size, 1)
            marker = f.read(16)
            if len(marker) != 16:
                raise ValueError(
                    f"{path}: truncated block payload/sync at offset "
                    f"{offset} (expected {size} payload bytes + sync)")
            if marker != sync:
                raise ValueError(
                    f"{path}: sync marker mismatch after block at offset "
                    f"{offset}")
            blocks.append(BlockSpan(offset, size, count))
    return FileBlockIndex(path=path, codec=codec, sync=sync,
                          schema_json=schema_json, blocks=blocks)


def read_block(f, codec: str, sync: bytes, path: str,
               expected=None):
    """Read ONE container block at the current file position: returns
    (record_count, decompressed_payload), consuming the trailing sync
    marker and verifying it.

    The single copy of the block-read idiom both decode consumers use
    (the block_stream streaming loop and random-access fetch).
    ``expected``: optional (count, payload_bytes, offset) from a prior
    scan — a mismatch means the file changed under the reader. All
    failures raise ValueError naming the file (and offset when known).
    """
    count = _read_long(f)
    size = _read_long(f)
    where = ""
    if expected is not None:
        e_count, e_size, offset = expected
        where = f" at offset {offset}"
        if (count, size) != (e_count, e_size):
            raise ValueError(
                f"{path}: block header{where} changed under the reader "
                f"(scanned {e_count} rows/{e_size} bytes, read "
                f"{count}/{size})")
    payload = f.read(size)
    if len(payload) != size:
        raise ValueError(
            f"{path}: truncated block payload{where} (wanted {size} "
            f"bytes, got {len(payload)})")
    if f.read(16) != sync:
        raise ValueError(
            f"{path}: sync marker mismatch after block{where}")
    if codec == "deflate":
        try:
            payload = zlib.decompress(payload, -15)
        except zlib.error as e:
            raise ValueError(
                f"{path}: corrupt deflate payload in block{where}: "
                f"{e}") from e
    return count, payload


def scan_paths(paths: Sequence) -> List[FileBlockIndex]:
    """Block indexes for a list of files, in the given order."""
    return [scan_container_blocks(Path(p)) for p in paths]
