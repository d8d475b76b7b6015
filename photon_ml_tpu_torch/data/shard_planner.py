"""Block index of Avro container files and its shards for a process pool
(port of photon_ml_tpu/data/shard_planner.py: BlockSpan :37,
FileBlockIndex :48, IngestShard :67-88, scan_container_blocks :90,
read_block :147, plan_shards :192-231, scan_paths :234).

An Avro object container file is a header followed by independent blocks
(count varint, byte-size varint, payload, 16-byte sync marker). Blocks are
self-contained — a reader that knows the file's codec, sync marker and a
block's byte offset can decode it without touching the header — so the
natural decode unit is a block. Scanning the block index reads only the
two varints per block (payloads are seeked over), so it costs O(blocks)
seeks, not O(bytes).

``data/block_stream.py`` walks the index in order, cutting decoded rows
into bounded batches, and fetches row ranges from it at random;
``plan_shards`` cuts it into byte-balanced block runs, which
``data/parallel_ingest.py``'s workers decode.

This module imports neither torch nor numpy: the ingest workers load it.
"""

from __future__ import annotations

import dataclasses
import json
import os
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

    @property
    def num_rows(self) -> int:
        return sum(b.count for b in self.blocks)

    @property
    def num_bytes(self) -> int:
        return sum(b.payload_bytes for b in self.blocks)


@dataclasses.dataclass(frozen=True)
class IngestShard:
    """A consecutive block run of one file, assigned to one worker.

    ``seq`` is the global assembly position: results concatenated in seq
    order are byte-identical to a single-process scan of the same paths.
    """

    seq: int
    path: str
    codec: str
    sync: bytes
    offset: int  # file position of the first block's count varint
    num_blocks: int
    num_rows: int
    num_bytes: int

    def label(self) -> str:
        """Human-readable shard name for error messages."""
        return (f"{os.path.basename(self.path)}"
                f"[@{self.offset}, {self.num_blocks} blocks, "
                f"{self.num_rows} rows]")


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


def plan_shards(indexes: Sequence[FileBlockIndex],
                num_shards: int) -> List[IngestShard]:
    """Group consecutive blocks into ~``num_shards`` byte-balanced shards.

    File order and block order are kept (seq numbers follow the scan
    order). Shards never cross a file boundary, so each has one schema,
    codec and sync marker; a file below the byte target still gets its
    own shard, so there may be up to ``num_shards + len(indexes)``
    shards and never fewer than the non-empty files.
    """
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    total_bytes = sum(ix.num_bytes for ix in indexes)
    target = max(1, -(-total_bytes // num_shards))  # ceil

    shards: List[IngestShard] = []
    for ix in indexes:
        run: List[BlockSpan] = []
        run_bytes = 0
        for i, b in enumerate(ix.blocks):
            run.append(b)
            run_bytes += b.payload_bytes
            if run_bytes >= target or i == len(ix.blocks) - 1:
                shards.append(IngestShard(
                    seq=len(shards), path=ix.path, codec=ix.codec,
                    sync=ix.sync, offset=run[0].offset,
                    num_blocks=len(run),
                    num_rows=sum(r.count for r in run),
                    num_bytes=run_bytes))
                run, run_bytes = [], 0
    return shards


def scan_paths(paths: Sequence) -> List[FileBlockIndex]:
    """Block indexes for a list of files, in the given order."""
    return [scan_container_blocks(Path(p)) for p in paths]
