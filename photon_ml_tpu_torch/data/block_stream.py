"""Block-streaming GameDataset feeder: bounded-memory, C-decoded,
prefetched (port of photon_ml_tpu/data/block_stream.py: _native_layouts,
_ColumnBuffer, BlockGameStream :189, BlockRandomAccess :358,
read_game_dataset_via_blocks :526).

1. **Block-level native decode** — containers are indexed with
   `shard_planner.scan_container_blocks` (two varints read per block,
   payloads seeked over) and each block's payload is decoded straight to
   CSR triplets + label/id columns by the C decoder
   (`native/_avro_native.c decode_training_block`, the `fast_ingest`
   path). Decoded rows accumulate in a host-side column buffer and are cut
   into GameDatasets of EXACTLY ``batch_rows`` rows — block boundaries
   never leak into batch boundaries, so the output is byte-identical
   (values, row order, dtypes, entity vocabularies) to the record loop
   over the pure-Python codec, which the ``python`` feeder runs.
2. **Prefetch** — a background thread (`device_feed.HostPrefetcher`) runs
   decode + featureize of batch k+1 while the consumer works on batch k.
   Peak resident batches stay bounded by ``prefetch_depth + 2`` (queue +
   producer's hand + consumer's hand).

The JAX module falls back to the record loop when the extension is
unbuilt; here the C decoder is built at first use and a failed build
raises. ``feeder="auto"`` takes the C path whenever every file's schema
fits the training layout, the record loop otherwise. Each batch's
production is one ``decode`` span (JAX :292), on the prefetch thread's
track under prefetch; ``decode_seconds`` accumulates either way.
"""

from __future__ import annotations

import bisect
import io
import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import scipy.sparse as sp

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.data.avro_reader import (
    _avro_paths,
    _GameBatchBuilder,
    _reject_duplicate_features,
    iter_records,
)
from photon_ml_tpu_torch.data.device_feed import HostPrefetcher
from photon_ml_tpu_torch.data.fast_ingest import build_training_layout
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.index_map import DELIMITER, IndexMap
from photon_ml_tpu_torch.data.shard_planner import (
    FileBlockIndex,
    read_block,
    scan_paths,
)
from photon_ml_tpu_torch.io.avro_codec import Schema, read_datum
from photon_ml_tpu_torch.native import load_avro_native

FEEDERS = ("auto", "native", "python")


def _native_layouts(indexes, id_types):
    """Compile one native decode layout per file index. Returns
    ``(layouts, None)`` on success or ``([], reason)`` when any file's
    schema cannot decode natively — shared by the sequential stream and
    the random-access fetch so both resolve the C path identically."""
    layouts = []
    for ix in indexes:
        layout = build_training_layout(Schema(ix.schema_json).root)
        if layout is None:
            return [], (f"{ix.path}: schema does not fit the native "
                        "training layout")
        if id_types and not layout.has_metadata:
            return [], f"{ix.path}: id types requested but no metadataMap"
        layouts.append(layout)
    return layouts, None


class _ColumnBuffer:
    """Decoded-but-unbatched rows, as per-block column chunks.

    `put_block` appends one decoded block's columns; `take(n)` cuts the
    oldest ``n`` rows into a GameDataset (concatenating chunks only at cut
    time, so the steady-state cost is one O(batch) concatenate per batch
    and the remainder re-seeds as a single chunk)."""

    def __init__(self, shard_maps: Dict[str, IndexMap],
                 id_types: Sequence[str]):
        self._maps = shard_maps
        self._id_types = tuple(id_types)
        self.rows = 0
        self._labels: List[np.ndarray] = []
        self._offsets: List[np.ndarray] = []
        self._weights: List[np.ndarray] = []
        self._uids: List[Optional[str]] = []
        # shard -> (vals chunks, cols chunks, row-length chunks)
        self._shards = {s: ([], [], []) for s in shard_maps}
        self._ids: Dict[str, list] = {t: [] for t in self._id_types}

    def put_block(self, decoded, count: int, layout) -> None:
        lb, ob, wb, us, shard_out, ids_out = decoded
        self._labels.append(np.frombuffer(lb, np.float64))
        # Mirror fast_ingest exactly: one chunk per block regardless of
        # optional fields, so mixed-layout files cannot misalign rows.
        self._offsets.append(np.frombuffer(ob, np.float64)
                             if layout.has_offset else np.zeros(count))
        self._weights.append(np.frombuffer(wb, np.float64)
                             if layout.has_weight else np.ones(count))
        self._uids.extend(us if layout.has_uid else [None] * count)
        for s, (vb, cb, rb) in zip(self._shards, shard_out):
            vals_c, cols_c, rlen_c = self._shards[s]
            vals_c.append(np.frombuffer(vb, np.float64))
            cols_c.append(np.frombuffer(cb, np.int64))
            rlen_c.append(np.frombuffer(rb, np.int64))
        for t, lst in zip(self._id_types, ids_out):
            self._ids[t].extend(lst)
        self.rows += count

    @staticmethod
    def _cat(chunks: List[np.ndarray], dtype) -> np.ndarray:
        """Concatenate to ONE writable array (np.frombuffer chunks are
        read-only, but the CSR canonicalization in
        `_reject_duplicate_features` sorts indices in place)."""
        if not chunks:
            return np.zeros(0, dtype)
        if len(chunks) == 1:
            c = chunks[0]
            return c if c.flags.writeable else c.copy()
        return np.concatenate(chunks)

    def take(self, n: int) -> GameDataset:
        """Cut the oldest ``n`` rows (n <= self.rows) into a GameDataset
        byte-identical to what `_GameBatchBuilder` builds for the same
        records."""
        labels = self._cat(self._labels, np.float64)
        offsets = self._cat(self._offsets, np.float64)
        weights = self._cat(self._weights, np.float64)
        self._labels = [labels[n:]] if n < len(labels) else []
        self._offsets = [offsets[n:]] if n < len(offsets) else []
        self._weights = [weights[n:]] if n < len(weights) else []
        uids = self._uids[:n]
        self._uids = self._uids[n:]

        shards = {}
        for s, imap in self._maps.items():
            vals_c, cols_c, rlen_c = self._shards[s]
            vals = self._cat(vals_c, np.float64)
            cols = self._cat(cols_c, np.int64)
            rlens = self._cat(rlen_c, np.int64)
            nnz = int(rlens[:n].sum())
            indptr = np.zeros(n + 1, np.int64)
            np.cumsum(rlens[:n], out=indptr[1:])
            mat = sp.csr_matrix(
                (vals[:nnz], cols[:nnz], indptr), shape=(n, len(imap)))
            _reject_duplicate_features(mat, imap, uids, s)
            shards[s] = mat
            self._shards[s] = ([vals[nnz:]] if nnz < len(vals) else [],
                               [cols[nnz:]] if nnz < len(cols) else [],
                               [rlens[n:]] if n < len(rlens) else [])
        ids = {}
        for t in self._id_types:
            ids[t] = np.asarray(self._ids[t][:n])
            self._ids[t] = self._ids[t][n:]
        self.rows -= n
        return GameDataset.build(
            responses=labels[:n],
            feature_shards=shards,
            ids=ids,
            offsets=offsets[:n],
            weights=weights[:n],
            uids=np.asarray([u if u is not None else "" for u in uids]),
        )


class BlockGameStream:
    """Bounded-memory streaming GAME ingest: iterate GameDatasets of
    <= ``batch_rows`` rows (exactly ``batch_rows`` except the final
    partial batch) decoded through the native C block decoder, or by the
    byte-identical record loop over the pure-Python codec.

    ``feeder``: "auto" (C when every file's schema fits the training
    layout, else the record loop), "native" (require the C path; raises
    RuntimeError when a schema does not fit), or "python" (the record
    loop over the pure-Python codec — parity tests, benchmarks). The C
    decoder is built at first use; a failed build raises.

    ``prefetch_depth``: > 0 decodes ahead on a background thread, holding
    at most that many finished batches (peak resident batches <=
    ``prefetch_depth + 2`` — see device_feed.HostPrefetcher); 0 decodes
    synchronously in the consumer's loop.

    Telemetry accumulates on the instance across iteration:
    ``decode_path`` ("native" | "python", resolved eagerly at
    construction), ``batches``, ``rows``, ``peak_resident_batches``.

    Each batch's entity vocabularies are batch-local — consumers joining
    against a model vocabulary must map through entity NAMES, which is
    exactly what the serving engine does.
    """

    def __init__(self, path, id_types: Sequence[str],
                 feature_shard_maps: Dict[str, IndexMap],
                 batch_rows: int, add_intercept: bool = True,
                 feeder: str = "auto", prefetch_depth: int = 2):
        if batch_rows < 1:
            raise ValueError(f"batch_rows must be >= 1, got {batch_rows}")
        if feeder not in FEEDERS:
            raise ValueError(f"feeder must be one of {FEEDERS}, "
                             f"got {feeder!r}")
        self._path = path
        self._id_types = tuple(id_types)
        self._maps = dict(feature_shard_maps)
        self._batch_rows = int(batch_rows)
        self._add_intercept = add_intercept
        self.prefetch_depth = max(0, int(prefetch_depth))
        self.batches = 0
        self.rows = 0
        self.peak_resident_batches = 0
        self.decode_seconds = 0.0
        self.prefetcher = None  # the last iteration's, for joining

        self._indexes: List[FileBlockIndex] = []
        self._layouts: list = []
        self.decode_path = "python"
        native = None if feeder == "python" else load_avro_native()
        why = None
        if native is not None:
            self._indexes = scan_paths(_avro_paths(path))
            why = self._compile_layouts()
            if why is None:
                self.decode_path = "native"
        if feeder == "native" and self.decode_path != "native":
            raise RuntimeError(
                f"feeder='native' requested but the C block path does not "
                f"apply: {why}")
        self._native = native if self.decode_path == "native" else None

    def _compile_layouts(self) -> Optional[str]:
        """Layout per file (aligned with self._indexes); returns a reason
        string when any file's schema can't decode natively, None on
        success."""
        self._layouts, why = _native_layouts(self._indexes,
                                             self._id_types)
        return why

    # -- iteration ---------------------------------------------------------

    def __iter__(self) -> Iterator[GameDataset]:
        src = self._timed(
            self._iter_native() if self.decode_path == "native"
            else self._iter_python())
        if self.prefetch_depth < 1:
            for ds in src:
                self.peak_resident_batches = max(
                    self.peak_resident_batches, 1)
                yield ds
            return
        prefetcher = self.prefetcher = HostPrefetcher(src,
                                                      self.prefetch_depth)
        try:
            yield from prefetcher
        finally:
            self.peak_resident_batches = max(self.peak_resident_batches,
                                             prefetcher.peak_resident)

    def _count(self, ds: GameDataset) -> GameDataset:
        self.batches += 1
        self.rows += ds.num_rows
        return ds

    def _timed(self, src: Iterator[GameDataset]
               ) -> Iterator[GameDataset]:
        """Accumulate the time spent producing each batch into
        ``decode_seconds`` (on the producer thread under prefetch)."""
        while True:
            t0 = time.perf_counter()
            with telemetry.span("decode"):
                ds = next(src, None)
            self.decode_seconds += time.perf_counter() - t0
            if ds is None:
                return
            yield ds

    def _iter_python(self) -> Iterator[GameDataset]:
        """The record-at-a-time loop — ONE copy of the python-path batch
        semantics via `_GameBatchBuilder` (shared with
        `read_game_dataset`'s fallback)."""
        batch = _GameBatchBuilder(self._maps, self._id_types,
                                  self._add_intercept)
        for rec in iter_records(self._path, native=False):
            batch.append(rec)
            if len(batch) >= self._batch_rows:
                yield self._count(batch.build())
                batch = _GameBatchBuilder(self._maps, self._id_types,
                                          self._add_intercept)
        if len(batch):
            yield self._count(batch.build())

    def _iter_native(self) -> Iterator[GameDataset]:
        shard_names = list(self._maps)
        dicts_t = tuple(self._maps[s].key_to_index_dict()
                        for s in shard_names)
        icepts_t = tuple(
            int(self._maps[s].intercept_index if self._add_intercept
                else -1)
            for s in shard_names)
        buf = _ColumnBuffer(self._maps, self._id_types)
        for ix, layout in zip(self._indexes, self._layouts):
            if not ix.blocks:
                continue
            with open(ix.path, "rb") as f:
                f.seek(ix.blocks[0].offset)
                for b in ix.blocks:
                    _, payload = read_block(
                        f, ix.codec, ix.sync, ix.path,
                        expected=(b.count, b.payload_bytes, b.offset))
                    try:
                        decoded = self._native.decode_training_block(
                            payload, b.count, layout.prog, layout.layout,
                            dicts_t, icepts_t, self._id_types, DELIMITER,
                            None)
                    except ValueError as e:
                        raise ValueError(
                            f"{ix.path}: block at offset {b.offset} "
                            f"failed to decode: {e}") from e
                    buf.put_block(decoded, b.count, layout)
                    while buf.rows >= self._batch_rows:
                        yield self._count(buf.take(self._batch_rows))
        if buf.rows:
            yield self._count(buf.take(buf.rows))

    def stats(self) -> dict:
        return {
            "decode_path": self.decode_path,
            "prefetch_depth": self.prefetch_depth,
            "batches": self.batches,
            "rows": self.rows,
            "peak_resident_batches": self.peak_resident_batches,
            "decode_seconds": self.decode_seconds,
        }


class BlockRandomAccess:
    """Random-access re-decode of container rows by GLOBAL row range —
    the miss path of the shard cache's fully out-of-core ``redecode``
    spill tier (data/shard_cache.py): evicted feature blocks keep NO
    host copy, and a cache miss re-decodes exactly the Avro container
    blocks that cover the requested rows through the same block index
    the sequential stream uses (`shard_planner.scan_container_blocks`).

    ``fetch_rows(row_start, n_rows)`` returns a GameDataset
    byte-identical to the ``BlockGameStream`` batch that covered rows
    ``[row_start, row_start + n_rows)`` at ingest, for the same maps /
    id types / intercept settings: the native path feeds the covering
    blocks through the same `_ColumnBuffer` cut, the python path feeds
    the covering records through the same `_GameBatchBuilder` — the two
    batch-construction code paths whose byte-identity
    tests/test_block_stream.py already pins.

    Cost per fetch: the covering container blocks are re-read from disk
    and re-decoded (a batch spans ceil(batch_rows / block_rows) + 1
    blocks); nothing else is touched, so host residency is O(one
    fetch). Instances keep cumulative ``payload_bytes_read`` /
    ``blocks_decoded`` / ``rows_fetched`` — the shard cache reads the
    payload-byte deltas into its ``bytes_redecoded`` telemetry.
    Instances are callable (``fetch(row_start, n_rows)``) so the cache
    can hold them as a plain hook."""

    def __init__(self, path, id_types: Sequence[str],
                 feature_shard_maps: Dict[str, IndexMap],
                 add_intercept: bool = True, feeder: str = "auto"):
        if feeder not in FEEDERS:
            raise ValueError(f"feeder must be one of {FEEDERS}, "
                             f"got {feeder!r}")
        self._id_types = tuple(id_types)
        self._maps = dict(feature_shard_maps)
        self._add_intercept = add_intercept
        self._indexes = scan_paths(_avro_paths(path))
        self.decode_path = "python"
        native = None if feeder == "python" else load_avro_native()
        why = None
        self._layouts: list = []
        if native is not None:
            self._layouts, why = _native_layouts(self._indexes,
                                                 self._id_types)
            if why is None:
                self.decode_path = "native"
        if feeder == "native" and self.decode_path != "native":
            raise RuntimeError(
                f"feeder='native' requested but the C block path does "
                f"not apply: {why}")
        self._native = native if self.decode_path == "native" else None
        self._schemas: dict = {}  # file idx -> parsed python schema root

        # Flattened (file idx, BlockSpan, global first row) table +
        # bisectable row starts: fetch maps a row range to the covering
        # block run in O(log blocks).
        self._blocks: list = []
        row = 0
        for fi, ix in enumerate(self._indexes):
            for b in ix.blocks:
                self._blocks.append((fi, b, row))
                row += b.count
        self.total_rows = row
        self._row_starts = [entry[2] for entry in self._blocks]
        self.payload_bytes_read = 0
        self.blocks_decoded = 0
        self.rows_fetched = 0

    def __call__(self, row_start: int, n_rows: int) -> GameDataset:
        return self.fetch_rows(row_start, n_rows)

    def _covering_blocks(self, row_start: int, n_rows: int):
        """Yield (file idx, BlockSpan) for the minimal block run
        covering the row range, reading each payload as it is needed."""
        first = bisect.bisect_right(self._row_starts, row_start) - 1
        need_until = row_start + n_rows
        i = first
        f = None
        cur_file = None
        try:
            while i < len(self._blocks) \
                    and self._blocks[i][2] < need_until:
                fi, b, _ = self._blocks[i]
                ix = self._indexes[fi]
                if fi != cur_file:
                    if f is not None:
                        f.close()
                    f = open(ix.path, "rb")
                    f.seek(b.offset)
                    cur_file = fi
                _, payload = read_block(
                    f, ix.codec, ix.sync, ix.path,
                    expected=(b.count, b.payload_bytes, b.offset))
                self.payload_bytes_read += b.payload_bytes
                self.blocks_decoded += 1
                yield fi, b, payload
                i += 1
        finally:
            if f is not None:
                f.close()

    def fetch_rows(self, row_start: int, n_rows: int) -> GameDataset:
        """Decode rows ``[row_start, row_start + n_rows)`` — see class
        docstring for the byte-identity contract."""
        if n_rows < 1:
            raise ValueError(f"n_rows must be >= 1, got {n_rows}")
        if row_start < 0 or row_start + n_rows > self.total_rows:
            raise ValueError(
                f"row range [{row_start}, {row_start + n_rows}) outside "
                f"the container ({self.total_rows} rows)")
        first = bisect.bisect_right(self._row_starts, row_start) - 1
        skip = row_start - self._blocks[first][2]
        self.rows_fetched += n_rows
        if self.decode_path == "native":
            return self._fetch_native(row_start, n_rows, skip)
        return self._fetch_python(row_start, n_rows, skip)

    def _fetch_native(self, row_start: int, n_rows: int,
                      skip: int) -> GameDataset:
        shard_names = list(self._maps)
        dicts_t = tuple(self._maps[s].key_to_index_dict()
                        for s in shard_names)
        icepts_t = tuple(
            int(self._maps[s].intercept_index if self._add_intercept
                else -1)
            for s in shard_names)
        buf = _ColumnBuffer(self._maps, self._id_types)
        for fi, b, payload in self._covering_blocks(row_start, n_rows):
            layout = self._layouts[fi]
            try:
                decoded = self._native.decode_training_block(
                    payload, b.count, layout.prog, layout.layout,
                    dicts_t, icepts_t, self._id_types, DELIMITER, None)
            except ValueError as e:
                raise ValueError(
                    f"{self._indexes[fi].path}: block at offset "
                    f"{b.offset} failed to decode: {e}") from e
            buf.put_block(decoded, b.count, layout)
        if skip:
            buf.take(skip)  # discard the head of the first block
        return buf.take(n_rows)

    def _fetch_python(self, row_start: int, n_rows: int,
                      skip: int) -> GameDataset:
        batch = _GameBatchBuilder(self._maps, self._id_types,
                                  self._add_intercept)
        pos = 0  # record position relative to the first covering block
        for fi, b, payload in self._covering_blocks(row_start, n_rows):
            root = self._schemas.get(fi)
            if root is None:
                root = Schema(self._indexes[fi].schema_json).root
                self._schemas[fi] = root
            src = io.BytesIO(payload)
            for _ in range(b.count):
                rec = read_datum(src, root)
                if skip <= pos < skip + n_rows:
                    batch.append(rec)
                pos += 1
        return batch.build()


def read_game_dataset_via_blocks(
    path, id_types: Sequence[str],
    feature_shard_maps: Dict[str, IndexMap],
    add_intercept: bool = True,
) -> Optional[GameDataset]:
    """One-shot GAME read through the C BLOCK decoder: the whole container
    decoded as one `BlockGameStream` batch (byte-identical to the record
    paths — the same `_ColumnBuffer.take` contract the per-batch identity
    tests pin down). This is `read_game_dataset`'s single-process fast
    path, which makes the block path the ONE C decode implementation for
    both streamed and one-shot reads. Returns None when the native path
    does not apply (a schema that does not fit the training layout) —
    callers fall back to the record loop."""
    stream = BlockGameStream(
        path, id_types=id_types, feature_shard_maps=feature_shard_maps,
        batch_rows=2 ** 62, add_intercept=add_intercept,
        feeder="auto", prefetch_depth=0)
    if stream.decode_path != "native":
        return None
    out = None
    for ds in stream:  # batch_rows spans the input: at most one batch
        out = ds
    return out
