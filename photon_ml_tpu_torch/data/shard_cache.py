"""Device-resident shard cache for out-of-core streaming training (port of
photon_ml_tpu/data/shard_cache.py: SpillBlock, encode_spill,
_decode_spill_impl, restore_spilled_features :157-320,
StreamedFixedEffectData, assemble_fixed_effect_batch :324-440, and the
DeviceShardCache :535-1150 with its 1-D mesh placement (``devices=``
:70-80, :496-497, :610-630, :904-935, :1140-1148) and its column blocks
(``col_blocks=``, ColumnSlice :442-463, :82-99, :564-632, :671-869,
_redecode_2d and _ensure_2d :968-1045, :1120-1143), its registry
mirrors :125-139 and spans :762, :946, :1039).

A `BlockGameStream` is consumed ONCE, batch by batch, and its rows land
on the device in one of two regimes:

- **exact assembly** (`assemble_fixed_effect_batch`): each batch's CSR
  slice uploads as it decodes (host residency stays O(batch_rows)) and
  the device pieces concatenate into the batch that
  `GameDataset.fixed_effect_batch` builds from a one-shot read, tensor
  for tensor (CSR cuts are row-contiguous, so values and column ids are
  literal slices of the one-shot arrays; casts are elementwise; the
  transpose is ordered as scipy orders it). The in-core solvers then run
  on the assembled batch, so ``--stream-train`` writes the one-shot
  driver's model while never holding more than a batch of rows on the
  host.

- **shard cache** (`DeviceShardCache`): each batch becomes a `CSRBlock`
  (ops/spmv.py: the CSR and its transpose, int32 indices, unpadded: the
  port's products need no static shapes) kept on the device, with the
  row-space columns (labels, offsets, weights) ALWAYS resident and an
  explicit ``hbm_budget_bytes`` that spills FEATURE blocks (Belady's
  furthest-next-use eviction on the cyclic shard order, not LRU).
  Solver iterations after the first replay cached blocks instead of
  re-decoding Avro; spilled blocks re-upload through `HostPrefetcher`
  and `chunked_device_put`, so the upload of shard k+1 overlaps the
  accumulate of shard k.

The budget binds the bytes the port really holds on the device for a
block, its transpose included (``CSRBlock.nbytes``, about 16 bytes an
entry in float32), where the JAX package counts its padded
float32/int32/int32 triplet (12 bytes an entry). Hits, misses and
evictions at the same budget therefore differ from the JAX package's;
the models do not.

The spill tier has two knobs:

- ``spill_dtype`` — ``"f32"`` (default) keeps the raw triplet at the
  cache's type (values, int32 column and row ids): re-uploads are the
  evicted bytes. ``"bf16"`` spills values as bfloat16 and the indices
  DELTA-ENCODED to u8/u16 (`encode_spill`; either stream falls back to
  raw int32 when a delta overflows or is negative). The restore decodes
  ON THE DEVICE with torch ops (an integer cumsum, a running max and a
  widening: exact), so the solver sees blocks of the cache's type.
  Values are quantized ONCE AT INGEST — never-evicted blocks take the
  same bf16 round trip — so a bf16 replay is deterministic and
  residency-independent, only less precise than the f32-spill model.
- ``spill_source`` — ``"buffer"`` (default) re-uploads host spill
  buffers; ``"redecode"`` keeps NO host copy: a miss re-decodes the Avro
  container blocks that produced the batch through a
  `BlockRandomAccess` row-range fetch (byte-identical to the ingest-time
  batch), inside the `blocks()` prefetch thread.

With ``devices`` (a 1-D mesh's slot devices, ``--mesh-devices``;
parallel/distributed.py), blocks place ROUND-ROBIN over the slots: block
i lives on ``devices[i % N]`` with its row-space columns, re-uploads and
re-decodes return to the block's slot, and ``hbm_budget_bytes`` binds PER
SLOT (each slot's resident feature bytes stay within it; Belady's rule
runs per slot, whose blocks are an index-arithmetic subsequence of the
shard order, so the global cyclic distance ranks them as the slot's own
replay does). Placement is a pure function of the block index, so the
shard order, and with it every fold's order, does not move. A one-slot
list (or None) is exactly the single-pool cache.

With ``col_blocks=C`` (> 1; the 2-D mesh, ``--mesh-shape RxC``) each
batch's CSR is cut into C column blocks of ceil(d / C) columns
(parallel/distributed.py ``split_csr_columns``: local column ids, each
block's entries an order-preserving subsequence of the batch's) and the
unit of placement, eviction and spill is the COLUMN SLICE (``ColumnSlice``,
a ``CSRBlock`` of width ceil(d / C)): slice c of shard i lives on slot
``(i % R) * C + c`` of the row-major ``devices`` (R = len(devices) / C),
spilled and restored through its own record in every tier (the
``redecode`` tier re-decodes the batch once and re-cuts only the missing
slices). The row-space columns live on the row's HOME slot
``(i % R) * C + C - 1``, with the blocks' row lengths [C, rows]; the home
slice also holds the product stream (ops/spmv.py ``EntryStream``: the
full rows' offsets and the map from their entry order to the slices'
concatenated products), counted in its bytes, rebuilt from the lengths
when it is restored. ``hbm_budget_bytes`` binds per slot and Belady's
rule runs per slot, as in the 1-D case: a slot's slices are an
index-arithmetic subsequence of the shard order. ``col_blocks=1`` is the
1-D cache, bit for bit.

The registry metrics ``data.shard_cache.*`` mirror ``stats()`` (while
telemetry is on; ``col_blocks`` and ``col_block_size`` as gauges, set
only with column blocks); each block's ingest upload is a
``shard_upload`` span, a buffer restore ``shard_reupload`` and a
re-decode ``shard_redecode``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.data.device_feed import (
    HostPrefetcher,
    chunked_device_put,
)
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops.features import (
    DENSE_DENSITY_THRESHOLD,
    CSRFeatures,
    DenseFeatures,
)
from photon_ml_tpu_torch.ops.glm_objective import GLMBatch
from photon_ml_tpu_torch.ops.spmv import (
    CSRBlock,
    EntryStream,
    block_from_triplet,
    block_lengths,
)

# Registry mirrors of the per-instance ``_stats`` (no-ops while
# telemetry is off); the JAX package's names.
_M_HITS = telemetry.counter("data.shard_cache.hits")
_M_MISSES = telemetry.counter("data.shard_cache.misses")
_M_EVICTIONS = telemetry.counter("data.shard_cache.evictions")
_M_REUPLOAD_BYTES = telemetry.counter("data.shard_cache.bytes_reuploaded")
_M_SPILL_WRITTEN = telemetry.counter("data.shard_cache.spill_bytes_written")
_M_REDECODE_BYTES = telemetry.counter("data.shard_cache.bytes_redecoded")
_M_EPOCHS = telemetry.counter("data.shard_cache.epochs")
_G_DEVICE_BYTES = telemetry.gauge("data.shard_cache.device_bytes")
_G_PEAK_BYTES = telemetry.gauge("data.shard_cache.peak_device_bytes")
# Host-side spill residency (stream_train.cache.spill_bytes_host).
_G_SPILL_HOST = telemetry.gauge("data.shard_cache.spill_bytes_host")
# The column blocks of a 2-D mesh's cache and their width (set only when
# col_blocks > 1).
_G_COL_BLOCKS = telemetry.gauge("data.shard_cache.col_blocks")
_G_COL_BLOCK_SIZE = telemetry.gauge("data.shard_cache.col_block_size")

Tensor = torch.Tensor

SPILL_DTYPES = ("f32", "bf16")
SPILL_SOURCES = ("buffer", "redecode")

_NUMPY_OF = {torch.float32: np.float32, torch.float64: np.float64}


def _row_ids_i32(indptr: np.ndarray, offset: int = 0) -> np.ndarray:
    n = len(indptr) - 1
    return (np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
            + offset).astype(np.int32)


def _mesh_devices(devices, col_blocks) -> Optional[List[torch.device]]:
    """The slot devices of a mesh placement (None for one slot or
    none), checked against the column blocks of a 2-D mesh (JAX's
    messages)."""
    devs = (None if devices is None or len(devices) < 2
            else [resolve_device(d) for d in devices])
    if int(col_blocks) < 1:
        raise ValueError(f"col_blocks must be >= 1, got {col_blocks}")
    if int(col_blocks) > 1:
        if devs is None:
            raise ValueError(
                "col_blocks > 1 places column blocks on a (data, model) "
                "device grid — pass devices="
                "mesh_fold_devices(make_mesh_2d(R, C))")
        if len(devs) % int(col_blocks):
            raise ValueError(
                f"{len(devs)} devices do not tile a grid with {col_blocks} "
                "column blocks — need a multiple of col_blocks")
    return devs


def _check_spill_options(spill_dtype: str, spill_source: str) -> None:
    if spill_dtype not in SPILL_DTYPES:
        raise ValueError(
            f"spill_dtype must be one of {SPILL_DTYPES}, got "
            f"{spill_dtype!r}")
    if spill_source not in SPILL_SOURCES:
        raise ValueError(
            f"spill_source must be one of {SPILL_SOURCES}, got "
            f"{spill_source!r}")
    if spill_source == "redecode" and spill_dtype != "f32":
        raise ValueError(
            f"spill_dtype={spill_dtype!r} compresses host spill "
            "buffers, but spill_source='redecode' keeps none — the "
            "combination would silently train as f32 while "
            "reporting bf16; pick one")


# ---------------------------------------------------------------------------
# Spill codecs: compressed host buffers + on-device restore
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpillBlock:
    """Host spill record of one evicted feature block (unpadded: entry
    k < nnz of each array is the block's k-th entry). Encodings per
    ``dtype_tag``:

    - ``"f32"``: the raw triplet — ``enc_values`` in the cache's type,
      ``enc_cols``/``enc_rows`` int32. Restore re-uploads them verbatim.
    - ``"bf16"``: ``enc_values`` the bit patterns (uint16) of the
      bfloat16 round-to-nearest-even of the values; ``enc_cols`` u8/u16
      per-row delta codes (absolute column at each row start, positive
      within-row diffs after); ``enc_rows`` u8/u16 non-negative diffs of
      the non-decreasing row ids. Either index stream falls back to raw
      int32 when a delta overflows u16 or is negative.

    The ``enc_*`` fields are consumed only by
    :func:`restore_spilled_features`.
    """

    nnz: int
    enc_values: np.ndarray
    enc_cols: np.ndarray
    enc_rows: np.ndarray
    dtype_tag: str  # "f32" | "bf16"

    @property
    def nbytes(self) -> int:
        return (self.enc_values.nbytes + self.enc_cols.nbytes
                + self.enc_rows.nbytes)


def _shrink_deltas(deltas: np.ndarray, raw: np.ndarray) -> np.ndarray:
    """The narrowest unsigned code that holds every delta; the RAW int32
    ids when a delta is negative or exceeds u16 (decode then skips the
    cumulative reconstruction)."""
    lo = int(deltas.min()) if len(deltas) else 0
    hi = int(deltas.max()) if len(deltas) else 0
    if lo < 0 or hi > np.iinfo(np.uint16).max:
        return raw.astype(np.int32)
    code = np.uint8 if hi <= np.iinfo(np.uint8).max else np.uint16
    return deltas.astype(code)


def bf16_bits(values: np.ndarray) -> np.ndarray:
    """uint16 bit patterns of the bfloat16 round-to-nearest-even of
    ``values``."""
    t = torch.from_numpy(np.ascontiguousarray(values)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def encode_spill(values: np.ndarray, cols: np.ndarray, rows: np.ndarray,
                 nnz: int, spill_dtype: str) -> SpillBlock:
    """Triplet -> host spill record (see SpillBlock). ``values/cols/rows``
    are the block's arrays (``cols``/``rows`` int32, local row ids);
    ``nnz`` is their entry count. The f32 tag stores them as they are."""
    if spill_dtype not in SPILL_DTYPES:
        raise ValueError(
            f"spill_dtype must be one of {SPILL_DTYPES}, got "
            f"{spill_dtype!r}")
    if spill_dtype == "f32":
        return SpillBlock(nnz=nnz, enc_values=values, enc_cols=cols,
                          enc_rows=rows, dtype_tag="f32")
    c = cols[:nnz].astype(np.int64)
    r = rows[:nnz].astype(np.int64)
    cd = c.copy()
    cd[1:] -= c[:-1]
    if nnz:
        # Absolute column at each row start (the first entry is one).
        starts = np.empty(nnz, bool)
        starts[0] = True
        starts[1:] = r[1:] != r[:-1]
        cd[starts] = c[starts]
    rd = r.copy()
    rd[1:] -= r[:-1]
    return SpillBlock(
        nnz=nnz, enc_values=bf16_bits(values[:nnz]),
        enc_cols=_shrink_deltas(cd, cols[:nnz]),
        enc_rows=_shrink_deltas(rd, rows[:nnz]),
        dtype_tag="bf16")


def decode_spill(values: Tensor, col_codes: Tensor, row_codes: Tensor,
                 dtype, cols_raw: bool = False, rows_raw: bool = False
                 ) -> tuple:
    """Device-side bf16 spill decode (port of _decode_spill_impl :249):
    widen the bfloat16 values (``values``: their bits as int16) to
    ``dtype`` and un-delta the index streams (``*_codes``: the u8/u16
    codes widened to int64, or the raw ids where ``*_raw``), with torch
    ops on the tensors' device. Every step is exact (a widening, integer
    cumsums and a running max), so the result is the same bits on every
    call."""
    vals = values.view(torch.bfloat16).to(dtype)
    rows = row_codes if rows_raw else torch.cumsum(row_codes, 0)
    if cols_raw:
        cols = col_codes
    else:
        d = col_codes
        cum = torch.cumsum(d, 0)
        start = torch.ones_like(rows, dtype=torch.bool)
        start[1:] = rows[1:] != rows[:-1]
        base = cum - d  # prefix sum before each element
        # Bases at row starts are non-decreasing (deltas >= 0), so a
        # running max carries each row's re-base forward.
        if len(base):
            corr = torch.cummax(
                torch.where(start, base, torch.zeros_like(base)), 0).values
            cols = cum - corr
        else:
            cols = cum
    return vals, cols.to(torch.int32), rows.to(torch.int32)


def _upload_codes(a: np.ndarray, device) -> Tensor:
    """An index stream on the device as int64: u8 and u16 codes travel at
    their own width (u16 as its int16 bits) and widen there."""
    if a.dtype == np.uint16:
        return chunked_device_put(a.view(np.int16), device=device).to(
            torch.int64) & 0xFFFF
    return chunked_device_put(a, device=device).to(torch.int64)


def restore_spilled_features(spill: SpillBlock, n_rows: int,
                             n_features: int, device,
                             dtype=torch.float32) -> CSRBlock:
    """The ONE spill -> device path: re-upload the record and rebuild the
    block in ``dtype``. f32 spill re-uploads the evicted bytes verbatim;
    bf16 spill uploads the encodings and decodes them on the device
    (`decode_spill`)."""
    if spill.dtype_tag == "f32":
        return block_from_triplet(
            chunked_device_put(spill.enc_values, device=device),
            chunked_device_put(spill.enc_cols, device=device),
            chunked_device_put(spill.enc_rows, device=device), n_rows,
            n_features)
    vals, cols, rows = decode_spill(
        chunked_device_put(spill.enc_values.view(np.int16), device=device),
        _upload_codes(spill.enc_cols, device),
        _upload_codes(spill.enc_rows, device), dtype,
        cols_raw=spill.enc_cols.dtype == np.int32,
        rows_raw=spill.enc_rows.dtype == np.int32)
    return block_from_triplet(vals, cols, rows, n_rows, n_features)


# ---------------------------------------------------------------------------
# Exact assembly: streamed ingest -> the one-shot device batch, bit for bit
# ---------------------------------------------------------------------------


class StreamedFixedEffectData:
    """Stand-in for the GameDataset a FixedEffectCoordinate consumes: the
    feature batch is already assembled on the device from a stream, so
    `fixed_effect_batch` hands it back instead of uploading host CSR. It
    has exactly the surface the fixed-effect training path touches
    (`num_rows`, `feature_shards[...].shape`, the row columns
    `responses`/`offsets`/`weights`, `fixed_effect_batch`)."""

    class _ShapeOnly:
        def __init__(self, shape):
            self.shape = shape

    def __init__(self, shard_id: str, batch: GLMBatch, n_rows: int, d: int,
                 ingest_stats: dict):
        self._shard_id = shard_id
        self._batch = batch
        self._n_rows = int(n_rows)
        self.feature_shards = {shard_id: self._ShapeOnly((n_rows, d))}
        # Device columns of the solver type: the consumer's
        # torch.as_tensor(col, dtype, device) is then the tensor itself,
        # equal to the one-shot float64 -> dtype cast.
        self.responses = batch.labels
        self.offsets = batch.offsets
        self.weights = batch.weights
        self.ingest_stats = dict(ingest_stats)

    @property
    def num_rows(self) -> int:
        return self._n_rows

    def fixed_effect_batch(self, shard_id: str, dtype=None, device=None,
                           extra_offsets=None) -> GLMBatch:
        """The assembled batch (``device`` is accepted for
        GameDataset's signature: the batch is where it was assembled)."""
        if shard_id != self._shard_id:
            raise KeyError(
                f"streamed ingest assembled shard {self._shard_id!r}, "
                f"coordinate asked for {shard_id!r}")
        if dtype is not None and dtype != self._batch.labels.dtype:
            raise ValueError(
                f"streamed batch was assembled as "
                f"{self._batch.labels.dtype}, asked for {dtype}")
        if extra_offsets is None:
            return self._batch
        return self._batch.with_offsets(
            self._batch.offsets + torch.as_tensor(
                extra_offsets, dtype=self._batch.offsets.dtype,
                device=self._batch.offsets.device))


def _crow_from_lengths(lengths: Tensor) -> Tensor:
    crow = torch.zeros(lengths.shape[0] + 1, dtype=torch.int32,
                       device=lengths.device)
    crow[1:] = torch.cumsum(lengths, 0)
    return crow


def assemble_fixed_effect_batch(
    stream, shard_id: str, dtype=torch.float32, device="cuda",
    dense_threshold: float = DENSE_DENSITY_THRESHOLD,
) -> StreamedFixedEffectData:
    """Consume a BlockGameStream into ONE device GLMBatch, tensor for
    tensor equal to ``read_game_dataset(...)[0].fixed_effect_batch(
    shard_id, dtype, device)``.

    Host residency is O(batch_rows): each decoded batch's arrays upload
    and are dropped before the next batch decodes. The dense-vs-CSR
    layout is decided from the GLOBAL density after the stream ends, as
    `features_to_device` decides it on the full matrix."""
    dev = resolve_device(device)
    vals_p, cols_p, lens_p = [], [], []
    lab_p, off_p, wgt_p = [], [], []
    n_rows = 0
    nnz = 0
    d = None
    for ds in stream:
        mat = ds.feature_shards[shard_id].tocsr()
        d = mat.shape[1]
        if ds.num_rows == 0:
            continue
        vals_p.append(chunked_device_put(mat.data, dtype, dev))
        cols_p.append(chunked_device_put(mat.indices.astype(np.int64),
                                         device=dev))
        lens_p.append(chunked_device_put(np.diff(mat.indptr).astype(
            np.int64), device=dev))
        lab_p.append(chunked_device_put(ds.responses, dtype, dev))
        off_p.append(chunked_device_put(ds.offsets, dtype, dev))
        wgt_p.append(chunked_device_put(ds.weights, dtype, dev))
        n_rows += ds.num_rows
        nnz += mat.nnz
    if n_rows == 0:
        raise ValueError("stream yielded no rows to assemble")

    def cat(parts):
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    values, col_ids, lengths = cat(vals_p), cat(cols_p), cat(lens_p)
    row_ids = torch.repeat_interleave(
        torch.arange(n_rows, dtype=torch.int64, device=dev), lengths)
    density = nnz / max(1, n_rows * d)
    if density >= dense_threshold:
        # The one-shot path densifies before upload; scattering the CSR
        # pieces into zeros gives the same array (no duplicates, and the
        # float64 -> dtype cast already happened elementwise).
        x = torch.zeros((n_rows, d), dtype=dtype, device=dev)
        x[row_ids, col_ids] = values
        feats = DenseFeatures(x)
    else:
        # csr_from_scipy's arrays: the CSR, and its transpose ordered by
        # column then row (scipy's csr.T.tocsr()), int32 indices.
        order = torch.argsort(col_ids, stable=True)
        feats = CSRFeatures(
            csr=torch.sparse_csr_tensor(
                _crow_from_lengths(lengths), col_ids.to(torch.int32), values,
                size=(n_rows, d), check_invariants=True),
            csr_t=torch.sparse_csr_tensor(
                _crow_from_lengths(torch.bincount(col_ids, minlength=d)),
                row_ids[order].to(torch.int32), values[order],
                size=(d, n_rows), check_invariants=True),
            values=values, col_ids=col_ids, row_ids=row_ids,
            n_rows=n_rows, n_features=int(d))
    batch = GLMBatch(features=feats, labels=cat(lab_p), offsets=cat(off_p),
                     weights=cat(wgt_p))
    stats = dict(stream.stats())
    stats.update({"assembled_rows": n_rows, "assembled_nnz": nnz,
                  "density": density,
                  "layout": type(feats).__name__})
    return StreamedFixedEffectData(shard_id, batch, n_rows, int(d), stats)


# ---------------------------------------------------------------------------
# The shard cache: device blocks, replay-aware spill, prefetch
# ---------------------------------------------------------------------------


def _drop(unit) -> None:
    """Evict a feature unit (a shard, or a column slice with its product
    stream)."""
    unit.feats = None
    if isinstance(unit, ColumnSlice):
        unit.stream = None


@dataclasses.dataclass
class ColumnSlice:
    """One (shard, column block) unit of a ``col_blocks > 1`` cache: the
    shard's entries whose columns lie in block ``c``, with local column
    ids (a ``CSRBlock`` of the block's width). The slice, not the shard,
    is the unit of placement (slot ``(i % R) * C + c``), eviction and
    spill. The home slice (c = C - 1) also holds the shard's product
    stream (``stream``), counted in its ``feature_bytes``."""

    c: int
    nnz: int
    spill: Optional[SpillBlock]
    feature_bytes: int
    feats: Optional[CSRBlock] = None  # None = spilled
    device: Optional[torch.device] = None
    slot: int = 0
    stream: Optional[EntryStream] = None  # the home slice's, while resident

    @property
    def spill_bytes(self) -> int:
        return 0 if self.spill is None else self.spill.nbytes


@dataclasses.dataclass
class CachedShard:
    """One streamed batch on the device. Row-space columns (labels,
    offsets, weights) are ALWAYS resident — keeping them is what makes
    the margin-cached line search feature-pass-free. The feature block
    (``feats``) is the evictable part; ``spill`` is the host record it
    restores from (None in the ``redecode`` tier, where a miss re-decodes
    the source Avro rows instead).

    With ``col_blocks > 1`` the features are the ``cols`` slices
    (``feats``/``spill`` None), ``device``/``slot`` are the HOME slot's,
    and ``lengths`` [C, rows] (int32, resident there) are the slices' row
    lengths, from which the product stream is rebuilt."""

    index: int
    n_rows: int
    nnz: int
    row_offset: int  # first global row id
    labels: Tensor
    offsets: Tensor
    weights: Tensor
    spill: Optional[SpillBlock]
    feature_bytes: int  # CSRBlock.nbytes while resident
    feats: Optional[CSRBlock] = None  # None = spilled
    device: Optional[torch.device] = None  # where the block lives
    slot: int = 0  # mesh slot (index % slots); 0 without a mesh
    cols: Optional[List[ColumnSlice]] = None  # col_blocks > 1 units
    lengths: Optional[Tensor] = None  # [C, rows] row lengths of cols

    @property
    def spill_bytes(self) -> int:
        if self.cols is not None:
            return sum(u.spill_bytes for u in self.cols)
        return 0 if self.spill is None else self.spill.nbytes


@dataclasses.dataclass(frozen=True)
class ResidentBlock:
    """A shard handed out by `DeviceShardCache.blocks()`: a SNAPSHOT
    holding its own reference to the feature block, so a later eviction
    (which only drops the cache's reference) never pulls it from under
    an accumulate."""

    index: int
    n_rows: int
    feats: Optional[CSRBlock]
    labels: Tensor
    offsets: Tensor
    weights: Tensor
    slot: int = 0  # the slot the block (and its partials) live on
    # col_blocks > 1: the column slices in column order (feats None) and
    # the product stream on the home slot (``slot``).
    cols: tuple = ()
    stream: Optional[EntryStream] = None


class DeviceShardCache:
    """Device cache of feature blocks over a streamed ingest.

    Built once from a `BlockGameStream` (`from_stream`); every solver
    pass then replays `blocks()` in FIXED shard order — the accumulation
    order is part of the numeric contract, so resident, spilled and
    re-uploaded replays give the same partials (re-uploaded bytes are
    the evicted bytes, and the product is deterministic).

    ``hbm_budget_bytes`` bounds the feature bytes resident on the
    device; None means unbounded (fully resident, spill buffers freed).
    The budget is enforced DURING ingest (evict-as-you-go, so the ingest
    peak is O(budget)) and on every re-upload. Eviction is Belady's rule
    for the known cyclic replay: the victim is the resident block whose
    next use is FURTHEST in the cyclic order from the block in hand.
    Plain LRU degenerates to a 0% hit rate here (with n shards and room
    for n-1, the least-recently-used block is always the next one
    needed). The in-hand block is never evicted, so one block can exceed
    a too-small budget.

    ``devices`` (two or more) places block i on ``devices[i % N]`` and
    makes the budget bind per slot (module docstring); ``device`` is then
    ``devices[0]``, where the solver's [d]-space state lives.
    ``col_blocks`` (> 1) cuts every block into that many column slices
    over a 2-D mesh's row-major ``devices`` (module docstring).
    """

    def __init__(self, entries: List[CachedShard], n_rows: int,
                 n_features: int, dtype=torch.float32,
                 hbm_budget_bytes: Optional[int] = None,
                 prefetch_depth: int = 2,
                 ingest_stats: Optional[dict] = None,
                 devices: Optional[List] = None,
                 spill_dtype: str = "f32",
                 spill_source: str = "buffer",
                 shard_id: Optional[str] = None,
                 redecode_fetch: Optional[Callable] = None,
                 col_blocks: int = 1, device="cuda"):
        devs = _mesh_devices(devices, col_blocks)
        _check_spill_options(spill_dtype, spill_source)
        if spill_source == "redecode" and hbm_budget_bytes is not None \
                and redecode_fetch is None:
            raise ValueError(
                "spill_source='redecode' needs a redecode_fetch "
                "callable (BlockRandomAccess.fetch_rows) to re-decode "
                "evicted blocks from")
        self._entries = entries
        self.n_rows = int(n_rows)
        self.n_features = int(n_features)
        self.dtype = dtype
        self.devices = devs
        self.n_slots = len(devs) if devs else 1
        self.col_blocks = int(col_blocks)
        # The uniform column-block width (split_csr_columns' rule); the
        # 2-D objective slices the coefficients by it.
        self.col_block_size = -(-self.n_features // self.col_blocks)
        self.device = devs[0] if devs else resolve_device(device)
        for e in entries:
            if e.device is None:
                e.device = self.device
        self.hbm_budget_bytes = hbm_budget_bytes
        self.prefetch_depth = max(0, int(prefetch_depth))
        self.ingest_stats = dict(ingest_stats or {})
        self.spill_dtype = spill_dtype
        self.spill_source = spill_source
        self._shard_id = shard_id
        self._redecode_fetch = redecode_fetch
        self._stats = {"hits": 0, "misses": 0, "evictions": 0,
                       "bytes_reuploaded": 0, "epochs": 0,
                       "spill_bytes_written": 0, "redecodes": 0,
                       "bytes_redecoded": 0}
        self._slot_bytes = [0] * self.n_slots
        for _, u in self._all_units():
            if u.feats is not None:
                self._slot_bytes[u.slot] += u.feature_bytes
        self.peak_device_bytes = self.device_bytes
        if hbm_budget_bytes is None:
            for _, u in self._all_units():
                u.spill = None
        _G_SPILL_HOST.set(self.spill_bytes_host)
        if self.col_blocks > 1:
            _G_COL_BLOCKS.set(self.col_blocks)
            _G_COL_BLOCK_SIZE.set(self.col_block_size)

    def _all_units(self):
        """(entry, evictable feature unit) pairs in shard order: the
        CachedShard itself, or its ColumnSlices with col_blocks > 1."""
        for e in self._entries:
            if e.cols is not None:
                for u in e.cols:
                    yield e, u
            else:
                yield e, e

    @property
    def spill_bytes_host(self) -> int:
        """Host bytes retained by spill records: O(dataset) for
        ``buffer`` spill (f32, or about a third for bf16), 0 for
        ``redecode``. Constant after ingest."""
        return sum(e.spill_bytes for e in self._entries)

    @property
    def device_bytes(self) -> int:
        """Feature bytes resident, summed over the slots (with a mesh the
        budget binds per slot: ``stats()["per_device_bytes"]``)."""
        return sum(self._slot_bytes)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_stream(cls, stream, shard_id: str, dtype=torch.float32,
                    hbm_budget_bytes: Optional[int] = None,
                    prefetch_depth: int = 2,
                    devices: Optional[List] = None,
                    spill_dtype: str = "f32",
                    spill_source: str = "buffer",
                    redecode_fetch: Optional[Callable] = None,
                    col_blocks: int = 1, device="cuda"
                    ) -> "DeviceShardCache":
        """Ingest pass: decode (prefetched, by the stream) -> block ->
        upload. With an ``hbm_budget`` the budget is enforced AS blocks
        upload — the most recently ingested block spills first (its next
        use, at the start of the first replay, is the furthest away), so
        the ingest peak stays O(budget + one block) and the resident set
        ends as a PREFIX of the shard order. ``devices`` (two or more)
        places block i on ``devices[i % N]``, and the budget then binds
        each slot's bytes, evicting within the new block's own slot."""
        devs = _mesh_devices(devices, col_blocks)
        _check_spill_options(spill_dtype, spill_source)
        n_slots = len(devs) if devs else 1
        n_cols = int(col_blocks)
        n_row_slots = n_slots // n_cols
        home = devs[0] if devs else resolve_device(device)
        np_dtype = _NUMPY_OF[dtype]
        keep_buffers = (hbm_budget_bytes is not None
                        and spill_source == "buffer")
        entries: List[CachedShard] = []
        n_rows = 0
        d = None
        slot_bytes = [0] * n_slots
        peak_bytes = 0
        evictions = 0
        spill_written = 0

        def build_unit(mat, n, width, dev):
            """Spill-encode and upload one feature unit (the whole
            shard, or one column slice): (spill record, block)."""
            nonlocal spill_written
            values = mat.data.astype(np_dtype)
            cols = mat.indices.astype(np.int32)
            rows = _row_ids_i32(mat.indptr)
            spill = None
            if keep_buffers:
                spill = encode_spill(values, cols, rows, int(mat.nnz),
                                     spill_dtype)
                spill_written += spill.nbytes
                _M_SPILL_WRITTEN.inc(spill.nbytes)
            if spill is not None and spill.dtype_tag != "f32":
                # Lossy spill encodings quantize AT INGEST: every block
                # takes the same encode -> restore round trip whether or
                # not it ever spills, so bf16 replays stay deterministic
                # and residency-independent.
                return spill, restore_spilled_features(spill, n, width,
                                                       dev, dtype)
            return spill, block_from_triplet(
                chunked_device_put(values, device=dev),
                chunked_device_put(cols, device=dev),
                chunked_device_put(rows, device=dev), n, width)

        for ds in stream:
            with telemetry.span("shard_upload"):
                if ds.num_rows == 0:
                    continue
                r_slot = len(entries) % n_row_slots
                # With column blocks the row-space columns live on the
                # row's HOME slot, the last column's.
                slot = r_slot * n_cols + n_cols - 1
                dev = devs[slot] if devs else home
                mat = ds.feature_shards[shard_id].tocsr()
                d = mat.shape[1]
                cols_list, lengths = None, None
                if n_cols > 1:
                    from photon_ml_tpu_torch.parallel.distributed import (
                        split_csr_columns,
                    )

                    width, subs = split_csr_columns(mat, n_cols)
                    cols_list = []
                    for c, sub in enumerate(subs):
                        c_slot = r_slot * n_cols + c
                        sp_c, f_c = build_unit(sub, ds.num_rows, width,
                                               devs[c_slot])
                        cols_list.append(ColumnSlice(
                            c=c, nnz=int(sub.nnz), spill=sp_c,
                            feature_bytes=f_c.nbytes, feats=f_c,
                            device=devs[c_slot], slot=c_slot))
                    lengths = block_lengths(
                        [u.feats for u in cols_list]).to(dev)
                    last = cols_list[-1]
                    last.stream = EntryStream(lengths, dtype)
                    last.feature_bytes += last.stream.nbytes
                    spill, feats = None, None
                else:
                    spill, feats = build_unit(mat, ds.num_rows, d, dev)

                def col(x):
                    return chunked_device_put(np.asarray(x), dtype, dev)

                e = CachedShard(
                    index=len(entries), n_rows=ds.num_rows,
                    nnz=int(mat.nnz), row_offset=n_rows,
                    labels=col(ds.responses), offsets=col(ds.offsets),
                    weights=col(ds.weights), spill=spill,
                    feature_bytes=(feats.nbytes if feats is not None else
                                   sum(u.feature_bytes for u in cols_list)),
                    feats=feats, device=dev, slot=slot, cols=cols_list,
                    lengths=lengths)
                entries.append(e)
                n_rows += ds.num_rows
                new_units = cols_list if cols_list is not None else [e]
                for u in new_units:
                    slot_bytes[u.slot] += u.feature_bytes
                peak_bytes = max(peak_bytes, sum(slot_bytes))
                if hbm_budget_bytes is not None:
                    # Evict-as-you-go within each new unit's slot, most
                    # recent first (keep the prefix), never the shard
                    # just uploaded.
                    for u in new_units:
                        for victim in reversed(entries[:-1]):
                            if slot_bytes[u.slot] <= hbm_budget_bytes:
                                break
                            vu = (victim.cols[u.slot % n_cols]
                                  if victim.cols is not None else victim)
                            if vu.slot == u.slot and vu.feats is not None:
                                _drop(vu)
                                slot_bytes[u.slot] -= vu.feature_bytes
                                evictions += 1
                                _M_EVICTIONS.inc()
        if not entries:
            raise ValueError("stream yielded no rows to cache")
        cache = cls(entries, n_rows, int(d), dtype,
                    hbm_budget_bytes=hbm_budget_bytes,
                    prefetch_depth=prefetch_depth,
                    ingest_stats=stream.stats(),
                    spill_dtype=spill_dtype, spill_source=spill_source,
                    shard_id=shard_id, redecode_fetch=redecode_fetch,
                    devices=devs, col_blocks=n_cols, device=home)
        cache._stats["evictions"] += evictions
        cache._stats["spill_bytes_written"] += spill_written
        cache.peak_device_bytes = max(cache.peak_device_bytes, peak_bytes)
        if hbm_budget_bytes is not None:
            # The final block stayed pinned during ingest; settle to the
            # budget with the replay-aware rule (next use = shard 0).
            cache._enforce_budget(pinned=-1)
        # Residency gauges even when nothing evicts.
        _G_DEVICE_BYTES.set(cache.device_bytes)
        _G_PEAK_BYTES.set(cache.peak_device_bytes)
        return cache

    # -- residency management ----------------------------------------------

    @property
    def n_shards(self) -> int:
        return len(self._entries)

    @property
    def entries(self) -> List[CachedShard]:
        return list(self._entries)

    def _enforce_budget(self, pinned: int) -> None:
        """Evict until within budget, slot by slot. Victim = the slot's
        resident block whose next use is FURTHEST in the fixed cyclic
        replay order from the block in hand (`pinned`; -1 = before an
        epoch, i.e. next use starts at shard 0). A slot's blocks are an
        index-arithmetic subsequence of the shard order, so the global
        cyclic distance ranks them as the slot's own replay does."""
        budget = self.hbm_budget_bytes
        if budget is None:
            return
        n = len(self._entries)
        cur = pinned if pinned >= 0 else 0
        for slot in range(self.n_slots):
            if self._slot_bytes[slot] <= budget:
                continue
            resident = [(e, u) for e, u in self._all_units()
                        if u.feats is not None and e.index != pinned
                        and u.slot == slot]
            # descending cyclic distance (j - cur) mod n: furthest next
            # use first (a slot holds one unit a shard at most).
            resident.sort(key=lambda p: -((p[0].index - cur) % n))
            while self._slot_bytes[slot] > budget and resident:
                _, victim = resident.pop(0)
                _drop(victim)
                self._slot_bytes[slot] -= victim.feature_bytes
                self._stats["evictions"] += 1
                _M_EVICTIONS.inc()
        _G_DEVICE_BYTES.set(self.device_bytes)

    def _redecode(self, e: CachedShard) -> CSRBlock:
        """redecode-tier miss: re-decode the block's source rows through
        the random-access block fetch and re-upload. The fetched batch is
        byte-identical to the ingest-time batch (deterministic block
        cut), so the block — hence every partial — is the resident
        replay's."""
        fetch = self._redecode_fetch
        before = getattr(fetch, "payload_bytes_read", None)
        with telemetry.span("shard_redecode"):
            ds = fetch(e.row_offset, e.n_rows)
            mat = ds.feature_shards[self._shard_id].tocsr()
            if mat.shape[0] != e.n_rows or int(mat.nnz) != e.nnz:
                raise RuntimeError(
                    f"re-decoded shard {e.index} does not match the "
                    f"ingested block: got {mat.shape[0]} rows/{mat.nnz} "
                    f"nnz, cached {e.n_rows}/{e.nnz} — the input "
                    "changed under the cache")
            spill = SpillBlock(
                nnz=e.nnz,
                enc_values=mat.data.astype(_NUMPY_OF[self.dtype]),
                enc_cols=mat.indices.astype(np.int32),
                enc_rows=_row_ids_i32(mat.indptr), dtype_tag="f32")
        self._stats["redecodes"] += 1
        after = getattr(fetch, "payload_bytes_read", None)
        redecoded = (after - before if before is not None
                     and after is not None else e.feature_bytes)
        self._stats["bytes_redecoded"] += redecoded
        _M_REDECODE_BYTES.inc(redecoded)
        return restore_spilled_features(spill, e.n_rows, self.n_features,
                                        e.device, self.dtype)

    def _redecode_2d(self, e: CachedShard, missing: List[ColumnSlice]
                     ) -> None:
        """redecode-tier miss of a column-blocked shard: ONE row-range
        fetch re-decodes the batch, the ingest's column cut re-cuts it,
        and only the missing slices upload, each to its own slot."""
        from photon_ml_tpu_torch.parallel.distributed import (
            split_csr_columns,
        )

        fetch = self._redecode_fetch
        before = getattr(fetch, "payload_bytes_read", None)
        with telemetry.span("shard_redecode"):
            ds = fetch(e.row_offset, e.n_rows)
            mat = ds.feature_shards[self._shard_id].tocsr()
            if mat.shape[0] != e.n_rows or int(mat.nnz) != e.nnz:
                raise RuntimeError(
                    f"re-decoded shard {e.index} does not match the "
                    f"ingested block: got {mat.shape[0]} rows/{mat.nnz} "
                    f"nnz, cached {e.n_rows}/{e.nnz} — the input "
                    "changed under the cache")
            _, subs = split_csr_columns(mat, self.col_blocks)
            for u in missing:
                sub = subs[u.c]
                u.feats = restore_spilled_features(
                    SpillBlock(nnz=u.nnz,
                               enc_values=sub.data.astype(
                                   _NUMPY_OF[self.dtype]),
                               enc_cols=sub.indices.astype(np.int32),
                               enc_rows=_row_ids_i32(sub.indptr),
                               dtype_tag="f32"),
                    e.n_rows, self.col_block_size, u.device, self.dtype)
        self._stats["redecodes"] += 1
        after = getattr(fetch, "payload_bytes_read", None)
        redecoded = (after - before if before is not None
                     and after is not None
                     else sum(u.feature_bytes for u in missing))
        self._stats["bytes_redecoded"] += redecoded
        _M_REDECODE_BYTES.inc(redecoded)

    def _ensure_2d(self, e: CachedShard) -> ResidentBlock:
        """Column-blocked residency: a miss restores each evicted slice
        to its own slot (and the home slice's product stream from the
        resident row lengths); the snapshot carries the slices in column
        order."""
        missing = [u for u in e.cols if u.feats is None]
        if missing:
            self._stats["misses"] += 1
            _M_MISSES.inc()
            item = np.dtype(_NUMPY_OF[self.dtype]).itemsize
            reupload = 0
            for u in missing:
                if u.spill is not None:
                    reupload += u.spill.nbytes
                elif self._redecode_fetch is not None:
                    reupload += u.nnz * (item + 8)
                else:
                    raise RuntimeError(
                        f"shard {e.index} column block {u.c} was evicted "
                        "but has no spill buffers (cache built without an "
                        "hbm budget)")
            self._stats["bytes_reuploaded"] += reupload
            _M_REUPLOAD_BYTES.inc(reupload)
            for u in missing:
                self._slot_bytes[u.slot] += u.feature_bytes
            self.peak_device_bytes = max(self.peak_device_bytes,
                                         self.device_bytes)
            _G_PEAK_BYTES.set(self.peak_device_bytes)
            if missing[0].spill is not None:
                with telemetry.span("shard_reupload"):
                    for u in missing:
                        u.feats = restore_spilled_features(
                            u.spill, e.n_rows, self.col_block_size,
                            u.device, self.dtype)
            else:
                self._redecode_2d(e, missing)
            last = e.cols[-1]
            if last.stream is None:
                last.stream = EntryStream(e.lengths, self.dtype)
            self._enforce_budget(pinned=e.index)
        else:
            self._stats["hits"] += 1
            _M_HITS.inc()
        return ResidentBlock(index=e.index, n_rows=e.n_rows, feats=None,
                             labels=e.labels, offsets=e.offsets,
                             weights=e.weights, slot=e.slot,
                             cols=tuple(u.feats for u in e.cols),
                             stream=e.cols[-1].stream)

    def ensure(self, index: int) -> ResidentBlock:
        """A resident snapshot of the block, restored on a miss: buffer
        spill re-uploads (and decodes) the host record, the redecode
        tier re-decodes the source Avro rows."""
        e = self._entries[index]
        if e.cols is not None:
            return self._ensure_2d(e)
        if e.feats is None:
            self._stats["misses"] += 1
            _M_MISSES.inc()
            if e.spill is not None:
                reupload = e.spill.nbytes
            elif self._redecode_fetch is not None:
                # The re-decoded triplet that uploads.
                reupload = e.nnz * (np.dtype(_NUMPY_OF[self.dtype]).itemsize
                                    + 8)
            else:
                raise RuntimeError(
                    f"shard {index} was evicted but has no spill "
                    "buffers (cache built without an hbm budget)")
            self._stats["bytes_reuploaded"] += reupload
            _M_REUPLOAD_BYTES.inc(reupload)
            self._slot_bytes[e.slot] += e.feature_bytes
            self.peak_device_bytes = max(self.peak_device_bytes,
                                         self.device_bytes)
            _G_PEAK_BYTES.set(self.peak_device_bytes)
            if e.spill is not None:
                with telemetry.span("shard_reupload"):
                    e.feats = restore_spilled_features(
                        e.spill, e.n_rows, self.n_features, e.device,
                        self.dtype)
            else:
                e.feats = self._redecode(e)
            self._enforce_budget(pinned=index)
        else:
            self._stats["hits"] += 1
            _M_HITS.inc()
        return ResidentBlock(index=e.index, n_rows=e.n_rows, feats=e.feats,
                             labels=e.labels, offsets=e.offsets,
                             weights=e.weights, slot=e.slot)

    def blocks(self, prefetch_depth: Optional[int] = None
               ) -> Iterator[ResidentBlock]:
        """One replay epoch in fixed shard order. With a prefetch depth
        > 0 and a budget, the restores run on a background thread
        (`HostPrefetcher`), so the upload of shard k+1 overlaps the
        consumer's accumulate of shard k; resident epochs yield straight
        from the device."""
        self._stats["epochs"] += 1
        _M_EPOCHS.inc()
        depth = (self.prefetch_depth if prefetch_depth is None
                 else max(0, int(prefetch_depth)))

        def gen():
            for i in range(len(self._entries)):
                yield self.ensure(i)

        if depth < 1 or self.hbm_budget_bytes is None:
            yield from gen()
            return
        yield from HostPrefetcher(gen(), depth)

    def stats(self) -> Dict:
        s = dict(self._stats)
        s.update({
            "shards": self.n_shards,
            "rows": self.n_rows,
            # The port's blocks are unpadded: each its own (rows, nnz),
            # a column slice's with column blocks.
            "bucket_shapes": sorted({(e.n_rows, u.nnz)
                                     for e, u in self._all_units()}),
            "hbm_budget_bytes": self.hbm_budget_bytes,
            "device_bytes": self.device_bytes,
            "peak_device_bytes": self.peak_device_bytes,
            "spill_dtype": self.spill_dtype,
            "spill_source": self.spill_source,
            "spill_bytes_host": self.spill_bytes_host,
            "resident_shards": sum(
                1 for e in self._entries
                if all(u.feats is not None for u in (e.cols or [e]))),
            "mesh_devices": len(self.devices) if self.devices else None,
            # With column blocks the per-slot unit is a column slice, and
            # the slots are row-major over the (R, C) grid.
            "col_blocks": self.col_blocks,
            "col_block_size": (self.col_block_size
                               if self.col_blocks > 1 else None),
            "per_device_bytes": list(self._slot_bytes),
            "per_device_resident_shards": [
                sum(1 for _, u in self._all_units()
                    if u.feats is not None and u.slot == slot)
                for slot in range(self.n_slots)],
        })
        return s
