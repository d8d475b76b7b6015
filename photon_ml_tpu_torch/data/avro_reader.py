"""TrainingExampleAvro ingest: Avro files -> IndexMap + CSR + GameDataset
(port of photon_ml_tpu/data/avro_reader.py: _avro_paths, iter_records,
the record helpers and _reject_duplicate_features :22-105,
build_index_map :108, read_labeled_points :135-200, _GameBatchBuilder
:200-284, iter_game_dataset_batches :287-319, read_game_dataset
:323-392).

Replaces the reference's AvroDataReader/GLMSuite Spark ingest
(ml/data/AvroDataReader.scala:53-436, ml/io/GLMSuite.scala:98-139): reads
records on the host, indexes (name, term) features, injects the intercept
column, and produces scipy CSR ready for device upload.

Host code only. The routes are the JAX package's: ``read_game_dataset``
reads through the C block decoder (data/block_stream.py), and
``build_index_map`` and ``read_labeled_points`` through ``fast_ingest``
(data/fast_ingest.py), each falling back to the record loop only when a
file's schema does not fit the training layout; every route gives the
record loop's arrays byte for byte. An ``ingest_workers`` count of 2 or
more (``auto``: the usable cores) goes through ``fast_ingest`` to the
process pool of data/parallel_ingest.py (avro_reader.py:346-368).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from photon_ml_tpu_torch.data.fast_ingest import fast_ingest
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.index_map import IndexMap, feature_key
from photon_ml_tpu_torch.io.avro_codec import read_container


def _avro_paths(path) -> List[Path]:
    """path: one file/dir, or a list of them (date-range resolution hands
    the readers a list of daily directories)."""
    if isinstance(path, (list, tuple)):
        out: List[Path] = []
        for p in path:
            out.extend(_avro_paths(p))
        return out
    p = Path(path)
    if p.is_dir():
        files = sorted(q for q in p.iterdir() if q.suffix == ".avro")
        if not files:
            raise FileNotFoundError(f"no .avro files under {p}")
        return files
    return [p]


def iter_records(path, native: bool = True) -> Iterator[dict]:
    """Every record of the files, decoded by the C decoder or, with
    ``native=False``, the pure-Python codec."""
    for f in _avro_paths(path):
        yield from read_container(f, native=native)


def _record_label(rec: dict) -> float:
    """Label under either field-name set: 'label' (TrainingExampleFieldNames)
    or 'response' (ResponsePredictionFieldNames) — the reference's two Avro
    input formats (ml/avro/TrainingExampleFieldNames.scala,
    ResponsePredictionFieldNames.scala, io/FieldNamesType.scala:22).
    Auto-detected per record instead of a --format-type flag."""
    v = rec.get("label")
    if v is None:
        v = rec.get("response")
    if v is None:
        raise ValueError(
            "record has neither a 'label' nor a 'response' field")
    return float(v)


def _record_features(rec: dict) -> Iterable[dict]:
    """Feature list, tolerating union-null arrays/entries (Pig-generated
    schemas wrap everything in [null, X] — e.g. the reference's
    poisson_test.avro fixture)."""
    return (f for f in (rec.get("features") or ()) if f is not None)


def _reject_duplicate_features(mat: sp.csr_matrix, index_map: IndexMap,
                               uids: Sequence, shard: str = "") -> None:
    """Hard-reject records carrying the same (name, term) feature twice,
    then canonicalize the matrix (sum_duplicates).

    Mirrors the reference's AvroDataReader validation
    (ml/data/AvroDataReader.scala:306-311: `require(duplicateFeatures
    .isEmpty, ...)`): the same input must produce the same error, not a
    silently different model (summing duplicates changes the fit).

    Detection is nearly free on the clean path: duplicates exist iff
    sum_duplicates shrinks nnz (the pre-call structure must be COPIED —
    sum_duplicates compacts indices/indptr in place). The O(nnz log nnz)
    labeling lexsort runs only on the terminal error path.
    """
    raw_indices = mat.indices.copy()
    raw_indptr = mat.indptr.copy()
    nnz_before = mat.nnz
    mat.sum_duplicates()
    if mat.nnz == nnz_before:
        return
    row_ids = np.repeat(np.arange(len(raw_indptr) - 1),
                        np.diff(raw_indptr))
    order = np.lexsort((raw_indices, row_ids))
    r = row_ids[order]
    c = raw_indices[order]
    dup = (r[1:] == r[:-1]) & (c[1:] == c[:-1])
    hits = np.nonzero(dup)[0][:5]
    details = []
    for i in hits:
        row, col = int(r[i]), int(c[i])
        uid = uids[row] if uids is not None and row < len(uids) else None
        details.append(
            f"row {row}" + (f" (uid {uid!r})" if uid else "")
            + f": feature {index_map.get_feature_name(col)!r}")
    where = f" in feature shard {shard!r}" if shard else ""
    raise ValueError(
        f"duplicate (name, term) features detected{where} — the reference "
        "rejects such records (AvroDataReader.scala:306-311): "
        + "; ".join(details))


def build_index_map(path, add_intercept: bool = True,
                    selected_features: Optional[set] = None,
                    ingest_workers=None) -> IndexMap:
    """Scan pass collecting distinct (name, term) keys — the analog of
    DefaultIndexMap generation / FeatureIndexingJob. ``selected_features``
    restricts the map to a whitelist of keys (the reference's
    createDefaultIndexMapLoader(avroRDD, selectedFeatures)).
    ``ingest_workers``: see read_labeled_points."""
    fast = fast_ingest(_avro_paths(path), {}, {}, collect_keys=True,
                       workers=ingest_workers)
    if fast is not None:
        keys = fast.collected_keys
        if selected_features is not None:
            keys &= selected_features
        return IndexMap.from_keys(keys, add_intercept=add_intercept)

    keys = set()
    for rec in iter_records(path):
        for f in _record_features(rec):
            key = feature_key(f["name"], f.get("term") or "")
            if selected_features is None or key in selected_features:
                keys.add(key)
    return IndexMap.from_keys(keys, add_intercept=add_intercept)


def read_labeled_points(
    path,
    index_map: Optional[IndexMap] = None,
    add_intercept: bool = True,
    selected_features: Optional[set] = None,
    ingest_workers=None,
) -> Tuple[sp.csr_matrix, np.ndarray, np.ndarray, np.ndarray,
           List[Optional[str]], IndexMap]:
    """Returns (features, labels, offsets, weights, uids, index_map): the
    GLM driver's reader.

    Unknown features (absent from a supplied index map) are dropped, like
    the reference's ingest. ``selected_features`` (keys) restricts columns
    (GLMSuite selected-features filtering). ``ingest_workers``: "auto"/None
    (the usable cores) or a count; 2 or more decode in a process pool
    (data/parallel_ingest.py), byte-identical to one process.
    """
    if index_map is None:
        index_map = build_index_map(path, add_intercept=add_intercept,
                                    selected_features=selected_features,
                                    ingest_workers=ingest_workers)
    intercept_idx = index_map.intercept_index if add_intercept else -1

    fast = fast_ingest(
        _avro_paths(path), {"m": index_map}, {"m": intercept_idx},
        restrict_keys=selected_features, workers=ingest_workers)
    if fast is not None:
        data_, idx_, indptr_ = fast.shards["m"]
        mat = sp.csr_matrix((data_, idx_, indptr_),
                            shape=(len(fast.labels), len(index_map)))
        _reject_duplicate_features(mat, index_map, fast.uids)
        return (mat, fast.labels, fast.offsets, fast.weights, fast.uids,
                index_map)

    labels, offsets, weights, uids = [], [], [], []
    data, indices, indptr = [], [], [0]
    for rec in iter_records(path):
        labels.append(_record_label(rec))
        offsets.append(float(rec.get("offset") or 0.0))
        w = rec.get("weight")
        weights.append(1.0 if w is None else float(w))
        uids.append(rec.get("uid"))
        for f in _record_features(rec):
            key = feature_key(f["name"], f.get("term") or "")
            if selected_features is not None and key not in selected_features:
                continue
            idx = index_map.get_index(key)
            if idx >= 0:
                indices.append(idx)
                data.append(float(f["value"]))
        if intercept_idx >= 0:
            indices.append(intercept_idx)
            data.append(1.0)
        indptr.append(len(indices))

    n, d = len(labels), len(index_map)
    mat = sp.csr_matrix(
        (np.asarray(data), np.asarray(indices, np.int64),
         np.asarray(indptr, np.int64)), shape=(n, d))
    _reject_duplicate_features(mat, index_map, uids)
    return (mat, np.asarray(labels), np.asarray(offsets),
            np.asarray(weights), uids, index_map)


class _GameBatchBuilder:
    """Per-record GAME decode state — the ONE copy of the python-path
    record semantics (label/offset/weight/uid, metadataMap id extraction,
    per-shard feature + intercept append, duplicate-feature rejection at
    build), as ``read_game_dataset``'s record loop runs it."""

    def __init__(self, feature_shard_maps: Dict[str, IndexMap],
                 id_types: Sequence[str], add_intercept: bool):
        self._maps = feature_shard_maps
        self._id_types = id_types
        self._add_intercept = add_intercept
        self._builders = {s: {"data": [], "indices": [], "indptr": [0]}
                          for s in feature_shard_maps}
        self._labels: list = []
        self._offsets: list = []
        self._weights: list = []
        self._uids: list = []
        self._ids: Dict[str, list] = {t: [] for t in id_types}
        # Per-record work hoisted out of append(): one
        # (key->index dict .get, intercept index, column lists) tuple per
        # shard, so the hot loop is dict lookups + list appends on locals
        # — no method dispatch, no dict-of-dicts traversal per record.
        self._shard_ops = []
        for s, imap in feature_shard_maps.items():
            b = self._builders[s]
            self._shard_ops.append(
                (imap.key_to_index_dict().get,
                 imap.intercept_index if add_intercept else -1,
                 b["data"], b["indices"], b["indptr"]))
        self._id_ops = [(t, self._ids[t]) for t in id_types]

    def __len__(self) -> int:
        return len(self._labels)

    def append(self, rec: dict) -> None:
        self._labels.append(_record_label(rec))
        self._offsets.append(float(rec.get("offset") or 0.0))
        w = rec.get("weight")
        self._weights.append(1.0 if w is None else float(w))
        self._uids.append(rec.get("uid"))
        metadata = rec.get("metadataMap") or {}
        for t, lst in self._id_ops:
            v = metadata.get(t)
            if v is None:
                raise ValueError(
                    f"record is missing id type {t!r} in metadataMap")
            lst.append(str(v))
        # Feature keys are built ONCE per record, not once per shard.
        feats = [(feature_key(f["name"], f.get("term") or ""), f["value"])
                 for f in _record_features(rec)]
        for get_index, intercept_idx, data, indices, indptr in \
                self._shard_ops:
            for key, value in feats:
                idx = get_index(key, -1)
                if idx >= 0:
                    indices.append(idx)
                    data.append(float(value))
            if intercept_idx >= 0:
                indices.append(intercept_idx)
                data.append(1.0)
            indptr.append(len(indices))

    def build(self) -> GameDataset:
        n = len(self._labels)
        shards = {}
        for shard, imap in self._maps.items():
            b = self._builders[shard]
            m = sp.csr_matrix(
                (np.asarray(b["data"]),
                 np.asarray(b["indices"], np.int64),
                 np.asarray(b["indptr"], np.int64)), shape=(n, len(imap)))
            _reject_duplicate_features(m, imap, self._uids, shard)
            shards[shard] = m
        return GameDataset.build(
            responses=np.asarray(self._labels),
            feature_shards=shards,
            ids={t: np.asarray(v) for t, v in self._ids.items()},
            offsets=np.asarray(self._offsets),
            weights=np.asarray(self._weights),
            uids=np.asarray([u if u is not None else ""
                             for u in self._uids]),
        )


def iter_game_dataset_batches(
    path,
    id_types: Sequence[str],
    feature_shard_maps: Dict[str, IndexMap],
    batch_rows: int,
    add_intercept: bool = True,
    feeder: str = "auto",
    prefetch_depth: int = 0,
) -> Iterator[GameDataset]:
    """Streaming GAME ingest: GameDatasets of <= ``batch_rows`` rows
    through ``block_stream.BlockGameStream`` (the C block decoder, or
    the byte-identical record loop with ``feeder="python"``), so only
    O(batch_rows x (prefetch_depth + 2)) rows are resident on the host.
    Each batch's entity vocabularies are its own: consumers joining
    against a model vocabulary map through entity names, as the serving
    engine does. ``prefetch_depth`` > 0 decodes ahead on a background
    thread."""
    from photon_ml_tpu_torch.data.block_stream import BlockGameStream

    yield from BlockGameStream(
        path, id_types=id_types, feature_shard_maps=feature_shard_maps,
        batch_rows=batch_rows, add_intercept=add_intercept,
        feeder=feeder, prefetch_depth=prefetch_depth)


def read_game_dataset(
    path,
    id_types: Sequence[str],
    feature_shard_maps: Optional[Dict[str, IndexMap]] = None,
    add_intercept: bool = True,
    default_shard: str = "global",
    ingest_workers=None,
) -> Tuple[GameDataset, Dict[str, IndexMap]]:
    """GAME ingest: one feature shard (default: all features) + entity id
    columns pulled from each record's metadataMap (falling back to uid).

    The reference's richer feature-bag/shard configuration
    (GameDriver.prepareFeatureMaps) maps onto ``feature_shard_maps``:
    shard id -> IndexMap restricted to that shard's features.

    ``ingest_workers``: a read the pool does not take (one worker, or
    "auto" below ``MIN_PARALLEL_BYTES``) goes through the C block decoder
    (data/block_stream.py); 2 or more workers ("auto": the usable cores
    on a large input) through ``fast_ingest``'s process pool, byte for
    byte the same dataset.
    """
    if feature_shard_maps is None:
        feature_shard_maps = {
            default_shard: build_index_map(path, add_intercept=add_intercept,
                                           ingest_workers=ingest_workers)}
    from photon_ml_tpu_torch.data.parallel_ingest import pool_applies

    if not pool_applies(_avro_paths(path), ingest_workers):
        from photon_ml_tpu_torch.data.block_stream import (
            read_game_dataset_via_blocks,
        )

        block_ds = read_game_dataset_via_blocks(
            path, id_types, feature_shard_maps, add_intercept)
        if block_ds is not None:
            return block_ds, feature_shard_maps

    fast = fast_ingest(
        _avro_paths(path), feature_shard_maps,
        {s: (m.intercept_index if add_intercept else -1)
         for s, m in feature_shard_maps.items()},
        id_types=id_types, workers=ingest_workers)
    if fast is not None:
        n = len(fast.labels)
        shards = {}
        for shard, imap in feature_shard_maps.items():
            data_, idx_, indptr_ = fast.shards[shard]
            m = sp.csr_matrix((data_, idx_, indptr_),
                              shape=(n, len(imap)))
            _reject_duplicate_features(m, imap, fast.uids, shard)
            shards[shard] = m
        data = GameDataset.build(
            responses=fast.labels,
            feature_shards=shards,
            ids=fast.ids,
            offsets=fast.offsets,
            weights=fast.weights,
            uids=np.asarray([u if u is not None else ""
                             for u in fast.uids]),
        )
        return data, feature_shard_maps

    batch = _GameBatchBuilder(feature_shard_maps, id_types, add_intercept)
    for rec in iter_records(path):
        batch.append(rec)
    return batch.build(), feature_shard_maps
