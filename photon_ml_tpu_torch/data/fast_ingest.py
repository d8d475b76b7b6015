"""Block-level native ingest of TrainingExampleAvro-shaped files (port of
photon_ml_tpu/data/fast_ingest.py: build_training_layout :56 and the
single-process route of fast_ingest :169-282).

The generic C decoder (native/_avro_native.c decode_block) still
materializes a python dict per record and per feature; this module goes one
level deeper for the training-data schema family: records decode STRAIGHT
to CSR triplets + label/offset/weight arrays in C
(decode_training_block), skipping all intermediate objects. Feature-name →
column lookups happen in C against the IndexMap's dict, so the whole ingest
is one C call per container block.

Schema flexibility: the file's actual field ORDER and optional-field
branch order are compiled into a layout descriptor per file (the reference
writes metadataMap before weight/offset; this codebase after — both work).
Anything that doesn't fit the expected shapes returns None and callers fall
back to the record-at-a-time path.

A ``workers`` count of 2 or more, and "auto" on a host of several cores
for at least ``MIN_PARALLEL_BYTES`` of input, goes to the process-pool
decode of data/parallel_ingest.py (fast_ingest.py:186-207), whose output
is byte-identical to this route by that module's contract.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.data.index_map import DELIMITER, IndexMap
from photon_ml_tpu_torch.io.avro_codec import (
    compile_schema_program,
    iter_raw_blocks,
)
from photon_ml_tpu_torch.native import load_avro_native


@dataclasses.dataclass
class TrainingLayout:
    prog: bytes
    layout: bytes
    has_uid: bool
    has_weight: bool
    has_offset: bool
    has_metadata: bool


def _union_null_branch(prog, node, other_op: int) -> Optional[int]:
    """For union [null, X] (either order): the null branch index, or None
    if the node isn't exactly that union shape."""
    if prog[node] != 9 or prog[node + 1] != 2:
        return None
    b0, b1 = int(prog[node + 2]), int(prog[node + 3])
    if prog[b0] == 0 and prog[b1] == other_op:
        return 0
    if prog[b1] == 0 and prog[b0] == other_op:
        return 1
    return None


def build_training_layout(schema_root) -> Optional[TrainingLayout]:
    sp = compile_schema_program(schema_root)
    if sp is None:
        return None
    prog = np.frombuffer(sp.prog, np.int64)
    root = sp.root
    if prog[root] != 12:
        return None
    nf = int(prog[root + 1])
    fields = [(sp.strings[int(prog[root + 2 + 2 * i])],
               int(prog[root + 2 + 2 * i + 1])) for i in range(nf)]

    outer: List[Tuple[int, int]] = []
    inner: Optional[List[Tuple[int, int]]] = None
    flags = dict(has_uid=False, has_weight=False, has_offset=False,
                 has_metadata=False)
    for name, child in fields:
        if name == "uid":
            nb = _union_null_branch(prog, child, 6)
            if nb is None:
                return None
            outer.append((1, nb))
            flags["has_uid"] = True
        elif name == "label":
            if prog[child] != 4:
                return None
            outer.append((2, 0))
        elif name == "weight" or name == "offset":
            nb = _union_null_branch(prog, child, 4)
            if nb is None:
                return None
            outer.append((3 if name == "weight" else 4, nb))
            flags["has_weight" if name == "weight" else "has_offset"] = True
        elif name == "features":
            if prog[child] != 10:  # array
                return None
            rec = int(prog[child + 1])
            if prog[rec] != 12:
                return None
            inner = []
            n_in = int(prog[rec + 1])
            seen = set()
            for i in range(n_in):
                fname = sp.strings[int(prog[rec + 2 + 2 * i])]
                fchild = int(prog[rec + 2 + 2 * i + 1])
                if fname == "name":
                    if prog[fchild] != 6:
                        return None
                    inner.append((10, 0))
                elif fname == "term":
                    if prog[fchild] == 6:
                        inner.append((11, -1))  # plain string
                    else:
                        nb = _union_null_branch(prog, fchild, 6)
                        if nb is None:
                            return None
                        inner.append((11, nb))
                elif fname == "value":
                    if prog[fchild] != 4:
                        return None
                    inner.append((12, 0))
                else:
                    inner.append((0, fchild))
                seen.add(fname)
            if not {"name", "value"} <= seen:
                return None
            outer.append((5, 0))
        elif name == "metadataMap":
            # union [null, map<string>]
            if prog[child] != 9 or prog[child + 1] != 2:
                return None
            b0, b1 = int(prog[child + 2]), int(prog[child + 3])

            def _is_str_map(b):
                return prog[b] == 11 and prog[int(prog[b + 1])] == 6

            if prog[b0] == 0 and _is_str_map(b1):
                nb = 0
            elif prog[b1] == 0 and _is_str_map(b0):
                nb = 1
            else:
                return None
            outer.append((6, nb))
            flags["has_metadata"] = True
        else:
            outer.append((0, child))
    if not any(k == 2 for k, _ in outer) or inner is None:
        return None

    from array import array

    lay = array("q")
    lay.append(len(outer))
    for k, a in outer:
        lay.extend([k, a])
    lay.append(len(inner))
    for k, a in inner:
        lay.extend([k, a])
    return TrainingLayout(prog=sp.prog, layout=lay.tobytes(), **flags)


@dataclasses.dataclass
class FastIngestResult:
    labels: np.ndarray
    offsets: np.ndarray
    weights: np.ndarray
    uids: List[Optional[str]]
    # shard name -> (data, indices, indptr) CSR pieces
    shards: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]
    ids: Dict[str, np.ndarray]
    collected_keys: Optional[set]


def fast_ingest(
    paths: Sequence,
    shard_maps: Dict[str, IndexMap],
    intercepts: Dict[str, int],
    id_types: Sequence[str] = (),
    collect_keys: bool = False,
    restrict_keys: Optional[set] = None,
    workers=None,
) -> Optional[FastIngestResult]:
    """Native whole-file ingest. Returns None when any file's schema
    doesn't fit the training layout — callers fall back to the
    record-at-a-time path. The C decoder is built at first use; a failed
    build raises.

    ``restrict_keys``: selected-features whitelist (lookups happen against
    the restricted dict).

    ``workers``: "auto"/None resolves to the usable core count; 2 or more
    decode block-range shards in a process pool (data/parallel_ingest.py)
    with byte-identical output (values and row order); 1 forces this
    single-process path. The pool declines on inputs too small to
    amortize it in ``auto`` mode, and this path then runs.
    """
    from photon_ml_tpu_torch.data.parallel_ingest import (
        parallel_fast_ingest,
        resolve_ingest_workers,
    )

    native = load_avro_native()
    n_workers = resolve_ingest_workers(workers)
    if n_workers > 1:
        result = parallel_fast_ingest(
            paths, shard_maps, intercepts, id_types=id_types,
            collect_keys=collect_keys, restrict_keys=restrict_keys,
            workers=n_workers, auto=workers in (None, "auto", 0))
        if result is not None:
            return result

    shard_names = list(shard_maps)
    dicts = []
    for s in shard_names:
        d = shard_maps[s].key_to_index_dict()
        if restrict_keys is not None:
            d = {k: v for k, v in d.items() if k in restrict_keys}
        dicts.append(d)
    dicts_t = tuple(dicts)
    icepts_t = tuple(int(intercepts.get(s, -1)) for s in shard_names)
    ids_t = tuple(id_types)
    keys: Optional[set] = set() if collect_keys else None

    label_chunks, off_chunks, w_chunks = [], [], []
    uids: List[Optional[str]] = []
    shard_chunks = {s: ([], [], []) for s in shard_names}  # vals, cols, rlen
    id_lists: Dict[str, list] = {t: [] for t in id_types}

    for path in paths:
        blocks = iter_raw_blocks(path)
        layout: Optional[TrainingLayout] = None
        for schema, payload, count in blocks:
            if layout is None:
                layout = build_training_layout(schema.root)
                if layout is None:
                    return None  # schema not ingestible natively
                if id_types and not layout.has_metadata:
                    return None  # ids requested but absent from schema
            (lb, ob, wb, us, shard_out, ids_out) = \
                native.decode_training_block(
                    payload, count, layout.prog, layout.layout,
                    dicts_t, icepts_t, ids_t, DELIMITER, keys)
            label_chunks.append(np.frombuffer(lb, np.float64))
            # Always append a chunk per block so files with and without
            # optional fields can be mixed without misaligning rows.
            off_chunks.append(np.frombuffer(ob, np.float64)
                              if layout.has_offset
                              else np.zeros(count))
            w_chunks.append(np.frombuffer(wb, np.float64)
                            if layout.has_weight
                            else np.ones(count))
            if layout.has_uid:
                uids.extend(us)
            else:
                uids.extend([None] * count)
            for s, (vb, cb, rb) in zip(shard_names, shard_out):
                shard_chunks[s][0].append(np.frombuffer(vb, np.float64))
                shard_chunks[s][1].append(np.frombuffer(cb, np.int64))
                shard_chunks[s][2].append(np.frombuffer(rb, np.int64))
            for t, lst in zip(ids_t, ids_out):
                id_lists[t].extend(lst)

    labels = (np.concatenate(label_chunks) if label_chunks
              else np.zeros(0))
    n = len(labels)
    offsets = (np.concatenate(off_chunks) if off_chunks
               else np.zeros(n))
    weights = (np.concatenate(w_chunks) if w_chunks
               else np.ones(n))
    shards = {}
    for s in shard_names:
        vals, cols, rlens = (
            np.concatenate(c) if c else np.zeros(0)
            for c in shard_chunks[s])
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(rlens.astype(np.int64), out=indptr[1:])
        shards[s] = (vals, cols.astype(np.int64), indptr)
    return FastIngestResult(
        labels=labels, offsets=offsets, weights=weights, uids=uids,
        shards=shards,
        ids={t: np.asarray(v) for t, v in id_lists.items()},
        collected_keys=keys,
    )
