"""Multi-process sharded Avro ingest: N workers run the C decoder over
block-range shards and hand the parent their columns through shared
memory (port of photon_ml_tpu/data/parallel_ingest.py:50-582, the whole
module: MIN_PARALLEL_BYTES, resolve_ingest_workers, IngestShardError,
the shared-memory transport, the worker protocol and
parallel_fast_ingest).

The shard planner (data/shard_planner.py) cuts the input files into
block-aligned byte ranges; each worker decodes its shards with
``native/_avro_native.c decode_training_block`` (inflate, Avro decode and
feature lookups in C, in parallel across processes), and the parent
assembles the results in shard-sequence order, so the output is
byte-identical (values and row order) to the single-process path for any
worker count.

Transport: a worker packs a shard's numeric columns (labels, offsets,
weights, per-shard-map CSR triplets) into ONE
``multiprocessing.shared_memory`` segment and sends the segment's name
and layout over its result pipe; the parent maps it and its final
``np.concatenate`` is the one copy. Uids, entity ids and collected keys
ride the pickle pipe. Without /dev/shm the columns ride the pipe as
bytes.

Workers are plain ``python -m photon_ml_tpu_torch.data.parallel_ingest``
subprocesses fed over stdin/stdout, not a multiprocessing pool: fork
would inherit the parent's CUDA context, and spawn re-imports the
parent's ``__main__``. A worker imports neither torch nor jax: only this
module, numpy, the port's ``native/`` decoder and the block reader of
data/shard_planner.py, so its start costs an interpreter and numpy
(about half a second).

Failure contract: a truncated or corrupt shard raises ``IngestShardError``
naming the shard (decode errors are caught in the worker and returned as
values), and a worker that dies outright is seen by pipe EOF and its exit
status: a bad file never hangs the pool.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

# Auto mode skips the pool below this much compressed payload: spawn-starting
# a worker costs ~0.5 s (python + numpy import), which only amortizes on
# inputs where decode itself is seconds.
MIN_PARALLEL_BYTES = 8 << 20

MAX_AUTO_WORKERS = 8


class IngestShardError(ValueError):
    """A shard failed to decode; the message names the shard."""


def resolve_ingest_workers(spec="auto") -> int:
    """CLI/env worker-count spec -> concrete count. "auto"/None resolves to
    the usable core count (capped at MAX_AUTO_WORKERS); explicit ints pass
    through (>= 1)."""
    if spec is None or spec == "auto" or spec == 0:
        try:
            cores = len(os.sched_getaffinity(0))
        except AttributeError:  # non-Linux
            cores = os.cpu_count() or 1
        return max(1, min(MAX_AUTO_WORKERS, cores))
    n = int(spec)
    if n < 1:
        raise ValueError(f"ingest workers must be >= 1, got {n}")
    return n


def pool_applies(paths: Sequence, workers) -> bool:
    """Whether a read of ``paths`` with ``workers`` belongs to the pool:
    an explicit count of 2 or more, or "auto" on several cores for at
    least MIN_PARALLEL_BYTES of input (below it a worker's start costs
    more than its share of the decode)."""
    if resolve_ingest_workers(workers) < 2:
        return False
    if workers in (None, "auto", 0):
        return sum(os.path.getsize(p) for p in paths) >= MIN_PARALLEL_BYTES
    return True


# ---------------------------------------------------------------------------
# Worker side. Runs in a `python -m photon_ml_tpu_torch.data.parallel_ingest`
# subprocess: keep the import graph free of torch and jax (numpy, zlib,
# the native module and the pure-Python varint reader only).
# ---------------------------------------------------------------------------

_W: dict = {}  # per-worker state, set by _init_worker


def _init_worker(file_specs, dicts_t, icepts_t, ids_t, delim, collect_keys):
    from photon_ml_tpu_torch.native import load_avro_native

    _W["native"] = load_avro_native()
    _W["files"] = file_specs  # path -> (prog, layout, flags dict)
    _W["dicts"] = dicts_t
    _W["icepts"] = icepts_t
    _W["ids"] = ids_t
    _W["delim"] = delim
    _W["collect"] = collect_keys


def _pack_shared(arrays: Sequence[np.ndarray]):
    """Pack arrays into one shared-memory segment; return a transport
    descriptor. Falls back to pickled bytes when shared memory is
    unavailable."""
    total = sum(a.nbytes for a in arrays)
    try:
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(create=True, size=max(1, total))
    except Exception:  # noqa: BLE001 — no /dev/shm etc.
        return ("bytes", [(a.dtype.str, a.tobytes()) for a in arrays])
    try:
        # The PARENT owns the segment's lifetime (it unlinks after
        # assembly); detach this process's resource tracker so it doesn't
        # double-unlink at worker exit.
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:  # noqa: BLE001 — tracker internals are best-effort
        pass
    off = 0
    meta = []
    for a in arrays:
        # Write through a view — a.tobytes() would materialize a second
        # full host copy of every shard payload.
        np.frombuffer(shm.buf, a.dtype, len(a), off)[:] = a
        meta.append((a.dtype.str, len(a), off))
        off += a.nbytes
    name = shm.name
    shm.close()
    return ("shm", name, meta)


def _unpack_shared(transport):
    """Parent side: transport descriptor -> (arrays, closer). Arrays are
    VIEWS for the shm transport — copy before calling the closer."""
    if transport[0] == "bytes":
        return ([np.frombuffer(b, dtype) for dtype, b in transport[1]],
                lambda: None)
    from multiprocessing import shared_memory

    _, name, meta = transport
    shm = shared_memory.SharedMemory(name=name)
    arrays = [
        np.frombuffer(shm.buf, dtype, count=length,
                      offset=off)
        for dtype, length, off in meta]

    def closer():
        try:
            shm.close()
        except BufferError:
            # A caller kept a view alive; still unlink (it doesn't need
            # zero exports) so the segment can't outlive the process.
            pass
        try:
            shm.unlink()
        except FileNotFoundError:
            pass

    return arrays, closer


def _discard_transport(transport) -> None:
    """Release a result transport without consuming it (error paths):
    attach + unlink the shm segment so it doesn't outlive the ingest."""
    if not transport or transport[0] != "shm":
        return
    try:
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(name=transport[1])
        shm.close()
        shm.unlink()
    except Exception:  # noqa: BLE001 — cleanup is best-effort
        pass


def _decode_shard(shard) -> tuple:
    """Decode one shard's blocks; never raises (errors return as values)."""
    from photon_ml_tpu_torch.data.shard_planner import read_block

    try:
        native = _W["native"]
        prog, layout, flags = _W["files"][shard.path]
        dicts_t, icepts_t, ids_t = _W["dicts"], _W["icepts"], _W["ids"]
        keys = set() if _W["collect"] else None

        label_chunks, off_chunks, w_chunks = [], [], []
        uids: list = []
        n_shards = len(dicts_t)
        vals_c: list = [[] for _ in range(n_shards)]
        cols_c: list = [[] for _ in range(n_shards)]
        rlen_c: list = [[] for _ in range(n_shards)]
        id_lists: list = [[] for _ in range(len(ids_t))]

        with open(shard.path, "rb") as f:
            f.seek(shard.offset)
            for _ in range(shard.num_blocks):
                count, payload = read_block(f, shard.codec, shard.sync,
                                            shard.path)
                (lb, ob, wb, us, shard_out, ids_out) = \
                    native.decode_training_block(
                        payload, count, prog, layout, dicts_t, icepts_t,
                        ids_t, _W["delim"], keys)
                label_chunks.append(np.frombuffer(lb, np.float64))
                # Mirror fast_ingest exactly: always one chunk per block so
                # mixed-layout files can't misalign rows.
                off_chunks.append(np.frombuffer(ob, np.float64)
                                  if flags["has_offset"]
                                  else np.zeros(count))
                w_chunks.append(np.frombuffer(wb, np.float64)
                                if flags["has_weight"]
                                else np.ones(count))
                if flags["has_uid"]:
                    uids.extend(us)
                else:
                    uids.extend([None] * count)
                for s, (vb, cb, rb) in enumerate(shard_out):
                    vals_c[s].append(np.frombuffer(vb, np.float64))
                    cols_c[s].append(np.frombuffer(cb, np.int64))
                    rlen_c[s].append(np.frombuffer(rb, np.int64))
                for t, lst in zip(range(len(ids_t)), ids_out):
                    id_lists[t].extend(lst)

        def cat(chunks, dtype):
            return (np.concatenate(chunks) if chunks
                    else np.zeros(0, dtype))

        arrays = [cat(label_chunks, np.float64),
                  cat(off_chunks, np.float64),
                  cat(w_chunks, np.float64)]
        for s in range(n_shards):
            arrays.append(cat(vals_c[s], np.float64))
            arrays.append(cat(cols_c[s], np.int64))
            arrays.append(cat(rlen_c[s], np.int64))
        transport = _pack_shared(arrays)
        return ("ok", shard.seq, transport, uids, id_lists, keys)
    except Exception as e:  # noqa: BLE001 — surfaces as IngestShardError
        return ("err", shard.seq, shard.label(),
                f"{type(e).__name__}: {e}")


def _worker_main() -> int:
    """Entry point of a worker subprocess (`python -m ...parallel_ingest`):
    read a tiny pickled task from stdin (shared-init file path + this
    worker's shards), load the init payload from the file (the feature
    dicts can be hundreds of MB at production index-map widths — pickled
    ONCE by the parent, read here through the shared page cache), stream
    one pickled result per shard to stdout."""
    import pickle
    import sys

    out = sys.stdout.buffer
    task = pickle.load(sys.stdin.buffer)
    with open(task["init_path"], "rb") as f:
        init = pickle.load(f)
    _init_worker(init["files"], init["dicts"], init["icepts"], init["ids"],
                 init["delim"], init["collect"])
    for shard in task["shards"]:
        pickle.dump(_decode_shard(shard), out,
                    protocol=pickle.HIGHEST_PROTOCOL)
        out.flush()
    return 0


# ---------------------------------------------------------------------------
# Parent side
# ---------------------------------------------------------------------------


def _run_workers(n_workers: int, shards, init: dict):
    """Launch worker subprocesses, interleave-assign shards, yield results
    AS THEY ARRIVE (completion order) — the parent assembles and feeds the
    device while other workers are still decoding.

    Shards are statically assigned round-robin (shard i -> worker
    i mod n): the planner's 2x oversplit keeps byte sizes even enough
    that static assignment balances within ~one shard. One reader thread
    per worker drains its stdout into a shared queue (results can exceed
    the pipe buffer); worker death surfaces as pipe EOF + exit status,
    never a hang.
    """
    import pickle
    import queue
    import subprocess
    import sys
    import tempfile
    import threading
    from pathlib import Path

    pkg_root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")

    procs = []
    err_files = []
    threads = []
    q: "queue.Queue[tuple]" = queue.Queue()
    counts = [0] * n_workers

    def reader(i, proc):
        try:
            while True:
                try:
                    q.put(("res", i, pickle.load(proc.stdout)))
                except EOFError:
                    q.put(("eof", i, None))
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in parent
            q.put(("exc", i, e))

    def stderr_tail(i):
        err_files[i].seek(0)
        text = err_files[i].read().decode("utf-8", "replace")
        return " | ".join(text.strip().splitlines()[-3:])

    # The (possibly huge) init payload is pickled ONCE to a temp file all
    # workers read — not re-serialized down every stdin pipe.
    init_fd, init_path = tempfile.mkstemp(prefix="photon_ingest_init_")
    try:
        with os.fdopen(init_fd, "wb") as f:
            pickle.dump(init, f, protocol=pickle.HIGHEST_PROTOCOL)
        for i in range(n_workers):
            # stderr goes to a temp FILE, not a pipe: nobody drains a
            # stderr pipe while workers run, and a chatty worker filling
            # it would deadlock the whole ingest.
            ef = tempfile.TemporaryFile()
            err_files.append(ef)
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "photon_ml_tpu_torch.data.parallel_ingest"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=ef, env=env)
            procs.append(proc)
            t = threading.Thread(target=reader, args=(i, proc),
                                 daemon=True)
            t.start()
            threads.append(t)
        for i, proc in enumerate(procs):
            task = {"init_path": init_path, "shards": shards[i::n_workers]}
            try:
                pickle.dump(task, proc.stdin,
                            protocol=pickle.HIGHEST_PROTOCOL)
                proc.stdin.flush()
                proc.stdin.close()
            except OSError:
                # Worker died before reading its task (bad interpreter,
                # import failure, ...) — the reader's EOF + exit status
                # below turns this into a clean IngestShardError with
                # the worker's stderr attached.
                pass

        done = 0
        while done < n_workers:
            kind, i, item = q.get()
            if kind == "res":
                counts[i] += 1
                yield item
            elif kind == "exc":
                raise IngestShardError(
                    f"ingest worker {i} result stream failed: "
                    f"{item}") from item
            else:  # eof
                threads[i].join()
                rc = procs[i].wait()
                expected = len(shards[i::n_workers])
                if rc != 0 or counts[i] != expected:
                    raise IngestShardError(
                        f"ingest worker {i} died (rc={rc}, "
                        f"{counts[i]}/{expected} shards done): "
                        + stderr_tail(i))
                done += 1
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for stream in (proc.stdin, proc.stdout):
                if stream:
                    try:
                        stream.close()
                    except OSError:
                        pass
        for ef in err_files:
            try:
                ef.close()
            except OSError:
                pass
        try:
            os.unlink(init_path)
        except OSError:
            pass
        # On an aborted run, queued-but-unyielded results still hold live
        # shm segments — release them (readers exit on the EOF their
        # worker's death produced).
        for t in threads:
            t.join(timeout=5)
        while not q.empty():
            kind, _, item = q.get_nowait()
            if kind == "res":
                _discard_transport(item[2])


def parallel_fast_ingest(
    paths: Sequence,
    shard_maps: Dict,
    intercepts: Dict[str, int],
    id_types: Sequence[str] = (),
    collect_keys: bool = False,
    restrict_keys: Optional[set] = None,
    workers: int = 2,
    auto: bool = False,
    column_consumer=None,
):
    """Multi-process variant of data/fast_ingest.fast_ingest.

    Returns a FastIngestResult byte-identical to the single-process fast
    path, or None when the parallel path doesn't apply (fewer than two
    workers or blocks, a schema not natively ingestible, too little data
    to amortize the pool in ``auto`` mode) — callers then take the
    single-process path.

    ``column_consumer``, when given, is called once per shard IN SEQUENCE
    ORDER with ``(seq, labels, offsets, weights)`` host arrays as soon as
    that shard's result is contiguous with everything already consumed —
    i.e. while later shards are still decoding: the overlap hook that
    data/device_feed.py's ``OverlappedUploader.submit`` plugs into.

    Raises IngestShardError (naming the shard) on a truncated or corrupt
    shard; the pool is torn down, never hung.
    """
    from photon_ml_tpu_torch.data.fast_ingest import (
        FastIngestResult,
        build_training_layout,
    )
    from photon_ml_tpu_torch.data.index_map import DELIMITER
    from photon_ml_tpu_torch.data.shard_planner import plan_shards, scan_paths
    from photon_ml_tpu_torch.io.avro_codec import Schema
    from photon_ml_tpu_torch.native import load_avro_native

    load_avro_native()  # built here once, not by every worker at once
    if workers < 2:
        return None

    indexes = scan_paths(paths)
    total_bytes = sum(ix.num_bytes for ix in indexes)
    total_blocks = sum(len(ix.blocks) for ix in indexes)
    if total_blocks < 2:
        return None  # nothing to parallelize over
    if auto and total_bytes < MIN_PARALLEL_BYTES:
        return None

    # Compile each file's layout up front; any non-ingestible schema sends
    # the WHOLE read down the fallback path (same contract as fast_ingest).
    file_specs = {}
    for ix in indexes:
        if not ix.blocks:
            continue
        layout = build_training_layout(Schema(ix.schema_json).root)
        if layout is None:
            return None
        if id_types and not layout.has_metadata:
            return None
        file_specs[ix.path] = (
            layout.prog, layout.layout,
            dict(has_uid=layout.has_uid, has_weight=layout.has_weight,
                 has_offset=layout.has_offset,
                 has_metadata=layout.has_metadata))

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

    shards = plan_shards(indexes, workers * 2)  # 2x oversplit: balance
    n_workers = min(workers, len(shards))

    # Incremental assembly: results arrive in COMPLETION order; each is
    # buffered until it is contiguous with everything already consumed,
    # then folded in (and handed to column_consumer) while later shards
    # are still decoding in the workers — decode, assembly, and H2D
    # genuinely overlap. Folding in seq order keeps the worker-count-
    # invariance contract: chunk concatenation in seq order reproduces
    # the single-process scan exactly.
    label_chunks, off_chunks, w_chunks = [], [], []
    uids: List[Optional[str]] = []
    shard_chunks = {s: ([], [], []) for s in shard_names}
    id_lists: Dict[str, list] = {t: [] for t in id_types}
    keys: Optional[set] = set() if collect_keys else None
    pending: Dict[int, tuple] = {}
    next_seq = 0
    closers = []

    def consume(res):
        _, seq, transport, s_uids, s_ids, s_keys = res
        arrays, closer = _unpack_shared(transport)
        closers.append(closer)
        labels_a, offs_a, ws_a = arrays[0], arrays[1], arrays[2]
        label_chunks.append(labels_a)
        off_chunks.append(offs_a)
        w_chunks.append(ws_a)
        for i, s in enumerate(shard_names):
            shard_chunks[s][0].append(arrays[3 + 3 * i])
            shard_chunks[s][1].append(arrays[3 + 3 * i + 1])
            shard_chunks[s][2].append(arrays[3 + 3 * i + 2])
        uids.extend(s_uids)
        for t, lst in zip(id_types, s_ids):
            id_lists[t].extend(lst)
        if keys is not None and s_keys is not None:
            keys.update(s_keys)
        if column_consumer is not None:
            column_consumer(seq, labels_a, offs_a, ws_a)

    try:
        for res in _run_workers(
                n_workers, shards,
                dict(files=file_specs, dicts=dicts_t, icepts=icepts_t,
                     ids=ids_t, delim=DELIMITER, collect=collect_keys)):
            if res[0] == "err":
                _, _, label, msg = res
                raise IngestShardError(
                    f"ingest shard {label} failed: {msg}")
            pending[res[1]] = res
            while next_seq in pending:
                consume(pending.pop(next_seq))
                next_seq += 1
        if next_seq != len(shards):
            raise IngestShardError(
                f"ingest lost shards: consumed {next_seq} of "
                f"{len(shards)}")

        labels = (np.concatenate(label_chunks) if label_chunks
                  else np.zeros(0))
        n = len(labels)
        offsets = (np.concatenate(off_chunks) if off_chunks
                   else np.zeros(n))
        weights = (np.concatenate(w_chunks) if w_chunks
                   else np.ones(n))
        shards_out = {}
        for s in shard_names:
            vals, cols, rlens = (
                np.concatenate(c) if c else np.zeros(0)
                for c in shard_chunks[s])
            indptr = np.zeros(n + 1, np.int64)
            np.cumsum(rlens.astype(np.int64), out=indptr[1:])
            shards_out[s] = (vals, cols.astype(np.int64), indptr)
        # Everything above COPIED out of the shared segments
        # (np.concatenate/astype allocate); drop the views now — a live
        # memoryview export makes shm.close() raise BufferError and the
        # segment would leak until interpreter shutdown.
        label_chunks.clear()
        off_chunks.clear()
        w_chunks.clear()
        shard_chunks.clear()
        return FastIngestResult(
            labels=labels, offsets=offsets, weights=weights, uids=uids,
            shards=shards_out,
            ids={t: np.asarray(v) for t, v in id_lists.items()},
            collected_keys=keys,
        )
    finally:
        # Error paths may leave shm views in the chunk lists (a live view
        # makes close() raise and the segment outlive us) and unconsumed
        # results in `pending` (segments nobody attached): drop the views
        # FIRST, then close the attached segments, then unlink the
        # orphans.
        label_chunks.clear()
        off_chunks.clear()
        w_chunks.clear()
        shard_chunks.clear()
        for closer in closers:
            try:
                closer()
            except Exception:  # noqa: BLE001 — cleanup is best-effort
                pass
        for res in pending.values():
            _discard_transport(res[2])
        pending.clear()


if __name__ == "__main__":
    raise SystemExit(_worker_main())
