"""Streaming GAME scoring engine: a frozen device-resident model, varying
request data, static-shape bucket dispatch through captured CUDA graphs
(port of photon_ml_tpu/serving/engine.py: the registry metrics :57-66,
ExecutableCache :69-118 with its profiler, _SubSpec :120, _StreamScoring
:131, _HostRequest :148, _vstack_csr :157, StreamingGameScorer :175-769
with its score monitor :197-204, :601-602, :640-641, :767-768).

The inverse of ``DeviceGameScorer`` (which freezes one dataset and
varies the model): the model's parameters are uploaded once at
construction and stay on the device (fixed-effect coefficient vectors,
random-effect entity matrices assembled once, MF factor tables). Every
request ships only its own payload: padded CSR feature blocks and mapped
entity codes.

- **bucket ladder** (buckets.py): request shapes quantize to powers of
  two. Each bucket shape gets one ``BucketExecutable`` held in the
  engine's own ``ExecutableCache``: static device inputs (per feature
  shard the bucket's CSR, and the entries' row ids where a random effect
  reads the shard; per sub-model the mapped codes), the bucket's scoring
  function over them and, on the card, the CUDA graph captured from it
  with its static output. A dispatch copies the request's payload into
  the static inputs (one pinned buffer, one copy), replays the graph and
  copies the output to a pinned host buffer, all on the caller's current
  stream, so a later dispatch of the same bucket cannot overwrite inputs
  or output an earlier one still needs. On the CPU the entry runs the
  eager function over its static inputs.
- **micro-batching**: ``score_many`` packs small requests into one
  dispatch and scatters results back per request;
- **pipelining**: ``score_stream`` keeps ``pipeline_depth`` dispatches in
  flight (``InFlightWindow``), so the host featureization of batch k+1
  overlaps the device work of batch k.

The bucket's scoring function, in this order: fixed-effect margins by
the CSR forward product (kernel row 9 on the card, ops/spmv.py; no
transpose is built), random effects by ``kernels.score_random_rows`` (the
same product summing x_ij M[entity(i), j]), MF by
``kernels.score_mf_rows``. Every addition of a row then depends on its
own entries only, so a served row gives the same bits whatever shares its
bucket and whatever the bucket's shape. No fallback: a bucket whose
graph fails to capture or replay raises.

A captured graph holds its parameters' addresses, so each engine owns
its cache, keyed by bucket shape, where JAX's same-structure engines
share executables through one cache (ROADMAP §C lists this). Engines
may share a :class:`TracingGuard`, which keeps each bucket's build count
but not the bucket, so a dropped engine frees its parameters, buffers
and graphs.

Padded rows cannot leak: padded rows have no CSR entries, padded code
slots carry -1 (the unknown-entity zero row), and results are sliced to
the real row count before they leave the engine.

Telemetry, as in JAX: the spans ``featureize``, ``assemble`` and
``dispatch`` (upload and replay enqueue; the device time shows as
``device_wait`` where the window waits), the registry counters
``serving.requests``, ``serving.dispatches``, ``serving.rows_scored`` and
the histogram ``serving.request_latency_seconds`` (featureization to
settled result), mirrored per model under ``serving.model.<label>.*``
when the engine has a ``metrics_label``, and the cache's
:class:`~photon_ml_tpu_torch.telemetry.ExecutableProfiler` (build and
first-replay wall per bucket, dispatch-to-settle per rows bucket, read
where the window already waits). ``stats()`` has JAX's keys.

``score_monitor`` (None by default; data/distmon.py
``ScoreDistributionMonitor``, attached by ``--distmon``) is fed at both
settles with the host scores the settle has just copied out of the
pinned output: one buffered append per settled group, no device read of
its own. ``stats()`` then carries its ``score_distribution``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.data.device_feed import (
    InFlightWindow,
    chunked_device_put,
)
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.models.fixed_effect import FixedEffectModel
from photon_ml_tpu_torch.models.game_model import GameModel
from photon_ml_tpu_torch.models.matrix_factorization import (
    MatrixFactorizationModel,
)
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.ops import spmv
from photon_ml_tpu_torch.ops.features import padded_csr
from photon_ml_tpu_torch.serving import kernels
from photon_ml_tpu_torch.serving.buckets import BucketLadder
from photon_ml_tpu_torch.telemetry import span
from photon_ml_tpu_torch.utils.tracing_guard import BuildCount, TracingGuard
from photon_ml_tpu_torch.utils.vocab import SortedVocab

Tensor = torch.Tensor

# Process-wide registry mirrors of the engines' ``_stats`` (no-ops while
# telemetry is off; they sum across live engines, whose own numbers stay
# on ``stats()``).
_M_REQUESTS = telemetry.counter("serving.requests")
_M_DISPATCHES = telemetry.counter("serving.dispatches")
_M_ROWS_SCORED = telemetry.counter("serving.rows_scored")
_H_REQUEST_LATENCY = telemetry.histogram(
    "serving.request_latency_seconds")

class ExecutableCache:
    """Explicit bucket cache: key -> ``BucketExecutable``, with an honest
    build counter (``compilations``: entries ever built). Every built
    entry registers with a :class:`TracingGuard`, so the build-count
    invariants are assertable: ``assert_max_retraces(max_total=N)`` bounds
    the executables ever built and their captures, an evicted and rebuilt
    bucket staying in the guard's totals under a fresh generation name.
    One engine's: its keys are bucket shapes. ``label`` prefixes the
    guard's names (the front-end's model name), and ``total_traces`` is
    the guard's, which engines may share. ``profiler`` (the front-end's
    shared :class:`ExecutableProfiler`, or the cache's own) records each
    build and dispatch under the bucket's guard name."""

    def __init__(self, guard: Optional[TracingGuard] = None,
                 label: Optional[str] = None,
                 profiler: Optional[telemetry.ExecutableProfiler] = None):
        self._entries: Dict[Tuple, object] = {}
        self.compilations = 0
        self.guard = guard if guard is not None else TracingGuard()
        self.profiler = (profiler if profiler is not None
                         else telemetry.ExecutableProfiler())
        self._prefix = f"bucket:{label}:" if label else "bucket:"

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self):
        return self._entries.keys()

    def items(self):
        return self._entries.items()

    def name_of(self, key: Tuple) -> str:
        """The bucket's name in the guard and the profiler."""
        return f"{self._prefix}{key!r}"

    def get_or_build(self, key: Tuple, build):
        fn = self._entries.get(key)
        if fn is None:
            fn = self._entries[key] = build()
            self.compilations += 1
            self.guard.track(self.name_of(key), fn)
        return fn

    def total_traces(self) -> int:
        """Builds across every executable ever built (evicted included);
        equals ``compilations`` exactly when each bucket built once."""
        return self.guard.total_traces()

    def assert_max_retraces(self, max_total: Optional[int] = None,
                            per_fn: Optional[int] = None) -> None:
        self.guard.assert_max_retraces(max_total=max_total, per_fn=per_fn)


@dataclasses.dataclass(frozen=True)
class _SubSpec:
    """Static per-sub-model serving structure (params live separately)."""

    name: str
    kind: str  # "fixed" | "random" | "mf"
    shard_id: Optional[str]  # feature shard consumed (None for mf)
    effect_types: Tuple[str, ...]  # id columns consumed ((), 1, or 2)
    vocabs: Tuple[SortedVocab, ...]  # model vocab per effect type


class _StreamScoring:
    """Iterator of (dataset, scores) pairs from ``score_container_stream``,
    carrying the underlying feeder (``.stream``)."""

    def __init__(self, it, stream):
        self._it = it
        self.stream = stream

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)


@dataclasses.dataclass
class _HostRequest:
    """One featureized request: host-side, unpadded."""

    n_rows: int
    shards: Dict[str, sp.csr_matrix]
    codes: Tuple[Tuple[np.ndarray, ...], ...]  # per sub, per effect type


def _vstack_csr(mats: List[sp.csr_matrix]) -> sp.csr_matrix:
    """Row-stack same-width CSRs by direct triplet concatenation (what
    ``sp.vstack(mats, format="csr")`` gives, without its per-block
    re-validation)."""
    indptr_parts = [np.zeros(1, mats[0].indptr.dtype)]
    off = 0
    for m in mats:
        indptr_parts.append(m.indptr[1:] + off)
        off += m.nnz
    return sp.csr_matrix(
        (np.concatenate([m.data for m in mats]),
         np.concatenate([m.indices for m in mats]),
         np.concatenate(indptr_parts)),
        shape=(sum(m.shape[0] for m in mats), mats[0].shape[1]))


_ALIGN = 16  # bytes: every static input starts on a 16-byte boundary


class BucketExecutable:
    """One bucket shape of one engine: its static inputs, its scoring
    function over them and, on the card, the CUDA graph captured from
    that function with its static output.

    The static inputs are views of one device byte buffer, so a dispatch
    stages the whole payload in one pinned host buffer and uploads it in
    one copy. Building runs the function once eagerly (which also makes
    the CSR operands' per-width state, which cannot be made inside a
    capture) and then captures it; ``traces`` counts captures on the card
    and builds of the eager function on the CPU, in ``builds``, the
    counter the TracingGuard keeps. ``replays`` counts graph replays;
    ``launches_per_replay`` is the row-9 launches one replay runs, which
    each replay adds to ``spmv.csr_matvec.launches``."""

    def __init__(self, engine: "StreamingGameScorer", rows_b: int,
                 nnz_by_shard: Tuple[int, ...]):
        dev, dt = engine.device, engine.dtype
        self.device = dev
        self.rows_b = rows_b
        self.builds = BuildCount()
        self.replays = 0
        self.launches_per_replay = 0
        np_dt = engine.np_dtype
        nnz = dict(zip(engine.shard_order, nnz_by_shard))
        layout = []  # (name, np dtype, length)
        for sid in engine.shard_order:
            layout += [(("crow", sid), np.int32, rows_b + 1),
                       (("col", sid), np.int32, nnz[sid]),
                       (("val", sid), np_dt, nnz[sid])]
            if sid in engine._re_shards:
                layout.append((("rid", sid), np.int32, nnz[sid]))
        for i, spec in enumerate(engine._subs):
            for j in range(len(spec.effect_types)):
                layout.append((("codes", i, j), np.int32, rows_b))
        self._slots = {}
        off = 0
        for name, ndt, n in layout:
            nbytes = n * np.dtype(ndt).itemsize
            self._slots[name] = (off, ndt, n)
            off += -(-nbytes // _ALIGN) * _ALIGN
        self.nbytes = max(off, _ALIGN)
        self._buf = torch.zeros(self.nbytes, dtype=torch.uint8, device=dev)
        views = {}
        for name, (o, ndt, n) in self._slots.items():
            tdt = torch.from_numpy(np.empty(0, ndt)).dtype
            views[name] = self._buf[o:o + n * np.dtype(ndt).itemsize].view(
                tdt)

        ops, re_ops, prods, ones = {}, {}, {}, {}
        for sid in engine.shard_order:
            ops[sid] = spmv.CSROperand(views["crow", sid], views["col", sid],
                                       views["val", sid],
                                       engine._shards[sid])
        for i, spec in enumerate(engine._subs):
            if spec.kind != "random":
                continue
            sid = spec.shard_id
            prods[i] = torch.zeros(nnz[sid], dtype=dt, device=dev)
            re_ops[i] = spmv.CSROperand(views["crow", sid],
                                        views["col", sid], prods[i],
                                        engine._shards[sid])
            ones[i] = torch.ones(engine._shards[sid], dtype=dt, device=dev)
        subs, params = engine._subs, engine._params

        def score_bucket() -> Tensor:
            total = torch.zeros(rows_b, dtype=dt, device=dev)
            for i, (spec, p) in enumerate(zip(subs, params)):
                if spec.kind == "fixed":
                    total = total + kernels.score_fixed(ops[spec.shard_id],
                                                        p, dt)
                elif spec.kind == "random":
                    sid = spec.shard_id
                    total = total + kernels.score_random_rows(
                        re_ops[i], prods[i], views["val", sid],
                        views["rid", sid], views["codes", i, 0], p, ones[i])
                else:
                    total = total + kernels.score_mf_rows(
                        views["codes", i, 0], views["codes", i, 1], p[0],
                        p[1], dt)
            return total

        self.eager = score_bucket
        self.graph = None
        self.out = None
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                score_bucket()  # makes the operands' state; all-empty rows
                graph = torch.cuda.CUDAGraph()
                before = spmv.csr_matvec.recorded
                # thread_local: another thread's CUDA calls (a prefetch
                # thread's pinned allocation, a second engine's upload)
                # may not invalidate this capture.
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    self.out = score_bucket()
                self.launches_per_replay = (spmv.csr_matvec.recorded
                                            - before)
            self.graph = graph
        self.builds.traces += 1

    @property
    def traces(self) -> int:
        return self.builds.traces

    def stage(self, host: Dict) -> None:
        """Write one payload (name -> host array of the slot's length)
        into the static inputs: on the card through one pinned buffer and
        one copy on the current stream (the caching host allocator keeps
        the buffer until that copy is done), on the CPU in place."""
        if self.device.type == "cuda":
            staging = torch.empty(self.nbytes, dtype=torch.uint8,
                                  pin_memory=True)
        else:
            staging = self._buf
        hv = staging.numpy()
        for name, arr in host.items():
            o, ndt, n = self._slots[name]
            hv[o:o + n * np.dtype(ndt).itemsize].view(ndt)[:] = arr
        if staging is not self._buf:
            self._buf.copy_(staging, non_blocking=True)

    def run(self) -> Tuple[Tensor, Optional[object]]:
        """Score the staged payload: (host scores [rows_b], the CUDA event
        behind their copy, or None on the CPU)."""
        if self.graph is None:
            return self.eager(), None
        self.graph.replay()
        self.replays += 1
        spmv.csr_matvec.launches += self.launches_per_replay
        host = torch.empty(self.rows_b, dtype=self.out.dtype,
                           pin_memory=True)
        host.copy_(self.out, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev


class StreamingGameScorer:
    """Scores arbitrary GameDatasets against ONE frozen GameModel.

    ``dtype`` is the compute and result type (float32 on the card;
    float64 for the CPU parity tests). Construction uploads and
    assembles all model state; no per-request work touches model
    parameters again. The engine owns its bucket cache (``cache``);
    engines that share ``tracing_guard`` and ``profiler`` (the
    front-end's) count their builds and dispatches in one place.
    ``metrics_label`` mirrors the serving metrics per model. ``device``
    defaults to the card and raises without CUDA unless it is
    ``"cpu"``."""

    def __init__(self, model: GameModel, dtype=torch.float32,
                 ladder: Optional[BucketLadder] = None,
                 pipeline_depth: int = 2,
                 tracing_guard: Optional[TracingGuard] = None,
                 metrics_label: Optional[str] = None,
                 profiler: Optional[telemetry.ExecutableProfiler] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        self.ladder = ladder if ladder is not None else BucketLadder()
        self.pipeline_depth = max(1, pipeline_depth)
        self._subs: List[_SubSpec] = []
        self._params: List = []  # on the device, aligned with _subs
        self._shards: Dict[str, int] = {}  # shard id -> n_features
        self._stats = {"dispatches": 0, "requests": 0, "rows_scored": 0,
                       "rows_padded": 0, "nnz_scored": 0, "nnz_padded": 0}
        self.cache = ExecutableCache(guard=tracing_guard,
                                     label=metrics_label, profiler=profiler)
        # Per-model registry metrics (serving.model.<label>.*): with
        # several engines resident, the process-wide serving.* metrics sum
        # across models, so a labelled engine also mirrors into its own
        # family and stats() reports its own latency histogram.
        self.metrics_label = metrics_label
        # Optional per-model score-distribution monitor; None skips the
        # settle's call (one attribute load and a branch).
        self.score_monitor = None
        if metrics_label:
            pre = f"serving.model.{metrics_label}."
            self._m_requests = telemetry.counter(pre + "requests")
            self._m_dispatches = telemetry.counter(pre + "dispatches")
            self._m_rows_scored = telemetry.counter(pre + "rows_scored")
            self._h_latency = telemetry.histogram(
                pre + "request_latency_seconds")
        else:
            self._m_requests = self._m_dispatches = None
            self._m_rows_scored = None
            self._h_latency = None

        dev, dt = self.device, dtype
        for name, m in model.models.items():
            re_model: Optional[RandomEffectModel] = None
            if isinstance(m, RandomEffectModel):
                re_model = m
            elif isinstance(getattr(m, "latent", None), RandomEffectModel):
                re_model = m.latent  # FactoredRandomEffectModel

            if kernels.is_re_snapshot(m):
                # A loaded random effect: its entity matrix is already
                # assembled in global space (plus the unknown row).
                dense = kernels.snapshot_dense_matrix(m, dt)
                self._register_shard(name, m.feature_shard_id,
                                     dense.shape[1])
                self._subs.append(_SubSpec(
                    name, "random", m.feature_shard_id,
                    (m.random_effect_type,),
                    (SortedVocab.build(m.vocabulary),)))
                self._params.append(chunked_device_put(dense, dt, dev))
                continue

            if isinstance(m, FixedEffectModel):
                w = chunked_device_put(
                    torch.as_tensor(m.glm.coefficients.means).cpu(), dt,
                    dev)
                self._register_shard(name, m.feature_shard_id, w.shape[0])
                self._subs.append(_SubSpec(name, "fixed",
                                           m.feature_shard_id, (), ()))
                self._params.append(w)
            elif re_model is not None:
                self._register_shard(name, re_model.feature_shard_id,
                                     re_model.num_global_features)
                block_static = tuple(
                    (torch.as_tensor(np.asarray(codes, np.int64),
                                     device=dev), fidx.to(dev))
                    for codes, fidx in zip(re_model.entity_codes,
                                           re_model.feat_idx))
                coefs = tuple(c.to(dev) for c in re_model.local_coefs)
                proj = (None if re_model.projection is None
                        else re_model.projection.to(dev))
                # Assembled once: the serving model is frozen.
                M = kernels.assemble_re_matrix(
                    block_static, coefs, proj, len(re_model.vocabulary),
                    re_model.num_global_features, dt).contiguous()
                self._subs.append(_SubSpec(
                    name, "random", re_model.feature_shard_id,
                    (re_model.random_effect_type,),
                    (SortedVocab.build(re_model.vocabulary),)))
                self._params.append(M)
            elif isinstance(m, MatrixFactorizationModel):
                self._subs.append(_SubSpec(
                    name, "mf", None,
                    (m.row_effect_type, m.col_effect_type),
                    (SortedVocab.build(m.row_vocabulary),
                     SortedVocab.build(m.col_vocabulary))))
                self._params.append(tuple(
                    chunked_device_put(torch.as_tensor(f).cpu(), dt, dev)
                    for f in (m.row_factors, m.col_factors)))
            else:
                raise kernels.UnsupportedSubModelError(
                    f"coordinate {name!r}: cannot device-score "
                    f"{type(m).__name__}")
        self._params = tuple(self._params)
        self._shard_order = tuple(self._shards)
        self._re_shards = {s.shard_id for s in self._subs
                           if s.kind == "random"}
        # Request-vocab join memo, keyed by (sub, effect, id(vocab)); each
        # entry keeps its vocab array, so the id is never recycled while
        # the entry lives (GameDataset.subset shares the vocabulary).
        self._join_memo: Dict[Tuple[int, int, int],
                              Tuple[np.ndarray, np.ndarray]] = {}

    def _register_shard(self, name: str, shard_id: str, d: int) -> None:
        prev = self._shards.setdefault(shard_id, int(d))
        if prev != d:
            raise ValueError(
                f"coordinate {name!r} expects shard {shard_id!r} with "
                f"{d} features but another coordinate registered {prev}")

    # -- host-side featureization -----------------------------------------

    def _featureize(self, data) -> _HostRequest:
        """GameDataset rows -> per-shard CSR + per-sub mapped model codes
        (the host half of a request, overlappable with device work)."""
        shards = {}
        for sid, d in self._shards.items():
            mat = data.feature_shards.get(sid)
            if mat is None:
                raise KeyError(f"request is missing feature shard {sid!r} "
                               f"(has {sorted(data.feature_shards)})")
            csr = mat.tocsr()
            if csr.shape[1] != d:
                raise ValueError(
                    f"shard {sid!r}: request has {csr.shape[1]} features, "
                    f"model expects {d}")
            shards[sid] = csr
        codes = []
        for i, spec in enumerate(self._subs):
            per_effect = []
            for j, (etype, vocab) in enumerate(zip(spec.effect_types,
                                                   spec.vocabs)):
                col = data.id_columns.get(etype)
                if col is None:
                    raise KeyError(
                        f"request is missing id column {etype!r} "
                        f"(has {sorted(data.id_columns)})")
                memo_key = (i, j, id(col.vocabulary))
                ent = self._join_memo.get(memo_key)
                if ent is None or ent[0] is not col.vocabulary:
                    if len(self._join_memo) >= 64:  # serving sees few
                        self._join_memo.clear()     # vocabularies
                    lookup = vocab.codes_of(
                        col.vocabulary).astype(np.int32)
                    self._join_memo[memo_key] = (col.vocabulary, lookup)
                else:
                    lookup = ent[1]
                per_effect.append(lookup[col.codes])
            codes.append(tuple(per_effect))
        return _HostRequest(int(data.num_rows), shards, tuple(codes))

    def _assemble(self, group: List[_HostRequest]):
        """Pack a group of requests into one padded bucket batch: (cache
        key, host payload {static input name: array}, per-request row
        splits)."""
        n_total = sum(r.n_rows for r in group)
        rows_b = self.ladder.rows_bucket(n_total)
        payload = {}
        nnz_buckets = []
        nnz_total = 0
        for sid in self._shard_order:
            mats = [r.shards[sid] for r in group]
            csr = mats[0] if len(mats) == 1 else _vstack_csr(mats)
            nnz_b = self.ladder.nnz_bucket(csr.nnz, rows_b)
            crow, col, val = padded_csr(csr, rows_b, nnz_b,
                                        value_dtype=self.np_dtype)
            payload["crow", sid] = crow
            payload["col", sid] = col
            payload["val", sid] = val
            if sid in self._re_shards:  # entries' rows, to gather M by
                rid = np.zeros(nnz_b, np.int32)
                rid[:csr.nnz] = np.repeat(
                    np.arange(csr.shape[0], dtype=np.int32),
                    np.diff(csr.indptr))
                payload["rid", sid] = rid
            nnz_buckets.append(nnz_b)
            nnz_total += int(csr.nnz)
        for i, spec in enumerate(self._subs):
            for j in range(len(spec.effect_types)):
                padded = np.full(rows_b, -1, np.int32)
                off = 0
                for r in group:
                    padded[off:off + r.n_rows] = r.codes[i][j]
                    off += r.n_rows
                payload["codes", i, j] = padded
        key = (rows_b, tuple(nnz_buckets))
        splits = np.cumsum([r.n_rows for r in group])[:-1]
        self._stats["requests"] += len(group)
        self._stats["rows_scored"] += n_total
        _M_REQUESTS.inc(len(group))
        _M_ROWS_SCORED.inc(n_total)
        if self._m_requests is not None:
            self._m_requests.inc(len(group))
            self._m_rows_scored.inc(n_total)
        self._stats["rows_padded"] += rows_b
        self._stats["nnz_scored"] += nnz_total
        self._stats["nnz_padded"] += sum(nnz_buckets)
        return key, payload, splits

    # -- device dispatch ---------------------------------------------------

    def _bucket_cost(self, rows_b: int, nnz_by_shard: Tuple[int, ...]
                     ) -> Dict[str, float]:
        """Static FLOPs and bytes of one dispatch of a bucket, reckoned
        from its padded shapes: each row-9 product at the count of
        chip_smoke.py's ``spmv_entry`` (2 nnz operations; values and
        column ids, row pointers, the vector and the result once); a
        random effect adds its nnz products x_ij M[entity(i), j] (one
        operation, one row id and one gathered M entry each); an MF term
        2k operations and 2k gathered factors a row."""
        isz = np.dtype(self.np_dtype).itemsize
        nnz = dict(zip(self._shard_order, nnz_by_shard))
        flops = bytes_ = 0.0
        for spec, p in zip(self._subs, self._params):
            if spec.kind == "mf":
                k = p[0].shape[1]
                flops += 2 * k * rows_b
                bytes_ += rows_b * (8 + 2 * k * isz)
                continue
            n, d = nnz[spec.shard_id], self._shards[spec.shard_id]
            flops += 2 * n
            bytes_ += (isz + 4) * n + 4 * (rows_b + 1) + isz * (d + rows_b)
            if spec.kind == "random":
                flops += n
                bytes_ += (4 + isz) * n + 4 * rows_b
        return {"flops": flops, "bytes_accessed": bytes_}

    def _dispatch(self, key, payload):
        """Stage one padded batch and run its bucket (asynchronous on the
        card): (host scores [rows_b], the event behind them or None). The
        ``dispatch`` span measures upload and enqueue; a build (cache
        miss) feeds the profiler its wall time and static cost, and the
        first run's wall time, with no sync added."""
        with span("dispatch"):
            before = self.cache.compilations
            t0 = time.perf_counter()
            ex = self.cache.get_or_build(
                key, lambda: BucketExecutable(self, *key))
            self._stats["dispatches"] += 1
            _M_DISPATCHES.inc()
            if self._m_dispatches is not None:
                self._m_dispatches.inc()
            built = self.cache.compilations != before
            if built:
                self.cache.profiler.profile_build(
                    self.cache.name_of(key), time.perf_counter() - t0,
                    rows_bucket=key[0], **self._bucket_cost(*key))
            t1 = time.perf_counter()
            if self.device.type != "cuda":
                ex.stage(payload)
                out = ex.run()
            else:
                with torch.cuda.device(self.device):
                    ex.stage(payload)
                    out = ex.run()
            if built:
                self.cache.profiler.record_first_call(
                    self.cache.name_of(key), time.perf_counter() - t1)
            return out

    #: _stats keys rolled back by :meth:`rollback_stats`: request and row
    #: accounting and its padding companions, not ``dispatches`` (a
    #: discarded partial dispatch still ran on the device).
    _ROLLBACK_KEYS = ("requests", "rows_scored", "rows_padded",
                      "nnz_scored", "nnz_padded")

    def stats_checkpoint(self) -> Dict[str, int]:
        """Snapshot of the request-accounting stats, for
        :meth:`rollback_stats` after a failed ``score_many`` attempt."""
        return {k: self._stats[k] for k in self._ROLLBACK_KEYS}

    def rollback_stats(self, checkpoint: Dict[str, int]) -> None:
        """Un-count a failed ``score_many`` attempt, in the engine's
        stats and their registry twins (global and per model), so
        requests and rows_scored count each served request once even when
        the front-end's fault isolation re-scores a window solo. Caller
        contract: one mutator (the front-end's dispatch thread), the
        checkpoint taken just before the attempt. Latency histograms are
        not rolled back: a settled sub-group really waited that long."""
        d_req = self._stats["requests"] - checkpoint["requests"]
        d_rows = self._stats["rows_scored"] - checkpoint["rows_scored"]
        for k in self._ROLLBACK_KEYS:
            self._stats[k] = checkpoint[k]
        if d_req:
            _M_REQUESTS.inc(-d_req)
            if self._m_requests is not None:
                self._m_requests.inc(-d_req)
        if d_rows:
            _M_ROWS_SCORED.inc(-d_rows)
            if self._m_rows_scored is not None:
                self._m_rows_scored.inc(-d_rows)

    def _observe_latency(self, seconds: float, n: int = 1) -> None:
        """``n`` requests settled at one latency (a coalesced group
        shares its dispatch): the process-wide histogram and, for a
        labelled engine, its per-model twin, one lock a group."""
        _H_REQUEST_LATENCY.observe(seconds, n=n)
        if self._h_latency is not None:
            self._h_latency.observe(seconds, n=n)

    # -- public scoring API ------------------------------------------------

    def _split(self, data) -> List:
        """Oversized requests split into ladder-sized row slices."""
        n = data.num_rows
        if n <= self.ladder.max_rows:
            return [data]
        return [data.subset(np.arange(a, min(a + self.ladder.max_rows, n)))
                for a in range(0, n, self.ladder.max_rows)]

    def _push(self, win: InFlightWindow, item, launched):
        out, ev = launched
        return win.push((out, *item), ready=ev if ev is not None else out)

    def score(self, data) -> np.ndarray:
        """Score one request dataset: host [n_rows] model margins (no
        offsets, the GameModel.score contract). Oversized requests split
        and pipeline through ``score_stream``."""
        return next(self.score_stream([data]))

    def score_many(self, datasets) -> List[np.ndarray]:
        """Micro-batch a list of small requests: consecutive requests
        pack into shared dispatches (combined rows <= ladder.max_rows),
        results scatter back per request. Dispatches are pipelined."""
        datasets = list(datasets)
        results: List[Optional[np.ndarray]] = [None] * len(datasets)
        groups: List[List[int]] = []
        rows = 0
        for i, ds in enumerate(datasets):
            n = ds.num_rows
            if n == 0:
                results[i] = np.zeros(0, self.np_dtype)
                continue
            if n > self.ladder.max_rows:
                groups.append([i])  # handled via score() (splitting)
                continue
            if groups and rows + n <= self.ladder.max_rows \
                    and datasets[groups[-1][-1]].num_rows \
                    <= self.ladder.max_rows:
                groups[-1].append(i)
                rows += n
            else:
                groups.append([i])
                rows = n
        win = InFlightWindow(self.pipeline_depth)

        def settle(done):
            out, idxs, splits, t_start, rows_b, t_disp = done
            n_real = sum(datasets[i].num_rows for i in idxs)
            host = out.numpy()[:n_real].copy()
            now = time.perf_counter()
            for idx, chunk in zip(idxs, np.split(host, splits)):
                results[idx] = chunk
            if self.score_monitor is not None:
                self.score_monitor.observe(host)
            # One shared dispatch: every request of the group waited the
            # same time from featureization to its settled result.
            self._observe_latency(now - t_start, n=len(idxs))
            # Dispatch-to-settle per rows bucket, where the window has
            # already waited on the dispatch's event.
            self.cache.profiler.record_dispatch(rows_b, now - t_disp,
                                                n_real)

        for g in groups:
            if len(g) == 1 and datasets[g[0]].num_rows \
                    > self.ladder.max_rows:
                results[g[0]] = self.score(datasets[g[0]])
                continue
            t_start = time.perf_counter()
            with span("featureize"):
                reqs = [self._featureize(datasets[i]) for i in g]
            with span("assemble"):
                key, payload, splits = self._assemble(reqs)
            launched = self._dispatch(key, payload)
            done = self._push(win, (g, splits, t_start, key[0],
                                    time.perf_counter()), launched)
            if done is not None:
                settle(done)
        for done in win.drain():
            settle(done)
        return results

    def score_stream(self, datasets: Iterable) -> Iterator[np.ndarray]:
        """Pipelined scoring of a stream of request datasets: one score
        vector per input, in order, with up to ``pipeline_depth``
        dispatches in flight."""
        win = InFlightWindow(self.pipeline_depth)
        pending: List[np.ndarray] = []

        def settle(done):
            out, n_real, t_start, rows_b, t_disp = done
            pending.append(out.numpy()[:n_real].copy())
            if self.score_monitor is not None:
                self.score_monitor.observe(pending[-1])
            now = time.perf_counter()
            self.cache.profiler.record_dispatch(rows_b, now - t_disp,
                                                n_real)
            if t_start is None:  # not the dataset's last piece
                return None
            self._observe_latency(now - t_start)
            res = (pending[0] if len(pending) == 1
                   else np.concatenate(pending))
            pending.clear()
            return res

        for ds in datasets:
            t_req = time.perf_counter()
            if ds.num_rows == 0:
                # Flush in-flight work so output order is preserved.
                for done in win.drain():
                    res = settle(done)
                    if res is not None:
                        yield res
                yield np.zeros(0, self.np_dtype)
                continue
            pieces = self._split(ds)
            for pi, piece in enumerate(pieces):
                with span("featureize"):
                    req = self._featureize(piece)
                with span("assemble"):
                    key, payload, _ = self._assemble([req])
                launched = self._dispatch(key, payload)
                done = self._push(
                    win, (piece.num_rows,
                          t_req if pi == len(pieces) - 1 else None,
                          key[0], time.perf_counter()), launched)
                if done is not None:
                    res = settle(done)
                    if res is not None:
                        yield res
        for done in win.drain():
            res = settle(done)
            if res is not None:
                yield res

    def score_container_stream(self, path, id_types, feature_shard_maps,
                               batch_rows: int = 4096,
                               add_intercept: bool = True,
                               feeder: str = "auto",
                               prefetch_depth: int = 2):
        """Streamed scoring of Avro container input: ``(dataset,
        scores)`` per decoded batch, in input order. The block-stream
        feeder (data/block_stream.py) decodes batch k+1 on its prefetch
        thread while ``score_stream`` keeps batch k's dispatch in flight;
        host residency is bounded by ``prefetch_depth + 2`` decoded
        batches plus ``pipeline_depth`` in flight. The iterator's
        ``.stream`` is the ``BlockGameStream``."""
        from photon_ml_tpu_torch.data.block_stream import BlockGameStream

        stream = BlockGameStream(
            path, id_types=id_types,
            feature_shard_maps=feature_shard_maps, batch_rows=batch_rows,
            add_intercept=add_intercept, feeder=feeder,
            prefetch_depth=prefetch_depth)

        def run():
            held: deque = deque()  # batches whose dispatch is in flight

            def feed():
                for ds in stream:
                    held.append(ds)
                    yield ds

            for scores in self.score_stream(feed()):
                yield held.popleft(), scores

        return _StreamScoring(run(), stream)

    # -- introspection -----------------------------------------------------

    @property
    def shard_order(self) -> Tuple[str, ...]:
        """Feature-shard order used in bucket keys (registration order)."""
        return self._shard_order

    def buckets(self) -> Dict[Tuple, BucketExecutable]:
        """This engine's bucket executables by bucket shape."""
        return dict(self.cache.items())

    def cache_info(self) -> dict:
        return {"entries": len(self.cache),
                "compilations": self.cache.compilations,
                "traces": self.cache.total_traces(),
                "bucket_shapes": sorted(self.cache.keys())}

    def stats(self) -> dict:
        """Engine counters, snake_case (JAX's keys, with the score
        monitor's ``score_distribution`` when one is attached).
        ``request_latency_seconds``
        reads this engine's per-model histogram when it has a
        ``metrics_label``, else the process-wide one (which sums across
        live engines; populated only while telemetry is enabled). An
        unlabelled engine reports its cache's ``profiler`` table; a
        labelled one is a front-end's, whose ``stats()["cache"]`` carries
        the shared table once."""
        s = dict(self._stats)
        s["padding_waste_rows"] = (
            1.0 - s["rows_scored"] / s["rows_padded"]
            if s["rows_padded"] else 0.0)
        s["padding_waste_nnz"] = (
            1.0 - s["nnz_scored"] / s["nnz_padded"]
            if s["nnz_padded"] else 0.0)
        s.update(self.cache_info())
        if self.metrics_label:
            s["metrics_label"] = self.metrics_label
        else:
            s["profiler"] = self.cache.profiler.table()
        h = (self._h_latency if self._h_latency is not None
             else _H_REQUEST_LATENCY)
        s["request_latency_seconds"] = h.snapshot()
        if self.score_monitor is not None:
            s["score_distribution"] = self.score_monitor.snapshot()
        return s
