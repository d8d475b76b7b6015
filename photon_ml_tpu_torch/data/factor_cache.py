"""Device-resident factor tables for out-of-core matrix factorization
(port of photon_ml_tpu/data/factor_cache.py:93-580: FactorShardSpec,
FactorPlan, plan_factors, count_stream_entities, FactorSpill,
encode_factor_spill / restore_spilled_factors, FactorShard and
DeviceFactorCache with its ``devices=`` placement :339-411).

The factor half of streamed MF (ops/mf_alternating.py is the solver
half): the per-entity latent factors of a factored random effect live in
shards that a budgeted cache may spill, so factor tables larger than the
card train to completion.

**Planning** (``plan_factors``, ALX's density bucketing): entities are
grouped by observation count into power-of-two classes, each class cut
into shards of at most ``entities_per_shard`` entities, padded to a
power-of-two entity axis ``e_pad``. The plan is a pure function of the
vocabulary and the counts, so the fixed shard order, the replay order of
every alternating sweep, is deterministic.

**Residency** (``DeviceFactorCache``): each shard's table ``[e_pad, k]``
is the evictable unit. ``hbm_budget_bytes`` bounds the factor bytes the
cache holds on the device, at the table's real element size (4 bytes in
float32, 8 in float64). Eviction is replay-aware: the sweep writes shards
0..n-1 and reads them 0..n-1, a cyclic scan, so the victim is the
resident shard whose next use is furthest in that cycle.

**Spill tiers**: ``f32`` (the default) spills a table's bytes verbatim to
the host and re-uploads them; ``bf16`` rounds every table to bfloat16 at
write, whether or not it ever spills (so a bf16 train is deterministic
and independent of residency), spills the half-width bytes and widens
them on the device (torch ops, as data/shard_cache.py does for feature
blocks); ``redecode`` keeps no host copy and re-derives an evicted shard
from the observations through the solver's hook: the γ solve is an exact
ridge solve, a pure function of (observations, B), so the re-derived
bytes are the evicted ones. bf16 with redecode is rejected.

**Placement** (``devices=``, a model-axis device list): shard i's table
lives on ``devices[i % D]``, placed at every write and restore, so spill
re-uploads and re-derivations land back on the shard's home device.
Without it every table lives on ``device``.

The registry metrics ``data.factor_cache.*`` (JAX :66-81) mirror the
cache's ``stats()`` while telemetry is on; a spill restore is a
``factor_reupload`` span and a re-derivation a ``factor_redecode`` span
(JAX :488, :494).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry

Tensor = torch.Tensor

FACTOR_SPILL_DTYPES = ("f32", "bf16")
FACTOR_SPILL_SOURCES = ("buffer", "redecode")

# Registry mirrors of the per-instance ``_stats`` (no-ops while
# telemetry is off); the JAX package's names.
_M_HITS = telemetry.counter("data.factor_cache.hits")
_M_MISSES = telemetry.counter("data.factor_cache.misses")
_M_EVICTIONS = telemetry.counter("data.factor_cache.evictions")
_M_REUPLOAD_BYTES = telemetry.counter("data.factor_cache.bytes_reuploaded")
_M_SPILL_WRITTEN = telemetry.counter("data.factor_cache.spill_bytes_written")
_M_REDECODES = telemetry.counter("data.factor_cache.redecodes")
_G_DEVICE_BYTES = telemetry.gauge("data.factor_cache.device_bytes")
_G_PEAK_BYTES = telemetry.gauge("data.factor_cache.peak_device_bytes")
_G_SPILL_HOST = telemetry.gauge("data.factor_cache.spill_bytes_host")


def next_pow2(n: int) -> int:
    """The smallest power of two >= n (1 for n <= 1)."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class FactorShardSpec:
    """One factor shard: a power-of-two-padded slice of one
    observation-count class. ``codes`` are global entity codes,
    ascending: the slot order inside the shard."""

    index: int
    obs_bucket: int  # power-of-two observation-count class
    codes: np.ndarray  # i64[n_entities], ascending
    e_pad: int  # power-of-two padded entity axis

    @property
    def n_entities(self) -> int:
        return len(self.codes)


@dataclasses.dataclass
class FactorPlan:
    """Deterministic entity -> (shard, slot) assignment. ``vocabulary``
    is the entity names by code (the sorted unique names, as
    ``np.unique`` gives them); ``counts[c]`` entity c's observations.
    Entities without observations ride the smallest class and solve to
    exactly zero factors."""

    vocabulary: np.ndarray
    counts: np.ndarray
    shards: List[FactorShardSpec]
    shard_of_code: np.ndarray  # i32[n_codes]
    slot_of_code: np.ndarray  # i32[n_codes]

    def __post_init__(self):
        v = np.asarray(self.vocabulary)
        v = v.astype(str) if v.dtype.kind != "U" else v
        self._order = np.argsort(v, kind="stable")
        self._sorted = v[self._order]

    @property
    def num_entities(self) -> int:
        return len(self.vocabulary)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def codes_of(self, names) -> np.ndarray:
        """Global entity codes of a batch of names, -1 where unknown."""
        q = np.asarray(names)
        q = q.astype(str) if q.dtype.kind != "U" else q
        if self._sorted.size == 0 or q.size == 0:
            return np.full(q.shape, -1, np.int64)
        pos = np.minimum(np.searchsorted(self._sorted, q),
                         len(self._sorted) - 1)
        return np.where(self._sorted[pos] == q, self._order[pos], -1)

    def obs_bucket_histogram(self) -> Dict[int, int]:
        """Entities per power-of-two observation-count class."""
        out: Dict[int, int] = {}
        for s in self.shards:
            out[s.obs_bucket] = out.get(s.obs_bucket, 0) + s.n_entities
        return out


def plan_factors(vocabulary, counts, entities_per_shard: int = 512,
                 min_entities_pad: int = 8) -> FactorPlan:
    """Bucket entities by observation count, then shard: classes are
    ``next_pow2(count)`` (zero counts join the smallest), entities keep
    ascending code order within a class, each class is cut into runs of
    at most ``entities_per_shard``, padded to ``e_pad = next_pow2(len)``
    (at least ``min_entities_pad``)."""
    vocabulary = np.asarray(vocabulary)
    counts = np.asarray(counts, np.int64)
    if len(vocabulary) != len(counts):
        raise ValueError(
            f"vocabulary has {len(vocabulary)} entities, counts has "
            f"{len(counts)}")
    if entities_per_shard < 1:
        raise ValueError(
            f"entities_per_shard must be >= 1, got {entities_per_shard}")
    n = len(vocabulary)
    # next_pow2 of the whole column at once: frexp is exact for ints
    # below 2^53, v = m 2^e with m in [0.5, 1).
    m, e = np.frexp(np.maximum(counts, 1).astype(np.float64))
    cls_of = np.where(m == 0.5, np.left_shift(np.int64(1), e - 1),
                      np.left_shift(np.int64(1), e))
    order = np.lexsort((np.arange(n, dtype=np.int64), cls_of))

    shards: List[FactorShardSpec] = []
    shard_of = np.full(n, -1, np.int32)
    slot_of = np.full(n, -1, np.int32)
    classes, starts = np.unique(cls_of[order], return_index=True)
    bounds = list(starts) + [n]
    for ci, cls in enumerate(classes):
        codes = order[bounds[ci]:bounds[ci + 1]]  # ascending by code
        for start in range(0, len(codes), entities_per_shard):
            run = codes[start:start + entities_per_shard]
            idx = len(shards)
            shards.append(FactorShardSpec(
                index=idx, obs_bucket=int(cls), codes=run,
                e_pad=max(next_pow2(len(run)), min_entities_pad)))
            shard_of[run] = idx
            slot_of[run] = np.arange(len(run), dtype=np.int32)
    return FactorPlan(vocabulary=vocabulary, counts=counts, shards=shards,
                      shard_of_code=shard_of, slot_of_code=slot_of)


def count_stream_entities(stream, re_type: str):
    """One bounded-memory pass over a GameDataset stream: the entity
    vocabulary (sorted unique names), per-entity observation counts, the
    row count and the feature count of every shard. Host state is
    O(entities). Returns ``(vocabulary, counts, n_rows,
    n_features_by_shard)``."""
    vocab = np.zeros(0, dtype="U1")
    cts = np.zeros(0, np.int64)
    n_rows = 0
    d_by_shard: Dict[str, int] = {}
    for ds in stream:
        if ds.num_rows == 0:
            continue
        col = ds.id_columns.get(re_type)
        if col is None:
            raise ValueError(
                f"stream batches carry no {re_type!r} id column — pass "
                "id_types=[random_effect_type] to the stream")
        names, per = np.unique(col.vocabulary[col.codes],
                               return_counts=True)
        all_names = np.concatenate([vocab, names.astype(str)])
        all_counts = np.concatenate([cts, per.astype(np.int64)])
        vocab, inv = np.unique(all_names, return_inverse=True)
        cts = np.zeros(len(vocab), np.int64)
        np.add.at(cts, inv, all_counts)
        n_rows += ds.num_rows
        for s, mat in ds.feature_shards.items():
            d_by_shard[s] = mat.shape[1]
    if n_rows == 0:
        raise ValueError("stream yielded no rows to plan factors from")
    return vocab, cts, n_rows, d_by_shard


# -- spill codec: verbatim, or bfloat16 widened back on the device --------


@dataclasses.dataclass
class FactorSpill:
    """Host record of one evicted shard: ``f32`` holds the table's bytes
    verbatim (in the cache's type), ``bf16`` the half-width table
    (lossless: the resident copy was rounded at write)."""

    enc: Tensor  # host [e_pad, k], the cache's type or bfloat16
    dtype_tag: str  # "f32" | "bf16"

    @property
    def nbytes(self) -> int:
        return self.enc.numel() * self.enc.element_size()


def quantize_bf16(gamma: Tensor) -> Tensor:
    """The write-time bfloat16 round trip of a bf16 train, on the
    table's device and back in its type."""
    return gamma.to(torch.bfloat16).to(gamma.dtype)


def encode_factor_spill(gamma: Tensor, spill_dtype: str) -> FactorSpill:
    """Device table -> host spill record (pinned memory on the card)."""
    if spill_dtype not in FACTOR_SPILL_DTYPES:
        raise ValueError(
            f"spill_dtype must be one of {FACTOR_SPILL_DTYPES}, got "
            f"{spill_dtype!r}")
    src = gamma if spill_dtype == "f32" else gamma.to(torch.bfloat16)
    pin = src.device.type == "cuda"
    enc = torch.empty(src.shape, dtype=src.dtype, pin_memory=pin)
    enc.copy_(src)
    return FactorSpill(enc=enc, dtype_tag=spill_dtype)


def restore_spilled_factors(spill: FactorSpill, dtype, device) -> Tensor:
    """The one spill -> device path: f32 re-uploads the evicted bytes;
    bf16 uploads the half-width table and widens it on the device."""
    return spill.enc.to(device).to(dtype)


# -- the cache ------------------------------------------------------------


@dataclasses.dataclass
class FactorShard:
    """One planned shard's residency: ``gamma`` the canonical device
    table (None = evicted), ``spill`` its host record (None in the
    redecode tier)."""

    spec: FactorShardSpec
    factor_bytes: int  # device bytes of the table while resident
    gamma: Optional[Tensor] = None
    spill: Optional[FactorSpill] = None
    written: bool = False  # at least one sweep wrote this shard

    @property
    def spill_bytes(self) -> int:
        return 0 if self.spill is None else self.spill.nbytes


class DeviceFactorCache:
    """Budgeted device residency for the factor tables of one streamed MF
    coordinate (module docstring). The sweep writes shards in fixed
    order (``write``) and reads them in the same order (``ensure``);
    ``set_redecode`` installs the redecode tier's hook,
    ``fn(shard_index) -> [e_pad, k]``, for the current sweep. ``devices``
    places shard i on ``devices[i % D]`` (module docstring)."""

    def __init__(self, plan: FactorPlan, num_factors: int,
                 hbm_budget_bytes: Optional[int] = None,
                 spill_dtype: str = "f32", spill_source: str = "buffer",
                 redecode: Optional[Callable] = None,
                 dtype=torch.float32, device="cuda",
                 devices: Optional[List] = None):
        if spill_dtype not in FACTOR_SPILL_DTYPES:
            raise ValueError(
                f"spill_dtype must be one of {FACTOR_SPILL_DTYPES}, got "
                f"{spill_dtype!r}")
        if spill_source not in FACTOR_SPILL_SOURCES:
            raise ValueError(
                f"spill_source must be one of {FACTOR_SPILL_SOURCES}, "
                f"got {spill_source!r}")
        if spill_source == "redecode" and spill_dtype != "f32":
            raise ValueError(
                f"spill_dtype={spill_dtype!r} compresses host spill "
                "buffers, but spill_source='redecode' keeps none — the "
                "combination would silently train as f32 while "
                "reporting bf16; pick one")
        if num_factors < 1:
            raise ValueError(f"num_factors must be >= 1, got {num_factors}")
        self.plan = plan
        self.k = int(num_factors)
        self.hbm_budget_bytes = hbm_budget_bytes
        self.spill_dtype = spill_dtype
        self.spill_source = spill_source
        self.dtype = dtype
        self.device = torch.device(device)
        self.devices = ([torch.device(d) for d in devices] if devices
                        else None)
        self._redecode = redecode
        item = torch.empty((), dtype=dtype).element_size()
        self._entries = [FactorShard(spec=s,
                                     factor_bytes=item * s.e_pad * self.k)
                         for s in plan.shards]
        self._stats = {"hits": 0, "misses": 0, "evictions": 0,
                       "bytes_reuploaded": 0, "spill_bytes_written": 0,
                       "redecodes": 0}
        self.device_bytes = 0
        self.peak_device_bytes = 0
        _G_SPILL_HOST.set(0)

    def set_redecode(self, fn: Optional[Callable]) -> None:
        self._redecode = fn

    def shard_device(self, index: int) -> Optional[torch.device]:
        """Shard ``index``'s home device, or None when unplaced."""
        if self.devices is None:
            return None
        return self.devices[index % len(self.devices)]

    def _home(self, index: int) -> torch.device:
        return self.shard_device(index) or self.device

    @property
    def n_shards(self) -> int:
        return len(self._entries)

    @property
    def entries(self) -> List[FactorShard]:
        return list(self._entries)

    @property
    def spill_bytes_host(self) -> int:
        return sum(e.spill_bytes for e in self._entries)

    def e_pad_buckets(self) -> set:
        return {e.spec.e_pad for e in self._entries}

    def _check_shape(self, index: int, gamma: Tensor, what: str) -> None:
        want = (self._entries[index].spec.e_pad, self.k)
        if tuple(gamma.shape) != want:
            raise ValueError(f"factor shard {index} {what} has shape "
                             f"{tuple(gamma.shape)}, expected {want}")

    def _resident(self, e: FactorShard, gamma: Tensor) -> None:
        self.device_bytes += e.factor_bytes
        self.peak_device_bytes = max(self.peak_device_bytes,
                                     self.device_bytes)
        _G_PEAK_BYTES.set(self.peak_device_bytes)
        _G_DEVICE_BYTES.set(self.device_bytes)
        e.gamma = gamma

    def write(self, index: int, gamma: Tensor) -> Tensor:
        """Commit one shard's freshly solved factors as the canonical
        copy; returns it (bf16 trains round it here, at every write, so
        callers must use the returned table). A stale spill record is
        dropped; the budget is enforced with this shard pinned."""
        e = self._entries[index]
        gamma = gamma.to(self._home(index), self.dtype)
        self._check_shape(index, gamma, "write")
        if self.spill_dtype == "bf16":
            gamma = quantize_bf16(gamma)
        if e.gamma is not None:
            self.device_bytes -= e.factor_bytes
        self._resident(e, gamma)
        if e.spill is not None:
            e.spill = None  # superseded by this write
            _G_SPILL_HOST.set(self.spill_bytes_host)
        e.written = True
        self._enforce_budget(pinned=index)
        return gamma

    def ensure(self, index: int) -> Tensor:
        """The shard's resident factors, restored on a miss (a spill
        re-upload, or the redecode hook). A read before the first write
        raises."""
        e = self._entries[index]
        if not e.written:
            raise RuntimeError(
                f"factor shard {index} was never written — run a gamma "
                "pass before reading factors")
        if e.gamma is not None:
            self._stats["hits"] += 1
            _M_HITS.inc()
            return e.gamma
        self._stats["misses"] += 1
        _M_MISSES.inc()
        if e.spill is not None:
            reupload = e.spill.nbytes
            with telemetry.span("factor_reupload"):
                gamma = restore_spilled_factors(e.spill, self.dtype,
                                                self._home(index))
        elif self._redecode is not None:
            reupload = e.factor_bytes
            self._stats["redecodes"] += 1
            _M_REDECODES.inc()
            with telemetry.span("factor_redecode"):
                gamma = self._redecode(index).to(self._home(index),
                                                 self.dtype)
            self._check_shape(index, gamma, "redecode")
        else:
            raise RuntimeError(
                f"factor shard {index} was evicted but has no spill "
                "record and no redecode hook (cache built without an "
                "hbm budget?)")
        self._stats["bytes_reuploaded"] += reupload
        _M_REUPLOAD_BYTES.inc(reupload)
        self._resident(e, gamma)
        self._enforce_budget(pinned=index)
        return e.gamma

    def _enforce_budget(self, pinned: int) -> None:
        """Evict the resident shards whose next use is furthest in the
        cyclic sweep order from the one in hand until within budget. The
        buffer tiers encode a fresh spill record unless a live one (a
        restored, unrewritten shard) already holds these bytes; the
        redecode tier drops the table."""
        budget = self.hbm_budget_bytes
        if budget is None or self.device_bytes <= budget:
            return
        n = len(self._entries)
        resident = [e for e in self._entries
                    if e.gamma is not None and e.spec.index != pinned]
        resident.sort(key=lambda e: -((e.spec.index - pinned) % n))
        while self.device_bytes > budget and resident:
            victim = resident.pop(0)
            if self.spill_source == "buffer" and victim.spill is None:
                victim.spill = encode_factor_spill(victim.gamma,
                                                   self.spill_dtype)
                self._stats["spill_bytes_written"] += victim.spill.nbytes
                _M_SPILL_WRITTEN.inc(victim.spill.nbytes)
            victim.gamma = None
            self.device_bytes -= victim.factor_bytes
            self._stats["evictions"] += 1
            _M_EVICTIONS.inc()
        _G_DEVICE_BYTES.set(self.device_bytes)
        _G_SPILL_HOST.set(self.spill_bytes_host)

    def stats(self) -> Dict:
        s = dict(self._stats)
        s.update({
            "shards": self.n_shards,
            "entities": self.plan.num_entities,
            "num_factors": self.k,
            "e_pad_buckets": sorted(self.e_pad_buckets()),
            "obs_bucket_histogram": {
                str(k): v for k, v in sorted(
                    self.plan.obs_bucket_histogram().items())},
            "hbm_budget_bytes": self.hbm_budget_bytes,
            "device_bytes": self.device_bytes,
            "peak_device_bytes": self.peak_device_bytes,
            "spill_dtype": self.spill_dtype,
            "spill_source": self.spill_source,
            "spill_bytes_host": self.spill_bytes_host,
            "devices": len(self.devices) if self.devices else None,
            "resident_shards": sum(1 for e in self._entries
                                   if e.gamma is not None),
        })
        return s
