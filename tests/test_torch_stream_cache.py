"""The port's data/shard_cache.py on the CPU at float64 (the cases of
tests/test_shard_cache.py): exact assembly equals the one-shot
``fixed_effect_batch`` tensor for tensor; the cache's blocks, spill
codecs (f32 and bf16, against the JAX package's ``encode_spill`` on the
same arrays) and redecode tier restore the evicted blocks bit for bit;
Belady eviction beats LRU's thrash; the budget binds during ingest; and
the cache's invariants hold: hits + misses = passes x shards, and device
bytes never above the budget plus one block. Every prefetch thread a
test starts is joined with a timeout of its own (the autouse fixture).
"""

import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.data import shard_cache as jax_cache
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.shard_cache import (
    DeviceShardCache,
    SpillBlock,
    assemble_fixed_effect_batch,
    bf16_bits,
    encode_spill,
    restore_spilled_features,
)
from photon_ml_tpu_torch.ops.features import CSRFeatures
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

F64 = torch.float64


@pytest.fixture(autouse=True)
def _join_prefetch_threads():
    yield
    for t in threading.enumerate():
        if t.name == "host-prefetch":
            t.join(timeout=10)
            assert not t.is_alive(), "a prefetch thread did not end"


class FakeStream:
    """GameDataset batches cut from one host matrix: the BlockGameStream
    shape without Avro."""

    def __init__(self, X, y, batch_rows, offsets=None, weights=None):
        self.X, self.y = sp.csr_matrix(X), np.asarray(y, float)
        self.offsets, self.weights = offsets, weights
        self.batch_rows = batch_rows

    def __iter__(self):
        n = self.X.shape[0]
        for s in range(0, n, self.batch_rows):
            e = min(n, s + self.batch_rows)
            yield GameDataset.build(
                responses=self.y[s:e], feature_shards={"g": self.X[s:e]},
                offsets=None if self.offsets is None else self.offsets[s:e],
                weights=None if self.weights is None else self.weights[s:e])

    def stats(self):
        return {"decode_path": "fake", "batches": -1}


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    n, d = 517, 37
    X = sp.random(n, d, density=0.08, random_state=5, format="csr")
    X.data[:] = rng.normal(0, 1, X.nnz)
    return (X, (rng.random(n) < 0.5).astype(float), rng.normal(0, 0.2, n),
            rng.gamma(1.0, 1.0, n))


def _cache(problem, batch_rows=100, **kw):
    X, y, off, w = problem
    return DeviceShardCache.from_stream(
        FakeStream(X, y, batch_rows, off, w), "g", dtype=F64, device="cpu",
        **kw)


def _block_tensors(feats):
    return tuple(getattr(feats, k) for k in ("crow", "col", "values",
                                             "crow_t", "row_t", "values_t"))


def _same(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(a, b))


def _csr_parts(t):
    return (t.crow_indices(), t.col_indices(), t.values())


@pytest.mark.parametrize("batch_rows", [64, 33, 517, 1000])
def test_assembly_equals_one_shot_sparse(problem, batch_rows):
    """CSR regime: both CSR tensors, the expanded triplet and the row
    columns are the one-shot tensors exactly, for aligned, non-aligned,
    exact and oversized batches."""
    X, y, off, w = problem
    ref = GameDataset.build(responses=y, feature_shards={"g": X},
                            offsets=off, weights=w).fixed_effect_batch(
        "g", dtype=F64, device="cpu")
    shim = assemble_fixed_effect_batch(FakeStream(X, y, batch_rows, off, w),
                                       "g", dtype=F64, device="cpu")
    got = shim.fixed_effect_batch("g", dtype=F64, device="cpu")
    assert isinstance(got.features, CSRFeatures)
    assert _same(_csr_parts(got.features.csr), _csr_parts(ref.features.csr))
    assert _same(_csr_parts(got.features.csr_t),
                 _csr_parts(ref.features.csr_t))
    assert _same([getattr(got.features, k) for k in
                  ("values", "col_ids", "row_ids")],
                 [getattr(ref.features, k) for k in
                  ("values", "col_ids", "row_ids")])
    assert _same([got.labels, got.offsets, got.weights],
                 [ref.labels, ref.offsets, ref.weights])
    assert shim.num_rows == X.shape[0]
    assert shim.feature_shards["g"].shape == X.shape


def test_assembly_equals_one_shot_dense():
    """Dense regime: scattering the CSR pieces gives the host densify-
    then-upload array exactly."""
    rng = np.random.default_rng(2)
    X = sp.csr_matrix(rng.normal(0, 1, (211, 12))
                      * (rng.random((211, 12)) < 0.6))
    y = (rng.random(211) < 0.5).astype(float)
    ref = GameDataset.build(responses=y, feature_shards={"g": X}) \
        .fixed_effect_batch("g", dtype=torch.float32, device="cpu")
    got = assemble_fixed_effect_batch(FakeStream(X, y, 50), "g",
                                      dtype=torch.float32, device="cpu") \
        .fixed_effect_batch("g")
    assert type(got.features) is type(ref.features)
    assert torch.equal(got.features.x, ref.features.x)


def test_shim_rejects_wrong_shard_and_dtype(problem):
    X, y, off, w = problem
    shim = assemble_fixed_effect_batch(FakeStream(X, y, 64, off, w), "g",
                                       dtype=F64, device="cpu")
    with pytest.raises(KeyError, match="assembled shard"):
        shim.fixed_effect_batch("other")
    with pytest.raises(ValueError, match="assembled as"):
        shim.fixed_effect_batch("g", dtype=torch.float16)


def test_cache_blocks_and_residency(problem):
    """Unbounded: every block resident, no spill records kept, a replay
    is pure hits; each block is its shard's rows (no padding) with the
    int32 CSR and transpose of that shard."""
    X, y, off, w = problem
    cache = _cache(problem)
    assert cache.n_rows == X.shape[0] and cache.n_shards == 6
    for e in cache.entries:
        assert e.feats is not None and e.spill is None
        rows = X[e.row_offset:e.row_offset + e.n_rows]
        b = e.feats
        assert (b.n_rows, b.nnz) == (e.n_rows, rows.nnz)
        assert b.crow.dtype == b.col.dtype == b.row_t.dtype == torch.int32
        np.testing.assert_array_equal(b.crow.numpy(), rows.indptr)
        np.testing.assert_array_equal(b.col.numpy(), rows.indices)
        t = rows.T.tocsr()
        np.testing.assert_array_equal(b.crow_t.numpy(), t.indptr)
        np.testing.assert_array_equal(b.row_t.numpy(), t.indices)
        np.testing.assert_array_equal(b.values_t.numpy(), t.data)
        assert e.feature_bytes == b.nbytes
        np.testing.assert_array_equal(e.weights.numpy(),
                                      w[e.row_offset:e.row_offset + e.n_rows])
    list(cache.blocks())
    s = cache.stats()
    assert s["hits"] == cache.n_shards and s["misses"] == 0
    assert s["evictions"] == 0


@pytest.mark.parametrize("prefetch", [0, 2])
def test_cache_spill_reupload_bitwise(problem, prefetch):
    """Eviction and (prefetched) re-upload reproduce the evicted blocks
    exactly — residency never changes a partial."""
    resident = _cache(problem)
    block_bytes = max(e.feature_bytes for e in resident.entries)
    spill = _cache(problem, hbm_budget_bytes=2 * block_bytes)
    assert spill.stats()["resident_shards"] < spill.n_shards
    got = {b.index: b for b in spill.blocks(prefetch_depth=prefetch)}
    for e_ref in resident.entries:
        assert _same(_block_tensors(got[e_ref.index].feats),
                     _block_tensors(e_ref.feats))
    s = spill.stats()
    assert s["misses"] > 0 and s["evictions"] > 0
    assert 0 < s["bytes_reuploaded"] <= s["misses"] * max(
        e.spill.nbytes for e in spill.entries)
    assert s["hits"] + s["misses"] == s["epochs"] * spill.n_shards
    assert spill.device_bytes <= 2 * block_bytes
    assert spill.peak_device_bytes <= 3 * block_bytes


def test_cache_minimal_budget_keeps_only_in_hand_block(problem):
    cache = _cache(problem, hbm_budget_bytes=1)
    for expect, b in enumerate(cache.blocks(prefetch_depth=0)):
        assert b.index == expect
        assert [e.index for e in cache.entries
                if e.feats is not None] == [expect]


def test_cache_ingest_respects_budget(problem):
    """Evict-as-you-go: the ingest peak stays within the budget plus one
    block."""
    resident = _cache(problem)
    block = max(e.feature_bytes for e in resident.entries)
    cache = _cache(problem, hbm_budget_bytes=2 * block)
    assert cache.stats()["evictions"] > 0
    assert cache.peak_device_bytes <= 2 * block + block
    assert cache.device_bytes <= 2 * block


def test_cache_replay_aware_eviction_beats_lru_thrash(problem):
    """Room for n - 1 of n equal blocks: LRU would miss on every access;
    Belady's rule pays 1 + 1/(n-1) misses an epoch."""
    X, y, off, w = problem
    cut = (X[:500], y[:500], off[:500], w[:500])
    resident = _cache(cut)
    n = resident.n_shards
    sizes = {e.feature_bytes for e in resident.entries}
    per_block = max(sizes)
    cache = _cache(cut, hbm_budget_bytes=(n - 1) * per_block)
    epochs = 2 * (n - 1)
    for _ in range(epochs):
        list(cache.blocks(prefetch_depth=0))
    s = cache.stats()
    bound = epochs + -(-epochs // (n - 1))
    assert s["misses"] <= bound, (s["misses"], bound)
    assert s["hits"] + s["misses"] == epochs * n
    assert s["misses"] < epochs * n / 2


def test_cache_snapshot_survives_eviction(problem):
    cache = _cache(problem, hbm_budget_bytes=1)
    blocks = list(cache.blocks(prefetch_depth=2))
    assert len(blocks) == cache.n_shards
    assert all(b.feats is not None and b.feats.values.numel() > 0
               for b in blocks)


def test_cache_stats_keys(problem):
    s = _cache(problem, batch_rows=200, hbm_budget_bytes=10 << 20).stats()
    jax_keys = {"hits", "misses", "evictions", "bytes_reuploaded",
                "epochs", "shards", "rows", "bucket_shapes",
                "hbm_budget_bytes", "device_bytes", "peak_device_bytes",
                "resident_shards", "spill_dtype", "spill_source",
                "spill_bytes_host", "spill_bytes_written", "redecodes",
                "bytes_redecoded", "mesh_devices", "col_blocks",
                "col_block_size", "per_device_bytes",
                "per_device_resident_shards"}
    assert set(s) == jax_keys
    assert s["spill_dtype"] == "f32" and s["spill_source"] == "buffer"


def test_empty_stream_and_mesh_raise(problem):
    X = sp.csr_matrix((0, 4))
    with pytest.raises(ValueError, match="no rows"):
        assemble_fixed_effect_batch(FakeStream(X, np.zeros(0), 10), "g",
                                    device="cpu")
    with pytest.raises(ValueError, match="no rows"):
        DeviceShardCache.from_stream(FakeStream(X, np.zeros(0), 10), "g",
                                     device="cpu")
    # devices= places the shards over a 1-D mesh of slots (ROADMAP A6a,
    # tests/test_torch_mesh.py); col_blocks=2 (which raised naming A6b)
    # cuts them into column slices over a 1 x 2 grid (ROADMAP A6b,
    # tests/test_torch_mesh2d.py), and needs the grid's devices.
    two = _cache(problem, devices=["cpu", "cpu"])
    assert two.n_slots == 2 and two.stats()["mesh_devices"] == 2
    assert [e.slot for e in two.entries] == [
        i % 2 for i in range(two.n_shards)]
    with pytest.raises(ValueError, match="device grid"):
        _cache(problem, col_blocks=2)
    cols = _cache(problem, devices=["cpu", "cpu"], col_blocks=2)
    assert cols.stats()["col_blocks"] == 2
    assert all(e.slot == 1 and [u.slot for u in e.cols] == [0, 1]
               for e in cols.entries)


# -- spill codecs, against the JAX package's ---------------------------------


def _triplet(X):
    X = sp.csr_matrix(X)
    X.sort_indices()
    rows = np.repeat(np.arange(X.shape[0]), np.diff(X.indptr))
    return X, (X.data.astype(np.float32), X.indices.astype(np.int32),
               rows.astype(np.int32))


def test_spill_codec_f32_roundtrip_is_bitwise():
    X, (vals, cols, rows) = _triplet(
        sp.random(90, 50, density=0.1, random_state=0))
    blk = encode_spill(vals, cols, rows, X.nnz, "f32")
    assert blk.dtype_tag == "f32" and blk.nbytes == 12 * X.nnz
    b = restore_spilled_features(blk, 90, 50, "cpu")
    assert (b.values.numpy().tobytes(), b.col.numpy().tobytes()) == (
        vals.tobytes(), cols.tobytes())
    np.testing.assert_array_equal(b.crow.numpy(), X.indptr)


def test_spill_codec_bf16_equals_jax_and_roundtrips_indices():
    """bf16 spill: the encodings are the JAX package's (values as bf16
    bits, the same delta codes), index streams round-trip exactly and
    values through bfloat16 rounding."""
    import ml_dtypes

    rng = np.random.default_rng(4)
    X = sp.random(60, 300, density=0.05, random_state=1, format="csr")
    X.data[:] = rng.normal(0, 1, X.nnz)
    X, (vals, cols, rows) = _triplet(X)
    blk = encode_spill(vals, cols, rows, X.nnz, "bf16")
    ref = jax_cache.encode_spill(vals, cols, rows, X.nnz, "bf16")
    assert blk.enc_cols.dtype == blk.enc_rows.dtype == np.uint8
    np.testing.assert_array_equal(blk.enc_cols, ref.enc_cols)
    np.testing.assert_array_equal(blk.enc_rows, ref.enc_rows)
    np.testing.assert_array_equal(blk.enc_values,
                                  ref.enc_values.view(np.uint16))
    assert blk.nbytes * 3 == 12 * X.nnz
    b = restore_spilled_features(blk, 60, 300, "cpu", torch.float32)
    np.testing.assert_array_equal(b.col.numpy(), cols)
    np.testing.assert_array_equal(b.crow.numpy(), X.indptr)
    want = vals.astype(ml_dtypes.bfloat16).astype(np.float32)
    assert b.values.numpy().tobytes() == want.tobytes()


def test_spill_codec_bf16_empty_and_single_entry():
    blk = encode_spill(np.zeros(0, np.float32), np.zeros(0, np.int32),
                       np.zeros(0, np.int32), 0, "bf16")
    b = restore_spilled_features(blk, 8, 10, "cpu")
    assert b.nnz == 0 and int(b.crow[-1]) == 0
    one = sp.csr_matrix((np.asarray([2.5]), ([3], [7])), shape=(5, 10))
    _, (vals, cols, rows) = _triplet(one)
    b = restore_spilled_features(encode_spill(vals, cols, rows, 1, "bf16"),
                                 5, 10, "cpu")
    assert b.col.tolist() == [7] and b.crow.tolist() == [0, 0, 0, 0, 1, 1]
    assert float(b.values[0]) == 2.5  # exact in bf16


def test_spill_codec_u16_and_i32_overflow_fallback():
    mid = sp.csr_matrix((np.ones(4), ([0, 0, 1, 1], [5, 10_005, 3, 9_003])),
                        shape=(2, 20_000))
    _, (vals, cols, rows) = _triplet(mid)
    blk = encode_spill(vals, cols, rows, 4, "bf16")
    assert blk.enc_cols.dtype == np.uint16
    np.testing.assert_array_equal(
        restore_spilled_features(blk, 2, 20_000, "cpu").col.numpy(), cols)
    big = sp.csr_matrix((np.ones(2), ([0, 0], [1, 200_001])),
                        shape=(1, 300_000))
    _, (vals, cols, rows) = _triplet(big)
    blk = encode_spill(vals, cols, rows, 2, "bf16")
    assert blk.enc_cols.dtype == np.int32 and blk.enc_rows.dtype == np.uint8
    np.testing.assert_array_equal(
        restore_spilled_features(blk, 1, 300_000, "cpu").col.numpy(), cols)


def test_spill_codec_rejects_unknown_dtype():
    with pytest.raises(ValueError, match="spill_dtype"):
        encode_spill(np.zeros(4, np.float32), np.zeros(4, np.int32),
                     np.zeros(4, np.int32), 0, "f16")
    assert bf16_bits(np.asarray([1.0], np.float32)).tolist() == [0x3F80]


# -- compressed spill + redecode tiers through the cache -------------------


def _block_map(cache, **kw):
    return {b.index: tuple(t.numpy().tobytes() for t in
                           _block_tensors(b.feats))
            for b in cache.blocks(**kw)}


def test_cache_bf16_spill_indices_bitwise_and_host_bytes_third(problem):
    resident = _cache(problem)
    block_bytes = max(e.feature_bytes for e in resident.entries)
    f32 = _cache(problem, hbm_budget_bytes=2 * block_bytes)
    bf16 = _cache(problem, hbm_budget_bytes=2 * block_bytes,
                  spill_dtype="bf16")
    # float64 values: 8 + 4 + 4 bytes an entry against 2 + 1 + 1.
    assert bf16.spill_bytes_host * 4 == f32.spill_bytes_host
    assert bf16.stats()["spill_bytes_written"] == bf16.spill_bytes_host
    got = _block_map(bf16)
    for e in resident.entries:
        g = got[e.index]
        ref = tuple(t.numpy().tobytes() for t in _block_tensors(e.feats))
        assert (g[0], g[1], g[3], g[4]) == (ref[0], ref[1], ref[3], ref[4])
        want = torch.from_numpy(e.feats.values.numpy()).to(
            torch.bfloat16).to(F64).numpy()
        assert g[2] == want.tobytes()
    assert _block_map(bf16) == got  # replays are deterministic
    list(f32.blocks())
    list(f32.blocks())
    s_f32, s_bf16 = f32.stats(), bf16.stats()
    assert s_bf16["misses"] == s_f32["misses"] > 0
    assert s_bf16["bytes_reuploaded"] * 4 == s_f32["bytes_reuploaded"]


def test_cache_redecode_tier_drops_host_copy_and_replays_bitwise(problem):
    X, y, off, w = problem
    resident = _cache(problem)
    block_bytes = max(e.feature_bytes for e in resident.entries)
    ref = {e.index: tuple(t.numpy().tobytes()
                          for t in _block_tensors(e.feats))
           for e in resident.entries}

    def fetch(row_start, n_rows):
        s = slice(row_start, row_start + n_rows)
        return GameDataset.build(responses=y[s], feature_shards={"g": X[s]},
                                 offsets=off[s], weights=w[s])

    cache = _cache(problem, hbm_budget_bytes=2 * block_bytes,
                   spill_source="redecode", redecode_fetch=fetch)
    assert cache.spill_bytes_host == 0
    assert all(e.spill is None for e in cache.entries)
    for _ in range(2):
        assert _block_map(cache) == ref
    s = cache.stats()
    assert s["redecodes"] == s["misses"] > 0
    assert s["bytes_redecoded"] > 0 and s["spill_source"] == "redecode"


def test_cache_redecode_validates_fetch_and_requires_hook(problem):
    X, y, off, w = problem
    with pytest.raises(ValueError, match="redecode_fetch"):
        _cache(problem, hbm_budget_bytes=1, spill_source="redecode")

    def bad_fetch(row_start, n_rows):
        return GameDataset.build(responses=y[:n_rows],
                                 feature_shards={"g": X[:n_rows] * 2.0})

    cache = _cache(problem, hbm_budget_bytes=1, spill_source="redecode",
                   redecode_fetch=bad_fetch)
    with pytest.raises(RuntimeError, match="changed under the cache"):
        list(cache.blocks(prefetch_depth=0))


def test_cache_rejects_unknown_spill_options(problem):
    with pytest.raises(ValueError, match="spill_dtype"):
        _cache(problem, spill_dtype="f64")
    with pytest.raises(ValueError, match="spill_source"):
        _cache(problem, spill_source="disk")
    with pytest.raises(ValueError, match="pick one"):
        _cache(problem, hbm_budget_bytes=1, spill_dtype="bf16",
               spill_source="redecode", redecode_fetch=lambda s, n: None)


def test_cache_spill_bytes_host_accounting(problem):
    assert _cache(problem).spill_bytes_host == 0
    cache = _cache(problem, hbm_budget_bytes=1)
    want = sum(16 * e.nnz for e in cache.entries)  # float64 + 2 x int32
    assert cache.spill_bytes_host == cache.stats()["spill_bytes_host"] \
        == want
    assert all(isinstance(e.spill, SpillBlock) for e in cache.entries)
