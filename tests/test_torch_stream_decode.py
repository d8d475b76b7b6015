"""The port's C Avro decoder (photon_ml_tpu_torch/native/, a copy of the
JAX package's), its codec hook, fast_ingest and the block-streaming
feeder, against the JAX package's on the same files (written from a
seeded numpy generator): records and arrays are compared for equality,
exactly.

Covers the cases of tests/test_native_avro.py and tests/test_block_stream.py
for the port: the port's native and pure-Python decoders and the JAX
native decoder give identical records and arrays; BlockGameStream batches
are byte-identical across feeders and to the JAX stream's at batch sizes
that do and do not divide the row count; BlockRandomAccess returns the
rows it is asked for; the one-shot readers route through the C decoder
and equal the JAX readers; a failed build raises. Every prefetch thread a
test starts is joined with a timeout of its own (the autouse fixture).
"""

import io
import threading
import time

import numpy as np
import pytest
import scipy.sparse as sp

from photon_ml_tpu.data import avro_reader as jax_reader
from photon_ml_tpu.data import block_stream as jax_bs
from photon_ml_tpu.data import fast_ingest as jax_fast
from photon_ml_tpu.io import avro_codec as jax_codec
from photon_ml_tpu_torch import native
from photon_ml_tpu_torch.data import avro_reader, block_stream, fast_ingest
from photon_ml_tpu_torch.data.shard_planner import scan_container_blocks
from photon_ml_tpu_torch.io import avro_codec, schemas
from photon_ml_tpu_torch.io.avro_codec import (
    Schema,
    _write_long,
    compile_schema_program,
    read_container,
    write_container,
)
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

N_ROWS = 1000


@pytest.fixture(scope="module")
def decoder():
    """The C decoder, built here at first use (not at import)."""
    return native.load_avro_native()


@pytest.fixture(autouse=True)
def _join_prefetch_threads():
    yield
    for t in threading.enumerate():
        if t.name == "host-prefetch":
            t.join(timeout=10)
            assert not t.is_alive(), "a prefetch thread did not end"


def _write_stream_file(path, n, rng, n_features=40, per_row=5,
                       sync_interval=1024, n_users=9, n_items=6):
    recs = []
    for i in range(n):
        cols = rng.choice(n_features, size=per_row, replace=False)
        recs.append({
            "uid": f"u{i}" if i % 3 else None,
            "label": float(i % 2),
            "features": [
                {"name": f"f{c}", "term": "t" if c % 2 else None,
                 "value": float(rng.normal())} for c in cols],
            "weight": 2.0 if i % 5 == 0 else None,
            "offset": 0.25 if i % 7 == 0 else None,
            "metadataMap": {"userId": f"user{i % n_users}",
                            "itemId": f"item{i % n_items}"},
        })
    write_container(path, schemas.TRAINING_EXAMPLE, recs,
                    sync_interval=sync_interval)
    return recs


def _assert_batches_identical(a, b):
    for col in ("responses", "offsets", "weights"):
        x, y = getattr(a, col), getattr(b, col)
        assert x.dtype == y.dtype and np.array_equal(x, y), col
    assert (np.asarray(a.uids) == np.asarray(b.uids)).all()
    assert set(a.feature_shards) == set(b.feature_shards)
    for name in a.feature_shards:
        ma, mb = a.feature_shards[name], b.feature_shards[name]
        assert ma.shape == mb.shape
        assert np.array_equal(ma.data, mb.data)
        assert np.array_equal(ma.indices, mb.indices)
        assert np.array_equal(ma.indptr, mb.indptr)
    assert set(a.id_columns) == set(b.id_columns)
    for t in a.id_columns:
        assert np.array_equal(a.id_columns[t].codes, b.id_columns[t].codes)
        assert np.array_equal(a.id_columns[t].vocabulary,
                              b.id_columns[t].vocabulary)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream")
    rng = np.random.default_rng(5)
    one = root / "stream.avro"
    _write_stream_file(one, N_ROWS, rng)
    a, b = root / "a.avro", root / "b.avro"
    _write_stream_file(a, 300, rng)
    _write_stream_file(b, 170, rng)
    maps = {"global": avro_reader.build_index_map(one)}
    pair_maps = {"global": avro_reader.build_index_map([a, b])}
    return dict(one=one, a=a, b=b, maps=maps, pair_maps=pair_maps)


# -- the decoder and its codec hook (tests/test_native_avro.py) -------------


def _three_ways(path):
    return (list(read_container(path)), list(read_container(path,
                                                            native=False)),
            list(jax_codec.read_container(path)))


def test_training_examples_equal(tmp_path):
    rng = np.random.default_rng(1)
    records = [{
        "uid": f"u{i}" if i % 3 else None,
        "label": float(rng.normal()),
        "features": [{"name": f"f{j}", "term": "t" if j % 2 else None,
                      "value": float(rng.normal())}
                     for j in range(int(rng.integers(0, 8)))],
        "weight": float(rng.random()) if i % 2 else None,
        "offset": None,
        "metadataMap": ({"userId": f"user{i % 7}", "k": "v"} if i % 4
                        else None),
    } for i in range(500)]
    p = tmp_path / "data.avro"
    write_container(p, schemas.TRAINING_EXAMPLE, records)
    mine, python, jax = _three_ways(p)
    assert mine == python == jax == records


def test_exotic_schema_equal(tmp_path):
    schema = {
        "type": "record", "name": "Exotic", "fields": [
            {"name": "e", "type": {"type": "enum", "name": "Color",
                                   "symbols": ["RED", "GREEN", "BLUE"]}},
            {"name": "fx", "type": {"type": "fixed", "name": "F8",
                                    "size": 8}},
            {"name": "b", "type": "bytes"},
            {"name": "flag", "type": "boolean"},
            {"name": "i", "type": "int"},
            {"name": "l", "type": "long"},
            {"name": "f", "type": "float"},
            {"name": "nested", "type": {"type": "array", "items": {
                "type": "map", "values": ["null", "double", "string"]}}},
        ]}
    records = [
        {"e": "GREEN", "fx": b"12345678", "b": b"\x00\xff", "flag": True,
         "i": -2**31, "l": 2**62 - 1, "f": 1.5,
         "nested": [{"a": None, "b": 3.25}, {}, {"s": "ünicøde"}]},
        {"e": "RED", "fx": b"\x00" * 8, "b": b"", "flag": False,
         "i": 0, "l": -2**62, "f": -0.0, "nested": []},
    ]
    p = tmp_path / "exotic.avro"
    write_container(p, schema, records)
    mine, python, jax = _three_ways(p)
    assert mine == python == jax == records


def test_all_bundled_schemas_compile_as_jax():
    for name in ("NAME_TERM_VALUE", "TRAINING_EXAMPLE",
                 "BAYESIAN_LINEAR_MODEL", "LATENT_FACTOR", "SCORING_RESULT",
                 "FEATURE_SUMMARIZATION_RESULT"):
        schema = getattr(schemas, name)
        mine = compile_schema_program(Schema(schema).root)
        jax = jax_codec.compile_schema_program(jax_codec.Schema(schema).root)
        assert mine is not None, name
        assert (mine.prog, mine.root, mine.strings) == (
            jax.prog, jax.root, jax.strings), name


def test_truncated_block_raises(decoder):
    prog = compile_schema_program(Schema(schemas.NAME_TERM_VALUE).root)
    with pytest.raises(ValueError):
        decoder.decode_block(b"\x02", 1, prog.prog, prog.root, prog.strings)


def test_trailing_bytes_raise(decoder):
    prog = compile_schema_program(Schema("long").root)
    with pytest.raises(ValueError, match="trailing"):
        decoder.decode_block(b"\x02\x02", 1, prog.prog, prog.root,
                             prog.strings)
    assert decoder.decode_block(b"\x02\x04", 2, prog.prog, prog.root,
                                prog.strings) == [1, 2]


# The reference's own wire layout: term a PLAIN string, metadataMap,
# weight and offset after the features.
REFERENCE_TRAINING_EXAMPLE = {
    "type": "record", "name": "TrainingExampleAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": {
            "type": "record", "name": "FeatureAvro", "fields": [
                {"name": "name", "type": "string"},
                {"name": "term", "type": "string"},
                {"name": "value", "type": "double"},
            ]}}},
        {"name": "metadataMap",
         "type": ["null", {"type": "map", "values": "string"}],
         "default": None},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
    ],
}


def _reference_records(n=50):
    return [
        {"uid": f"u{i}", "label": float(i % 2),
         "features": [{"name": "age", "term": "", "value": 1.0 + i},
                      {"name": "f", "term": "t2", "value": -0.5 * i}],
         "metadataMap": {"userId": f"user{i % 3}"},
         "weight": 1.0 + 0.5 * (i % 2), "offset": 0.25 * i}
        for i in range(n)]


def test_reference_layout_plain_string_term(tmp_path):
    """Plain-string terms take the C fast path, whose matrix equals the
    JAX reader's."""
    p = tmp_path / "ref.avro"
    write_container(p, REFERENCE_TRAINING_EXAMPLE, _reference_records())
    imap = avro_reader.build_index_map(p)
    fast = fast_ingest.fast_ingest([p], {"m": imap},
                                   {"m": imap.intercept_index},
                                   id_types=["userId"])
    assert fast is not None, "the C fast path rejected the reference layout"
    mine = avro_reader.read_labeled_points(p)
    jax = jax_reader.read_labeled_points(p)
    assert mine[4] == jax[4]
    for a, b in zip(mine[1:4], jax[1:4]):
        np.testing.assert_array_equal(a, b)
    assert (mine[0] != jax[0]).nnz == 0 and mine[0].shape == jax[0].shape
    assert list(mine[5].key_to_index_dict().items()) == list(
        jax[5].key_to_index_dict().items())
    assert fast.ids["userId"].tolist() == [
        r["metadataMap"]["userId"] for r in _reference_records()]


def test_mixed_optional_layouts_across_files(tmp_path):
    """A file with weight/offset and one without: rows stay aligned
    (absent fields default to weight 1, offset 0 per file)."""
    bare_schema = {
        "type": "record", "name": "TrainingExampleAvro", "fields": [
            {"name": "label", "type": "double"},
            {"name": "features", "type": {"type": "array", "items": {
                "type": "record", "name": "FeatureAvro", "fields": [
                    {"name": "name", "type": "string"},
                    {"name": "value", "type": "double"},
                ]}}},
        ]}
    rich, bare = tmp_path / "rich.avro", tmp_path / "bare.avro"
    write_container(rich, REFERENCE_TRAINING_EXAMPLE, _reference_records(8))
    write_container(bare, bare_schema, [
        {"label": 10.0 + i, "features": [{"name": "age", "value": 2.0}]}
        for i in range(3)])
    imap = avro_reader.build_index_map(rich)
    fast = fast_ingest.fast_ingest([rich, bare], {"m": imap},
                                   {"m": imap.intercept_index})
    assert fast is not None and len(fast.labels) == 11
    np.testing.assert_array_equal(fast.labels[8:], [10.0, 11.0, 12.0])
    np.testing.assert_array_equal(fast.offsets[:8],
                                  [0.25 * i for i in range(8)])
    np.testing.assert_array_equal(fast.offsets[8:], 0.0)
    np.testing.assert_array_equal(fast.weights[8:], 1.0)
    jax = jax_fast.fast_ingest([rich, bare], {"m": imap},
                               {"m": imap.intercept_index}, workers=1)
    for col in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(fast, col), getattr(jax, col))
    for a, b in zip(fast.shards["m"], jax.shards["m"]):
        np.testing.assert_array_equal(a, b)


def test_duplicate_metadata_key_keeps_last(decoder):
    """A doubly-present map key (legal on the wire) does not shift id
    alignment; the last occurrence wins, as with a Python dict."""
    schema = {
        "type": "record", "name": "T", "fields": [
            {"name": "label", "type": "double"},
            {"name": "features", "type": {"type": "array", "items": {
                "type": "record", "name": "F", "fields": [
                    {"name": "name", "type": "string"},
                    {"name": "value", "type": "double"},
                ]}}},
            {"name": "metadataMap",
             "type": ["null", {"type": "map", "values": "string"}]},
        ]}
    layout = fast_ingest.build_training_layout(Schema(schema).root)
    assert layout is not None

    def wstr(buf, s):
        b = s.encode()
        _write_long(buf, len(b))
        buf.write(b)

    buf = io.BytesIO()
    buf.write(np.float64(1.0).tobytes())
    _write_long(buf, 0)
    _write_long(buf, 1)
    _write_long(buf, 2)
    wstr(buf, "userId")
    wstr(buf, "first")
    wstr(buf, "userId")
    wstr(buf, "second")
    _write_long(buf, 0)
    (lb, _, _, _, _, ids_out) = decoder.decode_training_block(
        buf.getvalue(), 1, layout.prog, layout.layout,
        ({},), (-1,), ("userId",), "\x01", None)
    assert list(ids_out[0]) == ["second"]
    assert np.frombuffer(lb, np.float64).tolist() == [1.0]


def test_varint_extremes(decoder):
    vals = [0, 1, -1, 63, -64, 2**63 - 1, -2**63]
    buf = io.BytesIO()
    for v in vals:
        _write_long(buf, v)
    prog = compile_schema_program(Schema("long").root)
    assert decoder.decode_block(buf.getvalue(), len(vals), prog.prog,
                                prog.root, prog.strings) == vals


def test_failed_build_raises(tmp_path, monkeypatch):
    """No quiet fallback: a compiler failure raises with its output."""
    monkeypatch.setattr(native, "_module", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_command",
                        lambda out: ["false", str(out)])
    with pytest.raises(RuntimeError, match="did not build"):
        native.load_avro_native()
    with pytest.raises(RuntimeError, match="did not build"):
        avro_codec._native_decoder()


# -- the block-streaming feeder (tests/test_block_stream.py) ----------------


@pytest.mark.parametrize("batch_rows", [37, 125])
def test_native_batches_byte_identical_to_python_and_jax(files, batch_rows):
    """37 never divides the ~20-record blocks nor the 1,000 rows; 125
    divides the rows. Every cut is invisible."""
    args = (files["one"], ["userId", "itemId"], files["maps"])
    native_s = block_stream.BlockGameStream(*args, batch_rows=batch_rows,
                                            feeder="native",
                                            prefetch_depth=2)
    python_s = block_stream.BlockGameStream(*args, batch_rows=batch_rows,
                                            feeder="python")
    jax_s = jax_bs.BlockGameStream(*args, batch_rows=batch_rows,
                                   feeder="native", prefetch_depth=0)
    bn, bp, bj = list(native_s), list(python_s), list(jax_s)
    assert (native_s.decode_path, python_s.decode_path) == ("native",
                                                            "python")
    sizes = [batch_rows] * (N_ROWS // batch_rows) + (
        [N_ROWS % batch_rows] if N_ROWS % batch_rows else [])
    assert [d.num_rows for d in bn] == sizes
    assert len(bp) == len(bj) == len(sizes)
    for a, b, c in zip(bn, bp, bj):
        _assert_batches_identical(a, b)
        _assert_batches_identical(a, c)


def test_batches_concatenate_to_one_shot_dataset(files):
    whole, _ = avro_reader.read_game_dataset(
        files["one"], id_types=["userId"], feature_shard_maps=files["maps"])
    batches = list(block_stream.BlockGameStream(
        files["one"], ["userId"], files["maps"], batch_rows=129,
        feeder="native"))
    for col in ("responses", "offsets", "weights", "uids"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(d, col) for d in batches]),
            getattr(whole, col))
    m = sp.vstack([d.feature_shards["global"] for d in batches],
                  format="csr")
    w = whole.feature_shards["global"]
    for a in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(m, a), getattr(w, a))
    names = np.concatenate([d.id_columns["userId"].vocabulary[
        d.id_columns["userId"].codes] for d in batches])
    col = whole.id_columns["userId"]
    np.testing.assert_array_equal(names, col.vocabulary[col.codes])


def test_one_shot_read_uses_block_path_and_equals_jax(files, monkeypatch):
    calls = []
    real = block_stream.read_game_dataset_via_blocks

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(block_stream, "read_game_dataset_via_blocks", spy)
    mine, _ = avro_reader.read_game_dataset(
        files["one"], id_types=["userId", "itemId"],
        feature_shard_maps=files["maps"])
    jax, _ = jax_reader.read_game_dataset(
        files["one"], id_types=["userId", "itemId"],
        feature_shard_maps=files["maps"], ingest_workers=1)
    assert calls == [True]
    _assert_batches_identical(mine, jax)


def test_one_shot_block_read_declines_cleanly(tmp_path):
    """A schema outside the training layout (a float label) reads through
    the record loop, equal to the JAX reader."""
    schema = {
        "type": "record", "name": "T", "fields": [
            {"name": "label", "type": "float"},
            {"name": "features", "type": {"type": "array", "items": {
                "type": "record", "name": "F", "fields": [
                    {"name": "name", "type": "string"},
                    {"name": "value", "type": "double"},
                ]}}},
        ]}
    p = tmp_path / "odd.avro"
    write_container(p, schema, [
        {"label": float(i % 2), "features": [{"name": "a", "value": 0.5 * i}]}
        for i in range(20)])
    maps = {"global": avro_reader.build_index_map(p)}
    assert block_stream.read_game_dataset_via_blocks(p, [], maps) is None
    mine, _ = avro_reader.read_game_dataset(p, [], maps)
    jax, _ = jax_reader.read_game_dataset(p, [], maps, ingest_workers=1)
    _assert_batches_identical(mine, jax)
    with pytest.raises(RuntimeError, match="does not fit"):
        block_stream.BlockGameStream(p, [], maps, batch_rows=4,
                                     feeder="native")
    auto = block_stream.BlockGameStream(p, [], maps, batch_rows=4)
    assert auto.decode_path == "python" and sum(
        d.num_rows for d in auto) == 20


def test_validation_errors(files):
    with pytest.raises(ValueError, match="batch_rows"):
        block_stream.BlockGameStream(files["one"], [], files["maps"],
                                     batch_rows=0)
    with pytest.raises(ValueError, match="feeder"):
        block_stream.BlockGameStream(files["one"], [], files["maps"],
                                     batch_rows=1, feeder="spark")
    with pytest.raises(ValueError, match="batch_rows"):
        block_stream.BlockGameStream(files["one"], [], files["maps"],
                                     batch_rows=-1)


def test_multi_file_stream_preserves_order(files):
    paths, maps = [files["a"], files["b"]], files["pair_maps"]
    whole, _ = jax_reader.read_game_dataset(
        paths, id_types=["userId"], feature_shard_maps=maps,
        ingest_workers=1)
    batches = list(block_stream.BlockGameStream(
        paths, ["userId"], maps, batch_rows=90, feeder="native"))
    assert sum(d.num_rows for d in batches) == 470
    for col in ("responses", "uids"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(d, col) for d in batches]),
            getattr(whole, col))


def test_random_access_fetch_matches_streamed_batches(files):
    stream = block_stream.BlockGameStream(
        files["one"], ["userId", "itemId"], files["maps"], batch_rows=37,
        feeder="native")
    ra = block_stream.BlockRandomAccess(
        files["one"], ["userId", "itemId"], files["maps"], feeder="native")
    assert ra.decode_path == "native" and ra.total_rows == N_ROWS
    row = 0
    for batch in stream:
        _assert_batches_identical(ra.fetch_rows(row, batch.num_rows), batch)
        row += batch.num_rows
    assert ra.rows_fetched == N_ROWS
    assert ra.payload_bytes_read > 0 and ra.blocks_decoded > 0


def test_random_access_python_feeder_matches_stream(files):
    stream = block_stream.BlockGameStream(
        files["one"], ["userId"], files["maps"], batch_rows=64,
        feeder="python")
    ra = block_stream.BlockRandomAccess(files["one"], ["userId"],
                                        files["maps"], feeder="python")
    assert ra.decode_path == "python"
    batches = list(stream)
    for k in (0, len(batches) // 2, len(batches) - 1):
        _assert_batches_identical(ra.fetch_rows(64 * k, batches[k].num_rows),
                                  batches[k])


def test_random_access_spans_file_boundary(files):
    paths, maps = [files["a"], files["b"]], files["pair_maps"]
    batches = list(block_stream.BlockGameStream(
        paths, ["userId"], maps, batch_rows=90, feeder="native"))
    ra = block_stream.BlockRandomAccess(paths, ["userId"], maps,
                                        feeder="native")
    assert ra.total_rows == 470
    _assert_batches_identical(ra.fetch_rows(270, 90), batches[3])


def test_random_access_validates_ranges_and_feeder(files):
    ra = block_stream.BlockRandomAccess(files["one"], [], files["maps"],
                                        feeder="python")
    with pytest.raises(ValueError, match="n_rows"):
        ra.fetch_rows(0, 0)
    with pytest.raises(ValueError, match="outside"):
        ra.fetch_rows(990, 20)
    with pytest.raises(ValueError, match="feeder"):
        block_stream.BlockRandomAccess(files["one"], [], files["maps"],
                                       feeder="turbo")


def test_single_partial_batch_when_batch_rows_exceeds_input(files):
    batches = list(block_stream.BlockGameStream(
        files["one"], ["userId"], files["maps"], batch_rows=10_000,
        feeder="native"))
    assert [d.num_rows for d in batches] == [N_ROWS]


def test_prefetch_peak_residency_bounded(files):
    """A slow consumer lets the producer run as far ahead as it can:
    resident batches stay within depth + 2."""
    for depth in (1, 3):
        stream = block_stream.BlockGameStream(
            files["one"], ["userId"], files["maps"], batch_rows=50,
            feeder="native", prefetch_depth=depth)
        got = 0
        for _ in stream:
            got += 1
            if got <= 3:
                time.sleep(0.05)
        assert got == 20
        assert 0 < stream.peak_resident_batches <= depth + 2
        stream.prefetcher.thread.join(timeout=10)
        assert not stream.prefetcher.thread.is_alive()


def test_corrupt_block_payload_names_file(tmp_path, files):
    p = tmp_path / "bad.avro"
    _write_stream_file(p, 800, np.random.default_rng(3))
    block = scan_container_blocks(p).blocks[1]
    raw = bytearray(p.read_bytes())

    def varint_len(off):
        k = 0
        while raw[off + k] & 0x80:
            k += 1
        return k + 1

    start = block.offset + varint_len(block.offset)
    start += varint_len(start)
    for i in range(8):
        raw[start + 4 + i] ^= 0xFF
    p.write_bytes(bytes(raw))
    stream = block_stream.BlockGameStream(p, [], files["maps"],
                                          batch_rows=64, feeder="native",
                                          prefetch_depth=2)
    with pytest.raises(ValueError, match="bad.avro"):
        list(stream)
    stream.prefetcher.thread.join(timeout=10)
    assert not stream.prefetcher.thread.is_alive()


def test_index_map_and_labeled_points_equal_jax(files):
    paths = [files["a"], files["b"]]
    mine, jax = (avro_reader.build_index_map(paths),
                 jax_reader.build_index_map(paths, ingest_workers=1))
    assert mine.key_to_index_dict() == jax.key_to_index_dict()
    got = avro_reader.read_labeled_points(paths, index_map=mine)
    want = jax_reader.read_labeled_points(paths, index_map=jax,
                                          ingest_workers=1)
    for a in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(got[0], a),
                                      getattr(want[0], a))
    for a, b in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4]
