"""Parity: the port's feature-indexing job (cli/feature_indexing.py), its
PalDB writer (data/paldb.py) and its name-and-term sets
(data/name_and_term.py) against the JAX package's.

- Both jobs on the same small seeded Avro, in both formats, with 1, 2
  (run_game_full.sh's) and 3 PalDB partitions: every file they write is
  byte for byte the same (the PalDB stores, the JSON map and the
  name-and-term text sets; the log file aside).
- The writer's cases of JAX's tests/test_paldb.py:242-334: round trip,
  multibyte offsets, duplicates refused, an empty store and an empty hash
  partition, the layout's header fields and the slot hash. The
  reference's fixture stores are not in this repository, so the layout
  and the slot placement are held against the JAX writer's bytes and the
  murmur3 hash's published test vectors instead.
- The port's training driver (device="cpu") on the PalDB stores and on a
  JSON store of the same map writes the same model records.
"""

import struct
from pathlib import Path

import numpy as np
import pytest

from photon_ml_tpu.cli import feature_indexing as jax_indexing
from photon_ml_tpu.data import name_and_term as jax_nat
from photon_ml_tpu.data import paldb as jax_paldb
from photon_ml_tpu_torch.cli import feature_indexing, game_training_driver
from photon_ml_tpu_torch.data import paldb
from photon_ml_tpu_torch.data.avro_reader import build_index_map
from photon_ml_tpu_torch.data.index_map import INTERCEPT_KEY, feature_key
from photon_ml_tpu_torch.data.name_and_term import (
    NameAndTermFeatureSetContainer,
)
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro_codec import read_container, write_container
from photon_ml_tpu_torch.utils.logging_utils import LOG_FILE_NAME
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

# Names with terms (None, empty, ASCII, non-ASCII) and non-ASCII names:
# a Java hash over UTF-16 units and multi-byte characters in the stores.
NAMES = [f"f{j}" for j in range(40)] + ["größe", "名前", "xé"]
TERMS = [None, "", "t", "é", "中文"]


def _records(rng, n):
    for i in range(n):
        cols = rng.choice(len(NAMES), size=5, replace=False)
        yield {"uid": f"r{i}", "label": float(rng.random() < 0.5),
               "features": [{"name": NAMES[c], "term": TERMS[c % 5],
                             "value": float(rng.normal())} for c in cols],
               "weight": None, "offset": None,
               "metadataMap": {"userId": f"user{i % 7}"}}


@pytest.fixture(scope="module")
def avro(tmp_path_factory):
    root = tmp_path_factory.mktemp("indexing")
    rng = np.random.default_rng(23)
    for tag, n in (("train", 240), ("validate", 80)):
        (root / tag).mkdir()
        for k in range(2):
            write_container(root / tag / f"part-{k:05d}.avro",
                            schemas.TRAINING_EXAMPLE, _records(rng, n // 2))
    return root


def _files(directory: Path) -> dict:
    """Every file a job wrote but its log, by relative path."""
    return {p.relative_to(directory).as_posix(): p.read_bytes()
            for p in sorted(directory.rglob("*"))
            if p.is_file() and p.name != LOG_FILE_NAME}


@pytest.mark.parametrize("fmt,parts", [("json", 1), ("paldb", 1),
                                       ("paldb", 2), ("paldb", 3)])
def test_job_writes_the_jax_jobs_bytes(avro, tmp_path, fmt, parts):
    argv = ["--data-path", str(avro / "train"), "--format", fmt,
            "--partition-num", str(parts), "--shard-name", "global",
            "--save-name-and-term-sets", "true"]
    out = feature_indexing.run([*argv, "--output-dir", str(tmp_path / "p")])
    ref = jax_indexing.run([*argv, "--output-dir", str(tmp_path / "j")])
    assert out.name == ref.name
    ours, theirs = _files(tmp_path / "p"), _files(tmp_path / "j")
    want = ({"global.json"} if fmt == "json" else
            {f"paldb-partition-global-{i}.dat" for i in range(parts)})
    assert want | {"name-and-term-sets/features.txt"} == set(ours)
    assert set(ours) == set(theirs)
    for name in ours:
        assert ours[name] == theirs[name], name
    maps = paldb.load_feature_index_maps(tmp_path / "p")
    imap = maps["global"]
    assert sorted(i for _, i in imap.key_items()) == list(range(len(imap)))
    assert INTERCEPT_KEY in dict(imap.key_items())
    if fmt == "json":
        scanned = build_index_map(avro / "train")
        assert dict(imap.key_items()) == dict(scanned.key_items())
    else:
        # Both directions in every partition.
        for i in range(parts):
            pairs = list(paldb.read_paldb_store(
                tmp_path / "p" / f"paldb-partition-global-{i}.dat"))
            fwd = {k: v for k, v in pairs if isinstance(k, str)}
            back = {k: v for k, v in pairs if isinstance(k, int)}
            assert {v: k for k, v in fwd.items()} == back
    sets = NameAndTermFeatureSetContainer.load_from_text_files(
        tmp_path / "p" / "name-and-term-sets", ["features"])
    assert {feature_key(n, t) for n, t in sets.feature_sets["features"]} \
        == set(dict(imap.key_items())) - {INTERCEPT_KEY}


def test_name_and_term_sets_match_jax(avro, tmp_path):
    ours = NameAndTermFeatureSetContainer.from_avro(avro / "train")
    theirs = jax_nat.NameAndTermFeatureSetContainer.from_avro(avro / "train")
    assert ours.feature_sets == theirs.feature_sets
    for add in (False, True):
        a = ours.get_feature_name_and_term_to_index_map(["features"], add)
        b = theirs.get_feature_name_and_term_to_index_map(["features"], add)
        assert list(a.key_items()) == list(b.key_items())
    ours.save_as_text_files(tmp_path / "p")
    theirs.save_as_text_files(tmp_path / "j")
    assert ((tmp_path / "p" / "features.txt").read_bytes()
            == (tmp_path / "j" / "features.txt").read_bytes())
    back = NameAndTermFeatureSetContainer.load_from_text_files(
        tmp_path / "p", ["features"])
    assert back.feature_sets == ours.feature_sets


def _write_both(tmp_path, pairs, name="s.dat"):
    ours, theirs = tmp_path / ("p-" + name), tmp_path / ("j-" + name)
    paldb.write_paldb_store(ours, pairs)
    jax_paldb.write_paldb_store(theirs, pairs)
    assert ours.read_bytes() == theirs.read_bytes()
    return ours


def test_write_store_round_trips(tmp_path):
    pairs = [("a\x01t", 0), (0, "a\x01t"), ("b\x01", 1), (1, "b\x01"),
             ("long-feature-name\x01with-term", 300),
             (300, "long-feature-name\x01with-term"),
             ("i9", 9), (9, "i9"), ("i255", 255), (255, "i255"),
             ("unicode-é中", 70000), (70000, "unicode-é中")]
    path = _write_both(tmp_path, pairs)
    assert dict(paldb.read_paldb_store(path)) == dict(pairs)


def test_write_store_multibyte_offsets(tmp_path):
    """Enough entries in one key-length class that data offsets need
    multi-byte varints (the slot size grows accordingly)."""
    pairs = [(f"f{i:04d}\x01term-{i:04d}", i) for i in range(2000)]
    path = _write_both(tmp_path, pairs)
    got = dict(paldb.read_paldb_store(path))
    assert len(got) == 2000
    assert got["f1999\x01term-1999"] == 1999
    (_, _, _, ssize), = _sections(path)
    assert ssize > len(paldb._encode_value(pairs[0][0])) + 1


def test_write_store_rejects_duplicates_allows_empty(tmp_path):
    with pytest.raises(ValueError, match="duplicate"):
        paldb.write_paldb_store(tmp_path / "d.dat", [("a", 1), ("a", 2)])
    with pytest.raises(ValueError, match="duplicate"):
        paldb.build_paldb_index_stores(tmp_path, "dup", ["a", "a"])
    path = _write_both(tmp_path, [], "e.dat")
    assert list(paldb.read_paldb_store(path)) == []


def test_empty_hash_partition_is_written_and_loads(tmp_path):
    names = [feature_key("n1", "t"), feature_key("n2")]
    parts = 7
    hit = {paldb.java_hash_partition(n, parts) for n in names}
    assert len(hit) < parts  # some partitions hold no name
    imap = paldb.build_paldb_index_stores(tmp_path / "p", "ns", names, parts)
    jax_paldb.build_paldb_index_stores(tmp_path / "j", "ns", names, parts)
    for i in range(parts):
        f = f"paldb-partition-ns-{i}.dat"
        assert ((tmp_path / "p" / f).read_bytes()
                == (tmp_path / "j" / f).read_bytes())
    loaded = paldb.load_paldb_index_map(tmp_path / "p", "ns")
    assert dict(loaded.key_items()) == dict(imap.key_items())


@pytest.mark.parametrize("num_partitions", [1, 3])
def test_build_index_stores_round_trip(tmp_path, num_partitions):
    names = [feature_key(f"name{i}", f"t{i % 4}") for i in range(50)]
    names.append(INTERCEPT_KEY)
    written = paldb.build_paldb_index_stores(tmp_path, "myShard", names,
                                             num_partitions=num_partitions)
    theirs = jax_paldb.build_paldb_index_stores(
        tmp_path / "j", "myShard", names, num_partitions=num_partitions)
    assert list(written.key_items()) == list(theirs.key_items())
    loaded = paldb.load_paldb_index_map(tmp_path, "myShard", num_partitions)
    assert dict(written.key_items()) == dict(loaded.key_items())
    assert sorted(i for _, i in loaded.key_items()) == list(range(len(names)))


def _sections(path):
    raw = Path(path).read_bytes()
    n_magic = struct.unpack_from(">H", raw, 0)[0]
    o = 2 + n_magic + 8
    _, klc, _ = struct.unpack_from(">iii", raw, o)
    o += 12
    secs = []
    for _ in range(klc):
        klen, kcnt, slots, ssize, _ = struct.unpack_from(">iiiii", raw, o)
        o += 28
        secs.append((klen, kcnt, slots, ssize))
    return secs


def test_written_store_layout(tmp_path):
    """The header fields the PalDB 1.1 reader navigates by: sections by
    ascending serialized key length, Math.round(count / 0.75) slots, a
    slot the key plus its offset's varint, the header's key count and
    longest key."""
    names = [feature_key(f"name{i}", "t" * (i % 3)) for i in range(30)]
    pairs = [p for i, n in enumerate(names) for p in ((n, i), (i, n))]
    path = _write_both(tmp_path, pairs)
    raw = path.read_bytes()
    key_count, _, max_klen = struct.unpack_from(">iii", raw, 2 + 8 + 8)
    assert key_count == len(pairs)
    lengths = {}
    for k, _ in pairs:
        kb = paldb._encode_value(k)
        lengths[len(kb)] = lengths.get(len(kb), 0) + 1
    secs = _sections(path)
    assert [s[0] for s in secs] == sorted(lengths)
    assert max_klen == max(lengths)
    for klen, kcnt, slots, ssize in secs:
        assert kcnt == lengths[klen]
        assert slots == max(1, int(kcnt / 0.75 + 0.5))
        assert klen < ssize <= klen + 2


def test_slot_hash_and_placement(tmp_path):
    """murmur3 x86 32 (seed 42, masked positive) as JAX's, on the
    published vectors and every tail length, and every key of a written
    store sits at its hash slot or within linear-probe distance."""
    vectors = [(b"", 0, 0), (b"", 1, 0x514E28B7),
               (b"\0\0\0\0", 0, 0x2362F9DE),
               (b"Hello, world!", 0x9747B28C, 0x24884CBA),
               (b"The quick brown fox jumps over the lazy dog", 0x9747B28C,
                0x2FA826CD)]
    for data, seed, want in vectors:
        assert paldb._murmur3_32(data, seed) == want & 0x7FFFFFFF
    rng = np.random.default_rng(5)
    for n in range(0, 13):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert paldb._murmur3_32(data) == jax_paldb._murmur3_32(data)
    s = "名前xé"
    units = struct.unpack(f">{len(s)}H", s.encode("utf-16-be"))
    h = 0
    for u in units:
        h = (31 * h + u) & 0xFFFFFFFF
    assert paldb._java_string_hash(s) == (h - (1 << 32) if h >> 31 else h)

    pairs = [(f"k{i}\x01t", i) for i in range(40)]
    path = _write_both(tmp_path, pairs)
    raw = path.read_bytes()
    o = 2 + 8 + 8 + 12 + 28 * len(_sections(path)) + 4
    index_start = struct.unpack_from(">i", raw, o)[0]
    exact = 0
    ioff = 0
    for klen, kcnt, slots, ssize in _sections(path):
        base = index_start + ioff
        for s in range(slots):
            slot = raw[base + s * ssize: base + (s + 1) * ssize]
            if paldb._unpack_varint(slot, klen)[0] == 0:
                continue
            h = paldb._murmur3_32(bytes(slot[:klen])) % slots
            dist = (s - h) % slots
            exact += dist == 0
            assert dist <= kcnt
        ioff += slots * ssize
    assert exact / len(pairs) > 0.5


FIXED = ["--fixed-effect-data-configurations", "fixed:global",
         "--fixed-effect-optimization-configurations",
         "fixed:15,1e-5,1.0,1.0,TRON,L2"]
PER_USER = ["--random-effect-data-configurations",
            "perUser:userId,global,4,-1,-1,-1",
            "--random-effect-optimization-configurations",
            "perUser:30,1e-6,0.5,1.0,LBFGS,ELASTIC_NET,0.5"]


def _model_records(out: Path) -> dict:
    return {str(p.relative_to(out)): list(read_container(p))
            for p in sorted((out / "best").rglob("*.avro"))}


def test_training_on_paldb_stores_equals_the_same_map_as_json(avro,
                                                              tmp_path):
    """run_game_full.sh's indexing step, then its fixed and per-user
    flags through the port's training driver, on the PalDB stores and on
    a JSON store holding the map they load as."""
    stores = tmp_path / "paldb"
    feature_indexing.run(["--data-path", str(avro / "train"),
                          "--output-dir", str(stores), "--format", "paldb",
                          "--partition-num", "2", "--shard-name", "global"])
    as_json = tmp_path / "json"
    as_json.mkdir()
    paldb.load_feature_index_maps(stores)["global"].save(
        as_json / "global.json")
    records = {}
    for tag, index_dir in (("paldb", stores), ("json", as_json)):
        out = tmp_path / f"model-{tag}"
        game_training_driver.run([
            "--train-input-dirs", str(avro / "train"),
            "--validate-input-dirs", str(avro / "validate"),
            "--feature-index-dir", str(index_dir),
            "--output-dir", str(out),
            "--task-type", "LOGISTIC_REGRESSION", *FIXED, *PER_USER,
            "--updating-sequence", "fixed,perUser",
            "--num-iterations", "1", "--evaluators", "AUC"], device="cpu")
        records[tag] = _model_records(out)
    assert records["paldb"] == records["json"]
    assert any("fixed-effect" in k for k in records["paldb"])
    assert any("random-effect" in k for k in records["paldb"])
