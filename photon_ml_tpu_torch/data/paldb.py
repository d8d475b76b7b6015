"""Parser AND writer for PalDB 1.1 stores — reference index-map interop
(a copy of photon_ml_tpu/data/paldb.py: the reader :1-273, the writer
:274-445 and load_feature_index_maps :446; with ``timestamp=0`` the
writer's bytes equal the JAX package's, file for file).

The reference builds its feature-index stores with LinkedIn PalDB
(`com.linkedin.paldb:paldb:1.1.0`, photon-ml/build.gradle:52) through
FeatureIndexingJob (ml/FeatureIndexingJob.scala:145-174) and reads them with
PalDBIndexMap (ml/util/PalDBIndexMap.scala:43-220). Its GAME integ fixtures
ship pre-built stores (GameIntegTest/input/feature-indexes/,
test-with-uid-feature-indexes/) — the artifact a migrating user actually
has. This module parses the PALDB_V1 container directly (no JVM), so those
stores load as ordinary IndexMaps.

Store semantics (PalDBIndexMapBuilder.scala:45-49): every partition holds
BOTH directions in one store — (name: str) -> (index: int) and
(index: int) -> (name: str); feature names are `name + "\\u0001" + term`
(GLMSuite key convention). Partitioning follows Spark's HashPartitioner
over Java String.hashCode (PalDBIndexMap.scala:138-140), and partition i's
internal indices are offset by the cumulative size of partitions < i
(PalDBIndexMap.load, :71-100).

PALDB_V1 container layout (reverse-engineered from the fixtures and the
public PalDB 1.1 format):

    writeUTF("PALDB_V1") | timestamp i64 | keyCount i32 |
    keyLengthCount i32 | maxKeyLength i32 |
    per key-length class: {serializedKeyLen i32, keyCount i32, slots i32,
        slotSize i32, indexOffset i32, dataOffset i64} |
    serializerCount i32 (0) | indexStart i32 | dataStart i64 |
    index slots (open-addressed hash, slot = serialized key +
        MSB-first 7-bit varint data offset, 0 = empty) |
    data entries (varint byte length + serialized value)

Value/key serialization (observed subset of PalDB's StorageSerialization;
varints are LSB-first 7-bit groups with the high bit as continuation,
protobuf-style):
    0x05+k          -> int k, k in 0..8
    0x0e + u8       -> int 9..255
    0x10 + varint   -> int >= 256 (packed)
    0x67 ('g') + varint charCount + per-char varint -> str
Unknown type bytes raise with the offending byte, so stores written with
serializations outside this subset fail loudly instead of mis-decoding.
"""

from __future__ import annotations

import re
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

from photon_ml_tpu_torch.data.index_map import IndexMap

_MAGIC = "PALDB_V1"
_STORE_RE = re.compile(r"paldb-partition-(?P<ns>.+)-(?P<part>\d+)\.dat$")


def _unpack_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """LSB-first 7-bit varint (PalDB LongPacker, protobuf byte order):
    high bit = continuation."""
    ret = 0
    shift = 0
    while True:
        v = buf[pos]
        pos += 1
        ret |= (v & 0x7F) << shift
        shift += 7
        if not (v & 0x80):
            return ret, pos


def _decode_value(buf: bytes, pos: int, end: int) -> Union[int, str]:
    """Decode one serialized PalDB object in buf[pos:end], enforcing that
    the decode consumes EXACTLY the declared bytes — a truncated or
    corrupt entry fails loudly instead of mis-decoding into its
    neighbor's bytes."""
    start = pos
    t = buf[pos]
    pos += 1
    if 0x05 <= t <= 0x0D:  # small ints 0..8, immediate
        value: Union[int, str] = t - 0x05
    elif t == 0x0E:  # unsigned byte
        value = buf[pos]
        pos += 1
    elif t == 0x10:  # packed varint
        value, pos = _unpack_varint(buf, pos)
    elif t == 0x67:  # string: char count + per-char varints
        n, pos = _unpack_varint(buf, pos)
        chars = []
        for _ in range(n):
            c, pos = _unpack_varint(buf, pos)
            chars.append(chr(c))
        value = "".join(chars)
    else:
        raise ValueError(
            f"unsupported PalDB serialization type byte 0x{t:02x} at "
            f"{pos - 1} (only the int/str encodings produced by "
            "PalDBIndexMapBuilder are supported)")
    if pos != end:
        raise ValueError(
            f"corrupt PalDB entry at {start}: decoded {pos - start} bytes, "
            f"declared {end - start}")
    return value


def read_paldb_store(path) -> Iterator[Tuple[Union[int, str],
                                             Union[int, str]]]:
    """Yield (key, value) pairs from one PALDB_V1 store file."""
    raw = Path(path).read_bytes()
    n_magic = struct.unpack_from(">H", raw, 0)[0]
    magic = raw[2:2 + n_magic].decode()
    if magic != _MAGIC:
        raise ValueError(f"{path}: not a {_MAGIC} store (got {magic!r})")
    o = 2 + n_magic + 8  # skip timestamp
    key_count, key_len_count, _max_key_len = struct.unpack_from(">iii", raw, o)
    o += 12
    sections = []
    for _ in range(key_len_count):
        klen, kcnt, slots, ssize, ioff = struct.unpack_from(">iiiii", raw, o)
        o += 20
        doff = struct.unpack_from(">q", raw, o)[0]
        o += 8
        sections.append((klen, kcnt, slots, ssize, ioff, doff))
    n_serializers = struct.unpack_from(">i", raw, o)[0]
    o += 4
    if n_serializers:
        raise ValueError(
            f"{path}: custom PalDB serializers are not supported")
    index_start = struct.unpack_from(">i", raw, o)[0]
    o += 4
    data_start = struct.unpack_from(">q", raw, o)[0]

    seen = 0
    for klen, kcnt, slots, ssize, ioff, doff in sections:
        base = index_start + ioff
        for s in range(slots):
            slot = raw[base + s * ssize: base + (s + 1) * ssize]
            off, _ = _unpack_varint(slot, klen)
            if off == 0:  # empty slot
                continue
            key = _decode_value(slot, 0, klen)
            vpos = data_start + doff + off
            vlen, vpos = _unpack_varint(raw, vpos)
            value = _decode_value(raw, vpos, vpos + vlen)
            seen += 1
            yield key, value
    if seen != key_count:
        raise ValueError(
            f"{path}: decoded {seen} entries, header declares {key_count}")


def _java_string_hash(s: str) -> int:
    """Java String.hashCode (32-bit overflow semantics)."""
    h = 0
    for c in s:
        h = (31 * h + ord(c)) & 0xFFFFFFFF
    return h - 0x100000000 if h >= 0x80000000 else h


def java_hash_partition(key: str, num_partitions: int) -> int:
    """Spark HashPartitioner.getPartition: nonNegativeMod(hashCode, p)."""
    m = _java_string_hash(key) % num_partitions
    return m + num_partitions if m < 0 else m


def discover_namespaces(directory) -> Dict[str, int]:
    """namespace -> partition count, from paldb-partition-<ns>-<i>.dat
    filenames in `directory`."""
    found: Dict[str, List[int]] = {}
    for p in Path(directory).iterdir():
        m = _STORE_RE.match(p.name)
        if m:
            found.setdefault(m.group("ns"), []).append(int(m.group("part")))
    out = {}
    for ns, parts in found.items():
        expected = list(range(len(parts)))
        if sorted(parts) != expected:
            raise ValueError(
                f"{directory}: namespace {ns!r} has partitions "
                f"{sorted(parts)}, expected contiguous 0..{len(parts) - 1}")
        out[ns] = len(parts)
    if not out:
        raise FileNotFoundError(
            f"no paldb-partition-*.dat stores under {directory}")
    return out


def load_paldb_index_map(directory, namespace: str,
                         num_partitions: Optional[int] = None) -> IndexMap:
    """Load one namespace's partitioned PalDB stores as an IndexMap.

    Exactly mirrors PalDBIndexMap.load (ml/util/PalDBIndexMap.scala:71-100):
    partition i's indices are offset by the cumulative feature count of
    partitions < i, and lookups hash with Spark's HashPartitioner — the
    offsets are validated here by re-partitioning every key.
    """
    directory = Path(directory)
    if num_partitions is None:
        num_partitions = discover_namespaces(directory)[namespace]

    key_to_index: Dict[str, int] = {}
    offset = 0
    for i in range(num_partitions):
        path = directory / f"paldb-partition-{namespace}-{i}.dat"
        part_pairs = [(k, v) for k, v in read_paldb_store(path)
                      if isinstance(k, str)]
        for name, idx in part_pairs:
            if not isinstance(idx, int):
                raise ValueError(
                    f"{path}: string key {name!r} maps to non-int {idx!r}")
            expected = java_hash_partition(name, num_partitions)
            if expected != i:
                raise ValueError(
                    f"{path}: key {name!r} hashes to partition {expected}, "
                    f"found in partition {i} — wrong num_partitions?")
            key_to_index[name] = idx + offset
        offset += len(part_pairs)

    n = len(key_to_index)
    if sorted(key_to_index.values()) != list(range(n)):
        raise ValueError(
            f"{directory}/{namespace}: indices are not a permutation of "
            f"0..{n - 1} — corrupt store or partition mismatch")
    return IndexMap(key_to_index)


def load_paldb_index_maps(directory) -> Dict[str, IndexMap]:
    """Load EVERY namespace under `directory` (shard id -> IndexMap)."""
    return {ns: load_paldb_index_map(directory, ns, parts)
            for ns, parts in discover_namespaces(directory).items()}


def discover_store_namespaces(directory) -> Dict[str, int]:
    """namespace -> partition count for EITHER store format: the
    reference's partitioned PalDB stores (count >= 1) or this package's
    <ns>.json stores (count 0 marks the JSON format). The single place
    that knows the on-disk naming conventions."""
    directory = Path(directory)
    if any(_STORE_RE.match(p.name) for p in directory.iterdir()):
        return discover_namespaces(directory)
    out = {p.stem: 0 for p in sorted(directory.glob("*.json"))}
    if not out:
        raise FileNotFoundError(
            f"no paldb-partition-*.dat or *.json index stores in {directory}")
    return out


def load_store_namespace(directory, namespace: str,
                         num_partitions: int) -> IndexMap:
    """Load ONE namespace in either format (num_partitions from
    :func:`discover_store_namespaces`; 0 = JSON)."""
    if num_partitions:
        return load_paldb_index_map(directory, namespace, num_partitions)
    return IndexMap.load(Path(directory) / f"{namespace}.json")


# ---------------------------------------------------------------------------
# Writer — the other half of PalDBIndexMapBuilder interop
# (ml/FeatureIndexingJob.scala:145-174 produces these stores; a migrated
# pipeline that feeds index stores to other Photon-adjacent tooling needs
# us to produce them too). Layout constants verified against the
# reference's checked-in fixtures (PalDBIndexMapTest/, GameIntegTest/
# feature-indexes/): slots = Math.round(count / 0.75), slot = serialized
# key + LSB-first varint data offset zero-padded to slotSize, sections
# ascending by serialized key length, each section's data prefixed with
# one 0x00 byte (offset 0 = empty slot sentinel), and slot placement by
# murmur3-32(seed 42, masked positive) with linear probing — the hash was
# determined empirically from the fixtures (11/14 keys sit at their exact
# hash slot, the rest at linear-probe distance 1).
# ---------------------------------------------------------------------------

_LOAD_FACTOR = 0.75
_MURMUR_SEED = 42


def _pack_varint(v: int) -> bytes:
    """LSB-first 7-bit varint (inverse of _unpack_varint)."""
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _encode_value(v: Union[int, str]) -> bytes:
    """Serialize one int/str in the PalDB StorageSerialization subset
    (inverse of _decode_value)."""
    if isinstance(v, bool) or not isinstance(v, (int, str)):
        raise TypeError(f"PalDB writer supports int/str, got {type(v)}")
    if isinstance(v, int):
        if v < 0:
            raise ValueError(f"negative ints are not supported: {v}")
        if v <= 8:
            return bytes([0x05 + v])
        if v <= 255:
            return bytes([0x0E, v])
        return bytes([0x10]) + _pack_varint(v)
    out = bytearray([0x67])
    out += _pack_varint(len(v))
    for c in v:
        out += _pack_varint(ord(c))
    return bytes(out)


def _murmur3_32(data: bytes, seed: int = _MURMUR_SEED) -> int:
    """MurmurHash3 x86 32-bit — PalDB's HashUtils slot hash."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    n = len(data)
    for i in range(n // 4):
        k = struct.unpack_from("<I", data, i * 4)[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = data[(n // 4) * 4:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if tail:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h & 0x7FFFFFFF


def write_paldb_store(path, pairs, timestamp: int = 0) -> None:
    """Write one PALDB_V1 store file from (key, value) pairs (int/str
    each). Round-trips through read_paldb_store and follows the layout of
    stores the reference's PalDBIndexMapBuilder produces."""
    by_len: Dict[int, List[Tuple[bytes, bytes]]] = {}
    seen_keys = set()
    n_pairs = 0
    for k, v in pairs:
        kb = _encode_value(k)
        if kb in seen_keys:
            raise ValueError(f"duplicate PalDB key {k!r}")
        seen_keys.add(kb)
        by_len.setdefault(len(kb), []).append((kb, _encode_value(v)))
        n_pairs += 1
    # n_pairs == 0 is legal: a hash partition can be empty (Spark's
    # HashPartitioner tolerates it, and the store must still exist for
    # PalDBIndexMap.load's 0..N-1 filename scan).

    sections = []  # (klen, cnt, slots, ssize, index_blob, data_blob)
    for klen in sorted(by_len):
        entries = by_len[klen]
        data = bytearray(b"\x00")  # offset 0 marks an empty index slot
        offsets = []
        for _, vb in entries:
            offsets.append(len(data))
            data += _pack_varint(len(vb)) + vb
        cnt = len(entries)
        slots = max(1, int(cnt / _LOAD_FACTOR + 0.5))  # Math.round
        ssize = klen + len(_pack_varint(max(offsets)))
        index = bytearray(slots * ssize)
        for (kb, _), off in zip(entries, offsets):
            s = _murmur3_32(kb) % slots
            for _probe in range(slots):
                base = s * ssize
                if _unpack_varint(index, base + klen)[0] == 0:
                    rec = kb + _pack_varint(off)
                    index[base:base + len(rec)] = rec
                    break
                s = (s + 1) % slots
            else:
                raise AssertionError("open-addressed index overflow")
        sections.append((klen, cnt, slots, ssize, bytes(index),
                         bytes(data)))

    magic = _MAGIC.encode()
    header = bytearray()
    header += struct.pack(">H", len(magic)) + magic
    header += struct.pack(">q", timestamp)
    header += struct.pack(">iii", n_pairs, len(sections),
                          max(by_len) if by_len else 0)
    ioff = 0
    doff = 0
    for klen, cnt, slots, ssize, index, data in sections:
        header += struct.pack(">iiiii", klen, cnt, slots, ssize, ioff)
        header += struct.pack(">q", doff)
        ioff += len(index)
        doff += len(data)
    header += struct.pack(">i", 0)  # serializer count
    index_start = len(header) + 4 + 8
    header += struct.pack(">i", index_start)
    header += struct.pack(">q", index_start + ioff)  # data start

    with open(path, "wb") as f:
        f.write(bytes(header))
        for *_, index, _data in sections:
            f.write(index)
        for *_, data in sections:
            f.write(data)


def build_paldb_index_stores(directory, namespace: str,
                             names, num_partitions: int = 1) -> IndexMap:
    """Write a partitioned PalDB feature-index store the way
    FeatureIndexingJob does (ml/FeatureIndexingJob.scala:145-174 via
    PalDBIndexMapBuilder.put, which stores BOTH directions): names are
    partitioned with Spark's HashPartitioner, each partition assigns
    per-partition local indices (sorted order — deterministic), and the
    global index of partition i's features is local + the cumulative
    count of partitions < i, exactly the contract PalDBIndexMap.load
    (and load_paldb_index_map here) reconstructs. Returns the resulting
    global IndexMap."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    names = list(names)
    if len(set(names)) != len(names):
        raise ValueError("duplicate feature names")
    parts: List[List[str]] = [[] for _ in range(num_partitions)]
    for name in names:
        parts[java_hash_partition(name, num_partitions)].append(name)

    key_to_index: Dict[str, int] = {}
    offset = 0
    for i, members in enumerate(parts):
        members = sorted(members)
        pairs: List[Tuple[Union[int, str], Union[int, str]]] = []
        for local, name in enumerate(members):
            pairs.append((name, local))
            pairs.append((local, name))
            key_to_index[name] = local + offset
        write_paldb_store(
            directory / f"paldb-partition-{namespace}-{i}.dat", pairs)
        offset += len(members)
    return IndexMap(key_to_index)


def load_feature_index_maps(directory) -> Dict[str, IndexMap]:
    """shard id -> IndexMap from a feature-index directory of EITHER
    format: the reference's partitioned PalDB stores
    (paldb-partition-<shard>-<i>.dat) or this package's JSON stores
    (<shard>.json, written by the training driver / feature-indexing CLI)."""
    return {ns: load_store_namespace(directory, ns, parts)
            for ns, parts in discover_store_namespaces(directory).items()}
