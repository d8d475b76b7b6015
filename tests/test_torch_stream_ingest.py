"""Parallel ingest of the port (the cases of tests/test_parallel_ingest.py):
``python -m photon_ml_tpu_torch.data.parallel_ingest`` workers decode
block-range shards with the port's C decoder and the parent assembles
them in shard order. Held on the CPU against the port's one-process read
and against the JAX package's ``parallel_fast_ingest``, on the same
seeded Avro file:

- the pool's arrays (2 and 3 workers) are byte-identical to one process
  and to the JAX package's pool, for ``read_game_dataset``,
  ``read_labeled_points`` and two files in order;
- ``plan_shards`` gives the JAX package's shards;
- a truncated file raises naming the file, a corrupt payload raises
  ``IngestShardError`` naming the shard, and a worker that cannot start
  raises ``IngestShardError`` (pipe EOF and exit status), never a hang;
- a worker imports neither torch nor jax (its ``sys.modules`` after a
  decode);
- ``column_consumer`` feeds data/device_feed's ``OverlappedUploader`` the
  labels in row order;
- the GAME training driver and the GLM driver train the same model bits
  with ``--ingest-workers 2`` as with ``1``.

Every test that starts workers runs them under ``bounded_workers``: each
worker the pool starts is killed after 120 s at the latest, and on the
way out.
"""

import contextlib
import pickle
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from photon_ml_tpu.data import avro_reader as jax_reader
from photon_ml_tpu.data import parallel_ingest as jax_pi
from photon_ml_tpu.data import shard_planner as jax_planner
from photon_ml_tpu_torch.cli import game_training_driver, glm_driver
from photon_ml_tpu_torch.data import parallel_ingest as pi
from photon_ml_tpu_torch.data.avro_reader import (
    build_index_map,
    read_game_dataset,
    read_labeled_points,
)
from photon_ml_tpu_torch.data.device_feed import OverlappedUploader
from photon_ml_tpu_torch.data.shard_planner import (
    plan_shards,
    scan_container_blocks,
)
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro_codec import read_container, write_container
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def bounded_workers(timeout=120.0):
    """Every process started inside is killed after ``timeout`` seconds
    at the latest (the pool then sees pipe EOF and raises), and on exit."""
    procs = []
    real = subprocess.Popen

    def popen(*args, **kwargs):
        proc = real(*args, **kwargs)
        procs.append(proc)
        return proc

    def kill_all():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()

    subprocess.Popen = popen
    timer = threading.Timer(timeout, kill_all)
    timer.daemon = True
    timer.start()
    try:
        yield procs
    finally:
        timer.cancel()
        subprocess.Popen = real
        kill_all()
        for proc in procs:
            proc.wait(timeout=10)


def _write_training_file(path, n, rng, n_features=60, per_row=6):
    """A many-block TrainingExampleAvro file with every optional field
    (null uids, weights, offsets) exercised."""
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
            "metadataMap": {"userId": f"user{i % 13}",
                            "itemId": f"item{i % 31}"},
        })
    write_container(path, schemas.TRAINING_EXAMPLE, recs,
                    sync_interval=2048)


def _columns(ds):
    """Every array of a GameDataset (either package's), as bytes."""
    out = [np.asarray(ds.responses).tobytes(), np.asarray(ds.offsets).tobytes(),
           np.asarray(ds.weights).tobytes(), list(ds.uids)]
    for name in sorted(ds.feature_shards):
        m = ds.feature_shards[name]
        out += [name, m.shape, m.data.tobytes(),
                m.indices.astype(np.int64).tobytes(),
                m.indptr.astype(np.int64).tobytes()]
    for t in sorted(ds.id_columns):
        c = ds.id_columns[t]
        out += [t, np.asarray(c.codes).tobytes(), list(c.vocabulary)]
    return out


@pytest.fixture(scope="module")
def ingest(tmp_path_factory):
    rng = np.random.default_rng(41)
    root = tmp_path_factory.mktemp("ingest")
    path = root / "train.avro"
    _write_training_file(path, 3000, rng)
    ids = ["userId", "itemId"]
    out = {"path": path, "root": root}
    out["one"], maps = read_game_dataset(path, id_types=ids,
                                         ingest_workers=1)
    out["maps"] = maps
    with bounded_workers():
        out["two"], _ = read_game_dataset(path, id_types=ids,
                                          feature_shard_maps=maps,
                                          ingest_workers=2)
        out["jax"], _ = jax_reader.read_game_dataset(path, id_types=ids,
                                                     ingest_workers=2)
    return out


def test_pool_is_byte_identical_to_one_process_and_to_jax(ingest):
    assert _columns(ingest["two"]) == _columns(ingest["one"])
    assert _columns(ingest["jax"]) == _columns(ingest["one"])


def test_labeled_points_and_file_order_invariant(ingest, tmp_path):
    path = ingest["path"]
    imap = ingest["maps"]["global"]
    one = read_labeled_points(path, index_map=imap, ingest_workers=1)
    second = tmp_path / "b.avro"
    _write_training_file(second, 800, np.random.default_rng(2))
    files_one, maps = read_game_dataset([path, second], id_types=["userId"],
                                        ingest_workers=1)
    with bounded_workers():
        two = read_labeled_points(path, index_map=imap, ingest_workers=2)
        files_three, _ = read_game_dataset(
            [path, second], id_types=["userId"], feature_shard_maps=maps,
            ingest_workers=3)
    for a, b in zip(one[:4], two[:4]):
        if hasattr(a, "indptr"):
            assert (a.data.tobytes(), a.indices.tobytes(),
                    a.indptr.tobytes()) == (b.data.tobytes(),
                                            b.indices.tobytes(),
                                            b.indptr.tobytes())
        else:
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert one[4] == two[4]
    assert _columns(files_three) == _columns(files_one)


def test_plan_shards_gives_jax_shards(ingest):
    mine = scan_container_blocks(ingest["path"])
    want = jax_planner.scan_container_blocks(ingest["path"])
    assert mine.num_rows == want.num_rows == 3000
    assert mine.num_bytes == want.num_bytes
    for n in (1, 3, 7, 100):
        got = plan_shards([mine], n)
        assert [vars(s) for s in got] == [
            vars(s) for s in jax_planner.plan_shards([want], n)]
        assert sum(s.num_rows for s in got) == 3000
        assert sum(s.num_blocks for s in got) == len(mine.blocks)


def test_truncated_file_names_the_file(tmp_path):
    p = tmp_path / "trunc.avro"
    _write_training_file(p, 2000, np.random.default_rng(3))
    raw = p.read_bytes()
    p.write_bytes(raw[:len(raw) // 2])
    with bounded_workers(), pytest.raises(ValueError, match="trunc.avro"):
        read_game_dataset(p, id_types=["userId"], ingest_workers=2)


def test_corrupt_payload_names_the_shard(tmp_path):
    p = tmp_path / "bad.avro"
    _write_training_file(p, 3000, np.random.default_rng(4))
    index = scan_container_blocks(p)
    imap = build_index_map(p, ingest_workers=1)
    raw = bytearray(p.read_bytes())
    block = index.blocks[len(index.blocks) // 2]

    def varint_len(off):
        k = 0
        while raw[off + k] & 0x80:
            k += 1
        return k + 1

    start = block.offset + varint_len(block.offset)
    start += varint_len(start)
    for i in range(8):  # deflate bytes mid-payload; sizes and sync intact
        raw[start + 4 + i] ^= 0xFF
    p.write_bytes(bytes(raw))
    with bounded_workers(), pytest.raises(pi.IngestShardError,
                                          match=r"bad\.avro\[@"):
        pi.parallel_fast_ingest([str(p)], {"global": imap},
                                {"global": imap.intercept_index},
                                id_types=["userId"], workers=2)


def test_dead_worker_raises_never_hangs(ingest, monkeypatch):
    imap = ingest["maps"]["global"]
    monkeypatch.setattr(sys, "executable", shutil.which("false"))
    with bounded_workers(), pytest.raises(pi.IngestShardError,
                                          match="died"):
        pi.parallel_fast_ingest([str(ingest["path"])], {"global": imap},
                                {"global": imap.intercept_index}, workers=2)


def test_worker_imports_neither_torch_nor_jax(ingest, tmp_path):
    """Run the worker module as the pool runs it, one task on stdin, and
    read back its sys.modules after the decode."""
    from photon_ml_tpu_torch.data.fast_ingest import build_training_layout
    from photon_ml_tpu_torch.data.index_map import DELIMITER
    from photon_ml_tpu_torch.io.avro_codec import Schema

    index = scan_container_blocks(ingest["path"])
    layout = build_training_layout(Schema(index.schema_json).root)
    imap = ingest["maps"]["global"]
    init = tmp_path / "init.pkl"
    init.write_bytes(pickle.dumps(dict(
        files={index.path: (layout.prog, layout.layout, dict(
            has_uid=layout.has_uid, has_weight=layout.has_weight,
            has_offset=layout.has_offset,
            has_metadata=layout.has_metadata))},
        dicts=(imap.key_to_index_dict(),), icepts=(imap.intercept_index,),
        ids=("userId",), delim=DELIMITER, collect=False)))
    shards = plan_shards([index], 2)
    probe = ("import runpy, sys\n"
             "try:\n"
             "    runpy.run_module('photon_ml_tpu_torch.data.parallel_ingest',"
             " run_name='__main__')\n"
             "except SystemExit:\n"
             "    pass\n"
             "sys.stderr.write('MODULES ' + repr(sorted(m for m in "
             "sys.modules if m.split('.')[0] in ('torch', 'jax', "
             "'photon_ml_tpu'))))\n")
    with bounded_workers():
        proc = subprocess.run(
            [sys.executable, "-c", probe],
            input=pickle.dumps({"init_path": str(init), "shards": shards}),
            capture_output=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    results = []
    import io
    buf = io.BytesIO(proc.stdout)
    while buf.tell() < len(proc.stdout):
        results.append(pickle.load(buf))
    assert [r[0] for r in results] == ["ok"] * len(shards)
    for r in results:
        pi._discard_transport(r[2])
    assert proc.stderr.decode().strip().endswith("MODULES []")


def test_column_consumer_feeds_the_overlapped_uploader(ingest):
    imap = ingest["maps"]["global"]
    up = OverlappedUploader(device="cpu")
    seqs = []

    def consumer(seq, labels, offsets, weights):
        seqs.append(seq)
        up.submit(labels)

    with bounded_workers():
        res = pi.parallel_fast_ingest(
            [str(ingest["path"])], {"global": imap},
            {"global": imap.intercept_index}, workers=2,
            column_consumer=consumer)
    assert seqs == sorted(seqs) and len(seqs) > 1
    assert up.collect().numpy().tobytes() == res.labels.tobytes()


def test_auto_declines_tiny_inputs_and_resolves_counts(ingest):
    imap = ingest["maps"]["global"]
    assert pi.parallel_fast_ingest(
        [str(ingest["path"])], {"global": imap},
        {"global": imap.intercept_index}, workers=4, auto=True) is None
    assert pi.MIN_PARALLEL_BYTES == jax_pi.MIN_PARALLEL_BYTES
    for spec in (1, "4", "auto", None):
        assert pi.resolve_ingest_workers(spec) == \
            jax_pi.resolve_ingest_workers(spec)
    for bad in ("-2", 0.5):
        with pytest.raises(ValueError):
            pi.resolve_ingest_workers(bad)


def _generator():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "generate_example_data", REPO / "examples" / "generate_example_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model_records(out: Path):
    return [rec for f in sorted((out / "best").rglob("*.avro"))
            for rec in read_container(f)]


def test_drivers_train_the_same_bits_with_two_workers(tmp_path):
    gen = _generator()
    rng = np.random.default_rng(9)
    w, bias = rng.normal(0, 1, 5), rng.normal(0, 1.5, 24)
    train = tmp_path / "train"
    train.mkdir()
    write_container(train / "part-00000.avro", schemas.TRAINING_EXAMPLE,
                    gen.game_records(rng, 1500, w, bias),
                    sync_interval=2048)
    game = ["--train-input-dirs", str(train), "--task-type",
            "LOGISTIC_REGRESSION",
            "--fixed-effect-data-configurations", "fixed:global",
            "--fixed-effect-optimization-configurations",
            "fixed:30,1e-7,1.0,1.0,LBFGS,L2", "--updating-sequence",
            "fixed"]
    glm = ["--training-data-directory", str(train), "--task", "LOGISTIC_REGRESSION",
           "--regularization-weights", "1.0", "--max-num-iterations", "30",
           "--dtype", "float64"]
    outs = {}
    with bounded_workers() as procs:
        for workers in ("1", "2"):
            out = tmp_path / f"game-{workers}"
            game_training_driver.run(
                [*game, "--ingest-workers", workers, "--output-dir",
                 str(out)], device="cpu")
            outs[("game", workers)] = _model_records(out)
            out = tmp_path / f"glm-{workers}"
            glm_driver.run([*glm, "--ingest-workers", workers,
                            "--output-directory", str(out)], device="cpu")
            # Decoded records: a container's sync marker is random.
            outs[("glm", workers)] = [
                list(read_container(p)) if p.suffix == ".avro"
                else p.read_bytes()
                for p in sorted(out.rglob("*"))
                if p.suffix in (".avro", ".txt") and "log" not in p.name]
    assert len(procs) >= 4  # both drivers started their pools
    assert outs[("game", "1")] == outs[("game", "2")] != []
    assert outs[("glm", "1")] == outs[("glm", "2")] != []
