"""Model files, Avro containers, index stores, the Avro reader and the
evaluators of the port against the JAX package, float64 on the CPU.

- Each package saves the same fixed, random, factored (with its latent
  gamma and B files) and MF model, made from seeded numpy arrays; every
  Avro file of either directory decodes to the same records through
  either package's codec (records, not bytes: a container's sync marker
  is random), the metadata and id-info files are equal, and each package
  loads the other's files to the same coefficients.
- The port's container writer is read by the JAX reader and the other
  way round, and the port's read_game_dataset decodes the same
  GameDataset as the JAX one.
- JSON and PalDB feature-index stores written by the JAX package load in
  the port as equal IndexMaps.
- Every evaluator the training driver's --evaluators can name, with the
  precision-recall helpers and MetricMetadata, against the JAX one on
  the same arrays, rtol 1e-12.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.data import paldb as jax_paldb
from photon_ml_tpu.data.avro_reader import read_game_dataset as jax_read
from photon_ml_tpu.data.index_map import IndexMap as JaxIndexMap
from photon_ml_tpu.evaluation import evaluators as jax_ev
from photon_ml_tpu.io import avro_codec as jax_codec
from photon_ml_tpu.io import model_io as jax_io
from photon_ml_tpu.models.coefficients import Coefficients as JaxCoefficients
from photon_ml_tpu.models.factored_random_effect import (
    FactoredRandomEffectModel as JaxFactored,
)
from photon_ml_tpu.models.fixed_effect import FixedEffectModel as JaxFixed
from photon_ml_tpu.models.game_model import GameModel as JaxGameModel
from photon_ml_tpu.models.glm import LogisticRegressionModel as JaxLogistic
from photon_ml_tpu.models.matrix_factorization import (
    MatrixFactorizationModel as JaxMF,
)
from photon_ml_tpu.models.random_effect import RandomEffectModel as JaxRE
from photon_ml_tpu.optimization.config import (
    MFOptimizationConfiguration as JaxMFConfig,
)
from photon_ml_tpu.projector.projectors import ProjectionMatrix
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.convert import (
    FactoredRandomEffectArrays,
    FixedEffectArrays,
    MatrixFactorizationArrays,
    RandomEffectArrays,
    game_model_from_numpy,
)
from photon_ml_tpu_torch.data.avro_reader import read_game_dataset
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.index_map import IndexMap, feature_key
from photon_ml_tpu_torch.data.paldb import load_feature_index_maps
from photon_ml_tpu_torch.evaluation import evaluators as ev
from photon_ml_tpu_torch.io import avro_codec, model_io, schemas
from photon_ml_tpu_torch.models.device_scoring import DeviceGameScorer
from photon_ml_tpu_torch.models.game_model import GameModel
from photon_ml_tpu_torch.serving import kernels
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

D_GLOBAL, D_USER, D_ITEM, K = 6, 4, 5, 3
N_USERS, N_ITEMS = 9, 7


def _maps():
    def imap(prefix, d):
        keys = {feature_key(f"{prefix}{j}", "t" if j % 2 else ""): j
                for j in range(d - 1)}
        keys[feature_key("(INTERCEPT)")] = d - 1
        return keys

    return {"global": imap("g", D_GLOBAL), "user": imap("u", D_USER),
            "item": imap("i", D_ITEM)}


def _arrays(seed=5):
    """One GAME model's parameters: a fixed effect, a per-user effect in
    two buckets with padding columns and one zero coefficient, a factored
    per-item effect (gamma in two buckets, B) and an MF model."""
    rng = np.random.default_rng(seed)
    users = np.asarray([f"user{i}" for i in range(N_USERS)])
    items = np.asarray([f"item{i}" for i in range(N_ITEMS)])
    fidx0 = np.asarray([[0, 2, 3, -1]] * 4, np.int32)
    fidx1 = np.asarray([[0, 1, 2, 3]] * 5, np.int32)
    c0 = rng.normal(0, 1, (4, 4))
    c0[:, 3] = 0.0
    c0[1, 1] = 0.0
    c1 = rng.normal(0, 1, (5, 4))
    codes_u = [np.asarray([3, 0, 7, 5]), np.asarray([1, 2, 4, 6, 8])]
    codes_i = [np.asarray([6, 1, 3]), np.asarray([0, 2, 4, 5])]
    gammas = [rng.normal(0, 1, (3, K)), rng.normal(0, 1, (4, K))]
    return dict(
        w=rng.normal(0, 1, D_GLOBAL), users=users, items=items,
        re=(c0, c1), fidx=(fidx0, fidx1), codes_u=codes_u,
        codes_i=codes_i, gammas=gammas, B=rng.normal(0, 1, (K, D_ITEM)),
        row_f=rng.normal(0, 1, (N_USERS, 2)),
        col_f=rng.normal(0, 1, (N_ITEMS, 2)))


def _port_model(a) -> GameModel:
    fac_idx = [np.tile(np.arange(K, dtype=np.int32), (len(c), 1))
               for c in a["codes_i"]]
    return game_model_from_numpy(TaskType.LOGISTIC_REGRESSION, {
        "fixed": FixedEffectArrays("global", a["w"]),
        "perUser": RandomEffectArrays(
            "userId", "user", list(a["re"]), list(a["fidx"]), a["codes_u"],
            a["users"], D_USER),
        "itemFactors": FactoredRandomEffectArrays(RandomEffectArrays(
            "itemId", "item", a["gammas"], fac_idx, a["codes_i"],
            a["items"], D_ITEM, a["B"]), 2, K),
        "mf": MatrixFactorizationArrays("userId", "itemId", a["row_f"],
                                        a["col_f"], a["users"], a["items"]),
    }, dtype=torch.float64, device="cpu")


def _jax_model(a) -> JaxGameModel:
    fac_idx = [jnp.tile(jnp.arange(K, dtype=jnp.int32), (len(c), 1))
               for c in a["codes_i"]]
    latent = JaxRE(
        random_effect_type="itemId", feature_shard_id="item",
        local_coefs=[jnp.asarray(g) for g in a["gammas"]],
        feat_idx=fac_idx, entity_codes=list(a["codes_i"]),
        vocabulary=a["items"], num_global_features=D_ITEM,
        projection=ProjectionMatrix(a["B"]))
    return JaxGameModel({
        "fixed": JaxFixed(JaxLogistic(JaxCoefficients(jnp.asarray(a["w"]))),
                          "global"),
        "perUser": JaxRE(
            random_effect_type="userId", feature_shard_id="user",
            local_coefs=[jnp.asarray(c) for c in a["re"]],
            feat_idx=[jnp.asarray(f) for f in a["fidx"]],
            entity_codes=list(a["codes_u"]), vocabulary=a["users"],
            num_global_features=D_USER),
        "itemFactors": JaxFactored(latent, JaxMFConfig(2, K)),
        "mf": JaxMF("userId", "itemId", jnp.asarray(a["row_f"]),
                    jnp.asarray(a["col_f"]), a["users"], a["items"]),
    }, JaxTaskType.LOGISTIC_REGRESSION)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = tmp_path_factory.mktemp("model_io")
    a = _arrays()
    maps = _maps()
    extras = {"updatingSequence": ["fixed", "perUser", "itemFactors", "mf"]}
    model_io.save_game_model(root / "port", _port_model(a),
                             {k: IndexMap(v) for k, v in maps.items()},
                             metadata_extras=extras)
    jax_io.save_game_model(root / "jax", _jax_model(a),
                           {k: JaxIndexMap(v) for k, v in maps.items()},
                           metadata_extras=extras)
    return dict(root=root, arrays=a, maps=maps)


def _files(d: Path, pattern: str):
    return sorted(str(p.relative_to(d)) for p in d.rglob(pattern))


def test_both_packages_write_the_same_files(saved):
    port, jax = saved["root"] / "port", saved["root"] / "jax"
    assert _files(port, "*") == _files(jax, "*")
    avro = _files(port, "*.avro")
    assert len(avro) == 7  # fixed, per-user, factored + gamma, B, MF x 2
    for rel in _files(port, "model-metadata.json") + _files(port, "id-info"):
        assert json.loads((port / rel).read_text()) == json.loads(
            (jax / rel).read_text()), rel


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_every_model_file_decodes_to_the_same_records(saved, reader):
    """Both directories through one package's codec: the same records
    (so each codec reads the other's containers)."""
    read = {"port": avro_codec.read_container,
            "jax": jax_codec.read_container}[reader]
    port, jax = saved["root"] / "port", saved["root"] / "jax"
    for rel in _files(port, "*.avro"):
        assert list(read(port / rel)) == list(read(jax / rel)), rel
    recs = list(read(port / "random-effect/perUser/coefficients/"
                            "part-00000.avro"))
    assert [r["modelId"] for r in recs] == sorted(saved["arrays"]["users"])
    assert all(r["modelClass"] == "LogisticRegressionModel"
               and r["lossFunction"] == "logisticLoss" for r in recs)


@pytest.mark.parametrize("which", ["port", "jax"])
def test_each_package_loads_the_others_model(saved, which):
    """The port loads the JAX package's files and the JAX package loads
    the port's to the same coefficients; a factored effect loads as its
    original-space snapshot."""
    root = saved["root"] / which
    mine = model_io.load_game_model(
        root, {k: IndexMap(v) for k, v in saved["maps"].items()})
    theirs = jax_io.load_game_model(
        root, {k: JaxIndexMap(v) for k, v in saved["maps"].items()})
    assert mine.task_type.value == theirs.task_type.value
    assert list(mine.models) == list(theirs.models)
    a = saved["arrays"]
    np.testing.assert_array_equal(
        mine.models["fixed"].glm.coefficients.means.numpy(), a["w"])
    np.testing.assert_array_equal(
        np.asarray(theirs.models["fixed"].glm.coefficients.means), a["w"])
    for name in ("perUser", "itemFactors"):
        m, t = mine.models[name], theirs.models[name]
        assert isinstance(m, model_io.RandomEffectModelSnapshot)
        np.testing.assert_array_equal(m.vocabulary, t.vocabulary)
        np.testing.assert_array_equal(m.matrix.toarray(),
                                      t.matrix.toarray())
    dense = mine.models["itemFactors"].matrix.toarray()
    for g, codes in zip(a["gammas"], a["codes_i"]):
        np.testing.assert_allclose(dense[codes], g @ a["B"], rtol=1e-14,
                                   atol=1e-14)
    for side in ("row_factors", "col_factors"):
        np.testing.assert_array_equal(
            getattr(mine.models["mf"], side).numpy(),
            np.asarray(getattr(theirs.models["mf"], side)))


def _records(rng, n):
    out = []
    for i in range(n):
        feats = [{"name": f"g{j}", "term": "t" if j % 2 else None,
                  "value": float(rng.normal())}
                 for j in rng.choice(D_GLOBAL - 1, 3, replace=False)]
        feats += [{"name": f"u{j}", "term": "t" if j % 2 else None,
                   "value": float(rng.normal())} for j in range(2)]
        out.append({
            "uid": f"r{i}", "label": float(rng.random() < 0.5),
            "features": feats,
            "weight": None if i % 3 else float(rng.random() + 0.5),
            "offset": None if i % 4 else float(rng.normal()),
            "metadataMap": {"userId": f"user{rng.integers(N_USERS)}"}})
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_containers_and_datasets_cross_the_packages(tmp_path, writer):
    """A container written by one package reads back in both as the
    written records, and read_game_dataset gives the same GameDataset
    (labels, offsets, weights, uids, CSR shards, entity codes)."""
    records = _records(np.random.default_rng(11), 40)
    write = {"port": avro_codec.write_container,
             "jax": jax_codec.write_container}[writer]
    (tmp_path / "d").mkdir()
    write(tmp_path / "d" / "part-00000.avro", schemas.TRAINING_EXAMPLE,
          records, sync_interval=512)
    assert list(avro_codec.read_container(tmp_path / "d" / "part-00000.avro")
                ) == records
    assert list(jax_codec.read_container(
        tmp_path / "d" / "part-00000.avro")) == records
    maps = _maps()
    data, got_maps = read_game_dataset(
        tmp_path / "d", ["userId"],
        {k: IndexMap(maps[k]) for k in ("global", "user")})
    jdata, _ = jax_read(tmp_path / "d", ["userId"],
                        {k: JaxIndexMap(maps[k]) for k in ("global", "user")})
    assert isinstance(data, GameDataset) and data.num_rows == 40
    for col in ("responses", "offsets", "weights", "uids"):
        np.testing.assert_array_equal(getattr(data, col),
                                      getattr(jdata, col))
    for shard in ("global", "user"):
        got, want = data.feature_shards[shard], jdata.feature_shards[shard]
        assert got.shape == want.shape
        assert (got != want).nnz == 0
        np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(data.id_columns["userId"].codes,
                                  jdata.id_columns["userId"].codes)
    np.testing.assert_array_equal(data.id_columns["userId"].vocabulary,
                                  jdata.id_columns["userId"].vocabulary)
    # Without index maps both build one "global" shard from every key.
    scanned, smaps = read_game_dataset(tmp_path / "d", ["userId"])
    jscanned, jmaps = jax_read(tmp_path / "d", ["userId"])
    assert dict(smaps["global"].key_items()) == dict(
        jmaps["global"].key_items())
    assert (scanned.feature_shards["global"]
            != jscanned.feature_shards["global"]).nnz == 0


@pytest.mark.parametrize("fmt", ["json", "paldb"])
def test_index_stores_written_by_jax_load_in_the_port(tmp_path, fmt):
    names = sorted({feature_key(f"f{j}", t) for j in range(23)
                    for t in ("", "a")})
    if fmt == "paldb":
        for shard, parts in (("global", 2), ("user", 1)):
            jax_paldb.build_paldb_index_stores(tmp_path, shard, names,
                                               num_partitions=parts)
    else:
        for shard in ("global", "user"):
            JaxIndexMap.from_keys(names, add_intercept=True).save(
                tmp_path / f"{shard}.json")
    got = load_feature_index_maps(tmp_path)
    want = jax_paldb.load_feature_index_maps(tmp_path)
    assert sorted(got) == sorted(want) == ["global", "user"]
    for shard in got:
        assert dict(got[shard].key_items()) == dict(
            want[shard].key_items())
        assert got[shard].intercept_index == want[shard].intercept_index


EVALUATOR_SPECS = ["AUC", "RMSE", "LOGISTIC_LOSS", "POISSON_LOSS",
                   "SQUARED_LOSS", "SMOOTHED_HINGE_LOSS", "AUC:userId",
                   "PRECISION@3:userId", "precision@1:userId"]


@pytest.fixture(scope="module")
def eval_data():
    rng = np.random.default_rng(21)
    n = 300
    labels = (rng.random(n) < 0.4).astype(float)
    users = rng.integers(0, 17, n).astype(str)
    scores = np.round(rng.normal(0, 1, n) + labels, 1)  # with ties
    offsets = rng.normal(0, 0.1, n)
    weights = rng.random(n) + 0.5
    x = sp.csr_matrix(np.ones((n, 1)))
    from photon_ml_tpu.data.game_data import GameDataset as JaxGameDataset

    cols = dict(responses=labels, feature_shards={"g": x},
                ids={"userId": users}, offsets=offsets, weights=weights)
    return (scores, GameDataset.build(**cols), JaxGameDataset.build(**cols))


@pytest.mark.parametrize("spec", EVALUATOR_SPECS)
def test_evaluators_match_jax(eval_data, spec):
    scores, data, jdata = eval_data
    mine, theirs = ev.build_evaluator(spec), jax_ev.build_evaluator(spec)
    assert mine.name == theirs.name
    assert mine.higher_is_better == theirs.higher_is_better
    got = mine.evaluate_dataset(torch.as_tensor(scores), data)
    want = theirs.evaluate_dataset(scores, jdata)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert ev.metadata_for(mine).to_dict() == jax_ev.metadata_for(
        theirs).to_dict()
    assert mine.better_than(1.0, 0.5) == theirs.better_than(1.0, 0.5)


@pytest.mark.parametrize("fn", ["area_under_precision_recall",
                                "peak_f1_score", "area_under_roc_curve"])
def test_precision_recall_helpers_match_jax(eval_data, fn):
    scores, data, _ = eval_data
    got = getattr(ev, fn)(scores, data.responses, data.weights)
    want = getattr(jax_ev, fn)(scores, data.responses, data.weights)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_loaded_snapshot_scores_on_the_device_path(saved, eval_data):
    """The loaded per-user snapshot scores as the ``random_matrix`` kind,
    equal to the snapshot's host scores; past the densification ceiling
    the scorer raises (there is no host fallback)."""
    root = saved["root"] / "jax"
    model = model_io.load_game_model(
        root, {k: IndexMap(v) for k, v in saved["maps"].items()})
    rng = np.random.default_rng(3)
    n = 50
    data = GameDataset.build(
        responses=(rng.random(n) < 0.5).astype(float),
        feature_shards={"user": sp.random(n, D_USER, density=0.7,
                                          random_state=4, format="csr")},
        ids={"userId": np.asarray([f"user{i}" for i in
                                  rng.integers(0, N_USERS + 3, n)])})
    sub = GameModel({"perUser": model.models["perUser"]},
                    model.task_type)
    scorer = DeviceGameScorer(sub, data, dtype=torch.float64, device="cpu")
    assert scorer._kinds == [("perUser", "random_matrix")]
    np.testing.assert_allclose(scorer.score(sub).numpy(),
                               sub.models["perUser"].score_numpy(data),
                               atol=1e-12, rtol=0)
    big = model_io.RandomEffectModelSnapshot(
        "userId", "user", sp.csr_matrix((1, 1 << 29)), np.asarray(["u"]))
    with pytest.raises(kernels.UnsupportedSubModelError,
                       match="densification ceiling"):
        DeviceGameScorer(GameModel({"perUser": big}, model.task_type),
                         data, dtype=torch.float64, device="cpu")
