"""Model persistence in the reference's on-disk layout (port of
photon_ml_tpu/io/model_io.py: _coeff_records / _vector_from_records
:48-74, glm_to_avro_record :77, glm_from_avro_record :90,
write_text_model :111,
RandomEffectModelSnapshot :126, save_game_model :171 with the factored
latent files :230-263, load_game_model :286; reference
ml/avro/model/ModelProcessingUtils.scala:67-545):

  <root>/model-metadata.json
  <root>/fixed-effect/<coordinate>/coefficients/part-00000.avro
  <root>/random-effect/<coordinate>/coefficients/part-00000.avro
  <root>/random-effect/<coordinate>/id-info
  <root>/random-effect/<coordinate>/latent/{gamma,projection}-latent-factors.avro
  <root>/matrix-factorization/<coordinate>/{row,col}-latent-factors.avro

(BayesianLinearModelAvro records, random-effect modelId = entity id;
LatentFactorAvro for factors.) Files written here load in the JAX
package and the other way round: the gate is equal decoded records, not
equal bytes (a container's sync marker is random).

Coefficients cross the boundary as host numpy: a float32 coefficient
from the card widens exactly to the Avro double, and a loaded model
holds float64 tensors on the CPU, which the device scorer moves to its
device. The GLM driver's text model (write_text_model, :111-119) prints
each coefficient from its host numpy value, as the JAX package does, so
a float64 run writes the same text.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.data.index_map import IndexMap, feature_key, split_key
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro_codec import read_container, write_container
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.factored_random_effect import (
    FactoredRandomEffectModel,
)
from photon_ml_tpu_torch.models.fixed_effect import FixedEffectModel
from photon_ml_tpu_torch.models.game_model import GameModel
from photon_ml_tpu_torch.models.glm import (
    GeneralizedLinearModel,
    model_class_by_name,
    model_for_task,
)
from photon_ml_tpu_torch.models.matrix_factorization import (
    MatrixFactorizationModel,
)
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils.vocab import vocab_code_lookup


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ---------------------------------------------------------------------------
# name/term <-> index helpers
# ---------------------------------------------------------------------------


def _coeff_records(means: np.ndarray, index_map: IndexMap,
                   variances: Optional[np.ndarray] = None):
    mean_list, var_list = [], []
    for key, idx in index_map.key_items():
        v = float(means[idx])
        name, term = split_key(key)
        if v != 0.0:
            mean_list.append(
                {"name": name, "term": term or None, "value": v})
        # Variances are kept independently of the mean: a coefficient L1-ed
        # to exactly 0 can still carry a nonzero posterior variance.
        if variances is not None and float(variances[idx]) != 0.0:
            var_list.append({"name": name, "term": term or None,
                             "value": float(variances[idx])})
    return mean_list, (var_list if variances is not None else None)


def _vector_from_records(records, index_map: IndexMap, d: int) -> np.ndarray:
    out = np.zeros(d)
    for r in records:
        idx = index_map.get_index(feature_key(r["name"], r["term"] or ""))
        if idx >= 0:
            out[idx] = r["value"]
    return out


def glm_to_avro_record(model_id: str, glm: GeneralizedLinearModel,
                       index_map: IndexMap) -> dict:
    means, variances = glm.coefficients.to_numpy()
    mean_recs, var_recs = _coeff_records(means, index_map, variances)
    return {
        "modelId": model_id,
        "modelClass": glm.model_class_name,
        "lossFunction": glm.loss.name,
        "means": mean_recs,
        "variances": var_recs,
    }


def glm_from_avro_record(rec: dict, index_map: IndexMap
                         ) -> Tuple[str, GeneralizedLinearModel]:
    """(modelId, GLM with float64 coefficients on the CPU)."""
    d = len(index_map)
    means = _vector_from_records(rec["means"], index_map, d)
    variances = (None if rec.get("variances") is None else
                 _vector_from_records(rec["variances"], index_map, d))
    cls = model_class_by_name(rec["modelClass"]) if rec.get("modelClass") \
        else None
    if cls is None:
        raise ValueError(f"model record {rec['modelId']} has no modelClass")
    coeff = Coefficients(
        torch.as_tensor(means),
        None if variances is None else torch.as_tensor(variances))
    return rec["modelId"], cls(coeff)


# ---------------------------------------------------------------------------
# GLM driver text models (ml/util/IOUtils.scala:236-238)
# ---------------------------------------------------------------------------


def write_text_model(path, glm: GeneralizedLinearModel, index_map: IndexMap,
                     reg_weight: float) -> None:
    """One line per index-map key, in its order: name, term, coefficient
    and λ, tab-separated."""
    means, _ = glm.coefficients.to_numpy()
    lines = []
    for key, idx in index_map.key_items():
        name, term = split_key(key)
        lines.append(f"{name}\t{term}\t{means[idx]}\t{reg_weight}")
    Path(path).write_text("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# Loaded random-effect models (scoring form)
# ---------------------------------------------------------------------------


class RandomEffectModelSnapshot:
    """A random-effect model loaded from disk: per-entity global-space
    coefficient rows as scipy CSR, with the entity vocabulary, on the
    host. The device scorer densifies it (serving/kernels.py
    snapshot_dense_matrix)."""

    def __init__(self, random_effect_type: str, feature_shard_id: str,
                 matrix: sp.csr_matrix, vocabulary: np.ndarray):
        self.random_effect_type = random_effect_type
        self.feature_shard_id = feature_shard_id
        self.matrix = matrix.tocsr()
        self.vocabulary = np.asarray(vocabulary)

    @property
    def num_entities(self) -> int:
        return len(self.vocabulary)

    def score_numpy(self, data) -> np.ndarray:
        mat = data.feature_shards[self.feature_shard_id].tocsr()
        col = data.id_columns[self.random_effect_type]
        mapped = vocab_code_lookup(self.vocabulary, col.vocabulary)[col.codes]
        valid = mapped >= 0
        scores = np.zeros(data.num_rows)
        if valid.any():
            rows = np.flatnonzero(valid)
            scores[rows] = np.asarray(
                mat[rows].multiply(self.matrix[mapped[valid]]).sum(axis=1)
            ).ravel()
        return scores


# ---------------------------------------------------------------------------
# GAME model save / load
# ---------------------------------------------------------------------------

FIXED_DIR = "fixed-effect"
RANDOM_DIR = "random-effect"
METADATA_FILE = "model-metadata.json"
ID_INFO_FILE = "id-info"
COEFF_DIR = "coefficients"
PART_FILE = "part-00000.avro"


def _latent_records(names, rows) -> list:
    return [{"effectId": str(n), "latentFactor": [float(v) for v in r]}
            for n, r in zip(names, rows)]


def _save_latent_factors(directory: Path,
                         model: FactoredRandomEffectModel) -> None:
    """Per-entity gamma and the shared B as LatentFactorAvro, beside the
    original-space coefficients (the reference's MF factor schema,
    ModelProcessingUtils.scala:400-424)."""
    directory.mkdir(parents=True, exist_ok=True)
    latent = model.latent
    B = _host(model.projection_matrix)
    k = int(B.shape[0])
    gamma_recs = []
    for coefs, codes in zip(latent.local_coefs, latent.entity_codes):
        c = _host(coefs)[:, :k]
        gamma_recs.extend(_latent_records(latent.vocabulary[codes], c))
    gamma_recs.sort(key=lambda r: r["effectId"])
    write_container(directory / "gamma-latent-factors.avro",
                    schemas.LATENT_FACTOR, gamma_recs)
    write_container(directory / "projection-latent-factors.avro",
                    schemas.LATENT_FACTOR, _latent_records(
                        (f"factor-{i}" for i in range(k)), B))


def save_game_model(
    root, game_model: GameModel, index_maps: Dict[str, IndexMap],
    metadata_extras: Optional[dict] = None,
) -> None:
    """index_maps: feature_shard_id -> IndexMap (reference: one feature
    index per shard)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    meta = {
        "taskType": game_model.task_type.value,
        "coordinates": [],
        **(metadata_extras or {}),
    }
    for name, model in game_model.models.items():
        if isinstance(model, FixedEffectModel):
            d = root / FIXED_DIR / name / COEFF_DIR
            d.mkdir(parents=True, exist_ok=True)
            imap = index_maps[model.feature_shard_id]
            write_container(
                d / PART_FILE, schemas.BAYESIAN_LINEAR_MODEL,
                [glm_to_avro_record("fixed effect", model.glm, imap)])
            meta["coordinates"].append({
                "name": name, "kind": "fixed",
                "featureShardId": model.feature_shard_id})
        elif isinstance(model, (RandomEffectModel, RandomEffectModelSnapshot,
                                FactoredRandomEffectModel)):
            # Factored models persist in the ORIGINAL feature space, as the
            # reference does (ModelProcessingUtils.saveGameModelsToHDFS),
            # and load back as plain random-effect models.
            d = root / RANDOM_DIR / name / COEFF_DIR
            d.mkdir(parents=True, exist_ok=True)
            imap = index_maps[model.feature_shard_id]
            glm_cls = model_for_task(game_model.task_type)
            if isinstance(model, RandomEffectModelSnapshot):
                m = model.matrix
                entity_rows = {
                    str(n): (m.indices[m.indptr[i]:m.indptr[i + 1]],
                             m.data[m.indptr[i]:m.indptr[i + 1]])
                    for i, n in enumerate(model.vocabulary)}
            else:
                entity_rows = model.to_entity_dict()
            dim = len(imap)
            records = []
            for entity, (cols, vals) in sorted(entity_rows.items()):
                means = np.zeros(dim)
                means[cols] = vals
                records.append(glm_to_avro_record(
                    entity, glm_cls(Coefficients(torch.as_tensor(means))),
                    imap))
            write_container(d / PART_FILE, schemas.BAYESIAN_LINEAR_MODEL,
                            records)
            (root / RANDOM_DIR / name / ID_INFO_FILE).write_text(
                json.dumps({"randomEffectType": model.random_effect_type,
                            "featureShardId": model.feature_shard_id}))
            coord_meta = {
                "name": name, "kind": "random",
                "randomEffectType": model.random_effect_type,
                "featureShardId": model.feature_shard_id}
            if isinstance(model, FactoredRandomEffectModel):
                _save_latent_factors(root / RANDOM_DIR / name / "latent",
                                     model)
                coord_meta["factored"] = {
                    "numFactors": int(model.mf_config.num_factors),
                    "mfMaxIterations": int(model.mf_config.max_iterations)}
            meta["coordinates"].append(coord_meta)
        elif isinstance(model, MatrixFactorizationModel):
            d = root / "matrix-factorization" / name
            d.mkdir(parents=True, exist_ok=True)
            for which, factors, vocab in (
                    ("row", model.row_factors, model.row_vocabulary),
                    ("col", model.col_factors, model.col_vocabulary)):
                write_container(
                    d / f"{which}-latent-factors.avro", schemas.LATENT_FACTOR,
                    _latent_records(vocab, _host(factors)))
            (d / ID_INFO_FILE).write_text(json.dumps({
                "rowEffectType": model.row_effect_type,
                "colEffectType": model.col_effect_type}))
            meta["coordinates"].append({
                "name": name, "kind": "mf",
                "rowEffectType": model.row_effect_type,
                "colEffectType": model.col_effect_type})
        else:
            raise TypeError(f"cannot save model type {type(model)}")
    (root / METADATA_FILE).write_text(json.dumps(meta, indent=2))


def load_game_model(root, index_maps: Dict[str, IndexMap]) -> GameModel:
    """A saved model with host (CPU, float64) coefficients: fixed effects
    as FixedEffectModel, random and factored effects as
    RandomEffectModelSnapshot (original space), MF as
    MatrixFactorizationModel."""
    root = Path(root)
    meta = json.loads((root / METADATA_FILE).read_text())
    task = TaskType(meta["taskType"])
    models: Dict[str, object] = {}
    for coord in meta["coordinates"]:
        name = coord["name"]
        if coord["kind"] == "fixed":
            shard = coord["featureShardId"]
            recs = list(read_container(
                root / FIXED_DIR / name / COEFF_DIR / PART_FILE))
            _, glm = glm_from_avro_record(recs[0], index_maps[shard])
            models[name] = FixedEffectModel(glm, shard)
        elif coord["kind"] == "random":
            info = json.loads(
                (root / RANDOM_DIR / name / ID_INFO_FILE).read_text())
            shard = info["featureShardId"]
            imap = index_maps[shard]
            entities, rows_list = [], []
            for rec in read_container(
                    root / RANDOM_DIR / name / COEFF_DIR / PART_FILE):
                entities.append(rec["modelId"])
                rows_list.append(_vector_from_records(rec["means"], imap,
                                                      len(imap)))
            matrix = sp.csr_matrix(np.vstack(rows_list)) if rows_list else \
                sp.csr_matrix((0, len(imap)))
            models[name] = RandomEffectModelSnapshot(
                info["randomEffectType"], shard, matrix,
                np.asarray(entities))
        elif coord["kind"] == "mf":
            d = root / "matrix-factorization" / name
            info = json.loads((d / ID_INFO_FILE).read_text())
            vocabs, factors = [], []
            for which in ("row", "col"):
                recs = list(read_container(d / f"{which}-latent-factors.avro"))
                vocabs.append(np.asarray([r["effectId"] for r in recs]))
                factors.append(torch.as_tensor(
                    np.asarray([r["latentFactor"] for r in recs])))
            models[name] = MatrixFactorizationModel(
                info["rowEffectType"], info["colEffectType"],
                factors[0], factors[1], vocabs[0], vocabs[1])
        else:
            raise ValueError(f"unknown coordinate kind {coord['kind']!r}")
    return GameModel(models, task)
