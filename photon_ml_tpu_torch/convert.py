"""Carry a trained GAME model's parameters across from numpy.

``game_model_from_numpy`` builds the port's ``GameModel`` from plain
numpy arrays: a fixed effect's coefficient vector; per random-effect
bucket its local coefficients ``[E_b, d_pad]``, ``feat_idx`` and entity
codes, plus the vocabulary, the global feature count and, for a
RANDOM-projected model, its projection matrix ``[k1, d_global]``; a
factored random effect as those arrays of its latent model (gamma per
bucket) with the learned B as the projection, and its MF knobs; a
matrix-factorization model's two factor tables and vocabularies. A model
trained by the JAX package converts by ``np.asarray`` on each of its
arrays (photon_ml_tpu/models/fixed_effect.py, random_effect.py,
factored_random_effect.py, matrix_factorization.py); this module takes
numpy only and imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.factored_random_effect import (
    FactoredRandomEffectModel,
)
from photon_ml_tpu_torch.models.fixed_effect import FixedEffectModel
from photon_ml_tpu_torch.models.game_model import GameModel
from photon_ml_tpu_torch.models.glm import model_for_task
from photon_ml_tpu_torch.models.matrix_factorization import (
    MatrixFactorizationModel,
)
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.optimization.config import (
    MFOptimizationConfiguration,
)
from photon_ml_tpu_torch.types import TaskType


@dataclasses.dataclass(frozen=True)
class FixedEffectArrays:
    feature_shard_id: str
    coefficients: np.ndarray  # [d]


@dataclasses.dataclass(frozen=True)
class RandomEffectArrays:
    random_effect_type: str
    feature_shard_id: str
    local_coefs: Sequence[np.ndarray]  # [E_b, d_pad] per bucket
    feat_idx: Sequence[np.ndarray]  # [E_b, d_pad] per bucket, -1 padding
    entity_codes: Sequence[np.ndarray]  # [E_b] per bucket
    vocabulary: np.ndarray
    num_global_features: int
    projection: Optional[np.ndarray] = None  # [k1, d_global], latent model


@dataclasses.dataclass(frozen=True)
class FactoredRandomEffectArrays:
    latent: RandomEffectArrays  # gamma per bucket; projection = learned B
    max_iterations: int  # the MF knobs
    num_factors: int


@dataclasses.dataclass(frozen=True)
class MatrixFactorizationArrays:
    row_effect_type: str
    col_effect_type: str
    row_factors: np.ndarray  # [num_row_codes, k]
    col_factors: np.ndarray  # [num_col_codes, k]
    row_vocabulary: np.ndarray
    col_vocabulary: np.ndarray


SubModelArrays = Union[FixedEffectArrays, RandomEffectArrays,
                       FactoredRandomEffectArrays, MatrixFactorizationArrays]


def _random_effect(arrays: RandomEffectArrays, dtype, dev
                   ) -> RandomEffectModel:
    return RandomEffectModel(
        random_effect_type=arrays.random_effect_type,
        feature_shard_id=arrays.feature_shard_id,
        local_coefs=[torch.tensor(np.asarray(c), dtype=dtype, device=dev)
                     for c in arrays.local_coefs],
        feat_idx=[torch.tensor(np.asarray(f, np.int32), device=dev)
                  for f in arrays.feat_idx],
        entity_codes=[np.asarray(c, np.int32) for c in arrays.entity_codes],
        vocabulary=np.asarray(arrays.vocabulary),
        num_global_features=int(arrays.num_global_features),
        projection=(None if arrays.projection is None else torch.tensor(
            np.asarray(arrays.projection), dtype=dtype, device=dev)))


def game_model_from_numpy(
    task_type: TaskType, sub_models: Mapping[str, SubModelArrays],
    dtype=torch.float32, device="cuda",
) -> GameModel:
    """The port's GameModel from numpy parameters, sub-models in the
    mapping's order (the coordinate order)."""
    dev = resolve_device(device)
    models = {}
    for name, arrays in sub_models.items():
        if isinstance(arrays, FixedEffectArrays):
            means = torch.tensor(np.asarray(arrays.coefficients),
                                 dtype=dtype, device=dev)
            glm = model_for_task(task_type)(Coefficients(means))
            models[name] = FixedEffectModel(glm, arrays.feature_shard_id)
        elif isinstance(arrays, RandomEffectArrays):
            models[name] = _random_effect(arrays, dtype, dev)
        elif isinstance(arrays, FactoredRandomEffectArrays):
            models[name] = FactoredRandomEffectModel(
                _random_effect(arrays.latent, dtype, dev),
                MFOptimizationConfiguration(arrays.max_iterations,
                                            arrays.num_factors))
        elif isinstance(arrays, MatrixFactorizationArrays):
            models[name] = MatrixFactorizationModel(
                arrays.row_effect_type, arrays.col_effect_type,
                torch.tensor(np.asarray(arrays.row_factors), dtype=dtype,
                             device=dev),
                torch.tensor(np.asarray(arrays.col_factors), dtype=dtype,
                             device=dev),
                np.asarray(arrays.row_vocabulary),
                np.asarray(arrays.col_vocabulary))
        else:
            raise TypeError(f"sub-model {name!r}: expected one of "
                            f"{[t.__name__ for t in SubModelArrays.__args__]}"
                            f", got {type(arrays).__name__}")
    return GameModel(models, task_type)
