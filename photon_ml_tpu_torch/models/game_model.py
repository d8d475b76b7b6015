"""GAME composite model: named sub-models with additive scores (port of
photon_ml_tpu/models/game_model.py:18-48; reference
ml/model/GAMEModel.scala:33-171)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import numpy as np

from photon_ml_tpu_torch.models.factored_random_effect import (
    FactoredRandomEffectModel,
)
from photon_ml_tpu_torch.models.fixed_effect import FixedEffectModel
from photon_ml_tpu_torch.models.matrix_factorization import (
    MatrixFactorizationModel,
)
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.types import TaskType

SubModel = Union[FixedEffectModel, RandomEffectModel,
                 FactoredRandomEffectModel, MatrixFactorizationModel]


@dataclasses.dataclass
class GameModel:
    models: Dict[str, SubModel]  # insertion order == coordinate order
    task_type: TaskType

    def score(self, data) -> np.ndarray:
        """Additive host score over all sub-models."""
        total = np.zeros(data.num_rows)
        for m in self.models.values():
            total += np.asarray(m.score_numpy(data))
        return total
