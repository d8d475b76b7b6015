"""Factored random-effect model: per-entity latent factors gamma and a
shared, learned projection matrix B (port of
photon_ml_tpu/models/factored_random_effect.py, the whole file;
reference ml/model/FactoredRandomEffectModel.scala).

Entity e's global coefficients are gamma_e^T B. The model IS a
RandomEffectModel in the latent space with B as its projection, so
scoring and the global-space view reuse that model
(models/random_effect.py).
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.optimization.config import (
    MFOptimizationConfiguration,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FactoredRandomEffectModel:
    latent: RandomEffectModel  # local_coefs = gamma per bucket, projection = B
    mf_config: MFOptimizationConfiguration

    def __post_init__(self):
        if self.latent.projection is None:
            raise ValueError(
                "FactoredRandomEffectModel requires a latent "
                "RandomEffectModel with its learned projection matrix")

    @property
    def projection_matrix(self) -> Tensor:
        """The learned B: [num_factors, num_global_features]."""
        return self.latent.projection

    @property
    def random_effect_type(self) -> str:
        return self.latent.random_effect_type

    @property
    def feature_shard_id(self) -> str:
        return self.latent.feature_shard_id

    @property
    def num_entities(self) -> int:
        return self.latent.num_entities

    def with_update(self, local_coefs: List[Tensor], matrix: Tensor
                    ) -> "FactoredRandomEffectModel":
        latent = dataclasses.replace(self.latent,
                                     local_coefs=list(local_coefs),
                                     projection=matrix)
        return dataclasses.replace(self, latent=latent)

    def model_matrix(self):
        return self.latent.model_matrix()

    def to_entity_dict(self):
        return self.latent.to_entity_dict()

    def score_numpy(self, data):
        return self.latent.score_numpy(data)
