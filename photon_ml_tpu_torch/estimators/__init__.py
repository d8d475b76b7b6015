"""Estimator APIs: GLM λ-grid training and the GAME estimator (port of
photon_ml_tpu/estimators/; the exports are the JAX package's)."""

from photon_ml_tpu_torch.estimators.model_training import train_glm_models
from photon_ml_tpu_torch.estimators.model_selection import select_best_model
from photon_ml_tpu_torch.estimators.game_estimator import (
    GameEstimator,
    CoordinateSpec,
    FixedEffectSpec,
    RandomEffectSpec,
)

__all__ = [
    "train_glm_models",
    "select_best_model",
    "GameEstimator",
    "CoordinateSpec",
    "FixedEffectSpec",
    "RandomEffectSpec",
]
