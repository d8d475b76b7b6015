"""Model hierarchy: GLMs, fixed/random effect models, GAME composite, MF
(port of photon_ml_tpu/models/; the exports are the JAX package's)."""

from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import (
    GeneralizedLinearModel,
    LogisticRegressionModel,
    LinearRegressionModel,
    PoissonRegressionModel,
    SmoothedHingeLossLinearSVMModel,
    model_for_task,
)
from photon_ml_tpu_torch.models.fixed_effect import FixedEffectModel
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.models.factored_random_effect import (
    FactoredRandomEffectModel,
)
from photon_ml_tpu_torch.models.matrix_factorization import (
    MatrixFactorizationModel,
)
from photon_ml_tpu_torch.models.game_model import GameModel
from photon_ml_tpu_torch.models.tracking import (
    CoefficientSummary,
    ModelTracker,
    OptimizerState,
    summarize_coefficients,
    summarize_trackers,
)

__all__ = [
    "Coefficients",
    "GeneralizedLinearModel",
    "LogisticRegressionModel",
    "LinearRegressionModel",
    "PoissonRegressionModel",
    "SmoothedHingeLossLinearSVMModel",
    "model_for_task",
    "FixedEffectModel",
    "RandomEffectModel",
    "FactoredRandomEffectModel",
    "MatrixFactorizationModel",
    "GameModel",
    "CoefficientSummary",
    "ModelTracker",
    "OptimizerState",
    "summarize_coefficients",
    "summarize_trackers",
]
