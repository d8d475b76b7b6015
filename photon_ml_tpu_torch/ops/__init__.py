"""Compute: pointwise losses, feature matrices, GLM objectives and the
kernel wrappers (port of photon_ml_tpu/ops/; the exports are the JAX
package's). No kernel is built at import: each builds at first use
(cuda_build.py)."""

from photon_ml_tpu_torch.ops.losses import (
    PointwiseLoss,
    LogisticLoss,
    SquaredLoss,
    PoissonLoss,
    SmoothedHingeLoss,
    loss_for_task,
)
from photon_ml_tpu_torch.ops.features import (
    FeatureMatrix,
    DenseFeatures,
    CSRFeatures,
)
from photon_ml_tpu_torch.ops.glm_objective import GLMObjective

__all__ = [
    "PointwiseLoss",
    "LogisticLoss",
    "SquaredLoss",
    "PoissonLoss",
    "SmoothedHingeLoss",
    "loss_for_task",
    "FeatureMatrix",
    "DenseFeatures",
    "CSRFeatures",
    "GLMObjective",
]
