"""GLM training over a regularization-weight grid with warm starts (port
of photon_ml_tpu/estimators/model_training.py: TrainedGLM :41,
device_batch :51, train_glm_models :68-145; reference
ml/ModelTraining.scala:54-214 — the λ grid is sorted descending and each
solve warm-starts from the previous λ's model, fold at :182-207).

Each λ is one ``solve_glm`` on the device; the features and the batch
are uploaded once for the whole grid. The JAX package reuses one
compiled kernel across the grid; the port's solvers are host loops over
device tensors, so there is nothing to compile.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.data.normalization import NormalizationContext
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import (
    GeneralizedLinearModel,
    model_for_task,
)
from photon_ml_tpu_torch.models.tracking import ModelTracker
from photon_ml_tpu_torch.ops.features import (
    DENSE_DENSITY_THRESHOLD,
    features_to_device,
)
from photon_ml_tpu_torch.ops.glm_objective import (
    GLMBatch,
    GLMObjective,
    make_batch,
)
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.optimization.config import (
    GLMOptimizationConfiguration,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.optimization.convergence import OptimizerResult
from photon_ml_tpu_torch.optimization.solver import solve_glm
from photon_ml_tpu_torch.types import TaskType

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainedGLM:
    reg_weight: float
    model: GeneralizedLinearModel
    result: OptimizerResult
    # Populated when training ran with track_models=True
    # (reference: ml/supervised/model/ModelTracker.scala).
    tracker: Optional[ModelTracker] = None


def device_batch(features, labels, offsets=None, weights=None,
                 dtype=torch.float32,
                 dense_threshold: float = DENSE_DENSITY_THRESHOLD,
                 storage_dtype=None, sparse_layout: str = "csr",
                 device="cuda") -> GLMBatch:
    """Host arrays -> GLMBatch on ``device``, dense or CSR by density.
    ``storage_dtype=torch.bfloat16`` stores dense features at half width
    (solver-type accumulation, see ops/features.DenseFeatures);
    ``sparse_layout`` is checked and mapped as features_to_device does."""
    dev = resolve_device(device)
    feats = features_to_device(features, dtype, dev, dense_threshold,
                               storage_dtype=storage_dtype,
                               sparse_layout=sparse_layout)

    def vec(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a), dtype=dtype, device=dev)

    return make_batch(feats, vec(labels), vec(offsets), vec(weights))


def train_glm_models(
    features,
    labels,
    task: TaskType,
    regularization_weights: Sequence[float],
    # L2 by default, matching the reference driver (ml/Params.scala:66-91) —
    # a NONE default would silently ignore the caller's λ grid.
    regularization_context: RegularizationContext = RegularizationContext(
        RegularizationType.L2),
    optimizer_type: OptimizerType = OptimizerType.LBFGS,
    max_iterations: int = 80,
    tolerance: float = 1e-6,
    offsets=None,
    weights=None,
    normalization: Optional[NormalizationContext] = None,
    lower_bounds=None,
    upper_bounds=None,
    warm_start: bool = True,
    compute_variances: bool = False,
    dtype=torch.float64,
    storage_dtype=None,
    initial_model: Optional[GeneralizedLinearModel] = None,
    track_models: bool = False,
    device="cuda",
) -> List[TrainedGLM]:
    """Train one GLM per λ, descending, warm-started, on ``device``.
    Returns grid order as given (the reference reports models keyed by
    λ). Variances are taken at the solve-space coefficients, before the
    means go back to the original space, as in JAX."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        logger.info("the λ grid's solves run eagerly, one host read an "
                    "iteration: one graph a solve is ROADMAP A3b")
    batch = device_batch(features, labels, offsets, weights, dtype=dtype,
                         storage_dtype=storage_dtype, device=dev)
    d = batch.features.num_features
    if normalization is not None:
        normalization = normalization.to(dev, dtype)
    objective = GLMObjective(loss_for_task(task), normalization)
    glm_cls = model_for_task(task)

    # Box constraints clamp the SOLVE-SPACE iterate — the reference's
    # semantics exactly: its optimization variable is the normalized-
    # space vector (effectiveCoefficients = coef :* factors inside the
    # aggregators, ValueAndGradientAggregator.scala:100-120) and
    # projectCoefficientsToHypercube clamps it against the raw
    # constraint values (LBFGS.scala:77).
    def bound(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a), dtype=dtype, device=dev)

    lb, ub = bound(lower_bounds), bound(upper_bounds)

    order = sorted(regularization_weights, reverse=True)
    coef = torch.zeros((d,), dtype=dtype, device=dev)
    if initial_model is not None:
        coef = torch.as_tensor(initial_model.coefficients.means).to(
            device=dev, dtype=dtype)
        if normalization is not None:
            coef = normalization.model_to_normalized_space(coef)

    by_weight: Dict[float, TrainedGLM] = {}
    for lam in order:
        config = GLMOptimizationConfiguration(
            max_iterations=max_iterations, tolerance=tolerance,
            regularization_weight=lam,
            optimizer_type=optimizer_type,
            regularization_context=regularization_context)
        result = solve_glm(objective, batch, config, coef, lb, ub,
                           track_coefficients=track_models)
        if warm_start:
            coef = result.x
        variances = None
        if compute_variances:
            l2 = regularization_context.l2_weight(lam)
            variances = objective.coefficient_variances(result.x, batch, l2)
        out_coef = result.x
        if normalization is not None:
            out_coef = normalization.model_to_original_space(out_coef)
        model = glm_cls(Coefficients(out_coef, variances))
        tracker = (ModelTracker.from_result(result, task, normalization)
                   if track_models else None)
        by_weight[lam] = TrainedGLM(lam, model, result, tracker)
        logger.info(
            "lambda=%g: value=%.6f iters=%d reason=%s", lam,
            float(result.value), int(result.iterations),
            result.reason_enum().summary)

    return [by_weight[lam] for lam in regularization_weights]
