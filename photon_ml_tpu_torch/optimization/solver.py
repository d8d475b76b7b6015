"""Solver dispatch (port of photon_ml_tpu/optimization/solver.py:32-94).

TRON for twice-differentiable objectives without L1, OWL-QN whenever the
L1 weight is positive, the margin-cached GLM L-BFGS otherwise (reference
ml/optimization/OptimizerFactory.scala). The L2 part always rides inside
the objective; L1 is OWL-QN's orthant machinery. Box constraints go to
TRON's projected variant, or to the generic projected L-BFGS (they break
the margin cache); with L1 they raise ``ValueError``.
"""

from __future__ import annotations

from typing import Optional

import torch

from photon_ml_tpu_torch.ops.glm_objective import GLMBatch, GLMObjective
from photon_ml_tpu_torch.optimization.config import (
    GLMOptimizationConfiguration,
    OptimizerType,
)
from photon_ml_tpu_torch.optimization.convergence import OptimizerResult
from photon_ml_tpu_torch.optimization.glm_lbfgs import minimize_lbfgs_glm
from photon_ml_tpu_torch.optimization.lbfgs import minimize_lbfgs
from photon_ml_tpu_torch.optimization.owlqn import minimize_owlqn
from photon_ml_tpu_torch.optimization.tron import minimize_tron

Tensor = torch.Tensor


def solve_glm(
    objective: GLMObjective,
    batch: GLMBatch,
    config: GLMOptimizationConfiguration,
    coef0: Tensor,
    lower_bounds: Optional[Tensor] = None,
    upper_bounds: Optional[Tensor] = None,
    track_coefficients: bool = False,
) -> OptimizerResult:
    """One GLM solve, routed as the JAX ``solve_glm`` routes it.
    ``lower_bounds``/``upper_bounds`` ([d], either may be None) clamp the
    solve-space coefficients; ``track_coefficients`` fills the result's
    ``coef_history``."""
    bounded = lower_bounds is not None or upper_bounds is not None
    l1, l2 = config.l1_weight, config.l2_weight
    if config.optimizer_type == OptimizerType.TRON:
        if not objective.loss.twice_differentiable:
            raise ValueError(
                f"TRON requires a twice-differentiable loss, got "
                f"{objective.loss.name}")
        if l1 > 0:
            raise ValueError("TRON does not support L1 regularization")
        return minimize_tron(
            objective.value_and_grad, coef0, args=(batch, l2),
            max_iter=config.max_iterations, tol=config.tolerance,
            lower_bounds=lower_bounds, upper_bounds=upper_bounds,
            make_hvp=objective.make_tron_hvp,
            track_coefficients=track_coefficients)
    if l1 > 0:
        if bounded:
            raise ValueError(
                "box constraints with L1 regularization are not supported")
        return minimize_owlqn(
            objective.value_and_grad, coef0, args=(batch, l2), l1_weight=l1,
            max_iter=config.max_iterations, tol=config.tolerance,
            track_coefficients=track_coefficients)
    if not bounded:
        return minimize_lbfgs_glm(
            objective, batch, coef0, l2,
            max_iter=config.max_iterations, tol=config.tolerance,
            track_coefficients=track_coefficients)
    return minimize_lbfgs(
        objective.value_and_grad, coef0, args=(batch, l2),
        max_iter=config.max_iterations, tol=config.tolerance,
        lower_bounds=lower_bounds, upper_bounds=upper_bounds,
        track_coefficients=track_coefficients)
