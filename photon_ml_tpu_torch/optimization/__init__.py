"""Optimizers (port of photon_ml_tpu/optimization/; see each module's
docstring): L-BFGS, OWL-QN, TRON and damped Newton as device loops, and
the configuration vocabulary. The exports are the JAX package's."""

from photon_ml_tpu_torch.optimization.convergence import (
    ConvergenceReason,
    OptimizerResult,
    SolverDivergedError,
)
from photon_ml_tpu_torch.optimization.lbfgs import minimize_lbfgs
from photon_ml_tpu_torch.optimization.newton import minimize_newton
from photon_ml_tpu_torch.optimization.owlqn import minimize_owlqn
from photon_ml_tpu_torch.optimization.tron import minimize_tron
from photon_ml_tpu_torch.optimization.config import (
    OptimizerType,
    RegularizationType,
    OptimizerConfig,
    RegularizationContext,
    GLMOptimizationConfiguration,
    MFOptimizationConfiguration,
)

__all__ = [
    "ConvergenceReason",
    "OptimizerResult",
    "SolverDivergedError",
    "minimize_lbfgs",
    "minimize_newton",
    "minimize_owlqn",
    "minimize_tron",
    "OptimizerType",
    "RegularizationType",
    "OptimizerConfig",
    "RegularizationContext",
    "GLMOptimizationConfiguration",
    "MFOptimizationConfiguration",
]
