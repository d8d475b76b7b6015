"""Pointwise GLM losses: l(z, y), dl/dz, d2l/dz2 (port of
photon_ml_tpu/ops/losses.py:29-202).

Each loss is defined on the margin z = theta.x + offset and the label y
(reference: ml/function/glm/PointwiseLossFunction.scala:36-53,
ml/function/svm/SmoothedHingeLossFunction.scala:40-84). The functions are
elementwise torch ops, dtype-polymorphic (f32 on the card, f64 on the CPU
for parity tests). The same formulas are written out in double precision
in csrc/entity_lbfgs.cu; ``kernel_id`` selects them there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PointwiseLoss:
    """A pointwise loss: value, first and second derivative w.r.t. the
    margin. ``d2`` is zero for the once-differentiable smoothed hinge
    (ml/function/TwiceDiffFunction.scala:25-51). ``kernel_id`` is the
    loss's case in csrc/entity_lbfgs.cu."""

    name: str
    loss: Callable[[Tensor, Tensor], Tensor]
    d1: Callable[[Tensor, Tensor], Tensor]
    d2: Callable[[Tensor, Tensor], Tensor]
    kernel_id: int
    twice_differentiable: bool = True


def _log1p_exp_value(z: Tensor) -> Tensor:
    return torch.clamp_min(z, 0.0) + torch.log1p(torch.exp(-torch.abs(z)))


class _Log1pExp(torch.autograd.Function):
    """log(1 + exp(z)) with its derivative written out, sigmoid(z), as
    jnp.logaddexp's custom JVP does: differentiating the max/abs form
    gives 1 for the first derivative and 0 for the second at z = 0."""

    generate_vmap_rule = True

    @staticmethod
    def forward(z):
        return _log1p_exp_value(z)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def backward(ctx, grad):
        (z,) = ctx.saved_tensors
        return grad * torch.sigmoid(z)

    @staticmethod
    def jvp(ctx, z_t):
        (z,) = ctx.saved_tensors
        return z_t * torch.sigmoid(z)


def _log1p_exp(z: Tensor) -> Tensor:
    """Numerically stable log(1 + exp(z)) = max(z, 0) + log1p(exp(-|z|)),
    the logaddexp(0, z) form of the reference's Utils.log1pExp
    (ml/function/glm/LogisticLossFunction.scala:68-87). A ``z`` that
    requires grad (autograd, and ``torch.func``'s grad, jacrev and
    hessian, as optimization/newton.py uses them) goes through
    ``_Log1pExp`` for JAX's derivatives; any other runs the same ops
    directly, since ``Function.apply`` costs the eager solvers host time
    (``dev_scripts/loss_host_cost.py`` on the CPU, one thread: 45 against
    18 us a call at 64 entries; an eager L-BFGS solve at 200 x 8, 5.4
    against 4.2 ms)."""
    if z.requires_grad:
        return _Log1pExp.apply(z)
    return _log1p_exp_value(z)


# Logistic loss, y in {0, 1}:  l = log(1 + e^z) - y z

def _logistic_loss(z: Tensor, y: Tensor) -> Tensor:
    return _log1p_exp(z) - y * z


def _logistic_d1(z: Tensor, y: Tensor) -> Tensor:
    return torch.sigmoid(z) - y


def _logistic_d2(z: Tensor, y: Tensor) -> Tensor:
    s = torch.sigmoid(z)
    return s * (1.0 - s)


LogisticLoss = PointwiseLoss(
    name="logisticLoss", loss=_logistic_loss, d1=_logistic_d1,
    d2=_logistic_d2, kernel_id=0)


# Squared loss:  l = (z - y)^2 / 2   (ml/function/glm/SquaredLossFunction.scala)

def _squared_loss(z: Tensor, y: Tensor) -> Tensor:
    d = z - y
    return 0.5 * d * d


def _squared_d1(z: Tensor, y: Tensor) -> Tensor:
    return z - y


def _squared_d2(z: Tensor, y: Tensor) -> Tensor:
    return torch.ones_like(z)


SquaredLoss = PointwiseLoss(
    name="squaredLoss", loss=_squared_loss, d1=_squared_d1, d2=_squared_d2,
    kernel_id=1)


# Poisson loss:  l = e^z - y z   (ml/function/glm/PoissonLossFunction.scala)

def _poisson_loss(z: Tensor, y: Tensor) -> Tensor:
    return torch.exp(z) - y * z


def _poisson_d1(z: Tensor, y: Tensor) -> Tensor:
    return torch.exp(z) - y


def _poisson_d2(z: Tensor, y: Tensor) -> Tensor:
    return torch.exp(z)


PoissonLoss = PointwiseLoss(
    name="poissonLoss", loss=_poisson_loss, d1=_poisson_d1, d2=_poisson_d2,
    kernel_id=2)


# Rennie smoothed hinge, y in {0, 1} mapped to t = (2y-1) z:
#   l = 1/2 - t        if t <= 0
#       (1 - t)^2 / 2  if 0 < t < 1
#       0              if t >= 1
# Once-differentiable only (ml/function/svm/SmoothedHingeLossFunction.scala:40-84).

def _smoothed_hinge_loss(z: Tensor, y: Tensor) -> Tensor:
    yy = 2.0 * y - 1.0
    t = yy * z
    return torch.where(
        t <= 0.0, 0.5 - t,
        torch.where(t < 1.0, 0.5 * (1.0 - t) * (1.0 - t),
                    torch.zeros_like(t)))


def _smoothed_hinge_d1(z: Tensor, y: Tensor) -> Tensor:
    yy = 2.0 * y - 1.0
    t = yy * z
    dt = torch.where(
        t <= 0.0, -torch.ones_like(t),
        torch.where(t < 1.0, t - 1.0, torch.zeros_like(t)))
    return dt * yy


def _smoothed_hinge_d2(z: Tensor, y: Tensor) -> Tensor:
    # The reference treats this loss as once-differentiable only, so the
    # Gauss-Newton weight is exposed as zeros to keep TRON off it.
    return torch.zeros_like(z)


SmoothedHingeLoss = PointwiseLoss(
    name="smoothedHingeLoss", loss=_smoothed_hinge_loss,
    d1=_smoothed_hinge_d1, d2=_smoothed_hinge_d2, kernel_id=3,
    twice_differentiable=False)


_TASK_LOSSES = {
    TaskType.LOGISTIC_REGRESSION: LogisticLoss,
    TaskType.LINEAR_REGRESSION: SquaredLoss,
    TaskType.POISSON_REGRESSION: PoissonLoss,
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: SmoothedHingeLoss,
}

_LOSSES_BY_NAME = {
    loss.name: loss
    for loss in (LogisticLoss, SquaredLoss, PoissonLoss, SmoothedHingeLoss)
}


def loss_for_task(task: TaskType) -> PointwiseLoss:
    """The canonical pointwise loss for a task type."""
    return _TASK_LOSSES[task]


def loss_by_name(name: str) -> PointwiseLoss:
    return _LOSSES_BY_NAME[name]
