"""The GLM objective in closed form (port of photon_ml_tpu/ops/
glm_objective.py: GLMBatch :41, GLMObjective :84, margins :108,
_jt_product :152, curvature_from_margins :174,
hessian_vector_from_margins :181, make_tron_hvp :191,
hessian_diagonal :218-247, coefficient_variances :249-257).

    f(c) = sum_i w_i l(z_i, y_i) + l2/2 ||c||^2
    z    = X (c * factor) + offsets - (c * factor) . shift
    g(c) = J^T (w * l'(z, y)) + l2 c,  J^T u = (X^T u - sum(u) shift) * factor
    H v  = J^T (w l''(z, y) * J v) + l2 v

The normalization (data/normalization.py) is algebra on the coefficients,
so CSR features stay sparse and x' is never materialized. The JAX
package differentiates ``value`` automatically; the port writes the
gradient out, which is the same function.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.data.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.features import FeatureMatrix
from photon_ml_tpu_torch.ops.losses import PointwiseLoss

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GLMBatch:
    """Struct-of-arrays training shard on the device. Rows with weight 0
    are inert in every sum (padding and down-sampling)."""

    features: FeatureMatrix
    labels: Tensor  # [n]
    offsets: Tensor  # [n]
    weights: Tensor  # [n]

    def with_offsets(self, offsets: Tensor) -> "GLMBatch":
        return GLMBatch(self.features, self.labels, offsets, self.weights)


def make_batch(features, labels, offsets=None, weights=None) -> GLMBatch:
    labels = torch.as_tensor(labels)
    if offsets is None:
        offsets = torch.zeros_like(labels)
    if weights is None:
        weights = torch.ones_like(labels)
    return GLMBatch(features, labels, torch.as_tensor(offsets),
                    torch.as_tensor(weights))


@dataclasses.dataclass(frozen=True, eq=False)
class GLMObjective:
    """value(coef) = sum_i w_i * l(margin_i, y_i) + l2/2 ||coef||^2.
    L2 applies to all coefficients, the intercept included, in the
    (normalized) optimization space (ml/function/L2Regularization.scala:75).
    """

    loss: PointwiseLoss
    normalization: Optional[NormalizationContext] = None

    def margins(self, coef: Tensor, batch: GLMBatch) -> Tensor:
        norm = self.normalization
        if norm is None:
            return batch.features.matvec(coef) + batch.offsets
        eff = norm.effective_coefficients(coef)
        return (batch.features.matvec(eff) + batch.offsets
                + norm.margin_shift(coef))

    def value(self, coef: Tensor, batch: GLMBatch, l2_weight=0.0) -> Tensor:
        z = self.margins(coef, batch)
        return self.value_from_margins(z, torch.dot(coef, coef), batch,
                                       l2_weight)

    def value_and_grad(self, coef: Tensor, batch: GLMBatch, l2_weight=0.0):
        """(value, gradient) from one margin pass."""
        z = self.margins(coef, batch)
        return (self.value_from_margins(z, torch.dot(coef, coef), batch,
                                        l2_weight),
                self.gradient_from_margins(coef, z, batch, l2_weight))

    def gradient(self, coef: Tensor, batch: GLMBatch,
                 l2_weight=0.0) -> Tensor:
        return self.gradient_from_margins(
            coef, self.margins(coef, batch), batch, l2_weight)

    def margin_direction(self, direction: Tensor, batch: GLMBatch) -> Tensor:
        """Directional margins: margins(c + t d) = margins(c) + t * this.
        Written (X d + offsets) - offsets, as the JAX package does."""
        return self.margins(direction, batch) - batch.offsets

    def value_from_margins(self, z: Tensor, coef_sq_norm, batch: GLMBatch,
                           l2_weight) -> Tensor:
        """Objective value given precomputed margins."""
        return (torch.sum(batch.weights * self.loss.loss(z, batch.labels))
                + 0.5 * l2_weight * coef_sq_norm)

    def _jt_product(self, u: Tensor, batch: GLMBatch) -> Tensor:
        """J^T u with J = dz/dcoef: the normalization chain rule shared by
        the gradient and the Hessian-vector product, in the JAX order of
        operations (ValueAndGradientAggregator.scala:133-154)."""
        r = batch.features.rmatvec(u)
        norm = self.normalization
        if norm is not None:
            if norm.shifts is not None:
                r = r - torch.sum(u) * norm.shifts
            if norm.factors is not None:
                r = r * norm.factors
        return r

    def gradient_from_margins(self, coef: Tensor, z: Tensor,
                              batch: GLMBatch, l2_weight=0.0) -> Tensor:
        """J^T (w * l'(z, y)) + l2 * coef: one feature contraction."""
        u = batch.weights * self.loss.d1(z, batch.labels)
        return self._jt_product(u, batch) + l2_weight * coef

    def curvature_from_margins(self, z: Tensor, batch: GLMBatch) -> Tensor:
        """d2_i = w_i l''(z_i, y_i): the Gauss-Newton curvature weights,
        computed once per TRON outer iteration."""
        return batch.weights * self.loss.d2(z, batch.labels)

    def hessian_vector_from_margins(self, vec: Tensor, d2: Tensor,
                                    batch: GLMBatch, l2_weight=0.0
                                    ) -> Tensor:
        """H @ vec with precomputed curvature weights: one matvec and one
        rmatvec (J v is the directional margin)."""
        jv = self.margin_direction(vec, batch)
        return self._jt_product(d2 * jv, batch) + l2_weight * vec

    def make_tron_hvp(self, x: Tensor, batch: GLMBatch, l2_weight=0.0):
        """Hessian-vector factory for minimize_tron's ``make_hvp`` hook:
        margins and curvature once per outer iteration, then one matvec
        and one rmatvec per CG step."""
        d2 = self.curvature_from_margins(self.margins(x, batch), batch)
        return lambda v: self.hessian_vector_from_margins(v, d2, batch,
                                                          l2_weight)

    def hessian_diagonal(self, coef: Tensor, batch: GLMBatch,
                         l2_weight=0.0) -> Tensor:
        """diag(H) = sum_i w_i l''(z_i) x'_i^2 + l2, for coefficient
        variances (HessianDiagonalAggregator.calcHessianDiagonal). The
        normalized square x'_j^2 = factor_j^2 (x_j - shift_j)^2 expands
        into three aggregations, so sparse features stay sparse; factor^2
        and shift^2 are formed in the context's built type
        (NormalizationContext.square)."""
        d = self.curvature_from_margins(self.margins(coef, batch), batch)
        feats = batch.features
        out = feats.sq_rmatvec(d)  # sum d_i x_ij^2
        norm = self.normalization
        if norm is not None:
            shifts, factors = norm.shifts, norm.factors
            if shifts is not None:
                lin_sum = feats.rmatvec(d)  # sum d_i x_ij
                total = torch.sum(d)
                out = (out - 2.0 * shifts * lin_sum
                       + norm.square(shifts) * total)
            if factors is not None:
                out = norm.square(factors) * out
        return out + l2_weight

    def coefficient_variances(self, coef: Tensor, batch: GLMBatch,
                              l2_weight=0.0, epsilon: float = 1e-12
                              ) -> Tensor:
        """var = 1 / (diag(H) + eps) (GeneralizedLinearOptimizationProblem
        .scala:39-174, DistributedOptimizationProblem.scala:79-93)."""
        return 1.0 / (self.hessian_diagonal(coef, batch, l2_weight)
                      + epsilon)
