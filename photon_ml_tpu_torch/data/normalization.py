"""Feature normalization as algebra, never materialized on the data (port
of photon_ml_tpu/data/normalization.py: NormalizationContext :29-83,
no_normalization :84, gather_normalization :99-138,
gathered_to_normalized_space / gathered_to_original_space :141-161,
build_normalization_context :176-219; reference
ml/normalization/NormalizationContext.scala:38-83).

The solve runs in the normalized space x' = (x - shift) * factor without
rewriting the data: margins use effective coefficients eff = coef *
factor and a margin shift -eff . shift, so a CSR batch stays sparse.
Models live in the original space:

    w = w' * factor,  intercept -= w . shift   (to the original space)

The intercept column has factor 1 and shift 0. Factors and shifts are
stored as float32, as the JAX package stores them whatever its float
width, so both packages solve the same problem.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.types import NormalizationType

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    """factors/shifts over the feature axis (None = ones / zeros);
    ``intercept_id`` is the intercept column, or -1 if none."""

    factors: Optional[Tensor]
    shifts: Optional[Tensor]
    intercept_id: int = -1
    # The type the vectors were built in (float32 from
    # build_normalization_context), kept by ``to`` when it widens them: a
    # product of two context vectors (the Hessian diagonal's squares) is
    # formed there, as JAX, whose context stays float32, forms it.
    built_dtype: Optional[torch.dtype] = None

    def to(self, device, dtype=None) -> "NormalizationContext":
        """The same context with its vectors on ``device`` (and as
        ``dtype``: widening float32 is exact, and torch's products need
        both operands in one type where JAX promotes)."""
        def conv(a):
            return None if a is None else a.to(device=device, dtype=dtype)

        return NormalizationContext(conv(self.factors), conv(self.shifts),
                                    self.intercept_id, self.vector_dtype)

    @property
    def vector_dtype(self) -> Optional[torch.dtype]:
        """built_dtype, or the vectors' own type."""
        if self.built_dtype is not None:
            return self.built_dtype
        vec = self.factors if self.factors is not None else self.shifts
        return None if vec is None else vec.dtype

    def square(self, vec: Tensor) -> Tensor:
        """vec * vec for a context vector, formed in ``vector_dtype``."""
        v = vec.to(self.vector_dtype)
        return (v * v).to(vec.dtype)

    def effective_coefficients(self, coef: Tensor) -> Tensor:
        return coef * self.factors if self.factors is not None else coef

    def margin_shift(self, coef: Tensor) -> Tensor:
        if self.shifts is None:
            return torch.zeros((), dtype=coef.dtype, device=coef.device)
        return -(self.effective_coefficients(coef) @ self.shifts)

    def _require_intercept(self):
        if self.intercept_id < 0:
            raise ValueError(
                "Normalization with shifts requires an intercept column")

    def model_to_original_space(self, coef: Tensor) -> Tensor:
        """Coefficients trained in the normalized space -> raw space."""
        out = self.effective_coefficients(coef)
        if self.shifts is not None:
            self._require_intercept()
            out = out.clone()
            out[self.intercept_id] -= out @ self.shifts
        return out

    def model_to_normalized_space(self, coef: Tensor) -> Tensor:
        """Inverse of model_to_original_space (warm starts)."""
        out = coef
        if self.shifts is not None:
            self._require_intercept()
            out = out.clone()
            out[self.intercept_id] += out @ self.shifts
        if self.factors is not None:
            out = out / self.factors
        return out


def no_normalization() -> NormalizationContext:
    return NormalizationContext(factors=None, shifts=None, intercept_id=-1)


def gather_normalization(norm: NormalizationContext, feat_idx: Tensor
                         ) -> Tuple[Optional[Tensor], Optional[Tensor],
                                    Tensor]:
    """(factors, shifts, intercept_mask) gathered into a block's local
    feature space. ``feat_idx`` is int [E, d_local] with -1 for padding
    columns, which get factor 1 and shift 0 so they stay exactly zero
    through x' = (x - shift) * factor. The arrays land on ``feat_idx``'s
    device; ``intercept_mask`` is 1 at each entity's intercept column.
    With shifts, every entity that has data must hold the intercept."""
    dev = feat_idx.device
    safe = torch.clamp_min(feat_idx, 0).long()
    pad = feat_idx < 0

    factors = None
    if norm.factors is not None:
        fac = norm.factors.to(dev)
        factors = torch.where(pad, torch.ones((), dtype=fac.dtype,
                                              device=dev), fac[safe])
    shifts = None
    if norm.shifts is not None:
        if norm.intercept_id < 0:
            raise ValueError(
                "Normalization with shifts requires an intercept column")
        fi = feat_idx.cpu().numpy()
        # All-padding entities carry no data and zero coefficients.
        present = (fi == norm.intercept_id).any(axis=-1) | (fi < 0).all(
            axis=-1)
        if not present.all():
            raise ValueError(
                "Normalization with shifts requires the intercept column "
                f"(global id {norm.intercept_id}) in every entity's local "
                f"feature block; {int((~present).sum())} entities lack it "
                "- build the random-effect dataset with intercept_col set")
        shf = norm.shifts.to(dev)
        shifts = torch.where(pad, torch.zeros((), dtype=shf.dtype,
                                              device=dev), shf[safe])
    ref = factors if factors is not None else shifts
    mask = (feat_idx == norm.intercept_id).to(
        ref.dtype if ref is not None else torch.float32)
    return factors, shifts, mask


def gathered_to_normalized_space(coef: Tensor, factors: Optional[Tensor],
                                 shifts: Optional[Tensor],
                                 intercept_mask: Tensor) -> Tensor:
    """model_to_normalized_space with gathered [E, d] arrays: the
    intercept absorbs the shift dot, then divide by the factors."""
    out = coef
    if shifts is not None:
        dot = torch.sum(out * shifts, dim=-1, keepdim=True)
        out = out + intercept_mask * dot
    if factors is not None:
        out = out / factors
    return out


def gathered_to_original_space(coef: Tensor, factors: Optional[Tensor],
                               shifts: Optional[Tensor],
                               intercept_mask: Tensor) -> Tensor:
    """model_to_original_space with gathered [E, d] arrays:
    w = w' * factor, intercept -= w . shift."""
    out = coef * factors if factors is not None else coef
    if shifts is not None:
        dot = torch.sum(out * shifts, dim=-1, keepdim=True)
        out = out - intercept_mask * dot
    return out


def build_normalization_context(
    norm_type, summary, intercept_id: int = -1, device="cuda",
) -> NormalizationContext:
    """The four flavors of ml/normalization/NormalizationType.java:25-40
    from a BasicStatisticalSummary, as float32 vectors on ``device``."""
    nt = NormalizationType(norm_type)
    if nt == NormalizationType.NONE:
        return NormalizationContext(None, None, intercept_id)

    std = np.asarray(summary.variance) ** 0.5
    safe_std = np.where(std > 0, std, 1.0)
    max_mag = np.maximum(np.abs(np.asarray(summary.max)),
                         np.abs(np.asarray(summary.min)))
    safe_mag = np.where(max_mag > 0, max_mag, 1.0)

    factors = None
    shifts = None
    if nt == NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
        factors = 1.0 / safe_std
    elif nt == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
        factors = 1.0 / safe_mag
    elif nt == NormalizationType.STANDARDIZATION:
        factors = 1.0 / safe_std
        shifts = np.asarray(summary.mean).copy()
    if nt == NormalizationType.STANDARDIZATION and intercept_id < 0:
        raise ValueError("STANDARDIZATION requires an intercept column")

    # The intercept column stays untouched.
    if intercept_id >= 0:
        if factors is not None:
            factors = np.asarray(factors).copy()
            factors[intercept_id] = 1.0
        if shifts is not None:
            shifts[intercept_id] = 0.0

    dev = resolve_device(device)

    def to_tensor(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a, np.float32), device=dev)

    return NormalizationContext(to_tensor(factors), to_tensor(shifts),
                                intercept_id)
