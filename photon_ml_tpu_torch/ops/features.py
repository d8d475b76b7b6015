"""Device-resident feature matrices (port of photon_ml_tpu/ops/features.py:
DenseFeatures :33, CSRFeatures :106, KroneckerFeatures :177-228,
features_to_device :1002).

- ``DenseFeatures``: dense ``[n_rows, n_features]``; products are
  ``torch.matmul``.
- ``CSRFeatures``: ``torch.sparse_csr`` (cuSPARSE on the card) for the
  margins, plus the CSR of the transpose for the gradient product. The
  JAX package leaves both products to XLA, outside any Pallas kernel, so
  a library product is the port of them.
- ``KroneckerFeatures``: the lazy row-wise Kronecker product x_i (x)
  gamma_i of a factored random effect's projection-matrix refit; each
  product is one contraction and the ``[n, k d]`` matrix is never built.

The dense/sparse choice by density is the JAX package's; its
TPU-specific ELL layouts (features.py:233-930) are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DenseFeatures:
    """Dense feature matrix x: [n_rows, n_features]."""

    x: Tensor

    def matvec(self, v: Tensor) -> Tensor:
        """x @ v -> [n_rows]."""
        return torch.matmul(self.x, v)

    def rmatvec(self, u: Tensor) -> Tensor:
        """x.T @ u -> [n_features]."""
        return torch.matmul(u, self.x)


@dataclasses.dataclass(frozen=True)
class CSRFeatures:
    """Sparse feature matrix as CSR (``csr``) plus the CSR of its
    transpose (``csr_t``), so both products are row-major sparse
    matrix-vector products. ``row_ids``/``col_ids``/``values`` are the
    expanded-CSR triplet the random-effect scorer gathers through."""

    csr: Tensor
    csr_t: Tensor
    values: Tensor
    col_ids: Tensor
    row_ids: Tensor
    n_rows: int
    n_features: int

    def matvec(self, v: Tensor) -> Tensor:
        return torch.mv(self.csr, v)

    def rmatvec(self, u: Tensor) -> Tensor:
        return torch.mv(self.csr_t, u)


@dataclasses.dataclass(frozen=True)
class KroneckerFeatures:
    """Virtual row i = vec(gamma_i (x) x_i): the features of the refit of
    B [k, d] (FactoredRandomEffectCoordinate.scala:269-287 materializes
    them per datum). Coefficient index (a, j) is a * d + j, the
    ``B.reshape(-1)`` of a [k, d] matrix."""

    x: Tensor  # [n, d]
    gamma: Tensor  # [n, k]

    @property
    def shape(self):
        return (self.x.shape[0], self.num_features)

    @property
    def num_features(self) -> int:
        return self.gamma.shape[-1] * self.x.shape[-1]

    def _as_matrix(self, v: Tensor) -> Tensor:
        return v.reshape(self.gamma.shape[-1], self.x.shape[-1])

    def matvec(self, v: Tensor) -> Tensor:
        """margin_i = gamma_i^T B x_i."""
        return torch.einsum("nd,kd,nk->n", self.x, self._as_matrix(v),
                            self.gamma)

    def rmatvec(self, u: Tensor) -> Tensor:
        """sum_i u_i gamma_i x_i^T, flattened."""
        return torch.einsum("n,nk,nd->kd", u, self.gamma,
                            self.x).reshape(-1)

    def row_sq_matvec(self, v: Tensor) -> Tensor:
        return torch.einsum("nd,kd,nk->n", self.x * self.x,
                            self._as_matrix(v), self.gamma * self.gamma)

    def sq_rmatvec(self, u: Tensor) -> Tensor:
        return torch.einsum("n,nk,nd->kd", u, self.gamma * self.gamma,
                            self.x * self.x).reshape(-1)


FeatureMatrix = Union[DenseFeatures, CSRFeatures, KroneckerFeatures]


def _csr_tensor(mat: sp.csr_matrix, dtype, device) -> Tensor:
    mat = mat.tocsr()
    mat.sort_indices()
    return torch.sparse_csr_tensor(
        torch.as_tensor(mat.indptr, dtype=torch.int64),
        torch.as_tensor(mat.indices, dtype=torch.int64),
        torch.as_tensor(mat.data, dtype=dtype),
        size=mat.shape, device=device, check_invariants=True)


def csr_from_scipy(mat, dtype=torch.float32, device="cuda") -> CSRFeatures:
    dev = resolve_device(device)
    csr = sp.csr_matrix(mat)
    csr.sort_indices()
    rows = np.repeat(np.arange(csr.shape[0], dtype=np.int64),
                     np.diff(csr.indptr))
    return CSRFeatures(
        csr=_csr_tensor(csr, dtype, dev),
        csr_t=_csr_tensor(csr.T.tocsr(), dtype, dev),
        values=torch.as_tensor(csr.data, dtype=dtype, device=dev),
        col_ids=torch.as_tensor(csr.indices.astype(np.int64), device=dev),
        row_ids=torch.as_tensor(rows, device=dev),
        n_rows=int(csr.shape[0]), n_features=int(csr.shape[1]))


DENSE_DENSITY_THRESHOLD = 0.2


def features_to_device(mat, dtype=torch.float32, device="cuda",
                       dense_threshold: float = DENSE_DENSITY_THRESHOLD
                       ) -> FeatureMatrix:
    """Host feature matrix -> device layout, dense at or above
    ``dense_threshold`` density, CSR below it (features.py:1002)."""
    dev = resolve_device(device)
    if sp.issparse(mat):
        density = mat.nnz / max(1, mat.shape[0] * mat.shape[1])
        if density < dense_threshold:
            return csr_from_scipy(mat, dtype, dev)
        mat = mat.toarray()
    return DenseFeatures(torch.as_tensor(np.asarray(mat), dtype=dtype,
                                         device=dev))
