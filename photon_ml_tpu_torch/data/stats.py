"""Per-feature summary statistics (port of photon_ml_tpu/data/stats.py:
EmptyDatasetError :12, BasicStatisticalSummary.compute :25-74; reference
ml/stat/BasicStatistics.scala:36, BasicStatisticalSummary.scala:30-51,
which wrap Spark MLlib colStats). Host numpy, as there."""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


class EmptyDatasetError(ValueError):
    """``BasicStatisticalSummary.compute`` was handed a matrix with no
    rows: statistics over 0 rows are undefined, so it raises instead of
    returning all-NaN arrays."""

    def __init__(self, shape):
        super().__init__(
            f"cannot summarize an empty matrix (shape {tuple(shape)}): "
            "statistics over 0 rows are undefined")
        self.shape = tuple(shape)


@dataclasses.dataclass(frozen=True)
class BasicStatisticalSummary:
    mean: np.ndarray
    variance: np.ndarray
    count: int
    num_nonzeros: np.ndarray
    max: np.ndarray
    min: np.ndarray
    norm_l1: np.ndarray
    norm_l2: np.ndarray
    mean_abs: np.ndarray

    @classmethod
    def compute(cls, mat) -> "BasicStatisticalSummary":
        """From a scipy sparse or dense [n, d] matrix. Sparse zeros take
        part in mean/var/min/max as in MLlib colStats; the variance is
        the unbiased one."""
        n = mat.shape[0]
        if n == 0:
            raise EmptyDatasetError(mat.shape)
        if sp.issparse(mat):
            m = mat.tocsc()
            s1 = np.asarray(m.sum(axis=0)).ravel()
            s2 = np.asarray(m.multiply(m).sum(axis=0)).ravel()
            nnz = np.diff(m.indptr)
            mx = m.max(axis=0).toarray().ravel()
            mn = m.min(axis=0).toarray().ravel()
            # Columns with implicit zeros extend min/max to include 0.
            has_zero = nnz < n
            mx = np.where(has_zero, np.maximum(mx, 0.0), mx)
            mn = np.where(has_zero, np.minimum(mn, 0.0), mn)
            l1 = np.asarray(np.abs(m).sum(axis=0)).ravel()
        else:
            a = np.asarray(mat, np.float64)
            s1 = a.sum(axis=0)
            s2 = (a * a).sum(axis=0)
            nnz = (a != 0).sum(axis=0)
            mx = a.max(axis=0)
            mn = a.min(axis=0)
            l1 = np.abs(a).sum(axis=0)
        mean = s1 / n
        var = (s2 - n * mean**2) / max(n - 1, 1)
        return cls(
            mean=mean, variance=np.maximum(var, 0.0), count=n,
            num_nonzeros=nnz.astype(np.int64), max=mx, min=mn,
            norm_l1=l1, norm_l2=np.sqrt(s2), mean_abs=l1 / n,
        )
