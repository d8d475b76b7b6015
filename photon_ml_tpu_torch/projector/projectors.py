"""Feature-space projectors for random-effect coordinates (port of
photon_ml_tpu/projector/projectors.py, the whole file: IndexMapProjector
:46, ProjectionMatrix :81 with ``gaussian`` :90-120,
build_random_effect_projector :123; reference ml/projector/).

Numpy only, as in the JAX package, so a Gaussian projection drawn from
one seed is bit-equal in both packages.

- The index-map projector is a column gather: each entity's observed
  global columns become its local block columns (the inverse map is
  ``EntityBlock.feat_idx``, data/random_effect.py).
- The Gaussian projection is one dense ``[k1, d]`` matrix, applied at
  ingest, so RANDOM-projected training blocks are already latent-space;
  coefficients go back to the original space as ``gamma @ P``
  (models/random_effect.py).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Union

import numpy as np
import scipy.sparse as sp

RANDOM_SEED = 7  # reference: MathConst.RANDOM_SEED


@dataclasses.dataclass(frozen=True)
class IndexMapProjector:
    """Per-entity remap between global feature indices and a compact
    local space (ml/projector/IndexMapProjector.scala:42-106). ``cols``
    lists the global column of each local slot."""

    cols: np.ndarray  # [d_local]: local slot -> global column
    num_global_features: int

    @property
    def projected_space_dimension(self) -> int:
        return len(self.cols)

    @property
    def original_space_dimension(self) -> int:
        return self.num_global_features

    def project_features(self, x: Union[np.ndarray, sp.spmatrix]
                         ) -> np.ndarray:
        """Gather the observed columns: [n, d_global] -> [n, d_local]."""
        if sp.issparse(x):
            return np.asarray(x.tocsr()[:, self.cols].todense())
        return np.asarray(x)[:, self.cols]

    def project_coefficients(self, local: np.ndarray) -> np.ndarray:
        """Scatter local coefficients back to the global space."""
        out = np.zeros(self.num_global_features,
                       dtype=np.asarray(local).dtype)
        out[self.cols] = np.asarray(local)[: len(self.cols)]
        return out


@dataclasses.dataclass(frozen=True)
class ProjectionMatrix:
    """Dense projection [k1, d_global]: z = P x, back-projection P^T gamma
    (ml/projector/ProjectionMatrix.scala:47-62)."""

    matrix: np.ndarray  # float64 [k1, d_global]

    @property
    def projected_space_dimension(self) -> int:
        return self.matrix.shape[0]

    @property
    def original_space_dimension(self) -> int:
        return self.matrix.shape[1]

    def project_features(self, x: Union[np.ndarray, sp.spmatrix]
                         ) -> np.ndarray:
        """[n, d_global] -> [n, k1] (rows are feature vectors)."""
        if sp.issparse(x):
            return np.asarray(x @ self.matrix.T)
        return np.asarray(x) @ self.matrix.T

    def project_coefficients(self, latent: np.ndarray) -> np.ndarray:
        """Latent coefficients back to the original space: P^T gamma."""
        return self.matrix.T @ np.asarray(latent)

    @classmethod
    def gaussian(cls, projected_space_dimension: int,
                 original_space_dimension: int,
                 intercept_col: Optional[int] = None,
                 seed: int = RANDOM_SEED) -> "ProjectionMatrix":
        """Entries N(0, 1/k^2) (std 1/k, the reference's scaling,
        ProjectionMatrix.scala:96-110) clipped to [-1, 1]. With
        ``intercept_col`` that column is zeroed and a pass-through row is
        appended, so the intercept survives projection exactly."""
        k, d = projected_space_dimension, original_space_dimension
        rng = np.random.default_rng(seed)
        m = np.clip(rng.normal(0.0, 1.0, (k, d)) / k, -1.0, 1.0)
        if intercept_col is not None:
            m[:, intercept_col] = 0.0
            passthrough = np.zeros((1, d))
            passthrough[0, intercept_col] = 1.0
            m = np.vstack([m, passthrough])
        return cls(matrix=m)


def build_random_effect_projector(projector_type: str,
                                  num_global_features: int,
                                  intercept_col: Optional[int] = None,
                                  seed: int = RANDOM_SEED
                                  ) -> Optional[ProjectionMatrix]:
    """Projector selection (RandomEffectProjector.scala:54-66): None for
    INDEX_MAP and IDENTITY (the block packer's column gather), the shared
    Gaussian ProjectionMatrix for RANDOM=<k>."""
    t = projector_type.upper()
    if t in ("INDEX_MAP", "IDENTITY"):
        return None
    m = re.fullmatch(r"RANDOM[=_](\d+)", t)
    if m:
        return ProjectionMatrix.gaussian(
            int(m.group(1)), num_global_features, intercept_col, seed)
    raise ValueError(
        f"unknown projector type {projector_type!r}; expected INDEX_MAP, "
        "IDENTITY, or RANDOM=<projected dimension>")
