"""Random-effect model: one small GLM per entity, stored as bucketed local
coefficient blocks (port of photon_ml_tpu/models/random_effect.py:28-133,
with the ``projection`` field :38, ``model_matrix`` :49-70 through
P^T gamma and ``to_entity_dict`` :82; reference ml/model/RandomEffectModel.scala:33-168,
RandomEffectModelInProjectedSpace.scala).

Per-entity coefficients live in each entity's local feature subspace
(the training blocks' ``feat_idx`` gathers), or, with a ``projection``
[k1, d_global], in a shared latent space whose global view is
gamma @ P; the global view is a host matrix used for persistence and
host scoring.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.utils.vocab import vocab_code_lookup

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RandomEffectModel:
    random_effect_type: str
    feature_shard_id: str
    local_coefs: List[Tensor]  # [E_b, d_pad] per bucket, local space
    feat_idx: List[Tensor]  # int32 [E_b, d_pad] per bucket, -1 = padding
    entity_codes: List[np.ndarray]  # [E_b] per bucket
    vocabulary: np.ndarray  # entity name per code
    num_global_features: int
    # Set when local_coefs live in a projected latent space (a RANDOM
    # projector's matrix, or a factored effect's learned B): [k1,
    # d_global] on the coefficients' device; feat_idx then holds latent
    # ids.
    projection: Optional[Tensor] = None

    @property
    def num_entities(self) -> int:
        return sum(len(c) for c in self.entity_codes)

    def with_coefs(self, local_coefs: List[Tensor]) -> "RandomEffectModel":
        return dataclasses.replace(self, local_coefs=list(local_coefs))

    def model_matrix(self) -> sp.csr_matrix:
        """CSR [num_codes, d_global]: row c = entity c's global
        coefficients (gamma @ P when projected); entities never trained are
        zero rows."""
        if self.projection is not None:
            p = self.projection.detach().cpu().numpy()
            dense = np.zeros((len(self.vocabulary), self.num_global_features))
            for coefs, codes in zip(self.local_coefs, self.entity_codes):
                c = coefs.detach().cpu().numpy()[:, :p.shape[0]]
                dense[np.asarray(codes)] = c @ p
            return sp.csr_matrix(dense)
        rows, cols, vals = [], [], []
        for coefs, fidx, codes in zip(self.local_coefs, self.feat_idx,
                                      self.entity_codes):
            c = coefs.detach().cpu().numpy()
            f = fidx.detach().cpu().numpy()
            nz = (f >= 0) & (c != 0)
            r_i, c_i = np.nonzero(nz)
            rows.append(np.asarray(codes)[r_i])
            cols.append(f[r_i, c_i])
            vals.append(c[r_i, c_i])

        def cat(parts, dt):
            return np.concatenate(parts) if parts else np.empty((0,), dt)

        return sp.csr_matrix(
            (cat(vals, np.float64), (cat(rows, np.int64),
                                     cat(cols, np.int64))),
            shape=(len(self.vocabulary), self.num_global_features))

    def to_entity_dict(self) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """entity name -> (global col indices, values), for persistence."""
        m = self.model_matrix().tocsr()
        return {str(name): (m.indices[m.indptr[code]:m.indptr[code + 1]],
                            m.data[m.indptr[code]:m.indptr[code + 1]])
                for code, name in enumerate(self.vocabulary)}

    def score_numpy(self, data) -> np.ndarray:
        """Host score x_i . coef[entity(i)]; unknown entities score 0."""
        mat = data.feature_shards[self.feature_shard_id].tocsr()
        col = data.id_columns[self.random_effect_type]
        m = self.model_matrix()
        mapped = vocab_code_lookup(self.vocabulary, col.vocabulary)[col.codes]
        valid = mapped >= 0
        scores = np.zeros(data.num_rows)
        if valid.any():
            rows = np.flatnonzero(valid)
            scores[rows] = np.asarray(
                mat[rows].multiply(m[mapped[valid]]).sum(axis=1)).ravel()
        return scores

    @classmethod
    def zeros_like_dataset(cls, ds, dtype=torch.float32
                           ) -> "RandomEffectModel":
        """Zero model matching a RandomEffectDataset's block structure,
        on the blocks' device."""
        return cls(
            random_effect_type=ds.config.random_effect_type,
            feature_shard_id=ds.config.feature_shard_id,
            local_coefs=[torch.zeros((b.num_entities, b.d_pad), dtype=dtype,
                                     device=b.device) for b in ds.blocks],
            feat_idx=[b.feat_idx for b in ds.blocks],
            entity_codes=list(ds.entity_codes),
            vocabulary=ds.vocabulary,
            num_global_features=ds.num_global_features,
            projection=(None if ds.projection is None else torch.as_tensor(
                ds.projection.matrix, dtype=dtype,
                device=ds.blocks[0].device if ds.blocks else None)),
        )
