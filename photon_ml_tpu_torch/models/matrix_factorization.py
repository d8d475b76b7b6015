"""Matrix-factorization model: score = rowFactor(row entity) .
colFactor(col entity) (port of photon_ml_tpu/models/matrix_factorization.py,
the whole file, for scoring; reference
ml/model/MatrixFactorizationModel.scala:32-179).

``random`` draws from a ``torch.Generator``, which cannot reproduce the
JAX package's ``jax.random`` factors: a model trained or drawn there
comes across through convert.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.utils.vocab import vocab_code_lookup

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MatrixFactorizationModel:
    row_effect_type: str  # id column naming the row entities (userId)
    col_effect_type: str  # id column naming the column entities (itemId)
    row_factors: Tensor  # [num_row_codes, k]
    col_factors: Tensor  # [num_col_codes, k]
    row_vocabulary: np.ndarray
    col_vocabulary: np.ndarray

    @property
    def num_latent_factors(self) -> int:
        return self.row_factors.shape[-1]

    def score(self, data) -> Tensor:
        """Per-row dot of the two entities' factors; an entity unknown to
        the model scores 0. On the factors' device."""
        # serving.kernels imports the models package: taken at call time.
        from photon_ml_tpu_torch.serving.kernels import score_mf

        dev = self.row_factors.device
        r = torch.as_tensor(self._codes(data, self.row_effect_type,
                                        self.row_vocabulary), device=dev)
        c = torch.as_tensor(self._codes(data, self.col_effect_type,
                                        self.col_vocabulary), device=dev)
        return score_mf(r, c, self.row_factors, self.col_factors,
                        self.row_factors.dtype)

    def score_numpy(self, data) -> np.ndarray:
        return self.score(data).detach().cpu().numpy()

    @staticmethod
    def _codes(data, effect_type, vocab) -> np.ndarray:
        col = data.id_columns[effect_type]
        return vocab_code_lookup(vocab, col.vocabulary)[col.codes]

    @classmethod
    def random(cls, row_effect_type, col_effect_type, row_vocab, col_vocab,
               num_factors: int, seed: int = 0, dtype=torch.float32,
               device="cuda") -> "MatrixFactorizationModel":
        """Factors N(0, 1/k) from a ``torch.Generator`` seeded ``seed``."""
        dev = resolve_device(device)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        scale = 1.0 / np.sqrt(num_factors)

        def draw(n):
            return (torch.randn((n, num_factors), generator=gen,
                                dtype=dtype) * scale).to(dev)

        return cls(row_effect_type, col_effect_type, draw(len(row_vocab)),
                   draw(len(col_vocab)), np.asarray(row_vocab),
                   np.asarray(col_vocab))
