"""Device-side GAME model scoring over a GameDataset (port of
photon_ml_tpu/models/device_scoring.py: DeviceGameScorer :87-150 and
:187-191, fixed, random-effect (projected and factored too),
matrix-factorization and loaded random-effect snapshot sub-models).

The dataset's feature shards and entity-code columns are uploaded once at
construction; every scoring of an updated model then reuses them. Used by
coordinate descent's per-iteration validation and by the batch scoring
driver. A loaded snapshot (io/model_io.RandomEffectModelSnapshot) scores
as the ``random_matrix`` kind: its entity matrix is densified on the
host and uploaded at each scoring, and one past the densification
ceiling raises UnsupportedSubModelError at construction. A sub-model of
any other type raises it too: nothing here scores on the host.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.data.device_feed import chunked_device_put
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.models.fixed_effect import FixedEffectModel
from photon_ml_tpu_torch.models.factored_random_effect import (
    FactoredRandomEffectModel,
)
from photon_ml_tpu_torch.models.game_model import GameModel
from photon_ml_tpu_torch.models.matrix_factorization import (
    MatrixFactorizationModel,
)
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.ops.features import features_to_device
from photon_ml_tpu_torch.serving import kernels
from photon_ml_tpu_torch.utils.vocab import vocab_code_lookup

Tensor = torch.Tensor


def _mapped_codes(data: GameDataset, effect_type: str,
                  model_vocab: np.ndarray) -> np.ndarray:
    """The dataset's per-row entity codes in a model's vocabulary
    (-1 = unknown to the model)."""
    col = data.id_columns[effect_type]
    return vocab_code_lookup(model_vocab, col.vocabulary)[col.codes]


class DeviceGameScorer:
    """Scores GameModels sharing one structure on a fixed GameDataset."""

    def __init__(self, model: GameModel, data: GameDataset,
                 dtype=torch.float32, device="cuda"):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.num_rows = data.num_rows
        self._kinds: List[Tuple[str, str]] = []
        self._sdata = []
        dev = self.device
        for name, m in model.models.items():
            if isinstance(m, FixedEffectModel):
                feats = features_to_device(
                    data.feature_shards[m.feature_shard_id], dtype, dev)
                self._kinds.append((name, "fixed"))
                self._sdata.append((feats,))
            elif isinstance(m, (RandomEffectModel,
                                FactoredRandomEffectModel)):
                if isinstance(m, FactoredRandomEffectModel):
                    m = m.latent
                feats = features_to_device(
                    data.feature_shards[m.feature_shard_id], dtype, dev)
                mapped = torch.as_tensor(_mapped_codes(
                    data, m.random_effect_type, m.vocabulary), device=dev)
                block_static = tuple(
                    (torch.as_tensor(np.asarray(codes, np.int64),
                                     device=dev), fidx.to(dev))
                    for codes, fidx in zip(m.entity_codes, m.feat_idx))
                self._kinds.append((name, "random"))
                self._sdata.append((feats, mapped, block_static,
                                    len(m.vocabulary),
                                    m.num_global_features))
            elif isinstance(m, MatrixFactorizationModel):
                self._kinds.append((name, "mf"))
                self._sdata.append(tuple(
                    torch.as_tensor(_mapped_codes(data, t, v), device=dev)
                    for t, v in ((m.row_effect_type, m.row_vocabulary),
                                 (m.col_effect_type, m.col_vocabulary))))
            elif kernels.is_re_snapshot(m):
                # Checked here, so an oversize snapshot fails before any
                # scoring.
                kernels.check_snapshot_densifiable(m, dtype)
                feats = features_to_device(
                    data.feature_shards[m.feature_shard_id], dtype, dev)
                mapped = torch.as_tensor(_mapped_codes(
                    data, m.random_effect_type, m.vocabulary), device=dev)
                self._kinds.append((name, "random_matrix"))
                self._sdata.append((feats, mapped))
            else:
                raise kernels.UnsupportedSubModelError(
                    f"coordinate {name!r}: cannot device-score "
                    f"{type(m).__name__}")

    def score(self, model: GameModel) -> Tensor:
        """Additive score over all sub-models, on the device."""
        total = torch.zeros((self.num_rows,), dtype=self.dtype,
                            device=self.device)
        for (name, kind), sdata in zip(self._kinds, self._sdata):
            m = model.models[name]
            if kind == "fixed":
                total = total + kernels.score_fixed(
                    sdata[0], m.glm.coefficients.means.to(self.device),
                    self.dtype)
            elif kind == "mf":
                total = total + kernels.score_mf(
                    *sdata, m.row_factors.to(self.device),
                    m.col_factors.to(self.device), self.dtype)
            elif kind == "random_matrix":
                M = chunked_device_put(
                    kernels.snapshot_dense_matrix(m, self.dtype),
                    self.dtype, self.device)
                total = total + kernels.score_random_with_matrix(*sdata, M)
            else:
                feats, mapped, block_static, n_codes, d_global = sdata
                if isinstance(m, FactoredRandomEffectModel):
                    m = m.latent
                coefs = [c.to(self.device) for c in m.local_coefs]
                proj = (None if m.projection is None
                        else m.projection.to(self.device))
                total = total + kernels.score_random(
                    feats, mapped, block_static, coefs, proj, n_codes,
                    d_global, self.dtype)
        return total
