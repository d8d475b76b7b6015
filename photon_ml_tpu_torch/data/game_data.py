"""GameDataset: the host-side columnar container for GAME training data
(port of photon_ml_tpu/data/game_data.py: GameDataset :55, build :81,
fixed_effect_batch :114).

Row order is frozen at construction, so every score vector is a dense
``[n_rows]`` tensor indexed by row position (the reference's
RDD[(uid, GameDatum)], ml/data/GameDatum.scala:33-59). Feature shards are
named scipy CSR matrices; each random-effect type is an integer-coded id
column with its vocabulary kept on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.data.device_feed import chunked_device_put
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops.features import (
    DENSE_DENSITY_THRESHOLD,
    features_to_device,
)
from photon_ml_tpu_torch.ops.glm_objective import GLMBatch


@dataclasses.dataclass
class EntityIdColumn:
    """Integer-coded entity ids for one random-effect type."""

    codes: np.ndarray  # int32[n_rows]
    vocabulary: np.ndarray  # entity name per code


def group_rows_by_code(codes: np.ndarray) -> list:
    """Row indices grouped by code value (stable order within groups)."""
    order = np.argsort(codes, kind="stable")
    bounds = np.flatnonzero(np.diff(codes[order])) + 1
    return np.split(order, bounds)


@dataclasses.dataclass
class GameDataset:
    """Columnar GAME data, one row per example (host numpy/scipy)."""

    responses: np.ndarray
    offsets: np.ndarray
    weights: np.ndarray
    feature_shards: Dict[str, sp.csr_matrix]
    id_columns: Dict[str, EntityIdColumn]
    uids: Optional[np.ndarray] = None

    def __post_init__(self):
        n = len(self.responses)
        for name, mat in self.feature_shards.items():
            if mat.shape[0] != n:
                raise ValueError(
                    f"feature shard {name!r} has {mat.shape[0]} rows, "
                    f"expected {n}")
        for name, col in self.id_columns.items():
            if len(col.codes) != n:
                raise ValueError(
                    f"id column {name!r} has {len(col.codes)} rows, "
                    f"expected {n}")

    @property
    def num_rows(self) -> int:
        return len(self.responses)

    @classmethod
    def build(cls, responses, feature_shards: Dict[str, sp.spmatrix],
              ids: Optional[Dict[str, np.ndarray]] = None, offsets=None,
              weights=None, uids=None) -> "GameDataset":
        """Build from raw columns; string entity ids are integer-coded
        here (ml/data/GameConverters.scala:27-172)."""
        responses = np.asarray(responses, np.float64)
        n = len(responses)
        offsets = (np.zeros(n) if offsets is None
                   else np.asarray(offsets, np.float64))
        weights = (np.ones(n) if weights is None
                   else np.asarray(weights, np.float64))
        id_columns = {}
        for name, raw in (ids or {}).items():
            vocab, codes = np.unique(np.asarray(raw), return_inverse=True)
            id_columns[name] = EntityIdColumn(codes.astype(np.int32), vocab)
        return cls(
            responses=responses, offsets=offsets, weights=weights,
            feature_shards={k: sp.csr_matrix(v)
                            for k, v in feature_shards.items()},
            id_columns=id_columns, uids=uids)

    def fixed_effect_batch(
        self, shard_id: str, dtype=torch.float32, device="cuda",
        extra_offsets: Optional[np.ndarray] = None,
        dense_threshold: float = DENSE_DENSITY_THRESHOLD,
    ) -> GLMBatch:
        """One feature shard as a device GLMBatch
        (ml/data/FixedEffectDataSet.scala:29-103). The columns ride the
        chunked uploader, as in JAX (an ``h2d`` span each)."""
        dev = resolve_device(device)
        feats = features_to_device(self.feature_shards[shard_id], dtype,
                                   dev, dense_threshold)
        off = (self.offsets if extra_offsets is None
               else self.offsets + extra_offsets)

        def col(a):
            return chunked_device_put(a, dtype, dev)

        return GLMBatch(features=feats, labels=col(self.responses),
                        offsets=col(off), weights=col(self.weights))

    def subset(self, rows: np.ndarray) -> "GameDataset":
        """Row-sliced view (validation splits and tests)."""
        return GameDataset(
            responses=self.responses[rows],
            offsets=self.offsets[rows],
            weights=self.weights[rows],
            feature_shards={k: m[rows]
                            for k, m in self.feature_shards.items()},
            id_columns={k: EntityIdColumn(c.codes[rows], c.vocabulary)
                        for k, c in self.id_columns.items()},
            uids=None if self.uids is None else self.uids[rows])
