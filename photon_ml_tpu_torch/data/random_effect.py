"""Random-effect datasets: per-entity problems as bucketed, padded dense
blocks (port of photon_ml_tpu/data/random_effect.py: EntityBlock :83,
RandomEffectDataset :125, filter_features_by_support :201,
build_random_effect_dataset :233-333 with the
RANDOM=<k> projector branch, _pack_block :336-375).

Entities are grouped by id on the host, capped by reservoir sampling,
restricted to their observed feature columns (the reference's
IndexMapProjector, ml/projector/IndexMapProjector.scala:42-106, as a
column gather; IDENTITY gathers every column), optionally Pearson-
filtered, and bucketed by padded (n_rows, n_features) size classes. Each
bucket is one dense ``[E, n_pad, d_pad]`` block. With RANDOM=<k> the
blocks live in the shared Gaussian latent space
(projector/projectors.py): the Pearson selection still runs first on the
global columns, then each entity's rows are projected through the one
matrix, and ``dataset.projection`` holds it. Bucket keys and every block
array are the JAX package's exactly: blocks are packed in float32 on the
host and then cast, as there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.data.game_data import (
    GameDataset,
    group_rows_by_code,
)
from photon_ml_tpu_torch.data.sampling import reservoir_sample
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.projector.projectors import (
    ProjectionMatrix,
    build_random_effect_projector,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RandomEffectDataConfiguration:
    """ml/data/RandomEffectDataConfiguration.scala:1-127."""

    random_effect_type: str  # which id column groups the rows
    feature_shard_id: str
    num_active_data_points: Optional[int] = None  # reservoir cap
    num_passive_data_points_lower_bound: Optional[int] = None
    num_features_to_samples_ratio: Optional[float] = None  # Pearson cap
    projector_type: str = "INDEX_MAP"  # INDEX_MAP | IDENTITY | RANDOM=<k>

    @classmethod
    def parse(cls, s: str) -> "RandomEffectDataConfiguration":
        """'reType,shardId,numPartitions,activeBound,passiveBound,ratio
        [,projector]' (numPartitions is accepted and ignored)."""
        p = [t.strip() for t in s.split(",")]
        if len(p) not in (6, 7):
            raise ValueError(
                "expected 'reType,shardId,numPartitions,activeBound,"
                f"passiveBound,ratio[,projector]', got {s!r}")

        def maybe(v, cast):
            return None if v.lower() in ("none", "-1", "") else cast(v)

        return cls(
            random_effect_type=p[0],
            feature_shard_id=p[1],
            num_active_data_points=maybe(p[3], int),
            num_passive_data_points_lower_bound=maybe(p[4], int),
            num_features_to_samples_ratio=maybe(p[5], float),
            projector_type=p[6].upper() if len(p) == 7 else "INDEX_MAP",
        )


@dataclasses.dataclass(frozen=True)
class EntityBlock:
    """One bucket of entities with identical padded shapes.

    Padding: rows carry weight 0 and row_id == n_rows (the scatter
    sentinel); local feature columns are all-zero with feat_idx == -1."""

    x: Tensor  # [E, n_pad, d_pad]
    labels: Tensor  # [E, n_pad]
    offsets: Tensor  # [E, n_pad]
    weights: Tensor  # [E, n_pad]
    row_ids: Tensor  # int32 [E, n_pad], == n_rows for padding
    feat_idx: Tensor  # int32 [E, d_pad], == -1 for padding

    @property
    def num_entities(self) -> int:
        return self.x.shape[0]

    @property
    def n_pad(self) -> int:
        return self.x.shape[1]

    @property
    def d_pad(self) -> int:
        return self.x.shape[2]

    @property
    def dtype(self) -> torch.dtype:
        return self.x.dtype

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def slots(self) -> Tuple["EntityBlock", ...]:
        """The block as one slot (see ShardedEntityBlock)."""
        return (self,)

    def local_margins(self, coefs: Tensor) -> Tensor:
        """x @ coef per entity: [E, n_pad]."""
        return torch.einsum("end,ed->en", self.x, coefs)


@dataclasses.dataclass(frozen=True)
class ShardedEntityBlock:
    """A bucket whose entities are sharded over a 1-D mesh's slots
    (parallel.shard_block): ``slots[s]`` holds entity range s on its
    slot's device, the last ranges ending in all-padding entities, and
    ``num_entities`` counts the real ones. The slots hold the only copy
    of the data. The EntityBlock fields gather the real entities back on
    the first slot's device, for the metadata and row columns a caller
    reads once; solves and scores run slot by slot."""

    slots: Tuple[EntityBlock, ...]
    num_entities: int

    @property
    def n_pad(self) -> int:
        return self.slots[0].n_pad

    @property
    def d_pad(self) -> int:
        return self.slots[0].d_pad

    @property
    def dtype(self) -> torch.dtype:
        return self.slots[0].dtype

    @property
    def device(self) -> torch.device:
        return self.slots[0].device

    def _gather(self, name: str) -> Tensor:
        return torch.cat([getattr(b, name).to(self.device)
                          for b in self.slots])[:self.num_entities]

    x = property(lambda self: self._gather("x"))
    labels = property(lambda self: self._gather("labels"))
    offsets = property(lambda self: self._gather("offsets"))
    weights = property(lambda self: self._gather("weights"))
    row_ids = property(lambda self: self._gather("row_ids"))
    feat_idx = property(lambda self: self._gather("feat_idx"))


@dataclasses.dataclass
class RandomEffectDataset:
    """All buckets of one random-effect coordinate. ``projection`` is set
    when the blocks live in a Gaussian-projected latent space (block
    columns are then latent ids); None means local spaces are column
    gathers of the global space."""

    config: RandomEffectDataConfiguration
    blocks: List[EntityBlock]  # active data
    passive_blocks: List[Optional[EntityBlock]]  # aligned with blocks
    entity_codes: List[np.ndarray]  # [E] global entity code per slot
    vocabulary: np.ndarray  # entity name per code
    n_rows: int  # global row count == scatter sentinel
    num_global_features: int
    projection: Optional[ProjectionMatrix] = None

    @property
    def bucket_keys(self) -> List[Tuple[int, int, int]]:
        """(n_pad, d_pad, p_pad) per block, in block order."""
        return [(b.n_pad, b.d_pad, 0 if p is None else p.n_pad)
                for b, p in zip(self.blocks, self.passive_blocks)]


def pearson_correlation_scores(x: sp.csr_matrix, y: np.ndarray,
                               intercept_col: Optional[int]) -> np.ndarray:
    """|Pearson corr(feature_j, label)| per column; constant columns score
    0 and the intercept +inf (ml/data/LocalDataSet.scala:116-140)."""
    n = x.shape[0]
    y = np.asarray(y, np.float64)
    y_c = y - y.mean()
    y_ss = float(y_c @ y_c)
    xs = np.asarray(x.sum(axis=0)).ravel()
    x_mean = xs / n
    x_sq = np.asarray(x.multiply(x).sum(axis=0)).ravel()
    x_var = x_sq - n * x_mean**2
    xy = np.asarray(x.T @ y).ravel()
    cov = xy - n * x_mean * y.mean()
    denom = np.sqrt(np.maximum(x_var, 0) * max(y_ss, 0))
    with np.errstate(invalid="ignore", divide="ignore"):
        corr = np.where(denom > 1e-12,
                        np.abs(cov / np.maximum(denom, 1e-300)), 0.0)
    if intercept_col is not None and 0 <= intercept_col < x.shape[1]:
        corr[intercept_col] = np.inf
    return corr


def filter_features_by_support(
    x: sp.csr_matrix, min_num_support: int,
    intercept_col: Optional[int] = None,
) -> np.ndarray:
    """Column indices observed (nonzero) in at least ``min_num_support``
    rows (a copy of photon_ml_tpu/data/random_effect.py:201;
    LocalDataSet.filterFeaturesBySupport, ml/data/LocalDataSet.scala:93-114,
    an API the reference exposes but never wires into its pipeline; same
    status here). The intercept column always survives."""
    support = np.diff(x.tocsc().indptr)
    keep = support >= min_num_support
    if intercept_col is not None and 0 <= intercept_col < x.shape[1]:
        keep[intercept_col] = True
    return np.flatnonzero(keep)


def _next_size(v: int, minimum: int) -> int:
    """Smallest power of two >= max(v, minimum): the bucket size classes."""
    v = max(v, minimum)
    return 1 << (v - 1).bit_length()


@dataclasses.dataclass
class _EntityRows:
    code: int
    active: np.ndarray  # global row indices
    passive: np.ndarray
    weight_multiplier: float
    local_cols: np.ndarray  # selected global feature columns
    d_local: int  # local block width (k1 when projected)


def build_random_effect_dataset(
    data: GameDataset,
    config: RandomEffectDataConfiguration,
    seed: int = 0,
    intercept_col: Optional[int] = None,
    dtype=torch.float32,
    device="cuda",
    min_rows_pad: int = 4,
    min_cols_pad: int = 8,
) -> RandomEffectDataset:
    """Group -> cap -> select -> bucket, on the host, once at ingest."""
    dev = resolve_device(device)
    identity = config.projector_type == "IDENTITY"

    col = data.id_columns[config.random_effect_type]
    mat = data.feature_shards[config.feature_shard_id].tocsr()
    n_rows, d_global = mat.shape
    rng = np.random.default_rng(seed)
    projection = build_random_effect_projector(
        config.projector_type, d_global, intercept_col, seed=seed)

    entities: List[_EntityRows] = []
    for rows in group_rows_by_code(col.codes):
        code = int(col.codes[rows[0]])
        cap = config.num_active_data_points
        if cap is not None and len(rows) > cap:
            sel, mult = reservoir_sample(rng, len(rows), cap)
            active = rows[sel]
            passive_mask = np.ones(len(rows), bool)
            passive_mask[sel] = False
            passive = rows[passive_mask]
            lb = config.num_passive_data_points_lower_bound
            if lb is not None and len(passive) < lb:
                passive = np.empty((0,), np.int64)
        else:
            active, passive, mult = rows, np.empty((0,), np.int64), 1.0

        sub = mat[active]
        if identity:
            observed = np.arange(d_global)
        else:
            observed = (np.unique(sub.indices) if sub.nnz
                        else np.empty((0,), np.int64))
            if intercept_col is not None and intercept_col not in observed:
                observed = np.append(observed, intercept_col)
        ratio = config.num_features_to_samples_ratio
        if ratio is not None and len(observed) > 0:
            keep = max(1, int(np.ceil(ratio * len(active))))
            if keep < len(observed):
                scores = pearson_correlation_scores(
                    sub[:, observed], data.responses[active],
                    int(np.flatnonzero(observed == intercept_col)[0])
                    if intercept_col is not None
                    and intercept_col in observed else None)
                top = np.argsort(-scores, kind="stable")[:keep]
                observed = observed[np.sort(top)]
        observed = np.sort(observed)
        d_local = (projection.projected_space_dimension
                   if projection is not None else len(observed))
        entities.append(_EntityRows(code, active, passive, mult, observed,
                                    d_local))

    buckets: Dict[Tuple[int, int, int], List[_EntityRows]] = {}
    for e in entities:
        n_pad = _next_size(len(e.active), min_rows_pad)
        d_pad = _next_size(max(e.d_local, 1), min_cols_pad)
        p_pad = _next_size(len(e.passive), 1) if len(e.passive) else 0
        buckets.setdefault((n_pad, d_pad, p_pad), []).append(e)

    blocks, passive_blocks, codes_per_block = [], [], []
    for (n_pad, d_pad, p_pad), members in sorted(buckets.items()):
        blocks.append(_pack_block(
            members, [m.active for m in members], n_pad, d_pad, data, mat,
            n_rows, dtype, dev, weight_mult=True, projection=projection))
        passive_blocks.append(_pack_block(
            members, [m.passive for m in members], p_pad, d_pad, data, mat,
            n_rows, dtype, dev, weight_mult=False, projection=projection)
            if p_pad else None)
        codes_per_block.append(np.asarray([m.code for m in members],
                                          np.int32))

    return RandomEffectDataset(
        config=config, blocks=blocks, passive_blocks=passive_blocks,
        entity_codes=codes_per_block, vocabulary=col.vocabulary,
        n_rows=n_rows, num_global_features=d_global, projection=projection)


def _pack_block(members: List[_EntityRows], row_sets: Sequence[np.ndarray],
                n_pad: int, d_pad: int, data: GameDataset,
                mat: sp.csr_matrix, n_rows: int, dtype, device,
                weight_mult: bool,
                projection: Optional[ProjectionMatrix] = None
                ) -> EntityBlock:
    E = len(members)
    x = np.zeros((E, n_pad, d_pad), np.float32)
    labels = np.zeros((E, n_pad), np.float32)
    offsets = np.zeros((E, n_pad), np.float32)
    weights = np.zeros((E, n_pad), np.float32)
    row_ids = np.full((E, n_pad), n_rows, np.int32)
    feat_idx = np.full((E, d_pad), -1, np.int32)

    for i, (m, rows) in enumerate(zip(members, row_sets)):
        k = len(rows)
        if k == 0:
            continue
        cols = m.local_cols
        if projection is not None:
            # Latent block: the kept columns on both sides, which equals
            # zeroing the dropped columns and projecting the full row.
            k1 = projection.projected_space_dimension
            x[i, :k, :k1] = np.asarray(
                mat[rows][:, cols] @ projection.matrix[:, cols].T)
            feat_idx[i, :k1] = np.arange(k1)
        else:
            x[i, :k, :len(cols)] = mat[rows][:, cols].toarray()
            feat_idx[i, :len(cols)] = cols
        labels[i, :k] = data.responses[rows]
        offsets[i, :k] = data.offsets[rows]
        weights[i, :k] = data.weights[rows] * (
            m.weight_multiplier if weight_mult else 1.0)
        row_ids[i, :k] = rows

    def floats(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return EntityBlock(
        x=floats(x), labels=floats(labels), offsets=floats(offsets),
        weights=floats(weights),
        row_ids=torch.as_tensor(row_ids, device=device),
        feat_idx=torch.as_tensor(feat_idx, device=device))
