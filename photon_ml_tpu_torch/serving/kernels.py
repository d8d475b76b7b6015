"""Scoring math for fixed, random-effect and matrix-factorization
sub-models (port of photon_ml_tpu/serving/kernels.py:
UnsupportedSubModelError :36, is_re_snapshot :50, the densification
ceiling and check_snapshot_densifiable :62-77, snapshot_dense_matrix
:80-92, score_fixed :94,
assemble_re_matrix :99-118 with the projection, score_random_with_matrix
:121, score_random :132, score_mf :145).

These are plain tensor ops, not kernels: the JAX package runs them as XLA
gathers, scatters and small products with no Pallas kernel. The random
effect assembles an entity -> global-coefficient matrix from the model's
bucketed local blocks (row ``n_codes`` stays zero for unknown entities;
a projected or factored model's latent gamma goes through ``gamma @ P``),
then contracts it row by row against the feature shard; a loaded
snapshot (io/model_io.RandomEffectModelSnapshot) arrives as that matrix
already, densified on the host. MF scores are factor dots with a zero
row for unknown entities.

The serving engine (serving/engine.py) scores a bucket with
``score_random_rows`` and ``score_mf_rows``: the same contraction and
factor dots, summed so that a row's bits depend only on its own entries.
``score_random_with_matrix`` sums through ``index_add_``, which is an
atomic add on the card, so a row's bits there could depend on its
bucket-mates and change from call to call (JAX's segment_sum repeats its
bits); ``score_random_rows`` takes the row sums of the products through
the deterministic CSR product (kernel row 9) against a vector of ones,
exact products by 1, so each row keeps that kernel's order contract.
``score_mf_rows`` adds the k factor products in order.

A snapshot too large to densify raises UnsupportedSubModelError. The
JAX scoring driver turns that error into host-numpy scoring; the port
has no host fallback, so the error ends the run.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.ops.features import CSRFeatures
from photon_ml_tpu_torch.ops.spmv import CSROperand

Tensor = torch.Tensor


class UnsupportedSubModelError(TypeError):
    """A GAME coordinate's sub-model family has no device scoring path,
    or a snapshot is past the densification ceiling."""


def is_re_snapshot(m) -> bool:
    """Duck-typed io.model_io.RandomEffectModelSnapshot check (the IO
    layer imports the scorers' callers, so this module may not import
    model_io)."""
    return (not isinstance(m, RandomEffectModel)
            and hasattr(m, "matrix") and hasattr(m, "vocabulary")
            and hasattr(m, "random_effect_type")
            and hasattr(m, "feature_shard_id"))


# Densification ceiling for loaded entity matrices: past this the dense
# [n_entities, d_global] table does not belong in host RAM or device
# memory wholesale.
SNAPSHOT_DENSIFY_MAX_BYTES = 2 << 30


def check_snapshot_densifiable(m, dtype) -> None:
    """Raise UnsupportedSubModelError when densifying a snapshot's entity
    matrix in ``dtype`` (a torch dtype) would pass the ceiling."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (len(m.vocabulary) + 1) * m.matrix.shape[1] * itemsize
    if nbytes > SNAPSHOT_DENSIFY_MAX_BYTES:
        raise UnsupportedSubModelError(
            f"random-effect snapshot {m.random_effect_type!r} would "
            f"densify to {nbytes / 1e9:.1f} GB "
            f"({len(m.vocabulary)} entities x {m.matrix.shape[1]} global "
            "features) — beyond the device-scoring densification ceiling")


def snapshot_dense_matrix(m, dtype) -> np.ndarray:
    """Host dense [n_codes + 1, d_global] entity matrix of a loaded
    snapshot, float64, with the trailing unknown-entity zero row
    score_random_with_matrix expects. Checks the ceiling first."""
    check_snapshot_densifiable(m, dtype)
    dense = np.zeros((len(m.vocabulary) + 1, m.matrix.shape[1]))
    dense[:len(m.vocabulary)] = m.matrix.toarray()
    return dense


def score_fixed(feats, coefs: Tensor, dtype) -> Tensor:
    """Fixed-effect margins: feats @ coefs -> [n_rows]."""
    return feats.matvec(coefs.to(dtype))


def assemble_re_matrix(block_static: Sequence[Tuple[Tensor, Tensor]],
                       coefs: Sequence[Tensor], proj: Optional[Tensor],
                       n_codes: int, d_global: int, dtype) -> Tensor:
    """Entity -> global-coefficient matrix [n_codes + 1, d_global]; local
    padding columns (feat_idx -1) land in a scratch column that is cut.
    ``proj`` [k1, d_global] is the projection of a projected or factored
    model, whose local coefficients are latent: row = gamma[:k1] @ proj."""
    device = coefs[0].device if coefs else None
    M = torch.zeros((n_codes + 1, d_global + 1), dtype=dtype, device=device)
    for (codes_b, fidx_b), coefs_b in zip(block_static, coefs):
        c = coefs_b.to(dtype)
        if proj is not None:
            k = proj.shape[0]
            M[:, :d_global].index_add_(0, codes_b.long(),
                                       c[:, :k] @ proj.to(dtype))
            continue
        cols = torch.where(fidx_b >= 0, fidx_b.long(),
                           torch.full_like(fidx_b.long(), d_global))
        rows = codes_b.long()[:, None].expand_as(cols)
        M.index_put_((rows, cols), c, accumulate=True)
    return M[:, :d_global]


def score_random_with_matrix(feats, mapped: Tensor, M: Tensor) -> Tensor:
    """x_i . M[entity(i)]; ``mapped`` -1 (unknown) hits the zero row."""
    rows = torch.where(mapped >= 0, mapped.long(),
                       torch.full_like(mapped.long(), M.shape[0] - 1))
    if isinstance(feats, CSRFeatures):
        contrib = feats.values * M[rows[feats.row_ids], feats.col_ids]
        out = torch.zeros((feats.n_rows,), dtype=M.dtype, device=M.device)
        return out.index_add_(0, feats.row_ids, contrib)
    return torch.einsum("nd,nd->n", feats.x, M[rows])


def score_random_rows(op: CSROperand, prod: Tensor, values: Tensor,
                      row_ids: Tensor, mapped: Tensor, M: Tensor,
                      ones: Tensor) -> Tensor:
    """``score_random_with_matrix`` of a CSR feature block, row by row in
    the CSR product's order: ``op`` is the block's CSR with ``prod`` as
    its values, ``values`` and ``row_ids`` its entries' feature values
    and rows, ``ones`` [n_cols] of M's type. ``prod`` is written with
    x_ij * M[entity(i), j] and the rows summed by ``op.matvec(ones)``."""
    rows = torch.where(mapped >= 0, mapped, M.shape[0] - 1)
    torch.mul(values, M[rows[row_ids], op.col], out=prod)
    return op.matvec(ones)


def score_random(feats, mapped: Tensor,
                 block_static: Sequence[Tuple[Tensor, Tensor]],
                 coefs: Sequence[Tensor], proj: Optional[Tensor],
                 n_codes: int, d_global: int, dtype) -> Tensor:
    """Assemble-then-contract, for coefficients that change per call
    (validation scoring during training)."""
    M = assemble_re_matrix(block_static, coefs, proj, n_codes, d_global,
                           dtype)
    return score_random_with_matrix(feats, mapped, M)


def score_mf(row_mapped: Tensor, col_mapped: Tensor, row_factors: Tensor,
             col_factors: Tensor, dtype) -> Tensor:
    """MF margins rowFactor(row) . colFactor(col); -1 codes hit an
    appended zero row on either side."""
    rf, cf = row_factors.to(dtype), col_factors.to(dtype)
    k = rf.shape[-1]
    rf = torch.cat([rf, rf.new_zeros((1, k))])
    cf = torch.cat([cf, cf.new_zeros((1, k))])
    rr = torch.where(row_mapped >= 0, row_mapped.long(),
                     torch.full_like(row_mapped.long(), rf.shape[0] - 1))
    cc = torch.where(col_mapped >= 0, col_mapped.long(),
                     torch.full_like(col_mapped.long(), cf.shape[0] - 1))
    return torch.sum(rf[rr] * cf[cc], dim=-1)


def score_mf_rows(row_mapped: Tensor, col_mapped: Tensor,
                  row_factors: Tensor, col_factors: Tensor, dtype) -> Tensor:
    """``score_mf`` with the k products of a row added in order, so a
    row's bits do not depend on how many rows share its call."""
    rf, cf = row_factors.to(dtype), col_factors.to(dtype)
    k = rf.shape[-1]
    rf = torch.cat([rf, rf.new_zeros((1, k))])
    cf = torch.cat([cf, cf.new_zeros((1, k))])
    rr = torch.where(row_mapped >= 0, row_mapped, rf.shape[0] - 1)
    cc = torch.where(col_mapped >= 0, col_mapped, cf.shape[0] - 1)
    prod = rf[rr] * cf[cc]
    total = prod[:, 0]
    for j in range(1, k):
        total = total + prod[:, j]
    return total
