"""Device-resident feature matrices (port of photon_ml_tpu/ops/features.py:
DenseFeatures :33-103, CSRFeatures :106-174, KroneckerFeatures :177-228,
BlockedCSRFeatures :231-316, blocked_csr_from_scipy :319-349,
blocked_ell_from_scipy :516-521, padded_csr_arrays :969-997,
features_to_device :1002-1058).

- ``DenseFeatures``: dense ``[n_rows, n_features]``; products are
  ``torch.matmul``. ``x`` may be stored in bfloat16
  (``features_to_device(..., storage_dtype=torch.bfloat16)``): every
  product then accumulates in the solver type, never in bfloat16, as the
  JAX ``_acc`` asks (features.py:59-75); ``x`` is widened row chunk by
  row chunk and multiplied there, and ``v`` and the result are never
  rounded to bfloat16.
- ``CSRFeatures``: the CSR of the matrix for the margins, plus the CSR
  of its transpose for the gradient product, int32 offsets and indices.
  On the card both, and their squared-value variants, go through
  ops/spmv.py's deterministic kernel, as the streamed path's shard blocks
  do: the JAX package's products are a gather and a segment sum that
  repeat their bits, and cuSPARSE's SpMV did not for the transpose's long
  rows on the H100 (PERF.md). Both CSRs are checked once, when the
  features are built (``spmv.CSROperand``: int32, one device,
  contiguous), so a product checks only its vector. On the CPU they are
  ``torch.mv`` on the sparse tensor.
- ``BlockedCSRFeatures``: the CSR cut into C column blocks of
  ``block_size`` columns (the feature-sharded fixed effect over a mesh's
  column axis, parallel/distributed.py): block c holds its entries with
  LOCAL column ids, as a ``spmv.CSRBlock`` (CSR and transpose) on its
  own device, and the margins sum the blocks' entry products through the
  product stream (``spmv.EntryStream``) on the home device, so a margin
  is the unblocked CSR's bits on the card; each block's transposed
  product is that slice of the unblocked one's, whole in one block.
- ``KroneckerFeatures``: the lazy row-wise Kronecker product x_i (x)
  gamma_i of a factored random effect's projection-matrix refit; each
  product is one contraction and the ``[n, k d]`` matrix is never built.

The dense/sparse choice by density is the JAX package's. Its ELL
layouts (features.py:233-930, ``sparse_layout="bucketed_ell"`` and
``"sort_permute_ell"``) work around the TPU's slow gathers and
scatter-adds; ``features_to_device`` accepts their names and builds CSR
for them, and ``blocked_ell_from_scipy`` (the column-blocked ELL
``BlockedEllFeatures``) builds ``BlockedCSRFeatures``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops.spmv import (
    CSRBlock,
    CSROperand,
    EntryStream,
    block_from_triplet,
    block_lengths,
    entry_products,
)

Tensor = torch.Tensor


# Elements of x widened at a time when it is stored narrower than the
# accumulation type (64 MiB of float32).
UPCAST_CHUNK_ELEMENTS = 1 << 24


@dataclasses.dataclass(frozen=True)
class DenseFeatures:
    """Dense feature matrix x: [n_rows, n_features], stored in the solver
    type or in bfloat16."""

    x: Tensor

    @property
    def num_features(self) -> int:
        return self.x.shape[-1]

    @staticmethod
    def _acc(v: Tensor):
        # Accumulate in the solver type, never in the storage type.
        return torch.promote_types(v.dtype, torch.float32)

    def _row_chunks(self, acc, square: bool = False):
        """(start, rows of x in ``acc``, squared there if asked): x itself
        when stored in ``acc``, else widened UPCAST_CHUNK_ELEMENTS at a
        time."""
        n, d = self.x.shape
        step = n if self.x.dtype == acc else max(
            1, UPCAST_CHUNK_ELEMENTS // max(1, d))
        for s in range(0, n, step):
            xc = self.x[s:s + step].to(acc)
            yield s, (xc * xc if square else xc)

    def _matvec(self, v: Tensor, square: bool) -> Tensor:
        acc = self._acc(v)
        if self.x.dtype == acc and not square:
            return torch.matmul(self.x, v)
        out = torch.empty(self.x.shape[0], dtype=acc, device=self.x.device)
        for s, xc in self._row_chunks(acc, square):
            out[s:s + xc.shape[0]] = torch.matmul(xc, v)
        return out

    def _rmatvec(self, u: Tensor, square: bool) -> Tensor:
        acc = self._acc(u)
        if self.x.dtype == acc and not square:
            return torch.matmul(u, self.x)
        out = None
        for s, xc in self._row_chunks(acc, square):
            part = torch.matmul(u[s:s + xc.shape[0]], xc)
            out = part if out is None else out + part
        return out

    def matvec(self, v: Tensor) -> Tensor:
        """x @ v -> [n_rows]."""
        return self._matvec(v, square=False)

    def rmatvec(self, u: Tensor) -> Tensor:
        """x.T @ u -> [n_features]."""
        return self._rmatvec(u, square=False)

    def row_sq_matvec(self, v: Tensor) -> Tensor:
        """(x*x) @ v, the square formed in the accumulation type."""
        return self._matvec(v, square=True)

    def sq_rmatvec(self, u: Tensor) -> Tensor:
        """(x*x).T @ u -> [n_features]: per-feature weighted square sums
        (the Hessian diagonal's aggregation)."""
        return self._rmatvec(u, square=True)


@dataclasses.dataclass(frozen=True)
class CSRFeatures:
    """Sparse feature matrix as CSR (``csr``) plus the CSR of its
    transpose (``csr_t``), int32 offsets and indices, so both products
    are row-major sparse matrix-vector products. ``row_ids``/``col_ids``/
    ``values`` are the expanded-CSR triplet the random-effect scorer
    gathers through."""

    csr: Tensor
    csr_t: Tensor
    values: Tensor
    col_ids: Tensor
    row_ids: Tensor
    n_rows: int
    n_features: int
    _ops: tuple = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_ops", tuple(
            CSROperand(m.crow_indices(), m.col_indices(), m.values(),
                       m.shape[1]) for m in (self.csr, self.csr_t)))

    @property
    def num_features(self) -> int:
        return self.n_features

    def _mv(self, which: int, v: Tensor, square: bool = False) -> Tensor:
        """csr (0) or csr_t (1) @ v, each value squared first when asked:
        the deterministic kernel on the card, torch.mv on the CPU."""
        op = self._ops[which]
        if square:
            op = op.with_values(op.val * op.val)
        return op.matvec(v)

    def matvec(self, v: Tensor) -> Tensor:
        return self._mv(0, v)

    def rmatvec(self, u: Tensor) -> Tensor:
        return self._mv(1, u)

    def row_sq_matvec(self, v: Tensor) -> Tensor:
        return self._mv(0, v, square=True)

    def sq_rmatvec(self, u: Tensor) -> Tensor:
        return self._mv(1, u, square=True)


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


@dataclasses.dataclass(frozen=True)
class BlockedCSRFeatures:
    """A CSR [n_rows, n_features] cut into ``num_blocks`` column blocks of
    ``block_size`` columns (``n_features`` is the padded width, num_blocks
    x block_size): ``blocks[c]`` the block's entries with local column
    ids, on its own device; ``stream`` the product stream on the home
    device, where every [n_rows] vector lives. A [n_features] vector
    goes to the blocks a slice each; the transposed products come back
    a slice each and join in block order on the home device."""

    blocks: Tuple[CSRBlock, ...]
    stream: EntryStream
    n_rows: int
    n_features: int
    block_size: int

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_features)

    @property
    def num_features(self) -> int:
        return self.n_features

    @property
    def device(self) -> torch.device:
        return self.stream.device

    def _slices(self, v: Tensor) -> list:
        bs = self.block_size
        return [v[c * bs:(c + 1) * bs].to(b.crow.device)
                for c, b in enumerate(self.blocks)]

    def _mv(self, v: Tensor, square: bool) -> Tensor:
        return self.stream.matvec([
            entry_products(b, x, square)
            for b, x in zip(self.blocks, self._slices(v))])

    def _rmv(self, u: Tensor, square: bool) -> Tensor:
        parts = []
        for b in self.blocks:
            op = b._ops[1]
            if square:
                op = op.with_values(b.values_t * b.values_t)
            parts.append(op.matvec(u.to(b.crow.device)).to(self.device))
        return torch.cat(parts)

    def matvec(self, v: Tensor) -> Tensor:
        return self._mv(v, False)

    def rmatvec(self, u: Tensor) -> Tensor:
        return self._rmv(u, False)

    def row_sq_matvec(self, v: Tensor) -> Tensor:
        return self._mv(v, True)

    def sq_rmatvec(self, u: Tensor) -> Tensor:
        return self._rmv(u, True)


#: JAX's column-blocked dual ELL (features.py:354) is built as CSR blocks.
BlockedEllFeatures = BlockedCSRFeatures


def blocked_csr_from_scipy(mat, num_blocks: int, dtype=torch.float32,
                           device="cuda", devices=None
                           ) -> BlockedCSRFeatures:
    """Cut a host sparse matrix into ``num_blocks`` column blocks of
    ceil(d / num_blocks) columns (``split_csr_columns``; columns padded
    to a multiple of num_blocks): block c on ``devices[c]`` (every block
    on ``device`` when None), the product stream on ``devices[0]``."""
    from photon_ml_tpu_torch.parallel.distributed import split_csr_columns

    if devices is None:
        devices = [resolve_device(device)] * int(num_blocks)
    if len(devices) != num_blocks:
        raise ValueError(f"{num_blocks} column blocks need as many devices, "
                         f"got {len(devices)}")
    block, subs = split_csr_columns(mat, num_blocks)
    blocks = []
    for sub, dev in zip(subs, devices):
        dev = torch.device(dev)
        rows = np.repeat(np.arange(sub.shape[0], dtype=np.int32),
                         np.diff(sub.indptr))
        blocks.append(block_from_triplet(
            torch.as_tensor(sub.data, dtype=dtype, device=dev),
            torch.as_tensor(sub.indices.astype(np.int32), device=dev),
            torch.as_tensor(rows, device=dev), sub.shape[0], block))
    home = torch.device(devices[0])
    return BlockedCSRFeatures(
        tuple(blocks), EntryStream(block_lengths(blocks).to(home), dtype),
        int(mat.shape[0]), int(num_blocks * block), int(block))


def blocked_ell_from_scipy(mat, num_blocks: int = 1, dtype=torch.float32,
                           device="cuda") -> BlockedCSRFeatures:
    """JAX's ``BlockedEllFeatures`` builder, as ``BlockedCSRFeatures``."""
    return blocked_csr_from_scipy(mat, num_blocks, dtype, device)


FeatureMatrix = Union[DenseFeatures, CSRFeatures, KroneckerFeatures,
                      BlockedCSRFeatures]


def _csr_tensor(mat: sp.csr_matrix, dtype, device) -> Tensor:
    mat = mat.tocsr()
    mat.sort_indices()
    return torch.sparse_csr_tensor(
        torch.as_tensor(mat.indptr, dtype=torch.int32),
        torch.as_tensor(mat.indices, dtype=torch.int32),
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


def _host_csr(mat, n_rows_pad: int, nnz_pad: int) -> sp.csr_matrix:
    csr = mat.tocsr() if sp.issparse(mat) else sp.csr_matrix(mat)
    if csr.shape[0] > n_rows_pad:
        raise ValueError(f"{csr.shape[0]} rows > n_rows_pad={n_rows_pad}")
    if csr.nnz > nnz_pad:
        raise ValueError(f"nnz={csr.nnz} > nnz_pad={nnz_pad}")
    return csr


def padded_csr_arrays(mat, n_rows_pad: int, nnz_pad: int,
                      value_dtype=np.float32):
    """Host CSR -> the padded expanded-CSR triplet ``(values[nnz_pad],
    col_ids[nnz_pad], row_ids[nnz_pad])`` (numpy; port of
    photon_ml_tpu/ops/features.py:969-997, the same arrays bit for bit).
    Pad entries carry value 0 at (row 0, col 0); rows in
    [mat.shape[0], n_rows_pad) have no entries."""
    csr = _host_csr(mat, n_rows_pad, nnz_pad)
    values = np.zeros(nnz_pad, dtype=value_dtype)
    col_ids = np.zeros(nnz_pad, dtype=np.int32)
    row_ids = np.zeros(nnz_pad, dtype=np.int32)
    values[:csr.nnz] = csr.data
    col_ids[:csr.nnz] = csr.indices
    row_ids[:csr.nnz] = np.repeat(
        np.arange(csr.shape[0], dtype=np.int32), np.diff(csr.indptr))
    return values, col_ids, row_ids


def padded_csr(mat, n_rows_pad: int, nnz_pad: int, value_dtype=np.float32):
    """Host CSR -> the bucket's padded CSR ``(crow[n_rows_pad + 1],
    col[nnz_pad], val[nnz_pad])`` (int32 indices, numpy) for the
    deterministic product (ops/spmv.py).

    Unlike ``padded_csr_arrays``, whose pads sit at (row 0, col 0), no
    row holds a pad entry: rows from mat.shape[0] on are empty
    (``crow[n:] = nnz``) and the entries past ``crow[n_rows_pad]`` are
    zeros that no row reads. A pad in row 0 would lengthen it and, under
    the kernel's order contract (a row's additions depend on its own
    length), change its sum; so a row's bits here depend only on its own
    entries, whatever shares its bucket."""
    csr = _host_csr(mat, n_rows_pad, nnz_pad)
    crow = np.full(n_rows_pad + 1, csr.nnz, dtype=np.int32)
    crow[:csr.shape[0] + 1] = csr.indptr
    col = np.zeros(nnz_pad, dtype=np.int32)
    val = np.zeros(nnz_pad, dtype=value_dtype)
    col[:csr.nnz] = csr.indices
    val[:csr.nnz] = csr.data
    return crow, col, val


DENSE_DENSITY_THRESHOLD = 0.2


SPARSE_LAYOUTS = ("csr", "bucketed_ell", "sort_permute_ell")


def features_to_device(mat, dtype=torch.float32, device="cuda",
                       dense_threshold: float = DENSE_DENSITY_THRESHOLD,
                       storage_dtype=None, sparse_layout: str = "csr"
                       ) -> FeatureMatrix:
    """Host feature matrix -> device layout, dense at or above
    ``dense_threshold`` density, CSR below it (features.py:1002).

    ``storage_dtype=torch.bfloat16`` stores DENSE features at half width
    (products accumulate in the solver type); sparse layouts ignore it,
    with the JAX package's warning. ``sparse_layout`` is one of
    SPARSE_LAYOUTS, checked up front as in JAX (:1020-1026); every one
    builds CSR here."""
    if sparse_layout not in SPARSE_LAYOUTS:
        raise ValueError(
            f"unknown sparse_layout {sparse_layout!r}: expected "
            "'csr', 'bucketed_ell', or 'sort_permute_ell'")
    dev = resolve_device(device)
    dense_dt = storage_dtype if storage_dtype is not None else dtype
    if sp.issparse(mat):
        density = mat.nnz / max(1, mat.shape[0] * mat.shape[1])
        if density < dense_threshold:
            if storage_dtype is not None:
                import warnings

                warnings.warn(
                    f"storage_dtype={storage_dtype} ignored: data density "
                    f"is below the dense threshold ({dense_threshold:.2f}), "
                    "which selects a sparse layout (sparse layouts are "
                    "lookup-count-bound, not byte-bound)", stacklevel=2)
            return csr_from_scipy(mat, dtype, dev)
        mat = mat.toarray()
    return DenseFeatures(torch.as_tensor(np.asarray(mat), dtype=dense_dt,
                                         device=dev))
