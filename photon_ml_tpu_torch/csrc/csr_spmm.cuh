// The CSR x dense-panel product of kernel row 10 (csr_spmm.cu for float32,
// csr_spmm_f64.cu for float64), for Hopper (sm_90a):
//
//   Y[r, j] = sum_{k in [crow[r], crow[r + 1])} val[k] * X[col[k], j]
//
// with crow int32 [rows + 1], col int32 [nnz], val float32 or float64, X
// row-major [n_cols, n] and Y row-major [rows, n] of val's type, summed in
// that type.
//
// Stands for the panel products of the JAX package's batched lambda grid
// (photon_ml_tpu/ops/sharded_objective.py:612-700, grid_init, grid_dir,
// grid_grad and grid_hvp: the scalar CSRFeatures gather and segment sum
// vmapped over G coefficient or margin lanes) and of its streamed matrix
// factorization (photon_ml_tpu/ops/mf_alternating.py:176-270: V = X B^T
// and the B gradient X^T (u * gamma) with n = k, and the per-entity
// normal equations, a segment sum over entities written here as the
// product of an entity x row CSR with a [rows, k^2 + k] panel). XLA
// compiles all of these outside any Pallas kernel.
//
// Its reason to exist is determinism, as for csr_spmv.cu, and it is the
// same kernel (csr_order.cuh) at W > 1: every column is summed in the
// order contract's order, so column j is row 9's bits on column j of X by
// construction. The n columns go in tiles of an exact template width W
// (kWidths, largest first: n = 4, 8 and 20 are one tile), so a tile reads
// the CSR once and carries no predicate; a panel row is read as 16- or
// 8-byte vectors where its width and alignment allow. Bound on the H100:
// bytes (the CSR once a tile; the panel's rows stay in L2).

#pragma once

#include <cstdint>

#include "csr_order.cuh"

namespace csr_spmm {

constexpr int kWidths[] = {32, 24, 20, 16, 12, 8, 7, 6, 5, 4, 3, 2, 1};

template <typename T, int W>
int tile(const csr_order::Args<T>& a, long long nnz, long long n_cols,
         cudaStream_t s) {
  return csr_order::launch_tile<T, W>(a, nnz, n_cols, s);
}

template <typename T>
int launch(const csr_order::Call* c, const T* X, T* Y, void* stream) {
  const int n = c->n;
  if (c->rows < 0 || c->nnz < 0 || c->n_cols < 0 || n < 1 ||
      (c->part == nullptr) != (c->counter == nullptr))
    return (int)cudaErrorInvalidValue;
  if (c->rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t row_bytes = (size_t)n * sizeof(T);
  for (int c0 = 0; c0 < n;) {
    int w = 1;
    for (int cand : kWidths)
      if (cand <= n - c0) {
        w = cand;
        break;
      }
    const size_t tile_bytes = (size_t)w * sizeof(T);
    const uintptr_t base = reinterpret_cast<uintptr_t>(X + c0);
    const bool vec =
        tile_bytes % 16 == 0
            ? base % 16 == 0 && row_bytes % 16 == 0
            : (tile_bytes == 8 && sizeof(T) == 4 && base % 8 == 0 &&
               row_bytes % 8 == 0);
    const csr_order::Args<T> a{c->crow,
                               c->col,
                               static_cast<const T*>(c->val),
                               X + c0,
                               Y + c0,
                               static_cast<T*>(c->part),
                               c->counter,
                               c->rows,
                               n,
                               0,
                               vec};
    const long long nnz = c->nnz, n_cols = c->n_cols;
    int err;
    switch (w) {
      case 32: err = tile<T, 32>(a, nnz, n_cols, s); break;
      case 24: err = tile<T, 24>(a, nnz, n_cols, s); break;
      case 20: err = tile<T, 20>(a, nnz, n_cols, s); break;
      case 16: err = tile<T, 16>(a, nnz, n_cols, s); break;
      case 12: err = tile<T, 12>(a, nnz, n_cols, s); break;
      case 8: err = tile<T, 8>(a, nnz, n_cols, s); break;
      case 7: err = tile<T, 7>(a, nnz, n_cols, s); break;
      case 6: err = tile<T, 6>(a, nnz, n_cols, s); break;
      case 5: err = tile<T, 5>(a, nnz, n_cols, s); break;
      case 4: err = tile<T, 4>(a, nnz, n_cols, s); break;
      case 3: err = tile<T, 3>(a, nnz, n_cols, s); break;
      case 2: err = tile<T, 2>(a, nnz, n_cols, s); break;
      default: err = tile<T, 1>(a, nnz, n_cols, s); break;
    }
    if (err != 0) return err;
    c0 += w;
  }
  return 0;
}

}  // namespace csr_spmm
