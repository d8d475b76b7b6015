// Deterministic CSR matrix-vector product for Hopper (sm_90a), kernel row
// 9 of PERF.md's table:
//
//   y[r] = sum_{k in [crow[r], crow[r + 1])} val[k] * x[col[k]]
//
// with crow int32 [rows + 1], col int32 [nnz], val and x float32 or float64
// and y [rows] of the same type, summed in that type.
//
// Stands for the sparse products of the JAX package's CSRFeatures
// (photon_ml_tpu/ops/features.py:137-145, matvec and rmatvec: an XLA
// gather and jax.ops.segment_sum outside any Pallas kernel). The port's
// shard cache (data/shard_cache.py) keeps each shard as a CSR and the CSR
// of its transpose, and the in-core CSRFeatures do the same, so both
// products are this one. Its reason to exist is determinism: the streamed
// solve's model must be the same bits whether a shard stayed resident,
// was evicted and re-uploaded, or was re-decoded, so a row must give the
// same sum on every call and in every matrix. cuSPARSE's CSR SpMV
// (torch.mv on a sparse CSR tensor) did not repeat its bits for the
// transpose's long rows on the H100 (PERF.md).
//
// The kernel is csr_order.cuh's at W = 1: its order contract (a row's
// additions depend on its own length only), its lane groups sized by the
// row's length class, and its long rows cut into chunks that whole warps
// take in parallel, added in chunk order by the row's last warp. Bound on
// the H100: bytes (8 or 12 bytes an entry, the vector in L2).

#include "csr_order.cuh"

namespace {

template <typename T>
int spmv(const csr_order::Call* c, const T* x, T* y, void* stream) {
  if (c->rows < 0 || c->nnz < 0 || c->n_cols < 0 || c->n != 1 ||
      (c->part == nullptr) != (c->counter == nullptr))
    return (int)cudaErrorInvalidValue;
  if (c->rows == 0) return 0;
  const csr_order::Args<T> a{c->crow, c->col, static_cast<const T*>(c->val),
                             x, y, static_cast<T*>(c->part), c->counter,
                             c->rows, 1, 0, false};
  return csr_order::launch_tile<T, 1>(a, c->nnz, c->n_cols,
                                      static_cast<cudaStream_t>(stream));
}

}  // namespace

// kChunk: the entries of a chunk of a long row (part of the order
// contract).
extern "C" int csr_chunk_entries() { return csr_order::kChunk; }

// The chunk-sum slots a product of this shape needs (0: pass no scratch).
extern "C" long long csr_scratch_slots(int rows, long long nnz,
                                       long long n_cols) {
  return csr_order::scratch_slots(rows, nnz, n_cols);
}

// Launch y = A x on `stream` for the CSR A of `call` (n = 1). Returns the
// CUDA error of the launch (0 on success). Does not synchronise; the
// counters are 0 again after the launch.
extern "C" int csr_spmv_f32_run(const csr_order::Call* call, const float* x,
                                float* y, void* stream) {
  return spmv<float>(call, x, y, stream);
}

extern "C" int csr_spmv_f64_run(const csr_order::Call* call, const double* x,
                                double* y, void* stream) {
  return spmv<double>(call, x, y, stream);
}
