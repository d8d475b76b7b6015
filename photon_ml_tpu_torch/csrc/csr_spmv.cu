// Deterministic CSR matrix-vector product for Hopper (sm_90a):
//
//   y[r] = sum_{k in [crow[r], crow[r + 1])} val[k] * x[col[k]]
//
// with crow int32 [rows + 1], col int32 [nnz], val and x float32 or float64
// and y [rows] of the same type, summed in that type.
//
// Stands for the sparse products of the JAX package's streamed fixed
// effect (photon_ml_tpu/ops/features.py:137-145, CSRFeatures.matvec and
// rmatvec: an XLA gather and jax.ops.segment_sum outside any Pallas
// kernel). The port's shard cache (data/shard_cache.py) keeps each shard
// as a CSR and the CSR of its transpose, so both products are this one.
// Its reason to exist is determinism: the streamed solve's model must be
// the same bits whether a shard stayed resident, was evicted and
// re-uploaded, or was re-decoded, so the same shard must give the same
// partial on every call. cuSPARSE's CSR SpMV (torch.mv on a sparse CSR
// tensor) did not for the transpose's long rows on the H100 (PERF.md).
//
// Design: a group of G threads owns a row. Thread j of the group sums the
// row's entries j, j + G, j + 2G, ... in order, then the group adds its G
// partials by a fixed butterfly (warp shuffles, and for G = 256 a fixed
// tree through shared memory). The order of every addition depends only
// on the row's length, so a row's result is the same bits on every call.
// G = 32 (a warp a row, eight rows a block) for short rows; G = 256 (a
// block a row) where rows average 1,024 entries or more, as the
// transpose's rows do (one per feature, one entry per row of the shard).
// No fused multiply-add (-fmad=false, cuda_build.COMPILE_FLAGS).
//
// Bound on the H100: bytes. Each entry reads its value and column index
// (8 or 12 bytes) and a gathered x element; each row reads its offsets
// and writes its result.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T row_part(const int* __restrict__ col,
                                      const T* __restrict__ val,
                                      const T* __restrict__ x, int begin,
                                      int end, int lane, int group) {
  T acc = T(0);
  for (int k = begin + lane; k < end; k += group) acc += val[k] * __ldg(x + col[k]);
  return acc;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// G = 32: warp w of the block owns row blockIdx.x * 8 + w.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    spmv_warp_kernel(const int* __restrict__ crow, const int* __restrict__ col,
                     const T* __restrict__ val, const T* __restrict__ x,
                     T* __restrict__ y, int rows) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;
  T acc = row_part(col, val, x, crow[r], crow[r + 1], lane, 32);
  acc = warp_sum(acc);
  if (lane == 0) y[r] = acc;
}

// G = 256: block b owns row b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    spmv_block_kernel(const int* __restrict__ crow, const int* __restrict__ col,
                      const T* __restrict__ val, const T* __restrict__ x,
                      T* __restrict__ y) {
  __shared__ T part[kThreads / 32];
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  T acc = row_part(col, val, x, crow[r], crow[r + 1], t, kThreads);
  acc = warp_sum(acc);
  if ((t & 31) == 0) part[t >> 5] = acc;
  __syncthreads();
  if (t < 32) {
    T v = t < kThreads / 32 ? part[t] : T(0);
    v = warp_sum(v);
    if (t == 0) y[r] = v;
  }
}

template <typename T>
int launch(const int* crow, const int* col, const T* val, const T* x, T* y,
           int rows, long long nnz, void* stream) {
  if (rows < 0 || nnz < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nnz >= 1024LL * rows) {
    spmv_block_kernel<T><<<rows, kThreads, 0, s>>>(crow, col, val, x, y);
  } else {
    const int per_block = kThreads / 32;
    const int blocks = (rows + per_block - 1) / per_block;
    spmv_warp_kernel<T><<<blocks, kThreads, 0, s>>>(crow, col, val, x, y,
                                                    rows);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// 1 when rows of this shape take the block-a-row kernel, 0 for a warp a
// row: the same rule as the launch.
extern "C" int csr_spmv_block_rows(int rows, long long nnz) {
  return rows > 0 && nnz >= 1024LL * rows ? 1 : 0;
}

// Launch y = A x on `stream` for a CSR A of `rows` rows; return the CUDA
// error of the launch (0 on success). Does not synchronise.
extern "C" int csr_spmv_f32_launch(const int* crow, const int* col,
                                   const float* val, const float* x, float* y,
                                   int rows, long long nnz, void* stream) {
  return launch<float>(crow, col, val, x, y, rows, nnz, stream);
}

extern "C" int csr_spmv_f64_launch(const int* crow, const int* col,
                                   const double* val, const double* x,
                                   double* y, int rows, long long nnz,
                                   void* stream) {
  return launch<double>(crow, col, val, x, y, rows, nnz, stream);
}
