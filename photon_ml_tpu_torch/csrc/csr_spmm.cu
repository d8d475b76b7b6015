// Deterministic CSR x dense-panel product for Hopper (sm_90a):
//
//   Y[r, j] = sum_{k in [crow[r], crow[r + 1])} val[k] * X[col[k], j]
//
// with crow int32 [rows + 1], col int32 [nnz], val float32 or float64, X
// row-major [cols, n] and Y row-major [rows, n] of val's type, summed in
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
// Its reason to exist is determinism, as for csr_spmv.cu: every column is
// summed in exactly that kernel's order. A group of G threads owns a row
// (G = 32, a warp a row, or G = 256, a block a row where rows average
// 1,024 entries or more: the same rule on the same CSR); thread t of the
// group sums the row's entries t, t + G, t + 2G, ... in order, and the
// group adds its G partials by the same fixed butterfly. So column j of
// the product is the same bits as csr_spmv on column j of X, and a grid
// lane's products equal the scalar path's. Columns are taken NT at a time
// (one accumulator each in registers); the order of the additions of a
// column does not depend on n or on its tile. No fused multiply-add
// (-fmad=false, cuda_build.COMPILE_FLAGS).
//
// Bound on the H100: bytes. Each entry reads its value and column index
// and gathers n elements of X; each row writes n results.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;  // columns summed together

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// acc[j] = sum over the group's strided entries of val[k] * X[col[k], c0 + j]
template <typename T>
__device__ __forceinline__ void row_part(const int* __restrict__ col,
                                         const T* __restrict__ val,
                                         const T* __restrict__ X, int n,
                                         int c0, int nt, int begin, int end,
                                         int lane, int group, T (&acc)[kTile]) {
#pragma unroll
  for (int j = 0; j < kTile; ++j) acc[j] = T(0);
  for (int k = begin + lane; k < end; k += group) {
    const T v = val[k];
    const T* xr = X + (long long)col[k] * n + c0;
#pragma unroll
    for (int j = 0; j < kTile; ++j)
      if (j < nt) acc[j] += v * __ldg(xr + j);
  }
}

// G = 32: warp w of the block owns row blockIdx.x * 8 + w.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    spmm_warp_kernel(const int* __restrict__ crow, const int* __restrict__ col,
                     const T* __restrict__ val, const T* __restrict__ X,
                     T* __restrict__ Y, int rows, int n) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int begin = crow[r], end = crow[r + 1];
  for (int c0 = 0; c0 < n; c0 += kTile) {
    const int nt = n - c0 < kTile ? n - c0 : kTile;
    T acc[kTile];
    row_part(col, val, X, n, c0, nt, begin, end, lane, 32, acc);
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[j] = warp_sum(acc[j]);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kTile; ++j)
        if (j < nt) Y[r * n + c0 + j] = acc[j];
    }
  }
}

// G = 256: block b owns row b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    spmm_block_kernel(const int* __restrict__ crow, const int* __restrict__ col,
                      const T* __restrict__ val, const T* __restrict__ X,
                      T* __restrict__ Y, int n) {
  __shared__ T part[kTile][kThreads / 32];
  const long long r = blockIdx.x;
  const int t = threadIdx.x;
  const int begin = crow[r], end = crow[r + 1];
  for (int c0 = 0; c0 < n; c0 += kTile) {
    const int nt = n - c0 < kTile ? n - c0 : kTile;
    T acc[kTile];
    row_part(col, val, X, n, c0, nt, begin, end, t, kThreads, acc);
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      acc[j] = warp_sum(acc[j]);
      if ((t & 31) == 0) part[j][t >> 5] = acc[j];
    }
    __syncthreads();
    if (t < 32) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        T v = t < kThreads / 32 ? part[j][t] : T(0);
        v = warp_sum(v);
        if (t == 0 && j < nt) Y[r * n + c0 + j] = v;
      }
    }
    __syncthreads();  // part is rewritten by the next tile
  }
}

template <typename T>
int launch(const int* crow, const int* col, const T* val, const T* X, T* Y,
           int rows, long long nnz, int n, void* stream) {
  if (rows < 0 || nnz < 0 || n < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The row-to-group rule of csr_spmv.cu, unchanged.
  if (nnz >= 1024LL * rows) {
    spmm_block_kernel<T><<<rows, kThreads, 0, s>>>(crow, col, val, X, Y, n);
  } else {
    const int per_block = kThreads / 32;
    const int blocks = (rows + per_block - 1) / per_block;
    spmm_warp_kernel<T><<<blocks, kThreads, 0, s>>>(crow, col, val, X, Y,
                                                    rows, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launch Y = A X on `stream` for a CSR A of `rows` rows and a row-major
// panel X of n columns; return the CUDA error of the launch (0 on
// success). Does not synchronise.
extern "C" int csr_spmm_f32_launch(const int* crow, const int* col,
                                   const float* val, const float* X, float* Y,
                                   int rows, long long nnz, int n,
                                   void* stream) {
  return launch<float>(crow, col, val, X, Y, rows, nnz, n, stream);
}

extern "C" int csr_spmm_f64_launch(const int* crow, const int* col,
                                   const double* val, const double* X,
                                   double* Y, int rows, long long nnz, int n,
                                   void* stream) {
  return launch<double>(crow, col, val, X, Y, rows, nnz, n, stream);
}
