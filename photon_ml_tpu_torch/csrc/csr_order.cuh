// The deterministic CSR products of kernel rows 9 and 10 (csr_spmv.cu,
// csr_spmm.cu) for Hopper (sm_90a): one kernel, templated on the number
// of panel columns W it sums at once (W = 1 is row 9's matrix-vector
// product):
//
//   Y[r, c0 + j] = sum_{k in [crow[r], crow[r + 1])} val[k] * X[col[k], c0 + j]
//
// with crow int32 [rows + 1], col int32 [nnz], val float32 or float64, X
// row-major [n_cols, n] and Y row-major [rows, n] of val's type, summed in
// that type without fused multiply-adds (-fmad=false,
// ops/cuda_build.COMPILE_FLAGS).
//
// THE ORDER CONTRACT. The order of every addition of a row depends only on
// the row's own length m and on the compile-time constants below, never
// on where the row lies in memory, on the other rows of the matrix, on
// the shard it belongs to, on W or on n:
//
//   - the row is cut into chunks of kChunk consecutive entries (the last
//     one shorter); a row of at most kChunk entries is one chunk;
//   - a chunk is summed by G lanes, G = the smallest power of two >= m / 4,
//     at most 32 (so 32 for every row of more than 64 entries, and for
//     every chunk of a cut row): lane t adds the chunk's entries t, t + G,
//     t + 2G, ... in order to a sum that starts at 0, and the G lane sums
//     are added by an xor butterfly (offsets G/2, ..., 2, 1: the sum of
//     lane t and lane t ^ o at each step);
//   - the row is the sum of its chunks' sums in chunk order, P0 + P1 + ...;
//     an empty row is 0.
//
// So the same row gives the same bits in any matrix, a row-10 column j is
// row 9's bits on column j of X by construction, and a shard's partials
// repeat whatever else the shard cache holds. Which warps compute a row
// is a matter of speed only.
//
// Execution. A block is kWarps warps. Warp w of block x owns a tile of R
// consecutive rows (R = 32 / G of the average row length, chosen at
// launch): its lanes read the tile's row lengths, and for each lane count
// G = 1, 2, ..., 32 the rows of that class are shared out to the warp's
// 32 / G groups of G lanes in turn (a ballot, ranks in shared memory), so
// short rows keep every lane busy (MF's entity x row CSR, ~2.4 entries a
// row, puts 32 rows on a warp); a tile of one row (65 entries or more on
// average: the shard block's 200) goes to its G lanes without ranking,
// the warp's stride then known at compile time. Rows of more than kChunk
// entries (the
// transposes of the shard blocks: one row per feature, one entry per row
// of the shard) go chunk by chunk to whole warps, over the grid's y
// dimension: block (x, y) takes chunks y, y + gridDim.y, ... of the long
// rows of its tiles, so the full-width transpose (200 rows of 16,384
// entries) fills the card. A chunk's sums go to scratch at slot
// r + crow[r] / kChunk + k (distinct for every chunk of every row); the
// warp that finishes a row's last chunk (a per-row counter, atomic, which
// that warp sets back to 0 for the next launch) adds the row's chunk sums
// in chunk order and writes the row. Without scratch (no row can be long)
// a warp adds a long row's chunks itself, in the same order. Per entry a
// lane reads its value and column index and gathers X's row, as W values
// in 16- or 8-byte vectors where the panel's rows allow; U entries are
// loaded before any is added, for U independent loads in flight.
//
// Bound on the H100: bytes. Each entry reads its value and column index
// (8 or 12 bytes) and gathers W panel values, which stay in L2 (the panel
// is at most a few MB on the main path); each row reads its offsets and
// writes W results.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace csr_order {

// kChunk is part of the order contract: another value gives other bits.
// kLoads sets the entries a lane loads ahead (U = kLoads / W, 1 to 8) and
// kMinBlocks caps the registers (64 at 4 blocks of 256 threads an SM).
// On the H100 sweeps of chunks of 512, 1024 and 2048 entries, 16, 32 and
// 64 loads, 1 to 8 blocks and the load's cache hint found nothing faster
// for the 16,384 x 200 block's products (PERF.md), nor did staging the
// entries in shared memory by cp.async, loading the next step's entries
// ahead, or a plain strided loop for row 9.
constexpr int kChunk = 1024;  // entries of a chunk of a long row
constexpr int kLoads = 16;
constexpr int kMinBlocks = 4;
constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kLong = 6;  // the class of a row of more than kChunk entries
constexpr unsigned kFull = 0xffffffffu;

// log2 G for a row of m <= kChunk entries: G = the smallest power of two
// >= m / 4, at most 32.
__host__ __device__ __forceinline__ int lane_class(long long m) {
  int c = 0;
  while (c < 5 && (4LL << c) < m) ++c;
  return c;
}

// Entries each lane loads before it adds any: about kLoads panel values
// in registers, 1 to 8 entries.
template <int W>
__host__ __device__ constexpr int unroll() {
  return kLoads / W < 1 ? 1 : (kLoads / W > 8 ? 8 : kLoads / W);
}

template <typename T>
struct Args {
  const int* crow;
  const int* col;
  const T* val;
  const T* X;     // the panel's column c0, row stride n
  T* Y;           // the output's column c0, row stride n
  T* part;        // chunk sums [slots, W], or null
  int* counter;   // per-row chunk counters, 0 between launches, or null
  int rows;
  int n;
  int R;          // rows a warp's tile
  bool vec;       // X's rows start on 16 (W * sizeof(T) % 16 == 0) or 8
                  // (W * sizeof(T) == 8) bytes
};

// One product's operands as the wrapper keeps them, made once per CSR and
// panel width (ops/spmv.py _Call has the same layout): part (scratch_slots
// x min(n, 32) values) and counter (rows int32, all 0) are both null or
// both given.
struct Call {
  const int* crow;
  const int* col;
  const void* val;
  void* part;
  int* counter;
  long long nnz;
  long long n_cols;
  int rows;
  int n;
};

// One panel row's W values.
template <int W, typename T>
__device__ __forceinline__ void load_row(const T* p, bool vec, T (&o)[W]) {
  constexpr int B = W * (int)sizeof(T);
  if constexpr (B % 16 == 0) {
    if (vec) {
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int i = 0; i < W / 4; ++i) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
          o[4 * i] = v.x;
          o[4 * i + 1] = v.y;
          o[4 * i + 2] = v.z;
          o[4 * i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < W / 2; ++i) {
          const double2 v = __ldg(reinterpret_cast<const double2*>(p) + i);
          o[2 * i] = v.x;
          o[2 * i + 1] = v.y;
        }
      }
      return;
    }
  } else if constexpr (B == 8 && sizeof(T) == 4) {
    if (vec) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(p));
      o[0] = v.x;
      o[1] = v.y;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < W; ++j) o[j] = __ldg(p + j);
}

// Values and column indices of entries k, k + G, ..., k + (U - 1) G
// below end (0 past it).
template <int U, typename T>
__device__ __forceinline__ void load_entries(const Args<T>& a, int k,
                                             int end, const int G,
                                             int (&c)[U], T (&v)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int ku = k + u * G;
    c[u] = ku < end ? __ldcs(a.col + ku) : 0;
    v[u] = ku < end ? __ldcs(a.val + ku) : T(0);
  }
}

// acc[j] += val[k] * X[col[k], j] for k = k0, k0 + G, ... < end, in order,
// U entries a step: their values, column indices and panel rows are all
// loaded before the first of them is added.
template <int W, typename T>
__device__ __forceinline__ void lane_part(const Args<T>& a, int k, int end,
                                          const int G, T (&acc)[W]) {
  constexpr int U = unroll<W>();
  for (; k < end; k += U * G) {
    int c[U];
    T v[U];
    load_entries<U>(a, k, end, G, c, v);
    T x[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k + u * G < end)
        load_row<W>(a.X + (size_t)c[u] * a.n, a.vec, x[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k + u * G < end) {
#pragma unroll
        for (int j = 0; j < W; ++j) acc[j] += v[u] * x[u][j];
      }
  }
}

// lane_part for a whole warp: the stride 32 known at compile time.
template <int W, typename T>
__device__ __forceinline__ void warp_part(const Args<T>& a, int k, int end,
                                          T (&acc)[W]) {
  lane_part<W>(a, k, end, 32, acc);
}

// The xor butterfly over aligned groups of G lanes (every lane of the
// warp takes part; each group's lanes end with the same bits).
template <int W, typename T>
__device__ __forceinline__ void butterfly(int G, T (&acc)[W]) {
  for (int o = G >> 1; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] += __shfl_xor_sync(kFull, acc[j], o);
}

// The chunk [k0, end) of a row by the whole warp (G = 32).
template <int W, typename T>
__device__ __forceinline__ void chunk_sum(const Args<T>& a, int k0, int end,
                                          int lane, T (&acc)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = T(0);
  warp_part<W>(a, k0 + lane, end, acc);
  butterfly<W>(32, acc);
}

// Row r's W results, the lanes of its group sharing the columns.
template <int W, typename T>
__device__ __forceinline__ void store_row(const Args<T>& a, int r,
                                          const T (&acc)[W], int t, int G) {
  T* y = a.Y + (size_t)r * a.n;
#pragma unroll
  for (int j = 0; j < W; ++j)
    if ((j & (G - 1)) == t) y[j] = acc[j];
}

// The rows of lane class c in the warp's tile, a group of G = 2^c lanes a
// row. owner[] ranks the rows of the class; row, beg, len are the tile's
// (lane i holds row i of the tile).
template <int W, typename T>
__device__ __forceinline__ void class_rows(const Args<T>& a, int c, int cls,
                                           int row, int beg, int len,
                                           int lane, int* owner) {
  const unsigned m = __ballot_sync(kFull, cls == c);
  if (m == 0) return;
  if (cls == c) owner[__popc(m & ((1u << lane) - 1u))] = lane;
  __syncwarp();
  const int G = 1 << c, groups = 32 >> c, t = lane & (G - 1);
  const int count = __popc(m);
  for (int first = 0; first < count; first += groups) {
    const int idx = first + (lane >> c);
    const bool mine = idx < count;
    const int src = mine ? owner[idx] : 0;
    const int r = __shfl_sync(kFull, row, src);
    const int b = __shfl_sync(kFull, beg, src);
    int l = __shfl_sync(kFull, len, src);
    if (!mine) l = 0;
    T acc[W];
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] = T(0);
    if (G == 32)
      warp_part<W>(a, b + t, b + l, acc);
    else
      lane_part<W>(a, b + t, b + l, G, acc);
    butterfly<W>(G, acc);
    if (mine) store_row<W>(a, r, acc, t, G);
  }
  __syncwarp();  // owner[] is rewritten by the next class
}

// The long rows (more than kChunk entries) of the warp's tile, in tile
// order: chunks blockIdx.y, blockIdx.y + gridDim.y, ...
template <int W, typename T>
__device__ __forceinline__ void long_rows(const Args<T>& a, int cls, int row,
                                          int beg, int len, int lane) {
  unsigned m = __ballot_sync(kFull, cls == kLong);
  while (m != 0) {
    const int src = __ffs(m) - 1;
    m &= m - 1u;
    const int r = __shfl_sync(kFull, row, src);
    const int b = __shfl_sync(kFull, beg, src);
    const int l = __shfl_sync(kFull, len, src);
    const int K = (l + kChunk - 1) / kChunk;
    T acc[W];
    if (a.part == nullptr) {
      // One warp adds every chunk, in order.
      T p[W];
      for (int k = 0; k < K; ++k) {
        chunk_sum<W>(a, b + k * kChunk, b + (k + 1 == K ? l : (k + 1) * kChunk),
                     lane, p);
#pragma unroll
        for (int j = 0; j < W; ++j) acc[j] = k == 0 ? p[j] : acc[j] + p[j];
      }
      if (lane == 0) store_row<W>(a, r, acc, 0, 1);
      continue;
    }
    const size_t slot0 = (size_t)r + b / kChunk;
    for (int k = blockIdx.y; k < K; k += gridDim.y) {
      chunk_sum<W>(a, b + k * kChunk, b + (k + 1 == K ? l : (k + 1) * kChunk),
                   lane, acc);
      int done = 0;
      if (lane == 0) {
        T* out = a.part + (slot0 + k) * W;
#pragma unroll
        for (int j = 0; j < W; ++j) out[j] = acc[j];
        __threadfence();
        done = atomicAdd(a.counter + r, 1) == K - 1;
      }
      if (!__shfl_sync(kFull, done, 0)) continue;
      // The row's last chunk: add its chunk sums in chunk order.
      __threadfence();
      const T* p = a.part + slot0 * W;
      if (W == 1) {
        // Lanes fetch, lane 0 adds: the chain is the additions alone.
        T s = T(0);
        for (int k0 = 0; k0 < K; k0 += 32) {
          const T mine = k0 + lane < K ? __ldcg(p + k0 + lane) : T(0);
          const int n_here = K - k0 < 32 ? K - k0 : 32;
          for (int i = 0; i < n_here; ++i) {
            const T v = __shfl_sync(kFull, mine, i);
            s = (k0 == 0 && i == 0) ? v : s + v;
          }
        }
        if (lane == 0) a.Y[(size_t)r * a.n] = s;
      } else if (lane < W) {
        T s = __ldcg(p + lane);
        for (int i = 1; i < K; ++i) s += __ldcg(p + (size_t)i * W + lane);
        a.Y[(size_t)r * a.n + lane] = s;
      }
      if (lane == 0) a.counter[r] = 0;
    }
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    csr_kernel(const Args<T> a) {
  __shared__ int owner[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long first =
      ((long long)blockIdx.x * kWarps + warp) * (long long)a.R;
  int row = 0, beg = 0, len = 0, cls = -1;
  if (lane < a.R && first + lane < a.rows) {
    row = (int)(first + lane);
    beg = a.crow[row];
    len = a.crow[row + 1] - beg;
    cls = len > kChunk ? kLong : lane_class(len);
  }
  if (a.R == 1) {
    // One row a warp (rows of 65 entries or more on average): the row's
    // G lanes take it where it is not cut into chunks, with no ranking.
    row = __shfl_sync(kFull, row, 0);
    beg = __shfl_sync(kFull, beg, 0);
    len = __shfl_sync(kFull, len, 0);
    cls = __shfl_sync(kFull, cls, 0);
    if (blockIdx.y == 0 && cls >= 0 && cls < kLong) {
      const int G = 1 << cls;
      T acc[W];
#pragma unroll
      for (int j = 0; j < W; ++j) acc[j] = T(0);
      if (G == 32)
        warp_part<W>(a, beg + lane, beg + len, acc);
      else if (lane < G)
        lane_part<W>(a, beg + lane, beg + len, G, acc);
      butterfly<W>(G, acc);
      if (lane < G) store_row<W>(a, row, acc, lane, G);
    }
    if (cls == kLong) long_rows<W>(a, lane == 0 ? kLong : -1, row, beg, len,
                                   lane);
    return;
  }
  if (blockIdx.y == 0) {
    for (int c = 0; c <= 5; ++c)
      class_rows<W>(a, c, cls, row, beg, len, lane, owner[warp]);
  }
  long_rows<W>(a, cls, row, beg, len, lane);
}

// Chunk-sum slots a product needs: 0 when no row can be cut (n_cols or
// nnz at most kChunk: a row's entries have distinct columns), else rows +
// nnz / kChunk (slot r + crow[r] / kChunk + k is below it).
__host__ __forceinline__ long long scratch_slots(int rows, long long nnz,
                                                 long long n_cols) {
  if (rows <= 0 || n_cols <= kChunk || nnz <= kChunk) return 0;
  return (long long)rows + nnz / kChunk;
}

// Launch one column tile of W columns; returns the CUDA error.
template <typename T, int W>
int launch_tile(Args<T> a, long long nnz, long long n_cols, cudaStream_t s) {
  // Entry indices are int: leave room for a step past the last entry.
  if (nnz > 0x7fffffffLL - 2 * 8 * 32) return (int)cudaErrorInvalidValue;
  const long long avg = a.rows > 0 ? (nnz + a.rows - 1) / a.rows : 0;
  a.R = avg > kChunk ? 1 : 32 >> lane_class(avg);
  const long long tiles = (a.rows + a.R - 1) / a.R;
  const long long gx = (tiles + kWarps - 1) / kWarps;
  long long gy = 1;
  if (a.part != nullptr) {
    const long long bound = n_cols < nnz ? n_cols : nnz;
    gy = (bound + kChunk - 1) / kChunk;
    if (gy > 65535) gy = 65535;
    if (gy < 1) gy = 1;
  }
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  csr_kernel<T, W><<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace csr_order
