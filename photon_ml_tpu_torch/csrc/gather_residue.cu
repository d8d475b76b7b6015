// Residue-class gather for Hopper (sm_90a):
//
//   out[l, p] = w[idx[l, p] * 128 + l]
//
// with w float32 [a * 128] (the table T = w.view(a, 128), column l holding
// the coefficients of residue class l), idx int32 [128, per_lane] holding
// j // 128 for an index j of residue l = j mod 128 (lane l's stream of
// lookups, in order), and out float32 [128, per_lane], exactly.
//
// Replaces the Pallas TPU kernel of dev_scripts/gather_experiments.py
// (build_residue_call :209, pl.pallas_call at :220, kernel :217-218): the
// whole table resident in VMEM and a lane-local dynamic gather, lane l
// reading only T[:, l], over residue-class-packed indices. Its [chunks,
// a, 128] index array is the transpose of these lane-major streams, which
// are padded only to a multiple of 4 (16 bytes) where the TPU's blocks
// padded each stream to a multiple of a (ops/gather.py: lane_major,
// pack_residue).
//
// Design: one CTA per residue class, 128 CTAs on the 132 SMs, one wave.
// CTA l holds its column T[:, l] in shared memory (a floats: 62.5 KB at
// d = 2M), then reads its stream of indices in order with 16-byte
// streaming loads and writes its outputs in order with 16-byte streaming
// stores; the random reads are shared-memory reads (banks j mod 32, a
// few-way conflict on uniform indices). The column is one float in every
// 512-byte row of w, and 8 neighbouring classes share each 32-byte
// sector, so each CTA stages it with strided reads from w, eight loads in
// flight per thread, that L2 serves (8 MB at d = 2M; the 8 CTAs of a
// sector each fetch it). Clusters of 8 CTAs that read whole sectors and
// scatter them through distributed shared memory, each sector leaving L2
// once, were measured and dropped: 0.062 ms on the device against 0.057
// (PERF.md).
//
// Where the column does not fit a block's opt-in shared memory (d > ~7.4M)
// the l2 layout reads each element in place from device memory.
//
// An index outside [0, a) reads nothing and gives NaN.
//
// Bound on the H100: bytes. Each output reads its index and writes its
// value (8 bytes) and the table is read once; no arithmetic to speak of.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 1024;  // one CTA per class
constexpr int kL2Threads = 256;

__device__ __forceinline__ float pick(const float* col, int j, int a) {
  return (unsigned)j < (unsigned)a ? col[j] : NAN;
}

// Class l's stream: out[p] = col[src[p]], 16 bytes at a time between a
// scalar head (to src's 16-byte boundary; dst shares its offset, both
// bases being 16-byte aligned) and a scalar tail, four loads in flight
// per thread.
__device__ __forceinline__ void stream_class(const float* col,
                                             const int* __restrict__ src,
                                             float* __restrict__ dst,
                                             long long n, int a) {
  const int t = threadIdx.x;
  long long head = (long long)((16 - ((uintptr_t)src & 15)) & 15) / 4;
  if (head > n) head = n;
  if (t < head) dst[t] = pick(col, __ldcs(src + t), a);
  const long long n4 = (n - head) / 4;
  const int4* s4 = reinterpret_cast<const int4*>(src + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  long long q = t;
  for (; q + 3 * kThreads < n4; q += 4 * kThreads) {
    int4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __ldcs(s4 + q + k * kThreads);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 o = {pick(col, v[k].x, a), pick(col, v[k].y, a),
                        pick(col, v[k].z, a), pick(col, v[k].w, a)};
      __stcs(d4 + q + k * kThreads, o);
    }
  }
  for (; q < n4; q += kThreads) {
    const int4 v = __ldcs(s4 + q);
    const float4 o = {pick(col, v.x, a), pick(col, v.y, a),
                      pick(col, v.z, a), pick(col, v.w, a)};
    __stcs(d4 + q, o);
  }
  const long long tail = head + 4 * n4;
  if (tail + t < n) dst[tail + t] = pick(col, __ldcs(src + tail + t), a);
}

// CTA l stages its column, w[j * 128 + l] for every j, then streams its
// lookups.
__global__ void __launch_bounds__(kThreads)
    residue_column_kernel(const float* __restrict__ w,
                          const int* __restrict__ idx,
                          float* __restrict__ out, long long n, int a) {
  extern __shared__ float col[];
  const int l = blockIdx.x;
  int j = threadIdx.x;
  for (; j + 7 * kThreads < a; j += 8 * kThreads) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = __ldg(w + (size_t)(j + k * kThreads) * kLanes + l);
#pragma unroll
    for (int k = 0; k < 8; ++k) col[j + k * kThreads] = v[k];
  }
  for (; j < a; j += kThreads) col[j] = __ldg(w + (size_t)j * kLanes + l);
  __syncthreads();
  stream_class(col, idx + (size_t)l * n, out + (size_t)l * n, n, a);
}

// The l2 layout: each thread reads its element in place.
__global__ void __launch_bounds__(kL2Threads)
    residue_l2_kernel(const float* __restrict__ w,
                      const int* __restrict__ idx, float* __restrict__ out,
                      long long n, int a) {
  const long long o = (long long)blockIdx.x * kL2Threads + threadIdx.x;
  if (o >= (long long)kLanes * n) return;
  const int j = idx[o];
  out[o] = (unsigned)j < (unsigned)a
               ? __ldg(w + (long long)j * kLanes + o / n)
               : NAN;
}

// Whether the column fits a block's opt-in shared memory (`optin` bytes).
int column_fits(int a, int* fits, int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  *fits = (size_t)a * sizeof(float) <= (size_t)*optin;
  return 0;
}

}  // namespace

// The layout a gather over a table of a * 128 floats takes on the current
// device: 0 column, 1 l2; negative on a CUDA error.
extern "C" int gather_residue_layout(int a) {
  int fits = 0, optin = 0;
  const int err = column_fits(a, &fits, &optin);
  return err != 0 ? -err : (fits ? 0 : 1);
}

// Launches the gather of 128 streams of n lookups each on `stream`;
// returns the CUDA error of the launch (0 on success). Does not
// synchronise. An entry of idx outside [0, a) gives NaN; w, idx and out
// must be 16-byte aligned.
extern "C" int gather_residue_launch(const float* w, const int* idx,
                                     float* out, long long n, int a,
                                     void* stream) {
  if (n <= 0 || a <= 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(idx) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  int fits = 0, optin = 0;
  int err = column_fits(a, &fits, &optin);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fits) {
    const size_t bytes = (size_t)a * sizeof(float);
    // The card's opt-in budget, the same on every call (a launch of a
    // smaller table never lowers it under a larger one's).
    if (bytes > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          residue_column_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin);
      if (e != cudaSuccess) return (int)e;
    }
    residue_column_kernel<<<kLanes, kThreads, bytes, s>>>(w, idx, out, n, a);
  } else {
    const long long blocks = (kLanes * n + kL2Threads - 1) / kL2Threads;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    residue_l2_kernel<<<(unsigned)blocks, kL2Threads, 0, s>>>(w, idx, out, n,
                                                             a);
  }
  return (int)cudaGetLastError();
}
