// Residue-class gather for Hopper (sm_90a):
//
//   out[c, s, l] = w[idx[c, s, l] * 128 + l]
//
// with w float32 [a * 128] (the table T = w.view(a, 128)), idx int32
// [chunks, a, 128] holding j // 128 for an index j of residue l = j mod
// 128, and out float32 [chunks, a, 128], exactly.
//
// Replaces the Pallas TPU kernel of dev_scripts/gather_experiments.py
// (build_residue_call :209, pl.pallas_call at :220, kernel :217-218): the
// whole table resident in VMEM and a lane-local dynamic gather, lane l
// reading only T[:, l], over residue-class-packed indices.
//
// Design: the residue packing maps onto shared-memory banks. Element
// j * 128 + l lies in bank l mod 32, so a warp over 32 consecutive l at a
// fixed (c, s) reads 32 distinct banks whatever the indices are: the
// gather has no bank conflicts. Two layouts, planned per launch from the
// card's opt-in shared memory (gather_residue_layout):
// - shared: where the table fits a block's opt-in shared memory (227 KB,
//   d <= ~56k floats), each block stages it with 16-byte loads, then
//   walks rows (c, s) of 128 lanes with a grid-stride loop, one thread a
//   lane; the grid is as many blocks as fit the SMs at once.
// - l2: where it does not fit (d = 2M is 8 MB), each thread reads its
//   element in place from device memory; the table stays in the 50 MB L2.
//
// An index outside [0, a) reads nothing and gives NaN.
//
// Bound on the H100: bytes. Each output reads its index and writes its
// value (8 bytes) and the table is read once; no arithmetic to speak of.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;  // two rows of 128 lanes per pass
constexpr int kRowsPerPass = kThreads / kLanes;
constexpr int kMaxBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
    residue_shared_kernel(const float* __restrict__ w,
                          const int* __restrict__ idx,
                          float* __restrict__ out, long long rows, int a) {
  extern __shared__ float4 table4[];
  const float* table = reinterpret_cast<const float*>(table4);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const int n4 = a * (kLanes / 4);
  for (int i = threadIdx.x; i < n4; i += kThreads) table4[i] = w4[i];
  __syncthreads();
  const int l = threadIdx.x & (kLanes - 1);
  for (long long row = (long long)blockIdx.x * kRowsPerPass +
                       threadIdx.x / kLanes;
       row < rows; row += (long long)gridDim.x * kRowsPerPass) {
    const long long o = row * kLanes + l;
    const int j = idx[o];
    out[o] = (unsigned)j < (unsigned)a ? table[j * kLanes + l] : NAN;
  }
}

__global__ void __launch_bounds__(kThreads)
    residue_l2_kernel(const float* __restrict__ w,
                      const int* __restrict__ idx, float* __restrict__ out,
                      long long n, int a) {
  const long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (o >= n) return;
  const int j = idx[o];
  out[o] = (unsigned)j < (unsigned)a
               ? __ldg(w + (long long)j * kLanes + (o & (kLanes - 1)))
               : NAN;
}

struct Plan {
  int shared;  // 1: the table in shared memory, 0: read in place
  size_t bytes;  // the table's bytes
  int grid;  // blocks of the shared layout
};

int make_plan(int a, long long rows, Plan* plan) {
  int dev = 0, optin = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  plan->bytes = (size_t)a * kLanes * sizeof(float);
  plan->shared = plan->bytes <= (size_t)optin;
  int per = plan->shared ? (int)(per_sm / (plan->bytes + 1024)) : 0;
  per = per < 1 ? 1 : (per > kMaxBlocksPerSm ? kMaxBlocksPerSm : per);
  long long want = (rows + kRowsPerPass - 1) / kRowsPerPass;
  long long cap = (long long)sms * per;
  plan->grid = (int)(want < cap ? want : cap);
  return 0;
}

}  // namespace

// The layout a gather over a table of a * 128 floats takes on the current
// device: 0 shared, 1 l2; negative on a CUDA error.
extern "C" int gather_residue_layout(int a) {
  Plan plan;
  int err = make_plan(a, 1, &plan);
  return err != 0 ? -err : (plan.shared ? 0 : 1);
}

// Launches the gather of chunks x a x 128 outputs on `stream`; returns the
// CUDA error of the launch (0 on success). Does not synchronise. An entry
// of idx outside [0, a) gives NaN; w must be 16-byte aligned.
extern "C" int gather_residue_launch(const float* w, const int* idx,
                                     float* out, int chunks, int a,
                                     void* stream) {
  if (chunks <= 0 || a <= 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(w) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long rows = (long long)chunks * a;
  Plan plan;
  int err = make_plan(a, rows, &plan);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan.shared) {
    if (plan.bytes > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          residue_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)plan.bytes);
      if (e != cudaSuccess) return (int)e;
    }
    residue_shared_kernel<<<plan.grid, kThreads, plan.bytes, s>>>(
        w, idx, out, rows, a);
  } else {
    const long long n = rows * kLanes;
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    residue_l2_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(w, idx, out, n,
                                                            a);
  }
  return (int)cudaGetLastError();
}
