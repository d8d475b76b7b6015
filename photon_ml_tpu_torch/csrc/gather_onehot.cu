// One-hot gather on the tensor cores for Hopper (sm_90a):
//
//   out[b, i] = mask[b, i] * float(bf16(w_blk[b, local[b, i]]))
//
// over indices grouped by 2048-wide column block (local [kb, e] int32,
// mask [kb, e] float32, w_blk [kb, 2048] float32, out [kb, e] float32).
//
// Replaces the Pallas TPU kernel of dev_scripts/gather_experiments.py
// (build_onehot_call :110, pl.pallas_call at :142, kernel :133-140): per
// block a one-hot [512, 2048] bf16 matrix times the block's w slice on the
// MXU, float32 accumulation. The function is the same, and so is the
// formulation the experiment measures: a one-hot contraction on the
// matrix units, against a direct gather (csrc/gather_residue.cu and
// torch's w[idx]). A row of the one-hot matrix has one non-zero, so the
// float32 sum is exactly bf16(w) at the selected column.
//
// Design: one CTA of 8 warps per (block b, 1,024 slots); the block's w
// slice is staged once in shared memory as bf16 (4 KB). Each warp takes
// 16 slots at a time and walks the block's 2,048 columns in 128 depth
// steps of mma.sync.m16n8k16 (bf16 in, float32 accumulate): the A
// fragment (16 slots x 16 columns) is built in registers by comparing
// each slot's local index with the step's columns (bf16 1.0 = 0x3F80);
// the B fragment (16 columns x 8) holds the w slice in column 0 and zeros
// in the other seven. Column 0 of the accumulator is the gathered value,
// multiplied by the mask on the way out.
//
// Bound on the H100: the bytes are local, mask and out once (12 per slot)
// plus the w table, but the one-hot formulation does 2,048 multiply-adds
// per slot on the tensor cores (8x that with n = 8 padding, and the A
// fragments cost integer compares), so operations, not bytes, bound it,
// and it cannot approach a direct gather's time. Packing 8 blocks into
// the 8 columns of n, wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 2048;  // w columns per block
constexpr int kWarps = 8;  // warps per CTA
constexpr int kTilesPerWarp = 8;  // 16-slot tiles per warp
constexpr int kSlotsPerCta = kWarps * kTilesPerWarp * 16;
constexpr uint32_t kOneLow = 0x3F80u;  // bf16 1.0 in the low half
constexpr uint32_t kOneHigh = 0x3F800000u;  // bf16 1.0 in the high half

// Two adjacent one-hot entries of a slot whose local index is `loc`:
// columns `col` (low half) and `col + 1` (high half).
__device__ __forceinline__ uint32_t onehot_pair(int loc, int col) {
  return (loc == col ? kOneLow : 0u) | (loc == col + 1 ? kOneHigh : 0u);
}

__global__ void __launch_bounds__(kWarps * 32)
    onehot_kernel(const int* __restrict__ local,
                  const float* __restrict__ mask,
                  const float* __restrict__ w_blk, float* __restrict__ out,
                  int e) {
  __shared__ __align__(16) __nv_bfloat16 w_sh[kBlock];
  const int b = blockIdx.y;
  const float* w_row = w_blk + (size_t)b * kBlock;
  for (int i = threadIdx.x; i < kBlock; i += blockDim.x)
    w_sh[i] = __float2bfloat16_rn(w_row[i]);
  __syncthreads();

  const uint32_t* w_pairs = reinterpret_cast<const uint32_t*>(w_sh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane >> 2, tig = lane & 3;  // fragment row, column pair
  const int* l_row = local + (size_t)b * e;
  const float* m_row = mask + (size_t)b * e;
  float* o_row = out + (size_t)b * e;
  const int cta_base = blockIdx.x * kSlotsPerCta;
  for (int tile = 0; tile < kTilesPerWarp; ++tile) {
    const int base = cta_base + (tile * kWarps + warp) * 16;
    if (base >= e) break;  // warp-uniform
    const int s0 = base + group, s1 = s0 + 8;  // the lane's two A rows
    const int l0 = s0 < e ? l_row[s0] : -1;
    const int l1 = s1 < e ? l_row[s1] : -1;
    float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
    for (int k0 = 0; k0 < kBlock; k0 += 16) {
      const int c = k0 + 2 * tig;
      const uint32_t a0 = onehot_pair(l0, c), a1 = onehot_pair(l1, c);
      const uint32_t a2 = onehot_pair(l0, c + 8), a3 = onehot_pair(l1, c + 8);
      // B column n = group: only column 0 holds w.
      const uint32_t b0 = group == 0 ? w_pairs[c >> 1] : 0u;
      const uint32_t b1 = group == 0 ? w_pairs[(c + 8) >> 1] : 0u;
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
    // Accumulator column 0 (tig 0): d0 is row s0, d2 row s1.
    if (tig == 0) {
      if (s0 < e) o_row[s0] = d0 * m_row[s0];
      if (s1 < e) o_row[s1] = d2 * m_row[s1];
    }
  }
}

}  // namespace

// Launches the gather of kb x e slots on `stream`; returns the CUDA error
// of the launch (0 on success). Does not synchronise. A local index
// outside [0, 2048) matches no column and gives 0.
extern "C" int gather_onehot_launch(const int* local, const float* mask,
                                    const float* w_blk, float* out, int kb,
                                    int e, void* stream) {
  if (kb <= 0 || e <= 0) return (int)cudaErrorInvalidValue;
  const long long chunks = ((long long)e + kSlotsPerCta - 1) / kSlotsPerCta;
  if (kb > 65535 || chunks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)chunks, (unsigned)kb);
  onehot_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      local, mask, w_blk, out, e);
  return (int)cudaGetLastError();
}
