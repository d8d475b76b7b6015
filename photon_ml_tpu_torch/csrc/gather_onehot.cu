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
// Design. The block's w slice is viewed as B = [K = 2048 / N, N] in bf16,
// so every one of B's N columns holds w: the one-hot row of slot s sits
// at k = local >> log2 N, C[s, n] = bf16(w[k N + n]) exactly, and the
// result is C[s, local & (N - 1)]. Per 16 lookups that is 16
// mma.sync.m16n8k16 (K / 16 depth steps times N / 8 column tiles), 2,048
// multiply-adds per lookup. A row's one lies in one depth step, so each
// lane finds its A-fragment word once per row and each step's fragment
// is four selects.
//
// One CTA walks all of one block's slots, so each w slice is read from
// device memory once: it is staged in shared memory as bf16 (4 KB), and
// each warp then holds the whole B operand in registers (32 per lane)
// for every slot of the block. A warp takes 128 slots at a time: local
// and mask arrive by 16-byte coalesced loads (where e is a multiple of 4
// and the rows are aligned), the local indices pass through the warp's
// slice of shared memory to the fragment rows, each result is written
// there by the one lane whose accumulator fragment holds its column, and
// the 128 results leave, times the mask, by 16-byte stores. N (8, 16,
// 32 or 64) and the warps per CTA are launch arguments, so one build
// sweeps them.
//
// Bound on the H100: the bytes are local, mask and out once (12 per slot)
// plus the table, 156 MB at m = 12M (46.7 us at 3.35 TB/s); the
// operations are 2,048 multiply-adds per slot on the tensor cores, 50.6
// GFLOP (51.2 us at the 989 TFLOP/s bf16 peak, which only wgmma reaches).
// So the operations bound it; what stands between the kernel and that
// bound is the instructions around each mma.sync (the fragment selects,
// the column select, the shared-memory staging), since mma.sync issues at
// most half of what wgmma reaches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 2048;  // w columns per block
constexpr int kChunk = 128;  // slots a warp takes at a time
constexpr uint32_t kOneLow = 0x3F80u;  // bf16 1.0 in the low half
constexpr uint32_t kOneHigh = 0x3F800000u;  // bf16 1.0 in the high half

// The A-fragment word a row's one sits in, on the lane (tig t) that holds
// it: depth position k within its step, k & 15, lies in word 0 (k & 15 <
// 8) or word 2, at lane t = (k & 7) >> 1, low half when k is even.
__device__ __forceinline__ uint32_t onehot_word(int k, int t) {
  return t == ((k & 7) >> 1) ? ((k & 1) ? kOneHigh : kOneLow) : 0u;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int N>
__global__ void __launch_bounds__(512)
    onehot_kernel(const int* __restrict__ local,
                  const float* __restrict__ mask,
                  const float* __restrict__ w_blk, float* __restrict__ out,
                  int e, bool vec) {
  constexpr int kSteps = kBlock / N / 16;  // depth steps of 16
  constexpr int kTiles = N / 8;  // column tiles of 8
  constexpr int kLog2N = N == 8 ? 3 : N == 16 ? 4 : N == 32 ? 5 : 6;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w_sh = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* loc_sh = reinterpret_cast<int*>(smem + 2 * kBlock) + warp * kChunk;
  float* res_sh = reinterpret_cast<float*>(smem + 2 * kBlock) +
                  warps * kChunk + warp * kChunk;

  const int b = blockIdx.x;
  const float* w_row = w_blk + (size_t)b * kBlock;
  if (vec) {
    for (int i = threadIdx.x; i < kBlock / 4; i += blockDim.x) {
      const float4 v = reinterpret_cast<const float4*>(w_row)[i];
      uint2 p;
      p.x = pack_bf16(__float2bfloat16_rn(v.x), __float2bfloat16_rn(v.y));
      p.y = pack_bf16(__float2bfloat16_rn(v.z), __float2bfloat16_rn(v.w));
      reinterpret_cast<uint2*>(w_sh)[i] = p;
    }
  } else {
    for (int i = threadIdx.x; i < kBlock; i += blockDim.x)
      w_sh[i] = __float2bfloat16_rn(w_row[i]);
  }
  __syncthreads();

  // B = w viewed [K, N]: lane (group g, tig t) holds, for depth step s and
  // column tile j, B[16 s + 2 t + {0, 1}, 8 j + g] and the same 8 deeper.
  const int g = lane >> 2, t = lane & 3;
  uint32_t bf[kSteps][kTiles][2];
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int k0 = 16 * s + 2 * t, n = 8 * j + g;
      bf[s][j][0] = pack_bf16(w_sh[k0 * N + n], w_sh[(k0 + 1) * N + n]);
      bf[s][j][1] =
          pack_bf16(w_sh[(k0 + 8) * N + n], w_sh[(k0 + 9) * N + n]);
    }

  const int* l_row = local + (size_t)b * e;
  const float* m_row = mask + (size_t)b * e;
  float* o_row = out + (size_t)b * e;
  const int chunks = (e + kChunk - 1) / kChunk;
  for (int chunk = warp; chunk < chunks; chunk += warps) {
    const int base = chunk * kChunk;
    const bool whole = vec && base + kChunk <= e;
    if (whole) {
      reinterpret_cast<int4*>(loc_sh)[lane] =
          reinterpret_cast<const int4*>(l_row + base)[lane];
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = base + lane + 32 * q;
        loc_sh[lane + 32 * q] = i < e ? l_row[i] : -1;
      }
    }
    __syncwarp();
    for (int tile = 0; tile < kChunk / 16; ++tile) {
      if (base + 16 * tile >= e) break;  // warp-uniform
      const int l0 = loc_sh[16 * tile + g], l1 = loc_sh[16 * tile + g + 8];
      // Row g's one sits at depth k0 = l0 >> log2 N: in step k0 >> 4 only
      // (arithmetic shifts: a negative index stays negative, one past the
      // block lands past the last step; neither matches a step).
      const int k0 = l0 >> kLog2N, k1 = l1 >> kLog2N;
      const int s0 = k0 >> 4, s1 = k1 >> 4;
      const bool hi0 = k0 & 8, hi1 = k1 & 8;
      const uint32_t one0 = onehot_word(k0, t), one1 = onehot_word(k1, t);
      float acc[kTiles][4];
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const uint32_t a[4] = {s == s0 && !hi0 ? one0 : 0u,
                               s == s1 && !hi1 ? one1 : 0u,
                               s == s0 && hi0 ? one0 : 0u,
                               s == s1 && hi1 ? one1 : 0u};
#pragma unroll
        for (int j = 0; j < kTiles; ++j) mma_bf16(acc[j], a, bf[s][j]);
      }
      // Column n of a row sits in tile n / 8, at fragment column
      // n % 8 = 2 t + (n & 1): lane t = (n >> 1) & 3 holds it.
      const int n0 = l0 & (N - 1), n1 = l1 & (N - 1);
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        if (j == n0 >> 3) v0 = (n0 & 1) ? acc[j][1] : acc[j][0];
        if (j == n1 >> 3) v1 = (n1 & 1) ? acc[j][3] : acc[j][2];
      }
      if (t == ((n0 >> 1) & 3)) res_sh[16 * tile + g] = v0;
      if (t == ((n1 >> 1) & 3)) res_sh[16 * tile + g + 8] = v1;
    }
    __syncwarp();
    if (whole) {
      const float4 m = reinterpret_cast<const float4*>(m_row + base)[lane];
      const float4 r = reinterpret_cast<const float4*>(res_sh)[lane];
      reinterpret_cast<float4*>(o_row + base)[lane] =
          make_float4(r.x * m.x, r.y * m.y, r.z * m.z, r.w * m.w);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = base + lane + 32 * q;
        if (i < e) o_row[i] = res_sh[lane + 32 * q] * m_row[i];
      }
    }
    __syncwarp();
  }
}

template <int N>
int launch_n(const int* local, const float* mask, const float* w_blk,
             float* out, int kb, int e, int warps, bool vec,
             cudaStream_t stream) {
  const size_t smem = 2 * kBlock + 2 * (size_t)warps * kChunk * 4;
  onehot_kernel<N><<<kb, 32 * warps, smem, stream>>>(local, mask, w_blk,
                                                     out, e, vec);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Launches the gather of kb x e slots on `stream` with B viewed [2048 / n,
// n] (n = 8, 16, 32 or 64) and `warps` warps (1-16) per CTA, one CTA per
// block; returns the CUDA error of the launch (0 on success). Does not
// synchronise. A local index outside [0, 2048) matches no row of B and
// gives 0.
extern "C" int gather_onehot_launch(const int* local, const float* mask,
                                    const float* w_blk, float* out, int kb,
                                    int e, int n, int warps, void* stream) {
  if (kb <= 0 || e <= 0 || warps < 1 || warps > 16)
    return (int)cudaErrorInvalidValue;
  const bool vec = e % 4 == 0 && aligned16(local) && aligned16(mask) &&
                   aligned16(w_blk) && aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8: return launch_n<8>(local, mask, w_blk, out, kb, e, warps, vec, s);
    case 16: return launch_n<16>(local, mask, w_blk, out, kb, e, warps, vec, s);
    case 32: return launch_n<32>(local, mask, w_blk, out, kb, e, warps, vec, s);
    case 64: return launch_n<64>(local, mask, w_blk, out, kb, e, warps, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
