// Per-entity GLM solve for Hopper (sm_90a): L-BFGS (L2), OWL-QN (L1 /
// elastic net) and TRON (trust-region Newton-CG, L2), with an optional
// per-entity normalization fold and optional box constraints.
//
// Replaces the Pallas TPU kernel photon_ml_tpu/ops/pallas_entity_solver.py
// (pallas_entity_lbfgs, pl.pallas_call at :963, in every mode:
// _make_kernel -> body, body_owlqn, body_bounded, _tiered_sweep,
// _two_loop, finish; _make_tron_kernel; the factors/shifts fold and the
// lower/upper bounds). The algorithms, stop reasons and their order are
// documented in photon_ml_tpu_torch/ops/entity_solver.py, whose
// entity_lbfgs_plain is the same function in plain PyTorch.
//
// Design. Each entity has a working set of compute-type T arrays
// (float64 by default, float32 on request). L-BFGS and OWL-QN keep the
// rows' labels, offsets, weights, margins z, direction (or trial)
// margins zp and d1 weights u, the coordinates' c, g, direction, c_new
// (the trial point in OWL-QN and with bounds), g_new, pseudo-gradient,
// factor and shift, and the (s, y) history as a ring (the newest pair at
// `head`, so storing a pair writes one slot). TRON keeps no history: the
// rows' margins, trial margins, curvature weights and a scratch vector,
// and the coordinates' c, g, the CG step, residual and direction, H d,
// the trial point and its gradient, the free-coordinate mask, factor and
// shift, in T; its rows' labels, offsets and weights stay float32 as they
// come (widening float32 to float64 is exact, so the arithmetic is the
// same, and at n_pad 64, d_pad 32 the 768 bytes saved let an SM hold 16
// entities where it held 12). Bounds are read in place from
// device memory and do not grow the working set. Where it fits a
// block's shared memory, the working set sits there, followed by a
// float32 copy of the entity's x tile [r, d] with row stride d + 1 (lanes
// over rows then hit distinct banks), loaded with 16-byte loads where x
// is aligned. A tall entity whose x tile does not fit reads x in place
// from device memory (L2-cached), and one whose working set does not fit
// either keeps it in a device-memory workspace the caller allocates, so
// every r and d launches.
//
// Lanes. One warp per entity. Its coordinates go over the first C lanes, C
// the smallest power of two >= d (4 to 32), its rows over all 32. Margins and
// H v's X v put lanes over rows; the gradient, X^T u, the two-loop recursion,
// CG's vector updates and the history put lanes over coordinates. (TRON's
// passes keep that order: splitting H v's rows over the 32 / C idle lane
// groups with several accumulators made it no faster or slower, and its
// registers cost residency; PERF.md.) Sums over coordinates are xor
// butterflies over C lanes (log2 C shuffle steps in place of 5; for d <= C
// the 32-lane tree would only add zeros, so the bits are the same) and a
// broadcast from lane 0, sums over rows butterflies over 32 lanes. Every lane
// gets the same bits, so each entity's control flow is uniform over its warp.
// (Groups of C lanes with 32 / C entities per warp were measured and dropped:
// at the slice's buckets they took 1.2-2.5x as long, each entity's row loops
// being 32 / C times longer; PERF.md.)
//
// Grid. Every mode launches a persistent grid: as many blocks as the card
// holds resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor at plan time,
// for the count of warps per block, 1 to 4, that holds the most entities;
// TRON's instances are held to 96 registers so that registers do not cap the
// SM below what shared memory holds), each warp taking the next entity from
// an atomic counter when its entity stops, so a bucket larger than one wave
// leaves no partial last wave and no block waits on its slowest entity; the
// last warp out sets the counter back to 0. Inputs and outputs are float32.
//
// Plans. A launch plan (layout, C, warps per block, resident blocks, the
// kernel instance with its shared-memory attribute at the card's opt-in
// budget) is made once per
// shape, compute type, mode, loss and device by entity_lbfgs_plan and
// kept in a table; a launch names its plan and launches, with no query of
// the device.
//
// Normalization (factor and shift given): x' = (x - shift) * factor,
// computed in T and rounded to float32. In the shared layout it is applied
// once, as the x tile is loaded; where x is read from device memory it is
// applied on every read, with factor and shift in the working set. Either
// way every margin, gradient, Hessian product and trial sees the same x'.
// Coefficients are in the solve (normalized) space, and the bounds clamp
// them there.
//
// Bounds (lower and upper given): c0 is projected; L-BFGS builds each
// trial P(c + t d) in c_new and its margins in zp, the same scheme as
// OWL-QN's orthant-projected trials with the clamp in place of the
// orthant projection; TRON freezes the pinned coordinates in CG, clamps
// its trial and prices the realized step with one more H v.
//
// The mode is a template argument (OWL-QN and TRON loops differ in kind),
// and so is C; normalization and bounds are runtime flags (null pointers
// mean off, uniform over a launch), so they do not multiply the
// instances. Each (mode, compute type) pair is its own translation unit,
// entity_lbfgs_<mode>_<f64|f32>.cu, so that nvcc builds the six in
// parallel; TRON is instantiated only for the twice-differentiable losses
// (kernel_id 0-2).
// This file holds the plan table and the C entry points,
// entity_lbfgs.cuh the rest.
//
// The units are built with -fmad=false (ops/cuda_build.py): each product
// is rounded before it is added, as in the plain version, so that
// decisions taken at rounding level (a bounded entity's last Armijo test
// at its optimum) fall the same way in both.
//
// Bound on the H100: the solve moves few bytes (each x tile is read once)
// and does little arithmetic; each entity's iterations are a serial chain
// of dot products (shuffle trees), shared-memory round trips and loss
// evaluations, so the chain's latency, times the waves of entities the
// card holds resident, sets the time. The design shortens the trees where
// d < 32 (and in TRON's CG step makes two butterflies of several values
// where it made six of one), keeps every operand on chip where it fits
// and keeps the card full until the last entity starts.

#include "entity_lbfgs.cuh"

#include <mutex>
#include <vector>

using namespace entity_lbfgs;

namespace {

struct Entry {
  Plan plan;
  KernelFn kernel;
  int device, mode, r, d, m;
  int blocks;  // resident blocks of the card (the persistent grid's cap)
  size_t smem;  // dynamic shared memory per block
};

std::mutex plans_mu;
std::vector<Entry> plans;

KernelFn kernel_of(const Plan& plan, int mode, int f64, int loss) {
  switch (mode * 2 + (f64 ? 1 : 0)) {
    case 0: return kernel_lbfgs_f32(plan, loss);
    case 1: return kernel_lbfgs_f64(plan, loss);
    case 2: return kernel_owlqn_f32(plan, loss);
    case 3: return kernel_owlqn_f64(plan, loss);
    case 4: return kernel_tron_f32(plan, loss);
    case 5: return kernel_tron_f64(plan, loss);
    default: return nullptr;
  }
}

}  // namespace

// Plans a solve of entities of r rows and d coordinates on the current
// device: `mode` 0 L-BFGS, 1 OWL-QN, 2 TRON; `f64` float64 compute;
// `loss` the kernel_id. Sets the kernel's shared-memory attribute and
// picks the warps per block by its occupancy, once. Returns the
// plan's handle (>= 0), or minus a CUDA error. `info` receives: layout (0
// x tile and working set in shared memory, 1 x read from device memory,
// 2 working set in the workspace too), C (the lanes over an entity's
// coordinates), warps (entities) per block,
// resident blocks per SM, SMs, working-set bytes per entity (the
// workspace takes E times that in layout 2), shared memory per block.
extern "C" int entity_lbfgs_plan(int r, int d, int m, int f64, int mode,
                                 int loss, long long* info) {
  if (r <= 0 || d <= 0 || m <= 0 || mode < 0 || mode > 2)
    return -(int)cudaErrorInvalidValue;
  int dev = 0, budget = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &budget, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  Entry en;
  make_plan(r, d, m, f64 ? sizeof(double) : sizeof(float),
            mode == kModeTron, (size_t)budget, &en.plan);
  en.kernel = kernel_of(en.plan, mode, f64, loss);
  if (en.kernel == nullptr) return -(int)cudaErrorInvalidValue;
  en.device = dev;
  en.mode = mode;
  en.r = r;
  en.d = d;
  en.m = m;
  // The instance may serve plans of other shapes, so its shared-memory
  // attribute is the card's opt-in budget, never one plan's need.
  if (en.plan.entity_bytes * (size_t)en.plan.warps > 48 * 1024) {
    err = cudaFuncSetAttribute(
        en.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, budget);
    if (err != cudaSuccess) return -(int)err;
  }
  // Warps per block: the count (up to the plan's) that keeps the most
  // entities resident, more warps on a tie. Where shared memory caps the
  // SM, narrower blocks waste less of it (at 15.7 KB per entity, blocks
  // of 2 warps hold 14 entities per SM where blocks of 4 hold 12).
  int best_warps = 0, best_per_sm = 0;
  for (int wp = en.plan.warps; wp >= 1; --wp) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, en.kernel, 32 * wp, en.plan.entity_bytes * (size_t)wp);
    if (err != cudaSuccess) return -(int)err;
    if (per_sm * wp > best_per_sm * best_warps) {
      best_warps = wp;
      best_per_sm = per_sm;
    }
  }
  if (best_per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  en.plan.warps = best_warps;
  en.smem = en.plan.entity_bytes * (size_t)best_warps;
  const int per_sm = best_per_sm;
  en.blocks = per_sm * sms;
  const long long out[7] = {en.plan.layout, en.plan.coord_lanes,
                            en.plan.warps, per_sm, sms,
                            (long long)en.plan.state_bytes,
                            (long long)en.smem};
  for (int i = 0; i < 7; ++i) info[i] = out[i];
  std::lock_guard<std::mutex> lock(plans_mu);
  plans.push_back(en);
  return (int)plans.size() - 1;
}

// Launches the solve of E entities with plan `handle` on `stream`
// (the plan's device must be current); returns the CUDA error of the
// launch (0 on success). Does not synchronise. `out_c` holds c [E, d],
// `fout` f and |g| ([2, E]), `iout` [4, E] ints: iterations, reason,
// trials (or TRON's trips) and TRON's CG steps.
// `counter` holds 2 ints, 0 before the launch, which the persistent grid
// counts entities with and leaves 0 (launches sharing one counter must follow
// each other on one stream). `workspace` holds E times the plan's working-set
// bytes in layout 2 (may be null otherwise). `factor` null means no
// normalization (`shift` is then not read); `lower` null means no bounds
// (`upper` is then not read; not with OWL-QN). max_line_search and c1 are
// unused by TRON, l1 by L-BFGS and TRON.
extern "C" int entity_lbfgs_launch(
    int handle, const float* x, const float* y, const float* off,
    const float* w, const float* c0, const float* factor,
    const float* shift, const float* lower, const float* upper,
    float* out_c, float* fout, int* iout, int* counter, void* workspace,
    int E, int max_iter,
    int max_line_search, double l2, double l1, double tol, double c1,
    void* stream) {
  Entry en;
  {
    std::lock_guard<std::mutex> lock(plans_mu);
    if (handle < 0 || handle >= (int)plans.size())
      return (int)cudaErrorInvalidValue;
    en = plans[handle];
  }
  if (E <= 0) return (int)cudaErrorInvalidValue;
  if (factor != nullptr && shift == nullptr) return (int)cudaErrorInvalidValue;
  if (lower != nullptr && upper == nullptr) return (int)cudaErrorInvalidValue;
  if (en.mode == kModeOwlqn && lower != nullptr)
    return (int)cudaErrorInvalidValue;
  if (en.plan.layout == kAllGlobal && workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  if (counter == nullptr) return (int)cudaErrorInvalidValue;
  Params p{x, y, off, w, c0, factor, shift, lower, upper,
           out_c, fout, fout + E,
           iout, iout + E, iout + 2 * (size_t)E, iout + 3 * (size_t)E,
           counter, static_cast<unsigned char*>(workspace), E,
           en.r, en.d, en.m, max_iter, max_line_search, l2, l1, tol, c1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long needed = ((long long)E + en.plan.warps - 1) / en.plan.warps;
  const int blocks = needed < en.blocks ? (int)needed : en.blocks;
  en.kernel<<<blocks, 32 * en.plan.warps, en.smem, s>>>(p, en.plan);
  return (int)cudaGetLastError();
}
