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
// Design: one warp per entity, up to 4 warps per block. Each entity has a
// working set of compute-type T arrays (float64 by default, float32 on
// request). L-BFGS and OWL-QN keep the rows' labels, offsets, weights,
// margins z, direction (or trial) margins zp and d1 weights u, the
// coordinates' c, g, direction, c_new (the trial point in OWL-QN and with
// bounds), g_new, pseudo-gradient, factor and shift, and the (s, y)
// history (oldest first, shift-left on store). TRON keeps no history:
// the rows' labels, offsets, weights, margins, trial margins, curvature
// weights and a scratch vector, and the coordinates' c, g, the CG step,
// residual and direction, H d, the trial point and its gradient, the
// free-coordinate mask, factor and shift. Bounds are read in place from
// device memory and do not grow the working set. Where it fits a
// block's shared memory, the working set sits there, followed by a
// float32 copy of the entity's x tile [r, d] with row stride d + 1 (lanes
// over rows then hit distinct banks). A tall entity whose x tile does not
// fit reads x in place from device memory (L2-cached), and one whose
// working set does not fit either keeps it in a device-memory workspace
// the caller allocates (entity_lbfgs_workspace_bytes), so every r and d
// launches. Margins and H v's X v put lanes over rows; the gradient,
// X^T u, the two-loop recursion, CG's vector updates and the history put
// lanes over coordinates; sums over coordinates or rows are xor-butterfly
// warp shuffles, which give every lane the same bits, so all control flow
// is warp-uniform. Each warp loops until its own entity stops (for TRON,
// each trip's CG loop as well) and then exits; no block-level barrier is
// used. Inputs and outputs are float32.
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
// OWL-QN and TRON are template arguments (their loops differ in kind);
// normalization and bounds are runtime flags (null pointers mean off,
// uniform over a launch), so they do not multiply the instances. Each
// (mode, compute type) pair is its own translation unit,
// entity_lbfgs_<mode>_<f64|f32>.cu, so that nvcc builds the six in
// parallel; TRON is instantiated only for the twice-differentiable losses
// (kernel_id 0-2). This file holds the C entry points, entity_lbfgs.cuh
// the rest.
//
// The units are built with -fmad=false (ops/cuda_build.py): each product
// is rounded before it is added, as in the plain version, so that
// decisions taken at rounding level (a bounded entity's last Armijo test
// at its optimum) fall the same way in both.
//
// Bound on the H100: each entity's iterations are a serial chain of
// shared-memory dot products and shuffles, so latency, not bandwidth or
// FLOPs, sets the time; the kernel keeps the state on chip where it fits
// and as many entity warps resident per SM as shared memory allows.

#include "entity_lbfgs.cuh"

using namespace entity_lbfgs;

// Bytes of device-memory workspace a solve of E entities in `mode` (0
// lbfgs, 1 owlqn, 2 tron) needs: 0 when each entity's working set fits a
// block's shared memory on the current device, else E times that working
// set. `f64` selects float64 compute.
extern "C" size_t entity_lbfgs_workspace_bytes(int E, int r, int d, int m,
                                               int f64, int mode) {
  Plan plan;
  if (make_plan(r, d, m, f64 ? sizeof(double) : sizeof(float),
                mode == kModeTron, &plan) != 0)
    return 0;
  return plan.layout == kAllGlobal ? (size_t)E * plan.state_bytes : 0;
}

// The layout a solve at these shapes uses in `mode`: 0 x tile and working
// set in shared memory, 1 x read from device memory, 2 working set in the
// workspace too; negative on a CUDA error.
extern "C" int entity_lbfgs_layout(int r, int d, int m, int f64, int mode) {
  Plan plan;
  int err = make_plan(r, d, m, f64 ? sizeof(double) : sizeof(float),
                      mode == kModeTron, &plan);
  return err != 0 ? -err : plan.layout;
}

// Launches the solve of E entities on `stream`; returns the CUDA error
// of the launch (0 on success). Does not synchronise. `workspace` holds
// entity_lbfgs_workspace_bytes(E, r, d, m, f64, mode) bytes (may be null
// when that is 0). `factor` null means no normalization (`shift` is then
// not read); `lower` null means no bounds (`upper` is then not read).
// `mode` 0 is L-BFGS, 1 OWL-QN with weight `l1` (no bounds), 2 TRON
// (losses 0-2; m, max_line_search and c1 unused; `out_cg` receives the CG
// steps). `out_steps` receives the line-search trials, or TRON's trips.
extern "C" int entity_lbfgs_launch(
    const float* x, const float* y, const float* off, const float* w,
    const float* c0, const float* factor, const float* shift,
    const float* lower, const float* upper, float* out_c, float* out_f,
    float* out_gnorm, int* out_it, int* out_reason, int* out_steps,
    int* out_cg, void* workspace, int E, int r, int d, int m, int max_iter,
    int max_line_search, double l2, double l1, double tol, double c1,
    int loss, int f64, int mode, void* stream) {
  if (E <= 0 || r <= 0 || d <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  if (factor != nullptr && shift == nullptr) return (int)cudaErrorInvalidValue;
  if (lower != nullptr && upper == nullptr) return (int)cudaErrorInvalidValue;
  if (mode == kModeOwlqn && lower != nullptr)
    return (int)cudaErrorInvalidValue;
  if (mode == kModeTron && out_cg == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p{x, y, off, w, c0, factor, shift, lower, upper, out_c, out_f,
           out_gnorm, out_it, out_reason, out_steps, out_cg,
           static_cast<unsigned char*>(workspace), E, r, d, m, max_iter,
           max_line_search, l2, l1, tol, c1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kModeLbfgs:
      return f64 ? launch_lbfgs_f64(p, loss, s) : launch_lbfgs_f32(p, loss, s);
    case kModeOwlqn:
      return f64 ? launch_owlqn_f64(p, loss, s) : launch_owlqn_f32(p, loss, s);
    case kModeTron:
      return f64 ? launch_tron_f64(p, loss, s) : launch_tron_f32(p, loss, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
