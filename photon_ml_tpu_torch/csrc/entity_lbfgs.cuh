// Per-entity GLM solve for Hopper (sm_90a): the kernels (L-BFGS/OWL-QN
// and TRON), their launch plan and the instances each translation unit
// builds (entity_lbfgs_*.cu). See entity_lbfgs.cu for what they compute
// and how they are laid out.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace entity_lbfgs {

constexpr unsigned kFull = 0xffffffffu;
constexpr double kCautiousEps = 1e-10;
constexpr int kMaxWarps = 4;
constexpr int kNotConverged = 0;
constexpr int kMaxIterations = 1;
constexpr int kFunctionValuesConverged = 2;
constexpr int kGradientConverged = 3;
constexpr int kObjectiveNotImproving = 4;
// Modes, as the C entry points number them.
constexpr int kModeLbfgs = 0;
constexpr int kModeOwlqn = 1;
constexpr int kModeTron = 2;
// TRON (the Pallas kernel's LIBLINEAR rules and budgets).
constexpr double kEta0 = 1e-4, kEta1 = 0.25, kEta2 = 0.75;
constexpr double kSigma1 = 0.25, kSigma2 = 0.5, kSigma3 = 4.0;
constexpr double kCgXi = 0.1;
constexpr double kPinEps = 1e-12;
constexpr int kMaxCg = 20;
constexpr int kMaxFailures = 5;

struct Params {
  const float* x;       // [E, r, d]
  const float* y;       // [E, r]
  const float* off;     // [E, r]
  const float* w;       // [E, r]
  const float* c0;      // [E, d]
  const float* factor;  // [E, d] or null (no normalization)
  const float* shift;   // [E, d] (read only when factor is given)
  const float* lower;   // [E, d] or null (no bounds)
  const float* upper;   // [E, d] (read only when lower is given)
  float* out_c;         // [E, d]
  float* out_f;         // [E]
  float* out_gnorm;     // [E]
  int* out_it;          // [E]
  int* out_reason;      // [E]
  int* out_steps;       // [E] line-search trials priced, or TRON's trips
  int* out_cg;          // [E] TRON's CG steps (TRON only)
  int* next;            // [2]: the next entity to take and the warps
                        // done (0 before a launch and after it)
  unsigned char* workspace;  // [E, state_bytes] when the state is global
  int E, r, d, m, max_iter, max_line_search;
  double l2, l1, tol, c1;
};

// Where one launch keeps each entity's data. The layout is a template
// argument of the kernel, so that in the shared-memory layouts the
// compiler sees shared-memory pointers and emits shared loads.
enum Layout { kAllShared = 0, kXGlobal = 1, kAllGlobal = 2 };

struct Plan {
  size_t state_bytes;   // one entity's T working set, rounded up to 16
  size_t entity_bytes;  // shared memory per entity (0 in kAllGlobal)
  int layout;
  int coord_lanes;  // C: the lanes over an entity's coordinates
  int warps;        // warps (entities) per block
};

inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// The working set of one entity, in bytes (rounded up to 16): TRON keeps
// 4 row vectors and 11 coordinate vectors in T and the rows' labels,
// offsets and weights as the float32 inputs they are (T = double widens
// them exactly on every read); L-BFGS and OWL-QN keep 6 row vectors, 8
// coordinate vectors and the m (s, y) pairs with their rho and alpha, all
// in T. Bounds are not part of it (see load_entity).
inline size_t state_bytes_of(int r, int d, int m, size_t t_size, bool tron) {
  if (tron)
    return round16(t_size * (4 * (size_t)r + 11 * (size_t)d) +
                   sizeof(float) * 3 * (size_t)r);
  return round16(t_size * (6 * (size_t)r + 8 * (size_t)d +
                           2 * (size_t)m * d + 2 * (size_t)m));
}

// The lanes a coordinate sweep needs: the smallest power of two >= d,
// from 4 to 32.
inline int coord_lanes_for(int d) {
  int c = 4;
  while (c < d && c < 32) c *= 2;
  return c;
}

// Plans a solve of r x d entities with `budget` bytes of opt-in shared
// memory per block: the layout, C = coord_lanes_for(d) in the shared
// layout and 32 elsewhere, and the most warps per block (up to 4) the
// budget holds; entity_lbfgs_plan then takes the count of warps per block
// that keeps the most entities resident.
inline void make_plan(int r, int d, int m, size_t t_size, bool tron,
                      size_t budget, Plan* plan) {
  const size_t state = state_bytes_of(r, d, m, t_size, tron);
  const size_t x_tile = round16(4 * (size_t)r * (d + 1));
  plan->state_bytes = state;
  if (state + x_tile <= budget) {
    plan->entity_bytes = state + x_tile;
    plan->layout = kAllShared;
  } else if (state <= budget) {
    plan->entity_bytes = state;
    plan->layout = kXGlobal;
  } else {
    plan->entity_bytes = 0;
    plan->layout = kAllGlobal;
  }
  plan->coord_lanes = plan->layout == kAllShared ? coord_lanes_for(d) : 32;
  plan->warps = kMaxWarps;
  if (plan->entity_bytes > 0 && budget / plan->entity_bytes < kMaxWarps)
    plan->warps = (int)(budget / plan->entity_bytes);
}

// Math in the compute type.
__device__ __forceinline__ float ex(float v) { return expf(v); }
__device__ __forceinline__ double ex(double v) { return exp(v); }
__device__ __forceinline__ float lg1p(float v) { return log1pf(v); }
__device__ __forceinline__ double lg1p(double v) { return log1p(v); }
__device__ __forceinline__ float ab(float v) { return fabsf(v); }
__device__ __forceinline__ double ab(double v) { return fabs(v); }
__device__ __forceinline__ float mx(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double mx(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float rt(float v) { return sqrtf(v); }
__device__ __forceinline__ double rt(double v) { return sqrt(v); }
__device__ __forceinline__ float half_pow(float t, int k) {
  return ldexpf(t, -k);
}
__device__ __forceinline__ double half_pow(double t, int k) {
  return ldexp(t, -k);
}
__device__ __forceinline__ bool finite(float v) { return isfinite(v); }
__device__ __forceinline__ bool finite(double v) { return isfinite(v); }
// sign(v) as -1, 0 or 1; -0.0 and 0.0 both give 0.
template <typename T>
__device__ __forceinline__ int sgn(T v) {
  return (v > T(0)) - (v < T(0));
}
// max and min that return NaN when either operand is NaN, as jnp.maximum
// and torch.maximum do (fmax and fmin drop a NaN operand).
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
template <typename T>
__device__ __forceinline__ T nmin(T a, T b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
// The box projection min(max(v, lo), hi).
template <typename T>
__device__ __forceinline__ T box(T v, T lo, T hi) {
  return nmin(nmax(v, lo), hi);
}

// The normalization fold of one x value, rounded to float32 as the tile
// stores it: (x - shift) * factor.
template <typename T>
__device__ __forceinline__ float fold(float x, T sh, T fa) {
  return (float)(((T)x - sh) * fa);
}

// Pseudo-gradient of f + l1 |c| at one coordinate (optimization/owlqn.py).
template <typename T>
__device__ __forceinline__ T pseudo_grad(T c, T g, T l1) {
  if (c != T(0)) return g + l1 * (T)sgn(c);
  const T right = g + l1, left = g - l1;
  return right < T(0) ? right : (left > T(0) ? left : T(0));
}

// Losses (photon_ml_tpu_torch/ops/losses.py, kernel_id order).
template <int LOSS, typename T>
struct Loss;

template <typename T>
struct Loss<0, T> {  // logistic: log(1 + e^z) - y z
  __device__ static T value(T z, T y) {
    return mx(z, T(0)) + lg1p(ex(-ab(z))) - y * z;
  }
  __device__ static T d1(T z, T y) { return T(1) / (T(1) + ex(-z)) - y; }
  __device__ static T d2(T z, T) {
    const T s = T(1) / (T(1) + ex(-z));
    return s * (T(1) - s);
  }
};

template <typename T>
struct Loss<1, T> {  // squared: (z - y)^2 / 2
  __device__ static T value(T z, T y) {
    T e = z - y;
    return T(0.5) * e * e;
  }
  __device__ static T d1(T z, T y) { return z - y; }
  __device__ static T d2(T, T) { return T(1); }
};

template <typename T>
struct Loss<2, T> {  // Poisson: e^z - y z
  __device__ static T value(T z, T y) { return ex(z) - y * z; }
  __device__ static T d1(T z, T y) { return ex(z) - y; }
  __device__ static T d2(T z, T) { return ex(z); }
};

// Once differentiable only: TRON is not instantiated for it.
template <typename T>
struct Loss<3, T> {  // smoothed hinge on t = (2y - 1) z
  __device__ static T value(T z, T y) {
    T t = (T(2) * y - T(1)) * z;
    return t <= T(0) ? T(0.5) - t
                     : (t < T(1) ? T(0.5) * (T(1) - t) * (T(1) - t) : T(0));
  }
  __device__ static T d1(T z, T y) {
    T yy = T(2) * y - T(1);
    T t = yy * z;
    return (t <= T(0) ? T(-1) : (t < T(1) ? t - T(1) : T(0))) * yy;
  }
};

// One warp per entity. Its coordinates go over the first C lanes (C =
// the smallest power of two >= d, from 4 to 32; lanes past d hold zeros)
// and its rows over all 32. A sum over the rows is an xor butterfly over
// the 32 lanes; a sum over the coordinates one over the first C lanes
// (log2 C steps in place of 5: for d <= C the 32-lane tree would only add
// zeros, so the bits are the same) and, where C < 32, a broadcast from
// lane 0. Every lane gets the same bits, so the entity's control flow is
// uniform over its warp.
template <int W, typename T>
__device__ __forceinline__ T lane_sum(T v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// A sum over the coordinates, on every lane.
template <int C, typename T>
__device__ __forceinline__ T coord_sum(T v) {
  v = lane_sum<C>(v);
  if constexpr (C < 32) v = __shfl_sync(kFull, v, 0);
  return v;
}

// sum_j a[j] b[j], lanes over coordinates.
template <int C, typename T>
__device__ T dot(const T* a, const T* b, int d, int lane) {
  T s = T(0);
  for (int j = lane; j < d; j += C) s += a[j] * b[j];
  return coord_sum<C>(s);
}

// The entity's x as the solve sees it. In the shared layout the tile
// already holds x' (folded at load); where x is read from device memory
// and normalization is on, every read folds with the working set's
// factor and shift.
template <typename T, int LAYOUT>
struct XView {
  const float* xs;
  int ld;
  const T* fa;  // null: no fold on read
  const T* sh;
  __device__ __forceinline__ T at(int i, int j) const {
    const float v = xs[i * ld + j];
    if constexpr (LAYOUT != kAllShared) {
      if (fa != nullptr) return (T)fold(v, sh[j], fa[j]);
    }
    return (T)v;
  }
};

// out[i] = sum_j x[i, j] v[j] + off[i], lanes over rows.
template <typename T, int LAYOUT>
__device__ void margins(const XView<T, LAYOUT>& xv, const T* v, const T* off,
                        T* out, int r, int d, int lane) {
  for (int i = lane; i < r; i += 32) {
    T acc = T(0);
    for (int j = 0; j < d; ++j) acc += xv.at(i, j) * v[j];
    out[i] = acc + off[i];
  }
}

// out[j] = l2 c[j] + sum_i x[i, j] u[i] with u = w * l'(z, y).
template <int LOSS, int C, typename T, int LAYOUT>
__device__ void gradient(const XView<T, LAYOUT>& xv, const T* z, const T* y,
                         const T* w, T* u, const T* c, T l2, T* out, int r,
                         int d, int lane) {
  __syncwarp();
  for (int i = lane; i < r; i += 32)
    u[i] = w[i] * Loss<LOSS, T>::d1(z[i], y[i]);
  __syncwarp();
  for (int j = lane; j < d; j += C) {
    T acc = l2 * c[j];
    for (int i = 0; i < r; ++i) acc += xv.at(i, j) * u[i];
    out[j] = acc;
  }
}

// sum_i w[i] l(z[i] + t zp[i], y[i]) over the lane's rows (lanes over
// rows; y and w in T, or float32), and, in data_value, its sum over the
// warp.
template <int LOSS, typename T, typename R>
__device__ __forceinline__ T data_part(const T* z, const T* zp, T t,
                                       const R* y, const R* w, int r,
                                       int lane) {
  T s = T(0);
  for (int i = lane; i < r; i += 32)
    s += (T)w[i] *
         Loss<LOSS, T>::value(zp ? z[i] + t * zp[i] : z[i], (T)y[i]);
  return s;
}
template <int LOSS, typename T>
__device__ T data_value(const T* z, const T* zp, T t, const T* y, const T* w,
                        int r, int lane) {
  return lane_sum<32>(data_part<LOSS, T>(z, zp, t, y, w, r, lane));
}

// sum_j |v[j]|, lanes over coordinates.
template <int C, typename T>
__device__ T l1_norm(const T* v, int d, int lane) {
  T s = T(0);
  for (int j = lane; j < d; j += C) s += ab(v[j]);
  return coord_sum<C>(s);
}

// |pg(c, g)|: the OWL-QN stationarity measure.
template <int C, typename T>
__device__ T pg_norm(const T* c, const T* g, T l1, int d, int lane) {
  T s = T(0);
  for (int j = lane; j < d; j += C) {
    const T p = pseudo_grad(c[j], g[j], l1);
    s += p * p;
  }
  return rt(coord_sum<C>(s));
}

// One value of the x tile, folded when normalized.
template <typename T>
__device__ __forceinline__ float tile_value(float v, bool normalized,
                                            const T* fa, const T* sh,
                                            int j) {
  return normalized ? fold(v, sh[j], fa[j]) : v;
}

// Loads one entity's factor and shift when normalized, its x tile into shared
// memory in the shared layout (folded there when normalized), its rows (in T,
// or float32 as given) and c0 (projected when bounded). Returns the view the
// solve reads x through. The tile is read with 16-byte loads where the
// entity's x is 16-byte aligned, and laid out with row stride d + 1 (lanes
// over rows then hit distinct banks); its row and column advance by
// additions, not divisions. The bounds stay in device memory, read in place
// (read-only and cached) by the few projections that use them: staged in the
// working set they would cost 2 d of shared memory per entity, which at n_pad
// 64, d_pad 32 drops an SM from 3 blocks of 4 warps to 2.
template <int C, typename T, int LAYOUT, typename R>
__device__ XView<T, LAYOUT> load_entity(const Params& p, unsigned char* base,
                                        size_t state_bytes, int e, R* y,
                                        R* off, R* w, T* c, T* fa, T* sh,
                                        int lane) {
  const int r = p.r, d = p.d;
  const bool normalized = p.factor != nullptr;
  const bool bounded = p.lower != nullptr;
  if (normalized)
    for (int j = lane; j < d; j += C) {
      const size_t o = (size_t)e * d + j;
      fa[j] = (T)p.factor[o];
      sh[j] = (T)p.shift[o];
    }
  __syncwarp();
  const float* xe = p.x + (size_t)e * r * d;
  XView<T, LAYOUT> xv{xe, d, normalized ? fa : nullptr, sh};
  if constexpr (LAYOUT == kAllShared) {
    float* tile = reinterpret_cast<float*>(base + state_bytes);
    const int ld = d + 1, rd = r * d;
    if ((rd & 3) == 0 && (reinterpret_cast<uintptr_t>(xe) & 15) == 0) {
      const int step = 4 * 32, si = step / d, sj = step - si * d;
      int k = 4 * lane, i = k / d, j = k - i * d;
      for (; k < rd; k += step) {
        const float4 v = *reinterpret_cast<const float4*>(xe + k);
        const float vs[4] = {v.x, v.y, v.z, v.w};
        int ii = i, jj = j;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          tile[ii * ld + jj] = tile_value(vs[q], normalized, fa, sh, jj);
          if (++jj == d) {
            jj = 0;
            ++ii;
          }
        }
        i += si;
        j += sj;
        if (j >= d) {
          j -= d;
          ++i;
        }
      }
    } else {
      const int si = 32 / d, sj = 32 - si * d;
      int i = lane / d, j = lane - i * d;
      for (int k = lane; k < rd; k += 32) {
        tile[i * ld + j] = tile_value(xe[k], normalized, fa, sh, j);
        i += si;
        j += sj;
        if (j >= d) {
          j -= d;
          ++i;
        }
      }
    }
    xv.xs = tile;
    xv.ld = ld;
  }
  for (int i = lane; i < r; i += 32) {
    const size_t o = (size_t)e * r + i;
    y[i] = p.y[o];
    off[i] = p.off[o];
    w[i] = p.w[o];
  }
  for (int j = lane; j < d; j += C) {
    const size_t o = (size_t)e * d + j;
    const T c0 = p.c0[o];
    c[j] = bounded ? box(c0, (T)p.lower[o], (T)p.upper[o]) : c0;
  }
  __syncwarp();
  return xv;
}

// The entity's bounds in device memory, or null without bounds.
__device__ __forceinline__ const float* entity_row(const float* a, int e,
                                                   int d) {
  return a != nullptr ? a + (size_t)e * d : nullptr;
}

// The two-loop recursion (newest pair first, then oldest first) for d <=
// C, one coordinate per lane: the direction stays in a register, and
// each step loads the next pair's s, y and rho before its reduction, so
// the loads leave the serial chain of dot -> shuffle -> update. The
// arithmetic and its order are those of the general loop in solve_lbfgs
// (lanes past d carry zeros), so the bits are the same. Leaves
// -H q0 in dir[0, d).
template <int C, typename T>
__device__ __forceinline__ void two_loop_in_registers(
    const T* S, const T* Y, const T* rho, T* alpha, const T* q0, T* dir,
    int head, int m, int d, int count, T eps, int lane) {
  const bool own = lane < d;
  T q = own ? q0[lane] : T(0);
  int h = head;
  T sv = own ? S[h * d + lane] : T(0), yv = own ? Y[h * d + lane] : T(0);
  T rh = rho[h];
  for (int kk = 0; kk < m; ++kk) {
    const int hn = h == 0 ? m - 1 : h - 1;
    T sv_n = T(0), yv_n = T(0), rh_n = T(0);
    if (kk + 1 < m) {
      sv_n = own ? S[hn * d + lane] : T(0);
      yv_n = own ? Y[hn * d + lane] : T(0);
      rh_n = rho[hn];
    }
    const T a = rh * coord_sum<C>(T(0) + sv * q);
    if (lane == 0) alpha[h] = a;
    if (own) q -= a * yv;
    h = hn;
    sv = sv_n;
    yv = yv_n;
    rh = rh_n;
  }
  const T* s_new = S + head * d;
  const T* y_new = Y + head * d;
  const T yy = dot<C>(y_new, y_new, d, lane);
  const T sy_new = dot<C>(s_new, y_new, d, lane);
  const T gamma = count > 0 ? sy_new / mx(yy, eps) : T(1);
  if (own) q *= gamma;
  __syncwarp();  // alpha
  h = head == m - 1 ? 0 : head + 1;
  sv = own ? S[h * d + lane] : T(0);
  yv = own ? Y[h * d + lane] : T(0);
  rh = rho[h];
  T al = alpha[h];
  for (int kk = 0; kk < m; ++kk) {
    const int hn = h == m - 1 ? 0 : h + 1;
    T sv_n = T(0), yv_n = T(0), rh_n = T(0), al_n = T(0);
    if (kk + 1 < m) {
      sv_n = own ? S[hn * d + lane] : T(0);
      yv_n = own ? Y[hn * d + lane] : T(0);
      rh_n = rho[hn];
      al_n = alpha[hn];
    }
    const T b = rh * coord_sum<C>(T(0) + yv * q);
    const T coef = al - b;
    if (own) q += coef * sv;
    h = hn;
    sv = sv_n;
    yv = yv_n;
    rh = rh_n;
    al = al_n;
  }
  if (own) dir[lane] = -q;
}

// One entity's L-BFGS or OWL-QN solve on the warp's `lane`, its working
// set at `base`. The (s, y) history is a ring: slot `head` holds the newest
// pair, slot (head - k) mod m the k-th newest, so storing a pair writes
// one slot where a shift-left copied m - 1 of them.
template <int LOSS, typename T, int LAYOUT, bool OWLQN, int C>
__device__ void solve_lbfgs(const Params& p, size_t state_bytes,
                            unsigned char* base, int e, int lane) {
  const int r = p.r, d = p.d, m = p.m;
  const T l2 = (T)p.l2, l1 = (T)p.l1, tol = (T)p.tol, c1 = (T)p.c1;
  const T eps = (T)kCautiousEps;
  // Trials that are projected (orthant or box) and priced from their own
  // margins; otherwise the line search prices cached margins. Bounds are
  // uniform over a launch, like the fold.
  const bool projected = OWLQN || p.lower != nullptr;

  T* y = reinterpret_cast<T*>(base);
  T* off = y + r;
  T* w = off + r;
  T* z = w + r;
  T* zp = z + r;
  T* u = zp + r;
  T* c = u + r;
  T* g = c + d;
  T* dir = g + d;
  T* cn = dir + d;
  T* gn = cn + d;
  T* pg = gn + d;
  T* fa = pg + d;
  T* sh = fa + d;
  T* S = sh + d;
  T* Y = S + m * d;
  T* rho = Y + m * d;
  T* alpha = rho + m;

  const float* lb = entity_row(p.lower, e, d);
  const float* ub = entity_row(p.upper, e, d);
  const XView<T, LAYOUT> xv = load_entity<C, T, LAYOUT>(
      p, base, state_bytes, e, y, off, w, c, fa, sh, lane);
  for (int k = lane; k < m * d; k += 32) S[k] = Y[k] = T(0);
  for (int k = lane; k < m; k += 32) rho[k] = T(0);
  __syncwarp();

  margins(xv, c, off, z, r, d, lane);
  T f = data_value<LOSS, T>(z, (const T*)nullptr, T(0), y, w, r, lane) +
        T(0.5) * l2 * dot<C>(c, c, d, lane);
  if constexpr (OWLQN) f += l1 * l1_norm<C>(c, d, lane);
  gradient<LOSS, C>(xv, z, y, w, u, c, l2, g, r, d, lane);
  __syncwarp();
  const T gnorm0 = OWLQN ? pg_norm<C>(c, g, l1, d, lane) : rt(dot<C>(g, g, d, lane));
  const T f0_scale = mx(ab(f), (T)1e-30);
  T gnorm = gnorm0;
  int reason = gnorm0 <= T(0) ? kGradientConverged : kNotConverged;
  int it = 0, count = 0, trials = 0, head = m - 1;

  for (int k = 0; k < p.max_iter && reason == kNotConverged; ++k) {
    // The gradient the direction descends: g, or OWL-QN's pseudo-gradient.
    const T* q0 = g;
    if constexpr (OWLQN) {
      for (int j = lane; j < d; j += C) pg[j] = pseudo_grad(c[j], g[j], l1);
      __syncwarp();
      q0 = pg;
    }
    // Direction: two-loop recursion, newest pair first.
    if (d <= C) {
      two_loop_in_registers<C>(S, Y, rho, alpha, q0, dir, head, m, d, count,
                               eps, lane);
      if constexpr (OWLQN) {
        // Keep only the components that descend along -pg.
        if (lane < d && !(dir[lane] * pg[lane] < T(0))) dir[lane] = T(0);
      }
      __syncwarp();
      if (dot<C>(dir, q0, d, lane) >= T(0) && lane < d) dir[lane] = -q0[lane];
    } else {
      for (int j = lane; j < d; j += C) dir[j] = q0[j];
      for (int kk = 0, h = head; kk < m; ++kk, h = h == 0 ? m - 1 : h - 1) {
        const T a = rho[h] * dot<C>(S + h * d, dir, d, lane);
        if (lane == 0) alpha[h] = a;
        for (int j = lane; j < d; j += C) dir[j] -= a * Y[h * d + j];
      }
      const T* s_new = S + head * d;
      const T* y_new = Y + head * d;
      const T yy = dot<C>(y_new, y_new, d, lane);
      const T sy_new = dot<C>(s_new, y_new, d, lane);
      const T gamma = count > 0 ? sy_new / mx(yy, eps) : T(1);
      for (int j = lane; j < d; j += C) dir[j] *= gamma;
      __syncwarp();
      for (int kk = 0, h = head == m - 1 ? 0 : head + 1; kk < m;
           ++kk, h = h == m - 1 ? 0 : h + 1) {
        const T b = rho[h] * dot<C>(Y + h * d, dir, d, lane);
        const T coef = alpha[h] - b;
        for (int j = lane; j < d; j += C) dir[j] += coef * S[h * d + j];
      }
      for (int j = lane; j < d; j += C) dir[j] = -dir[j];
      if constexpr (OWLQN) {
        // Keep only the components that descend along -pg.
        for (int j = lane; j < d; j += C)
          if (!(dir[j] * pg[j] < T(0))) dir[j] = T(0);
      }
      if (dot<C>(dir, q0, d, lane) >= T(0))
        for (int j = lane; j < d; j += C) dir[j] = -q0[j];
    }
    __syncwarp();

    bool ok = false;
    T t_acc = T(0), f_new = T(0);
    const T pp = dot<C>(dir, dir, d, lane);
    const T t0 = count == 0 ? T(1) / mx(rt(pp), T(1)) : T(1);
    if (projected) {
      // Projected trials (onto the orthant in OWL-QN, onto the box with
      // bounds), each priced from its own margins: the first that passes
      // Armijo on the realized displacement q0.(x_t - c) wins. The trial
      // point is built in cn and its margins in zp.
      for (int kk = 0; kk <= p.max_line_search; ++kk) {
        const T t = half_pow(t0, kk);  // t0 * 0.5^kk, exactly
        for (int j = lane; j < d; j += C) {
          const T xt = c[j] + t * dir[j];
          if constexpr (OWLQN) {
            const int orth = c[j] != T(0) ? sgn(c[j]) : sgn(-pg[j]);
            cn[j] = sgn(xt) == orth ? xt : T(0);
          } else {
            cn[j] = box(xt, (T)lb[j], (T)ub[j]);
          }
        }
        __syncwarp();
        margins(xv, cn, off, zp, r, d, lane);
        T dec = T(0);
        for (int j = lane; j < d; j += C) dec += q0[j] * (cn[j] - c[j]);
        dec = coord_sum<C>(dec);
        T ft = data_value<LOSS, T>(zp, (const T*)nullptr, T(0), y, w, r,
                                   lane) +
               T(0.5) * l2 * dot<C>(cn, cn, d, lane);
        if constexpr (OWLQN) ft += l1 * l1_norm<C>(cn, d, lane);
        ++trials;
        if (ft <= f + c1 * dec && finite(ft)) {
          ok = true;
          f_new = ft;
          break;
        }
        __syncwarp();
      }
    } else {
      // Line search priced from cached margins: zp = (X d + off) - off.
      margins(xv, dir, off, zp, r, d, lane);
      for (int i = lane; i < r; i += 32) zp[i] -= off[i];
      const T xx = dot<C>(c, c, d, lane);
      const T xp = dot<C>(c, dir, d, lane);
      const T gp = dot<C>(g, dir, d, lane);
      for (int kk = 0; kk <= p.max_line_search; ++kk) {
        const T t = half_pow(t0, kk);  // t0 * 0.5^kk, exactly
        const T ft = data_value<LOSS, T>(z, (const T*)zp, t, y, w, r, lane) +
                     T(0.5) * l2 * (xx + T(2) * t * xp + t * t * pp);
        ++trials;
        if (ft <= f + c1 * t * gp && finite(ft)) {
          ok = true;
          t_acc = t;
          f_new = ft;
          break;
        }
      }
    }
    ++it;
    if (!ok) {  // the iterate stays; the iteration counts
      reason = kObjectiveNotImproving;
      break;
    }

    if (projected) {
      // The accepted trial's margins, non-finite ones kept as 0 (the
      // Pallas kernel's accumulator rule).
      for (int i = lane; i < r; i += 32) z[i] = finite(zp[i]) ? zp[i] : T(0);
    } else {
      for (int j = lane; j < d; j += C) cn[j] = c[j] + t_acc * dir[j];
      for (int i = lane; i < r; i += 32) z[i] += t_acc * zp[i];
    }
    gradient<LOSS, C>(xv, z, y, w, u, cn, l2, gn, r, d, lane);
    __syncwarp();
    const T gnorm_new =
        OWLQN ? pg_norm<C>(cn, gn, l1, d, lane) : rt(dot<C>(gn, gn, d, lane));

    // Cautious history update, from the smooth gradients.
    T sy = T(0), ss = T(0), yy2 = T(0);
    for (int j = lane; j < d; j += C) {
      const T sj = cn[j] - c[j], yj = gn[j] - g[j];
      sy += sj * yj;
      ss += sj * sj;
      yy2 += yj * yj;
    }
    sy = coord_sum<C>(sy);
    ss = coord_sum<C>(ss);
    yy2 = coord_sum<C>(yy2);
    if (sy > eps * rt(ss) * rt(yy2)) {
      head = head == m - 1 ? 0 : head + 1;  // the oldest slot
      for (int j = lane; j < d; j += C) {
        S[head * d + j] = cn[j] - c[j];
        Y[head * d + j] = gn[j] - g[j];
      }
      if (lane == 0) rho[head] = sy != T(0) ? T(1) / sy : T(0);
      count = count + 1 < m ? count + 1 : m;
    }

    if (gnorm_new <= tol * gnorm0)
      reason = kGradientConverged;
    else if (ab(f - f_new) <= tol * f0_scale)
      reason = kFunctionValuesConverged;
    else if (it >= p.max_iter)
      reason = kMaxIterations;
    __syncwarp();
    for (int j = lane; j < d; j += C) {
      c[j] = cn[j];
      g[j] = gn[j];
    }
    f = f_new;
    gnorm = gnorm_new;
    __syncwarp();
  }

  for (int j = lane; j < d; j += C)
    p.out_c[(size_t)e * d + j] = (float)c[j];
  if (lane == 0) {
    p.out_f[e] = (float)f;
    p.out_gnorm[e] = (float)gnorm;
    p.out_it[e] = it;
    p.out_reason[e] = reason;
    p.out_steps[e] = trials;
  }
}

// Sums over the coordinates of N independent values at once, on every
// lane: one butterfly whose N shuffles per step overlap, each value with
// the bits of coord_sum<C>.
template <int C, typename T, int N>
__device__ __forceinline__ void coord_sums(T (&v)[N]) {
#pragma unroll
  for (int o = C / 2; o > 0; o >>= 1)
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += __shfl_xor_sync(kFull, v[n], o);
  if constexpr (C < 32)
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] = __shfl_sync(kFull, v[n], 0);
}

// Sums over the warp of N independent values at once (row sums, or a mix
// of row and coordinate sums: a coordinate partial is 0 on lanes past C,
// so the 32-lane tree gives it the bits of coord_sum<C>).
template <typename T, int N>
__device__ __forceinline__ void warp_sums(T (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += __shfl_xor_sync(kFull, v[n], o);
}

// TRON's row and column passes (X v, X^T u: its H v once per CG step, its
// margins and gradient once per trip) round each product and each sum,
// as -fmad=false asks and as the plain version does: a fused multiply-add
// was 2-3% faster on the large buckets and moved more rounding-level
// trust-region tests away from the plain version (PERF.md).

// out[i] = scale[i] * (sum_j x[i, j] v[j]) + add[i], lanes over rows
// (scale or add null: left out).
template <typename T, int LAYOUT, typename R>
__device__ __forceinline__ void tron_rows(const XView<T, LAYOUT>& xv,
                                          const T* v, const T* scale,
                                          const R* add, T* out, int r, int d,
                                          int lane) {
  for (int i = lane; i < r; i += 32) {
    T acc = T(0);
    for (int j = 0; j < d; ++j) acc += xv.at(i, j) * v[j];
    if (scale != nullptr) acc = scale[i] * acc;
    out[i] = add != nullptr ? acc + (T)add[i] : acc;
  }
}

// init + sum_i x[i, j] u[i] for coordinate j, the rows in order (lanes
// over coordinates).
template <typename T, int LAYOUT>
__device__ __forceinline__ T xt_col(const XView<T, LAYOUT>& xv, const T* u,
                                    T init, int r, int j) {
  T acc = init;
  for (int i = 0; i < r; ++i) acc += xv.at(i, j) * u[i];
  return acc;
}

// out[j] = l2 base[j] + sum_i x[i, j] u[i] (base = c in the gradient, the
// (masked) v in H v), lanes over coordinates; mask non-null multiplies
// the result by mask[j].
template <int C, typename T, int LAYOUT>
__device__ __forceinline__ void xt_times(const XView<T, LAYOUT>& xv,
                                         const T* u, T l2, const T* base,
                                         const T* mask, T* out, int r, int d,
                                         int lane) {
  for (int j = lane; j < d; j += C) {
    const T a = xt_col(xv, u, l2 * base[j], r, j);
    out[j] = mask != nullptr ? mask[j] * a : a;
  }
}

// TRON's gradient: out[j] = l2 c[j] + sum_i x[i, j] u[i] with u = w *
// l'(z, y).
template <int LOSS, int C, typename T, int LAYOUT>
__device__ __forceinline__ void tron_gradient(const XView<T, LAYOUT>& xv,
                                              const T* z, const float* y,
                                              const float* w, T* u,
                                              const T* c, T l2, T* out,
                                              int r, int d, int lane) {
  __syncwarp();
  for (int i = lane; i < r; i += 32)
    u[i] = (T)w[i] * Loss<LOSS, T>::d1(z[i], (T)y[i]);
  __syncwarp();
  xt_times<C>(xv, u, l2, c, (const T*)nullptr, out, r, d, lane);
}

// out = fr .* (H (fr .* v)) with H v = X^T (d2w .* X v) + l2 v; fr null
// means no mask. u is r scratch; with a mask, out holds fr .* v until the
// last pass overwrites it.
template <int C, typename T, int LAYOUT>
__device__ __forceinline__ void hess_vec(const XView<T, LAYOUT>& xv,
                                         const T* d2w, const T* v,
                                         const T* fr, T l2, T* u, T* out,
                                         int r, int d, int lane) {
  __syncwarp();
  const T* vm = v;
  if (fr != nullptr) {
    for (int j = lane; j < d; j += C) out[j] = fr[j] * v[j];
    __syncwarp();
    vm = out;
  }
  tron_rows(xv, vm, d2w, (const float*)nullptr, u, r, d, lane);
  __syncwarp();
  xt_times<C>(xv, u, l2, vm, fr, out, r, d, lane);
  __syncwarp();
}

// TRON's stationarity: |g|, or |c - P(c - g)| with bounds.
template <int C, typename T>
__device__ __forceinline__ T stat_norm(const T* c, const T* g,
                                       const float* lb, const float* ub,
                                       int d, int lane) {
  T s = T(0);
  for (int j = lane; j < d; j += C) {
    const T v = lb == nullptr ? g[j]
                              : c[j] - box(c[j] - g[j], (T)lb[j], (T)ub[j]);
    s += v * v;
  }
  return rt(coord_sum<C>(s));
}

// One entity's TRON solve (the Pallas _make_tron_kernel) on the warp's
// `lane`, its working set at `base`: a trust-region loop whose
// Steihaug-Toint CG runs per warp, with the curvature weights d2w computed
// once per trip. Bounds freeze the pinned coordinates in CG, clamp the
// trial and price the realized step with one more H v. A CG step makes
// one H v and two butterflies of several values: d.Hd, s.d, d.d and s.s
// together, then |s + alpha d|^2 with the residual norm of the step
// alpha, |r - alpha Hd|^2, so the step and the new residual norm are
// known at once; the step that crosses the radius (at most one a trip)
// sums |r - tau Hd|^2 in a third. A trip's value and ||c||^2 share one
// butterfly, and so do g.s, ||s||^2 and the model term.
template <int LOSS, typename T, int LAYOUT, int C>
__device__ void solve_tron(const Params& p, size_t state_bytes,
                           unsigned char* base, int e, int lane) {
  const int r = p.r, d = p.d;
  const T l2 = (T)p.l2, tol = (T)p.tol;
  const T pin_eps = (T)kPinEps;
  const T eta0 = (T)kEta0, eta1 = (T)kEta1, eta2 = (T)kEta2;
  const T sig1 = (T)kSigma1, sig2 = (T)kSigma2, sig3 = (T)kSigma3;
  const T tiny = (T)1e-30;
  const bool bounded = p.lower != nullptr;

  T* z = reinterpret_cast<T*>(base);
  T* zt = z + r;    // trial margins
  T* d2w = zt + r;  // curvature weights of the trip
  T* u = d2w + r;   // scratch: d1 weights, or d2w .* X v
  T* c = u + r;
  T* g = c + d;
  T* s = g + d;    // CG step
  T* rr = s + d;   // CG residual
  T* dv = rr + d;  // CG direction, then the realized step
  T* hd = dv + d;
  T* cn = hd + d;  // trial point
  T* gn = cn + d;
  T* fr = gn + d;  // 1 free, 0 pinned
  T* fa = fr + d;
  T* sh = fa + d;
  float* y = reinterpret_cast<float*>(sh + d);
  float* off = y + r;
  float* w = off + r;
  const T* mask = bounded ? fr : nullptr;
  const float* lb = entity_row(p.lower, e, d);
  const float* ub = entity_row(p.upper, e, d);

  const XView<T, LAYOUT> xv = load_entity<C, T, LAYOUT>(
      p, base, state_bytes, e, y, off, w, c, fa, sh, lane);
  tron_rows(xv, c, (const T*)nullptr, off, z, r, d, lane);
  T f;
  {
    T v[2] = {data_part<LOSS, T>(z, (const T*)nullptr, T(0), y, w, r, lane),
              T(0)};
    for (int j = lane; j < d; j += C) v[1] += c[j] * c[j];
    warp_sums(v);
    f = v[0] + T(0.5) * l2 * v[1];
  }
  tron_gradient<LOSS, C>(xv, z, y, w, u, c, l2, g, r, d, lane);
  __syncwarp();
  const T gnorm0 = stat_norm<C>(c, g, lb, ub, d, lane);
  const T f0_scale = mx(ab(f), tiny);
  T gnorm = gnorm0, delta = gnorm0;
  int reason = gnorm0 <= T(0) ? kGradientConverged : kNotConverged;
  int it = 0, fails = 0, trips = 0, cg_steps = 0;
  const int max_trips = p.max_iter * (kMaxFailures + 2);

  for (; trips < max_trips && reason == kNotConverged; ++trips) {
    for (int i = lane; i < r; i += 32)
      d2w[i] = (T)w[i] * Loss<LOSS, T>::d2(z[i], (T)y[i]);
    // Coordinates pinned at a bound with the gradient pushing outward
    // stay out of CG.
    T gg = T(0);
    for (int j = lane; j < d; j += C) {
      const bool pinned =
          bounded && ((c[j] <= (T)lb[j] + pin_eps && g[j] > T(0)) ||
                      (c[j] >= (T)ub[j] - pin_eps && g[j] < T(0)));
      fr[j] = pinned ? T(0) : T(1);
      const T gc = bounded ? g[j] * fr[j] : g[j];
      s[j] = T(0);
      rr[j] = -gc;
      dv[j] = -gc;
      gg += gc * gc;
    }
    gg = coord_sum<C>(gg);
    // Steihaug-Toint truncated CG.
    const T stop_norm = (T)kCgXi * rt(gg);
    T rtr = gg;
    bool done = rt(gg) <= stop_norm;
    for (int kk = 0; kk < kMaxCg && !done; ++kk) {
      hess_vec<C>(xv, d2w, dv, mask, l2, u, hd, r, d, lane);
      T q[4] = {T(0), T(0), T(0), T(0)};  // d.Hd, s.d, d.d, s.s
      for (int j = lane; j < d; j += C) {
        q[0] += dv[j] * hd[j];
        q[1] += s[j] * dv[j];
        q[2] += dv[j] * dv[j];
        q[3] += s[j] * s[j];
      }
      coord_sums<C>(q);
      const T dhd = q[0], std_ = q[1], dd = q[2], ss = q[3];
      const T alpha = rtr / (dhd > T(0) ? dhd : T(1));
      const T gap = nmax(delta * delta - ss, T(0));
      const T rad = rt(nmax(std_ * std_ + dd * gap, T(0)));
      const T tau = std_ >= T(0) ? gap / nmax(std_ + rad, tiny)
                                 : (rad - std_) / nmax(dd, tiny);
      // |s + alpha d|^2 and |r - alpha Hd|^2; a step that crosses the
      // radius (at most once a trip) sums |r - tau Hd|^2 on its own.
      T n[2] = {T(0), T(0)};
      for (int j = lane; j < d; j += C) {
        const T st = s[j] + alpha * dv[j];
        const T ra = rr[j] - alpha * hd[j];
        n[0] += st * st;
        n[1] += ra * ra;
      }
      coord_sums<C>(n);
      const bool crossed = n[0] > delta * delta || dhd <= T(0);
      const T step = crossed ? tau : alpha;
      T rtr_new = n[1];
      if (crossed) {
        T rt2 = T(0);
        for (int j = lane; j < d; j += C) {
          const T rt_ = rr[j] - tau * hd[j];
          rt2 += rt_ * rt_;
        }
        rtr_new = coord_sum<C>(rt2);
      }
      const T beta = rtr_new / nmax(rtr, tiny);
      for (int j = lane; j < d; j += C) {
        s[j] += step * dv[j];
        const T rn = rr[j] - step * hd[j];
        rr[j] = rn;
        dv[j] = rn + beta * dv[j];
      }
      __syncwarp();
      rtr = rtr_new;
      ++cg_steps;
      done = crossed || rt(rtr_new) <= stop_norm;
    }

    // The trial, its value and gradient; the realized step in dv.
    for (int j = lane; j < d; j += C) {
      cn[j] = bounded ? box(c[j] + s[j], (T)lb[j], (T)ub[j]) : c[j] + s[j];
      if (bounded) dv[j] = cn[j] - c[j];
    }
    __syncwarp();
    const T* sr = bounded ? dv : s;
    tron_rows(xv, cn, (const T*)nullptr, off, zt, r, d, lane);
    T f_new;
    {
      T v[2] = {
          data_part<LOSS, T>(zt, (const T*)nullptr, T(0), y, w, r, lane),
          T(0)};
      for (int j = lane; j < d; j += C) v[1] += cn[j] * cn[j];
      warp_sums(v);
      f_new = v[0] + T(0.5) * l2 * v[1];
    }
    tron_gradient<LOSS, C>(xv, zt, y, w, u, cn, l2, gn, r, d, lane);
    __syncwarp();
    if (bounded) hess_vec<C>(xv, d2w, sr, (const T*)nullptr, l2, u, hd, r, d,
                             lane);
    // g.s_r, s_r.s_r, and s_r.H s_r with bounds or s.r without.
    T q[3] = {T(0), T(0), T(0)};
    for (int j = lane; j < d; j += C) {
      q[0] += g[j] * sr[j];
      q[1] += sr[j] * sr[j];
      q[2] += bounded ? sr[j] * hd[j] : s[j] * rr[j];
    }
    coord_sums<C>(q);
    const T gs = q[0];
    const T prered = bounded ? -(gs + T(0.5) * q[2]) : T(-0.5) * (gs - q[2]);
    const T actred = f - f_new;
    const T snorm = rt(q[1]);

    // LIBLINEAR's radius update.
    T delta_n = trips == 0 ? nmin(delta, snorm) : delta;
    const T denom = f_new - f - gs;
    const T alpha_i =
        denom <= T(0) ? sig3 : nmax(sig1, T(-0.5) * (gs / nmax(denom, tiny)));
    const T alpha_s = alpha_i * snorm;
    if (actred < eta0 * prered)
      delta_n = nmin(nmax(alpha_i, sig1) * snorm, sig2 * delta_n);
    else if (actred < eta1 * prered)
      delta_n = nmax(sig1 * delta_n, nmin(alpha_s, sig2 * delta_n));
    else if (actred < eta2 * prered)
      delta_n = nmax(sig1 * delta_n, nmin(alpha_s, sig3 * delta_n));
    else
      delta_n = nmax(delta_n, nmin(alpha_s, sig3 * delta_n));

    const bool accept = actred > eta0 * prered && finite(f_new);
    const T f_old = f;
    __syncwarp();
    if (accept) {
      ++it;
      fails = 0;
      // Non-finite margins and gradient entries are kept as 0, as the
      // Pallas kernel keeps them.
      for (int j = lane; j < d; j += C) {
        c[j] = cn[j];
        g[j] = finite(gn[j]) ? gn[j] : T(0);
      }
      for (int i = lane; i < r; i += 32) z[i] = finite(zt[i]) ? zt[i] : T(0);
      f = f_new;
    } else {
      ++fails;
    }
    __syncwarp();
    gnorm = stat_norm<C>(c, g, lb, ub, d, lane);
    delta = delta_n;
    if (fails > kMaxFailures)
      reason = kObjectiveNotImproving;
    else if (accept && gnorm <= tol * gnorm0)
      reason = kGradientConverged;
    else if (accept && ab(f_old - f) <= tol * f0_scale)
      reason = kFunctionValuesConverged;
    else if (it >= p.max_iter)
      reason = kMaxIterations;
  }

  for (int j = lane; j < d; j += C) p.out_c[(size_t)e * d + j] = (float)c[j];
  if (lane == 0) {
    p.out_f[e] = (float)f;
    p.out_gnorm[e] = (float)gnorm;
    p.out_it[e] = it;
    p.out_reason[e] = reason;
    p.out_steps[e] = trips;
    p.out_cg[e] = cg_steps;
  }
}

// The persistent grid of every mode: each warp takes the next entity from
// p.next until none is left, so no block waits on its slowest entity and
// no partial last wave idles. The last warp to finish sets the counter
// pair back to 0 for the next launch.
template <int LOSS, typename T, int LAYOUT, int MODE, int C>
__device__ __forceinline__ void solve_entities(const Params& p,
                                               const Plan& plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* slot = smem + (size_t)warp * plan.entity_bytes;
  for (;;) {
    int e = 0;
    if (lane == 0) e = atomicAdd(p.next, 1);
    e = __shfl_sync(kFull, e, 0);
    if (e >= p.E) break;  // whole warps only: no block barrier follows
    unsigned char* base =
        LAYOUT == kAllGlobal ? p.workspace + (size_t)e * plan.state_bytes
                             : slot;
    if constexpr (MODE == kModeTron)
      solve_tron<LOSS, T, LAYOUT, C>(p, plan.state_bytes, base, e, lane);
    else
      solve_lbfgs<LOSS, T, LAYOUT, MODE == kModeOwlqn, C>(
          p, plan.state_bytes, base, e, lane);
    __syncwarp();  // the warp is done with the slot
  }
  if (lane == 0) {
    // Every warp takes one ticket past E before it counts itself done, so
    // the last one done is the last to touch p.next.
    __threadfence();
    const int warps = (int)(gridDim.x * (blockDim.x >> 5));
    if (atomicAdd(p.next + 1, 1) == warps - 1) {
      atomicExch(p.next, 0);
      atomicExch(p.next + 1, 0);
    }
  }
}

// The L-BFGS and OWL-QN kernel.
template <int LOSS, typename T, int LAYOUT, int MODE, int C>
__global__ void __launch_bounds__(128) entity_lbfgs_kernel(Params p,
                                                           Plan plan) {
  solve_entities<LOSS, T, LAYOUT, MODE, C>(p, plan);
}

// The TRON kernel. It asks for 5 resident blocks of 128 threads, so at
// most 96 registers: uncapped, its float64 instances take 138-162 and an
// SM then holds 3-4 blocks of 4 warps where shared memory allows 4-6
// (PERF.md: at n_pad 32 and 64, d_pad 32, the cap is worth 16-20% of
// device time).
template <int LOSS, typename T, int LAYOUT, int MODE, int C>
__global__ void __launch_bounds__(128, 5) entity_tron_kernel(Params p,
                                                             Plan plan) {
  solve_entities<LOSS, T, LAYOUT, kModeTron, C>(p, plan);
}

using KernelFn = void (*)(Params, Plan);

// The instance for a plan, in every mode: C = 4, 8, 16 or 32 in the
// shared layout and C = 32 in the device-memory layouts.
template <int LOSS, typename T, int MODE, int LAYOUT, int C>
constexpr KernelFn kernel_of_mode() {
  if constexpr (MODE == kModeTron)
    return entity_tron_kernel<LOSS, T, LAYOUT, MODE, C>;
  else
    return entity_lbfgs_kernel<LOSS, T, LAYOUT, MODE, C>;
}
template <int LOSS, typename T, int MODE>
KernelFn plan_kernel(const Plan& plan) {
  if (plan.layout == kXGlobal)
    return kernel_of_mode<LOSS, T, MODE, kXGlobal, 32>();
  if (plan.layout == kAllGlobal)
    return kernel_of_mode<LOSS, T, MODE, kAllGlobal, 32>();
  switch (plan.coord_lanes) {
    case 4: return kernel_of_mode<LOSS, T, MODE, kAllShared, 4>();
    case 8: return kernel_of_mode<LOSS, T, MODE, kAllShared, 8>();
    case 16: return kernel_of_mode<LOSS, T, MODE, kAllShared, 16>();
    default: return kernel_of_mode<LOSS, T, MODE, kAllShared, 32>();
  }
}

// A unit's instance for `loss` (kernel_id 0-3; TRON 0-2 only), or
// nullptr.
template <typename T, int MODE>
KernelFn unit_kernel(const Plan& plan, int loss) {
  switch (loss) {
    case 0: return plan_kernel<0, T, MODE>(plan);
    case 1: return plan_kernel<1, T, MODE>(plan);
    case 2: return plan_kernel<2, T, MODE>(plan);
    case 3:
      // TRON needs a twice-differentiable loss.
      if constexpr (MODE == kModeTron) return nullptr;
      else return plan_kernel<3, T, MODE>(plan);
    default: return nullptr;
  }
}

// One per translation unit, so that nvcc builds them in parallel.
KernelFn kernel_lbfgs_f64(const Plan& plan, int loss);
KernelFn kernel_lbfgs_f32(const Plan& plan, int loss);
KernelFn kernel_owlqn_f64(const Plan& plan, int loss);
KernelFn kernel_owlqn_f32(const Plan& plan, int loss);
KernelFn kernel_tron_f64(const Plan& plan, int loss);
KernelFn kernel_tron_f32(const Plan& plan, int loss);

}  // namespace entity_lbfgs
