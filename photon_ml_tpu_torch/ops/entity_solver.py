"""Per-entity GLM solve: a hand-written Hopper kernel and its plain
PyTorch version (port of photon_ml_tpu/ops/pallas_entity_solver.py:
``pallas_entity_lbfgs`` :852 in its three modes, with or without the
normalization fold and box constraints: ``_make_kernel`` -> ``body``
:453-541, ``body_owlqn`` :328-394, ``body_bounded`` :396-451,
``_tiered_sweep`` :141, ``_two_loop`` :116, ``finish`` :267, the fold
:199-209; ``_make_tron_kernel`` :561-845).

The random-effect coordinate solves thousands of tiny independent GLMs,
one per entity, over a bucket's ``[E, r, d]`` block. With ``factors`` and
``shifts`` the solve runs on x' = (x - shift) * factor, per entity; x' is
computed in the compute type and rounded to the input type (float32 on
the card), so the kernel's shared-memory tile holds it exactly. With
``lower``/``upper`` ([E, d], +-inf where a coordinate is free) every
iterate is clamped onto the box P(c) = min(max(c, lower), upper); c0 is
projected first. Bounds clamp the solve-space coefficients as they are.
Coefficients in and out are in that solve space.

Modes "lbfgs" and "owlqn", per entity:

    c0 given; z0 = X c0 + off; f0 = sum w l(z0) + l2/2 |c0|^2
      (+ l1 |c0|_1 in OWL-QN); g0 = smooth gradient
    q = g (L-BFGS) or the pseudo-gradient pg(c, g) (OWL-QN); |q0| is the
      gradient norm every stop test uses (the raw |g| with bounds)
    reason = GRADIENT_CONVERGED if |q0| <= 0 else NOT_CONVERGED
    while k < max_iter and the entity is active:
      direction: two-loop recursion on q over the last count <= m pairs
        (gamma = s.y / max(y.y, 1e-10), 1 when empty). L-BFGS: -g unless
        descent. OWL-QN: zero each component with dir * pg >= 0, then -pg
        if dir . pg >= 0
      line search, t_k = t0 0.5^k for k = 0..max_line_search, t0 =
        1/max(|d|, 1) while the history is empty, else 1; accept the FIRST
        t whose trial value is finite and passes Armijo:
        L-BFGS: zp = X d; f_t = sum w l(z + t zp) + l2/2 (xx + 2 t xp +
          t^2 pp) <= f + c1 t g.d
        bounded L-BFGS: x_t = P(c + t d); z_t = X x_t + off; f_t = sum w
          l(z_t) + l2/2 |x_t|^2 <= f + c1 g.(x_t - c)
        OWL-QN: x_t = c + t d with each coordinate whose sign differs
          from the orthant (sign(c) where c != 0, else sign(-pg)) set to
          0; z_t = X x_t + off; f_t = sum w l(z_t) + l2/2 |x_t|^2 +
          l1 |x_t|_1 <= f + c1 pg.(x_t - c)
        the accepted trial's non-finite margins are kept as 0
      history: store (s, y) from the smooth gradients when the search
        succeeded and s.y > 1e-10 |s| |y|; rho = 1/s.y; count =
        min(count + 1, m)
      stop: failed search -> OBJECTIVE_NOT_IMPROVING; |q| <= tol |q0| ->
        GRADIENT_CONVERGED; |df| <= tol max(|f0|, 1e-30) ->
        FUNCTION_VALUES_CONVERGED; iterations >= max_iter -> MAX_ITERATIONS
      a failed search leaves the iterate where it was but counts the
        iteration

Mode "tron" (twice-differentiable losses, L2 only), per entity, the
Pallas kernel's TRON and not optimization/tron.py's (they differ in
where a trip is counted and in how non-finite trials are kept):

    stationarity |g|, or |c - P(c - g)| with bounds; gnorm0 from c0;
      radius delta = gnorm0; first = true
    while trips < max_iter * 7 and the entity is active:
      d2w = w l''(z) once per trip; Hv = X^T (d2w * X v) + l2 v
      with bounds: free = not (c <= lower + 1e-12 and g > 0 or c >= upper
        - 1e-12 and g < 0); CG sees g * free and free * H(free * v)
      Steihaug-Toint CG from s = 0 for at most 20 steps, stopping on the
        boundary |s| = delta, on curvature d.Hd <= 0, or at |r| <= 0.1 |g|
      c_t = c + s (P(c + s) with bounds), s_real = c_t - c; f_t, g_t;
        prered = -(g.s - s.r)/2, or -(g.s_real + s_real.H s_real / 2)
        with bounds (one more Hv); actred = f - f_t
      delta: min(delta, |s_real|) on the first trip, then LIBLINEAR's
        update (eta 1e-4, 0.25, 0.75; sigma 0.25, 0.5, 4)
      accept when actred > 1e-4 prered and f_t is finite: iterations + 1,
        failures 0; else failures + 1. Non-finite z_t, g_t and f_t are
        kept as 0
      stop: failures > 5 -> OBJECTIVE_NOT_IMPROVING; accepted and
        stationarity <= tol gnorm0 -> GRADIENT_CONVERGED; accepted and
        |df| <= tol max(|f0|, 1e-30) -> FUNCTION_VALUES_CONVERGED;
        iterations >= max_iter -> MAX_ITERATIONS

Both versions compute in ``compute_dtype`` (float64 by default) whatever
the input type, and the kernel takes float32 in and writes float32 out.
Float64 is the default because two float32 implementations that sum in
different orders stop some entities for different reasons at the
random-effect tolerance: chip_smoke.py counts those disagreements
between the float32 kernel and the float32 plain version at the headline
buckets. Both report the work each entity did, from which chip_smoke.py
counts operations: the line-search trials it priced
(``OptimizerResult.trials``) in the L-BFGS modes, its TRON trips and CG
steps (``outer_steps``, ``cg_steps``) in TRON.

``entity_lbfgs`` is the wrapper: it runs the plain version for tensors on
the CPU, launches the CUDA kernel for tensors on the card, and raises for
anything else. There is no fallback from one to the other.

Kernel note (csrc/entity_lbfgs.cu). Replaces the Pallas TPU kernel above,
which ran 128 entities in lane lockstep. On the H100 one warp owns one
entity; an L-BFGS or OWL-QN entity's coordinates go over its first C
lanes, C the smallest power of two >= d, so a sum over coordinates is a
butterfly of log2 C shuffle steps. Its working set and x tile sit in
shared memory with the tile's row stride padded to d + 1 floats (no bank
conflicts for lanes over rows); margins put lanes over rows, the gradient
and the history (a ring, newest pair first) lanes over coordinates. The
grid is persistent: as many blocks as the card holds resident, each
warp taking the next entity from an atomic counter when its own stops,
so a bucket of more than one wave keeps the card full to its last
entity; the last warp out sets the counter back to 0. Line-search
candidates are tried in order up to the first that passes, where the TPU
prices 8 as a block and 23 more on demand (the same accepted step). TRON
is its own solve body on the same helpers and the same persistent grid
and lanes, with its own working set (no history; its rows' labels,
offsets and weights kept float32) and its CG loop per warp: a CG step's
dot products go in two multi-value butterflies, and its instances are
held to 96 registers so that registers do not cap residency. The
normalization fold is applied once as the tile is loaded, or on every
read where x stays in device memory; bounds are a runtime flag (a null
pointer means none). An entity too tall for shared memory reads x
from device memory, and its working set goes to a workspace the wrapper
allocates, so every bucket launches the kernel. Each launch plan (layout,
C, warps per block, chosen by occupancy to keep the most entities
resident, resident blocks, the kernel's shared-memory attribute) is made
once per shape, compute type, mode, loss and device (``kernel_plan``)
and a call then allocates two output buffers and makes one C call. What
bounds the solve on this card is each entity's serial dependency chain
(dot -> shuffle -> update) times the waves of entities the card holds.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.optimization.convergence import (
    ConvergenceReason,
    OptimizerResult,
)
from photon_ml_tpu_torch.optimization.owlqn import pseudo_gradient
from photon_ml_tpu_torch.utils import device_loop

Tensor = torch.Tensor

DEFAULT_M = 10
DEFAULT_MAX_LINE_SEARCH = 30
_CAUTIOUS_EPS = 1e-10
MODES = ("lbfgs", "owlqn", "tron")
# TRON's constants (the LIBLINEAR rules of optimization/tron.py and the
# Pallas kernel :579-582, with its CG and failure budgets).
TRON_ETA0, TRON_ETA1, TRON_ETA2 = 1e-4, 0.25, 0.75
TRON_SIGMA1, TRON_SIGMA2, TRON_SIGMA3 = 0.25, 0.5, 4.0
TRON_CG_XI = 0.1
TRON_MAX_CG = 20
TRON_MAX_FAILURES = 5


def _where(mask: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """where(mask, a, b) for a per-entity [E] mask against [E, ...]."""
    return torch.where(mask.view(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _two_loop(g, S, Y, rho, count):
    """Two-loop recursion batched over entities: g [E, d], S/Y [E, m, d]
    oldest first, rho [E, m] (0 = empty slot)."""
    m = S.shape[1]
    q = g
    alphas = [None] * m
    for j in reversed(range(m)):
        alphas[j] = rho[:, j] * torch.sum(S[:, j] * q, dim=-1)
        q = q - alphas[j][:, None] * Y[:, j]
    yy = torch.sum(Y[:, -1] * Y[:, -1], dim=-1)
    sy = torch.sum(S[:, -1] * Y[:, -1], dim=-1)
    gamma = torch.where(count > 0, sy / torch.clamp_min(yy, _CAUTIOUS_EPS),
                        torch.ones_like(sy))
    rr = gamma[:, None] * q
    for j in range(m):
        beta = rho[:, j] * torch.sum(Y[:, j] * rr, dim=-1)
        rr = rr + (alphas[j] - beta)[:, None] * S[:, j]
    return -rr


def check_mode(mode: str, lower=None, upper=None,
               loss: Optional[PointwiseLoss] = None) -> None:
    """Raise for what the entity solver does not take (on the CPU and the
    card alike): an unknown mode, bounds with OWL-QN, and TRON on a loss
    that is not twice differentiable, as ``solve_glm`` refuses them."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: expected lbfgs | owlqn | "
                         "tron")
    if mode == "owlqn" and (lower is not None or upper is not None):
        raise ValueError("box constraints with L1 are not supported "
                         "(matching solve_glm)")
    if mode == "tron" and loss is not None and \
            not loss.twice_differentiable:
        raise ValueError(f"TRON requires a twice-differentiable loss, got "
                         f"{loss.name}")


def _project(c: Tensor, lo: Optional[Tensor], hi: Optional[Tensor]
             ) -> Tensor:
    """min(max(c, lo), hi), NaN-propagating as jnp's; c when unbounded."""
    if lo is None:
        return c
    return torch.minimum(torch.maximum(c, lo), hi)


def entity_lbfgs_plain(
    loss: PointwiseLoss, x: Tensor, labels: Tensor, offsets: Tensor,
    weights: Tensor, coef0: Tensor, l2_weight: float, l1_weight: float = 0.0,
    factors: Optional[Tensor] = None, shifts: Optional[Tensor] = None,
    lower: Optional[Tensor] = None, upper: Optional[Tensor] = None, *,
    max_iter: int = 100, tol: float = 1e-7, m: int = DEFAULT_M,
    c1: float = 1e-4, max_line_search: int = DEFAULT_MAX_LINE_SEARCH,
    mode: str = "lbfgs", compute_dtype: torch.dtype = torch.float64,
) -> OptimizerResult:
    """The solve in plain batched PyTorch over the entity axis, with
    masks for entities that have stopped (one host sync per iteration,
    and per CG step in TRON). All line-search candidates are priced as
    one [E, T, r] block (from the [E, T, d] trial points' own margins in
    OWL-QN and with bounds); the first passing one per entity is the
    accepted step, and the trials an entity priced are counted as the
    kernel prices them, in order up to that one."""
    check_mode(mode, lower, upper, loss)
    _check_compute_dtype(compute_dtype)
    out_dtype = x.dtype
    dt = compute_dtype
    x = _fold(x, factors, shifts, dt)
    y, off, w, c = (a.to(dt) for a in (labels, offsets, weights, coef0))
    lo, hi = _box(lower, upper, c)
    c = _project(c, lo, hi)
    if mode == "tron":
        return _tron_plain(loss, x, y, off, w, c, l2_weight, lo, hi,
                           max_iter, tol, out_dtype)
    owlqn = mode == "owlqn"
    bounded = lo is not None
    E, _, d = x.shape
    dev = x.device
    i32 = torch.int32
    NC = int(ConvergenceReason.NOT_CONVERGED)
    l1 = float(l1_weight) if owlqn else 0.0

    def margins(v):
        return torch.sum(x * v[:, None, :], dim=-1) + off

    def grad_from(cc, zz):
        u = w * loss.d1(zz, y)
        return l2_weight * cc + torch.sum(x * u[:, :, None], dim=1)

    def conv_norm(cc, gg):
        return torch.sqrt(_sq(pseudo_gradient(cc, gg, l1) if owlqn else gg))

    z = margins(c)
    f = torch.sum(w * loss.loss(z, y), dim=-1) + 0.5 * l2_weight * _sq(c)
    if owlqn:
        f = f + l1 * torch.sum(torch.abs(c), dim=-1)
    g = grad_from(c, z)
    gnorm0 = conv_norm(c, g)
    gnorm = gnorm0
    f0_scale = torch.clamp_min(torch.abs(f), 1e-30)
    S = torch.zeros((E, m, d), dtype=dt, device=dev)
    Y = torch.zeros_like(S)
    rho = torch.zeros((E, m), dtype=dt, device=dev)
    count = torch.zeros((E,), dtype=i32, device=dev)
    it = torch.zeros((E,), dtype=i32, device=dev)
    trials = torch.zeros((E,), dtype=i32, device=dev)

    def code(reason):
        return torch.full((E,), int(reason), dtype=i32, device=dev)

    reason = torch.where(gnorm0 <= 0.0,
                         code(ConvergenceReason.GRADIENT_CONVERGED), code(NC))
    n_trials = max_line_search + 1
    powers = torch.pow(torch.tensor(0.5, dtype=dt, device=dev),
                       torch.arange(n_trials, dtype=dt, device=dev))

    k = 0
    while k < max_iter and bool(torch.any(reason == NC)):
        active = reason == NC
        if owlqn:
            pg = pseudo_gradient(c, g, l1)
            direction = _two_loop(pg, S, Y, rho, count)
            direction = torch.where(direction * pg < 0, direction,
                                    torch.zeros_like(direction))
            direction = _where(torch.sum(direction * pg, dim=-1) >= 0, -pg,
                               direction)
        else:
            direction = _two_loop(g, S, Y, rho, count)
            direction = _where(torch.sum(direction * g, dim=-1) >= 0, -g,
                               direction)
        pp = _sq(direction)
        init = torch.where(count == 0,
                           1.0 / torch.clamp_min(torch.sqrt(pp), 1.0),
                           torch.ones_like(pp))
        ts = init[:, None] * powers  # [E, T]
        if owlqn or bounded:
            # Projected trials, each priced from its own margins.
            xt = c[:, None, :] + ts[:, :, None] * direction[:, None, :]
            if owlqn:
                orthant = torch.where(c != 0, torch.sign(c), torch.sign(-pg))
                xt = torch.where(torch.sign(xt) == orthant[:, None, :], xt,
                                 torch.zeros_like(xt))  # [E, T, d]
                q = pg
            else:
                xt = _project(xt, lo[:, None, :], hi[:, None, :])
                q = g
            zt = torch.einsum("erd,etd->etr", x, xt) + off[:, None, :]
            ft = (torch.sum(w[:, None, :] * loss.loss(zt, y[:, None, :]),
                            dim=-1)
                  + 0.5 * l2_weight * torch.sum(xt * xt, dim=-1)
                  + l1 * torch.sum(torch.abs(xt), dim=-1))
            dec = torch.sum(q[:, None, :] * (xt - c[:, None, :]), dim=-1)
            armijo = (ft <= f[:, None] + c1 * dec) & torch.isfinite(ft)
        else:
            zp = margins(direction) - off
            xx = _sq(c)
            xp = torch.sum(c * direction, dim=-1)
            gp = torch.sum(g * direction, dim=-1)
            zt = z[:, None, :] + ts[:, :, None] * zp[:, None, :]  # [E, T, r]
            ft = (torch.sum(w[:, None, :] * loss.loss(zt, y[:, None, :]),
                            dim=-1)
                  + 0.5 * l2_weight * (xx[:, None] + 2.0 * ts * xp[:, None]
                                       + ts * ts * pp[:, None]))
            armijo = (ft <= f[:, None] + c1 * ts * gp[:, None]) \
                & torch.isfinite(ft)
        ok = torch.any(armijo, dim=-1)
        first = torch.argmax(armijo.to(i32), dim=-1, keepdim=True)
        f_new = torch.where(ok, torch.gather(ft, 1, first)[:, 0],
                            torch.zeros_like(pp))
        if owlqn or bounded:
            pick = first[:, :, None]
            c_new = torch.gather(xt, 1, pick.expand(E, 1, d))[:, 0]
            z_new = torch.gather(zt, 1, pick.expand(E, 1, zt.shape[-1]))[:, 0]
            z_new = torch.where(torch.isfinite(z_new), z_new,
                                torch.zeros_like(z_new))
        else:
            t_acc = torch.where(ok, torch.gather(ts, 1, first)[:, 0],
                                torch.zeros_like(pp))
            c_new = c + t_acc[:, None] * direction
            z_new = z + t_acc[:, None] * zp
        g_new = grad_from(c_new, z_new)
        gnorm_new = conv_norm(c_new, g_new)

        s_vec, y_vec = c_new - c, g_new - g
        sy = torch.sum(s_vec * y_vec, dim=-1)
        store = ok & (sy > _CAUTIOUS_EPS * torch.sqrt(_sq(s_vec))
                      * torch.sqrt(_sq(y_vec)))
        store = store & active
        S = _where(store, torch.cat([S[:, 1:], s_vec[:, None]], dim=1), S)
        Y = _where(store, torch.cat([Y[:, 1:], y_vec[:, None]], dim=1), Y)
        inv_sy = torch.where(sy != 0, 1.0 / sy, torch.zeros_like(sy))
        rho = _where(store, torch.cat([rho[:, 1:], inv_sy[:, None]], dim=1),
                     rho)
        count = torch.where(store, torch.clamp_max(count + 1, m), count)

        it_new = it + 1
        f_delta = torch.abs(f - f_new)
        new_reason = torch.where(
            ~ok, code(ConvergenceReason.OBJECTIVE_NOT_IMPROVING),
            torch.where(
                gnorm_new <= tol * gnorm0,
                code(ConvergenceReason.GRADIENT_CONVERGED),
                torch.where(
                    f_delta <= tol * f0_scale,
                    code(ConvergenceReason.FUNCTION_VALUES_CONVERGED),
                    torch.where(it_new >= max_iter,
                                code(ConvergenceReason.MAX_ITERATIONS),
                                code(NC)))))

        # Entities whose search failed keep their iterate; stopped ones
        # keep everything.
        moved = ok & active
        c = _where(moved, c_new, c)
        z = _where(moved, z_new, z)
        f = torch.where(moved, f_new, f)
        g = _where(moved, g_new, g)
        gnorm = torch.where(moved, gnorm_new, gnorm)
        priced = torch.where(ok, first[:, 0] + 1, n_trials).to(i32)
        trials = torch.where(active, trials + priced, trials)
        it = torch.where(active, it_new, it)
        reason = torch.where(active, new_reason, reason)
        k += 1

    return OptimizerResult(
        x=c.to(out_dtype), value=f.to(out_dtype),
        grad_norm=gnorm.to(out_dtype), iterations=it, reason=reason,
        trials=trials)


def _tron_plain(loss: PointwiseLoss, x: Tensor, y: Tensor, off: Tensor,
                w: Tensor, c: Tensor, l2: float, lo: Optional[Tensor],
                hi: Optional[Tensor], max_iter: int, tol: float,
                out_dtype: torch.dtype) -> OptimizerResult:
    """Mode "tron" of ``entity_lbfgs_plain`` (the Pallas ``_make_tron_kernel``
    body :655-828) on folded ``x`` and a projected ``c``, all in the
    compute type: outer trips and CG steps batched over entities with
    per-entity masks, one host sync per trip and per CG step. Every sum
    is taken in the kernel's order (``_lane_sum``, ``_row_products``,
    ``_col_products``), so that on the card both round alike."""
    E = x.shape[0]
    dev, dt = x.device, x.dtype
    i32 = torch.int32
    bounded = lo is not None
    NC = int(ConvergenceReason.NOT_CONVERGED)

    def code(reason):
        return torch.full((E,), int(reason), dtype=i32, device=dev)

    def sq(v):
        return _lane_sum(v * v)

    def margins(v):
        return _row_products(x, v) + off

    def value_from(zz, cc):
        return _lane_sum(w * loss.loss(zz, y)) + 0.5 * l2 * sq(cc)

    def grad_from(cc, zz):
        return _col_products(x, w * loss.d1(zz, y), l2 * cc)

    def stat_norm(cc, gg):
        if not bounded:
            return torch.sqrt(sq(gg))
        return torch.sqrt(sq(cc - _project(cc - gg, lo, hi)))

    def zero_nonfinite(a):
        return torch.where(torch.isfinite(a), a, torch.zeros_like(a))

    z = margins(c)
    f = value_from(z, c)
    g = grad_from(c, z)
    gnorm0 = stat_norm(c, g)
    f0_scale = torch.clamp_min(torch.abs(f), 1e-30)
    delta, gnorm = gnorm0, gnorm0
    it = torch.zeros((E,), dtype=i32, device=dev)
    fails = torch.zeros_like(it)
    outer = torch.zeros_like(it)
    cg_steps = torch.zeros_like(it)
    first = torch.ones((E,), dtype=torch.bool, device=dev)
    reason = torch.where(gnorm0 <= 0.0,
                         code(ConvergenceReason.GRADIENT_CONVERGED), code(NC))
    trips = max_iter * (TRON_MAX_FAILURES + 2)
    k = 0
    while k < trips and bool(torch.any(reason == NC)):
        active = reason == NC
        d2w = w * loss.d2(z, y)  # curvature once per trip

        def hvp(v):
            return _col_products(x, d2w * _row_products(x, v), l2 * v)

        if bounded:
            # Coordinates pinned at a bound with the gradient pushing
            # outward stay out of CG.
            eps = 1e-12
            pinned = (((c <= lo + eps) & (g > 0))
                      | ((c >= hi - eps) & (g < 0)))
            free = (~pinned).to(dt)
            g_cg = g * free

            def hvp_cg(v):
                return free * hvp(free * v)
        else:
            g_cg, hvp_cg = g, hvp

        # Steihaug-Toint truncated CG; entities that stop keep their state.
        gg = sq(g_cg)
        stop_norm = TRON_CG_XI * torch.sqrt(gg)
        s = torch.zeros_like(g_cg)
        rres, dvec, rtr = -g_cg, -g_cg, gg
        done = ~active | (torch.sqrt(gg) <= stop_norm)
        kk = 0
        while kk < TRON_MAX_CG and not bool(torch.all(done)):
            hd = hvp_cg(dvec)
            dhd = _lane_sum(dvec * hd)
            alpha = rtr / torch.where(dhd > 0, dhd, torch.ones_like(dhd))
            s_try = s + alpha[:, None] * dvec
            crossed = (sq(s_try) > delta * delta) | (dhd <= 0)
            std = _lane_sum(s * dvec)
            dd = sq(dvec)
            ss = sq(s)
            gap = torch.clamp_min(delta * delta - ss, 0.0)
            rad = torch.sqrt(torch.clamp_min(std * std + dd * gap, 0.0))
            tau = torch.where(std >= 0,
                              gap / torch.clamp_min(std + rad, 1e-30),
                              (rad - std) / torch.clamp_min(dd, 1e-30))
            step = torch.where(crossed, tau, alpha)
            s_new = s + step[:, None] * dvec
            r_new = rres - step[:, None] * hd
            rtr_new = sq(r_new)
            beta = rtr_new / torch.clamp_min(rtr, 1e-30)
            d_new = r_new + beta[:, None] * dvec
            done_new = crossed | (torch.sqrt(rtr_new) <= stop_norm)
            cg_steps = cg_steps + (~done).to(i32)
            s = _where(done, s, s_new)
            rres = _where(done, rres, r_new)
            dvec = _where(done, dvec, d_new)
            rtr = torch.where(done, rtr, rtr_new)
            done = done | done_new
            kk += 1

        if bounded:
            c_try = _project(c + s, lo, hi)
            s_real = c_try - c
        else:
            c_try = c + s
            s_real = s
        z_try = margins(c_try)
        f_new = value_from(z_try, c_try)
        g_new = grad_from(c_try, z_try)
        gs = _lane_sum(g * s_real)
        if bounded:
            prered = -(gs + 0.5 * _lane_sum(s_real * hvp(s_real)))
        else:
            prered = -0.5 * (gs - _lane_sum(s * rres))
        actred = f - f_new
        snorm = torch.sqrt(sq(s_real))
        delta_n = torch.where(first, torch.minimum(delta, snorm), delta)
        denom = f_new - f - gs
        alpha_i = torch.where(
            denom <= 0, torch.full_like(denom, TRON_SIGMA3),
            torch.clamp_min(-0.5 * (gs / torch.clamp_min(denom, 1e-30)),
                            TRON_SIGMA1))
        alpha_s = alpha_i * snorm
        delta_n = torch.where(
            actred < TRON_ETA0 * prered,
            torch.minimum(torch.clamp_min(alpha_i, TRON_SIGMA1) * snorm,
                          TRON_SIGMA2 * delta_n),
            torch.where(
                actred < TRON_ETA1 * prered,
                torch.maximum(TRON_SIGMA1 * delta_n,
                              torch.minimum(alpha_s, TRON_SIGMA2 * delta_n)),
                torch.where(
                    actred < TRON_ETA2 * prered,
                    torch.maximum(TRON_SIGMA1 * delta_n,
                                  torch.minimum(alpha_s,
                                                TRON_SIGMA3 * delta_n)),
                    torch.maximum(delta_n,
                                  torch.minimum(alpha_s,
                                                TRON_SIGMA3 * delta_n)))))

        accept = (actred > TRON_ETA0 * prered) & torch.isfinite(f_new)
        it_n = it + accept.to(i32)
        fails_n = torch.where(accept, torch.zeros_like(fails), fails + 1)
        # The Pallas kernel keeps a rejected trial's non-finite values as 0.
        z_try, g_new, f_new = (zero_nonfinite(a) for a in (z_try, g_new,
                                                            f_new))
        c_acc = _where(accept, c_try, c)
        z_acc = _where(accept, z_try, z)
        f_acc = torch.where(accept, f_new, f)
        g_acc = _where(accept, g_new, g)
        gnorm_acc = stat_norm(c_acc, g_acc)
        f_delta = torch.abs(f - f_acc)
        reason_n = torch.where(
            fails_n > TRON_MAX_FAILURES,
            code(ConvergenceReason.OBJECTIVE_NOT_IMPROVING),
            torch.where(
                accept & (gnorm_acc <= tol * gnorm0),
                code(ConvergenceReason.GRADIENT_CONVERGED),
                torch.where(
                    accept & (f_delta <= tol * f0_scale),
                    code(ConvergenceReason.FUNCTION_VALUES_CONVERGED),
                    torch.where(it_n >= max_iter,
                                code(ConvergenceReason.MAX_ITERATIONS),
                                code(NC)))))

        c = _where(active, c_acc, c)
        z = _where(active, z_acc, z)
        f = torch.where(active, f_acc, f)
        g = _where(active, g_acc, g)
        delta = torch.where(active, delta_n, delta)
        it = torch.where(active, it_n, it)
        fails = torch.where(active, fails_n, fails)
        reason = torch.where(active, reason_n, reason)
        gnorm = torch.where(active, gnorm_acc, gnorm)
        first = first & ~active
        outer = outer + active.to(i32)
        k += 1

    return OptimizerResult(
        x=c.to(out_dtype), value=f.to(out_dtype),
        grad_norm=gnorm.to(out_dtype), iterations=it, reason=reason,
        outer_steps=outer, cg_steps=cg_steps)


def _sq(v: Tensor) -> Tensor:
    return torch.sum(v * v, dim=-1)


# The kernel's reduction orders (csrc/entity_lbfgs.cuh), which the plain
# TRON follows so that both round every sum alike: at a bounded optimum
# the accept test actred > eta0 prered compares two values of rounding
# size, and torch's own reduction trees flipped it for 14 of 20,000
# entities on the H100.


def _in_order(p: Tensor, dim: int, init: Optional[Tensor] = None
              ) -> Tensor:
    """The sum of p along ``dim`` with its entries added in order to init
    (0 when None): a loop of adds, or, for float64 on the CPU, the last
    prefix of one cumsum (whose CPU scan adds in that order, in
    float64)."""
    if p.device.type == "cpu" and p.dtype == torch.float64:
        if init is not None:
            p = torch.cat([init.unsqueeze(dim), p], dim)
        return torch.cumsum(p, dim).select(dim, -1)
    acc = torch.zeros_like(p.select(dim, 0)) if init is None else init
    for i in range(p.shape[dim]):
        acc = acc + p.select(dim, i)
    return acc


def _lane_sum(v: Tensor) -> Tensor:
    """Sum over the last axis as a warp sums it: entry i goes to lane
    i mod 32, each lane adds its entries in order from 0, then an xor
    butterfly adds the 32 lanes (offsets 16, 8, 4, 2, 1). Rows over the
    warp's lanes sum so (``warp_sums``), and so do coordinates over its
    first C lanes (``coord_sums``): C >= d up to 32, and the butterfly's
    steps past C only add the zeros of the idle lanes."""
    n = v.shape[-1]
    k = -(-n // 32)
    if k * 32 != n:
        v = torch.nn.functional.pad(v, (0, k * 32 - n))
    acc = _in_order(v.reshape(*v.shape[:-1], k, 32), -2)
    for o in (16, 8, 4, 2, 1):
        acc = acc[..., :o] + acc[..., o:2 * o]
    return acc[..., 0]


def _row_products(x: Tensor, v: Tensor) -> Tensor:
    """[E, r] = x [E, r, d] times v [E, d], each row's coordinates added
    in order from 0 (``tron_rows``)."""
    return _in_order(x * v[:, None, :], -1)


def _col_products(x: Tensor, u: Tensor, init: Tensor) -> Tensor:
    """[E, d] = init + x [E, r, d]^T u [E, r], each coordinate's rows
    added in order to its init (``xt_col``)."""
    return _in_order(x * u[:, :, None], 1, init)


def _box(lower: Optional[Tensor], upper: Optional[Tensor], like: Tensor
         ) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """Both bounds in ``like``'s type (the missing one +-inf), or (None,
    None) without bounds."""
    if lower is None and upper is None:
        return None, None
    lo = (torch.full_like(like, -math.inf) if lower is None
          else lower.to(like.dtype))
    hi = (torch.full_like(like, math.inf) if upper is None
          else upper.to(like.dtype))
    return lo, hi


def _fold(x: Tensor, factors: Optional[Tensor], shifts: Optional[Tensor],
          dt: torch.dtype) -> Tensor:
    """x' = (x - shift) * factor in ``dt``, rounded to x's own type as the
    kernel's tile stores it; x in ``dt`` when there is no normalization."""
    if factors is None and shifts is None:
        return x.to(dt)
    xf = x.to(dt)
    if shifts is not None:
        xf = xf - shifts.to(dt)[:, None, :]
    if factors is not None:
        xf = xf * factors.to(dt)[:, None, :]
    return xf.to(x.dtype).to(dt)


def _check_compute_dtype(compute_dtype: torch.dtype) -> None:
    if compute_dtype not in (torch.float32, torch.float64):
        raise TypeError("compute_dtype must be torch.float32 or "
                        f"torch.float64, got {compute_dtype}")


_MODE_IDS = {"lbfgs": 0, "owlqn": 1, "tron": 2}
_PLAN_FIELDS = ("layout", "coord_lanes", "warps", "blocks_per_sm", "sms",
                "state_bytes", "smem_bytes")


@functools.lru_cache(maxsize=None)
def _load_kernel():
    """The kernel's C entry points with their ctypes signatures, set once:
    (plan, launch)."""
    from photon_ml_tpu_torch.ops import cuda_build

    lib = cuda_build.load("entity_lbfgs")
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    plan = lib.entity_lbfgs_plan
    plan.argtypes = [ci] * 6 + [vp]
    plan.restype = ci
    launch = lib.entity_lbfgs_launch
    launch.argtypes = [ci] + [vp] * 14 + [ci] * 3 + [cd] * 4 + [vp]
    launch.restype = ci
    return plan, launch


@functools.lru_cache(maxsize=None)
def _plan(device: int, r: int, d: int, m: int, f64: bool, mode: int,
          loss_id: int) -> Tuple[int, dict]:
    """The kernel's launch plan on CUDA device ``device``, made once: its
    handle and fields (``_PLAN_FIELDS`` and ``resident``, the entities
    the card holds at once)."""
    info = (ctypes.c_longlong * len(_PLAN_FIELDS))()
    with torch.cuda.device(device):
        handle = _load_kernel()[0](r, d, m, int(f64), mode, loss_id, info)
    if handle < 0:
        raise RuntimeError(f"entity_lbfgs plan: CUDA error {-handle}")
    fields = dict(zip(_PLAN_FIELDS, info))
    fields["resident"] = (fields["blocks_per_sm"] * fields["sms"]
                          * fields["warps"])
    return handle, fields


@functools.lru_cache(maxsize=None)
def _counter(device: int, stream: int) -> Tensor:
    """The persistent grid's entity counter for launches on CUDA device
    ``device`` and stream ``stream``: 2 int32 zeros, made once; every
    launch leaves them 0 again. Launches on one stream follow each
    other, so they share it; a launch on another stream (two mesh slots
    of one card driven from two streams) gets its own and cannot skip or
    repeat another launch's entities."""
    return torch.zeros((2,), dtype=torch.int32,
                       device=torch.device("cuda", device))


def kernel_plan(r: int, d: int, m: int = DEFAULT_M,
                compute_dtype: torch.dtype = torch.float64,
                mode: str = "lbfgs", loss_id: int = 0,
                device: Optional[int] = None) -> dict:
    """How the kernel solves entities of r rows and d coordinates on a
    CUDA device (the current one by default) in ``mode``, one warp per
    entity: ``layout`` (0 x tile and working set in shared memory, 1 x
    read from device memory, 2 x and working set in device memory),
    ``coord_lanes`` (the lanes over an entity's coordinates: the smallest
    power of two >= d, at least 4, in the shared layout, else 32),
    ``warps`` per block (1-4, the count that keeps the most entities
    resident), resident ``blocks_per_sm`` on
    ``sms`` SMs, ``resident`` entities on the card, ``state_bytes`` per
    entity and ``smem_bytes`` per block."""
    if device is None:
        device = torch.cuda.current_device()
    return dict(_plan(device, r, d, m, compute_dtype == torch.float64,
                      _MODE_IDS[mode], loss_id)[1])


def kernel_layout(r: int, d: int, m: int = DEFAULT_M,
                  compute_dtype: torch.dtype = torch.float64,
                  mode: str = "lbfgs") -> int:
    """Where the kernel keeps an entity of r rows and d coordinates on the
    current CUDA device in ``mode``: 0 x tile and working set in shared
    memory, 1 x read from device memory, 2 x and working set in device
    memory."""
    return kernel_plan(r, d, m, compute_dtype, mode)["layout"]


def variant(mode: str, normalized: bool, bounded: bool = False) -> str:
    """The name a launch is counted under in ``entity_lbfgs.variants``."""
    return (mode + ("+normalized" if normalized else "")
            + ("+bounded" if bounded else ""))


def entity_lbfgs(
    loss: PointwiseLoss, x: Tensor, labels: Tensor, offsets: Tensor,
    weights: Tensor, coef0: Tensor, l2_weight: float, l1_weight: float = 0.0,
    factors: Optional[Tensor] = None, shifts: Optional[Tensor] = None,
    lower: Optional[Tensor] = None, upper: Optional[Tensor] = None, *,
    max_iter: int = 100, tol: float = 1e-7, m: int = DEFAULT_M,
    c1: float = 1e-4, max_line_search: int = DEFAULT_MAX_LINE_SEARCH,
    mode: str = "lbfgs", compute_dtype: torch.dtype = torch.float64,
) -> OptimizerResult:
    """Batched per-entity GLM solve. ``x`` [E, r, d], ``labels``/
    ``offsets``/``weights`` [E, r], ``coef0`` and the optional
    ``factors``/``shifts`` and ``lower``/``upper`` [E, d]; ``mode``
    "lbfgs" (L2; ``l1_weight`` unused), "owlqn" (elastic net) or "tron"
    (L2, twice-differentiable losses; ``m``, ``c1`` and
    ``max_line_search`` unused). Returns an OptimizerResult with
    [E]-leading fields (no histories): the trials each entity priced in
    the L-BFGS modes, its TRON trips and CG steps in TRON.

    CPU tensors (float32 or float64) run ``entity_lbfgs_plain``. CUDA
    tensors launch the kernel (float32, contiguous, any r and d) and raise
    on anything it does not take. Each launch runs on the current stream
    of its device, with an entity counter of its own for that stream.
    Both compute in ``compute_dtype``.
    ``entity_lbfgs.launches`` counts kernel launches, and
    ``entity_lbfgs.variants`` counts them per ``variant(mode, normalized,
    bounded)``; a launch recorded into a CUDA graph counts per replay
    (``_count``). A graph capture needs ``prepare_launch`` first."""
    check_mode(mode, lower, upper, loss)
    normalized = factors is not None or shifts is not None
    bounded = lower is not None or upper is not None
    if x.dim() != 3:
        raise ValueError(f"x must be [E, r, d], got {tuple(x.shape)}")
    E, r, d = x.shape
    if normalized:
        # The kernel takes both or neither: the absent one is inert.
        if factors is None:
            factors = torch.ones_like(shifts)
        if shifts is None:
            shifts = torch.zeros_like(factors)
    if bounded:
        # Likewise for the bounds: the absent one is +-inf.
        if lower is None:
            lower = torch.full_like(upper, -math.inf)
        if upper is None:
            upper = torch.full_like(lower, math.inf)
    rows, coords = (E, r), (E, d)
    tensors = [("x", x, (E, r, d)), ("labels", labels, rows),
               ("offsets", offsets, rows), ("weights", weights, rows),
               ("coef0", coef0, coords)]
    if normalized:
        tensors += [("factors", factors, coords), ("shifts", shifts, coords)]
    if bounded:
        tensors += [("lower", lower, coords), ("upper", upper, coords)]
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"entity_lbfgs takes CPU or CUDA tensors, got {dev}")
    on_cuda = dev.type == "cuda"
    for name, t, shape in tensors:
        if t.shape != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError("entity_lbfgs takes tensors all on the CPU or "
                             "all on one CUDA device, got "
                             f"{sorted({str(u.device) for _, u, _ in tensors})}")
        if on_cuda and t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32, got {t.dtype}")
        if on_cuda and not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors")
    _check_compute_dtype(compute_dtype)
    if not on_cuda:
        if any(t.dtype not in (torch.float32, torch.float64)
               for _, t, _ in tensors):
            raise TypeError("entity_lbfgs takes float32 or float64 on the "
                            "CPU, got "
                            f"{[t.dtype for _, t, _ in tensors]}")
        return entity_lbfgs_plain(
            loss, x, labels, offsets, weights, coef0, l2_weight, l1_weight,
            factors, shifts, lower, upper, max_iter=max_iter, tol=tol, m=m,
            c1=c1, max_line_search=max_line_search, mode=mode,
            compute_dtype=compute_dtype)
    if min(m, max_iter) < 1 or max_line_search < 0:
        raise ValueError("m and max_iter must be >= 1, max_line_search >= 0")

    # Three outputs: c [E, d], f and |g| as the rows of one [2, E] and
    # iterations, reasons, trials (or trips) and CG steps as the rows of
    # one [4, E] (a row view costs a host about what an allocation does).
    out_c = torch.empty((E, d), dtype=torch.float32, device=dev)
    fout = torch.empty((2, E), dtype=torch.float32, device=dev)
    iout = torch.empty((4, E), dtype=torch.int32, device=dev)
    out_f, out_gnorm = fout.unbind(0)
    out_it, out_reason, out_steps, out_cg = iout.unbind(0)
    if mode == "tron":
        result = OptimizerResult(out_c, out_f, out_gnorm, out_it, out_reason,
                                 outer_steps=out_steps, cg_steps=out_cg)
    else:
        result = OptimizerResult(out_c, out_f, out_gnorm, out_it, out_reason,
                                 trials=out_steps)
    if E == 0:
        return result
    handle, plan = _plan(dev.index, r, d, m, compute_dtype == torch.float64,
                         _MODE_IDS[mode], loss.kernel_id)
    # Scratch for entities too tall for shared memory (none at the
    # slice's buckets).
    workspace = (torch.empty((E * plan["state_bytes"],), dtype=torch.uint8,
                             device=dev) if plan["layout"] == 2 else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def launch():
        stream = torch.cuda.current_stream().cuda_stream
        return _load_kernel()[1](
            handle, x.data_ptr(), labels.data_ptr(), offsets.data_ptr(),
            weights.data_ptr(), coef0.data_ptr(), ptr(factors), ptr(shifts),
            ptr(lower), ptr(upper), out_c.data_ptr(), fout.data_ptr(),
            iout.data_ptr(), _counter(dev.index, stream).data_ptr(),
            ptr(workspace), E, max_iter, max_line_search, float(l2_weight),
            float(l1_weight), float(tol), float(c1), stream)

    if dev.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(dev):
            err = launch()
    if err != 0:
        raise RuntimeError(f"entity_lbfgs kernel launch failed: CUDA error "
                           f"{err}")
    _count(variant(mode, normalized, bounded))
    return result


def _count(name: str) -> None:
    """One launch of the kernel in variant ``name``: counted now; or,
    recorded into a CUDA graph, counted by the graph's launch tally for
    every replay that runs it (utils/device_loop.py). A capture without
    a tally raises: its launches would go uncounted."""
    if torch.cuda.is_current_stream_capturing():
        tally = device_loop.active_tally()
        if tally is None:
            raise RuntimeError("entity_lbfgs recorded into a CUDA graph "
                               "with no launch tally active: its launches "
                               "would not be counted")
        tally.count(("entity_lbfgs", name))
        return
    entity_lbfgs.launches += 1
    entity_lbfgs.variants[name] += 1


def _settle(key, n: int) -> None:
    entity_lbfgs.launches += n
    entity_lbfgs.variants[key[1]] += n


def prepare_launch(device: torch.device, r: int, d: int, m: int = DEFAULT_M,
                   compute_dtype: torch.dtype = torch.float64,
                   mode: str = "lbfgs", loss_id: int = 0) -> None:
    """Make what a launch on entities of r rows and d coordinates on the
    CUDA ``device`` takes from the current stream, before a CUDA graph
    capture: the launch plan and that stream's entity counter."""
    _plan(device.index, r, d, m, compute_dtype == torch.float64,
          _MODE_IDS[mode], loss_id)
    with torch.cuda.device(device):
        _counter(device.index, torch.cuda.current_stream().cuda_stream)


def reset_launch_counts() -> None:
    """Set the total and every per-variant launch count to 0."""
    entity_lbfgs.launches = 0
    entity_lbfgs.variants.clear()


entity_lbfgs.launches = 0
entity_lbfgs.variants = collections.Counter()
device_loop.on_settle("entity_lbfgs", _settle)
