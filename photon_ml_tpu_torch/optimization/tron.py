"""TRON: trust-region Newton with truncated conjugate gradient (port of
photon_ml_tpu/optimization/tron.py: the LIBLINEAR constants :42-44,
_truncated_cg :47-109, _minimize_tron_impl :132-290, minimize_tron
:755-793; reference ml/optimization/TRON.scala:153-340).

An outer trust-region loop whose inner Steihaug-Toint CG does one
Hessian-vector product per step. The radius starts at ||g0||, is clamped
to the first step's length, and follows LIBLINEAR's rules; the solve
stops after more than 5 consecutive improvement failures. The JAX
``lax.while_loop``s become device loops (utils/device_loop.py), CG one
inside the outer iteration's: in a captured update graph nothing is read
back; run eagerly, the host reads one predicate a CG step and one an
outer iteration.

With box constraints (the projected variant, TRON.scala:228) x0 is
projected first; stationarity is the projected-gradient norm
||x - P(x - g)||, which also seeds the radius; coordinates pinned at a
bound with the gradient pushing outward (within 1e-12) are frozen, so CG
runs in the free subspace; the trial is P(x + s), and the predicted
reduction is the quadratic model on the realized step, with one more
Hessian-vector product.

``minimize_tron_streaming`` is the out-of-core variant (tron.py:293-522:
_stream_cg_step, _stream_tr_update and the host outer loop) over a
ShardedGLMObjective; ``minimize_tron_grid_streaming`` the batched λ-grid
variant (tron.py:524-754: _grid_cg_step, _grid_tr_update and the masked
host loop), with the streamed solvers' telemetry (:34-40, :450-455,
:648).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.optimization.convergence import (
    ConvergenceReason,
    OptimizerResult,
    check_solver_finite,
    code,
    history_buffer,
    history_write,
    padded_history,
)
from photon_ml_tpu_torch.optimization.lbfgs import _project
from photon_ml_tpu_torch.utils.device_loop import while_loop

Tensor = torch.Tensor

_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0
_CG_XI = 0.1  # inner CG stops at ||r|| <= xi ||g||

# The streamed solvers' per-outer-iteration telemetry, shared with the
# streaming L-BFGS (glm_lbfgs.py; the registry hands both the same
# objects).
_H_ITERATION = telemetry.histogram("training.iteration_seconds")
_M_ITERATIONS = telemetry.counter("training.solver_iterations")
_G_GRID_ACTIVE = telemetry.gauge("training.grid.active_points")


def _truncated_cg(hvp: Callable[[Tensor], Tensor], g: Tensor, delta: Tensor,
                  max_cg: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Steihaug-Toint truncated CG: approximately solve H s = -g with
    ||s|| <= delta. Returns (s, r, steps) with r the final residual
    -g - H s, used by the predicted reduction, and steps a 0-d device
    count. An inner device loop (utils/device_loop.py)."""
    stop_norm = _CG_XI * torch.linalg.norm(g)
    r = -g
    state = {"s": torch.zeros_like(g), "r": r, "d": r.clone(),
             "rtr": torch.dot(r, r),
             "k": torch.zeros((), dtype=torch.int32, device=g.device),
             "done": torch.linalg.norm(r) <= stop_norm}

    def cg_step(st):
        s, r, d, rtr, done = _stream_cg_step(st["s"], st["r"], st["d"],
                                             st["rtr"], hvp(st["d"]), delta,
                                             stop_norm)
        return {"s": s, "r": r, "d": d, "rtr": rtr, "k": st["k"] + 1,
                "done": done}

    st = while_loop(state, cg_step,
                    lambda st: ~st["done"] & (st["k"] < max_cg))
    return st["s"], st["r"], st["k"]


def minimize_tron(
    value_and_grad: Callable[..., Tuple[Tensor, Tensor]],
    x0: Tensor,
    args: Tuple[Any, ...] = (),
    *,
    max_iter: int = 15,
    tol: float = 1e-5,
    max_cg: int = 20,
    max_improvement_failures: int = 5,
    lower_bounds: Optional[Tensor] = None,
    upper_bounds: Optional[Tensor] = None,
    make_hvp: Optional[Callable] = None,
    track_coefficients: bool = False,
) -> OptimizerResult:
    """Minimize a twice-differentiable function from ``x0``.

    ``value_and_grad(x, *args)`` returns (value, gradient);
    ``make_hvp(x, *args)`` returns ``v -> H v`` at x and is called once
    per outer iteration (GLMObjective.make_tron_hvp). Defaults mirror the
    reference (maxIter=15, tol=1e-5, <=20 CG steps, <=5 improvement
    failures). ``iterations`` counts accepted steps; ``outer_steps`` and
    ``cg_steps`` count every outer iteration and CG step (0-d device
    counts). Either bound may be None (unbounded on that side). Only
    accepted iterates are recorded.
    ``track_coefficients`` writes each recorded iterate into
    ``coef_history``; the solve is the same either way. The outer
    iteration and CG are device loops (utils/device_loop.py); the outer
    one runs at most (max_improvement_failures + 1) x max_iter times."""
    from photon_ml_tpu_torch.optimization.glm_lbfgs import (
        first_reason,
        not_converged,
        select,
    )

    if make_hvp is None:
        raise TypeError("minimize_tron needs make_hvp: the port has no "
                        "automatic Hessian-vector product")
    dtype, device = x0.dtype, x0.device

    def scalar(v):
        return torch.full((), v, dtype=dtype, device=device)

    sigma1, sigma2, sigma3 = scalar(_SIGMA1), scalar(_SIGMA2), scalar(_SIGMA3)
    lo, hi = lower_bounds, upper_bounds
    bounded = lo is not None or hi is not None
    i32 = torch.int32

    def proj_grad_norm(x, g):
        # ||g|| unconstrained; the projected-gradient norm with bounds.
        if not bounded:
            return torch.linalg.norm(g)
        return torch.linalg.norm(x - _project(x - g, lo, hi))

    x = _project(x0, lo, hi)
    f, g = value_and_grad(x, *args)
    gnorm0 = proj_grad_norm(x, g)
    f0_scale = torch.clamp_min(torch.abs(f), 1e-30)

    def zero():
        return torch.zeros((), dtype=i32, device=device)

    state = {"x": x.clone(), "f": f.clone(), "g": g.clone(),
             "delta": gnorm0.clone(), "it": zero(), "fails": zero(),
             "outer": zero(), "cg": zero(),
             "first": torch.ones((), dtype=torch.bool, device=device),
             "reason": first_reason(gnorm0),
             "values": history_buffer(f, max_iter),
             "gnorms": history_buffer(gnorm0, max_iter)}
    if track_coefficients:
        state["coefs"] = history_buffer(x, max_iter)

    def trip(st):
        x, f, g, delta = st["x"], st["f"], st["g"], st["delta"]
        hvp = make_hvp(x, *args)
        if bounded:
            # Active-set reduction: CG runs in the free subspace.
            eps = 1e-12
            pinned = torch.zeros_like(x, dtype=torch.bool)
            if lo is not None:
                pinned = pinned | ((x <= lo + eps) & (g > 0))
            if hi is not None:
                pinned = pinned | ((x >= hi - eps) & (g < 0))
            free = (~pinned).to(dtype)
            s, r, k = _truncated_cg(lambda v: free * hvp(free * v), g * free,
                                    delta, max_cg)
        else:
            s, r, k = _truncated_cg(hvp, g, delta, max_cg)
        x_try = _project(x + s, lo, hi)
        s_real = x_try - x
        f_new, g_new = value_and_grad(x_try, *args)

        gs = torch.dot(g, s_real)
        if bounded:
            # The projection changed the step: the model on the realized
            # step, with one more Hessian-vector product.
            prered = -(gs + 0.5 * torch.dot(s_real, hvp(s_real)))
        else:
            prered = -0.5 * (gs - torch.dot(s_real, r))
        actred = f - f_new
        snorm = torch.linalg.norm(s_real)
        delta = torch.where(st["first"], torch.minimum(delta, snorm), delta)

        # LIBLINEAR step-size interpolation for the radius update.
        denom = f_new - f - gs
        alpha = torch.where(
            denom <= 0, sigma3,
            torch.maximum(sigma1, -0.5 * (gs / torch.clamp_min(denom,
                                                               1e-30))))
        alpha_s = alpha * snorm
        delta = torch.where(
            actred < _ETA0 * prered,
            torch.minimum(torch.maximum(alpha, sigma1) * snorm,
                          sigma2 * delta),
            torch.where(
                actred < _ETA1 * prered,
                torch.maximum(sigma1 * delta,
                              torch.minimum(alpha_s, sigma2 * delta)),
                torch.where(
                    actred < _ETA2 * prered,
                    torch.maximum(sigma1 * delta,
                                  torch.minimum(alpha_s, sigma3 * delta)),
                    torch.maximum(delta,
                                  torch.minimum(alpha_s, sigma3 * delta)))))

        accept = (actred > _ETA0 * prered) & torch.isfinite(f_new)
        it = st["it"] + accept.to(i32)
        fails = torch.where(accept, torch.zeros_like(st["fails"]),
                            st["fails"] + 1)
        f_delta = torch.abs(f - f_new)
        gnorm = proj_grad_norm(x_try, g_new)
        # Only accepted iterates are recorded: a rejected trip writes the
        # entry at the unchanged count back onto itself.
        for key, v in (("values", f_new), ("gnorms", gnorm),
                       ("coefs", x_try)):
            if key in st:
                history_write(st[key], it, torch.where(
                    accept, v, select(it, st[key])))
        nc = code(ConvergenceReason.NOT_CONVERGED, x)
        reason = torch.where(
            accept,
            torch.where(gnorm <= tol * gnorm0,
                        code(ConvergenceReason.GRADIENT_CONVERGED, x),
                        torch.where(f_delta <= tol * f0_scale,
                                    code(ConvergenceReason.
                                         FUNCTION_VALUES_CONVERGED, x),
                                    nc)),
            st["reason"])
        reason = torch.where(
            fails > max_improvement_failures,
            code(ConvergenceReason.OBJECTIVE_NOT_IMPROVING, x),
            torch.where((reason == nc) & (it >= max_iter),
                        code(ConvergenceReason.MAX_ITERATIONS, x), reason))
        return {"x": torch.where(accept, x_try, x),
                "f": torch.where(accept, f_new, f),
                "g": torch.where(accept, g_new, g), "delta": delta,
                "it": it, "fails": fails, "outer": st["outer"] + 1,
                "cg": st["cg"] + k,
                "first": torch.zeros_like(st["first"]), "reason": reason}

    st = while_loop(state, trip, not_converged)
    return OptimizerResult(
        x=st["x"], value=st["f"], grad_norm=torch.linalg.norm(st["g"]),
        iterations=st["it"], reason=st["reason"],
        value_history=st["values"], grad_norm_history=st["gnorms"],
        coef_history=st.get("coefs"),
        outer_steps=st["outer"], cg_steps=st["cg"])


def _host(v: Tensor):
    """0-d numpy scalar in the solve type (see glm_lbfgs._host)."""
    return v.detach().cpu().numpy()[()]


def _stream_cg_step(s, r, d_vec, rtr, hd, delta, stop_norm):
    """One Steihaug-Toint CG step given the Hessian product ``hd``: the
    body of `_truncated_cg`'s device loop, and of the streaming driver's
    host loop. A non-positive curvature direction marches to the
    boundary (tau >= 0 with ||s + tau d|| = delta)."""
    one = torch.ones((), dtype=s.dtype, device=s.device)
    dhd = torch.dot(d_vec, hd)
    alpha = rtr / torch.where(dhd > 0, dhd, one)
    s_try = s + alpha * d_vec
    crossed = (torch.linalg.norm(s_try) > delta) | (dhd <= 0)

    std = torch.dot(s, d_vec)
    dd = torch.dot(d_vec, d_vec)
    ss = torch.dot(s, s)
    gap = torch.clamp_min(delta * delta - ss, 0.0)
    rad = torch.sqrt(torch.clamp_min(std * std + dd * gap, 0.0))
    safe_dd = torch.clamp_min(dd, 1e-30)
    tau = torch.where(std >= 0, gap / torch.clamp_min(std + rad, 1e-30),
                      (rad - std) / safe_dd)

    step = torch.where(crossed, tau, alpha)
    s_new = s + step * d_vec
    r_new = r - step * hd
    rtr_new = torch.dot(r_new, r_new)
    beta = rtr_new / torch.clamp_min(rtr, 1e-30)
    d_new = r_new + beta * d_vec
    done = crossed | (torch.sqrt(rtr_new) <= stop_norm)
    return s_new, r_new, d_new, rtr_new, done


def _stream_tr_update(f, f_new, g, s, r, delta, first: bool):
    """Trust-region bookkeeping for one outer step: the LIBLINEAR radius
    interpolation of the unbounded in-core solver."""
    dtype, device = g.dtype, g.device

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    sigma1, sigma2, sigma3 = scalar(_SIGMA1), scalar(_SIGMA2), scalar(_SIGMA3)
    gs = torch.dot(g, s)
    prered = -0.5 * (gs - torch.dot(s, r))
    actred = f - f_new
    snorm = torch.linalg.norm(s)
    if first:
        delta = torch.minimum(delta, snorm)

    denom = f_new - f - gs
    alpha = torch.where(
        denom <= 0, sigma3,
        torch.maximum(sigma1, -0.5 * (gs / torch.clamp_min(denom, 1e-30))))
    alpha_s = alpha * snorm
    delta = torch.where(
        actred < _ETA0 * prered,
        torch.minimum(torch.maximum(alpha, sigma1) * snorm, sigma2 * delta),
        torch.where(
            actred < _ETA1 * prered,
            torch.maximum(sigma1 * delta,
                          torch.minimum(alpha_s, sigma2 * delta)),
            torch.where(
                actred < _ETA2 * prered,
                torch.maximum(sigma1 * delta,
                              torch.minimum(alpha_s, sigma3 * delta)),
                torch.maximum(delta,
                              torch.minimum(alpha_s, sigma3 * delta)))))
    accept = (actred > _ETA0 * prered) & torch.isfinite(f_new)
    return delta, accept


def minimize_tron_streaming(
    sharded_objective,
    x0: Tensor,
    l2_weight: float,
    *,
    max_iter: int = 15,
    tol: float = 1e-5,
    max_cg: int = 20,
    max_improvement_failures: int = 5,
    track_coefficients: bool = False,
    trace_ctx=None,
    convergence_ring=None,
    margins_out=None,
) -> OptimizerResult:
    """Out-of-core TRON: the outer trust-region loop runs on the host;
    each value/gradient evaluation and each inner-CG Hessian-vector
    product is a streaming pass over the shard cache (margins and
    curvature computed once per outer iteration, as
    ``GLMObjective.make_tron_hvp`` does; each CG product costs one matvec
    and one rmatvec per shard). No box constraints (the resident path
    has them). Accumulation order is the fixed shard order:
    deterministic and residency-independent. An outer iteration with k
    CG steps costs k + 2 feature passes.

    The loss and gradient norm of every ACCEPTED step are checked on the
    host (``SolverDivergedError`` when non-finite); a rejected trial with
    a non-finite value only shrinks the trust region, as in the in-core
    solver. ``trace_ctx`` and the ``solver_step`` span of each outer
    iteration (CG and trial included) are as in
    ``minimize_lbfgs_glm_streaming``. ``convergence_ring`` gets one
    entry per accepted step (step size ``||s||``, read in the same copy
    as the gradient norm the convergence test reads). ``margins_out`` (a
    caller-owned list) is replaced with the final per-shard margins."""
    sobj = sharded_objective
    x = x0
    dtype = x.dtype
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    l2 = float(l2_weight)

    tol_s = np_dtype.type(tol)
    z_list, f, g = sobj.margins_value_grad(x, l2)
    f_h = _host(f)
    gnorm = _host(torch.linalg.norm(g))
    check_solver_finite("streaming-tron", 0, f_h, gnorm, trace_ctx)
    if convergence_ring is not None:
        convergence_ring.append(0, f_h, gnorm, None)
    gnorm0 = gnorm
    f0_scale = np.maximum(np.abs(f_h), np_dtype.type(1e-30))
    delta = torch.linalg.norm(g)

    value_hist = np.full(max_iter + 1, np.nan, np_dtype)
    gnorm_hist = np.full(max_iter + 1, np.nan, np_dtype)
    value_hist[0], gnorm_hist[0] = f_h, gnorm
    coefs = [x] if track_coefficients else None

    reason = (ConvergenceReason.GRADIENT_CONVERGED if gnorm0 <= 0.0
              else ConvergenceReason.NOT_CONVERGED)
    it = fails = outer = cg_steps = 0
    first = True
    while reason == ConvergenceReason.NOT_CONVERGED:
        with telemetry.timed_span("solver_step", histogram=_H_ITERATION,
                                  counter=_M_ITERATIONS):
            if trace_ctx is not None:
                trace_ctx.event("solver_step")
            d2_list = sobj.curvature_list(z_list)

            # -- truncated CG (streamed Hv per step) --------------------------
            s = torch.zeros_like(g)
            r = -g
            d_vec = -g
            rtr = torch.dot(r, r)
            stop_norm = _CG_XI * torch.linalg.norm(g)
            cg_done = bool(torch.linalg.norm(r) <= stop_norm)
            k = 0
            while not cg_done and k < max_cg:
                hd = sobj.hessian_vector(d_vec, d2_list, l2)
                s, r, d_vec, rtr, done = _stream_cg_step(
                    s, r, d_vec, rtr, hd, delta, stop_norm)
                cg_done = bool(done)
                k += 1
            cg_steps += k
            outer += 1

            x_try = x + s
            z_try, f_new, g_new = sobj.margins_value_grad(x_try, l2)
            delta, accept_t = _stream_tr_update(f, f_new, g, s, r, delta,
                                                first)
            first = False

            if bool(accept_t):
                it += 1
                fails = 0
                x, z_list, g = x_try, z_try, g_new
                f_new_h = _host(f_new)
                f_delta = np.abs(f_h - f_new_h)
                f, f_h = f_new, f_new_h
                # The step's norm comes back in the gradient norm's copy.
                gnorm, snorm = torch.stack(
                    (torch.linalg.norm(g), torch.linalg.norm(s))).cpu().numpy()
                check_solver_finite("streaming-tron", it, f_h, gnorm,
                                    trace_ctx)
                value_hist[it], gnorm_hist[it] = f_h, gnorm
                if coefs is not None:
                    coefs.append(x)
                if convergence_ring is not None:
                    convergence_ring.append(it, f_h, gnorm, snorm)
                if gnorm <= tol_s * gnorm0:
                    reason = ConvergenceReason.GRADIENT_CONVERGED
                elif f_delta <= tol_s * f0_scale:
                    reason = ConvergenceReason.FUNCTION_VALUES_CONVERGED
                elif it >= max_iter:
                    reason = ConvergenceReason.MAX_ITERATIONS
            else:
                fails += 1
                if fails > max_improvement_failures:
                    reason = ConvergenceReason.OBJECTIVE_NOT_IMPROVING

    if margins_out is not None:
        margins_out[:] = z_list
    return OptimizerResult(
        x=x, value=f, grad_norm=torch.tensor(gnorm, dtype=dtype),
        iterations=torch.tensor(it, dtype=torch.int32),
        reason=torch.tensor(int(reason), dtype=torch.int32),
        value_history=torch.from_numpy(value_hist),
        grad_norm_history=torch.from_numpy(gnorm_hist),
        coef_history=(None if coefs is None
                      else padded_history(coefs, max_iter)),
        outer_steps=outer, cg_steps=cg_steps)


def _grid_cg_step(s, r, d_vec, rtr, hd, delta, stop_norm):
    """Per-row Steihaug-Toint CG step: `_stream_cg_step` on each lane
    (JAX vmaps it), stacked."""
    rows = [_stream_cg_step(s[i], r[i], d_vec[i], rtr[i], hd[i], delta[i],
                            stop_norm[i]) for i in range(s.shape[0])]
    return tuple(torch.stack(f) for f in zip(*rows))


def _grid_tr_update(f, f_new, g, s, r, delta, first: bool):
    """Per-row LIBLINEAR trust-region update (``first`` shared by all
    rows: the before-first-step clamp)."""
    rows = [_stream_tr_update(f[i], f_new[i], g[i], s[i], r[i], delta[i],
                              first) for i in range(g.shape[0])]
    return tuple(torch.stack(f) for f in zip(*rows))


def minimize_tron_grid_streaming(
    sharded_objective,
    x0s: Tensor,
    l2_weights,
    *,
    max_iter: int = 15,
    tol: float = 1e-5,
    max_cg: int = 20,
    max_improvement_failures: int = 5,
    track_coefficients: bool = False,
    trace_ctxs=None,
    convergence_rings=None,
    margins_out=None,
):
    """Batched λ-grid streaming TRON: one curvature pass, one shared CG
    (each Hessian-vector feature pass serves every grid row's iterate)
    and one trial pass advance all G trust-region solves per outer
    iteration. Coefficients ``[G, d]``, margins and curvature
    ``[G, rows]`` per shard, λ row ``[G]``; returns G
    :class:`OptimizerResult`, row-aligned.

    Per-row CG done-masks freeze a row's (s, r, d, rtr) at its own
    Steihaug-Toint stop, and the inner loop runs until every active row
    is done or ``max_cg``. Accept/reject, improvement-failure budgets
    and reasons are per row (host masks); finished rows keep their state
    bit for bit through row selects. G = 1 delegates to
    :func:`minimize_tron_streaming` (the bitwise gate). Only accepted
    states are watchdog-checked; a non-finite accepted row raises
    ``SolverDivergedError`` naming that row and its λ, tagged with
    ``trace_ctxs[row]`` (row-aligned, entries may be None; each active
    row gets its ``solver_step`` events); ``convergence_rings``
    (row-aligned, entries may be None) get one entry per accepted
    step."""
    from photon_ml_tpu_torch.optimization.glm_lbfgs import (
        _grid_select_rows,
    )

    sobj = sharded_objective
    x = x0s
    if x.dim() != 2:
        raise ValueError(
            f"x0s must be [G, d] (one coefficient row per grid point), "
            f"got shape {tuple(x.shape)}")
    G, d = x.shape
    dtype, device = x.dtype, x.device
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    l2s = torch.as_tensor(np.asarray(l2_weights, np_dtype), device=device)
    if l2s.shape != (G,):
        raise ValueError(
            f"l2_weights must be [G]={G} (one λ per grid row), got "
            f"shape {tuple(l2s.shape)}")
    ctxs = list(trace_ctxs) if trace_ctxs is not None else [None] * G
    rings = (list(convergence_rings) if convergence_rings is not None
             else [None] * G)
    if len(ctxs) != G or len(rings) != G:
        raise ValueError(
            f"trace_ctxs/convergence_rings must be row-aligned with the "
            f"grid (G={G}), got {len(ctxs)}/{len(rings)}")

    if G == 1:
        # Bitwise gate: the 1-row grid IS the scalar streamed solver.
        holder = [] if margins_out is not None else None
        res = minimize_tron_streaming(
            sobj, x[0], float(l2s[0]), max_iter=max_iter, tol=tol,
            max_cg=max_cg,
            max_improvement_failures=max_improvement_failures,
            track_coefficients=track_coefficients, trace_ctx=ctxs[0],
            convergence_ring=rings[0], margins_out=holder)
        if margins_out is not None:
            margins_out[:] = [z[None] for z in holder]
        return [res]

    tol_s = np_dtype.type(tol)
    l2_h = l2s.cpu().numpy()
    z_list, f, g = sobj.grid_margins_value_grad(x, l2s)
    f_h = f.cpu().numpy()
    gnorm = torch.linalg.norm(g, dim=-1).cpu().numpy()
    for gi in range(G):
        check_solver_finite("streaming-tron-grid", 0, f_h[gi], gnorm[gi],
                            ctxs[gi], lam=l2_h[gi], grid_row=gi)
        if rings[gi] is not None:
            rings[gi].append(0, f_h[gi], gnorm[gi], None)
    gnorm0 = gnorm.copy()
    f0_scale = np.maximum(np.abs(f_h), np_dtype.type(1e-30))
    delta = torch.as_tensor(gnorm0, device=device)

    value_hist = np.full((G, max_iter + 1), np.nan, np_dtype)
    gnorm_hist = np.full((G, max_iter + 1), np.nan, np_dtype)
    value_hist[:, 0], gnorm_hist[:, 0] = f_h, gnorm
    coef_hist = (np.full((G, max_iter + 1, d), np.nan, np_dtype)
                 if track_coefficients else None)
    if coef_hist is not None:
        coef_hist[:, 0] = x.cpu().numpy()

    reasons = [ConvergenceReason.GRADIENT_CONVERGED if gnorm0[gi] <= 0.0
               else ConvergenceReason.NOT_CONVERGED for gi in range(G)]
    active = np.array([r == ConvergenceReason.NOT_CONVERGED
                       for r in reasons])
    its = np.zeros(G, np.int64)
    fails = np.zeros(G, np.int64)
    first = True
    outer = cg_steps = 0

    while active.any():
        with telemetry.timed_span("solver_step", histogram=_H_ITERATION,
                                  counter=_M_ITERATIONS):
            _G_GRID_ACTIVE.set(int(active.sum()))
            for gi in np.flatnonzero(active):
                if ctxs[gi] is not None:
                    ctxs[gi].event("solver_step")
            d2_list = sobj.grid_curvature_list(z_list)

            # -- per-row truncated CG: one shared Hvp feature pass per
            # step; rows past their own stop are frozen by row masks.
            s = torch.zeros_like(g)
            r = -g
            d_vec = -g
            rtr = torch.sum(r * r, dim=-1)
            stop_norm = _CG_XI * torch.linalg.norm(g, dim=-1)
            cg_done = ((torch.linalg.norm(r, dim=-1) <= stop_norm)
                       .cpu().numpy() | ~active)
            k = 0
            while not cg_done.all() and k < max_cg:
                hd = sobj.grid_hessian_vector(d_vec, d2_list, l2s)
                s2, r2, d2v, rtr2, done_dev = _grid_cg_step(
                    s, r, d_vec, rtr, hd, delta, stop_norm)
                run = torch.as_tensor(~cg_done, device=device)
                s = _grid_select_rows(run, s2, s)
                r = _grid_select_rows(run, r2, r)
                d_vec = _grid_select_rows(run, d2v, d_vec)
                rtr = torch.where(run, rtr2, rtr)
                cg_done |= (~cg_done) & done_dev.cpu().numpy()
                k += 1
            cg_steps += k
            outer += 1

            active_dev = torch.as_tensor(active, device=device)
            x_try = _grid_select_rows(active_dev, x + s, x)
            z_try, f_new, g_new = sobj.grid_margins_value_grad(x_try, l2s)
            delta_new, accept_dev = _grid_tr_update(
                torch.as_tensor(f_h, device=device), f_new, g, s, r, delta,
                first)
            first = False
            delta = torch.where(active_dev, delta_new, delta)
            accept = accept_dev.cpu().numpy() & active

            if accept.any():
                acc_dev = torch.as_tensor(accept, device=device)
                x = _grid_select_rows(acc_dev, x_try, x)
                g = _grid_select_rows(acc_dev, g_new, g)
                # Each shard's margins live on its own mesh slot's device.
                z_list = [torch.where(acc_dev.to(z.device)[:, None], zt, z)
                          for zt, z in zip(z_try, z_list)]
                f_new_h = f_new.cpu().numpy()
                gnorm_new, snorm = torch.stack(
                    (torch.linalg.norm(g, dim=-1),
                     torch.linalg.norm(s, dim=-1))).cpu().numpy()
                f_delta = np.abs(f_h - f_new_h)
                f_h = np.where(accept, f_new_h, f_h)
                gnorm = np.where(accept, gnorm_new, gnorm)
                its[accept] += 1
                fails[accept] = 0
                for gi in np.flatnonzero(accept):
                    # Watchdog on accepted rows only: a rejected non-finite
                    # trial is normal trust-region behaviour.
                    check_solver_finite("streaming-tron-grid", int(its[gi]),
                                        f_h[gi], gnorm[gi], ctxs[gi],
                                        lam=l2_h[gi], grid_row=gi)
                    value_hist[gi, its[gi]] = f_h[gi]
                    gnorm_hist[gi, its[gi]] = gnorm[gi]
                    if coef_hist is not None:
                        coef_hist[gi, its[gi]] = x[gi].cpu().numpy()
                    if rings[gi] is not None:
                        rings[gi].append(int(its[gi]), f_h[gi], gnorm[gi],
                                         float(snorm[gi]))
                    if gnorm[gi] <= tol_s * gnorm0[gi]:
                        reasons[gi] = ConvergenceReason.GRADIENT_CONVERGED
                    elif f_delta[gi] <= tol_s * f0_scale[gi]:
                        reasons[gi] = (
                            ConvergenceReason.FUNCTION_VALUES_CONVERGED)
                    elif its[gi] >= max_iter:
                        reasons[gi] = ConvergenceReason.MAX_ITERATIONS
                    if reasons[gi] != ConvergenceReason.NOT_CONVERGED:
                        active[gi] = False

            rejected = active & ~accept
            fails[rejected] += 1
            for gi in np.flatnonzero(rejected):
                if fails[gi] > max_improvement_failures:
                    reasons[gi] = ConvergenceReason.OBJECTIVE_NOT_IMPROVING
                    active[gi] = False

    if margins_out is not None:
        margins_out[:] = z_list
    return [
        OptimizerResult(
            x=x[gi], value=torch.tensor(f_h[gi], dtype=dtype),
            grad_norm=torch.tensor(gnorm[gi], dtype=dtype),
            iterations=torch.tensor(int(its[gi]), dtype=torch.int32),
            reason=torch.tensor(int(reasons[gi]), dtype=torch.int32),
            value_history=torch.from_numpy(value_hist[gi].copy()),
            grad_norm_history=torch.from_numpy(gnorm_hist[gi].copy()),
            coef_history=(None if coef_hist is None
                          else torch.from_numpy(coef_hist[gi].copy())),
            outer_steps=outer, cg_steps=cg_steps)
        for gi in range(G)
    ]
