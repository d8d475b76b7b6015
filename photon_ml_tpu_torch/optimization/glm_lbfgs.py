"""GLM L-BFGS with a margin-cached line search (port of
photon_ml_tpu/optimization/glm_lbfgs.py: _minimize_lbfgs_glm_impl :83,
minimize_lbfgs_glm :810, the out-of-core
minimize_lbfgs_glm_streaming :241-500 over a ShardedGLMObjective, and
the batched λ grid minimize_lbfgs_glm_grid_streaming :502-809 with its
helpers _grid_direction ... _grid_update_history; the streamed solvers'
telemetry :55-62, :404-409, :690).

Margins are affine in the coefficients, so along a direction p

    margins(x + t p) = z + t zp
    value(x + t p)   = sum_i w_i l(z_i + t zp_i, y_i)
                       + l2/2 (||x||^2 + 2 t x.p + t^2 ||p||^2)

and every Armijo trial is elementwise work with no feature contraction.
Each iteration does one matvec (zp) and one rmatvec (the gradient at the
accepted point).

The JAX ``lax.while_loop`` becomes a device loop (utils/device_loop.py):
one WHILE node of a CUDA graph when the solve is captured, a host loop
that reads the stop reason once an iteration when it runs eagerly. All
``max_line_search + 1`` candidates t_k = t0 * 0.5^k are priced in one
``[T, n]`` pass and the first passing one is taken (no inner loop); the
JAX solver prices 8 and runs the rest only when none pass, which accepts
the same step. The streamed solvers below stay host loops (ROADMAP A7).
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.ops.glm_objective import GLMBatch, GLMObjective
from photon_ml_tpu_torch.optimization.convergence import (
    ConvergenceReason,
    OptimizerResult,
    check_solver_finite,
    code,
    history_buffer,
    history_write,
    padded_history,
)
from photon_ml_tpu_torch.optimization.lbfgs import (
    LBFGSHistory,
    compact_direction,
    empty_history,
    select_history,
    update_history,
)
from photon_ml_tpu_torch.utils.device_loop import while_loop

Tensor = torch.Tensor

_NC = int(ConvergenceReason.NOT_CONVERGED)

# Per-outer-iteration telemetry of the streamed solvers, shared with
# tron.py (no-ops while telemetry is off): one streamed iteration's
# wall time, read at the host sync the iteration already ends with.
_H_ITERATION = telemetry.histogram("training.iteration_seconds")
_M_ITERATIONS = telemetry.counter("training.solver_iterations")
# Grid points still iterating in a batched λ sweep.
_G_GRID_ACTIVE = telemetry.gauge("training.grid.active_points")


def _reason(ok, gnorm_new, gnorm0, f_delta, f0_scale, it_new: Tensor,
            max_iter: int, tol: float) -> Tensor:
    """Stop reason after one iteration, checked in the JAX order
    (``it_new`` a 0-d device count)."""
    tail = torch.where(it_new >= max_iter,
                       code(ConvergenceReason.MAX_ITERATIONS, ok),
                       code(ConvergenceReason.NOT_CONVERGED, ok))
    return torch.where(
        ~ok, code(ConvergenceReason.OBJECTIVE_NOT_IMPROVING, ok),
        torch.where(gnorm_new <= tol * gnorm0,
                    code(ConvergenceReason.GRADIENT_CONVERGED, ok),
                    torch.where(f_delta <= tol * f0_scale,
                                code(ConvergenceReason.
                                     FUNCTION_VALUES_CONVERGED, ok),
                                tail)))


def first_reason(gnorm0: Tensor) -> Tensor:
    """GRADIENT_CONVERGED when the start is stationary, else
    NOT_CONVERGED: the solvers' stop reason before their first
    iteration, on the device."""
    return torch.where(gnorm0 <= 0.0,
                       code(ConvergenceReason.GRADIENT_CONVERGED, gnorm0),
                       code(ConvergenceReason.NOT_CONVERGED, gnorm0))


def not_converged(state) -> Tensor:
    """The solvers' loop predicate: no stop reason yet."""
    return state["reason"] == _NC


def select(i: Tensor, v: Tensor) -> Tensor:
    """``v[i]`` for a 0-d device index, without reading it on the host."""
    return torch.index_select(v, 0, i.reshape(1))[0]


def history_state(hist: LBFGSHistory) -> dict:
    return {"hs": hist.s, "hy": hist.y, "hrho": hist.rho,
            "hcount": hist.count}


def state_history(state) -> LBFGSHistory:
    return LBFGSHistory(state["hs"], state["hy"], state["hrho"],
                        state["hcount"])


def minimize_lbfgs_glm(
    objective: GLMObjective,
    batch: GLMBatch,
    x0: Tensor,
    l2_weight: float,
    *,
    max_iter: int = 100,
    tol: float = 1e-7,
    history_size: int = 10,
    c1: float = 1e-4,
    max_line_search: int = 30,
    track_coefficients: bool = False,
) -> OptimizerResult:
    """Unconstrained L2 GLM solve; defaults mirror the reference
    (maxIter=100, tol=1e-7, m=10, ml/optimization/LBFGS.scala:152-156).
    ``track_coefficients`` writes each recorded iterate into
    ``coef_history``; the solve is the same either way. One device loop
    (utils/device_loop.py): captured into a CUDA graph it reads nothing
    back; run eagerly it reads the stop reason once an iteration."""
    dtype, device = x0.dtype, x0.device
    x = x0
    z = objective.margins(x, batch)
    f = objective.value_from_margins(z, torch.dot(x, x), batch, l2_weight)
    g = objective.gradient_from_margins(x, z, batch, l2_weight)
    gnorm0 = torch.linalg.norm(g)
    f0_scale = torch.clamp_min(torch.abs(f), 1e-30)
    hist = empty_history(x.shape[-1], history_size, dtype, device)
    state = {"x": x.clone(), "z": z, "f": f, "g": g,
             **history_state(hist),
             "it": torch.zeros((), dtype=torch.int32, device=device),
             "reason": first_reason(gnorm0),
             "values": history_buffer(f, max_iter),
             "gnorms": history_buffer(gnorm0, max_iter)}
    if track_coefficients:
        state["coefs"] = history_buffer(x, max_iter)
    powers = torch.pow(
        torch.full((), 0.5, dtype=dtype, device=device),
        torch.arange(max_line_search + 1, dtype=dtype, device=device))
    labels, weights = batch.labels[None, :], batch.weights[None, :]

    def step(s):
        x, z, f, g = s["x"], s["z"], s["f"], s["g"]
        hist = state_history(s)
        direction = compact_direction(g, hist)
        direction = torch.where(torch.dot(direction, g) >= 0, -g, direction)
        zp = objective.margin_direction(direction, batch)
        xx, xp = torch.dot(x, x), torch.dot(x, direction)
        pp, gp = torch.dot(direction, direction), torch.dot(g, direction)
        init_step = torch.where(
            hist.count == 0, 1.0 / torch.clamp_min(torch.sqrt(pp), 1.0),
            torch.ones((), dtype=dtype, device=device))
        ts = init_step * powers  # [T]

        z_trials = z[None, :] + ts[:, None] * zp[None, :]
        f_trials = (torch.sum(weights * objective.loss.loss(z_trials, labels),
                              dim=-1)
                    + 0.5 * l2_weight * (xx + 2.0 * ts * xp + ts * ts * pp))
        armijo = (f_trials <= f + c1 * ts * gp) & torch.isfinite(f_trials)
        ok = torch.any(armijo)
        idx = torch.argmax(armijo.to(torch.int32))  # first passing trial
        t_acc, f_new = select(idx, ts), select(idx, f_trials)

        x_new = x + t_acc * direction
        z_new = z + t_acc * zp
        g_new = objective.gradient_from_margins(x_new, z_new, batch,
                                                l2_weight)
        hist_new = update_history(hist, x_new - x, g_new - g)
        it = s["it"] + 1
        gnorm_new = torch.linalg.norm(g_new)
        reason = _reason(ok, gnorm_new, gnorm0, torch.abs(f - f_new),
                         f0_scale, it, max_iter, tol)

        # A failed line search does not move the iterate.
        x = torch.where(ok, x_new, x)
        f = torch.where(ok, f_new, f)
        gnorm_new = torch.where(ok, gnorm_new, torch.linalg.norm(g))
        history_write(s["values"], it, f)
        history_write(s["gnorms"], it, gnorm_new)
        if track_coefficients:
            history_write(s["coefs"], it, x)
        return {"x": x, "z": torch.where(ok, z_new, z), "f": f,
                "g": torch.where(ok, g_new, g),
                **history_state(select_history(ok, hist_new, hist)),
                "it": it, "reason": reason}

    s = while_loop(state, step, not_converged)
    return OptimizerResult(
        x=s["x"], value=s["f"], grad_norm=torch.linalg.norm(s["g"]),
        iterations=s["it"], reason=s["reason"],
        value_history=s["values"], grad_norm_history=s["gnorms"],
        coef_history=s.get("coefs"))


def _host(v: Tensor):
    """0-d numpy scalar in the solve type: host-side convergence
    arithmetic stays in the solver's precision (a Python-float compare
    would widen float32 to float64 and could flip a boundary
    decision)."""
    return v.detach().cpu().numpy()[()]


def _stream_direction(g: Tensor, hist, x: Tensor):
    """Search direction + the line-search dot products ([d]-space only),
    as the in-core solver forms them."""
    direction = compact_direction(g, hist)
    direction = torch.where(torch.dot(direction, g) >= 0, -g, direction)
    return (direction, torch.dot(x, x), torch.dot(x, direction),
            torch.dot(direction, direction), torch.dot(g, direction))


def minimize_lbfgs_glm_streaming(
    sharded_objective,
    x0: Tensor,
    l2_weight: float,
    *,
    max_iter: int = 100,
    tol: float = 1e-7,
    history_size: int = 10,
    c1: float = 1e-4,
    max_line_search: int = 30,
    track_coefficients: bool = False,
    trace_ctx=None,
    convergence_ring=None,
    margins_out=None,
) -> OptimizerResult:
    """Out-of-core L-BFGS: the outer iteration runs on the host,
    streaming each feature pass through a ShardedGLMObjective
    (ops/sharded_objective.py) whose shard cache replays device-resident
    blocks, spilling and re-uploading under a device-memory budget.

    Semantics follow the JAX solver step for step — margins cached per
    shard (row-space, always resident), ONE matvec pass for the whole
    line search, one rmatvec pass for the accepted gradient, the same
    convergence reasons — so each iteration costs exactly 2 feature
    passes. The first 8 candidate steps are priced in one row-space pass
    and the rest, rarely needed, one at a time, as in JAX. The
    accumulation order is the fixed shard order, so results are
    deterministic and independent of cache residency. The Armijo sweep
    and the margin update touch no feature block: no re-upload, no
    re-decode.

    Every outer iteration checks the host loss and gradient norm and
    raises ``SolverDivergedError`` when either went non-finite.
    ``trace_ctx`` (one telemetry ``TraceContext`` per solve, or None)
    gets a ``solver_step`` event per outer iteration, and its id rides on
    the divergence fault; each outer iteration is a ``solver_step`` span
    feeding ``training.iteration_seconds`` and
    ``training.solver_iterations``. ``convergence_ring`` (a
    ``ConvergenceRing``, the ``--distmon`` hook) gets one entry per
    outer iteration, from host values the convergence tests already
    read (the candidate steps come back in the same copy as the trial
    values), so it adds no device synchronization. ``margins_out`` (a
    caller-owned list) is replaced with the final per-shard margins."""
    sobj = sharded_objective
    x = x0
    dtype, device = x.dtype, x.device
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    l2 = float(l2_weight)
    d = x.shape[-1]
    n_batched = min(max_line_search + 1, 8)
    powers = torch.pow(torch.tensor(0.5, dtype=dtype, device=device),
                       torch.arange(n_batched, dtype=dtype, device=device))
    shrink = torch.tensor(0.5, dtype=dtype, device=device)

    tol_s = np_dtype.type(tol)
    z_list, f, g = sobj.margins_value_grad(x, l2)
    f_h = _host(f)
    gnorm = _host(torch.linalg.norm(g))
    check_solver_finite("streaming-lbfgs", 0, f_h, gnorm, trace_ctx)
    if convergence_ring is not None:
        convergence_ring.append(0, f_h, gnorm, None)
    gnorm0 = gnorm
    f0_scale = np.maximum(np.abs(f_h), np_dtype.type(1e-30))
    hist = empty_history(d, history_size, dtype, device)

    value_hist = np.full(max_iter + 1, np.nan, np_dtype)
    gnorm_hist = np.full(max_iter + 1, np.nan, np_dtype)
    value_hist[0], gnorm_hist[0] = f_h, gnorm
    coefs = [x] if track_coefficients else None

    reason = (ConvergenceReason.GRADIENT_CONVERGED if gnorm0 <= 0.0
              else ConvergenceReason.NOT_CONVERGED)
    it = 0
    while reason == ConvergenceReason.NOT_CONVERGED:
        with telemetry.timed_span("solver_step", histogram=_H_ITERATION,
                                  counter=_M_ITERATIONS):
            if trace_ctx is not None:
                trace_ctx.event("solver_step")
            direction, xx, xp, pp, gp = _stream_direction(g, hist, x)
            zp_list = sobj.margin_direction_list(direction)

            init_step = torch.where(
                hist.count == 0, 1.0 / torch.clamp_min(torch.sqrt(pp), 1.0),
                torch.ones((), dtype=dtype, device=device))
            ts = init_step * powers
            thresholds = f + c1 * ts * gp
            f_trials = sobj.trial_values(
                z_list, zp_list, ts, xx + 2.0 * ts * xp + ts * ts * pp, l2)
            # One copy brings the trial values, their thresholds and the
            # candidate steps to the host.
            ft_host, thr_host, ts_host = torch.stack(
                (f_trials, thresholds, ts)).cpu().numpy()
            armijo = np.logical_and(ft_host <= thr_host,
                                    np.isfinite(ft_host))
            ok = bool(armijo.any())
            idx = int(np.argmax(armijo))  # first True
            t_acc, f_new = ts[idx], f_trials[idx]
            t_acc_h = ts_host[idx]

            k = n_batched
            t_tail = ts[-1]
            t_tail_h = ts_host[-1]
            while not ok and k < max_line_search + 1:
                # Sequential tail past the batched block: rare (0.5^8).
                # Halving is exact, so the host step tracks the device's.
                t_tail = t_tail * shrink
                t_tail_h = t_tail_h * np_dtype.type(0.5)
                t1 = t_tail[None]
                f_t = sobj.trial_values(z_list, zp_list, t1,
                                        xx + 2.0 * t1 * xp + t1 * t1 * pp,
                                        l2)[0]
                f_t_h = _host(f_t)
                if f_t_h <= _host(f + c1 * t_tail * gp) and np.isfinite(f_t_h):
                    ok, t_acc, f_new = True, t_tail, f_t
                    t_acc_h = t_tail_h
                    break
                k += 1

            it += 1  # the in-core solver counts failed-line-search steps too
            if not ok:
                reason = ConvergenceReason.OBJECTIVE_NOT_IMPROVING
                if it <= max_iter:
                    value_hist[it], gnorm_hist[it] = f_h, gnorm
                    if coefs is not None:
                        coefs.append(x)
                if convergence_ring is not None:
                    # Failed line search: the iterate did not move.
                    convergence_ring.append(it, f_h, gnorm, 0.0)
                break

            x_new = x + t_acc * direction
            z_new = sobj.update_margins(z_list, t_acc, zp_list)
            g_new = sobj.grad_from_margins_list(x_new, z_new, l2)
            hist = update_history(hist, x_new - x, g_new - g)

            gnorm_new = _host(torch.linalg.norm(g_new))
            f_new_h = _host(f_new)
            check_solver_finite("streaming-lbfgs", it, f_new_h, gnorm_new,
                                trace_ctx)
            f_delta = np.abs(f_h - f_new_h)
            x, z_list, f, g = x_new, z_new, f_new, g_new
            f_h, gnorm = f_new_h, gnorm_new
            value_hist[it], gnorm_hist[it] = f_h, gnorm
            if coefs is not None:
                coefs.append(x)
            if convergence_ring is not None:
                convergence_ring.append(it, f_h, gnorm, t_acc_h)

            if gnorm_new <= tol_s * gnorm0:
                reason = ConvergenceReason.GRADIENT_CONVERGED
            elif f_delta <= tol_s * f0_scale:
                reason = ConvergenceReason.FUNCTION_VALUES_CONVERGED
            elif it >= max_iter:
                reason = ConvergenceReason.MAX_ITERATIONS

    if margins_out is not None:
        margins_out[:] = z_list
    return OptimizerResult(
        x=x, value=f,
        grad_norm=torch.tensor(gnorm, dtype=dtype),
        iterations=torch.tensor(it, dtype=torch.int32),
        reason=torch.tensor(int(reason), dtype=torch.int32),
        value_history=torch.from_numpy(value_hist),
        grad_norm_history=torch.from_numpy(gnorm_hist),
        coef_history=(None if coefs is None
                      else padded_history(coefs, max_iter)))


# -- the batched λ grid --------------------------------------------------
#
# JAX vmaps the scalar bodies over the grid axis; the port applies them
# lane by lane and stacks, so each lane's [d]-space arithmetic is the
# scalar solver's, bit for bit.


def _hist_row(hist: LBFGSHistory, i: int) -> LBFGSHistory:
    return LBFGSHistory(*(f[i] for f in hist))


def _stack_hists(rows) -> LBFGSHistory:
    return LBFGSHistory(*(torch.stack(f) for f in zip(*rows)))


def _grid_direction(g: Tensor, hist: LBFGSHistory, x: Tensor):
    """Per-row search directions and line-search dot products."""
    rows = [_stream_direction(g[i], _hist_row(hist, i), x[i])
            for i in range(g.shape[0])]
    return tuple(torch.stack(f) for f in zip(*rows))


def _grid_candidates(first: Tensor, pp: Tensor, f: Tensor, gp: Tensor,
                     powers: Tensor, c1: float):
    """[G, K] Armijo candidates and thresholds, per grid row."""
    one = torch.ones((), dtype=pp.dtype, device=pp.device)
    init_step = torch.where(first, 1.0 / torch.clamp_min(torch.sqrt(pp),
                                                         1.0), one)
    ts = init_step[:, None] * powers[None, :]
    return ts, f[:, None] + c1 * ts * gp[:, None]


def _grid_coef_sq(xx, xp, pp, ts):
    return xx[:, None] + 2.0 * ts * xp[:, None] + ts * ts * pp[:, None]


def _grid_axpy_masked(a: Tensor, t: Tensor, b: Tensor) -> Tensor:
    """Per-row a + t*b; rows with t == 0 stay bit for bit (masked, not
    added)."""
    return torch.where((t != 0.0)[:, None], a + t[:, None] * b, a)


def _grid_select_rows(mask: Tensor, a, b):
    """Row select: rows where ``mask`` take ``a``, else ``b`` (a tensor
    or an LBFGSHistory)."""
    if isinstance(a, LBFGSHistory):
        return LBFGSHistory(*(_grid_select_rows(mask, x, y)
                              for x, y in zip(a, b)))
    m = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
    return torch.where(m, a, b)


def _grid_update_history(hist: LBFGSHistory, x_new, x, g_new, g,
                         moved: Tensor) -> LBFGSHistory:
    """Cautious history update per row, applied only to rows that moved
    (a failed line search leaves its row's history alone)."""
    new = _stack_hists([update_history(_hist_row(hist, i),
                                       x_new[i] - x[i], g_new[i] - g[i])
                        for i in range(x.shape[0])])
    return _grid_select_rows(moved, new, hist)


def minimize_lbfgs_glm_grid_streaming(
    sharded_objective,
    x0s: Tensor,
    l2_weights,
    *,
    max_iter: int = 100,
    tol: float = 1e-7,
    history_size: int = 10,
    c1: float = 1e-4,
    max_line_search: int = 30,
    track_coefficients: bool = False,
    trace_ctxs=None,
    convergence_rings=None,
    margins_out=None,
):
    """Batched λ-grid streaming L-BFGS: one set of feature passes per
    outer iteration advances all G grid points (coefficients ``[G, d]``,
    per-shard margins ``[G, rows]``, λ row ``l2_weights`` ``[G]``).
    Returns G :class:`OptimizerResult`, row-aligned with the inputs.

    Row state lives on the host as numpy masks: a converged or failed row
    is frozen by forcing its accepted step to 0 and selecting its
    previous state by row masks. Each outer iteration costs 2 feature
    passes whatever G, and the loop ends when every row is done, so a
    sweep costs the slowest row's passes. G = 1 delegates to
    :func:`minimize_lbfgs_glm_streaming` outright (the bitwise gate).
    For G > 1 each row follows the scalar iteration's semantics (same
    candidates, same convergence order and thresholds in the same type).
    A non-finite loss or gradient norm in one row raises
    ``SolverDivergedError`` naming that row and its λ.

    ``trace_ctxs`` (row-aligned, entries may be None) gets each active
    row's ``solver_step`` events and tags its divergence fault; each
    outer iteration is one ``solver_step`` span, and the gauge
    ``training.grid.active_points`` counts the rows still iterating.
    ``convergence_rings`` (row-aligned, entries may be None) get one
    entry per outer iteration a row takes part in, from host values.
    ``margins_out`` receives the final per-shard ``[G, rows]`` margins
    (``ShardedGLMObjective.grid_row_margins`` slices one row out)."""
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
        res = minimize_lbfgs_glm_streaming(
            sobj, x[0], float(l2s[0]), max_iter=max_iter, tol=tol,
            history_size=history_size, c1=c1,
            max_line_search=max_line_search,
            track_coefficients=track_coefficients, trace_ctx=ctxs[0],
            convergence_ring=rings[0], margins_out=holder)
        if margins_out is not None:
            margins_out[:] = [z[None] for z in holder]
        return [res]

    tol_s = np_dtype.type(tol)
    c1_np = np_dtype.type(c1)
    l2_h = l2s.cpu().numpy()
    n_batched = min(max_line_search + 1, 8)
    powers = torch.pow(torch.tensor(0.5, dtype=dtype, device=device),
                       torch.arange(n_batched, dtype=dtype, device=device))

    z_list, f, g = sobj.grid_margins_value_grad(x, l2s)
    f_h = f.cpu().numpy()
    gnorm = torch.linalg.norm(g, dim=-1).cpu().numpy()
    for gi in range(G):
        check_solver_finite("streaming-lbfgs-grid", 0, f_h[gi], gnorm[gi],
                            ctxs[gi], lam=l2_h[gi], grid_row=gi)
        if rings[gi] is not None:
            rings[gi].append(0, f_h[gi], gnorm[gi], None)
    gnorm0 = gnorm.copy()
    f0_scale = np.maximum(np.abs(f_h), np_dtype.type(1e-30))
    hist = _stack_hists([empty_history(d, history_size, dtype, device)] * G)

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
    rows = np.arange(G)

    while active.any():
        with telemetry.timed_span("solver_step", histogram=_H_ITERATION,
                                  counter=_M_ITERATIONS):
            _G_GRID_ACTIVE.set(int(active.sum()))
            for gi in np.flatnonzero(active):
                if ctxs[gi] is not None:
                    ctxs[gi].event("solver_step")
            dirs, xx, xp, pp, gp = _grid_direction(g, hist, x)
            zp_list = sobj.grid_margin_direction_list(dirs)

            first = hist.count == 0
            ts, thresholds = _grid_candidates(
                first, pp, torch.as_tensor(f_h, device=device), gp, powers, c1)
            f_trials = sobj.grid_trial_values(
                z_list, zp_list, ts, _grid_coef_sq(xx, xp, pp, ts), l2s)
            ft = f_trials.cpu().numpy()
            armijo = np.logical_and(ft <= thresholds.cpu().numpy(),
                                    np.isfinite(ft))
            ok = armijo.any(axis=1)
            idx = np.argmax(armijo, axis=1)
            ts_h = ts.cpu().numpy()
            t_np = np.where(ok & active, ts_h[rows, idx], np_dtype.type(0.0))
            f_new_h = np.where(ok, ft[rows, idx], f_h)

            searching = active & ~ok
            k = n_batched
            t_tail = ts_h[:, -1].copy()
            gp_h = gp.cpu().numpy()
            while searching.any() and k < max_line_search + 1:
                # Sequential tail past the batched block: rare (0.5^8).
                t_tail = t_tail * np_dtype.type(0.5)
                tsd = torch.as_tensor(
                    np.where(searching, t_tail, np_dtype.type(0.0))[:, None],
                    device=device)
                f_t_h = sobj.grid_trial_values(
                    z_list, zp_list, tsd, _grid_coef_sq(xx, xp, pp, tsd),
                    l2s).cpu().numpy()[:, 0]
                thr_t = f_h + c1_np * t_tail * gp_h
                hit = searching & (f_t_h <= thr_t) & np.isfinite(f_t_h)
                t_np = np.where(hit, t_tail, t_np)
                f_new_h = np.where(hit, f_t_h, f_new_h)
                ok |= hit
                searching &= ~hit
                k += 1

            its[active] += 1  # failed searches count, like the scalar solver
            moved = ok & active
            failed = active & ~ok
            for gi in np.flatnonzero(failed):
                reasons[gi] = ConvergenceReason.OBJECTIVE_NOT_IMPROVING
                if its[gi] <= max_iter:
                    value_hist[gi, its[gi]] = f_h[gi]
                    gnorm_hist[gi, its[gi]] = gnorm[gi]
                    if coef_hist is not None:
                        coef_hist[gi, its[gi]] = x[gi].cpu().numpy()
                if rings[gi] is not None:
                    # Failed line search: the row's iterate did not move.
                    rings[gi].append(int(its[gi]), f_h[gi], gnorm[gi], 0.0)
            active &= ok

            if moved.any():
                t_dev = torch.as_tensor(t_np, device=device)
                moved_dev = torch.as_tensor(moved, device=device)
                x_new = _grid_axpy_masked(x, t_dev, dirs)
                z_new = sobj.grid_update_margins(z_list, t_dev, zp_list)
                g_full = sobj.grid_grad_from_margins_list(x_new, z_new, l2s)
                g_new = _grid_select_rows(moved_dev, g_full, g)
                hist = _grid_update_history(hist, x_new, x, g_new, g,
                                            moved_dev)
                gnorm_new = torch.linalg.norm(g_new, dim=-1).cpu().numpy()
                x, z_list, g = x_new, z_new, g_new
                f_delta = np.abs(f_h - f_new_h)
                f_h = np.where(moved, f_new_h, f_h)
                gnorm = np.where(moved, gnorm_new, gnorm)

                for gi in np.flatnonzero(moved):
                    check_solver_finite("streaming-lbfgs-grid", int(its[gi]),
                                        f_h[gi], gnorm[gi], ctxs[gi],
                                        lam=l2_h[gi], grid_row=gi)
                    value_hist[gi, its[gi]] = f_h[gi]
                    gnorm_hist[gi, its[gi]] = gnorm[gi]
                    if coef_hist is not None:
                        coef_hist[gi, its[gi]] = x[gi].cpu().numpy()
                    if rings[gi] is not None:
                        rings[gi].append(int(its[gi]), f_h[gi], gnorm[gi],
                                         float(t_np[gi]))
                    if gnorm[gi] <= tol_s * gnorm0[gi]:
                        reasons[gi] = ConvergenceReason.GRADIENT_CONVERGED
                    elif f_delta[gi] <= tol_s * f0_scale[gi]:
                        reasons[gi] = (
                            ConvergenceReason.FUNCTION_VALUES_CONVERGED)
                    elif its[gi] >= max_iter:
                        reasons[gi] = ConvergenceReason.MAX_ITERATIONS
                    if reasons[gi] != ConvergenceReason.NOT_CONVERGED:
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
                          else torch.from_numpy(coef_hist[gi].copy())))
        for gi in range(G)
    ]
