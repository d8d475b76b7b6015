"""L-BFGS history, search directions, the projected line search and the
generic projected L-BFGS solver (port of
photon_ml_tpu/optimization/lbfgs.py: _LBFGSHistory :47,
two_loop_direction :63, compact_direction :93, update_history :136,
_project :173, backtracking_line_search :181-229, _minimize_lbfgs_impl
and minimize_lbfgs :232-387).

The history is a fixed-shape chronological ring of ``m`` (s, y) pairs,
oldest first; empty slots carry rho = 0 and contribute nothing. Updates
are cautious: a pair is stored only when s.y > eps ||s|| ||y||. Every
field stays a device tensor, so a solver loop never has to read the
history back to the host.

``minimize_lbfgs`` is the solver ``solve_glm`` takes for a bounded
L-BFGS problem (box constraints break the margin cache of
glm_lbfgs.py): x0 is projected onto [lower, upper] first, each trial is
clamped and priced by a full value-and-gradient evaluation, Armijo is
tested on the realized displacement, and the stop tests use the raw
gradient norm (reference: OptimizationUtils.projectCoefficientsToHypercube
at LBFGS.scala:77). The JAX ``lax.while_loop``s become device loops
(utils/device_loop.py), the line search one inside the iteration's: in
a captured update graph nothing is read back; run eagerly, the host
reads one predicate a trial and one an iteration.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from photon_ml_tpu_torch.optimization.convergence import (
    OptimizerResult,
    history_buffer,
    history_write,
)
from photon_ml_tpu_torch.utils.device_loop import while_loop

Tensor = torch.Tensor

CAUTIOUS_EPS = 1e-10


class LBFGSHistory(NamedTuple):
    s: Tensor  # [m, d] chronological: oldest first, newest at m-1
    y: Tensor  # [m, d]
    rho: Tensor  # [m]; 0 marks an empty slot
    count: Tensor  # int32 scalar: number of valid pairs


def empty_history(d: int, m: int, dtype, device) -> LBFGSHistory:
    return LBFGSHistory(
        s=torch.zeros((m, d), dtype=dtype, device=device),
        y=torch.zeros((m, d), dtype=dtype, device=device),
        rho=torch.zeros((m,), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device))


def _gamma(hist: LBFGSHistory, sy_newest: Tensor, g: Tensor) -> Tensor:
    yy = torch.dot(hist.y[-1], hist.y[-1])
    return torch.where(hist.count > 0,
                       sy_newest / torch.clamp_min(yy, CAUTIOUS_EPS),
                       torch.ones((), dtype=g.dtype, device=g.device))


def two_loop_direction(g: Tensor, hist: LBFGSHistory) -> Tensor:
    """-H_k g by the two-loop recursion; slots with rho == 0 contribute
    nothing. The entity solver (ops/entity_solver.py) runs the same
    recursion batched over entities."""
    m = hist.rho.shape[0]
    q = g
    alphas = []
    for j in reversed(range(m)):  # newest -> oldest
        alpha = hist.rho[j] * torch.dot(hist.s[j], q)
        q = q - alpha * hist.y[j]
        alphas.append(alpha)
    alphas.reverse()
    r = _gamma(hist, torch.dot(hist.s[-1], hist.y[-1]), g) * q
    for j in range(m):  # oldest -> newest
        beta = hist.rho[j] * torch.dot(hist.y[j], r)
        r = r + (alphas[j] - beta) * hist.s[j]
    return -r


def compact_direction(g: Tensor, hist: LBFGSHistory) -> Tensor:
    """-H_k g by the Byrd-Nocedal-Schnabel compact representation
    (Nocedal & Wright eq. 7.24), algebraically the two-loop recursion.
    The JAX fixed-effect solver uses this form, so the port does too:
    the two agree only to rounding, and the fixed-effect parity test
    holds iteration counts equal."""
    S, Y = hist.s, hist.y
    valid = hist.rho != 0
    sty = S @ Y.T  # [m, m]
    a = S @ g
    b = Y @ g
    diag = torch.diagonal(sty)
    gamma = _gamma(hist, diag[-1], g)
    r_mat = torch.triu(sty) + torch.diag(
        torch.where(valid, 0.0, 1.0).to(sty.dtype))
    p1 = torch.linalg.solve_triangular(r_mat, a[:, None], upper=True)[:, 0]
    rhs = diag * p1 + gamma * (Y @ (Y.T @ p1)) - gamma * b
    p2 = torch.linalg.solve_triangular(r_mat.T, rhs[:, None],
                                       upper=False)[:, 0]
    hg = gamma * g + S.T @ p2 - gamma * (Y.T @ p1)
    return -hg


def update_history(hist: LBFGSHistory, s: Tensor, y: Tensor
                   ) -> LBFGSHistory:
    """Cautious shift-left update: (s, y) lands in slot m-1 only when
    s.y > eps ||s|| ||y||; otherwise the history is unchanged."""
    sy = torch.dot(s, y)
    ok = sy > CAUTIOUS_EPS * torch.linalg.norm(s) * torch.linalg.norm(y)
    m = hist.rho.shape[0]
    stored = LBFGSHistory(
        s=torch.cat([hist.s[1:], s[None]]),
        y=torch.cat([hist.y[1:], y[None]]),
        rho=torch.cat([hist.rho[1:], (1.0 / sy)[None]]),
        count=torch.clamp_max(hist.count + 1, m))
    return select_history(ok, stored, hist)


def select_history(cond: Tensor, a: LBFGSHistory, b: LBFGSHistory
                   ) -> LBFGSHistory:
    """Field-wise ``where(cond, a, b)`` for a scalar condition."""
    return LBFGSHistory(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def _project(x: Tensor, lower: Optional[Tensor], upper: Optional[Tensor]
             ) -> Tensor:
    if lower is not None:
        x = torch.maximum(x, lower)
    if upper is not None:
        x = torch.minimum(x, upper)
    return x


def backtracking_line_search(
    vg: Callable[..., Tuple[Tensor, Tensor]],
    x: Tensor,
    f: Tensor,
    decrease_grad: Tensor,
    direction: Tensor,
    args: Tuple,
    *,
    initial_step: Tensor,
    c1: float,
    max_steps: int,
    project_fn: Callable[[Tensor], Tensor],
    shrink: float = 0.5,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Armijo backtracking on the projected step: t = initial_step, then
    t * shrink up to ``max_steps`` more times, until
    f(x_t) <= f + c1 <decrease_grad, x_t - x> with f(x_t) finite, where
    x_t = project_fn(x + t direction). Returns (ok, x_new, f_new, g_new),
    ``ok`` a device bool, the last trial when none passed. An inner
    device loop (utils/device_loop.py): a WHILE node inside the solver's
    when captured, a host read a trial when eager."""
    device = x.device
    state = {"t": initial_step.clone(),
             "k": torch.zeros((), dtype=torch.int32, device=device),
             "searching": torch.ones((), dtype=torch.bool, device=device),
             "ok": torch.zeros((), dtype=torch.bool, device=device),
             "x_t": torch.empty_like(x), "f_t": torch.empty_like(f),
             "g_t": torch.empty_like(x)}

    def trial(s):
        x_t = project_fn(x + s["t"] * direction)
        f_t, g_t = vg(x_t, *args)
        armijo = ((f_t <= f + c1 * torch.dot(decrease_grad, x_t - x))
                  & torch.isfinite(f_t))
        return {"x_t": x_t, "f_t": f_t, "g_t": g_t, "ok": armijo,
                "searching": ~armijo & (s["k"] < max_steps),
                "t": s["t"] * shrink, "k": s["k"] + 1}

    s = while_loop(state, trial, lambda s: s["searching"])
    return s["ok"], s["x_t"], s["f_t"], s["g_t"]


def minimize_lbfgs(
    value_and_grad: Callable[..., Tuple[Tensor, Tensor]],
    x0: Tensor,
    args: Tuple[Any, ...] = (),
    *,
    max_iter: int = 100,
    tol: float = 1e-7,
    history_size: int = 10,
    lower_bounds: Optional[Tensor] = None,
    upper_bounds: Optional[Tensor] = None,
    c1: float = 1e-4,
    max_line_search: int = 30,
    track_coefficients: bool = False,
) -> OptimizerResult:
    """Minimize f(x, *args) from ``x0`` within [lower_bounds,
    upper_bounds] (either may be None: unbounded on that side).
    ``value_and_grad(x, *args)`` returns (value, gradient). Defaults
    mirror the reference (maxIter=100, tol=1e-7, m=10).
    ``track_coefficients`` writes each recorded iterate into
    ``coef_history``; the solve is the same either way."""
    # glm_lbfgs imports this module, so its helpers are taken at call
    # time.
    from photon_ml_tpu_torch.optimization.glm_lbfgs import (
        _reason,
        first_reason,
        history_state,
        not_converged,
        state_history,
    )

    dtype, device = x0.dtype, x0.device
    x = _project(x0, lower_bounds, upper_bounds)
    f, g = value_and_grad(x, *args)
    gnorm0 = torch.linalg.norm(g)
    f0_scale = torch.clamp_min(torch.abs(f), 1e-30)
    hist = empty_history(x.shape[-1], history_size, dtype, device)
    state = {"x": x.clone(), "f": f.clone(), "g": g.clone(),
             **history_state(hist),
             "it": torch.zeros((), dtype=torch.int32, device=device),
             "reason": first_reason(gnorm0),
             "values": history_buffer(f, max_iter),
             "gnorms": history_buffer(gnorm0, max_iter)}
    if track_coefficients:
        state["coefs"] = history_buffer(x, max_iter)

    def step(s):
        x, f, g = s["x"], s["f"], s["g"]
        hist = state_history(s)
        direction = compact_direction(g, hist)
        # Steepest descent when the direction does not descend.
        direction = torch.where(torch.dot(direction, g) >= 0, -g, direction)
        init_step = torch.where(
            hist.count == 0,
            1.0 / torch.clamp_min(torch.linalg.norm(direction), 1.0),
            torch.ones((), dtype=dtype, device=device))
        ok, x_new, f_new, g_new = backtracking_line_search(
            value_and_grad, x, f, g, direction, args, initial_step=init_step,
            c1=c1, max_steps=max_line_search,
            project_fn=lambda v: _project(v, lower_bounds, upper_bounds))
        hist_new = update_history(hist, x_new - x, g_new - g)
        it = s["it"] + 1
        gnorm_new = torch.linalg.norm(g_new)
        reason = _reason(ok, gnorm_new, gnorm0, torch.abs(f - f_new),
                         f0_scale, it, max_iter, tol)
        # A failed search leaves the iterate where it was.
        x = torch.where(ok, x_new, x)
        f = torch.where(ok, f_new, f)
        history_write(s["values"], it, f)
        history_write(s["gnorms"], it, gnorm_new)
        if track_coefficients:
            history_write(s["coefs"], it, x)
        return {"x": x, "f": f, "g": torch.where(ok, g_new, g),
                **history_state(select_history(ok, hist_new, hist)),
                "it": it, "reason": reason}

    s = while_loop(state, step, not_converged)
    return OptimizerResult(
        x=s["x"], value=s["f"], grad_norm=torch.linalg.norm(s["g"]),
        iterations=s["it"], reason=s["reason"],
        value_history=s["values"], grad_norm_history=s["gnorms"],
        coef_history=s.get("coefs"))
