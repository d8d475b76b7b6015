"""TRON: trust-region Newton with truncated conjugate gradient (port of
photon_ml_tpu/optimization/tron.py: the LIBLINEAR constants :42-44,
_truncated_cg :47-109, _minimize_tron_impl :132-290, minimize_tron
:755-793; reference ml/optimization/TRON.scala:153-340).

An outer trust-region loop whose inner Steihaug-Toint CG does one
Hessian-vector product per step. The radius starts at ||g0||, is clamped
to the first step's length, and follows LIBLINEAR's rules; the solve
stops after more than 5 consecutive improvement failures. The JAX
``lax.while_loop``s become host loops over device tensors: one sync per
CG step (its stop test) and one per outer iteration (the stop reason).

With box constraints (the projected variant, TRON.scala:228) x0 is
projected first; stationarity is the projected-gradient norm
||x - P(x - g)||, which also seeds the radius; coordinates pinned at a
bound with the gradient pushing outward (within 1e-12) are frozen, so CG
runs in the free subspace; the trial is P(x + s), and the predicted
reduction is the quadratic model on the realized step, with one more
Hessian-vector product. The streaming and batched-grid variants
(tron.py:293-751) wait for ROADMAP queue A item 12.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from photon_ml_tpu_torch.optimization.convergence import (
    ConvergenceReason,
    OptimizerResult,
    padded_history,
)
from photon_ml_tpu_torch.optimization.lbfgs import _project

Tensor = torch.Tensor

_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0
_CG_XI = 0.1  # inner CG stops at ||r|| <= xi ||g||


def _truncated_cg(hvp: Callable[[Tensor], Tensor], g: Tensor, delta: Tensor,
                  max_cg: int) -> Tuple[Tensor, Tensor, int]:
    """Steihaug-Toint truncated CG: approximately solve H s = -g with
    ||s|| <= delta. Returns (s, r, steps) with r the final residual
    -g - H s, used by the predicted reduction."""
    s = torch.zeros_like(g)
    r = -g
    d = -g
    rtr = torch.dot(r, r)
    stop_norm = _CG_XI * torch.linalg.norm(g)
    one = torch.ones((), dtype=g.dtype, device=g.device)
    done = bool(torch.linalg.norm(r) <= stop_norm)
    k = 0
    while not done and k < max_cg:
        hd = hvp(d)
        dhd = torch.dot(d, hd)
        # A non-positive curvature direction marches to the boundary.
        alpha = rtr / torch.where(dhd > 0, dhd, one)
        s_try = s + alpha * d
        crossed = (torch.linalg.norm(s_try) > delta) | (dhd <= 0)

        # Boundary intersection: tau >= 0 with ||s + tau d|| = delta.
        std = torch.dot(s, d)
        dd = torch.dot(d, d)
        ss = torch.dot(s, s)
        gap = torch.clamp_min(delta * delta - ss, 0.0)
        rad = torch.sqrt(torch.clamp_min(std * std + dd * gap, 0.0))
        safe_dd = torch.clamp_min(dd, 1e-30)
        tau = torch.where(std >= 0, gap / torch.clamp_min(std + rad, 1e-30),
                          (rad - std) / safe_dd)

        step = torch.where(crossed, tau, alpha)
        s = s + step * d
        r = r - step * hd
        rtr_new = torch.dot(r, r)
        beta = rtr_new / torch.clamp_min(rtr, 1e-30)
        d = r + beta * d
        rtr = rtr_new
        k += 1
        done = bool(crossed | (torch.sqrt(rtr_new) <= stop_norm))
    return s, r, k


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
    ``cg_steps`` count every outer iteration and CG step. Either bound
    may be None (unbounded on that side). Only accepted iterates are
    recorded.
    ``track_coefficients`` keeps each recorded iterate (a reference to
    the device tensor, no host sync) and stacks them once at the end
    into ``coef_history``; the solve is the same either way."""
    if make_hvp is None:
        raise TypeError("minimize_tron needs make_hvp: the port has no "
                        "automatic Hessian-vector product")
    dtype, device = x0.dtype, x0.device

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    sigma1, sigma2, sigma3 = scalar(_SIGMA1), scalar(_SIGMA2), scalar(_SIGMA3)
    lo, hi = lower_bounds, upper_bounds
    bounded = lo is not None or hi is not None

    def proj_grad_norm(x, g):
        # ||g|| unconstrained; the projected-gradient norm with bounds.
        if not bounded:
            return torch.linalg.norm(g)
        return torch.linalg.norm(x - _project(x - g, lo, hi))

    x = _project(x0, lo, hi)
    f, g = value_and_grad(x, *args)
    gnorm0 = proj_grad_norm(x, g)
    f0_scale = torch.clamp_min(torch.abs(f), 1e-30)
    delta = gnorm0
    values, gnorms = [f], [gnorm0]
    coefs = [x] if track_coefficients else None
    reason = (int(ConvergenceReason.GRADIENT_CONVERGED)
              if float(gnorm0) <= 0.0
              else int(ConvergenceReason.NOT_CONVERGED))
    it = fails = outer = cg_steps = 0
    first = True
    while reason == int(ConvergenceReason.NOT_CONVERGED):
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
        cg_steps += k
        outer += 1
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
        if first:
            delta = torch.minimum(delta, snorm)

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

        accept = bool((actred > _ETA0 * prered) & torch.isfinite(f_new))
        first = False
        if accept:
            it += 1
            fails = 0
            f_delta = torch.abs(f - f_new)
            x, f, g = x_try, f_new, g_new
            gnorm = proj_grad_norm(x, g)
            values.append(f)
            gnorms.append(gnorm)
            if coefs is not None:
                coefs.append(x)
            if bool(gnorm <= tol * gnorm0):
                reason = int(ConvergenceReason.GRADIENT_CONVERGED)
            elif bool(f_delta <= tol * f0_scale):
                reason = int(ConvergenceReason.FUNCTION_VALUES_CONVERGED)
        else:
            fails += 1
        if fails > max_improvement_failures:
            reason = int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING)
        elif (reason == int(ConvergenceReason.NOT_CONVERGED)
              and it >= max_iter):
            reason = int(ConvergenceReason.MAX_ITERATIONS)

    return OptimizerResult(
        x=x, value=f, grad_norm=torch.linalg.norm(g),
        iterations=torch.tensor(it, dtype=torch.int32),
        reason=torch.tensor(reason, dtype=torch.int32),
        value_history=padded_history(values, max_iter),
        grad_norm_history=padded_history(gnorms, max_iter),
        coef_history=(None if coefs is None
                      else padded_history(coefs, max_iter)),
        outer_steps=outer, cg_steps=cg_steps)
