"""GLM L-BFGS with a margin-cached line search (port of
photon_ml_tpu/optimization/glm_lbfgs.py: _minimize_lbfgs_glm_impl :83,
minimize_lbfgs_glm :810).

Margins are affine in the coefficients, so along a direction p

    margins(x + t p) = z + t zp
    value(x + t p)   = sum_i w_i l(z_i + t zp_i, y_i)
                       + l2/2 (||x||^2 + 2 t x.p + t^2 ||p||^2)

and every Armijo trial is elementwise work with no feature contraction.
Each iteration does one matvec (zp) and one rmatvec (the gradient at the
accepted point).

The JAX ``lax.while_loop`` becomes a host loop over device tensors with
one host sync per iteration (the stop reason). To keep that single sync,
all ``max_line_search + 1`` candidates t_k = t0 * 0.5^k are priced in one
``[T, n]`` pass and the first passing one is taken; the JAX solver prices
8 and runs the rest only when none pass, which accepts the same step.
"""

from __future__ import annotations

import torch

from photon_ml_tpu_torch.ops.glm_objective import GLMBatch, GLMObjective
from photon_ml_tpu_torch.optimization.convergence import (
    ConvergenceReason,
    OptimizerResult,
    padded_history,
)
from photon_ml_tpu_torch.optimization.lbfgs import (
    compact_direction,
    empty_history,
    select_history,
    update_history,
)

Tensor = torch.Tensor

_NC = int(ConvergenceReason.NOT_CONVERGED)


def _reason(ok, gnorm_new, gnorm0, f_delta, f0_scale, it_new: int,
            max_iter: int, tol: float) -> Tensor:
    """Stop reason after one iteration, checked in the JAX order."""
    i32 = torch.int32

    def code(reason):
        return torch.tensor(int(reason), dtype=i32, device=ok.device)

    tail = code(ConvergenceReason.MAX_ITERATIONS if it_new >= max_iter
                else ConvergenceReason.NOT_CONVERGED)
    return torch.where(
        ~ok, code(ConvergenceReason.OBJECTIVE_NOT_IMPROVING),
        torch.where(gnorm_new <= tol * gnorm0,
                    code(ConvergenceReason.GRADIENT_CONVERGED),
                    torch.where(f_delta <= tol * f0_scale,
                                code(ConvergenceReason.
                                     FUNCTION_VALUES_CONVERGED),
                                tail)))


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
    ``track_coefficients`` keeps each recorded iterate (a reference to
    the device tensor, no host sync) and stacks them once at the end
    into ``coef_history``; the solve is the same either way."""
    dtype, device = x0.dtype, x0.device
    x = x0
    z = objective.margins(x, batch)
    f = objective.value_from_margins(z, torch.dot(x, x), batch, l2_weight)
    g = objective.gradient_from_margins(x, z, batch, l2_weight)
    gnorm0 = torch.linalg.norm(g)
    f0_scale = torch.clamp_min(torch.abs(f), 1e-30)
    hist = empty_history(x.shape[-1], history_size, dtype, device)

    values, gnorms = [f], [gnorm0]
    coefs = [x] if track_coefficients else None
    reason = (int(ConvergenceReason.GRADIENT_CONVERGED)
              if float(gnorm0) <= 0.0 else _NC)
    it = 0
    powers = torch.pow(
        torch.tensor(0.5, dtype=dtype, device=device),
        torch.arange(max_line_search + 1, dtype=dtype, device=device))
    labels, weights = batch.labels[None, :], batch.weights[None, :]

    while reason == _NC:
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
        t_acc, f_new = ts[idx], f_trials[idx]

        x_new = x + t_acc * direction
        z_new = z + t_acc * zp
        g_new = objective.gradient_from_margins(x_new, z_new, batch,
                                                l2_weight)
        hist_new = update_history(hist, x_new - x, g_new - g)
        it += 1
        gnorm_new = torch.linalg.norm(g_new)
        reason_t = _reason(ok, gnorm_new, gnorm0, torch.abs(f - f_new),
                           f0_scale, it, max_iter, tol)

        # A failed line search does not move the iterate.
        x = torch.where(ok, x_new, x)
        z = torch.where(ok, z_new, z)
        f = torch.where(ok, f_new, f)
        gnorm_new = torch.where(ok, gnorm_new, torch.linalg.norm(g))
        g = torch.where(ok, g_new, g)
        hist = select_history(ok, hist_new, hist)
        values.append(f)
        gnorms.append(gnorm_new)
        if coefs is not None:
            coefs.append(x)
        reason = int(reason_t)  # the iteration's one host sync

    return OptimizerResult(
        x=x, value=f, grad_norm=torch.linalg.norm(g),
        iterations=torch.tensor(it, dtype=torch.int32),
        reason=torch.tensor(reason, dtype=torch.int32),
        value_history=padded_history(values, max_iter),
        grad_norm_history=padded_history(gnorms, max_iter),
        coef_history=(None if coefs is None
                      else padded_history(coefs, max_iter)))
