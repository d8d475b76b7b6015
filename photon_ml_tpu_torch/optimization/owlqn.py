"""OWL-QN (Orthant-Wise Limited-memory Quasi-Newton) for L1 and elastic
net (port of photon_ml_tpu/optimization/owlqn.py: pseudo_gradient :43,
_orthant_project :51, _minimize_owlqn_impl :74-180, minimize_owlqn
:183-207; reference ml/optimization/OWLQN.scala:43-91).

L-BFGS with the three OWL-QN changes (Andrew & Gao 2007):

- the direction comes from the pseudo-gradient of F = f + l1 |x|_1 and
  keeps only the components that agree with -pg;
- trial points are projected onto the orthant of the current iterate
  (components that cross zero become zero);
- curvature pairs use the smooth gradient only.

The JAX ``lax.while_loop`` becomes a device loop (utils/device_loop.py)
with the line search as an inner one: captured into an update graph it
reads nothing back; run eagerly, the host reads one predicate a trial
and one an iteration.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from photon_ml_tpu_torch.optimization.convergence import (
    OptimizerResult,
    history_buffer,
    history_write,
)
from photon_ml_tpu_torch.optimization.glm_lbfgs import (
    _reason,
    first_reason,
    history_state,
    not_converged,
    state_history,
)
from photon_ml_tpu_torch.optimization.lbfgs import (
    backtracking_line_search,
    compact_direction,
    empty_history,
    select_history,
    update_history,
)
from photon_ml_tpu_torch.utils.device_loop import while_loop

Tensor = torch.Tensor

def pseudo_gradient(x: Tensor, g: Tensor, l1) -> Tensor:
    """Pseudo-gradient of f(x) + l1 . |x| (elementwise l1 >= 0)."""
    right = g + l1  # the derivative approaching x == 0 from the right
    left = g - l1
    zero = torch.zeros_like(g)
    at_zero = torch.where(right < 0, right, torch.where(left > 0, left, zero))
    return torch.where(x != 0, g + l1 * torch.sign(x), at_zero)


def _orthant_project(x_new: Tensor, orthant: Tensor) -> Tensor:
    """Zero the components that left the chosen orthant."""
    return torch.where(torch.sign(x_new) == orthant, x_new,
                       torch.zeros_like(x_new))


def minimize_owlqn(
    value_and_grad: Callable[..., Tuple[Tensor, Tensor]],
    x0: Tensor,
    args: Tuple[Any, ...] = (),
    *,
    l1_weight,
    max_iter: int = 100,
    tol: float = 1e-7,
    history_size: int = 10,
    c1: float = 1e-4,
    max_line_search: int = 30,
    track_coefficients: bool = False,
) -> OptimizerResult:
    """Minimize f(x, *args) + l1_weight . |x| from x0. ``value_and_grad``
    returns the smooth part's (value, gradient); ``l1_weight`` is a
    scalar or a per-coordinate vector. Histories hold the full objective
    and the pseudo-gradient norm.
    ``track_coefficients`` writes each recorded iterate into
    ``coef_history``; the solve is the same either way."""
    dtype, device = x0.dtype, x0.device
    if isinstance(l1_weight, Tensor):
        l1 = l1_weight.to(dtype=dtype, device=device)
    else:
        l1 = torch.full((), float(l1_weight), dtype=dtype, device=device)
    l1 = torch.broadcast_to(l1, x0.shape)

    def full(x, *a):
        f_s, g_s = value_and_grad(x, *a)
        return f_s + torch.sum(l1 * torch.abs(x)), g_s

    x = x0
    f, g = full(x, *args)
    pg = pseudo_gradient(x, g, l1)
    pgnorm0 = torch.linalg.norm(pg)
    f0_scale = torch.clamp_min(torch.abs(f), 1e-30)
    hist = empty_history(x.shape[-1], history_size, dtype, device)
    state = {"x": x.clone(), "f": f, "g": g.clone(), "pg": pg,
             **history_state(hist),
             "it": torch.zeros((), dtype=torch.int32, device=device),
             "reason": first_reason(pgnorm0),
             "values": history_buffer(f, max_iter),
             "gnorms": history_buffer(pgnorm0, max_iter)}
    if track_coefficients:
        state["coefs"] = history_buffer(x, max_iter)

    def step(s):
        x, f, g, pg = s["x"], s["f"], s["g"], s["pg"]
        hist = state_history(s)
        direction = compact_direction(pg, hist)
        direction = torch.where(direction * pg < 0, direction,
                                torch.zeros_like(direction))
        direction = torch.where(torch.dot(direction, pg) >= 0, -pg,
                                direction)
        orthant = torch.where(x != 0, torch.sign(x), torch.sign(-pg))
        init_step = torch.where(
            hist.count == 0,
            1.0 / torch.clamp_min(torch.linalg.norm(direction), 1.0),
            torch.ones((), dtype=dtype, device=device))
        ok, x_new, f_new, g_new = backtracking_line_search(
            full, x, f, pg, direction, args, initial_step=init_step, c1=c1,
            max_steps=max_line_search,
            project_fn=lambda v: _orthant_project(v, orthant))
        hist_new = update_history(hist, x_new - x, g_new - g)
        pg_new = pseudo_gradient(x_new, g_new, l1)
        it = s["it"] + 1
        pgnorm_new = torch.linalg.norm(pg_new)
        reason = _reason(ok, pgnorm_new, pgnorm0, torch.abs(f - f_new),
                         f0_scale, it, max_iter, tol)
        x = torch.where(ok, x_new, x)
        f = torch.where(ok, f_new, f)
        history_write(s["values"], it, f)
        history_write(s["gnorms"], it, pgnorm_new)
        if track_coefficients:
            history_write(s["coefs"], it, x)
        return {"x": x, "f": f, "g": torch.where(ok, g_new, g),
                "pg": torch.where(ok, pg_new, pg),
                **history_state(select_history(ok, hist_new, hist)),
                "it": it, "reason": reason}

    s = while_loop(state, step, not_converged)
    return OptimizerResult(
        x=s["x"], value=s["f"], grad_norm=torch.linalg.norm(s["pg"]),
        iterations=s["it"], reason=s["reason"],
        value_history=s["values"], grad_norm_history=s["gnorms"],
        coef_history=s.get("coefs"))
