"""Damped (Levenberg-style) exact Newton for SMALL dense problems (port of
photon_ml_tpu/optimization/newton.py: the damping constants :44-47, the
branch-free accept/reject body :104-158, minimize_newton :169-203).

After feature selection or projection an entity problem has d of order
8-64 (reference ml/data/RandomEffectDataSet.scala:380-394). At those
sizes the exact Hessian is a tiny matrix and a direct solve replaces both
the L-BFGS two-loop recursion and TRON's inner CG — the same
trust-region-Newton family as the reference's TRON
(ml/optimization/TRON.scala), with the truncated CG degenerating to an
exact solve.

Damping loop per iteration (branch-free, masked per problem):
  step = -(H + damping I)^{-1} g; accept if f decreases (damping shrinks),
  else reject and grow damping — the Levenberg analog of TRON's
  trust-region radius update (TRON.scala:153-255).

Convergence semantics follow ml/optimization/Optimizer.scala:156-170, as
in lbfgs.py and tron.py.

The port differentiates ``fun`` with ``torch.func`` (``grad_and_value``,
``hessian``), so ``fun`` must be made of torch operations that write
nothing in place into their inputs: ``GLMObjective.value`` over
``DenseFeatures`` is. A function that reaches a kernel bound by ctypes
(row 9's CSR product on the card) cannot be differentiated and raises.
The damped system is solved by ``torch.linalg.solve_ex`` without its
error check (JAX's ``linalg.solve`` gives non-finite entries for a
singular system, which the body rejects): a step is rejected when the
factorization reports a zero pivot or the step is not finite. The loop is
``utils/device_loop.while_loop``: a WHILE node when the stream captures a
graph, the eager plain loop otherwise.

A batch: ``x0`` of shape [B, d] solves B problems in one loop, every
tensor of ``args`` (inside tuples, lists, dicts and dataclasses, such as
a ``GLMBatch``) that has a dimension carrying a leading B, 0-d tensors
and other values shared. It stands for ``jax.vmap(minimize_newton)``:
each problem's state is held once it has stopped, as the JAX body masks
it with ``done``, so its iterations, reason and histories are those of
its own solve.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from photon_ml_tpu_torch.optimization.convergence import (
    ConvergenceReason,
    OptimizerResult,
)
from photon_ml_tpu_torch.optimization.lbfgs import _project
from photon_ml_tpu_torch.utils.checkpoint import map_leaves
from photon_ml_tpu_torch.utils.device_loop import while_loop

Tensor = torch.Tensor

_DAMP_INIT = 1e-4
_DAMP_SHRINK = 0.3
_DAMP_GROW = 10.0
_DAMP_MAX = 1e10

_NOT_CONVERGED = int(ConvergenceReason.NOT_CONVERGED)


def _derivatives(fun: Callable[..., Tensor], args: Tuple, batch):
    """(value_and_grad(x) -> (f, g), hessian(x) -> H) of ``fun(x, *args)``
    by torch.func, vmapped over the problems when ``batch`` is their
    count (None for one problem)."""
    leaves: List[Tensor] = []
    map_leaves(args, lambda t: leaves.append(t) or t)
    # The problems' own tensors go through vmap; the shared ones are
    # closed over.
    mapped = [i for i, t in enumerate(leaves)
              if batch is not None and t.dim()]
    for i in mapped:
        if leaves[i].shape[0] != batch:
            raise ValueError(
                f"minimize_newton of a [{batch}, d] batch: every tensor of "
                f"args with a dimension carries a leading {batch}, got "
                f"{tuple(leaves[i].shape)}")
    inputs = [leaves[i] for i in mapped]

    def f(x, *ls):
        if not ls:
            return fun(x, *args)
        own = list(leaves)
        for i, t in zip(mapped, ls):
            own[i] = t
        it = iter(own)
        return fun(x, *map_leaves(args, lambda _: next(it)))

    grad_and_value = torch.func.grad_and_value(f)
    hess = torch.func.hessian(f)
    if batch is not None:
        grad_and_value = torch.func.vmap(grad_and_value)
        hess = torch.func.vmap(hess)

    def value_and_grad(x):
        g, v = grad_and_value(x, *inputs)
        return v, g

    return value_and_grad, lambda x: hess(x, *inputs)


def _write(hist: Tensor, it: Tensor, value: Tensor, accept: Tensor,
           axis: int) -> Tensor:
    """``hist`` with ``value`` at iteration ``it`` along ``axis`` of each
    problem that accepted its step."""
    shape = list(value.unsqueeze(axis).shape)
    index = it.long().reshape(it.shape + (1,) * (len(shape) - it.dim()))
    written = hist.scatter(axis, index.expand(shape), value.unsqueeze(axis))
    mask = accept.reshape(accept.shape + (1,) * (hist.dim() - accept.dim()))
    return torch.where(mask, written, hist)


def minimize_newton(
    fun: Callable[..., Tensor],
    x0: Tensor,
    args: Tuple[Any, ...] = (),
    *,
    max_iter: int = 15,
    tol: float = 1e-5,
    max_improvement_failures: int = 25,
    lower_bounds: Optional[Tensor] = None,
    upper_bounds: Optional[Tensor] = None,
    track_coefficients: bool = False,
) -> OptimizerResult:
    """Minimize twice-differentiable ``fun(x, *args)`` from ``x0`` with
    damped exact Newton, on the device of ``x0``. Intended for small d
    (the full Hessian is materialized). NOT routed to by ``solve_glm``
    (as in the JAX package): call it explicitly. Defaults mirror TRON's
    budget (maxIter=15, tol=1e-5; ml/optimization/TRON.scala:258-264).
    ``max_improvement_failures`` is higher than TRON's because a rejected
    damped step is much cheaper than a rejected trust-region step (no CG
    inside). ``x0`` [B, d] solves B problems (the module docstring);
    then every field of the result has a leading B."""
    x0 = torch.as_tensor(x0)
    if x0.dim() not in (1, 2):
        raise ValueError(f"x0 must be [d] or [B, d], got {tuple(x0.shape)}")
    dtype, device = x0.dtype, x0.device
    d = x0.shape[-1]
    lo = (None if lower_bounds is None
          else torch.as_tensor(lower_bounds, dtype=dtype, device=device))
    hi = (None if upper_bounds is None
          else torch.as_tensor(upper_bounds, dtype=dtype, device=device))
    batch = x0.shape[0] if x0.dim() == 2 else None
    value_and_grad, hess = _derivatives(fun, args, batch)
    lead = x0.shape[:-1]

    def full(value, dt=dtype):
        return torch.full(lead, value, dtype=dt, device=device)

    x = _project(x0, lo, hi)
    f, g = value_and_grad(x)
    gnorm0 = torch.linalg.vector_norm(g, dim=-1)
    f0_scale = torch.clamp_min(torch.abs(f), 1e-30)
    eye = torch.eye(d, dtype=dtype, device=device)

    def history(first):
        buf = torch.full((*first.shape[:len(lead)], max_iter + 1,
                          *first.shape[len(lead):]), float("nan"),
                         dtype=dtype, device=device)
        buf.select(len(lead), 0).copy_(first)
        return buf

    state = {
        "x": x.clone(), "f": f.clone(), "g": g.clone(),
        "damping": full(_DAMP_INIT),
        "it": full(0, torch.int32), "fails": full(0, torch.int32),
        "reason": torch.where(
            gnorm0 <= 0.0, int(ConvergenceReason.GRADIENT_CONVERGED),
            _NOT_CONVERGED).to(torch.int32),
        "values": history(f), "gnorms": history(gnorm0)}
    if track_coefficients:
        state["coefs"] = history(x)

    def step(s):
        x, f, g, damping = s["x"], s["f"], s["g"], s["damping"]
        system = hess(x) + damping[..., None, None] * eye
        sol, info = torch.linalg.solve_ex(system, g, check_errors=False)
        newton_step = -sol
        # A singular system gives a zero pivot or non-finite entries:
        # a rejected step (damping grows until H + damping I is safely PD).
        step_ok = (info == 0) & torch.isfinite(newton_step).all(-1)
        x_try = _project(
            x + torch.where(step_ok[..., None], newton_step,
                            torch.zeros_like(newton_step)), lo, hi)
        f_new, g_new = value_and_grad(x_try)

        accept = step_ok & torch.isfinite(f_new) & (f_new < f)
        damping_new = torch.where(
            accept, torch.clamp_min(damping * _DAMP_SHRINK, 1e-12),
            torch.clamp_max(damping * _DAMP_GROW, _DAMP_MAX))
        it_new = s["it"] + accept.to(torch.int32)
        fails_new = torch.where(accept, 0, s["fails"] + 1).to(torch.int32)

        x_acc = torch.where(accept[..., None], x_try, x)
        f_acc = torch.where(accept, f_new, f)
        g_acc = torch.where(accept[..., None], g_new, g)
        gnorm_acc = torch.linalg.vector_norm(g_acc, dim=-1)
        f_delta = torch.abs(f - f_acc)

        reason = torch.where(
            fails_new > max_improvement_failures,
            int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING),
            torch.where(
                accept & (gnorm_acc <= tol * gnorm0),
                int(ConvergenceReason.GRADIENT_CONVERGED),
                torch.where(
                    accept & (f_delta <= tol * f0_scale),
                    int(ConvergenceReason.FUNCTION_VALUES_CONVERGED),
                    torch.where(
                        it_new >= max_iter,
                        int(ConvergenceReason.MAX_ITERATIONS),
                        _NOT_CONVERGED)))).to(torch.int32)

        new = {"x": x_acc, "f": f_acc, "g": g_acc, "damping": damping_new,
               "it": it_new, "fails": fails_new, "reason": reason,
               "values": _write(s["values"], it_new, f_acc, accept, -1),
               "gnorms": _write(s["gnorms"], it_new, gnorm_acc, accept, -1)}
        if track_coefficients:
            new["coefs"] = _write(s["coefs"], it_new, x_acc, accept, -2)
        # A problem that has stopped keeps its state.
        done = s["reason"] != _NOT_CONVERGED
        return {k: torch.where(
            done.reshape(done.shape + (1,) * (v.dim() - done.dim())),
            s[k], v) for k, v in new.items()}

    s = while_loop(state, step,
                   lambda s: (s["reason"] == _NOT_CONVERGED).any())
    return OptimizerResult(
        x=s["x"], value=s["f"],
        grad_norm=torch.linalg.vector_norm(s["g"], dim=-1),
        iterations=s["it"], reason=s["reason"],
        value_history=s["values"], grad_norm_history=s["gnorms"],
        coef_history=s.get("coefs"))
