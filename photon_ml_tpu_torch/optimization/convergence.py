"""Convergence reasons and optimizer results (port of
photon_ml_tpu/optimization/convergence.py:143-201: ConvergenceReason
with its summary :151, OptimizerResult with coef_history :184 and
reason_enum :190; the streaming solvers' divergence watchdog
check_solver_finite and SolverDivergedError :71-140 with the batched λ
grid's per-row provenance and the solve's trace context; the
``--distmon`` ``ConvergenceRing`` :28-60).

An optimizer stops when (ml/optimization/Optimizer.scala:156-170)
  - iteration count hits max_iter                   -> MAX_ITERATIONS
  - |f_k - f_{k-1}| <= tol * |f_0|                  -> FUNCTION_VALUES_CONVERGED
  - ||g_k|| <= tol * ||g_0||                        -> GRADIENT_CONVERGED
  - the line search cannot improve                  -> OBJECTIVE_NOT_IMPROVING
The integer codes are the JAX package's, so results compare one to one.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import threading
from collections import deque
from typing import Optional, Union

import torch

Tensor = torch.Tensor


class ConvergenceRing:
    """Bounded per-outer-iteration solver history (loss, gradient norm,
    accepted step size): the live-observable complement of
    :class:`OptimizerResult`'s padded history arrays.

    The host-driven streaming solvers (optimization/glm_lbfgs.py and
    tron.py ``convergence_ring=``) append one entry per outer iteration
    from host floats they already synchronized for their convergence
    tests, so a long ``--stream-train --distmon`` run's /distz shows each
    λ's convergence tail live. The in-core solvers fill rings after the
    fact from their histories (data/distmon.py ``ring_from_history``;
    ``step`` is None there). Only the newest ``capacity`` entries are
    kept (``recorded`` counts every append). Lock-guarded: the solver
    thread appends while scrape threads snapshot."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.recorded = 0
        self._entries: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()

    def append(self, iteration: int, value, grad_norm,
               step=None) -> None:
        entry = {
            "iteration": int(iteration),
            "value": float(value),
            "grad_norm": float(grad_norm),
            "step": None if step is None else float(step),
        }
        with self._lock:
            self.recorded += 1
            self._entries.append(entry)

    def snapshot(self) -> dict:
        with self._lock:
            return {"capacity": self.capacity,
                    "recorded": self.recorded,
                    "tail": [dict(e) for e in self._entries]}


class ConvergenceReason(enum.IntEnum):
    NOT_CONVERGED = 0
    MAX_ITERATIONS = 1
    FUNCTION_VALUES_CONVERGED = 2
    GRADIENT_CONVERGED = 3
    OBJECTIVE_NOT_IMPROVING = 4

    @property
    def summary(self) -> str:
        return {
            ConvergenceReason.NOT_CONVERGED: "not converged",
            ConvergenceReason.MAX_ITERATIONS: "max iterations reached",
            ConvergenceReason.FUNCTION_VALUES_CONVERGED:
                "objective function values converged",
            ConvergenceReason.GRADIENT_CONVERGED: "gradient converged",
            ConvergenceReason.OBJECTIVE_NOT_IMPROVING:
                "objective is not improving",
        }[self]


@dataclasses.dataclass(frozen=True)
class OptimizerResult:
    """Solution + telemetry. For a batched (per-entity) solve every field
    has a leading entity axis; ``value_history``/``grad_norm_history``
    are ``[max_iter + 1]`` vectors (NaN past ``iterations``) for a single
    solve and None for the batched entity solver, as in the JAX package.
    TRON counts only accepted steps in ``iterations``; its total outer
    and inner CG steps are in ``outer_steps`` and ``cg_steps``."""

    x: Tensor
    value: Tensor
    grad_norm: Tensor
    iterations: Tensor  # int32, on the solve's device
    reason: Tensor  # int32, a ConvergenceReason value, on the device
    value_history: Optional[Tensor] = None
    grad_norm_history: Optional[Tensor] = None
    # Batched entity solver only: line-search trials priced per entity,
    # summed over its iterations (the JAX package does not report them).
    trials: Optional[Tensor] = None
    # TRON only: outer iterations run, accepted or not, and
    # conjugate-gradient steps summed over them (0-d int32 tensors for an
    # in-core solve, ints for a streamed one, [E] int32 tensors for the
    # batched entity solver).
    outer_steps: Optional[Union[int, Tensor]] = None
    cg_steps: Optional[Union[int, Tensor]] = None
    # Per-iteration coefficient snapshots [max_iter + 1, d] (NaN past
    # ``iterations``), recorded only when the solver was asked to track
    # them (the reference's ModelTracker state); None otherwise.
    coef_history: Optional[Tensor] = None

    def reason_enum(self) -> ConvergenceReason:
        return ConvergenceReason(int(self.reason))


def history_buffer(first: Tensor, max_iter: int) -> Tensor:
    """A solver's history on the device: ``[max_iter + 1, ...]`` of NaN
    with ``first`` (the iterate's value, gradient norm or coefficients
    before the first iteration) in row 0. Later rows are written at a
    device index (``history_write``), so the host need not know how
    many iterations ran; ``padded_history``'s contract holds."""
    buf = torch.full((max_iter + 1, *first.shape), float("nan"),
                     dtype=first.dtype, device=first.device)
    buf[0] = first
    return buf


def history_write(buf: Tensor, index: Tensor, value: Tensor) -> None:
    """``buf[index] = value`` in place, ``index`` a 0-d device integer."""
    buf.index_copy_(0, index.reshape(1).long(), value.unsqueeze(0))


def code(reason: ConvergenceReason, like: Tensor) -> Tensor:
    """A stop reason as a 0-d int32 on ``like``'s device, made there (no
    copy from the host, so it may be recorded into a CUDA graph)."""
    return torch.full((), int(reason), dtype=torch.int32, device=like.device)


def padded_history(rows, max_iter: int) -> Tensor:
    """Per-iteration snapshots (scalars or [d] vectors, one per recorded
    iterate) stacked once into ``[max_iter + 1, ...]``, NaN past the
    last: the solvers' value, gradient-norm and coefficient histories."""
    h = torch.stack(rows)
    pad = torch.full((max_iter + 1 - h.shape[0], *h.shape[1:]),
                     float("nan"), dtype=h.dtype, device=h.device)
    return torch.cat([h, pad])


class SolverDivergedError(RuntimeError):
    """A host-driven streaming solver observed a non-finite loss or
    gradient norm: the divergence watchdog's typed fault, naming the
    solver, the outer iteration, the offending values and the solve's
    ``trace_id`` (telemetry/tracectx.py), so the driver's flight dump is
    tagged with it. The batched λ grid names the one row that diverged
    (``grid_row``) and its λ (``lam``); the other rows' masks are
    untouched by the check."""

    def __init__(self, solver: str, iteration: int, value, grad_norm,
                 trace_id=None, lam=None, grid_row=None):
        where = ""
        if grid_row is not None:
            where = f" [grid row {int(grid_row)}"
            if lam is not None:
                where += f", l2={float(lam)!r}"
            where += "]"
        elif lam is not None:
            where = f" [l2={float(lam)!r}]"
        super().__init__(
            f"{solver} diverged at outer iteration {iteration}{where}: "
            f"value={value!r}, grad_norm={grad_norm!r} (non-finite). "
            "Typical causes: learning-rate/regularization far off scale, "
            "corrupt feature values, or an overflowing loss; see the "
            "flight dump for the solve's last stages"
            + (f" (trace {trace_id})" if trace_id else ""))
        self.solver = solver
        self.iteration = int(iteration)
        self.value = value
        self.grad_norm = grad_norm
        self.trace_id = trace_id
        self.lam = None if lam is None else float(lam)
        self.grid_row = None if grid_row is None else int(grid_row)


def check_solver_finite(solver: str, iteration: int, value, grad_norm,
                        trace_ctx=None, *, lam=None,
                        grid_row=None) -> None:
    """Raise :class:`SolverDivergedError` when the loss or gradient norm
    went non-finite. ``value``/``grad_norm`` are host scalars the
    streamed outer loops already hold for their convergence compares, so
    the check adds no device sync. ``trace_ctx``, the solve's trace
    context, is finished as ``diverged`` (tail-kept) and its id rides on
    the fault. The grid solvers pass ``lam`` and ``grid_row``."""
    v, g = float(value), float(grad_norm)
    if math.isfinite(v) and math.isfinite(g):
        return
    trace_id = None
    if trace_ctx is not None:
        trace_id = trace_ctx.trace_id
        trace_ctx.annotate(solver=solver, iteration=int(iteration),
                           value=v, grad_norm=g)
        if lam is not None:
            trace_ctx.annotate(reg_weight=float(lam))
        if grid_row is not None:
            trace_ctx.annotate(grid_row=int(grid_row))
        trace_ctx.finish("diverged")
    raise SolverDivergedError(solver, iteration, v, g, trace_id=trace_id,
                              lam=lam, grid_row=grid_row)
