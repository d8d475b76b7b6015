"""Per-entity GLM solve: a hand-written Hopper kernel and its plain
PyTorch version (port of photon_ml_tpu/ops/pallas_entity_solver.py:
``pallas_entity_lbfgs`` :852 in modes "lbfgs" and "owlqn", with or
without the normalization fold, without bounds: ``_make_kernel`` ->
``body`` :453-541, ``body_owlqn`` :328-394, ``_tiered_sweep`` :141,
``_two_loop`` :116, ``finish`` :267, the fold :199-209).

The random-effect coordinate solves thousands of tiny independent GLMs,
one per entity, over a bucket's ``[E, r, d]`` block. With ``factors`` and
``shifts`` the solve runs on x' = (x - shift) * factor, per entity; x' is
computed in the compute type and rounded to the input type (float32 on
the card), so the kernel's shared-memory tile holds it exactly.
Coefficients in and out are in that solve space. Per entity:

    c0 given; z0 = X c0 + off; f0 = sum w l(z0) + l2/2 |c0|^2
      (+ l1 |c0|_1 in OWL-QN); g0 = smooth gradient
    q = g (L-BFGS) or the pseudo-gradient pg(c, g) (OWL-QN); |q0| is the
      gradient norm every stop test uses
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
        OWL-QN: x_t = c + t d with each coordinate whose sign differs
          from the orthant (sign(c) where c != 0, else sign(-pg)) set to
          0; z_t = X x_t + off; f_t = sum w l(z_t) + l2/2 |x_t|^2 +
          l1 |x_t|_1 <= f + c1 pg.(x_t - c)
      history: store (s, y) from the smooth gradients when the search
        succeeded and s.y > 1e-10 |s| |y|; rho = 1/s.y; count =
        min(count + 1, m)
      stop: failed search -> OBJECTIVE_NOT_IMPROVING; |q| <= tol |q0| ->
        GRADIENT_CONVERGED; |df| <= tol max(|f0|, 1e-30) ->
        FUNCTION_VALUES_CONVERGED; iterations >= max_iter -> MAX_ITERATIONS
      a failed search leaves the iterate where it was but counts the
        iteration

Both versions compute in ``compute_dtype`` (float64 by default) whatever
the input type, and the kernel takes float32 in and writes float32 out.
Float64 is the default because two float32 implementations that sum in
different orders stop some entities for different reasons at the
random-effect tolerance: chip_smoke.py counts those disagreements
between the float32 kernel and the float32 plain version at the headline
buckets. Both report the line-search trials each entity priced
(``OptimizerResult.trials``), from which chip_smoke.py counts operations.

``entity_lbfgs`` is the wrapper: it runs the plain version for tensors on
the CPU, launches the CUDA kernel for tensors on the card, and raises for
anything else. There is no fallback from one to the other. TRON mode
(ROADMAP B5) and bounds (B3) are not ported and raise on either device.

Kernel note (csrc/entity_lbfgs.cu). Replaces the Pallas TPU kernel above,
which ran 128 entities in lane lockstep. On the H100 one warp owns one
entity: its working set and x tile sit in shared memory with the tile's
row stride padded to d + 1 floats (no bank conflicts for lanes over
rows), margins put lanes over rows, the gradient and the history put
lanes over coordinates, and sums over coordinates are warp shuffles.
Each warp loops until its own entity stops, so a slow entity never holds
up its neighbours, and tries line-search candidates in order, stopping at
the first that passes, where the TPU prices 8 as a block and 23 more on
demand (the same accepted step). The normalization fold is applied once
as the tile is loaded, or on every read where x stays in device memory.
An entity too tall for shared memory reads x from device memory, and its
working set goes to a workspace the wrapper allocates, so every bucket
launches the kernel. The solve moves few bytes (each x tile is read
once) and does little arithmetic; what bounds it on this card is the
serial dependency chain of each entity's iterations (dot -> shuffle ->
update), so the design keeps every operand on chip where it fits and
runs as many entity warps per SM as shared memory allows. Making it fast
is later work.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.optimization.convergence import (
    ConvergenceReason,
    OptimizerResult,
)
from photon_ml_tpu_torch.optimization.owlqn import pseudo_gradient

Tensor = torch.Tensor

DEFAULT_M = 10
DEFAULT_MAX_LINE_SEARCH = 30
_CAUTIOUS_EPS = 1e-10
MODES = ("lbfgs", "owlqn")


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


def check_mode(mode: str, lower=None, upper=None) -> None:
    """Raise for what the port's entity solver does not take (on the CPU
    and the card alike)."""
    if mode == "tron":
        raise NotImplementedError(
            "the per-entity TRON solver is not ported yet (ROADMAP queue B "
            "row 5, with queue A item 4)")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: expected lbfgs | owlqn | "
                         "tron")
    if lower is not None or upper is not None:
        raise NotImplementedError(
            "box constraints in the entity solver are not ported yet "
            "(ROADMAP queue B row 3)")


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
    masks for entities that have stopped (one host sync per iteration).
    All line-search candidates are priced as one [E, T, r] block (in
    OWL-QN from the [E, T, d] trial points' own margins); the first
    passing one per entity is the accepted step, and the trials an
    entity priced are counted as the kernel prices them, in order up to
    that one."""
    check_mode(mode, lower, upper)
    _check_compute_dtype(compute_dtype)
    owlqn = mode == "owlqn"
    out_dtype = x.dtype
    dt = compute_dtype
    x = _fold(x, factors, shifts, dt)
    y, off, w, c = (a.to(dt) for a in (labels, offsets, weights, coef0))
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

    def sq(v):
        return torch.sum(v * v, dim=-1)

    def conv_norm(cc, gg):
        return torch.sqrt(sq(pseudo_gradient(cc, gg, l1) if owlqn else gg))

    z = margins(c)
    f = torch.sum(w * loss.loss(z, y), dim=-1) + 0.5 * l2_weight * sq(c)
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
        pp = sq(direction)
        init = torch.where(count == 0,
                           1.0 / torch.clamp_min(torch.sqrt(pp), 1.0),
                           torch.ones_like(pp))
        ts = init[:, None] * powers  # [E, T]
        if owlqn:
            orthant = torch.where(c != 0, torch.sign(c), torch.sign(-pg))
            xt = c[:, None, :] + ts[:, :, None] * direction[:, None, :]
            xt = torch.where(torch.sign(xt) == orthant[:, None, :], xt,
                             torch.zeros_like(xt))  # [E, T, d]
            zt = torch.einsum("erd,etd->etr", x, xt) + off[:, None, :]
            ft = (torch.sum(w[:, None, :] * loss.loss(zt, y[:, None, :]),
                            dim=-1)
                  + 0.5 * l2_weight * torch.sum(xt * xt, dim=-1)
                  + l1 * torch.sum(torch.abs(xt), dim=-1))
            dec = torch.sum(pg[:, None, :] * (xt - c[:, None, :]), dim=-1)
            armijo = (ft <= f[:, None] + c1 * dec) & torch.isfinite(ft)
        else:
            zp = margins(direction) - off
            xx = sq(c)
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
        if owlqn:
            pick = first[:, :, None]
            c_new = torch.gather(xt, 1, pick.expand(E, 1, d))[:, 0]
            z_new = torch.gather(zt, 1, pick.expand(E, 1, zt.shape[-1]))[:, 0]
        else:
            t_acc = torch.where(ok, torch.gather(ts, 1, first)[:, 0],
                                torch.zeros_like(pp))
            c_new = c + t_acc[:, None] * direction
            z_new = z + t_acc[:, None] * zp
        g_new = grad_from(c_new, z_new)
        gnorm_new = conv_norm(c_new, g_new)

        s_vec, y_vec = c_new - c, g_new - g
        sy = torch.sum(s_vec * y_vec, dim=-1)
        store = ok & (sy > _CAUTIOUS_EPS * torch.sqrt(sq(s_vec))
                      * torch.sqrt(sq(y_vec)))
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


@functools.lru_cache(maxsize=None)
def _load_kernel():
    """The kernel's C entry points with their ctypes signatures, set once:
    (launch, workspace_bytes, layout)."""
    from photon_ml_tpu_torch.ops import cuda_build

    lib = cuda_build.load("entity_lbfgs")
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    launch = lib.entity_lbfgs_launch
    launch.argtypes = [vp] * 14 + [ci] * 6 + [cd] * 4 + [ci, ci, ci, vp]
    launch.restype = ci
    workspace_bytes = lib.entity_lbfgs_workspace_bytes
    workspace_bytes.argtypes = [ci] * 5
    workspace_bytes.restype = ctypes.c_size_t
    layout = lib.entity_lbfgs_layout
    layout.argtypes = [ci] * 4
    layout.restype = ci
    return launch, workspace_bytes, layout


def kernel_layout(r: int, d: int, m: int = DEFAULT_M,
                  compute_dtype: torch.dtype = torch.float64) -> int:
    """Where the kernel keeps an entity of r rows and d coordinates on the
    current CUDA device: 0 x tile and working set in shared memory, 1 x
    read from device memory, 2 x and working set in device memory."""
    layout = _load_kernel()[2](r, d, m, int(compute_dtype == torch.float64))
    if layout < 0:
        raise RuntimeError(f"entity_lbfgs layout query: CUDA error {-layout}")
    return layout


def variant(mode: str, normalized: bool) -> str:
    """The name a launch is counted under in ``entity_lbfgs.variants``."""
    return mode + ("+normalized" if normalized else "")


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
    ``factors``/``shifts`` [E, d]; ``mode`` "lbfgs" (L2; ``l1_weight``
    unused) or "owlqn" (elastic net). Returns an OptimizerResult with
    [E]-leading fields (no histories) and the trials each entity priced.

    CPU tensors (float32 or float64) run ``entity_lbfgs_plain``. CUDA
    tensors launch the kernel (float32, contiguous, any r and d) and raise
    on anything it does not take. Both compute in ``compute_dtype``.
    ``entity_lbfgs.launches`` counts kernel launches, and
    ``entity_lbfgs.variants`` counts them per ``variant(mode,
    normalized)``."""
    check_mode(mode, lower, upper)
    normalized = factors is not None or shifts is not None
    if x.dim() != 3:
        raise ValueError(f"x must be [E, r, d], got {tuple(x.shape)}")
    E, r, d = x.shape
    if normalized:
        # The kernel takes both or neither: the absent one is inert.
        if factors is None:
            factors = torch.ones_like(shifts)
        if shifts is None:
            shifts = torch.zeros_like(factors)
    tensors = {"x": x, "labels": labels, "offsets": offsets,
               "weights": weights, "coef0": coef0}
    if normalized:
        tensors.update(factors=factors, shifts=shifts)
    shapes = {"x": (E, r, d), "labels": (E, r), "offsets": (E, r),
              "weights": (E, r), "coef0": (E, d), "factors": (E, d),
              "shifts": (E, d)}
    for name, t in tensors.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got "
                             f"{tuple(t.shape)}")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or x.device.type not in ("cpu", "cuda"):
        raise ValueError("entity_lbfgs takes tensors all on the CPU or all "
                         "on one CUDA device, got "
                         f"{sorted(str(dv) for dv in devices)}")
    _check_compute_dtype(compute_dtype)
    kw = dict(max_iter=max_iter, tol=tol, m=m, c1=c1,
              max_line_search=max_line_search, mode=mode,
              compute_dtype=compute_dtype)
    if x.device.type == "cpu":
        if any(t.dtype not in (torch.float32, torch.float64)
               for t in tensors.values()):
            raise TypeError("entity_lbfgs takes float32 or float64 on the "
                            "CPU, got "
                            f"{[t.dtype for t in tensors.values()]}")
        return entity_lbfgs_plain(loss, x, labels, offsets, weights, coef0,
                                  l2_weight, l1_weight, factors, shifts, **kw)
    for t in tensors.values():
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors")
    if min(m, max_iter) < 1 or max_line_search < 0:
        raise ValueError("m and max_iter must be >= 1, max_line_search >= 0")

    out_c = torch.empty((E, d), dtype=torch.float32, device=x.device)
    out_f = torch.empty((E,), dtype=torch.float32, device=x.device)
    out_gnorm = torch.empty_like(out_f)
    out_it = torch.empty((E,), dtype=torch.int32, device=x.device)
    out_reason = torch.empty_like(out_it)
    out_trials = torch.empty_like(out_it)
    if E == 0:
        return OptimizerResult(out_c, out_f, out_gnorm, out_it, out_reason,
                               trials=out_trials)
    launch, workspace_bytes, _ = _load_kernel()
    f64 = int(compute_dtype == torch.float64)
    with torch.cuda.device(x.device):
        # Scratch for entities too tall for shared memory (0 bytes at
        # the slice's buckets).
        n_ws = workspace_bytes(E, r, d, m, f64)
        workspace = torch.empty((n_ws,), dtype=torch.uint8, device=x.device)
        err = launch(
            x.data_ptr(), labels.data_ptr(), offsets.data_ptr(),
            weights.data_ptr(), coef0.data_ptr(),
            factors.data_ptr() if normalized else None,
            shifts.data_ptr() if normalized else None,
            out_c.data_ptr(), out_f.data_ptr(), out_gnorm.data_ptr(),
            out_it.data_ptr(), out_reason.data_ptr(), out_trials.data_ptr(),
            workspace.data_ptr() if n_ws else None,
            E, r, d, m, max_iter, max_line_search, float(l2_weight),
            float(l1_weight), float(tol), float(c1), loss.kernel_id, f64,
            int(mode == "owlqn"),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"entity_lbfgs kernel launch failed: CUDA error "
                           f"{err}")
    entity_lbfgs.launches += 1
    entity_lbfgs.variants[variant(mode, normalized)] += 1
    return OptimizerResult(out_c, out_f, out_gnorm, out_it, out_reason,
                           trials=out_trials)


def reset_launch_counts() -> None:
    """Set the total and every per-variant launch count to 0."""
    entity_lbfgs.launches = 0
    entity_lbfgs.variants.clear()


entity_lbfgs.launches = 0
entity_lbfgs.variants = collections.Counter()
