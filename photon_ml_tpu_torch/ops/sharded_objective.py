"""Sharded GLM objective: full-batch (value, gradient, Hessian-vector) by
accumulating per-shard partials over a device shard cache (port of
photon_ml_tpu/ops/sharded_objective.py: ShardedGLMObjective :276 with
the single-device kit :424-497 and the fixed shard-order fold
_SingleFold/_OrderedFold :195-215).

The out-of-core analog of the reference's treeAggregate objective
(`ValueAndGradientAggregator.scala:243-274`,
`HessianVectorAggregator.scala`): no tensor spans the dataset — each
cached shard (data/shard_cache.py) contributes a partial, and partials
fold on the device in FIXED shard order, so only the final scalars and
[d]-vectors reach the solver.

Numeric contract, as in the JAX package:

- per-row quantities (margins, loss terms, curvature) equal the one-shot
  path's bit for bit — they are row-local;
- a SINGLE shard reproduces the one-shot ``GLMObjective`` value and
  gradient bit for bit (the same tensors and ops: the port needs no
  padding, so no reduction runs over padded rows);
- for any fixed shard decomposition the accumulation is deterministic
  and INDEPENDENT of cache residency: resident replay, spill and
  re-upload, re-decode and any prefetch depth give the same bits,
  because re-uploaded blocks are the evicted bytes, the block product
  is deterministic (ops/spmv.py; on the card a kernel with a fixed
  order of additions) and the fold order is the shard order.
  ``spill_dtype="bf16"`` replays are equally deterministic and
  residency-independent, and differ from the f32-spill model by the
  bf16 rounding of the values.

Normalization accumulates the RAW ``X^T u`` partials plus ``sum(u)`` and
applies the factor/shift chain ONCE at the apex (the algebra
``GLMObjective._jt_product`` applies per batch; for a single shard the
two are the same bits).

The batched λ grid (port of _build_grid_kit :612-700,
_build_grid_norm_kit :798-810 and the grid passes :1342-1575; the JAX
kits are jitted closures built by _ensure_grid_kits :812-836, the
port's are methods): coefficients ``[G, d]``, margins, directional
margins and curvature ``[G, rows]`` per shard, λ row ``[G]``. One feature
pass serves every lane: each cached block is read once a pass and
multiplied with the G-column panel of coefficients or margins through
ops/spmv.py ``csr_matmul`` (row 10), whose column j is the bits of the
scalar path's ``csr_matvec`` on the card. The masked margin ``axpy``
keeps frozen rows bit for bit (``where`` on t != 0, never a + 0 b).
``grid_passes`` counts the grid's feature passes, mirrored into the
registry counter ``training.grid.feature_passes`` (JAX :153). Every
feature pass is one ``accumulate`` span (JAX :1122): launches are
asynchronous, so its self time is enqueue plus what the cache makes it
wait for (``shard_reupload`` and ``prefetch_wait`` nest inside).

Not ported here: the 1-D and 2-D mesh folds, ``combine="local"`` and the
row and column kits, scalar and grid, which only a mesh builds (ROADMAP
A6), and the JAX
``TracingGuard`` trace budgets (``trace_budgets``,
``assert_trace_budget``; ROADMAP A7 — the port compiles nothing per
shape). Passing ``mesh`` raises naming A6.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.ops.glm_objective import GLMBatch, GLMObjective
from photon_ml_tpu_torch.telemetry import span

Tensor = torch.Tensor

#: One batched-grid feature pass (the registry twin of ``grid_passes``).
_M_GRID_PASSES = telemetry.counter("training.grid.feature_passes")


def _fold(acc, part):
    """One step of the left-fold of per-shard partials (tuples of tensors)
    in fixed shard order: the JAX _SingleFold's association."""
    return part if acc is None else tuple(a + b for a, b in zip(acc, part))


class ShardedGLMObjective:
    """Streaming (value, gradient, Hvp) over a DeviceShardCache.

    ``objective`` supplies the loss and (optional) normalization context;
    row-space solver state (margins, direction margins, curvature) lives
    as per-shard lists aligned with the cache's fixed shard order and is
    always resident — the feature blocks are the only thing the cache may
    spill, which keeps the margin-cached L-BFGS line search free of
    feature passes (optimization/glm_lbfgs.py)."""

    def __init__(self, objective: GLMObjective, cache, mesh=None):
        if mesh is not None:
            raise ValueError("a mesh-sharded objective folds over several "
                             "devices: multi-GPU training is ROADMAP A6")
        self.objective = objective
        self.cache = cache
        self.grid_passes = 0

    # -- per-shard partials (the JAX single-device kit) ---------------------

    def _init(self, e, coef: Tensor):
        """Margins + value partial + raw-gradient partial, one pass."""
        obj = self.objective
        batch = GLMBatch(e.feats, e.labels, e.offsets, e.weights)
        z = obj.margins(coef, batch)
        val = torch.sum(e.weights * obj.loss.loss(z, e.labels))
        u = e.weights * obj.loss.d1(z, e.labels)
        return z, (val, e.feats.rmatvec(u), torch.sum(u))

    def _trial(self, z, zp, labels, weights, ts):
        """[K] weighted-loss sums at z + t*zp: the batched Armijo sweep's
        data terms."""
        z_t = z[None, :] + ts[:, None] * zp[None, :]
        return (torch.sum(
            weights[None, :] * self.objective.loss.loss(z_t,
                                                        labels[None, :]),
            dim=-1),)

    def _require_restored(self, block) -> None:
        """A feature block must reach the accumulate in the cache's type:
        a spill encoding leaking past `restore_spilled_features` would
        otherwise accumulate at the wrong precision."""
        got = block.feats.values.dtype
        if got != self.cache.dtype:
            raise TypeError(
                f"feature block {block.index} reached the sharded "
                f"accumulate as {got}, expected {self.cache.dtype} — spill "
                "codecs must restore through data/shard_cache.py "
                "restore_spilled_features")

    def _finish_grad(self, g_raw: Tensor, su: Tensor, coef: Tensor,
                     l2) -> Tensor:
        """Apply the normalization chain + L2 ONCE at the apex (the
        algebra of GLMObjective._jt_product + l2*coef)."""
        norm = self.objective.normalization
        r = g_raw
        if norm is not None:
            if norm.shifts is not None:
                r = r - su * norm.shifts
            if norm.factors is not None:
                r = r * norm.factors
        return r + l2 * coef

    # -- accumulation passes -----------------------------------------------

    def margins_value_grad(self, coef: Tensor, l2
                           ) -> Tuple[List[Tensor], Tensor, Tensor]:
        """One pass over the feature blocks: per-shard margins (kept as
        row-space state), the objective value and the gradient."""
        z_list: List[Tensor] = []
        acc = None
        with span("accumulate"):
            for e in self.cache.blocks():
                self._require_restored(e)
                z, part = self._init(e, coef)
                z_list.append(z)
                acc = _fold(acc, part)
        val, g_raw, su = acc
        f = val + 0.5 * l2 * torch.dot(coef, coef)
        return z_list, f, self._finish_grad(g_raw, su, coef, l2)

    def value_and_grad(self, coef: Tensor, l2=0.0) -> Tuple[Tensor, Tensor]:
        _, f, g = self.margins_value_grad(coef, l2)
        return f, g

    def margin_direction_list(self, direction: Tensor) -> List[Tensor]:
        """Per-shard directional margins (one feature pass)."""
        out: List[Tensor] = []
        with span("accumulate"):
            for e in self.cache.blocks():
                self._require_restored(e)
                out.append(self.objective.margin_direction(
                    direction, GLMBatch(e.feats, e.labels, e.offsets,
                                        e.weights)))
        return out

    def trial_values(self, z_list: Sequence[Tensor],
                     zp_list: Sequence[Tensor], ts: Tensor,
                     coef_sq: Tensor, l2) -> Tensor:
        """Objective values at the [K] line-search candidates — row-space
        only (margins are cached): NO feature pass, no spill traffic."""
        acc = None
        for e, z, zp in zip(self.cache.entries, z_list, zp_list):
            acc = _fold(acc, self._trial(z, zp, e.labels, e.weights, ts))
        return acc[0] + 0.5 * l2 * coef_sq

    def update_margins(self, z_list: Sequence[Tensor], t,
                       zp_list: Sequence[Tensor]) -> List[Tensor]:
        """z + t*zp per shard — the accepted-step margin update (the
        expression the in-core solver applies to its whole margin
        vector)."""
        return [z + t * zp for z, zp in zip(z_list, zp_list)]

    def grad_from_margins_list(self, coef: Tensor,
                               z_list: Sequence[Tensor], l2) -> Tensor:
        """Gradient given cached margins: one rmatvec pass."""
        loss = self.objective.loss
        acc = None
        with span("accumulate"):
            for e, z in zip(self.cache.blocks(), z_list):
                self._require_restored(e)
                u = e.weights * loss.d1(z, e.labels)
                acc = _fold(acc, (e.feats.rmatvec(u), torch.sum(u)))
        g_raw, su = acc
        return self._finish_grad(g_raw, su, coef, l2)

    def curvature_list(self, z_list: Sequence[Tensor]) -> List[Tensor]:
        """d2_i = w_i l''(z_i, y_i) per shard — computed once per TRON
        outer iteration, row-space resident for the inner CG."""
        d2 = self.objective.loss.d2
        return [e.weights * d2(z, e.labels)
                for e, z in zip(self.cache.entries, z_list)]

    def hessian_vector(self, vec: Tensor, d2_list: Sequence[Tensor],
                       l2) -> Tensor:
        """H @ vec with precomputed curvature: one matvec + one rmatvec
        per shard (the streaming form of
        GLMObjective.hessian_vector_from_margins)."""
        acc = None
        with span("accumulate"):
            for e, d2 in zip(self.cache.blocks(), d2_list):
                self._require_restored(e)
                jv = self.objective.margin_direction(
                    vec, GLMBatch(e.feats, e.labels, e.offsets, e.weights))
                t = d2 * jv
                acc = _fold(acc, (e.feats.rmatvec(t), torch.sum(t)))
        r_raw, su = acc
        return self._finish_grad(r_raw, su, vec, l2)

    def host_scores_from_margins(self, z_list: Sequence[Tensor]):
        """Host training scores (offsets taken back out) in the fixed
        shard order, i.e. the original row order, from a solver's final
        per-shard margins: no scoring feature pass."""
        import numpy as np

        if len(z_list) != len(self.cache.entries):
            raise ValueError(
                f"margin list has {len(z_list)} shards, cache has "
                f"{len(self.cache.entries)} — not this objective's "
                "margins?")
        parts = [(z - e.offsets).detach().cpu().numpy()[:e.n_rows]
                 for e, z in zip(self.cache.entries, z_list)]
        return np.concatenate(parts) if parts else np.zeros(0)

    # -- the batched λ grid: per-shard grid partials ----------------------

    def _grid_norm_prep(self, coefs: Tensor):
        """Per-row (effective coefficients, margin shift [G, 1])."""
        norm = self.objective.normalization
        if norm is None:
            return coefs, None
        eff = torch.stack([norm.effective_coefficients(c) for c in coefs])
        shift = torch.stack([norm.margin_shift(c) for c in coefs])
        return eff, shift[:, None]

    def _grid_margins(self, e, coefs: Tensor) -> Tensor:
        """[G, rows] margins X c_g + offsets (+ shift_g): the scalar
        ``GLMObjective.margins`` per lane, the product through row 10."""
        eff, shift = self._grid_norm_prep(coefs)
        z = e.feats.matmat(eff.T.contiguous()).T + e.offsets[None, :]
        return z if shift is None else z + shift

    def _grid_rmatmat(self, e, u: Tensor) -> Tensor:
        """[G, d] X^T u_g for [G, rows] lanes, through row 10."""
        return e.feats.rmatmat(u.T.contiguous()).T

    def _grid_init(self, e, coefs: Tensor):
        loss = self.objective.loss
        z = self._grid_margins(e, coefs)
        val = torch.sum(e.weights[None, :] * loss.loss(z, e.labels[None, :]),
                        dim=-1)
        u = e.weights[None, :] * loss.d1(z, e.labels[None, :])
        return z, (val, self._grid_rmatmat(e, u), torch.sum(u, dim=-1))

    def _grid_direction(self, e, directions: Tensor) -> Tensor:
        """margins(p) - offsets per lane, as margin_direction writes it."""
        return self._grid_margins(e, directions) - e.offsets[None, :]

    def _grid_trial(self, z, zp, labels, weights, ts):
        """[G, K] weighted-loss sums at z_g + t_gk zp_g."""
        z_t = z[:, None, :] + ts[:, :, None] * zp[:, None, :]
        return (torch.sum(weights[None, None, :] * self.objective.loss.loss(
            z_t, labels[None, None, :]), dim=-1),)

    def _grid_grad(self, e, z):
        u = e.weights[None, :] * self.objective.loss.d1(z, e.labels[None, :])
        return self._grid_rmatmat(e, u), torch.sum(u, dim=-1)

    def _grid_hvp(self, e, d2, vecs):
        t = d2 * self._grid_direction(e, vecs)
        return self._grid_rmatmat(e, t), torch.sum(t, dim=-1)

    @staticmethod
    def _grid_axpy(a: Tensor, t: Tensor, b: Tensor) -> Tensor:
        # Frozen rows carry t == 0 and must keep their margins bit for
        # bit: a + 0*b is not an identity (-0.0 + 0.0 is +0.0, and a
        # non-finite b would poison the row), so mask.
        return torch.where((t != 0.0)[:, None], a + t[:, None] * b, a)

    def _grid_finish_grad(self, g_raw: Tensor, su: Tensor, coefs: Tensor,
                          l2s: Tensor) -> Tensor:
        """Per-row normalization chain + L2 at the apex."""
        norm = self.objective.normalization
        r = g_raw
        if norm is not None:
            if norm.shifts is not None:
                r = r - su[:, None] * norm.shifts[None, :]
            if norm.factors is not None:
                r = r * norm.factors[None, :]
        return r + l2s[:, None] * coefs

    # -- grid passes ---------------------------------------------------------

    def grid_margins_value_grad(self, coefs: Tensor, l2s: Tensor
                                ) -> Tuple[List[Tensor], Tensor, Tensor]:
        """One feature pass for every grid row: per-shard [G, rows]
        margins, [G] values and [G, d] gradients."""
        self.grid_passes += 1
        _M_GRID_PASSES.inc()
        z_list: List[Tensor] = []
        acc = None
        with span("accumulate"):
            for e in self.cache.blocks():
                self._require_restored(e)
                z, part = self._grid_init(e, coefs)
                z_list.append(z)
                acc = _fold(acc, part)
        val, g_raw, su = acc
        f = val + 0.5 * l2s * torch.sum(coefs * coefs, dim=-1)
        return z_list, f, self._grid_finish_grad(g_raw, su, coefs, l2s)

    def grid_margin_direction_list(self, directions: Tensor) -> List[Tensor]:
        """Per-shard [G, rows] directional margins: one feature pass."""
        self.grid_passes += 1
        _M_GRID_PASSES.inc()
        out: List[Tensor] = []
        with span("accumulate"):
            for e in self.cache.blocks():
                self._require_restored(e)
                out.append(self._grid_direction(e, directions))
        return out

    def grid_trial_values(self, z_list: Sequence[Tensor],
                          zp_list: Sequence[Tensor], ts: Tensor,
                          coef_sq: Tensor, l2s: Tensor) -> Tensor:
        """[G, K] objective values at per-row step candidates ts [G, K]:
        row-space only, no feature pass."""
        acc = None
        for e, z, zp in zip(self.cache.entries, z_list, zp_list):
            acc = _fold(acc, self._grid_trial(z, zp, e.labels, e.weights,
                                              ts))
        return acc[0] + 0.5 * l2s[:, None] * coef_sq

    def grid_update_margins(self, z_list: Sequence[Tensor], t: Tensor,
                            zp_list: Sequence[Tensor]) -> List[Tensor]:
        """z + t*zp per shard with a per-row step [G]; rows with t == 0
        keep their margins bit for bit."""
        return [self._grid_axpy(z, t, zp) for z, zp in zip(z_list, zp_list)]

    def grid_grad_from_margins_list(self, coefs: Tensor,
                                    z_list: Sequence[Tensor],
                                    l2s: Tensor) -> Tensor:
        """[G, d] gradients from cached [G, rows] margins: one pass."""
        self.grid_passes += 1
        _M_GRID_PASSES.inc()
        acc = None
        with span("accumulate"):
            for e, z in zip(self.cache.blocks(), z_list):
                self._require_restored(e)
                acc = _fold(acc, self._grid_grad(e, z))
        g_raw, su = acc
        return self._grid_finish_grad(g_raw, su, coefs, l2s)

    def grid_curvature_list(self, z_list: Sequence[Tensor]) -> List[Tensor]:
        """Per-shard [G, rows] curvature: row-space, no feature pass."""
        d2 = self.objective.loss.d2
        return [e.weights[None, :] * d2(z, e.labels[None, :])
                for e, z in zip(self.cache.entries, z_list)]

    def grid_hessian_vector(self, vecs: Tensor, d2_list: Sequence[Tensor],
                            l2s: Tensor) -> Tensor:
        """[G, d] H_g v_g with per-row curvature: one pass serves every
        row's CG iterate."""
        self.grid_passes += 1
        _M_GRID_PASSES.inc()
        acc = None
        with span("accumulate"):
            for e, d2 in zip(self.cache.blocks(), d2_list):
                self._require_restored(e)
                acc = _fold(acc, self._grid_hvp(e, d2, vecs))
        r_raw, su = acc
        return self._grid_finish_grad(r_raw, su, vecs, l2s)

    @staticmethod
    def grid_row_margins(z_list: Sequence[Tensor], row: int
                         ) -> List[Tensor]:
        """One grid row's per-shard margins, scalar-shaped (for
        ``host_scores_from_margins``)."""
        return [z[row] for z in z_list]
