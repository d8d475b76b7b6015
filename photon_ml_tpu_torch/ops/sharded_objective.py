"""Sharded GLM objective: full-batch (value, gradient, Hessian-vector) by
accumulating per-shard partials over a device shard cache and, with a
mesh, over the slots of a 1-D or 2-D device mesh (port of
photon_ml_tpu/ops/sharded_objective.py: ShardedGLMObjective :276-423 with
its mesh validation :294-352 and gauges :161-164, the kit :424-497, the
folds _SingleFold/_OrderedFold/_LocalFold :173-240 and _ColFold
:242-273, the 2-D row and column kits :498-611 and grid twins :703-838,
_per_device :839-845, _dev_span :847-854, _new_fold :856-865, the 2-D
plumbing _put_col_slices/_chain_margins/_rmv_cols :888-943, the 2-D
passes :1254-1341 and the 2-D grid passes :1484-1569).

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

**Mesh (``mesh=``, a 1-D `parallel.Mesh`).** The cache must be placed on
the mesh's slot devices (``DeviceShardCache.from_stream(devices=...)``):
block i lives on slot i % N. Each block's partial is computed on its own
slot's device, the coefficient or direction put on each slot's device
once a pass (``_per_device``, the reference's coefficient broadcast);
row-space state (margins, directional margins, curvature) stays on each
block's device. ``combine`` picks the cross-device reduction:

- ``"ordered"`` (default): every partial moves to ``devices[0]`` and
  left-folds in GLOBAL SHARD ORDER: the single-device fold's additions,
  one for one, so the result is the same bits for every slot count
  (each slot's products are the same kernels on the same inputs).
- ``"local"``: each slot left-folds its own blocks in shard order on its
  device, then the slot partials left-fold in slot order on
  ``devices[0]`` (the depth-2 treeAggregate shape: N - 1 transfers a
  pass). It reassociates the same S addends into N round-robin groups,
  so it differs from "ordered" by at most (S - 1) eps sum_i |p_i|; it is
  deterministic for fixed (S, N) and IS "ordered" at N = 1.

A one-slot mesh (or none) is the single-device fold exactly. The batched
λ grid folds the same ways. Each slot's share of a pass is a
``device_fold:d<slot>`` span and each combine a ``cross_device_combine``
span (JAX's names); the registry gauge
``training.mesh.data_axis_devices`` holds the slot count and the counter
``training.mesh.data_axis_transfer_bytes`` the bytes of partials that
the folds moved to another device (none on a mesh of slots of one
card). Not ported: the JAX ``TracingGuard`` trace budgets
(``trace_budgets``, ``assert_trace_budget``; ROADMAP A7 — the port
compiles nothing per shape).

**2-D (data x model) mesh** (``parallel.make_mesh_2d(R, C)``, C > 1,
over a cache built with ``col_blocks=C``). Shard i's column slice c
lives on ``grid[i % R][c]`` and its row-space state (labels, margins,
curvature, the value and u partials) on the row's home slot
``grid[i % R][C - 1]`` (``ResidentBlock.slot``). A pass:

- puts the coefficient's (or direction's) column slices on the slots,
  1/C of it each (``_col_slices``; under normalization ``eff`` and the
  margin shift come from the same full-width calls as the 1-D path's,
  on the solver's device, ``devices[0]``);
- forms each slice's entry products on its slot (``spmv.
  entry_products``, a ``col_block_fold:c<c>`` span), moves them to the
  home slot, and sums them there through the product stream
  (``spmv.EntryStream``: rows 9 and 10 on the full rows' offsets and a
  map into the concatenated products). The JAX package chains
  per-block scatter-adds into the margin, whose bits rest on XLA's
  scatter adding in stream order; the port's row 9 sums a row in lanes
  set by its length, which a block's sub-row does not share, so the
  port moves the products instead of partial margins: the margin is the
  unblocked row's bits on the card. The price: each pass moves a
  shard's nnz products across the model axis, where JAX moves n_rows
  partial margins;
- sends u (or t) from the home slot to the column slots, each slice's
  transposed product there (whole features, so each is that slice of
  the unblocked rmatvec, bit for bit) folding per column in GLOBAL shard
  order on ``grid[0][c]`` (``_ColFold``, the ordered fold per
  coefficient slice), the C folded slices joined in column order on the
  solver's device (``torch.cat``: a ``model_axis_concat`` span; a
  concat adds nothing). The scalars (value, sum u) fold through the
  ordered data-axis fold.

So every shape {none, 1x1, 2x1, 1x2, 2x2} gives the same value,
gradient, Hvp and solve bits on the card (the CPU's plain products keep
no order, so there the shapes agree to rounding). ``combine="local"`` is
refused with C > 1, as in JAX. The registry gauge
``training.mesh.model_axis_devices`` holds C and the counter
``training.mesh.model_axis_transfer_bytes`` the bytes that the model
axis moved to another device (slices, products, u, the concat; none on
slots of one card).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Sequence, Tuple

import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.ops.glm_objective import GLMBatch, GLMObjective
from photon_ml_tpu_torch.ops.spmv import entry_products
from photon_ml_tpu_torch.telemetry import span

Tensor = torch.Tensor

#: One batched-grid feature pass (the registry twin of ``grid_passes``).
_M_GRID_PASSES = telemetry.counter("training.grid.feature_passes")
# Each axis's extent and the bytes its folds and hops move between
# devices (JAX :161-164).
_G_MESH_DATA = telemetry.gauge("training.mesh.data_axis_devices")
_G_MESH_MODEL = telemetry.gauge("training.mesh.model_axis_devices")
_M_DATA_XFER = telemetry.counter("training.mesh.data_axis_transfer_bytes")
_M_MODEL_XFER = telemetry.counter("training.mesh.model_axis_transfer_bytes")

_NULL_SPAN = contextlib.nullcontext()


def _fold(acc, part):
    """One step of the left-fold of per-shard partials (tuples of tensors)
    in fixed shard order: the JAX _SingleFold's association."""
    return part if acc is None else tuple(a + b for a, b in zip(acc, part))


def _move(part, device, counter=_M_DATA_XFER):
    """A partial (a tuple of tensors) on ``device``, counting the bytes
    that cross to another device."""
    moved = sum(t.numel() * t.element_size() for t in part
                if t.device != device)
    if moved:
        counter.inc(moved)
    return tuple(t.to(device) for t in part)


def _to_model(t: Tensor, device) -> Tensor:
    """``t`` on ``device`` across the model axis."""
    return _move((t,), device, _M_MODEL_XFER)[0]


class _SingleFold:
    """No mesh (or one slot): today's left-fold in shard order."""

    def __init__(self, devices=None):
        self.devices = devices
        self.acc = None

    def add(self, slot: int, part) -> None:
        self.acc = _fold(self.acc, part)

    def result(self):
        return self.acc


class _OrderedFold(_SingleFold):
    """The default mesh combine: each partial moves to ``devices[0]`` and
    left-folds in GLOBAL shard order, the single fold's additions."""

    def add(self, slot: int, part) -> None:
        with span("cross_device_combine"):
            self.acc = _fold(self.acc, _move(part, self.devices[0]))


class _LocalFold(_SingleFold):
    """Per-slot left-folds on each slot's device, in shard order, then
    the slot partials left-fold in slot order on ``devices[0]``."""

    def __init__(self, devices):
        super().__init__(devices)
        self.accs = [None] * len(devices)

    def add(self, slot: int, part) -> None:
        self.accs[slot] = _fold(self.accs[slot], part)

    def result(self):
        acc = None
        with span("cross_device_combine"):
            for part in self.accs:
                if part is not None:
                    acc = _fold(acc, _move(part, self.devices[0]))
        return acc


class _ColFold:
    """The 2-D combine of per-column [block_size] (or [block_size, G])
    partials: column c left-folds in GLOBAL shard order on its fold slot
    ``grid[0][c]`` (the ordered fold per coefficient slice), and
    ``result`` joins the C folded slices in column order on the solver's
    device, cut to the true width. A panel joins as [d, G] and comes
    back as its transpose: the [G, d] layout of the 1-D path's
    ``rmatmat(...).T`` partials, so the solver's reductions over it (a
    norm a row) walk the same memory order and keep their bits."""

    def __init__(self, sobj: "ShardedGLMObjective"):
        self.s = sobj
        self.cols = [None] * sobj.col_blocks

    def add(self, c: int, part: Tensor) -> None:
        with span("cross_device_combine"):
            (part,) = _move((part,), self.s.grid[0][c])
            self.cols[c] = part if self.cols[c] is None \
                else self.cols[c] + part

    def result(self) -> Tensor:
        with span("model_axis_concat"):
            dev0 = self.s.devices[0]
            joined = torch.cat([_to_model(p, dev0) for p in self.cols])
            joined = joined[:self.s.cache.n_features]
            return joined if joined.dim() == 1 else joined.T


class ShardedGLMObjective:
    """Streaming (value, gradient, Hvp) over a DeviceShardCache.

    ``objective`` supplies the loss and (optional) normalization context;
    row-space solver state (margins, direction margins, curvature) lives
    as per-shard lists aligned with the cache's fixed shard order and is
    always resident, on each shard's own slot device — the feature blocks
    are the only thing the cache may spill, which keeps the margin-cached
    L-BFGS line search free of feature passes (optimization/glm_lbfgs.py).

    ``mesh`` (a 1-D or 2-D `parallel.Mesh`) folds over the slots of a
    cache placed on the same devices (with ``col_blocks`` the mesh's
    model extent); ``combine`` is "ordered" or "local" (module
    docstring)."""

    def __init__(self, objective: GLMObjective, cache, mesh=None,
                 combine: str = "ordered"):
        if combine not in ("ordered", "local"):
            raise ValueError(
                f"combine must be 'ordered' or 'local', got {combine!r}")
        self.combine = combine
        devices, grid, col_blocks = None, None, 1
        if mesh is not None:
            from photon_ml_tpu_torch.parallel.distributed import mesh_grid_2d

            n_data, n_model, g2d = mesh_grid_2d(mesh)
            if n_data * n_model > 1:
                devices = [d for row in g2d for d in row]
                grid, col_blocks = g2d, n_model
        self.mesh = mesh if devices is not None else None
        self.devices = devices
        self.grid = grid
        self.col_blocks = col_blocks
        self.data_rows = 1 if devices is None else len(devices) // col_blocks
        cache_devs = getattr(cache, "devices", None)
        if devices is not None:
            if cache_devs is None or list(cache_devs) != list(devices):
                raise ValueError(
                    "mesh-sharded objective needs a cache placed on the "
                    f"same devices: mesh has {devices}, cache has "
                    f"{cache_devs} — build the DeviceShardCache with "
                    "devices=mesh_device_list(mesh)")
        elif cache_devs is not None:
            raise ValueError(
                f"cache is placed on {len(cache_devs)} mesh devices but "
                "the objective was built without a mesh — pass "
                "mesh=make_mesh(len(cache.devices))")
        cache_cols = int(getattr(cache, "col_blocks", 1) or 1)
        if cache_cols != col_blocks:
            raise ValueError(
                f"cache was built with col_blocks={cache_cols} but the "
                f"mesh has {col_blocks} model-axis devices — build the "
                "DeviceShardCache with col_blocks matching the mesh's "
                "model extent")
        if col_blocks > 1 and combine != "ordered":
            raise ValueError(
                "combine='local' is not supported with a model axis "
                "(col_blocks > 1): per-column partials fold in ordered "
                "shard order only — use combine='ordered' or a 1-D mesh")
        if devices is not None:
            _G_MESH_DATA.set(self.data_rows)
            _G_MESH_MODEL.set(col_blocks)
        self.block_size = cache.col_block_size if col_blocks > 1 else 0
        self.objective = objective
        self.cache = cache
        self.grid_passes = 0
        # The objective on each slot's device (its normalization vectors
        # moved there), so a slot's kernels read only its own device; a
        # 2-D mesh applies the normalization on the solver's device only.
        norm = objective.normalization
        slots = devices if col_blocks == 1 else (devices or [])[:1]
        self._objs = ([objective] if devices is None or norm is None
                      else [dataclasses.replace(objective,
                                                normalization=norm.to(d))
                            for d in slots])

    # -- mesh plumbing -------------------------------------------------------

    def _per_device(self, x) -> list:
        """``x`` on every slot's device, once a pass: the coefficient
        broadcast. Without a mesh the value is used as it is."""
        if self.devices is None or not isinstance(x, Tensor):
            return [x] * (1 if self.devices is None else len(self.devices))
        return [x.to(d) for d in self.devices]

    def _obj(self, slot: int) -> GLMObjective:
        return self._objs[slot if len(self._objs) > 1 else 0]

    def _dev_span(self, slot: int):
        """A slot's share of a pass (mesh only), as JAX names it."""
        if self.devices is None:
            return _NULL_SPAN
        return span(f"device_fold:d{slot}")

    def _new_fold(self):
        if self.devices is None:
            return _SingleFold()
        if self.combine == "ordered":
            return _OrderedFold(self.devices)
        return _LocalFold(self.devices)

    # -- per-shard partials (the JAX single-device kit) ---------------------

    def _init(self, e, coef: Tensor):
        """Margins + value partial + raw-gradient partial, one pass."""
        obj = self._obj(e.slot)
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
        """A feature block (every column slice of it) must reach the
        accumulate in the cache's type: a spill encoding leaking past
        `restore_spilled_features` would otherwise accumulate at the
        wrong precision."""
        for feats in block.cols or (block.feats,):
            got = feats.values.dtype
            if got != self.cache.dtype:
                raise TypeError(
                    f"feature block {block.index} reached the sharded "
                    f"accumulate as {got}, expected {self.cache.dtype} — "
                    "spill codecs must restore through data/shard_cache.py "
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

    def _pass(self, fn, vec=None, z_list=None):
        """One feature pass in shard order: ``fn(e, vec_on_slot, z)`` per
        block returns (row-space output or None, partial); partials fold
        as the mesh's combine folds them. Returns (outputs, folded)."""
        fold = self._new_fold()
        outs: List[Tensor] = []
        with span("accumulate"):
            vecs = self._per_device(vec)
            zs = z_list if z_list is not None else [None] * self.cache.n_shards
            for e, z in zip(self.cache.blocks(), zs):
                self._require_restored(e)
                with self._dev_span(e.slot):
                    out, part = fn(e, vecs[e.slot], z)
                if out is not None:
                    outs.append(out)
                if part is not None:
                    fold.add(e.slot, part)
        return outs, fold.result()

    def _row_fold(self, fn, z_list, zp_list, ts):
        """A row-space pass (no feature block): ``fn(e, z, zp, ts)`` per
        shard, folded as ``_pass`` folds."""
        fold = self._new_fold()
        tss = self._per_device(ts)
        for e, z, zp in zip(self.cache.entries, z_list, zp_list):
            fold.add(e.slot, fn(e, z, zp, tss[e.slot]))
        return fold.result()

    # -- accumulation passes -----------------------------------------------

    def margins_value_grad(self, coef: Tensor, l2
                           ) -> Tuple[List[Tensor], Tensor, Tensor]:
        """One pass over the feature blocks: per-shard margins (kept as
        row-space state), the objective value and the gradient."""
        if self.col_blocks > 1:
            return self._margins_value_grad_2d(coef, l2)
        z_list, (val, g_raw, su) = self._pass(
            lambda e, c, _: self._init(e, c), coef)
        f = val + 0.5 * l2 * torch.dot(coef, coef)
        return z_list, f, self._finish_grad(g_raw, su, coef, l2)

    def value_and_grad(self, coef: Tensor, l2=0.0) -> Tuple[Tensor, Tensor]:
        _, f, g = self.margins_value_grad(coef, l2)
        return f, g

    def margin_direction_list(self, direction: Tensor) -> List[Tensor]:
        """Per-shard directional margins (one feature pass)."""
        if self.col_blocks > 1:
            return self._direction_2d(direction)
        out, _ = self._pass(lambda e, p, _: (
            self._obj(e.slot).margin_direction(
                p, GLMBatch(e.feats, e.labels, e.offsets, e.weights)),
            None), direction)
        return out

    def trial_values(self, z_list: Sequence[Tensor],
                     zp_list: Sequence[Tensor], ts: Tensor,
                     coef_sq: Tensor, l2) -> Tensor:
        """Objective values at the [K] line-search candidates — row-space
        only (margins are cached): NO feature pass, no spill traffic."""
        acc = self._row_fold(
            lambda e, z, zp, t: self._trial(z, zp, e.labels, e.weights, t),
            z_list, zp_list, ts)
        return acc[0] + 0.5 * l2 * coef_sq

    def update_margins(self, z_list: Sequence[Tensor], t,
                       zp_list: Sequence[Tensor]) -> List[Tensor]:
        """z + t*zp per shard — the accepted-step margin update (the
        expression the in-core solver applies to its whole margin
        vector)."""
        ts = self._per_device(t)
        return [z + ts[e.slot] * zp
                for e, z, zp in zip(self.cache.entries, z_list, zp_list)]

    def grad_from_margins_list(self, coef: Tensor,
                               z_list: Sequence[Tensor], l2) -> Tensor:
        """Gradient given cached margins: one rmatvec pass."""
        if self.col_blocks > 1:
            return self._grad_from_margins_2d(coef, z_list, l2)
        loss = self.objective.loss

        def part(e, _, z):
            u = e.weights * loss.d1(z, e.labels)
            return None, (e.feats.rmatvec(u), torch.sum(u))

        _, (g_raw, su) = self._pass(part, z_list=z_list)
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
        if self.col_blocks > 1:
            return self._hessian_vector_2d(vec, d2_list, l2)

        def part(e, v, d2):
            jv = self._obj(e.slot).margin_direction(
                v, GLMBatch(e.feats, e.labels, e.offsets, e.weights))
            t = d2 * jv
            return None, (e.feats.rmatvec(t), torch.sum(t))

        _, (r_raw, su) = self._pass(part, vec, d2_list)
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

    def _grid_norm_prep(self, coefs: Tensor, slot: int = 0):
        """Per-row (effective coefficients, margin shift [G, 1])."""
        norm = self._obj(slot).normalization
        if norm is None:
            return coefs, None
        eff = torch.stack([norm.effective_coefficients(c) for c in coefs])
        shift = torch.stack([norm.margin_shift(c) for c in coefs])
        return eff, shift[:, None]

    def _grid_margins(self, e, coefs: Tensor) -> Tensor:
        """[G, rows] margins X c_g + offsets (+ shift_g): the scalar
        ``GLMObjective.margins`` per lane, the product through row 10."""
        eff, shift = self._grid_norm_prep(coefs, e.slot)
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

    def _count_grid_pass(self) -> None:
        self.grid_passes += 1
        _M_GRID_PASSES.inc()

    # -- grid passes ---------------------------------------------------------

    def grid_margins_value_grad(self, coefs: Tensor, l2s: Tensor
                                ) -> Tuple[List[Tensor], Tensor, Tensor]:
        """One feature pass for every grid row: per-shard [G, rows]
        margins, [G] values and [G, d] gradients."""
        self._count_grid_pass()
        if self.col_blocks > 1:
            return self._margins_value_grad_2d(coefs, l2s)
        z_list, (val, g_raw, su) = self._pass(
            lambda e, c, _: self._grid_init(e, c), coefs)
        f = val + 0.5 * l2s * torch.sum(coefs * coefs, dim=-1)
        return z_list, f, self._grid_finish_grad(g_raw, su, coefs, l2s)

    def grid_margin_direction_list(self, directions: Tensor) -> List[Tensor]:
        """Per-shard [G, rows] directional margins: one feature pass."""
        self._count_grid_pass()
        if self.col_blocks > 1:
            return self._direction_2d(directions)
        out, _ = self._pass(
            lambda e, p, _: (self._grid_direction(e, p), None), directions)
        return out

    def grid_trial_values(self, z_list: Sequence[Tensor],
                          zp_list: Sequence[Tensor], ts: Tensor,
                          coef_sq: Tensor, l2s: Tensor) -> Tensor:
        """[G, K] objective values at per-row step candidates ts [G, K]:
        row-space only, no feature pass."""
        acc = self._row_fold(
            lambda e, z, zp, t: self._grid_trial(z, zp, e.labels,
                                                 e.weights, t),
            z_list, zp_list, ts)
        return acc[0] + 0.5 * l2s[:, None] * coef_sq

    def grid_update_margins(self, z_list: Sequence[Tensor], t: Tensor,
                            zp_list: Sequence[Tensor]) -> List[Tensor]:
        """z + t*zp per shard with a per-row step [G]; rows with t == 0
        keep their margins bit for bit."""
        ts = self._per_device(t)
        return [self._grid_axpy(z, ts[e.slot], zp)
                for e, z, zp in zip(self.cache.entries, z_list, zp_list)]

    def grid_grad_from_margins_list(self, coefs: Tensor,
                                    z_list: Sequence[Tensor],
                                    l2s: Tensor) -> Tensor:
        """[G, d] gradients from cached [G, rows] margins: one pass."""
        self._count_grid_pass()
        if self.col_blocks > 1:
            return self._grad_from_margins_2d(coefs, z_list, l2s)
        _, (g_raw, su) = self._pass(
            lambda e, _, z: (None, self._grid_grad(e, z)), z_list=z_list)
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
        self._count_grid_pass()
        if self.col_blocks > 1:
            return self._hessian_vector_2d(vecs, d2_list, l2s)
        _, (r_raw, su) = self._pass(
            lambda e, v, d2: (None, self._grid_hvp(e, d2, v)), vecs,
            d2_list)
        return self._grid_finish_grad(r_raw, su, vecs, l2s)

    # -- the 2-D (data x model) passes (module docstring) -------------------
    #
    # One body serves the scalar pass ([d] coefficients, [rows] margins)
    # and its grid twin ([G, d], [G, rows]): the same expressions as the
    # 1-D path's, with each product split over the column slices.

    def _col_slices(self, vec: Tensor) -> List[List[Tensor]]:
        """``out[r][c]``: column slice c of a [d] vector (or of a [G, d]
        panel, as [block_size, G]), its tail zero-padded, on
        ``grid[r][c]``."""
        bs, n_cols = self.block_size, self.col_blocks
        pad = n_cols * bs - vec.shape[-1]
        v = torch.nn.functional.pad(vec, (0, pad)) if pad else vec
        sl = [v[c * bs:(c + 1) * bs] if v.dim() == 1
              else v[:, c * bs:(c + 1) * bs].T for c in range(n_cols)]
        return [[_to_model(x, d) for x, d in zip(sl, row)]
                for row in self.grid]

    def _norm_2d(self, vec: Tensor):
        """(eff, margin shift or None) on the solver's device, from the
        calls the 1-D path makes (``GLMObjective.margins``)."""
        norm = self._objs[0].normalization
        if norm is None:
            return vec, None
        if vec.dim() == 2:
            return self._grid_norm_prep(vec, 0)
        return norm.effective_coefficients(vec), norm.margin_shift(vec)

    def _margins_2d(self, e, w_r, shift) -> Tensor:
        """The shard's margins X eff + offsets (+ shift) on its home slot:
        each slice's entry products on its slot, summed there through the
        product stream (row 9, or row 10 for a panel)."""
        home = e.labels.device
        parts = []
        for c, (blk, x) in enumerate(zip(e.cols, w_r)):
            with span(f"col_block_fold:c{c}"):
                parts.append(_to_model(entry_products(blk, x), home))
        if w_r[0].dim() == 1:
            z = e.stream.matvec(parts) + e.offsets
        else:
            z = e.stream.matmat(parts).T + e.offsets[None, :]
        return z if shift is None else z + _to_model(shift, home)

    def _rmv_2d(self, e, u: Tensor, fold: _ColFold) -> None:
        """u [rows] (or [G, rows]) from the home slot to the column
        slots, each slice's transposed product there into its column's
        fold."""
        r = e.slot // self.col_blocks
        for c, blk in enumerate(e.cols):
            u_c = _to_model(u, self.grid[r][c])
            with span(f"col_block_fold:c{c}"):
                part = (blk.rmatvec(u_c) if u.dim() == 1
                        else blk.rmatmat(u_c.T.contiguous()))
            fold.add(c, part)

    def _pass_2d(self, fn, vec=None, z_list=None):
        """One feature pass over the 2-D mesh in shard order: ``fn(e,
        slices of row r or None, z, column fold)`` per block returns
        (row-space output or None, scalar partial or None). Returns
        (outputs, folded scalars, joined column partials or None)."""
        sfold, colfold = self._new_fold(), _ColFold(self)
        outs: List[Tensor] = []
        with span("accumulate"):
            slices = None if vec is None else self._col_slices(vec)
            zs = z_list if z_list is not None else [None] * self.cache.n_shards
            for e, z in zip(self.cache.blocks(), zs):
                self._require_restored(e)
                w_r = None if slices is None \
                    else slices[e.slot // self.col_blocks]
                with self._dev_span(e.slot):
                    out, part = fn(e, w_r, z, colfold)
                if out is not None:
                    outs.append(out)
                if part is not None:
                    sfold.add(e.slot, part)
            joined = (colfold.result() if colfold.cols[0] is not None
                      else None)
        return outs, sfold.result(), joined

    def _sum(self, t: Tensor) -> Tensor:
        """A row-space sum, per lane for a [G, rows] panel."""
        return torch.sum(t) if t.dim() == 1 else torch.sum(t, dim=-1)

    def _finish_2d(self, g_raw, su, coef, l2):
        if coef.dim() == 1:
            return self._finish_grad(g_raw, su, coef, l2)
        return self._grid_finish_grad(g_raw, su, coef, l2)

    def _margins_value_grad_2d(self, coef: Tensor, l2):
        eff, shift = self._norm_2d(coef)
        loss = self.objective.loss

        def part(e, w_r, _, fold):
            z = self._margins_2d(e, w_r, shift)
            lab = e.labels if z.dim() == 1 else e.labels[None, :]
            wts = e.weights if z.dim() == 1 else e.weights[None, :]
            u = wts * loss.d1(z, lab)
            self._rmv_2d(e, u, fold)
            return z, (self._sum(wts * loss.loss(z, lab)), self._sum(u))

        z_list, (val, su), g_raw = self._pass_2d(part, eff)
        sq = (torch.dot(coef, coef) if coef.dim() == 1
              else torch.sum(coef * coef, dim=-1))
        return (z_list, val + 0.5 * l2 * sq,
                self._finish_2d(g_raw, su, coef, l2))

    def _direction_2d(self, direction: Tensor) -> List[Tensor]:
        eff, shift = self._norm_2d(direction)

        def part(e, w_r, _, fold):
            z = self._margins_2d(e, w_r, shift)
            return z - (e.offsets if z.dim() == 1 else e.offsets[None, :]), \
                None

        return self._pass_2d(part, eff)[0]

    def _grad_from_margins_2d(self, coef: Tensor, z_list, l2) -> Tensor:
        loss = self.objective.loss

        def part(e, _, z, fold):
            lab = e.labels if z.dim() == 1 else e.labels[None, :]
            wts = e.weights if z.dim() == 1 else e.weights[None, :]
            u = wts * loss.d1(z, lab)
            self._rmv_2d(e, u, fold)
            return None, (self._sum(u),)

        _, (su,), g_raw = self._pass_2d(part, z_list=z_list)
        return self._finish_2d(g_raw, su, coef, l2)

    def _hessian_vector_2d(self, vec: Tensor, d2_list, l2) -> Tensor:
        eff, shift = self._norm_2d(vec)

        def part(e, w_r, d2, fold):
            z = self._margins_2d(e, w_r, shift)
            t = d2 * (z - (e.offsets if z.dim() == 1
                           else e.offsets[None, :]))
            self._rmv_2d(e, t, fold)
            return None, (self._sum(t),)

        _, (su,), r_raw = self._pass_2d(part, eff, d2_list)
        return self._finish_2d(r_raw, su, vec, l2)

    @staticmethod
    def grid_row_margins(z_list: Sequence[Tensor], row: int
                         ) -> List[Tensor]:
        """One grid row's per-shard margins, scalar-shaped (for
        ``host_scores_from_margins``)."""
        return [z[row] for z in z_list]
