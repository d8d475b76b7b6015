"""Streamed alternating least squares for the GAME matrix-factorization
coordinate (port of photon_ml_tpu/ops/mf_alternating.py:109-734,
StreamedMFObjective).

The in-core factored coordinate holds every entity's observations on the
device. Here observations stream instead (ALX's sharded factor tables;
a streamed chunk pipeline for the observations):

- **Observations stream** through a ``make_stream`` factory (the
  driver's ``BlockGameStream``), re-decoded for every feature pass: host
  memory stays O(one batch). Row-space state (labels, offsets, weights,
  cached margins and the per-row factor gather ``[rows, k]``) stays on
  the device.
- **Factors live in a ``DeviceFactorCache``** (data/factor_cache.py):
  power-of-two observation-count shards, residency bounded by
  ``--hbm-budget``, spill tiers f32 / bf16 / redecode.
- **The γ half-step is exact ridge ALS**: per-entity normal equations
  ``(Σ w v vᵀ + λ₂ I) γ = Σ w (y - off) v`` with ``v = B x``. The sums
  over an entity's rows are the product of an entity x row CSR (value 1
  per observation) with a ``[rows, k² + k]`` panel of ``w v vᵀ`` and
  ``w (y - off) v``; batches fold into per-shard tables on the device in
  batch order (each batch's entities are distinct, so the fold is a
  gather, an add and a write: no atomics); then one batched solve per
  shard, in shard order. There is no warm start: a shard's factors are
  a pure function of (observations, B), which makes the redecode tier
  exact.
- **The B half-step reuses the streamed L-BFGS**: this object has the
  margin-cached surface of ``ShardedGLMObjective`` (margins_value_grad,
  margin_direction_list, trial_values, update_margins,
  grad_from_margins_list), so optimization/glm_lbfgs.py's
  ``minimize_lbfgs_glm_streaming`` drives the refit unchanged.

Every product with the features goes through ops/spmv.py's
``csr_matmul`` (row 10): V = X Bᵀ and a direction's margins with n = k,
the B gradient Xᵀ (u γ) with n = k, and the normal equations with
n = k² + k; on the card its sums run in a fixed order. The batched ridge
solve is ``torch.linalg.solve`` on ``[u, k, k]`` (a small dense solve,
outside any Pallas kernel in JAX too). So the factor and projection bits
are the same across factor-cache residency, spill tier f32 or redecode,
feeder and prefetch depth; bf16 rounds the factors once at write.

Batches are not padded: each keeps its true row and entry counts, so no
reduction runs over padding. The JAX ``TracingGuard`` budgets
(``trace_budgets``, ``assert_trace_budget``) have no counterpart until
ROADMAP A7: the port compiles nothing per shape. Every pass over the
observations is one ``accumulate`` span and each shard's ridge solve and
commit a ``factor_solve`` span (JAX :463-475, :577-678).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.data.factor_cache import (
    DeviceFactorCache,
    FactorPlan,
)
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.spmv import block_from_triplet, csr_matmul
from photon_ml_tpu_torch.telemetry import span

Tensor = torch.Tensor


@dataclasses.dataclass
class _BatchGeom:
    """One streamed batch's geometry and resident row-space state, set
    by the first pass and checked against every later one."""

    index: int
    row_offset: int
    n_rows: int
    nnz: int
    labels: Tensor
    offsets_raw: Tensor
    weights: Tensor
    # The entity x row CSR of the batch's distinct entities (rows in
    # entity order, value 1): the normal equations' segment sum.
    seg_crow: Tensor
    seg_rows: Tensor
    seg_ones: Tensor
    # Per factor shard touched: (positions among the distinct entities,
    # slots within the shard), device int64.
    fold: Dict[int, tuple]
    n_uniq: int


class StreamedMFObjective:
    """Streamed MF state and products for ONE factored coordinate.

    ``make_stream`` is a zero-argument callable returning a fresh
    iterable of GameDataset batches (any deterministic replayable source
    in tests). ``random_access`` is an optional ``fetch(row_start,
    n_rows) -> GameDataset`` (``BlockRandomAccess``) the redecode tier
    uses to re-fetch only a shard's covering batches; without it the
    tier replays the whole stream and skips the others."""

    def __init__(self, make_stream: Callable, feature_shard_id: str,
                 random_effect_type: str, plan: FactorPlan,
                 cache: DeviceFactorCache, n_features: int,
                 loss: PointwiseLoss, random_access: Optional[Callable] = None,
                 dtype=torch.float32, device="cuda"):
        if cache.plan is not plan:
            raise ValueError("cache must be built over the same FactorPlan")
        self.make_stream = make_stream
        self.shard_id = feature_shard_id
        self.re_type = random_effect_type
        self.plan = plan
        self.cache = cache
        self.k = cache.k
        self.d = int(n_features)
        self.loss = loss
        self.random_access = random_access
        self.dtype = dtype
        self.device = torch.device(device)
        self.n_rows = 0  # settled by the first pass
        self._geoms: Optional[List[_BatchGeom]] = None
        self._G: Optional[Tensor] = None  # [n_rows, k] row-space gather
        self._shard_rows: Dict[int, tuple] = {}  # shard -> (rows, slots)
        self._touch: Dict[int, List[int]] = {}  # shard -> batch indices
        self._B_sweep: Optional[Tensor] = None  # the γ pass's B
        self._l2_sweep = None
        self._res: Optional[Tensor] = None  # residual scores [n_rows]

    # -- tensors and products ---------------------------------------------

    def _col(self, x) -> Tensor:
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    def _idx(self, x) -> Tensor:
        return torch.as_tensor(np.asarray(x, np.int64), device=self.device)

    def _block(self, mat, geom: _BatchGeom):
        """The CSR block (and its transpose) of one decoded batch."""
        mat = mat.tocsr()
        mat.sort_indices()
        if mat.shape[0] != geom.n_rows or int(mat.nnz) != geom.nnz:
            raise RuntimeError(
                f"streamed batch {geom.index} does not match the geometry "
                f"pass ({mat.shape[0]} rows/{mat.nnz} nnz vs "
                f"{geom.n_rows}/{geom.nnz}) — the input changed under "
                "the objective")
        rows = np.repeat(np.arange(geom.n_rows, dtype=np.int32),
                         np.diff(mat.indptr))
        return block_from_triplet(
            self._col(mat.data),
            torch.as_tensor(mat.indices.astype(np.int32), device=self.device),
            torch.as_tensor(rows, device=self.device), geom.n_rows, self.d)

    @staticmethod
    def _v_of(block, B: Tensor) -> Tensor:
        """[rows, k] latent projections V = X Bᵀ (row 10, n = k)."""
        return block.matmat(B.T.contiguous())

    def _g_rows(self, G: Tensor, geom: _BatchGeom) -> Tensor:
        return G[geom.row_offset:geom.row_offset + geom.n_rows]

    def _normals(self, geom: _BatchGeom, block, offsets: Tensor,
                 B: Tensor):
        """Per-entity normal-equation partials of one batch: A [u, k, k],
        b [u, k], the segment sum as the entity x row CSR times the
        [rows, k² + k] panel (row 10)."""
        k = self.k
        v = self._v_of(block, B)
        t = geom.labels - offsets
        a_rows = geom.weights[:, None, None] * v[:, :, None] * v[:, None, :]
        b_rows = (geom.weights * t)[:, None] * v
        panel = torch.cat([a_rows.reshape(-1, k * k), b_rows], dim=1)
        out = csr_matmul(geom.seg_crow, geom.seg_rows, geom.seg_ones,
                         panel.contiguous(), geom.n_rows)
        return out[:, :k * k].reshape(-1, k, k), out[:, k * k:]

    def _u_grad(self, block, u: Tensor, g_rows: Tensor) -> Tensor:
        """[k, d] B gradient partial Σ_i u_i γ_i x_iᵀ = (Xᵀ (u γ))ᵀ."""
        return block.rmatmat((u[:, None] * g_rows).contiguous()).T

    # -- streaming geometry -------------------------------------------------

    def _ensure_built(self) -> None:
        """One decode pass that settles batch shapes, the resident row
        columns, the entity routing and the row-space factor gather.
        Feature triplets are not kept: every later pass re-decodes."""
        if self._geoms is not None:
            return
        geoms: List[_BatchGeom] = []
        route: Dict[int, List] = {}
        row_offset = 0
        for ds in self.make_stream():
            if ds.num_rows == 0:
                continue
            geoms.append(self._build_geom(len(geoms), row_offset, ds,
                                          route))
            row_offset += ds.num_rows
        if not geoms:
            raise ValueError("stream yielded no rows to train on")
        self._geoms = geoms
        self.n_rows = row_offset
        self._G = torch.zeros((row_offset, self.k), dtype=self.dtype,
                              device=self.device)
        for spec in self.plan.shards:
            parts = route.get(spec.index, [])
            rows = (np.concatenate([p[0] for p in parts]) if parts
                    else np.zeros(0, np.int64))
            slots = (np.concatenate([p[1] for p in parts]) if parts
                     else np.zeros(0, np.int64))
            self._shard_rows[spec.index] = (self._idx(rows),
                                            self._idx(slots))

    def _build_geom(self, index: int, row_offset: int, ds,
                    route: Dict[int, List]) -> _BatchGeom:
        n = ds.num_rows
        col = ds.id_columns.get(self.re_type)
        if col is None:
            raise ValueError(
                f"stream batches carry no {self.re_type!r} id column — "
                "pass id_types=[random_effect_type] to the stream")
        codes = self.plan.codes_of(col.vocabulary[col.codes])
        if (codes < 0).any():
            raise RuntimeError(
                f"batch {index} carries entities unseen at planning "
                "time — the input changed under the objective")
        uniq, inv = np.unique(codes, return_inverse=True)
        order = np.argsort(inv, kind="stable")
        seg_crow = np.zeros(len(uniq) + 1, np.int32)
        seg_crow[1:] = np.cumsum(np.bincount(inv, minlength=len(uniq)))
        uniq_shards = self.plan.shard_of_code[uniq]
        uniq_slots = self.plan.slot_of_code[uniq]
        fold = {}
        for s in np.unique(uniq_shards):
            pos = np.flatnonzero(uniq_shards == s)
            fold[int(s)] = (self._idx(pos), self._idx(uniq_slots[pos]))
            self._touch.setdefault(int(s), []).append(index)
        rows_glob = row_offset + np.arange(n, dtype=np.int64)
        shard_per_row = self.plan.shard_of_code[codes]
        slot_per_row = self.plan.slot_of_code[codes]
        for s in np.unique(shard_per_row):
            mask = shard_per_row == s
            route.setdefault(int(s), []).append(
                (rows_glob[mask], slot_per_row[mask]))
        return _BatchGeom(
            index=index, row_offset=row_offset, n_rows=n,
            nnz=int(ds.feature_shards[self.shard_id].nnz),
            labels=self._col(ds.responses), offsets_raw=self._col(ds.offsets),
            weights=self._col(ds.weights),
            seg_crow=torch.as_tensor(seg_crow, device=self.device),
            seg_rows=torch.as_tensor(order.astype(np.int32),
                                     device=self.device),
            seg_ones=torch.ones(n, dtype=self.dtype, device=self.device),
            fold=fold, n_uniq=len(uniq))

    def _feature_pass(self):
        """``(geom, block)`` per streamed batch, re-decoding the source
        on every call and checking each batch against the geometry."""
        self._ensure_built()
        count = 0
        for ds in self.make_stream():
            if ds.num_rows == 0:
                continue
            if count >= len(self._geoms):
                raise RuntimeError(
                    "stream yielded more batches than the geometry pass "
                    "— the input changed under the objective")
            geom = self._geoms[count]
            yield geom, self._block(ds.feature_shards[self.shard_id], geom)
            count += 1
        if count != len(self._geoms):
            raise RuntimeError(
                "stream yielded fewer batches than the geometry pass — "
                "the input changed under the objective")

    # -- residual (coordinate-descent offsets) -------------------------------

    def set_residual(self, residual_scores) -> None:
        """Install the coordinate-descent residual ([n_rows] scores of
        the other coordinates) for later passes; None clears it."""
        if residual_scores is None:
            self._res = None
            return
        res = torch.as_tensor(residual_scores, dtype=self.dtype,
                              device=self.device).reshape(-1)
        if self.n_rows and res.shape[0] != self.n_rows:
            raise ValueError(
                f"residual has {res.shape[0]} rows, stream has "
                f"{self.n_rows}")
        self._res = res

    def _offsets(self, geom: _BatchGeom) -> Tensor:
        if self._res is None:
            return geom.offsets_raw
        return geom.offsets_raw + self._res[
            geom.row_offset:geom.row_offset + geom.n_rows]

    # -- the γ half-step --------------------------------------------------------

    def gamma_pass(self, B: Tensor, l2_gamma: float) -> None:
        """One sweep's factor update: stream the observations once,
        folding per-entity normal equations into per-shard tables in
        batch order, then solve and commit each shard in shard order
        (batched ridge solve -> cache write -> row-space scatter)."""
        B = torch.as_tensor(B, dtype=self.dtype, device=self.device)
        tabs: Dict[int, tuple] = {}
        with span("accumulate"):
            for geom, block in self._feature_pass():
                a_u, b_u = self._normals(geom, block, self._offsets(geom),
                                         B)
                self._add_normals(geom, a_u, b_u, tabs, only_shard=None)
        self._B_sweep, self._l2_sweep = B, float(l2_gamma)
        if self.cache.spill_source == "redecode":
            self.cache.set_redecode(self._redecode_gamma)
        for spec in self.plan.shards:
            with span("factor_solve"):
                gamma = self.cache.write(spec.index, self._solve_shard(
                    spec, tabs.get(spec.index), self._l2_sweep))
                # The cache's copy (rounded at write in a bf16 train)
                # feeds both the model and the refit's row gather.
                rows, slots = self._shard_rows[spec.index]
                self._G[rows] = gamma[slots]

    def _add_normals(self, geom: _BatchGeom, a_u: Tensor, b_u: Tensor,
                     tabs: Dict, only_shard: Optional[int]) -> None:
        for s, (pos, slots) in geom.fold.items():
            if only_shard is not None and s != only_shard:
                continue
            if s not in tabs:
                e_pad = self.plan.shards[s].e_pad
                tabs[s] = (torch.zeros((e_pad, self.k, self.k),
                                       dtype=self.dtype, device=self.device),
                           torch.zeros((e_pad, self.k), dtype=self.dtype,
                                       device=self.device))
            a_t, b_t = tabs[s]
            # Distinct slots within a batch: a gather, an add, a write.
            a_t[slots] = a_t[slots] + a_u[pos]
            b_t[slots] = b_t[slots] + b_u[pos]

    def _solve_shard(self, spec, tab: Optional[tuple], l2: float) -> Tensor:
        """(A + λ₂ I)⁻¹ b per entity of the shard: strictly convex for
        λ₂ > 0, so entities without observations solve to zero."""
        if tab is None:
            return torch.zeros((spec.e_pad, self.k), dtype=self.dtype,
                               device=self.device)
        a_t, b_t = tab
        eye = torch.eye(self.k, dtype=self.dtype, device=self.device)
        return torch.linalg.solve(a_t + l2 * eye, b_t[..., None])[..., 0]

    def _redecode_gamma(self, index: int) -> Tensor:
        """The redecode tier's miss path: re-derive one shard from its
        covering batches against the sweep's B, through the same
        products in the same fold order: the evicted bits."""
        if self._B_sweep is None:
            raise RuntimeError("redecode requested before any gamma pass")
        touching = sorted(set(self._touch.get(index, ())))
        if self.random_access is not None:
            batches = ((bi, self.random_access(
                self._geoms[bi].row_offset, self._geoms[bi].n_rows))
                for bi in touching)
        else:
            batches = ((bi, ds) for bi, ds in enumerate(
                d for d in self.make_stream() if d.num_rows)
                if bi in touching)
        tabs: Dict[int, tuple] = {}
        for bi, ds in batches:
            geom = self._geoms[bi]
            block = self._block(ds.feature_shards[self.shard_id], geom)
            a_u, b_u = self._normals(geom, block, self._offsets(geom),
                                     self._B_sweep)
            self._add_normals(geom, a_u, b_u, tabs, only_shard=index)
        return self._solve_shard(self.plan.shards[index], tabs.get(index),
                                 self._l2_sweep)

    # -- the B half-step: the streamed L-BFGS surface -----------------------
    # coef is vec(B) [k d]; margins are affine in B (z = γᵀ B x + off), so
    # the margin-cached line search carries over.

    def margins_value_grad(self, coef: Tensor, l2):
        B = coef.reshape(self.k, self.d)
        z_list: List[Tensor] = []
        acc = None
        with span("accumulate"):
            for geom, block in self._feature_pass():
                g_rows = self._g_rows(self._G, geom)
                z = (torch.sum(self._v_of(block, B) * g_rows, dim=-1)
                     + self._offsets(geom))
                val = torch.sum(geom.weights
                                * self.loss.loss(z, geom.labels))
                u = geom.weights * self.loss.d1(z, geom.labels)
                part = (val, self._u_grad(block, u, g_rows))
                z_list.append(z)
                acc = part if acc is None else (acc[0] + part[0],
                                                acc[1] + part[1])
        val, g = acc
        f = val + 0.5 * l2 * torch.dot(coef, coef)
        return z_list, f, g.reshape(-1) + l2 * coef

    def value_and_grad(self, coef: Tensor, l2=0.0):
        _, f, g = self.margins_value_grad(coef, l2)
        return f, g

    def margin_direction_list(self, direction: Tensor) -> List[Tensor]:
        d_mat = direction.reshape(self.k, self.d)
        with span("accumulate"):
            return [torch.sum(self._v_of(block, d_mat)
                              * self._g_rows(self._G, geom), dim=-1)
                    for geom, block in self._feature_pass()]

    def trial_values(self, z_list: Sequence[Tensor],
                     zp_list: Sequence[Tensor], ts: Tensor, coef_sq, l2):
        """Row-space only: the Armijo sweep costs no feature pass."""
        acc = None
        with span("accumulate"):
            for geom, z, zp in zip(self._geoms, z_list, zp_list):
                z_t = z[None, :] + ts[:, None] * zp[None, :]
                part = torch.sum(geom.weights[None, :] * self.loss.loss(
                    z_t, geom.labels[None, :]), dim=-1)
                acc = part if acc is None else acc + part
        return acc + 0.5 * l2 * coef_sq

    def update_margins(self, z_list: Sequence[Tensor], t,
                       zp_list: Sequence[Tensor]) -> List[Tensor]:
        return [z + t * zp for z, zp in zip(z_list, zp_list)]

    def grad_from_margins_list(self, coef: Tensor,
                               z_list: Sequence[Tensor], l2) -> Tensor:
        acc = None
        with span("accumulate"):
            for (geom, block), z in zip(self._feature_pass(), z_list):
                u = geom.weights * self.loss.d1(z, geom.labels)
                part = self._u_grad(block, u, self._g_rows(self._G, geom))
                acc = part if acc is None else acc + part
        return acc.reshape(-1) + l2 * coef

    # -- scoring ---------------------------------------------------------------

    def gather_from_tables(self, tables: Sequence) -> Tensor:
        """The row-space gather of explicit per-shard factor tables
        ([n_entities, k] each, plan order): scoring a model must not read
        the solve state, which a later λ point may have overwritten."""
        self._ensure_built()
        if len(tables) != self.plan.n_shards:
            raise ValueError(
                f"expected {self.plan.n_shards} factor tables, got "
                f"{len(tables)}")
        g = torch.zeros_like(self._G)
        for spec, table in zip(self.plan.shards, tables):
            table = torch.as_tensor(table, dtype=self.dtype,
                                    device=self.device)
            if tuple(table.shape) != (spec.n_entities, self.k):
                raise ValueError(
                    f"factor table {spec.index} has shape "
                    f"{tuple(table.shape)}, expected "
                    f"{(spec.n_entities, self.k)}")
            rows, slots = self._shard_rows[spec.index]
            g[rows] = table[slots]
        return g

    def score_pass(self, B, tables: Optional[Sequence] = None
                   ) -> np.ndarray:
        """Raw margins γᵀ B x per row (offsets excluded), one streamed
        pass; ``tables`` scores an explicit model, None the latest
        solve's gather."""
        B = torch.as_tensor(B, dtype=self.dtype, device=self.device)
        g = self._G if tables is None else self.gather_from_tables(tables)
        out = np.zeros(self.n_rows, np.dtype(str(self.dtype)[6:]))
        with span("accumulate"):
            for geom, block in self._feature_pass():
                z = torch.sum(self._v_of(block, B) * self._g_rows(g, geom),
                              dim=-1)
                out[geom.row_offset:geom.row_offset + geom.n_rows] = \
                    z.cpu().numpy()
        return out

    def factor_tables(self) -> List[Tensor]:
        """Per-shard factor tables at their true entity counts, read
        through the cache in shard order (misses restore or re-derive)."""
        return [self.cache.ensure(spec.index)[:spec.n_entities]
                for spec in self.plan.shards]
