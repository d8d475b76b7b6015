"""Coordinates: the per-block solvers of GAME coordinate descent (port of
photon_ml_tpu/algorithm/coordinates.py: Coordinate :48,
FixedEffectCoordinate :122, RandomEffectCoordinate :544,
_gather_block_normalization :687, _gather_block_bounds :704-721,
StreamingFixedEffectCoordinate :281-425, grid_batchable :426-460,
solve_fixed_effect_grid :461-543,
StreamingFactoredRandomEffectCoordinate :739-970 with its ``factor_plan``
span :841 and per-sweep trace contexts :915-972,
FactoredRandomEffectCoordinate :978-1120, _solve_factored_block
:1120-1157, _flatten_factored_static :1159, _flatten_gammas :1176,
_solve_latent_matrix :1188 (a solve_glm call), _dispatch_pallas_solver
:1207, _shard_re_dataset :722-735 and _shard_mapped_pallas_solver
:1234-1266 (one loop over each bucket's mesh slots here; on a 2-D
mesh over its data rows), FixedEffectCoordinate's feature sharding
(``feature_sharding``, ``_pad_d``, :136-193),
_solve_block :1371, _solve_fixed :1442, _fe_score_impl :1474 and
_re_score_impl / _fre_score_impl :1484-1514 (``_slot_scores``), the size
guard of _use_pallas_entity_solver :1294-1366, which the kernel makes
unnecessary by taking any bucket).

Each coordinate solves against offsets augmented with the other
coordinates' scores (reference: ml/algorithm/Coordinate.scala:26-82).
Scores are raw margins x.coef; offsets are not included. Models live in
the original feature space; with a NormalizationContext the solve runs
in the normalized space (warm start converted in, solution converted
out) and the penalties are taken there.

- FixedEffectCoordinate: one GLM solve over the whole shard
  (optimization/solver.py: TRON, OWL-QN, the margin-cached L-BFGS, or
  the projected L-BFGS with bounds), normalization as objective-level
  algebra.
- StreamingFixedEffectCoordinate: the same GLM solve, accumulated shard
  by shard over a device shard cache (data/shard_cache.py,
  ops/sharded_objective.py) by the host-driven streaming L-BFGS or TRON,
  for training data larger than device memory (``--hbm-budget``).
- StreamingFactoredRandomEffectCoordinate: matrix factorization for
  factor tables larger than device memory: streamed ridge ALS for the
  factors (ops/mf_alternating.py, data/factor_cache.py) and the streaming
  L-BFGS for the projection B.
- RandomEffectCoordinate: one batched per-entity solve per bucket, mode
  "tron" for a TRON configuration, else "owlqn" when the L1 weight is
  positive, else "lbfgs", with the normalization and the bounds gathered
  per block into each entity's local feature space at construction. On
  CUDA tensors every bucket goes to the entity-solver kernel, whatever
  its n_pad and d_pad (the kernel keeps an entity too tall for shared
  memory in device memory, where the JAX package's VMEM guard routes it
  off the Pallas kernel). On CPU tensors the wrapper runs the plain
  solver.

Box constraints (``lower_bounds``/``upper_bounds``, [d] in the
coordinate's global feature space, +-inf where free) clamp the
solve-space coefficients as they are, with no space conversion: with a
normalization they bound the normalized iterate, as the reference's
projected Breeze iterate is the normalized vector (LBFGS.scala:77,
OptimizationUtils.scala:53).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.normalization import (
    NormalizationContext,
    gather_normalization,
    gathered_to_normalized_space,
    gathered_to_original_space,
)
from photon_ml_tpu_torch.data.random_effect import (
    EntityBlock,
    RandomEffectDataset,
    ShardedEntityBlock,
)
from photon_ml_tpu_torch.data.sampling import down_sample_weights
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.factored_random_effect import (
    FactoredRandomEffectModel,
)
from photon_ml_tpu_torch.models.fixed_effect import FixedEffectModel
from photon_ml_tpu_torch.models.glm import model_for_task
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.ops.entity_solver import (
    check_mode,
    entity_lbfgs,
    prepare_launch,
)
from photon_ml_tpu_torch.ops.features import KroneckerFeatures
from photon_ml_tpu_torch.ops.glm_objective import GLMBatch, GLMObjective
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.optimization.config import (
    GLMOptimizationConfiguration,
    MFOptimizationConfiguration,
    OptimizerType,
)
from photon_ml_tpu_torch.optimization.convergence import OptimizerResult
from photon_ml_tpu_torch.optimization.solver import solve_glm
from photon_ml_tpu_torch.projector.projectors import ProjectionMatrix
from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


class Coordinate:
    """Interface: ``update_model(model, residual_scores, generator)`` ->
    (model, tracker), ``score(model)`` -> [n_rows] margins,
    ``initialize_model()``, and ``penalties(model)`` -> (coefficients,
    l1, l2) triples in the optimization space
    (CoordinateDescent.scala:203-212).

    The pure interface under it (JAX coordinates.py:88-120) works on a
    model's parameters, a list of tensors: ``params_of(model)``,
    ``model_of(params, model)``, ``pure_update(params, residual,
    weights)`` -> (params, tracker), ``pure_score(params)`` and
    ``pure_penalties(params)``. It makes no model objects and reads
    nothing back, so coordinate descent records a whole update into one
    CUDA graph (algorithm/coordinate_descent.py). ``sample_weights``
    draws a down-sampled update's weights outside that graph (None: the
    update does not down-sample), and ``prepare_capture`` makes what a
    capture needs first (a kernel's plan, a product's scratch).
    ``update_model``, ``score`` and ``penalties`` are thin wrappers over
    it."""

    name: str

    def update_model(self, model, residual_scores: Optional[Tensor],
                     generator: Optional[torch.Generator] = None,
                     weights: Optional[Tensor] = None):
        """``weights``, when given, are the update's down-sampled
        weights, drawn before (coordinate descent draws them outside its
        update graph); else they are drawn from ``generator``."""
        if weights is None:
            weights = self.sample_weights(generator)
        params, tracker = self.pure_update(self.params_of(model),
                                           residual_scores, weights)
        return self.model_of(params, model), tracker

    def score(self, model) -> Tensor:
        return self.pure_score(self.params_of(model))

    def penalties(self, model) -> List[Tuple[Tensor, float, float]]:
        return self.pure_penalties(self.params_of(model))

    def initialize_model(self):
        raise NotImplementedError

    def params_of(self, model) -> List[Tensor]:
        raise NotImplementedError

    def model_of(self, params: List[Tensor], model):
        raise NotImplementedError

    def pure_update(self, params: List[Tensor],
                    residual_scores: Optional[Tensor],
                    weights: Optional[Tensor] = None):
        raise NotImplementedError

    def pure_score(self, params: List[Tensor]) -> Tensor:
        raise NotImplementedError

    def pure_penalties(self, params: List[Tensor]
                       ) -> List[Tuple[Tensor, float, float]]:
        raise NotImplementedError

    def sample_weights(self, generator: Optional[torch.Generator]
                       ) -> Optional[Tensor]:
        return None

    def prepare_capture(self) -> None:
        pass


@dataclasses.dataclass
class FixedEffectCoordinate(Coordinate):
    """Global GLM coordinate (ml/algorithm/FixedEffectCoordinate.scala).
    With ``mesh`` (a 1-D or 2-D `parallel.Mesh` whose first slot is
    ``device``) the batch's rows shard over the data axis's slots
    (``shard_batch``): every solver runs as it does, each feature product
    split over the slots and its [d] partials folded in slot order on
    devices[0]. The sums reassociate against the unsharded solve, as
    XLA's do under the JAX mesh.

    ``feature_sharding`` (with a mesh) shards the FEATURE dimension too
    (``shard_batch_feature_dim``): over the model axis of a 2-D mesh,
    rows over its data axis at the same time (dense features only: a
    CSR raises JAX's message), or over the one axis of a 1-D mesh (a CSR
    becomes ``BlockedCSRFeatures``, one column block a slot). The width
    is padded to C column blocks: coefficients, normalization (factor 1,
    shift 0) and bounds (+-inf) are padded into the solve and the score
    (``_pad_d``) and cut back after it, so models keep the true width
    and the padded coordinates stay exactly 0."""

    name: str
    data: GameDataset
    feature_shard_id: str
    task_type: TaskType
    config: GLMOptimizationConfiguration
    normalization: Optional[NormalizationContext] = None
    dtype: object = torch.float32
    device: object = "cuda"
    lower_bounds: Optional[object] = None  # [d], solve space
    upper_bounds: Optional[object] = None
    mesh: Optional[object] = None  # parallel.Mesh: shard rows over it
    feature_sharding: bool = False  # shard the features over the mesh

    def __post_init__(self):
        self.device = resolve_device(self.device)
        devs = _mesh_slots(self.mesh, self.device)
        self.device = devs[0]
        by_features = self.feature_sharding and self.mesh is not None
        sharded = len(devs) > 1 or (by_features and self.mesh.size > 1)
        # A sharded batch is built on the host and each slot uploads only
        # its share.
        self._batch = self.data.fixed_effect_batch(
            self.feature_shard_id, dtype=self.dtype,
            device="cpu" if sharded else self.device)
        self._d = self.data.feature_shards[self.feature_shard_id].shape[1]
        if by_features:
            from photon_ml_tpu_torch.parallel import (
                DATA_AXIS,
                MODEL_AXIS,
                shard_batch_feature_dim,
            )

            two_d = MODEL_AXIS in self.mesh.shape
            self._batch = shard_batch_feature_dim(
                self._batch, self.mesh,
                col_axis=MODEL_AXIS if two_d else DATA_AXIS,
                row_axis=DATA_AXIS if two_d else None)
        elif sharded:
            from photon_ml_tpu_torch.parallel import shard_batch

            # Rows padded to a multiple of the slots with weight-0 rows;
            # each slot's products run on its device, the row columns
            # and every fold on devices[0] (parallel/distributed.py).
            self._batch = shard_batch(self._batch, self.mesh,
                                      axis=self.mesh.axis_names[0])
        self._d_pad = self._batch.features.num_features
        if self.normalization is not None:
            self.normalization = self.normalization.to(self.device,
                                                       self.dtype)
        norm_solve = self.normalization
        if norm_solve is not None and self._d_pad != self._d:
            # Padded columns take inert normalization entries (factor 1,
            # shift 0), so the padded coordinates stay zero.
            norm_solve = dataclasses.replace(
                norm_solve,
                factors=self._pad_d(norm_solve.factors, 1.0),
                shifts=self._pad_d(norm_solve.shifts))
        self._norm_solve = norm_solve
        self._bounds = tuple(
            None if b is None else self._pad_d(torch.as_tensor(
                b, dtype=self.dtype, device=self.device), fill)
            for b, fill in ((self.lower_bounds, -math.inf),
                            (self.upper_bounds, math.inf)))
        self._objective = GLMObjective(loss_for_task(self.task_type),
                                       norm_solve)
        self._l1, self._l2 = self.config.l1_weight, self.config.l2_weight

    def _pad_d(self, a: Optional[Tensor], fill=0.0) -> Optional[Tensor]:
        """A [d] vector padded to the feature-sharded width (as it is
        without feature sharding)."""
        if a is None or self._d_pad == self._d:
            return a
        return torch.nn.functional.pad(a, (0, self._d_pad - self._d),
                                       value=fill)

    def initialize_model(self) -> FixedEffectModel:
        d = self.data.feature_shards[self.feature_shard_id].shape[1]
        glm_cls = model_for_task(self.task_type)
        return FixedEffectModel(
            glm_cls(Coefficients.zeros(d, self.dtype, self.device)),
            self.feature_shard_id)

    def params_of(self, model: FixedEffectModel) -> List[Tensor]:
        return [model.glm.coefficients.means]

    def model_of(self, params: List[Tensor],
                 model: FixedEffectModel) -> FixedEffectModel:
        return model.update_model(
            model.glm.update_coefficients(Coefficients(params[0])))

    def sample_weights(self, generator: Optional[torch.Generator]
                       ) -> Optional[Tensor]:
        """The down-sampled weights of an update drawn from ``generator``
        (None at rate 1.0, where the batch's weights stand)."""
        if self.config.down_sampling_rate >= 1.0:
            return None
        return down_sample_weights(generator, self._batch.labels,
                                   self._batch.weights,
                                   self.config.down_sampling_rate,
                                   self.task_type.is_classification)

    def pure_update(self, params: List[Tensor],
                    residual_scores: Optional[Tensor],
                    weights: Optional[Tensor] = None
                    ) -> Tuple[List[Tensor], OptimizerResult]:
        pad = self._batch.labels.shape[0] - self.data.num_rows
        if residual_scores is not None and pad:
            # The mesh's padding rows carry weight 0: any residual is inert.
            residual_scores = torch.nn.functional.pad(residual_scores,
                                                      (0, pad))
        result, coef = _solve_fixed(
            self._objective, self.config, self._batch, residual_scores,
            weights, self._pad_d(params[0]), self._norm_solve,
            *self._bounds)
        return [coef[:self._d]], result

    def pure_score(self, params: List[Tensor]) -> Tensor:
        return _fe_score_impl(self._pad_d(params[0]), self._batch.features,
                              self.data.num_rows)

    def pure_penalties(self, params: List[Tensor]):
        # The penalty applies in the optimization (normalized) space.
        coef = params[0]
        if self.normalization is not None:
            coef = self.normalization.model_to_normalized_space(coef)
        return [(coef, self._l1, self._l2)]

    def prepare_capture(self) -> None:
        """The CSR operands' scratch, made before a capture (ops/spmv.py;
        dense features need none)."""
        for op in getattr(self._batch.features, "_ops", ()):
            op.prepare()


@dataclasses.dataclass
class StreamingFixedEffectCoordinate:
    """Out-of-core fixed-effect solver over a device shard cache — the
    spill-mode (``--hbm-budget``) counterpart of FixedEffectCoordinate.

    It accumulates (value, gradient, Hessian-vector) shard by shard over a
    :class:`~photon_ml_tpu_torch.data.shard_cache.DeviceShardCache`
    (ops/sharded_objective.py) and drives the solve from the host
    (``minimize_lbfgs_glm_streaming`` / ``minimize_tron_streaming``): the
    treeAggregate shape of the reference's distributed solve, with
    device memory as the partition cache tier.

    Scope (enforced, as in JAX): L-BFGS or TRON with L2 only — no
    L1/OWL-QN, box constraints, normalization context, or down-sampling
    below 1.0. Those configurations stream-train through the resident
    assembled path. ``sharded_objective`` shares one objective across a
    λ grid (the L2 weight is an argument of every pass). ``mesh`` (a 1-D
    or 2-D `parallel.Mesh`) folds the solve over the slots of a cache
    placed on the same devices (ops/sharded_objective.py); a 2-D mesh of
    C model-axis extents needs a cache built with ``col_blocks=C``. The
    solved model is the same bits for every mesh shape on the card. A
    shared objective must fold over the same mesh.
    """

    name: str
    cache: object  # DeviceShardCache
    feature_shard_id: str
    task_type: TaskType
    config: GLMOptimizationConfiguration
    dtype: object = torch.float32
    sharded_objective: Optional[object] = None
    mesh: Optional[object] = None

    def __post_init__(self):
        from photon_ml_tpu_torch.ops.sharded_objective import (
            ShardedGLMObjective,
        )

        if self.config.l1_weight > 0:
            raise ValueError(
                "streaming fixed-effect solves support L2 only; "
                "L1/elastic-net needs the resident (assembled) path")
        if self.config.down_sampling_rate < 1.0:
            raise ValueError(
                "down-sampling is not supported with --hbm-budget "
                "streaming solves (per-row randomness is defined on the "
                "full batch); use the resident path")
        if self.config.optimizer_type not in (OptimizerType.LBFGS,
                                              OptimizerType.TRON):
            raise ValueError(
                f"streaming fixed-effect solves support LBFGS/TRON, got "
                f"{self.config.optimizer_type}")
        self._l2 = self.config.l2_weight
        if self.sharded_objective is not None:
            if self.sharded_objective.cache is not self.cache:
                raise ValueError(
                    "shared sharded_objective must wrap the same cache")
            want = None
            if self.mesh is not None:
                from photon_ml_tpu_torch.parallel import mesh_fold_devices

                devs = mesh_fold_devices(self.mesh)
                want = devs if len(devs) > 1 else None
            if self.sharded_objective.devices != want:
                raise ValueError(
                    "shared sharded_objective must use the same mesh "
                    f"(objective devices {self.sharded_objective.devices}, "
                    f"coordinate mesh devices {want})")
            self._sharded = self.sharded_objective
            self._objective = self._sharded.objective
        else:
            self._objective = GLMObjective(loss_for_task(self.task_type))
            self._sharded = ShardedGLMObjective(self._objective, self.cache,
                                                mesh=self.mesh)
            # Exposed through the field callers pass back in (a λ grid
            # shares one objective).
            self.sharded_objective = self._sharded

    def initialize_model(self) -> FixedEffectModel:
        glm_cls = model_for_task(self.task_type)
        return FixedEffectModel(
            glm_cls(Coefficients.zeros(self.cache.n_features, self.dtype,
                                       self.cache.device)),
            self.feature_shard_id)

    def solve(self, model: Optional[FixedEffectModel] = None,
              trace_ctx=None, convergence_ring=None, margins_out=None
              ) -> Tuple[FixedEffectModel, OptimizerResult]:
        """One full-batch GLM solve by streamed accumulation,
        warm-started from ``model`` when given. ``trace_ctx`` is the
        solve's trace context (telemetry/tracectx.py; the streaming
        driver mints one per λ), threaded into the solver for its
        per-iteration events and divergence tagging.
        ``convergence_ring`` and ``margins_out`` are the ``--distmon``
        hooks: the ring gets one entry per outer iteration, and the list
        receives the final per-shard margins."""
        from photon_ml_tpu_torch.optimization.glm_lbfgs import (
            minimize_lbfgs_glm_streaming,
        )
        from photon_ml_tpu_torch.optimization.tron import (
            minimize_tron_streaming,
        )

        if model is None:
            model = self.initialize_model()
        coef0 = torch.as_tensor(model.glm.coefficients.means,
                                dtype=self.dtype, device=self.cache.device)
        if self.config.optimizer_type == OptimizerType.TRON:
            if not self._objective.loss.twice_differentiable:
                raise ValueError(
                    f"TRON requires a twice-differentiable loss, got "
                    f"{self._objective.loss.name}")
            result = minimize_tron_streaming(
                self._sharded, coef0, self._l2,
                max_iter=self.config.max_iterations,
                tol=self.config.tolerance, trace_ctx=trace_ctx,
                convergence_ring=convergence_ring, margins_out=margins_out)
        else:
            result = minimize_lbfgs_glm_streaming(
                self._sharded, coef0, self._l2,
                max_iter=self.config.max_iterations,
                tol=self.config.tolerance, trace_ctx=trace_ctx,
                convergence_ring=convergence_ring, margins_out=margins_out)
        new_glm = model.glm.update_coefficients(Coefficients(result.x))
        return model.update_model(new_glm), result


def grid_batchable(configs) -> Tuple[bool, str]:
    """Can this λ grid run as ONE batched streamed solve
    (:func:`solve_fixed_effect_grid`)? True only when every point is a
    streamable L2 solve and the points differ in nothing but the
    regularization weight (the batched solvers share one candidate
    schedule or trust-region recipe across rows). Returns
    ``(ok, why_not)``."""
    configs = list(configs)
    if not configs:
        return False, "empty grid"
    base = configs[0]
    if base.optimizer_type not in (OptimizerType.LBFGS, OptimizerType.TRON):
        return False, (f"streaming grid solves support LBFGS/TRON, got "
                       f"{base.optimizer_type}")
    for cfg in configs:
        if cfg.l1_weight > 0:
            return False, ("L1/elastic-net grid points need the "
                           "resident path")
        if cfg.down_sampling_rate < 1.0:
            return False, ("down-sampling is not supported by streamed "
                           "solves")
        if (cfg.optimizer_type != base.optimizer_type
                or cfg.max_iterations != base.max_iterations
                or cfg.tolerance != base.tolerance):
            return False, (
                "grid points must share optimizer type, max_iterations "
                "and tolerance to batch — only the regularization "
                "weight may vary across rows")
    return True, ""


def solve_fixed_effect_grid(coordinate: StreamingFixedEffectCoordinate,
                            configs, models=None, trace_ctxs=None,
                            convergence_rings=None, margins_out=None
                            ) -> List[Tuple[FixedEffectModel,
                                            OptimizerResult]]:
    """Solve a whole λ grid in ONE batched streamed sweep: coefficients
    stack to ``[G, d]`` and every feature pass of the grid solver
    (glm_lbfgs.minimize_lbfgs_glm_grid_streaming /
    tron.minimize_tron_grid_streaming) advances all G points, so a sweep
    costs the slowest row's passes instead of the sum over rows.

    ``coordinate`` supplies the cache, objective and task; ``configs``
    is the grid (ValueError with the reason when not
    :func:`grid_batchable`); ``models`` warm-starts per row (entries may
    be None); ``trace_ctxs`` and ``convergence_rings`` (row-aligned,
    entries may be None) thread into the grid solver; ``margins_out``
    receives the ``[G, rows]`` per-shard margins. Returns the row-aligned
    ``(model, result)`` pairs that G sequential ``coordinate.solve``
    calls produce; G = 1 is the scalar streamed solve, bit for bit."""
    from photon_ml_tpu_torch.optimization.glm_lbfgs import (
        minimize_lbfgs_glm_grid_streaming,
    )
    from photon_ml_tpu_torch.optimization.tron import (
        minimize_tron_grid_streaming,
    )

    configs = list(configs)
    ok, why = grid_batchable(configs)
    if not ok:
        raise ValueError(f"λ-grid is not batchable: {why}")
    G = len(configs)
    if models is None:
        models = [None] * G
    if len(models) != G:
        raise ValueError(
            f"models must be row-aligned with the grid (G={G}), got "
            f"{len(models)}")
    models = [m if m is not None else coordinate.initialize_model()
              for m in models]
    device = coordinate.cache.device
    x0s = torch.stack([torch.as_tensor(m.glm.coefficients.means,
                                       dtype=coordinate.dtype,
                                       device=device) for m in models])
    l2s = [cfg.l2_weight for cfg in configs]
    base = configs[0]
    if base.optimizer_type == OptimizerType.TRON:
        if not coordinate._objective.loss.twice_differentiable:
            raise ValueError(
                f"TRON requires a twice-differentiable loss, got "
                f"{coordinate._objective.loss.name}")
        results = minimize_tron_grid_streaming(
            coordinate._sharded, x0s, l2s, max_iter=base.max_iterations,
            tol=base.tolerance, trace_ctxs=trace_ctxs,
            convergence_rings=convergence_rings, margins_out=margins_out)
    else:
        results = minimize_lbfgs_glm_grid_streaming(
            coordinate._sharded, x0s, l2s, max_iter=base.max_iterations,
            tol=base.tolerance, trace_ctxs=trace_ctxs,
            convergence_rings=convergence_rings, margins_out=margins_out)
    return [(m.update_model(m.glm.update_coefficients(
        Coefficients(r.x))), r) for m, r in zip(models, results)]


@dataclasses.dataclass
class StreamingFactoredRandomEffectCoordinate:
    """Out-of-core factored random effect (matrix factorization), the
    streamed counterpart of :class:`FactoredRandomEffectCoordinate`:
    factor tables live in a budgeted ``DeviceFactorCache`` (power-of-two
    observation-count shards, replay-aware eviction, f32 / bf16 /
    redecode spill), observations stream through ``make_stream``
    batches re-decoded per feature pass, the γ half-step is exact
    streamed ridge ALS and the refit of B is
    ``minimize_lbfgs_glm_streaming`` over ops/mf_alternating.py's
    ``StreamedMFObjective``.

    Scope (enforced, as in JAX): LINEAR_REGRESSION (the alternating
    half-steps are least squares), L2 only with a γ ridge above zero, no
    down-sampling, L-BFGS refits of B. ``solve(model,
    residual_scores=...)`` folds the other coordinates' scores into the
    offsets; ``score(model)`` returns raw margins γᵀ B x. Each sweep's
    refit is checked by the divergence watchdog. ``mf_objective`` shares
    one built objective (plan, factor cache) across λ-grid points with
    the same ``num_factors``. Each sweep mints its own trace context
    (``mf_sweep``), which the refit's iterations and the watchdog tag."""

    name: str
    make_stream: object  # () -> iterable of GameDataset batches
    feature_shard_id: str
    random_effect_type: str
    task_type: TaskType
    config: GLMOptimizationConfiguration  # the per-entity γ ridge
    latent_config: GLMOptimizationConfiguration  # the refit of B
    mf_config: MFOptimizationConfiguration
    n_features: Optional[int] = None  # settled by the planning pass
    hbm_budget_bytes: Optional[int] = None
    spill_dtype: str = "f32"
    spill_source: str = "buffer"
    entities_per_shard: int = 512
    seed: int = 7
    mf_objective: Optional[object] = None  # a shared StreamedMFObjective
    random_access: Optional[object] = None  # BlockRandomAccess hook
    dtype: object = torch.float32
    device: object = "cuda"

    def __post_init__(self):
        if self.task_type != TaskType.LINEAR_REGRESSION:
            raise ValueError(
                "streamed MF alternating least squares is defined for "
                "LINEAR_REGRESSION (squared loss); other tasks train "
                "through the in-core FactoredRandomEffectCoordinate")
        if self.config.l1_weight > 0 or self.latent_config.l1_weight > 0:
            raise ValueError(
                "streamed MF supports L2 only; L1/elastic-net factors "
                "need the in-core path")
        if self.config.l2_weight <= 0:
            raise ValueError(
                "streamed MF needs a strictly positive gamma L2 weight "
                "(the per-entity ridge normal equations are singular at "
                "λ₂ = 0 for low-observation entities)")
        if self.config.down_sampling_rate < 1.0 \
                or self.latent_config.down_sampling_rate < 1.0:
            raise ValueError(
                "down-sampling is not supported with streamed MF "
                "solves; use the in-core path")
        if self.latent_config.optimizer_type != OptimizerType.LBFGS:
            raise ValueError(
                f"streamed MF latent refits support LBFGS, got "
                f"{self.latent_config.optimizer_type}")
        self.device = resolve_device(self.device)
        self._l2 = self.config.l2_weight
        self._ll2 = self.latent_config.l2_weight
        k = self.mf_config.num_factors
        if self.mf_objective is not None:
            if self.mf_objective.k != k:
                raise ValueError(
                    f"shared mf_objective was built for num_factors="
                    f"{self.mf_objective.k}, coordinate asks for {k}")
            self._obj = self.mf_objective
        else:
            from photon_ml_tpu_torch.data.factor_cache import (
                DeviceFactorCache,
                count_stream_entities,
                plan_factors,
            )
            from photon_ml_tpu_torch.ops.mf_alternating import (
                StreamedMFObjective,
            )

            with telemetry.span("factor_plan"):
                vocab, counts, n_rows, d_by_shard = count_stream_entities(
                    self.make_stream(), self.random_effect_type)
            if self.feature_shard_id not in d_by_shard:
                raise KeyError(
                    f"stream carries no feature shard "
                    f"{self.feature_shard_id!r} (have {sorted(d_by_shard)})")
            d = d_by_shard[self.feature_shard_id]
            if self.n_features is not None and self.n_features != d:
                raise ValueError(
                    f"stream decodes {d} features for shard "
                    f"{self.feature_shard_id!r}, coordinate expected "
                    f"{self.n_features}")
            plan = plan_factors(vocab, counts,
                                entities_per_shard=self.entities_per_shard)
            cache = DeviceFactorCache(
                plan, k, hbm_budget_bytes=self.hbm_budget_bytes,
                spill_dtype=self.spill_dtype,
                spill_source=self.spill_source, dtype=self.dtype,
                device=self.device)
            self._obj = StreamedMFObjective(
                self.make_stream, self.feature_shard_id,
                self.random_effect_type, plan, cache, d,
                loss_for_task(self.task_type),
                random_access=self.random_access, dtype=self.dtype,
                device=self.device)
            self._obj.n_rows = n_rows
            self.mf_objective = self._obj
        self.n_features = self._obj.d

    @property
    def cache(self):
        return self._obj.cache

    @property
    def plan(self):
        return self._obj.plan

    def initialize_model(self) -> FactoredRandomEffectModel:
        """Zero factors and the in-core coordinate's seeded Gaussian B0."""
        k, d = self.mf_config.num_factors, self.n_features
        plan = self._obj.plan
        b0 = ProjectionMatrix.gaussian(k, d, intercept_col=None,
                                       seed=self.seed)
        latent = RandomEffectModel(
            random_effect_type=self.random_effect_type,
            feature_shard_id=self.feature_shard_id,
            local_coefs=[torch.zeros((s.n_entities, k), dtype=self.dtype,
                                     device=self.device)
                         for s in plan.shards],
            feat_idx=[torch.arange(k, dtype=torch.int32,
                                   device=self.device).repeat(
                                       s.n_entities, 1)
                      for s in plan.shards],
            entity_codes=[s.codes.astype(np.int32) for s in plan.shards],
            vocabulary=plan.vocabulary, num_global_features=d,
            projection=torch.as_tensor(b0.matrix, dtype=self.dtype,
                                       device=self.device))
        return FactoredRandomEffectModel(latent, self.mf_config)

    def solve(self, model: Optional[FactoredRandomEffectModel] = None,
              residual_scores=None, trace_ctx=None):
        """``mf_config.max_iterations`` alternating sweeps (a streamed
        ridge γ pass, then a streamed L-BFGS refit of B), B warm-started
        from ``model``. Returns ``(model, trackers)``, one
        OptimizerResult per sweep. ``trace_ctx`` (the λ's solve context)
        gets an ``mf_sweep`` event a sweep."""
        from photon_ml_tpu_torch.optimization.convergence import (
            check_solver_finite,
        )
        from photon_ml_tpu_torch.optimization.glm_lbfgs import (
            minimize_lbfgs_glm_streaming,
        )

        if model is None:
            model = self.initialize_model()
        b_mat = torch.as_tensor(model.projection_matrix, dtype=self.dtype,
                                device=self.device)
        self._obj.set_residual(residual_scores)
        trackers = []
        for sweep in range(self.mf_config.max_iterations):
            # One trace context a sweep: a divergence fault carries the
            # sweep's trace_id into the flight dump.
            ctx = telemetry.mint("mf_sweep")
            ctx.annotate(coordinate=self.name, sweep=sweep,
                         num_factors=self.mf_config.num_factors,
                         reg_weight=self.config.regularization_weight)
            if trace_ctx is not None:
                trace_ctx.event("mf_sweep")
            ctx.event("gamma_pass")
            self._obj.gamma_pass(b_mat, self._l2)
            ctx.event("latent_refit")
            result = minimize_lbfgs_glm_streaming(
                self._obj, b_mat.reshape(-1), self._ll2,
                max_iter=self.latent_config.max_iterations,
                tol=self.latent_config.tolerance, trace_ctx=ctx)
            b_mat = result.x.reshape(b_mat.shape)
            # The refit checks its own iterations; this catches a NaN
            # that rode the factor tables into it, under the MF label.
            check_solver_finite("streaming-mf-alternating", sweep,
                                float(result.value),
                                float(result.grad_norm), ctx)
            ctx.finish("ok")
            trackers.append(result)
        return (model.with_update(self._obj.factor_tables(), b_mat),
                trackers)

    def score(self, model: FactoredRandomEffectModel) -> Tensor:
        """Raw margins γᵀ B x per row (offsets excluded), scoring the
        model's own factor tables in one streamed pass."""
        return torch.as_tensor(self._obj.score_pass(
            model.projection_matrix, tables=model.latent.local_coefs))


@dataclasses.dataclass
class RandomEffectCoordinate(Coordinate):
    """Entity-sharded coordinate (ml/algorithm/RandomEffectCoordinate.scala:
    36-201): one batched solve per bucket, scores back through a
    scatter-add. Blocks live on the dataset's device.

    With ``mesh`` (a `parallel.Mesh` whose first slot is the dataset's
    device) the dataset is replaced by one whose active and passive
    buckets shard their entities over the data axis's slots (a 2-D
    mesh's data rows: one launch a data row, where JAX's ``shard_map``
    runs each row's shard again on each model-axis device)
    (``shard_re_dataset``, as JAX does), and the gathered normalization
    and bounds are gathered per slot. Without one every bucket is one
    slot. Update and score run one loop over each bucket's slots: one
    entity-solver launch a slot over its entity range (the counterpart of
    JAX's ``_shard_mapped_pallas_solver``), results back on devices[0] in
    entity order (the model keeps the bucket's real entities, the tracker
    every one, the padding entities with zero coefficients last), scores
    scattered slot by slot, padding rows into the sentinel."""

    name: str
    dataset: RandomEffectDataset
    task_type: TaskType
    config: GLMOptimizationConfiguration
    normalization: Optional[NormalizationContext] = None  # global space
    lower_bounds: Optional[object] = None  # [d], global feature space
    upper_bounds: Optional[object] = None
    mesh: Optional[object] = None  # parallel.Mesh: shard entities over it

    def __post_init__(self):
        self._objective = GLMObjective(loss_for_task(self.task_type))
        check_mode(entity_mode(self.config), self.lower_bounds,
                   self.upper_bounds, self._objective.loss)
        self._l1, self._l2 = self.config.l1_weight, self.config.l2_weight
        self.dataset, self._devices = shard_re_dataset(self.dataset,
                                                       self.mesh)
        # Per bucket, one entry a slot.
        self.norm_blocks = [
            [_gather_block_normalization(self.normalization, s)
             for s in b.slots] for b in self.dataset.blocks]
        self.bounds_blocks = [
            [_gather_block_bounds(self.lower_bounds, self.upper_bounds, s)
             for s in b.slots] for b in self.dataset.blocks]

    def initialize_model(self) -> RandomEffectModel:
        blocks = self.dataset.blocks
        dt = blocks[0].dtype if blocks else torch.float32
        return RandomEffectModel.zeros_like_dataset(self.dataset, dtype=dt)

    def params_of(self, model: RandomEffectModel) -> List[Tensor]:
        return list(model.local_coefs)

    def model_of(self, params: List[Tensor],
                 model: RandomEffectModel) -> RandomEffectModel:
        return model.with_coefs(params)

    def pure_update(self, params: List[Tensor],
                    residual_scores: Optional[Tensor],
                    weights: Optional[Tensor] = None
                    ) -> Tuple[List[Tensor], List[OptimizerResult]]:
        """One solve per bucket and slot (the analog of the reference's
        per-entity mapValues solve, RandomEffectCoordinate.scala:104-113),
        in the normalized space when there is a normalization. The
        tracker keeps the solve-space results, as JAX's does."""
        devs = self._devices
        residuals = _per_slot(residual_scores, devs)
        coefs, results = [], []
        for block, c0, norms, bounds in zip(
                self.dataset.blocks, params, self.norm_blocks,
                self.bounds_blocks):
            parts, out = [], []
            for sb, c, res, norm, bnd in zip(
                    block.slots, _split(c0, devs), residuals, norms,
                    bounds):
                if norm is not None:
                    c = gathered_to_normalized_space(c, *norm)
                r = _solve_block(self._objective, self.config, sb, res, c,
                                 norm, bnd)
                parts.append(r)
                out.append(r.x if norm is None
                           else gathered_to_original_space(r.x, *norm))
            coefs.append(_join(out, devs[0])[:block.num_entities])
            results.append(_gather_results(parts, devs[0]))
        return coefs, results

    def pure_score(self, params: List[Tensor]) -> Tensor:
        return _slot_scores(self.dataset, params, self._devices,
                            lambda blk, c: blk.local_margins(c))

    def pure_penalties(self, params: List[Tensor]):
        # In the optimization (normalized) space, like the fixed effect.
        devs = self._devices
        out = []
        for c, norms in zip(params, self.norm_blocks):
            if norms[0] is not None:
                c = _join([gathered_to_normalized_space(p, *n) for p, n in
                           zip(_split(c, devs), norms)],
                          devs[0])[:c.shape[0]]
            out.append((c, self._l1, self._l2))
        return out

    def prepare_capture(self) -> None:
        """Every bucket's entity-solver plan and stream counter."""
        mode = entity_mode(self.config)
        for block in self.dataset.blocks:
            for sb in block.slots:
                if sb.x.is_cuda:
                    prepare_launch(sb.x.device, sb.x.shape[1],
                                   sb.x.shape[2], mode=mode,
                                   loss_id=self._objective.loss.kernel_id)


@dataclasses.dataclass
class FactoredUpdate:
    """One MF alternation of a factored update: the latent solve of each
    bucket and the refit of B."""

    latent: List[OptimizerResult]
    refit: OptimizerResult


@dataclasses.dataclass
class FactoredRandomEffectCoordinate(Coordinate):
    """Matrix-factorization-flavoured random effect
    (ml/algorithm/FactoredRandomEffectCoordinate.scala:39-289). The
    dataset must be built with the IDENTITY projector, so blocks carry
    global-width features (B is the dimension reduction). The tracker of
    an update is one FactoredUpdate per MF alternation.

    With ``mesh`` the dataset's entities shard over the slots as the
    RandomEffectCoordinate's do, and every latent solve launches once a
    slot. An update reads the buckets' rows back on devices[0] for the
    whole bucket's latent projection and for the refit of B, and frees
    them when it ends."""

    name: str
    dataset: RandomEffectDataset
    task_type: TaskType
    config: GLMOptimizationConfiguration  # per-entity latent solves
    latent_config: GLMOptimizationConfiguration  # refit of B
    mf_config: MFOptimizationConfiguration
    seed: int = 7
    mesh: Optional[object] = None  # parallel.Mesh: latent solves per slot

    def __post_init__(self):
        if self.dataset.projection is not None:
            raise ValueError(
                "FactoredRandomEffectCoordinate learns its own projection: "
                "build the dataset with projector_type=IDENTITY")
        d = self.dataset.num_global_features
        for b in self.dataset.blocks:
            if b.d_pad < d:
                raise ValueError(
                    "factored random effects need global-width blocks "
                    f"(d_pad {b.d_pad} < num_global_features {d}); build "
                    "the dataset with projector_type=IDENTITY")
        self._objective = GLMObjective(loss_for_task(self.task_type))
        check_mode(entity_mode(self.config), loss=self._objective.loss)
        self._l1, self._l2 = self.config.l1_weight, self.config.l2_weight
        self._ll1 = self.latent_config.l1_weight
        self._ll2 = self.latent_config.l2_weight
        self.dataset, self._devices = shard_re_dataset(self.dataset,
                                                       self.mesh)

    def initialize_model(self) -> FactoredRandomEffectModel:
        """gamma = 0 and B from ProjectionMatrix.gaussian(k, d, no
        intercept, seed): numpy, so bit-equal to the JAX package's B."""
        ds = self.dataset
        dt, dev = ds.blocks[0].dtype, ds.blocks[0].device
        k = self.mf_config.num_factors
        b0 = ProjectionMatrix.gaussian(k, ds.num_global_features,
                                       intercept_col=None, seed=self.seed)
        latent = RandomEffectModel(
            random_effect_type=ds.config.random_effect_type,
            feature_shard_id=ds.config.feature_shard_id,
            local_coefs=[torch.zeros((b.num_entities, k), dtype=dt,
                                     device=dev) for b in ds.blocks],
            feat_idx=[torch.arange(k, dtype=torch.int32, device=dev)
                      .repeat(b.num_entities, 1) for b in ds.blocks],
            entity_codes=list(ds.entity_codes),
            vocabulary=ds.vocabulary,
            num_global_features=ds.num_global_features,
            projection=torch.as_tensor(b0.matrix, dtype=dt, device=dev))
        return FactoredRandomEffectModel(latent, self.mf_config)

    def params_of(self, model: FactoredRandomEffectModel) -> List[Tensor]:
        """Each bucket's gamma, then B."""
        return [*model.latent.local_coefs, model.projection_matrix]

    def model_of(self, params: List[Tensor],
                 model: FactoredRandomEffectModel
                 ) -> FactoredRandomEffectModel:
        return model.with_update(params[:-1], params[-1])

    def pure_update(self, params: List[Tensor],
                    residual_scores: Optional[Tensor],
                    weights: Optional[Tensor] = None
                    ) -> Tuple[List[Tensor], List[FactoredUpdate]]:
        blocks = self.dataset.blocks
        d = self.dataset.num_global_features
        gammas, B = list(params[:-1]), params[-1]
        offsets = [block_offsets(b, residual_scores) for b in blocks]
        xs = [b.x[..., :d] for b in blocks]
        # Rows, labels, offsets and weights of the refit do not change
        # across alternations; only the per-row gammas do.
        x_flat, y_flat, off_flat, w_flat = _flatten_factored_static(
            xs, blocks, offsets)
        trackers = []
        for _ in range(self.mf_config.max_iterations):
            latent = [self._solve_latent(block, x, B, off, g0)
                      for block, x, off, g0 in zip(blocks, xs, offsets,
                                                   gammas)]
            gammas = [r.x[:b.num_entities] for r, b in zip(latent, blocks)]
            batch = GLMBatch(
                KroneckerFeatures(x_flat, _flatten_gammas(blocks, gammas)),
                y_flat, off_flat, w_flat)
            refit = solve_glm(self._objective, batch, self.latent_config,
                              B.reshape(-1))
            B = refit.x.reshape(B.shape)
            trackers.append(FactoredUpdate(latent, refit))
        return [*gammas, B], trackers

    def prepare_capture(self) -> None:
        """Every latent bucket's entity-solver plan and stream counter
        (its features are [E, n_pad, k])."""
        mode = entity_mode(self.config)
        k = self.mf_config.num_factors
        for block in self.dataset.blocks:
            for sb in block.slots:
                if sb.x.is_cuda:
                    prepare_launch(sb.x.device, sb.x.shape[1], k, mode=mode,
                                   loss_id=self._objective.loss.kernel_id)

    def _solve_latent(self, block, x: Tensor, B: Tensor, offsets: Tensor,
                      gamma0: Tensor) -> OptimizerResult:
        """A bucket's latent solves: the projection of the whole bucket
        ``x`` [E, n_pad, d] on devices[0], so its GEMM has the same
        height whatever the slots (one of another height may take another
        algorithm, and other bits, on the card); then one entity-solver
        launch a slot over its entity range."""
        devs = self._devices
        lat, off, g0 = (_split(a, devs)
                        for a in (project_latent(x, B), offsets, gamma0))
        return _gather_results(
            [_solve_factored_block(self._objective, self.config, sb, l_s,
                                   o_s, g_s)
             for sb, l_s, o_s, g_s in zip(block.slots, lat, off, g0)],
            devs[0])

    def pure_score(self, params: List[Tensor]) -> Tensor:
        B = params[-1]
        d = self.dataset.num_global_features

        def margins(blk, gamma):
            coefs = gamma @ B.to(gamma.device)  # [E, d]
            pad = blk.d_pad - d
            if pad:
                coefs = torch.nn.functional.pad(coefs, (0, pad))
            return blk.local_margins(coefs)

        return _slot_scores(self.dataset, params[:-1], self._devices,
                            margins)

    def pure_penalties(self, params: List[Tensor]):
        """Each bucket's gamma under the latent solves' weights, then B
        under the refit's, in the JAX order."""
        out = [(g, self._l1, self._l2) for g in params[:-1]]
        out.append((params[-1], self._ll1, self._ll2))
        return out


def _dataset_device(dataset: RandomEffectDataset) -> torch.device:
    return dataset.blocks[0].device if dataset.blocks \
        else torch.device("cpu")


def _mesh_slots(mesh, home) -> List[torch.device]:
    """The slot devices of a coordinate's mesh along its data axis (a
    1-D mesh's slots, a 2-D mesh's data rows ``grid[r][0]``: entities
    and rows shard over them, one launch a data row), ``[home]`` without
    one. The first slot must be the coordinate's own device (a CUDA
    device without an index stands for any card), where its [d]-space
    state, scores and folds live."""
    home = torch.device(home)
    if mesh is None:
        return [home]
    from photon_ml_tpu_torch.parallel import axis_slots

    devs = axis_slots(mesh, mesh.axis_names[0])
    if devs[0].type != home.type or (home.index is not None
                                     and devs[0].index != home.index):
        raise ValueError(
            f"the mesh's first slot is {devs[0]} but the coordinate's data "
            f"lives on {home}: build the mesh from the estimator's device")
    return devs


def shard_re_dataset(dataset: RandomEffectDataset, mesh
                     ) -> Tuple[RandomEffectDataset, List[torch.device]]:
    """``(dataset, slot devices)``: every active and passive bucket's
    entities sharded over the mesh's slots (``parallel.shard_block`` into
    a ShardedEntityBlock, whose slots then hold the only copy of the
    data; JAX's ``_shard_re_dataset``). Without a mesh, or with a
    one-slot mesh, the buckets stay as they are. A bucket already sharded
    over these slots stays as it is, so an estimator shards a dataset
    once for every coordinate built on it."""
    from photon_ml_tpu_torch.parallel import shard_block

    devs = _mesh_slots(mesh, _dataset_device(dataset))

    def shard(b):
        if b is None or [s.device for s in b.slots] == devs:
            return b
        if len(devs) == 1 or isinstance(b, ShardedEntityBlock):
            raise ValueError(
                f"a bucket sharded over {[str(s.device) for s in b.slots]} "
                f"cannot be used over the slots {[str(d) for d in devs]}")
        return ShardedEntityBlock(tuple(shard_block(
            b, mesh, dataset.n_rows, axis=mesh.axis_names[0])),
            b.num_entities)

    if len(devs) == 1 and not any(
            isinstance(b, ShardedEntityBlock) for b in dataset.blocks):
        return dataset, devs
    return dataclasses.replace(
        dataset, blocks=[shard(b) for b in dataset.blocks],
        passive_blocks=[shard(b) for b in dataset.passive_blocks]), devs


def _split(a: Tensor, devices) -> List[Tensor]:
    """Per-entity ``a`` [E, ...] padded with zeros to the slots' entity
    count and cut into the slots' ranges (``a`` itself for one slot)."""
    from photon_ml_tpu_torch.parallel.distributed import (
        pad_entities,
        split_slots,
    )

    return split_slots(pad_entities(a, len(devices)), devices)


def _join(parts: List[Tensor], device) -> Tensor:
    """Per-slot tensors back on ``device`` in slot order."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(device) for p in parts])


def _per_slot(x: Optional[Tensor], devices) -> list:
    """``x`` on each slot's device once (None stays None)."""
    return [None if x is None else x.to(d) for d in devices]


def _gather_results(parts: List[OptimizerResult], device) -> OptimizerResult:
    """Per-slot batched results back on ``device`` in entity order."""
    def cat(name):
        vals = [getattr(p, name) for p in parts]
        if not isinstance(vals[0], Tensor):
            return vals[0]
        return _join(vals, device)

    return OptimizerResult(**{f.name: cat(f.name)
                              for f in dataclasses.fields(OptimizerResult)})


def _slot_scores(dataset: RandomEffectDataset, coefs, devices,
                 margins) -> Tensor:
    """Every bucket's margins (active and passive rows), each slot's
    ``margins(block, coefs)`` on its device, scattered into one [n_rows]
    score vector on devices[0]; padding rows and entities land in the
    sentinel row, which is dropped."""
    n_rows, dev0 = dataset.n_rows, devices[0]
    scores = torch.zeros(
        (n_rows + 1,), dtype=coefs[0].dtype if coefs else torch.float32,
        device=dev0)
    for act, pas, c in zip(dataset.blocks, dataset.passive_blocks, coefs):
        cs = _split(c, devices)
        for group in (act, pas):
            for blk, c_s in zip(group.slots if group is not None else (),
                                cs):
                _scatter_rows(scores, blk.row_ids.to(dev0),
                              margins(blk, c_s).to(dev0), n_rows)
    return scores[:-1]


def _solve_factored_block(objective: GLMObjective,
                          config: GLMOptimizationConfiguration,
                          block: EntityBlock, lat: Tensor, offsets: Tensor,
                          gamma0: Tensor) -> OptimizerResult:
    """The latent solves of a bucket (or of a slot's range of it) on its
    projected features ``lat`` [E, n_pad, k], as ``_solve_block`` calls
    the entity solver."""
    return entity_lbfgs(objective.loss, lat, block.labels, offsets,
                        block.weights, gamma0.contiguous(), config.l2_weight,
                        config.l1_weight, max_iter=config.max_iterations,
                        tol=config.tolerance, mode=entity_mode(config))


def project_latent(x: Tensor, B: Tensor) -> Tensor:
    """A bucket's latent features lat = x B^T for its global-width
    features ``x`` [E, n_pad, d]: [E, n_pad, k], contiguous."""
    return torch.einsum("end,kd->enk", x, B).contiguous()


def _flatten_factored_static(xs, blocks, offsets):
    """Every bucket's rows in block order, padding rows in place: the
    alternation-invariant half of the refit batch (x [N, d] from each
    bucket's ``xs`` [E, n_pad, d], labels, offsets with the residual,
    weights [N])."""
    d = xs[0].shape[-1]
    return (torch.cat([x.reshape(-1, d) for x in xs]),
            torch.cat([b.labels.reshape(-1) for b in blocks]),
            torch.cat([o.reshape(-1) for o in offsets]),
            torch.cat([b.weights.reshape(-1) for b in blocks]))


def _flatten_gammas(blocks, gammas) -> Tensor:
    """Per-row latent factors aligned with _flatten_factored_static's
    rows: each entity's gamma repeated over its n_pad rows."""
    return torch.cat([
        g[:, None, :].expand(b.num_entities, b.n_pad, g.shape[-1])
        .reshape(-1, g.shape[-1]) for b, g in zip(blocks, gammas)])


def _gather_block_normalization(normalization, block: EntityBlock):
    """(factors, shifts, intercept_mask) in the block's local feature
    space and type, or None without normalization."""
    if normalization is None:
        return None
    factors, shifts, mask = gather_normalization(normalization,
                                                 block.feat_idx)
    if factors is None and shifts is None:
        return None
    dt = block.x.dtype

    def conv(a):
        return None if a is None else a.to(dt)

    return conv(factors), conv(shifts), mask.to(dt)


def _gather_block_bounds(lower, upper, block: EntityBlock):
    """(lower, upper) [E, d] in the block's local feature space and type,
    or None without bounds. Padding columns (feat_idx < 0) are unbounded:
    their coefficients touch no data and L2 holds them at zero."""
    if lower is None and upper is None:
        return None
    dt, dev = block.x.dtype, block.x.device
    idx = block.feat_idx.long()
    safe = torch.clamp_min(idx, 0)
    pad = idx < 0

    def gather(vec, default):
        fill = torch.full(tuple(idx.shape), default, dtype=dt, device=dev)
        if vec is None:
            return fill
        return torch.where(pad, fill,
                           torch.as_tensor(vec, dtype=dt, device=dev)[safe])

    return gather(lower, -math.inf), gather(upper, math.inf)


def entity_mode(config: GLMOptimizationConfiguration) -> str:
    """The entity solver's mode for a configuration, as the JAX
    ``_dispatch_pallas_solver`` chooses it."""
    if config.optimizer_type == OptimizerType.TRON:
        return "tron"
    return "owlqn" if config.l1_weight > 0 else "lbfgs"


def block_offsets(block: EntityBlock, residual_scores: Optional[Tensor]
                  ) -> Tensor:
    """The block's offsets plus the other coordinates' scores gathered per
    row; padding rows (row_ids == n_rows) gather a zero sentinel."""
    if residual_scores is None:
        return block.offsets
    ext = torch.cat([residual_scores,
                     torch.zeros((1,), dtype=residual_scores.dtype,
                                 device=residual_scores.device)])
    return block.offsets + ext[block.row_ids.long()].to(block.offsets.dtype)


def _solve_block(objective: GLMObjective,
                 config: GLMOptimizationConfiguration, block: EntityBlock,
                 residual_scores: Optional[Tensor], coefs0: Tensor,
                 norm=None, bounds=None) -> OptimizerResult:
    """One batched solve over the bucket's entity axis. ``norm`` is the
    gathered (factors, shifts, intercept_mask) and ``bounds`` the
    gathered (lower, upper); coefs0 and the result are in the solve
    space."""
    offsets = block_offsets(block, residual_scores)
    factors, shifts = (norm[0], norm[1]) if norm is not None else (None,
                                                                   None)
    lower, upper = bounds if bounds is not None else (None, None)
    return entity_lbfgs(objective.loss, block.x, block.labels, offsets,
                        block.weights, coefs0, config.l2_weight,
                        config.l1_weight, factors, shifts, lower, upper,
                        max_iter=config.max_iterations, tol=config.tolerance,
                        mode=entity_mode(config))


def _solve_fixed(objective: GLMObjective,
                 config: GLMOptimizationConfiguration, batch: GLMBatch,
                 residual_scores: Optional[Tensor],
                 weights: Optional[Tensor], coef0: Tensor,
                 normalization: Optional[NormalizationContext] = None,
                 lower_bounds: Optional[Tensor] = None,
                 upper_bounds: Optional[Tensor] = None
                 ) -> Tuple[OptimizerResult, Tensor]:
    """The fixed-effect update: residual -> offsets, the down-sampled
    ``weights`` (None: the batch's), the solve in the normalized space
    (bounds clamp that iterate), the coefficients back to the original
    space. Returns (result, original-space coefficients)."""
    if residual_scores is not None:
        batch = batch.with_offsets(
            batch.offsets + residual_scores.to(batch.offsets.dtype))
    if weights is not None:
        batch = GLMBatch(batch.features, batch.labels, batch.offsets,
                         weights)
    if normalization is not None:
        coef0 = normalization.model_to_normalized_space(coef0)
    result = solve_glm(objective, batch, config, coef0, lower_bounds,
                       upper_bounds)
    coef = result.x
    if normalization is not None:
        coef = normalization.model_to_original_space(coef)
    return result, coef


def _fe_score_impl(coef: Tensor, feats, n_rows: int) -> Tensor:
    return feats.matvec(coef)[:n_rows]


def _scatter_rows(scores: Tensor, row_ids: Tensor, margins: Tensor,
                  n_rows: int) -> Tensor:
    m = torch.where(row_ids < n_rows, margins, torch.zeros_like(margins))
    return scores.index_add_(0, row_ids.reshape(-1).long(), m.reshape(-1))
