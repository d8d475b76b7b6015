"""Block coordinate descent over named coordinates — the GAME outer loop
(port of photon_ml_tpu/algorithm/coordinate_descent.py:
LazyTrackers and _unstack_tracker_block :41-92, CoordinateDescent :101
with its fused update :124-167 and its run :240-555 (checkpoints and
resume :245-330, device-resident params and scores :323-346, the
objective history written on the device :348-360, sync spans :440-486,
the per-step path :483-529, the retrace assertion :534-540),
_training_rows :557, _hist_set :583, _rows_from_blocks :588; reference
ml/algorithm/CoordinateDescent.scala:41-271).

For each iteration, for each coordinate in the updating sequence: the
residual is the sum of the other coordinates' scores, recomputed fresh;
the coordinate re-solves against it as extra offsets and re-scores; the
full objective sum_i w_i l(total_i + offset_i, y_i) + sum_c penalty_c is
recomputed; after each iteration the validation set is scored and the
best model by the first evaluator is kept.

The fused update. Every coordinate's parameters and scores live in
static device buffers; an update (the residual from the other
coordinates' score buffers, the solve through the coordinate's pure
interface, the score, the full objective with every penalty, written
into a device history at the step's index as ``_hist_set`` does) is one
function, ``_UpdateExecutable``. On the card it is captured once a run
into one CUDA graph, its solver loops as WHILE nodes
(utils/device_loop.py), and each update is one replay: nothing is read
back inside it. Its results stay on the card until a sync point, where
one transfer materializes the objectives (and the launch tally): at
each validation, at each checkpoint save and at the run's end. The sync
spans follow JAX's rules: one iteration when validating; up to the next
save when checkpoints fall on iteration boundaries; otherwise the rest
of the run; the per-step path for a resume that lands mid-iteration or
a checkpoint interval that is not a multiple of the coordinates. The
``updates`` records are written at a sync point, each update's seconds
the span's over its updates. Models are built from clones of the
buffers at a sync point, and each update's tracker is cloned after its
replay, since the next replay overwrites the graph's outputs; trackers
come back as ``LazyTrackers``. ``tracing_guard`` counts one capture per
coordinate (``fused:{name}``), asserted at the run's end.

``fused=False``, the CPU, and a mesh run the same function eagerly (the
eager plain loop: its solver loops read their predicate on the host once
an iteration). A mesh's coordinates update eagerly: graphs over several
devices are ROADMAP A3b, and the run says so in its log.

Checkpoints (``checkpoint_dir``, utils/checkpoint.py) are saved every
``checkpoint_interval`` updates and at each validated iteration's end,
and a run resumes from the latest one there. Update ``step`` draws from a
``torch.Generator`` seeded from (seed, step) outside the graph, into a
static weights buffer, so a resumed run is bit for bit the uninterrupted
one, as the JAX package's ``fold_in(base, step)`` makes it. A model
whose first coordinate is a random effect takes its rows (labels,
offsets, weights) from that coordinate's blocks.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.algorithm.coordinates import Coordinate
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.evaluation.evaluators import Evaluator
from photon_ml_tpu_torch.models.game_model import GameModel
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.optimization.convergence import history_write
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import checkpoint as ckpt
from photon_ml_tpu_torch.utils import device_loop
from photon_ml_tpu_torch.utils.tracing_guard import BuildCount, TracingGuard

logger = logging.getLogger(__name__)

Tensor = torch.Tensor


def _clone(obj):
    """``obj`` with every tensor in it cloned (a replay's outputs,
    before the next replay overwrites them)."""
    return ckpt.map_leaves(obj, lambda t: t.clone())


class LazyTrackers(Mapping):
    """coordinate name -> per-update optimizer trackers, put in place on
    FIRST ACCESS from the updates still pending (JAX LazyTrackers,
    coordinate_descent.py:55-85). A tracker's tensors stay on the card
    where the update made them; a caller that never looks at them pays
    nothing more for them."""

    def __init__(self, base: Dict[str, list], pending: List[tuple]):
        self._base = base
        self._pending = list(pending)  # (coordinate, tracker), step order

    def _force(self) -> None:
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        for name, tracker in pending:
            self._base[name].append(tracker)

    def __getitem__(self, key):
        self._force()
        return self._base[key]

    def __iter__(self):
        self._force()
        return iter(self._base)

    def __len__(self):
        return len(self._base)


@dataclasses.dataclass
class CoordinateDescentResult:
    model: GameModel
    objective_history: List[float]  # one entry per coordinate update
    validation_history: List[Dict[str, float]]  # one entry per iteration
    best_model: Optional[GameModel]
    best_metric: Optional[float]
    # coordinate -> per-update OptimizerResults (LazyTrackers from a run)
    trackers: Mapping[str, list]
    # One record per update: iteration, coordinate, seconds, objective.
    updates: List[dict]
    # coordinate -> seconds summed over its updates (the training
    # driver's coordinateSeconds).
    timings: Dict[str, float]
    # coordinate -> its update graph's nodes, capture and instantiate
    # seconds and pool bytes (empty when the run captured none).
    graphs: Dict[str, dict] = dataclasses.field(default_factory=dict)


class _UpdateExecutable:
    """One coordinate's whole update over the run's static buffers: on
    the card one CUDA graph captured at construction (``fused``), else
    the function itself, run eagerly. ``run()`` performs one update and
    returns its tracker (a clone after a replay). ``builds.traces``
    counts captures on the card and builds of the eager function
    elsewhere, as a serving bucket's executable does."""

    def __init__(self, fn, coord: Coordinate, device: torch.device,
                 fused: bool, tally):
        self.fn = fn
        self.graph = None
        if fused:
            with tally.recording():
                self.graph = device_loop.CapturedGraph(
                    fn, device, prepare=coord.prepare_capture)
            self.builds = self.graph.builds
            self.stats = self.graph.stats
        else:
            self.builds = BuildCount()
            self.builds.traces += 1
            self.stats = None

    def run(self):
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        return _clone(self.graph.outputs)

    def close(self) -> None:
        if self.graph is not None:
            self.graph.close()


class CoordinateDescent:
    """``fused`` (the default) captures each coordinate's update into a
    CUDA graph on the card; False runs the eager plain loop. The CPU and
    a mesh run eagerly whatever it says. ``graph_stats`` holds each
    graph's nodes, capture and instantiate seconds and pool bytes from
    the last run (also the result's ``graphs``); ``tracing_guard`` its
    captures."""

    def __init__(self, coordinates: Dict[str, Coordinate],
                 task_type: TaskType,
                 validation_data: Optional[GameDataset] = None,
                 validation_evaluators: Sequence[Evaluator] = (),
                 dtype=torch.float32, device="cuda", fused: bool = True):
        if not coordinates:
            raise ValueError("at least one coordinate is required")
        self.coordinates = dict(coordinates)
        self.task_type = task_type
        self.validation_data = validation_data
        self.validation_evaluators = list(validation_evaluators)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.fused = fused
        self._val_scorer = None
        self.tracing_guard = TracingGuard()
        self.graph_stats: Dict[str, dict] = {}

    def _training_rows(self):
        """(labels, offsets, weights) in global row order, from the first
        coordinate's data, or, for a random effect, from its blocks."""
        first = self.coordinates[next(iter(self.coordinates))]
        data = getattr(first, "data", None)

        def col(a):
            return torch.as_tensor(a, dtype=self.dtype, device=self.device)

        if data is None:
            return tuple(col(r) for r in _rows_from_blocks(first.dataset))
        return col(data.responses), col(data.offsets), col(data.weights)

    def _objective(self, total: Tensor, rows, params) -> Tensor:
        loss = loss_for_task(self.task_type)
        labels, offsets, weights = rows
        obj = torch.sum(weights * loss.loss(total + offsets, labels))
        for n, coord in self.coordinates.items():
            for c, l1, l2 in coord.pure_penalties(params[n]):
                obj = obj + 0.5 * l2 * torch.sum(c * c)
                if l1:
                    obj = obj + l1 * torch.sum(torch.abs(c))
        return obj

    def _update_fn(self, n: str, models, params, scores, weights, rows,
                   hist, step_idx):
        """Coordinate ``n``'s whole update over the static buffers: the
        residual, the solve (``update_model`` on a model over the
        parameter buffers, a thin wrapper of the pure interface), the
        score and the full objective (written at the device step index),
        then the new parameters and score into their buffers. Returns
        the tracker."""
        names = list(self.coordinates)
        coord = self.coordinates[n]

        def update():
            residual = None
            for m in names:
                if m != n:
                    residual = (scores[m] if residual is None
                                else residual + scores[m])
            new_model, tracker = coord.update_model(
                coord.model_of(params[n], models[n]), residual,
                weights=weights.get(n))
            new_p = coord.params_of(new_model)
            score = coord.pure_score(new_p)
            total = score if residual is None else residual + score
            obj = self._objective(total, rows, {**params, n: new_p})
            history_write(hist, step_idx, obj.to(hist.dtype))
            step_idx.add_(1)
            for buf, v in zip(params[n], new_p):
                buf.copy_(v)
            scores[n].copy_(score)
            return tracker

        return update

    def run(self, num_iterations: int, seed: int = 0,
            initial_model: Optional[GameModel] = None,
            checkpoint_dir=None, checkpoint_interval: int = 1,
            checkpoint_tag: Optional[Mapping[str, str]] = None
            ) -> CoordinateDescentResult:
        """checkpoint_dir: save resumable state every
        ``checkpoint_interval`` coordinate updates, and resume from the
        latest checkpoint found there. checkpoint_tag: the configuration
        (name -> configuration string) that the checkpoint identity
        check compares, besides the seed, coordinates and task type."""
        if checkpoint_interval < 1:
            raise ValueError(
                f"checkpoint_interval must be >= 1, got {checkpoint_interval}")
        names = list(self.coordinates)
        n_coords = len(names)
        if initial_model is None:
            models = {n: c.initialize_model()
                      for n, c in self.coordinates.items()}
        else:
            models = {n: initial_model.models[n] for n in names}

        objective_history: List[float] = []
        validation_history: List[Dict[str, float]] = []
        trackers: Dict[str, list] = {n: [] for n in names}
        timings: Dict[str, float] = {n: 0.0 for n in names}
        updates: List[dict] = []
        best_model, best_metric = None, None
        done_steps = 0
        meta = {"seed": seed, "coordinates": names,
                "taskType": self.task_type.value,
                "tag": dict(checkpoint_tag or {})}

        if checkpoint_dir is not None:
            latest = ckpt.latest_checkpoint(checkpoint_dir)
            if latest is not None:
                state = ckpt.to_device(ckpt.load_checkpoint(latest),
                                       self.device)
                if state.meta != meta:
                    raise ValueError(
                        f"checkpoint {latest} belongs to a different "
                        f"configuration (saved {state.meta}, current {meta});"
                        " point --checkpoint-dir elsewhere or delete it")
                done_steps = state.step
                models = dict(state.models)
                objective_history = list(state.objective_history)
                validation_history = list(state.validation_history)
                best_metric = state.best_metric
                timings = dict(state.timings)
                trackers = {n: list(state.trackers.get(n, []))
                            for n in names}
                updates = list(state.updates)
                if state.best_models is not None:
                    best_model = GameModel(dict(state.best_models),
                                           self.task_type)
                logger.info("resumed from %s (step %d)", latest, done_steps)

        on_mesh = any(getattr(c, "mesh", None) is not None
                      for c in self.coordinates.values())
        fused = (self.fused and self.device.type == "cuda" and not on_mesh)
        if on_mesh and self.fused and self.device.type == "cuda":
            logger.info("coordinate updates run eagerly over the mesh: the "
                        "fused update graphs span one device (ROADMAP A3b)")

        # The training state on the device: parameters and scores in
        # static buffers (scores are a function of the models, so after
        # a resume they are the uninterrupted run's bits), the objective
        # history and its device step index.
        params = {n: [t.clone() for t in c.params_of(models[n])]
                  for n, c in self.coordinates.items()}
        scores = {n: self.coordinates[n].pure_score(params[n])
                  for n in names}
        rows = self._training_rows()
        weights = {}
        for n, c in self.coordinates.items():
            w = c.sample_weights(ckpt.step_generator(seed, 1, self.device))
            if w is not None:
                weights[n] = torch.empty_like(w)
        hist = torch.zeros(max(num_iterations * n_coords, done_steps, 1),
                           dtype=self.dtype, device=self.device)
        step_idx = torch.full((), done_steps, dtype=torch.int64,
                              device=self.device)
        tally = device_loop.LaunchTally(self.device) if fused else None
        executables = {}
        for n in names:
            fn = self._update_fn(n, models, params, scores, weights, rows,
                                 hist, step_idx)
            executables[n] = _UpdateExecutable(fn, self.coordinates[n],
                                               self.device, fused, tally)
            self.tracing_guard.track(f"fused:{n}", executables[n])
        self.graph_stats = {n: e.stats for n, e in executables.items()
                            if e.stats is not None}

        validating = (self.validation_data is not None
                      and bool(self.validation_evaluators))
        # Updates run since the last sync point: (iteration, coordinate,
        # tracker); and that span's start on the host clock.
        span: List[tuple] = []
        span_t0 = [time.perf_counter()]
        pending_trackers: List[tuple] = []

        def update(it, n, step):
            coord = self.coordinates[n]
            if n in weights:
                weights[n].copy_(coord.sample_weights(
                    ckpt.step_generator(seed, step, self.device)))
            if not span:
                span_t0[0] = time.perf_counter()
            span.append((it, n, executables[n].run()))

        def materialize():
            """The sync point: one transfer of the span's objectives (and
            the launch tally), then its records and models."""
            if not span:
                return
            k = len(span)
            host = hist[len(objective_history):len(objective_history) + k]
            if tally is not None:
                host = torch.cat([host.to(torch.float64),
                                  tally.values().to(torch.float64)])
            host = host.cpu()
            if tally is not None:
                tally.settle(host[k:].tolist())
            seconds = (time.perf_counter() - span_t0[0]) / k
            for (it, n, tracker), obj in zip(span, host[:k].tolist()):
                objective_history.append(obj)
                pending_trackers.append((n, tracker))
                timings[n] += seconds
                updates.append({"iteration": it, "coordinate": n,
                                "seconds": seconds, "objective": obj})
                logger.info("iter %d coordinate %s updated (%.1f ms), "
                            "objective %.6f", it, n, 1e3 * seconds, obj,
                            extra={"update": updates[-1]})
            span.clear()
            for n in names:
                models[n] = self.coordinates[n].model_of(
                    [t.clone() for t in params[n]], models[n])

        def save(step):
            materialize()
            for n, tracker in pending_trackers:
                trackers[n].append(tracker)
            pending_trackers.clear()
            ckpt.save_checkpoint(checkpoint_dir, ckpt.CheckpointState(
                step=step, models=models,
                objective_history=list(objective_history),
                validation_history=validation_history,
                best_metric=best_metric,
                best_models=(dict(best_model.models)
                             if best_model is not None else None),
                timings=timings, trackers=trackers, meta=meta,
                updates=updates))

        def validate(it):
            nonlocal best_metric, best_model
            materialize()
            game_model = GameModel(dict(models), self.task_type)
            metrics = self._validate(game_model)
            validation_history.append(metrics)
            head = self.validation_evaluators[0]
            if head.better_than(metrics[head.name], best_metric):
                best_metric, best_model = metrics[head.name], game_model
            logger.info("iter %d validation: %s", it, metrics)

        # Blocks cover whole iterations; they apply when checkpoint saves
        # land on iteration boundaries (otherwise the per-step path keeps
        # the exact mid-iteration saves).
        blockable = (checkpoint_dir is None
                     or checkpoint_interval % n_coords == 0)
        step = it = 0
        try:
            while it < num_iterations:
                if step + n_coords <= done_steps:
                    # The whole iteration was restored, with its
                    # validation.
                    step += n_coords
                    it += 1
                    continue
                if blockable and step >= done_steps:
                    # ---- a sync span of whole iterations ----
                    if validating:
                        n_it = 1
                    elif checkpoint_dir is not None:
                        next_save = ((step // checkpoint_interval) + 1
                                     ) * checkpoint_interval
                        n_it = (next_save - step) // n_coords
                    else:
                        n_it = num_iterations - it
                    n_it = max(1, min(n_it, num_iterations - it))
                    for i in range(it, it + n_it):
                        for n in names:
                            step += 1
                            update(i, n, step)
                    t0 = span_t0[0]
                    materialize()
                    logger.info("iterations %d-%d dispatched as one device "
                                "block (%.1f ms)", it, it + n_it - 1,
                                1e3 * (time.perf_counter() - t0))
                    it += n_it
                    if validating:
                        validate(it - 1)
                    if (checkpoint_dir is not None
                            and (validating
                                 or step % checkpoint_interval == 0)):
                        # The iteration-boundary save, with this
                        # iteration's validation when validating.
                        save(step)
                    continue

                # ---- the per-step path: a resume that lands
                # mid-iteration, or checkpoints off iteration boundaries
                for ci, n in enumerate(names):
                    step += 1
                    if step <= done_steps:
                        continue  # resumed past this update
                    update(it, n, step)
                    # An iteration's last save waits for its validation,
                    # so a resume never skips the validation bookkeeping.
                    if (checkpoint_dir is not None
                            and step % checkpoint_interval == 0
                            and not (ci == n_coords - 1 and validating)):
                        save(step)
                if validating:
                    validate(it)
                    if checkpoint_dir is not None:
                        save(step)
                it += 1
            materialize()
        finally:
            for e in executables.values():
                e.close()
        # Each update's executable built once this run.
        self.tracing_guard.assert_max_retraces(per_fn=1)

        final = GameModel(dict(models), self.task_type)
        return CoordinateDescentResult(
            model=final, objective_history=objective_history,
            validation_history=validation_history,
            best_model=best_model if best_model is not None else final,
            best_metric=best_metric,
            trackers=LazyTrackers(trackers, pending_trackers),
            updates=updates, timings=timings, graphs=dict(self.graph_stats))

    def _validate(self, game_model: GameModel) -> Dict[str, float]:
        if self._val_scorer is None:
            from photon_ml_tpu_torch.models.device_scoring import (
                DeviceGameScorer,
            )
            self._val_scorer = DeviceGameScorer(
                game_model, self.validation_data, dtype=self.dtype,
                device=self.device)
        val_scores = self._val_scorer.score(game_model).cpu().numpy()
        return {ev.name: ev.evaluate_dataset(val_scores, self.validation_data)
                for ev in self.validation_evaluators}


def _rows_from_blocks(ds):
    """(labels, offsets, weights) of a random-effect dataset's rows, as
    float32 numpy in global row order (JAX coordinate_descent.py:588,
    which builds them in float32 too); padding rows land in a dropped
    sentinel slot."""
    n = ds.n_rows
    labels = np.zeros(n + 1, np.float32)
    offsets = np.zeros(n + 1, np.float32)
    weights = np.zeros(n + 1, np.float32)
    for blocks in (ds.blocks, [b for b in ds.passive_blocks if b is not None]):
        for b in blocks:
            rid = b.row_ids.cpu().numpy().ravel()
            labels[rid] = b.labels.cpu().numpy().ravel()
            offsets[rid] = b.offsets.cpu().numpy().ravel()
            weights[rid] = b.weights.cpu().numpy().ravel()
    return labels[:-1], offsets[:-1], weights[:-1]
