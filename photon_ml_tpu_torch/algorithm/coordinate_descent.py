"""Block coordinate descent over named coordinates — the GAME outer loop
(port of photon_ml_tpu/algorithm/coordinate_descent.py:
CoordinateDescent :101, run :240-492 with its checkpoints and resume
:245-330, _training_rows :494, _rows_from_blocks :588; reference
ml/algorithm/CoordinateDescent.scala:41-271).

For each iteration, for each coordinate in the updating sequence: the
residual is the sum of the other coordinates' scores, recomputed fresh;
the coordinate re-solves against it as extra offsets and re-scores; the
full objective sum_i w_i l(total_i + offset_i, y_i) + sum_c penalty_c is
recomputed; after each iteration the validation set is scored and the
best model by the first evaluator is kept.

Checkpoints (``checkpoint_dir``, utils/checkpoint.py) are saved every
``checkpoint_interval`` updates and at each validated iteration's end,
and a run resumes from the latest one there. Update ``step`` draws from a
``torch.Generator`` seeded from (seed, step), so a resumed run is bit for
bit the uninterrupted one, as the JAX package's ``fold_in(base, step)``
makes it. A model whose first coordinate is a random effect takes its
rows (labels, offsets, weights) from that coordinate's blocks.

A host loop: the JAX package's ``lax.scan`` fusion of whole iterations
(:169) and its retrace guard are not ported. Each update ends with one
host sync (its objective value), so the recorded per-update seconds
include the device work.
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
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import checkpoint as ckpt

logger = logging.getLogger(__name__)

Tensor = torch.Tensor


@dataclasses.dataclass
class CoordinateDescentResult:
    model: GameModel
    objective_history: List[float]  # one entry per coordinate update
    validation_history: List[Dict[str, float]]  # one entry per iteration
    best_model: Optional[GameModel]
    best_metric: Optional[float]
    trackers: Dict[str, list]  # coordinate -> per-update OptimizerResults
    # One record per update: iteration, coordinate, seconds, objective.
    updates: List[dict]
    # coordinate -> seconds summed over its updates (the training
    # driver's coordinateSeconds).
    timings: Dict[str, float]


class CoordinateDescent:
    def __init__(self, coordinates: Dict[str, Coordinate],
                 task_type: TaskType,
                 validation_data: Optional[GameDataset] = None,
                 validation_evaluators: Sequence[Evaluator] = (),
                 dtype=torch.float32, device="cuda"):
        if not coordinates:
            raise ValueError("at least one coordinate is required")
        self.coordinates = dict(coordinates)
        self.task_type = task_type
        self.validation_data = validation_data
        self.validation_evaluators = list(validation_evaluators)
        self.dtype = dtype
        self.device = resolve_device(device)
        self._val_scorer = None

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

    def _objective(self, total: Tensor, rows, models) -> Tensor:
        loss = loss_for_task(self.task_type)
        labels, offsets, weights = rows
        obj = torch.sum(weights * loss.loss(total + offsets, labels))
        for n, coord in self.coordinates.items():
            for c, l1, l2 in coord.penalties(models[n]):
                obj = obj + 0.5 * l2 * torch.sum(c * c)
                if l1:
                    obj = obj + l1 * torch.sum(torch.abs(c))
        return obj

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

        def save(step):
            ckpt.save_checkpoint(checkpoint_dir, ckpt.CheckpointState(
                step=step, models=models,
                objective_history=list(objective_history),
                validation_history=validation_history,
                best_metric=best_metric,
                best_models=(dict(best_model.models)
                             if best_model is not None else None),
                timings=timings, trackers=trackers, meta=meta,
                updates=updates))

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

        # Scores are a function of the models, so after a resume they are
        # the uninterrupted run's bits.
        scores = {n: self.coordinates[n].score(models[n]) for n in names}
        rows = self._training_rows()
        validating = (self.validation_data is not None
                      and bool(self.validation_evaluators))

        for it in range(num_iterations):
            if (it + 1) * n_coords <= done_steps:
                continue  # restored with its validation
            for ci, n in enumerate(names):
                step = it * n_coords + ci + 1
                if step <= done_steps:
                    continue
                t0 = time.perf_counter()
                coord = self.coordinates[n]
                residual = None
                for m in names:
                    if m != n:
                        residual = (scores[m] if residual is None
                                    else residual + scores[m])
                models[n], tracker = coord.update_model(
                    models[n], residual,
                    ckpt.step_generator(seed, step, self.device))
                scores[n] = coord.score(models[n])
                total = scores[n] if residual is None else residual + scores[n]
                obj = float(self._objective(total, rows, models))
                seconds = time.perf_counter() - t0
                objective_history.append(obj)
                trackers[n].append(tracker)
                timings[n] += seconds
                updates.append({"iteration": it, "coordinate": n,
                                "seconds": seconds, "objective": obj})
                logger.info("iter %d coordinate %s updated (%.1f ms), "
                            "objective %.6f", it, n, 1e3 * seconds, obj,
                            extra={"update": updates[-1]})
                # An iteration's last save waits for its validation, so a
                # resume never skips the validation bookkeeping.
                if (checkpoint_dir is not None
                        and step % checkpoint_interval == 0
                        and not (ci == n_coords - 1 and validating)):
                    save(step)
            if validating:
                game_model = GameModel(dict(models), self.task_type)
                metrics = self._validate(game_model)
                validation_history.append(metrics)
                head = self.validation_evaluators[0]
                if head.better_than(metrics[head.name], best_metric):
                    best_metric, best_model = metrics[head.name], game_model
                logger.info("iter %d validation: %s", it, metrics)
                if checkpoint_dir is not None:
                    save((it + 1) * n_coords)

        final = GameModel(dict(models), self.task_type)
        return CoordinateDescentResult(
            model=final, objective_history=objective_history,
            validation_history=validation_history,
            best_model=best_model if best_model is not None else final,
            best_metric=best_metric, trackers=trackers, updates=updates,
            timings=timings)

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
