"""GameEstimator: data prep + coordinate construction + grid training
(port of photon_ml_tpu/estimators/game_estimator.py: FixedEffectSpec :42,
RandomEffectSpec :58, FactoredRandomEffectSpec :74-83, GameEstimator
:88-108 with ``mesh`` and .fit :110 with the factored wiring and the
mesh passed to every coordinate :124-173, per-combination checkpoints
:175-191, select_best :193, select_best_result :227; reference
ml/estimators/GameEstimator.scala:51-527).

``fit`` builds each random-effect dataset once, then trains one
coordinate-descent run per combination of per-coordinate configs. A
spec's ``normalization`` (a NormalizationContext over the coordinate's
global feature space, data/normalization.py) and its box constraints
``lower_bounds``/``upper_bounds`` (global [d] arrays, e.g. from
optimization/config.constraint_arrays) go to its coordinate (the
reference's per-problem normalization and constraintMap,
RandomEffectOptimizationProblem.scala:105-125). A factored spec's
dataset is built with the IDENTITY projector whatever its config says,
with no Pearson trim and no intercept column, and its coordinate draws
B from the fit's ``seed``. With ``checkpoint_dir`` each combination
checkpoints into its own ``combo-<i>/`` there, tagged with its
configurations, and a rerun resumes each one.

``mesh`` (a 1-D or 2-D `parallel.Mesh` whose first slot is ``device``;
None by default) goes to every coordinate, as in JAX: the fixed effects
shard their rows, the random and factored effects their entities, over
its data axis's slots (a 2-D mesh's data rows; algorithm/coordinates.py).
Each random-effect dataset is sharded once, before the combinations, so
its slots hold the only copy of its data. A fixed-effect spec's
``feature_sharding`` (FixedEffectSpec :43-54) shards its coefficients
over the mesh's model axis (the one axis of a 1-D mesh) as well.

``fused`` (True by default) runs each coordinate update on the card as
one replay of a CUDA graph captured once a run (algorithm/
coordinate_descent.py); False runs the eager plain loop. A mesh, and the
CPU, run eagerly whatever it says.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from photon_ml_tpu_torch.algorithm.coordinate_descent import (
    CoordinateDescent,
    CoordinateDescentResult,
)
from photon_ml_tpu_torch.algorithm.coordinates import (
    FactoredRandomEffectCoordinate,
    FixedEffectCoordinate,
    RandomEffectCoordinate,
    shard_re_dataset,
)
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.normalization import NormalizationContext
from photon_ml_tpu_torch.data.random_effect import (
    RandomEffectDataConfiguration,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.evaluation.evaluators import Evaluator
from photon_ml_tpu_torch.optimization.config import (
    FactoredRandomEffectOptimizationConfiguration,
    GLMOptimizationConfiguration,
)
from photon_ml_tpu_torch.types import TaskType

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class FixedEffectSpec:
    name: str
    feature_shard_id: str
    configs: Sequence[GLMOptimizationConfiguration]
    normalization: Optional[NormalizationContext] = None
    lower_bounds: Optional[object] = None
    upper_bounds: Optional[object] = None
    feature_sharding: bool = False  # coefficients over the mesh's model axis


@dataclasses.dataclass
class RandomEffectSpec:
    name: str
    data_config: RandomEffectDataConfiguration
    configs: Sequence[GLMOptimizationConfiguration]
    intercept_col: Optional[int] = None
    normalization: Optional[NormalizationContext] = None
    lower_bounds: Optional[object] = None
    upper_bounds: Optional[object] = None


@dataclasses.dataclass
class FactoredRandomEffectSpec:
    """Per-entity latent factors and a learned shared projection matrix;
    the dataset is built with the IDENTITY projector (B is the dimension
    reduction)."""

    name: str
    data_config: RandomEffectDataConfiguration
    configs: Sequence[FactoredRandomEffectOptimizationConfiguration]


CoordinateSpec = Union[FixedEffectSpec, RandomEffectSpec,
                       FactoredRandomEffectSpec]
Results = List[Tuple[Dict[str, GLMOptimizationConfiguration],
                     CoordinateDescentResult]]


def spec_dataset(data: GameDataset,
                 spec: Union[RandomEffectSpec, FactoredRandomEffectSpec],
                 seed: int = 0, dtype=torch.float32, device="cuda"):
    """The random-effect dataset ``fit`` builds for a spec. A factored
    spec's blocks carry global-width features whatever its config says:
    the IDENTITY projector, no Pearson trim, no intercept column."""
    cfg, intercept = spec.data_config, getattr(spec, "intercept_col", None)
    if isinstance(spec, FactoredRandomEffectSpec):
        cfg = dataclasses.replace(cfg, projector_type="IDENTITY",
                                  num_features_to_samples_ratio=None)
    return build_random_effect_dataset(data, cfg, seed=seed,
                                       intercept_col=intercept, dtype=dtype,
                                       device=device)


class GameEstimator:
    def __init__(self, task_type: TaskType,
                 coordinate_specs: Sequence[CoordinateSpec],
                 num_iterations: int = 1,
                 validation_evaluators: Sequence[Evaluator] = (),
                 dtype=torch.float32, device="cuda", mesh=None,
                 fused: bool = True):
        if not coordinate_specs:
            raise ValueError("at least one coordinate spec required")
        names = [s.name for s in coordinate_specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate coordinate names in {names}")
        self.task_type = task_type
        self.specs = list(coordinate_specs)
        self.num_iterations = num_iterations
        self.validation_evaluators = list(validation_evaluators)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.mesh = mesh
        self.fused = fused

    def fit(self, data: GameDataset,
            validation_data: Optional[GameDataset] = None,
            seed: int = 0, checkpoint_dir=None,
            checkpoint_interval: int = 1) -> Results:
        """Train one model per per-coordinate config combination."""
        re_datasets = {
            s.name: shard_re_dataset(
                spec_dataset(data, s, seed, self.dtype, self.device),
                self.mesh)[0]
            for s in self.specs
            if isinstance(s, (RandomEffectSpec, FactoredRandomEffectSpec))}

        results = []
        for combo_index, combo in enumerate(itertools.product(
                *[[(s.name, c) for c in s.configs] for s in self.specs])):
            configs = dict(combo)
            coords = {}
            for s in self.specs:
                if isinstance(s, FixedEffectSpec):
                    coords[s.name] = FixedEffectCoordinate(
                        name=s.name, data=data,
                        feature_shard_id=s.feature_shard_id,
                        task_type=self.task_type, config=configs[s.name],
                        normalization=s.normalization, dtype=self.dtype,
                        device=self.device, lower_bounds=s.lower_bounds,
                        upper_bounds=s.upper_bounds,
                        feature_sharding=s.feature_sharding, mesh=self.mesh)
                elif isinstance(s, FactoredRandomEffectSpec):
                    cfg = configs[s.name]
                    coords[s.name] = FactoredRandomEffectCoordinate(
                        name=s.name, dataset=re_datasets[s.name],
                        task_type=self.task_type,
                        config=cfg.random_effect,
                        latent_config=cfg.latent_factor, mf_config=cfg.mf,
                        seed=seed, mesh=self.mesh)
                else:
                    coords[s.name] = RandomEffectCoordinate(
                        name=s.name, dataset=re_datasets[s.name],
                        task_type=self.task_type, config=configs[s.name],
                        normalization=s.normalization,
                        lower_bounds=s.lower_bounds,
                        upper_bounds=s.upper_bounds, mesh=self.mesh)
            cd = CoordinateDescent(
                coords, self.task_type, validation_data=validation_data,
                validation_evaluators=self.validation_evaluators,
                dtype=self.dtype, device=self.device, fused=self.fused)
            tag = {k: v.to_string() for k, v in configs.items()}
            logger.info("training combo %s", tag)
            results.append((configs, cd.run(
                self.num_iterations, seed=seed,
                checkpoint_dir=(None if checkpoint_dir is None else
                                Path(checkpoint_dir) / f"combo-{combo_index}"),
                checkpoint_interval=checkpoint_interval,
                checkpoint_tag=tag)))
        return results

    def select_best(self, results: Results):
        """Best combination by the first validation evaluator, else by the
        training objective (cli/game/training/Driver.selectBestModel)."""
        return select_best_result(results, self.validation_evaluators)


def _config_lambda_key(configs: Dict[str, GLMOptimizationConfiguration]):
    """Regularization weights in sorted coordinate-name order (a factored
    effect's latent solves' weight): breaks exact metric/objective ties
    toward the smallest lambda."""
    return tuple(float(getattr(cfg, "random_effect", cfg)
                       .regularization_weight)
                 for _, cfg in sorted(configs.items()))


def select_best_result(results: Results, validation_evaluators):
    """Best combo by the first validation evaluator when validation
    produced metrics, else lowest final training objective; exact ties
    go to the smallest lambda (game_estimator.py:227-258)."""
    if not results:
        raise ValueError("no results")
    if validation_evaluators and results[0][1].validation_history \
            and results[0][1].validation_history[-1]:
        head = validation_evaluators[0]
        best = None
        for item in results:
            metric = item[1].validation_history[-1][head.name]
            if best is None or head.better_than(metric, best[0]) or (
                    metric == best[0]
                    and _config_lambda_key(item[0])
                    < _config_lambda_key(best[1][0])):
                best = (metric, item)
        return best[1]
    return min(results, key=lambda item: (item[1].objective_history[-1],
                                          _config_lambda_key(item[0])))
