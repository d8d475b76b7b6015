"""Generalized linear models (port of photon_ml_tpu/models/glm.py:25-128,
with model_class_by_name :127 for model files;
reference ml/supervised/model/GeneralizedLinearModel.scala:30-143)."""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from photon_ml_tpu_torch.constants import POSITIVE_RESPONSE_THRESHOLD
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.ops.losses import (
    LogisticLoss,
    PointwiseLoss,
    PoissonLoss,
    SmoothedHingeLoss,
    SquaredLoss,
)
from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GeneralizedLinearModel:
    """score = coef . x + offset; mean = link^{-1}(score)."""

    coefficients: Coefficients

    task_type: ClassVar[TaskType]
    loss: ClassVar[PointwiseLoss]

    def compute_score(self, features) -> Tensor:
        return self.coefficients.compute_score(features)

    def compute_mean(self, features, offsets=0.0) -> Tensor:
        return self.mean_of_score(self.compute_score(features) + offsets)

    @staticmethod
    def mean_of_score(score: Tensor) -> Tensor:
        raise NotImplementedError

    def update_coefficients(self, coefficients: Coefficients):
        return type(self)(coefficients)

    @property
    def model_class_name(self) -> str:
        return type(self).__name__


class LogisticRegressionModel(GeneralizedLinearModel):
    task_type = TaskType.LOGISTIC_REGRESSION
    loss = LogisticLoss

    @staticmethod
    def mean_of_score(score: Tensor) -> Tensor:
        return torch.sigmoid(score)

    def predict_class(self, features, offsets=0.0,
                      threshold=POSITIVE_RESPONSE_THRESHOLD) -> Tensor:
        return (self.compute_mean(features, offsets) >= threshold).to(
            torch.float32)


class LinearRegressionModel(GeneralizedLinearModel):
    task_type = TaskType.LINEAR_REGRESSION
    loss = SquaredLoss

    @staticmethod
    def mean_of_score(score: Tensor) -> Tensor:
        return score


class PoissonRegressionModel(GeneralizedLinearModel):
    task_type = TaskType.POISSON_REGRESSION
    loss = PoissonLoss

    @staticmethod
    def mean_of_score(score: Tensor) -> Tensor:
        return torch.exp(score)


class SmoothedHingeLossLinearSVMModel(GeneralizedLinearModel):
    task_type = TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM
    loss = SmoothedHingeLoss

    @staticmethod
    def mean_of_score(score: Tensor) -> Tensor:
        return score  # raw margin; classification via threshold 0

    def predict_class(self, features, offsets=0.0, threshold=0.0) -> Tensor:
        return (self.compute_mean(features, offsets) >= threshold).to(
            torch.float32)


_MODEL_BY_TASK = {
    m.task_type: m
    for m in (LogisticRegressionModel, LinearRegressionModel,
              PoissonRegressionModel, SmoothedHingeLossLinearSVMModel)
}


_MODEL_BY_NAME = {m.__name__: m for m in _MODEL_BY_TASK.values()}


def model_for_task(task: TaskType) -> type:
    return _MODEL_BY_TASK[task]


def model_class_by_name(name: str) -> type:
    """The class a model file's ``modelClass`` names."""
    return _MODEL_BY_NAME[name]
