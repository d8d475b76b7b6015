"""Optimizer / regularization configuration and box constraints (port of
photon_ml_tpu/optimization/config.py:19-228 with OptimizerConfig :85,
the matrix-factorization
configurations :233-310 and parse_constraint_string / constraint_arrays
:313-370).

Mirrors the reference's config vocabulary so CLI strings and model
metadata round-trip compatibly:
- OptimizerType {LBFGS, TRON} (ml/optimization/OptimizerType.scala:17)
- RegularizationType {NONE, L1, L2, ELASTIC_NET}, elastic-net weight split
  L1 = alpha*lambda, L2 = (1-alpha)*lambda
  (ml/optimization/RegularizationContext.scala:35-113)
- the six-field "maxIter,tol,lambda,downSampleRate,optimizer,regType" string
  (ml/optimization/GLMOptimizationConfiguration.scala:56-90)
- the "maxIter,numFactors" MF string and the ';'-joined factored-random-
  effect triple (ml/optimization/game/MFOptimizationConfiguration.scala)
- the GLMSuite box-constraint JSON (ml/io/GLMSuite.scala:207-260)
"""

from __future__ import annotations

import dataclasses
import enum
import json
import math
from typing import Dict, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.data.index_map import IndexMap, feature_key

# feature index -> (lower, upper)
ConstraintMap = Dict[int, Tuple[float, float]]


class OptimizerType(str, enum.Enum):
    LBFGS = "LBFGS"
    TRON = "TRON"


class RegularizationType(str, enum.Enum):
    NONE = "NONE"
    L1 = "L1"
    L2 = "L2"
    ELASTIC_NET = "ELASTIC_NET"


@dataclasses.dataclass(frozen=True)
class RegularizationContext:
    """Splits a total regularization weight into L1/L2 parts
    (ml/optimization/RegularizationContext.scala)."""

    reg_type: RegularizationType = RegularizationType.NONE
    elastic_net_alpha: Optional[float] = None

    def __post_init__(self):
        if self.reg_type == RegularizationType.ELASTIC_NET:
            a = self.elastic_net_alpha
            if a is None or not (0.0 <= a <= 1.0):
                raise ValueError(
                    f"ELASTIC_NET requires alpha in [0, 1], got {a}")
        elif self.elastic_net_alpha is not None:
            raise ValueError(
                f"alpha is only valid for ELASTIC_NET, got {self.reg_type}")

    def l1_weight(self, reg_weight: float) -> float:
        if self.reg_type == RegularizationType.L1:
            return reg_weight
        if self.reg_type == RegularizationType.ELASTIC_NET:
            return self.elastic_net_alpha * reg_weight
        return 0.0

    def l2_weight(self, reg_weight: float) -> float:
        if self.reg_type == RegularizationType.L2:
            return reg_weight
        if self.reg_type == RegularizationType.ELASTIC_NET:
            return (1.0 - self.elastic_net_alpha) * reg_weight
        return 0.0

    def to_json(self) -> Dict:
        return {"regularizationType": self.reg_type.value,
                "elasticNetParam": self.elastic_net_alpha}


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """What the optimizer factory needs (ml/optimization/OptimizerConfig.scala).

    Defaults are per-optimizer in the factory (LBFGS: 100/1e-7,
    TRON: 15/1e-5), so None here means "use the optimizer's default".
    """

    optimizer_type: OptimizerType = OptimizerType.LBFGS
    max_iterations: Optional[int] = None
    tolerance: Optional[float] = None
    constraint_map: Optional[ConstraintMap] = None

    def __post_init__(self):
        if self.max_iterations is not None and self.max_iterations <= 0:
            raise ValueError(
                f"maxIterations must be positive, got {self.max_iterations}")
        if self.tolerance is not None and self.tolerance <= 0:
            raise ValueError(
                f"tolerance must be positive, got {self.tolerance}")

    def resolved(self) -> "OptimizerConfig":
        if self.optimizer_type == OptimizerType.TRON:
            mi, tol = 15, 1e-5
        else:
            mi, tol = 100, 1e-7
        return dataclasses.replace(
            self,
            max_iterations=(
                self.max_iterations if self.max_iterations is not None else mi),
            tolerance=self.tolerance if self.tolerance is not None else tol,
        )

    def to_json(self) -> Dict:
        r = self.resolved()
        return {
            "optimizerType": r.optimizer_type.value,
            "maximumIterations": r.max_iterations,
            "tolerance": r.tolerance,
            "constraintMap": (
                None if r.constraint_map is None
                else {str(k): list(v) for k, v in r.constraint_map.items()}),
        }

    @classmethod
    def from_json(cls, d: Dict) -> "OptimizerConfig":
        cm = d.get("constraintMap")
        return cls(
            OptimizerType(d["optimizerType"]),
            d.get("maximumIterations"),
            d.get("tolerance"),
            None if cm is None else {int(k): tuple(v) for k, v in cm.items()},
        )


@dataclasses.dataclass(frozen=True)
class GLMOptimizationConfiguration:
    """Per-coordinate optimization config. String form:
      "maxIter,tolerance,regWeight,downSamplingRate,optimizerType,regType[,alpha]"
    """

    max_iterations: int = 20
    tolerance: float = 1e-5
    regularization_weight: float = 0.0
    down_sampling_rate: float = 1.0
    optimizer_type: OptimizerType = OptimizerType.LBFGS
    regularization_context: RegularizationContext = dataclasses.field(
        default_factory=RegularizationContext)

    def __post_init__(self):
        if (self.regularization_weight > 0 and
                self.regularization_context.reg_type ==
                RegularizationType.NONE):
            # Reference semantics: under NONE the weight is ignored.
            object.__setattr__(self, "regularization_weight", 0.0)
        if not (0.0 < self.down_sampling_rate <= 1.0):
            raise ValueError(
                f"downSamplingRate must be in (0, 1], got "
                f"{self.down_sampling_rate}")
        if self.regularization_weight < 0:
            raise ValueError(
                f"regularization weight must be >= 0, got "
                f"{self.regularization_weight}")
        if self.max_iterations <= 0:
            raise ValueError(
                f"maxIterations must be positive, got {self.max_iterations}")
        if self.tolerance <= 0:
            raise ValueError(
                f"tolerance must be positive, got {self.tolerance}")

    @property
    def l1_weight(self) -> float:
        return self.regularization_context.l1_weight(
            self.regularization_weight)

    @property
    def l2_weight(self) -> float:
        return self.regularization_context.l2_weight(
            self.regularization_weight)

    @classmethod
    def parse(cls, s: str) -> "GLMOptimizationConfiguration":
        parts = [p.strip() for p in s.split(",") if p.strip()]
        if len(parts) not in (6, 7):
            raise ValueError(
                f"expected 'maxIter,tol,regWeight,downSamplingRate,"
                f"optimizerType,regType[,alpha]', got {s!r}")
        alpha = float(parts[6]) if len(parts) == 7 else None
        reg_type = RegularizationType(parts[5].upper())
        if reg_type != RegularizationType.ELASTIC_NET:
            alpha = None
        return cls(
            max_iterations=int(parts[0]),
            tolerance=float(parts[1]),
            regularization_weight=float(parts[2]),
            down_sampling_rate=float(parts[3]),
            optimizer_type=OptimizerType(parts[4].upper()),
            regularization_context=RegularizationContext(reg_type, alpha),
        )

    def to_string(self) -> str:
        base = (f"{self.max_iterations},{self.tolerance},"
                f"{self.regularization_weight},{self.down_sampling_rate},"
                f"{self.optimizer_type.value},"
                f"{self.regularization_context.reg_type.value}")
        if self.regularization_context.reg_type == \
                RegularizationType.ELASTIC_NET:
            base += f",{self.regularization_context.elastic_net_alpha}"
        return base

    def to_json(self) -> Dict:
        return {"maxIterations": self.max_iterations,
                "tolerance": self.tolerance,
                "regularizationWeight": self.regularization_weight,
                "downSamplingRate": self.down_sampling_rate,
                "optimizerType": self.optimizer_type.value,
                **self.regularization_context.to_json()}

    @classmethod
    def from_json(cls, d: Dict) -> "GLMOptimizationConfiguration":
        return cls(
            max_iterations=d["maxIterations"], tolerance=d["tolerance"],
            regularization_weight=d["regularizationWeight"],
            down_sampling_rate=d.get("downSamplingRate", 1.0),
            optimizer_type=OptimizerType(d["optimizerType"]),
            regularization_context=RegularizationContext(
                RegularizationType(d["regularizationType"]),
                d.get("elasticNetParam")))


@dataclasses.dataclass(frozen=True)
class MFOptimizationConfiguration:
    """Matrix-factorization knobs of a factored random effect, string form
    "maxIter,numFactors": ``max_iterations`` alternations of the
    per-entity latent solves and the projection-matrix refit per
    coordinate update; ``num_factors`` the latent dimension k."""

    max_iterations: int = 1
    num_factors: int = 5

    def __post_init__(self):
        if self.max_iterations <= 0:
            raise ValueError(
                f"maxIterations must be positive, got {self.max_iterations}")
        if self.num_factors <= 0:
            raise ValueError(
                f"numFactors must be positive, got {self.num_factors}")

    @classmethod
    def parse(cls, s: str) -> "MFOptimizationConfiguration":
        parts = [p.strip() for p in s.split(",") if p.strip()]
        if len(parts) != 2:
            raise ValueError(
                f"expected 'maxNumberIterations,numFactors', got {s!r}")
        return cls(max_iterations=int(parts[0]), num_factors=int(parts[1]))

    def to_string(self) -> str:
        return f"{self.max_iterations},{self.num_factors}"

    def to_json(self) -> Dict:
        return {"maxIterations": self.max_iterations,
                "numFactors": self.num_factors}

    @classmethod
    def from_json(cls, d: Dict) -> "MFOptimizationConfiguration":
        return cls(d["maxIterations"], d["numFactors"])


@dataclasses.dataclass(frozen=True)
class FactoredRandomEffectOptimizationConfiguration:
    """A factored random effect's configurations: the per-entity latent
    solves, the projection-matrix refit and the MF knobs, string form
    'reCfg;latentCfg;maxIter,numFactors'."""

    random_effect: GLMOptimizationConfiguration
    latent_factor: GLMOptimizationConfiguration
    mf: MFOptimizationConfiguration

    @classmethod
    def parse(cls, s: str
              ) -> "FactoredRandomEffectOptimizationConfiguration":
        parts = s.split(";")
        if len(parts) != 3:
            raise ValueError(
                "expected 'reOptConfig;latentOptConfig;mfConfig' "
                f"(';'-separated), got {s!r}")
        return cls(GLMOptimizationConfiguration.parse(parts[0]),
                   GLMOptimizationConfiguration.parse(parts[1]),
                   MFOptimizationConfiguration.parse(parts[2]))

    def to_string(self) -> str:
        return (f"{self.random_effect.to_string()};"
                f"{self.latent_factor.to_string()};{self.mf.to_string()}")

    def to_json(self) -> Dict:
        return {"randomEffect": self.random_effect.to_json(),
                "latentFactor": self.latent_factor.to_json(),
                "mf": self.mf.to_json()}

    @classmethod
    def from_json(cls, d: Dict
                  ) -> "FactoredRandomEffectOptimizationConfiguration":
        return cls(GLMOptimizationConfiguration.from_json(d["randomEffect"]),
                   GLMOptimizationConfiguration.from_json(d["latentFactor"]),
                   MFOptimizationConfiguration.from_json(d["mf"]))


def parse_constraint_string(s: str, index_map) -> ConstraintMap:
    """Parse the reference's box-constraint JSON: a list of
    {"name": ..., "term": ..., "lowerBound": ..., "upperBound": ...} with
    "*" wildcards for name and term (a missing bound is unbounded, a
    missing term is ""). ``index_map`` is an IndexMap, as the JAX parser
    takes it, or a mapping of (name, term) to the feature index; keys it
    lacks are skipped. A {"*", "*"} entry applies to every feature no
    other entry constrains. Returns {index: (lower, upper)}."""
    out: ConstraintMap = {}
    wildcard_all: Optional[Tuple[float, float]] = None
    for e in json.loads(s):
        name = e["name"]
        term = e.get("term", "")
        lb = float(e.get("lowerBound", -math.inf))
        ub = float(e.get("upperBound", math.inf))
        if lb > ub:
            raise ValueError(f"lowerBound > upperBound in constraint {e}")
        if name == "*" and term == "*":
            wildcard_all = (lb, ub)
        elif name == "*" or term == "*":
            for (kname, kterm), idx in index_map.items():
                if (name == "*" or kname == name) and \
                        (term == "*" or kterm == term):
                    out[idx] = (lb, ub)
        else:
            idx = (index_map.get_index(feature_key(name, term))
                   if isinstance(index_map, IndexMap)
                   else index_map.get((name, term), -1))
            if idx >= 0:
                out[idx] = (lb, ub)
    if wildcard_all is not None:
        for _, idx in index_map.items():
            out.setdefault(idx, wildcard_all)
    return out


def constraint_arrays(constraint_map: Optional[ConstraintMap],
                      num_features: int, intercept_id: int = -1
                      ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Dense float64 (lower, upper) arrays from a constraint map:
    unconstrained features get (-inf, +inf) and the intercept is never
    constrained. (None, None) for an empty or missing map."""
    if not constraint_map:
        return None, None
    lo = np.full(num_features, -np.inf)
    hi = np.full(num_features, np.inf)
    for idx, (lb, ub) in constraint_map.items():
        if idx == intercept_id:
            continue
        lo[idx] = lb
        hi[idx] = ub
    return lo, hi
