"""GAME block-coordinate-descent algorithm layer (port of
photon_ml_tpu/algorithm/; the exports are the JAX package's, and
LazyTrackers, the trackers a fused run returns)."""

from photon_ml_tpu_torch.algorithm.coordinates import (
    Coordinate,
    FactoredRandomEffectCoordinate,
    FixedEffectCoordinate,
    RandomEffectCoordinate,
    StreamingFactoredRandomEffectCoordinate,
    StreamingFixedEffectCoordinate,
)
from photon_ml_tpu_torch.algorithm.coordinate_descent import (
    CoordinateDescent,
    LazyTrackers,
)

__all__ = [
    "Coordinate",
    "FactoredRandomEffectCoordinate",
    "FixedEffectCoordinate",
    "RandomEffectCoordinate",
    "StreamingFactoredRandomEffectCoordinate",
    "StreamingFixedEffectCoordinate",
    "CoordinateDescent",
    "LazyTrackers",
]
