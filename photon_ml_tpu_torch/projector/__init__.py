"""Random-effect projectors (port of photon_ml_tpu/projector/; see
projectors.py; the exports are the JAX package's)."""

from photon_ml_tpu_torch.projector.projectors import (
    IndexMapProjector,
    ProjectionMatrix,
    build_random_effect_projector,
)

__all__ = [
    "IndexMapProjector",
    "ProjectionMatrix",
    "build_random_effect_projector",
]
