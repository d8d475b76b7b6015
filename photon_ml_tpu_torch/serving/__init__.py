"""Streaming GAME serving (port of photon_ml_tpu/serving/__init__.py, the
names ported so far).

``DeviceGameScorer`` (models/device_scoring.py) freezes one dataset and
varies the model; this package is the inverse production shape: the
model is frozen on the device while request data varies per call.
Requests are padded into a small ladder of static bucket shapes, each
scored by one CUDA graph held in an explicit cache.

Imports are lazy (PEP 562): ``serving.kernels`` is shared with
``models.device_scoring``, and eager engine imports here would cycle
through the model hierarchy. The network front door, adaptive admission
and the replica router are ROADMAP A5d.
"""

from __future__ import annotations

_EXPORTS = {
    "BucketLadder": "photon_ml_tpu_torch.serving.buckets",
    "StreamingGameScorer": "photon_ml_tpu_torch.serving.engine",
    "ExecutableCache": "photon_ml_tpu_torch.serving.engine",
    "ServingFrontend": "photon_ml_tpu_torch.serving.frontend",
    "FrontendConfig": "photon_ml_tpu_torch.serving.frontend",
    "FrontendError": "photon_ml_tpu_torch.serving.frontend",
    "RequestRejected": "photon_ml_tpu_torch.serving.frontend",
    "UnknownModelError": "photon_ml_tpu_torch.serving.frontend",
    "UnsupportedSubModelError": "photon_ml_tpu_torch.serving.kernels",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
