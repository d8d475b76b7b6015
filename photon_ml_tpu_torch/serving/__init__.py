"""Streaming GAME serving (port of photon_ml_tpu/serving/__init__.py).

``DeviceGameScorer`` (models/device_scoring.py) freezes one dataset and
varies the model; this package is the inverse production shape: the
model is frozen on the device while request data varies per call.
Requests are padded into a small ladder of static bucket shapes, each
scored by one CUDA graph held in an explicit cache.

Imports are lazy (PEP 562): ``serving.kernels`` is shared with
``models.device_scoring``, and eager engine imports here would cycle
through the model hierarchy, and the replica router (router.py over
wire.py) must load without torch.
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
    # Network front door (netserver.py, its dataset-free codec in
    # wire.py): dual-framing listener, client and typed wire errors over
    # the front-end's admission path.
    "NetServer": "photon_ml_tpu_torch.serving.netserver",
    "NetServerConfig": "photon_ml_tpu_torch.serving.netserver",
    "NetClient": "photon_ml_tpu_torch.serving.netserver",
    "WireError": "photon_ml_tpu_torch.serving.wire",
    "MalformedFrame": "photon_ml_tpu_torch.serving.wire",
    "FrameTooLarge": "photon_ml_tpu_torch.serving.wire",
    "HeaderTimeout": "photon_ml_tpu_torch.serving.wire",
    "ClientDisconnect": "photon_ml_tpu_torch.serving.wire",
    "ServerError": "photon_ml_tpu_torch.serving.wire",
    # SLO-adaptive admission (adaptive.py) and the replica fleet router
    # (router.py).
    "AdaptiveAdmission": "photon_ml_tpu_torch.serving.adaptive",
    "AdaptiveAdmissionConfig": "photon_ml_tpu_torch.serving.adaptive",
    "WindowedBurn": "photon_ml_tpu_torch.serving.adaptive",
    "ReplicaRouter": "photon_ml_tpu_torch.serving.router",
    "RouterConfig": "photon_ml_tpu_torch.serving.router",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
