"""Cross-cutting utilities: logging, timing, events, the tracing guard
(port of photon_ml_tpu/utils/; the exports are the JAX package's). None
of these modules imports torch, so a torch-free process may import
the package."""

from photon_ml_tpu_torch.utils.timer import Timer
from photon_ml_tpu_torch.utils.logging_utils import setup_photon_logger
from photon_ml_tpu_torch.utils.events import (
    Event,
    EventEmitter,
    EventListener,
    PhotonOptimizationLogEvent,
    TrainingFinishEvent,
    TrainingStartEvent,
)
from photon_ml_tpu_torch.utils.tracing_guard import (
    RetraceError,
    TracingGuard,
    assert_max_retraces,
    trace_count,
)

__all__ = [
    "Timer",
    "setup_photon_logger",
    "Event",
    "EventEmitter",
    "EventListener",
    "PhotonOptimizationLogEvent",
    "TrainingStartEvent",
    "TrainingFinishEvent",
    "RetraceError",
    "TracingGuard",
    "assert_max_retraces",
    "trace_count",
]
