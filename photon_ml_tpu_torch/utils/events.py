"""Event system for external observers (a copy of
photon_ml_tpu/utils/events.py:1-84)
(reference: ml/event/Event.scala:27-60, EventEmitter.scala:24-72,
EventListener.scala:20-31 — listener classes registered by name from CLI
params, ml/Driver.scala:109-118)."""

from __future__ import annotations

import dataclasses
import importlib
import threading
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Event:
    pass


@dataclasses.dataclass
class PhotonSetupEvent(Event):
    params: Dict[str, Any]


@dataclasses.dataclass
class TrainingStartEvent(Event):
    job_name: str


@dataclasses.dataclass
class TrainingFinishEvent(Event):
    job_name: str
    duration_seconds: float


@dataclasses.dataclass
class PhotonOptimizationLogEvent(Event):
    """Per-λ optimization telemetry (tracker states + metrics)."""

    reg_weight: float
    iterations: int
    converged_reason: str
    final_value: float
    metrics: Optional[Dict[str, float]] = None


class EventListener:
    def on_event(self, event: Event) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class EventEmitter:
    """Thread-safe listener registry mixin."""

    def __init__(self):
        self._listeners: List[EventListener] = []
        self._lock = threading.Lock()

    def register_listener(self, listener: EventListener) -> None:
        with self._lock:
            self._listeners.append(listener)

    def register_listener_by_name(self, class_path: str) -> None:
        """Reflective registration, e.g. 'my.module.MyListener'
        (the reference loads listener classes by name the same way)."""
        module, _, cls = class_path.rpartition(".")
        listener = getattr(importlib.import_module(module), cls)()
        if not isinstance(listener, EventListener):
            raise TypeError(f"{class_path} is not an EventListener")
        self.register_listener(listener)

    def send_event(self, event: Event) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for listener in listeners:
            listener.on_event(event)

    def clear_listeners(self) -> None:
        with self._lock:
            for listener in self._listeners:
                listener.close()
            self._listeners.clear()
