"""Stopwatch + measure combinators (a copy of photon_ml_tpu/utils/timer.py:1-68;
reference: ml/util/Timer.scala:32-236)."""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple, TypeVar

T = TypeVar("T")


class Timer:
    def __init__(self):
        self._start: Optional[float] = None
        self._stop: Optional[float] = None

    def start(self) -> "Timer":
        if self._start is not None and self._stop is None:
            raise RuntimeError("timer already running")
        self._start = time.perf_counter()
        self._stop = None
        return self

    def stop(self) -> "Timer":
        if self._start is None or self._stop is not None:
            raise RuntimeError("timer is not running")
        self._stop = time.perf_counter()
        return self

    @property
    def duration_seconds(self) -> float:
        if self._start is None:
            raise RuntimeError("timer never started")
        return (self._stop if self._stop is not None
                else time.perf_counter()) - self._start

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @classmethod
    def measure(cls, fn: Callable[[], T]) -> Tuple[T, float]:
        t = cls().start()
        out = fn()
        t.stop()
        return out, t.duration_seconds


class PhaseTimer:
    """Named phase timings (the driver/estimator stage logs)."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    def time(self, name: str):
        outer = self

        class _Ctx:
            def __enter__(self):
                self.t = Timer().start()
                return self

            def __exit__(self, *exc):
                outer.phases[name] = outer.phases.get(name, 0.0) + \
                    self.t.stop().duration_seconds

        return _Ctx()
