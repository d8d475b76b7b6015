"""SLO-adaptive admission control: close the loop from burn rate to the
front-end's live knobs (port of photon_ml_tpu/serving/adaptive.py: the
metrics :59-64, _frac_over_delta :67-83, WindowedBurn :86-148,
AdaptiveAdmissionConfig :151-169, AdaptiveAdmission :172-302).

The front-end's admission bound (``max_pending``) and coalesce window
are static config, but the right numbers depend on load: under overload
a smaller pending bound sheds earlier (the queue a completed request
waits behind stays short) and a larger window packs denser dispatches;
at light load both should sit at their configured baseline.

The controller reads the declared SLOs' burn rate each tick and actuates
both knobs with hysteresis:

- ``burn > high_burn``: tighten at once: ``frontend.max_pending`` times
  ``tighten_factor`` (floor ``min_pending``), ``frontend.
  coalesce_window_s`` times ``window_grow`` (at least
  ``window_floor_s``, at most ``window_cap_s``);
- ``burn < low_burn`` (or no traffic) for ``relax_ticks`` consecutive
  ticks: relax one step, pending times ``relax_factor`` (at most the
  configured baseline), window times ``window_shrink`` (at least the
  baseline window);
- in between: dead band, no actuation, and the relax streak resets.

Burn is measured over the last tick only: the tracker diffs histogram
bucket state and counter values between ticks, so the controller never
steers on a process-lifetime average. It reads the port's registry.

Telemetry, as in JAX: gauges ``serving.adaptive.burn_rate``,
``.shed_threshold`` and ``.coalesce_window_s``, counters
``serving.adaptive.ticks``, ``.tightens`` and ``.relaxes``.
``apply=False`` is a dry run: burn is measured and published, nothing is
actuated. Ticks are event-loop work (``asyncio.sleep`` and dict
arithmetic); the controller owns no device.
"""

from __future__ import annotations

import asyncio
import bisect
import dataclasses
import importlib
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.telemetry.slo import (
    LatencyObjective,
    Objective,
    ValueObjective,
    parse_slo,
)

_reg = importlib.import_module("photon_ml_tpu_torch.telemetry.registry")

_G_BURN = telemetry.gauge("serving.adaptive.burn_rate")
_G_SHED = telemetry.gauge("serving.adaptive.shed_threshold")
_G_WINDOW = telemetry.gauge("serving.adaptive.coalesce_window_s")
_M_TICKS = telemetry.counter("serving.adaptive.ticks")
_M_TIGHTENS = telemetry.counter("serving.adaptive.tightens")
_M_RELAXES = telemetry.counter("serving.adaptive.relaxes")


def _frac_over_delta(bounds: Sequence[float], delta_cum: Sequence[float],
                     delta_count: float, threshold: float) -> float:
    """slo._frac_over_threshold on a per-tick delta of a histogram's
    cumulative bucket state (the same interpolation and the same
    conservative reading of the overflow bucket)."""
    i = bisect.bisect_left(bounds, threshold)
    if i >= len(bounds):
        good = delta_cum[-1]
    else:
        lo = bounds[i - 1] if i > 0 else 0.0
        prev = delta_cum[i - 1] if i > 0 else 0
        in_bucket = delta_cum[i] - prev
        frac = ((threshold - lo) / (bounds[i] - lo)
                if bounds[i] > lo else 1.0)
        good = prev + frac * in_bucket
    return max(0.0, min(1.0, 1.0 - good / delta_count))


class WindowedBurn:
    """Per-tick burn rate over declared SLOs: each ``measure()`` judges
    only the traffic since the previous call (histogram buckets and
    counters diffed against remembered state; value objectives read their
    gauge as it is). Returns the largest burn across objectives, or
    ``None`` when no objective saw traffic this tick."""

    def __init__(self, specs: Sequence[Union[Objective, str]]):
        self.objectives: Tuple[Objective, ...] = tuple(
            parse_slo(s) if isinstance(s, str) else s for s in specs)
        self._hist_state: Dict[str, Tuple[Tuple[float, ...], float]] = {}
        self._counter_state: Dict[str, float] = {}

    def _counter_delta(self, name: str, reg) -> float:
        v = float(reg.counter(name).value)
        prev = self._counter_state.get(name, 0.0)
        self._counter_state[name] = v
        return v - prev

    def _measure_one(self, o: Objective, reg) -> Optional[float]:
        if isinstance(o, LatencyObjective):
            bounds, cum, count, _ = reg.histogram(
                o.histogram).exposition_state()
            prev_cum, prev_count = self._hist_state.get(
                o.histogram, ((0.0,) * len(cum), 0.0))
            self._hist_state[o.histogram] = (tuple(cum), float(count))
            d_count = count - prev_count
            if d_count <= 0 or len(prev_cum) != len(cum):
                return None
            d_cum = [c - p for c, p in zip(cum, prev_cum)]
            return _frac_over_delta(bounds, d_cum, d_count,
                                    o.threshold_s) / (1.0 - o.quantile)
        if isinstance(o, ValueObjective):
            g = reg.gauge(o.gauge)
            if g.calls == 0:
                return None
            return (g.value / o.max_value if o.max_value > 0
                    else float("inf"))
        d_den = sum(self._counter_delta(d, reg) for d in o.denominators)
        d_num = self._counter_delta(o.numerator, reg)
        if d_den <= 0:
            return None
        ratio = d_num / d_den
        return ratio / o.max_ratio if o.max_ratio > 0 else float("inf")

    def measure(self) -> Optional[float]:
        reg = _reg.registry()
        burns = [b for b in (self._measure_one(o, reg)
                             for o in self.objectives) if b is not None]
        return max(burns) if burns else None


@dataclasses.dataclass(frozen=True)
class AdaptiveAdmissionConfig:
    """Control-law knobs (the module docstring states the law)."""

    interval_s: float = 0.25
    high_burn: float = 1.0     # tighten at once above this
    low_burn: float = 0.5      # the relax streak accrues below this
    relax_ticks: int = 4       # consecutive quiet ticks before a relax
    tighten_factor: float = 0.5
    relax_factor: float = 1.25
    min_pending: int = 1
    window_grow: float = 1.5
    window_shrink: float = 0.75
    window_cap_s: float = 0.05
    #: tighten target when the baseline window is 0 (adaptive drain has
    #: no window to grow by a factor).
    window_floor_s: float = 0.001
    apply: bool = True         # False = dry run (measure, never actuate)


class AdaptiveAdmission:
    """The controller. It reads the process registry through its own
    :class:`WindowedBurn`, or an injected ``burn_fn`` (the unit-test
    seam). ``tick()`` is one synchronous, deterministic control step;
    :meth:`start` runs it every ``interval_s`` on the serving loop::

        ctl = await AdaptiveAdmission(frontend, slo_specs=args.slo).start()
        ...
        await ctl.stop()
    """

    def __init__(self, frontend,
                 slo_specs: Optional[Sequence[Union[Objective, str]]]
                 = None,
                 burn_fn: Optional[Callable[[], Optional[float]]] = None,
                 config: Optional[AdaptiveAdmissionConfig] = None):
        if burn_fn is None and not slo_specs:
            raise ValueError("AdaptiveAdmission needs slo_specs (or an "
                             "injected burn_fn) to steer on")
        self.frontend = frontend
        self.config = (config if config is not None
                       else AdaptiveAdmissionConfig())
        self._burn_fn = (burn_fn if burn_fn is not None
                         else WindowedBurn(slo_specs).measure)
        # Baselines taken at construction: relaxing converges here; the
        # controller only tightens below the operator's configured point.
        self.base_max_pending = int(frontend.max_pending)
        self.base_window_s = float(frontend.coalesce_window_s)
        self._relax_streak = 0
        self._stats = {"ticks": 0, "tightens": 0, "relaxes": 0,
                       "last_burn": None}
        self._task: Optional[asyncio.Task] = None
        self._stop = False

    # -- one control step --------------------------------------------------

    def _tighten(self) -> None:
        cfg = self.config
        fe = self.frontend
        new_pending = max(cfg.min_pending,
                          int(fe.max_pending * cfg.tighten_factor))
        new_window = min(cfg.window_cap_s,
                         max(fe.coalesce_window_s * cfg.window_grow,
                             cfg.window_floor_s))
        if cfg.apply:
            fe.max_pending = new_pending
            fe.coalesce_window_s = new_window
        self._stats["tightens"] += 1
        _M_TIGHTENS.inc()

    def _relax(self) -> None:
        cfg = self.config
        fe = self.frontend
        new_pending = min(self.base_max_pending,
                          max(fe.max_pending + 1,
                              int(fe.max_pending * cfg.relax_factor)))
        new_window = max(self.base_window_s,
                         fe.coalesce_window_s * cfg.window_shrink)
        if new_window <= self.base_window_s + 1e-12:
            new_window = self.base_window_s
        if cfg.apply:
            fe.max_pending = new_pending
            fe.coalesce_window_s = new_window
        self._stats["relaxes"] += 1
        _M_RELAXES.inc()

    def tick(self) -> Optional[float]:
        """One control step: measure this tick's burn, maybe actuate.
        Returns the measured burn (None: no traffic)."""
        cfg = self.config
        burn = self._burn_fn()
        self._stats["ticks"] += 1
        self._stats["last_burn"] = burn
        _M_TICKS.inc()
        _G_BURN.set(0.0 if burn is None else burn)
        if burn is not None and burn > cfg.high_burn:
            self._relax_streak = 0
            self._tighten()
        elif burn is None or burn < cfg.low_burn:
            self._relax_streak += 1
            at_base = (self.frontend.max_pending >= self.base_max_pending
                       and self.frontend.coalesce_window_s
                       <= self.base_window_s + 1e-12)
            if self._relax_streak >= cfg.relax_ticks and not at_base:
                self._relax_streak = 0
                self._relax()
        else:
            self._relax_streak = 0  # dead band
        _G_SHED.set(self.frontend.max_pending)
        _G_WINDOW.set(self.frontend.coalesce_window_s)
        return burn

    # -- lifecycle ---------------------------------------------------------

    async def _run(self) -> None:
        while not self._stop:
            await asyncio.sleep(self.config.interval_s)
            if self._stop:
                return
            self.tick()

    async def start(self) -> "AdaptiveAdmission":
        if self._task is not None:
            raise RuntimeError("adaptive admission already started")
        self._stop = False
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def stop(self) -> None:
        """Stop ticking. A tick that raised fails here, with its error."""
        if self._task is None:
            return
        self._stop = True
        task, self._task = self._task, None
        if task.done():
            task.result()
            return
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            if not task.cancelled():
                raise  # stop() itself was cancelled

    def stats(self) -> dict:
        """The controller's live view (the ``/statusz`` provider)."""
        return {
            **dict(self._stats),
            "apply": self.config.apply,
            "max_pending": self.frontend.max_pending,
            "base_max_pending": self.base_max_pending,
            "coalesce_window_s": self.frontend.coalesce_window_s,
            "base_window_s": self.base_window_s,
            "relax_streak": self._relax_streak,
        }
