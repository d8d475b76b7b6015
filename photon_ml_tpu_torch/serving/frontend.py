"""Async serving front-end: cross-request coalescing, multi-model
tenancy and admission control in front of the streaming engine (port of
photon_ml_tpu/serving/frontend.py: FrontendError :88, UnknownModelError
:92, RequestRejected :102, FrontendConfig :125, _Pending :155,
ServingFrontend :180-747, with its registry metrics :58-85 and trace
contexts).

- **coalescing**: requests arriving on the event loop are held for a
  bounded wait window (``FrontendConfig.coalesce_window_s``, default 2
  ms; 0 = drain whatever queued) or until a full bucket's worth of rows
  is queued, then packed into shared bucket dispatches through the
  engine's ``score_many`` and scattered back per request.
- **admission control**: at most ``max_pending`` requests may be
  admitted and unfinished (and, optionally, ``max_pending_per_model``
  per model); past that ``score`` fails fast with a typed
  :class:`RequestRejected`.
- **multi-model tenancy**: N frozen GAME models resident at once, sharing
  one :class:`BucketLadder` and one :class:`TracingGuard`. A captured
  graph holds its engine's parameter addresses, so each engine captures
  its own buckets into its own cache (JAX's same-structure engines share
  one executable cache; ROADMAP §C). ``swap_model`` is atomic: requests
  pin their engine at admission, so everything admitted before the swap
  completes on the old weights. Nothing else holds a swapped-out or
  removed engine: once its last admitted request settles, its
  parameters, bucket buffers and graphs are freed (the guard keeps only
  their build counts).

Blocking work never runs on the event loop: device dispatch runs on one
dedicated executor thread, the only thread that captures or replays the
engines' graphs, so the loop keeps admitting and coalescing window k+1
while window k is on the device.

Telemetry, as in JAX: the ``serving.frontend.*`` counters, the
histograms of queue wait, end-to-end latency (admission to settled
result, with trace-id exemplars) and coalesced group size, the spans
``coalesce`` and ``scatter``, and a trace per request. A request handed
a context (``score(..., trace=ctx)``) carries it across every thread
hop; by default the trace is deferred: admission records only its time,
and the scatter settles the whole group in the tail sampler under one
lock (``TraceTail.settle_batch``), so an unsampled request costs a
deque append. Sheds and unknown models finish their trace at once.
The engines share one :class:`ExecutableProfiler`, whose table is
``stats()["cache"]["profiler"]``.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.serving.buckets import BucketLadder
from photon_ml_tpu_torch.serving.engine import StreamingGameScorer
from photon_ml_tpu_torch.telemetry import NOOP_CONTEXT, mint, span, trace_tail
from photon_ml_tpu_torch.telemetry import tracectx as _tracectx
from photon_ml_tpu_torch.utils.tracing_guard import TracingGuard

# Process-wide front-end metrics (no-ops while telemetry is off). The
# front-end's ``request_latency_seconds`` is end to end (admission to
# settled result, queue wait included); the engine's starts at
# featureization.
_M_ADMITTED = telemetry.counter("serving.frontend.admitted")
_M_REJECTED = telemetry.counter("serving.frontend.rejected")
_M_COMPLETED = telemetry.counter("serving.frontend.completed")
# Conservation: admitted == completed + failed + cancelled once drained.
_M_FAILED = telemetry.counter("serving.frontend.failed")
_M_CANCELLED = telemetry.counter("serving.frontend.cancelled")
_M_GROUPS = telemetry.counter("serving.frontend.coalesced_groups")
_M_SWAPS = telemetry.counter("serving.frontend.model_swaps")
_H_QUEUE_WAIT = telemetry.histogram("serving.frontend.queue_wait_seconds")
# Each latency bucket remembers the last kept trace id that landed in it.
_H_LATENCY = telemetry.histogram(
    "serving.frontend.request_latency_seconds", exemplars=True)
#: pow-2 buckets 1..4096: group sizes quantize like the row ladder.
_H_GROUP_REQUESTS = telemetry.histogram(
    "serving.frontend.coalesce_group_requests",
    buckets=tuple(float(1 << k) for k in range(13)))


class FrontendError(RuntimeError):
    """Base class for front-end contract violations."""


class UnknownModelError(FrontendError):
    """Request names a model that is not resident."""

    def __init__(self, model: str, resident: Sequence[str]):
        super().__init__(
            f"unknown model {model!r} (resident: {sorted(resident)})")
        self.model = model
        self.resident = tuple(sorted(resident))


class RequestRejected(FrontendError):
    """Load-shed: admission control refused the request because
    ``max_pending`` requests (process scope) or ``max_pending_per_model``
    requests of its model (model scope) are admitted and unfinished."""

    def __init__(self, model: str, pending: int, limit: int,
                 scope: str = "process", trace_id: Optional[str] = None):
        what = ("max_pending" if scope == "process"
                else "max_pending_per_model")
        super().__init__(
            f"request for model {model!r} rejected: {pending} requests "
            f"already pending >= {what}={limit} (overload load-shed, "
            f"{scope} scope)")
        self.model = model
        self.pending = pending
        self.limit = limit
        self.scope = scope
        # The shed's trace id (every shed's timeline is tail-kept).
        self.trace_id = trace_id


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Admission and coalescing knobs.

    - ``coalesce_window_s``: bounded wait after the first request of a
      group arrives; 0 disables the timer (the batcher drains whatever
      queued).
    - ``max_pending``: bound on admitted-and-unfinished requests.
    - ``max_pending_per_model``: optional per-model quota, so one hot
      tenant cannot fill ``max_pending`` and starve a quiet one.
    - ``max_group_rows``: dispatch a group early once this many rows are
      queued (default: the ladder's ``max_rows``).
    """

    coalesce_window_s: float = 0.002
    max_pending: int = 1024
    max_pending_per_model: Optional[int] = None
    max_group_rows: Optional[int] = None


@dataclasses.dataclass
class _Pending:
    """One admitted request: engine pinned at admission (a hot swap can
    never re-route it), future settled at scatter-back. ``ctx`` is None
    on the default path (the trace materializes at settle from
    ``t_admit`` and the group's stage stamps); a caller's context, or
    one the solo-retry path made, travels with the request, so a retried
    request keeps its trace id."""

    data: object
    engine: StreamingGameScorer
    future: asyncio.Future
    t_admit: float
    ctx: object = None


class ServingFrontend:
    """Event-loop front door over N resident :class:`StreamingGameScorer`
    engines. Construct with a ``{name: GameModel}`` mapping (or
    ``add_model``), then::

        async with frontend:
            scores = await frontend.score(request_ds, model="default")

    or drive a request list through :meth:`replay`. ``coalesce_window_s``
    and ``max_pending`` are re-read every cycle and admission from the
    public attributes. ``device`` defaults to the card and raises without
    CUDA unless it is ``"cpu"``."""

    def __init__(self, models: Optional[Dict[str, object]] = None,
                 dtype=torch.float32,
                 ladder: Optional[BucketLadder] = None,
                 config: Optional[FrontendConfig] = None,
                 tracing_guard: Optional[TracingGuard] = None,
                 pipeline_depth: int = 2, device="cuda"):
        self.ladder = ladder if ladder is not None else BucketLadder()
        self.guard = (tracing_guard if tracing_guard is not None
                      else TracingGuard())
        self.profiler = telemetry.ExecutableProfiler()
        self.config = config if config is not None else FrontendConfig()
        self.max_group_rows = (self.config.max_group_rows
                               if self.config.max_group_rows is not None
                               else self.ladder.max_rows)
        self._dtype = dtype
        self._device = device
        self._pipeline_depth = pipeline_depth
        self._engines: Dict[str, StreamingGameScorer] = {}
        self._stats = {"admitted": 0, "rejected": 0, "completed": 0,
                       "failed": 0, "cancelled": 0, "coalesced_groups": 0,
                       "dispatch_groups": 0, "model_swaps": 0,
                       "isolation_splits": 0}
        self._pending = 0
        self._pending_by_model: Dict[str, int] = {}
        self._rejected_by_model: Dict[str, int] = {}
        self._m_rejected_by_model: Dict[str, object] = {}
        self._queue: deque = deque()
        self._queued_rows = 0
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._wake: Optional[asyncio.Event] = None
        self._batcher_task: Optional[asyncio.Task] = None
        self._dispatch_tasks: set = set()
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._closing = False
        for name, model in (models or {}).items():
            self.add_model(name, model)

    @property
    def config(self) -> FrontendConfig:
        return self._config

    @config.setter
    def config(self, cfg: FrontendConfig) -> None:
        # Re-seed the live mirrors, read on the next cycle and admission.
        self._config = cfg
        self.coalesce_window_s = float(cfg.coalesce_window_s)
        self.max_pending = int(cfg.max_pending)

    # -- model registry ----------------------------------------------------

    def _build_engine(self, name: str, model) -> StreamingGameScorer:
        return StreamingGameScorer(
            model, dtype=self._dtype, ladder=self.ladder,
            pipeline_depth=self._pipeline_depth, tracing_guard=self.guard,
            metrics_label=name, profiler=self.profiler,
            device=self._device)

    def add_model(self, name: str, model) -> StreamingGameScorer:
        """Upload ``model`` and make it routable as ``name``. Blocking
        (uploads params): call it at startup or from a worker thread."""
        if name in self._engines:
            raise FrontendError(
                f"model {name!r} already resident; use swap_model")
        eng = self._build_engine(name, model)
        self._engines[name] = eng
        return eng

    def swap_model(self, name: str, model) -> StreamingGameScorer:
        """Atomic hot swap: build the replacement engine, then rebind the
        name in one assignment. Everything admitted before completes on
        the old weights; everything after routes to the new engine.
        Returns the old engine."""
        if name not in self._engines:
            raise UnknownModelError(name, self._engines)
        eng = self._build_engine(name, model)
        old = self._engines[name]
        self._engines[name] = eng  # atomic under the GIL
        self._stats["model_swaps"] += 1
        _M_SWAPS.inc()
        return old

    def remove_model(self, name: str) -> None:
        """Stop routing ``name``; in-flight requests still complete."""
        if name not in self._engines:
            raise UnknownModelError(name, self._engines)
        del self._engines[name]

    @property
    def models(self) -> Tuple[str, ...]:
        return tuple(sorted(self._engines))

    def engine(self, name: str) -> StreamingGameScorer:
        eng = self._engines.get(name)
        if eng is None:
            raise UnknownModelError(name, self._engines)
        return eng

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> "ServingFrontend":
        if self._batcher_task is not None:
            raise FrontendError("frontend already started")
        self._loop = asyncio.get_running_loop()
        self._wake = asyncio.Event()
        self._closing = False
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serving-dispatch")
        self._batcher_task = self._loop.create_task(self._batch_loop())
        return self

    async def close(self) -> None:
        """Drain: every admitted request settles before close returns,
        and the dispatch thread is joined."""
        if self._batcher_task is None:
            return
        self._closing = True
        self._wake.set()
        await self._batcher_task
        self._batcher_task = None
        while self._dispatch_tasks:
            await asyncio.gather(*list(self._dispatch_tasks))
        self._pool.shutdown(wait=True)
        self._pool = None

    async def __aenter__(self) -> "ServingFrontend":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- request path ------------------------------------------------------

    async def score(self, data, model: str = "default",
                    trace: Optional[object] = None) -> np.ndarray:
        """Admit one scoring request and await its result (host
        [n_rows], the ``StreamingGameScorer.score`` contract). Raises
        :class:`RequestRejected` under overload and
        :class:`UnknownModelError` for a non-resident model, both before
        admission, each finishing the request's trace (``trace``, or one
        minted here) at once. An admitted request's trace settles at
        scatter-back with its admit, coalesce, dispatch and settle
        stages (deferred when no ``trace`` is given)."""
        if self._batcher_task is None:
            raise FrontendError("frontend not started (use 'async with' "
                                "or await start())")
        if self._closing:
            # close() drains what was admitted before it; a request
            # admitted after the batcher's final drain would hang.
            raise FrontendError("frontend is closing; request refused")
        engine = self._engines.get(model)
        if engine is None:
            ctx = trace if trace is not None else mint("request")
            ctx.annotate(model=model)
            ctx.finish("error")
            raise UnknownModelError(model, self._engines)
        if self._pending >= self.max_pending:
            self._reject(model)
            ctx = trace if trace is not None else mint("request")
            ctx.annotate(model=model, scope="process")
            ctx.finish("shed")
            raise RequestRejected(model, self._pending, self.max_pending,
                                  trace_id=ctx.trace_id)
        quota = self.config.max_pending_per_model
        model_pending = self._pending_by_model.get(model, 0)
        if quota is not None and model_pending >= quota:
            self._reject(model)
            ctx = trace if trace is not None else mint("request")
            ctx.annotate(model=model, scope="model")
            ctx.finish("shed")
            raise RequestRejected(model, model_pending, quota,
                                  scope="model", trace_id=ctx.trace_id)
        if trace is not None:
            trace.event("admit")
        fut = self._loop.create_future()
        p = _Pending(data, engine, fut, time.perf_counter(), trace)
        self._pending += 1
        self._pending_by_model[model] = model_pending + 1
        # The registry twin is incremented a group at a time (coalesce).
        self._stats["admitted"] += 1
        self._queue.append(p)
        self._queued_rows += int(data.num_rows)
        self._wake.set()
        try:
            return await fut
        finally:
            self._pending -= 1
            self._pending_by_model[model] -= 1

    def _reject(self, model: str) -> None:
        """Shed accounting: the process-wide counters and the per-model
        ``serving.model.<name>.rejected`` twin."""
        self._stats["rejected"] += 1
        self._rejected_by_model[model] = \
            self._rejected_by_model.get(model, 0) + 1
        _M_REJECTED.inc()
        m = self._m_rejected_by_model.get(model)
        if m is None:
            m = self._m_rejected_by_model[model] = telemetry.counter(
                f"serving.model.{model}.rejected")
        m.inc()

    # -- coalescing batcher ------------------------------------------------

    async def _batch_loop(self) -> None:
        while True:
            if not self._queue:
                if self._closing:
                    return
                await self._wake.wait()
                self._wake.clear()
                continue
            window = self.coalesce_window_s
            if window > 0 and self._queued_rows < self.max_group_rows \
                    and not self._closing:
                await self._sleep_or_full(window)
            self._form_groups()

    async def _sleep_or_full(self, window: float) -> None:
        deadline = time.perf_counter() + window
        while True:
            remain = deadline - time.perf_counter()
            if remain <= 0 or self._queued_rows >= self.max_group_rows \
                    or self._closing:
                return
            self._wake.clear()
            try:
                await asyncio.wait_for(self._wake.wait(), remain)
            except asyncio.TimeoutError:
                return

    def _form_groups(self) -> None:
        """Drain the queue into per-engine groups (arrival order kept
        within each) and launch one dispatch task per group; a
        ``coalesce`` span of synchronous event-loop work."""
        with span("coalesce"):
            group = list(self._queue)
            self._queue.clear()
            self._queued_rows = 0
            if telemetry.enabled():
                # One vectorized observation and one counter batch a
                # group, not a lock round trip a request.
                now = time.perf_counter()
                _H_QUEUE_WAIT.observe_many(
                    [now - p.t_admit for p in group])
                _M_ADMITTED.inc(len(group))
            _H_GROUP_REQUESTS.observe(len(group))
            self._stats["coalesced_groups"] += 1
            _M_GROUPS.inc()
            parts: Dict[int, List[_Pending]] = {}
            order: List[int] = []
            for p in group:
                key = id(p.engine)
                if key not in parts:
                    parts[key] = []
                    order.append(key)
                parts[key].append(p)
            # Group-shared trace stamp, merged into each request's
            # timeline at settle.
            t_coalesce = time.perf_counter()
            for key in order:
                self._stats["dispatch_groups"] += 1
                task = self._loop.create_task(
                    self._dispatch_group(parts[key], t_coalesce))
                self._dispatch_tasks.add(task)
                task.add_done_callback(self._dispatch_tasks.discard)

    def _score_group(self, items: List[_Pending]) -> Tuple[List, float]:
        """Executor-thread body: one coalesced ``score_many`` pass,
        per-request (result, error) pairs and the dispatch's start time
        (the group-shared ``dispatch`` trace stage). A failing group
        retries per request, so only the offender errors (fault
        isolation, counted in ``isolation_splits``); the failed attempt's
        accounting is rolled back first, so the engine counts each served
        request once. A retried request gets (or keeps) a trace context
        with a ``retry_solo`` event."""
        t_dispatch = time.perf_counter()
        engine = items[0].engine
        datasets = [p.data for p in items]
        ckpt = engine.stats_checkpoint()
        try:
            return ([(r, None) for r in engine.score_many(datasets)],
                    t_dispatch)
        except Exception:  # noqa: BLE001 — isolate, then re-raise solo
            engine.rollback_stats(ckpt)
            if len(datasets) == 1:
                raise
        self._stats["isolation_splits"] += 1
        out = []
        for p in items:
            if p.ctx is None:
                # The rare isolation path gets a real context, backdated
                # to admission (both clocks by the same delta).
                ctx = mint("request")
                if ctx is not NOOP_CONTEXT:
                    ctx.start_unix -= ctx.t0 - p.t_admit
                    ctx.t0 = p.t_admit
                p.ctx = ctx
            p.ctx.event("retry_solo")
            ckpt = engine.stats_checkpoint()
            try:
                out.append((engine.score_many([p.data])[0], None))
            except Exception as e:  # noqa: BLE001 — per-request verdict
                engine.rollback_stats(ckpt)
                out.append((None, e))
        return out, t_dispatch

    async def _dispatch_group(self, items: List[_Pending],
                              t_coalesce: float) -> None:
        t_dispatch = None
        try:
            results, t_dispatch = await self._loop.run_in_executor(
                self._pool, self._score_group, items)
        except Exception as e:  # noqa: BLE001 — fail the whole group
            results = [(None, e)] * len(items)
        with span("scatter"):
            now = time.perf_counter()
            # One stage dict a settled group, merged into each kept
            # request's timeline.
            stages = {"coalesce": t_coalesce, "settle": now}
            if t_dispatch is not None:
                stages["dispatch"] = t_dispatch
            sampling = _tracectx.enabled()
            lats: List[float] = []
            exemplar_ids: List = []
            deferred: List = []  # settle_batch entries
            n_failed = n_cancelled = 0
            for p, (res, err) in zip(items, results):
                if p.future.done():  # the caller cancelled
                    self._stats["cancelled"] += 1
                    n_cancelled += 1
                    outcome, slot = "cancelled", None
                elif err is None:
                    p.future.set_result(res)
                    self._stats["completed"] += 1
                    outcome = "ok"
                    lats.append(now - p.t_admit)
                    exemplar_ids.append(None)
                    slot = len(lats) - 1
                else:
                    p.future.set_exception(err)
                    self._stats["failed"] += 1
                    n_failed += 1
                    outcome, slot = "error", None
                ctx = p.ctx
                if ctx is not None:
                    if outcome == "error":
                        ctx.annotate(error=type(err).__name__)
                    ctx.finish(outcome, stages=stages)
                    # Only a kept trace's id lands on a bucket, so every
                    # exemplar resolves.
                    if slot is not None and ctx.kept:
                        exemplar_ids[slot] = ctx.trace_id
                elif sampling:
                    deferred.append((
                        p.t_admit, now - p.t_admit, outcome,
                        (type(err).__name__ if err is not None
                         else None), slot))
            if deferred:
                # One lock for the whole group; kept ok entries come back
                # with their minted ids.
                for slot, tid in trace_tail().settle_batch(
                        deferred, stages).items():
                    exemplar_ids[slot] = tid
            if n_failed:
                _M_FAILED.inc(n_failed)
            if n_cancelled:
                _M_CANCELLED.inc(n_cancelled)
            if lats:
                _M_COMPLETED.inc(len(lats))
                _H_LATENCY.observe_many(
                    lats, exemplars=(exemplar_ids
                                     if any(t is not None
                                            for t in exemplar_ids)
                                     else None))

    # -- replay harness ----------------------------------------------------

    def replay(self, requests: Sequence, model: str = "default",
               concurrency: int = 16,
               arrivals: Optional[Sequence[float]] = None):
        """Drive ``requests`` through the front-end on a private event
        loop; returns ``(results, info)`` with ``results[i]`` the scores
        of ``requests[i]`` (None where shed). Closed loop by default:
        ``concurrency`` requesters each submit the next request once
        their previous one settles. With ``arrivals`` (seconds per
        request) submission is open loop at those offsets."""
        return asyncio.run(self._replay(requests, model, concurrency,
                                        arrivals))

    async def _replay(self, requests, model, concurrency, arrivals):
        async with self:
            results: List[Optional[np.ndarray]] = [None] * len(requests)
            info = {"requests": len(requests), "shed": 0, "errors": 0}

            async def run_one(i: int) -> None:
                try:
                    results[i] = await self.score(requests[i], model=model)
                except RequestRejected:
                    info["shed"] += 1
                except FrontendError:
                    raise
                except Exception:  # noqa: BLE001 — count, keep serving
                    info["errors"] += 1

            if arrivals is None:
                it = iter(range(len(requests)))

                async def worker() -> None:
                    for i in it:
                        await run_one(i)

                n = max(1, min(int(concurrency), len(requests) or 1))
                await asyncio.gather(*[worker() for _ in range(n)])
            else:
                if len(arrivals) != len(requests):
                    raise ValueError(
                        f"arrivals ({len(arrivals)}) must match requests "
                        f"({len(requests)})")

                async def submit(i: int, at: float) -> None:
                    await asyncio.sleep(at)
                    await run_one(i)

                await asyncio.gather(
                    *[submit(i, float(a))
                      for i, a in enumerate(arrivals)])
            info["completed"] = sum(r is not None for r in results)
            return results, info

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        """Front-end counters and histograms (JAX's keys; the local
        counters are always live, the histogram percentiles populate only
        while telemetry is enabled and are process-wide). ``engines``
        nests each resident model's engine stats (their
        ``request_latency_seconds`` excludes the queue; the front-end's
        is end to end). ``cache`` sums the resident engines' caches
        (``entries``) and the guard's builds, swapped-out engines'
        included (``compilations``, ``traces``), with the engines' shared
        ``profiler`` table."""
        return {
            "models": list(self.models),
            **dict(self._stats),
            "pending": self._pending,
            "max_pending": self.max_pending,
            "max_pending_per_model": self.config.max_pending_per_model,
            "pending_by_model": dict(sorted(
                self._pending_by_model.items())),
            "rejected_by_model": dict(sorted(
                self._rejected_by_model.items())),
            "coalesce_window_s": self.coalesce_window_s,
            "max_group_rows": self.max_group_rows,
            "queue_wait_seconds": _H_QUEUE_WAIT.snapshot(),
            "request_latency_seconds": _H_LATENCY.snapshot(),
            "coalesce_group_requests": _H_GROUP_REQUESTS.snapshot(),
            "cache": {"entries": sum(len(e.cache)
                                     for e in self._engines.values()),
                      "compilations": len(self.guard),
                      "traces": self.guard.total_traces(),
                      "profiler": self.profiler.table()},
            "engines": {name: eng.stats()
                        for name, eng in sorted(self._engines.items())},
        }
