"""Device loops and captured update graphs: the port's counterpart of
``lax.while_loop`` (photon_ml_tpu/optimization/glm_lbfgs.py:181 and
:231, lbfgs.py:225 and :342, owlqn.py:174, tron.py:108 and :283) and of
the one-dispatch coordinate update (algorithm/coordinate_descent.py
:124-167).

A loop is a dict of fixed-shape tensors (its state), a
``step(state) -> dict`` whose results are copied into the state, and a
device predicate ``active(state)`` (a 0-d bool tensor). ``while_loop``
runs it in one of two forms, chosen by the stream and nothing else:

- While the current CUDA stream captures a graph, the loop is recorded
  into the graph as a conditional WHILE node (csrc/device_loop.cu): the
  predicate sets the node's condition before it, the body is captured
  once on a stream of its own, and its last kernel sets the condition
  from the predicate the body computed. The device runs the body while
  the predicate holds: no host read, whatever the iterations. Loops
  nest (the line search and CG inside a solver's iteration), one body
  stream a depth.
- Otherwise the step runs eagerly and the predicate is read on the host
  once an iteration. This is the plain version: the CPU runs it, and so
  does a run on the card that captures nothing (the eager plain loop of
  ``CoordinateDescent(fused=False)``, a mesh, the GLM driver's λ grid).

Both forms run the same operations on the same shapes, so a captured
solve gives the eager one's bits.

Design. The card's PyTorch binds no conditional nodes
(``CUDAGraph.begin_capture_to_if_node`` is missing from its build), so
the WHILE node is made through the CUDA runtime in a small source bound
by ctypes, like the kernels. A WHILE node keeps a graph's size that of
one iteration: TRON's up to 6 x max_iter trips of up to 20 CG steps
would unroll into some tens of thousands of nodes as IF nodes, and a
graph replayed iteration by iteration from the host would put a host
step back between iterations. Allocations in a body go to a memory pool
of the capture's own (``CapturedGraph.body_pool``), so they live as long
as the graph.

``CapturedGraph`` captures a function once on a side stream prepared
for it (cuBLAS workspaces made, body streams made) and replays it.
``LaunchTally`` counts the kernel launches that a replay really made:
a kernel wrapper that records its launch into a graph adds one to a
device counter beside it, so a launch inside a loop body counts once for
each time the body ran, and the host reads the counters at a sync point.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from photon_ml_tpu_torch.utils.tracing_guard import BuildCount

Tensor = torch.Tensor

# Body streams a device keeps: nesting depth of the port's loops (a
# solver's iteration, its line search or CG) plus one.
MAX_DEPTH = 3

_local = threading.local()


def _state() -> threading.local:
    if not hasattr(_local, "depth"):
        _local.depth = 0
        _local.capture = None  # the CapturedGraph being captured
        _local.streams = {}  # device index -> capture_streams
        _local.tally = None  # the LaunchTally a capture records into
    return _local


def _assign(state: Dict[str, Tensor], new: Dict[str, Tensor]) -> None:
    for k, v in new.items():
        state[k].copy_(v)


def while_loop(state: Dict[str, Tensor],
               step: Callable[[Dict[str, Tensor]], Dict[str, Tensor]],
               active: Callable[[Dict[str, Tensor]], Tensor]
               ) -> Dict[str, Tensor]:
    """Run ``state = step(state)`` while ``active(state)``; the state's
    tensors are updated in place (``step`` may also write them in place)
    and returned. ``active`` is what ends the loop: it must turn false
    within the loop's bound (a solver's stop reason does)."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        _captured(state, step, active)
        return state
    while bool(active(state)):
        _assign(state, step(state))
    return state


@functools.lru_cache(maxsize=None)
def _lib():
    from photon_ml_tpu_torch.ops import cuda_build

    lib = cuda_build.load("device_loop")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.device_loop_open.argtypes = [vp, vp, vp, vp, vp]
    lib.device_loop_open.restype = ci
    lib.device_loop_close.argtypes = [vp, ctypes.c_ulonglong, vp]
    lib.device_loop_close.restype = ci
    lib.device_loop_abort.argtypes = [vp]
    lib.device_loop_abort.restype = ci
    lib.device_loop_nodes.argtypes = [vp]
    lib.device_loop_nodes.restype = ctypes.c_longlong
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"device loop: {what} failed (CUDA error {err})")


def _captured(state, step, active) -> None:
    st = _state()
    cap = st.capture
    if cap is None:
        raise RuntimeError(
            "a device loop is captured only inside CapturedGraph, which "
            "prepares its body streams and memory pool")
    depth = st.depth
    if depth + 1 >= len(cap.streams):
        raise RuntimeError(f"device loops nest deeper than {MAX_DEPTH - 1}")
    lib = _lib()
    parent = torch.cuda.current_stream()
    body = cap.streams[depth + 1]
    pred = active(state)
    handle, graph = ctypes.c_ulonglong(0), ctypes.c_void_p(0)
    _check(lib.device_loop_open(parent.cuda_stream, body.cuda_stream,
                                pred.data_ptr(), ctypes.byref(handle),
                                ctypes.byref(graph)), "opening a WHILE node")
    cap.body_graphs.append(graph.value)
    routed = depth == 0
    if routed:
        # The parent capture's allocator filter matches its own stream
        # only: the bodies' allocations go to a pool of the capture's.
        torch._C._cuda_beginAllocateCurrentThreadToPool(cap.index,
                                                         cap.body_pool)
        cap.body_pool_uses += 1
    st.depth = depth + 1
    closed = False
    try:
        with torch.cuda.stream(body):
            _assign(state, step(state))
            again = active(state)
            _check(lib.device_loop_close(body.cuda_stream, handle.value,
                                         again.data_ptr()),
                   "closing a WHILE node")
            closed = True
    finally:
        st.depth = depth
        if not closed:
            lib.device_loop_abort(body.cuda_stream)
        if routed:
            torch._C._cuda_endAllocateToPool(cap.index, cap.body_pool)


def _warm(stream: torch.cuda.Stream, device: torch.device) -> None:
    """Make the cuBLAS workspace of (this thread's handle, ``stream``)
    and load the kernels a solver's linear algebra uses, outside any
    capture."""
    with torch.cuda.stream(stream):
        for dt in (torch.float32, torch.float64):
            a = torch.ones((4, 4), dtype=dt, device=device)
            v = torch.ones((4,), dtype=dt, device=device)
            torch.dot(v, v)
            a @ v
            a @ a
            torch.addmm(a, a, a)
            torch.linalg.solve_triangular(a, v[:, None], upper=True)
            torch.linalg.solve_triangular(a, v[:, None], upper=False)
    stream.synchronize()


def capture_streams(device: torch.device) -> List[torch.cuda.Stream]:
    """The capture stream and the body streams of ``device`` for this
    thread (cuBLAS handles are per thread), made and warmed once."""
    prepared = _state().streams
    streams = prepared.get(device.index)
    if streams is None:
        with torch.cuda.device(device):
            streams = [torch.cuda.Stream() for _ in range(MAX_DEPTH)]
            for s in streams:
                _warm(s, device)
        prepared[device.index] = streams
    return streams


class CapturedGraph:
    """``fn()`` captured once into a CUDA graph on a prepared side stream
    (``capture_error_mode="thread_local"``: other threads may use the
    card meanwhile) and replayed with ``replay()`` on the current stream.
    ``outputs`` is what ``fn`` returned: tensors in the graph's memory,
    overwritten by every replay. ``prepare()``, called on the capture
    stream before the capture, makes what must exist before it (a
    kernel's plan and counter, a product's scratch). ``stats`` holds the
    graph's nodes (its own and its loop bodies'), the capture and
    instantiate seconds and the pool's bytes. A failed capture raises."""

    def __init__(self, fn: Callable, device, prepare: Optional[Callable] = None):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device, self.index = device, device.index
        self.streams = capture_streams(device)
        self.body_graphs: List[int] = []
        self.body_pool = torch.cuda.graph_pool_handle()
        self.body_pool_uses = 0
        self.builds = BuildCount()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        st = _state()
        if st.capture is not None:
            raise RuntimeError("CUDA graph captures do not nest")
        with torch.cuda.device(device):
            torch.cuda.synchronize(device)
            if prepare is not None:
                with torch.cuda.stream(self.streams[0]):
                    prepare()
                self.streams[0].synchronize()
            st.capture = self
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(self.graph, stream=self.streams[0],
                                      capture_error_mode="thread_local"):
                    self.outputs = fn()
            finally:
                st.capture = None
            capture_s = time.perf_counter() - t0
            lib = _lib()
            own = lib.device_loop_nodes(self.graph.raw_cuda_graph())
            bodies = [lib.device_loop_nodes(g) for g in self.body_graphs]
            t0 = time.perf_counter()
            self.graph.instantiate()
            instantiate_s = time.perf_counter() - t0
        self.builds.traces += 1
        self.stats = {"nodes": own + sum(bodies), "loops": len(bodies),
                      "capture_s": capture_s,
                      "instantiate_s": instantiate_s,
                      "pool_bytes": self.pool_bytes()}

    @property
    def traces(self) -> int:
        return self.builds.traces

    def pool_bytes(self) -> int:
        """Bytes the caching allocator holds for this graph's pools."""
        pools = {tuple(self.graph.pool()), tuple(self.body_pool)}
        return sum(seg["total_size"]
                   for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) in pools)

    def replay(self) -> None:
        self.graph.replay()

    def close(self) -> None:
        """Free the graph and hand its body pool back to the allocator."""
        self.graph.reset()
        self.outputs = None
        for _ in range(self.body_pool_uses):
            torch._C._cuda_releasePool(self.index, self.body_pool)
        self.body_pool_uses = 0


_SETTLERS: Dict[str, Callable] = {}


def on_settle(kernel: str, fn: Callable) -> None:
    """Register ``fn(key, n)``, which adds ``n`` launches of ``key``
    (a tuple whose first item is ``kernel``) to a wrapper's counts."""
    _SETTLERS[kernel] = fn


class LaunchTally:
    """Per-kernel launch counters on the card, for launches recorded
    into a graph. While a ``CapturedGraph`` is captured under
    ``recording()``, a kernel wrapper's ``count(key)`` records one
    addition into its counter beside the launch, so every replay adds
    the launches it ran (a loop body's once a trip). ``settle()`` hands
    the counts since the last settle to the kernel's ``on_settle``
    function. ``key`` is a tuple whose first item names the kernel."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.keys: List[object] = []
        self.counts = torch.zeros((64,), dtype=torch.int64,
                                  device=self.device)
        self._seen = [0] * 64

    def slot(self, key) -> int:
        if key not in self.keys:
            if len(self.keys) == self.counts.shape[0]:
                raise RuntimeError("too many kernels in one launch tally")
            self.keys.append(key)
        return self.keys.index(key)

    @contextlib.contextmanager
    def recording(self):
        st = _state()
        prev, st.tally = st.tally, self
        try:
            yield self
        finally:
            st.tally = prev

    def count(self, key) -> None:
        i = self.slot(key)
        self.counts[i:i + 1].add_(1)

    def values(self) -> Tensor:
        """The counters in use, on the card (read them at a sync point
        and hand them to ``settle``)."""
        return self.counts[:len(self.keys)]

    def settle(self, values) -> None:
        """Add the launches since the last settle to each kernel's
        wrapper (``on_settle``), from the counters' host ``values``."""
        for i, key in enumerate(self.keys):
            n = int(values[i]) - self._seen[i]
            if n:
                _SETTLERS[key[0]](key, n)
            self._seen[i] = int(values[i])


class _Uncounted:
    """The tally of ``uncounted()``: it counts nothing."""

    def count(self, key) -> None:
        pass


@contextlib.contextmanager
def uncounted():
    """Launches recorded into a graph captured inside this block count
    nowhere: for a graph replayed only to time its kernels, whose
    launches belong to no run."""
    st = _state()
    prev, st.tally = st.tally, _Uncounted()
    try:
        yield
    finally:
        st.tally = prev


def active_tally():
    """The tally a kernel wrapper counts into while a graph is captured
    under ``LaunchTally.recording()`` or ``uncounted()``, else None."""
    return _state().tally
