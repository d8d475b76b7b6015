"""Chunked, overlapped host->device upload and bounded host prefetch
(port of photon_ml_tpu/data/device_feed.py: chunked_device_put :49,
InFlightWindow :126, HostPrefetcher :177, OverlappedUploader :252, with
their telemetry spans :38, :73, :161, :172, :239).

``chunked_device_put`` uploads a host array (numpy, or scipy sparse rows
densified chunk by chunk) in leading-axis chunks of at most
``chunk_bytes``. On a CUDA device each chunk is cast on the host into
one of ``depth`` pinned staging buffers and copied into its slice of the
preallocated destination on a side ``torch.cuda.Stream``; a staging
buffer is reused only after the CUDA event recorded behind its last
copy has completed, so the host's slicing and casting of chunk k+1
overlaps the copy of chunk k, and the device peak is the array itself
(the JAX version concatenates its chunks, transiently twice the array).
The caller's stream waits for the side stream before the result is
returned, so later work on it sees the whole array. On the CPU nothing
is pinned or streamed: the chunks are cast into the destination.

``InFlightWindow`` bounds asynchronous device work: ``push`` records a
CUDA event behind an item and, once ``depth`` items are in flight,
waits for the oldest and returns it. ``HostPrefetcher`` is its host-side
dual: a background thread runs an iterator ahead of its consumer,
holding at most ``depth`` finished items. ``OverlappedUploader`` is the
push-style variant for producers that emit chunks over time.

Telemetry: a ``chunked_device_put`` call is one ``h2d`` span; the
waits a window already makes are ``device_wait`` spans (the place
device execution meets the host: no sync is added to time it), and a
consumer blocked on its prefetcher is a ``prefetch_wait`` span.
"""

from __future__ import annotations

import queue
import threading
from collections import deque

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.telemetry import span

# Default per-transfer cap (the JAX package's): big enough that
# per-copy overhead stays negligible.
DEFAULT_CHUNK_BYTES = 128 << 20


def _rows_per_chunk(nbytes_per_row: int, chunk_bytes: int) -> int:
    return max(1, chunk_bytes // max(1, nbytes_per_row))


def _as_host(chunk, sparse: bool) -> np.ndarray:
    return np.ascontiguousarray(chunk.toarray() if sparse else chunk)


def chunked_device_put(x, dtype=None, device="cuda",
                       chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                       depth: int = 2) -> torch.Tensor:
    """Upload ``x`` (numpy, a torch CPU tensor, or scipy sparse, whose
    row chunks are densified one at a time) as one tensor on ``device``
    equal to ``torch.as_tensor(x, dtype)`` there; ``dtype`` None keeps
    x's type. At most ``depth`` chunk copies are in flight. The call is
    one ``h2d`` span."""
    with span("h2d"):
        return _chunked_device_put(x, dtype, device, chunk_bytes, depth)


def _chunked_device_put(x, dtype, device, chunk_bytes, depth):
    import scipy.sparse as sp

    dev = resolve_device(device)
    sparse = sp.issparse(x)
    if sparse:
        x = x.tocsr()
    elif isinstance(x, torch.Tensor):
        x = x.numpy()
    else:
        x = np.asarray(x)
    src_dtype = np.dtype(np.float64) if sparse else x.dtype
    out_dtype = (dtype if dtype is not None
                 else torch.from_numpy(np.empty(0, src_dtype)).dtype)
    out = torch.empty(tuple(x.shape), dtype=out_dtype, device=dev)
    n = x.shape[0] if x.ndim else 0
    if x.ndim == 0 or n == 0:
        return out.copy_(torch.as_tensor(_as_host(x, sparse)))
    elems_per_row = int(np.prod(x.shape[1:])) if x.ndim > 1 else 1
    row_bytes = elems_per_row * max(src_dtype.itemsize,
                                    out.element_size())
    rows = _rows_per_chunk(row_bytes, chunk_bytes)
    if dev.type != "cuda":
        for s in range(0, n, rows):
            out[s:s + rows] = torch.as_tensor(_as_host(x[s:s + rows],
                                                      sparse))
        return out

    caller = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(caller)  # ``out`` was allocated on the caller's stream
    staging = [None] * max(1, depth)
    done = [None] * max(1, depth)
    with torch.cuda.stream(side):
        for k, s in enumerate(range(0, n, rows)):
            slot = k % len(staging)
            host = torch.as_tensor(_as_host(x[s:s + rows], sparse))
            if done[slot] is not None:
                done[slot].synchronize()  # its last copy has left the buffer
            buf = staging[slot]
            if buf is None or buf.shape != host.shape:
                buf = staging[slot] = torch.empty(
                    host.shape, dtype=out_dtype).pin_memory()
            buf.copy_(host)
            out[s:s + host.shape[0]].copy_(buf, non_blocking=True)
            done[slot] = torch.cuda.Event()
            done[slot].record(side)
    caller.wait_stream(side)
    out.record_stream(side)
    return out


def _record(ready):
    """A CUDA event recorded on the current stream behind ``ready``'s
    tensors (a tensor or a nest of them), or None when none is on a CUDA
    device (CPU work has finished when it returns)."""
    if isinstance(ready, torch.cuda.Event):
        return ready
    stack, dev = [ready], None
    while stack and dev is None:
        item = stack.pop()
        if isinstance(item, torch.Tensor):
            if item.device.type == "cuda":
                dev = item.device
        elif isinstance(item, (list, tuple)):
            stack.extend(item)
        elif isinstance(item, dict):
            stack.extend(item.values())
    if dev is None:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


class InFlightWindow:
    """Bounded window of in-flight async device work: ``push(item,
    ready=...)`` records an event behind ``ready`` (default: the item's
    tensors, or a given CUDA event) and, once ``depth`` items are in
    flight, waits for the oldest and returns its item (else None)."""

    def __init__(self, depth: int = 2):
        self._depth = max(1, depth)
        self._q: deque = deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, item, ready=None):
        self._q.append((item, _record(item if ready is None else ready)))
        if len(self._q) >= self._depth:
            old_item, ev = self._q.popleft()
            # The one place device execution meets the host: this wait
            # bounds the window anyway, so the span adds no sync.
            with span("device_wait"):
                if ev is not None:
                    ev.synchronize()
            return old_item
        return None

    def drain(self):
        """Yield the remaining items oldest-first, waiting on each."""
        while self._q:
            item, ev = self._q.popleft()
            with span("device_wait"):
                if ev is not None:
                    ev.synchronize()
            yield item


class HostPrefetcher:
    """Bounded background-thread prefetch of an iterator.

    ``iter(HostPrefetcher(src, depth))`` yields ``src``'s items in order
    while a daemon thread keeps producing ahead, blocking once ``depth``
    finished items wait unconsumed. Items RESIDENT at any instant are
    bounded by ``depth`` (queued) + 1 (in the producer's hand, blocked on
    a full queue) + 1 (held by the consumer) = ``depth + 2``;
    ``peak_resident`` records the high-water mark.

    Producer exceptions re-raise in the consumer at the position they
    occurred; abandoning the iterator mid-stream (``close()`` or garbage
    collection of the generator) sets a stop flag the producer polls, so
    its thread ends once the item in its hand is done rather than
    blocking on a full queue forever. ``thread`` is the last iteration's
    producer thread, for callers that join it.
    """

    _POLL_S = 0.05

    def __init__(self, src, depth: int = 2):
        self._src = src
        self._depth = max(1, depth)
        self.peak_resident = 0
        self.thread = None

    def __iter__(self):
        q: "queue.Queue[tuple]" = queue.Queue(maxsize=self._depth)
        stop = threading.Event()
        lock = threading.Lock()
        in_flight = [0]  # produced, not yet handed to the consumer

        def put(msg) -> bool:
            while not stop.is_set():
                try:
                    q.put(msg, timeout=self._POLL_S)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in self._src:
                    with lock:
                        in_flight[0] += 1
                        # +1: the item the consumer currently holds.
                        self.peak_resident = max(self.peak_resident,
                                                 in_flight[0] + 1)
                    if not put(("item", item)):
                        return
                put(("done", None))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                put(("err", e))

        t = threading.Thread(target=produce, daemon=True,
                             name="host-prefetch")
        self.thread = t
        t.start()
        try:
            while True:
                # The consumer blocked on the producer: the feeder-bound
                # share of a stall (its dual is device_wait).
                with span("prefetch_wait"):
                    kind, val = q.get()
                if kind == "done":
                    break
                if kind == "err":
                    raise val
                with lock:
                    in_flight[0] -= 1
                yield val
        finally:
            stop.set()


class OverlappedUploader:
    """Push-style feeder: ``submit(host_chunk)`` uploads a chunk (its
    copies overlapped as in ``chunked_device_put``) and returns once at
    most ``depth`` submitted chunks are unfinished; ``collect()``
    concatenates everything submitted on the device.

    Chunks are copied at submit time, so callers may hand in views over
    transient buffers."""

    def __init__(self, dtype=None, device="cuda", depth: int = 2,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES):
        self._dtype = dtype
        self._device = device
        self._depth = max(1, depth)
        self._chunk_bytes = chunk_bytes
        self._parts: list = []
        self._window = InFlightWindow(depth)

    def submit(self, chunk) -> None:
        a = chunked_device_put(chunk, self._dtype, self._device,
                               self._chunk_bytes, self._depth)
        self._parts.append(a)
        self._window.push(a)

    def collect(self):
        """Device concatenation of everything submitted (None if empty)."""
        if not self._parts:
            return None
        out = (self._parts[0] if len(self._parts) == 1
               else torch.cat(self._parts, dim=0))
        self._parts = []
        self._window = InFlightWindow(self._depth)
        return out
