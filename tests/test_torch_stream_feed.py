"""The port's data/device_feed.py on the CPU: HostPrefetcher's shutdown
paths (the cases of tests/test_device_feed.py: close() mid-stream, an
abandoned generator and a producer exception each end the producer
thread, which every test here joins with a timeout of its own), and
chunked_device_put / InFlightWindow / OverlappedUploader on CPU tensors,
which equal torch.as_tensor of the host array exactly at chunk sizes
that do and do not divide the rows. Pinned staging and the side stream
run only on the card (tests/test_torch_stream_cuda.py).
"""

import gc
import threading
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.data.device_feed import (
    HostPrefetcher,
    InFlightWindow,
    OverlappedUploader,
    chunked_device_put,
)
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

JOIN_S = 10.0


class _CountingSource:
    """Unbounded source that records how far production got."""

    def __init__(self, n=10**9, delay=0.0):
        self.produced = 0
        self.n = n
        self.delay = delay
        self.exited = threading.Event()

    def __iter__(self):
        try:
            for i in range(self.n):
                if self.delay:
                    time.sleep(self.delay)
                self.produced += 1
                yield i
        finally:
            self.exited.set()


def _joined(pf: HostPrefetcher) -> None:
    pf.thread.join(timeout=JOIN_S)
    assert not pf.thread.is_alive(), "the producer thread did not end"


def test_close_mid_stream_stops_producer():
    src = _CountingSource()
    pf = HostPrefetcher(src, depth=2)
    it = iter(pf)
    assert next(it) == 0
    assert next(it) == 1
    it.close()  # the consumer walks away mid-stream
    _joined(pf)
    # Bounded overrun: queue depth + producer's hand, not the source.
    assert src.produced <= 2 + 2 + 2


def test_generator_abandonment_stops_producer():
    src = _CountingSource()
    pf = HostPrefetcher(src, depth=1)
    it = iter(pf)
    assert next(it) == 0
    del it  # GC finalizes the generator -> finally -> stop flag
    gc.collect()
    _joined(pf)
    assert src.produced <= 1 + 2 + 2


def test_producer_exception_reraised_at_position():
    def src():
        yield 1
        yield 2
        raise ValueError("decode exploded at block 2")

    pf = HostPrefetcher(src(), depth=2)
    it = iter(pf)
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(ValueError, match="decode exploded at block 2"):
        next(it)
    _joined(pf)


def test_producer_exception_before_any_item():
    def src():
        raise RuntimeError("corrupt header")
        yield  # pragma: no cover

    pf = HostPrefetcher(src(), depth=2)
    with pytest.raises(RuntimeError, match="corrupt header"):
        next(iter(pf))
    _joined(pf)


def test_exhaustion_is_clean_and_ordered():
    src = _CountingSource(n=7)
    pf = HostPrefetcher(src, depth=3)
    assert list(pf) == list(range(7))
    assert src.exited.wait(2.0)
    _joined(pf)
    assert pf.peak_resident <= 3 + 2


def test_close_then_new_iteration_is_fresh():
    """Each __iter__ starts its own producer; closing one does not poison
    the next."""
    src1 = _CountingSource(n=5)
    pf = HostPrefetcher(src1, depth=1)
    it = iter(pf)
    next(it)
    it.close()
    _joined(pf)
    pf2 = HostPrefetcher(_CountingSource(n=4), depth=1)
    assert list(pf2) == [0, 1, 2, 3]
    _joined(pf2)


@pytest.mark.parametrize("chunk_bytes", [8 * 7, 8 * 20, 1 << 20])
def test_chunked_device_put_equals_one_upload(chunk_bytes):
    rng = np.random.default_rng(0)
    dense = rng.normal(size=(40, 3))
    for x, dtype in ((dense, None), (dense, torch.float32),
                     (rng.integers(0, 9, 40).astype(np.int32), None),
                     (sp.random(40, 5, density=0.3, random_state=1,
                                format="csr"), torch.float64)):
        got = chunked_device_put(x, dtype, device="cpu",
                                 chunk_bytes=chunk_bytes)
        host = x.toarray() if sp.issparse(x) else x
        want = torch.as_tensor(host) if dtype is None else torch.as_tensor(
            host, dtype=dtype)
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert chunked_device_put(np.zeros((0, 2)), device="cpu").shape == (0, 2)


def test_in_flight_window_and_uploader_keep_order():
    win = InFlightWindow(depth=2)
    assert win.push(torch.ones(2)) is None
    assert torch.equal(win.push(torch.zeros(2)), torch.ones(2))
    assert [t.tolist() for t in win.drain()] == [[0.0, 0.0]]
    up = OverlappedUploader(dtype=torch.float64, device="cpu", depth=2,
                            chunk_bytes=16)
    parts = [np.arange(5.0), np.arange(5.0, 9.0)]
    for p in parts:
        up.submit(p)
    assert torch.equal(up.collect(), torch.arange(9, dtype=torch.float64))
    assert up.collect() is None
