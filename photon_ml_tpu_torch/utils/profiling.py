"""Profiler traces of a driver's device work (port of
photon_ml_tpu/utils/profiling.py:1-18, which wraps ``jax.profiler.trace``).

``maybe_trace(trace_dir, device)`` records a ``torch.profiler`` trace of
the region it wraps and writes it into ``trace_dir`` as Chrome
trace-event JSON (``torch_trace_<n>.json``, the first free ``n``),
loadable in Perfetto. The activities are the host's (CPU), plus the
card's (CUDA, through CUPTI) when ``device`` is a CUDA device: every
kernel launched on the context shows, the port's ``ctypes``-bound
kernels included (category ``kernel``, under their own names).

No fallback that hides the device: a CUDA run whose finished trace
holds no kernel event (CUPTI missing, say) raises and writes nothing,
rather than leaving a host-only trace. Do not wrap a CUDA graph
capture: the profiler's own launches would land in it.
"""

from __future__ import annotations

import contextlib
import json
import os
from pathlib import Path
from typing import Optional

import torch


def _next_path(trace_dir: Path) -> Path:
    n = 0
    while (trace_dir / f"torch_trace_{n}.json").exists():
        n += 1
    return trace_dir / f"torch_trace_{n}.json"


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str], device=None):
    """Context manager: a torch.profiler trace of the wrapped region
    written into ``trace_dir`` when it is set, a no-op otherwise. Yields
    the trace's path-to-be (None when off); drivers wrap their solve
    with this."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device if device is not None else "cpu").type \
        == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    out_dir = Path(trace_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = _next_path(out_dir)
    with profile(activities=activities) as prof:
        yield path
    tmp = path.with_name(f".{path.name}.{os.getpid()}.part")
    prof.export_chrome_trace(str(tmp))
    if on_card:
        with open(tmp) as f:
            events = json.load(f).get("traceEvents", [])
        if not any(e.get("cat") == "kernel" for e in events):
            tmp.unlink()
            raise RuntimeError(
                "torch.profiler recorded no CUDA kernel event on a CUDA "
                "run (is CUPTI available?); no host-only trace is written")
    os.replace(tmp, path)
