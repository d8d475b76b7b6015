"""Command-line drivers (port of photon_ml_tpu/cli/; reference
ml/Driver.scala, ml/cli/game/): the GAME training and scoring drivers,
the GLM driver, the feature-indexing job (``feature_indexing``), the
fleet observability aggregator (``obs_aggregate``) and the replica
router (``net_router``).

They keep every flag of their JAX parsers, so every JAX command line
parses. A flag value that belongs to a later item of ROADMAP queue A
raises an error naming that item (``later_item_error``; no flag of the
drivers does now). The helpers here are shared by the drivers; ``obs.py`` holds the observability plane's wiring. This module
imports torch only inside the helpers that need it, so
``python -m photon_ml_tpu_torch.cli.net_router`` runs without torch.
"""

from __future__ import annotations

import contextlib
import logging
import time

from photon_ml_tpu_torch.telemetry import span

# Later queue items, for the error a flag of one of them raises (none of
# the drivers' flags belongs to one now).
ITEMS: dict = {}


def later_item_error(flag: str, item: str, why: str = "") -> ValueError:
    """The error of a flag (or flag value) whose path is a later ROADMAP
    queue item."""
    return ValueError(f"{flag} is not ported yet: it comes with ROADMAP "
                      f"queue {item} ({ITEMS[item]})"
                      + (f": {why}" if why else ""))


def resolve_run_device(device, dtype):
    """(torch.device, dtype) of a driver run: ``device`` as
    resolve_device gives it (raising without CUDA unless it names the
    CPU), and ``dtype`` None meaning float64 on the CPU and float32 on
    the card (the JAX scoring driver's _maybe_enable_cpu_x64 /
    _scoring_dtype policy, game_scoring_driver.py:152-171)."""
    import torch

    from photon_ml_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.float64 if dev.type == "cpu" else torch.float32
    return dev, dtype


@contextlib.contextmanager
def phase(logger: logging.Logger, name: str):
    """One driver phase: the telemetry span the JAX drivers open under
    that name (ingest, solve, finalize, load_model, score, ...), with its
    seconds logged, also as the record's ``phase`` and ``seconds``
    attributes. On a CUDA run the phase's device work is finished before
    the span and the clock stop."""
    import torch

    t0 = time.perf_counter()
    with span(name):
        yield
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    logger.info("phase %s: %.6f s", name, seconds,
                extra={"phase": name, "seconds": seconds})
