"""Multi-host initialization (port of photon_ml_tpu/parallel/multihost.py:
initialize_multihost :37-82, is_primary_host :85-91).

The JAX package joins hosts through ``jax.distributed``; the port joins
processes through ``torch.distributed``. Every process calls
:func:`initialize_multihost` once before training:

- explicit: a coordinator ``host:port`` by argument or the
  ``COORDINATOR_ADDRESS`` environment variable, with ``NUM_PROCESSES``
  and ``PROCESS_ID`` (JAX's names), becomes ``init_method=
  "tcp://host:port"`` with that world size and rank;
- ``auto=True`` without a coordinator: ``init_method="env://"``, the
  variables a launcher such as ``torchrun`` sets (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).

The backend follows the device: ``gloo`` for ``"cpu"``, ``nccl`` for a
CUDA device. With neither mode the call is a no-op that returns False
and the process stays alone (``is_primary_host()`` is then True); a
launcher that needs several processes checks the result. A process
leaves the group with ``torch.distributed.destroy_process_group()``.

A mesh still spans one process's slots (parallel/distributed.py), as
JAX's single-controller mesh spans ``jax.devices()``: multi-host adds
the process group and the primary-host rule (the process that writes
models and logs), and no fold across processes, as in JAX.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch

logger = logging.getLogger(__name__)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         auto: bool = False, device="cuda",
                         timeout: Optional[float] = None) -> bool:
    """Join the process group (module docstring). ``timeout`` (seconds)
    bounds the rendezvous and every collective's wait. Returns True once
    the group is up, False when neither mode applies."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    if coordinator_address is None and not auto:
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kwargs = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    else:
        if num_processes is None or process_id is None:
            raise ValueError(
                "an explicit coordinator needs the number of processes and "
                "this process's id (NUM_PROCESSES and PROCESS_ID)")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id), **kwargs)
    logger.info("torch.distributed initialized (%s): process %d/%d",
                backend, dist.get_rank(), dist.get_world_size())
    return True


def is_primary_host() -> bool:
    """True on the process that owns writes (models, checkpoints, logs):
    rank 0, or a process that joined no group (the Spark driver's role)."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        return True
    return dist.get_rank() == 0
