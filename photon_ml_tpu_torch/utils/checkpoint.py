"""Mid-training checkpoint/resume for GAME coordinate descent (port of
photon_ml_tpu/utils/checkpoint.py: CheckpointState :61, to_host :82,
save_checkpoint :104, latest_checkpoint :128, load_checkpoint :133).

State = (coordinate models, step counter, histories, best model, timings,
trackers, per-update records) saved every k coordinate updates; a killed
run resumes from the last complete step and reproduces the uninterrupted
run bit for bit, because each update's ``torch.Generator`` is seeded from
(seed, step) (``step_generator``), the counterpart of the JAX package's
``jax.random.fold_in(base, step)``.

Format: the port's own, one pickle per step under <dir>/ckpt-<step>.pkl,
written atomically (tmp + rename). Tensors are stored as host numpy
arrays inside ``HostArray`` markers, so a file does not depend on the
device it was written from, and ``to_device`` puts exactly those tensors
back on a device (numpy fields of the models, such as vocabularies and
entity codes, stay numpy). A checkpoint's identity is its ``meta``
dict as saved, compared for equality on resume; the JAX package's
hashed fingerprints, which also accept its older flattened tags, have
no counterpart, since no older port checkpoint exists.
"""

from __future__ import annotations

import dataclasses
import pickle
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_CKPT_RE = re.compile(r"ckpt-(\d+)\.pkl$")


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of coordinate update ``step`` (1-based) of a run
    seeded ``seed``: a function of (seed, step) alone, so a resumed run
    draws what an uninterrupted one draws."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


@dataclasses.dataclass
class CheckpointState:
    """Everything needed to resume CoordinateDescent.run mid-descent."""

    step: int  # number of completed coordinate updates
    models: Dict[str, Any]  # coordinate name -> sub-model (host arrays)
    objective_history: List[float]
    validation_history: List[Dict[str, float]]
    best_metric: Optional[float]
    best_models: Optional[Dict[str, Any]]  # host copy of best GameModel parts
    timings: Dict[str, float]
    # Per-coordinate solver results so far, aligned with objective_history.
    trackers: Dict[str, list] = dataclasses.field(default_factory=dict)
    # Identity (seed, coordinate names, task type, configuration tag):
    # loading into a run whose meta differs is an error.
    meta: Optional[Dict[str, Any]] = None
    # The port's per-update records (iteration, coordinate, seconds,
    # objective), aligned with objective_history.
    updates: List[dict] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class HostArray:
    """A tensor stored on the host: ``to_device`` makes it a tensor again."""

    array: np.ndarray


def map_leaves(obj, fn):
    """``obj`` with ``fn`` applied to each tensor (and HostArray) inside
    its dataclasses, dicts, lists and tuples, in that walk's order; other
    values kept as they are."""
    if isinstance(obj, (torch.Tensor, HostArray)):
        return fn(obj)
    if isinstance(obj, np.ndarray) or obj is None or isinstance(
            obj, (str, bytes, int, float, bool)):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {f.name: map_leaves(getattr(obj, f.name), fn)
                   for f in dataclasses.fields(obj) if f.init}
        return dataclasses.replace(obj, **changes)
    if isinstance(obj, dict):
        return {k: map_leaves(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_leaves(v, fn) for v in obj)
    return obj


def to_host(obj):
    """Replace every tensor in dataclasses / dicts / lists / tuples with a
    HostArray holding its values as numpy."""
    return map_leaves(obj, lambda t: t if isinstance(t, HostArray)
                      else HostArray(t.detach().cpu().numpy()))


def to_device(obj, device):
    """Inverse of ``to_host``: each HostArray becomes a tensor on
    ``device`` with its dtype and values."""
    return map_leaves(obj, lambda t: t.to(device)
                      if isinstance(t, torch.Tensor)
                      else torch.as_tensor(t.array, device=device))


def checkpoint_path(directory, step: int) -> Path:
    return Path(directory) / f"ckpt-{step:08d}.pkl"


def save_checkpoint(directory, state: CheckpointState,
                    keep: int = 2) -> Path:
    """Atomic write + retention of the newest `keep` checkpoints."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = checkpoint_path(directory, state.step)
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(to_host(state), f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.rename(path)

    steps = sorted(all_checkpoint_steps(directory))
    for old in steps[:-keep]:
        checkpoint_path(directory, old).unlink(missing_ok=True)
    return path


def all_checkpoint_steps(directory) -> List[int]:
    directory = Path(directory)
    if not directory.is_dir():
        return []
    return [int(m.group(1)) for p in directory.iterdir()
            if (m := _CKPT_RE.search(p.name))]


def latest_checkpoint(directory) -> Optional[Path]:
    steps = all_checkpoint_steps(directory)
    return checkpoint_path(directory, max(steps)) if steps else None


def load_checkpoint(path) -> CheckpointState:
    """The state as saved, tensors still HostArrays (see to_device)."""
    with open(path, "rb") as f:
        state = pickle.load(f)
    if not isinstance(state, CheckpointState):
        raise ValueError(f"{path} is not a CoordinateDescent checkpoint")
    return state
