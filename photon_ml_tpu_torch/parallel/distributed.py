"""The 1-D device mesh (port of photon_ml_tpu/parallel/distributed.py:
DATA_AXIS/MODEL_AXIS :46-47, make_mesh :50-59, mesh_device_list :62-75,
mesh_grid_2d :93-112 and mesh_fold_devices :115-122 for the 1-D case,
_pad_to_multiple :154-161, replicate :164-165, shard_batch :168-207,
shard_block :352-375).

JAX names a mesh of devices and lets XLA place shards and insert the
collectives. The port folds in one process, as the JAX streamed objective
does (ops/sharded_objective.py): a mesh is an ordered tuple of torch
devices, one per SLOT, and each slot's share of a product runs on its own
device. Slot s of an N-slot mesh holds

- row range s of a fixed-effect batch (``shard_batch``: rows padded to a
  multiple of N with weight-0 rows);
- entity range s of a random-effect bucket (``shard_block``: entities
  padded to a multiple of N with all-padding entities, weight 0, row ids
  the scatter sentinel and feature ids -1, as in JAX);
- shard-cache blocks i with i % N == s (data/shard_cache.py).

Partials come back to the first slot's device and fold there in slot (or
shard) order, so the device count changes no addition that a fold makes.

**The slot rule.** A mesh may name one device more than once:

- ``make_mesh(N, "cpu")``: N slots on the CPU (the tests' counterpart of
  the JAX harness's virtual CPU devices, tests/conftest.py:16-21, so the
  port needs no ``utils/virtual_devices.py``);
- ``make_mesh(N, "cuda")``: cards ``cuda:0`` .. ``cuda:N-1``; fewer cards
  raise JAX's "requested N devices, have M";
- ``make_mesh(N, "cuda:K")``: N slots on card K.

``Mesh.distinct_devices`` says how many devices the slots use, so a run
of N slots on one card is never read as an N-card run.

The port cuts a CSR batch by rows, where JAX shards its nnz stream padded
with zero entries at row and column 0 (distributed.py:182-195): a slot's
product then needs only its own rows, and padding rows carry no entry.
The cut is made once, when the batch is sharded, on a host copy of the
CSR (as JAX's column split reads its CSR on the host); every product
after it runs on the slots' devices.

The 2-D mesh and its column blocks (``make_mesh_2d``,
``split_csr_columns``, ``shard_batch_feature_dim``,
``shard_batch_csr_feature_dim``, ``shard_coef``, ``unpad_coef``) are
ROADMAP A6b: they raise naming it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.data.random_effect import EntityBlock
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops.features import (
    CSRFeatures,
    DenseFeatures,
    csr_from_scipy,
)
from photon_ml_tpu_torch.ops.glm_objective import GLMBatch

Tensor = torch.Tensor

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _a6b(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name} belongs to the 2-D (data x model) mesh: it is not ported "
        "yet, it comes with ROADMAP queue A6b")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` in slot order (a device may repeat) along
    the axis ``axis_names[0]``; ``shape[axis]`` is the slot count, as
    ``jax.sharding.Mesh.shape`` reads."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (DATA_AXIS,)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one slot")
        if len(self.axis_names) != 1:
            raise _a6b(f"a mesh with axes {self.axis_names}")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self) -> int:
        return len(set(self.devices))

    def describe(self) -> str:
        """'N slots on K distinct devices (...)', for log lines."""
        names = ", ".join(str(d) for d in self.devices)
        return (f"{self.size} slot{'s' if self.size != 1 else ''} on "
                f"{self.distinct_devices} distinct "
                f"device{'s' if self.distinct_devices != 1 else ''} "
                f"({names})")


def make_mesh(num_devices: Optional[int] = None, axis: str = DATA_AXIS,
              device="cuda") -> Mesh:
    """A 1-D mesh of ``num_devices`` slots by the slot rule (module
    docstring): every card for ``"cuda"`` (one slot each), one slot for
    ``"cpu"`` or ``"cuda:K"``, when ``num_devices`` is None."""
    dev = resolve_device(device)
    if num_devices is not None and num_devices < 1:
        raise ValueError(f"a mesh needs at least one slot, got "
                         f"{num_devices}")
    if dev.type == "cuda" and dev.index is None:
        have = torch.cuda.device_count()
        n = have if num_devices is None else int(num_devices)
        if n > have:
            raise ValueError(f"requested {n} devices, have {have}")
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)),
                    (axis,))
    n = 1 if num_devices is None else int(num_devices)
    return Mesh((dev,) * n, (axis,))


def mesh_device_list(mesh: Mesh) -> List[torch.device]:
    """The slots' devices in axis order: shard-cache block i lives on
    ``mesh_device_list(mesh)[i % N]``, and partials fold in this order."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a photon_ml_tpu_torch.parallel.Mesh, got "
                        f"{type(mesh).__name__}")
    if len(mesh.shape) != 1:
        raise ValueError(
            f"expected a 1-D mesh, got axes {tuple(mesh.shape)} — the "
            "streamed device fold round-robins blocks over one axis")
    return list(mesh.devices)


def make_mesh_2d(num_data: int, num_model: int, data_axis: str = DATA_AXIS,
                 model_axis: str = MODEL_AXIS, device="cuda"):
    raise _a6b("make_mesh_2d")


def mesh_grid_2d(mesh: Mesh) -> tuple:
    """``(R, C, grid)`` of a 1-D mesh: R slots, C = 1, ``grid`` the
    ``[R][1]`` device lists (a 2-D mesh is ROADMAP A6b)."""
    devs = mesh_device_list(mesh)
    return len(devs), 1, [[d] for d in devs]


def mesh_fold_devices(mesh: Mesh) -> List[torch.device]:
    """The ``devices=`` list of `DeviceShardCache` for a mesh: for a 1-D
    mesh exactly :func:`mesh_device_list`."""
    _, _, grid = mesh_grid_2d(mesh)
    return [d for row in grid for d in row]


def split_csr_columns(mat, num_blocks: int):
    raise _a6b("split_csr_columns")


def shard_batch_feature_dim(batch, mesh, col_axis=DATA_AXIS, row_axis=None):
    raise _a6b("shard_batch_feature_dim")


def shard_batch_csr_feature_dim(batch, mesh, col_axis=DATA_AXIS,
                                row_axis=None):
    raise _a6b("shard_batch_csr_feature_dim")


def shard_coef(coef, mesh, axis=DATA_AXIS):
    raise _a6b("shard_coef")


def unpad_coef(coef, num_features: int):
    raise _a6b("unpad_coef")


def _pad_to_multiple(a: Tensor, k: int, axis: int, fill) -> Tensor:
    """``a`` padded along ``axis`` with ``fill`` to a multiple of ``k``."""
    n = a.shape[axis]
    pad = (-n) % k
    if pad == 0:
        return a
    shape = list(a.shape)
    shape[axis] = pad
    return torch.cat([a, torch.full(shape, fill, dtype=a.dtype,
                                    device=a.device)], dim=axis)


def replicate(x: Tensor, mesh: Mesh) -> List[Tensor]:
    """``x`` on every slot's device: ``x`` itself for a slot on its own
    device, a copy for each other slot."""
    return [x.to(d) for d in mesh_device_list(mesh)]


def split_slots(a: Tensor, devices: Sequence[torch.device]) -> List[Tensor]:
    """``a``'s leading axis (a multiple of ``len(devices)``) cut into
    equal contiguous ranges, range s on ``devices[s]``. Of several slots
    each owns a copy of its range, never a view of ``a``, so a slot
    keeps no other slot's data alive; one slot is ``a`` itself."""
    n = len(devices)
    if a.shape[0] % n:
        raise ValueError(f"leading axis {a.shape[0]} is not a multiple of "
                         f"{n} slots")
    if n == 1:
        return [a.to(devices[0])]
    per = a.shape[0] // n
    return [a[s * per:(s + 1) * per].to(d, copy=True)
            for s, d in enumerate(devices)]


@dataclasses.dataclass(frozen=True)
class RowShardedFeatures:
    """A feature matrix cut into contiguous row ranges, range s
    (``slots[s]``, Dense or CSR features) on ``devices[s]``. A product
    sends its vector to each slot's device once, runs each slot's product
    there and brings the results to ``devices[0]``: margins concatenate
    in row order, and the transposed products' [d] partials left-fold in
    slot order."""

    slots: Tuple[object, ...]
    devices: Tuple[torch.device, ...]
    rows_per_slot: int

    @property
    def num_features(self) -> int:
        return self.slots[0].num_features

    def _rows(self, fn, v: Tensor) -> Tensor:
        dev0 = self.devices[0]
        return torch.cat([fn(f, v.to(d)).to(dev0)
                          for f, d in zip(self.slots, self.devices)])

    def _fold(self, fn, u: Tensor) -> Tensor:
        dev0, per = self.devices[0], self.rows_per_slot
        acc = None
        for s, (f, d) in enumerate(zip(self.slots, self.devices)):
            part = fn(f, u[s * per:(s + 1) * per].to(d)).to(dev0)
            acc = part if acc is None else acc + part
        return acc

    def matvec(self, v: Tensor) -> Tensor:
        return self._rows(lambda f, x: f.matvec(x), v)

    def rmatvec(self, u: Tensor) -> Tensor:
        return self._fold(lambda f, x: f.rmatvec(x), u)

    def row_sq_matvec(self, v: Tensor) -> Tensor:
        return self._rows(lambda f, x: f.row_sq_matvec(x), v)

    def sq_rmatvec(self, u: Tensor) -> Tensor:
        return self._fold(lambda f, x: f.sq_rmatvec(x), u)


def _host_csr(feats: CSRFeatures) -> sp.csr_matrix:
    m = feats.csr
    return sp.csr_matrix(
        (m.values().cpu().numpy(), m.col_indices().cpu().numpy(),
         m.crow_indices().cpu().numpy()), shape=tuple(m.shape))


def shard_batch(batch: GLMBatch, mesh: Mesh, axis: str = DATA_AXIS
                ) -> GLMBatch:
    """Shard a GLMBatch's rows over the mesh's slots.

    Rows are padded to a multiple of the slot count with weight-0 rows
    (inert in the objective); slot s gets the s-th contiguous row range of
    the features on its device (``RowShardedFeatures``). The row columns
    (labels, offsets, weights), padded alike, stay on the first slot's
    device, where the margins, the loss sums and the folds live."""
    k = mesh.shape[axis]
    devs = mesh_device_list(mesh)
    labels = _pad_to_multiple(batch.labels, k, 0, 0.0)
    offsets = _pad_to_multiple(batch.offsets, k, 0, 0.0)
    weights = _pad_to_multiple(batch.weights, k, 0, 0.0)
    n_pad = int(labels.shape[0])
    per = n_pad // k
    feats = batch.features
    if isinstance(feats, DenseFeatures):
        slots = tuple(DenseFeatures(x)
                      for x in split_slots(
                          _pad_to_multiple(feats.x, k, 0, 0.0), devs))
    elif isinstance(feats, CSRFeatures):
        mat = _host_csr(feats)
        mat = sp.vstack([mat, sp.csr_matrix(
            (n_pad - mat.shape[0], mat.shape[1]), dtype=mat.dtype)],
            format="csr")
        slots = tuple(csr_from_scipy(mat[s * per:(s + 1) * per],
                                     dtype=feats.values.dtype, device=d)
                      for s, d in enumerate(devs))
    else:
        raise TypeError(f"unsupported feature type {type(feats)}")
    dev0 = devs[0]
    return GLMBatch(RowShardedFeatures(slots, tuple(devs), per),
                    labels.to(dev0), offsets.to(dev0), weights.to(dev0))


def shard_block(block: EntityBlock, mesh: Mesh, sentinel_row: int,
                axis: str = DATA_AXIS) -> List[EntityBlock]:
    """Shard an entity block along its entity axis: one EntityBlock a
    slot, slot s holding the s-th contiguous entity range on its device.

    Entities are padded to a multiple of the slot count with all-padding
    entities (weight 0 everywhere, row_ids == sentinel, feat_idx == -1):
    their solves stop at once with zero coefficients and their scatter
    contributions land in the sentinel slot."""
    k = mesh.shape[axis]
    devs = mesh_device_list(mesh)
    parts = [split_slots(_pad_to_multiple(t, k, 0, fill), devs)
             for t, fill in ((block.x, 0.0), (block.labels, 0.0),
                             (block.offsets, 0.0), (block.weights, 0.0),
                             (block.row_ids, sentinel_row),
                             (block.feat_idx, -1))]
    return [EntityBlock(*fields) for fields in zip(*parts)]


def pad_entities(a: Tensor, k: int, fill=0.0) -> Tensor:
    """Per-entity ``a`` [E, ...] padded to shard_block's entity count."""
    return _pad_to_multiple(a, k, 0, fill)

