"""The device mesh, 1-D and 2-D (port of photon_ml_tpu/parallel/
distributed.py: DATA_AXIS/MODEL_AXIS :46-47, make_mesh :49-59,
mesh_device_list :61-74, make_mesh_2d :76-90, mesh_grid_2d :92-109,
mesh_fold_devices :111-118, split_csr_columns :120-146,
_pad_to_multiple :149-157, replicate :160-161, shard_batch :164-204,
shard_batch_feature_dim :207-259, shard_batch_csr_feature_dim
:262-331, shard_coef :334-343, unpad_coef :346-349, shard_block
:352-375).

JAX names a mesh of devices and lets XLA place shards and insert the
collectives. The port folds in one process, as the JAX streamed objective
does (ops/sharded_objective.py): a mesh is an ordered tuple of torch
devices, one per SLOT, and each slot's share of a product runs on its own
device. Slot s of an N-slot 1-D mesh holds

- row range s of a fixed-effect batch (``shard_batch``: rows padded to a
  multiple of N with weight-0 rows);
- entity range s of a random-effect bucket (``shard_block``: entities
  padded to a multiple of N with all-padding entities, weight 0, row ids
  the scatter sentinel and feature ids -1, as in JAX);
- shard-cache blocks i with i % N == s (data/shard_cache.py).

Partials come back to the first slot's device and fold there in slot (or
shard) order, so the device count changes no addition that a fold makes.

**The 2-D mesh** (``make_mesh_2d(R, C)``: axes ``data`` x ``model``)
keeps its R x C slots row-major, slot ``r * C + c`` at ``grid[r][c]``
(``mesh_grid_2d``). Rows shard over the R data rows and the feature
(coefficient) dimension over the C columns: ``split_csr_columns`` cuts
a host CSR into C contiguous column blocks of ceil(d / C) columns with
local column ids; ``shard_batch_feature_dim`` places a dense batch's
(r, c) block on ``grid[r][c]`` (``FeatureShardedFeatures``), and
``shard_batch_csr_feature_dim`` a CSR's column blocks on the column
axis's slots (``ops/features.BlockedCSRFeatures``; a CSR cannot shard
rows at the same time, as in JAX); ``shard_coef`` cuts a coefficient
vector into the per-slot column slices and ``unpad_coef`` strips the
padding. Entities and the row-sharded batch shard over the data axis:
on a 2-D mesh over the first column's slots ``grid[r][0]``
(``axis_slots``), one launch a data row where JAX's ``shard_map`` runs
each row's shard again on each of the C model-axis devices.

**The slot rule.** A mesh may name one device more than once:

- ``make_mesh(N, "cpu")``, ``make_mesh_2d(R, C, device="cpu")``: N
  (R x C) slots on the CPU (the tests' counterpart of the JAX harness's
  virtual CPU devices, tests/conftest.py:16-21, so the port needs no
  ``utils/virtual_devices.py``);
- ``make_mesh(N, "cuda")``, ``make_mesh_2d(R, C, device="cuda")``: cards
  ``cuda:0`` .. ``cuda:N-1`` (R x C of them); fewer cards raise JAX's
  "requested N devices, have M";
- ``make_mesh(N, "cuda:K")``, ``make_mesh_2d(R, C, device="cuda:K")``:
  N (R x C) slots on card K.

``Mesh.distinct_devices`` says how many devices the slots use, so a run
of N slots on one card is never read as an N-card run.

The port cuts a CSR batch by rows, where JAX shards its nnz stream padded
with zero entries at row and column 0 (distributed.py:182-195): a slot's
product then needs only its own rows, and padding rows carry no entry.
The cut is made once, when the batch is sharded, on a host copy of the
CSR (as JAX's column split reads its CSR on the host); every product
after it runs on the slots' devices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.data.random_effect import EntityBlock
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops.features import (
    BlockedCSRFeatures,
    CSRFeatures,
    DenseFeatures,
    blocked_csr_from_scipy,
    csr_from_scipy,
)
from photon_ml_tpu_torch.ops.glm_objective import GLMBatch

Tensor = torch.Tensor

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D or 2-D mesh: ``devices`` in slot order, row-major over
    ``dims`` (a device may repeat), along the axes ``axis_names``;
    ``shape[axis]`` is an axis's extent, as ``jax.sharding.Mesh.shape``
    reads. ``dims`` defaults to the slot count of a 1-D mesh."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (DATA_AXIS,)
    dims: Tuple[int, ...] = ()

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one slot")
        if len(self.axis_names) not in (1, 2):
            raise ValueError(f"a mesh has one or two axes, got "
                             f"{self.axis_names}")
        dims = tuple(int(n) for n in self.dims) or (
            (len(self.devices),) if len(self.axis_names) == 1 else ())
        if len(dims) != len(self.axis_names) or \
                math.prod(dims) != len(self.devices):
            raise ValueError(f"a mesh with axes {self.axis_names} needs "
                             f"dims whose product is its {len(self.devices)} "
                             f"slots, got {self.dims}")
        object.__setattr__(self, "dims", dims)
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self) -> int:
        return len(set(self.devices))

    def describe(self) -> str:
        """'N slots on K distinct devices (...)', or 'R x C slots on ...'
        for a 2-D mesh, for log lines."""
        names = ", ".join(str(d) for d in self.devices)
        slots = " x ".join(str(n) for n in self.dims)
        return (f"{slots} slot{'s' if self.size != 1 else ''} on "
                f"{self.distinct_devices} distinct "
                f"device{'s' if self.distinct_devices != 1 else ''} "
                f"({names})")


def _slot_devices(n: int, device) -> Tuple[torch.device, ...]:
    """n slots by the slot rule (module docstring)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        have = torch.cuda.device_count()
        if n > have:
            raise ValueError(f"requested {n} devices, have {have}")
        return tuple(torch.device("cuda", i) for i in range(n))
    return (dev,) * n


def make_mesh(num_devices: Optional[int] = None, axis: str = DATA_AXIS,
              device="cuda") -> Mesh:
    """A 1-D mesh of ``num_devices`` slots by the slot rule (module
    docstring): every card for ``"cuda"`` (one slot each), one slot for
    ``"cpu"`` or ``"cuda:K"``, when ``num_devices`` is None."""
    dev = resolve_device(device)
    if num_devices is not None and num_devices < 1:
        raise ValueError(f"a mesh needs at least one slot, got "
                         f"{num_devices}")
    if num_devices is None:
        num_devices = (torch.cuda.device_count()
                       if dev.type == "cuda" and dev.index is None else 1)
    return Mesh(_slot_devices(int(num_devices), dev), (axis,))


def make_mesh_2d(num_data: int, num_model: int, data_axis: str = DATA_AXIS,
                 model_axis: str = MODEL_AXIS, device="cuda") -> Mesh:
    """A 2-D (data, model) mesh of R x C slots by the slot rule, row-major:
    batch rows shard over ``data_axis``, the feature (coefficient)
    dimension over ``model_axis`` (the reference's two scale axes,
    GameEstimator.scala:330-334, 523-525)."""
    if num_data < 1 or num_model < 1:
        raise ValueError(f"mesh extents must be >= 1, got "
                         f"{num_data}x{num_model}")
    return Mesh(_slot_devices(num_data * num_model, device),
                (data_axis, model_axis), (int(num_data), int(num_model)))


def _check_mesh(mesh) -> Mesh:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a photon_ml_tpu_torch.parallel.Mesh, got "
                        f"{type(mesh).__name__}")
    return mesh


def mesh_device_list(mesh: Mesh) -> List[torch.device]:
    """The slots' devices of a 1-D mesh in axis order: shard-cache block
    i lives on ``mesh_device_list(mesh)[i % N]``, and partials fold in
    this order. A 2-D mesh raises (its fold lists are
    ``mesh_fold_devices``)."""
    if len(_check_mesh(mesh).shape) != 1:
        raise ValueError(
            f"expected a 1-D mesh, got axes {tuple(mesh.shape)} — the "
            "streamed device fold round-robins blocks over one axis")
    return list(mesh.devices)


def mesh_grid_2d(mesh: Mesh) -> tuple:
    """``(R, C, grid)`` of a 1-D or 2-D mesh: R data-axis extents, C
    model-axis extents, ``grid`` the row-major ``[R][C]`` device lists. A
    1-D mesh is the C = 1 column. Cache shard i's column block c lives
    on ``grid[i % R][c]``."""
    devs = _check_mesh(mesh).devices
    if len(mesh.dims) == 1:
        return len(devs), 1, [[d] for d in devs]
    r, c = mesh.dims
    return r, c, [list(devs[i * c:(i + 1) * c]) for i in range(r)]


def mesh_fold_devices(mesh: Mesh) -> List[torch.device]:
    """The flat row-major slot list of a 1-D or 2-D mesh: the ``devices=``
    of `DeviceShardCache`, whose slot ``(i % R) * C + c`` holds shard i's
    column block c. For a 1-D mesh exactly :func:`mesh_device_list`."""
    _, _, grid = mesh_grid_2d(mesh)
    return [d for row in grid for d in row]


def _slot(mesh: Mesh, index: dict) -> torch.device:
    """The slot at ``index`` ({axis name: position}; an axis left out is
    at 0)."""
    pos = [index.get(a, 0) for a in mesh.axis_names]
    if len(pos) == 1:
        return mesh.devices[pos[0]]
    return mesh.devices[pos[0] * mesh.dims[1] + pos[1]]


def axis_slots(mesh: Mesh, axis: str = DATA_AXIS) -> List[torch.device]:
    """The slots along ``axis`` (every other axis at 0): a 1-D mesh's
    slots, or on a 2-D mesh the data rows' first slots ``grid[r][0]``
    (or the model columns' ``grid[0][c]``)."""
    n = _check_mesh(mesh).shape[axis]
    return [_slot(mesh, {axis: i}) for i in range(n)]


def split_csr_columns(mat, num_blocks: int) -> tuple:
    """``(block_size, [sub_0 .. sub_{C-1}])`` of a host sparse matrix:
    ``block_size = ceil(d / num_blocks)`` and ``sub_c`` the canonical CSR
    slice ``mat[:, c*bs:(c+1)*bs]`` with LOCAL column ids (the last
    blocks narrower or empty where C does not divide d). Scipy's column
    slice keeps the canonical entry order, so each block's entries are an
    order-preserving subsequence of the full stream, and a row's entries
    are its block 0 entries, then its block 1 entries, and so on (the
    product stream's map, ops/spmv.py ``EntryStream``)."""
    if num_blocks < 1:
        raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
    mat = sp.csr_matrix(mat)
    d = mat.shape[1]
    block = -(-d // num_blocks)
    subs = []
    for c in range(num_blocks):
        lo = min(c * block, d)
        hi = min(lo + block, d)
        sub = mat[:, lo:hi].tocsr()
        sub.sort_indices()
        subs.append(sub)
    return block, subs


@dataclasses.dataclass(frozen=True)
class FeatureShardedFeatures:
    """A dense matrix cut into an R x C grid of blocks (rows padded to a
    multiple of R, columns to a multiple of C): ``blocks[r][c]`` on
    ``devices[r][c]``, [rows_per_slot, block_size] each; every [n_rows]
    and [n_features] vector lives on ``home``. A margin adds the row's C
    block partials in column order on ``home``; a transposed product
    adds each column's R partials in row order there and joins the
    columns in order. One ``torch.matmul`` a block: the sums reassociate
    against the unsharded product, as the JAX mesh's psum does."""

    blocks: Tuple[Tuple[DenseFeatures, ...], ...]
    devices: Tuple[Tuple[torch.device, ...], ...]
    rows_per_slot: int
    block_size: int
    home: torch.device

    @property
    def num_features(self) -> int:
        return len(self.blocks[0]) * self.block_size

    def _mv(self, name: str, v: Tensor) -> Tensor:
        bs, out = self.block_size, []
        for row, devs in zip(self.blocks, self.devices):
            acc = None
            for c, (f, d) in enumerate(zip(row, devs)):
                part = getattr(f, name)(v[c * bs:(c + 1) * bs].to(d))
                part = part.to(self.home)
                acc = part if acc is None else acc + part
            out.append(acc)
        return torch.cat(out)

    def _rmv(self, name: str, u: Tensor) -> Tensor:
        per, out = self.rows_per_slot, []
        for c in range(len(self.blocks[0])):
            acc = None
            for r, (row, devs) in enumerate(zip(self.blocks, self.devices)):
                part = getattr(row[c], name)(u[r * per:(r + 1) * per].to(
                    devs[c])).to(self.home)
                acc = part if acc is None else acc + part
            out.append(acc)
        return torch.cat(out)

    def matvec(self, v: Tensor) -> Tensor:
        return self._mv("matvec", v)

    def rmatvec(self, u: Tensor) -> Tensor:
        return self._rmv("rmatvec", u)

    def row_sq_matvec(self, v: Tensor) -> Tensor:
        return self._mv("row_sq_matvec", v)

    def sq_rmatvec(self, u: Tensor) -> Tensor:
        return self._rmv("sq_rmatvec", u)


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
    """``x`` on every slot's device (row-major on a 2-D mesh): ``x``
    itself for a slot on its own device, a copy for each other slot."""
    return [x.to(d) for d in mesh_fold_devices(mesh)]


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
    """Shard a GLMBatch's rows over the slots of ``axis`` (on a 2-D mesh
    the data rows' first slots, ``axis_slots``).

    Rows are padded to a multiple of the slot count with weight-0 rows
    (inert in the objective); slot s gets the s-th contiguous row range of
    the features on its device (``RowShardedFeatures``). The row columns
    (labels, offsets, weights), padded alike, stay on the first slot's
    device, where the margins, the loss sums and the folds live."""
    devs = axis_slots(mesh, axis)
    k = len(devs)
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


def shard_batch_feature_dim(batch: GLMBatch, mesh: Mesh,
                            col_axis: str = DATA_AXIS,
                            row_axis: Optional[str] = None) -> GLMBatch:
    """Shard a dense GLMBatch's FEATURE dimension over ``col_axis`` and,
    with ``row_axis``, its rows over that axis at the same time (a 2-D
    mesh): columns zero-padded to a multiple of the column extent C, rows
    to a multiple of R with weight-0 rows; block (r, c) on the slot at
    (r, c) (``FeatureShardedFeatures``), the row columns on the mesh's
    first slot. Padded coordinates stay exactly 0 in a solve: their
    columns are zero, so is their gradient. Sparse features go to
    :func:`shard_batch_csr_feature_dim`."""
    feats = batch.features
    if isinstance(feats, (CSRFeatures, BlockedCSRFeatures)):
        return shard_batch_csr_feature_dim(batch, mesh, col_axis=col_axis,
                                           row_axis=row_axis)
    if not isinstance(feats, DenseFeatures):
        raise TypeError(
            f"unsupported feature type {type(feats)} for feature-dimension "
            "sharding")
    kc = _check_mesh(mesh).shape[col_axis]
    kr = 1 if row_axis is None else mesh.shape[row_axis]
    x = _pad_to_multiple(_pad_to_multiple(feats.x.cpu(), kc, 1, 0.0), kr,
                         0, 0.0)
    rows = [_pad_to_multiple(t, kr, 0, 0.0)
            for t in (batch.labels, batch.offsets, batch.weights)]
    per, bs = x.shape[0] // kr, x.shape[1] // kc
    devs = tuple(tuple(_slot(mesh, {row_axis: r, col_axis: c})
                       for c in range(kc)) for r in range(kr))
    blocks = tuple(tuple(
        DenseFeatures(x[r * per:(r + 1) * per, c * bs:(c + 1) * bs].to(
            d, copy=True).contiguous()) for c, d in enumerate(row))
        for r, row in enumerate(devs))
    home = mesh.devices[0]
    return GLMBatch(FeatureShardedFeatures(blocks, devs, per, bs, home),
                    *(t.to(home) for t in rows))


def shard_batch_csr_feature_dim(batch: GLMBatch, mesh: Mesh,
                                col_axis: str = DATA_AXIS,
                                row_axis: Optional[str] = None) -> GLMBatch:
    """Feature-dimension sharding of SPARSE features: the entries cut
    into column blocks (``BlockedCSRFeatures``), block c on the c-th slot
    of ``col_axis``, the product stream and the row columns on the mesh's
    first slot. Entries are routed by column, so rows cannot shard at
    the same time: ``row_axis`` must be None, as in JAX."""
    if row_axis is not None:
        raise ValueError(
            "CSR feature-dim sharding routes nnz by column; a 2-D "
            "(row x col) layout is only available for dense features")
    kc = _check_mesh(mesh).shape[col_axis]
    feats = batch.features
    if isinstance(feats, BlockedCSRFeatures) and feats.num_blocks != kc:
        raise ValueError(
            f"features have {feats.num_blocks} column blocks, mesh axis "
            f"{col_axis!r} has {kc} devices — rebuild with num_blocks={kc}")
    if isinstance(feats, BlockedCSRFeatures):
        feats = _host_blocked(feats)
    elif isinstance(feats, CSRFeatures):
        feats = _host_csr(feats)
    else:
        raise TypeError(f"expected CSR features, got {type(feats)}")
    home = mesh.devices[0]
    feats = blocked_csr_from_scipy(
        feats, kc, dtype=batch.labels.dtype,
        devices=[_slot(mesh, {col_axis: c}) for c in range(kc)])
    return GLMBatch(feats, *(t.to(home) for t in (
        batch.labels, batch.offsets, batch.weights)))


def _host_blocked(feats: BlockedCSRFeatures) -> sp.csr_matrix:
    """The host CSR of column-blocked features (global columns)."""
    bs = feats.block_size
    parts = []
    for b in feats.blocks:
        parts.append(sp.csr_matrix(
            (b.values.cpu().numpy(), b.col.cpu().numpy(),
             b.crow.cpu().numpy()), shape=(feats.n_rows, bs)))
    return sp.hstack(parts, format="csr")


def shard_coef(coef, mesh: Mesh, axis: str = DATA_AXIS) -> List[Tensor]:
    """A coefficient vector zero-padded to a multiple of the extent of
    ``axis`` and cut into its slots' column slices, slice c on the c-th
    slot of the axis: the layout of :func:`shard_batch_feature_dim` (JAX
    keeps them as one sharded array)."""
    slots = axis_slots(mesh, axis)
    coef = _pad_to_multiple(torch.as_tensor(coef), len(slots), 0, 0.0)
    bs = coef.shape[0] // len(slots)
    return [coef[c * bs:(c + 1) * bs].to(d, copy=True)
            for c, d in enumerate(slots)]


def unpad_coef(coef, num_features: int) -> Tensor:
    """Strip feature-dimension padding from a coefficient vector (or a
    [k, d_padded] stack), or from the column slices of ``shard_coef``
    (joined on the first slice's device)."""
    if isinstance(coef, (list, tuple)):
        coef = torch.cat([c.to(coef[0].device) for c in coef], dim=-1)
    return torch.as_tensor(coef)[..., :num_features]


def shard_block(block: EntityBlock, mesh: Mesh, sentinel_row: int,
                axis: str = DATA_AXIS) -> List[EntityBlock]:
    """Shard an entity block along its entity axis: one EntityBlock a
    slot of ``axis`` (``axis_slots``: a 2-D mesh's data rows, one launch
    each), slot s holding the s-th contiguous entity range on its device.

    Entities are padded to a multiple of the slot count with all-padding
    entities (weight 0 everywhere, row_ids == sentinel, feat_idx == -1):
    their solves stop at once with zero coefficients and their scatter
    contributions land in the sentinel slot."""
    devs = axis_slots(mesh, axis)
    k = len(devs)
    parts = [split_slots(_pad_to_multiple(t, k, 0, fill), devs)
             for t, fill in ((block.x, 0.0), (block.labels, 0.0),
                             (block.offsets, 0.0), (block.weights, 0.0),
                             (block.row_ids, sentinel_row),
                             (block.feat_idx, -1))]
    return [EntityBlock(*fields) for fields in zip(*parts)]


def pad_entities(a: Tensor, k: int, fill=0.0) -> Tensor:
    """Per-entity ``a`` [E, ...] padded to shard_block's entity count."""
    return _pad_to_multiple(a, k, 0, fill)

