"""The shard cache's sparse feature block and its deterministic product.

``csr_matvec`` is y = A x for a CSR A with int32 row offsets and column
indices: the CUDA kernel ``csrc/csr_spmv.cu`` for tensors on the card,
its plain PyTorch version (``torch.mv`` on a sparse CSR tensor) for
tensors on the CPU, and a raise for anything else. The kernel fixes the
order of every addition by the row's length, so the same block gives the
same bits on every call; cuSPARSE's CSR SpMV, which the plain version
reaches on the card, did not for long rows on the H100 (PERF.md). It
stands for the products of the JAX package's CSRFeatures
(photon_ml_tpu/ops/features.py:137-145: a gather and a segment sum that
XLA compiles outside any Pallas kernel). ``csr_matvec.launches`` counts
kernel launches.

``csr_matmul`` is Y = A X for the same CSR and a dense row-major panel X
of n columns (row 10 of PERF.md's kernel table): the CUDA kernel
``csrc/csr_spmm.cu`` on the card, ``torch.sparse.mm`` on a CPU CSR
tensor on the CPU. Its column j is summed in ``csr_matvec``'s order, so
on the card it is the same bits as ``csr_matvec(A, X[:, j])``. The
batched lambda grid (ops/sharded_objective.py) multiplies G coefficient
or margin lanes through it, and the streamed matrix factorization
(ops/mf_alternating.py) its k-wide projections and its per-entity normal
equations. ``csr_matmul.launches`` counts its launches.

``CSRBlock`` is one cached shard of a fixed-effect feature matrix: its
CSR and the CSR of its transpose (so both products are row-major), built
on the block's device from the expanded-CSR triplet the spill tiers keep
(``block_from_triplet``), with int32 indices. ``nbytes`` is what it holds
on the device, the transpose included: the quantity the cache's budget
binds.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

Tensor = torch.Tensor


def csr_matvec_plain(crow: Tensor, col: Tensor, val: Tensor, x: Tensor,
                     n_cols: int) -> Tensor:
    """y = A x through torch's sparse CSR product."""
    a = torch.sparse_csr_tensor(crow, col, val,
                                size=(crow.shape[0] - 1, n_cols),
                                check_invariants=False)
    return torch.mv(a, x)


@functools.lru_cache(maxsize=None)
def _load_kernels(name: str):
    """{torch dtype: launch} of ``csrc/<name>.cu``'s f32 and f64 entry
    points, their ctypes signatures set once. csr_spmm's launch takes
    the panel's width before the stream."""
    from photon_ml_tpu_torch.ops import cuda_build

    lib = cuda_build.load(name)
    vp = ctypes.c_void_p
    width = [ctypes.c_int] if name == "csr_spmm" else []
    out = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        fn = getattr(lib, f"{name}_{suffix}_launch")
        fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_longlong,
                       *width, vp]
        fn.restype = ctypes.c_int
        out[dtype] = fn
    return out


def _device_of(crow: Tensor, col: Tensor, val: Tensor,
               x: Tensor) -> torch.device:
    """The one device (CPU or CUDA) of a product's operands, after the
    checks both products share: int32 indices, val and x of one float
    type."""
    if crow.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError(f"crow and col must be int32, got {crow.dtype} "
                        f"and {col.dtype}")
    if x.dtype != val.dtype or val.dtype not in (torch.float32,
                                                 torch.float64):
        raise TypeError(f"val and x must share float32 or float64, got "
                        f"{val.dtype} and {x.dtype}")
    devices = {t.device for t in (crow, col, val, x)}
    dev = crow.device
    if len(devices) != 1 or dev.type not in ("cpu", "cuda"):
        raise ValueError("takes tensors all on the CPU or all on one CUDA "
                         f"device, got {sorted(map(str, devices))}")
    return dev


def _launch(name: str, crow: Tensor, col: Tensor, val: Tensor, x: Tensor,
            y: Tensor, *width: int) -> bool:
    """Runs ``csrc/<name>.cu`` into y [rows, ...] on the card; False if
    there are no rows, so nothing was launched."""
    rows = y.shape[0]
    if rows == 0:
        return False
    if not all(t.is_contiguous() for t in (crow, col, val, x)):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    launch = _load_kernels(name)[val.dtype]
    dev = y.device
    with torch.cuda.device(dev):
        err = launch(crow.data_ptr(), col.data_ptr(), val.data_ptr(),
                     x.data_ptr(), y.data_ptr(), rows, col.shape[0], *width,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return True


def csr_matvec(crow: Tensor, col: Tensor, val: Tensor, x: Tensor,
               n_cols: int) -> Tensor:
    """y [rows] = A x for the CSR A = (crow int32 [rows + 1], col int32
    [nnz], val [nnz]) of ``n_cols`` columns and x [n_cols] of val's type
    (float32 or float64). Deterministic on the card."""
    dev = _device_of(crow, col, val, x)
    if x.shape != (n_cols,):
        raise ValueError(f"x must be [{n_cols}], got {tuple(x.shape)}")
    if dev.type == "cpu":
        return csr_matvec_plain(crow, col, val, x, n_cols)
    y = torch.empty(crow.shape[0] - 1, dtype=val.dtype, device=dev)
    if _launch("csr_spmv", crow, col, val, x, y):
        csr_matvec.launches += 1
    return y


def csr_matmul_plain(crow: Tensor, col: Tensor, val: Tensor, x: Tensor,
                     n_cols: int) -> Tensor:
    """Y = A X through torch's sparse CSR x dense product."""
    a = torch.sparse_csr_tensor(crow, col, val,
                                size=(crow.shape[0] - 1, n_cols),
                                check_invariants=False)
    return torch.sparse.mm(a, x)


def csr_matmul(crow: Tensor, col: Tensor, val: Tensor, x: Tensor,
               n_cols: int) -> Tensor:
    """Y [rows, n] = A X for the CSR A = (crow int32 [rows + 1], col int32
    [nnz], val [nnz]) of ``n_cols`` columns and a panel x [n_cols, n] of
    val's type (float32 or float64). Deterministic on the card, column by
    column the bits of ``csr_matvec``."""
    dev = _device_of(crow, col, val, x)
    if x.dim() != 2 or x.shape[0] != n_cols or x.shape[1] < 1:
        raise ValueError(f"x must be [{n_cols}, n >= 1], got "
                         f"{tuple(x.shape)}")
    if dev.type == "cpu":
        return csr_matmul_plain(crow, col, val, x, n_cols)
    n = x.shape[1]
    y = torch.empty((crow.shape[0] - 1, n), dtype=val.dtype, device=dev)
    if _launch("csr_spmm", crow, col, val, x, y, n):
        csr_matmul.launches += 1
    return y


def reset_launch_counts() -> None:
    csr_matvec.launches = 0
    csr_matmul.launches = 0


csr_matvec.launches = 0
csr_matmul.launches = 0


def _crow(ids: Tensor, n: int) -> Tensor:
    """Row offsets [n + 1] (int32) of sorted row ids."""
    counts = torch.bincount(ids.long(), minlength=n)
    crow = torch.zeros(n + 1, dtype=torch.int32, device=ids.device)
    crow[1:] = torch.cumsum(counts, 0)
    return crow


@dataclasses.dataclass(frozen=True)
class CSRBlock:
    """One feature block, [n_rows, n_features], as its CSR (crow, col,
    values) and its transpose's (crow_t, row_t, values_t), int32
    indices."""

    crow: Tensor
    col: Tensor
    values: Tensor
    crow_t: Tensor
    row_t: Tensor
    values_t: Tensor
    n_rows: int
    n_features: int

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.crow, self.col, self.values, self.crow_t,
                             self.row_t, self.values_t))

    def matvec(self, v: Tensor) -> Tensor:
        """x @ v -> [n_rows]."""
        return csr_matvec(self.crow, self.col, self.values, v,
                          self.n_features)

    def rmatvec(self, u: Tensor) -> Tensor:
        """x.T @ u -> [n_features]."""
        return csr_matvec(self.crow_t, self.row_t, self.values_t, u,
                          self.n_rows)

    def matmat(self, v: Tensor) -> Tensor:
        """x @ v for a panel v [n_features, n] -> [n_rows, n]."""
        return csr_matmul(self.crow, self.col, self.values, v,
                          self.n_features)

    def rmatmat(self, u: Tensor) -> Tensor:
        """x.T @ u for a panel u [n_rows, n] -> [n_features, n]."""
        return csr_matmul(self.crow_t, self.row_t, self.values_t, u,
                          self.n_rows)


def block_from_triplet(values: Tensor, cols: Tensor, rows: Tensor,
                       n_rows: int, n_features: int) -> CSRBlock:
    """The block of a canonical expanded CSR (row ids non-decreasing,
    columns sorted within a row), built on the triplet's device. The
    transpose's entries are ordered by column, then row (a stable sort),
    as scipy's ``csr.T.tocsr()`` orders them."""
    cols = cols.to(torch.int32)
    rows = rows.to(torch.int32)
    order = torch.argsort(cols, stable=True)
    return CSRBlock(
        crow=_crow(rows, n_rows), col=cols.contiguous(),
        values=values.contiguous(),
        crow_t=_crow(cols[order], n_features),
        row_t=rows[order].contiguous(), values_t=values[order].contiguous(),
        n_rows=int(n_rows), n_features=int(n_features))
