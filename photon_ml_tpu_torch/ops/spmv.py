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
def _load_kernels():
    """The C entry points with their ctypes signatures, set once:
    {torch dtype: launch}."""
    from photon_ml_tpu_torch.ops import cuda_build

    lib = cuda_build.load("csr_spmv")
    vp = ctypes.c_void_p
    out = {}
    for dtype, fn in ((torch.float32, lib.csr_spmv_f32_launch),
                      (torch.float64, lib.csr_spmv_f64_launch)):
        fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int,
                       ctypes.c_longlong, vp]
        fn.restype = ctypes.c_int
        out[dtype] = fn
    return out


def csr_matvec(crow: Tensor, col: Tensor, val: Tensor, x: Tensor,
               n_cols: int) -> Tensor:
    """y [rows] = A x for the CSR A = (crow int32 [rows + 1], col int32
    [nnz], val [nnz]) of ``n_cols`` columns and x [n_cols] of val's type
    (float32 or float64). Deterministic on the card."""
    if crow.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError(f"crow and col must be int32, got {crow.dtype} "
                        f"and {col.dtype}")
    if x.dtype != val.dtype or val.dtype not in (torch.float32,
                                                 torch.float64):
        raise TypeError(f"val and x must share float32 or float64, got "
                        f"{val.dtype} and {x.dtype}")
    if x.shape != (n_cols,):
        raise ValueError(f"x must be [{n_cols}], got {tuple(x.shape)}")
    devices = {t.device for t in (crow, col, val, x)}
    dev = crow.device
    if len(devices) != 1 or dev.type not in ("cpu", "cuda"):
        raise ValueError("takes tensors all on the CPU or all on one CUDA "
                         f"device, got {sorted(map(str, devices))}")
    if dev.type == "cpu":
        return csr_matvec_plain(crow, col, val, x, n_cols)
    rows = crow.shape[0] - 1
    y = torch.empty(rows, dtype=val.dtype, device=dev)
    if rows == 0:
        return y
    if not all(t.is_contiguous() for t in (crow, col, val, x)):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    launch = _load_kernels()[val.dtype]
    with torch.cuda.device(dev):
        err = launch(crow.data_ptr(), col.data_ptr(), val.data_ptr(),
                     x.data_ptr(), y.data_ptr(), rows, col.shape[0],
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"csr_spmv kernel launch failed: CUDA error "
                           f"{err}")
    csr_matvec.launches += 1
    return y


def reset_launch_counts() -> None:
    csr_matvec.launches = 0


csr_matvec.launches = 0


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
