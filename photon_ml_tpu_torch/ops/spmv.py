"""The deterministic CSR products (kernel rows 9 and 10) and the shard
cache's sparse feature block.

``csr_matvec`` is y = A x for a CSR A with int32 row offsets and column
indices: the CUDA kernel ``csrc/csr_spmv.cu`` for tensors on the card,
its plain PyTorch version (``torch.mv`` on a sparse CSR tensor) for
tensors on the CPU, and a raise for anything else. It stands for the
products of the JAX package's CSRFeatures (photon_ml_tpu/ops/features.py:
137-145: a gather and a segment sum that XLA compiles outside any Pallas
kernel). ``csr_matvec.launches`` counts kernel launches; a product
recorded into a CUDA graph launches nothing then and counts in
``csr_matvec.recorded`` instead (whoever replays the graph counts its
launches).

``csr_matmul`` is Y = A X for the same CSR and a dense row-major panel X
of n columns (row 10): the CUDA kernel ``csrc/csr_spmm.cu`` on the card,
``torch.sparse.mm`` on a CPU CSR tensor on the CPU. The batched lambda
grid (ops/sharded_objective.py) multiplies G coefficient or margin lanes
through it, and the streamed matrix factorization (ops/mf_alternating.py)
its k-wide projections and its per-entity normal equations.
``csr_matmul.launches`` and ``.recorded`` count its launches and
captures alike.

Both kernels are ``csrc/csr_order.cuh``'s, and keep its order contract:
the order of every addition of a row depends only on the row's own length
(and compile-time constants), so the same row gives the same bits in any
matrix and on every call, and column j of ``csr_matmul`` is the bits of
``csr_matvec(A, X[:, j])``. cuSPARSE's products, which the plain versions
reach on the card, did not repeat their bits for the transpose's long
rows on the H100 (PERF.md).

``CSROperand`` is a CSR checked once for the kernels (int32 indices, one
device, contiguous, values float32 or float64), with its pointers and
its scratch size kept: a product then checks only its vector or panel,
allocates its output (and, for a CSR whose rows may be cut into chunks,
the chunk sums' scratch) and makes one C call on the current stream.
``CSRBlock`` is one cached shard of a fixed-effect feature matrix: its
CSR and the CSR of its transpose (so both products are row-major), built
on the block's device from the expanded-CSR triplet the spill tiers keep
(``block_from_triplet``), with int32 indices, each checked once as a
``CSROperand`` when the block is built. ``nbytes`` is what it holds on
the device, the transpose included: the quantity the cache's budget
binds. An operand's products follow each other on the current stream
(they share its scratch and counters).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Tuple

import torch

from photon_ml_tpu_torch.utils import device_loop

Tensor = torch.Tensor


def csr_matvec_plain(crow: Tensor, col: Tensor, val: Tensor, x: Tensor,
                     n_cols: int) -> Tensor:
    """y = A x through torch's sparse CSR product."""
    a = torch.sparse_csr_tensor(crow, col, val,
                                size=(crow.shape[0] - 1, n_cols),
                                check_invariants=False)
    return torch.mv(a, x)


def csr_matmul_plain(crow: Tensor, col: Tensor, val: Tensor, x: Tensor,
                     n_cols: int) -> Tensor:
    """Y = A X through torch's sparse CSR x dense product."""
    a = torch.sparse_csr_tensor(crow, col, val,
                                size=(crow.shape[0] - 1, n_cols),
                                check_invariants=False)
    return torch.sparse.mm(a, x)


def order_lanes(m: int, chunk: int) -> int:
    """G, the lanes that sum a chunk of a row of m entries in the order
    contract: the smallest power of two >= m / 4, at most 32 (32 for a
    row cut into chunks)."""
    if m > chunk:
        return 32
    g = 1
    while g < 32 and 4 * g < m:
        g *= 2
    return g


def csr_order_reference(crow, col, val, x, chunk: int):
    """Y = A X in numpy, in the kernels' order contract
    (``csrc/csr_order.cuh``) and in val's type: each row cut into chunks
    of ``chunk`` entries, lane t of G = ``order_lanes`` adding the chunk's
    products t, t + G, ... in order from 0, the lanes added by an xor
    butterfly, the chunks' sums in chunk order. A specification to hold
    the kernels' bits against (slow: a Python loop over rows); x is
    [n_cols] or [n_cols, n] and so is the result's second axis."""
    import numpy as np

    crow, col, val, x = (np.asarray(a) for a in (crow, col, val, x))
    X = x[:, None] if x.ndim == 1 else x
    dt = val.dtype
    Y = np.zeros((len(crow) - 1, X.shape[1]), dt)
    for r in range(len(crow) - 1):
        b, e = int(crow[r]), int(crow[r + 1])
        if e == b:
            continue
        p = val[b:e, None] * X[col[b:e]]
        g = order_lanes(e - b, chunk)
        total = None
        for s in range(0, e - b, chunk):
            q = p[s:s + chunk]
            acc = np.zeros((g, X.shape[1]), dt)
            for i in range(0, len(q), g):
                acc[:len(q[i:i + g])] += q[i:i + g]
            o = g // 2
            while o > 0:
                acc = acc[:o] + acc[o:2 * o]
                o //= 2
            total = acc[0] if total is None else total + acc[0]
        Y[r] = total
    return Y[:, 0] if x.ndim == 1 else Y


class _Call(ctypes.Structure):
    """csr_order.cuh's Call: one product's operands, made once per CSR
    and panel width."""

    _fields_ = [("crow", ctypes.c_void_p), ("col", ctypes.c_void_p),
                ("val", ctypes.c_void_p), ("part", ctypes.c_void_p),
                ("counter", ctypes.c_void_p), ("nnz", ctypes.c_longlong),
                ("n_cols", ctypes.c_longlong), ("rows", ctypes.c_int),
                ("n", ctypes.c_int)]


class _Library:
    """The two kernels' C entry points with their ctypes signatures, the
    chunk length of the order contract and the scratch rule."""

    def __init__(self):
        from photon_ml_tpu_torch.ops import cuda_build

        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        spmv_lib, spmm_lib = (cuda_build.load(n)
                              for n in ("csr_spmv", "csr_spmm"))
        # (panel, dtype) -> run(call, x, y, stream)
        self.run: Dict[Tuple[bool, torch.dtype], object] = {}
        for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
            for panel, lib, name in ((False, spmv_lib, "csr_spmv"),
                                     (True, spmm_lib, "csr_spmm")):
                fn = getattr(lib, f"{name}_{suffix}_run")
                fn.argtypes = [vp] * 4
                fn.restype = ci
                self.run[panel, dtype] = fn
        self.chunk = int(spmv_lib.csr_chunk_entries())
        slots = spmv_lib.csr_scratch_slots
        slots.argtypes = [ci, cll, cll]
        slots.restype = cll
        self.slots = slots
        # The current device and stream without a context or a Stream
        # object: a product's host time is the point of its thin path.
        self.current_device = torch._C._cuda_getDevice
        self.stream = torch._C._cuda_getCurrentRawStream


@functools.lru_cache(maxsize=None)
def _library() -> _Library:
    return _Library()


def chunk_entries() -> int:
    """The entries of a chunk of a long row in the kernels' order
    contract (``csrc/csr_order.cuh`` kChunk); builds the kernels."""
    return _library().chunk


class CSROperand:
    """A CSR (crow int32 [rows + 1], col int32 [nnz], val float32 or
    float64 [nnz]) of ``n_cols`` columns, checked once: one device (the
    CPU or one CUDA device), int32 indices, contiguous tensors, matching
    lengths. On the card it keeps the pointers and the chunk-sum slots
    its products need: per panel width, the C call's operands (a
    ``_Call``), the chunk sums' scratch and the row counters, made at its
    first product of that width (outside any CUDA graph capture) and
    kept, so that a later product allocates only its output and passes
    the C call four pointers."""

    __slots__ = ("crow", "col", "val", "rows", "n_cols", "nnz", "device",
                 "index", "_calls", "_kept", "_plain")

    def __init__(self, crow: Tensor, col: Tensor, val: Tensor, n_cols: int,
                 kept: bool = True):
        if crow.dtype != torch.int32 or col.dtype != torch.int32:
            raise TypeError(f"crow and col must be int32, got {crow.dtype} "
                            f"and {col.dtype}")
        if val.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"values must be float32 or float64, got "
                            f"{val.dtype}")
        devices = {t.device for t in (crow, col, val)}
        dev = crow.device
        if len(devices) != 1 or dev.type not in ("cpu", "cuda"):
            raise ValueError("a CSR lies all on the CPU or all on one CUDA "
                             f"device, got {sorted(map(str, devices))}")
        if not all(t.is_contiguous() for t in (crow, col, val)):
            raise ValueError("a CSR's tensors must be contiguous")
        if (crow.dim() != 1 or col.dim() != 1 or val.shape != col.shape
                or crow.shape[0] < 1):
            raise ValueError(f"a CSR is crow [rows + 1], col and val [nnz], "
                             f"got {tuple(crow.shape)}, {tuple(col.shape)}, "
                             f"{tuple(val.shape)}")
        self.crow, self.col, self.val = crow, col, val
        self.rows = int(crow.shape[0]) - 1
        self.n_cols = int(n_cols)
        self.nnz = int(col.shape[0])
        self.device = dev
        self.index = dev.index if dev.type == "cuda" else None
        self._calls = {}  # width -> (address of its _Call, what it holds)
        self._kept = kept  # False: one call's operand (csr_matvec's)
        # On the CPU, the plain version's sparse tensor (the same storage).
        self._plain = (None if self.index is not None else
                       torch.sparse_csr_tensor(crow, col, val,
                                               size=(self.rows, self.n_cols),
                                               check_invariants=False))

    @property
    def dtype(self) -> torch.dtype:
        return self.val.dtype

    def with_values(self, val: Tensor) -> "CSROperand":
        """The same pattern with other values (checked like these)."""
        return CSROperand(self.crow, self.col, val, self.n_cols, kept=False)

    def matvec(self, x: Tensor) -> Tensor:
        """A x for x [n_cols] of the values' type on the CSR's device."""
        if x.device != self.device or x.dtype != self.val.dtype:
            raise ValueError(f"x must be {self.val.dtype} on {self.device}, "
                             f"got {x.dtype} on {x.device}")
        if x.shape != (self.n_cols,):
            raise ValueError(f"x must be [{self.n_cols}], got "
                             f"{tuple(x.shape)}")
        if self.index is None:
            return torch.mv(self._plain, x)
        y = torch.empty(self.rows, dtype=self.val.dtype, device=self.device)
        if self._launch(False, x, y, 1):
            _count(csr_matvec)
        return y

    def matmat(self, x: Tensor) -> Tensor:
        """A X for a panel X [n_cols, n >= 1] of the values' type on the
        CSR's device."""
        if x.device != self.device or x.dtype != self.val.dtype:
            raise ValueError(f"x must be {self.val.dtype} on {self.device}, "
                             f"got {x.dtype} on {x.device}")
        if x.dim() != 2 or x.shape[0] != self.n_cols or x.shape[1] < 1:
            raise ValueError(f"x must be [{self.n_cols}, n >= 1], got "
                             f"{tuple(x.shape)}")
        if self.index is None:
            return torch.sparse.mm(self._plain, x)
        n = x.shape[1]
        y = torch.empty((self.rows, n), dtype=self.val.dtype,
                        device=self.device)
        if self._launch(True, x, y, n):
            _count(csr_matmul)
        return y

    def prepare(self, n: int = 1) -> None:
        """Make the C call's operands of width n (the scratch included)
        without a product: what a CUDA graph capture needs before it
        records the operand's first product of that width."""
        if self.index is not None and n not in self._calls:
            self._make_call(_library(), n)

    def _launch(self, panel: bool, x: Tensor, y: Tensor, n: int) -> bool:
        """One C call into y on the current stream; False when there are
        no rows (nothing launched)."""
        if self.rows == 0:
            return False
        if torch._C._functorch.is_functorch_wrapped_tensor(x):
            raise TypeError(
                "the CSR product's CUDA kernel is called through ctypes: "
                "torch.func cannot differentiate or vmap it (a "
                "minimize_newton objective over CSRFeatures on the card); "
                "give such an objective DenseFeatures")
        if not x.is_contiguous():
            raise ValueError("the CUDA kernel takes a contiguous x")
        lib = _library()
        if self.index != lib.current_device():
            raise ValueError(f"the CSR lies on {self.device}, not on the "
                             "current CUDA device")
        call = self._calls.get(n)
        if call is None:
            call = self._make_call(lib, n)
        err = lib.run[panel, self.val.dtype](call[0], x.data_ptr(),
                                             y.data_ptr(),
                                             lib.stream(self.index))
        if err != 0:
            raise RuntimeError(f"{'csr_spmm' if panel else 'csr_spmv'} "
                               f"kernel launch failed: CUDA error {err}")
        return True

    def _make_call(self, lib: _Library, n: int) -> tuple:
        """The C call's operands at width n: the CSR, and the chunk sums
        (slots x min(n, 32) values) and row counters (zeros, which every
        launch leaves zero) where a row can be cut into chunks."""
        call = _Call(self.crow.data_ptr(), self.col.data_ptr(),
                     self.val.data_ptr(), None, None, self.nnz, self.n_cols,
                     self.rows, n)
        held = [call]
        slots = int(lib.slots(self.rows, self.nnz, self.n_cols))
        if slots:
            if self._kept and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "a CSR's first product of a width makes its scratch, "
                    "which cannot be made while a CUDA graph is captured: "
                    f"make one product of width {n} before the capture")
            part = torch.empty(slots * min(n, 32), dtype=self.val.dtype,
                               device=self.device)
            counter = torch.zeros(self.rows, dtype=torch.int32,
                                  device=self.device)
            call.part, call.counter = part.data_ptr(), counter.data_ptr()
            held += [part, counter]
        self._calls[n] = (ctypes.addressof(call), held)
        return self._calls[n]


def _count(product) -> None:
    """One call of ``product``'s kernel: a launch, or, on a stream that
    is capturing a CUDA graph, a launch recorded into the graph. A
    recorded launch counts in ``recorded`` (a serving bucket's graph adds
    its recorded launches per replay), or, while a coordinate update's
    graph is captured with a launch tally, in the tally, which counts it
    each time a replay runs it, inside a device loop once a trip
    (utils/device_loop.py)."""
    if torch.cuda.is_current_stream_capturing():
        tally = device_loop.active_tally()
        if tally is not None:
            tally.count((product.__name__,))
        else:
            product.recorded += 1
    else:
        product.launches += 1


def _settle(key, n: int) -> None:
    _PRODUCTS[key[0]].launches += n


def _checked(crow: Tensor, col: Tensor, val: Tensor, x: Tensor,
             n_cols: int) -> CSROperand:
    """The operand of one product given as tensors, after the checks both
    products share: int32 indices, val and x of one float type, all on
    one device (on the CPU, any strides)."""
    if x.dtype != val.dtype:
        raise TypeError(f"val and x must share float32 or float64, got "
                        f"{val.dtype} and {x.dtype}")
    if x.device != crow.device:
        raise ValueError("takes tensors all on the CPU or all on one CUDA "
                         f"device, got {crow.device} and {x.device}")
    if crow.device.type == "cpu":
        crow, col, val = crow.contiguous(), col.contiguous(), val.contiguous()
    return CSROperand(crow, col, val, n_cols, kept=False)


def csr_matvec(crow: Tensor, col: Tensor, val: Tensor, x: Tensor,
               n_cols: int) -> Tensor:
    """y [rows] = A x for the CSR A = (crow int32 [rows + 1], col int32
    [nnz], val [nnz]) of ``n_cols`` columns and x [n_cols] of val's type
    (float32 or float64). Deterministic on the card."""
    return _checked(crow, col, val, x, n_cols).matvec(x)


def csr_matmul(crow: Tensor, col: Tensor, val: Tensor, x: Tensor,
               n_cols: int) -> Tensor:
    """Y [rows, n] = A X for the CSR A = (crow int32 [rows + 1], col int32
    [nnz], val [nnz]) of ``n_cols`` columns and a panel x [n_cols, n] of
    val's type (float32 or float64). Deterministic on the card, column by
    column the bits of ``csr_matvec``."""
    return _checked(crow, col, val, x, n_cols).matmat(x)


def reset_launch_counts() -> None:
    for product in (csr_matvec, csr_matmul):
        product.launches = product.recorded = 0


reset_launch_counts()
_PRODUCTS = {p.__name__: p for p in (csr_matvec, csr_matmul)}
for _name in _PRODUCTS:
    device_loop.on_settle(_name, _settle)


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
    indices. Both are checked as ``CSROperand``s when the block is built
    (a wrong dtype, device mix, length or a non-contiguous tensor
    raises)."""

    crow: Tensor
    col: Tensor
    values: Tensor
    crow_t: Tensor
    row_t: Tensor
    values_t: Tensor
    n_rows: int
    n_features: int
    _ops: Tuple[CSROperand, CSROperand] = dataclasses.field(
        init=False, repr=False, compare=False)

    def __post_init__(self):
        fwd = CSROperand(self.crow, self.col, self.values, self.n_features)
        bwd = CSROperand(self.crow_t, self.row_t, self.values_t, self.n_rows)
        if (fwd.rows, bwd.rows) != (self.n_rows, self.n_features) or \
                fwd.device != bwd.device or fwd.dtype != bwd.dtype:
            raise ValueError(
                f"a block of {self.n_rows} x {self.n_features} takes a CSR "
                f"of {fwd.rows} rows and a transpose of {bwd.rows}, of one "
                f"type on one device ({fwd.dtype} on {fwd.device}, "
                f"{bwd.dtype} on {bwd.device})")
        object.__setattr__(self, "_ops", (fwd, bwd))

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
        return self._ops[0].matvec(v)

    def rmatvec(self, u: Tensor) -> Tensor:
        """x.T @ u -> [n_features]."""
        return self._ops[1].matvec(u)

    def matmat(self, v: Tensor) -> Tensor:
        """x @ v for a panel v [n_features, n] -> [n_rows, n]."""
        return self._ops[0].matmat(v)

    def rmatmat(self, u: Tensor) -> Tensor:
        """x.T @ u for a panel u [n_rows, n] -> [n_features, n]."""
        return self._ops[1].matmat(u)


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


def entry_products(block: CSRBlock, x: Tensor, square: bool = False
                   ) -> Tensor:
    """A column block's entry products, in its entry order: ``val[k] *
    x[col[k]]`` ([nnz]) for a vector x [n_features], or ``val[k] *
    x[col[k], :]`` ([nnz, n]) for a panel [n_features, n]; with
    ``square`` each value is squared first (``val * val``, as
    ``CSRFeatures.row_sq_matvec`` squares it). These are the roundings
    of the products that rows 9 and 10 form for the same operands, so
    the product stream (``EntryStream``) sums them to the unblocked
    row's bits."""
    val = block.values * block.values if square else block.values
    gathered = torch.index_select(x, 0, block.col)
    return val * gathered if x.dim() == 1 else val[:, None] * gathered


class EntryStream:
    """The product stream of a CSR cut into C column blocks (the 2-D
    mesh's margins, ops/sharded_objective.py, and ``BlockedCSRFeatures``'
    products, ops/features.py).

    A row's entries, columns ascending, are block 0's entries of the row,
    then block 1's, and so on: the blocks are contiguous column ranges,
    each an order-preserving subsequence of the full entry stream
    (parallel/distributed.py ``split_csr_columns``). So the full row's
    entry k is entry ``pos[k]`` of ``concat(p_0, ..., p_{C-1})``, where
    ``p_c`` are block c's ``entry_products``. The margin is then row 9
    (row 10 for a panel) on the CSR ``(crow, pos, ones)`` of the full
    rows over that concatenation: each product ``1.0 * p`` is ``p``
    exactly, and the kernel adds a row's products in the order its
    length sets (csrc/csr_order.cuh), so the result is the unblocked
    product's bits on the card. On the CPU both go through the plain
    version, which keeps no such order.

    Built from the blocks' row lengths ``lengths`` [C, rows] on the
    device that sums (the 2-D mesh's home slot), with exact integer
    ops; ``nbytes`` is what it holds there (offsets, map and ones)."""

    def __init__(self, lengths: Tensor, dtype: torch.dtype):
        lengths = lengths.to(torch.int64)
        dev = lengths.device
        n_blocks, rows = lengths.shape
        crow = torch.zeros(rows + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(lengths.sum(0), 0)
        nnz = int(crow[-1])
        pos = torch.empty(nnz, dtype=torch.int64, device=dev)
        row_ids = torch.arange(rows, device=dev)
        before = torch.zeros(rows, dtype=torch.int64, device=dev)
        offset = 0
        for c in range(n_blocks):
            n_c = int(lengths[c].sum())
            crow_c = torch.zeros(rows + 1, dtype=torch.int64, device=dev)
            crow_c[1:] = torch.cumsum(lengths[c], 0)
            r = torch.repeat_interleave(row_ids, lengths[c])
            k = torch.arange(n_c, device=dev)
            pos[crow[r] + before[r] + (k - crow_c[r])] = offset + k
            before += lengths[c]
            offset += n_c
        self.sizes = [int(n) for n in lengths.sum(1)]
        self.op = CSROperand(crow.to(torch.int32), pos.to(torch.int32),
                             torch.ones(nnz, dtype=dtype, device=dev), nnz)

    @property
    def device(self) -> torch.device:
        return self.op.device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.op.crow, self.op.col, self.op.val))

    def _concat(self, parts) -> Tensor:
        got = [int(p.shape[0]) for p in parts]
        if got != self.sizes:
            raise ValueError(f"the product stream takes blocks of "
                             f"{self.sizes} entries, got {got}")
        return torch.cat([p.to(self.device) for p in parts])

    def matvec(self, parts) -> Tensor:
        """[rows] margins from the blocks' [nnz_c] products."""
        return self.op.matvec(self._concat(parts))

    def matmat(self, parts) -> Tensor:
        """[rows, n] margins from the blocks' [nnz_c, n] products."""
        return self.op.matmat(self._concat(parts))


def block_lengths(blocks) -> Tensor:
    """[C, rows] int32 row lengths of column blocks (``CSRBlock``s of one
    row count), on the first block's device."""
    dev = blocks[0].crow.device
    return torch.stack([torch.diff(b.crow).to(dev) for b in blocks])
