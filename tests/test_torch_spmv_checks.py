"""The pre-checked call path of the deterministic CSR products
(ops/spmv.py ``CSROperand``, kernel rows 9 and 10): a ``CSRBlock`` or
``CSRFeatures`` checks its CSRs once, when it is built, and raises there
on int64 indices, tensors on more than one device, non-contiguous
tensors or lengths that do not fit; a product then checks only its
vector or panel. On the CPU every product is the plain version (no
launch), bit for bit. And the order contract's numpy specification
(``csr_order_reference``, which the card tests hold the kernels to)
against the exact product.

This file imports neither jax nor the JAX package and needs no card.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.ops import spmv
from photon_ml_tpu_torch.ops.features import CSRFeatures, csr_from_scipy
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


def _block(n=40, d=12, density=0.3, dtype=torch.float64, seed=0):
    X = sp.random(n, d, density=density, random_state=seed, format="csr")
    rows = np.repeat(np.arange(n), np.diff(X.indptr))
    block = spmv.block_from_triplet(torch.as_tensor(X.data, dtype=dtype),
                                    torch.as_tensor(X.indices),
                                    torch.as_tensor(rows), n, d)
    return X, block


def _fields(block):
    return {f: getattr(block, f) for f in (
        "crow", "col", "values", "crow_t", "row_t", "values_t", "n_rows",
        "n_features")}


@pytest.mark.parametrize("field,change,error", [
    ("crow", lambda t: t.long(), TypeError),
    ("row_t", lambda t: t.long(), TypeError),
    ("values", lambda t: t.to(torch.bfloat16), TypeError),
    ("col", lambda t: torch.empty_like(t, device="meta"), ValueError),
    ("values_t", lambda t: torch.stack([t, t], 1)[:, 0], ValueError),
    ("col", lambda t: t[:-1], ValueError),
    ("n_rows", lambda v: v + 1, ValueError),
])
def test_block_checks_its_csrs_once_when_built(field, change, error):
    """int64 indices, a values type the kernels do not take, a tensor on
    another device, a non-contiguous one, lengths that do not fit and a
    wrong row count raise at construction."""
    _, block = _block()
    kw = _fields(block)
    kw[field] = change(kw[field])
    with pytest.raises(error):
        spmv.CSRBlock(**kw)


def test_block_on_the_cpu_is_the_plain_version_bit_for_bit():
    X, block = _block(n=60, d=9)
    g = torch.Generator().manual_seed(0)
    v = torch.randn(9, generator=g, dtype=torch.float64)
    u = torch.randn(60, generator=g, dtype=torch.float64)
    V = torch.randn((9, 3), generator=g, dtype=torch.float64)
    U = torch.randn((60, 3), generator=g, dtype=torch.float64)
    spmv.reset_launch_counts()
    pairs = [
        (block.matvec(v), spmv.csr_matvec_plain(
            block.crow, block.col, block.values, v, 9)),
        (block.rmatvec(u), spmv.csr_matvec_plain(
            block.crow_t, block.row_t, block.values_t, u, 60)),
        (block.matmat(V), spmv.csr_matmul_plain(
            block.crow, block.col, block.values, V, 9)),
        (block.rmatmat(U), spmv.csr_matmul_plain(
            block.crow_t, block.row_t, block.values_t, U, 60)),
    ]
    assert spmv.csr_matvec.launches == spmv.csr_matmul.launches == 0
    for got, want in pairs:
        assert torch.equal(got, want)
    np.testing.assert_allclose(block.matvec(v).numpy(), X @ v.numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize("arg,error", [
    (torch.zeros(9, dtype=torch.float32), ValueError),
    (torch.zeros(8, dtype=torch.float64), ValueError),
    (torch.zeros((9, 2), dtype=torch.float64), ValueError),
    (torch.zeros(9, dtype=torch.float64, device="meta"), ValueError),
])
def test_a_product_checks_its_vector(arg, error):
    _, block = _block(n=60, d=9)
    with pytest.raises(error):
        block.matvec(arg)


def test_features_check_their_csrs_once_when_built():
    X = sp.random(30, 8, density=0.4, random_state=1, format="csr")
    feats = csr_from_scipy(X, torch.float64, device="cpu")
    assert feats.csr.crow_indices().dtype == torch.int32
    assert feats.csr_t.col_indices().dtype == torch.int32
    wide = torch.sparse_csr_tensor(
        feats.csr.crow_indices().long(), feats.csr.col_indices().long(),
        feats.csr.values(), size=feats.csr.shape)
    with pytest.raises(TypeError):
        CSRFeatures(csr=wide, csr_t=feats.csr_t, values=feats.values,
                    col_ids=feats.col_ids, row_ids=feats.row_ids,
                    n_rows=feats.n_rows, n_features=feats.n_features)
    u = torch.linspace(-1, 1, 30, dtype=torch.float64)
    spmv.reset_launch_counts()
    np.testing.assert_allclose(feats.sq_rmatvec(u).numpy(),
                               X.multiply(X).T @ u.numpy(), rtol=1e-12)
    assert spmv.csr_matvec.launches == 0


@pytest.mark.parametrize("call", [spmv.csr_matvec, spmv.csr_matmul])
def test_public_products_keep_their_full_checks(call):
    _, block = _block(n=20, d=6)
    x = torch.zeros(6, dtype=torch.float64)
    if call is spmv.csr_matmul:
        x = x[:, None]
    with pytest.raises(TypeError):
        call(block.crow.long(), block.col.long(), block.values, x, 6)
    with pytest.raises(TypeError):
        call(block.crow, block.col, block.values, x.float(), 6)
    with pytest.raises(ValueError):
        call(block.crow, block.col, block.values, x[:5], 6)


@pytest.mark.parametrize("chunk", [4, 16, 1024])
def test_order_reference_is_the_product(chunk):
    """The numpy specification of the order contract sums every row
    (rows of 0 to 3 chunks + 5 entries) to within float64 rounding of the
    exact product, and a row's bits do not depend on its neighbours."""
    rng = np.random.default_rng(chunk)
    lengths = [0, 1, 2, 5, chunk - 1, chunk, chunk + 1, 3 * chunk + 5]
    n_cols = 4 * chunk + 8
    crow = np.zeros(len(lengths) + 1, np.int32)
    crow[1:] = np.cumsum(lengths)
    col = np.concatenate([np.sort(rng.choice(n_cols, m, replace=False))
                          for m in lengths]).astype(np.int32)
    val = rng.normal(size=col.shape[0])
    x = rng.normal(size=(n_cols, 3))
    got = spmv.csr_order_reference(crow, col, val, x, chunk)
    A = sp.csr_matrix((val, col, crow), shape=(len(lengths), n_cols))
    np.testing.assert_allclose(got, A @ x, rtol=1e-12, atol=1e-12)
    last = spmv.csr_order_reference(crow[-2:] - crow[-2],
                                    col[crow[-2]:], val[crow[-2]:], x, chunk)
    assert np.array_equal(last, got[-1:])


def test_order_lanes_by_row_length():
    """G = the smallest power of two >= m / 4, at most 32; 32 for a row
    cut into chunks."""
    assert [spmv.order_lanes(m, 1024) for m in (
        0, 1, 4, 5, 8, 9, 16, 17, 32, 33, 64, 65, 1024, 1025)] == [
        1, 1, 1, 2, 2, 4, 4, 8, 8, 16, 16, 32, 32, 32]
    assert spmv.order_lanes(9, 8) == 32
