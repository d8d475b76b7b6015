"""The deterministic CSR x panel product (csrc/csr_spmm.cu, PERF.md's
row 10) and the products that rely on it, on the card: the kernel
against its plain version (torch.sparse.mm on the same CSR, rtol 1e-5
of sum |a x| in float32, 1e-12 in float64), each of its columns bit for
bit against row 9 (csrc/csr_spmv.cu) on that column, and itself over 20
calls; at rows of 0 to 3 kChunk + 5 entries, with unaligned arrays and
n in {1, 3, 4, 8, 9, 20}, every column the order contract's bits
(spmv.csr_order_reference) and row 9's, a row's bits whatever its
neighbours, and a call captured in a CUDA graph equal to an eager one;
the batched ridge solve of the streamed matrix factorization
(torch.linalg.solve on [u, k, k]) bit for bit over 20 calls; and the
in-core CSRFeatures' four products, which go through row 9 on the card,
bit for bit over 20 calls.

Marked ``cuda``: skips without a GPU. This file imports neither jax nor
the JAX package, so it runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_spmm_cuda.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.ops import spmv
from photon_ml_tpu_torch.ops.features import csr_from_scipy
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _csr(n, d, density, seed=0):
    rng = np.random.default_rng(seed)
    X = sp.random(n, d, density=density, random_state=seed, format="csr")
    X.data[:] = rng.normal(0, 1, X.nnz)
    return X


def _on(X, dtype, dev):
    return (torch.as_tensor(X.indptr, dtype=torch.int32, device=dev),
            torch.as_tensor(X.indices, dtype=torch.int32, device=dev),
            torch.as_tensor(X.data, dtype=dtype, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape", [(5000, 40, 0.3), (40, 70000, 0.05),
                                   (7, 9, 0.0)])
@pytest.mark.parametrize("n", [1, 3, 8, 20])
def test_spmm_matches_plain_and_row9_column_by_column(cuda_device, dtype,
                                                      rtol, shape, n):
    """Short rows (lane groups under a warp), long rows (chunks over
    warps), empty rows; n = 3 and 20 take one exact-width tile each."""
    rows, d, density = shape
    crow, col, val = _on(_csr(rows, d, density), dtype, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((d, n), generator=g, device=cuda_device, dtype=dtype)
    spmv.reset_launch_counts()
    got = spmv.csr_matmul(crow, col, val, x, d)
    assert spmv.csr_matmul.launches == 1
    plain = spmv.csr_matmul_plain(crow, col, val, x, d)
    scale = spmv.csr_matmul_plain(crow, col, val.abs(), x.abs(), d)
    assert bool(((got - plain).abs() <= rtol * scale + 1e-30).all())
    for j in range(n):
        assert torch.equal(got[:, j], spmv.csr_matvec(
            crow, col, val, x[:, j].contiguous(), d)), j
    for _ in range(20):
        assert torch.equal(spmv.csr_matmul(crow, col, val, x, d), got)


def _lengths_csr(lengths, n_cols, dtype, dev, seed, offset=0):
    """A CSR whose rows have the given lengths (distinct sorted columns),
    its col and val views starting ``offset`` entries into larger
    buffers (offset 1: pointers off 16-byte alignment)."""
    rng = np.random.default_rng(seed)
    crow = np.zeros(len(lengths) + 1, np.int32)
    crow[1:] = np.cumsum(lengths)
    col = np.concatenate(
        [np.sort(rng.choice(n_cols, m, replace=False)) for m in lengths]
        + [np.zeros(0, int)]).astype(np.int32)
    col_buf = torch.zeros(offset + col.shape[0], dtype=torch.int32,
                          device=dev)
    val_buf = torch.zeros(offset + col.shape[0], dtype=dtype, device=dev)
    col_buf[offset:] = torch.as_tensor(col, device=dev)
    val_buf[offset:] = torch.as_tensor(rng.normal(0, 1, col.shape[0]),
                                       dtype=dtype, device=dev)
    return (torch.as_tensor(crow, device=dev), col_buf[offset:],
            val_buf[offset:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 3, 4, 8, 9, 20])
def test_spmm_rows_follow_the_order_contract(cuda_device, dtype, offset, n):
    """Rows of 0, 1, 2, 31, 33, L - 1, L, L + 1 and 3L + 5 entries among
    random ones: the product is the order contract's bits (numpy), each
    column row 9's bits, over 20 calls; offset 1 starts col, val and the
    panel off 16-byte alignment (no vector loads)."""
    chunk = spmv.chunk_entries()
    rng = np.random.default_rng(n)
    lengths = [0, 1, 2, 31, 33, chunk - 1, chunk, chunk + 1, 3 * chunk + 5]
    lengths += [int(m) for m in rng.integers(0, 300, 40)]
    rng.shuffle(lengths)
    n_cols = 4 * chunk
    crow, col, val = _lengths_csr(lengths, n_cols, dtype, cuda_device, n,
                                  offset)
    g = torch.Generator(cuda_device).manual_seed(n)
    x = torch.randn(offset + n_cols * n, generator=g, device=cuda_device,
                    dtype=dtype)[offset:].view(n_cols, n)
    spmv.reset_launch_counts()
    got = spmv.csr_matmul(crow, col, val, x, n_cols)
    assert spmv.csr_matmul.launches == 1
    want = spmv.csr_order_reference(crow.cpu(), col.cpu(), val.cpu(),
                                    x.cpu(), chunk)
    assert np.array_equal(got.cpu().numpy(), want)
    for j in range(n):
        assert torch.equal(got[:, j], spmv.csr_matvec(
            crow, col, val, x[:, j].contiguous(), n_cols)), j
    for _ in range(20):
        assert torch.equal(spmv.csr_matmul(crow, col, val, x, n_cols), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 20])
def test_spmm_row_bits_do_not_depend_on_neighbours(cuda_device, n):
    """The order contract at row 10: a row of 3, L - 1, L, L + 1 and
    3L + 5 entries, first in one CSR and last in another with other
    neighbours, gives the same bits in both."""
    chunk = spmv.chunk_entries()
    n_cols = 4 * chunk
    g = torch.Generator(cuda_device).manual_seed(8)
    x = torch.randn((n_cols, n), device=cuda_device, generator=g)
    for m in (3, chunk - 1, chunk, chunk + 1, 3 * chunk + 5):
        crow, col, val = _lengths_csr([m], n_cols, torch.float32,
                                      cuda_device, m)
        alone = spmv.csr_matmul(crow, col, val, x, n_cols)
        for lengths, first in (([m, 5, 2 * chunk, 40], True),
                               ([7, 3 * chunk, 1, m], False)):
            c2, col2, val2 = _lengths_csr(lengths, n_cols, torch.float32,
                                          cuda_device, m + len(lengths))
            b = 0 if first else int(c2[-2].item())
            col2[b:b + m], val2[b:b + m] = col, val
            got = spmv.csr_matmul(c2, col2, val2, x, n_cols)
            assert torch.equal(got[:1] if first else got[-1:], alone), m


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 8, 20])
def test_spmm_in_a_cuda_graph_equals_eager(cuda_device, n):
    """X V and X^T U of a block (long transpose rows: chunk sums and
    counters) captured in a CUDA graph and replayed give the eager
    bits."""
    X = _csr(5000, 40, 0.5)
    rows = np.repeat(np.arange(5000), np.diff(X.indptr))
    block = spmv.block_from_triplet(
        torch.as_tensor(X.data, dtype=torch.float32, device=cuda_device),
        torch.as_tensor(X.indices, device=cuda_device),
        torch.as_tensor(rows, device=cuda_device), 5000, 40)
    g = torch.Generator(cuda_device).manual_seed(9)
    v = torch.randn((40, n), generator=g, device=cuda_device)
    u = torch.randn((5000, n), generator=g, device=cuda_device)
    eager = (block.matmat(v), block.rmatmat(u))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = (block.matmat(v), block.rmatmat(u))
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], eager[0])
        assert torch.equal(out[1], eager[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [2, 4, 16])
def test_batched_ridge_solve_repeats_its_bits(cuda_device, dtype, k):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    v = torch.randn((2048, 6, k), generator=g, device=cuda_device,
                    dtype=dtype)
    a = torch.einsum("uni,unj->uij", v, v) + 0.1 * torch.eye(
        k, dtype=dtype, device=cuda_device)
    b = torch.randn((2048, k, 1), generator=g, device=cuda_device,
                    dtype=dtype)
    first = torch.linalg.solve(a, b)
    for _ in range(20):
        assert torch.equal(torch.linalg.solve(a, b), first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_in_core_csr_products_repeat_their_bits(cuda_device, dtype):
    """Transpose rows of 20,000 entries are cut into chunks."""
    X = _csr(20000, 50, 0.2)
    feats = csr_from_scipy(X, dtype=dtype, device=cuda_device)
    assert feats.csr.crow_indices().dtype == torch.int32
    g = torch.Generator(device=cuda_device).manual_seed(3)
    v = torch.randn(50, generator=g, device=cuda_device, dtype=dtype)
    u = torch.randn(20000, generator=g, device=cuda_device, dtype=dtype)
    calls = (lambda: feats.matvec(v), lambda: feats.rmatvec(u),
             lambda: feats.row_sq_matvec(v), lambda: feats.sq_rmatvec(u))
    for call in calls:
        spmv.reset_launch_counts()
        first = call()
        assert spmv.csr_matvec.launches == 1
        for _ in range(20):
            assert torch.equal(call(), first)
    want = X.T @ u.double().cpu().numpy()
    np.testing.assert_allclose(feats.rmatvec(u).double().cpu().numpy(),
                               want, rtol=1e-4 if dtype == torch.float32
                               else 1e-12, atol=1e-3)
