"""The deterministic CSR x panel product (csrc/csr_spmm.cu, PERF.md's
row 10) and the products that rely on it, on the card: the kernel
against its plain version (torch.sparse.mm on the same CSR, rtol 1e-5
of sum |a x| in float32, 1e-12 in float64), each of its columns bit for
bit against row 9 (csrc/csr_spmv.cu) on that column, and itself over 20
calls; the batched ridge solve of the streamed matrix factorization
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
    """Short rows (a warp a row), long rows (a block a row), empty rows;
    n = 20 takes three column tiles."""
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
    """Transpose rows of 20,000 entries take the block-a-row kernel."""
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
