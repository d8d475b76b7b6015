"""Streamed training on the card: the C Avro decoder's build on the GPU
host, the deterministic CSR product (csrc/csr_spmv.cu) against its plain
version (torch.mv on the same CSR, rtol 1e-5 of sum |a x| in float32,
1e-12 in float64) and bit for bit against itself over 20 calls, against
the order contract (spmv.csr_order_reference, bit for bit) at rows of 0
to 3 kChunk + 5 entries with unaligned arrays, a row's bits whatever its
neighbours, a call captured in a CUDA graph equal to an eager one, a
cached shard's partials bit for bit over 20 calls, spill and re-upload
through pinned staging buffers and the side stream (every re-uploaded
block the evicted bytes), and a streamed L-BFGS model bit-identical
across residency, and bf16 spill as deterministic.

Marked ``cuda``: skips without a GPU. This file imports neither jax nor
the JAX package, so it runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_stream_cuda.py
"""

import json
import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch import native
from photon_ml_tpu_torch.data.device_feed import chunked_device_put
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.shard_cache import DeviceShardCache
from photon_ml_tpu_torch.ops import spmv
from photon_ml_tpu_torch.ops.glm_objective import GLMObjective
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.sharded_objective import ShardedGLMObjective
from photon_ml_tpu_torch.optimization.glm_lbfgs import (
    minimize_lbfgs_glm_streaming,
)
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _join_prefetch_threads():
    yield
    for t in threading.enumerate():
        if t.name == "host-prefetch":
            t.join(timeout=10)
            assert not t.is_alive(), "a prefetch thread did not end"


class _Stream(list):
    def stats(self):
        return {"decode_path": "memory"}


def _problem(n=3000, d=60, density=0.2, seed=0):
    rng = np.random.default_rng(seed)
    X = sp.random(n, d, density=density, random_state=seed, format="csr")
    X.data[:] = rng.normal(0, 1, X.nnz)
    y = (rng.random(n) < 0.5).astype(float)
    return X, y


def _stream(X, y, rows):
    return _Stream(GameDataset.build(responses=y[s:s + rows],
                                     feature_shards={"g": X[s:s + rows]})
                   for s in range(0, X.shape[0], rows))


@pytest.mark.cuda
def test_native_decoder_builds_on_the_gpu_host(cuda_device):
    mod = native.load_avro_native()
    assert hasattr(mod, "decode_training_block")
    assert native.library_path().exists()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape", [(5000, 40, 0.3), (300, 2000, 0.01),
                                   (40, 70000, 0.05), (7, 9, 0.0)])
def test_spmv_kernel_matches_plain_and_is_deterministic(cuda_device, dtype,
                                                        rtol, shape):
    """Short rows (lane groups under a warp), long rows (chunks over
    warps) and empty rows; the transpose's long rows too."""
    n, d, density = shape
    X, _ = _problem(n, d, density)
    rows = np.repeat(np.arange(n), np.diff(X.indptr))
    block = spmv.block_from_triplet(
        torch.as_tensor(X.data, dtype=dtype, device=cuda_device),
        torch.as_tensor(X.indices, device=cuda_device),
        torch.as_tensor(rows, device=cuda_device), n, d)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    v = torch.randn(d, generator=g, device=cuda_device, dtype=dtype)
    u = torch.randn(n, generator=g, device=cuda_device, dtype=dtype)
    spmv.reset_launch_counts()
    got = (block.matvec(v), block.rmatvec(u))
    assert spmv.csr_matvec.launches == 2
    plain = (spmv.csr_matvec_plain(block.crow, block.col, block.values, v,
                                   d),
             spmv.csr_matvec_plain(block.crow_t, block.row_t,
                                   block.values_t, u, n))
    scale = (spmv.csr_matvec_plain(block.crow, block.col,
                                   block.values.abs(), v.abs(), d),
             spmv.csr_matvec_plain(block.crow_t, block.row_t,
                                   block.values_t.abs(), u.abs(), n))
    for k, p, s in zip(got, plain, scale):
        assert bool(((k - p).abs() <= rtol * s + 1e-30).all())
    for _ in range(20):
        assert torch.equal(block.matvec(v), got[0])
        assert torch.equal(block.rmatvec(u), got[1])


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
    val = rng.normal(0, 1, col.shape[0])
    col_buf = torch.zeros(offset + col.shape[0], dtype=torch.int32,
                          device=dev)
    val_buf = torch.zeros(offset + col.shape[0], dtype=dtype, device=dev)
    col_buf[offset:] = torch.as_tensor(col, device=dev)
    val_buf[offset:] = torch.as_tensor(val, dtype=dtype, device=dev)
    return (torch.as_tensor(crow, device=dev), col_buf[offset:],
            val_buf[offset:])


def _contract_lengths(chunk, seed):
    """Rows of 0, 1, 2, 31, 33, L - 1, L, L + 1 and 3L + 5 entries (L the
    chunk) among rows of random lengths, shuffled."""
    rng = np.random.default_rng(seed)
    lengths = [0, 1, 2, 31, 33, chunk - 1, chunk, chunk + 1, 3 * chunk + 5]
    lengths += [int(m) for m in rng.integers(0, 300, 60)]
    rng.shuffle(lengths)
    return lengths


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("offset", [0, 1])
def test_spmv_rows_follow_the_order_contract(cuda_device, dtype, rtol,
                                             offset):
    """Every row's bits are the order contract's (numpy, in the same
    type), within rtol of sum |a x| of the plain version, over 20 calls;
    offset 1 starts col, val and x off 16-byte alignment."""
    chunk = spmv.chunk_entries()
    n_cols = 4 * chunk
    crow, col, val = _lengths_csr(_contract_lengths(chunk, 5), n_cols,
                                  dtype, cuda_device, 6, offset)
    x_buf = torch.randn(offset + n_cols, dtype=dtype, device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(7))
    x = x_buf[offset:]
    spmv.reset_launch_counts()
    got = spmv.csr_matvec(crow, col, val, x, n_cols)
    assert spmv.csr_matvec.launches == 1
    want = spmv.csr_order_reference(crow.cpu(), col.cpu(), val.cpu(),
                                    x.cpu(), chunk)
    assert np.array_equal(got.cpu().numpy(), want)
    plain = spmv.csr_matvec_plain(crow, col, val, x, n_cols)
    scale = spmv.csr_matvec_plain(crow, col, val.abs(), x.abs(), n_cols)
    assert bool(((got - plain).abs() <= rtol * scale + 1e-30).all())
    for _ in range(20):
        assert torch.equal(spmv.csr_matvec(crow, col, val, x, n_cols), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spmv_row_bits_do_not_depend_on_neighbours(cuda_device, dtype):
    """The order contract: a row of 3, L - 1, L, L + 1 and 3L + 5
    entries, first in one CSR and last in another with other neighbours,
    gives the same bits in both."""
    chunk = spmv.chunk_entries()
    n_cols = 4 * chunk
    g = torch.Generator(cuda_device).manual_seed(8)
    x = torch.randn(n_cols, dtype=dtype, device=cuda_device, generator=g)
    for m in (3, chunk - 1, chunk, chunk + 1, 3 * chunk + 5):
        crow, col, val = _lengths_csr([m], n_cols, dtype, cuda_device, m)
        alone = spmv.csr_matvec(crow, col, val, x, n_cols)
        for lengths, at in (([m, 5, 2 * chunk, 40], 0),
                            ([7, 3 * chunk, 1, m], -1)):
            c2, col2, val2 = _lengths_csr(lengths, n_cols, dtype,
                                          cuda_device, m + len(lengths))
            b = int(c2[at].item()) if at == 0 else int(c2[-2].item())
            col2[b:b + m], val2[b:b + m] = col, val
            got = spmv.csr_matvec(c2, col2, val2, x, n_cols)
            assert torch.equal(got[:1] if at == 0 else got[-1:], alone), m


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spmv_in_a_cuda_graph_equals_eager(cuda_device, dtype):
    """A block's matvec and rmatvec (long transpose rows: chunk sums and
    counters) captured in a CUDA graph and replayed give the eager bits."""
    X, _ = _problem(5000, 40, 0.5)
    rows = np.repeat(np.arange(5000), np.diff(X.indptr))
    block = spmv.block_from_triplet(
        torch.as_tensor(X.data, dtype=dtype, device=cuda_device),
        torch.as_tensor(X.indices, device=cuda_device),
        torch.as_tensor(rows, device=cuda_device), 5000, 40)
    g = torch.Generator(cuda_device).manual_seed(9)
    v = torch.randn(40, generator=g, device=cuda_device, dtype=dtype)
    u = torch.randn(5000, generator=g, device=cuda_device, dtype=dtype)
    eager = (block.matvec(v), block.rmatvec(u))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = (block.matvec(v), block.rmatvec(u))
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], eager[0])
        assert torch.equal(out[1], eager[1])


@pytest.mark.cuda
def test_cached_shard_partials_bitwise_over_20_calls(cuda_device):
    X, y = _problem(20000, 200, 1.0)
    cache = DeviceShardCache.from_stream(_stream(X, y, 16384), "g",
                                         device=cuda_device)
    sobj = ShardedGLMObjective(
        GLMObjective(loss_for_task(TaskType.LOGISTIC_REGRESSION)), cache)
    coef = torch.linspace(-0.1, 0.1, 200, device=cuda_device)
    f0, g0 = sobj.value_and_grad(coef, 1.0)
    for _ in range(20):
        f, g = sobj.value_and_grad(coef, 1.0)
        assert torch.equal(f, f0) and torch.equal(g, g0)


@pytest.mark.cuda
def test_spill_and_reupload_through_pinned_staging(cuda_device):
    """Uploads go through pinned staging buffers on a side stream: chunked
    uploads equal one upload, and every re-uploaded block (prefetched on
    the producer thread) is the evicted block, tensor for tensor."""
    a = np.random.default_rng(2).normal(size=(1000, 7))
    for chunk in (8 * 7 * 3, 1 << 20):
        got = chunked_device_put(a, torch.float32, cuda_device,
                                 chunk_bytes=chunk)
        assert torch.equal(got.cpu(), torch.as_tensor(a, dtype=torch.float32))
    X, y = _problem()
    resident = DeviceShardCache.from_stream(_stream(X, y, 500), "g",
                                            device=cuda_device)
    budget = 2 * max(e.feature_bytes for e in resident.entries)
    for spill_dtype in ("f32", "bf16"):
        spilled = DeviceShardCache.from_stream(
            _stream(X, y, 500), "g", hbm_budget_bytes=budget,
            spill_dtype=spill_dtype, device=cuda_device)
        for _ in range(2):
            for b, ref in zip(spilled.blocks(prefetch_depth=2),
                              resident.entries):
                for name in ("crow", "col", "crow_t", "row_t"):
                    assert torch.equal(getattr(b.feats, name),
                                       getattr(ref.feats, name))
                want = ref.feats.values
                if spill_dtype == "bf16":
                    want = want.to(torch.bfloat16).float()
                assert torch.equal(b.feats.values, want)
        s = spilled.stats()
        assert s["misses"] > 0
        assert s["hits"] + s["misses"] == s["epochs"] * spilled.n_shards
        assert s["peak_device_bytes"] <= budget + max(
            e.feature_bytes for e in spilled.entries)


@pytest.mark.cuda
def test_streamed_model_identical_across_residency_on_the_card(cuda_device):
    X, y = _problem(6000, 80, 0.25, seed=4)
    obj = GLMObjective(loss_for_task(TaskType.LOGISTIC_REGRESSION))

    def solve(**kw):
        cache = DeviceShardCache.from_stream(_stream(X, y, 1024), "g",
                                             device=cuda_device, **kw)
        return minimize_lbfgs_glm_streaming(
            ShardedGLMObjective(obj, cache),
            torch.zeros(80, device=cuda_device), 1.0, max_iter=30).x

    resident = solve()
    assert torch.equal(solve(hbm_budget_bytes=1, prefetch_depth=0),
                       resident)
    assert torch.equal(solve(hbm_budget_bytes=600_000, prefetch_depth=2),
                       resident)
    assert torch.equal(solve(hbm_budget_bytes=1, spill_dtype="bf16"),
                       solve(hbm_budget_bytes=10 << 20, spill_dtype="bf16"))


@pytest.mark.cuda
def test_maybe_trace_records_row9_and_entity_kernel(cuda_device, tmp_path):
    """utils/profiling.maybe_trace on the card records the port's
    ctypes-launched kernels as kernel events under their own names: one
    for each launch of row 9 and of the entity kernel."""
    from photon_ml_tpu_torch.ops import entity_solver
    from photon_ml_tpu_torch.utils.profiling import maybe_trace

    X, y = _problem(2000, 40, 0.2, seed=7)
    cache = DeviceShardCache.from_stream(_stream(X, y, 2000), "g",
                                         device=cuda_device)
    block = next(iter(cache.blocks())).feats
    v = torch.ones(40, device=cuda_device)
    rng = np.random.default_rng(3)
    e, r, d = 64, 12, 5
    x = rng.normal(0, 1, (e, r, d))
    args = [torch.as_tensor(np.asarray(a, np.float32), device=cuda_device)
            for a in (x, rng.random((e, r)) < 0.5, np.zeros((e, r)),
                      np.ones((e, r)), np.zeros((e, d)))]
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    block.matvec(v)  # first products make their per-width state
    entity_solver.entity_lbfgs(loss, *args, 1.0, max_iter=5)
    torch.cuda.synchronize()
    spmv.reset_launch_counts()
    entity_solver.reset_launch_counts()
    with maybe_trace(tmp_path, cuda_device) as path:
        for _ in range(3):
            block.matvec(v)
        entity_solver.entity_lbfgs(loss, *args, 1.0, max_iter=5)
        torch.cuda.synchronize()
    events = [ev for ev in json.loads(path.read_text())["traceEvents"]
              if ev.get("cat") == "kernel"]
    names = [ev["name"] for ev in events]
    assert sum("csr_kernel" in n for n in names) == \
        spmv.csr_matvec.launches == 3
    assert sum("entity_lbfgs_kernel" in n for n in names) == \
        entity_solver.entity_lbfgs.launches == 1


@pytest.mark.cuda
def test_streamed_solve_bytes_do_not_depend_on_telemetry(cuda_device):
    """A streamed L-BFGS solve over a spilling cache on the card, with
    telemetry off and on (spans, metrics, a trace context and a flight
    recorder): the same coefficient and history bytes."""
    from photon_ml_tpu_torch import telemetry
    from photon_ml_tpu_torch.telemetry import FlightRecorder

    X, y = _problem(6000, 80, 0.25, seed=5)
    obj = GLMObjective(loss_for_task(TaskType.LOGISTIC_REGRESSION))

    def solve(ctx=None):
        cache = DeviceShardCache.from_stream(
            _stream(X, y, 1024), "g", device=cuda_device,
            hbm_budget_bytes=600_000, prefetch_depth=2)
        res = minimize_lbfgs_glm_streaming(
            ShardedGLMObjective(obj, cache),
            torch.zeros(80, device=cuda_device), 1.0, max_iter=30,
            trace_ctx=ctx)
        return res.x.cpu().numpy().tobytes(), \
            res.value_history.numpy().tobytes()

    off = solve()
    telemetry.reset()
    telemetry.enable(trace=True)
    rec = FlightRecorder(max_events=256).install()
    try:
        on = solve(telemetry.mint("solve"))
        counters = telemetry.snapshot()["counters"]
    finally:
        rec.uninstall()
        telemetry.disable()
        telemetry.reset()
    assert on == off
    assert counters["training.solver_iterations"] > 0
    assert counters["data.shard_cache.misses"] > 0
