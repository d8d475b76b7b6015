"""The gather kernels (rows 7 and 8) against their plain PyTorch versions
on the card, exactly: the one-hot tensor-core gather at ragged block and
slot counts, the residue-class gather in both layouts (one class's
column in shared memory up to the card's opt-in limit, the table read in
place past it), at ragged stream lengths,
at the former shared layout's boundary and at the gather experiment's
full width, with the torch packing on the card equal to the numpy one;
out-of-range indices reading nothing; and a factored random effect's
latent bucket (d = k = 4) through the entity-solver kernel against its
plain version.

Marked ``cuda``: skips without a GPU. This file imports neither jax nor
the JAX package, so it runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_gather_kernel.py
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.ops import entity_solver, gather
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _draw(m, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, d, m).astype(np.int32),
            rng.normal(0, 1, d).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(3_000, 4_096), (1, 5), (40_000, 2048 * 9),
                                 (200_000, 2048 * 3 + 1)])
def test_onehot_kernel_equals_plain_version(cuda_device, m, d):
    idx, w = _draw(m, d, seed=m + d)
    local, mask, slot = gather.prep_blocks(idx, d)
    args = (torch.as_tensor(local, device=cuda_device),
            torch.as_tensor(mask, device=cuda_device),
            gather.block_table(torch.as_tensor(w, device=cuda_device)))
    before = gather.onehot_gather.launches
    got = gather.onehot_gather(*args)
    torch.cuda.synchronize()
    assert gather.onehot_gather.launches == before + 1
    want = gather.onehot_gather_plain(*args)
    assert torch.equal(got, want)
    w_bf16 = torch.as_tensor(w).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got.cpu().numpy().reshape(-1)[slot],
                                  w_bf16[idx])


def _column_limit():
    """The largest a whose column takes the column layout on this card."""
    lo, hi = 1, 1 << 22
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if gather.residue_layout(mid) == "column":
            lo = mid
        else:
            hi = mid
    return lo


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,layout", [
    (3_000, 4_096, "column"), (100_000, 128 * 57, "column"),
    # The former shared layout's last table (the whole table in one block)
    # and the first past it.
    (200_000, 128 * 440, "column"), (200_000, 128 * 441, "column"),
    (2_000_000, 2_000_000, "column"), (77, 128 * 1_000, "column"),
    # The gather experiment's full width.
    (12_000_000, 2_000_000, "column"),
    # The column layout's last table on this card and the first past it.
    (5_000, "limit", "column"), (5_000, "limit+1", "l2")])
def test_residue_kernel_equals_plain_version(cuda_device, m, d, layout):
    """Exactly the plain version and, through the slot map, w[idx], over
    the streams padded to the kernel's 16 bytes (``pack_residue``'s
    packing), ragged (pad 1) and at the JAX width (pad a); the torch
    packing on the card is bit for bit the numpy one."""
    if isinstance(d, str):
        d = 128 * (_column_limit() + (1 if d.endswith("+1") else 0))
    idx, w = _draw(m, d, seed=m)
    packed = gather.prep_residue(idx, d)
    w_t = torch.as_tensor(w, device=cuda_device)
    assert gather.residue_layout(d // gather.LANES) == layout
    for pad in (gather.PACK_PAD, 1, d // gather.LANES):
        streams, slot = gather.lane_major(*packed, pad=pad)
        streams_t = torch.as_tensor(streams, device=cuda_device)
        if pad == gather.PACK_PAD:
            got_t, slot_t = gather.pack_residue(
                torch.as_tensor(idx, device=cuda_device), d)
            assert torch.equal(got_t, streams_t)
            assert torch.equal(slot_t.cpu(), torch.as_tensor(slot))
        before = gather.residue_gather.layouts[layout]
        got = gather.residue_gather(w_t, streams_t)
        torch.cuda.synchronize()
        assert gather.residue_gather.layouts[layout] == before + 1
        assert torch.equal(got, gather.residue_gather_plain(w_t, streams_t))
        np.testing.assert_array_equal(got.cpu().numpy().reshape(-1)[slot],
                                      w[idx])
        del streams_t, got


@pytest.mark.cuda
def test_factored_latent_bucket_through_the_entity_kernel(cuda_device):
    """A latent bucket of the factored random effect: x projected through
    a Gaussian B (d = k = 4, no intercept), residual offsets, gamma from
    0, the L-BFGS configuration of bench.py's itemFactors coordinate."""
    rng = np.random.default_rng(4)
    e, r, d, k = 300, 64, 16, 4
    x = rng.normal(0, 1, (e, r, d))
    x[:, :, 0] = 1.0
    B = rng.normal(0, 1, (k, d)) / k
    lat = np.einsum("end,kd->enk", x, B)
    rows = rng.integers(r // 2, r + 1, e)
    w = (np.arange(r)[None, :] < rows[:, None]).astype(float)
    lat *= w[:, :, None]
    y = (rng.random((e, r)) < 0.5) * w
    off = rng.normal(0, 1, (e, r)) * w
    args = [torch.as_tensor(np.asarray(a, np.float32), device=cuda_device)
            for a in (lat, y, off, w, np.zeros((e, k)))]
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    kw = dict(max_iter=20, tol=1e-6)
    res_k = entity_solver.entity_lbfgs(loss, *args, 1.0, **kw)
    res_p = entity_solver.entity_lbfgs_plain(loss, *args, 1.0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(res_k.iterations, res_p.iterations)
    assert torch.equal(res_k.reason, res_p.reason)
    assert torch.equal(res_k.trials, res_p.trials)
    assert int(res_k.iterations.min()) >= 1
    torch.testing.assert_close(res_k.value, res_p.value, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(res_k.x, res_p.x, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4_096, 2_000_000, 128 * 60_000])
def test_out_of_range_indices_read_nothing(cuda_device, d):
    """An index outside its range reads no memory: the residue kernel
    gives NaN there (in the column layout at d = 4,096 and 2,000,000, in
    the l2 layout at 7,680,000), the one-hot kernel 0 (no column
    matches); every other output stays exact."""
    idx, w = _draw(5_000, d, seed=d)
    a = d // gather.LANES
    assert gather.residue_layout(a) == ("l2" if d > 2_000_000 else "column")
    bad, _ = gather.pack_residue(torch.as_tensor(idx, device=cuda_device), d)
    bad[0, :2] = torch.tensor([a, -1], dtype=torch.int32)
    w_t = torch.as_tensor(w, device=cuda_device)
    got = gather.residue_gather(w_t, bad)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[0, :2]).all())
    good = torch.ones_like(bad, dtype=torch.bool)
    good[0, :2] = False
    want = gather.residue_gather_plain(w_t, bad.clamp(0, a - 1))
    assert torch.equal(got[good], want[good])

    local, mask, _ = gather.prep_blocks(idx, d)
    local_t = torch.as_tensor(local, device=cuda_device)
    local_t[0, :2] = torch.tensor([gather.BLOCK, -1], dtype=torch.int32)
    mask_t = torch.as_tensor(mask, device=cuda_device)
    w_blk = gather.block_table(w_t)
    out = gather.onehot_gather(local_t, mask_t, w_blk)
    torch.cuda.synchronize()
    assert bool((out[0, :2] == 0).all())
    ref = gather.onehot_gather_plain(local_t.clamp(0, gather.BLOCK - 1),
                                     mask_t, w_blk)
    assert torch.equal(out[:, 2:], ref[:, 2:]) and torch.equal(out[1:],
                                                               ref[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("n", gather.ONEHOT_NS)
@pytest.mark.parametrize("warps", gather.ONEHOT_WARPS)
@pytest.mark.parametrize("e", [3 * 128, 1_001, 12_654])
def test_onehot_every_launch_shape(cuda_device, n, warps, e):
    """Every swept view of B ([2048 / n, n]) and CTA width, at e a whole
    number of a warp's 128-slot chunks (the 16-byte path), e ragged and
    not a multiple of 4 (the scalar path), and the full-width run's e:
    exactly the plain version, with masked padding, locals 0 and 2047,
    and out-of-range and negative locals giving 0."""
    kb = 5
    rng = np.random.default_rng(n * warps + e)
    local = rng.integers(0, gather.BLOCK, (kb, e)).astype(np.int32)
    local[:, :2] = [0, gather.BLOCK - 1]
    mask = (rng.random((kb, e)) < 0.9).astype(np.float32)
    bad = np.zeros((kb, e), bool)
    bad[1, 3:7] = True
    local[1, 3:7] = [gather.BLOCK, 5_000, -1, -(1 << 20)]
    w = rng.normal(0, 1, kb * gather.BLOCK).astype(np.float32)
    local_t = torch.as_tensor(local, device=cuda_device)
    mask_t = torch.as_tensor(mask, device=cuda_device)
    w_blk = gather.block_table(torch.as_tensor(w, device=cuda_device))
    before = gather.onehot_gather.launches
    got = gather.onehot_gather(local_t, mask_t, w_blk, n=n, warps=warps)
    torch.cuda.synchronize()
    assert gather.onehot_gather.launches == before + 1
    want = gather.onehot_gather_plain(
        local_t.clamp(0, gather.BLOCK - 1), mask_t, w_blk)
    bad_t = torch.as_tensor(bad, device=cuda_device)
    want = torch.where(bad_t, torch.zeros_like(want), want)
    assert torch.equal(got, want)
