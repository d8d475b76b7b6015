"""The port's gather experiment against the JAX package's, on the CPU:

- ``prep_blocks`` / ``prep_residue`` equal dev_scripts/gather_experiments'
  ``_prep_blocks`` / ``_prep_residue`` exactly, and the lane-major
  residue packing (``lane_major``, and ``pack_residue`` in torch ops)
  is exactly the transposition of ``_prep_residue``'s at its width, and
  that transposition cut to the longest stream at the kernel's pad;
- ``onehot_gather_plain`` (kernel row 7's plain version) equals the
  interpreted Pallas ``build_onehot_call`` exactly, and
  ``residue_gather_plain`` (row 8's) the interpreted
  ``build_residue_call`` (through the lane-major transposition), at
  ``--check``'s size and at a ragged one; both also through their slot
  maps against bf16(w)[idx] and w[idx];
- the wrappers take the plain versions for CPU tensors and refuse what
  the kernels do not take;
- the port's entry point runs ``--check`` (and verifies ``--sweep``'s
  block widths) on the CPU with every candidate ok.

tests/test_torch_gather_kernel.py holds the CUDA kernels against these
plain versions on the card.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dev_scripts import gather_experiments as jax_gather
from photon_ml_tpu_torch.dev_scripts import gather_experiments
from photon_ml_tpu_torch.ops import gather
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

SIZES = [(3_000, 4_096), (5_000, 6 * 2048 + 17)]
RESIDUE_SIZES = [(3_000, 4_096), (4_096, 128 * 57), (500, 128 * 8)]


def _draw(m, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, d, m).astype(np.int32),
            rng.normal(0, 1, d).astype(np.float32))


@pytest.mark.parametrize("m,d", SIZES)
@pytest.mark.parametrize("block", [512, gather.BLOCK])
def test_prep_blocks_equals_jax(m, d, block):
    idx, _ = _draw(m, d, seed=m)
    for ours, ref in zip(gather.prep_blocks(idx, d, block),
                         jax_gather._prep_blocks(idx, d, block)):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("m,d", RESIDUE_SIZES)
def test_prep_residue_equals_jax(m, d):
    idx, _ = _draw(m, d, seed=m)
    if d == 128 * 8:  # one residue class only: the most skewed packing
        idx = (np.arange(m, dtype=np.int32) % 8) * 128 + 5
    for ours, ref in zip(gather.prep_residue(idx, d),
                         jax_gather._prep_residue(idx, d)):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


def _jax_layout(streams, chunks, a):
    """Lane-major [128, chunks * a] back to the JAX script's [chunks, a,
    128]: out[c, s, l] = streams[l, c * a + s]."""
    return np.asarray(streams).reshape(gather.LANES, chunks, a).transpose(
        1, 2, 0)


@pytest.mark.parametrize("m,d", RESIDUE_SIZES)
def test_lane_major_packings_equal_jax(m, d):
    """At the JAX width (pad a), ``lane_major`` of the JAX packing is
    exactly the JAX script's ``_prep_residue`` packing transposed; at the
    kernel's pad of 4 and at 1 (ragged streams) it is that array cut to
    the longest stream, rounded up to the pad, the rest zero padding;
    ``pack_residue`` on CPU tensors is the pad-4 array bit for bit, and
    every slot map places each index at its own lookup."""
    idx, w = _draw(m, d, seed=m + 1)
    if d == 128 * 8:  # one residue class only: the most skewed packing
        idx = (np.arange(m, dtype=np.int32) % 8) * 128 + 5
    ref, ref_slot = jax_gather._prep_residue(idx, d)
    chunks, a, _ = ref.shape
    wide, _ = gather.lane_major(*gather.prep_residue(idx, d), pad=a)
    assert wide.shape == (gather.LANES, chunks * a)
    np.testing.assert_array_equal(_jax_layout(wide, chunks, a), ref)
    longest = int(np.bincount(idx % gather.LANES).max())
    for pad in (a, gather.PACK_PAD, 1):
        streams, slot = gather.lane_major(*gather.prep_residue(idx, d),
                                          pad=pad)
        assert streams.dtype == np.int32 and slot.dtype == np.int64
        per_lane = -(-longest // pad) * pad
        assert streams.shape == (gather.LANES, per_lane)
        keep = min(per_lane, chunks * a)
        np.testing.assert_array_equal(streams[:, :keep], wide[:, :keep])
        assert not streams[:, keep:].any() and not wide[:, keep:].any()
        if pad == gather.PACK_PAD:
            got_t, slot_t = gather.pack_residue(torch.as_tensor(idx), d)
            assert got_t.dtype == torch.int32
            assert slot_t.dtype == torch.int64
            np.testing.assert_array_equal(got_t.numpy(), streams)
            np.testing.assert_array_equal(slot_t.numpy(), slot)
        # The slot maps: the JAX one into [chunks, a, 128], ours into
        # [128, per_lane], each at the same packed lookup.
        np.testing.assert_array_equal(streams.reshape(-1)[slot],
                                      ref.reshape(-1)[ref_slot])
        np.testing.assert_array_equal(streams.reshape(-1)[slot], idx // 128)


def _pallas_onehot(local, mask, w):
    """The interpreted Pallas call on the TPU's padded shapes, cut back."""
    kb, e = local.shape
    f, ep, kbp = jax_gather.build_onehot_call(kb, e, interpret=True)
    w_blk = np.zeros((kbp, gather.BLOCK), np.float32)
    w_blk.reshape(-1)[:len(w)] = w
    pad = ((0, kbp - kb), (0, ep - e))
    out = f(jnp.asarray(np.pad(local, pad)), jnp.asarray(np.pad(mask, pad)),
            jnp.asarray(w_blk))
    return np.asarray(out)[:kb, :e]


@pytest.mark.parametrize("m,d", SIZES)
def test_onehot_plain_equals_interpreted_pallas(m, d):
    idx, w = _draw(m, d)
    local, mask, slot = gather.prep_blocks(idx, d)
    w_blk = gather.block_table(torch.as_tensor(w))
    ours = gather.onehot_gather_plain(torch.as_tensor(local),
                                      torch.as_tensor(mask), w_blk)
    assert tuple(w_blk.shape) == (-(-d // gather.BLOCK), gather.BLOCK)
    np.testing.assert_array_equal(ours.numpy(), _pallas_onehot(local, mask,
                                                               w))
    # Through the slot map: the rounded table at each index, padding 0.
    w_bf16 = torch.as_tensor(w).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(ours.numpy().reshape(-1)[slot],
                                  w_bf16[idx])
    assert (ours.numpy()[mask == 0] == 0).all()


@pytest.mark.parametrize("m,d", RESIDUE_SIZES[:2])
def test_residue_plain_equals_interpreted_pallas(m, d):
    """The plain version over the lane-major streams at the JAX width
    against the interpreted Pallas call over the JAX packing, compared
    through the exact transposition between the two layouts; over the
    kernel's streams (pad 4) through its slot map."""
    idx, w = _draw(m, d)
    packed, jax_slot = gather.prep_residue(idx, d)
    streams, slot = gather.lane_major(packed, jax_slot, pad=packed.shape[1])
    ours = gather.residue_gather_plain(torch.as_tensor(w),
                                       torch.as_tensor(streams))
    f = jax_gather.build_residue_call(*packed.shape, jnp.float32,
                                      interpret=True)
    ref = np.asarray(f(jnp.asarray(w.reshape(-1, gather.LANES)),
                       jnp.asarray(packed)))
    assert ref.shape == packed.shape
    assert tuple(ours.shape) == streams.shape
    np.testing.assert_array_equal(
        _jax_layout(ours.numpy(), *packed.shape[:2]), ref)
    np.testing.assert_array_equal(ref.reshape(-1)[jax_slot], w[idx])
    np.testing.assert_array_equal(ours.numpy().reshape(-1)[slot], w[idx])
    short, short_slot = gather.lane_major(packed, jax_slot)
    got = gather.residue_gather_plain(torch.as_tensor(w),
                                      torch.as_tensor(short)).numpy()
    np.testing.assert_array_equal(got, ours.numpy()[:, :short.shape[1]])
    np.testing.assert_array_equal(got.reshape(-1)[short_slot], w[idx])


@pytest.mark.parametrize("n", [8, 16, 32, 64, 128])
def test_tiled_onehot_formulation_equals_the_plain_version(n):
    """Row 7's kernel views each block's w slice as B = [2048 / n, n]:
    a lookup's one-hot row sits at local >> log2 n, every column of B
    holds w, and the value is column local & (n - 1) of the product. In
    bf16 with float32 accumulation that equals onehot_gather_plain
    exactly, masked padding (local 0, mask 0) and locals 0 and 2047
    included."""
    kb, e = 3, 37
    rng = np.random.default_rng(n)
    local = rng.integers(0, gather.BLOCK, (kb, e)).astype(np.int32)
    local[:, :2] = [0, gather.BLOCK - 1]
    mask = np.ones((kb, e), np.float32)
    local[2, -5:], mask[2, -5:] = 0, 0.0  # padding
    w = torch.as_tensor(rng.normal(0, 1, kb * gather.BLOCK - 100)
                        .astype(np.float32))
    local_t, mask_t = torch.as_tensor(local), torch.as_tensor(mask)
    w_blk = gather.block_table(w)
    onehot = torch.nn.functional.one_hot(
        local_t.long() >> (n.bit_length() - 1), gather.BLOCK // n)
    b = w_blk.to(torch.bfloat16).view(kb, gather.BLOCK // n, n)
    prod = torch.matmul(onehot.to(torch.bfloat16).float(), b.float())
    tiled = prod.gather(2, (local_t.long() & (n - 1))[..., None])[..., 0]
    assert torch.equal(tiled * mask_t,
                       gather.onehot_gather_plain(local_t, mask_t, w_blk))


def test_wrappers_take_the_plain_versions_on_the_cpu():
    m, d = 2_000, 128 * 40
    idx, w = _draw(m, d, seed=3)
    local, mask, _ = gather.prep_blocks(idx, d)
    packed, _ = gather.pack_residue(torch.as_tensor(idx), d)
    w_t = torch.as_tensor(w)
    args = (torch.as_tensor(local), torch.as_tensor(mask),
            gather.block_table(w_t))
    before = (gather.onehot_gather.launches, gather.residue_gather.launches)
    assert torch.equal(gather.onehot_gather(*args),
                       gather.onehot_gather_plain(*args))
    assert torch.equal(gather.residue_gather(w_t, packed),
                       gather.residue_gather_plain(w_t, packed))
    assert (gather.onehot_gather.launches,
            gather.residue_gather.launches) == before
    with pytest.raises(TypeError, match="int32"):
        gather.onehot_gather(args[0].long(), *args[1:])
    with pytest.raises(ValueError, match="w_blk"):
        gather.onehot_gather(*args[:2], args[2][:, :100])
    with pytest.raises(ValueError, match="n must be"):
        gather.onehot_gather(*args, n=128)
    with pytest.raises(ValueError, match="idx must be"):
        gather.residue_gather(w_t, packed[:64])
    with pytest.raises(ValueError, match="w must be"):
        gather.residue_gather(w_t[:100], packed)
    with pytest.raises(TypeError, match="int32"):
        gather.residue_gather(w_t, packed.long())
    with pytest.raises(ValueError, match="multiple of 128"):
        gather.pack_residue(torch.as_tensor(idx), d + 1)


def test_entry_point_check_runs_on_the_cpu(capsys):
    assert gather_experiments.main(["--check", "--device", "cpu"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [r["candidate"] for r in lines] == [
        "torch_gather", "torch_onehot_scan", "cuda_onehot",
        "cuda_residue_gather"]
    assert all(r["ok"] and r["m"] == 3_000 and r["d"] == 4_096
               and r["mlookups_per_sec"] is None for r in lines)


def test_entry_point_sweep_verifies_on_the_cpu(capsys):
    assert gather_experiments.main(["--sweep", "--device", "cpu", "--m",
                                    "3000", "--d", "4096"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [r["candidate"] for r in lines] == ["torch_gather_reduced"] + [
        f"torch_onehot_scan_b{b}" for b in (256, 512, 1024, 2048, 4096)]
    assert all(r["ok"] and r["ms"] is None for r in lines)


def test_onehot_scan_equals_the_plain_version():
    m, d = 4_000, 3 * 1024 + 5
    idx, w = _draw(m, d, seed=8)
    local, mask, _ = gather.prep_blocks(idx, d, block=1024)
    args = (gather.block_table(torch.as_tensor(w), 1024),
            torch.as_tensor(local), torch.as_tensor(mask))
    assert torch.equal(gather_experiments.onehot_scan(*args),
                       gather.onehot_gather_plain(args[1], args[2], args[0]))
