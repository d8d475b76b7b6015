"""The sparse gather primitive out[i] = w[idx[i]] in two packed layouts:
hand-written Hopper kernels and their plain PyTorch versions (port of
dev_scripts/gather_experiments.py: _prep_blocks :49-68, build_onehot_call
:110 with its kernel :133-140, _prep_residue :177-206,
build_residue_call :209 with its kernel :217-218).

The JAX package measured these as alternatives to XLA's random-access
gather on a TPU; photon_ml_tpu_torch/dev_scripts/gather_experiments.py
runs the same experiment on the card.

- **One-hot (kernel row 7).** ``prep_blocks`` groups the indices by
  2048-wide column block: ``local`` [kb, e] (int32, the index within its
  block), ``mask`` [kb, e] (1 for a real lookup, 0 for padding) and the
  slot of each original index in the packed [kb * e] order. Then
  out[b, i] = mask[b, i] * bf16(w_blk[b, local[b, i]]), computed as a
  one-hot bf16 matrix times the block's w slice on the tensor cores with
  float32 accumulation: with one non-zero term per row the product is
  exactly the rounded w value. The kernel views the slice as [2048 / N,
  N] (``ONEHOT_N``), so the one-hot row of a lookup sits at
  local >> log2 N and its value in column local & (N - 1).
- **Residue classes (kernel row 8).** ``prep_residue`` buckets the
  indices by j mod 128: idx [chunks, a, 128] (int32, a = d / 128) holds
  j // 128 at lane j mod 128, so out[c, s, l] = T[idx[c, s, l], l] with
  T = w.view(a, 128), exactly, in float32.

``onehot_gather`` and ``residue_gather`` are the wrappers: the plain
version for tensors on the CPU, the CUDA kernel for tensors on the card
(``csrc/gather_onehot.cu``, ``csrc/gather_residue.cu``), and a raise for
anything else. Each counts its kernel launches in ``.launches``;
``residue_gather.layouts`` counts them per layout ("shared": the whole
table staged in each block's shared memory, "l2": the table read in
place from device memory, where the 50 MB L2 holds it).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

Tensor = torch.Tensor

BLOCK = 2048  # w columns per one-hot block
# Row 7's launch: B = the block's w slice viewed [2048 / N, N], and warps
# per CTA. The defaults are the fastest of the sweep over ONEHOT_NS x
# ONEHOT_WARPS that chip_smoke.py runs at the gather experiment's full
# width (PERF.md).
ONEHOT_NS = (8, 16, 32, 64)
ONEHOT_WARPS = (4, 8, 16)
ONEHOT_N, ONEHOT_WARP_COUNT = 16, 16
LANES = 128  # residue classes
LAYOUTS = ("shared", "l2")


def prep_blocks(idx: np.ndarray, d: int, block: int = BLOCK):
    """Group indices by ``block``-wide column block, each block padded to
    the largest block's count (padding gathers local 0 with mask 0).
    Returns (local int32 [kb, e], mask float32 [kb, e], slot int64 [m]:
    each index's position in the packed [kb * e] order)."""
    kb = -(-d // block)
    owner = idx // block
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=kb)
    e = max(1, int(counts.max()))
    local = np.zeros((kb, e), np.int32)
    mask = np.zeros((kb, e), np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(idx)) - np.repeat(starts, counts)
    local[owner[order], pos] = (idx[order] - owner[order] * block)
    mask[owner[order], pos] = 1.0
    packed_of = (owner[order] * e + pos)
    slot = np.empty(len(idx), np.int64)
    slot[order] = packed_of
    return local, mask, slot


def prep_residue(idx: np.ndarray, d: int):
    """Bucket indices by residue j mod 128 (one stream per lane), each
    stream padded to a multiple of a = d / 128. Returns (sub int32
    [chunks, a, 128] holding j // 128, slot int64 [m]: each index's
    position in the flat [chunks, a, 128] output)."""
    assert d % LANES == 0
    a = d // LANES
    lane = idx % LANES
    sub = idx // LANES
    order = np.argsort(lane, kind="stable")
    counts = np.bincount(lane, minlength=LANES)
    per_lane = -(-max(1, int(counts.max())) // a) * a
    chunks = per_lane // a
    packed = np.zeros((LANES, per_lane), np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(idx)) - np.repeat(starts, counts)
    packed[lane[order], pos] = sub[order]
    packed = np.ascontiguousarray(
        packed.reshape(LANES, chunks, a).transpose(1, 2, 0))
    slot = np.empty(len(idx), np.int64)
    slot[order] = ((pos // a) * a * LANES + (pos % a) * LANES
                   + lane[order])
    return packed, slot


def block_table(w: Tensor, block: int = BLOCK) -> Tensor:
    """w [d] zero-padded to whole blocks: [kb, block], contiguous."""
    kb = -(-w.shape[0] // block)
    return torch.nn.functional.pad(w, (0, kb * block - w.shape[0])).reshape(
        kb, block).contiguous()


def onehot_gather_plain(local: Tensor, mask: Tensor, w_blk: Tensor
                        ) -> Tensor:
    """out[b, i] = mask[b, i] * float(bf16(w_blk[b, local[b, i]]))."""
    return (w_blk.to(torch.bfloat16).float().gather(1, local.long())
            * mask)


def residue_gather_plain(w: Tensor, idx: Tensor) -> Tensor:
    """out[c, s, l] = w.view(a, 128)[idx[c, s, l], l]."""
    chunks, a, lanes = idx.shape
    table = w.view(a, lanes)
    return table.expand(chunks, a, lanes).gather(1, idx.long())


@functools.lru_cache(maxsize=None)
def _load_kernels():
    """The C entry points with their ctypes signatures, set once:
    (onehot launch, residue launch, residue layout)."""
    from photon_ml_tpu_torch.ops import cuda_build

    lib = cuda_build.load("gather")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    onehot = lib.gather_onehot_launch
    onehot.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
    onehot.restype = ci
    residue = lib.gather_residue_launch
    residue.argtypes = [vp, vp, vp, ci, ci, vp]
    residue.restype = ci
    layout = lib.gather_residue_layout
    layout.argtypes = [ci]
    layout.restype = ci
    return onehot, residue, layout


def _check(name: str, t: Tensor, shape, dtype) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")


def _device_of(*tensors: Tensor) -> torch.device:
    devices = {t.device for t in tensors}
    dev = tensors[0].device
    if len(devices) != 1 or dev.type not in ("cpu", "cuda"):
        raise ValueError("takes tensors all on the CPU or all on one CUDA "
                         f"device, got {sorted(map(str, devices))}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    return dev


def onehot_gather(local: Tensor, mask: Tensor, w_blk: Tensor, *,
                  n: int = ONEHOT_N, warps: int = ONEHOT_WARP_COUNT
                  ) -> Tensor:
    """Row 7: ``local`` int32 and ``mask`` float32 [kb, e], ``w_blk``
    float32 [kb, 2048] (``block_table``); returns float32 [kb, e]. A local
    index outside [0, 2048) raises in the plain version and gives 0 in
    the kernel. ``n`` (one of ``ONEHOT_NS``) and ``warps`` (1-16) shape
    the kernel's launch and do not change its result.
    ``onehot_gather.launches`` counts kernel launches."""
    kb, e = local.shape
    _check("local", local, (kb, e), torch.int32)
    _check("mask", mask, (kb, e), torch.float32)
    _check("w_blk", w_blk, (kb, BLOCK), torch.float32)
    if n not in ONEHOT_NS or not 1 <= warps <= 16:
        raise ValueError(f"n must be one of {ONEHOT_NS} and warps 1-16, got "
                         f"n={n}, warps={warps}")
    if _device_of(local, mask, w_blk).type == "cpu":
        return onehot_gather_plain(local, mask, w_blk)
    out = torch.empty((kb, e), dtype=torch.float32, device=local.device)
    if kb == 0 or e == 0:
        return out
    launch = _load_kernels()[0]
    with torch.cuda.device(local.device):
        err = launch(local.data_ptr(), mask.data_ptr(), w_blk.data_ptr(),
                     out.data_ptr(), kb, e, n, warps,
                     torch.cuda.current_stream(local.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_onehot kernel launch failed: CUDA error "
                           f"{err}")
    onehot_gather.launches += 1
    return out


def residue_layout(a: int) -> str:
    """The layout ``residue_gather`` takes for a table of a * 128 floats
    on the current CUDA device: "shared" where it fits a block's opt-in
    shared memory, else "l2"."""
    code = _load_kernels()[2](a)
    if code < 0:
        raise RuntimeError(f"gather_residue layout query: CUDA error {-code}")
    return LAYOUTS[code]


def residue_gather(w: Tensor, idx: Tensor) -> Tensor:
    """Row 8: ``w`` float32 [a * 128], ``idx`` int32 [chunks, a, 128];
    returns float32 [chunks, a, 128]. An entry of idx outside [0, a)
    raises in the plain version and gives NaN in the kernel. The kernel
    needs ``w`` 16-byte aligned. ``residue_gather.launches`` counts kernel
    launches, ``residue_gather.layouts`` per layout."""
    chunks, a, lanes = idx.shape
    if lanes != LANES:
        raise ValueError(f"idx must be [chunks, a, {LANES}], got "
                         f"{tuple(idx.shape)}")
    _check("w", w, (a * LANES,), torch.float32)
    _check("idx", idx, (chunks, a, LANES), torch.int32)
    if _device_of(w, idx).type == "cpu":
        return residue_gather_plain(w, idx)
    out = torch.empty((chunks, a, LANES), dtype=torch.float32,
                      device=w.device)
    if chunks == 0 or a == 0:
        return out
    launch = _load_kernels()[1]
    with torch.cuda.device(w.device):
        layout = residue_layout(a)
        err = launch(w.data_ptr(), idx.data_ptr(), out.data_ptr(), chunks,
                     a, torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_residue kernel launch failed: CUDA "
                           f"error {err}")
    residue_gather.launches += 1
    residue_gather.layouts[layout] += 1
    return out


def reset_launch_counts() -> None:
    """Set both kernels' launch counts to 0."""
    onehot_gather.launches = 0
    residue_gather.launches = 0
    residue_gather.layouts.clear()


onehot_gather.launches = 0
residue_gather.launches = 0
residue_gather.layouts = collections.Counter()
