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
  indices by j mod 128 as the JAX script does: idx [chunks, a, 128]
  (int32, a = d / 128) holds j // 128 at lane j mod 128, each lane's
  stream padded to a multiple of a (the TPU kernel's [a, 128] blocks).
  The kernel reads the same streams lane-major and needs no such
  padding: ``lane_major`` transposes that packing exactly into idx [128,
  per_lane] (row l is lane l's stream of lookups, in order) with its
  slot map, cut to the least multiple of ``pad`` that holds every
  stream (by default ``PACK_PAD`` = 4: 16-byte rows for the kernel's
  vector loads; ``pad`` = a keeps the JAX width). ``pack_residue`` builds
  the kernel's packing from an index tensor with torch ops on its own
  device (a stable sort by lane, a bincount and a cumsum), bit for bit
  equal to ``lane_major(*prep_residue(idx, d))``. Then out[l, p] =
  T[idx[l, p], l] with T = w.view(a, 128), exactly, in float32.

``onehot_gather`` and ``residue_gather`` are the wrappers: the plain
version for tensors on the CPU, the CUDA kernel for tensors on the card
(``csrc/gather_onehot.cu``, ``csrc/gather_residue.cu``), and a raise for
anything else. Each counts its kernel launches in ``.launches``;
``residue_gather.layouts`` counts them per layout ("column": one CTA per
residue class, its column of the table staged in shared memory; "l2":
the table read in place from device memory, where the column does not
fit a block's shared memory).
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
PACK_PAD = 4  # residue streams padded to a multiple of 4 int32 (16 bytes)
LAYOUTS = ("column", "l2")


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


def lane_major(packed: np.ndarray, slot: np.ndarray,
               pad: int = PACK_PAD):
    """``prep_residue``'s packing [chunks, a, 128] as the lane-major
    streams the kernel reads: idx [128, per_lane] with idx[l, c * a + s]
    = packed[c, s, l], per_lane the least multiple of ``pad`` that holds
    the longest stream (``pad`` = a keeps all chunks * a), and each
    index's position in the flat [128, per_lane] output (from its flat
    [chunks, a, 128] position c * a * 128 + s * 128 + l). An exact
    transposition: what it cuts off or adds is zero padding."""
    chunks, a, lanes = packed.shape
    lane, pos = slot % lanes, slot // lanes
    longest = int(pos.max()) + 1 if len(pos) else 1
    per_lane = -(-longest // pad) * pad
    keep = min(per_lane, chunks * a)
    streams = np.zeros((lanes, per_lane), packed.dtype)
    streams[:, :keep] = packed.transpose(2, 0, 1).reshape(
        lanes, chunks * a)[:, :keep]
    return streams, lane * per_lane + pos


def pack_residue(idx: Tensor, d: int):
    """The kernel's lane-major residue packing of int32 ``idx`` [m]
    (indices in [0, d)) with torch ops on idx's device: each lane's stream
    zero-padded to the least multiple of ``PACK_PAD`` that holds the
    longest. Returns (streams int32 [128, per_lane], slot int64 [m]), bit
    for bit equal to ``lane_major(*prep_residue(idx, d))``."""
    if d % LANES:
        raise ValueError(f"d must be a multiple of {LANES}, got {d}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32 [m], got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    dev = idx.device
    lane = idx % LANES
    order = torch.argsort(lane, stable=True)
    counts = torch.bincount(lane, minlength=LANES)
    per_lane = -(-max(1, int(counts.max())) // PACK_PAD) * PACK_PAD
    lane_o = lane[order].long()
    pos = (torch.arange(idx.numel(), device=dev)
           - (torch.cumsum(counts, 0) - counts)[lane_o])
    streams = torch.zeros((LANES, per_lane), dtype=torch.int32, device=dev)
    streams[lane_o, pos] = (idx // LANES)[order]
    slot = torch.empty(idx.numel(), dtype=torch.int64, device=dev)
    slot[order] = lane_o * per_lane + pos
    return streams, slot


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
    """out[l, p] = w.view(a, 128)[idx[l, p], l] for lane-major idx [128,
    n]."""
    return w.view(-1, LANES).t().gather(1, idx.long())


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
    residue.argtypes = [vp, vp, vp, ctypes.c_longlong, ci, vp]
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
    on the current CUDA device: "column" where one class's column fits a
    block's opt-in shared memory, else "l2"."""
    code = _load_kernels()[2](a)
    if code < 0:
        raise RuntimeError(f"gather_residue layout query: CUDA error {-code}")
    return LAYOUTS[code]


def residue_gather(w: Tensor, idx: Tensor) -> Tensor:
    """Row 8: ``w`` float32 [a * 128], ``idx`` int32 [128, n] (lane-major:
    ``pack_residue`` or ``lane_major``; any n, rows of whole 16 bytes
    taking the kernel's vector path end to end); returns float32 [128,
    n]. An
    entry of idx outside [0, a) raises in the plain version and gives NaN
    in the kernel. The kernel needs ``w``, ``idx`` and the output 16-byte
    aligned. ``residue_gather.launches`` counts kernel launches and
    ``residue_gather.layouts`` per layout."""
    if idx.dim() != 2 or idx.shape[0] != LANES:
        raise ValueError(f"idx must be [{LANES}, n], got "
                         f"{tuple(idx.shape)}")
    if w.dim() != 1 or w.shape[0] % LANES or w.shape[0] == 0:
        raise ValueError(f"w must be [a * {LANES}], got {tuple(w.shape)}")
    a, n = w.shape[0] // LANES, idx.shape[1]
    _check("w", w, (a * LANES,), torch.float32)
    _check("idx", idx, (LANES, n), torch.int32)
    if _device_of(w, idx).type == "cpu":
        return residue_gather_plain(w, idx)
    out = torch.empty((LANES, n), dtype=torch.float32, device=w.device)
    if n == 0:
        return out
    launch = _load_kernels()[1]
    with torch.cuda.device(w.device):
        layout = residue_layout(a)
        err = launch(w.data_ptr(), idx.data_ptr(), out.data_ptr(), n, a,
                     torch.cuda.current_stream(w.device).cuda_stream)
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
