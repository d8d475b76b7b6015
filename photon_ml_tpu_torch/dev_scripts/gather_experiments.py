"""Sparse gather experiments on the card (port of
dev_scripts/gather_experiments.py: run :266-340, sweep :343-408, main
:411-425).

Measures implementations of the sparse fixed effect's core primitive

    out[i] = w[idx[i]]   (w: float32 [d], idx: int32 [m]; m = 12M, d = 2M)

and prints one JSON line per candidate with ``ok`` (the result agrees
with w[idx] within 2e-2, the bf16 rounding of the one-hot candidates,
through each layout's slot map) and ``mlookups_per_sec``:

  torch_gather         w[idx], the library baseline
  torch_onehot_scan    per 2048-wide block, a bf16 one-hot matrix times
                       the block's w slice (torch.matmul, float32 result),
                       a few blocks at a time so memory stays bounded
  cuda_onehot          kernel row 7, the same contraction on the tensor
                       cores (ops/gather.onehot_gather)
  cuda_residue_gather  kernel row 8, the residue-class gather over the
                       lane-major packing (ops/gather.residue_gather)

Times are CUDA events over REPS calls after a warm-up call, on inputs
made on the card once (packing the indices is set-up). The table stays
in L2 across calls, as it does across a solver's iterations.

    python -m photon_ml_tpu_torch.dev_scripts.gather_experiments
    python -m photon_ml_tpu_torch.dev_scripts.gather_experiments --sweep
    python -m photon_ml_tpu_torch.dev_scripts.gather_experiments --check \
        --device cpu

``--check`` runs m = 3,000, d = 4,096 without timing; with ``--device
cpu`` the kernels' plain versions stand in for them. ``--sweep`` times
torch_onehot_scan over block widths 256-4096 beside a reduced w[idx]
(on the CPU it only verifies them).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops import gather

REPS = 5
SCAN_CHUNK_BYTES = 1 << 29  # one-hot bytes per torch_onehot_scan step
ATOL = 2e-2  # bf16 rounding of |w| <= ~5


def onehot_scan(w_blk: torch.Tensor, local: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """torch_onehot_scan: [kb, e] packed outputs, each block's one-hot
    [e, block] bf16 matrix built and contracted a few blocks at a time."""
    kb, e = local.shape
    block = w_blk.shape[1]
    iota = torch.arange(block, dtype=local.dtype, device=local.device)
    wb = w_blk.to(torch.bfloat16)
    step = max(1, SCAN_CHUNK_BYTES // max(1, 2 * e * block))
    out = torch.empty_like(mask)
    for s in range(0, kb, step):
        onehot = (local[s:s + step, :, None] == iota).to(torch.bfloat16)
        prod = torch.matmul(onehot, wb[s:s + step, :, None])
        out[s:s + step] = prod[..., 0].float() * mask[s:s + step]
    return out


def cuda_ms(fn: Callable[[], object], reps: int = REPS) -> float:
    """Mean ms per call: CUDA events over ``reps`` calls after a warm-up
    call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rate(m: int, ms: Optional[float]) -> Optional[float]:
    """Million lookups per second, or None when not timed."""
    return None if ms is None else m / (ms * 1e-3) / 1e6


def problem(m: int, d: int, device, seed: int = 0) -> Dict[str, object]:
    """The experiment's inputs: idx and w drawn as the JAX script draws
    them, both packings (the residue one lane-major, packed on ``device``
    by ``gather.pack_residue``), and their tensors on ``device``."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, m).astype(np.int32)
    w = rng.normal(0, 1, d).astype(np.float32)
    local, mask, slot = gather.prep_blocks(idx, d)
    dev = torch.device(device)
    w_t = torch.as_tensor(w, device=dev)
    idx_t = torch.as_tensor(idx, device=dev)
    res_idx, res_slot = gather.pack_residue(idx_t, d)
    return dict(
        m=m, d=d, idx_np=idx, w_np=w, slot=slot,
        res_slot=res_slot.cpu().numpy(), w=w_t, idx=idx_t,
        w_blk=gather.block_table(w_t),
        local=torch.as_tensor(local, device=dev),
        mask=torch.as_tensor(mask, device=dev), res_idx=res_idx)


def candidates(p: Dict[str, object]) -> Dict[str, tuple]:
    """name -> (call, slot map of its flat output, or None)."""
    return {
        "torch_gather": (lambda: p["w"][p["idx"]], None),
        "torch_onehot_scan": (
            lambda: onehot_scan(p["w_blk"], p["local"], p["mask"]),
            p["slot"]),
        "cuda_onehot": (
            lambda: gather.onehot_gather(p["local"], p["mask"], p["w_blk"]),
            p["slot"]),
        "cuda_residue_gather": (
            lambda: gather.residue_gather(p["w"], p["res_idx"]),
            p["res_slot"]),
    }


def _verify(out: torch.Tensor, slot: Optional[np.ndarray],
            expect: np.ndarray) -> None:
    flat = out.reshape(-1).cpu().numpy()
    got = flat[slot] if slot is not None else flat
    np.testing.assert_allclose(got, expect, atol=ATOL, rtol=0)


def run(m: int, d: int, check: bool = False, device="cuda",
        p: Optional[Dict[str, object]] = None) -> Dict[str, dict]:
    """Every candidate once: verified against w[idx] and, unless
    ``check``, timed. Prints and returns one record per candidate. A
    candidate that fails is reported (ok false, its error) and the run
    goes on; ``main`` exits non-zero when any failed."""
    dev = resolve_device(device)
    p = problem(m, d, dev) if p is None else p
    expect = p["w_np"][p["idx_np"]]
    results = {}
    for name, (fn, slot) in candidates(p).items():
        rec = {"candidate": name, "m": m, "d": d, "device": str(dev)}
        try:
            _verify(fn(), slot, expect)
            ms = None if check or dev.type != "cuda" else cuda_ms(fn)
            rec.update(ok=True, ms=ms, mlookups_per_sec=_rate(m, ms))
        except Exception as exc:  # noqa: BLE001 -- reported per candidate
            rec.update(ok=False, error=f"{type(exc).__name__}: {exc}"[:300])
        print(json.dumps(rec), flush=True)
        results[name] = rec
    return results


def sweep(m: int, d: int, blocks: Sequence[int] = (256, 512, 1024, 2048,
                                                   4096),
          device="cuda") -> Dict[str, dict]:
    """torch_onehot_scan over block widths, beside w[idx] closed by a sum
    (reduced, as the JAX sweep times it). On the CPU it verifies without
    timing."""
    dev = resolve_device(device)
    timed = cuda_ms if dev.type == "cuda" else (lambda fn: None)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, d, m).astype(np.int32)
    w = rng.normal(0, 1, d).astype(np.float32)
    expect = w[idx]
    w_t, idx_t = torch.as_tensor(w, device=dev), torch.as_tensor(idx,
                                                                 device=dev)
    ms = timed(lambda: w_t[idx_t].sum())
    results = {"torch_gather_reduced": {
        "candidate": "torch_gather_reduced", "m": m, "d": d, "ok": True,
        "ms": ms, "mlookups_per_sec": _rate(m, ms)}}
    print(json.dumps(results["torch_gather_reduced"]), flush=True)
    for block in blocks:
        name = f"torch_onehot_scan_b{block}"
        rec = {"candidate": name, "m": m, "d": d}
        try:
            local, mask, slot = gather.prep_blocks(idx, d, block=block)
            args = (gather.block_table(w_t, block),
                    torch.as_tensor(local, device=dev),
                    torch.as_tensor(mask, device=dev))
            _verify(onehot_scan(*args), slot, expect)
            ms = timed(lambda: onehot_scan(*args))
            rec.update(ok=True, ms=ms, mlookups_per_sec=_rate(m, ms),
                       pad_ratio=local.size / m)
        except Exception as exc:  # noqa: BLE001 -- reported per width
            rec.update(ok=False, error=f"{type(exc).__name__}: {exc}"[:200])
        print(json.dumps(rec), flush=True)
        results[name] = rec
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="small-shape correctness check, no timing")
    ap.add_argument("--sweep", action="store_true",
                    help="block-width sweep of the one-hot scan")
    ap.add_argument("--m", type=int, default=None)
    ap.add_argument("--d", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    if args.check:
        results = run(args.m or 3_000, args.d or 4_096, check=True,
                      device=args.device)
    elif args.sweep:
        results = sweep(args.m or 12_000_000, args.d or 2_000_000,
                        device=args.device)
    else:
        results = run(args.m or 12_000_000, args.d or 2_000_000,
                      device=args.device)
    return 0 if all(r["ok"] for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
