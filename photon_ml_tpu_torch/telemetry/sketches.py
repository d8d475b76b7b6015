"""Deterministic, mergeable streaming sketches for distribution
observability (port of photon_ml_tpu/telemetry/sketches.py:1-667:
QuantileSketch, MomentsSketch, TopKSketch, sketch_from_state, psi, ks
and _canonical_json). numpy and the standard library only, as in JAX:
the serialized state is the JAX package's byte for byte for the same
update payloads.

Two constraints shape them:

1. **No extra feature pass.** Updates are vectorized numpy over columns
   the decode pass already produced; a device tensor reaches a sketch
   only as a host array its path already copied.
2. **Bit-stable determinism.** Every sketch has a canonical serialized
   form that is a pure function of the sequence of ``update`` payloads,
   and for the quantile and moments sketches of their MULTISET: merging
   sub-sketches in any order, under any merge tree, gives bitwise-equal
   serialized state. A torch reduction would sum in another order, so
   the sums stay numpy's.

The three sketches:

- :class:`QuantileSketch`: a deterministic fixed log-bucket store (the
  DDSketch accuracy model): ``v`` lands in bucket ``ceil(log_gamma
  |v|)``, ``gamma = (1 + a) / (1 - a)`` for relative accuracy ``a``.
  Counts are exact integers, so merge is bucket-wise addition. Rank
  selection is exact; the value reported inside the selected bucket is
  within ``a * |q_exact|`` (clamped to the observed [min, max]).
- :class:`MomentsSketch`: count / nnz / min / max / mean / variance.
  Each ``update`` contributes one ``np.sum`` of its payload (numpy's
  pairwise order: deterministic for a payload), and the sums across
  updates accumulate as exact ``fractions.Fraction`` values, so
  accumulation is associative and merge-tree-independent.
- :class:`TopKSketch`: bounded heavy hitters (weighted Misra-Gries)
  for entity ids: any key with frequency ``> n/(k+1)`` is present and
  stored counts undercount by at most ``n/(k+1)``. Deterministic for a
  fixed ingestion order, but not merge-tree-independent.

Drift scoring (:func:`psi`, :func:`ks`) compares two quantile sketches:
PSI over ``bins`` reference-quantile bins (eps-smoothed) and the max CDF
gap over the union of both sketches' bucket boundaries. Serving scores
the live score sketch against the reference a trained model carries
(``serving.model.<label>.score_drift_psi``, data/distmon.py).

Sketches are plain data owned by whoever builds them; they do not read
the telemetry enable flag.
"""

from __future__ import annotations

import hashlib
import json
import math
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "MomentsSketch",
    "QuantileSketch",
    "TopKSketch",
    "ks",
    "psi",
    "sketch_from_state",
]


def _canonical_json(obj) -> bytes:
    """Canonical bytes of a state dict: sorted keys, no whitespace,
    floats via repr (shortest round-trip — bit-faithful for f64)."""
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


class _SketchBase:
    """Shared serialization contract: ``state()`` is a plain JSON-able
    dict (canonical member order handled at dump time), ``serialize()``
    its canonical bytes, ``digest()`` their sha256 — the unit the
    bitwise-equality tests and the metrics.json ``state_sha256`` use."""

    def state(self) -> dict:  # pragma: no cover - abstract
        raise NotImplementedError

    def serialize(self) -> bytes:
        return _canonical_json(self.state())

    def digest(self) -> str:
        return hashlib.sha256(self.serialize()).hexdigest()


class _BucketStore:
    """Contiguous integer bucket counts over a signed index range
    (``base`` = lowest index ever seen). Updates and merges are one
    vectorized array-add over the union span — no per-bucket python
    loop on the hot path. The span is structurally bounded by the f64
    dynamic range (~71k buckets at 1% accuracy, ~0.6 MB worst case;
    real columns span a few hundred)."""

    __slots__ = ("base", "counts")

    def __init__(self, base: int = 0,
                 counts: Optional[np.ndarray] = None):
        self.base = base
        self.counts = (np.zeros(0, np.int64) if counts is None
                       else np.asarray(counts, np.int64))

    def add_span(self, base: int, counts: np.ndarray) -> None:
        if self.counts.size == 0:
            self.base = base
            self.counts = counts.astype(np.int64, copy=True)
            return
        lo = min(self.base, base)
        hi = max(self.base + self.counts.size, base + counts.size)
        if lo != self.base or hi != self.base + self.counts.size:
            grown = np.zeros(hi - lo, np.int64)
            grown[self.base - lo:self.base - lo + self.counts.size] = \
                self.counts
            self.base, self.counts = lo, grown
        self.counts[base - lo:base - lo + counts.size] += counts

    def total(self) -> int:
        return int(self.counts.sum())

    def items(self) -> List[Tuple[int, int]]:
        """(index, count) for populated buckets, ascending index."""
        nz = np.flatnonzero(self.counts)
        return [(self.base + int(i), int(self.counts[i])) for i in nz]

    def count_le(self, index: int) -> int:
        """Total count in buckets with index <= ``index``."""
        if index < self.base:
            return 0
        return int(self.counts[:index - self.base + 1].sum())

    def count_ge(self, index: int) -> int:
        """Total count in buckets with index >= ``index``."""
        if index >= self.base + self.counts.size:
            return 0
        return int(self.counts[max(0, index - self.base):].sum())


class QuantileSketch(_SketchBase):
    """Deterministic mergeable streaming quantiles (module docstring).

    ``relative_accuracy`` is the one knob: quantile VALUES are within
    that relative error of the exact order statistic (rank selection is
    exact; estimates clamp to the exact observed min/max). Instances
    with different accuracies cannot merge (the bucket grids differ).
    """

    KIND = "quantile"

    def __init__(self, relative_accuracy: float = 0.01):
        if not 0.0 < relative_accuracy < 1.0:
            raise ValueError(
                f"relative_accuracy must be in (0, 1), "
                f"got {relative_accuracy}")
        self.relative_accuracy = float(relative_accuracy)
        self._gamma = (1.0 + self.relative_accuracy) \
            / (1.0 - self.relative_accuracy)
        self._log_gamma = math.log(self._gamma)
        self._inv_log_gamma = 1.0 / self._log_gamma
        self.count = 0
        self._zero = 0
        self._pos = _BucketStore()
        self._neg = _BucketStore()
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    # -- ingest ------------------------------------------------------------

    def _indices(self, mags: np.ndarray) -> np.ndarray:
        # ceil(log_gamma(|v|)): bucket i covers (gamma^(i-1), gamma^i].
        return np.ceil(np.log(mags) * self._inv_log_gamma) \
            .astype(np.int64)

    def update(self, values) -> None:
        """Fold a batch of values in (vectorized; one pass over the
        array, bucket counting via bincount over the payload's index
        span — the monitor rides the decode hot path, so this is
        allocation-lean by design; cost is priced by the caller
        ``distmon`` extra). NaNs are rejected loudly — a NaN
        label/score is a data fault the divergence watchdog family
        owns, not a distribution."""
        v = np.asarray(values, np.float64).ravel()
        if v.size == 0:
            return
        lo = float(v.min())
        hi = float(v.max())
        # NaN/Inf propagate into the min/max scalars, so the validity
        # check costs no extra pass over the payload.
        if not (math.isfinite(lo) and math.isfinite(hi)):
            raise ValueError(
                f"{type(self).__name__} observed non-finite values "
                "(corrupt column?)")
        self.count += int(v.size)
        self._min = lo if self._min is None else min(self._min, lo)
        self._max = hi if self._max is None else max(self._max, hi)
        pos = v[v > 0.0]
        neg = v[v < 0.0]
        self._zero += int(v.size - pos.size - neg.size)
        for store, mags in ((self._pos, pos), (self._neg, -neg)):
            if mags.size == 0:
                continue
            idx = self._indices(mags)
            base = int(idx.min())
            store.add_span(base, np.bincount(idx - base))

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into self (bucket-count addition — associative
        and commutative, so any merge tree over the same sub-sketches
        produces bitwise-identical serialized state)."""
        if other.relative_accuracy != self.relative_accuracy:
            raise ValueError(
                f"cannot merge sketches with different accuracies "
                f"({self.relative_accuracy} vs {other.relative_accuracy})")
        self.count += other.count
        self._zero += other._zero
        for mine, theirs in ((self._pos, other._pos),
                             (self._neg, other._neg)):
            if theirs.counts.size:
                mine.add_span(theirs.base, theirs.counts)
        for v in (other._min,):
            if v is not None:
                self._min = v if self._min is None else min(self._min, v)
        for v in (other._max,):
            if v is not None:
                self._max = v if self._max is None else max(self._max, v)
        return self

    # -- queries -----------------------------------------------------------

    def _rep(self, index: int, negative: bool) -> float:
        # Mid-bucket representative: 2*gamma^i/(gamma+1) is within
        # relative_accuracy of every value in (gamma^(i-1), gamma^i].
        r = 2.0 * math.exp(index * self._log_gamma) / (self._gamma + 1.0)
        return -r if negative else r

    def _ordered_buckets(self) -> List[Tuple[float, int]]:
        """(representative, count) in ascending value order: negatives
        by descending magnitude index, the zero bucket, positives by
        ascending index."""
        out = [(self._rep(i, True), c)
               for i, c in reversed(self._neg.items())]
        if self._zero:
            out.append((0.0, self._zero))
        out.extend((self._rep(i, False), c) for i, c in self._pos.items())
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Value estimate at quantile ``q`` (None while empty): the
        representative of the bucket containing the exact rank
        ``q * (count - 1)``, clamped to the exact [min, max]."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return None
        if q == 0.0:
            return self._min
        if q == 1.0:
            return self._max  # extreme quantiles are exact
        target = q * (self.count - 1)
        cum = 0
        val = self._max
        for rep, c in self._ordered_buckets():
            cum += c
            if cum > target:
                val = rep
                break
        return min(max(val, self._min), self._max)

    def cdf(self, x: float) -> float:
        """Fraction of observations <= ``x``. Exact when ``x`` sits on a
        bucket boundary (``gamma^i``), zero, or beyond the observed
        range; otherwise off by at most the mass of one bucket — which
        is what makes the sketch-KS statistic meaningful."""
        if self.count == 0:
            return 0.0
        if self._min is not None and x < self._min:
            return 0.0
        if self._max is not None and x >= self._max:
            return 1.0
        n = 0
        if x >= 0.0:
            n += self._neg.total() + self._zero
            if x > 0.0:
                # Buckets entirely <= x: i with gamma^i <= x.
                ix = math.floor(math.log(x) / self._log_gamma + 1e-12)
                n += self._pos.count_le(ix)
        else:
            # Negative x: count negatives with value <= x, i.e.
            # magnitude >= |x|: buckets i with gamma^(i-1) >= |x|.
            ix = math.ceil(math.log(-x) / self._log_gamma - 1e-12)
            n += self._neg.count_ge(ix + 1)
        return n / self.count

    def boundaries(self) -> List[float]:
        """The populated buckets' upper/lower value boundaries (plus the
        exact min/max) — the evaluation grid for :func:`ks`."""
        out = set()
        for i, _ in self._pos.items():
            out.add(math.exp(i * self._log_gamma))
            out.add(math.exp((i - 1) * self._log_gamma))
        for i, _ in self._neg.items():
            out.add(-math.exp(i * self._log_gamma))
            out.add(-math.exp((i - 1) * self._log_gamma))
        if self._zero:
            out.add(0.0)
        if self._min is not None:
            out.add(self._min)
            out.add(self._max)
        return sorted(out)

    def summary(self) -> dict:
        """Human-readable digest for /distz and metrics.json."""
        qs = {f"p{int(q * 100):02d}": self.quantile(q)
              for q in (0.01, 0.25, 0.50, 0.75, 0.99)}
        return {"count": self.count, "min": self._min, "max": self._max,
                "zero_fraction": (self._zero / self.count
                                  if self.count else None), **qs}

    # -- serialization -----------------------------------------------------

    def state(self) -> dict:
        return {
            "kind": self.KIND,
            "relative_accuracy": self.relative_accuracy,
            "count": self.count,
            "zero": self._zero,
            "pos": [[i, c] for i, c in self._pos.items()],
            "neg": [[i, c] for i, c in self._neg.items()],
            "min": self._min,
            "max": self._max,
        }

    @staticmethod
    def _store_from_pairs(pairs) -> _BucketStore:
        if not pairs:
            return _BucketStore()
        base = min(int(i) for i, _ in pairs)
        hi = max(int(i) for i, _ in pairs)
        counts = np.zeros(hi - base + 1, np.int64)
        for i, c in pairs:
            counts[int(i) - base] = int(c)
        return _BucketStore(base, counts)

    @classmethod
    def from_state(cls, state: dict) -> "QuantileSketch":
        if state.get("kind") != cls.KIND:
            raise ValueError(f"not a quantile-sketch state: "
                             f"{state.get('kind')!r}")
        sk = cls(relative_accuracy=state["relative_accuracy"])
        sk.count = int(state["count"])
        sk._zero = int(state["zero"])
        sk._pos = cls._store_from_pairs(state["pos"])
        sk._neg = cls._store_from_pairs(state["neg"])
        sk._min = state["min"]
        sk._max = state["max"]
        return sk


class MomentsSketch(_SketchBase):
    """Exact streaming moments (module docstring): count, nnz, min, max,
    mean, unbiased variance, L1 mass. Sums are exact dyadic rationals,
    so merge is exactly associative — the serialized state is a pure
    function of the multiset of ``update`` payloads."""

    KIND = "moments"

    def __init__(self):
        self.count = 0
        self.nnz = 0
        self._sum = Fraction(0)
        self._sum_sq = Fraction(0)
        self._sum_abs = Fraction(0)
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def update(self, values) -> None:
        v = np.asarray(values, np.float64).ravel()
        if v.size == 0:
            return
        lo, hi = float(v.min()), float(v.max())
        if not (math.isfinite(lo) and math.isfinite(hi)):
            # NaN/Inf propagate into min/max: no extra validity pass.
            raise ValueError("MomentsSketch observed non-finite values")
        self.count += int(v.size)
        self.nnz += int(np.count_nonzero(v))
        # One vectorized pairwise np.sum per update — deterministic for
        # the payload (fixed algorithm, fixed content) — accumulated
        # EXACTLY across updates/merges as dyadic rationals.
        self._sum += Fraction(float(v.sum()))
        self._sum_sq += Fraction(float(np.dot(v, v)))
        self._sum_abs += Fraction(float(np.abs(v).sum()))
        self._min = lo if self._min is None else min(self._min, lo)
        self._max = hi if self._max is None else max(self._max, hi)

    def merge(self, other: "MomentsSketch") -> "MomentsSketch":
        self.count += other.count
        self.nnz += other.nnz
        self._sum += other._sum
        self._sum_sq += other._sum_sq
        self._sum_abs += other._sum_abs
        if other._min is not None:
            self._min = other._min if self._min is None \
                else min(self._min, other._min)
        if other._max is not None:
            self._max = other._max if self._max is None \
                else max(self._max, other._max)
        return self

    @property
    def mean(self) -> Optional[float]:
        return float(self._sum / self.count) if self.count else None

    @property
    def variance(self) -> Optional[float]:
        """Unbiased (n-1) variance, computed exactly then rounded once."""
        if self.count == 0:
            return None
        n = self.count
        num = self._sum_sq - self._sum * self._sum / n
        var = float(num / max(n - 1, 1))
        return max(var, 0.0)

    def summary(self) -> dict:
        return {"count": self.count, "nnz": self.nnz,
                "mean": self.mean, "variance": self.variance,
                "min": self._min, "max": self._max,
                "sum": float(self._sum) if self.count else None,
                "abs_mean": (float(self._sum_abs / self.count)
                             if self.count else None)}

    def state(self) -> dict:
        def frac(f: Fraction):
            return [str(f.numerator), str(f.denominator)]

        return {"kind": self.KIND, "count": self.count, "nnz": self.nnz,
                "sum": frac(self._sum), "sum_sq": frac(self._sum_sq),
                "sum_abs": frac(self._sum_abs),
                "min": self._min, "max": self._max}

    @classmethod
    def from_state(cls, state: dict) -> "MomentsSketch":
        if state.get("kind") != cls.KIND:
            raise ValueError(f"not a moments-sketch state: "
                             f"{state.get('kind')!r}")
        sk = cls()
        sk.count = int(state["count"])
        sk.nnz = int(state["nnz"])
        sk._sum = Fraction(int(state["sum"][0]), int(state["sum"][1]))
        sk._sum_sq = Fraction(int(state["sum_sq"][0]),
                              int(state["sum_sq"][1]))
        sk._sum_abs = Fraction(int(state["sum_abs"][0]),
                               int(state["sum_abs"][1]))
        sk._min = state["min"]
        sk._max = state["max"]
        return sk


class TopKSketch(_SketchBase):
    """Bounded heavy hitters over string keys (weighted Misra-Gries).

    Holds at most ``k`` counters. Any key with true frequency
    ``> total / (k + 1)`` is guaranteed present; a stored count
    undercounts the true count by at most ``error_bound()`` (the
    classic Misra-Gries bound, preserved under :meth:`merge`).

    Determinism: state is a pure function of the SEQUENCE of updates
    (batch updates fold unique keys in sorted order), which is all the
    distribution monitor needs — it feeds batches in fixed shard order.
    Unlike the quantile/moments sketches the state is NOT merge-tree-
    independent (no bounded heavy-hitter summary is); the guarantee is.
    """

    KIND = "topk"

    def __init__(self, k: int = 16):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = int(k)
        self.total = 0
        self.decremented = 0
        self._counts: Dict[str, int] = {}

    def update(self, keys, counts: Optional[Sequence[int]] = None) -> None:
        """Fold keys in (an array of strings, with optional counts).
        Uniques fold in sorted key order, so a batch's effect is
        deterministic regardless of row order within the batch."""
        arr = np.asarray(keys)
        if arr.size == 0:
            return
        if counts is None:
            uniq, cnt = np.unique(arr, return_counts=True)
        else:
            cnt_in = np.asarray(counts, np.int64)
            order = np.argsort(arr, kind="stable")
            uniq, starts = np.unique(arr[order], return_index=True)
            cnt = np.add.reduceat(cnt_in[order], starts)
        for key, c in zip(uniq, cnt):
            self._add(str(key), int(c))

    def _add(self, key: str, c: int) -> None:
        self.total += c
        d = self._counts
        if key in d:
            d[key] += c
            return
        if len(d) < self.k:
            d[key] = c
            return
        m = min(d.values())
        dec = min(c, m)
        self.decremented += dec
        for other in list(d):
            d[other] -= dec
            if d[other] <= 0:
                del d[other]
        if c > dec:
            d[key] = c - dec
        # else: the new key was fully absorbed by the decrement

    def merge(self, other: "TopKSketch") -> "TopKSketch":
        """Mergeable-summaries combine: add counters, then subtract the
        (k+1)-th largest count and keep the strictly positive rest
        (<= k survivors by construction). Error bounds add."""
        if other.k != self.k:
            raise ValueError(f"cannot merge top-{self.k} with "
                             f"top-{other.k}")
        merged = dict(self._counts)
        for key, c in other._counts.items():
            merged[key] = merged.get(key, 0) + c
        self.total += other.total
        self.decremented += other.decremented
        if len(merged) > self.k:
            ranked = sorted(merged.items(), key=lambda kv: (-kv[1], kv[0]))
            cut = ranked[self.k][1]
            self.decremented += cut
            merged = {key: c - cut for key, c in ranked if c - cut > 0}
        self._counts = merged
        return self

    def error_bound(self) -> int:
        """Max undercount of any stored count (== max count of any
        UNSTORED key): the mass removed by decrements, itself bounded by
        ``total / (k + 1)``."""
        return self.decremented

    def items(self) -> List[Tuple[str, int]]:
        """(key, lower-bound count) sorted by (-count, key)."""
        return sorted(self._counts.items(), key=lambda kv: (-kv[1], kv[0]))

    def summary(self) -> dict:
        return {"k": self.k, "total": self.total,
                "error_bound": self.error_bound(),
                "top": [[k, c] for k, c in self.items()]}

    def state(self) -> dict:
        return {"kind": self.KIND, "k": self.k, "total": self.total,
                "decremented": self.decremented,
                "counts": [[k, c] for k, c in self.items()]}

    @classmethod
    def from_state(cls, state: dict) -> "TopKSketch":
        if state.get("kind") != cls.KIND:
            raise ValueError(f"not a topk-sketch state: "
                             f"{state.get('kind')!r}")
        sk = cls(k=int(state["k"]))
        sk.total = int(state["total"])
        sk.decremented = int(state["decremented"])
        sk._counts = {str(k): int(c) for k, c in state["counts"]}
        return sk


_KINDS = {cls.KIND: cls
          for cls in (QuantileSketch, MomentsSketch, TopKSketch)}


def sketch_from_state(state: dict):
    """Reconstruct any sketch from its ``state()`` dict (the form model
    artifacts and /distz payloads carry)."""
    cls = _KINDS.get(state.get("kind"))
    if cls is None:
        raise ValueError(f"unknown sketch kind {state.get('kind')!r}")
    return cls.from_state(state)


# ---------------------------------------------------------------------------
# Drift scores
# ---------------------------------------------------------------------------

SketchOrState = Union[QuantileSketch, dict]


def _as_quantile_sketch(s: SketchOrState) -> QuantileSketch:
    return s if isinstance(s, QuantileSketch) \
        else QuantileSketch.from_state(s)


def psi(reference: SketchOrState, current: SketchOrState,
        bins: int = 10, eps: float = 1e-4) -> Optional[float]:
    """Population stability index between two quantile sketches: bin
    boundaries are the REFERENCE's ``bins``-quantiles (the classic PSI
    recipe), both distributions' bin fractions come from the sketch
    CDFs, and fractions are eps-smoothed so an empty bin contributes a
    large-but-finite term. Conventional reading: < 0.1 stable, 0.1-0.25
    moderate shift, > 0.25 major shift. None while either side is
    empty."""
    ref = _as_quantile_sketch(reference)
    cur = _as_quantile_sketch(current)
    if ref.count == 0 or cur.count == 0:
        return None
    cuts: List[float] = []
    for j in range(1, bins):
        c = ref.quantile(j / bins)
        if not cuts or c > cuts[-1]:
            cuts.append(c)
    total = 0.0
    prev_r = prev_c = 0.0
    for edge in cuts + [None]:
        r = 1.0 if edge is None else ref.cdf(edge)
        c = 1.0 if edge is None else cur.cdf(edge)
        p = max(r - prev_r, 0.0)
        q = max(c - prev_c, 0.0)
        prev_r, prev_c = r, c
        p = (p + eps) / (1.0 + (len(cuts) + 1) * eps)
        q = (q + eps) / (1.0 + (len(cuts) + 1) * eps)
        total += (p - q) * math.log(p / q)
    return total


def ks(reference: SketchOrState, current: SketchOrState
       ) -> Optional[float]:
    """Sketch-KS statistic: max |CDF_ref - CDF_cur| over the union of
    both sketches' bucket boundaries (where each CDF is exact). In
    [0, 1]; 0 for identical sketches. None while either side is empty."""
    ref = _as_quantile_sketch(reference)
    cur = _as_quantile_sketch(current)
    if ref.count == 0 or cur.count == 0:
        return None
    grid = sorted(set(ref.boundaries()) | set(cur.boundaries()))
    return max((abs(ref.cdf(x) - cur.cdf(x)) for x in grid),
               default=0.0)
