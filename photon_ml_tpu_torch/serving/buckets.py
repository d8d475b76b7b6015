"""Static-shape bucket ladder for request padding (port of
photon_ml_tpu/serving/buckets.py:19-77: next_pow2 and BucketLadder).

The serving engine captures one CUDA graph per bucket shape, and a graph
replays only at the shapes it was captured at, so request shapes are
quantized to powers of two on both axes: any request lands in one of
~log2(max_rows) x log2(max_width) buckets, so the graph population is
small, enumerable, and warm after a handful of requests. Padding waste
is bounded by 2x per axis and reported by the engine's stats.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def next_pow2(n: int) -> int:
    """Smallest power of two >= n for n >= 1 (2 for n = 0, as the JAX
    function gives)."""
    return 1 << max(0, int(n - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """Quantizes (rows, nnz) request shapes to static buckets.

    - rows: next power of two in [min_rows, max_rows]; requests beyond
      max_rows are split by the engine, so max_rows is also the
      micro-batch packing ceiling.
    - nnz (per feature shard): quantized via the per-row width
      ceil(nnz / rows_bucket) -> next power of two >= 1, so the nnz
      bucket is always a rows_bucket multiple and a zero-nnz request
      still gets a valid (all-padding) CSR block.
    """

    min_rows: int = 16
    max_rows: int = 4096

    def __post_init__(self):
        if self.min_rows < 1 or self.max_rows < self.min_rows:
            raise ValueError(
                f"invalid ladder bounds [{self.min_rows}, {self.max_rows}]")

    def rows_bucket(self, n_rows: int) -> int:
        if n_rows > self.max_rows:
            raise ValueError(
                f"request has {n_rows} rows > max_rows={self.max_rows}; "
                "split it (the engine does this automatically)")
        return min(self.max_rows, max(self.min_rows, next_pow2(n_rows)))

    def nnz_bucket(self, nnz: int, rows_bucket: int) -> int:
        width = -(-int(nnz) // rows_bucket) if nnz > 0 else 1
        return rows_bucket * next_pow2(max(1, width))

    def bucket_shape(self, n_rows: int,
                     nnz_by_shard: Tuple[int, ...]) -> Tuple:
        """(rows_bucket, (nnz_bucket, ...)): the shape part of a cache
        key, in the caller's fixed shard order."""
        rb = self.rows_bucket(n_rows)
        return (rb, tuple(self.nnz_bucket(z, rb) for z in nnz_by_shard))

    def num_row_buckets(self) -> int:
        """Distinct row buckets the ladder can emit."""
        lo = self.rows_bucket(1)
        count, b = 1, lo
        while b < self.max_rows:
            b *= 2
            count += 1
        return count
