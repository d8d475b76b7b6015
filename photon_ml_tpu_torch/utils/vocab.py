"""Vectorized entity-vocabulary code lookup (port of
photon_ml_tpu/utils/vocab.py: SortedVocab :21-48, vocab_code_lookup
:51-56): one argsort of the model vocabulary and a searchsorted per query
batch. The serving engine keeps a prebuilt ``SortedVocab`` per sub-model,
so the sort is paid once per model rather than per request."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SortedVocab:
    """A model vocabulary presorted for repeated searchsorted lookups.

    ``codes_of(names)`` returns, per name, the index of that name in the
    ORIGINAL vocab order (the model's code space), or -1 when absent (the
    reference's missing-join semantics: unknown entities score 0)."""

    sorted_names: np.ndarray  # unicode, ascending
    order: np.ndarray  # int64: position in sorted_names -> original code

    @classmethod
    def build(cls, vocab) -> "SortedVocab":
        v = np.asarray(vocab)
        v = v.astype(str) if v.dtype.kind != "U" else v
        order = np.argsort(v, kind="stable")
        return cls(sorted_names=v[order], order=order.astype(np.int64))

    def codes_of(self, names) -> np.ndarray:
        q = np.asarray(names)
        q = q.astype(str) if q.dtype.kind != "U" else q
        if self.sorted_names.size == 0 or q.size == 0:
            return np.full(q.shape, -1, np.int64)
        pos = np.searchsorted(self.sorted_names, q)
        pos = np.minimum(pos, len(self.sorted_names) - 1)
        return np.where(self.sorted_names[pos] == q, self.order[pos], -1)


def vocab_code_lookup(vocab, names) -> np.ndarray:
    """For each name in ``names``: its code (index) in ``vocab``, or -1
    (the one-shot form of ``SortedVocab``: sorts per call)."""
    return SortedVocab.build(vocab).codes_of(names).astype(np.int64)
