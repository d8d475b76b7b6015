"""Feature index maps: name⊕term feature keys -> contiguous column indices
(a copy of photon_ml_tpu/data/index_map.py:1-120, which loads no JAX; the
port keeps its own copy so it imports nothing of the JAX package).

The reference needs an off-heap PalDB store for this (ml/util/PalDBIndexMap.scala:43-220)
only to keep JVM heaps small; on the TPU stack a plain host-side dict plus a
frozen numpy view is sufficient (SURVEY §2.9). Key construction matches
GLMSuite: key = name + "\\u0001" + term (ml/io/GLMSuite.scala:370 — the
delimiter is the 0x01 control byte, NOT an empty string), intercept key is
"(INTERCEPT)" with empty term.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, Iterator, Optional, Tuple

DELIMITER = ""
INTERCEPT_NAME = "(INTERCEPT)"
INTERCEPT_KEY = INTERCEPT_NAME + DELIMITER


def feature_key(name: str, term: str = "") -> str:
    return f"{name}{DELIMITER}{term}"


def split_key(key: str) -> Tuple[str, str]:
    name, _, term = key.partition(DELIMITER)
    return name, term


class IndexMap:
    """Bidirectional feature-key <-> index map (ml/util/IndexMap.scala:1-54)."""

    def __init__(self, key_to_index: Dict[str, int]):
        self._k2i = dict(key_to_index)
        self._i2k: Dict[int, str] = {i: k for k, i in self._k2i.items()}
        if len(self._i2k) != len(self._k2i):
            raise ValueError("index map has duplicate indices")

    # -- core interface ---------------------------------------------------

    def get_index(self, key: str) -> int:
        """-1 when absent (the reference's NULL_KEY contract)."""
        return self._k2i.get(key, -1)

    def get_feature_name(self, index: int) -> Optional[str]:
        return self._i2k.get(index)

    def __len__(self) -> int:
        return len(self._k2i)

    def __contains__(self, key: str) -> bool:
        return key in self._k2i

    @property
    def num_features(self) -> int:
        return len(self._k2i)

    def items(self) -> Iterator[Tuple[Tuple[str, str], int]]:
        """Yields ((name, term), index) — used for wildcard constraint
        expansion (ml/io/GLMSuite.scala:207-260)."""
        for key, idx in self._k2i.items():
            yield split_key(key), idx

    def key_items(self) -> Iterator[Tuple[str, int]]:
        return iter(self._k2i.items())

    def key_to_index_dict(self) -> Dict[str, int]:
        """The underlying key->index dict (NOT a copy) — handed to the
        native ingest so feature lookups happen in C. Treat as read-only."""
        return self._k2i

    @property
    def intercept_index(self) -> int:
        idx = self.get_index(INTERCEPT_KEY)
        if idx < 0:
            # Tolerate an intercept registered without the delimiter.
            idx = self.get_index(INTERCEPT_NAME)
        return idx

    # -- construction -----------------------------------------------------

    @classmethod
    def from_keys(cls, keys: Iterable[str], add_intercept: bool = False
                  ) -> "IndexMap":
        """Deterministic map: sorted unique keys, intercept appended last.

        (The reference's DefaultIndexMap sorts for determinism as well.)
        """
        uniq = sorted(set(keys) - {INTERCEPT_KEY})
        if add_intercept:
            uniq.append(INTERCEPT_KEY)
        return cls({k: i for i, k in enumerate(uniq)})

    @classmethod
    def from_name_terms(cls, pairs: Iterable[Tuple[str, str]],
                        add_intercept: bool = False) -> "IndexMap":
        return cls.from_keys(
            (feature_key(n, t) for n, t in pairs), add_intercept)

    # -- persistence (replaces PalDB stores) ------------------------------

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self._k2i))

    @classmethod
    def load(cls, path: str | Path) -> "IndexMap":
        return cls(json.loads(Path(path).read_text()))


class IdentityIndexMap(IndexMap):
    """index i <-> key str(i), for pre-indexed (e.g. LIBSVM) data
    (reference: ml/util/IdentityIndexMapLoader.scala)."""

    def __init__(self, num_features: int, intercept_last: bool = False):
        n = num_features - (1 if intercept_last else 0)
        mapping = {feature_key(str(i)): i for i in range(n)}
        if intercept_last:
            mapping[INTERCEPT_KEY] = n
        super().__init__(mapping)
