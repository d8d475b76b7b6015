"""Name-and-term feature-set extraction and persistence (a copy of
photon_ml_tpu/data/name_and_term.py over the port's avro_reader and
index_map; the same sorted order and text layout, so the files compare
byte for byte. Reference:
ml/avro/data/NameAndTerm.scala and
ml/avro/data/NameAndTermFeatureSetContainer.scala — per-feature-section
distinct (name, term) sets, persisted as text files, merged into a feature
index map with optional intercept; the GAME driver's "Avro scan" feature-map
path, ml/cli/game/GAMEDriver.prepareFeatureMaps:43-100)."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Sequence, Set, Tuple

from photon_ml_tpu_torch.data.avro_reader import iter_records
from photon_ml_tpu_torch.data.index_map import (
    DELIMITER,
    INTERCEPT_KEY,
    IndexMap,
    feature_key,
)

NameAndTerm = Tuple[str, str]


@dataclasses.dataclass
class NameAndTermFeatureSetContainer:
    """section key -> set of (name, term) pairs."""

    feature_sets: Dict[str, Set[NameAndTerm]]

    def get_feature_name_and_term_to_index_map(
        self, section_keys: Sequence[str], add_intercept: bool = False,
    ) -> IndexMap:
        """Union the selected sections into one contiguous IndexMap
        (NameAndTermFeatureSetContainer.getFeatureNameAndTermToIndexMap).
        Sorted for determinism (the reference's set-fold order is JVM-hash
        dependent; stable order makes models reproducible)."""
        merged: Set[NameAndTerm] = set()
        for key in section_keys:
            merged |= self.feature_sets.get(key, set())
        k2i = {feature_key(n, t): i
               for i, (n, t) in enumerate(sorted(merged))}
        if add_intercept:
            k2i[INTERCEPT_KEY] = len(k2i)
        return IndexMap(k2i)

    def save_as_text_files(self, output_dir) -> None:
        """One `<section>.txt` per section, one `name<0x01>term` line per
        feature (saveAsTextFiles)."""
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        for section, features in self.feature_sets.items():
            lines = [f"{n}{DELIMITER}{t}" for n, t in sorted(features)]
            (out / f"{section}.txt").write_text(
                "\n".join(lines) + ("\n" if lines else ""))

    @classmethod
    def load_from_text_files(
        cls, input_dir, section_keys: Sequence[str],
    ) -> "NameAndTermFeatureSetContainer":
        """(readNameAndTermFeatureSetContainerFromTextFiles)."""
        feature_sets: Dict[str, Set[NameAndTerm]] = {}
        for section in section_keys:
            path = Path(input_dir) / f"{section}.txt"
            features: Set[NameAndTerm] = set()
            for line in path.read_text().splitlines():
                if line:
                    name, _, term = line.partition(DELIMITER)
                    features.add((name, term))
            feature_sets[section] = features
        return cls(feature_sets)

    @classmethod
    def from_avro(
        cls, path, section_keys: Sequence[str] = ("features",),
    ) -> "NameAndTermFeatureSetContainer":
        """Scan Avro training records and collect distinct (name, term) per
        feature-bag field (AvroUtils.readNameAndTermFeatureSetContainer...
        FromGenericRecords — each section key is a record field holding a
        list of {name, term, value} records)."""
        feature_sets: Dict[str, Set[NameAndTerm]] = {
            key: set() for key in section_keys}
        for rec in iter_records(path):
            for key in section_keys:
                for f in rec.get(key) or ():
                    feature_sets[key].add(
                        (f["name"], f.get("term") or ""))
        return cls(feature_sets)
