"""Feature indexing job (a copy of photon_ml_tpu/cli/feature_indexing.py
over the port's modules: the same flags, defaults and files; a host job,
so it takes no device. Run it as ``python -m
photon_ml_tpu_torch.cli.feature_indexing``. Reference:
ml/FeatureIndexingJob.scala:59-350):
scan training Avro, build a name⊕term -> index map per feature shard, persist.
``--format json`` (default) writes this package's JSON map per shard;
``--format paldb`` writes partitioned PalDB 1.1 stores exactly like the
reference (FeatureIndexingJob.scala:145-174 via PalDBIndexMapBuilder —
both directions per partition, Spark HashPartitioner, cumulative-offset
global indices), so downstream Photon-adjacent tooling can consume them."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from photon_ml_tpu_torch.data.avro_reader import build_index_map
from photon_ml_tpu_torch.utils.logging_utils import setup_photon_logger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="photon-feature-indexing-job")
    p.add_argument("--data-path", required=True)
    p.add_argument("--partition-num", type=int, default=1,
                   help="PalDB store partition count (ignored by the "
                        "single-partition JSON format)")
    p.add_argument("--format", default="json", choices=["json", "paldb"],
                   help="index store format: this package's JSON map or "
                        "reference-compatible partitioned PalDB stores")
    p.add_argument("--add-intercept", default="true",
                   choices=["true", "false"])
    p.add_argument("--output-dir", required=True)
    p.add_argument("--shard-name", default="global")
    p.add_argument("--save-name-and-term-sets", default="false",
                   choices=["true", "false"],
                   help="also persist per-section (name, term) text sets "
                        "(ml/avro/data/NameAndTermFeatureSetContainer.scala)")
    return p


def run(argv=None) -> Path:
    args = build_parser().parse_args(argv)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = setup_photon_logger(out_dir)
    imap = build_index_map(args.data_path,
                           add_intercept=args.add_intercept == "true")
    if args.format == "paldb":
        from photon_ml_tpu_torch.data.paldb import build_paldb_index_stores

        # Re-index through the partitioned builder: per-partition local
        # indices + cumulative offsets, the layout PalDBIndexMap.load
        # expects (indices change from the scan order, as they do in the
        # reference where the partitioned store IS the index authority).
        names = [k for k, _ in sorted(imap.key_items(), key=lambda kv: kv[1])]
        imap = build_paldb_index_stores(out_dir, args.shard_name, names,
                                        num_partitions=args.partition_num)
        out = out_dir / f"paldb-partition-{args.shard_name}-0.dat"
        logger.info("indexed %d features -> %s (%d PalDB partitions)",
                    len(imap), out_dir, args.partition_num)
    else:
        out = out_dir / f"{args.shard_name}.json"
        imap.save(out)
        logger.info("indexed %d features -> %s", len(imap), out)
    if args.save_name_and_term_sets == "true":
        from photon_ml_tpu_torch.data.index_map import INTERCEPT_KEY, split_key
        from photon_ml_tpu_torch.data.name_and_term import (
            NameAndTermFeatureSetContainer,
        )

        # The index map already holds every (name, term) — no second scan.
        container = NameAndTermFeatureSetContainer({"features": {
            split_key(k) for k, _ in imap.key_items()
            if k != INTERCEPT_KEY}})
        set_dir = out_dir / "name-and-term-sets"
        container.save_as_text_files(set_dir)
        logger.info("feature sets -> %s", set_dir)
    return out


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
