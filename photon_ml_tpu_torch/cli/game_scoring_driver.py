"""GAME scoring driver, batch path (port of
photon_ml_tpu/cli/game_scoring_driver.py: build_parser :48-150, run :197,
the legacy aliases :264-278, _run_scoring's default branch :280-373;
reference ml/cli/game/scoring/Driver.scala:36-265): load a saved GAME
model, score a dataset on the card, write ScoringResultAvro records to
<output-dir>/scores/part-00000.avro, optionally evaluate, and write
metrics.json.

The whole input is read into one GameDataset and scored by
``DeviceGameScorer`` (fixed effects, loaded random-effect snapshots and
MF models). The JAX driver falls back to host numpy when its scorer
refuses a sub-model; the port does not: a sub-model the scorer refuses
(or a snapshot too large to densify) ends the run with its error.
``scoring_path`` is the constant "device", kept for the JAX metrics.json
keys; the guarantee is the scorer's raising, not this key.

Every JAX flag parses. --stream, --serve, --listen, --adaptive-admission,
--distmon, --trace-out and the observability flags raise an error naming
ROADMAP queue A5 (the serving stack and telemetry); the flags that only
shape those paths (--batch-rows, --feeder, --serve-concurrency, ...) are
accepted and unused, as in the JAX batch path. metrics.json has the JAX
batch keys but ``telemetry`` (A5).

``run(argv, device="cuda", dtype=None)`` scores on the card and raises
without CUDA unless the caller passes ``device="cpu"``; ``dtype`` None
means float64 on the CPU and float32 on the card.

    python -m photon_ml_tpu_torch.cli.game_scoring_driver --input-dirs ...
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from photon_ml_tpu_torch.cli import (
    OBSERVABILITY_FLAGS,
    add_observability_args,
    phase,
    reject_later_flags,
    resolve_run_device,
)
from photon_ml_tpu_torch.data.avro_reader import read_game_dataset
from photon_ml_tpu_torch.data.paldb import load_feature_index_maps
from photon_ml_tpu_torch.evaluation import build_evaluator
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro_codec import write_container
from photon_ml_tpu_torch.io.model_io import load_game_model
from photon_ml_tpu_torch.models.device_scoring import DeviceGameScorer
from photon_ml_tpu_torch.utils.date_range import resolve_input_dirs
from photon_ml_tpu_torch.utils.logging_utils import setup_photon_logger

LATER_FLAGS = {
    "stream": ("--stream", False, "A5"),
    "serve": ("--serve", False, "A5"),
    "listen": ("--listen", None, "A5"),
    "adaptive_admission": ("--adaptive-admission", False, "A5"),
    "distmon": ("--distmon", False, "A5"),
    "trace_out": ("--trace-out", None, "A5"),
    **OBSERVABILITY_FLAGS,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="photon-game-scoring-driver")
    p.add_argument("--input-dirs", required=True)
    p.add_argument("--date-range", default=None,
                   help="yyyyMMdd-yyyyMMdd; expands daily/yyyy/MM/dd "
                        "subdirs of the input dirs")
    p.add_argument("--date-range-days-ago", default=None)
    p.add_argument("--game-model-input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--feature-index-dir", default=None,
                   help="feature index stores keyed by shard id: "
                        "<shard>.json maps or the reference's partitioned "
                        "PalDB stores (defaults to "
                        "<model-dir>/feature-indexes)")
    p.add_argument("--evaluators", default=None)
    p.add_argument("--id-types", default=None)
    p.add_argument("--stream", action="store_true",
                   help="streamed scoring (ROADMAP A5; raises)")
    p.add_argument("--batch-rows", type=int, default=4096,
                   help="rows per streamed batch (--stream only)")
    p.add_argument("--feeder", choices=["auto", "native", "python"],
                   default="auto", help="--stream decode path")
    p.add_argument("--prefetch-batches", type=int, default=2,
                   help="--stream decode-ahead depth")
    p.add_argument("--serve", action="store_true",
                   help="request replay through the serving front-end "
                        "(ROADMAP A5; raises)")
    p.add_argument("--serve-concurrency", type=int, default=16,
                   help="--serve requesters")
    p.add_argument("--coalesce-ms", type=float, default=2.0,
                   help="--serve coalesce window in milliseconds")
    p.add_argument("--request-rows", type=int, default=1,
                   help="--serve rows per request")
    p.add_argument("--max-pending", type=int, default=1024,
                   help="--serve admission bound")
    p.add_argument("--listen", default=None, metavar="ADDR",
                   help="network serving (ROADMAP A5; raises)")
    p.add_argument("--serve-seconds", type=float, default=None,
                   metavar="S", help="--listen lifetime")
    p.add_argument("--adaptive-admission", action="store_true",
                   help="SLO-adaptive admission (ROADMAP A5; raises)")
    p.add_argument("--distmon", action="store_true",
                   help="score drift monitoring (ROADMAP A5; raises)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="pipeline trace (ROADMAP A5; raises)")
    add_observability_args(p)
    return p


def run(argv=None, *, device="cuda", dtype=None) -> dict:
    """Score and write; returns the metrics.json summary."""
    dev, dtype = resolve_run_device(device, dtype)
    args = build_parser().parse_args(argv)
    reject_later_flags(args, LATER_FLAGS)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = setup_photon_logger(out_dir)
    t0 = time.perf_counter()
    summary = _run_scoring(args, out_dir, logger, dev, dtype)
    summary["total_seconds"] = time.perf_counter() - t0
    _apply_legacy_aliases(summary)
    (out_dir / "metrics.json").write_text(json.dumps(summary, indent=2))
    logger.info("scoring done: %s", summary["metrics"])
    return summary


# snake_case canonical -> camelCase alias, as the JAX driver writes both.
_LEGACY_ALIASES = {
    "num_rows": "numRows",
    "num_batches": "numBatches",
    "batch_rows": "batchRows",
    "scoring_path": "scoringPath",
    "total_seconds": "totalSeconds",
}


def _apply_legacy_aliases(summary: dict) -> dict:
    for snake, camel in _LEGACY_ALIASES.items():
        if snake in summary:
            summary[camel] = summary[snake]
    return summary


def _run_scoring(args, out_dir, logger, device, dtype) -> dict:
    model_dir = Path(args.game_model_input_dir)
    index_dir = Path(args.feature_index_dir) if args.feature_index_dir else \
        model_dir / "feature-indexes"
    with phase(logger, "load_model"):
        shard_maps = load_feature_index_maps(index_dir)
        model = load_game_model(model_dir, shard_maps)

    with phase(logger, "setup"):
        meta = json.loads((model_dir / "model-metadata.json").read_text())
        id_types = sorted(
            {c["randomEffectType"] for c in meta["coordinates"]
             if c["kind"] == "random"} |
            # MF coordinates key rows by both their entity axes.
            {c[k] for c in meta["coordinates"] if c["kind"] == "mf"
             for k in ("rowEffectType", "colEffectType")} |
            {s.strip() for s in (args.id_types or "").split(",")
             if s.strip()})
        inputs = resolve_input_dirs(
            args.input_dirs, date_range=args.date_range,
            date_range_days_ago=args.date_range_days_ago)
        evaluators = [build_evaluator(s.strip())
                      for s in (args.evaluators or "").split(",")
                      if s.strip()]
        scores_dir = out_dir / "scores"
        scores_dir.mkdir(exist_ok=True)
        scores_path = scores_dir / "part-00000.avro"

    with phase(logger, "ingest"):
        data, _ = read_game_dataset(inputs, id_types=id_types,
                                    feature_shard_maps=shard_maps)
    with phase(logger, "score"):
        scorer = DeviceGameScorer(model, data, dtype=dtype, device=device)
        scores = np.asarray(scorer.score(model).cpu().numpy(), np.float64)
    logger.info("scored %d rows (device path)", data.num_rows)

    with phase(logger, "write_scores"):
        uids = data.uids if data.uids is not None else \
            np.asarray([str(i) for i in range(data.num_rows)])
        write_container(
            scores_path, schemas.SCORING_RESULT,
            [{"uid": str(u), "predictionScore": float(s + o),
              "label": float(lab), "metadataMap": None}
             for u, s, o, lab in zip(uids, scores, data.offsets,
                                     data.responses)])
    with phase(logger, "evaluate"):
        metrics = {ev.name: ev.evaluate_dataset(scores, data)
                   for ev in evaluators}
    return {
        "num_rows": int(data.num_rows),
        "metrics": metrics,
        "scoring_path": "device",
    }


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
