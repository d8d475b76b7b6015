"""GAME training driver, in core (port of
photon_ml_tpu/cli/game_training_driver.py: _parse_named :52,
_positive_int :62, _parse_mesh_shape :69, parse_byte_size :99,
build_parser :116-310, run :311, _run_training's in-core path :391-612,
_save_outputs :613-662, _write_summary :663-703; reference
ml/cli/game/training/Driver.scala:43-298, params from
ml/estimators/GameParams.scala:40-427).

Coordinate mini-DSLs preserved from the reference:
  --fixed-effect-data-configurations   name:featureShardId
  --random-effect-data-configurations  name:reType,shardId,numPartitions,
                                       activeBound,passiveBound,ratio[,proj]
  --fixed-effect-optimization-configurations / --random-effect-...:
                                       name:maxIter,tol,λ,rate,optimizer,reg
                                       (| separates grid points)
  --updating-sequence                  comma-separated coordinate names
Outputs: <output-dir>/best/ (saved GAME model, model-metadata.json,
feature-indexes/<shard>.json), all/<i>/ under --save-all-models true,
metrics.json and log-message.txt.

Every JAX flag parses. The flags of later queue items raise an error that
names the item: --stream-train, --hbm-budget, --grid-batched other than
auto, --spill-dtype, --spill-source, --feeder, --prefetch-batches (A4);
--distmon, --trace-out, --profile-output-dir and the observability flags
(A5); --mesh-devices, --mesh-shape (A6). metrics.json has the JAX
in-core keys but ``telemetry`` (A5).

``run(argv, device="cuda", dtype=None)`` trains on the card and raises
without CUDA unless the caller passes ``device="cpu"`` (the CPU tests);
``dtype`` None means float64 on the CPU and float32 on the card.

    python -m photon_ml_tpu_torch.cli.game_training_driver --train-input-dirs ...
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from photon_ml_tpu_torch.cli import (
    OBSERVABILITY_FLAGS,
    add_observability_args,
    phase,
    reject_later_flags,
    resolve_run_device,
)
from photon_ml_tpu_torch.data.avro_reader import read_game_dataset
from photon_ml_tpu_torch.data.paldb import load_feature_index_maps
from photon_ml_tpu_torch.data.random_effect import (
    RandomEffectDataConfiguration,
)
from photon_ml_tpu_torch.estimators.game_estimator import (
    FactoredRandomEffectSpec,
    FixedEffectSpec,
    GameEstimator,
    RandomEffectSpec,
)
from photon_ml_tpu_torch.evaluation import build_evaluator
from photon_ml_tpu_torch.io.model_io import save_game_model
from photon_ml_tpu_torch.models.tracking import summarize_trackers
from photon_ml_tpu_torch.optimization.config import (
    FactoredRandomEffectOptimizationConfiguration,
    GLMOptimizationConfiguration,
)
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils.date_range import resolve_input_dirs
from photon_ml_tpu_torch.utils.events import (
    EventEmitter,
    TrainingFinishEvent,
    TrainingStartEvent,
)
from photon_ml_tpu_torch.utils.logging_utils import setup_photon_logger

# dest -> (flag, default, ROADMAP queue item): given any other value, the
# flag raises (cli/__init__.reject_later_flags).
LATER_FLAGS = {
    "stream_train": ("--stream-train", False, "A4"),
    "hbm_budget": ("--hbm-budget", None, "A4"),
    "grid_batched": ("--grid-batched", "auto", "A4"),
    "spill_dtype": ("--spill-dtype", "f32", "A4"),
    "spill_source": ("--spill-source", "buffer", "A4"),
    "feeder": ("--feeder", "auto", "A4"),
    "prefetch_batches": ("--prefetch-batches", 2, "A4"),
    "distmon": ("--distmon", False, "A5"),
    "trace_out": ("--trace-out", None, "A5"),
    "profile_output_dir": ("--profile-output-dir", None, "A5"),
    **OBSERVABILITY_FLAGS,
    "mesh_devices": ("--mesh-devices", None, "A6"),
    "mesh_shape": ("--mesh-shape", None, "A6"),
}


def _parse_named(values, what):
    out = {}
    for item in values or []:
        name, _, rest = item.partition(":")
        if not rest:
            raise ValueError(f"bad {what} {item!r}: expected 'name:...'")
        out[name.strip()] = rest.strip()
    return out


def _positive_int(s: str) -> int:
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def _parse_mesh_shape(s: str) -> tuple:
    """'RxC' -> (R, C): data-axis x model-axis device extents."""
    parts = s.strip().lower().split("x")
    try:
        r, c = (int(v) for v in parts)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"bad mesh shape {s!r} (expected RxC, e.g. 2x2, 4x1)")
    if r < 1 or c < 1:
        raise argparse.ArgumentTypeError(
            f"mesh extents must be >= 1, got {r}x{c}")
    return (r, c)


_BYTE_SUFFIXES = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40}


def parse_byte_size(s: str) -> int:
    """'512M', '8G', '1048576' -> bytes."""
    s = s.strip().upper().removesuffix("B")
    mult = 1
    if s and s[-1] in _BYTE_SUFFIXES:
        mult = _BYTE_SUFFIXES[s[-1]]
        s = s[:-1]
    try:
        v = int(float(s) * mult)
    except (ValueError, OverflowError):
        raise argparse.ArgumentTypeError(
            f"bad byte size {s!r} (expected e.g. 512M, 8G, 1048576)")
    if v < 1:
        raise argparse.ArgumentTypeError(f"byte size must be >= 1, got {v}")
    return v


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon-game-training-driver",
        description="Train GAME models (fixed + random effects)")
    p.add_argument("--train-input-dirs", required=True)
    p.add_argument("--validate-input-dirs", default=None)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--task-type", required=True,
                   choices=[t.value for t in TaskType])
    p.add_argument("--fixed-effect-data-configurations", nargs="*",
                   default=[], metavar="name:featureShardId")
    p.add_argument("--fixed-effect-optimization-configurations", nargs="*",
                   default=[], metavar="name:optConfig[|optConfig...]")
    p.add_argument("--random-effect-data-configurations", nargs="*",
                   default=[], metavar="name:reDataConfig")
    p.add_argument("--random-effect-optimization-configurations", nargs="*",
                   default=[], metavar="name:optConfig[|optConfig...]")
    p.add_argument("--factored-random-effect-data-configurations", nargs="*",
                   default=[], metavar="name:reDataConfig")
    p.add_argument("--factored-random-effect-optimization-configurations",
                   nargs="*", default=[],
                   metavar="name:reOpt;latentOpt;mfMaxIter,numFactors[|...]")
    p.add_argument("--updating-sequence", required=True,
                   help="comma-separated coordinate order")
    p.add_argument("--train-date-range", default=None,
                   help="yyyyMMdd-yyyyMMdd; expands daily/yyyy/MM/dd "
                        "subdirs of the train input dirs")
    p.add_argument("--train-date-range-days-ago", default=None,
                   help="start-end in days ago, e.g. 90-1")
    p.add_argument("--validate-date-range", default=None)
    p.add_argument("--validate-date-range-days-ago", default=None)
    p.add_argument("--num-iterations", type=_positive_int, default=1)
    p.add_argument("--checkpoint-dir", default=None,
                   help="resumable coordinate-descent checkpoints land "
                        "here; a rerun resumes from the latest")
    p.add_argument("--checkpoint-interval", type=_positive_int, default=1,
                   help="coordinate updates between checkpoints (>=1)")
    p.add_argument("--evaluators", default=None,
                   help="comma-separated evaluator specs (first selects)")
    p.add_argument("--id-types", default=None,
                   help="extra entity id columns to read from metadataMap "
                        "(defaults to the random-effect types)")
    p.add_argument("--ingest-workers", default="auto",
                   help="accepted for the JAX command line; the Avro "
                        "decode runs in this process")
    p.add_argument("--feature-index-dir", default=None,
                   help="pre-built feature index stores keyed by shard id: "
                        "the reference's partitioned PalDB stores "
                        "(paldb-partition-<shard>-<N>.dat) or <shard>.json "
                        "stores; replaces the Avro-scan index pass")
    p.add_argument("--profile-output-dir", default=None,
                   help="profiler trace (ROADMAP A5; raises)")
    p.add_argument("--save-all-models", default="false",
                   choices=["true", "false"],
                   help="model-output-mode ALL vs BEST")
    p.add_argument("--stream-train", action="store_true",
                   help="out-of-core training (ROADMAP A4; raises)")
    p.add_argument("--batch-rows", type=_positive_int, default=4096,
                   help="rows per streamed batch (--stream-train only)")
    p.add_argument("--hbm-budget", default=None, metavar="BYTES",
                   type=parse_byte_size,
                   help="device-memory budget (ROADMAP A4; raises)")
    p.add_argument("--grid-batched", choices=["auto", "on", "off"],
                   default="auto",
                   help="batched λ-grid sweep (ROADMAP A4; raises when "
                        "not auto)")
    p.add_argument("--mesh-devices", type=_positive_int, default=None,
                   metavar="N", help="1-D device mesh (ROADMAP A6; raises)")
    p.add_argument("--mesh-shape", type=_parse_mesh_shape, default=None,
                   metavar="RxC", help="2-D device mesh (ROADMAP A6; raises)")
    p.add_argument("--spill-dtype", choices=["f32", "bf16"], default="f32",
                   help="spill encoding (ROADMAP A4; raises when not f32)")
    p.add_argument("--spill-source", choices=["buffer", "redecode"],
                   default="buffer",
                   help="spill source (ROADMAP A4; raises when not buffer)")
    p.add_argument("--feeder", choices=["auto", "native", "python"],
                   default="auto",
                   help="streamed decode path (ROADMAP A4; raises when "
                        "not auto)")
    p.add_argument("--prefetch-batches", type=int, default=2,
                   help="decode-ahead depth (ROADMAP A4; raises when "
                        "not 2)")
    p.add_argument("--distmon", action="store_true",
                   help="distribution observability (ROADMAP A5; raises)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="pipeline trace (ROADMAP A5; raises)")
    p.add_argument("--job-name", default="photon-game-training",
                   help="job name carried on Training{Start,Finish} "
                        "events")
    p.add_argument("--event-listeners", default=None,
                   help="comma-separated EventListener class paths "
                        "registered by name (utils/events.py)")
    add_observability_args(p)
    return p


def run(argv=None, *, device="cuda", dtype=None) -> dict:
    """Train and save; returns the metrics.json summary."""
    dev, dtype = resolve_run_device(device, dtype)
    args = build_parser().parse_args(argv)
    reject_later_flags(args, LATER_FLAGS)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = setup_photon_logger(out_dir)
    task = TaskType(args.task_type)
    t0 = time.perf_counter()
    emitter = EventEmitter()
    try:
        for cp in (args.event_listeners or "").split(","):
            if cp.strip():
                emitter.register_listener_by_name(cp.strip())
        emitter.send_event(TrainingStartEvent(args.job_name))
        (sequence, results, best_configs, best_result, shard_maps,
         num_rows) = _run_training(args, logger, task, dev, dtype)
        _save_outputs(args, out_dir, logger, sequence, results,
                      best_configs, best_result, shard_maps)
        summary = _write_summary(out_dir, logger, task, sequence, t0,
                                 results, best_configs, best_result,
                                 num_rows)
        emitter.send_event(
            TrainingFinishEvent(args.job_name, summary["totalSeconds"]))
        return summary
    finally:
        emitter.clear_listeners()


def _run_training(args, logger, task, device, dtype):
    """Config parse + in-core train; returns what the save and summary
    need."""
    fe_data = _parse_named(args.fixed_effect_data_configurations,
                           "fixed-effect data config")
    fe_opt = _parse_named(args.fixed_effect_optimization_configurations,
                          "fixed-effect optimization config")
    re_data = {
        name: RandomEffectDataConfiguration.parse(cfg)
        for name, cfg in _parse_named(
            args.random_effect_data_configurations,
            "random-effect data config").items()}
    re_opt = _parse_named(args.random_effect_optimization_configurations,
                          "random-effect optimization config")
    fre_data = {
        name: RandomEffectDataConfiguration.parse(cfg)
        for name, cfg in _parse_named(
            args.factored_random_effect_data_configurations,
            "factored-random-effect data config").items()}
    fre_opt = _parse_named(
        args.factored_random_effect_optimization_configurations,
        "factored-random-effect optimization config")

    sequence = [s.strip() for s in args.updating_sequence.split(",")]
    for name in sequence:
        if name not in fe_data and name not in re_data \
                and name not in fre_data:
            raise ValueError(
                f"updating-sequence entry {name!r} has no data configuration")

    id_types = sorted(
        {c.random_effect_type for c in re_data.values()} |
        {c.random_effect_type for c in fre_data.values()} |
        {s.strip() for s in (args.id_types or "").split(",") if s.strip()})

    preloaded_maps = None
    if args.feature_index_dir:
        preloaded_maps = load_feature_index_maps(args.feature_index_dir)
        logger.info(
            "loaded feature index stores from %s: %s", args.feature_index_dir,
            {k: len(v) for k, v in sorted(preloaded_maps.items())})

    train_inputs = resolve_input_dirs(
        args.train_input_dirs,
        date_range=args.train_date_range,
        date_range_days_ago=args.train_date_range_days_ago)

    def opt_grid(table, name, flag):
        if name not in table:
            raise ValueError(
                f"coordinate {name!r} has no optimization configuration — "
                f"pass it via {flag} (have {sorted(table) or 'none'})")
        return [GLMOptimizationConfiguration.parse(part)
                for part in table[name].split("|")]

    evaluators = [build_evaluator(s.strip())
                  for s in (args.evaluators or "").split(",") if s.strip()]

    logger.info("reading training data from %s", train_inputs)
    with phase(logger, "ingest"):
        data, shard_maps = read_game_dataset(
            train_inputs, id_types=id_types,
            feature_shard_maps=preloaded_maps,
            ingest_workers=args.ingest_workers)
        validation = None
        if args.validate_input_dirs:
            validate_inputs = resolve_input_dirs(
                args.validate_input_dirs,
                date_range=args.validate_date_range,
                date_range_days_ago=args.validate_date_range_days_ago)
            validation, _ = read_game_dataset(
                validate_inputs, id_types=id_types,
                feature_shard_maps=shard_maps,
                ingest_workers=args.ingest_workers)

    specs = []
    for name in sequence:
        if name in fe_data:
            shard = fe_data[name]
            if shard not in shard_maps:
                raise ValueError(
                    f"fixed-effect coordinate {name!r} references unknown "
                    f"feature shard {shard!r} (have {sorted(shard_maps)})")
            specs.append(FixedEffectSpec(
                name=name, feature_shard_id=shard,
                configs=opt_grid(
                    fe_opt, name,
                    "--fixed-effect-optimization-configurations")))
        elif name in fre_data:
            cfg = fre_data[name]
            if cfg.feature_shard_id not in shard_maps:
                raise ValueError(
                    f"factored-random-effect coordinate {name!r} references "
                    f"unknown feature shard {cfg.feature_shard_id!r}")
            if name not in fre_opt:
                raise ValueError(
                    f"coordinate {name!r} has no optimization configuration "
                    "— pass it via "
                    "--factored-random-effect-optimization-configurations")
            specs.append(FactoredRandomEffectSpec(
                name=name, data_config=cfg,
                configs=[FactoredRandomEffectOptimizationConfiguration
                         .parse(part)
                         for part in fre_opt[name].split("|")]))
        else:
            cfg = re_data[name]
            if cfg.feature_shard_id not in shard_maps:
                raise ValueError(
                    f"random-effect coordinate {name!r} references unknown "
                    f"feature shard {cfg.feature_shard_id!r}")
            imap = shard_maps[cfg.feature_shard_id]
            specs.append(RandomEffectSpec(
                name=name, data_config=cfg,
                configs=opt_grid(
                    re_opt, name,
                    "--random-effect-optimization-configurations"),
                intercept_col=(imap.intercept_index
                               if imap.intercept_index >= 0 else None)))

    estimator = GameEstimator(
        task_type=task, coordinate_specs=specs,
        num_iterations=args.num_iterations,
        validation_evaluators=evaluators, dtype=dtype, device=device)
    with phase(logger, "solve"):
        results = estimator.fit(
            data, validation_data=validation,
            checkpoint_dir=(Path(args.checkpoint_dir)
                            if args.checkpoint_dir else None),
            checkpoint_interval=args.checkpoint_interval)
    best_configs, best_result = estimator.select_best(results)
    return (sequence, results, best_configs, best_result, shard_maps,
            int(data.num_rows))


def _save_outputs(args, out_dir, logger, sequence, results,
                  best_configs, best_result, shard_maps) -> None:
    """Model + index-map save (the ``finalize`` phase)."""
    tracker_summary = summarize_trackers(best_result.trackers)
    for name, per_update in tracker_summary.items():
        if per_update:
            last = per_update[-1]
            logger.info(
                "coordinate %s (last update): %d solves, reasons %s, "
                "iterations mean %.1f max %d", name, last["numSolves"],
                last["convergenceReasons"], last["iterations"]["mean"],
                int(last["iterations"]["max"]))

    with phase(logger, "finalize"):
        save_game_model(
            out_dir / "best", best_result.best_model, shard_maps,
            metadata_extras={
                "optimizationConfigurations": {
                    k: v.to_json() for k, v in best_configs.items()},
                "updatingSequence": sequence,
                "numIterations": args.num_iterations,
                "optimizationTrackers": tracker_summary,
            })
        # The feature index maps beside the model, so the scoring driver
        # decodes features identically.
        index_dir = out_dir / "best" / "feature-indexes"
        index_dir.mkdir(parents=True, exist_ok=True)
        for shard, imap in shard_maps.items():
            imap.save(index_dir / f"{shard}.json")
        if args.save_all_models == "true":
            for i, (configs, result) in enumerate(results):
                save_game_model(
                    out_dir / "all" / str(i), result.model, shard_maps,
                    metadata_extras={
                        "optimizationConfigurations": {
                            k: v.to_json() for k, v in configs.items()}})


def _write_summary(out_dir, logger, task, sequence, t0, results,
                   best_configs, best_result, num_rows) -> dict:
    """metrics.json: the JAX in-core keys but ``telemetry`` (A5)."""
    wall = time.perf_counter() - t0
    summary = {
        "taskType": task.value,
        "numRows": num_rows,
        "num_rows": num_rows,
        "updatingSequence": sequence,
        "numCombos": len(results),
        "bestConfigs": {k: v.to_string() for k, v in best_configs.items()},
        "objectiveHistory": best_result.objective_history,
        "validationHistory": best_result.validation_history,
        "coordinateSeconds": best_result.timings,
        "totalSeconds": wall,
        "total_seconds": wall,
    }
    (out_dir / "metrics.json").write_text(json.dumps(summary, indent=2))
    logger.info("GAME training done in %.1fs", summary["totalSeconds"])
    return summary


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
