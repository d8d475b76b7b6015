"""GAME training driver, in core and streamed (port of
photon_ml_tpu/cli/game_training_driver.py: _parse_named :52,
_positive_int :62, _parse_mesh_shape :69, _mesh_shape :86,
parse_byte_size :99,
build_parser :116-310, run :311-389 with its telemetry and
observability plane, _run_training :391-612, _save_outputs :613-662,
_write_summary :663-703, _stream_validate_many :704-737,
_solve_grid_batched :739-822, _stream_train :824-1158 and
_stream_train_mf :1161-1403, each with its --distmon wiring; reference
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

``--stream-train`` (one fixed-effect coordinate) ingests the training
Avro through the block-streaming C-decoded pipeline in ``--batch-rows``
batches. Without ``--hbm-budget`` the batches assemble into the one-shot
device batch and the in-core estimator trains on it (the one-shot
driver's model, bit for bit); with ``--hbm-budget`` (bytes, as 512M or
8G) they fill a device shard cache that spills feature blocks beyond
the budget (``--spill-dtype`` f32|bf16, ``--spill-source``
buffer|redecode) and the streaming L-BFGS/TRON solves over it.
``--feeder`` picks the decode path and ``--prefetch-batches`` the
decode-ahead depth. Validation streams once for every λ of the grid.

Under ``--hbm-budget`` a batchable λ grid of more than one point
(``--grid-batched auto``, the default) or any batchable grid
(``--grid-batched on``) trains as ONE batched sweep
(``_solve_grid_batched``: every feature pass advances all G points);
``off`` sweeps one λ at a time. ``--stream-train`` of a factored random
effect trains as streamed matrix factorization (``_stream_train_mf``:
alternating ridge γ passes and streamed L-BFGS refits of B, the factor
tables in a budgeted device cache). ``--ingest-workers`` N >= 2 decodes
in a process pool (data/parallel_ingest.py).

Telemetry, as in JAX: the run resets and enables the process's
telemetry (span events recorded only under ``--trace-out``, which
writes a Chrome trace; trace sampling also under ``--obs-port``), opens
the root ``driver`` span and the phase spans, arms the flight recorder
(``--flight-events``, default 4096; ``<output-dir>/flight.json`` on a
fault or SIGTERM), serves the live plane under ``--obs-port`` with a
1 s heartbeat (``/readyz`` ready once the solve succeeded; the shard or
factor cache's ``stats()`` on ``/statusz``), judges the ``--slo``
objectives, mints one trace context per λ of a streamed solve, and
writes metrics.json's ``telemetry``, ``observability`` and ``slo``
blocks. ``--profile-output-dir`` wraps the solve (in core) or the whole
streamed training in a ``torch.profiler`` trace (utils/profiling.py).

``--distmon`` (``--stream-train`` only; ValueError otherwise) wraps the
training stream in a ``MonitoredStream``: label, offset, weight and
feature-value sketches of every decoded batch (the MF stream observes
one pass), whose ``state_sha256`` does not depend on residency, feeder
or prefetch depth; per-λ convergence rings (live from the streaming
solvers, from the histories on the resident path); training-score
sketches from the streaming solvers' final margins, or on the resident
path from one product of the assembled batch with the best model
(kernel row 9 on the card); metrics.json's ``data_quality`` block; and
``referenceDistributions`` (label and, for a fixed effect, training
scores) in the best model's model-metadata.json.

``--mesh-devices N`` (or its other spelling ``--mesh-shape Nx1``) folds
the ``--hbm-budget`` solve, scalar or batched grid, over a 1-D mesh of N
slots built from the run's ``device`` by the slot rule
(parallel/distributed.py): ``"cuda"`` takes the first N cards (fewer
raise "requested N devices, have M"), ``"cuda:K"`` N slots on card K and
``"cpu"`` N slots on the CPU. Cached shards place round-robin over the
slots, the budget binds per slot, and the fold combines in fixed shard
order, so every N writes the same model bytes. ``--mesh-shape RxC`` with
C > 1 folds it over the 2-D (data x model) mesh of R x C slots
(``make_mesh_2d`` by the same rule): the cache cuts every shard into C
column slices (``col_blocks=C``), the budget binds per slot, and the
model is the unmeshed run's bits on the card (ops/sharded_objective.py).
The log line says how many slots and how many distinct devices the run
used ("R data x C model" for a 2-D mesh), and metrics.json records
``mesh_devices`` and ``mesh_shape``. JAX's checks hold: not both
spellings, a mesh only with ``--stream-train``, a mesh of more than one
slot only with ``--hbm-budget``, no mesh for streamed MF. The
``stream_train``
block of metrics.json has no ``trace_budgets`` or ``trace_counts`` (the
JAX TracingGuard, ROADMAP A7).

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

import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.algorithm.coordinates import grid_batchable
from photon_ml_tpu_torch.cli import phase, resolve_run_device
from photon_ml_tpu_torch.cli.obs import (
    DriverObservability,
    add_observability_args,
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
from photon_ml_tpu_torch.optimization.convergence import ConvergenceRing
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils.date_range import resolve_input_dirs
from photon_ml_tpu_torch.utils.events import (
    EventEmitter,
    PhotonOptimizationLogEvent,
    TrainingFinishEvent,
    TrainingStartEvent,
)
from photon_ml_tpu_torch.utils.logging_utils import setup_photon_logger
from photon_ml_tpu_torch.utils.profiling import maybe_trace


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


def _mesh_shape(args) -> tuple | None:
    """Resolved (data, model) mesh extents: --mesh-shape RxC, or
    --mesh-devices N == Nx1; None when neither is given."""
    if args.mesh_shape is not None:
        return args.mesh_shape
    if args.mesh_devices is not None:
        return (args.mesh_devices, 1)
    return None


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
                   help="Avro decode workers: 'auto' (usable cores, the "
                        "pool only for large inputs) or a count; 1 decodes "
                        "in this process")
    p.add_argument("--feature-index-dir", default=None,
                   help="pre-built feature index stores keyed by shard id: "
                        "the reference's partitioned PalDB stores "
                        "(paldb-partition-<shard>-<N>.dat) or <shard>.json "
                        "stores; replaces the Avro-scan index pass")
    p.add_argument("--profile-output-dir", default=None,
                   help="write a torch.profiler trace of training here "
                        "(Chrome trace JSON; CUDA activity on the card)")
    p.add_argument("--save-all-models", default="false",
                   choices=["true", "false"],
                   help="model-output-mode ALL vs BEST")
    p.add_argument("--stream-train", action="store_true",
                   help="out-of-core training: ingest the training Avro "
                        "through the block-streaming C-decoded pipeline "
                        "in --batch-rows batches (host memory stays "
                        "O(batch)). Without --hbm-budget the batches "
                        "assemble into the one-shot device batch (the "
                        "one-shot driver's model); with --hbm-budget the "
                        "solve streams over a device shard cache with "
                        "replay-aware spill. One fixed-effect coordinate")
    p.add_argument("--batch-rows", type=_positive_int, default=4096,
                   help="rows per streamed ingest batch (and per cached "
                        "device shard in --hbm-budget mode)")
    p.add_argument("--hbm-budget", default=None, metavar="BYTES",
                   type=parse_byte_size,
                   help="device-memory budget for cached feature blocks "
                        "(e.g. 512M, 8G): furthest-next-use shards spill "
                        "and re-upload overlapped with the accumulate. "
                        "Selects the sharded streaming solve (L2 "
                        "LBFGS/TRON only)")
    p.add_argument("--grid-batched", choices=["auto", "on", "off"],
                   default="auto",
                   help="batch the λ₂ grid into ONE streamed sweep "
                        "(--stream-train --hbm-budget): every feature "
                        "pass advances all G grid points. 'auto' batches "
                        "a batchable grid of more than one point; 'off' "
                        "sweeps the grid one λ at a time")
    p.add_argument("--mesh-devices", type=_positive_int, default=None,
                   metavar="N",
                   help="fold the --hbm-budget streaming solve over a "
                        "1-D mesh of N slots: the first N cards, or N "
                        "slots of one card when the run's device names "
                        "it (cuda:K). Cached shards place round-robin "
                        "(shard i on slot i mod N), per-shard partials "
                        "accumulate on their own device, and the fold "
                        "combines in fixed shard order: every N writes "
                        "the same model. Requires --stream-train; N > 1 "
                        "also --hbm-budget. Equivalent to --mesh-shape "
                        "Nx1")
    p.add_argument("--mesh-shape", type=_parse_mesh_shape, default=None,
                   metavar="RxC",
                   help="fold the --hbm-budget streaming solve over a "
                        "2-D (data x model) mesh of R x C slots: cached "
                        "shards place round-robin over the R data rows "
                        "AND split into C column blocks of the "
                        "coefficient dimension, one per model-axis slot; "
                        "Nx1 is --mesh-devices N. Requires --stream-train; "
                        "R*C > 1 also --hbm-budget")
    p.add_argument("--spill-dtype", choices=["f32", "bf16"], default="f32",
                   help="--hbm-budget spill encoding: 'f32' spills the "
                        "raw triplet (re-uploads are the evicted bytes); "
                        "'bf16' spills bfloat16 values and delta-coded "
                        "indices, decoded on the device")
    p.add_argument("--spill-source", choices=["buffer", "redecode"],
                   default="buffer",
                   help="where evicted --hbm-budget blocks come back "
                        "from: 'buffer' re-uploads host spill buffers; "
                        "'redecode' keeps no host copy and re-decodes "
                        "the covering Avro blocks")
    p.add_argument("--feeder", choices=["auto", "native", "python"],
                   default="auto",
                   help="--stream-train decode path: 'native' the C "
                        "block decoder, 'python' the record loop over "
                        "the pure-Python codec (byte-identical), 'auto' "
                        "C where every schema fits")
    p.add_argument("--prefetch-batches", type=int, default=2,
                   help="decode-ahead depth of the --stream-train feeder "
                        "(and spill re-upload look-ahead); 0 disables")
    p.add_argument("--distmon", action="store_true",
                   help="distribution observability (--stream-train "
                        "only): label/weight/offset/feature sketches of "
                        "every decoded batch (no extra feature pass; "
                        "state independent of residency, feeder and "
                        "prefetch), per-λ convergence rings, a "
                        "data_quality metrics.json block, live /distz "
                        "(with --obs-port), and reference distributions "
                        "(label and training-score quantiles) written "
                        "into the model for serving-side drift scoring")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write a Chrome trace-event JSON of the run's "
                        "pipeline spans (one track a thread; load in "
                        "Perfetto)")
    p.add_argument("--job-name", default="photon-game-training",
                   help="job name carried on Training{Start,Finish} "
                        "events")
    p.add_argument("--event-listeners", default=None,
                   help="comma-separated EventListener class paths "
                        "registered by name (utils/events.py)")
    add_observability_args(p)
    return p


def _check_flags(args) -> None:
    """The JAX driver's flag checks that need no data (_run_training
    :458-505), then the paths of later queue items: run before anything
    is written."""
    if args.mesh_shape is not None and args.mesh_devices is not None:
        raise ValueError(
            "--mesh-shape and --mesh-devices are two spellings of the "
            "same mesh (--mesh-devices N == --mesh-shape Nx1); pass one")
    mesh_rc = _mesh_shape(args)
    if mesh_rc is not None and not args.stream_train:
        raise ValueError(
            "--mesh-devices/--mesh-shape apply to the --stream-train "
            "solve; pass --stream-train (and --hbm-budget for a mesh "
            "of > 1 device)")
    if mesh_rc is not None and mesh_rc[0] * mesh_rc[1] > 1 \
            and args.hbm_budget is None:
        raise ValueError(
            "a mesh of > 1 device requires --hbm-budget: the device "
            "fold runs over the sharded shard-cache solve (the "
            "resident assembled path is a single fused device batch)")
    if args.grid_batched != "auto" and not args.stream_train:
        raise ValueError(
            "--grid-batched applies to the --stream-train λ-grid "
            "sweep; pass --stream-train (the one-shot estimator "
            "trains the grid one combination at a time)")
    if args.grid_batched == "on" and args.hbm_budget is None:
        raise ValueError(
            "--grid-batched on requires --hbm-budget: the batched "
            "sweep runs over the sharded shard-cache solve (the "
            "resident assembled path reuses the fused one-shot "
            "solvers, which already share the device batch across "
            "the grid)")
    if args.spill_dtype != "f32" and args.hbm_budget is None:
        raise ValueError(
            "--spill-dtype applies to --hbm-budget spill buffers; pass "
            "--stream-train --hbm-budget (the resident assembled path "
            "never spills)")
    if args.spill_source != "buffer" and args.hbm_budget is None:
        raise ValueError(
            "--spill-source applies to --hbm-budget eviction; pass "
            "--stream-train --hbm-budget (the resident assembled path "
            "never evicts)")
    if args.spill_source == "redecode" and args.spill_dtype != "f32":
        raise ValueError(
            "--spill-dtype bf16 compresses host spill buffers, but "
            "--spill-source redecode keeps none — the combination "
            "would silently train as f32; pick one")
    if args.distmon and not args.stream_train:
        raise ValueError(
            "--distmon piggybacks distribution sketches on the "
            "--stream-train decode pass; pass --stream-train (the "
            "one-shot path has data/stats.py BasicStatisticalSummary "
            "for one-shot statistics)")
    if not args.stream_train:
        return
    fe_data = _parse_named(args.fixed_effect_data_configurations,
                           "fixed-effect data config")
    fre_data = _parse_named(
        args.factored_random_effect_data_configurations,
        "factored-random-effect data config")
    sequence = [s.strip() for s in args.updating_sequence.split(",")]
    if args.random_effect_data_configurations or len(sequence) != 1 \
            or (sequence[0] not in fe_data
                and sequence[0] not in fre_data):
        raise ValueError(
            "--stream-train supports exactly one fixed-effect "
            "or factored-random-effect coordinate (plain random "
            "effects need entity grouping over the full dataset); "
            f"got sequence {sequence}")
    if sequence[0] in fre_data and mesh_rc is not None:
        raise ValueError(
            "--mesh-devices/--mesh-shape are not supported for "
            "streamed MF coordinates yet (the factor-table device "
            "fold is the noted follow-on); drop the flag")
    if sequence[0] in fre_data or args.hbm_budget is None:
        return
    table = _parse_named(args.fixed_effect_optimization_configurations,
                         "fixed-effect optimization config")
    grid = [GLMOptimizationConfiguration.parse(part)
            for part in table.get(sequence[0], "").split("|") if part]
    batchable, why_not = grid_batchable(grid)
    if args.grid_batched == "on" and not batchable:
        raise ValueError(
            f"--grid-batched on: λ-grid is not batchable: {why_not}")


def run(argv=None, *, device="cuda", dtype=None) -> dict:
    """Train and save; returns the metrics.json summary."""
    dev, dtype = resolve_run_device(device, dtype)
    args = build_parser().parse_args(argv)
    _check_flags(args)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = setup_photon_logger(out_dir)
    task = TaskType(args.task_type)
    t0 = time.perf_counter()
    # The driver owns this process's telemetry: per-run metrics and
    # stage spans land in metrics.json (and --trace-out).
    telemetry.reset()
    # Trace sampling is on whenever something consumes traces: a
    # --trace-out export, or the live plane's /tracez.
    telemetry.enable(trace=bool(args.trace_out)
                     or args.obs_port is not None)
    obs = None
    emitter = EventEmitter()
    try:
        # Built inside the try: a bad --slo spec or an occupied
        # --obs-port still unwinds through the finally below. The 1 s
        # heartbeat keeps liveness gauges, registry deltas and SLO burn
        # fresh between solver iterations.
        obs = DriverObservability(args, out_dir, heartbeat_s=1.0,
                                  role="training").start()
        for cp in (args.event_listeners or "").split(","):
            if cp.strip():
                emitter.register_listener_by_name(cp.strip())
        emitter.send_event(TrainingStartEvent(args.job_name))
        # Root span: the glue between the named phases lands in its
        # self time, so the stage table sums to the whole run.
        with telemetry.span("driver"):
            (sequence, results, best_configs, best_result, shard_maps,
             num_rows, stream_info, distmon_out) = _run_training(
                args, logger, task, dev, dtype, emitter, obs)
            # /readyz turns 200 only after the solve succeeded.
            obs.mark_ready("solve_complete")
            _save_outputs(args, out_dir, logger, sequence, results,
                          best_configs, best_result, shard_maps,
                          extra_metadata=(
                              {"referenceDistributions":
                               distmon_out["reference"]}
                              if distmon_out is not None else None))
        summary = _write_summary(args, out_dir, logger, task, sequence,
                                 t0, results, best_configs, best_result,
                                 num_rows, stream_info, obs,
                                 data_quality=(
                                     distmon_out["data_quality"]
                                     if distmon_out is not None
                                     else None))
        emitter.send_event(
            TrainingFinishEvent(args.job_name, summary["totalSeconds"]))
        return summary
    except BaseException as e:
        # The phase spans have unwound: the flight ring's last events
        # cover the failing stage.
        if obs is not None:
            obs.dump_fault(e, logger)
        raise
    finally:
        emitter.clear_listeners()
        if obs is not None:
            obs.stop()
        telemetry.disable()


def _run_training(args, logger, task, device, dtype, emitter, obs):
    """Config parse + train (the in-core estimator or --stream-train);
    returns what the save and summary need. ``obs`` lets the streamed
    paths register their live providers as their components come up."""
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

    if args.stream_train:
        with maybe_trace(args.profile_output_dir, device):
            if sequence[0] in fre_data:
                (results, best_configs, best_result, shard_maps, num_rows,
                 stream_info, distmon_out) = _stream_train_mf(
                    args, logger, task, fre_data, fre_opt, sequence,
                    train_inputs, evaluators, preloaded_maps, emitter,
                    obs, device, dtype)
            else:
                (results, best_configs, best_result, shard_maps, num_rows,
                 stream_info, distmon_out) = _stream_train(
                    args, logger, task, fe_data, fe_opt, sequence,
                    train_inputs, evaluators, preloaded_maps, opt_grid,
                    emitter, obs, device, dtype)
        return (sequence, results, best_configs, best_result, shard_maps,
                num_rows, stream_info, distmon_out)

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
    with maybe_trace(args.profile_output_dir, device), \
            phase(logger, "solve"):
        results = estimator.fit(
            data, validation_data=validation,
            checkpoint_dir=(Path(args.checkpoint_dir)
                            if args.checkpoint_dir else None),
            checkpoint_interval=args.checkpoint_interval)
    best_configs, best_result = estimator.select_best(results)
    return (sequence, results, best_configs, best_result, shard_maps,
            int(data.num_rows), None, None)


def _stream_validate_many(game_models, args, shard_maps, evaluators,
                          logger, device, dtype):
    """Bounded-memory validation of ALL grid models in ONE decode pass:
    the validation container streams once (`BlockGameStream`,
    `--batch-rows` batches) and every model's scorer scores each decoded
    batch, keeping ONLY the evaluation columns
    (`StreamedEvalAccumulator`) — never features. An empty validation
    input gives empty metric maps."""
    from photon_ml_tpu_torch.data.block_stream import BlockGameStream
    from photon_ml_tpu_torch.evaluation.validation import (
        StreamedEvalAccumulator,
    )
    from photon_ml_tpu_torch.serving.engine import StreamingGameScorer

    validate_inputs = resolve_input_dirs(
        args.validate_input_dirs,
        date_range=args.validate_date_range,
        date_range_days_ago=args.validate_date_range_days_ago)
    # The models' entity columns too: the JAX driver reads only the
    # evaluators' and fails on a streamed factored model's validation
    # (ROADMAP §C).
    id_types = sorted({ev.id_type for ev in evaluators
                       if getattr(ev, "id_type", None)}
                      | {m.random_effect_type for gm in game_models
                         for m in gm.models.values()
                         if getattr(m, "random_effect_type", None)})
    engines = [StreamingGameScorer(m, dtype=dtype, device=device)
               for m in game_models]
    accs = [StreamedEvalAccumulator(id_types) for _ in game_models]
    stream = BlockGameStream(
        validate_inputs, id_types=id_types, feature_shard_maps=shard_maps,
        batch_rows=args.batch_rows, feeder=args.feeder,
        prefetch_depth=max(0, args.prefetch_batches))
    for ds in stream:
        for engine, acc in zip(engines, accs):
            acc.add(ds, engine.score(ds))
    metrics = [acc.metrics(evaluators) for acc in accs]
    logger.info("streamed validation (%d rows, %s feeder, %d models): %s",
                stream.rows, stream.decode_path, len(engines), metrics)
    return metrics


def _solve_grid_batched(args, logger, name, shard, task, grid, cache,
                        dtype, mesh, monitor, lam_label):
    """--grid-batched sweep: ONE StreamingFixedEffectCoordinate hosts the
    whole λ grid and ``solve_fixed_effect_grid`` advances all G points
    per feature pass over the shard cache. Observability stays per λ:
    each grid point keeps its trace context, its --distmon convergence
    ring and its training-score sketch (sliced from the batched
    ``[G, rows]`` margins). Returns the (configs,
    CoordinateDescentResult) pairs the sequential sweep builds, every
    point with the sweep's shared wall time, and the shared sharded
    objective."""
    from photon_ml_tpu_torch.algorithm.coordinate_descent import (
        CoordinateDescentResult,
    )
    from photon_ml_tpu_torch.algorithm.coordinates import (
        StreamingFixedEffectCoordinate,
        solve_fixed_effect_grid,
    )
    from photon_ml_tpu_torch.models.game_model import GameModel

    G = len(grid)
    logger.info("λ-grid sweep batched: %d points advance per feature "
                "pass (--grid-batched %s)", G, args.grid_batched)
    coord = StreamingFixedEffectCoordinate(
        name=name, cache=cache, feature_shard_id=shard, task_type=task,
        config=grid[0], dtype=dtype, mesh=mesh)
    t0 = time.perf_counter()
    rings, margins_holder = None, []
    if monitor is not None:
        rings = []
        for cfg in grid:
            ring = ConvergenceRing()
            monitor.add_ring(lam_label(cfg), ring)
            rings.append(ring)
    # One trace context per grid point, as the sequential sweep mints
    # them: a row's divergence fault carries its own trace id.
    ctxs = []
    for gi, cfg in enumerate(grid):
        ctx = telemetry.mint("solve")
        ctx.annotate(coordinate=name,
                     reg_weight=cfg.regularization_weight,
                     optimizer=str(cfg.optimizer_type),
                     grid_row=gi, grid_width=G)
        ctxs.append(ctx)
    models = None
    trackers_per = [[] for _ in grid]
    obj_hist_per = [[] for _ in grid]
    for _ in range(args.num_iterations):
        pairs = solve_fixed_effect_grid(
            coord, grid, models=models, trace_ctxs=ctxs,
            convergence_rings=rings, margins_out=margins_holder)
        models = [m for m, _ in pairs]
        for gi, (_, res) in enumerate(pairs):
            trackers_per[gi].append(res)
            obj_hist_per[gi].append(float(res.value))
    shared = coord.sharded_objective
    if monitor is not None and margins_holder:
        for gi, cfg in enumerate(grid):
            monitor.observe_scores(
                lam_label(cfg),
                shared.host_scores_from_margins(
                    shared.grid_row_margins(margins_holder, gi)))
    elapsed = time.perf_counter() - t0
    results = []
    for gi, cfg in enumerate(grid):
        ctxs[gi].annotate(
            iterations=int(trackers_per[gi][-1].iterations),
            reason=trackers_per[gi][-1].reason_enum().summary)
        ctxs[gi].finish("ok")
        gm = GameModel({name: models[gi]}, task)
        results.append(({name: cfg}, CoordinateDescentResult(
            model=gm, objective_history=obj_hist_per[gi],
            validation_history=[], best_model=gm, best_metric=None,
            trackers={name: trackers_per[gi]}, updates=[],
            timings={name: elapsed})))
    return results, shared


def _stream_train(args, logger, task, fe_data, fe_opt, sequence,
                  train_inputs, evaluators, preloaded_maps, opt_grid,
                  emitter, obs, device, dtype):
    """Out-of-core training (--stream-train): block-streamed ingest (host
    memory O(batch_rows)) into either

    - the one-shot device batch, assembled exactly, and the in-core
      estimator (no --hbm-budget; the one-shot driver's model), or
    - a DeviceShardCache and the streaming solve over it, one λ at a time
      (--hbm-budget; deterministic partials, so resident and
      eviction-forced runs write the same model).

    Validation (when asked for) streams through the scorer in both
    modes. With --distmon the training stream is a ``MonitoredStream``
    and the returned ``distmon_out`` holds the ``data_quality`` block
    and the model's ``referenceDistributions``; it is None otherwise."""
    from photon_ml_tpu_torch.algorithm.coordinate_descent import (
        CoordinateDescentResult,
    )
    from photon_ml_tpu_torch.algorithm.coordinates import (
        StreamingFixedEffectCoordinate,
    )
    from photon_ml_tpu_torch.data.avro_reader import build_index_map
    from photon_ml_tpu_torch.data.block_stream import (
        BlockGameStream,
        BlockRandomAccess,
    )
    from photon_ml_tpu_torch.data.shard_cache import (
        DeviceShardCache,
        assemble_fixed_effect_batch,
    )
    from photon_ml_tpu_torch.estimators.game_estimator import (
        select_best_result,
    )
    from photon_ml_tpu_torch.models.game_model import GameModel

    name = sequence[0]
    shard = fe_data[name]
    grid = opt_grid(fe_opt, name,
                    "--fixed-effect-optimization-configurations")
    if preloaded_maps is not None:
        if shard not in preloaded_maps:
            raise ValueError(
                f"fixed-effect coordinate {name!r} references unknown "
                f"feature shard {shard!r} "
                f"(have {sorted(preloaded_maps)})")
        shard_maps = {shard: preloaded_maps[shard]}
    else:
        logger.info("building feature index for shard %r from %s",
                    shard, train_inputs)
        with phase(logger, "build_index"):
            shard_maps = {shard: build_index_map(
                train_inputs, ingest_workers=args.ingest_workers)}

    monitor = None
    if args.distmon:
        from photon_ml_tpu_torch.data.distmon import (
            MonitoredStream,
            StreamingDistributionMonitor,
        )

        # The sketches ride the decode pass: every batch the stream
        # yields is observed on its way to the cache or the assembler
        # (on the prefetch thread when the feeder prefetches), so they
        # cost no feature pass and their state is fixed by shard order.
        monitor = StreamingDistributionMonitor(feature_shards=[shard])
        obs.add_dist_provider("training", monitor.snapshot)
        obs.add_scrape_hook("distmon", monitor.publish_gauges)
        obs.add_sketch_provider("training", monitor.sketch_states)

    def make_stream():
        s = BlockGameStream(
            train_inputs, id_types=[], feature_shard_maps=shard_maps,
            batch_rows=args.batch_rows, feeder=args.feeder,
            prefetch_depth=max(0, args.prefetch_batches))
        return s if monitor is None else MonitoredStream(s, monitor)

    def lam_label(cfg):
        return f"{name}:l2={cfg.regularization_weight:g}"

    budget = args.hbm_budget  # parsed to bytes by argparse
    if args.checkpoint_dir and budget is not None:
        logger.warning("--checkpoint-dir is not supported with "
                       "--hbm-budget streaming solves; ignoring")

    if budget is None:
        # -- resident: exact assembly + the one-shot estimator ------------
        logger.info("stream-train (resident): assembling %r from %s in "
                    "%d-row batches", shard, train_inputs, args.batch_rows)
        with phase(logger, "ingest"):
            data = assemble_fixed_effect_batch(make_stream(), shard,
                                               dtype=dtype, device=device)
        estimator = GameEstimator(
            task_type=task,
            coordinate_specs=[FixedEffectSpec(
                name=name, feature_shard_id=shard, configs=grid)],
            num_iterations=args.num_iterations,
            validation_evaluators=evaluators, dtype=dtype, device=device)
        # One trace context per grid point spanning the shared fit.
        ctxs = [telemetry.mint("solve") for _ in grid]
        for ctx, cfg in zip(ctxs, grid):
            ctx.annotate(coordinate=name, mode="resident",
                         reg_weight=cfg.regularization_weight,
                         optimizer=str(cfg.optimizer_type),
                         grid_points=len(grid))
        with phase(logger, "solve"):
            results = estimator.fit(
                data, validation_data=None,
                checkpoint_dir=(Path(args.checkpoint_dir)
                                if args.checkpoint_dir else None),
                checkpoint_interval=args.checkpoint_interval)
        for ctx in ctxs:
            ctx.finish("ok")
        num_rows = data.num_rows
        stream_info = {
            "mode": "resident-assembled",
            "batch_rows": args.batch_rows,
            "hbm_budget_bytes": None,
            "mesh_devices": args.mesh_devices,
            "mesh_shape": _mesh_shape(args),
            "spill_dtype": None,  # nothing spills on the resident path
            "spill_source": None,
            "feeder": dict(data.ingest_stats),
            "cache": None,
            "grid_batched": False,
            "grid_points": len(grid),
        }
    else:
        # -- spill: sharded streaming accumulate over the device cache ----
        mesh, devices, col_blocks = None, None, 1
        mesh_rc = _mesh_shape(args)
        if mesh_rc is not None and mesh_rc[0] * mesh_rc[1] > 1:
            from photon_ml_tpu_torch.parallel import (
                make_mesh,
                make_mesh_2d,
                mesh_fold_devices,
            )

            col_blocks = mesh_rc[1]
            mesh = (make_mesh(mesh_rc[0], device=device) if col_blocks == 1
                    else make_mesh_2d(*mesh_rc, device=device))
            devices = mesh_fold_devices(mesh)
        logger.info("stream-train (spill, hbm budget %d bytes%s, spill "
                    "%s/%s): caching %r from %s in %d-row shards", budget,
                    (f" PER SLOT x {mesh.describe()}"
                     + (f" ({mesh_rc[0]} data x {mesh_rc[1]} model)"
                        if col_blocks > 1 else "") if mesh else ""),
                    args.spill_dtype, args.spill_source, shard,
                    train_inputs, args.batch_rows)
        logger.info("streamed solves run as host loops over the shard "
                    "cache, not as fused update graphs (ROADMAP A3b)")
        fetcher = None
        if args.spill_source == "redecode":
            # Misses re-decode their covering container blocks by global
            # row range instead of re-uploading host spill buffers.
            fetcher = BlockRandomAccess(
                train_inputs, id_types=[], feature_shard_maps=shard_maps,
                feeder=args.feeder)
        with phase(logger, "ingest"):
            cache = DeviceShardCache.from_stream(
                make_stream(), shard, dtype=dtype, hbm_budget_bytes=budget,
                prefetch_depth=max(0, args.prefetch_batches),
                devices=devices, spill_dtype=args.spill_dtype,
                spill_source=args.spill_source, redecode_fetch=fetcher,
                col_blocks=col_blocks, device=device)
        # Live residency view on /statusz: hits, misses, evictions and
        # spill bytes as they happen.
        obs.add_status_provider("shard_cache", cache.stats)
        results = []
        shared = None
        batchable, why_not = grid_batchable(grid)
        use_batched = batchable and (
            args.grid_batched == "on"
            or (args.grid_batched == "auto" and len(grid) > 1))
        if args.grid_batched == "auto" and len(grid) > 1 and not batchable:
            logger.info("λ-grid sweeps sequentially (%s)", why_not)
        with phase(logger, "solve"):
            if use_batched:
                results, shared = _solve_grid_batched(
                    args, logger, name, shard, task, grid, cache, dtype,
                    mesh, monitor, lam_label)
            for cfg in (() if use_batched else grid):
                coord = StreamingFixedEffectCoordinate(
                    name=name, cache=cache, feature_shard_id=shard,
                    task_type=task, config=cfg, dtype=dtype,
                    sharded_objective=shared, mesh=mesh)
                shared = coord.sharded_objective
                t0 = time.perf_counter()
                model, trackers, obj_hist = None, [], []
                # --distmon hooks: a live per-λ convergence ring and the
                # solver's final margins, from which the training scores
                # are sketched without a scoring pass.
                ring, margins_holder = None, None
                if monitor is not None:
                    ring = ConvergenceRing()
                    monitor.add_ring(lam_label(cfg), ring)
                    margins_holder = []
                # One trace context per λ: the solve's identity across
                # its outer iterations; a divergence fault carries it.
                ctx = telemetry.mint("solve")
                ctx.annotate(coordinate=name,
                             reg_weight=cfg.regularization_weight,
                             optimizer=str(cfg.optimizer_type))
                for _ in range(args.num_iterations):
                    model, res = coord.solve(
                        model, trace_ctx=ctx, convergence_ring=ring,
                        margins_out=margins_holder)
                    trackers.append(res)
                    obj_hist.append(float(res.value))
                if monitor is not None and margins_holder:
                    monitor.observe_scores(
                        lam_label(cfg),
                        shared.host_scores_from_margins(margins_holder))
                ctx.annotate(
                    iterations=int(trackers[-1].iterations),
                    reason=trackers[-1].reason_enum().summary)
                ctx.finish("ok")
                gm = GameModel({name: model}, task)
                results.append(({name: cfg}, CoordinateDescentResult(
                    model=gm, objective_history=obj_hist,
                    validation_history=[], best_model=gm,
                    best_metric=None, trackers={name: trackers},
                    updates=[],
                    timings={name: time.perf_counter() - t0})))
        num_rows = cache.n_rows
        stream_info = {
            "mode": "spill",
            "batch_rows": args.batch_rows,
            "hbm_budget_bytes": budget,
            "mesh_devices": args.mesh_devices,
            "mesh_shape": mesh_rc,
            "spill_dtype": args.spill_dtype,
            "spill_source": args.spill_source,
            "feeder": cache.ingest_stats,
            "cache": cache.stats(),
            "grid_batched": use_batched,
            "grid_points": len(grid),
        }
        if fetcher is not None:
            stream_info["redecode"] = {
                "decode_path": fetcher.decode_path,
                "payload_bytes_read": fetcher.payload_bytes_read,
                "blocks_decoded": fetcher.blocks_decoded,
                "rows_fetched": fetcher.rows_fetched,
            }

    if args.validate_input_dirs and evaluators:
        with phase(logger, "validate"):
            all_metrics = _stream_validate_many(
                [res.model for _, res in results], args, shard_maps,
                evaluators, logger, device, dtype)
        for (_, res), metrics in zip(results, all_metrics):
            res.validation_history.append(metrics)

    # Per-λ optimization events, as the GLM driver emits per model.
    for configs, res in results:
        cfg = configs[name]
        trk = list(res.trackers.get(name) or [])
        last = trk[-1] if trk else None
        emitter.send_event(PhotonOptimizationLogEvent(
            reg_weight=cfg.regularization_weight,
            iterations=(int(last.iterations) if last is not None else 0),
            converged_reason=(last.reason_enum().summary
                              if last is not None else "unknown"),
            final_value=(float(last.value) if last is not None
                         else float("nan")),
            metrics=(res.validation_history[-1]
                     if res.validation_history else None)))

    best_configs, best_result = select_best_result(results, evaluators)

    distmon_out = None
    if monitor is not None:
        best_label = lam_label(best_configs[name])
        if budget is None:
            # Resident path: the in-core solvers ran, so the rings fill
            # from every solve's history, and the best model's training
            # scores come from ONE product over the assembled device
            # batch (no decode pass; kernel row 9 on the card), copied
            # to the host once.
            for configs, res in results:
                for trk in res.trackers.get(name) or []:
                    monitor.ring_from_history(
                        lam_label(configs[name]),
                        trk.value_history.cpu().numpy(),
                        trk.grad_norm_history.cpu().numpy())
            batch = data.fixed_effect_batch(shard)
            fe_model = best_result.best_model.models[name]
            w = torch.as_tensor(fe_model.glm.coefficients.means,
                                dtype=batch.labels.dtype,
                                device=batch.labels.device)
            monitor.observe_scores(
                best_label, batch.features.matvec(w).cpu().numpy())
        monitor.publish_gauges()
        distmon_out = {
            "data_quality": monitor.data_quality_block(),
            "reference": monitor.reference(score_label=best_label),
        }
    return (results, best_configs, best_result, shard_maps, num_rows,
            stream_info, distmon_out)


def _stream_train_mf(args, logger, task, fre_data, fre_opt, sequence,
                     train_inputs, evaluators, preloaded_maps, emitter,
                     obs, device, dtype):
    """Out-of-core matrix factorization (--stream-train of a factored
    random effect; port of the JAX driver's _stream_train_mf
    :1161-1403): observations stream through ``BlockGameStream``,
    re-decoded every feature pass; the factor tables live in a budgeted
    ``DeviceFactorCache`` (--hbm-budget, --spill-dtype, --spill-source);
    each alternating sweep is a streamed ridge γ pass and a streamed
    L-BFGS refit of B. λ-grid points with the same num_factors share one
    objective. Each λ mints a trace context; the factor cache's stats()
    is a live /statusz provider. With --distmon the first stream (one
    full pass) is observed, so every row counts once; the reference
    holds the label only (MF has no cheap training-score surface)."""
    from photon_ml_tpu_torch.algorithm.coordinate_descent import (
        CoordinateDescentResult,
    )
    from photon_ml_tpu_torch.algorithm.coordinates import (
        StreamingFactoredRandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.data.avro_reader import build_index_map
    from photon_ml_tpu_torch.data.block_stream import (
        BlockGameStream,
        BlockRandomAccess,
    )
    from photon_ml_tpu_torch.estimators.game_estimator import (
        select_best_result,
    )
    from photon_ml_tpu_torch.models.game_model import GameModel

    name = sequence[0]
    data_cfg = fre_data[name]
    shard = data_cfg.feature_shard_id
    re_type = data_cfg.random_effect_type
    if name not in fre_opt:
        raise ValueError(
            f"coordinate {name!r} has no optimization configuration — "
            "pass it via "
            "--factored-random-effect-optimization-configurations")
    grid = [FactoredRandomEffectOptimizationConfiguration.parse(part)
            for part in fre_opt[name].split("|")]
    if preloaded_maps is not None:
        if shard not in preloaded_maps:
            raise ValueError(
                f"factored coordinate {name!r} references unknown "
                f"feature shard {shard!r} (have {sorted(preloaded_maps)})")
        shard_maps = {shard: preloaded_maps[shard]}
    else:
        logger.info("building feature index for shard %r from %s",
                    shard, train_inputs)
        with phase(logger, "build_index"):
            shard_maps = {shard: build_index_map(
                train_inputs, ingest_workers=args.ingest_workers)}

    streams = []
    monitor = None
    if args.distmon:
        from photon_ml_tpu_torch.data.distmon import (
            MonitoredStream,
            StreamingDistributionMonitor,
        )

        # MF re-decodes the observations every feature pass, each pass
        # the same bytes: the monitor observes the first pass only.
        monitor = StreamingDistributionMonitor(
            feature_shards=[shard], id_types=[re_type])
        obs.add_dist_provider("training", monitor.snapshot)
        obs.add_scrape_hook("distmon", monitor.publish_gauges)
        obs.add_sketch_provider("training", monitor.sketch_states)

    def make_stream():
        s = BlockGameStream(
            train_inputs, id_types=[re_type], feature_shard_maps=shard_maps,
            batch_rows=args.batch_rows, feeder=args.feeder,
            prefetch_depth=max(0, args.prefetch_batches))
        first = not streams
        streams[:] = [s]
        if monitor is not None and first:
            return MonitoredStream(s, monitor, max_passes=1)
        return s

    budget = args.hbm_budget
    if args.checkpoint_dir:
        logger.warning("--checkpoint-dir is not supported with "
                       "--stream-train MF coordinates; ignoring")
    fetcher = None
    if budget is not None and args.spill_source == "redecode":
        # Factor-shard misses re-derive from the covering observation
        # batches, re-decoded by global row range.
        fetcher = BlockRandomAccess(
            train_inputs, id_types=[re_type], feature_shard_maps=shard_maps,
            feeder=args.feeder)
    logger.info(
        "stream-train (mf%s): %r over %r entities from %s in %d-row "
        "batches", "" if budget is None else
        f", hbm budget {budget} bytes, spill {args.spill_dtype}/"
        f"{args.spill_source}", name, re_type, train_inputs,
        args.batch_rows)
    logger.info("streamed solves run as host loops over the factor "
                "cache, not as fused update graphs (ROADMAP A3b)")

    shared = {}  # num_factors -> StreamedMFObjective
    results = []

    def factor_cache_status():
        # Reads through the shared-objective table, so a grid over
        # several num_factors values (several caches) stays observable.
        if len(shared) == 1:
            return next(iter(shared.values())).cache.stats()
        return {f"num_factors_{k}": o.cache.stats()
                for k, o in sorted(shared.items())}

    with phase(logger, "solve"):
        for cfg in grid:
            coord = StreamingFactoredRandomEffectCoordinate(
                name=name, make_stream=make_stream, feature_shard_id=shard,
                random_effect_type=re_type, task_type=task,
                config=cfg.random_effect, latent_config=cfg.latent_factor,
                mf_config=cfg.mf,
                # seed 0: GameEstimator.fit's default, so B0 is the
                # in-core driver's.
                seed=0, hbm_budget_bytes=budget,
                spill_dtype=(args.spill_dtype if budget is not None
                             else "f32"),
                spill_source=(args.spill_source if budget is not None
                              else "buffer"),
                mf_objective=shared.get(cfg.mf.num_factors),
                random_access=fetcher, dtype=dtype, device=device)
            if not shared:
                obs.add_status_provider("factor_cache", factor_cache_status)
            shared[cfg.mf.num_factors] = coord.mf_objective
            t0 = time.perf_counter()
            model, trackers, obj_hist = None, [], []
            ctx = telemetry.mint("solve")
            ctx.annotate(coordinate=name,
                         reg_weight=cfg.random_effect.regularization_weight,
                         num_factors=cfg.mf.num_factors,
                         mf_sweeps=cfg.mf.max_iterations)
            for _ in range(args.num_iterations):
                model, sweep_trackers = coord.solve(model, trace_ctx=ctx)
                trackers.extend(sweep_trackers)
                obj_hist.append(float(sweep_trackers[-1].value))
            ctx.annotate(
                iterations=int(trackers[-1].iterations),
                reason=trackers[-1].reason_enum().summary)
            ctx.finish("ok")
            gm = GameModel({name: model}, task)
            results.append(({name: cfg}, CoordinateDescentResult(
                model=gm, objective_history=obj_hist,
                validation_history=[], best_model=gm, best_metric=None,
                trackers={name: trackers}, updates=[],
                timings={name: time.perf_counter() - t0})))

    first = next(iter(shared.values()))
    stream_info = {
        "mode": "mf-stream",
        "batch_rows": args.batch_rows,
        "hbm_budget_bytes": budget,
        "mesh_devices": None,
        "mesh_shape": None,
        "spill_dtype": args.spill_dtype if budget is not None else None,
        "spill_source": (args.spill_source if budget is not None
                         else None),
        "feeder": streams[0].stats() if streams else None,
        "cache": first.cache.stats(),
        "plan": {
            "entities": first.plan.num_entities,
            "shards": first.plan.n_shards,
            "obs_bucket_histogram": {
                str(k): v for k, v in sorted(
                    first.plan.obs_bucket_histogram().items())},
        },
    }
    if len(shared) > 1:
        stream_info["cache_by_num_factors"] = {
            str(k): o.cache.stats() for k, o in sorted(shared.items())}
    if fetcher is not None:
        stream_info["redecode"] = {
            "decode_path": fetcher.decode_path,
            "payload_bytes_read": fetcher.payload_bytes_read,
            "blocks_decoded": fetcher.blocks_decoded,
            "rows_fetched": fetcher.rows_fetched,
        }

    if args.validate_input_dirs and evaluators:
        with phase(logger, "validate"):
            all_metrics = _stream_validate_many(
                [res.model for _, res in results], args, shard_maps,
                evaluators, logger, device, dtype)
        for (_, res), metrics in zip(results, all_metrics):
            res.validation_history.append(metrics)

    for configs, res in results:
        cfg = configs[name]
        trk = list(res.trackers.get(name) or [])
        last = trk[-1] if trk else None
        emitter.send_event(PhotonOptimizationLogEvent(
            reg_weight=cfg.random_effect.regularization_weight,
            iterations=(int(last.iterations) if last is not None else 0),
            converged_reason=(last.reason_enum().summary
                              if last is not None else "unknown"),
            final_value=(float(last.value) if last is not None
                         else float("nan")),
            metrics=(res.validation_history[-1]
                     if res.validation_history else None)))

    best_configs, best_result = select_best_result(results, evaluators)

    distmon_out = None
    if monitor is not None:
        monitor.publish_gauges()
        distmon_out = {
            "data_quality": monitor.data_quality_block(),
            "reference": monitor.reference(),
        }
    return (results, best_configs, best_result, shard_maps, first.n_rows,
            stream_info, distmon_out)


def _save_outputs(args, out_dir, logger, sequence, results,
                  best_configs, best_result, shard_maps,
                  extra_metadata=None) -> None:
    """Model + index-map save (the ``finalize`` phase).
    ``extra_metadata`` merges keys into model-metadata.json (the
    --distmon ``referenceDistributions``)."""
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
                **(extra_metadata or {}),
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


def _write_summary(args, out_dir, logger, task, sequence, t0, results,
                   best_configs, best_result, num_rows, stream_info,
                   obs, data_quality=None) -> dict:
    """metrics.json (the JAX keys; the ``stream_train`` block of a
    --stream-train run) and the --trace-out export. Runs after the root
    ``driver`` span closed, so the telemetry block includes its self
    time."""
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
    if stream_info is not None:
        summary["stream_train"] = stream_info
    if data_quality is not None:
        # --distmon: sketch summaries, per-λ convergence tails and the
        # canonical state hash.
        summary["data_quality"] = data_quality
    obs.finish(summary)
    summary["telemetry"] = telemetry.attribution_summary(wall)
    if args.trace_out:
        telemetry.export_chrome_trace(args.trace_out)
        logger.info("pipeline trace written to %s (load in Perfetto)",
                    args.trace_out)
    (out_dir / "metrics.json").write_text(json.dumps(summary, indent=2))
    logger.info("GAME training done in %.1fs", summary["totalSeconds"])
    return summary


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
