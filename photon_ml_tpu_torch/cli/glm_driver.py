"""GLM training driver (port of photon_ml_tpu/cli/glm_driver.py:
build_parser :68-140, _read_selected_features :143,
_write_feature_summary :153, _load :181, _run_diagnostics :228, run
:319-539; reference: the spark-submit entry ml/Driver.scala:70-638, flags
from ml/Params.scala:42-203 / ml/OptionNames.scala; defaults preserved:
80 iterations, λ=[10], LBFGS, L2, tolerance 1e-6, intercept on).

Staged pipeline: INIT -> PREPROCESSED -> TRAINED -> VALIDATED -> DIAGNOSED.
Outputs under --output-directory:
  log-message.txt, best-model/{model.txt,model.avro},
  all-models/<λ>/model.txt, feature-index.json, validation-metrics.json,
  summary.json, model-diagnostic.{json,html} under a diagnostic mode

Every JAX flag parses with its default. ``--dtype`` picks the solver type
(float32 by default, as in JAX). ``--profile-output-dir`` writes a
``torch.profiler`` trace of the train phase there (utils/profiling.py;
CUDA activity on the card); ``--ingest-workers`` N >= 2 (and
``auto`` on a large input) decodes the Avro in a process pool
(data/parallel_ingest.py). Training, variances and the
diagnostics' re-fits solve on the device; validation scores and the
diagnostics' scoring are host numpy (``vmat @ means``), as in JAX.

``run(argv, device="cuda")`` trains on the card and raises without CUDA
unless the caller passes ``device="cpu"`` (the CPU tests).

    python -m photon_ml_tpu_torch.cli.glm_driver --training-data-directory ...
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from photon_ml_tpu_torch.data.avro_reader import read_labeled_points
from photon_ml_tpu_torch.data.index_map import IdentityIndexMap, IndexMap
from photon_ml_tpu_torch.data.libsvm import read_libsvm
from photon_ml_tpu_torch.data.normalization import build_normalization_context
from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary
from photon_ml_tpu_torch.data.validators import validate_data
from photon_ml_tpu_torch.diagnostics import (
    DiagnosticMode,
    DiagnosticReport,
    bootstrap_training,
    expected_magnitude_importance,
    fitting_diagnostic,
    hosmer_lemeshow_diagnostic,
    prediction_error_independence,
    variance_importance,
    write_report,
)
from photon_ml_tpu_torch.diagnostics.reporting import ModelDiagnosticReport
from photon_ml_tpu_torch.estimators.model_selection import select_best_model
from photon_ml_tpu_torch.estimators.model_training import train_glm_models
from photon_ml_tpu_torch.evaluation.evaluators import METRIC_METADATA
from photon_ml_tpu_torch.evaluation.validation import evaluate_glm
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro_codec import write_container
from photon_ml_tpu_torch.io.model_io import glm_to_avro_record, write_text_model
from photon_ml_tpu_torch.optimization.config import (
    OptimizerType,
    RegularizationContext,
    RegularizationType,
    constraint_arrays,
    parse_constraint_string,
)
from photon_ml_tpu_torch.types import DataValidationType, NormalizationType, TaskType
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.utils.events import (
    EventEmitter,
    PhotonOptimizationLogEvent,
    TrainingFinishEvent,
    TrainingStartEvent,
)
from photon_ml_tpu_torch.utils.logging_utils import setup_photon_logger
from photon_ml_tpu_torch.utils.profiling import maybe_trace
from photon_ml_tpu_torch.utils.timer import PhaseTimer

STAGES = ["INIT", "PREPROCESSED", "TRAINED", "VALIDATED", "DIAGNOSED"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon-glm-driver",
        description="Train GLMs over a regularization-weight grid "
                    "(reference flag names from ml/OptionNames.scala)")
    p.add_argument("--training-data-directory", required=True)
    p.add_argument("--validating-data-directory", default=None)
    p.add_argument("--output-directory", required=True)
    p.add_argument("--task", required=True,
                   choices=[t.value for t in TaskType])
    p.add_argument("--format", default="AVRO", choices=["AVRO", "LIBSVM"])
    p.add_argument("--max-num-iterations", type=int, default=80)
    p.add_argument("--regularization-weights", default="10",
                   help="comma-separated λ grid")
    p.add_argument("--regularization-type", default="L2",
                   choices=[t.value for t in RegularizationType])
    p.add_argument("--elastic-net-alpha", type=float, default=None)
    p.add_argument("--optimizer", default="LBFGS",
                   choices=[t.value for t in OptimizerType])
    p.add_argument("--tolerance", type=float, default=1e-6)
    p.add_argument("--intercept", default="true",
                   choices=["true", "false"], help="add intercept term")
    p.add_argument("--normalization-type", default="NONE",
                   choices=[t.value for t in NormalizationType])
    p.add_argument("--coefficient-box-constraints", default=None,
                   help="JSON constraint string (GLMSuite format)")
    p.add_argument("--ingest-workers", default="auto",
                   help="Avro decode workers: 'auto' (usable cores, the "
                        "pool only for large inputs) or a count; 1 decodes "
                        "in this process")
    p.add_argument("--offheap-indexmap-dir", default=None,
                   help="pre-built feature index stores (the reference's "
                        "partitioned PalDB paldb-partition-<ns>-<N>.dat "
                        "stores, OptionNames.OFFHEAP_INDEXMAP_DIR, or this "
                        "package's <ns>.json) — skips the Avro index scan; "
                        "uses the 'global' namespace, or the only one "
                        "present")
    p.add_argument("--offheap-indexmap-namespace", default=None,
                   help="store namespace to use when the directory holds "
                        "several (defaults to 'global' or the only one)")
    p.add_argument("--selected-features-file", default=None,
                   help="Avro file of name/term records restricting the "
                        "feature set (GLMSuite selectedFeaturesFile)")
    p.add_argument("--summarization-output-dir", default=None,
                   help="write per-feature statistics as "
                        "FeatureSummarizationResultAvro here "
                        "(ml/Driver.scala summarizeFeatures)")
    p.add_argument("--validate-data", default="VALIDATE_FULL",
                   choices=[t.value for t in DataValidationType])
    p.add_argument("--diagnostic-mode", default="NONE",
                   choices=["NONE", "TRAIN", "VALIDATE", "ALL"],
                   help="which diagnostics to run "
                        "(ml/diagnostics/DiagnosticMode.scala)")
    p.add_argument("--num-bootstrap-samples", type=int, default=4)
    p.add_argument("--compute-variance", default="false",
                   choices=["true", "false"])
    p.add_argument("--warm-start", default="true", choices=["true", "false"])
    p.add_argument("--job-name", default="photon-ml-tpu")
    p.add_argument("--event-listeners", default=None,
                   help="comma-separated listener class paths")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--feature-storage-dtype", default=None,
                   choices=["bfloat16"],
                   help="store DENSE features at half width (bfloat16) "
                        "with solver-dtype accumulation — ~2x on the "
                        "bandwidth-bound fixed-effect solve; see "
                        "docs/F32_PARITY.md for the precision bounds")
    p.add_argument("--profile-output-dir", default=None,
                   help="write a torch.profiler trace of the train phase "
                        "here (Chrome trace JSON; CUDA activity on the "
                        "card)")
    return p


def _read_selected_features(path: str) -> set:
    """Selected-feature keys from an Avro file of name/term records
    (GLMSuite.getSelectedFeatureSetFromFile, io/GLMSuite.scala:133-150)."""
    from photon_ml_tpu_torch.data.index_map import feature_key
    from photon_ml_tpu_torch.io.avro_codec import read_container

    return {feature_key(r["name"], r.get("term") or "")
            for r in read_container(path)}


def _write_feature_summary(out_dir: Path, summary, imap) -> None:
    """Per-feature statistics as FeatureSummarizationResultAvro
    (util/IOUtils.scala:270-330: max/min/mean/normL1/normL2/numNonzeros/
    variance keyed by feature name+term)."""
    from photon_ml_tpu_torch.data.index_map import split_key

    records = []
    for i in range(len(summary.mean)):
        key = imap.get_feature_name(i) or str(i)
        name, term = split_key(key)
        records.append({
            "featureName": name,
            "featureTerm": term or None,
            "metrics": {
                "max": float(summary.max[i]),
                "min": float(summary.min[i]),
                "mean": float(summary.mean[i]),
                "normL1": float(summary.norm_l1[i]),
                "normL2": float(summary.norm_l2[i]),
                "numNonzeros": float(summary.num_nonzeros[i]),
                "variance": float(summary.variance[i]),
            },
        })
    out_dir.mkdir(parents=True, exist_ok=True)
    write_container(out_dir / "part-00000.avro",
                    schemas.FEATURE_SUMMARIZATION_RESULT, records)


def _load(path: str, fmt: str, add_intercept: bool, task: TaskType,
          index_map: IndexMap | None = None,
          num_raw_features: int | None = None,
          selected_features: set | None = None,
          ingest_workers="auto"):
    """index_map / num_raw_features: pass the training map (AVRO) or the
    training feature width before intercept (LIBSVM) when loading validation
    data, so columns decode identically (the reference shares one feature
    index across splits)."""
    if fmt == "AVRO":
        mat, y, off, w, _, imap = read_labeled_points(
            path, index_map=index_map, add_intercept=add_intercept,
            selected_features=selected_features,
            ingest_workers=ingest_workers)
        return mat, y, off, w, imap
    if selected_features is not None:
        raise ValueError(
            "--selected-features-file requires --format AVRO "
            "(LIBSVM features have no name/term keys)")
    files = sorted(Path(path).glob("*")) if Path(path).is_dir() else \
        [Path(path)]
    mats, ys = [], []
    for f in files:
        if f.is_file():
            m, y = read_libsvm(
                f, add_intercept=False,
                map_negative_labels=task.is_classification)
            mats.append(m)
            ys.append(y)
    import scipy.sparse as sp

    d = max(m.shape[1] for m in mats)
    if num_raw_features is not None:
        # Validation width is dictated by training: features unseen at
        # training time are dropped (the shared index has no slot for them).
        d = num_raw_features
        mats = [m[:, :d] if m.shape[1] > d else m for m in mats]
    mats = [sp.csr_matrix((m.data, m.indices, m.indptr), shape=(m.shape[0], d))
            for m in mats]
    mat = sp.vstack(mats, format="csr")
    if add_intercept:
        mat = sp.hstack([mat, np.ones((mat.shape[0], 1))], format="csr")
    y = np.concatenate(ys)
    imap = IdentityIndexMap(mat.shape[1], intercept_last=add_intercept)
    return mat, y, np.zeros(len(y)), np.ones(len(y)), imap


def _run_diagnostics(mode, out_dir, task, trained, metrics_by_lambda,
                     mat, y, off, w, imap, vdata, train_kwargs,
                     num_bootstrap_samples):
    """DIAGNOSED stage (reference: ml/Driver.scala:524-551 — training
    diagnostics run against training data, validation diagnostics against
    the validation set; everything lands in one report document)."""
    summary = BasicStatisticalSummary.compute(mat)
    feature_names = [imap.get_feature_name(i) or str(i)
                     for i in range(mat.shape[1])]
    lambdas = list(train_kwargs["regularization_weights"])

    def subset_trainer(train_idx, holdout_idx, warm, eval_train=True):
        """(λ, model, train metrics, holdout metrics) per grid point —
        the curried trainModel closure of BootstrapTraining/FittingDiagnostic.
        eval_train=False skips the train-split scoring pass (bootstrap only
        consumes holdout metrics)."""
        init = warm.get(max(lambdas)) if warm else None
        results = train_glm_models(
            mat[train_idx], y[train_idx], task,
            offsets=off[train_idx], weights=w[train_idx],
            initial_model=init,
            **train_kwargs)
        out = []
        for t in results:
            means, _ = t.model.coefficients.to_numpy()
            train_metrics = {}
            if eval_train:
                train_scores = np.asarray(mat[train_idx] @ means).ravel()
                train_metrics = evaluate_glm(
                    task, train_scores, y[train_idx],
                    off[train_idx], w[train_idx])
            hold_scores = np.asarray(mat[holdout_idx] @ means).ravel()
            out.append((
                t.reg_weight, t.model, train_metrics,
                evaluate_glm(task, hold_scores, y[holdout_idx],
                             off[holdout_idx], w[holdout_idx])))
        return out

    fitting_by_lambda = {}
    bootstrap_by_lambda = {}
    if mode.train_enabled:
        fitting_by_lambda = fitting_diagnostic(
            mat.shape[0], mat.shape[1], subset_trainer)
        if num_bootstrap_samples > 1:
            def bootstrap_trainer(train_idx, holdout_idx, warm):
                return [(lam, model, hold)
                        for lam, model, _, hold
                        in subset_trainer(train_idx, holdout_idx, warm,
                                          eval_train=False)]

            bootstrap_by_lambda = bootstrap_training(
                mat.shape[0], bootstrap_trainer,
                num_bootstrap_samples=num_bootstrap_samples)

    report = DiagnosticReport(system={
        "task": task.value,
        "numRows": int(mat.shape[0]),
        "numFeatures": int(mat.shape[1]),
        "lambdas": lambdas,
        "diagnosticMode": mode.value,
    })
    for t in trained:
        means, _ = t.model.coefficients.to_numpy()
        chapter = ModelDiagnosticReport(
            model_description=t.model.model_class_name,
            reg_weight=t.reg_weight,
            metrics=metrics_by_lambda.get(t.reg_weight, {}))
        chapter.feature_importance = [
            expected_magnitude_importance(
                means, summary, feature_names).to_dict(),
            variance_importance(means, summary, feature_names).to_dict(),
        ]
        if t.reg_weight in fitting_by_lambda:
            chapter.fitting = fitting_by_lambda[t.reg_weight].to_dict()
        if t.reg_weight in bootstrap_by_lambda:
            chapter.bootstrap = bootstrap_by_lambda[t.reg_weight].to_dict()
        if mode.validate_enabled and vdata is not None:
            vmat, vy, voff, vw = vdata
            vscores = np.asarray(vmat @ means).ravel() + voff
            predictions = t.model.mean_of_score(
                torch.as_tensor(vscores)).numpy()
            chapter.prediction_error_independence = \
                prediction_error_independence(vy, predictions).to_dict()
            if task == TaskType.LOGISTIC_REGRESSION:
                chapter.hosmer_lemeshow = hosmer_lemeshow_diagnostic(
                    vy, predictions, vmat.shape[1]).to_dict()
        report.models.append(chapter)

    write_report(report, out_dir)


def run(argv=None, *, device="cuda") -> dict:
    """Train, validate, diagnose and write; returns summary.json's
    content."""
    dev = resolve_device(device)
    args = build_parser().parse_args(argv)
    out_dir = Path(args.output_directory)
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = setup_photon_logger(out_dir)
    task = TaskType(args.task)
    add_intercept = args.intercept == "true"
    timer = PhaseTimer()
    stages = ["INIT"]

    emitter = EventEmitter()
    for cp in (args.event_listeners or "").split(","):
        if cp.strip():
            emitter.register_listener_by_name(cp.strip())
    emitter.send_event(TrainingStartEvent(args.job_name))
    t_start = time.perf_counter()

    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    storage_dtype = (torch.bfloat16
                     if args.feature_storage_dtype == "bfloat16" else None)

    # ---- preprocess ------------------------------------------------------
    with timer.time("preprocess"):
        selected = (_read_selected_features(args.selected_features_file)
                    if args.selected_features_file else None)
        preloaded_map = None
        if args.offheap_indexmap_dir:
            if args.format != "AVRO":
                raise ValueError(
                    "--offheap-indexmap-dir requires --format AVRO")
            from photon_ml_tpu_torch.data.paldb import (
                discover_store_namespaces,
                load_store_namespace,
            )

            store_dir = Path(args.offheap_indexmap_dir)
            namespaces = discover_store_namespaces(store_dir)
            ns = args.offheap_indexmap_namespace or (
                "global" if "global" in namespaces
                else next(iter(namespaces)) if len(namespaces) == 1
                else None)
            if ns is None or ns not in namespaces:
                raise ValueError(
                    f"--offheap-indexmap-dir holds namespaces "
                    f"{sorted(namespaces)}; pick one with "
                    "--offheap-indexmap-namespace")
            # Parse only the selected namespace (a dir can hold several
            # multi-million-feature shards).
            preloaded_map = load_store_namespace(store_dir, ns,
                                                 namespaces[ns])
            if add_intercept and preloaded_map.intercept_index < 0:
                raise ValueError(
                    f"feature index store {ns!r} has no intercept key but "
                    "--intercept is true — rebuild the store with an "
                    "intercept or pass --intercept false")
            logger.info("loaded feature index store %r (%d features) "
                        "from %s", ns, len(preloaded_map), store_dir)
        mat, y, off, w, imap = _load(
            args.training_data_directory, args.format, add_intercept, task,
            index_map=preloaded_map, selected_features=selected,
            ingest_workers=args.ingest_workers)
        logger.info("loaded %d rows x %d features", *mat.shape)
        validate_data(task, mat, y, off, w,
                      DataValidationType(args.validate_data))
        norm = None
        if args.normalization_type != "NONE" or args.summarization_output_dir:
            summary = BasicStatisticalSummary.compute(mat)
            if args.summarization_output_dir:
                _write_feature_summary(
                    Path(args.summarization_output_dir), summary, imap)
                logger.info("feature statistics written to %s",
                            args.summarization_output_dir)
        if args.normalization_type != "NONE":
            norm = build_normalization_context(
                args.normalization_type, summary,
                intercept_id=imap.intercept_index, device=dev)
        lb = ub = None
        if args.coefficient_box_constraints:
            cmap = parse_constraint_string(
                args.coefficient_box_constraints, imap)
            lb, ub = constraint_arrays(cmap, len(imap),
                                       imap.intercept_index)
    stages.append("PREPROCESSED")

    # ---- train -----------------------------------------------------------
    lambdas = [float(s) for s in args.regularization_weights.split(",")]
    reg_ctx = RegularizationContext(
        RegularizationType(args.regularization_type),
        args.elastic_net_alpha)
    with timer.time("train"), maybe_trace(args.profile_output_dir, dev):
        trained = train_glm_models(
            mat, y, task,
            regularization_weights=lambdas,
            regularization_context=reg_ctx,
            optimizer_type=OptimizerType(args.optimizer),
            max_iterations=args.max_num_iterations,
            tolerance=args.tolerance,
            offsets=off, weights=w, normalization=norm,
            lower_bounds=lb, upper_bounds=ub,
            warm_start=args.warm_start == "true",
            compute_variances=args.compute_variance == "true",
            dtype=dtype,
            storage_dtype=storage_dtype, device=dev)
        _finish_device_work(dev)
    stages.append("TRAINED")
    for t in trained:
        emitter.send_event(PhotonOptimizationLogEvent(
            t.reg_weight, int(t.result.iterations),
            t.result.reason_enum().summary, float(t.result.value)))

    # ---- validate + select ----------------------------------------------
    best_lambda = lambdas[0]
    metrics_by_lambda = {}
    if args.validating_data_directory:
        with timer.time("validate"):
            vmat, vy, voff, vw, _ = _load(
                args.validating_data_directory, args.format, add_intercept,
                task, index_map=imap if args.format == "AVRO" else None,
                num_raw_features=(mat.shape[1] - int(add_intercept)
                                  if args.format == "LIBSVM" else None),
                ingest_workers=args.ingest_workers)
            if vmat.shape[1] != mat.shape[1]:
                raise ValueError(
                    f"validation feature dim {vmat.shape[1]} != "
                    f"training {mat.shape[1]}")
            scored = {}
            for t in trained:
                means, _ = t.model.coefficients.to_numpy()
                scored[t.reg_weight] = np.asarray(vmat @ means).ravel()
            best_lambda, _ = select_best_model(task, scored, vy, voff, vw)
            for t in trained:
                metrics_by_lambda[t.reg_weight] = evaluate_glm(
                    task, scored[t.reg_weight], vy, voff, vw,
                    num_coefficients=mat.shape[1])
            metric_names = sorted(
                {m for ms in metrics_by_lambda.values() for m in ms})
            (out_dir / "validation-metrics.json").write_text(
                json.dumps({
                    "metrics": {str(k): v
                                for k, v in metrics_by_lambda.items()},
                    "metricMetadata": {
                        name: METRIC_METADATA[name].to_dict()
                        for name in metric_names
                        if name in METRIC_METADATA},
                }, indent=2))
        stages.append("VALIDATED")

    # ---- diagnose --------------------------------------------------------
    diag_mode = DiagnosticMode(args.diagnostic_mode)
    if diag_mode is not DiagnosticMode.NONE:
        with timer.time("diagnose"):
            _run_diagnostics(
                diag_mode, out_dir, task, trained, metrics_by_lambda,
                mat, y, off, w, imap,
                vdata=(vmat, vy, voff, vw)
                if args.validating_data_directory else None,
                train_kwargs=dict(
                    regularization_weights=lambdas,
                    regularization_context=reg_ctx,
                    optimizer_type=OptimizerType(args.optimizer),
                    max_iterations=args.max_num_iterations,
                    tolerance=args.tolerance, normalization=norm,
                    lower_bounds=lb, upper_bounds=ub,
                    warm_start=args.warm_start == "true", dtype=dtype,
                    storage_dtype=storage_dtype, device=dev),
                num_bootstrap_samples=args.num_bootstrap_samples)
        stages.append("DIAGNOSED")
        logger.info("diagnostics written to model-diagnostic.{json,html}")

    # ---- write models ----------------------------------------------------
    with timer.time("write"):
        by_lambda = {t.reg_weight: t for t in trained}
        best = by_lambda[best_lambda]
        best_dir = out_dir / "best-model"
        best_dir.mkdir(exist_ok=True)
        write_text_model(best_dir / "model.txt", best.model, imap,
                         best.reg_weight)
        write_container(best_dir / "model.avro",
                        schemas.BAYESIAN_LINEAR_MODEL,
                        [glm_to_avro_record("best", best.model, imap)])
        all_dir = out_dir / "all-models"
        for t in trained:
            d = all_dir / str(t.reg_weight)
            d.mkdir(parents=True, exist_ok=True)
            write_text_model(d / "model.txt", t.model, imap, t.reg_weight)
        imap.save(out_dir / "feature-index.json")

    duration = time.perf_counter() - t_start
    summary = {
        "jobName": args.job_name,
        "task": task.value,
        "stages": stages,
        "numRows": int(mat.shape[0]),
        "numFeatures": int(mat.shape[1]),
        "lambdas": lambdas,
        "bestLambda": best_lambda,
        "convergence": {
            str(t.reg_weight): {
                "iterations": int(t.result.iterations),
                "reason": t.result.reason_enum().summary,
                "finalObjective": float(t.result.value)}
            for t in trained},
        "validationMetrics": {str(k): v
                              for k, v in metrics_by_lambda.items()},
        "phaseSeconds": timer.phases,
        "totalSeconds": duration,
    }
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    emitter.send_event(TrainingFinishEvent(args.job_name, duration))
    emitter.clear_listeners()
    logger.info("done in %.1fs; best lambda = %g", duration, best_lambda)
    return summary


def _finish_device_work(dev) -> None:
    """A phase's device work is done before its clock stops."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
