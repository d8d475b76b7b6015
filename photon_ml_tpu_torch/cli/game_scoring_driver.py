"""GAME scoring driver (port of photon_ml_tpu/cli/game_scoring_driver.py:
build_parser :48-150, run :197-261 with its telemetry and observability
plane, the legacy aliases :264-278, _run_scoring :280-373 with its
--listen/--stream/--serve/--adaptive-admission/--distmon flag checks
:284-300, _attach_score_monitor :375-391, _run_stream :393-471,
_run_serve :474-576, _run_listen :595-655 with _parse_listen :579-592,
which is cli/net_router.py's address parsing;
reference ml/cli/game/scoring/Driver.scala:36-265): load a saved GAME
model, score a dataset on the card, write ScoringResultAvro records to
<output-dir>/scores/part-00000.avro, optionally evaluate, and write
metrics.json.

Four execution shapes, as in JAX:

- default: the whole input is read into one GameDataset and scored by
  ``DeviceGameScorer``; ``scoring_path`` "device";
- ``--stream --batch-rows N``: the input streams through the serving
  engine (serving/engine.py ``score_container_stream``): the model
  uploaded once, batches padded to bucket shapes, each bucket one CUDA
  graph, the decode of batch k+1 (the block stream's prefetch thread)
  overlapping the dispatch of batch k; ``scoring_path``
  "streaming-engine", with ``num_batches``, ``batch_rows``, ``feeder``
  and ``engine`` in metrics.json;
- ``--serve``: the decoded input is cut into ``--request-rows``-row
  requests that ``--serve-concurrency`` closed-loop requesters replay
  through the async front-end (serving/frontend.py), which coalesces
  each ``--coalesce-ms`` window into shared bucket dispatches;
  ``scoring_path`` "async-frontend", with ``num_requests``,
  ``request_rows``, ``coalesce_window_ms``, ``concurrency`` and
  ``frontend``;
- ``--listen ADDR`` (implies ``--serve``): the input is not replayed;
  the network front door (serving/netserver.py) serves real sockets on
  ADDR (PORT, :PORT or HOST:PORT; port 0 is ephemeral), HTTP/1.1 JSON
  and the binary framing on one port, both into the front-end's
  admission path. The bound port goes to ``<output-dir>/net_port`` as
  soon as the server listens; ``/statusz`` gains the ``netserver``
  provider (and ``adaptive_admission``), and ``/readyz`` turns ready
  with reason "serving". The run serves until ``--serve-seconds`` run
  out or SIGINT arrives, then drains (every request already read is
  answered) and writes metrics.json with ``scoring_path`` "netserver",
  ``listen``, ``net``, ``adaptive_admission`` (with the controller),
  ``frontend`` and, beside JAX's keys, ``kernel_launches``: the row-9
  launches of the process (``spmv.csr_matvec.launches``: the bucket
  graphs' eager builds and replays), for a harness outside it.
  ``--adaptive-admission`` (with ``--listen`` and at least one
  ``--slo``) runs serving/adaptive.py's controller over the front-end's
  live ``max_pending`` and coalesce window.

The JAX driver falls back to host numpy when its batch scorer refuses a
sub-model; the port does not: a sub-model the scorer refuses (or a
snapshot too large to densify) ends the run with its error, and with
``SystemExit`` on the --stream and --serve paths, as JAX's --stream does.

Telemetry, as in JAX: the run resets and enables the process's
telemetry (trace sampling on under ``--trace-out`` or ``--obs-port``),
opens the root ``driver`` span and the phase spans, arms the flight
recorder (``--flight-events``), serves the live plane under
``--obs-port`` (``/readyz`` ready once the model is loaded; the
front-end's ``stats()`` on ``/statusz`` under ``--serve``), judges the
``--slo`` objectives, writes a Chrome trace under ``--trace-out`` and
metrics.json's ``telemetry``, ``observability`` and ``slo`` blocks.

``--distmon`` (with ``--stream`` or ``--serve``; SystemExit otherwise)
hangs a ``ScoreDistributionMonitor`` off the engine's settle, scored
against the model's ``referenceDistributions`` (written by a
``--stream-train --distmon`` run): the drift gauges
``serving.model.default.score_drift_psi`` / ``_ks`` refresh on every
scrape and once before the ``slo`` block, ``/distz`` shows the live
sketch, and metrics.json gains ``distributions``.

``run(argv, device="cuda", dtype=None)`` scores on the card and raises
without CUDA unless the caller passes ``device="cpu"``; ``dtype`` None
means float64 on the CPU and float32 on the card.

    python -m photon_ml_tpu_torch.cli.game_scoring_driver --input-dirs ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.cli import phase, resolve_run_device
from photon_ml_tpu_torch.cli.obs import (
    DriverObservability,
    add_observability_args,
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
                   help="bounded-memory streamed scoring through the "
                        "serving engine")
    p.add_argument("--batch-rows", type=int, default=4096,
                   help="rows per streamed batch (--stream only)")
    p.add_argument("--feeder", choices=["auto", "native", "python"],
                   default="auto", help="--stream decode path")
    p.add_argument("--prefetch-batches", type=int, default=2,
                   help="--stream decode-ahead depth")
    p.add_argument("--serve", action="store_true",
                   help="concurrent request replay through the async "
                        "serving front-end")
    p.add_argument("--serve-concurrency", type=int, default=16,
                   help="--serve requesters")
    p.add_argument("--coalesce-ms", type=float, default=2.0,
                   help="--serve coalesce window in milliseconds")
    p.add_argument("--request-rows", type=int, default=1,
                   help="--serve rows per request")
    p.add_argument("--max-pending", type=int, default=1024,
                   help="--serve admission bound")
    p.add_argument("--listen", default=None, metavar="ADDR",
                   help="network serving (implies --serve): open the "
                        "front door on ADDR (PORT, :PORT or HOST:PORT; "
                        "port 0 = ephemeral, written to <output-dir>/"
                        "net_port) speaking HTTP/1.1 JSON (POST /score) "
                        "and the length-prefixed binary framing on one "
                        "port, both into the front-end's admission path")
    p.add_argument("--serve-seconds", type=float, default=None,
                   metavar="S",
                   help="--listen lifetime: serve for S seconds, then "
                        "drain and write the summary (default: until "
                        "SIGINT; the drain still runs)")
    p.add_argument("--adaptive-admission", action="store_true",
                   help="--listen SLO-adaptive admission: a controller "
                        "reads the declared --slo objectives' per-tick "
                        "burn rate and retunes the live shed threshold "
                        "and coalesce window with hysteresis (requires "
                        "at least one --slo)")
    p.add_argument("--distmon", action="store_true",
                   help="score-distribution monitoring (--stream or "
                        "--serve): a streaming score sketch fed at the "
                        "engine's settle, drift (PSI/KS) against the "
                        "model's embedded referenceDistributions "
                        "(trained with --stream-train --distmon) as "
                        "serving.model.default.score_drift_psi/_ks "
                        "gauges, live /distz with --obs-port, and a "
                        "distributions metrics.json block")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write a Chrome trace-event JSON of the run's "
                        "pipeline spans (one track a thread; load in "
                        "Perfetto)")
    add_observability_args(p)
    return p


def run(argv=None, *, device="cuda", dtype=None) -> dict:
    """Score and write; returns the metrics.json summary."""
    dev, dtype = resolve_run_device(device, dtype)
    args = build_parser().parse_args(argv)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = setup_photon_logger(out_dir)
    t0 = time.perf_counter()
    # Per-run telemetry: phase spans and the registry snapshot in
    # metrics.json (and --trace-out).
    telemetry.reset()
    # Trace sampling is on whenever something consumes traces: a
    # --trace-out export, or the live plane's /tracez.
    telemetry.enable(trace=bool(args.trace_out)
                     or args.obs_port is not None)
    obs = None
    try:
        # Built inside the try: a bad --slo spec or an occupied
        # --obs-port still unwinds through the finally below.
        obs = DriverObservability(args, out_dir, role="scoring").start()
        # Root span: imports, logging and the glue between the named
        # phases land in its self time.
        with telemetry.span("driver"):
            summary = _run_scoring(args, out_dir, logger, obs, dev, dtype)
        wall = time.perf_counter() - t0
        summary["total_seconds"] = wall
        _apply_legacy_aliases(summary)
        obs.finish(summary)
        summary["telemetry"] = telemetry.attribution_summary(wall)
        if args.trace_out:
            telemetry.export_chrome_trace(args.trace_out)
            logger.info("pipeline trace written to %s (load in Perfetto)",
                        args.trace_out)
        (out_dir / "metrics.json").write_text(json.dumps(summary, indent=2))
        logger.info("scoring done: %s", summary["metrics"])
        return summary
    except BaseException as e:
        # The spans have unwound: the flight ring's last events cover
        # the failing stage.
        if obs is not None:
            obs.dump_fault(e, logger)
        raise
    finally:
        if obs is not None:
            obs.stop()
        telemetry.disable()


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


def _run_scoring(args, out_dir, logger, obs, device, dtype) -> dict:
    # Flag contradictions fail before the model loads.
    if args.listen is not None:
        args.serve = True  # --listen is the network serving shape
    if args.stream and args.serve:
        raise SystemExit("--stream and --serve are mutually exclusive: "
                         "--stream is the bounded-memory bulk path, "
                         "--serve the concurrent-request replay harness")
    if args.adaptive_admission and args.listen is None:
        raise SystemExit("--adaptive-admission retunes a live network "
                         "front door; pass --listen")
    if args.adaptive_admission and not args.slo:
        raise SystemExit("--adaptive-admission steers on the declared "
                         "--slo objectives; pass at least one --slo")
    if args.distmon and not (args.stream or args.serve):
        raise SystemExit("--distmon attaches score sketches to the "
                         "streaming engine's scatter-back; pass "
                         "--stream or --serve")
    model_dir = Path(args.game_model_input_dir)
    index_dir = Path(args.feature_index_dir) if args.feature_index_dir else \
        model_dir / "feature-indexes"
    with phase(logger, "load_model"):
        shard_maps = load_feature_index_maps(index_dir)
        model = load_game_model(model_dir, shard_maps)
    # Liveness and readiness part here: /healthz answered from the
    # server's start, /readyz turns 200 now the model is resident.
    obs.mark_ready("model_loaded")

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

    # The reference distributions a --stream-train --distmon run wrote
    # into the model (None otherwise): what serving drift-scores against.
    reference = meta.get("referenceDistributions")
    if args.serve:
        return _run_serve(args, inputs, id_types, shard_maps, model,
                          evaluators, scores_path, logger, obs, reference,
                          device, dtype)
    if args.stream:
        return _run_stream(args, inputs, id_types, shard_maps, model,
                           evaluators, scores_path, logger, obs, reference,
                           device, dtype)
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


def _records(datasets_and_scores, counters, acc):
    """ScoringResultAvro records of (dataset, scores) pairs, counting rows
    and feeding the evaluation accumulator as they pass; uids default to
    the running row number."""
    uid_base = 0
    for ds, scores in datasets_and_scores:
        counters["rows"] += ds.num_rows
        counters["batches"] += 1
        if acc is not None:
            acc.add(ds, scores)
        uids = ds.uids if ds.uids is not None else np.asarray(
            [str(uid_base + i) for i in range(ds.num_rows)])
        uid_base += ds.num_rows
        for u, s, o, lab in zip(uids, scores, ds.offsets, ds.responses):
            yield {"uid": str(u), "predictionScore": float(s + o),
                   "label": float(lab), "metadataMap": None}


def _attach_score_monitor(args, engine, label, reference, obs):
    """--distmon: hang a ScoreDistributionMonitor off the engine's
    settle and register its /distz provider, its drift-gauge scrape hook
    (drift is computed on every scrape and heartbeat, and once more at
    finish before the slo block) and its /snapshotz sketches. Returns the
    monitor, or None without the flag."""
    if not args.distmon:
        return None
    from photon_ml_tpu_torch.data.distmon import ScoreDistributionMonitor

    mon = ScoreDistributionMonitor(label, reference=reference)
    engine.score_monitor = mon
    obs.add_dist_provider("serving", lambda: {label: mon.snapshot()})
    obs.add_scrape_hook("score_drift", mon.publish_gauges)
    obs.add_sketch_provider("serving", mon.sketch_states)
    return mon


def _distributions(summary: dict, score_mon) -> dict:
    """The ``distributions`` block of a --distmon run, after a last
    gauge refresh."""
    if score_mon is not None:
        score_mon.publish_gauges()
        summary["distributions"] = {"default": score_mon.snapshot()}
    return summary


def _run_stream(args, inputs, id_types, shard_maps, model, evaluators,
                scores_path, logger, obs, reference, device,
                dtype) -> dict:
    """Bounded-memory scoring through the decode -> upload -> dispatch
    pipeline (``score_container_stream``), writing records per batch.
    Only the evaluation columns accumulate across batches (when
    evaluators are asked for), never features."""
    from photon_ml_tpu_torch.evaluation.validation import (
        StreamedEvalAccumulator,
    )
    from photon_ml_tpu_torch.serving import (
        StreamingGameScorer,
        UnsupportedSubModelError,
    )

    try:
        with phase(logger, "setup_engine"):
            engine = StreamingGameScorer(model, dtype=dtype, device=device)
    except UnsupportedSubModelError as e:
        raise SystemExit(
            f"--stream requires a device-scorable model: {e}") from e
    score_mon = _attach_score_monitor(args, engine, "default", reference,
                                      obs)
    try:
        with phase(logger, "setup_stream"):
            scored = engine.score_container_stream(
                inputs, id_types=id_types, feature_shard_maps=shard_maps,
                batch_rows=args.batch_rows, feeder=args.feeder,
                prefetch_depth=args.prefetch_batches)
    except RuntimeError as e:
        raise SystemExit(str(e)) from e
    logger.info("streamed scoring: %s feeder, prefetch depth %d",
                scored.stream.decode_path, scored.stream.prefetch_depth)
    counters = {"rows": 0, "batches": 0}
    acc = StreamedEvalAccumulator(id_types) if evaluators else None
    with phase(logger, "score"):
        write_container(scores_path, schemas.SCORING_RESULT,
                        _records(scored, counters, acc))
    logger.info("scored %d rows in %d streamed batches (batch-rows=%d)",
                counters["rows"], counters["batches"], args.batch_rows)
    with phase(logger, "evaluate"):
        metrics = acc.metrics(evaluators) if acc is not None else {}
    return _distributions({
        "num_rows": counters["rows"],
        "metrics": metrics,
        "scoring_path": "streaming-engine",
        "num_batches": counters["batches"],
        "batch_rows": args.batch_rows,
        "feeder": scored.stream.stats(),
        "engine": engine.stats(),
    }, score_mon)


def _run_serve(args, inputs, id_types, shard_maps, model, evaluators,
               scores_path, logger, obs, reference, device,
               dtype) -> dict:
    """Concurrent-request replay through the async front-end: the decoded
    input cut into ``--request-rows``-row requests, ``--serve-concurrency``
    closed-loop requesters, each ``--coalesce-ms`` window coalesced into
    shared bucket dispatches. Holds the requests and their scores in
    memory: it exercises the serving shape, not the bounded-memory
    one."""
    from photon_ml_tpu_torch.data.avro_reader import (
        iter_game_dataset_batches,
    )
    from photon_ml_tpu_torch.evaluation.validation import (
        StreamedEvalAccumulator,
    )
    from photon_ml_tpu_torch.serving import (
        FrontendConfig,
        ServingFrontend,
        UnsupportedSubModelError,
    )

    if args.request_rows < 1:
        raise SystemExit("--request-rows must be >= 1")
    try:
        with phase(logger, "setup_engine"):
            frontend = ServingFrontend(
                {"default": model}, dtype=dtype, device=device,
                config=FrontendConfig(
                    coalesce_window_s=args.coalesce_ms / 1e3,
                    max_pending=max(args.max_pending,
                                    args.serve_concurrency)))
    except UnsupportedSubModelError as e:
        raise SystemExit(
            f"--serve requires a device-scorable model: {e}") from e
    # /statusz carries the front-end's live stats().
    obs.add_status_provider("frontend", frontend.stats)
    score_mon = _attach_score_monitor(args, frontend.engine("default"),
                                      "default", reference, obs)
    if args.listen is not None:
        return _distributions(_run_listen(args, frontend, logger, obs),
                              score_mon)
    with phase(logger, "ingest"):
        requests = []
        for ds in iter_game_dataset_batches(
                inputs, id_types=id_types, feature_shard_maps=shard_maps,
                batch_rows=args.batch_rows, feeder=args.feeder,
                prefetch_depth=args.prefetch_batches):
            for a in range(0, ds.num_rows, args.request_rows):
                requests.append(ds.subset(np.arange(
                    a, min(a + args.request_rows, ds.num_rows))))
    logger.info("serving replay: %d requests (%d rows each), "
                "concurrency %d, coalesce window %.1f ms",
                len(requests), args.request_rows, args.serve_concurrency,
                args.coalesce_ms)
    with phase(logger, "score"):
        results, info = frontend.replay(
            requests, concurrency=args.serve_concurrency)
    if info["shed"]:
        raise RuntimeError(f"--serve: {info['shed']} requests shed, which "
                           "a closed-loop replay with max_pending >= "
                           "concurrency cannot do")
    if info["errors"]:
        raise SystemExit(
            f"--serve: {info['errors']} requests failed "
            "(see log; scores would be incomplete)")
    acc = StreamedEvalAccumulator(id_types) if evaluators else None
    counters = {"rows": 0, "batches": 0}
    with phase(logger, "write_scores"):
        write_container(scores_path, schemas.SCORING_RESULT,
                        _records(zip(requests, results), counters, acc))
    with phase(logger, "evaluate"):
        metrics = acc.metrics(evaluators) if acc is not None else {}
    return _distributions({
        "num_rows": counters["rows"],
        "metrics": metrics,
        "scoring_path": "async-frontend",
        "num_requests": len(requests),
        "request_rows": args.request_rows,
        "coalesce_window_ms": args.coalesce_ms,
        "concurrency": args.serve_concurrency,
        "frontend": frontend.stats(),
    }, score_mon)


def _run_listen(args, frontend, logger, obs) -> dict:
    """--listen: the network front door over the front-end, serving real
    sockets instead of replaying the input (requests arrive over the
    wire). The bound port lands in <output-dir>/net_port as soon as the
    listener is up; the drain on exit (--serve-seconds elapsed, or
    SIGINT) lets every admitted request settle and its response flush
    before the summary is written."""
    import asyncio

    from photon_ml_tpu_torch.cli.net_router import _parse_addr
    from photon_ml_tpu_torch.ops import spmv
    from photon_ml_tpu_torch.serving.adaptive import AdaptiveAdmission
    from photon_ml_tpu_torch.serving.netserver import (
        NetServer,
        NetServerConfig,
    )

    host, port = _parse_addr(args.listen, "--listen")
    out_dir = Path(args.output_dir)
    report = {}

    async def serve() -> None:
        async with frontend:
            server = await NetServer(
                frontend, NetServerConfig(host=host, port=port)).start()
            ctl = None
            try:
                if args.adaptive_admission:
                    ctl = await AdaptiveAdmission(
                        frontend, slo_specs=args.slo).start()
                    obs.add_status_provider("adaptive_admission",
                                            ctl.stats)
                obs.add_status_provider("netserver", server.stats)
                # Written whole, then renamed: a poller that sees the
                # file never reads it half written.
                tmp = out_dir / "net_port.tmp"
                tmp.write_text(str(server.port))
                os.replace(tmp, out_dir / "net_port")
                obs.mark_ready("serving")
                logger.info("serving on %s:%d (HTTP/1.1 + binary framing)%s",
                            host, server.port,
                            " with SLO-adaptive admission"
                            if ctl is not None else "")
                if args.serve_seconds is not None:
                    await asyncio.sleep(args.serve_seconds)
                else:
                    while True:
                        await asyncio.sleep(3600)
            finally:
                if ctl is not None:
                    await ctl.stop()
                    report["adaptive_admission"] = ctl.stats()
                await server.close()
                report["net"] = server.stats()

    with telemetry.span("serve"):
        try:
            asyncio.run(serve())
        except KeyboardInterrupt:
            logger.info("interrupted; network front door drained")
    return {
        "num_rows": 0,  # rows served are in the frontend and engine stats
        "metrics": {},
        "scoring_path": "netserver",
        "listen": f"{host}:{port}",
        **report,
        "frontend": frontend.stats(),
        "kernel_launches": {"csr_matvec": spmv.csr_matvec.launches},
    }


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
