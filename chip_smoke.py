#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's GLMix training paths on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

It builds the port's CUDA kernels from photon_ml_tpu_torch/csrc/ with
nvcc (one process per translation unit, all at once), then trains
bench.py's headline data (200k rows x 200 fixed features with an
intercept, 5k users x 25 per-user features, logistic; a 20% hold-out
scored for AUC) through photon_ml_tpu_torch's GameEstimator on two
paths, 3 coordinate-descent iterations each:

- path 1, the headline GLMix of bench.py: fixed effect L-BFGS max_iter
  50, tol 1e-7, L2 1; per-user L-BFGS max_iter 20, tol 1e-6, L2 1;
- path 2, the full-surface GAME demo's two GLM coordinates
  (examples/run_game_full.sh:36-38): fixed effect TRON/L2
  "15,1e-5,1.0,1.0", per-user elastic net "30,1e-6,0.5,1.0,LBFGS,
  ELASTIC_NET,0.5" (OWL-QN, l1 = l2 = 0.25), both under STANDARDIZATION
  (the fixed effect's intercept is column 199, the per-user one's 0).

For each path it checks:

- every random-effect bucket went through the entity-solver kernel in
  the path's variant ("lbfgs" on path 1, "owlqn+normalized" on path 2):
  launches == buckets x iterations, counted from 0 just before the
  path's fit and read just after;
- per bucket of the first random-effect update, replayed on the same
  inputs (the replay must give the main run's iterations and stop
  reasons), the kernel against its plain PyTorch version on the same
  CUDA inputs: value rtol 1e-4, coefficients atol 5e-3 (the f32 floors
  of tests/test_pallas_entity_solver.py), equal iterations and stop
  reasons, and on path 2 equal exact-zero sets, in "owlqn" mode and in
  "lbfgs" mode with the same gathered factors and shifts;
- objectives, AUC and scores are finite, the objective falls, the AUC
  beats chance, and the device scorer agrees with the host scorer.

Path 1 also measures, per bucket, how many entities the float32-compute
kernel and the float32 plain version stop with different reasons or
iteration counts (the reason both compute in float64 by default), and
the float32 kernel's time.

TF32 is switched off for matmuls and cuDNN, so every float32 product
runs in full float32. Timings are CUDA-event or synchronised host times
on the card named in the output. The third line from the end is a JSON
record of the kernels, then the card's name and power limit, and the
last line is {"ok": true, "device": ...}. It exits non-zero, printing no
result, without CUDA or when any check fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

N_ROWS, D_FIXED, N_USERS, D_USER, N_ITEMS, D_ITEM = (
    200_000, 200, 5_000, 25, 2_000, 16)
CD_ITERATIONS = 3
HOLDOUT = 0.2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# H100 SXM data-sheet peaks outside the tensor cores; the entity solver
# computes in float64.
FP64_FLOPS_PER_S = 34e12
VALUE_RTOL, COEF_ATOL = 1e-4, 5e-3
LOSS_OPS = 8  # a loss value or derivative counts 8 operations
# examples/run_game_full.sh:36-38
FE_TRON_CFG = "15,1e-5,1.0,1.0,TRON,L2"
RE_ENET_CFG = "30,1e-6,0.5,1.0,LBFGS,ELASTIC_NET,0.5"
SOURCE = "photon_ml_tpu_torch/csrc/entity_lbfgs.cu"
REPLACES = "photon_ml_tpu/ops/pallas_entity_solver.py:963"


class CheckFailed(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def build_problem(seed: int = 7):
    """bench.py:build_problem at its full shapes: the same draws in the
    same order, so the data is bench.py's (the item columns are drawn and
    left out: this slice trains the fixed effect and per-user effect)."""
    import scipy.sparse as sp

    from photon_ml_tpu_torch.data.game_data import GameDataset

    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (N_ROWS, D_FIXED)).astype(np.float32)
    x[:, -1] = 1.0
    w = rng.normal(0, 0.5, D_FIXED)
    users = rng.integers(0, N_USERS, N_ROWS)
    items = rng.integers(0, N_ITEMS, N_ROWS)
    xu = rng.normal(0, 1, (N_ROWS, D_USER)).astype(np.float32)
    xu[:, 0] = 1.0
    xi = rng.normal(0, 1, (N_ROWS, D_ITEM)).astype(np.float32)
    xi[:, 0] = 1.0
    wu = rng.normal(0, 0.3, (N_USERS, D_USER))
    bias_i = rng.normal(0, 0.5, N_ITEMS)
    z = x @ w + np.einsum("nd,nd->n", xu, wu[users]) + bias_i[items]
    y = (rng.random(N_ROWS) < 1 / (1 + np.exp(-z))).astype(float)
    del xi
    return GameDataset.build(
        responses=y,
        feature_shards={"global": sp.csr_matrix(x),
                        "user": sp.csr_matrix(xu)},
        ids={"userId": users.astype(str)})


def configs():
    from photon_ml_tpu_torch.optimization.config import (
        GLMOptimizationConfiguration,
    )

    return (GLMOptimizationConfiguration.parse("50,1e-7,1.0,1.0,LBFGS,L2"),
            GLMOptimizationConfiguration.parse("20,1e-6,1.0,1.0,LBFGS,L2"))


def configs_path2():
    from photon_ml_tpu_torch.optimization.config import (
        GLMOptimizationConfiguration,
    )

    return (GLMOptimizationConfiguration.parse(FE_TRON_CFG),
            GLMOptimizationConfiguration.parse(RE_ENET_CFG))


def contexts_path2(train):
    """STANDARDIZATION of both shards from the training rows."""
    from photon_ml_tpu_torch.data.normalization import (
        build_normalization_context,
    )
    from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary

    def context(shard, intercept):
        return build_normalization_context(
            "STANDARDIZATION",
            BasicStatisticalSummary.compute(train.feature_shards[shard]),
            intercept)

    return context("global", D_FIXED - 1), context("user", 0)


def entity_solver_flops(e: int, r: int, d: int, m: int, iterations: int,
                        trials: int, mode: str, normalized: bool) -> float:
    """Floating-point operations one bucket's solve needs, counted from
    the kernel's code: the set-up per entity, the work of each iteration
    it ran and of each line-search trial it priced (both reported by the
    kernel). An OWL-QN trial recomputes its margins (2 r d) from the
    orthant-projected trial point; an L-BFGS trial prices cached
    margins."""
    L = LOSS_OPS
    gradient = r * (L + 1) + 2 * r * d + d
    setup = (2 * r * d + r  # z0
             + r * (L + 2) + 2 * d  # f0
             + gradient + 2 * d)  # g0 and its norm
    if normalized:
        setup += 2 * r * d  # the fold, once per entity
    history = 6 * d + 2 * m + 8  # cautious update and stop tests
    two_loop = 8 * m * d + 6 * d
    if mode == "owlqn":
        setup += 2 * d + 6 * d  # l1 |c0| and the pseudo-gradient
        per_iter = (6 * d + two_loop + 2 * d + 3 * d  # pg, dir, projection
                    + 2 * d + 4  # |dir|, t0
                    + gradient + 8 * d + history)  # g_new, |pg_new|
        per_trial = (5 * d  # trial point and orthant
                     + 2 * r * d + r  # its margins
                     + r * (L + 1) + 4 * d + 3 * d + 10)  # value, Armijo
    else:
        per_iter = (two_loop + 3 * d  # direction, descent check
                    + 2 * r * d + 2 * r  # zp = X dir
                    + 8 * d + 4  # xx, xp, pp, gp, t0
                    + 2 * d + 2 * r  # the step
                    + gradient + 2 * d + history)
        per_trial = r * (L + 4) + 10
    return float(e * setup + iterations * per_iter + trials * per_trial)


def entity_solver_bytes(e: int, r: int, d: int, normalized: bool) -> float:
    """Bytes in (x, labels, offsets, weights, coef0, and factors and
    shifts when normalized) and out (c, f, |g|, iterations, reason,
    trials), each once, float32/int32."""
    ins = e * r * d + 3 * e * r + e * d + (2 * e * d if normalized else 0)
    return 4.0 * ins + 4.0 * (e * d + 5 * e)


def cuda_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def hold_against_plain(tag: str, args, kw, main=None, check_zeros=False):
    """The kernel and its plain version on the same CUDA inputs: equal
    iterations and stop reasons (and exact-zero sets when asked), value
    and coefficients within the f32 floors. ``main`` is the main run's
    result for this bucket, which the replay must reproduce. Returns the
    kernel's result and a row of measurements."""
    import torch

    from photon_ml_tpu_torch.ops import entity_solver

    torch.cuda.synchronize()
    res_k = entity_solver.entity_lbfgs(*args, **kw)
    res_p = entity_solver.entity_lbfgs_plain(*args, **kw)
    torch.cuda.synchronize()
    kernel_ms = cuda_ms(lambda: entity_solver.entity_lbfgs(*args, **kw), 10)
    plain_ms = cuda_ms(lambda: entity_solver.entity_lbfgs_plain(*args, **kw),
                       1)
    err = float((res_k.x - res_p.x).abs().max())
    rel = float(((res_k.value - res_p.value).abs()
                 / res_p.value.abs().clamp_min(1e-30)).max())
    if main is not None:
        check(torch.equal(main.iterations, res_k.iterations)
              and torch.equal(main.reason, res_k.reason),
              f"{tag}: the replay's iterations or reasons differ from the "
              "main run's")
    check(rel <= VALUE_RTOL, f"{tag}: value rel err {rel}")
    check(err <= COEF_ATOL, f"{tag}: coefficient err {err}")
    check(torch.equal(res_k.reason, res_p.reason), f"{tag}: reasons differ")
    check(torch.equal(res_k.iterations, res_p.iterations),
          f"{tag}: iteration counts differ")
    if check_zeros:
        check(torch.equal(res_k.x == 0, res_p.x == 0),
              f"{tag}: exact-zero sets differ")
    check(bool(torch.isfinite(res_k.x).all()), f"{tag}: non-finite")
    e, r, d = args[1].shape
    mode = kw.get("mode", "lbfgs")
    normalized = len(args) > 8 and args[8] is not None
    its = int(res_k.iterations.sum())
    trials = int(res_k.trials.sum())
    bound_bytes_ms = 1e3 * entity_solver_bytes(e, r, d, normalized) \
        / HBM_BYTES_PER_S
    bound_ops_ms = 1e3 * entity_solver_flops(
        e, r, d, entity_solver.DEFAULT_M, its, trials, mode, normalized) \
        / FP64_FLOPS_PER_S
    row = dict(check=tag, entities=e, n_pad=r, d_pad=d,
               layout=entity_solver.kernel_layout(r, d),
               kernel_ms=kernel_ms, plain_ms=plain_ms,
               max_abs_coef_err=err, max_value_rel_err=rel,
               mean_iterations=its / e, mean_trials=trials / e,
               trials_differ=int((res_k.trials != res_p.trials).sum()),
               zeros=int((res_k.x == 0).sum()),
               reasons=np.bincount(res_k.reason.cpu().numpy(),
                                   minlength=5).tolist(),
               bound_bytes_ms=bound_bytes_ms, bound_ops_ms=bound_ops_ms)
    return res_k, res_p, row


def compare_first_re_update(train, fe_cfg, re_cfg, main_tracker):
    """Path 1: replay the first random-effect update's inputs (the
    residual is the fixed effect's score after its first solve) and hold
    the kernel against the plain version per bucket, on the same CUDA
    tensors; also the float32-compute experiment."""
    import torch

    from photon_ml_tpu_torch.algorithm.coordinates import (
        FixedEffectCoordinate,
        RandomEffectCoordinate,
        block_offsets,
    )
    from photon_ml_tpu_torch.data.random_effect import (
        RandomEffectDataConfiguration,
        build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.ops import entity_solver
    from photon_ml_tpu_torch.ops.losses import LogisticLoss
    from photon_ml_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    fe = FixedEffectCoordinate("fixed", train, "global", task, fe_cfg)
    ds = build_random_effect_dataset(
        train, RandomEffectDataConfiguration("userId", "user"), seed=0,
        intercept_col=0)
    re = RandomEffectCoordinate("perUser", ds, task, re_cfg)
    fe_model, _ = fe.update_model(fe.initialize_model(),
                                  re.score(re.initialize_model()))
    residual = fe.score(fe_model)
    kw = dict(max_iter=re_cfg.max_iterations, tol=re_cfg.tolerance)
    rows = []
    for bi, block in enumerate(ds.blocks):
        off = block_offsets(block, residual)
        c0 = torch.zeros((block.num_entities, block.d_pad),
                         dtype=torch.float32, device=off.device)
        args = (LogisticLoss, block.x, block.labels, off, block.weights, c0,
                re_cfg.l2_weight)
        res_k, _, row = hold_against_plain(f"path 1 bucket {bi}", args, kw,
                                           main=main_tracker[bi])
        # The float32-compute experiment: kernel vs plain, both in f32.
        kw32 = dict(kw, compute_dtype=torch.float32)
        k32 = entity_solver.entity_lbfgs(*args, **kw32)
        p32 = entity_solver.entity_lbfgs_plain(*args, **kw32)
        torch.cuda.synchronize()
        row.update(
            bucket=bi,
            kernel_f32_ms=cuda_ms(
                lambda: entity_solver.entity_lbfgs(*args, **kw32), 10),
            f32_reasons_differ=int((k32.reason != p32.reason).sum()),
            f32_iterations_differ=int(
                (k32.iterations != p32.iterations).sum()),
            f32_vs_f64_reasons_differ=int((k32.reason != res_k.reason).sum()))
        print("bucket " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


def compare_first_re_update_path2(train, fe_cfg, re_cfg, fe_norm, re_norm,
                                  main_tracker):
    """Path 2: the same replay with normalization, per bucket in "owlqn"
    mode (the main run's) and in "lbfgs" mode with the same gathered
    factors and shifts."""
    import torch

    from photon_ml_tpu_torch.algorithm.coordinates import (
        FixedEffectCoordinate,
        RandomEffectCoordinate,
        block_offsets,
    )
    from photon_ml_tpu_torch.data.normalization import (
        gathered_to_normalized_space,
    )
    from photon_ml_tpu_torch.data.random_effect import (
        RandomEffectDataConfiguration,
        build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.ops.losses import LogisticLoss
    from photon_ml_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    fe = FixedEffectCoordinate("fixed", train, "global", task, fe_cfg,
                               normalization=fe_norm)
    ds = build_random_effect_dataset(
        train, RandomEffectDataConfiguration("userId", "user"), seed=0,
        intercept_col=0)
    re = RandomEffectCoordinate("perUser", ds, task, re_cfg,
                                normalization=re_norm)
    re_model = re.initialize_model()
    fe_model, _ = fe.update_model(fe.initialize_model(), re.score(re_model))
    residual = fe.score(fe_model)
    kw = dict(max_iter=re_cfg.max_iterations, tol=re_cfg.tolerance)
    rows = {"owlqn": [], "lbfgs": []}
    for bi, (block, c0, norm) in enumerate(zip(ds.blocks, re_model.local_coefs,
                                               re.norm_blocks)):
        off = block_offsets(block, residual)
        c0 = gathered_to_normalized_space(c0, *norm).contiguous()
        args = (LogisticLoss, block.x, block.labels, off, block.weights, c0,
                re_cfg.l2_weight, re_cfg.l1_weight, norm[0], norm[1])
        for mode in ("owlqn", "lbfgs"):
            _, _, row = hold_against_plain(
                f"path 2 bucket {bi} {mode}", args, dict(kw, mode=mode),
                main=main_tracker[bi] if mode == "owlqn" else None,
                check_zeros=True)
            row.update(bucket=bi, mode=mode + "+normalized")
            print("bucket " + json.dumps(row), flush=True)
            rows[mode].append(row)
    return rows


def report_updates(result) -> None:
    import torch

    for u in result.updates:
        tracker = result.trackers[u["coordinate"]][u["iteration"]]
        if isinstance(tracker, list):  # one result per bucket
            its = torch.cat([t.iterations for t in tracker]).float()
            trials = torch.cat([t.trials for t in tracker]).float()
            solver = (f"entity iterations mean {float(its.mean()):.2f} "
                      f"max {int(its.max())}, line-search trials mean "
                      f"{float(trials.mean()):.2f}")
        elif tracker.outer_steps is not None:
            solver = (f"TRON iterations {int(tracker.iterations)} "
                      f"({tracker.outer_steps} outer, {tracker.cg_steps} "
                      f"CG), reason {int(tracker.reason)}")
        else:
            solver = (f"solver iterations {int(tracker.iterations)}, "
                      f"reason {int(tracker.reason)}")
        print(f"update: iteration {u['iteration']} {u['coordinate']}: "
              f"{1e3 * u['seconds']:.1f} ms, objective "
              f"{u['objective']:.6f}, {solver}")
    for it, m in enumerate(result.validation_history):
        print(f"validation AUC after iteration {it}: {m['AUC']:.6f}")


def check_model(result, val, tag: str) -> None:
    """Finite objectives that fall, an AUC above chance, finite
    coefficients of the right shapes, device scores equal to host
    scores."""
    import torch

    from photon_ml_tpu_torch.models.device_scoring import DeviceGameScorer

    hist = result.objective_history
    check(len(hist) == 2 * CD_ITERATIONS and all(map(math.isfinite, hist)),
          f"{tag}: objective history {hist}")
    check(hist[-1] < hist[0], f"{tag}: objective did not fall: {hist}")
    aucs = [m["AUC"] for m in result.validation_history]
    check(all(math.isfinite(a) and a > 0.5 for a in aucs),
          f"{tag}: AUC {aucs}")
    model = result.model
    re_model = model.models["perUser"]
    fe_coef = model.models["fixed"].glm.coefficients.means
    check(tuple(fe_coef.shape) == (D_FIXED,)
          and bool(torch.isfinite(fe_coef).all()), f"{tag}: fixed coefs")
    check(sum(c.shape[0] for c in re_model.local_coefs) == N_USERS
          and all(bool(torch.isfinite(c).all())
                  for c in re_model.local_coefs),
          f"{tag}: per-user coefficients")
    dev_scores = DeviceGameScorer(model, val).score(model).cpu().numpy()
    host_scores = model.score(val)
    score_err = float(np.abs(dev_scores - host_scores).max())
    print(f"{tag} hold-out scores: device vs host max abs diff "
          f"{score_err:.3g}")
    check(dev_scores.shape == (val.num_rows,)
          and np.isfinite(dev_scores).all() and score_err <= 1e-3,
          f"{tag}: device scorer disagrees with the host scorer")


def kernel_entry(name: str, rows, launches: int) -> dict:
    bound_bytes = sum(r["bound_bytes_ms"] for r in rows)
    bound_ops = sum(r["bound_ops_ms"] for r in rows)
    return {
        "name": name,
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max(r["max_abs_coef_err"] for r in rows),
        "ms": sum(r["kernel_ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": None,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    try:
        from photon_ml_tpu_torch.data.random_effect import (
            RandomEffectDataConfiguration,
        )
        from photon_ml_tpu_torch.estimators.game_estimator import (
            FixedEffectSpec,
            GameEstimator,
            RandomEffectSpec,
        )
        from photon_ml_tpu_torch.evaluation.evaluators import (
            AreaUnderROCCurveEvaluator,
        )
        from photon_ml_tpu_torch.ops import cuda_build, entity_solver
        from photon_ml_tpu_torch.types import TaskType
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc}); run it from the "
              "repository root", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmul and cudnn (float32 products in full "
          "float32)", flush=True)

    t0 = time.perf_counter()
    builds = cuda_build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s for "
          f"{sorted(builds)}", flush=True)
    for name, rep in builds.items():
        for line in rep["log"].splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    data = build_problem()
    cut = int(round(N_ROWS * (1 - HOLDOUT)))
    train = data.subset(np.arange(cut))
    val = data.subset(np.arange(cut, N_ROWS))
    print(f"data: {train.num_rows} train / {val.num_rows} hold-out rows, "
          f"{D_FIXED} fixed features, {N_USERS} users x {D_USER} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    task = TaskType.LOGISTIC_REGRESSION
    auc = AreaUnderROCCurveEvaluator()
    user_cfg = RandomEffectDataConfiguration("userId", "user")

    # ---------------- path 1: the headline GLMix, L-BFGS/L2 ----------------
    fe_cfg, re_cfg = configs()
    estimator = GameEstimator(
        task, [FixedEffectSpec("fixed", "global", [fe_cfg]),
               RandomEffectSpec("perUser", user_cfg, [re_cfg],
                                intercept_col=0)],
        num_iterations=CD_ITERATIONS, validation_evaluators=[auc])
    # ---- the main path: counts set to 0 just before, read just after ----
    entity_solver.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (_, result), = estimator.fit(train, val)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches1 = dict(entity_solver.entity_lbfgs.variants)
    # ----------------------------------------------------------------------
    buckets = len(result.model.models["perUser"].local_coefs)
    print(f"path 1 fit: {fit_s:.2f} s (random-effect dataset build "
          f"included), {buckets} buckets", flush=True)
    report_updates(result)
    print(f"path 1 entity-solver launches: {launches1} (buckets x "
          f"iterations = {buckets * CD_ITERATIONS})", flush=True)
    check(launches1 == {"lbfgs": buckets * CD_ITERATIONS},
          f"path 1 launches {launches1} != {buckets} x {CD_ITERATIONS} "
          "lbfgs")
    check_model(result, val, "path 1")
    rows1 = compare_first_re_update(train, fe_cfg, re_cfg,
                                    result.trackers["perUser"][0])
    print("float32 compute, kernel vs plain: "
          f"{sum(r['f32_reasons_differ'] for r in rows1)} of {N_USERS} "
          "entities stop for different reasons, "
          f"{sum(r['f32_iterations_differ'] for r in rows1)} after "
          "different iteration counts; float32 kernel "
          f"{sum(r['kernel_f32_ms'] for r in rows1):.4f} ms vs float64 "
          f"{sum(r['kernel_ms'] for r in rows1):.4f} ms", flush=True)

    # ------- path 2: TRON fixed effect, elastic-net per-user effect, -------
    # ------- both standardized --------------------------------------------
    fe_cfg2, re_cfg2 = configs_path2()
    t0 = time.perf_counter()
    fe_norm, re_norm = contexts_path2(train)
    print(f"path 2 normalization contexts: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    estimator2 = GameEstimator(
        task, [FixedEffectSpec("fixed", "global", [fe_cfg2],
                               normalization=fe_norm),
               RandomEffectSpec("perUser", user_cfg, [re_cfg2],
                                intercept_col=0, normalization=re_norm)],
        num_iterations=CD_ITERATIONS, validation_evaluators=[auc])
    # ---- the main path: counts set to 0 just before, read just after ----
    entity_solver.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (_, result2), = estimator2.fit(train, val)
    torch.cuda.synchronize()
    fit2_s = time.perf_counter() - t0
    launches2 = dict(entity_solver.entity_lbfgs.variants)
    # ----------------------------------------------------------------------
    model2 = result2.model
    buckets2 = len(model2.models["perUser"].local_coefs)
    print(f"path 2 fit: {fit2_s:.2f} s (random-effect dataset build "
          f"included), {buckets2} buckets", flush=True)
    report_updates(result2)
    print(f"path 2 entity-solver launches: {launches2} (buckets x "
          f"iterations = {buckets2 * CD_ITERATIONS})", flush=True)
    check(launches2 == {"owlqn+normalized": buckets2 * CD_ITERATIONS},
          f"path 2 launches {launches2} != {buckets2} x {CD_ITERATIONS} "
          "owlqn+normalized")
    check_model(result2, val, "path 2")
    re2 = model2.models["perUser"]
    real = [f >= 0 for f in re2.feat_idx]
    zeros = sum(int(((c == 0) & m).sum())
                for c, m in zip(re2.local_coefs, real))
    total = sum(int(m.sum()) for m in real)
    print(f"path 2 per-user coefficients exactly zero: {zeros} of {total}",
          flush=True)
    check(zeros > 0, "path 2: the elastic net gave no exact zeros")
    rows2 = compare_first_re_update_path2(
        train, fe_cfg2, re_cfg2, fe_norm, re_norm,
        result2.trackers["perUser"][0])

    kernels = [
        kernel_entry("entity_lbfgs[lbfgs] (row 1)", rows1,
                     launches1.get("lbfgs", 0)),
        kernel_entry("entity_lbfgs[normalization fold] (row 2)",
                     rows2["lbfgs"],
                     sum(n for v, n in launches2.items()
                         if v.endswith("+normalized"))),
        kernel_entry("entity_lbfgs[owlqn] (row 4)", rows2["owlqn"],
                     launches2.get("owlqn+normalized", 0)),
    ]
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel of the paths did not launch: {kernels}")
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        sys.exit(1)
