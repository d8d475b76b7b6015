#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's GLMix training paths on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

It builds the port's CUDA kernels from photon_ml_tpu_torch/csrc/ with
nvcc (one process per translation unit, all at once), then trains
bench.py's data at its full size (seed 7: 200k rows x 200 fixed features
with an intercept, 5k users x 25 per-user features, 2k items x 16
per-item features, both with an intercept in column 0, logistic; a 20%
hold-out scored for AUC) through photon_ml_tpu_torch's GameEstimator on
five paths, 3 coordinate-descent iterations each, path 6 through the
training and scoring drivers and path 7 through the GLM driver, paths
8-11 through the streamed trainer and the serving paths, path 12 over
the network, path 13 over a 1-D mesh of two slots of cuda:0, path 14
over 2-D (data x model) meshes of slots of cuda:0, path 16 through the
feature-indexing job and damped Newton:

- path 1, the headline GLMix of bench.py: fixed effect L-BFGS max_iter
  50, tol 1e-7, L2 1; per-user L-BFGS max_iter 20, tol 1e-6, L2 1;
- path 2, the full-surface GAME demo's two GLM coordinates
  (examples/run_game_full.sh:36-38): fixed effect TRON/L2
  "15,1e-5,1.0,1.0", per-user elastic net "30,1e-6,0.5,1.0,LBFGS,
  ELASTIC_NET,0.5" (OWL-QN, l1 = l2 = 0.25), both under STANDARDIZATION
  (the fixed effect's intercept is column 199, the per-user one's 0);
- path 3, per-entity TRON: bench.py's config-5 coordinates without its
  factored one (fixed, per-user, per-item), every one TRON/L2
  "15,1e-5,1.0,1.0" (the reference's TRON defaults that
  run_game_full.sh:36 gives its fixed effect); fixed and per-user under
  STANDARDIZATION as on path 2, per-item without normalization;
- path 4, box constraints: the same three coordinates, fixed and
  per-user with path 1's L-BFGS configurations, per-item TRON/L2
  "15,1e-5,1.0,1.0"; every coordinate gets a coefficient box made with
  optimization/config.constraint_arrays, intercept free: |c| <= 0.5
  (fixed), 0.25 (per-user), 0.1 (per-item). The fixed effect runs the
  host projected L-BFGS (optimization/lbfgs.minimize_lbfgs);
- path 5, bench.py's full GAME (config 5, bench.py:200-228): path 1's
  fixed and per-user coordinates, a per-item one with the per-user
  configuration, and the factored itemFactors coordinate on the item
  shard (latent solves and refit of B both L-BFGS max_iter 20, tol 1e-6,
  L2 1; one MF alternation, k = 4), whose latent buckets [E, n_pad, 4]
  go through the entity-solver kernel.

Path 6 runs the drivers a user would call on Avro inputs: the first
40,000 training and 10,000 hold-out rows of the same data (the one cut,
rows only: the pure-Python codec writes them at ~1.4 ms a row, and path
8 trains on them five times), written as
TrainingExampleAvro by the port's codec in worker processes (features
g*, u*, i*, userId and itemId in metadataMap) beside three JSON
feature-index stores (global, user, item); then
photon_ml_tpu_torch.cli.game_training_driver.run with bench.py's config
5 (path 5's coordinates and configurations, 3 iterations, evaluators
AUC and LOGISTIC_LOSS), which saves the best model in the reference's
layout, and game_scoring_driver.run on the hold-out. Its checks: the
entity kernel launched once per bucket and solve during the driver run,
as many times as GameEstimator.fit on the decoded files (decoded in two
workers while the driver runs) launches it; the driver's objective
history equals that fit's bit for bit; every bucket of that fit's first
update (per user, per item and the factored effect's latent buckets),
replayed against the plain version as on paths 1-5; the saved model,
loaded back by
io/model_io.load_game_model, gives the trained coefficients (fixed,
per-user, per-item, the factored effect in the original space, its
gamma and B) exactly; the scoring driver's AUC equals the best
validation AUC of training within 1e-6 (DeviceGameScorer scores on the
card and raises on a sub-model it cannot score; no host path). It prints
the write, ingest, solve, finalize and score seconds and each update's
ms. Every driver run of paths 6-10 runs with telemetry on (as every
driver run does); path 6's training run also takes --trace-out and
--profile-output-dir, and its checks add: the telemetry block's stages
(driver, ingest, solve, finalize) and an attributed wall fraction of at
least 0.9, the Chrome trace parsed with one named track a thread, and
the torch.profiler trace of the solve (CPU and CUDA activity) holding
one entity-kernel event per launch the wrapper counted. From that trace
it prints the solve's device busy share (the union of kernel, memcpy
and memset intervals over the profiled window), its idle share, the
three largest idle gaps with the host operations under them, and the
device ms by kernel name.

Path 7 runs the GLM driver (photon_ml_tpu_torch.cli.glm_driver.run, in
this process) on path 6's files before they are removed, with the flags
of examples/run_glm_driver.sh (logistic, LBFGS, λ grid 100,10,1,0.1, L2,
80 iterations, STANDARDIZATION, variances) plus --diagnostic-mode ALL
with 4 bootstrap samples and a feature summary, through path 6's
``global`` index store: bench.py's fixed-effect width, g0..g198 and the
intercept (the u*/i* features are dropped as unknown, as the
reference's ingest drops them). Its one cut is path 6's: rows. The
driver's decoded matrices are kept by wrapping its ``_load`` (no second
decode). Its checks: the stages INIT..DIAGNOSED and four finite λ;
train_glm_models on the kept matrix gives the driver's iterations,
reasons and objectives bit for bit, coefficients on the card;
best-model/model.avro loads as the best λ's means and variances exactly
and model.txt has a line per feature; the best λ's validation AUC
equals evaluate_glm on the loaded model's host scores within 1e-12 and
beats 0.5; the variances are finite, positive and within rtol 1e-3 of
the float64 host formula 1 / (diag H + 1e-12) at the same solve-space
coefficients; model-diagnostic.json has four chapters with every
section. It launches no kernel of the table (checked). Then the
full-width phase runs train_glm_models on the training fixed shard
(160,000 x 200) with the same grid, STANDARDIZATION and variances, with
float32 and with bfloat16 storage (which must stay bfloat16), printing
per λ the iterations, seconds and ms per iteration; each λ's bf16
objective must lie within rtol 2e-3 of float32's
(docs/F32_PARITY.md:75-77) and every variance be finite and positive.

Path 8 runs the training driver's --stream-train on path 6's files
before they are removed (the fixed effect over the ``global`` shard,
L-BFGS/L2 on a 4-point λ grid with --grid-batched off, --feeder native,
4,096-row shards) five ways: resident (exact assembly, the one-shot
estimator), --hbm-budget above the shard's device bytes, at a quarter
of them with f32 buffer spill, the same with --spill-source redecode on
one λ (the quarter run's best: a cut of depth, since the redecode run
re-decodes every miss), and with --spill-dtype bf16, each with
--distmon; the one-shot driver on the same flags; and the budget-above
run without --distmon.
Its checks: the C decoder decoded every run; evictions where the budget
forces them; the three f32 spill runs' decoded best models are the same
records; the resident run's are the one-shot driver's; the bf16 model is
within the JAX package's bf16 bound of the f32 one; the streamed
validation AUC equals the batch scoring driver's within 1e-6; the
deterministic CSR product (kernel row 9, csrc/csr_spmv.cu) launched in
every spill run; the registry's shard-cache counters (hits, misses,
evictions, bytes re-uploaded and re-decoded) equal each cached run's
``stream_train.cache`` block; --distmon moves no model bit (the plain
budget-above run's records are the f32 spill runs'); the five runs'
``data_quality.state_sha256`` is one value, over 40,000 rows; the spill
runs' convergence rings carry steps and the resident run's come from
the solver history; every best model carries reference label and score
sketches of 40,000 rows, the f32 runs' score medians within 5% of each
other.
It prints each run's phases and cache counters, its distribution
summary, and the C decoder's and the pure-Python codec's ms a row on
one of the files.
Then the full-width stream phase feeds bench.py's training fixed shard
(160,000 x 200, CSR float32 with int32 indices, nothing cut) from
memory in 16,384-row batches into the shard cache and solves streamed
L-BFGS/L2 with no budget and at a quarter of the shard's device bytes:
ms per iteration, feature passes per solve, bytes re-uploaded per pass
and their rate against a pinned copy_, and the two budgets' coefficients
bit for bit. Row 9 is held against its plain version (torch.mv on the
same CSR, cuSPARSE on the card) on one of its blocks within 1e-5 of
sum |a x|, and against itself over 20 calls bit for bit (cuSPARSE's own
repeatability is printed); its matvec+rmatvec pair is timed (call and
device ms) beside torch.mv's, with the host ms of each call.

Path 9 (the second half of streamed training) runs the training driver
on path 6's files three ways. Grid: path 8's quarter-budget f32 run with
--grid-batched on (all four λ advance per feature pass); it must select
path 8's sequential best λ with fewer feature passes and fewer bytes
re-uploaded. Ingest: path 6's one-shot flags with --ingest-workers 4
against 1 (worker processes that import no torch); the decoded arrays
and the trained models must be the same bytes, and the ingest seconds of
both and of path 7's GLM driver at auto are printed. MF: --stream-train
of the itemFactors coordinate alone (config 5's MF, k = 4, 2,000 items,
its 20-iteration refit of B, nothing cut) under LINEAR_REGRESSION with
no budget, a 16K budget that evicts factor shards, that budget with bf16
spill and with redecode spill; the no-budget, f32 and redecode factors
must be the same bits and bf16 within 5% of the largest factor value
(the JAX package's bound); the no-budget run takes --distmon, whose
monitor must count the 40,000 rows once (one observed pass), sum its
itemId heavy hitters over them, and write a label-only reference. Kernel
row 10 (csrc/csr_spmm.cu, the deterministic CSR x panel product)
launches in the grid and MF runs, and is held at the shapes MF gave it
(the normal equations' entity x row CSR with its [rows, 20] panel, one
column tile; the feature block with B^T and its transpose) against its
plain version and column by column against row 9, each product's call
and device ms printed beside its bound. Then the grid full-width phase
solves the full-width stream phase's shard (160,000 x 200 from memory)
by batched L-BFGS at G = 4 and 8 against the sequential sweep of the
same λ, with no budget and at 25% (ms per iteration, feature passes,
bytes re-uploaded, the same selected λ), reports whether a G > 1 lane's
value and gradient are the scalar path's bits, and holds row 10 against
its plain version (torch.sparse.mm) within 1e-5 of sum |a x|, column by
column against row 9 bit for bit and itself over 20 calls, timed at n =
4 and 8 against n calls of row 9, cuSPARSE's SpMM and its bound. The
order contract of rows 9 and 10 (csrc/csr_order.cuh: a row's additions
depend on its own length only) is checked: a row of 3, L - 1, L, L + 1
and 3L + 5 entries (L the chunk) first in one CSR and last in another
gives the same bits in both, the contract's (spmv.csr_order_reference),
in row 9 and in row 10 at n = 4 and 20. Last, 20 calls bit for bit each:
the batched ridge solve of streamed MF (torch.linalg.solve on [2048, 4,
4]) and the in-core CSRFeatures' four products (row 9).

Path 10 serves path 6's saved model (config 5 at full width, loaded
from the reference's model files) on its 10,000 hold-out rows through
the scoring driver's in-process serving paths (serving/engine.py,
serving/frontend.py): --stream with 4,096-row batches, --serve with
one-row requests (16 requesters, 2 ms coalesce windows) and --serve
with 8-row requests. Each bucket shape is one CUDA graph: the row-9
fixed-effect product, the random effects' row sums through row 9 and
the MF dots, captured once and replayed per dispatch. Its checks: each
run's scores within 2 gamma_n S of path 6's batch scores a row (n the
row's products, S the sum of their absolute values, u = 2^-24: the
bound on two float32 summation orders), its AUC within 1e-6 of the
batch run's, the front-end's admitted == completed and no request
rejected, failed or cancelled, graphs built == the distinct bucket
shapes dispatched, each captured once, every bucket's replay bit for
bit its eager function, and the three runs' scores bit for bit equal
for every row whatever was coalesced with it; the executable profiler
counted every dispatch; the front-end's registry counter of completed
requests equals its admitted and completed ones; the one-row run's
--trace-out passes the telemetry checks. It prints rows a second,
dispatches, padding waste, graphs, per bucket the ms of a replayed
against an eager dispatch, the profiler's table (per rows bucket:
dispatches, mean and max dispatch-to-settle ms, est. FLOP/s) and the
served request latency and queue wait P50/P95/P99. Last, the one-row
requests are replayed through a front-end outside the driver with
telemetry off and on in turns (off, on, on, off): rows a second each,
and the scores must be the same bytes.

Path 11 serves path 8's resident best model (trained with --distmon, so
it carries reference distributions) on path 6's 10,000 hold-out rows
and on a shifted copy (the global shard's values x4, written through
the port's codec): --serve --distmon with 8-row requests, 16
requesters, 2 ms windows, --obs-port 0, a drift SLO (PSI <= 0.25) and
a P99 latency SLO (<= 50 ms) on both inputs, then --stream --distmon on
the shifted one. A thread scrapes each run's live plane (/readyz,
/metrics, /distz) and an in-process fleet aggregator polls its
/snapshotz. Its checks: PSI < 0.1 unchanged and > 0.25 shifted; the
drift SLO compliant, then violated; the served and streamed shifted
score quantile sketches the same state bit for bit; 10,000 rows in
``score_distribution``; legal Prometheus names, front-end counters
with ``_total``, live /distz scores, and the aggregator's merged
serving counters equal to the run's metrics.json. Last, the 8-row
requests are replayed outside the driver with the score monitor off
and on in turns (off, on, on, off): rows a second each, the same
score bytes.

Path 12 serves the same model over the network (serving/netserver.py,
serving/router.py, serving/adaptive.py): replicas of ``python -m
photon_ml_tpu_torch.cli.game_scoring_driver --listen 127.0.0.1:0
--coalesce-ms 2 --obs-port 0``, each a fresh process with its own CUDA
context on device 0, and ``python -m photon_ml_tpu_torch.cli.net_router``
in front of two of them; this process is the client, over real sockets.
(a) The 10,000 hold-out rows as one-row binary frames (16 connections,
32 frames in flight each), then as 8-row HTTP/1.1 keep-alive requests:
every score bit for bit path 10's --stream score of its row, the two
framings the same bytes, the replica's counters exact and its graphs one
a bucket shape; rows a second and client P50/P99 for each framing beside
path 10's in-process figures. (b) A malformed frame between good ones,
an oversized frame and an unknown model, each answered with its typed
error, no neighbour's score moved. (c) The fleet: every score (a)'s,
the router's forwarded == returned, no backend error, both replicas
answering, the CUDA driver mapped in both replicas and never in the
router. (d) A replica with --adaptive-admission and a P99 SLO at (a)'s
served one-row P99, driven by an open-loop burst at 4x (a)'s rate, then
idle: it tightens, then relaxes, and sheds only as typed ``shed``
answers. Every process stops by SIGINT and must drain and exit 0; its
row-9 launches (graph replays and builds times the launches a graph
captures) must equal the process's own count.

Path 13 trains over the 1-D device mesh (photon_ml_tpu_torch/parallel/,
``make_mesh(2, device="cuda:0")``: two slots of the one card; slots on
one card measure the fold's correctness, not its scaling). (a) The
training driver's path-8 quarter-budget f32 run (--distmon, path 8's
grid swept one λ at a time) with --mesh-devices 2 and half the quarter
budget per slot: every λ's model records equal path 8's, each slot
evicted and ended within its budget, ``stream_train.cache`` carries
``mesh_devices`` 2 and ``per_device_bytes`` and the registry equals it,
and row 9 launched as often as in path 8's run. (b) Path 9's batched
grid at --mesh-devices 2 writes path 9's grid model bit for bit. (c) On
a cache placed like (a)'s, through the API, one value, gradient and Hvp
with ``combine="local"`` lie within (S - 1) eps sum |p_i| of the ordered
fold's. (d) GameEstimator(mesh=) on path 5's coordinates: from the same
offsets each random-effect and the factored coordinate's first update
over two slots gives the unsharded update's coefficients, reasons and
iterations bit for bit with two entity-kernel launches a bucket and the
padding entities zero; the whole fit's objective history lies within
rtol 1e-5 of path 5's and its final AUC within 1e-4. It prints its
seconds and its launches of rows 1-6, 9 and 10.

Path 14 trains over the 2-D (data x model) mesh
(``make_mesh_2d(R, C, device="cuda:0")``: R x C slots of the one card;
the coefficients' column blocks on the model axis, ROADMAP A6b). (a)
Path 8's quarter-budget f32 run (path 8's files and grid, swept one λ at
a time, --feeder native, path 8's batch rows) through the training
driver at --mesh-shape 1x2 and 2x2, half the quarter budget per slot:
every λ's model records equal the quarter run's bit for bit, every slot
evicted and ended within its budget, ``stream_train.cache`` carries
``col_blocks``, ``col_block_size`` and ``per_device_bytes`` for 2 and 4
slots and the registry equals it, and row 9 launched as often as path
8's run plus S (C - 1) launches for each pass that carries a transposed
product (S shards; the passes counted in the run; the count printed).
(b) Path 9's batched grid at 2x2 writes path 9's grid model bit for bit.
(c) Path 8's --spill-source redecode run at 2x2, twice the quarter
budget a slot (a miss re-decodes its rows; the slots of column 0, which
also hold their shards' product maps, still evict), writes its records
bit for bit. (d) GameEstimator(mesh=make_mesh_2d(2, 2, device="cuda:0")) on
path 5's coordinates with the fixed effect feature-sharded: each random-
effect and the factored coordinate's first update over the mesh gives
the unsharded update's bits with two entity-kernel launches a bucket
(one a data row) and the padding entities zero, the fixed effect's
first update lies within value rtol 1e-5 and coefficients atol 2e-3 (the
float32 floor of tests/test_distributed.py) of the unsharded one, the
fit's objective history within rtol 1e-5 of path 5's and its final AUC
within 1e-4. (e) A world of one process joins over loopback on nccl
(``initialize_multihost``), is the primary host, all-reduces a tensor
on cuda:0 and leaves. It prints its seconds and its launches of rows 1,
9 and 10.

Path 16 runs the tooling a user of examples/run_game_full.sh calls
first, on path 6's files. (a) The port's feature-indexing job
(photon_ml_tpu_torch.cli.feature_indexing.run) twice on the training
files: with run_game_full.sh:20-23's flags (--format paldb
--partition-num 2 --shard-name global) and --save-name-and-term-sets
true, and with --format json. Both stores load through
load_feature_index_maps, hold path 6's 238 names and the intercept at
indices contiguous from 0; every PalDB partition holds both directions;
the JSON map is build_index_map's; the two name-and-term text sets are
equal. (b) run_game_full.sh's fixed and per-user coordinates (TRON/L2
fixed effect over global, elastic-net per-user effect over global, one
coordinate-descent iteration) through the training driver five times:
with --feature-index-dir on the PalDB stores, on a JSON store holding
the map they load as (the same columns: the model records and the
objective history bit for bit), and on the scan-order JSON store; then
on the PalDB stores and the scan-order store again with the per-user
solves run to convergence (500 iterations, tolerance 1e-12). That map
orders the columns otherwise, so its models are compared by feature
name, for either per-user budget: hold-out AUCs within 1e-4,
fixed-effect coefficients within 1e-3, the per-user coefficients'
largest difference printed with each run's per-user stop reasons. The
other order of the float32 sums moves the fixed effect and so every
per-user offset, and the flags' per-user solves, cut at 30 iterations
and a relative tolerance of 1e-6, carry that on; with the solves
converged every per-user coefficient is held within 1e-3. The per-user
solves launch row 4 ("owlqn"), as often in every run. (c) minimize_newton in float64 on path 1's
per-user bucket of n_pad 32 (2,755 entities, d_pad 32, path 1's λ; dense
tensors: torch.func differentiates no ctypes kernel) on the card and on
the CPU: equal iterations and reasons for every entity, coefficients
within 1e-9, every entity's objective within rtol 1e-6 of row 1's
L-BFGS on the same inputs run to convergence (tol 1e-12; at path 1's
tolerance row 1 stops some entities ~1e-5 above their optimum, and no
entity's Newton objective may lie above that solution by more than rtol
1e-6); it prints the ms an iteration. It prints its
seconds and its part of row 4's launches.

Paths 1-6 fit through the fused coordinate update (ROADMAP A3a): each
in-core coordinate update is one replay of a CUDA graph captured once a
run, its solvers' loops WHILE nodes (photon_ml_tpu_torch/utils/
device_loop.py, csrc/device_loop.cu), its launches counted per replay;
each fit prints its digest (sha256 of its coefficients and objective
history) and one ``graph`` line a coordinate (nodes, loop bodies,
capture and instantiate seconds, pool bytes). Path 15 (right after path
5) refits paths 1-5 through the eager plain loop
(``GameEstimator(fused=False)``: every solver loop reads its predicate
on the host) and holds them against the fused fits bit for bit: digest,
objective history, validation AUCs, every tracker tensor of every
update, and the row-1 and row-9 launches; paths 1-5 are dense, so it
also fits path 1's coordinates both ways on a copy of the data whose
global shard is thinned to a tenth of its entries (CSRFeatures: row 9
inside the fixed effect's update graph, which must launch it as often as
the eager fit does). It prints a ``path 15`` line a fit with both fits'
ms per update in iterations 0-2 (span averages: the capture falls
outside every span), both fits' seconds (captures included) and the
graphs' figures. Path 6's profile line adds the busy share from the first graph
replay on.

Then the gather phase runs the port's gather experiment
(photon_ml_tpu_torch/dev_scripts/gather_experiments.py) at its full
width, m = 12,000,000 lookups into d = 2,000,000 coefficients: w[idx],
the one-hot scan in torch, and kernel rows 7 (the one-hot tensor-core
gather) and 8 (the residue-class gather: one CTA per residue class, its
column of the table in shared memory), each verified against w[idx] and
timed; and the residue packing in torch ops on the card, bit for bit
against the numpy packing, both timed.

For each path it checks:

- every random-effect bucket went through the entity-solver kernel in
  the path's variants ("lbfgs" on path 1, "owlqn+normalized" on path 2,
  "tron+normalized" per user and "tron" per item on path 3,
  "lbfgs+bounded" per user and "tron+bounded" per item on path 4):
  launches == buckets x iterations per variant, counted from 0 just
  before the path's fit and read just after;
- per bucket of the first update of every random-effect coordinate,
  replayed on the same inputs (the replay must give the main run's
  iterations and stop reasons), the kernel against its plain PyTorch
  version on the same CUDA inputs: value rtol 1e-4, coefficients atol
  5e-3 (the f32 floors of tests/test_pallas_entity_solver.py), equal
  iterations, stop reasons and work (line-search trials, or TRON's trips
  and CG steps); on path 2 equal exact-zero sets, in "owlqn" mode and in
  "lbfgs" mode with the same gathered factors and shifts; on path 4
  equal sets of coefficients at a bound; on path 3's per-user buckets
  also TRON with the fold and path 4's per-user box, a variant no path
  launches;
- objectives, AUC and scores are finite, the objective falls, the AUC
  beats chance, and the device scorer agrees with the host scorer; on
  path 4 every coefficient lies in its box and every coordinate has
  coefficients exactly at a bound.

Path 1 also measures, per bucket, how many entities the float32-compute
kernel and the float32 plain version stop with different reasons or
iteration counts (the reason both compute in float64 by default), and
the float32 kernel's time.

Then the gather phase holds both gather kernels against their plain
versions exactly (row 8 also past its column layout's limit, in its l2
layout), sweeps kernel row 7's
launch (B viewed [2048 / N, N] for each N, times the warps per CTA) at
full width, each candidate exactly equal to the plain version, and
prints every time beside w[idx]'s from the same run.

TF32 is switched off for matmuls and cuDNN, so every float32 product
runs in full float32. Timings are CUDA-event or synchronised host times
on the card named in the output. Each kernel has a call time (CUDA
events around back-to-back wrapper calls: ``kernel_ms``/``call_ms`` in a
bucket line, ``ms`` in the kernels line) and a device time (the calls
captured in one CUDA graph and replayed between events: ``device_ms``);
bucket lines also carry the launch plan (lanes over the coordinates,
resident entities, waves).

    python3 chip_smoke.py --entity-buckets [--tree DIR]
    python3 chip_smoke.py --fit-digests [--tree DIR]

times only the entity-solver kernel of DIR's photon_ml_tpu_torch (this
checkout by default) on every bucket of paths 1-5's first updates:
device, call and host ms, occupancy, the spread of the entities'
iterations and a digest of every entity's iterations, reason and work
(``stops``), one ``ab`` line each; run it on two trees in turns to
compare them on one card (equal digests: no entity's stop moved).
``--fit-digests`` fits paths 1-5 with DIR's GameEstimator at its
defaults and prints a ``digest`` line a path (digest, AUCs, entity-kernel
launches, fit seconds): equal digests in two trees' lines mean the same
coefficients and objective histories.

The third line from the end is a JSON record of the kernels (rows 1-8
of the PERF.md table: L-BFGS, the normalization fold, bounded L-BFGS,
OWL-QN, TRON and bounded TRON, the one-hot and the residue-class gather,
each with its launches on the main paths, path 6's, path 13's and
path 14's among row 1's, path 16's per-user solves among row 4's, times
and bound; row 9, the deterministic CSR product, with its launches in
path 8 and the full-width stream phase and the launches path 10's bucket
graphs executed (wrapper calls, less those recorded at capture, plus
replays times the launches a graph holds), with path 11's and the
path-12 replicas' (counted from their metrics.json), path 13's and
path 14's; row 10, the CSR x panel product, with its launches in path 9,
paths 13 and 14 and the grid phase and its times
at MF's shapes), then the
card's name and power limit, and the last line is {"ok": true,
"device": ...}. It exits non-zero, printing no result, without CUDA or
when any check fails.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import itertools
import json
import logging
import math
import multiprocessing
import signal
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

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
# Path 4's coefficient boxes, |c| <= bound, intercepts free.
FE_BOX, USER_BOX, ITEM_BOX = 0.5, 0.25, 0.1
SOURCE = "photon_ml_tpu_torch/csrc/entity_lbfgs.cu"
REPLACES = "photon_ml_tpu/ops/pallas_entity_solver.py:963"
# bench.py:_configs, :218-227: the factored coordinate's MF knobs.
MF_ITERATIONS, MF_FACTORS = 1, 4
# The gather experiment's full width (dev_scripts/gather_experiments.py
# :411-425) and --check's size.
GATHER_M, GATHER_D = 12_000_000, 2_000_000
CHECK_M, CHECK_D = 3_000, 4_096
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores


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
    same order, so the data is bench.py's."""
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
    return GameDataset.build(
        responses=y,
        feature_shards={"global": sp.csr_matrix(x),
                        "user": sp.csr_matrix(xu),
                        "item": sp.csr_matrix(xi)},
        ids={"userId": users.astype(str), "itemId": items.astype(str)})


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
                        trials: int, mode: str, normalized: bool,
                        bounded: bool = False) -> float:
    """Floating-point operations one bucket's L-BFGS or OWL-QN solve
    needs, counted from the kernel's code: the set-up per entity, the
    work of each iteration it ran and of each line-search trial it priced
    (both reported by the kernel). An OWL-QN or bounded trial recomputes
    its margins (2 r d) from the projected trial point; an L-BFGS trial
    prices cached margins."""
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
    elif bounded:
        setup += 2 * d  # c0 projected
        per_iter = (two_loop + 3 * d + 2 * d + 4  # direction, |dir|, t0
                    + gradient + 2 * d + history)
        per_trial = (4 * d  # c + t d, clamped
                     + 2 * r * d + r  # its margins
                     + r * (L + 1) + 2 * d + 3 * d + 10)  # value, Armijo
    else:
        per_iter = (two_loop + 3 * d  # direction, descent check
                    + 2 * r * d + 2 * r  # zp = X dir
                    + 8 * d + 4  # xx, xp, pp, gp, t0
                    + 2 * d + 2 * r  # the step
                    + gradient + 2 * d + history)
        per_trial = r * (L + 4) + 10
    return float(e * setup + iterations * per_iter + trials * per_trial)


def tron_flops(e: int, r: int, d: int, outer: int, cg: int,
               normalized: bool, bounded: bool) -> float:
    """Floating-point operations one bucket's TRON solve needs, counted
    from the kernel's code with the trips and CG steps it reports: per
    trip the curvature weights, the trial's margins, value and gradient,
    the model and radius arithmetic (bounded: the pinned mask, the
    clamped trial and one more Hv); per CG step one Hv and the dot
    products and vector updates."""
    L = LOSS_OPS
    gradient = r * (L + 1) + 2 * r * d + d
    hv = 2 * r * d + r + 2 * r * d + 2 * d  # X v, d2w . , X^T u + l2 v
    stat = 5 * d if bounded else 2 * d
    setup = (2 * r * d + r + r * (L + 2) + 2 * d + gradient + stat)
    if normalized:
        setup += 2 * r * d
    if bounded:
        setup += 2 * d
    per_trip = (r * (L + 1)  # d2w
                + 4 * d  # CG start: residual, direction, |g|
                + d + 2 * r * d + r + r * (L + 2) + 2 * d  # trial, f_t
                + gradient + 2 * d + 2 * d + 2 * d  # g_t, g.s, s.r, |s|
                + 30 + 2 * d + stat)  # radius, accept, stationarity
    if bounded:
        per_trip += 6 * d + 3 * d + hv + 2 * d  # pins, clamp, extra Hv
    per_cg = (hv + (2 * d if bounded else 0)  # the mask
              + 2 * d + 3 * d + 6 * d  # d.Hd, |s + a d|^2, s.d, d.d, s.s
              + 4 * d + 2 * d + 2 * d + 20)  # s, r updates, r.r, d
    return float(e * setup + outer * per_trip + cg * per_cg)


def entity_solver_bytes(e: int, r: int, d: int, normalized: bool,
                        bounded: bool = False, tron: bool = False) -> float:
    """Bytes in (x, labels, offsets, weights, coef0, and factors and
    shifts when normalized, lower and upper when bounded) and out (c, f,
    |g|, iterations, reason, trials or trips, and TRON's CG steps), each
    once, float32/int32."""
    ins = (e * r * d + 3 * e * r + e * d + (2 * e * d if normalized else 0)
           + (2 * e * d if bounded else 0))
    return 4.0 * ins + 4.0 * (e * d + (6 if tron else 5) * e)


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


def device_ms(fn, reps: int = 10) -> float:
    """Mean device ms per call of ``fn``, without its host work: ``reps``
    calls captured in one CUDA graph (after a warm-up call, which plans
    and builds outside the capture), the graph replayed 3 times between
    CUDA events. The launches recorded into the graph count nowhere
    (``device_loop.uncounted``; a tree without it counts them as
    ``recorded``)."""
    import torch

    try:
        from photon_ml_tpu_torch.utils.device_loop import uncounted
    except ImportError:
        uncounted = contextlib.nullcontext
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with uncounted(), torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = cuda_ms(graph.replay, 3) / reps
    del graph
    return ms


def host_ms(fn, calls: int = 100) -> float:
    """Mean host ms per call of ``fn`` over ``calls`` calls with no
    synchronise between them (the host's share of a call)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / calls


# The occupancy of a tree whose entity solver has no plan query (an older
# checkout's): its own launch plan and kernel instance (logistic loss,
# shared layout) asked of cudaOccupancyMaxActiveBlocksPerMultiprocessor.
_PROBE_SRC = r"""
#include "entity_lbfgs.cuh"
using namespace entity_lbfgs;
template <typename T, int MODE>
static int occ(int r, int d, int m, int* out) {
  Plan plan;
  int err = make_plan(r, d, m, sizeof(T), MODE == kModeTron, &plan);
  if (err != 0) return err;
  if (plan.layout != kAllShared) return -1;
  KernelFn k = kernel_of<0, T, kAllShared, MODE>();
  const size_t smem = plan.warp_bytes * plan.warps;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, k, 32 * plan.warps, smem);
  out[0] = plan.layout;
  out[1] = plan.warps;
  out[2] = blocks;
  out[3] = (int)smem;
  return err;
}
extern "C" int occupancy_probe(int r, int d, int m, int f64, int mode,
                               int* out) {
  switch (mode * 2 + f64) {
    case 0: return occ<float, kModeLbfgs>(r, d, m, out);
    case 1: return occ<double, kModeLbfgs>(r, d, m, out);
    case 2: return occ<float, kModeOwlqn>(r, d, m, out);
    case 3: return occ<double, kModeOwlqn>(r, d, m, out);
    case 4: return occ<float, kModeTron>(r, d, m, out);
    case 5: return occ<double, kModeTron>(r, d, m, out);
  }
  return -2;
}
"""
_PROBE = {}


def _occupancy_probe():
    import ctypes

    from photon_ml_tpu_torch.ops import cuda_build

    if "fn" not in _PROBE:
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = cuda_build.BUILD_DIR / "occupancy_probe.cu"
        lib = cuda_build.BUILD_DIR / "occupancy_probe.so"
        src.write_text(_PROBE_SRC)
        subprocess.run([cuda_build._nvcc(), *cuda_build.COMPILE_FLAGS,
                        "-shared", "-I", str(cuda_build.CSRC), "-o",
                        str(lib), str(src)], check=True,
                       capture_output=True, timeout=600)
        fn = ctypes.CDLL(str(lib)).occupancy_probe
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _PROBE["fn"] = fn
    return _PROBE["fn"]


def kernel_occupancy(e: int, r: int, d: int, kw) -> dict:
    """How the kernel lays out a bucket of ``e`` entities of r rows and d
    coordinates: its layout, lanes over an entity's coordinates (one warp
    per entity), warps per block, resident blocks per SM, resident
    entities on the card and waves (e ÷ resident)."""
    import ctypes

    import torch

    from photon_ml_tpu_torch.ops import entity_solver

    mode = kw.get("mode", "lbfgs")
    dt = kw.get("compute_dtype", torch.float64)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if hasattr(entity_solver, "kernel_plan"):
        plan = entity_solver.kernel_plan(r, d, mode=mode, compute_dtype=dt)
        out = dict(layout=plan["layout"],
                   coord_lanes=plan["coord_lanes"], warps=plan["warps"],
                   blocks_per_sm=plan["blocks_per_sm"],
                   smem_bytes=plan["smem_bytes"],
                   resident=plan["resident"])
    else:
        info = (ctypes.c_int * 4)()
        err = _occupancy_probe()(r, d, entity_solver.DEFAULT_M,
                                 int(dt == torch.float64),
                                 entity_solver._MODE_IDS[mode], info)
        if err != 0:
            return dict(occupancy_error=err)
        out = dict(layout=info[0], coord_lanes=32, warps=info[1],
                   blocks_per_sm=info[2], smem_bytes=info[3],
                   resident=info[2] * info[1] * sms)
    out["waves"] = e / max(1, out["resident"])
    return out


def spread(t) -> dict:
    """min, median and max of an integer tensor."""
    v = t.float()
    return dict(min=int(v.min()), median=float(v.median()),
                max=int(v.max()))


def bench_bucket(args, kw) -> dict:
    """One bucket through the entity solver: device ms (``device_ms``),
    call ms (CUDA events over 10 back-to-back wrapper calls), host ms per
    call (``host_ms``), the kernel's occupancy, the spread of the
    entities' iterations and work (trials, or TRON's trips) and ``stops``,
    a digest of every entity's iterations, reason and work: two trees
    whose digests are equal stop every entity of the bucket alike."""
    import hashlib

    import torch

    from photon_ml_tpu_torch.ops import entity_solver

    res = entity_solver.entity_lbfgs(*args, **kw)
    torch.cuda.synchronize()
    e, r, d = args[1].shape

    def call():
        return entity_solver.entity_lbfgs(*args, **kw)

    work = res.trials if res.trials is not None else res.outer_steps
    stops = hashlib.sha1()
    for t in (res.iterations, res.reason, res.trials, res.outer_steps,
              res.cg_steps):
        if t is not None:
            stops.update(t.to(torch.int32).cpu().numpy().tobytes())
    return dict(entities=e, n_pad=r, d_pad=d, mode=kw.get("mode", "lbfgs"),
                device_ms=device_ms(call), call_ms=cuda_ms(call, 10),
                host_ms=host_ms(call), **kernel_occupancy(e, r, d, kw),
                iterations=spread(res.iterations), work=spread(work),
                stops=stops.hexdigest()[:16])


def hold_against_plain(tag: str, args, kw, main=None, check_zeros=False):
    """The kernel and its plain version on the same CUDA inputs: equal
    iterations, stop reasons and work (trials, or TRON's trips and CG
    steps), exact-zero sets when asked and the sets of coefficients at a
    bound when bounded; value and coefficients within the f32 floors.
    ``main`` is the main run's result for this bucket, which the replay
    must reproduce. Returns the kernel's result and a row of
    measurements."""
    import torch

    from photon_ml_tpu_torch.ops import entity_solver

    torch.cuda.synchronize()
    res_k = entity_solver.entity_lbfgs(*args, **kw)
    res_p = entity_solver.entity_lbfgs_plain(*args, **kw)
    torch.cuda.synchronize()
    kernel_ms = cuda_ms(lambda: entity_solver.entity_lbfgs(*args, **kw), 10)
    dev_ms = device_ms(lambda: entity_solver.entity_lbfgs(*args, **kw))
    plain_ms = cuda_ms(lambda: entity_solver.entity_lbfgs_plain(*args, **kw),
                       1)
    err = float((res_k.x - res_p.x).abs().max())
    rel = float(((res_k.value - res_p.value).abs()
                 / res_p.value.abs().clamp_min(1e-30)).max())
    mode = kw.get("mode", "lbfgs")
    tron = mode == "tron"
    normalized = len(args) > 8 and args[8] is not None
    bounded = len(args) > 10 and args[10] is not None
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
    if tron:
        check(torch.equal(res_k.outer_steps, res_p.outer_steps)
              and torch.equal(res_k.cg_steps, res_p.cg_steps),
              f"{tag}: TRON trips or CG steps differ")
    else:
        check(torch.equal(res_k.trials, res_p.trials),
              f"{tag}: line-search trials differ")
    if check_zeros:
        check(torch.equal(res_k.x == 0, res_p.x == 0),
              f"{tag}: exact-zero sets differ")
    pinned = 0
    if bounded:
        lo, hi = args[10], args[11]
        pin_k = (res_k.x == lo) | (res_k.x == hi)
        check(torch.equal(pin_k, (res_p.x == lo) | (res_p.x == hi)),
              f"{tag}: the sets of coefficients at a bound differ")
        check(bool(((res_k.x >= lo) & (res_k.x <= hi)).all()),
              f"{tag}: a coefficient left its box")
        pinned = int(pin_k.sum())
    check(bool(torch.isfinite(res_k.x).all()), f"{tag}: non-finite")
    e, r, d = args[1].shape
    its = int(res_k.iterations.sum())
    bound_bytes_ms = 1e3 * entity_solver_bytes(e, r, d, normalized, bounded,
                                               tron) / HBM_BYTES_PER_S
    if tron:
        outer, cg = int(res_k.outer_steps.sum()), int(res_k.cg_steps.sum())
        flops = tron_flops(e, r, d, outer, cg, normalized, bounded)
        work = dict(mean_trips=outer / e, mean_cg_steps=cg / e)
    else:
        trials = int(res_k.trials.sum())
        flops = entity_solver_flops(e, r, d, entity_solver.DEFAULT_M, its,
                                    trials, mode, normalized, bounded)
        work = dict(mean_trials=trials / e)
    occ = kernel_occupancy(e, r, d, kw)
    row = dict(check=tag, entities=e, n_pad=r, d_pad=d,
               layout=occ["layout"], coord_lanes=occ["coord_lanes"],
               resident=occ["resident"],
               waves=occ["waves"], device_ms=dev_ms, call_ms=kernel_ms,
               kernel_ms=kernel_ms, plain_ms=plain_ms,
               max_abs_coef_err=err, max_value_rel_err=rel,
               mean_iterations=its / e, **work,
               zeros=int((res_k.x == 0).sum()), pinned=pinned,
               reasons=np.bincount(res_k.reason.cpu().numpy(),
                                   minlength=5).tolist(),
               bound_bytes_ms=bound_bytes_ms,
               bound_ops_ms=1e3 * flops / FP64_FLOPS_PER_S)
    return res_k, res_p, row


def first_update_buckets(coords):
    """The first coordinate-descent iteration replayed as
    CoordinateDescent.run runs it, over coordinates built as the fit
    builds them. Yields ``(name, bucket, kind, block, args, kw)`` for every
    bucket of every random-effect coordinate's first update, ``kind``
    "re" or "latent" (a factored coordinate's latent buckets, against the
    initial B), with the entity solver's arguments on that update's
    inputs; after a factored coordinate's buckets it yields ``(name,
    None, "factored", (coord, model, residual), None, None)``. Then it
    makes the update and rescores, as the fit does."""
    import torch

    from photon_ml_tpu_torch.algorithm.coordinates import (
        FactoredRandomEffectCoordinate,
        RandomEffectCoordinate,
        block_offsets,
        entity_mode,
        project_latent,
    )
    from photon_ml_tpu_torch.data.normalization import (
        gathered_to_normalized_space,
    )

    names = list(coords)
    models = {n: c.initialize_model() for n, c in coords.items()}
    scores = {n: coords[n].score(models[n]) for n in names}
    for n in names:
        coord = coords[n]
        residual = None
        for other in names:
            if other != n:
                residual = (scores[other] if residual is None
                            else residual + scores[other])
        if isinstance(coord, RandomEffectCoordinate):
            cfg = coord.config
            kw = dict(max_iter=cfg.max_iterations, tol=cfg.tolerance,
                      mode=entity_mode(cfg))
            # One slot a bucket: the coordinate has no mesh.
            for bi, (block, c0, (norm,), (bounds,)) in enumerate(zip(
                    coord.dataset.blocks, models[n].local_coefs,
                    coord.norm_blocks, coord.bounds_blocks)):
                if norm is not None:
                    c0 = gathered_to_normalized_space(c0, *norm)
                args = (coord._objective.loss, block.x, block.labels,
                        block_offsets(block, residual), block.weights,
                        c0.contiguous(), cfg.l2_weight, cfg.l1_weight,
                        *(norm[:2] if norm is not None else (None, None)),
                        *(bounds if bounds is not None else (None, None)))
                yield n, bi, "re", block, args, kw
        elif isinstance(coord, FactoredRandomEffectCoordinate):
            cfg = coord.config
            kw = dict(max_iter=cfg.max_iterations, tol=cfg.tolerance,
                      mode=entity_mode(cfg))
            B = models[n].projection_matrix
            d = coord.dataset.num_global_features
            for bi, (block, g0) in enumerate(zip(
                    coord.dataset.blocks, models[n].latent.local_coefs)):
                args = (coord._objective.loss,
                        project_latent(block.x[..., :d], B),
                        block.labels, block_offsets(block, residual),
                        block.weights, g0.contiguous(), cfg.l2_weight,
                        cfg.l1_weight)
                yield n, bi, "latent", block, args, kw
            yield n, None, "factored", (coord, models[n], residual), None, \
                None
        models[n], _ = coord.update_model(models[n], residual, None)
        scores[n] = coord.score(models[n])
        torch.cuda.synchronize()


def replay_first_updates(tag: str, coords, main_trackers, extra=None,
                         check_zeros=False):
    """Every bucket of every random-effect coordinate's first update
    (``first_update_buckets``) held against the plain version on that
    update's inputs (the replay must reproduce the main run's iterations
    and reasons). ``extra(name, block, args, kw, res_k)`` may run more
    checks on a bucket's inputs and return fields for its row. A factored
    coordinate's latent buckets must match their plain version exactly,
    and its update is timed phase by phase (``rows["phases"][name]``).
    Returns the rows per coordinate."""
    from photon_ml_tpu_torch.ops.entity_solver import variant

    rows = {}
    for n, bi, kind, block, args, kw in first_update_buckets(coords):
        if kind == "factored":
            phases = factored_phase_ms(*block)
            print(f"{tag} {n} first update phases: " + json.dumps(phases),
                  flush=True)
            rows.setdefault("phases", {})[n] = phases
            continue
        if kind == "re":
            res_k, _, row = hold_against_plain(
                f"{tag} {n} bucket {bi}", args, kw,
                main=main_trackers[n][0][bi], check_zeros=check_zeros)
            row.update(bucket=bi, coordinate=n, mode=variant(
                kw["mode"], args[8] is not None, args[10] is not None))
            if extra is not None:
                row.update(extra(n, block, args, kw, res_k) or {})
        else:
            _, _, row = hold_against_plain(
                f"{tag} {n} latent bucket {bi}", args, kw,
                main=main_trackers[n][0][0].latent[bi])
            check(row["max_abs_coef_err"] == 0,
                  f"{tag} {n} latent bucket {bi}: kernel and plain "
                  f"version differ by {row['max_abs_coef_err']}")
            row.update(bucket=bi, coordinate=n, mode="lbfgs (latent)")
        print("bucket " + json.dumps(row), flush=True)
        rows.setdefault(n, []).append(row)
    return rows


def factored_phase_ms(coord, model, residual, reps: int = 3) -> dict:
    """A factored update's phases on its inputs, split as bench.py's
    game_full_phase_ms splits them (bench.py:529-614): the latent solves
    (every bucket's projection and entity-solver launch), the refit of B
    (the host L-BFGS over the Kronecker features) and the rescoring of
    the coordinate. Synchronised host clock, mean over ``reps`` runs
    after a warm-up run."""
    import torch

    from photon_ml_tpu_torch.algorithm.coordinates import (
        _flatten_factored_static,
        _flatten_gammas,
        _solve_factored_block,
        block_offsets,
        project_latent,
    )
    from photon_ml_tpu_torch.ops.features import KroneckerFeatures
    from photon_ml_tpu_torch.ops.glm_objective import GLMBatch
    from photon_ml_tpu_torch.optimization.solver import solve_glm

    blocks = coord.dataset.blocks
    d = coord.dataset.num_global_features
    B = model.projection_matrix
    offsets = [block_offsets(b, residual) for b in blocks]
    xs = [b.x[..., :d] for b in blocks]

    def timed(fn):
        out = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps, out

    latent_ms, latent = timed(lambda: [
        _solve_factored_block(coord._objective, coord.config, b,
                              project_latent(x, B), o, g)
        for b, x, o, g in zip(blocks, xs, offsets,
                              model.latent.local_coefs)])
    gammas = [r.x for r in latent]
    x, y, off, w = _flatten_factored_static(xs, blocks, offsets)
    batch = GLMBatch(KroneckerFeatures(x, _flatten_gammas(blocks, gammas)),
                     y, off, w)
    refit_ms, refit = timed(lambda: solve_glm(
        coord._objective, batch, coord.latent_config, B.reshape(-1)))
    updated = model.with_update(gammas, refit.x.reshape(B.shape))
    rescore_ms, _ = timed(lambda: coord.score(updated))
    return dict(latent_solves_ms=latent_ms, refit_ms=refit_ms,
                rescore_ms=rescore_ms,
                refit_iterations=int(refit.iterations),
                refit_rows=int(x.shape[0]))


def report_updates(result) -> None:
    import torch

    from photon_ml_tpu_torch.algorithm.coordinates import FactoredUpdate

    for u in result.updates:
        tracker = result.trackers[u["coordinate"]][u["iteration"]]
        if isinstance(tracker, list) and isinstance(tracker[0],
                                                    FactoredUpdate):
            parts = []
            for alt in tracker:  # one per MF alternation
                its = torch.cat([t.iterations for t in alt.latent]).float()
                parts.append(
                    f"latent entity iterations mean {float(its.mean()):.2f}"
                    f", refit of B iterations {int(alt.refit.iterations)} "
                    f"reason {int(alt.refit.reason)}")
            solver = "; ".join(parts)
        elif isinstance(tracker, list):  # one result per bucket
            its = torch.cat([t.iterations for t in tracker]).float()
            if tracker[0].trials is not None:
                work = torch.cat([t.trials for t in tracker]).float()
                work = f"line-search trials mean {float(work.mean()):.2f}"
            else:
                trips = torch.cat([t.outer_steps for t in tracker]).float()
                cg = torch.cat([t.cg_steps for t in tracker]).float()
                work = (f"TRON trips mean {float(trips.mean()):.2f}, CG "
                        f"steps mean {float(cg.mean()):.2f}")
            solver = (f"entity iterations mean {float(its.mean()):.2f} "
                      f"max {int(its.max())}, {work}")
        elif tracker.outer_steps is not None:
            solver = (f"TRON iterations {int(tracker.iterations)} "
                      f"({int(tracker.outer_steps)} outer, "
                      f"{int(tracker.cg_steps)} CG), reason "
                      f"{int(tracker.reason)}")
        else:
            solver = (f"solver iterations {int(tracker.iterations)}, "
                      f"reason {int(tracker.reason)}")
        print(f"update: iteration {u['iteration']} {u['coordinate']}: "
              f"{1e3 * u['seconds']:.1f} ms, objective "
              f"{u['objective']:.6f}, {solver}")
    for it, m in enumerate(result.validation_history):
        print(f"validation AUC after iteration {it}: {m['AUC']:.6f}")


def check_model(result, val, tag: str, entities=None) -> None:
    """Finite objectives that fall, an AUC above chance, finite
    coefficients of the right shapes (``entities``: (random-effect
    coordinate, entity count) pairs, the per-user one by default),
    device scores equal to host scores."""
    import torch

    entities = entities or (("perUser", N_USERS),)
    from photon_ml_tpu_torch.models.device_scoring import DeviceGameScorer

    hist = result.objective_history
    check(len(hist) == (1 + len(entities)) * CD_ITERATIONS
          and all(map(math.isfinite, hist)),
          f"{tag}: objective history {hist}")
    check(hist[-1] < hist[0], f"{tag}: objective did not fall: {hist}")
    aucs = [m["AUC"] for m in result.validation_history]
    check(all(math.isfinite(a) and a > 0.5 for a in aucs),
          f"{tag}: AUC {aucs}")
    model = result.model
    fe_coef = model.models["fixed"].glm.coefficients.means
    check(tuple(fe_coef.shape) == (D_FIXED,)
          and bool(torch.isfinite(fe_coef).all()), f"{tag}: fixed coefs")
    for name, count in entities:
        re_model = model.models[name]
        re_model = getattr(re_model, "latent", re_model)  # factored: gamma
        check(sum(c.shape[0] for c in re_model.local_coefs) == count
              and all(bool(torch.isfinite(c).all())
                      for c in re_model.local_coefs),
              f"{tag}: {name} coefficients")
    dev_scores = DeviceGameScorer(model, val).score(model).cpu().numpy()
    host_scores = model.score(val)
    score_err = float(np.abs(dev_scores - host_scores).max())
    print(f"{tag} hold-out scores: device vs host max abs diff "
          f"{score_err:.3g}")
    check(dev_scores.shape == (val.num_rows,)
          and np.isfinite(dev_scores).all() and score_err <= 1e-3,
          f"{tag}: device scorer disagrees with the host scorer")


def box(d: int, bound: float, intercept: int):
    """|c| <= bound on every feature but the intercept, through the
    port's GLMSuite constraint parser and constraint_arrays."""
    from photon_ml_tpu_torch.optimization.config import (
        constraint_arrays,
        parse_constraint_string,
    )

    spec = json.dumps([{"name": "*", "term": "*", "lowerBound": -bound,
                        "upperBound": bound}])
    index_map = {(f"f{j}", ""): j for j in range(d)}
    return constraint_arrays(parse_constraint_string(spec, index_map), d,
                             intercept)


def count_at_bounds(tag: str, model, boxes) -> dict:
    """Per coordinate, the coefficients on real columns exactly at a
    bound; fails when one lies outside its box or a coordinate has none
    at a bound."""
    import torch

    counts = {}
    for name, (lo, hi) in boxes.items():
        sub = model.models[name]
        if name == "fixed":
            pairs = [(sub.glm.coefficients.means, None)]
        else:
            pairs = list(zip(sub.local_coefs, sub.feat_idx))
        at, total = 0, 0
        for c, fidx in pairs:
            lo_t = torch.as_tensor(lo, dtype=c.dtype, device=c.device)
            hi_t = torch.as_tensor(hi, dtype=c.dtype, device=c.device)
            if fidx is None:
                real = torch.ones_like(c, dtype=torch.bool)
            else:
                real = fidx >= 0
                idx = fidx.long().clamp_min(0)
                lo_t = torch.where(real, lo_t[idx],
                                   torch.full_like(c, -math.inf))
                hi_t = torch.where(real, hi_t[idx],
                                   torch.full_like(c, math.inf))
            check(bool(((c >= lo_t) & (c <= hi_t)).all()),
                  f"{tag}: a {name} coefficient left its box")
            at += int((((c == lo_t) | (c == hi_t)) & real).sum())
            total += int(real.sum())
        counts[name] = at
        print(f"{tag} {name}: {at} of {total} coefficients exactly at a "
              "bound", flush=True)
        check(at > 0, f"{tag}: no {name} coefficient at a bound")
    return counts


def coordinates_of(train, specs):
    """The coordinates GameEstimator.fit builds from these specs (each
    spec's first configuration, the fit's seed 0)."""
    from photon_ml_tpu_torch.algorithm.coordinates import (
        FactoredRandomEffectCoordinate,
        FixedEffectCoordinate,
        RandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.estimators.game_estimator import (
        FactoredRandomEffectSpec,
        FixedEffectSpec,
        spec_dataset,
    )
    from photon_ml_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    coords = {}
    for spec in specs:
        if isinstance(spec, FixedEffectSpec):
            coords[spec.name] = FixedEffectCoordinate(
                spec.name, train, spec.feature_shard_id, task,
                spec.configs[0], normalization=spec.normalization,
                lower_bounds=spec.lower_bounds,
                upper_bounds=spec.upper_bounds)
        elif isinstance(spec, FactoredRandomEffectSpec):
            cfg = spec.configs[0]
            coords[spec.name] = FactoredRandomEffectCoordinate(
                spec.name, spec_dataset(train, spec), task,
                cfg.random_effect, cfg.latent_factor, cfg.mf, seed=0)
        else:
            coords[spec.name] = RandomEffectCoordinate(
                spec.name, spec_dataset(train, spec), task, spec.configs[0],
                normalization=spec.normalization,
                lower_bounds=spec.lower_bounds,
                upper_bounds=spec.upper_bounds)
    return coords


# Row 9's launches and the seconds of each fit_path run, by tag.
FIT_ROW9: dict = {}
FIT_S: dict = {}
# The density of path 15's sparse fixed-effect shard: below the dense
# threshold (ops/features.py), so the fixed effect is CSRFeatures.
SPARSE_FE_DENSITY = 0.1


def tensors_of(obj) -> list:
    """Every tensor in a model, tracker or list of them, in a fixed
    order."""
    import torch

    out = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            out.append(o)
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
        elif hasattr(o, "__dataclass_fields__"):
            for f in o.__dataclass_fields__:
                walk(getattr(o, f))

    walk(obj)
    return out


def fit_digest(result) -> str:
    """sha256 of a fit's final coefficients (every tensor of its model,
    in coordinate order) and its objective history."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors_of(list(result.model.models.values())):
        h.update(t.detach().cpu().numpy().tobytes())
    h.update(np.asarray(result.objective_history, np.float64).tobytes())
    return h.hexdigest()


def fit_path(tag: str, specs, train, val, mesh=None, fused=True):
    """The path's main run: GameEstimator.fit (over ``mesh`` when given;
    ``fused=False``: the eager plain loop) with the launch counts set to
    0 just before and read just after. Returns (result, launches per
    variant, buckets per random-effect coordinate); row 9's launches go
    to ``FIT_ROW9[tag]``."""
    import torch

    from photon_ml_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_ml_tpu_torch.evaluation.evaluators import (
        AreaUnderROCCurveEvaluator,
    )
    from photon_ml_tpu_torch.ops import entity_solver, spmv
    from photon_ml_tpu_torch.types import TaskType

    estimator = GameEstimator(
        TaskType.LOGISTIC_REGRESSION, specs, num_iterations=CD_ITERATIONS,
        validation_evaluators=[AreaUnderROCCurveEvaluator()], fused=fused,
        **({} if mesh is None else dict(device=mesh.devices[0],
                                        mesh=mesh)))
    # ---- the main path: counts set to 0 just before, read just after ----
    entity_solver.reset_launch_counts()
    spmv.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (_, result), = estimator.fit(train, val)
    torch.cuda.synchronize()
    fit_s = FIT_S[tag] = time.perf_counter() - t0
    launches = dict(entity_solver.entity_lbfgs.variants)
    FIT_ROW9[tag] = spmv.csr_matvec.launches
    # ----------------------------------------------------------------------
    buckets = {name: len(getattr(m, "latent", m).local_coefs)
               for name, m in result.model.models.items()
               if hasattr(getattr(m, "latent", m), "local_coefs")}
    print(f"{tag} fit: {fit_s:.2f} s (random-effect dataset builds and "
          f"graph captures included), buckets {buckets}, digest "
          f"{fit_digest(result)}", flush=True)
    for name, st in result.graphs.items():
        print(f"{tag} graph {name}: " + json.dumps(st), flush=True)
    report_updates(result)
    print(f"{tag} entity-solver launches: {launches}, row 9 launches "
          f"{FIT_ROW9[tag]}", flush=True)
    return result, launches, buckets


def ms_by_iteration(result) -> list:
    """Mean ms per update in each coordinate-descent iteration."""
    out = []
    for it in range(CD_ITERATIONS):
        secs = [u["seconds"] for u in result.updates if u["iteration"] == it]
        out.append(1e3 * sum(secs) / len(secs))
    return out


def sparse_fixed(data, seed: int = 15):
    """``data`` with its global shard thinned to SPARSE_FE_DENSITY (a
    seeded draw over its entries; the intercept column kept whole), so
    that a fixed effect on it is CSRFeatures and its solves run row 9."""
    import scipy.sparse as sp

    x = data.feature_shards["global"].tocoo()
    keep = ((np.random.default_rng(seed).random(x.nnz) < SPARSE_FE_DENSITY)
            | (x.col == D_FIXED - 1))
    thin = sp.csr_matrix((x.data[keep], (x.row[keep], x.col[keep])),
                         shape=x.shape)
    return dataclasses.replace(
        data, feature_shards={**data.feature_shards, "global": thin})


def path15(train, val, specs, fused: dict) -> dict:
    """Path 15 (A3a, the fused coordinate update): paths 1-5 refitted
    through the eager plain loop (``GameEstimator(fused=False)``: every
    solver loop a host loop) and held against their fused fits: the same
    digest, objective history, validation AUCs, every tracker tensor of
    every update (coefficients, values, iterations, stop reasons,
    histories, work) and the same row-1 and row-9 launches, bit for bit.
    Paths 1-5 are dense, so path 1's coordinates are also fitted both
    ways on ``sparse_fixed`` data ("csr"): its fixed effect runs row 9
    inside its update graph, and row 9 must launch, as often as in the
    eager fit. Prints each graph's nodes, capture and instantiate seconds
    and pool bytes, the ms per update of iterations 0-2 (span averages:
    a capture is outside every span) and each fit's seconds (captures
    included), fused and eager."""
    t0 = time.perf_counter()
    train_csr, val_csr = sparse_fixed(train), sparse_fixed(val)
    nnz = train_csr.feature_shards["global"].nnz
    print(f"path 15 csr data: global shard density "
          f"{nnz / (train.num_rows * D_FIXED):.4f} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    res_c, launches_c, _ = fit_path("path 15 (csr)", specs[1], train_csr,
                                    val_csr)
    check(FIT_ROW9["path 15 (csr)"] > 0,
          "path 15 (csr): row 9 did not launch in the fused fit")
    fused = {**fused, "csr": (res_c, launches_c)}
    data = {p: (train, val) for p in fused}
    data["csr"] = (train_csr, val_csr)
    table = {}
    for p in fused:
        res_f, launches_f = fused[p]
        tag = f"path 15 (path {p} eager)"
        res_e, launches_e, _ = fit_path(tag, specs[1 if p == "csr" else p],
                                        *data[p], fused=False)
        check(fit_digest(res_e) == fit_digest(res_f),
              f"path 15: path {p}'s eager digest differs from its fused")
        check(res_e.objective_history == res_f.objective_history,
              f"path 15: path {p}'s objective histories differ")
        check(res_e.validation_history == res_f.validation_history,
              f"path 15: path {p}'s validation AUCs differ")
        for name in res_f.trackers:
            te = tensors_of(res_e.trackers[name])
            tf = tensors_of(res_f.trackers[name])
            check(len(te) == len(tf) and all(
                a.shape == b.shape and a.dtype == b.dtype
                and bool(((a == b) | (a.isnan() & b.isnan())).all())
                for a, b in zip(te, tf)),
                f"path 15: path {p} {name}'s trackers differ")
        ftag = "path 15 (csr)" if p == "csr" else f"path {p}"
        check(launches_e == launches_f and FIT_ROW9[tag] == FIT_ROW9[ftag],
              f"path 15: path {p}'s launches differ: eager {launches_e} "
              f"row 9 {FIT_ROW9[tag]}, fused {launches_f} row 9 "
              f"{FIT_ROW9[ftag]}")
        row = {"path": p, "digest": fit_digest(res_f)[:16],
               "fused_ms": ms_by_iteration(res_f),
               "eager_ms": ms_by_iteration(res_e),
               "fused_fit_s": FIT_S[ftag], "eager_fit_s": FIT_S[tag],
               "row9": FIT_ROW9[ftag], "graphs": res_f.graphs}
        print("path 15 " + json.dumps(row), flush=True)
        table[p] = row
    return table


def fit_digests() -> None:
    """``--fit-digests``: paths 1-5 fitted by the imported tree's
    GameEstimator with its defaults, one ``digest`` line each (the
    fit's digest, AUCs and entity-kernel launches); run it on two trees
    in turns to compare them on one card."""
    from photon_ml_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_ml_tpu_torch.evaluation.evaluators import (
        AreaUnderROCCurveEvaluator,
    )
    from photon_ml_tpu_torch.ops import entity_solver
    from photon_ml_tpu_torch.types import TaskType

    train, val = split_data()
    specs, _ = path_specs(train)
    for p in sorted(specs):
        entity_solver.reset_launch_counts()
        t0 = time.perf_counter()
        (_, result), = GameEstimator(
            TaskType.LOGISTIC_REGRESSION, specs[p],
            num_iterations=CD_ITERATIONS,
            validation_evaluators=[AreaUnderROCCurveEvaluator()]).fit(
                train, val)
        print("digest " + json.dumps({
            "path": p, "digest": fit_digest(result),
            "auc": [m["AUC"] for m in result.validation_history],
            "launches": dict(entity_solver.entity_lbfgs.variants),
            "fit_s": time.perf_counter() - t0}), flush=True)


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
        "device_ms": sum(r["device_ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": None,
    }


def gather_phase() -> list:
    """The port's gather experiment at full width with both kernels'
    launch counts set to 0 just before its run and read just after; then
    each kernel against its plain version on the same inputs, exactly, at
    full width and at --check's size (row 8 in its column layout) and row
    8 in its l2 layout (a table past the column layout's limit); the
    torch packing of the residue streams on the card against the numpy
    one, bit for bit, and both timed. Returns rows 7 and 8 of the kernels
    line."""
    import torch

    from photon_ml_tpu_torch.dev_scripts import gather_experiments as gx
    from photon_ml_tpu_torch.ops import gather

    t0 = time.perf_counter()
    p = gx.problem(GATHER_M, GATHER_D, "cuda")
    torch.cuda.synchronize()
    kb, e = p["local"].shape
    per_lane = p["res_idx"].shape[1]
    a = GATHER_D // gather.LANES
    print(f"gather problem: m {GATHER_M}, d {GATHER_D}; one-hot blocks "
          f"[{kb}, {e}], residue streams [{gather.LANES}, {per_lane}] "
          f"(a = {a}; {time.perf_counter() - t0:.1f} s to draw and pack)",
          flush=True)
    # ---- the main path: counts set to 0 just before, read just after ----
    gather.reset_launch_counts()
    results = gx.run(GATHER_M, GATHER_D, p=p)
    torch.cuda.synchronize()
    launches = {"onehot": gather.onehot_gather.launches,
                "residue": gather.residue_gather.launches,
                "residue layouts": dict(gather.residue_gather.layouts)}
    # ----------------------------------------------------------------------
    print(f"gather launches: {launches}", flush=True)
    check(all(r["ok"] for r in results.values()),
          f"gather: a candidate disagrees with w[idx]: {results}")
    check(launches["residue layouts"].get("column", 0)
          == launches["residue"],
          f"gather: row 8 did not take its column layout at d = {GATHER_D}")

    # The residue packing on the card (torch ops, what problem() ran)
    # against the numpy one.
    idx_dev = p["idx"]
    t0 = time.perf_counter()
    streams, slot = gather.lane_major(*gather.prep_residue(p["idx_np"],
                                                           GATHER_D))
    host_pack_ms = 1e3 * (time.perf_counter() - t0)
    check(torch.equal(p["res_idx"].cpu(), torch.as_tensor(streams))
          and np.array_equal(p["res_slot"], slot),
          "gather: the torch packing on the card differs from the numpy "
          "packing")
    del streams, slot
    pack_ms = cuda_ms(lambda: gather.pack_residue(idx_dev, GATHER_D), 3)
    print(f"gather residue packing at full width: torch on the card "
          f"{pack_ms:.4f} ms, numpy on the host {host_pack_ms:.1f} ms "
          "(equal bit for bit)", flush=True)

    small = gx.problem(CHECK_M, CHECK_D, "cuda")
    l2_d = 128 * 60_000
    wide = gx.problem(5_000, l2_d, "cuda")
    for d in (CHECK_D, GATHER_D):
        check(gather.residue_layout(d // gather.LANES) == "column",
              f"gather: row 8 does not take its column layout at d = {d}")
    check(gather.residue_layout(l2_d // gather.LANES) == "l2",
          f"gather: row 8 does not take its l2 layout at d = {l2_d}")
    onehot_args = (p["local"], p["mask"], p["w_blk"])
    residue_args = (p["w"], p["res_idx"])
    errs = {}
    for tag, q in (("full width", p), (f"d = {CHECK_D}", small),
                   (f"d = {l2_d}", wide)):
        for name, fn, plain, args in (
                ("onehot", gather.onehot_gather, gather.onehot_gather_plain,
                 (q["local"], q["mask"], q["w_blk"])),
                ("residue", gather.residue_gather,
                 gather.residue_gather_plain, (q["w"], q["res_idx"]))):
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs[name] = max(errs.get(name, 0.0), err)
            check(torch.equal(got, want),
                  f"gather {name} at {tag}: kernel and plain version differ "
                  f"(max abs {err})")
    del small, wide
    print(f"gather kernels equal their plain versions: max abs {errs}",
          flush=True)

    # Row 7's launch shapes: every view of B and CTA width, exactly equal
    # to the plain version and timed, beside w[idx] in the same call.
    want = gather.onehot_gather_plain(*onehot_args)
    sweep = {}
    for n in gather.ONEHOT_NS:
        for wp in gather.ONEHOT_WARPS:
            got = gather.onehot_gather(*onehot_args, n=n, warps=wp)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"gather onehot n = {n}, warps = {wp}: kernel and plain "
                  "version differ")
            sweep[f"n{n}_w{wp}"] = gx.cuda_ms(
                lambda: gather.onehot_gather(*onehot_args, n=n, warps=wp))
    del got, want
    best = min(sweep, key=sweep.get)
    print(f"gather row 7 launch: n {gather.ONEHOT_N}, warps "
          f"{gather.ONEHOT_WARP_COUNT}; fastest of the sweep {best} "
          f"{sweep[best]:.4f} ms; w[idx] "
          f"{results['torch_gather']['ms']:.4f} ms; sweep (ms): "
          + json.dumps(sweep), flush=True)

    library_ms = results["torch_gather"]["ms"]
    plain_ms = {"onehot": cuda_ms(lambda: gather.onehot_gather_plain(
        *onehot_args), 3), "residue": cuda_ms(
            lambda: gather.residue_gather_plain(*residue_args), 3)}
    dev_ms = {"onehot": device_ms(lambda: gather.onehot_gather(*onehot_args),
                                  5),
              "residue": device_ms(
                  lambda: gather.residue_gather(*residue_args), 5)}
    # Bytes: every input read once, every output written once (float32 and
    # int32, 4 bytes each). Row 7's one-hot contraction does 2,048
    # multiply-adds per slot on the tensor cores.
    bounds = {
        "onehot": (4.0 * (3 * kb * e + kb * gather.BLOCK) / HBM_BYTES_PER_S,
                   2.0 * kb * e * gather.BLOCK / BF16_FLOPS_PER_S),
        # Row 8 (as w[idx]): the m lookups' indices and values and the
        # table; its streams' padding is not work the function needs.
        "residue": (4.0 * (2 * GATHER_M + GATHER_D) / HBM_BYTES_PER_S, 0.0)}
    print(f"gather bound (bytes) of w[idx] and row 8: "
          f"{1e3 * bounds['residue'][0]:.4f} ms; row 7: "
          f"{1e3 * max(bounds['onehot']):.4f} ms; row 8 on the device "
          f"{dev_ms['residue']:.4f} ms, "
          f"{100 * 1e3 * bounds['residue'][0] / dev_ms['residue']:.1f}% of "
          f"its bound (streams {gather.LANES} x {per_lane}: "
          f"{100 * (gather.LANES * per_lane / GATHER_M - 1):.2f}% padding)",
          flush=True)
    entries = []
    for name, row, source, replaces, key in (
            ("gather_onehot (row 7)", 7, "photon_ml_tpu_torch/csrc/"
             "gather_onehot.cu", "dev_scripts/gather_experiments.py:142",
             "onehot"),
            ("gather_residue (row 8)", 8, "photon_ml_tpu_torch/csrc/"
             "gather_residue.cu", "dev_scripts/gather_experiments.py:220",
             "residue")):
        bytes_s, ops_s = bounds[key]
        candidate = "cuda_onehot" if key == "onehot" else \
            "cuda_residue_gather"
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": errs[key], "ms": results[candidate]["ms"],
            "device_ms": dev_ms[key], "plain_ms": plain_ms[key],
            "bound_ms": 1e3 * max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "library_ms": library_ms})
    print("gather rates (M lookups/s): " + json.dumps(
        {k: r["mlookups_per_sec"] for k, r in results.items()}), flush=True)
    return entries


def path_specs(train):
    """Every path's coordinate specs (paths 1-5, as the module docstring
    sets them out) and path 4's boxes per coordinate."""
    from photon_ml_tpu_torch.data.random_effect import (
        RandomEffectDataConfiguration,
    )
    from photon_ml_tpu_torch.estimators.game_estimator import (
        FactoredRandomEffectSpec,
        FixedEffectSpec,
        RandomEffectSpec,
    )
    from photon_ml_tpu_torch.optimization.config import (
        FactoredRandomEffectOptimizationConfiguration,
        GLMOptimizationConfiguration,
        MFOptimizationConfiguration,
    )

    user_cfg = RandomEffectDataConfiguration("userId", "user")
    item_cfg = RandomEffectDataConfiguration("itemId", "item")
    fe_cfg, re_cfg = configs()
    fe_cfg2, re_cfg2 = configs_path2()
    t0 = time.perf_counter()
    fe_norm, re_norm = contexts_path2(train)
    print(f"path 2 normalization contexts: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    tron_cfg = GLMOptimizationConfiguration.parse(FE_TRON_CFG)
    boxes = {"fixed": box(D_FIXED, FE_BOX, D_FIXED - 1),
             "perUser": box(D_USER, USER_BOX, 0),
             "perItem": box(D_ITEM, ITEM_BOX, 0)}
    fac_cfg = FactoredRandomEffectOptimizationConfiguration(
        re_cfg, re_cfg, MFOptimizationConfiguration(MF_ITERATIONS,
                                                    MF_FACTORS))
    specs = {
        1: [FixedEffectSpec("fixed", "global", [fe_cfg]),
            RandomEffectSpec("perUser", user_cfg, [re_cfg],
                             intercept_col=0)],
        2: [FixedEffectSpec("fixed", "global", [fe_cfg2],
                            normalization=fe_norm),
            RandomEffectSpec("perUser", user_cfg, [re_cfg2],
                             intercept_col=0, normalization=re_norm)],
        3: [FixedEffectSpec("fixed", "global", [tron_cfg],
                            normalization=fe_norm),
            RandomEffectSpec("perUser", user_cfg, [tron_cfg],
                             intercept_col=0, normalization=re_norm),
            RandomEffectSpec("perItem", item_cfg, [tron_cfg],
                             intercept_col=0)],
        4: [FixedEffectSpec("fixed", "global", [fe_cfg],
                            lower_bounds=boxes["fixed"][0],
                            upper_bounds=boxes["fixed"][1]),
            RandomEffectSpec("perUser", user_cfg, [re_cfg],
                             intercept_col=0,
                             lower_bounds=boxes["perUser"][0],
                             upper_bounds=boxes["perUser"][1]),
            RandomEffectSpec("perItem", item_cfg, [tron_cfg],
                             intercept_col=0,
                             lower_bounds=boxes["perItem"][0],
                             upper_bounds=boxes["perItem"][1])],
        5: [FixedEffectSpec("fixed", "global", [fe_cfg]),
            RandomEffectSpec("perUser", user_cfg, [re_cfg],
                             intercept_col=0),
            RandomEffectSpec("perItem", item_cfg, [re_cfg],
                             intercept_col=0),
            FactoredRandomEffectSpec("itemFactors", item_cfg, [fac_cfg])],
    }
    return specs, boxes


def build_kernels() -> None:
    """Build every kernel of the port (one nvcc per unit, all at once)
    and print nvcc's register, shared-memory and spill report."""
    from photon_ml_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    builds = cuda_build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s for "
          f"{sorted(builds)}", flush=True)
    for name, rep in builds.items():
        for line in rep["log"].splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print(f"  {name}: {line.strip()}")


def split_data():
    t0 = time.perf_counter()
    data = build_problem()
    cut = int(round(N_ROWS * (1 - HOLDOUT)))
    train = data.subset(np.arange(cut))
    val = data.subset(np.arange(cut, N_ROWS))
    print(f"data: {train.num_rows} train / {val.num_rows} hold-out rows, "
          f"{D_FIXED} fixed features, {N_USERS} users x {D_USER}, "
          f"{N_ITEMS} items x {D_ITEM} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return train, val


def entity_buckets(tag: str) -> None:
    """``--entity-buckets``: the imported tree's entity-solver kernel on
    every bucket of paths 1-5's first updates (path 1 in float64 and
    float32 compute, path 2 in OWL-QN and L-BFGS mode), one ``ab`` line
    each with ``bench_bucket``'s measurements. No checks and no contract
    lines: this mode compares two trees' kernels in turns inside one call
    (their ``stops`` digests tell whether a bucket's stops moved)."""
    train, _ = split_data()
    specs, _ = path_specs(train)
    import torch

    for path, sp in specs.items():
        for n, bi, kind, _, args, kw in first_update_buckets(
                coordinates_of(train, sp)):
            if kind == "factored":
                continue
            # Path 1 in both compute types; path 2's buckets also in
            # L-BFGS mode on the same fold (row 2, as main() replays it).
            runs = [dict(kw, compute_dtype=dt) for dt in (
                (torch.float64, torch.float32) if path == 1
                else (torch.float64,))]
            if path == 2:
                runs.append(dict(kw, mode="lbfgs"))
            for kwr in runs:
                row = bench_bucket(args, kwr)
                row.update(tree=tag, path=path, coordinate=n, bucket=bi,
                           kind=kind, compute=str(kwr.get(
                               "compute_dtype", torch.float64)).split(".")[-1])
                print("ab " + json.dumps(row), flush=True)


# Path 6's one cut: rows. Its files are written by the pure-Python codec
# (~1.4 ms a row, in worker processes) and read by the C block decoder;
# path 8 trains on them five times, one of them re-decoding evicted
# shards on every pass. bench.py's 200,000 rows become 50,000.
PATH6_TRAIN, PATH6_VAL = 40_000, 10_000
PATH6_SEQUENCE = "fixed,perUser,perItem,itemFactors"


class _DriverLog(logging.Handler):
    """Collects the drivers' phase and update log records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.phases, self.updates = {}, []

    def emit(self, record):
        if hasattr(record, "phase"):
            self.phases[record.phase] = (self.phases.get(record.phase, 0.0)
                                         + record.seconds)
        if hasattr(record, "update"):
            self.updates.append(record.update)


PATH6_NAMES = {"global": [f"g{j}" for j in range(D_FIXED - 1)],
               "user": [f"u{j}" for j in range(1, D_USER)],
               "item": [f"i{j}" for j in range(1, D_ITEM)]}
PATH6_COLS = {"global": list(range(D_FIXED - 1)),
              "user": list(range(1, D_USER)),
              "item": list(range(1, D_ITEM))}
# Avro files per directory, written in parallel.
PATH6_PARTS = {"train": 5, "validate": 2}


def _write_part(path, dense, labels, users, items, tag, first) -> None:
    """One Avro part file of path 6's rows (run in a worker process)."""
    from photon_ml_tpu_torch.io import schemas
    from photon_ml_tpu_torch.io.avro_codec import write_container

    def records():
        for i in range(len(labels)):
            feats = [{"name": nm, "term": None, "value": float(v)}
                     for s, names in PATH6_NAMES.items()
                     for nm, v in zip(names, dense[s][i])]
            yield {"uid": f"{tag}{first + i}", "label": float(labels[i]),
                   "features": feats, "weight": None, "offset": None,
                   "metadataMap": {"userId": str(users[i]),
                                   "itemId": str(items[i])}}

    write_container(path, schemas.TRAINING_EXAMPLE, records())


def _decode(path, maps_dir):
    """read_game_dataset of one input directory (run in a worker
    process, beside the driver)."""
    from photon_ml_tpu_torch.data.avro_reader import read_game_dataset
    from photon_ml_tpu_torch.data.paldb import load_feature_index_maps

    data, _ = read_game_dataset(path, ["itemId", "userId"],
                                load_feature_index_maps(maps_dir))
    return data


def write_path6_inputs(train, val, root: Path, pool) -> dict:
    """The first PATH6_TRAIN training and PATH6_VAL hold-out rows (in
    PATH6_PARTS files each) as TrainingExampleAvro through the port's
    codec, each file in a worker of ``pool`` (features g0..g198, u1..u24,
    i1..i15 with their float32 values, userId and itemId in metadataMap),
    and JSON index stores global, user and item with the intercept where
    build_problem has it. Returns the shard maps."""
    from photon_ml_tpu_torch.data.index_map import (
        INTERCEPT_KEY,
        IndexMap,
        feature_key,
    )

    maps = {s: IndexMap({**{feature_key(n): c for n, c in zip(
        PATH6_NAMES[s], PATH6_COLS[s])},
        INTERCEPT_KEY: D_FIXED - 1 if s == "global" else 0})
        for s in PATH6_NAMES}
    (root / "feature-index").mkdir(parents=True)
    for s, imap in maps.items():
        imap.save(root / "feature-index" / f"{s}.json")
    jobs = []
    for data, n, tag in ((train, PATH6_TRAIN, "train"),
                         (val, PATH6_VAL, "validate")):
        parts = PATH6_PARTS[tag]
        (root / tag).mkdir()
        dense = {s: data.feature_shards[s][:n].toarray()[:, PATH6_COLS[s]]
                 for s in PATH6_NAMES}
        names = {t: data.id_columns[t].vocabulary[data.id_columns[t]
                                                  .codes[:n]]
                 for t in ("userId", "itemId")}
        for k, rows in enumerate(np.array_split(np.arange(n), parts)):
            sl = slice(rows[0], rows[-1] + 1)
            jobs.append(pool.submit(
                _write_part, root / tag / f"part-{k:05d}.avro",
                {s: v[sl] for s, v in dense.items()}, data.responses[sl],
                names["userId"][sl], names["itemId"][sl], tag, rows[0]))
    for job in jobs:
        job.result()
    return maps


PATH6_RE_CFG = "20,1e-6,1.0,1.0,LBFGS,L2"
PATH6_MF_DATA = "itemFactors:itemId,item,1,-1,-1,-1,IDENTITY"
PATH6_MF_OPT = (f"itemFactors:{PATH6_RE_CFG};{PATH6_RE_CFG};"
                f"{MF_ITERATIONS},{MF_FACTORS}")


def path6_argv(root: Path) -> list:
    """The training driver's flags of path 6 (bench.py's config 5 on the
    Avro files under ``root``), without --output-dir."""
    return [
        "--train-input-dirs", str(root / "train"),
        "--validate-input-dirs", str(root / "validate"),
        "--feature-index-dir", str(root / "feature-index"),
        "--task-type", "LOGISTIC_REGRESSION",
        "--fixed-effect-data-configurations", "fixed:global",
        "--fixed-effect-optimization-configurations",
        "fixed:50,1e-7,1.0,1.0,LBFGS,L2",
        "--random-effect-data-configurations",
        "perUser:userId,user,1,-1,-1,-1",
        "perItem:itemId,item,1,-1,-1,-1",
        "--random-effect-optimization-configurations",
        f"perUser:{PATH6_RE_CFG}", f"perItem:{PATH6_RE_CFG}",
        "--factored-random-effect-data-configurations", PATH6_MF_DATA,
        "--factored-random-effect-optimization-configurations",
        PATH6_MF_OPT,
        "--updating-sequence", PATH6_SEQUENCE,
        "--num-iterations", str(CD_ITERATIONS),
        "--evaluators", "AUC,LOGISTIC_LOSS"]


#: Chrome-trace categories of device activity in torch.profiler's export.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: Stage names every GAME training driver run opens (the root span and
#: its phases; JAX's names).
TRAINING_STAGES = {"driver", "ingest", "solve", "finalize"}


def telemetry_checks(tag: str, summary: dict, trace_path: Path,
                     stages: set) -> dict:
    """A driver run's telemetry: metrics.json's ``telemetry`` block holds
    ``stages`` and attributes at least 0.9 of the run's wall time (the
    share JAX documents, docs/OBSERVABILITY.md:150-157); its
    ``--trace-out`` Chrome trace parses, with one named track a thread.
    Returns the trace's span names by track."""
    tel = summary["telemetry"]
    att = tel["stage_attribution"]
    frac = tel["attributed_wall_frac"]
    doc = json.loads(trace_path.read_text())
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    tracks = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    by_track = {tracks.get(t, t): sorted({e["name"] for e in spans
                                          if e["tid"] == t})
                for t in sorted({e["tid"] for e in spans})}
    print(f"{tag} telemetry: stages {sorted(att)}, attributed wall "
          f"{tel['attributed_wall_seconds']:.3f} of {tel['wall_seconds']:.3f}"
          f" s ({frac:.4f}); trace {trace_path.stat().st_size} bytes, "
          f"{len(spans)} spans on {len(tracks)} tracks {by_track}; "
          f"flight recorder {summary['observability']['flight_recorder']}",
          flush=True)
    check(stages <= set(att), f"{tag}: stages {sorted(att)} lack "
          f"{sorted(stages - set(att))}")
    check(frac >= 0.9, f"{tag}: attributed wall fraction {frac}")
    check(set(tracks) == {e["tid"] for e in spans} and "driver"
          in tracks.values(), f"{tag}: trace tracks {tracks}")
    return by_track


def device_activity(trace_path: Path, card: str) -> dict:
    """The profiled window of a torch.profiler trace (utils/profiling.py,
    CPU and CUDA activity): its device busy share (the union of kernel,
    memcpy and memset intervals over the window, from the first to the
    last event of any kind), the idle share, the busy share from the
    first CUDA graph launch on (the fused updates and their validations,
    None without a replay), the three largest idle gaps
    with what the host was doing in each: the operations that cover the
    gap's midpoint (outermost and innermost ``cpu_op``, and the CUDA
    runtime call if one is under way) or, where none does (Python
    between operations), the last operation to end before the midpoint
    and the first to start after it; and the device time by kernel
    name."""
    doc = json.loads(trace_path.read_text())
    events = [e for e in doc["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in DEVICE_CATEGORIES)
    merged = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:3]
    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime")]

    def under(t: float, cat: str) -> list:
        return sorted((e for e in host if e["cat"] == cat
                       and e["ts"] <= t <= e["ts"] + e["dur"]),
                      key=lambda e: -e["dur"])

    cpu_ops = [e for e in host if e["cat"] == "cpu_op"]
    gap_rows = []
    for dur, start in gaps:
        mid = start + dur / 2
        ops = under(mid, "cpu_op")
        rt = under(mid, "cuda_runtime")
        ended = [e for e in cpu_ops if e["ts"] + e["dur"] <= mid]
        starts = [e for e in cpu_ops if e["ts"] >= mid]
        gap_rows.append({
            "ms": dur / 1e3, "at_ms": (start - lo) / 1e3,
            "outer_op": ops[0]["name"] if ops else None,
            "inner_op": ops[-1]["name"] if ops else None,
            "runtime": rt[-1]["name"] if rt else None,
            "op_before": (max(ended, key=lambda e: e["ts"] + e["dur"])
                          ["name"] if ended else None),
            "op_after": (min(starts, key=lambda e: e["ts"])["name"]
                         if starts else None)})
    by_kernel = {}
    for e in events:
        if e.get("cat") == "kernel":
            by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + e["dur"]
    window = hi - lo
    # The replays' window: from the first CUDA graph launch to the end of
    # the last device event (the fused coordinate-descent loop, with its
    # validations).
    replays = [e["ts"] for e in host if e["cat"] == "cuda_runtime"
               and e["name"].startswith("cudaGraphLaunch")]
    graph_share = graph_ms = None
    if replays and merged:
        g0, g1 = min(replays), merged[-1][1]
        graph_ms = (g1 - g0) / 1e3
        graph_share = sum(max(0.0, min(b, g1) - max(a, g0))
                          for a, b in merged) / (g1 - g0)
    out = {"window_ms": window / 1e3, "busy_ms": busy / 1e3,
           "busy_share": busy / window, "idle_share": 1 - busy / window,
           "replay_window_ms": graph_ms, "replay_busy_share": graph_share,
           "device_events": len(dev), "gaps": gap_rows,
           "kernel_ms": {k: v / 1e3 for k, v in sorted(
               by_kernel.items(), key=lambda kv: -kv[1])},
           "kernel_events": [e["name"] for e in events
                             if e.get("cat") == "kernel"]}
    top = dict(list(out["kernel_ms"].items())[:5])
    print(f"profile {trace_path.name}: window {out['window_ms']:.1f} ms, "
          f"device busy {out['busy_ms']:.1f} ms (share "
          f"{out['busy_share']:.4f}, idle {out['idle_share']:.4f}) over "
          f"{len(dev)} kernel/memcpy/memset events; from the first graph "
          f"replay on: {graph_ms} ms, busy share {graph_share}; largest "
          f"idle gaps "
          f"{gap_rows}; device ms by kernel (top 5) "
          f"{ {k[:60]: round(v, 3) for k, v in top.items()} }; card {card}",
          flush=True)
    return out


def path6(train, val, specs5, root: Path) -> int:
    """Path 6: bench.py's config 5 through the training driver on Avro
    inputs, the model saved and loaded back, then the scoring driver on
    the hold-out. Checks: the entity kernel launched once per bucket and
    solve, as the estimator's own run on the decoded data gives; the
    driver's objective history equals that run's bit for bit; every
    bucket of that run's first update holds against the plain version
    (``replay_first_updates``); the loaded model gives the trained
    coefficients exactly; the scoring driver's AUC is the best validation
    AUC of training within 1e-6. (Its ``scoring_path`` is a constant; the
    device path is what DeviceGameScorer, which raises on a sub-model it
    cannot score, guarantees.) The training run takes ``--trace-out`` and
    ``--profile-output-dir``, and the estimator's run has telemetry off,
    so the bit-for-bit history also shows that telemetry moves no bit;
    its telemetry block and trace pass ``telemetry_checks``, and the
    profiler trace of the solve holds as many entity-kernel events as the
    wrapper counted, and gives the solve's device busy share
    (``device_activity``). Its files stay under ``root`` for path 7.
    Returns the driver run's entity-kernel launches and the replayed
    bucket rows."""
    import torch

    from photon_ml_tpu_torch.cli import (
        game_scoring_driver,
        game_training_driver,
    )
    from photon_ml_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_ml_tpu_torch.evaluation import build_evaluator
    from photon_ml_tpu_torch.io.avro_codec import read_container
    from photon_ml_tpu_torch.io.model_io import load_game_model
    from photon_ml_tpu_torch.ops import entity_solver
    from photon_ml_tpu_torch.types import TaskType
    from photon_ml_tpu_torch.utils.vocab import vocab_code_lookup

    print(f"path 6 cut: rows only, {PATH6_TRAIN} training and {PATH6_VAL} "
          "hold-out rows of bench.py's 200,000 (written by the "
          "pure-Python codec, read by the C block decoder); widths, "
          "entities and configurations as path 5",
          flush=True)
    log = _DriverLog()
    logging.getLogger("photon_ml_tpu_torch").addHandler(log)
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(sum(PATH6_PARTS.values()),
                             mp_context=spawn) as pool:
        t0 = time.perf_counter()
        maps = write_path6_inputs(train, val, root, pool)
        write_s = time.perf_counter() - t0
        # The estimator's own decode of the same files, in two workers
        # while the driver runs here.
        decoded = [pool.submit(_decode, root / tag, root / "feature-index")
                   for tag in ("train", "validate")]
        argv = [*path6_argv(root), "--output-dir", str(root / "model"),
                "--trace-out", str(root / "path6-trace.json"),
                "--profile-output-dir", str(root / "path6-profile")]
        # ---- the main path: counts set to 0 just before, read just after --
        entity_solver.reset_launch_counts()
        t0 = time.perf_counter()
        summary = game_training_driver.run(argv)
        driver_s = time.perf_counter() - t0
        launches = dict(entity_solver.entity_lbfgs.variants)
        # ----------------------------------------------------------------
        train_phases = dict(log.phases)
        driver_updates = list(log.updates)
        card = card_line()
        telemetry_checks("path 6", summary, root / "path6-trace.json",
                         TRAINING_STAGES)
        (prof,) = sorted((root / "path6-profile").glob("*.json"))
        t0 = time.perf_counter()
        act = device_activity(prof, card)
        entity_events = sum(1 for name in act["kernel_events"]
                            if "entity_lbfgs_kernel" in name)
        print(f"path 6 profiler: the driver run {driver_s:.2f} s with the "
              f"solve profiled ({train_phases['solve']:.2f} s), trace "
              f"{prof.stat().st_size} bytes, read in "
              f"{time.perf_counter() - t0:.2f} s; entity kernel events "
              f"{entity_events}, wrapper launches {launches}; solve device "
              f"busy share {act['busy_share']:.4f}, idle share "
              f"{act['idle_share']:.4f}; card {card}", flush=True)
        check(entity_events == sum(launches.values()),
              f"path 6: the profile holds {entity_events} entity-kernel "
              f"events, the wrapper counted {launches}")

        # The estimator on the decoded data, in this process.
        t0 = time.perf_counter()
        data, vdata = (job.result() for job in decoded)
        decode_wait_s = time.perf_counter() - t0
        estimator = GameEstimator(
            TaskType.LOGISTIC_REGRESSION, specs5,
            num_iterations=CD_ITERATIONS,
            validation_evaluators=[build_evaluator("AUC"),
                                   build_evaluator("LOGISTIC_LOSS")])
        entity_solver.reset_launch_counts()
        results = estimator.fit(data, vdata)
        est_launches = dict(entity_solver.entity_lbfgs.variants)
        _, result = estimator.select_best(results)
        buckets = {n: len(getattr(m, "latent", m).local_coefs)
                   for n, m in result.model.models.items() if n != "fixed"}
        want = {"lbfgs": (buckets["perUser"] + buckets["perItem"]
                          + buckets["itemFactors"] * MF_ITERATIONS)
                * CD_ITERATIONS}
        print(f"path 6 entity-solver launches: driver {launches}, "
              f"estimator {est_launches}, buckets {buckets}", flush=True)
        check(launches == est_launches == want,
              f"path 6 launches {launches} / {est_launches} != {want}")
        check(summary["objectiveHistory"] == result.objective_history,
              f"path 6: driver objective history "
              f"{summary['objectiveHistory']} != the estimator's "
              f"{result.objective_history}")
        t0 = time.perf_counter()
        rows6 = replay_first_updates("path 6", coordinates_of(data, specs5),
                                     result.trackers)
        print(f"path 6 replay: {time.perf_counter() - t0:.1f} s",
              flush=True)

        # The saved model, loaded back, against the trained coefficients.
        t0 = time.perf_counter()
        loaded = load_game_model(root / "model" / "best", maps)
        load_s = time.perf_counter() - t0
        best = result.best_model.models
        fe = loaded.models["fixed"].glm.coefficients.means
        check(torch.equal(fe, best["fixed"].glm.coefficients.means.cpu()
                          .double()), "path 6: fixed effect not exact")
        for name in ("perUser", "perItem", "itemFactors"):
            snap = loaded.models[name]
            trained = best[name]
            rows = vocab_code_lookup(trained.latent.vocabulary
                                     if name == "itemFactors"
                                     else trained.vocabulary, snap.vocabulary)
            check(bool((rows >= 0).all()), f"path 6: {name} entities")
            want_m = trained.model_matrix().toarray()[rows]
            check(np.array_equal(snap.matrix.toarray(), want_m),
                  f"path 6: {name} coefficients not exact")
        latent = root / "model" / "best" / "random-effect" / "itemFactors"
        fac = best["itemFactors"]
        B = np.asarray([r["latentFactor"] for r in read_container(
            latent / "latent" / "projection-latent-factors.avro")])
        check(np.array_equal(B, fac.projection_matrix.cpu().double()
                             .numpy()), "path 6: B not exact")
        gamma = {r["effectId"]: r["latentFactor"] for r in read_container(
            latent / "latent" / "gamma-latent-factors.avro")}
        for coefs, codes in zip(fac.latent.local_coefs,
                                fac.latent.entity_codes):
            c = coefs.cpu().double().numpy()[:, :MF_FACTORS]
            got = np.asarray([gamma[str(fac.latent.vocabulary[k])]
                              for k in codes])
            check(np.array_equal(got, c), "path 6: gamma not exact")

        # The scoring driver on the hold-out.
        log.phases.clear()
        t0 = time.perf_counter()
        scored = game_scoring_driver.run([
            "--input-dirs", str(root / "validate"),
            "--game-model-input-dir", str(root / "model" / "best"),
            "--output-dir", str(root / "scores"),
            "--evaluators", "AUC"])
        score_s = time.perf_counter() - t0
        score_phases = dict(log.phases)
    logging.getLogger("photon_ml_tpu_torch").removeHandler(log)

    best_auc = max(m["AUC"] for m in summary["validationHistory"])
    auc = scored["metrics"]["AUC"]
    print(f"path 6 seconds: write {write_s:.2f}, ingest "
          f"{train_phases['ingest']:.2f}, solve {train_phases['solve']:.2f},"
          f" finalize {train_phases['finalize']:.2f}, score run "
          f"{score_s:.2f} (ingest {score_phases['ingest']:.2f}, score "
          f"{score_phases['score']:.3f}, load {score_phases['load_model']:.2f})"
          f"; the estimator's decode (in workers beside the driver) "
          f"waited {decode_wait_s:.2f} after the driver, load_game_model "
          f"{load_s:.2f}", flush=True)
    for it in range(CD_ITERATIONS):
        ms = {u["coordinate"]: round(1e3 * u["seconds"], 1)
              for u in driver_updates if u["iteration"] == it}
        print(f"path 6 iteration {it} update ms: {ms}", flush=True)
    print(f"path 6 final: training AUC {best_auc:.6f} (best of "
          f"{[round(m['AUC'], 6) for m in summary['validationHistory']]}),"
          f" scoring driver AUC {auc:.6f} on {scored['num_rows']} rows",
          flush=True)
    check(scored["num_rows"] == PATH6_VAL, f"path 6: scoring {scored}")
    check(abs(auc - best_auc) <= 1e-6,
          f"path 6: scoring AUC {auc} != training's best {best_auc}")
    return launches.get("lbfgs", 0), rows6


# examples/run_glm_driver.sh's flags, with every diagnostic (fitting and
# bootstrap train on the card too); path 7 adds the data, the index store
# and the output directories.
GLM_FLAGS = [
    "--task", "LOGISTIC_REGRESSION", "--format", "AVRO",
    "--max-num-iterations", "80", "--regularization-weights",
    "100,10,1,0.1", "--regularization-type", "L2", "--optimizer", "LBFGS",
    "--normalization-type", "STANDARDIZATION", "--compute-variance", "true",
    "--diagnostic-mode", "ALL", "--num-bootstrap-samples", "4"]
GLM_LAMBDAS = [100.0, 10.0, 1.0, 0.1]
GLM_STAGES = ["INIT", "PREPROCESSED", "TRAINED", "VALIDATED", "DIAGNOSED"]
DIAGNOSTIC_SECTIONS = ("featureImportance", "fitting", "bootstrap",
                       "hosmerLemeshow", "predictionErrorIndependence")
# Variances against the float64 host formula (float32 solve on the card).
VARIANCE_RTOL = 1e-3
# bf16 storage's final objective against float32 storage's, per λ
# (docs/F32_PARITY.md:75-77, tests/test_distributed.py:463-464).
BF16_OBJECTIVE_RTOL = 2e-3


def host_variances(x, off, w, coef, factors, shifts, l2):
    """1 / (diag H + 1e-12) in float64 numpy at the solve-space ``coef``:
    x' = (x - shifts) * factors, H = sum_i w_i p_i (1 - p_i) x'_i x'_i^T
    + l2 I (the logistic loss)."""
    xs = (x - shifts) * factors
    z = xs @ coef + off
    p = 1.0 / (1.0 + np.exp(-z))
    d = w * p * (1.0 - p)
    return 1.0 / ((d[:, None] * xs * xs).sum(axis=0) + l2 + 1e-12)


def path7(root: Path) -> dict:
    """Path 7: the GLM driver (photon_ml_tpu_torch.cli.glm_driver.run) on
    path 6's Avro files with run_glm_driver.sh's flags and every
    diagnostic, at bench.py's fixed-effect width through path 6's
    ``global`` index store (g0..g198 and the intercept; the u*/i*
    features are dropped as unknown). The driver's decoded matrices are
    kept by wrapping its ``_load``. Checks: the stages and the grid; the
    driver adds no arithmetic (train_glm_models on the same matrix gives
    its iterations, reasons and objectives bit for bit, coefficients on
    the card); model.avro and model.txt give the best λ's model exactly;
    the best λ's validation AUC equals evaluate_glm on the loaded model
    within 1e-12 and beats 0.5; variances finite, positive and within
    VARIANCE_RTOL of the float64 host formula; the diagnostics report
    with its four chapters. No kernel of the table launches."""
    import torch

    from photon_ml_tpu_torch.cli import glm_driver
    from photon_ml_tpu_torch.data.normalization import (
        build_normalization_context,
    )
    from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary
    from photon_ml_tpu_torch.estimators.model_training import (
        train_glm_models,
    )
    from photon_ml_tpu_torch.evaluation.validation import evaluate_glm
    from photon_ml_tpu_torch.io.avro_codec import read_container
    from photon_ml_tpu_torch.io.model_io import glm_from_avro_record
    from photon_ml_tpu_torch.ops import entity_solver, gather
    from photon_ml_tpu_torch.types import TaskType

    out = root / "glm"
    loaded = []
    load = glm_driver._load

    def keep_load(*args, **kwargs):
        res = load(*args, **kwargs)
        loaded.append(res)
        return res

    argv = ["--training-data-directory", str(root / "train"),
            "--validating-data-directory", str(root / "validate"),
            "--output-directory", str(out),
            "--offheap-indexmap-dir", str(root / "feature-index"),
            "--offheap-indexmap-namespace", "global",
            "--summarization-output-dir", str(root / "glm-summary"),
            *GLM_FLAGS]
    entity_solver.reset_launch_counts()
    gather.reset_launch_counts()
    glm_driver._load = keep_load
    try:
        t0 = time.perf_counter()
        summary = glm_driver.run(argv)
        run_s = time.perf_counter() - t0
    finally:
        glm_driver._load = load
    launched = (entity_solver.entity_lbfgs.launches
                + gather.onehot_gather.launches
                + gather.residue_gather.launches)
    (mat, y, off, w, imap), (vmat, vy, voff, vw, _) = loaded
    phases = {k: round(v, 3) for k, v in summary["phaseSeconds"].items()}
    print(f"path 7 cut: rows only, path 6's {mat.shape[0]} training and "
          f"{vmat.shape[0]} hold-out rows of bench.py's 200,000 at its "
          f"fixed-effect width {mat.shape[1]} (read by the C decoder)",
          flush=True)
    print(f"path 7 seconds: run {run_s:.2f}, phases {phases}", flush=True)
    conv = summary["convergence"]
    for lam in GLM_LAMBDAS:
        print(f"path 7 lambda {lam:g}: {conv[str(lam)]}", flush=True)
    check(launched == 0, f"path 7 launched a kernel of the table: "
          f"{launched}")
    check(summary["stages"] == GLM_STAGES, f"path 7 stages "
          f"{summary['stages']}")
    check(summary["lambdas"] == GLM_LAMBDAS
          and sorted(conv) == sorted(map(str, GLM_LAMBDAS))
          and all(math.isfinite(c["finalObjective"]) for c in conv.values()),
          f"path 7 grid: {summary['lambdas']}, {conv}")
    check((mat.shape[1], len(imap), imap.intercept_index)
          == (D_FIXED, D_FIXED, D_FIXED - 1),
          f"path 7 width {mat.shape} / {len(imap)}")

    # 2. The driver adds no arithmetic.
    norm = build_normalization_context(
        "STANDARDIZATION", BasicStatisticalSummary.compute(mat),
        intercept_id=imap.intercept_index)
    t0 = time.perf_counter()
    trained = train_glm_models(
        mat, y, TaskType.LOGISTIC_REGRESSION, GLM_LAMBDAS,
        max_iterations=80, offsets=off, weights=w, normalization=norm,
        compute_variances=True, dtype=torch.float32, device="cuda")
    lib_s = time.perf_counter() - t0
    for t in trained:
        c = conv[str(t.reg_weight)]
        got = (int(t.result.iterations), t.result.reason_enum().summary,
               float(t.result.value))
        check(got == (c["iterations"], c["reason"], c["finalObjective"]),
              f"path 7 lambda {t.reg_weight}: train_glm_models {got} != the "
              f"driver's {c}")
        check(t.model.coefficients.means.is_cuda
              and t.model.coefficients.variances.is_cuda,
              "path 7: coefficients not on the card")
    print(f"path 7 train_glm_models in process: {lib_s:.2f} s, iterations, "
          "reasons and objectives equal to the driver's bit for bit",
          flush=True)

    # 3. Save and load are exact.
    best = {t.reg_weight: t for t in trained}[summary["bestLambda"]]
    (rec,) = read_container(out / "best-model" / "model.avro")
    _, model = glm_from_avro_record(rec, imap)
    means = best.model.coefficients.means.cpu().double()
    variances = best.model.coefficients.variances.cpu().double()
    check(torch.equal(model.coefficients.means, means)
          and torch.equal(model.coefficients.variances, variances),
          "path 7: model.avro does not give the trained model exactly")
    lines = (out / "best-model" / "model.txt").read_text().splitlines()
    check(len(lines) == len(imap) and all(
        ln.split("\t")[3] == str(summary["bestLambda"]) for ln in lines),
        "path 7: model.txt")

    # 4. Validation metrics, on the loaded model's host scores.
    metrics = json.loads((out / "validation-metrics.json").read_text())
    auc = metrics["metrics"][str(summary["bestLambda"])]["AUC"]
    want = evaluate_glm(TaskType.LOGISTIC_REGRESSION,
                        np.asarray(vmat @ model.coefficients.means.numpy())
                        .ravel(), vy, voff, vw)["AUC"]
    print(f"path 7 final: best lambda {summary['bestLambda']:g}, AUC "
          f"{auc:.6f} (evaluate_glm on the loaded model {want:.6f})",
          flush=True)
    check(abs(auc - want) <= 1e-12 and auc > 0.5, f"path 7 AUC {auc} vs "
          f"{want}")

    # 5. Variances against the float64 host formula.
    x = mat.toarray()
    factors = norm.factors.double().cpu().numpy()
    shifts = norm.shifts.double().cpu().numpy()
    worst = 0.0
    for t in trained:
        var = t.model.coefficients.variances.double().cpu().numpy()
        ref = host_variances(x, off, w, t.result.x.double().cpu().numpy(),
                             factors, shifts, t.reg_weight)
        check(bool(np.isfinite(var).all() and (var > 0).all()),
              f"path 7 lambda {t.reg_weight}: variances not finite positive")
        err = float(np.max(np.abs(var - ref) / ref))
        worst = max(worst, err)
        check(err <= VARIANCE_RTOL, f"path 7 lambda {t.reg_weight}: "
              f"variances {err:.3g} from the float64 formula")
    print(f"path 7 variances: worst relative error {worst:.3g} against the "
          f"float64 host formula (bound {VARIANCE_RTOL})", flush=True)

    # 6. The diagnostics report.
    report = json.loads((out / "model-diagnostic.json").read_text())
    check(len(report["models"]) == 4 and all(
        set(DIAGNOSTIC_SECTIONS) <= set(m) for m in report["models"])
        and (out / "model-diagnostic.html").stat().st_size > 0,
        "path 7: model-diagnostic.json lacks a chapter or a section")
    summarized = list(read_container(root / "glm-summary"
                                     / "part-00000.avro"))
    check(len(summarized) == D_FIXED, "path 7: feature summary")
    return summary["phaseSeconds"]


def glm_full_width(train) -> None:
    """train_glm_models on the full training fixed shard (bench.py's data,
    160,000 x 200, seed 7) with path 7's grid, STANDARDIZATION and
    variances, once with float32 storage and once with bfloat16 storage
    (float32 accumulation). Prints the batch build's seconds (host
    densify and upload), per λ the iterations, seconds (each λ's solve and
    variances, from the log record the trainer writes after it) and ms
    per iteration, and the two products' ms on the batch (CUDA events
    around 20 calls) beside their bound (x read once at its storage
    width); checks that bf16 stays bf16, that every λ's bf16 objective is
    within BF16_OBJECTIVE_RTOL of float32's, and that the variances are
    finite and positive."""
    import torch

    from photon_ml_tpu_torch.data.normalization import (
        build_normalization_context,
    )
    from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary
    from photon_ml_tpu_torch.estimators import model_training
    from photon_ml_tpu_torch.types import TaskType

    mat = train.feature_shards["global"]
    norm = build_normalization_context(
        "STANDARDIZATION", BasicStatisticalSummary.compute(mat),
        intercept_id=D_FIXED - 1)

    class Stamps(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.times = []

        def emit(self, record):
            self.times.append(record.created)

    log = logging.getLogger(model_training.__name__)
    log.setLevel(logging.INFO)
    batches, built = [], []
    make_batch = model_training.device_batch

    def keep_batch(*args, **kwargs):
        batches.append(make_batch(*args, **kwargs))
        torch.cuda.synchronize()
        built.append(time.time())
        return batches[-1]

    runs = {}
    for name, storage in (("float32", None), ("bfloat16", torch.bfloat16)):
        stamps = Stamps()
        log.addHandler(stamps)
        model_training.device_batch = keep_batch
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            trained = model_training.train_glm_models(
                mat, train.responses, TaskType.LOGISTIC_REGRESSION,
                GLM_LAMBDAS, max_iterations=80, normalization=norm,
                compute_variances=True, dtype=torch.float32,
                storage_dtype=storage, device="cuda")
        finally:
            model_training.device_batch = make_batch
            log.removeHandler(stamps)
        feats = batches[-1].features
        stored = feats.x.dtype
        check(stored == (storage or torch.float32),
              f"full width {name}: features stored as {stored}")
        ends = stamps.times[-len(GLM_LAMBDAS):]
        starts = [built[-1]] + ends[:-1]
        rows = []
        for t, s, e in zip(trained, starts, ends):
            it = int(t.result.iterations)
            var = t.model.coefficients.variances
            check(bool(torch.isfinite(var).all() and (var > 0).all()),
                  f"full width {name} lambda {t.reg_weight}: variances")
            rows.append({"lambda": t.reg_weight, "iterations": it,
                         "reason": t.result.reason_enum().name,
                         "objective": float(t.result.value),
                         "s": round(e - s, 4),
                         "ms_per_iteration": round(1e3 * (e - s)
                                                   / max(it, 1), 3)})
        runs[name] = rows
        v = torch.randn(mat.shape[1], device="cuda")
        u = torch.randn(mat.shape[0], device="cuda")
        products = {}
        for op, arg in (("matvec", v), ("rmatvec", u)):
            fn = getattr(feats, op)
            fn(arg)
            products[f"{op}_ms"] = round(cuda_ms(lambda: fn(arg), 20), 5)
        bound = (feats.x.numel() * feats.x.element_size()) / HBM_BYTES_PER_S
        products["bound_ms"] = round(1e3 * bound, 5)
        print(f"glm full width {name} storage ({mat.shape[0]} x "
              f"{mat.shape[1]}): batch {built[-1] - t0:.3f} s, products "
              f"{json.dumps(products)}, per lambda " + json.dumps(rows),
              flush=True)
    for f32, b16 in zip(runs["float32"], runs["bfloat16"]):
        rel = abs(b16["objective"] - f32["objective"]) / abs(f32["objective"])
        check(rel <= BF16_OBJECTIVE_RTOL,
              f"full width lambda {f32['lambda']}: bf16 objective "
              f"{b16['objective']} vs float32 {f32['objective']} ({rel:.3g})")
    print("glm full width: bf16 objectives within "
          f"{BF16_OBJECTIVE_RTOL} of float32 per lambda", flush=True)


# Path 8: the training driver's --stream-train on path 6's files, the
# fixed effect over the `global` shard (200 features with the intercept),
# L-BFGS/L2 on a 4-point grid swept one λ at a time.
PATH8_GRID = ("fixed:50,1e-7,100,1.0,LBFGS,L2|50,1e-7,10,1.0,LBFGS,L2|"
              "50,1e-7,1,1.0,LBFGS,L2|50,1e-7,0.1,1.0,LBFGS,L2")
PATH8_BATCH_ROWS = 4096
# The JAX package's bound of a bf16-spill model against the f32-spill
# model, per coefficient (tests/test_cli_drivers.py:826-828).
BF16_RTOL, BF16_ATOL = 0.1, 5e-3
# The full-width stream phase: bench.py's training fixed shard in
# 16,384-row batches.
STREAM_BATCH_ROWS = 16_384
FP32_FLOPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
SPMV_SOURCE = "photon_ml_tpu_torch/csrc/csr_spmv.cu"
# The product it stands for (no TPU kernel: XLA's gather and segment sum).
SPMV_REPLACES = "photon_ml_tpu/ops/features.py:137"
SPMV_RTOL = 1e-5  # of sum |a_k x_k|, float32 against cuSPARSE


def _fixed_records(out: Path) -> list:
    """Decoded coefficient records of a driver run's best fixed effect."""
    from photon_ml_tpu_torch.io.avro_codec import read_container

    files = sorted((out / "best" / "fixed-effect").rglob("*.avro"))
    check(files, f"no fixed-effect model under {out}")
    return [rec for f in files for rec in read_container(f)]


def _means(records) -> dict:
    return {(m["name"], m["term"]): m["value"]
            for rec in records for m in rec["means"]}


def codec_ms_a_row(path: Path) -> dict:
    """ms a row of the C block decoder and of the pure-Python codec on one
    Avro file, through the streaming feeder (one batch, no prefetch)."""
    from photon_ml_tpu_torch.data.block_stream import BlockGameStream
    from photon_ml_tpu_torch.data.paldb import load_feature_index_maps

    maps = load_feature_index_maps(path.parent.parent / "feature-index")
    out = {}
    for feeder in ("native", "python"):
        stream = BlockGameStream(path, ["userId", "itemId"], maps,
                                 batch_rows=1 << 40, feeder=feeder,
                                 prefetch_depth=0)
        t0 = time.perf_counter()
        rows = sum(ds.num_rows for ds in stream)
        out[feeder] = 1e3 * (time.perf_counter() - t0) / rows
        out["rows"] = rows
    return out


def path8(root: Path) -> tuple:
    """Path 8: the training driver with --stream-train on path 6's files
    (40,000 training and 10,000 hold-out rows, the fixed effect over the
    200-feature ``global`` shard, L-BFGS/L2 on PATH8_GRID with
    --grid-batched off, --feeder native, PATH8_BATCH_ROWS-row shards),
    five ways: resident; --hbm-budget above the shard's device bytes;
    at about a quarter of them (f32 buffer spill); the same with
    --spill-source redecode on one λ of the grid, the quarter run's best
    (a cut of depth: the redecode run re-decodes every miss); and
    --spill-dtype bf16. Checks: the C
    decoder decoded every run; the budget forced evictions where it is
    below the shard's bytes; the three f32 spill runs write the same
    decoded best model; the resident run writes the one-shot driver's
    model on the same flags bit for bit; the bf16 model is within
    BF16_RTOL/BF16_ATOL of the f32 one per coefficient; the streamed
    validation AUC of the best λ equals the batch scoring driver's on
    that model within 1e-6; the deterministic product launched in every
    spill run; in every cached run the registry's ``data.shard_cache.*``
    counters of metrics.json's ``telemetry`` block equal its
    ``stream_train.cache`` block (SHARD_CACHE_KEYS).

    The five --stream-train runs take --distmon (the one-shot run cannot:
    the flag rides the streamed decode), and a sixth, the budget-above
    run without it, shows that --distmon moves no model bit (its records
    equal the f32 spill runs'). Checks (``distmon_checks``): the
    ``data_quality.state_sha256`` is the same in all five (the monitor
    sees each decoded batch before the cache picks its storage type or
    re-decodes); it counted the 40,000 training rows; the spill runs'
    rings carry a step and the resident run's come from the solver
    history (no step); every run's best model-metadata.json carries
    ``referenceDistributions`` with label and score sketches of 40,000
    rows; the resident scores (one row-9 product of the assembled batch)
    and the f32 spill runs' (the solver's final margins) have medians
    within 5% of each other (the bf16 run trains another model).

    Returns its launches in the spill runs, and the quarter budget and
    the quarter f32 run's summary (path 9 holds the batched grid against
    it)."""
    from photon_ml_tpu_torch.cli import (
        game_scoring_driver,
        game_training_driver,
    )
    from photon_ml_tpu_torch.ops import spmv

    log = _DriverLog()
    logging.getLogger("photon_ml_tpu_torch").addHandler(log)
    base = ["--train-input-dirs", str(root / "train"),
            "--validate-input-dirs", str(root / "validate"),
            "--feature-index-dir", str(root / "feature-index"),
            "--task-type", "LOGISTIC_REGRESSION",
            "--fixed-effect-data-configurations", "fixed:global",
            "--updating-sequence", "fixed",
            "--evaluators", "AUC,LOGISTIC_LOSS"]
    stream = ["--stream-train", "--grid-batched", "off", "--feeder",
              "native", "--batch-rows", str(PATH8_BATCH_ROWS)]
    runs = {}

    def run(tag, extra, grid=PATH8_GRID):
        log.phases.clear()
        spmv.reset_launch_counts()
        t0 = time.perf_counter()
        summary = game_training_driver.run(
            [*base, "--fixed-effect-optimization-configurations", grid,
             *extra, "--output-dir", str(root / f"p8-{tag}")])
        seconds = time.perf_counter() - t0
        launches = spmv.csr_matvec.launches
        info = summary.get("stream_train") or {}
        cache = info.get("cache") or {}
        runs[tag] = dict(summary=summary, launches=launches)
        counters = summary["telemetry"]["metrics"]["counters"]
        registry = {k: counters.get(f"data.shard_cache.{k}")
                    for k in SHARD_CACHE_KEYS}
        if cache:
            print(f"path 8 {tag} registry: {registry}", flush=True)
            check(registry == {k: cache[k] for k in SHARD_CACHE_KEYS},
                  f"path 8 {tag}: registry {registry} != cache {cache}")
        print(f"path 8 {tag}: {seconds:.2f} s, phases "
              f"{ {k: round(v, 3) for k, v in log.phases.items()} }, best "
              f"{summary['bestConfigs']['fixed']}, validation AUC "
              f"{[round(m['AUC'], 6) for m in summary['validationHistory']]}"
              f", decode {(info.get('feeder') or {}).get('decode_path')}, "
              f"cache { {k: cache.get(k) for k in ('shards', 'hits', 'misses', 'evictions', 'epochs', 'bytes_reuploaded', 'bytes_redecoded', 'peak_device_bytes', 'spill_bytes_host')} }"
              f", product launches {launches}", flush=True)
        return summary

    run("oneshot", [])
    monitored = [*stream, "--distmon"]
    run("resident", monitored)
    hi = run("budget-above", [*monitored, "--hbm-budget", "1G"])
    run("budget-above-plain", [*stream, "--hbm-budget", "1G"])
    shard_bytes = hi["stream_train"]["cache"]["device_bytes"]
    quarter = str(shard_bytes // 4)
    q = run("quarter-f32", [*monitored, "--hbm-budget", quarter])
    best = q["bestConfigs"]["fixed"]
    run("quarter-redecode", [*monitored, "--hbm-budget", quarter,
                             "--spill-source", "redecode"],
        grid="fixed:" + best)
    run("quarter-bf16", [*monitored, "--hbm-budget", quarter,
                         "--spill-dtype", "bf16"])
    logging.getLogger("photon_ml_tpu_torch").removeHandler(log)
    print(f"path 8 shard: {shard_bytes} device bytes (CSR and transpose, "
          f"int32 indices), quarter budget {quarter}", flush=True)

    for tag, r in runs.items():
        if tag == "oneshot":
            continue
        info = r["summary"]["stream_train"]
        check(info["feeder"]["decode_path"] == "native",
              f"path 8 {tag}: decode path {info['feeder']}")
        if tag != "resident":
            check(r["launches"] > 0, f"path 8 {tag}: the product kernel "
                  "did not launch")
    check(runs["budget-above"]["summary"]["stream_train"]["cache"]
          ["evictions"] == 0, "path 8: the budget above the shard evicted")
    for tag in ("quarter-f32", "quarter-redecode", "quarter-bf16"):
        check(runs[tag]["summary"]["stream_train"]["cache"]["evictions"]
              > 0, f"path 8 {tag}: no eviction")
    recs = {tag: _fixed_records(root / f"p8-{tag}") for tag in runs}
    check(recs["budget-above"] == recs["quarter-f32"]
          == recs["quarter-redecode"],
          "path 8: the f32 spill runs' models differ")
    check(recs["budget-above-plain"] == recs["budget-above"],
          "path 8: --distmon moved a model bit")
    distmon_checks(root, runs)
    check(runs["quarter-redecode"]["summary"]["bestConfigs"]
          == runs["quarter-f32"]["summary"]["bestConfigs"],
          "path 8: the redecode run selected another λ")
    check(recs["resident"] == recs["oneshot"],
          "path 8: the resident run's model differs from the one-shot "
          "driver's")
    ref, got = _means(recs["quarter-f32"]), _means(recs["quarter-bf16"])
    check(set(ref) == set(got), "path 8: bf16 model features")
    keys = sorted(ref)
    a, b = (np.asarray([m[k] for k in keys]) for m in (got, ref))
    worst = float(np.max(np.abs(a - b) / (BF16_ATOL + BF16_RTOL * np.abs(b))))
    print(f"path 8 bf16 vs f32 spill model: max |dc| "
          f"{float(np.max(np.abs(a - b))):.3g}, worst share of the bound "
          f"{worst:.3g}", flush=True)
    check(np.allclose(a, b, rtol=BF16_RTOL, atol=BF16_ATOL),
          "path 8: bf16 model outside its bound")
    res = runs["resident"]["summary"]
    best_auc = max(m["AUC"] for m in res["validationHistory"])
    scored = game_scoring_driver.run([
        "--input-dirs", str(root / "validate"),
        "--game-model-input-dir", str(root / "p8-resident" / "best"),
        "--output-dir", str(root / "p8-scores"), "--evaluators", "AUC"])
    print(f"path 8 final: streamed validation AUC {best_auc:.6f}, scoring "
          f"driver AUC {scored['metrics']['AUC']:.6f}", flush=True)
    check(abs(scored["metrics"]["AUC"] - best_auc) <= 1e-6,
          f"path 8: scoring AUC {scored['metrics']['AUC']} != streamed "
          f"validation's {best_auc}")
    codec = codec_ms_a_row(root / "train" / "part-00000.avro")
    print(f"path 8 decode of path 6's first training part ({codec['rows']} "
          f"rows): C block decoder {codec['native']:.4f} ms a row, "
          f"pure-Python codec {codec['python']:.4f} ms a row", flush=True)
    launches = sum(r["launches"] for t, r in runs.items()
                   if t not in ("oneshot", "resident", "budget-above-plain"))
    return launches, {"quarter": quarter,
                      "quarter-f32": runs["quarter-f32"]["summary"],
                      "quarter-f32-launches": runs["quarter-f32"]["launches"]}


#: Path 8's --distmon runs (the one-shot run and the plain budget-above
#: run take no --distmon).
PATH8_DISTMON = ("resident", "budget-above", "quarter-f32",
                 "quarter-redecode", "quarter-bf16")
#: JAX's tolerance between the two training-score surfaces, one product
#: against the solver's margins (tests/test_distmon.py:378-389).
SCORE_MEDIAN_RTOL = 0.05


def distmon_checks(root: Path, runs: dict) -> None:
    """Path 8's --distmon checks (``path8``'s docstring)."""
    from photon_ml_tpu_torch.telemetry.sketches import QuantileSketch

    dq = {tag: runs[tag]["summary"]["data_quality"] for tag in PATH8_DISTMON}
    hashes = {tag: d["state_sha256"] for tag, d in dq.items()}
    medians = {}
    for tag, d in dq.items():
        ref = json.loads((root / f"p8-{tag}" / "best"
                          / "model-metadata.json").read_text())[
            "referenceDistributions"]
        label = QuantileSketch.from_state(ref["label"])
        score = QuantileSketch.from_state(ref["score"])
        medians[tag] = score.quantile(0.5)
        steps = [e["step"] for ring in d["convergence"].values()
                 for e in ring["tail"][1:]]
        from_history = all(s is None for s in steps)
        print(f"path 8 {tag} distmon: rows {d['rows']}, batches "
              f"{d['batches']}, state_sha256 {d['state_sha256'][:16]}, "
              f"label mean {d['columns']['label']['moments']['mean']:.6f}, "
              f"feature values {d['feature_shards']['global']['moments']['count']}"
              f", rings {len(d['convergence'])} "
              f"({'from history' if from_history else 'live, with steps'})"
              f", reference label/score rows {label.count}/{score.count}, "
              f"score median {medians[tag]:.6f}", flush=True)
        check(d["rows"] == PATH6_TRAIN and label.count == score.count
              == PATH6_TRAIN, f"path 8 {tag}: distmon counted {d['rows']}")
        check(steps and from_history == (tag == "resident"),
              f"path 8 {tag}: ring steps {steps[:4]}")
    check(len(set(hashes.values())) == 1,
          f"path 8: data_quality.state_sha256 differs: {hashes}")
    # The f32 runs' two surfaces; the bf16 run trains another model.
    base = medians["budget-above"]
    worst = max(abs(medians[tag] - base) / abs(base)
                for tag in ("resident", "quarter-f32", "quarter-redecode"))
    print(f"path 8 distmon: one state_sha256 across {len(hashes)} runs; "
          f"the f32 runs' score medians within {worst:.3g} of the "
          f"budget-above run's (bound {SCORE_MEDIAN_RTOL})", flush=True)
    check(worst <= SCORE_MEDIAN_RTOL, f"path 8: score medians {medians}")


#: The shard cache's counters that the registry mirrors (path 8).
SHARD_CACHE_KEYS = ("hits", "misses", "evictions", "bytes_reuploaded",
                    "bytes_redecoded")


class _Batches(list):
    """A list of GameDatasets with the stream's ``stats``."""

    def stats(self) -> dict:
        return {"decode_path": "memory", "batches": len(self)}


def spmv_entry(block, launches: int) -> dict:
    """Kernel row 9 on one cached block of the full-width phase: its
    matvec and rmatvec held against the plain version (torch.mv on the
    same CSR tensors: cuSPARSE), 20 calls of each compared bit for bit
    (the kernel must be deterministic; cuSPARSE's result is printed),
    and timed against the bound of the pair."""
    import torch

    from photon_ml_tpu_torch.ops import spmv

    g = torch.Generator(device="cuda").manual_seed(0)
    v = torch.randn(block.n_features, generator=g, device="cuda")
    u = torch.randn(block.n_rows, generator=g, device="cuda")
    k_mv, k_rmv = block.matvec(v), block.rmatvec(u)
    p_mv = spmv.csr_matvec_plain(block.crow, block.col, block.values, v,
                                 block.n_features)
    p_rmv = spmv.csr_matvec_plain(block.crow_t, block.row_t,
                                  block.values_t, u, block.n_rows)
    a_mv = spmv.csr_matvec_plain(block.crow, block.col, block.values.abs(),
                                 v.abs(), block.n_features)
    a_rmv = spmv.csr_matvec_plain(block.crow_t, block.row_t,
                                  block.values_t.abs(), u.abs(),
                                  block.n_rows)
    err = max(float((k_mv - p_mv).abs().max()),
              float((k_rmv - p_rmv).abs().max()))
    share = max(float(((k_mv - p_mv).abs() / a_mv.clamp_min(1e-30)).max()),
                float(((k_rmv - p_rmv).abs() / a_rmv.clamp_min(1e-30))
                      .max()))
    kernel_bitwise = all(
        torch.equal(block.matvec(v), k_mv)
        and torch.equal(block.rmatvec(u), k_rmv) for _ in range(20))
    plain_bitwise = [all(torch.equal(f(), ref) for _ in range(20))
                     for f, ref in (
                         (lambda: spmv.csr_matvec_plain(
                             block.crow, block.col, block.values, v,
                             block.n_features), p_mv),
                         (lambda: spmv.csr_matvec_plain(
                             block.crow_t, block.row_t, block.values_t, u,
                             block.n_rows), p_rmv))]
    spmv.reset_launch_counts()

    def pair():
        block.matvec(v)
        block.rmatvec(u)

    def plain_pair():
        spmv.csr_matvec_plain(block.crow, block.col, block.values, v,
                              block.n_features)
        spmv.csr_matvec_plain(block.crow_t, block.row_t, block.values_t, u,
                              block.n_rows)

    ms = cuda_ms(pair, 20)
    dev_ms = device_ms(pair)
    host = {"matvec": host_ms(lambda: block.matvec(v)),
            "rmatvec": host_ms(lambda: block.rmatvec(u))}
    plain = cuda_ms(plain_pair, 20)
    a_csr = torch.sparse_csr_tensor(block.crow, block.col, block.values,
                                    size=(block.n_rows, block.n_features))
    a_csr_t = torch.sparse_csr_tensor(
        block.crow_t, block.row_t, block.values_t,
        size=(block.n_features, block.n_rows))
    library = cuda_ms(lambda: (torch.mv(a_csr, v), torch.mv(a_csr_t, u)),
                      20)
    nnz, n, d = block.nnz, block.n_rows, block.n_features
    bytes_pair = 2 * (8 * nnz + 4 * (n + d)) + 4 * (n + 1) + 4 * (d + 1)
    bound_bytes = 1e3 * bytes_pair / HBM_BYTES_PER_S
    bound_ops = 1e3 * 4 * nnz / FP32_FLOPS_PER_S
    print(f"spmv block {n} x {d} ({nnz} entries): kernel matvec+rmatvec "
          f"{ms:.4f} ms a pair ({dev_ms:.4f} on the device; host "
          f"{host['matvec']:.4f} ms a matvec call, {host['rmatvec']:.4f} an "
          f"rmatvec call), plain "
          f"(torch.mv, cuSPARSE) {plain:.4f}, bound {max(bound_bytes, bound_ops):.4f}"
          f" (bytes); max abs err {err:.3g}, worst share of "
          f"{SPMV_RTOL} x sum|a x| {share / SPMV_RTOL:.3g}; 20 calls bit "
          f"for bit: kernel {kernel_bitwise}, cuSPARSE matvec "
          f"{plain_bitwise[0]}, rmatvec {plain_bitwise[1]}", flush=True)
    check(kernel_bitwise, "spmv: the kernel is not deterministic")
    check(share <= SPMV_RTOL, f"spmv: kernel vs plain {share}")
    return {
        "name": "csr_spmv (deterministic CSR product, row 9)",
        "route": "cuda", "source": SPMV_SOURCE, "replaces": SPMV_REPLACES,
        "launches": launches, "max_abs_err": err, "ms": ms,
        "device_ms": dev_ms, "host_ms": host, "plain_ms": plain,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": library,
    }


def stream_full_width(train) -> tuple:
    """The full-width stream phase: bench.py's training fixed shard
    (160,000 x 200, CSR float32 with int32 indices, nothing cut) fed
    from memory in STREAM_BATCH_ROWS-row batches into DeviceShardCache,
    then streamed L-BFGS/L2 (path 1's fixed-effect configuration) with
    no budget and at about 25% of the shard's device bytes. Prints ms
    per iteration, feature passes per solve (each shard's index set is
    used once a pass), bytes re-uploaded per pass and one replay
    epoch's re-upload rate against a pinned copy_ of the same bytes.
    Checks: the coefficients are the same bits under both budgets.
    Returns (the deterministic product's launches, a cached block)."""
    import torch

    from photon_ml_tpu_torch.data.shard_cache import DeviceShardCache
    from photon_ml_tpu_torch.ops import spmv
    from photon_ml_tpu_torch.ops.glm_objective import GLMObjective
    from photon_ml_tpu_torch.ops.losses import loss_for_task
    from photon_ml_tpu_torch.ops.sharded_objective import ShardedGLMObjective
    from photon_ml_tpu_torch.optimization.glm_lbfgs import (
        minimize_lbfgs_glm_streaming,
    )
    from photon_ml_tpu_torch.types import TaskType

    n = train.num_rows
    batches = _Batches(train.subset(np.arange(a, min(a + STREAM_BATCH_ROWS,
                                                     n)))
                       for a in range(0, n, STREAM_BATCH_ROWS))
    obj = GLMObjective(loss_for_task(TaskType.LOGISTIC_REGRESSION))
    fe_cfg, _ = configs()
    results, launches, block = {}, 0, None
    budget = None
    for tag in ("resident", "quarter"):
        t0 = time.perf_counter()
        cache = DeviceShardCache.from_stream(
            batches, "global", dtype=torch.float32,
            hbm_budget_bytes=budget, prefetch_depth=2)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        sobj = ShardedGLMObjective(obj, cache)
        x0 = torch.zeros(cache.n_features, device=cache.device)
        # One untimed iteration first: the first calls load the kernels.
        minimize_lbfgs_glm_streaming(sobj, x0, fe_cfg.l2_weight, max_iter=1,
                                     tol=fe_cfg.tolerance)
        before = cache.stats()
        spmv.reset_launch_counts()
        t0 = time.perf_counter()
        res = minimize_lbfgs_glm_streaming(
            sobj, x0, fe_cfg.l2_weight, max_iter=fe_cfg.max_iterations,
            tol=fe_cfg.tolerance)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        launches += spmv.csr_matvec.launches
        st = cache.stats()
        for k in ("hits", "misses", "evictions", "epochs",
                  "bytes_reuploaded"):
            st[k] -= before[k]
        iters = int(res.iterations)
        passes = st["epochs"]
        line = (f"stream full width {tag}: {n} x {cache.n_features} in "
                f"{cache.n_shards} shards, {st['device_bytes']} device "
                f"bytes (budget {budget}), ingest {ingest_s:.2f} s, "
                f"{iters} L-BFGS iterations "
                f"({res.reason_enum().summary}) in {solve_s:.3f} s, "
                f"{1e3 * solve_s / max(1, iters):.2f} ms per iteration, "
                f"{passes} feature passes per solve (each shard's index "
                f"set used {passes} times), hits {st['hits']}, misses "
                f"{st['misses']}, evictions {st['evictions']}, re-uploaded "
                f"{st['bytes_reuploaded'] / max(1, passes):.0f} bytes a "
                f"pass, peak {st['peak_device_bytes']}")
        if budget is not None:
            before = cache.stats()["bytes_reuploaded"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in cache.blocks():
                pass
            torch.cuda.synchronize()
            epoch_s = time.perf_counter() - t0
            moved = cache.stats()["bytes_reuploaded"] - before
            host = torch.empty(max(1, moved), dtype=torch.uint8) \
                .pin_memory()
            dev = torch.empty_like(host, device="cuda")
            pinned_ms = cuda_ms(lambda: dev.copy_(host, non_blocking=True),
                                3)
            line += (f"; one replay epoch re-uploads {moved} bytes in "
                     f"{1e3 * epoch_s:.1f} ms "
                     f"({moved / epoch_s / 1e9:.2f} GB/s) against a pinned "
                     f"copy_ of the same bytes {pinned_ms:.2f} ms "
                     f"({moved / pinned_ms / 1e6:.2f} GB/s)")
        else:
            block = cache.entries[0].feats
            budget = st["device_bytes"] // 4
        print(line, flush=True)
        check(bool(torch.isfinite(res.x).all()), f"stream {tag}: non-finite")
        results[tag] = res.x
    same = torch.equal(results["resident"], results["quarter"])
    print(f"stream full width: coefficients bit for bit equal across the "
          f"two budgets: {same}", flush=True)
    check(same, "stream full width: the budgets' coefficients differ")
    return launches, block


# ---------------------------------------------------------------------------
# Path 9 and the grid full-width phase: the second half of streamed
# training (the batched λ grid, parallel ingest, streamed MF) and row 10.
# ---------------------------------------------------------------------------

SPMM_SOURCE = "photon_ml_tpu_torch/csrc/csr_spmm.cu"
# The products it stands for (no TPU kernel: the vmapped gather and
# segment sum of the grid kit, and MF's projections and normal equations).
SPMM_REPLACES = "photon_ml_tpu/ops/sharded_objective.py:612"
PATH9_MF_BUDGET = "16K"  # below the factor tables' bytes: evictions
PATH9_INGEST_WORKERS = 4
# The JAX package's bound of a bf16 factor train against f32
# (tests/test_mf_alternating.py:193-197): max |d| <= 0.05 max |f32|.
MF_BF16_SHARE = 0.05
GRID_WIDTHS = (4, 8)


def _avro_records(out: Path) -> list:
    """Decoded records of every Avro file under a run's best model."""
    from photon_ml_tpu_torch.io.avro_codec import read_container

    files = sorted((out / "best").rglob("*.avro"))
    check(files, f"no model under {out}")
    return [list(read_container(f)) for f in files]


def _floats(obj) -> list:
    """Every float of decoded records, in order."""
    if isinstance(obj, float):
        return [obj]
    if isinstance(obj, dict):
        return [v for k in sorted(obj) for v in _floats(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [v for x in obj for v in _floats(x)]
    return []


def path9(root: Path, p8: dict, glm_phases: dict) -> int:
    """Path 9, on path 6's files: the training driver three ways.

    - Grid: path 8's --stream-train run (the fixed effect over
      ``global``, L-BFGS/L2, path 8's four λ) with --grid-batched on at
      path 8's quarter budget (f32 buffer spill). Checks: path 8's
      sequential run's bestConfigs; fewer feature passes and bytes
      re-uploaded than that run; row 10 launched.
    - Ingest: path 6's one-shot training flags with --ingest-workers
      PATH9_INGEST_WORKERS against 1. Checks: the decoded arrays
      (read_game_dataset, both counts) and the trained models are the
      same bytes.
    - MF: --stream-train of the itemFactors coordinate alone (config 5's
      MF, k = 4, 2,000 items, its 20-iteration refit of B) under
      LINEAR_REGRESSION, with no budget,
      PATH9_MF_BUDGET (evictions), that budget with bf16 spill and with
      redecode spill. The no-budget run takes --distmon. Checks:
      no-budget (with --distmon), f32 and redecode factors the same
      bits; bf16 within MF_BF16_SHARE; evictions; row 10 launched; the
      monitor observed one pass (40,000 rows, not one a feature pass),
      its itemId heavy hitters summed over the 40,000 rows, and the
      model's reference holds the label only.
      Row 10 is then held (hold_spmm) at the shapes MF gave it in the
      no-budget run: the first batch's entity x row CSR of ones with
      its [rows, k^2 + k] normal-equation panel, the batch's feature
      block with B^T, and its transpose with a [rows, k] panel.

    Returns row 10's launches in its runs (counted from 0 just before
    each run, read just after) and hold_mf_shapes' result (the largest
    error of the MF checks, the products' times and bounds)."""
    from photon_ml_tpu_torch.cli import game_training_driver
    from photon_ml_tpu_torch.data.avro_reader import read_game_dataset
    from photon_ml_tpu_torch.data.paldb import load_feature_index_maps
    from photon_ml_tpu_torch.ops import spmv

    log = _DriverLog()
    logging.getLogger("photon_ml_tpu_torch").addHandler(log)
    launches10 = 0

    def run(tag, argv):
        nonlocal launches10
        log.phases.clear()
        spmv.reset_launch_counts()
        t0 = time.perf_counter()
        summary = game_training_driver.run(
            [*argv, "--output-dir", str(root / f"p9-{tag}")])
        seconds = time.perf_counter() - t0
        mm, mv = spmv.csr_matmul.launches, spmv.csr_matvec.launches
        launches10 += mm
        info = summary.get("stream_train") or {}
        cache = info.get("cache") or {}
        print(f"path 9 {tag}: {seconds:.2f} s, phases "
              f"{ {k: round(v, 3) for k, v in log.phases.items()} }, best "
              f"{summary['bestConfigs']}, cache "
              f"{ {k: cache.get(k) for k in ('shards', 'hits', 'misses', 'evictions', 'epochs', 'bytes_reuploaded', 'redecodes', 'peak_device_bytes', 'spill_bytes_host')} }"
              f", row 10 launches {mm}, row 9 launches {mv}", flush=True)
        return summary, mm, dict(log.phases)

    # -- grid ---------------------------------------------------------------
    seq = p8["quarter-f32"]
    grid, mm, _ = run("grid", [
        "--train-input-dirs", str(root / "train"),
        "--validate-input-dirs", str(root / "validate"),
        "--feature-index-dir", str(root / "feature-index"),
        "--task-type", "LOGISTIC_REGRESSION",
        "--fixed-effect-data-configurations", "fixed:global",
        "--fixed-effect-optimization-configurations", PATH8_GRID,
        "--updating-sequence", "fixed", "--evaluators", "AUC,LOGISTIC_LOSS",
        "--stream-train", "--grid-batched", "on", "--feeder", "native",
        "--batch-rows", str(PATH8_BATCH_ROWS), "--hbm-budget", p8["quarter"]])
    g_info, s_info = grid["stream_train"], seq["stream_train"]
    g_cache, s_cache = g_info["cache"], s_info["cache"]
    print(f"path 9 grid against path 8's sequential quarter-f32 run: "
          f"feature passes {g_cache['epochs']} against {s_cache['epochs']}, "
          f"bytes re-uploaded {g_cache['bytes_reuploaded']} against "
          f"{s_cache['bytes_reuploaded']}", flush=True)
    check(g_info["grid_batched"] is True, "path 9: the grid did not batch")
    check(grid["bestConfigs"] == seq["bestConfigs"],
          f"path 9: grid best {grid['bestConfigs']} != sequential "
          f"{seq['bestConfigs']}")
    check(g_cache["epochs"] < s_cache["epochs"]
          and g_cache["bytes_reuploaded"] < s_cache["bytes_reuploaded"],
          "path 9: the grid did not cut feature passes and re-uploads")
    check(mm > 0, "path 9 grid: row 10 did not launch")

    # -- ingest ---------------------------------------------------------------
    maps = load_feature_index_maps(root / "feature-index")
    decoded = {}
    for workers in (1, PATH9_INGEST_WORKERS):
        t0 = time.perf_counter()
        ds, _ = read_game_dataset(root / "train", ["itemId", "userId"],
                                  feature_shard_maps=maps,
                                  ingest_workers=workers)
        decoded[workers] = (ds, time.perf_counter() - t0)
    a, b = decoded[1][0], decoded[PATH9_INGEST_WORKERS][0]
    same = (a.responses.tobytes() == b.responses.tobytes()
            and a.offsets.tobytes() == b.offsets.tobytes()
            and a.weights.tobytes() == b.weights.tobytes()
            and all(a.feature_shards[s].data.tobytes()
                    == b.feature_shards[s].data.tobytes()
                    and a.feature_shards[s].indices.astype(np.int64)
                    .tobytes() == b.feature_shards[s].indices
                    .astype(np.int64).tobytes()
                    and a.feature_shards[s].indptr.astype(np.int64)
                    .tobytes() == b.feature_shards[s].indptr
                    .astype(np.int64).tobytes()
                    for s in a.feature_shards)
            and all(np.array_equal(a.id_columns[t].codes,
                                   b.id_columns[t].codes)
                    and list(a.id_columns[t].vocabulary)
                    == list(b.id_columns[t].vocabulary)
                    for t in a.id_columns))
    print(f"path 9 ingest of the training files: 1 process "
          f"{decoded[1][1]:.3f} s, {PATH9_INGEST_WORKERS} workers "
          f"{decoded[PATH9_INGEST_WORKERS][1]:.3f} s, arrays byte-identical "
          f"{same}", flush=True)
    check(same, "path 9: the pool's arrays differ from one process's")
    phases = {}
    for workers in (1, PATH9_INGEST_WORKERS):
        _, _, phases[workers] = run(f"ingest-{workers}", [
            *path6_argv(root), "--ingest-workers", str(workers)])
    print(f"path 9 driver ingest seconds: --ingest-workers 1 "
          f"{phases[1].get('ingest', 0.0):.3f}, {PATH9_INGEST_WORKERS} "
          f"{phases[PATH9_INGEST_WORKERS].get('ingest', 0.0):.3f}; path 7's "
          f"GLM driver at auto: preprocess "
          f"{glm_phases.get('preprocess', float('nan')):.3f}", flush=True)
    check(_avro_records(root / "p9-ingest-1")
          == _avro_records(root / f"p9-ingest-{PATH9_INGEST_WORKERS}"),
          "path 9: the models differ across --ingest-workers")

    # -- streamed MF ------------------------------------------------------
    mf = ["--train-input-dirs", str(root / "train"),
          "--validate-input-dirs", str(root / "validate"),
          "--feature-index-dir", str(root / "feature-index"),
          "--task-type", "LINEAR_REGRESSION",
          "--factored-random-effect-data-configurations", PATH6_MF_DATA,
          "--factored-random-effect-optimization-configurations",
          PATH6_MF_OPT, "--updating-sequence", "itemFactors",
          "--evaluators", "RMSE", "--stream-train", "--batch-rows",
          str(PATH8_BATCH_ROWS)]
    budget = ["--hbm-budget", PATH9_MF_BUDGET]
    mf_runs = {}
    for tag, extra in (("mf-none", ["--distmon"]), ("mf-f32", budget),
                       ("mf-bf16", [*budget, "--spill-dtype", "bf16"]),
                       ("mf-redecode", [*budget, "--spill-source",
                                        "redecode"])):
        kept = {}
        with mf_operands(kept):
            mf_runs[tag], mm, _ = run(tag, [*mf, *extra])
        if tag == "mf-none":
            mf_held = hold_mf_shapes(kept)
            mf_distmon_checks(root, mf_runs[tag])
        check(mm > 0, f"path 9 {tag}: row 10 did not launch")
        rmse = mf_runs[tag]["validationHistory"][0]["RMSE"]
        check(math.isfinite(rmse), f"path 9 {tag}: RMSE {rmse}")
    for tag in ("mf-f32", "mf-bf16", "mf-redecode"):
        check(mf_runs[tag]["stream_train"]["cache"]["evictions"] > 0,
              f"path 9 {tag}: no eviction")
    recs = {tag: _avro_records(root / f"p9-{tag}") for tag in mf_runs}
    check(recs["mf-none"] == recs["mf-f32"] == recs["mf-redecode"],
          "path 9: the MF factors differ across residency")
    ref = np.asarray(_floats(recs["mf-f32"]))
    got = np.asarray(_floats(recs["mf-bf16"]))
    share = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
    print(f"path 9 MF: {ref.size} model values; bf16 against f32 max |d| "
          f"{share:.3g} of max |f32| (bound {MF_BF16_SHARE}); plan "
          f"{mf_runs['mf-none']['stream_train']['plan']}", flush=True)
    check(ref.shape == got.shape and share <= MF_BF16_SHARE,
          "path 9: bf16 factors outside their bound")
    logging.getLogger("photon_ml_tpu_torch").removeHandler(log)
    return launches10, mf_held


def mf_distmon_checks(root: Path, summary: dict) -> None:
    """Path 9's --distmon MF checks (``path9``'s docstring)."""
    dq = summary["data_quality"]
    ref = json.loads((root / "p9-mf-none" / "best"
                      / "model-metadata.json").read_text())[
        "referenceDistributions"]
    ent = dq["entities"]
    print(f"path 9 mf-none distmon: rows {dq['rows']}, batches "
          f"{dq['batches']}, label rows "
          f"{dq['columns']['label']['moments']['count']}, heavy hitters "
          f"{ {k: (v['total'], len(v['top'])) for k, v in ent.items()} }, "
          f"reference keys {sorted(ref)}", flush=True)
    check(dq["rows"] == dq["columns"]["label"]["moments"]["count"]
          == PATH6_TRAIN, f"path 9 MF distmon rows {dq['rows']}")
    check(set(ent) == {"itemId"} and ent["itemId"]["total"] == PATH6_TRAIN,
          f"path 9 MF distmon entities {ent}")
    check("score" not in ref and ref["rows"] == PATH6_TRAIN,
          f"path 9 MF reference {sorted(ref)}")


@contextlib.contextmanager
def mf_operands(kept: dict):
    """Keeps, in ``kept``, the operands of the first call at streamed
    MF's two row-10 sites: the normal equations' segment sum
    (``normals``: crow, col, val, panel, n_cols) and V = X B^T
    (``features``: block, B). Each wrapper calls straight through, so
    the run and its launch counts are unchanged."""
    from photon_ml_tpu_torch.ops import mf_alternating as mfa

    seg, v_of = mfa.csr_matmul, mfa.StreamedMFObjective._v_of

    def seg_kept(crow, col, val, x, n_cols):
        kept.setdefault("normals", (crow, col, val, x, n_cols))
        return seg(crow, col, val, x, n_cols)

    def v_of_kept(block, B):
        kept.setdefault("features", (block, B))
        return v_of(block, B)

    mfa.csr_matmul = seg_kept
    mfa.StreamedMFObjective._v_of = staticmethod(v_of_kept)
    try:
        yield kept
    finally:
        mfa.csr_matmul = seg
        mfa.StreamedMFObjective._v_of = staticmethod(v_of)


def spmm_bound(rows: int, n_cols: int, nnz: int, n: int,
               itemsize: int) -> tuple:
    """The least ms of Y = A X on the H100 and what bounds it: the CSR
    read once (values, column indices, offsets), the panel read once, Y
    written once, against 2 n nnz operations at the float32 rate."""
    nbytes = (nnz * (itemsize + 4) + 4 * (rows + 1)
              + itemsize * n * (n_cols + rows))
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * 2 * n * nnz / FP32_FLOPS_PER_S
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def hold_mf_shapes(kept: dict) -> tuple:
    """Row 10 at streamed MF's shapes (mf_operands), each product held
    by hold_spmm within SPMV_RTOL of sum |a x| and column by column
    against row 9, and timed: call and device ms against its bound.
    Returns the largest abs error and one dict per product."""
    import torch

    from photon_ml_tpu_torch.ops import spmv

    check("normals" in kept and "features" in kept,
          "path 9: streamed MF did not reach row 10's call sites")
    block, B = kept["features"]
    g = torch.Generator(device="cuda").manual_seed(9)
    u = torch.randn((block.n_rows, B.shape[0]), generator=g, device="cuda",
                    dtype=B.dtype)
    crow, col, val, panel, n_cols = kept["normals"]
    errs, shapes = [], []
    for name, what, args in (
            ("normal equations",
             f"{crow.shape[0] - 1} entities x {n_cols} rows with a "
             f"[{n_cols}, {panel.shape[1]}] panel",
             (crow, col, val, panel, n_cols)),
            ("V = X B^T",
             f"X {block.n_rows} x {block.n_features} ({block.nnz} "
             f"entries), n = {B.shape[0]}",
             (block.crow, block.col, block.values, B.T.contiguous(),
              block.n_features)),
            ("X^T (u g)", f"n = {B.shape[0]}",
             (block.crow_t, block.row_t, block.values_t, u, block.n_rows))):
        _, err, share, columns = hold_spmm(*args)
        errs.append(err)
        a_crow, a_col, a_val, x, nc = args
        ms = cuda_ms(lambda: spmv.csr_matmul(*args), 20)
        dev_ms = device_ms(lambda: spmv.csr_matmul(*args))
        bound, by = spmm_bound(a_crow.shape[0] - 1, nc, a_col.shape[0],
                               x.shape[1], a_val.element_size())
        shapes.append(dict(product=name, rows=a_crow.shape[0] - 1,
                           n_cols=nc, nnz=a_col.shape[0], n=x.shape[1],
                           ms=ms, device_ms=dev_ms, bound_ms=bound,
                           bound_by=by))
        print(f"path 9 MF row 10 at {name}, {what}: max abs err {err:.3g}, "
              f"worst share of {SPMV_RTOL} x sum|a x| "
              f"{share / SPMV_RTOL:.3g}; columns bit for bit = row 9: "
              f"{columns}; call {ms:.4f} ms ({dev_ms:.4f} on the device), "
              f"bound {bound:.4f} ({by}; device time {dev_ms / bound:.2f}x "
              f"the bound)", flush=True)
        check(columns, f"path 9 MF {name}: a column differs from row 9")
        check(share <= SPMV_RTOL, f"path 9 MF {name}: kernel vs plain "
              f"{share}")
    return max(errs), shapes


def grid_full_width(train) -> tuple:
    """The grid full-width phase: bench.py's training fixed shard
    (160,000 x 200, nothing cut) from memory in STREAM_BATCH_ROWS-row
    batches, batched L-BFGS/L2 (path 1's fixed-effect configuration) at
    G in GRID_WIDTHS against the sequential sweep of the same λ, with
    no budget and at about 25% of the shard's device bytes. Prints ms
    per iteration, feature passes per sweep and bytes re-uploaded.
    Checks: each sweep selects the same λ both ways. Reports whether a
    G > 1 lane's value and gradient are the scalar path's bits. Returns
    row 10's launches and a cached block."""
    import torch

    from photon_ml_tpu_torch.data.shard_cache import DeviceShardCache
    from photon_ml_tpu_torch.ops import spmv
    from photon_ml_tpu_torch.ops.glm_objective import GLMObjective
    from photon_ml_tpu_torch.ops.losses import loss_for_task
    from photon_ml_tpu_torch.ops.sharded_objective import ShardedGLMObjective
    from photon_ml_tpu_torch.optimization.glm_lbfgs import (
        minimize_lbfgs_glm_grid_streaming,
        minimize_lbfgs_glm_streaming,
    )
    from photon_ml_tpu_torch.types import TaskType

    n = train.num_rows
    batches = _Batches(train.subset(np.arange(a, min(a + STREAM_BATCH_ROWS,
                                                     n)))
                       for a in range(0, n, STREAM_BATCH_ROWS))
    obj = GLMObjective(loss_for_task(TaskType.LOGISTIC_REGRESSION))
    fe_cfg, _ = configs()
    launches, block, budget = 0, None, None
    for tag in ("resident", "quarter"):
        cache = DeviceShardCache.from_stream(
            batches, "global", dtype=torch.float32, hbm_budget_bytes=budget,
            prefetch_depth=2)
        sobj = ShardedGLMObjective(obj, cache)
        d = cache.n_features
        if block is None:
            block = cache.entries[0].feats
            budget = cache.stats()["device_bytes"] // 4
        for G in GRID_WIDTHS:
            l2s = [float(v) for v in np.geomspace(0.1, 100.0, G)]
            x0s = torch.zeros((G, d), device=cache.device)
            # One untimed iteration of each first: the first calls load.
            minimize_lbfgs_glm_grid_streaming(sobj, x0s, l2s, max_iter=1)
            out = {}
            for mode in ("grid", "sequential"):
                before = cache.stats()
                spmv.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if mode == "grid":
                    res = minimize_lbfgs_glm_grid_streaming(
                        sobj, x0s, l2s, max_iter=fe_cfg.max_iterations,
                        tol=fe_cfg.tolerance)
                else:
                    res = [minimize_lbfgs_glm_streaming(
                        sobj, x0s[0], l2, max_iter=fe_cfg.max_iterations,
                        tol=fe_cfg.tolerance) for l2 in l2s]
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                if mode == "grid":
                    launches += spmv.csr_matmul.launches
                st = cache.stats()
                iters = [int(r.iterations) for r in res]
                out[mode] = dict(
                    secs=secs, iters=iters,
                    passes=st["epochs"] - before["epochs"],
                    moved=st["bytes_reuploaded"] - before["bytes_reuploaded"],
                    best=int(np.argmin([float(r.value) for r in res])))
                check(all(bool(torch.isfinite(r.x).all()) for r in res),
                      f"grid full width {tag} G={G} {mode}: non-finite")
            gr, sq = out["grid"], out["sequential"]
            print(f"grid full width {tag} G={G} (λ {l2s}, budget {budget if tag == 'quarter' else None}): "
                  f"batched {gr['secs']:.3f} s, {gr['passes']} feature passes, "
                  f"{1e3 * gr['secs'] / max(1, max(gr['iters'])):.2f} ms per "
                  f"outer iteration, iterations {gr['iters']}, re-uploaded "
                  f"{gr['moved']} bytes; sequential {sq['secs']:.3f} s, "
                  f"{sq['passes']} passes, "
                  f"{1e3 * sq['secs'] / max(1, sum(sq['iters'])):.2f} ms per "
                  f"iteration, iterations {sq['iters']}, re-uploaded "
                  f"{sq['moved']} bytes; row 10 launches {launches}",
                  flush=True)
            check(gr["best"] == sq["best"],
                  f"grid full width {tag} G={G}: selection differs")
        if tag == "resident":
            # Is a G > 1 lane the scalar path's bits? (A finding.)
            G = GRID_WIDTHS[0]
            g = torch.Generator(device="cuda").manual_seed(5)
            xs = 0.01 * torch.randn((G, d), generator=g, device="cuda")
            l2s = torch.full((G,), 1.0, device="cuda")
            _, fg, gg = sobj.grid_margins_value_grad(xs, l2s)
            lanes = []
            for i in range(G):
                _, f1, g1 = sobj.margins_value_grad(xs[i].contiguous(), 1.0)
                lanes.append((bool(torch.equal(fg[i], f1)),
                              bool(torch.equal(gg[i], g1))))
            print(f"grid full width: G={G} lanes against the scalar "
                  f"path, (value, gradient) bit for bit: {lanes}",
                  flush=True)
    return launches, block


def hold_spmm(crow, col, val, x, n_cols: int) -> tuple:
    """Row 10 on (A, X) held against its plain version (torch.sparse.mm
    on the same CSR) and, column by column, against row 9. Returns the
    product, the max abs error, the worst error as a share of sum |a x|,
    and whether every column is the bits of csr_matvec on that column."""
    import torch

    from photon_ml_tpu_torch.ops import spmv

    k = spmv.csr_matmul(crow, col, val, x, n_cols)
    diff = (k - spmv.csr_matmul_plain(crow, col, val, x, n_cols)).abs()
    scale = spmv.csr_matmul_plain(crow, col, val.abs(), x.abs(), n_cols)
    err = float(diff.max()) if diff.numel() else 0.0
    share = (float((diff / scale.clamp_min(1e-30)).max()) if diff.numel()
             else 0.0)
    columns = all(torch.equal(k[:, j], spmv.csr_matvec(
        crow, col, val, x[:, j].contiguous(), n_cols))
        for j in range(x.shape[1]))
    return k, err, share, columns


def spmm_entry(block, launches: int, mf_held: tuple) -> dict:
    """Kernel row 10 on one cached block of the full-width phase: X V
    and X^T U for panels of n in (4, 8) columns held against the plain
    version within SPMV_RTOL of sum |a x|, every column bit for bit
    against row 9 on that column, 20 calls bit for bit; call and device
    ms against n calls of row 9, torch.sparse.mm (cuSPARSE SpMM) and the
    bound. ``mf_held`` is hold_mf_shapes' result at streamed MF's
    shapes: its largest error is folded into the row's max_abs_err, and
    its times and bounds are printed and kept under ``mf_shapes``."""
    import torch

    from photon_ml_tpu_torch.ops import spmv

    nnz, rows, d = block.nnz, block.n_rows, block.n_features
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for n in (4, 8):
        v = torch.randn((d, n), generator=g, device="cuda")
        u = torch.randn((rows, n), generator=g, device="cuda")
        k_mv, err_mv, share_mv, col_mv = hold_spmm(
            block.crow, block.col, block.values, v, d)
        k_rmv, err_rmv, share_rmv, col_rmv = hold_spmm(
            block.crow_t, block.row_t, block.values_t, u, rows)
        err, share = max(err_mv, err_rmv), max(share_mv, share_rmv)
        columns = col_mv and col_rmv
        repeat = all(torch.equal(block.matmat(v), k_mv)
                     and torch.equal(block.rmatmat(u), k_rmv)
                     for _ in range(20))
        vs = [v[:, j].contiguous() for j in range(n)]
        us = [u[:, j].contiguous() for j in range(n)]

        def pair():
            block.matmat(v)
            block.rmatmat(u)

        def row9():
            for j in range(n):
                block.matvec(vs[j])
                block.rmatvec(us[j])

        def plain_pair():
            spmv.csr_matmul_plain(block.crow, block.col, block.values, v, d)
            spmv.csr_matmul_plain(block.crow_t, block.row_t, block.values_t,
                                  u, rows)

        a_csr = torch.sparse_csr_tensor(block.crow, block.col, block.values,
                                        size=(rows, d))
        a_csr_t = torch.sparse_csr_tensor(block.crow_t, block.row_t,
                                          block.values_t, size=(d, rows))
        ms, dev_ms = cuda_ms(pair, 20), device_ms(pair)
        r9_ms, r9_dev = cuda_ms(row9, 20), device_ms(row9)
        plain = cuda_ms(plain_pair, 20)
        library = cuda_ms(lambda: (torch.sparse.mm(a_csr, v),
                                   torch.sparse.mm(a_csr_t, u)), 20)
        # Each product reads its CSR once (values, indices, offsets) and
        # its panel once, and writes its output once: the panel's rows
        # are gathered many times but stay in L2, as row 9's vector does.
        bytes_pair = (2 * 8 * nnz + 4 * (rows + 1) + 4 * (d + 1)
                      + 4 * n * 2 * (rows + d))
        bound_bytes = 1e3 * bytes_pair / HBM_BYTES_PER_S
        bound_ops = 1e3 * 4 * n * nnz / FP32_FLOPS_PER_S
        out[n] = dict(err=err, ms=ms, dev_ms=dev_ms, plain=plain,
                      library=library, bound_bytes=bound_bytes,
                      bound_ops=bound_ops)
        bound = max(bound_bytes, bound_ops)
        print(f"spmm block {rows} x {d} ({nnz} entries), n = {n}: kernel "
              f"X V + X^T U {ms:.4f} ms a pair ({dev_ms:.4f} on the device), "
              f"{n} row-9 pairs {r9_ms:.4f} ({r9_dev:.4f}), plain "
              f"(torch.sparse.mm) {plain:.4f}, library (cuSPARSE SpMM) "
              f"{library:.4f}, bound {bound:.4f} "
              f"({'bytes' if bound_bytes >= bound_ops else 'operations'}; "
              f"device time {dev_ms / bound:.2f}x the bound); max abs err "
              f"{err:.3g}, worst share of {SPMV_RTOL} x sum|a x| "
              f"{share / SPMV_RTOL:.3g}; columns bit for bit = row 9: "
              f"{columns}; 20 calls bit for bit: {repeat}", flush=True)
        check(columns, f"spmm n={n}: a column differs from row 9")
        check(repeat, f"spmm n={n}: the kernel is not deterministic")
        check(share <= SPMV_RTOL, f"spmm n={n}: kernel vs plain {share}")
    for sh in mf_held[1]:
        print(f"spmm MF shape {sh['product']} ({sh['rows']} x "
              f"{sh['n_cols']}, {sh['nnz']} entries, n = {sh['n']}): call "
              f"{sh['ms']:.4f} ms, device {sh['device_ms']:.4f}, bound "
              f"{sh['bound_ms']:.4f} ({sh['bound_by']}; bound / device "
              f"{sh['bound_ms'] / sh['device_ms']:.1%})", flush=True)
    m = out[8]
    return {
        "name": "csr_spmm (deterministic CSR x panel, row 10)",
        "route": "cuda", "source": SPMM_SOURCE, "replaces": SPMM_REPLACES,
        "launches": launches,
        "max_abs_err": max(mf_held[0], *(o["err"] for o in out.values())),
        "ms": m["ms"], "device_ms": m["dev_ms"], "plain_ms": m["plain"],
        "bound_ms": max(m["bound_bytes"], m["bound_ops"]),
        "bound_by": ("bytes" if m["bound_bytes"] >= m["bound_ops"]
                     else "operations"),
        "library_ms": m["library"], "mf_shapes": mf_held[1],
    }


PATH10_RUNS = (
    ("stream", ["--stream", "--batch-rows", "4096"]),
    ("serve 1", ["--serve", "--request-rows", "1", "--serve-concurrency",
                 "16", "--coalesce-ms", "2"]),
    ("serve 8", ["--serve", "--request-rows", "8"]),
)
#: The path-10 run that takes --trace-out.
TELEMETRY_RUN = "serve 1"
UNIT_ROUNDOFF_F32 = 2.0 ** -24


def _scores_by_uid(path: Path) -> dict:
    from photon_ml_tpu_torch.io.avro_codec import read_container

    return {r["uid"]: r["predictionScore"]
            for r in read_container(path / "scores" / "part-00000.avro")}


def score_bounds(root: Path) -> dict:
    """uid -> (n, S): the number of products in a hold-out row's margin
    (every sub-model's features of the row) and the sum of their
    absolute values, in float64, from the saved model and the decoded
    hold-out files. Two float32 sums of the same n products in two
    orders differ by at most 2 gamma_n S (gamma_n = n u / (1 - n u), u =
    2^-24; Higham, Accuracy and Stability, 3.1), the tolerance path 10
    holds each served score to against the batch path's."""
    from photon_ml_tpu_torch.data.avro_reader import read_game_dataset
    from photon_ml_tpu_torch.data.paldb import load_feature_index_maps
    from photon_ml_tpu_torch.io.model_io import load_game_model
    from photon_ml_tpu_torch.models.fixed_effect import FixedEffectModel
    from photon_ml_tpu_torch.utils.vocab import vocab_code_lookup

    model_dir = root / "model" / "best"
    maps = load_feature_index_maps(model_dir / "feature-indexes")
    model = load_game_model(model_dir, maps)
    id_types = sorted({m.random_effect_type for m in model.models.values()
                       if hasattr(m, "random_effect_type")})
    data, _ = read_game_dataset(root / "validate", id_types, maps)
    n = np.zeros(data.num_rows)
    total = np.zeros(data.num_rows)
    for m in model.models.values():
        x = abs(data.feature_shards[m.feature_shard_id].tocsr())
        n += np.diff(x.indptr)
        if isinstance(m, FixedEffectModel):
            w = np.abs(m.glm.coefficients.means.cpu().double().numpy())
            total += x @ w
            continue
        col = data.id_columns[m.random_effect_type]
        rows = vocab_code_lookup(m.vocabulary, col.vocabulary)[col.codes]
        dense = np.vstack([abs(m.matrix).toarray(),
                           np.zeros(m.matrix.shape[1])])
        total += np.asarray(x.multiply(dense[rows]).sum(axis=1)).ravel()
    return {str(u): (k, t) for u, k, t in zip(data.uids, n, total)}


def path10(root: Path) -> int:
    """Path 10: in-process serving of path 6's saved model (config 5 at
    full width: 200 fixed features, 5,000 users x 25, 2,000 items x 16,
    the factored itemFactors effect at k = 4, each loaded as the
    reference's model files) on its 10,000 hold-out rows, through the
    scoring driver three times (PATH10_RUNS): --stream with 4,096-row
    batches, --serve with one-row requests from 16 requesters in 2 ms
    coalesce windows, and --serve with 8-row requests. The only cut is
    path 6's, rows. Checks: each run's scores against path 6's batch
    scores within 2 gamma_n S a row (``score_bounds``); its AUC within
    1e-6 of the batch run's; the front-end admitted == completed and
    rejected == failed == cancelled == 0; graphs captured == the
    distinct bucket shapes the run dispatched, each captured once; every
    bucket's graph replay bit for bit its eager scoring function on the
    same inputs; the three runs' scores bit for bit the same for every
    row, whatever was coalesced with it; the executable profiler counted
    every dispatch of the engine; the front-end's registry counter
    ``serving.frontend.completed`` equals its admitted and completed
    requests; the one-row run's ``--trace-out`` (TELEMETRY_RUN) passes
    ``telemetry_checks``. Prints rows a second, dispatches, padding
    waste, graphs, per bucket the ms of a dispatch replayed against the
    eager function, the profiler's table (per rows bucket: dispatches,
    mean and max dispatch-to-settle ms, est. FLOP/s) and the served
    request latency and queue wait P50/P95/P99. Then
    ``telemetry_cost``. Returns the row-9 launches the runs executed
    (wrapper calls, less those recorded at capture, plus graph replays
    times the launches captured per graph), the launches one bucket graph
    of this model captures (path 12 counts its replicas' launches with
    it) and the served runs' figures (rows a second; request latency
    P50 and P99 ms), for path 12 to print beside its own."""
    import json as _json

    import torch

    from photon_ml_tpu_torch.cli import game_scoring_driver
    from photon_ml_tpu_torch.ops import spmv
    from photon_ml_tpu_torch.serving import engine as serving_engine
    from photon_ml_tpu_torch.serving import frontend as serving_frontend

    t_path = time.perf_counter()
    card = card_line()
    batch = _scores_by_uid(root / "scores")
    batch_auc = _json.loads((root / "scores" / "metrics.json")
                            .read_text())["metrics"]["AUC"]
    bounds = score_bounds(root)
    base = ["--input-dirs", str(root / "validate"),
            "--game-model-input-dir", str(root / "model" / "best"),
            "--evaluators", "AUC"]

    class Kept(serving_engine.StreamingGameScorer):
        """The driver's engines, each with the bucket shapes it
        dispatched."""

        made = []

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.shapes_used = set()
            Kept.made.append(self)

        def _dispatch(self, key, payload):
            self.shapes_used.add(key)
            return super()._dispatch(key, payload)

    log = _DriverLog()
    logging.getLogger("photon_ml_tpu_torch").addHandler(log)
    originals = (serving_engine.StreamingGameScorer,
                 serving_frontend.StreamingGameScorer)
    serving_engine.StreamingGameScorer = Kept
    serving_frontend.StreamingGameScorer = Kept
    launches = 0
    served = {}
    per_graph = set()
    figures = {}
    try:
        for tag, flags in PATH10_RUNS:
            Kept.made.clear()
            log.phases.clear()
            out = root / f"p10-{tag.replace(' ', '-')}"
            trace = out.with_name(out.name + "-trace.json")
            if tag == TELEMETRY_RUN:
                flags = [*flags, "--trace-out", str(trace)]
            # ---- the main path: counts set to 0 just before, read after --
            spmv.reset_launch_counts()
            t0 = time.perf_counter()
            summary = game_scoring_driver.run(
                [*base, *flags, "--output-dir", str(out)])
            seconds = time.perf_counter() - t0
            run_launches = spmv.csr_matvec.launches
            # ----------------------------------------------------------------
            launches += run_launches
            (eng,) = Kept.made
            replayed = sum(ex.replays * ex.launches_per_replay
                           for ex in eng.buckets().values())
            st = eng.stats()
            scores = _scores_by_uid(out)
            served[tag] = scores
            check(set(scores) == set(batch) and len(scores) == PATH6_VAL,
                  f"path 10 {tag}: rows {len(scores)}")
            ratio, worst = 0.0, 0.0
            for uid, s in scores.items():
                k, total = bounds[uid]
                gamma = k * UNIT_ROUNDOFF_F32 / (1 - k * UNIT_ROUNDOFF_F32)
                diff = abs(s - batch[uid])
                worst = max(worst, diff)
                ratio = max(ratio, diff / max(2 * gamma * total, 1e-300))
            auc = summary["metrics"]["AUC"]
            rows_s = summary["num_rows"] / log.phases["score"]
            figures[tag] = {"rows_s": rows_s}
            print(f"path 10 {tag}: {summary['num_rows']} rows in "
                  f"{seconds:.2f} s (score phase {log.phases['score']:.3f} s,"
                  f" {rows_s:.0f} rows a second; phases "
                  f"{ {k: round(v, 3) for k, v in log.phases.items()} }), "
                  f"dispatches {st['dispatches']}, padding waste rows "
                  f"{st['padding_waste_rows']:.4f} nnz "
                  f"{st['padding_waste_nnz']:.4f}, graphs built "
                  f"{st['compilations']} for shapes "
                  f"{sorted(eng.shapes_used)}; row-9 launches {run_launches}"
                  f" ({replayed} in graph replays); scores vs path 6's "
                  f"batch: max |diff| {worst:.3g}, worst share of 2 gamma_n"
                  f" S {ratio:.3g}; AUC {auc:.6f} (batch {batch_auc:.6f}); "
                  f"card {card}", flush=True)
            check(ratio <= 1.0, f"path 10 {tag}: scores off the batch "
                  f"path's by {ratio} of 2 gamma_n S")
            check(abs(auc - batch_auc) <= 1e-6,
                  f"path 10 {tag}: AUC {auc} != batch {batch_auc}")
            profiler = (summary["frontend"]["cache"]["profiler"]
                        if "frontend" in summary else st["profiler"])
            table = {rb: {"dispatches": r["dispatches"],
                          "mean_ms": round(1e3 * r["mean_s"], 4),
                          "max_ms": round(1e3 * r["max_s"], 4),
                          "est_flops_per_sec": r.get("est_flops_per_sec")}
                     for rb, r in profiler["dispatch"].items()}
            builds = {k: (round(b["lower_s"], 4), round(b["first_call_s"], 4))
                      for k, b in profiler["builds"].items()}
            print(f"path 10 {tag} profiler: dispatch-to-settle by rows "
                  f"bucket {table}; builds (lower_s, first_call_s) "
                  f"{builds}; card {card}", flush=True)
            check(sum(r["dispatches"] for r in table.values())
                  == st["dispatches"], f"path 10 {tag}: the profiler "
                  f"counted {table}, the engine {st['dispatches']}")
            if "frontend" in summary:
                fe = summary["frontend"]
                completed = summary["telemetry"]["metrics"]["counters"].get(
                    "serving.frontend.completed")
                pct = {k: {q: (None if fe[k][q] is None
                               else round(1e3 * fe[k][q], 4))
                           for q in ("p50", "p95", "p99")}
                       for k in ("request_latency_seconds",
                                 "queue_wait_seconds")}
                print(f"path 10 {tag} frontend: requests "
                      f"{summary['num_requests']}, admitted {fe['admitted']},"
                      f" completed {fe['completed']} (registry "
                      f"{completed}), rejected {fe['rejected']}, failed "
                      f"{fe['failed']}, cancelled {fe['cancelled']}, "
                      f"coalesced groups {fe['coalesced_groups']}; ms "
                      f"{pct}; card {card}", flush=True)
                figures[tag].update(
                    p50_ms=pct["request_latency_seconds"]["p50"],
                    p99_ms=pct["request_latency_seconds"]["p99"])
                check(fe["admitted"] == fe["completed"] == completed
                      == summary["num_requests"]
                      and fe["rejected"] == fe["failed"] == fe["cancelled"]
                      == 0, f"path 10 {tag}: frontend {fe}")
            if tag == TELEMETRY_RUN:
                telemetry_checks(f"path 10 {tag}", summary, trace,
                                 {"driver", "score", "coalesce",
                                  "dispatch", "scatter"})
            buckets = eng.buckets()
            per_graph |= {ex.launches_per_replay for ex in buckets.values()}
            check(set(buckets) == eng.shapes_used
                  and st["compilations"] == len(eng.shapes_used),
                  f"path 10 {tag}: graphs {sorted(buckets)} for shapes "
                  f"{sorted(eng.shapes_used)}")
            eng.cache.assert_max_retraces(max_total=len(buckets), per_fn=1)
            for shape, ex in sorted(buckets.items()):
                host, ev = ex.run()
                ev.synchronize()
                check(ex.graph is not None and ex.traces == 1
                      and torch.equal(host, ex.eager().cpu()),
                      f"path 10 {tag}: bucket {shape} replay != eager")
                pinned = torch.empty(ex.rows_b, pin_memory=True)

                def eager_dispatch():
                    pinned.copy_(ex.eager(), non_blocking=True)

                graph_ms = cuda_ms(ex.run, 20)
                eager_ms = cuda_ms(eager_dispatch, 20)
                print(f"path 10 {tag} bucket {shape}: replays "
                      f"{ex.replays}, launches a replay "
                      f"{ex.launches_per_replay}, a dispatch {graph_ms:.4f} "
                      f"ms replayed against {eager_ms:.4f} ms eager; card "
                      f"{card}", flush=True)
    finally:
        serving_engine.StreamingGameScorer = originals[0]
        serving_frontend.StreamingGameScorer = originals[1]
        logging.getLogger("photon_ml_tpu_torch").removeHandler(log)
    first = served[PATH10_RUNS[0][0]]
    same = {tag: all(s[u] == first[u] for u in first)
            for tag, s in served.items()}
    print(f"path 10 scores bit for bit the same as --stream's: {same}; "
          f"path {time.perf_counter() - t_path:.1f} s; card {card}",
          flush=True)
    check(all(same.values()), f"path 10: served scores differ: {same}")
    check(len(per_graph) == 1 and min(per_graph) > 0,
          f"path 10: row-9 launches a graph {per_graph}")
    telemetry_cost(root, card)
    return launches, per_graph.pop(), figures


def telemetry_cost(root: Path, card: str) -> None:
    """Path 10's one-row serving outside the driver (which always runs
    with telemetry on): the same 10,000 one-row requests replayed through
    a front-end of the loaded model by 16 requesters in 2 ms windows with
    telemetry off and on, in turns (off, on, on, off), each replay timed
    on the host clock (its futures settle after the events behind their
    copies); every replay's scores must be the same bytes."""
    import torch

    from photon_ml_tpu_torch import telemetry
    from photon_ml_tpu_torch.data.avro_reader import (
        iter_game_dataset_batches,
    )
    from photon_ml_tpu_torch.data.paldb import load_feature_index_maps
    from photon_ml_tpu_torch.io.model_io import load_game_model
    from photon_ml_tpu_torch.serving import FrontendConfig, ServingFrontend

    model_dir = root / "model" / "best"
    maps = load_feature_index_maps(model_dir / "feature-indexes")
    model = load_game_model(model_dir, maps)
    meta = json.loads((model_dir / "model-metadata.json").read_text())
    id_types = sorted({c["randomEffectType"] for c in meta["coordinates"]
                       if c["kind"] == "random"}
                      | {c[k] for c in meta["coordinates"] if c["kind"] == "mf"
                         for k in ("rowEffectType", "colEffectType")})
    requests = [ds.subset(np.arange(a, a + 1))
                for ds in iter_game_dataset_batches(
                    root / "validate", id_types=id_types,
                    feature_shard_maps=maps, batch_rows=4096)
                for a in range(ds.num_rows)]
    rates, outs = [], []
    for on in (False, True, True, False):
        telemetry.reset()
        if on:
            telemetry.enable()
        fe = ServingFrontend({"default": model}, dtype=torch.float32,
                             config=FrontendConfig(coalesce_window_s=0.002,
                                                   max_pending=1024))
        try:
            t0 = time.perf_counter()
            results, info = fe.replay(requests, concurrency=16)
            seconds = time.perf_counter() - t0
        finally:
            telemetry.disable()
        check(info["shed"] == info["errors"] == 0, f"telemetry cost: {info}")
        rates.append((on, len(requests) / seconds))
        outs.append(b"".join(r.tobytes() for r in results))
        del fe
    same = all(o == outs[0] for o in outs)
    on_r = [r for o, r in rates if o]
    off_r = [r for o, r in rates if not o]
    print(f"path 10 telemetry cost: one-row replays, rows a second in turns "
          f"{[(('on' if o else 'off'), round(r, 1)) for o, r in rates]}; "
          f"mean on {np.mean(on_r):.1f} against off {np.mean(off_r):.1f} "
          f"({np.mean(on_r) / np.mean(off_r) - 1:+.3%}); scores the same "
          f"bytes off and on: {same}; card {card}", flush=True)
    check(same, "telemetry cost: scores differ with telemetry on and off")


# ---------------------------------------------------------------------------
# Path 11: drift serving at full width (the observability plane, --distmon,
# --obs-port and --slo).
# ---------------------------------------------------------------------------

#: JAX's test_serve_drift_acceptance shift: the global shard's values x4.
PATH11_SCALE = 4.0
PATH11_SLOS = ("drift=value:serving.model.default.score_drift_psi<=0.25",
               "p99:serving.frontend.request_latency_seconds<=50ms")
PATH11_SERVE = ["--serve", "--distmon", "--request-rows", "8",
                "--serve-concurrency", "16", "--coalesce-ms", "2",
                "--obs-port", "0"]
#: The front-end's and engine's counters the fleet view must carry (the
#: engine's alone, the last three, on --stream).
PATH11_COUNTERS = ("serving.frontend.admitted", "serving.frontend.completed",
                   "serving.requests", "serving.rows_scored",
                   "serving.dispatches")


def write_shifted_holdout(val, root: Path) -> None:
    """Path 6's hold-out rows again, the global shard's values times
    PATH11_SCALE (user and item features, labels and ids unchanged),
    through the port's codec in PATH6_PARTS["validate"] spawned
    workers, under ``root / "shifted"``."""
    n, parts = PATH6_VAL, PATH6_PARTS["validate"]
    (root / "shifted").mkdir()
    dense = {s: val.feature_shards[s][:n].toarray()[:, PATH6_COLS[s]]
             for s in PATH6_NAMES}
    dense["global"] = dense["global"] * PATH11_SCALE
    names = {t: val.id_columns[t].vocabulary[val.id_columns[t].codes[:n]]
             for t in ("userId", "itemId")}
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(parts, mp_context=spawn) as pool:
        jobs = []
        for k, rows in enumerate(np.array_split(np.arange(n), parts)):
            sl = slice(rows[0], rows[-1] + 1)
            jobs.append(pool.submit(
                _write_part, root / "shifted" / f"part-{k:05d}.avro",
                {s: v[sl] for s, v in dense.items()}, val.responses[sl],
                names["userId"][sl], names["itemId"][sl], "validate",
                rows[0]))
        for job in jobs:
            job.result()


def watch_plane(out_dir: Path, results: dict, stop) -> None:
    """A scraper and a fleet aggregator over a live driver's plane (run
    in a thread beside it): wait for ``out_dir/obs_port``, then poll
    /readyz, /metrics and /distz, and a FleetAggregator's /snapshotz
    poll, until the driver's server goes away. Keeps the last bodies,
    every /metrics sample name, the largest /distz score count seen and
    the aggregator's merged counters and sketch states."""
    import re
    import urllib.error
    import urllib.request

    from photon_ml_tpu_torch.telemetry import read_obs_descriptor
    from photon_ml_tpu_torch.telemetry.federation import FleetAggregator

    name_re = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
    port_file = out_dir / "obs_port"
    deadline = time.monotonic() + 120
    while not port_file.exists():
        if stop.is_set() or time.monotonic() > deadline:
            results["error"] = "obs_port never appeared"
            return
        time.sleep(0.005)
    port = read_obs_descriptor(port_file)["port"]
    agg = FleetAggregator(peer_dirs=[out_dir], interval_s=0.05,
                          timeout_s=10.0)
    names, bad = set(), set()
    try:
        while not stop.is_set():
            # The aggregator alone reads /snapshotz, from the first
            # moment, so the driver's final-scrape handshake waits for
            # its last poll.
            agg.poll_once()
            view = agg.view()
            if any(s["has_snapshot"] for s in agg.peer_staleness().values()):
                results["fleet"] = view.registry.snapshot()["counters"]
                results["sketches"] = view.sketches
            try:
                for route in ("/readyz", "/metrics", "/distz"):
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}{route}",
                            timeout=10) as r:
                        results[route] = r.read().decode()
            except urllib.error.HTTPError as e:
                if e.code != 503:  # /readyz before the model loaded
                    results["error"] = f"{e.code} {e.url}"
                    return
                results["not_ready"] = results.get("not_ready", 0) + 1
                time.sleep(0.005)
                continue
            except (urllib.error.URLError, ConnectionError, OSError):
                return  # the driver's plane went away: done
            results["scrapes"] = results.get("scrapes", 0) + 1
            for line in results["/metrics"].splitlines():
                if line and not line.startswith("#"):
                    nm = line.split("{", 1)[0].split(" ", 1)[0]
                    (names if name_re.match(nm) else bad).add(nm)
            dist = json.loads(results["/distz"]).get("serving", {})
            rows = dist.get("default", {}).get("scores", {}).get(
                "moments", {}).get("count", 0)
            results["max_live_rows"] = max(rows,
                                           results.get("max_live_rows", 0))
            time.sleep(0.01)
    finally:
        agg.stop()
        results["names"], results["bad_names"] = names, bad


def distmon_cost(root: Path, card: str, reference: dict) -> None:
    """Path 11's serving outside the driver: the 10,000 hold-out rows in
    8-row requests replayed through a front-end of path 8's resident
    model by 16 requesters in 2 ms windows, with no score monitor and
    with one (the driver's --distmon), in turns (off, on, on, off), each
    replay timed on the host clock; every replay's scores must be the
    same bytes."""
    import torch

    from photon_ml_tpu_torch.data.avro_reader import (
        iter_game_dataset_batches,
    )
    from photon_ml_tpu_torch.data.distmon import ScoreDistributionMonitor
    from photon_ml_tpu_torch.data.paldb import load_feature_index_maps
    from photon_ml_tpu_torch.io.model_io import load_game_model
    from photon_ml_tpu_torch.serving import FrontendConfig, ServingFrontend

    model_dir = root / "p8-resident" / "best"
    maps = load_feature_index_maps(model_dir / "feature-indexes")
    model = load_game_model(model_dir, maps)
    requests = [ds.subset(np.arange(a, min(a + 8, ds.num_rows)))
                for ds in iter_game_dataset_batches(
                    root / "validate", id_types=[], feature_shard_maps=maps,
                    batch_rows=4096)
                for a in range(0, ds.num_rows, 8)]
    rates, outs = [], []
    for on in (False, True, True, False):
        fe = ServingFrontend({"default": model}, dtype=torch.float32,
                             config=FrontendConfig(coalesce_window_s=0.002,
                                                   max_pending=1024))
        mon = None
        if on:
            mon = ScoreDistributionMonitor("default", reference=reference)
            fe.engine("default").score_monitor = mon
        t0 = time.perf_counter()
        results, info = fe.replay(requests, concurrency=16)
        seconds = time.perf_counter() - t0
        check(info["shed"] == info["errors"] == 0, f"distmon cost: {info}")
        if mon is not None:
            mon.publish_gauges()
            check(mon.snapshot()["scores"]["moments"]["count"] == PATH6_VAL,
                  "distmon cost: the monitor missed rows")
        rates.append((on, PATH6_VAL / seconds))
        outs.append(b"".join(r.tobytes() for r in results))
        del fe
    same = all(o == outs[0] for o in outs)
    on_r = [r for o, r in rates if o]
    off_r = [r for o, r in rates if not o]
    print(f"path 11 distmon cost: 8-row replays, rows a second in turns "
          f"{[(('on' if o else 'off'), round(r, 1)) for o, r in rates]}; "
          f"mean on {np.mean(on_r):.1f} against off {np.mean(off_r):.1f} "
          f"({np.mean(on_r) / np.mean(off_r) - 1:+.3%}); scores the same "
          f"bytes off and on: {same}; card {card}", flush=True)
    check(same, "distmon cost: scores differ with the monitor on and off")


def path11(root: Path, val) -> int:
    """Path 11: drift serving of path 8's resident best model (the fixed
    effect over the 200-feature ``global`` shard, trained with
    --distmon, so its model-metadata.json carries
    ``referenceDistributions``) on path 6's 10,000 hold-out rows,
    unchanged and shifted (``write_shifted_holdout``), through the
    scoring driver three times: PATH11_SERVE with both PATH11_SLOS on
    the unchanged rows, the same on the shifted rows, and --stream
    --distmon (4,096-row batches) on the shifted rows, each with
    --obs-port 0 and watched from a thread (``watch_plane``; the
    --stream run's for its final sketch state). Checks: PSI < 0.1
    unchanged and > 0.25 shifted; the drift SLO compliant, then violated
    with violations >= 1; the served and the streamed shifted runs give
    the same score quantile sketch state bit for bit (a row's bits do
    not depend on its bucket, and the sketch is multiset-determined) and
    the same moments' count, min and max (their sums are folded per
    flush, and a live scrape flushes the served run's buffer at times
    the run does not fix: the means within 1e-12 of the mean |score|);
    ``score_distribution`` counts 10,000 rows; every /metrics sample
    name is legal Prometheus; the front-end's counters appear with
    ``_total``; /distz showed scores while the served runs were live;
    the aggregator's merged PATH11_COUNTERS equal the run's
    metrics.json. Then ``distmon_cost``. Returns the row-9 launches of
    the three runs, counted from 0 just before each and read just after."""
    import threading

    from photon_ml_tpu_torch.cli import game_scoring_driver
    from photon_ml_tpu_torch.ops import spmv

    card = card_line()
    t0 = time.perf_counter()
    write_shifted_holdout(val, root)
    print(f"path 11 shifted hold-out written: {PATH6_VAL} rows, global "
          f"values x{PATH11_SCALE:g}, {time.perf_counter() - t0:.1f} s",
          flush=True)
    model_dir = root / "p8-resident" / "best"
    reference = json.loads((model_dir / "model-metadata.json")
                           .read_text())["referenceDistributions"]
    slos = [a for s in PATH11_SLOS for a in ("--slo", s)]
    launches = 0
    runs = {}
    for tag, inp, flags in (
            ("serve", "validate", [*PATH11_SERVE, *slos]),
            ("serve-shifted", "shifted", [*PATH11_SERVE, *slos]),
            ("stream-shifted", "shifted", ["--stream", "--distmon",
                                           "--batch-rows", "4096",
                                           "--obs-port", "0"])):
        out = root / f"p11-{tag}"
        out.mkdir()
        results, stop = {}, threading.Event()
        watcher = threading.Thread(target=watch_plane,
                                   args=(out, results, stop), daemon=True)
        watcher.start()
        # ---- the main path: counts set to 0 just before, read after ----
        spmv.reset_launch_counts()
        t1 = time.perf_counter()
        try:
            summary = game_scoring_driver.run([
                "--input-dirs", str(root / inp), "--game-model-input-dir",
                str(model_dir), "--evaluators", "AUC", *flags,
                "--output-dir", str(out)])
        finally:
            stop.set()
            watcher.join(timeout=60)
        seconds = time.perf_counter() - t1
        run_launches = spmv.csr_matvec.launches
        # ------------------------------------------------------------------
        launches += run_launches
        runs[tag] = (summary, results)
        dist = summary["distributions"]["default"]
        drift = dist["drift"]
        slo = {k: (v["current"], v["burn_rate"], v["compliant"],
                   v["violations"])
               for k, v in summary.get("slo", {}).items()}
        print(f"path 11 {tag}: {summary['num_rows']} rows in {seconds:.2f} "
              f"s, AUC {summary['metrics']['AUC']:.6f}, PSI "
              f"{drift['psi']:.6f}, KS {drift['ks']:.6f}, score rows "
              f"{drift['rows']} (reference {drift['reference_rows']}), "
              f"slo (current, burn, compliant, violations) {slo}"
              f", row-9 launches {run_launches}; card {card}", flush=True)
        check(drift["rows"] == PATH6_VAL and run_launches > 0,
              f"path 11 {tag}: rows {drift['rows']}, launches "
              f"{run_launches}")
        check(not watcher.is_alive(), f"path 11 {tag}: watcher still runs")
        eng = (summary["frontend"]["engines"]["default"]
               if "frontend" in summary else summary["engine"])
        counters = summary["telemetry"]["metrics"]["counters"]
        fleet = results.get("fleet", {})
        names = (PATH11_COUNTERS if "frontend" in summary
                 else PATH11_COUNTERS[2:])
        merged = {k: (fleet.get(k), counters.get(k)) for k in names}
        print(f"path 11 {tag} plane: {results.get('scrapes', 0)} scrapes "
              f"({results.get('not_ready', 0)} before ready), "
              f"{len(results.get('names', ()))} sample names, illegal "
              f"{sorted(results.get('bad_names', ()))}, /distz score rows "
              f"seen live {results.get('max_live_rows')}, fleet vs "
              f"metrics.json {merged}", flush=True)
        check("error" not in results and results.get("scrapes", 0) > 0,
              f"path 11 {tag}: scraper {results.get('error')}")
        check(not results["bad_names"], f"path 11 {tag}: illegal names")
        check("frontend" not in summary
              or {"serving_frontend_admitted_total",
                  "serving_frontend_completed_total"} <= results["names"],
              f"path 11 {tag}: front-end counters without _total")
        check("frontend" not in summary
              or results.get("max_live_rows", 0) > 0,
              f"path 11 {tag}: /distz showed no scores")
        check(all(a == b and b > 0 for a, b in merged.values()),
              f"path 11 {tag}: fleet counters {merged}")
        check(eng["score_distribution"]["scores"]["moments"]["count"]
              == PATH6_VAL, f"path 11 {tag}: score_distribution")
    same = runs["serve"][0]["distributions"]["default"]["drift"]
    moved = runs["serve-shifted"][0]["distributions"]["default"]["drift"]
    check(same["psi"] < 0.1 < 0.25 < moved["psi"],
          f"path 11: PSI {same['psi']} unchanged, {moved['psi']} shifted")
    d_same = runs["serve"][0]["slo"]["drift"]
    d_moved = runs["serve-shifted"][0]["slo"]["drift"]
    check(d_same["compliant"] is True and d_moved["compliant"] is False
          and d_moved["violations"] >= 1,
          f"path 11: drift SLO {d_same} then {d_moved}")
    # The final sketch states, as the aggregator's last /snapshotz poll
    # merged them (one peer: its own states).
    states = [runs[tag][1]["sketches"]["serving"]
              for tag in ("serve-shifted", "stream-shifted")]
    q_same = (states[0]["default.scores.quantiles"]
              == states[1]["default.scores.quantiles"])
    a, b = (s["default.scores.moments"] for s in states)
    m_same = all(a[k] == b[k] for k in ("count", "nnz", "min", "max"))
    (ma, _), (mb, scale) = (
        (m["mean"], m["abs_mean"]) for m in (
            runs[tag][0]["distributions"]["default"]["scores"]["moments"]
            for tag in ("serve-shifted", "stream-shifted")))
    m_rel = abs(ma - mb) / scale  # of the mean |score|
    print(f"path 11 served vs streamed shifted sketches: quantile state "
          f"bit for bit {q_same} ({states[0]['default.scores.quantiles']['count']}"
          f" rows), moments count/nnz/min/max equal {m_same}, mean "
          f"relative difference {m_rel:.3g}", flush=True)
    check(q_same and m_same and m_rel <= 1e-12,
          "path 11: the served and streamed sketches differ")
    distmon_cost(root, card, reference)
    return launches


PATH12_REPLICA = ["--listen", "127.0.0.1:0", "--serve-seconds", "900",
                  "--coalesce-ms", "2", "--obs-port", "0"]
PATH12_CONNS, PATH12_WINDOW = 16, 32  # (a): connections, frames in flight
PATH12_HTTP_ROWS = 8
PATH12_FLEET_CONNS = 8
# (d): an open-loop burst at 4x (a)'s one-row rate on 64 connections (4x
# (a)'s frames in flight at the server), then idle until a relax.
PATH12_BURST, PATH12_BURST_S, PATH12_BURST_CONNS = 4.0, 1.0, 64
PATH12_START_S, PATH12_STOP_S = 240.0, 120.0
REPO = Path(__file__).resolve().parent


class _Proc:
    """A path-12 process, started fresh as ``python -m`` from the
    repository root (never a fork of this process, which holds a CUDA
    context), its output in a log file."""

    def __init__(self, name: str, argv: list, log: Path):
        self.name = name
        self.log = log
        with open(log, "w") as fh:
            self.p = subprocess.Popen([sys.executable, "-m", *argv],
                                      cwd=REPO, stdout=fh,
                                      stderr=subprocess.STDOUT)

    def tail(self, n: int = 25) -> str:
        return "\n".join(self.log.read_text(errors="replace")
                         .splitlines()[-n:])

    def wait_file(self, path: Path, timeout: float) -> str:
        """The text of ``path`` once this process has written it."""
        deadline = time.monotonic() + timeout
        while not (path.exists() and path.read_text().strip()):
            check(self.p.poll() is None, f"path 12: {self.name} exited "
                  f"{self.p.returncode} before {path.name}:\n{self.tail()}")
            check(time.monotonic() < deadline,
                  f"path 12: no {path.name} from {self.name} in {timeout} s")
            time.sleep(0.05)
        return path.read_text().strip()

    def stop(self, signalled: bool = False) -> int:
        """SIGINT (the drain path; unless ``signalled``), then the exit
        code."""
        if not signalled:
            self.p.send_signal(signal.SIGINT)
        try:
            return self.p.wait(timeout=PATH12_STOP_S)
        except subprocess.TimeoutExpired:
            raise CheckFailed(f"path 12: {self.name} did not drain in "
                              f"{PATH12_STOP_S} s:\n{self.tail()}") from None

    def kill(self) -> None:
        if self.p.poll() is None:
            self.p.kill()
            self.p.wait(timeout=60)


def _status(out: Path) -> dict:
    """A replica's live /statusz ``status`` block, off its --obs-port."""
    import urllib.request

    port = json.loads((out / "obs_port").read_text())["port"]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/statusz",
                                timeout=30) as resp:
        return json.loads(resp.read())["status"]


def _ms(values, q: float) -> float:
    return 1e3 * float(np.quantile(np.asarray(values), q))


async def _binary_run(port: int, frames: list, conns: int, window: int,
                      results=None):
    """``frames`` ((row, frame bytes)) over ``conns`` connections, each
    keeping ``window`` frames in flight: {row: scores or the typed error
    kind} (filled into ``results`` as answers come), the request
    latencies (s, write to response) and the wall s."""
    from photon_ml_tpu_torch.serving.wire import (
        ServerError,
        read_binary_response,
    )

    results = {} if results is None else results
    lat = []

    async def one(part):
        r, w = await asyncio.open_connection("127.0.0.1", port)
        sent = collections.deque()
        todo = iter(part)
        try:
            for row, frame in itertools.islice(todo, window):
                w.write(frame)
                sent.append((row, time.perf_counter()))
            while sent:
                await w.drain()
                try:
                    res = await read_binary_response(r)
                except ServerError as e:
                    res = e.kind
                row, t0 = sent.popleft()
                lat.append(time.perf_counter() - t0)
                results[row] = res
                for row, frame in itertools.islice(todo, 1):
                    w.write(frame)
                    sent.append((row, time.perf_counter()))
        finally:
            w.close()

    t0 = time.perf_counter()
    await asyncio.gather(*[one(frames[k::conns]) for k in range(conns)])
    return results, lat, time.perf_counter() - t0


async def _http_run(port: int, requests: list, conns: int):
    """``requests`` ((rows, request bytes)) as sequential HTTP/1.1
    keep-alive requests over ``conns`` connections: {row: float32
    score}, the latencies and the wall s."""
    from photon_ml_tpu_torch.serving.wire import read_http_response

    results, lat = {}, []

    async def one(part):
        r, w = await asyncio.open_connection("127.0.0.1", port)
        try:
            for rows, req in part:
                t0 = time.perf_counter()
                w.write(req)
                await w.drain()
                status, payload = await read_http_response(r)
                lat.append(time.perf_counter() - t0)
                obj = json.loads(payload)
                check(status == 200, f"path 12: HTTP {status} {obj}")
                scores = np.asarray(obj["scores"], np.float64).astype(
                    np.dtype(obj["dtype"]))
                for j, row in enumerate(rows):
                    results[row] = scores[j:j + 1]
        finally:
            w.close()

    t0 = time.perf_counter()
    await asyncio.gather(*[one(requests[k::conns]) for k in range(conns)])
    return results, lat, time.perf_counter() - t0


async def _burst(port: int, frames: list, rate: float, seconds: float,
                 conns: int):
    """Open loop: ``rate * seconds`` frames (``frames`` cycled) sent at
    ``rate`` a second over ``conns`` connections, whatever comes back;
    then every answer read: [(row, scores or the typed error kind)]."""
    from photon_ml_tpu_torch.serving.wire import (
        ServerError,
        read_binary_response,
    )

    links = [await asyncio.open_connection("127.0.0.1", port)
             for _ in range(conns)]
    pending = [collections.deque() for _ in range(conns)]
    sent = [0] * conns
    state = {"done": False}
    answers = []

    async def reader(c):
        r = links[c][0]
        got = 0
        while not state["done"] or got < sent[c]:
            if got == sent[c]:
                await asyncio.sleep(0.001)
                continue
            try:
                res = await read_binary_response(r)
            except ServerError as e:
                res = e.kind
            answers.append((pending[c].popleft(), res))
            got += 1

    readers = [asyncio.ensure_future(reader(c)) for c in range(conns)]
    try:
        n = int(rate * seconds)
        t0 = time.perf_counter()
        k = 0
        while k < n:
            due = min(n, int((time.perf_counter() - t0) * rate) + 1)
            while k < due:
                row, frame = frames[k % len(frames)]
                c = k % conns
                links[c][1].write(frame)
                pending[c].append(row)
                sent[c] += 1
                k += 1
            await asyncio.sleep(0.0005)
        state["done"] = True
        await asyncio.gather(*readers)
    finally:
        for task in readers:
            task.cancel()
        for _, w in links:
            w.close()
    return answers


def path12(root: Path, per_graph: int, figures10: dict) -> int:
    """Path 12: network serving of path 6's saved model (config 5 at full
    width: 200 fixed features, 5,000 users x 25, 2,000 items x 16, the
    factored itemFactors effect at k = 4) on its 10,000 hold-out rows,
    through replicas of ``python -m photon_ml_tpu_torch.cli.
    game_scoring_driver --listen`` (each a fresh process with its own
    CUDA context on device 0, --coalesce-ms 2, --obs-port 0) and
    ``python -m photon_ml_tpu_torch.cli.net_router``, this process the
    client. Four replicas: A for (a) and (b), B1 and B2 behind the router
    for (c), D with --adaptive-admission for (d), started once (a) set
    its SLO.

    (a) The 10,000 rows as one-row binary frames from 16 connections,
    each keeping 32 frames in flight, then as 8-row requests over 16
    HTTP/1.1 keep-alive connections: every row's score bit for bit path
    10's --stream score of its uid (the float32 score plus the row's
    offset), both framings the same bytes, the replica's ``net``
    responses the requests sent and ``wire_errors`` {}, graphs captured
    the distinct bucket shapes, each captured once. Prints rows a second
    and request P50/P99 (client side, write to response) for each
    framing beside path 10's in-process figures.
    (b) On A: a malformed frame pipelined between two good ones gets a
    typed ``malformed`` answer and its neighbours' scores are (a)'s; a
    frame over max_body_bytes gets ``too_large``; model "nope" gets
    ``unknown_model``; A still serves, and its ``wire_errors`` count
    exactly those three.
    (c) 8 connections of binary frames through the router: every score
    (a)'s bytes, the router's forwarded == returned == 10,000 with no
    backend error, both replicas answered, and, taken while the fleet
    serves, nvidia-smi lists compute apps and both replicas, never the
    router, have the CUDA driver mapped (``_cuda_holders_while``).
    (d) D with --slo p99:serving.frontend.request_latency_seconds<=X, X
    A's own P99 of (a)'s one-row requests (its front-end's histogram):
    an open-loop burst at 4x (a)'s one-row rate for a second on 64
    connections, then idle: the controller tightens, then relaxes; every
    error is a typed ``shed``, counted by D as the client counted it; every
    answered score is (a)'s bytes.

    Every process is stopped with SIGINT and must exit 0 with its
    metrics.json (the replicas') or its stats line (the router's); a
    failed phase kills what it started. Returns the replicas' row-9
    launches: per replica (dispatches + graph builds) x the launches a
    graph captures (``per_graph``, path 10's; each dispatch replays one
    graph, each build runs the bucket's function once eagerly), which
    must equal the process's own ``kernel_launches`` count."""
    from photon_ml_tpu_torch.data.avro_reader import read_game_dataset
    from photon_ml_tpu_torch.data.paldb import load_feature_index_maps
    from photon_ml_tpu_torch.serving import netserver, wire

    t_path = time.perf_counter()
    card = card_line()
    model_dir = root / "model" / "best"
    maps = load_feature_index_maps(model_dir / "feature-indexes")
    meta = json.loads((model_dir / "model-metadata.json").read_text())
    id_types = sorted(  # the scoring driver's id columns
        {c["randomEffectType"] for c in meta["coordinates"]
         if c["kind"] == "random"}
        | {c[k] for c in meta["coordinates"] if c["kind"] == "mf"
           for k in ("rowEffectType", "colEffectType")})
    data, _ = read_game_dataset(root / "validate", id_types, maps)
    stream = _scores_by_uid(root / "p10-stream")
    n = data.num_rows
    check(n == PATH6_VAL, f"path 12: {n} hold-out rows")
    singles = [(i, netserver.encode_request(_request(data, i, i + 1)))
               for i in range(n)]
    http = []
    for a in range(0, n, PATH12_HTTP_ROWS):
        rows = np.arange(a, min(a + PATH12_HTTP_ROWS, n))
        body = json.dumps(netserver.json_payload(
            _request(data, a, a + len(rows)))).encode("utf-8")
        http.append((rows, (f"POST /score HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                            f"Content-Type: application/json\r\n"
                            f"Content-Length: {len(body)}\r\n\r\n")
                     .encode("latin-1") + body))
    print(f"path 12 requests encoded: {n} one-row frames, {len(http)} "
          f"{PATH12_HTTP_ROWS}-row HTTP bodies, "
          f"{time.perf_counter() - t_path:.1f} s", flush=True)
    base = ["photon_ml_tpu_torch.cli.game_scoring_driver", "--input-dirs",
            str(root / "validate"), "--game-model-input-dir",
            str(model_dir), *PATH12_REPLICA]
    procs = {}

    def replica(name, extra=()):
        out = root / f"p12-{name}"
        procs[name] = _Proc(name, [*base, *extra, "--output-dir", str(out)],
                            root / f"p12-{name}.log")
        return out

    def ready(name, out):
        port = int(procs[name].wait_file(out / "net_port", PATH12_START_S))
        procs[name].wait_file(out / "obs_port", PATH12_START_S)
        return port

    def run_async(coro):
        return asyncio.run(asyncio.wait_for(coro, 300))

    try:
        t0 = time.perf_counter()
        outs = {name: replica(name) for name in ("A", "B1", "B2")}
        ports = {name: ready(name, out) for name, out in outs.items()}
        print(f"path 12 replicas A, B1, B2 listening on {ports} after "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # ---- (a) one replica, both framings ----------------------------
        bin_res, bin_lat, bin_s = run_async(_binary_run(
            ports["A"], singles, PATH12_CONNS, PATH12_WINDOW))
        served_p99 = _status(outs["A"])["frontend"][
            "request_latency_seconds"]["p99"]
        http_res, http_lat, http_s = run_async(_http_run(
            ports["A"], http, PATH12_CONNS))
        st = _status(outs["A"])
        net, fe = st["netserver"], st["frontend"]
        eng = fe["engines"]["default"]
        wrong = [i for i in range(n)
                 if not isinstance(bin_res.get(i), np.ndarray)
                 or float(np.float64(bin_res[i][0]) + data.offsets[i])
                 != stream[str(data.uids[i])]]
        framings = [i for i in range(n)
                    if bin_res[i].tobytes() != http_res[i].tobytes()]
        rate = n / bin_s
        print(f"path 12 (a) over the wire: one-row binary {rate:.0f} rows "
              f"a second, request P50 {_ms(bin_lat, 0.5):.3f} P99 "
              f"{_ms(bin_lat, 0.99):.3f} ms ({PATH12_CONNS} connections x "
              f"{PATH12_WINDOW} in flight); {PATH12_HTTP_ROWS}-row HTTP "
              f"{n / http_s:.0f} rows a second, P50 "
              f"{_ms(http_lat, 0.5):.3f} P99 {_ms(http_lat, 0.99):.3f} ms "
              f"({PATH12_CONNS} keep-alive connections); in process (path "
              f"10): {figures10}; served P99 of the one-row requests "
              f"{1e3 * served_p99:.3f} ms; card {card}", flush=True)
        print(f"path 12 (a) checks: rows off path 10's --stream bits "
              f"{len(wrong)}, framings differing {len(framings)}; net "
              f"{ {k: net[k] for k in ('requests_binary', 'requests_http', 'responses', 'wire_errors')} }; "
              f"graphs {fe['cache']['compilations']} (traces "
              f"{fe['cache']['traces']}) for {len(eng['bucket_shapes'])} "
              f"bucket shapes", flush=True)
        check(not wrong and not framings, f"path 12 (a): {len(wrong)} "
              f"rows off --stream's bits, {len(framings)} framings differ")
        check(net["requests_binary"] == n and net["requests_http"]
              == len(http) and net["responses"] == n + len(http)
              and net["wire_errors"] == {}, f"path 12 (a): net {net}")
        check(fe["cache"]["compilations"] == fe["cache"]["traces"]
              == fe["cache"]["entries"] == len(eng["bucket_shapes"]) > 0,
              f"path 12 (a): graphs {fe['cache']['compilations']} traces "
              f"{fe['cache']['traces']} for {eng['bucket_shapes']}")
        slo = ("p99:serving.frontend.request_latency_seconds"
               f"<={1e3 * served_p99:.6f}ms")
        outs["D"] = replica("D", ["--adaptive-admission", "--slo", slo])
        print(f"path 12 (d) SLO from (a): {slo}", flush=True)

        # ---- (b) wire faults on the live replica -----------------------
        async def faults(port):
            bad = _U4_FRAME.pack(7) + b"badmeta"
            r, w = await asyncio.open_connection("127.0.0.1", port)
            try:
                w.write(singles[0][1] + wire.REQUEST_MAGIC
                        + _U4_FRAME.pack(len(bad)) + bad + singles[1][1])
                w.write(netserver.encode_request(_request(data, 2, 3),
                                                 model="nope"))
                w.write(singles[3][1])
                await w.drain()
                got = []
                for _ in range(5):
                    try:
                        got.append(await wire.read_binary_response(r))
                    except wire.ServerError as e:
                        got.append(e.kind)
            finally:
                w.close()
            r, w = await asyncio.open_connection("127.0.0.1", port)
            try:
                w.write(wire.REQUEST_MAGIC + _U4_FRAME.pack(16 << 20))
                await w.drain()
                try:
                    await wire.read_binary_response(r)
                    got.append("answered")
                except wire.ServerError as e:
                    got.append(e.kind)
                got.append(await r.read())
            finally:
                w.close()
            return got

        got = run_async(faults(ports["A"]))
        net = _status(outs["A"])["netserver"]
        kinds = [g if isinstance(g, (str, bytes)) else "scores" for g in got]
        print(f"path 12 (b) faults: answers {kinds}; wire_errors "
              f"{net['wire_errors']}", flush=True)
        check(kinds == ["scores", "malformed", "scores", "unknown_model",
                        "scores", "too_large", b""],
              f"path 12 (b): answers {kinds}")
        check(all(got[j].tobytes() == bin_res[i].tobytes()
                  for j, i in ((0, 0), (2, 1), (4, 3))),
              "path 12 (b): a neighbour of a fault scored otherwise")
        check(net["wire_errors"] == {"malformed": 1, "too_large": 1,
                                     "unknown_model": 1}
              and net["responses"] == n + len(http) + 3,
              f"path 12 (b): net {net}")

        # ---- (c) two replicas behind the router ------------------------
        router_file = root / "p12-router-port"
        procs["router"] = _Proc("router", [
            "photon_ml_tpu_torch.cli.net_router", "--listen",
            "127.0.0.1:0", "--backend", f"127.0.0.1:{ports['B1']}",
            "--backend", f"127.0.0.1:{ports['B2']}", "--port-file",
            str(router_file)], root / "p12-router.log")
        router_port = int(procs["router"].wait_file(router_file, 60))

        pids = {name: procs[name].p.pid
                for name in ("B1", "B2", "router")}

        async def fleet():
            apps = asyncio.ensure_future(asyncio.to_thread(
                _cuda_holders_while, lambda: len(fleet_res) > n // 4,
                pids))
            out = await _binary_run(router_port, singles,
                                    PATH12_FLEET_CONNS, PATH12_WINDOW,
                                    fleet_res)
            return out, await apps

        fleet_res = {}
        (_, fleet_lat, fleet_s), apps = run_async(fleet())
        code = procs["router"].stop()
        router = json.loads(procs["router"].log.read_text()
                            .strip().splitlines()[-1])
        answered = {name: _status(outs[name])["netserver"]["responses"]
                    for name in ("B1", "B2")}
        same = sum(fleet_res[i].tobytes() == bin_res[i].tobytes()
                   for i in range(n))
        print(f"path 12 (c) fleet: {n / fleet_s:.0f} rows a second, P50 "
              f"{_ms(fleet_lat, 0.5):.3f} P99 {_ms(fleet_lat, 0.99):.3f} "
              f"ms ({PATH12_FLEET_CONNS} connections x {PATH12_WINDOW}); "
              f"replica split {answered}; router forwarded "
              f"{router['forwarded']} returned {router['returned']} "
              f"backend_errors {router['backend_errors']}, exit {code}; "
              f"while serving: {apps} (pids {pids}); scores as (a) "
              f"{same} of {n}; card {card}", flush=True)
        check(code == 0 and router["forwarded"] == router["returned"] == n
              and router["backend_errors"] == 0,
              f"path 12 (c): router exit {code}, stats {router}")
        check(all(v > 0 for v in answered.values())
              and sum(answered.values()) == n, f"path 12 (c): {answered}")
        check(same == n, f"path 12 (c): {n - same} scores differ from (a)")
        check(apps["compute_apps"] and apps["libcuda_mapped"] == {
            "B1": True, "B2": True, "router": False},
            f"path 12 (c): CUDA holders {apps}, pids {pids}")

        # ---- (d) adaptive admission under a burst ----------------------
        ports["D"] = ready("D", outs["D"])
        answers = run_async(_burst(ports["D"], singles,
                                   PATH12_BURST * rate, PATH12_BURST_S,
                                   PATH12_BURST_CONNS))
        t_idle = time.perf_counter()
        while True:
            ctl = _status(outs["D"])["adaptive_admission"]
            if ctl["relaxes"] >= 1 or time.perf_counter() - t_idle > 30:
                break
            time.sleep(0.25)
        net = _status(outs["D"])["netserver"]
        kinds = collections.Counter(
            "scores" if isinstance(res, np.ndarray) else res
            for _, res in answers)
        off = sum(isinstance(res, np.ndarray)
                  and res.tobytes() != bin_res[row].tobytes()
                  for row, res in answers)
        print(f"path 12 (d) adaptive: burst {len(answers)} frames at "
              f"{PATH12_BURST * rate:.0f} a second for {PATH12_BURST_S} s "
              f"on {PATH12_BURST_CONNS} connections: answers "
              f"{dict(kinds)}; controller tightens {ctl['tightens']}, "
              f"relaxes {ctl['relaxes']}, ticks {ctl['ticks']}, "
              f"max_pending {ctl['max_pending']} (base "
              f"{ctl['base_max_pending']}), window {ctl['coalesce_window_s']}"
              f" s (base {ctl['base_window_s']}); wire_errors "
              f"{net['wire_errors']}; idle to the first relax "
              f"{time.perf_counter() - t_idle:.2f} s; card {card}",
              flush=True)
        check(ctl["tightens"] >= 1 and ctl["relaxes"] >= 1,
              f"path 12 (d): controller {ctl}")
        check(set(kinds) <= {"scores", "shed"} and off == 0,
              f"path 12 (d): answers {dict(kinds)}, {off} scores off (a)")
        check(net["wire_errors"] == ({"shed": kinds["shed"]}
                                     if kinds["shed"] else {}),
              f"path 12 (d): wire_errors {net['wire_errors']}, client "
              f"counted {kinds['shed']} sheds")

        # ---- stop: the drain path ---------------------------------------
        launches = 0
        replicas = ("A", "B1", "B2", "D")
        for name in replicas:
            procs[name].p.send_signal(signal.SIGINT)
        for name in replicas:
            code = procs[name].stop(signalled=True)
            check(code == 0, f"path 12: {name} exited {code}:\n"
                  f"{procs[name].tail()}")
            summary = json.loads((outs[name] / "metrics.json").read_text())
            fe = summary["frontend"]
            eng = fe["engines"]["default"]
            counted = summary["kernel_launches"]["csr_matvec"]
            from_stats = (eng["dispatches"] + fe["cache"]["compilations"]) \
                * per_graph
            stages = sorted(
                summary["telemetry"]["stage_attribution"].items(),
                key=lambda kv: -kv[1]["self_s"])[:6]
            print(f"path 12 replica {name}: drained, exit 0, "
                  f"scoring_path {summary['scoring_path']}, net responses "
                  f"{summary['net']['responses']}, dispatches "
                  f"{eng['dispatches']}, graphs {fe['cache']['compilations']}"
                  f", row-9 launches {from_stats} (the process counted "
                  f"{counted}); top stages by self s "
                  f"{ {k: (v['count'], round(v['self_s'], 3)) for k, v in stages} }",
                  flush=True)
            check(summary["scoring_path"] == "netserver"
                  and counted == from_stats > 0
                  and fe["cache"]["compilations"] == fe["cache"]["traces"]
                  == len(eng["bucket_shapes"]),
                  f"path 12 {name}: launches {counted} != {from_stats}, or "
                  f"graphs {fe['cache']['compilations']} traces "
                  f"{fe['cache']['traces']} for "
                  f"{len(eng['bucket_shapes'])} bucket shapes")
            launches += counted
    except BaseException:
        for proc in procs.values():
            if proc.p.poll() is None:
                print(f"path 12 {proc.name} log tail:\n{proc.tail()}",
                      file=sys.stderr, flush=True)
        raise
    finally:
        for proc in procs.values():
            proc.kill()
    print(f"path 12: {time.perf_counter() - t_path:.1f} s, row-9 launches "
          f"{launches}; card {card}", flush=True)
    return launches


_U4_FRAME = struct.Struct("<I")


def _request(data, a: int, b: int):
    """Rows a..b of ``data`` as a client sends them: each id column
    holding only the ids its rows use (a row slice keeps the whole
    column's vocabulary, 5,000 users and 2,000 items, which a binary frame
    would carry and a replica would join per request)."""
    from photon_ml_tpu_torch.data.game_data import EntityIdColumn

    ds = data.subset(slice(a, b))
    for name, col in ds.id_columns.items():
        vocab, codes = np.unique(np.asarray(col.vocabulary)[col.codes],
                                 return_inverse=True)
        ds.id_columns[name] = EntityIdColumn(codes.astype(np.int32), vocab)
    return ds


def _cuda_holders_while(serving, pids: dict) -> dict:
    """Once ``serving()`` is true (the fleet is mid-run; within 60 s):
    nvidia-smi's compute apps (pid, name, memory) and, per process of
    ``pids`` (name -> pid), whether the CUDA driver library is mapped
    into it (/proc/<pid>/maps), which it is once the process has made a
    CUDA context. Where the card's processes run in a container with a
    pid namespace of its own, nvidia-smi reports compute apps under pids
    that are not theirs (every one as pid 1, "/process_api", on the
    H100 host these lines were measured on), so the mappings are what
    names the processes."""
    deadline = time.monotonic() + 60
    while not serving() and time.monotonic() < deadline:
        time.sleep(0.01)
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,process_name,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    mapped = {name: "libcuda.so" in Path(f"/proc/{pid}/maps").read_text()
              for name, pid in pids.items()}
    return {"compute_apps": apps, "libcuda_mapped": mapped}


# Path 13: the 1-D mesh, two slots of cuda:0 (ROADMAP A6a).
PATH13_SLOTS = 2
PATH13_DEVICE = "cuda:0"  # the slots' card
PATH13_CD_RTOL, PATH13_AUC_ATOL = 1e-5, 1e-4
#: The PERF.md row of an entity-solver variant (path 5's coordinates
#: launch only "lbfgs").
PATH13_ROW_OF_VARIANT = {"lbfgs": 1, "lbfgs+normalized": 2,
                         "lbfgs+bounded": 3, "owlqn": 4,
                         "owlqn+normalized": 4, "tron": 5,
                         "tron+normalized": 5, "tron+bounded": 6}


def _fold_bound_share(ordered, local, parts) -> float:
    """The largest |local - ordered| over its bound (S - 1) eps sum |p_i|
    (float32), elementwise; ``parts`` the S per-shard partials."""
    import torch

    eps = float(torch.finfo(torch.float32).eps)
    s = len(parts)
    mag = sum(p.abs().double() for p in parts)
    bound = (s - 1) * eps * mag
    diff = (local.double() - ordered.double()).abs()
    return float(torch.max(diff / torch.clamp_min(bound, 1e-300)))


def path13(root: Path, p8: dict, train, val, specs5, result5) -> dict:
    """Path 13: path 8's, path 9's and path 5's training over a 1-D mesh
    of PATH13_SLOTS slots of cuda:0 (module docstring, (a)-(d)). Returns
    its launches: ``entity`` per variant, ``row9`` and ``row10``, each
    counted from 0 just before a run of the main path and read just
    after."""
    import torch

    from photon_ml_tpu_torch.algorithm.coordinates import (
        FactoredRandomEffectCoordinate,
        RandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.cli import game_training_driver
    from photon_ml_tpu_torch.data.block_stream import BlockGameStream
    from photon_ml_tpu_torch.data.paldb import load_feature_index_maps
    from photon_ml_tpu_torch.data.shard_cache import DeviceShardCache
    from photon_ml_tpu_torch.ops import entity_solver, spmv
    from photon_ml_tpu_torch.ops.glm_objective import GLMBatch, GLMObjective
    from photon_ml_tpu_torch.ops.losses import loss_for_task
    from photon_ml_tpu_torch.ops.sharded_objective import ShardedGLMObjective
    from photon_ml_tpu_torch.parallel import make_mesh, mesh_device_list
    from photon_ml_tpu_torch.types import TaskType

    t_path = time.perf_counter()
    mesh = make_mesh(PATH13_SLOTS, device=PATH13_DEVICE)
    print(f"path 13 mesh: {mesh.describe()}; card {card_line()}",
          flush=True)
    launches = {"entity": collections.Counter(), "row9": 0, "row10": 0}
    base = ["--train-input-dirs", str(root / "train"),
            "--validate-input-dirs", str(root / "validate"),
            "--feature-index-dir", str(root / "feature-index"),
            "--task-type", "LOGISTIC_REGRESSION",
            "--fixed-effect-data-configurations", "fixed:global",
            "--updating-sequence", "fixed",
            "--evaluators", "AUC,LOGISTIC_LOSS",
            "--feeder", "native", "--batch-rows", str(PATH8_BATCH_ROWS),
            "--stream-train", "--mesh-devices", str(PATH13_SLOTS)]

    def run(tag, extra):
        spmv.reset_launch_counts()
        t0 = time.perf_counter()
        summary = game_training_driver.run(
            [*base, "--fixed-effect-optimization-configurations", PATH8_GRID,
             *extra, "--output-dir", str(root / f"p13-{tag}")],
            device=PATH13_DEVICE)
        torch.cuda.synchronize()
        mv, mm = spmv.csr_matvec.launches, spmv.csr_matmul.launches
        launches["row9"] += mv
        launches["row10"] += mm
        cache = summary["stream_train"]["cache"]
        print(f"path 13 {tag}: {time.perf_counter() - t0:.2f} s, best "
              f"{summary['bestConfigs']['fixed']}, cache "
              f"{ {k: cache.get(k) for k in ('shards', 'hits', 'misses', 'evictions', 'epochs', 'mesh_devices', 'per_device_bytes', 'per_device_resident_shards')} }"
              f", row 9 launches {mv}, row 10 launches {mm}", flush=True)
        return summary, mv, mm

    # (a) the scalar streamed solve, half the quarter budget a slot.
    per_slot = int(p8["quarter"]) // PATH13_SLOTS
    a, mv, _ = run("scalar", ["--grid-batched", "off", "--distmon",
                              "--hbm-budget", str(per_slot)])
    info, cache = a["stream_train"], a["stream_train"]["cache"]
    check(info["mesh_devices"] == PATH13_SLOTS
          and cache["mesh_devices"] == PATH13_SLOTS
          and len(cache["per_device_bytes"]) == PATH13_SLOTS,
          f"path 13 (a): mesh in metrics {info}")
    for slot in range(PATH13_SLOTS):
        held = (cache["shards"] - slot + PATH13_SLOTS - 1) // PATH13_SLOTS
        check(cache["per_device_resident_shards"][slot] < held,
              f"path 13 (a): slot {slot} never evicted ({cache})")
        check(cache["per_device_bytes"][slot] <= per_slot,
              f"path 13 (a): slot {slot} holds "
              f"{cache['per_device_bytes'][slot]} > {per_slot}")
    counters = a["telemetry"]["metrics"]["counters"]
    registry = {k: counters.get(f"data.shard_cache.{k}")
                for k in SHARD_CACHE_KEYS}
    check(registry == {k: cache[k] for k in SHARD_CACHE_KEYS},
          f"path 13 (a): registry {registry} != cache {cache}")
    check(mv == p8["quarter-f32-launches"],
          f"path 13 (a): row 9 launched {mv} times, path 8's quarter run "
          f"{p8['quarter-f32-launches']}")
    # Every λ: the best model's records, and per λ its solve's
    # convergence ring (objective and gradient norm an iteration) and its
    # training-score sketch (the final margins) from --distmon.
    q = p8["quarter-f32"]
    check(_fixed_records(root / "p13-scalar")
          == _fixed_records(root / "p8-quarter-f32"),
          "path 13 (a): the mesh's best model differs from path 8's")
    for key in ("convergence", "training_scores"):
        check(a["data_quality"][key] == q["data_quality"][key],
              f"path 13 (a): a λ's {key} differs from path 8's")
    check(a["objectiveHistory"] == q["objectiveHistory"],
          "path 13 (a): objective histories differ")
    print(f"path 13 (a): {PATH13_SLOTS} slots at {per_slot} bytes each: "
          f"path 8's quarter-f32 model bit for bit (best records, every "
          f"λ's convergence ring and score sketch), {mv} row-9 launches "
          "as there", flush=True)

    # (b) the batched grid.
    b, _, mm = run("grid", ["--grid-batched", "on", "--hbm-budget",
                            p8["quarter"]])
    check(b["stream_train"]["grid_batched"] is True,
          "path 13 (b): the grid did not batch")
    check(mm > 0, "path 13 (b): row 10 did not launch")
    check(_fixed_records(root / "p13-grid") == _fixed_records(
        root / "p9-grid"), "path 13 (b): the mesh's grid model differs "
          "from path 9's")
    print("path 13 (b): the batched grid over the mesh writes path 9's "
          f"grid model bit for bit ({mm} row-10 launches)", flush=True)

    # (c) the local fold on a cache placed like (a)'s.
    maps = load_feature_index_maps(root / "feature-index")
    stream = BlockGameStream(root / "train", id_types=[],
                             feature_shard_maps={"global": maps["global"]},
                             batch_rows=PATH8_BATCH_ROWS, feeder="native")
    cache_c = DeviceShardCache.from_stream(
        stream, "global", hbm_budget_bytes=per_slot,
        devices=mesh_device_list(mesh), device=PATH13_DEVICE)
    obj = GLMObjective(loss_for_task(TaskType.LOGISTIC_REGRESSION))
    ordered = ShardedGLMObjective(obj, cache_c, mesh=mesh)
    local = ShardedGLMObjective(obj, cache_c, mesh=mesh, combine="local")
    gen = torch.Generator().manual_seed(13)
    d = cache_c.n_features
    coef = (0.1 * torch.randn(d, generator=gen)).to(PATH13_DEVICE)
    vec = torch.randn(d, generator=gen).to(PATH13_DEVICE)
    z_o, f_o, g_o = ordered.margins_value_grad(coef, 1.0)
    _, f_l, g_l = local.margins_value_grad(coef, 1.0)
    d2 = ordered.curvature_list(z_o)
    h_o = ordered.hessian_vector(vec, d2, 1.0)
    h_l = local.hessian_vector(vec, d2, 1.0)
    vparts, gparts, hparts = [], [], []
    for e, w2 in zip(cache_c.blocks(), d2):
        _, (v_part, g_raw, _) = ordered._init(e, coef)
        jv = obj.margin_direction(vec, GLMBatch(e.feats, e.labels,
                                                e.offsets, e.weights))
        vparts.append(v_part.reshape(1))
        gparts.append(g_raw)
        hparts.append(e.feats.rmatvec(w2 * jv))
    shares = {"value": _fold_bound_share(f_o.reshape(1), f_l.reshape(1),
                                         vparts),
              "gradient": _fold_bound_share(g_o - coef, g_l - coef, gparts),
              "hvp": _fold_bound_share(h_o - vec, h_l - vec, hparts)}
    print(f"path 13 (c): combine='local' against 'ordered' over "
          f"{cache_c.n_shards} shards: worst share of (S - 1) eps sum |p| "
          f"{ {k: round(v, 4) for k, v in shares.items()} }, value "
          f"{float(f_o):.9g} / {float(f_l):.9g}", flush=True)
    check(all(v <= 1.0 for v in shares.values()),
          f"path 13 (c): the local fold outside its bound {shares}")
    del cache_c, ordered, local

    # (d) in core: the first updates from the same offsets, then the fit.
    coords = coordinates_of(train, specs5)
    residual = coords["fixed"].score(result5.model.models["fixed"])
    for name, coord in coords.items():
        if not isinstance(coord, (RandomEffectCoordinate,
                                  FactoredRandomEffectCoordinate)):
            continue
        twin = dataclasses.replace(coord, mesh=mesh)
        model0 = coord.initialize_model()
        entity_solver.reset_launch_counts()
        one, one_trk = coord.update_model(model0, residual, None)
        torch.cuda.synchronize()
        n_one = entity_solver.entity_lbfgs.launches
        entity_solver.reset_launch_counts()
        two, two_trk = twin.update_model(model0, residual, None)
        torch.cuda.synchronize()
        n_two = entity_solver.entity_lbfgs.variants.copy()
        launches["entity"].update(n_two)
        check(sum(n_two.values()) == PATH13_SLOTS * n_one,
              f"path 13 (d) {name}: {dict(n_two)} launches over the mesh, "
              f"{n_one} without")
        if isinstance(coord, FactoredRandomEffectCoordinate):
            pairs = [(a, b) for u, v in zip(two_trk, one_trk)
                     for a, b in zip(u.latent, v.latent)]
            same = all(torch.equal(a, b) for a, b in zip(
                two.latent.local_coefs, one.latent.local_coefs)) and \
                torch.equal(two.projection_matrix, one.projection_matrix)
        else:
            pairs = list(zip(two_trk, one_trk))
            same = all(torch.equal(a, b) for a, b in zip(
                two.local_coefs, one.local_coefs))
        pad_zero = all(bool(torch.all(a.x[b.x.shape[0]:] == 0))
                       for a, b in pairs)
        stops = all(torch.equal(a.reason[:b.x.shape[0]], b.reason)
                    and torch.equal(a.iterations[:b.x.shape[0]],
                                    b.iterations) for a, b in pairs)
        padded = sum(a.x.shape[0] - b.x.shape[0] for a, b in pairs)
        print(f"path 13 (d) {name} first update over the mesh: "
              f"coefficients {'equal' if same else 'DIFFER'}, reasons and "
              f"iterations {'equal' if stops else 'DIFFER'}, "
              f"{padded} padding entities zero {pad_zero}, entity-kernel "
              f"launches {dict(n_two)} against {n_one}", flush=True)
        check(same and stops and pad_zero,
              f"path 13 (d) {name}: the mesh's first update differs")
    del coords
    result13, launches13, _ = fit_path("path 13", specs5, train, val,
                                       mesh=mesh)
    launches["entity"].update(launches13)
    hist13 = np.asarray(result13.objective_history)
    hist5 = np.asarray(result5.objective_history)
    rel = float(np.max(np.abs(hist13 - hist5) / np.abs(hist5)))
    auc13 = result13.validation_history[-1]["AUC"]
    auc5 = result5.validation_history[-1]["AUC"]
    print(f"path 13 (d) fit over the mesh: objective history within "
          f"{rel:.3g} of path 5's (rtol {PATH13_CD_RTOL}), final AUC "
          f"{auc13:.6f} against {auc5:.6f}", flush=True)
    check(len(hist13) == len(hist5) and rel <= PATH13_CD_RTOL,
          f"path 13 (d): objective history {hist13} against {hist5}")
    check(abs(auc13 - auc5) <= PATH13_AUC_ATOL,
          f"path 13 (d): AUC {auc13} against {auc5}")
    rows = {f"row {i}": 0 for i in range(1, 7)}
    for v, n in launches["entity"].items():
        rows[f"row {PATH13_ROW_OF_VARIANT[v]}"] += n
    rows["row 9"], rows["row 10"] = launches["row9"], launches["row10"]
    print(f"path 13: {time.perf_counter() - t_path:.1f} s, launches "
          + json.dumps(rows), flush=True)
    return launches


# Path 14: the 2-D (data x model) mesh, slots of cuda:0 (ROADMAP A6b).
PATH14_DEVICE = "cuda:0"
PATH14_SHAPES = ((1, 2), (2, 2))
PATH14_FE_RTOL, PATH14_FE_ATOL = 1e-5, 2e-3
# (c)'s budget a slot, in quarters of path 8's shard bytes.
PATH14_REDECODE_QUARTERS = 2


class _PassCounts:
    """Counts the streamed objective's feature passes by kind while it is
    entered (the methods wrapped, their results untouched): a pass with
    a transposed product launches row 9 once a column slice of a shard,
    one without once a shard."""

    KINDS = ("margins_value_grad", "margin_direction_list",
             "grad_from_margins_list", "hessian_vector")

    def __enter__(self):
        from photon_ml_tpu_torch.ops.sharded_objective import (
            ShardedGLMObjective,
        )

        self.cls, self.counts = ShardedGLMObjective, dict.fromkeys(
            self.KINDS, 0)
        self.saved = {k: getattr(ShardedGLMObjective, k) for k in self.KINDS}

        def wrap(kind, fn):
            def counted(*a, **kw):
                self.counts[kind] += 1
                return fn(*a, **kw)
            return counted

        for k, fn in self.saved.items():
            setattr(ShardedGLMObjective, k, wrap(k, fn))
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(self.cls, k, fn)

    def row9(self, shards: int, cols: int, base: int) -> int:
        """Row 9's launches at ``cols`` column blocks, from the unblocked
        run's ``base``: each pass with a transposed product adds C - 1 a
        shard (1 + C launches against 2, or C against 1)."""
        c = self.counts
        transposed = (c["margins_value_grad"] + c["grad_from_margins_list"]
                      + c["hessian_vector"])
        return base + shards * (cols - 1) * transposed


def path14(root: Path, p8: dict, train, val, specs5, result5) -> dict:
    """Path 14: path 8's, path 9's and path 5's training over 2-D meshes
    of slots of cuda:0, and a world of one process (module docstring,
    (a)-(e)). Returns its launches: ``entity`` per variant, ``row9`` and
    ``row10``, each counted from 0 just before a run of the main path and
    read just after."""
    import torch

    from photon_ml_tpu_torch.algorithm.coordinates import (
        FactoredRandomEffectCoordinate,
        FixedEffectCoordinate,
        RandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.cli import game_training_driver
    from photon_ml_tpu_torch.estimators.game_estimator import FixedEffectSpec
    from photon_ml_tpu_torch.ops import entity_solver, spmv
    from photon_ml_tpu_torch.parallel import (
        initialize_multihost,
        is_primary_host,
        make_mesh_2d,
    )

    t_path = time.perf_counter()
    launches = {"entity": collections.Counter(), "row9": 0, "row10": 0}
    base = ["--train-input-dirs", str(root / "train"),
            "--validate-input-dirs", str(root / "validate"),
            "--feature-index-dir", str(root / "feature-index"),
            "--task-type", "LOGISTIC_REGRESSION",
            "--fixed-effect-data-configurations", "fixed:global",
            "--updating-sequence", "fixed",
            "--evaluators", "AUC,LOGISTIC_LOSS",
            "--feeder", "native", "--batch-rows", str(PATH8_BATCH_ROWS),
            "--stream-train"]
    per_slot = int(p8["quarter"]) // 2

    def run(tag, shape, extra, grid=PATH8_GRID, budget=per_slot):
        spmv.reset_launch_counts()
        t0 = time.perf_counter()
        with _PassCounts() as passes:
            summary = game_training_driver.run(
                [*base, "--fixed-effect-optimization-configurations", grid,
                 "--mesh-shape", f"{shape[0]}x{shape[1]}",
                 "--hbm-budget", str(budget), *extra,
                 "--output-dir", str(root / f"p14-{tag}")],
                device=PATH14_DEVICE)
            torch.cuda.synchronize()
        mv, mm = spmv.csr_matvec.launches, spmv.csr_matmul.launches
        launches["row9"] += mv
        launches["row10"] += mm
        cache = summary["stream_train"]["cache"]
        print(f"path 14 {tag}: {time.perf_counter() - t0:.2f} s, best "
              f"{summary['bestConfigs']['fixed']}, cache "
              f"{ {k: cache.get(k) for k in ('shards', 'hits', 'misses', 'evictions', 'epochs', 'col_blocks', 'col_block_size', 'per_device_bytes', 'per_device_resident_shards')} }"
              f", passes {passes.counts}, row 9 launches {mv}, row 10 "
              f"launches {mm}", flush=True)
        return summary, passes, mv, mm

    def check_cache(tag, summary, shape):
        r, c = shape
        info, cache = summary["stream_train"], summary["stream_train"][
            "cache"]
        check(list(info["mesh_shape"]) == [r, c]
              and cache["mesh_devices"] == r * c
              and cache["col_blocks"] == c
              and cache["col_block_size"] == -(-200 // c)
              and len(cache["per_device_bytes"]) == r * c,
              f"path 14 {tag}: mesh in metrics {info}")
        for slot in range(r * c):
            held = (cache["shards"] - slot // c + r - 1) // r
            check(cache["per_device_resident_shards"][slot] < held,
                  f"path 14 {tag}: slot {slot} never evicted ({cache})")
            check(cache["per_device_bytes"][slot] <= per_slot,
                  f"path 14 {tag}: slot {slot} holds "
                  f"{cache['per_device_bytes'][slot]} > {per_slot}")
        metrics = summary["telemetry"]["metrics"]
        registry = {k: metrics["counters"].get(f"data.shard_cache.{k}")
                    for k in SHARD_CACHE_KEYS}
        registry.update({k: metrics["gauges"].get(f"data.shard_cache.{k}")
                         for k in ("col_blocks", "col_block_size")})
        check(registry == {k: cache[k] for k in registry},
              f"path 14 {tag}: registry {registry} != cache {cache}")

    # (a) the scalar streamed solve, half the quarter budget a slot.
    q = p8["quarter-f32"]
    want = _fixed_records(root / "p8-quarter-f32")
    for shape in PATH14_SHAPES:
        tag = f"scalar-{shape[0]}x{shape[1]}"
        a, passes, mv, _ = run(tag, shape, ["--grid-batched", "off",
                                            "--distmon"])
        check_cache(tag, a, shape)
        check(_fixed_records(root / f"p14-{tag}") == want,
              f"path 14 (a) {tag}: the best model differs from path 8's")
        for key in ("convergence", "training_scores"):
            check(a["data_quality"][key] == q["data_quality"][key],
                  f"path 14 (a) {tag}: a λ's {key} differs from path 8's")
        check(a["objectiveHistory"] == q["objectiveHistory"],
              f"path 14 (a) {tag}: objective histories differ")
        shards = a["stream_train"]["cache"]["shards"]
        base9 = p8["quarter-f32-launches"]
        expect = passes.row9(shards, shape[1], base9)
        n_t = (expect - base9) // (shards * (shape[1] - 1))
        print(f"path 14 (a) {tag}: {per_slot} bytes a slot: path 8's "
              "quarter-f32 model bit for bit (best records, every λ's "
              f"convergence ring and score sketch); row 9 launched {mv} "
              f"times = path 8's {base9} + {shards} shards x (C - 1 = "
              f"{shape[1] - 1}) x {n_t} passes with a transposed product "
              f"= {expect}", flush=True)
        check(mv == expect, f"path 14 (a) {tag}: row 9 launched {mv} "
              f"times, expected {expect}")

    # (b) the batched grid.
    b, _, _, mm = run("grid-2x2", (2, 2), ["--grid-batched", "on"])
    check(b["stream_train"]["grid_batched"] is True,
          "path 14 (b): the grid did not batch")
    check(mm > 0, "path 14 (b): row 10 did not launch")
    check(_fixed_records(root / "p14-grid-2x2") == _fixed_records(
        root / "p9-grid"), "path 14 (b): the 2x2 grid model differs from "
          "path 9's")
    print("path 14 (b): the batched grid over 2x2 writes path 9's grid "
          f"model bit for bit ({mm} row-10 launches)", flush=True)

    # (c) the redecode tier, at half path 8's shard bytes a slot (twice
    # the quarter): every miss re-decodes its Avro rows, so fewer misses
    # keep it short. A column-0 slot also holds its shards' product maps
    # and needs more than half the shard bytes, so it still evicts.
    best = q["bestConfigs"]["fixed"]
    red, _, _, _ = run("redecode-2x2", (2, 2), [
        "--grid-batched", "off", "--spill-source", "redecode"],
        grid="fixed:" + best, budget=PATH14_REDECODE_QUARTERS
        * int(p8["quarter"]))
    check(red["stream_train"]["cache"]["evictions"] > 0,
          "path 14 (c): the redecode run evicted nothing")
    check(_fixed_records(root / "p14-redecode-2x2")
          == _fixed_records(root / "p8-quarter-redecode"),
          "path 14 (c): the 2x2 redecode model differs from path 8's")
    print("path 14 (c): --spill-source redecode over 2x2 writes path 8's "
          "redecode records bit for bit", flush=True)

    # (d) in core: the first updates from the same offsets, then the fit.
    mesh = make_mesh_2d(2, 2, device=PATH14_DEVICE)
    print(f"path 14 mesh: {mesh.describe()}; card {card_line()}",
          flush=True)
    coords = coordinates_of(train, specs5)
    residual = coords["fixed"].score(result5.model.models["fixed"])
    for name, coord in coords.items():
        model0 = coord.initialize_model()
        if isinstance(coord, FixedEffectCoordinate):
            twin = dataclasses.replace(coord, mesh=mesh,
                                       feature_sharding=True)
            one, one_res = coord.update_model(model0, None)
            two, two_res = twin.update_model(model0, None)
            torch.cuda.synchronize()
            a_ = two.glm.coefficients.means.double()
            b_ = one.glm.coefficients.means.double()
            worst = float((a_ - b_).abs().max())
            rel = abs(float(two_res.value) - float(one_res.value)) / abs(
                float(one_res.value))
            print(f"path 14 (d) {name} feature-sharded first update: value "
                  f"within {rel:.3g} (rtol {PATH14_FE_RTOL}), coefficients "
                  f"within {worst:.3g} (atol {PATH14_FE_ATOL}) of the "
                  f"unsharded update, padded width {twin._d_pad}", flush=True)
            check(rel <= PATH14_FE_RTOL and worst <= PATH14_FE_ATOL,
                  f"path 14 (d) {name}: the feature-sharded update differs")
            continue
        twin = dataclasses.replace(coord, mesh=mesh)
        entity_solver.reset_launch_counts()
        one, one_trk = coord.update_model(model0, residual, None)
        torch.cuda.synchronize()
        n_one = entity_solver.entity_lbfgs.launches
        entity_solver.reset_launch_counts()
        two, two_trk = twin.update_model(model0, residual, None)
        torch.cuda.synchronize()
        n_two = entity_solver.entity_lbfgs.variants.copy()
        launches["entity"].update(n_two)
        check(sum(n_two.values()) == 2 * n_one,
              f"path 14 (d) {name}: {dict(n_two)} launches over the mesh, "
              f"{n_one} without")
        if isinstance(coord, FactoredRandomEffectCoordinate):
            pairs = [(x, y) for u, v in zip(two_trk, one_trk)
                     for x, y in zip(u.latent, v.latent)]
            same = all(torch.equal(x, y) for x, y in zip(
                two.latent.local_coefs, one.latent.local_coefs)) and \
                torch.equal(two.projection_matrix, one.projection_matrix)
        else:
            pairs = list(zip(two_trk, one_trk))
            same = all(torch.equal(x, y) for x, y in zip(
                two.local_coefs, one.local_coefs))
        pad_zero = all(bool(torch.all(x.x[y.x.shape[0]:] == 0))
                       for x, y in pairs)
        stops = all(torch.equal(x.reason[:y.x.shape[0]], y.reason)
                    and torch.equal(x.iterations[:y.x.shape[0]],
                                    y.iterations) for x, y in pairs)
        print(f"path 14 (d) {name} first update over 2x2: coefficients "
              f"{'equal' if same else 'DIFFER'}, reasons and iterations "
              f"{'equal' if stops else 'DIFFER'}, padding entities zero "
              f"{pad_zero}, entity-kernel launches {dict(n_two)} against "
              f"{n_one}", flush=True)
        check(same and stops and pad_zero,
              f"path 14 (d) {name}: the mesh's first update differs")
    del coords
    specs14 = [dataclasses.replace(s_, feature_sharding=True)
               if isinstance(s_, FixedEffectSpec) else s_ for s_ in specs5]
    result14, launches14, _ = fit_path("path 14", specs14, train, val,
                                       mesh=mesh)
    launches["entity"].update(launches14)
    hist14 = np.asarray(result14.objective_history)
    hist5 = np.asarray(result5.objective_history)
    rel = float(np.max(np.abs(hist14 - hist5) / np.abs(hist5)))
    auc14 = result14.validation_history[-1]["AUC"]
    auc5 = result5.validation_history[-1]["AUC"]
    print(f"path 14 (d) fit over 2x2: objective history within {rel:.3g} "
          f"of path 5's (rtol {PATH13_CD_RTOL}), final AUC {auc14:.6f} "
          f"against {auc5:.6f}", flush=True)
    check(len(hist14) == len(hist5) and rel <= PATH13_CD_RTOL,
          f"path 14 (d): objective history {hist14} against {hist5}")
    check(abs(auc14 - auc5) <= PATH13_AUC_ATOL,
          f"path 14 (d): AUC {auc14} against {auc5}")

    # (e) multi-host: a world of one over loopback on nccl.
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    try:
        up = initialize_multihost(f"127.0.0.1:{port}", 1, 0,
                                  device=PATH14_DEVICE, timeout=120)
        primary = is_primary_host()
        t = torch.ones(4, device=PATH14_DEVICE)
        torch.distributed.all_reduce(t)
        torch.cuda.synchronize()
        summed = t.tolist()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    print(f"path 14 (e): initialize_multihost over loopback on nccl "
          f"{up}, primary host {primary}, all-reduce {summed}, group "
          f"left {not torch.distributed.is_initialized()}", flush=True)
    check(up and primary and summed == [1.0] * 4
          and not torch.distributed.is_initialized(),
          "path 14 (e): the world of one failed")
    rows = {"row 1": launches["entity"].get("lbfgs", 0),
            "row 9": launches["row9"], "row 10": launches["row10"]}
    print(f"path 14: {time.perf_counter() - t_path:.1f} s, launches "
          + json.dumps(rows), flush=True)
    return launches


# Path 16: the indexing job, training on its stores, damped Newton.
PATH16_FIXED = "fixed:15,1e-5,1.0,1.0,TRON,L2"  # run_game_full.sh:35-36
PATH16_PER_USER = ("perUser:userId,global,4,-1,-1,-1",
                   "perUser:30,1e-6,0.5,1.0,LBFGS,ELASTIC_NET,0.5")
PATH16_AUC_ATOL, PATH16_COEF_ATOL = 1e-4, 1e-3
# Against the scan-order JSON map the columns sit in another order, so
# the float32 sums do: that moves the TRON fixed effect, hence every
# per-user offset, and run_game_full.sh's per-user solves, cut at 30
# iterations and at a relative tolerance of 1e-6, carry the move on. The
# same two maps with the per-user solves run to convergence (these
# flags) witness that, and there every per-user coefficient is held.
PATH16_PER_USER_CONVERGED = "perUser:500,1e-12,0.5,1.0,LBFGS,ELASTIC_NET,0.5"
PATH16_NEWTON_ATOL, PATH16_NEWTON_VALUE_RTOL = 1e-9, 1e-6
PATH16_N_PAD = 32  # the per-user bucket Newton solves (2,755 entities)
PATH16_DEVICE = "cuda"
PATH16_LBFGS_TOL, PATH16_LBFGS_MAX_ITER = 1e-12, 200


def _by_name(loaded, maps, coordinate: str, names: list) -> np.ndarray:
    """A loaded coordinate's coefficients in the column order of
    ``names``: the fixed effect's as [1, n], a random effect's as
    [entities, n] in vocabulary order."""
    cols = [maps["global"].get_index(n) for n in names]
    model = loaded.models[coordinate]
    if coordinate == "fixed":
        return model.glm.coefficients.means.cpu().double().numpy()[
            None, cols]
    order = np.argsort(np.asarray(model.vocabulary, dtype=object))
    return model.matrix.toarray()[order][:, cols]


def path16(root: Path, train, specs1) -> dict:
    """Path 16 (module docstring): (a) the feature-indexing job on path
    6's training files, PalDB and JSON; (b) run_game_full.sh's fixed and
    per-user coordinates trained on either store; (c) damped Newton on
    the card against the CPU and row 1. Returns the per-user solves'
    entity-kernel launches per variant (counted from 0 just before each
    training run and read just after)."""
    import torch

    from photon_ml_tpu_torch.cli import feature_indexing, game_training_driver
    from photon_ml_tpu_torch.data.avro_reader import build_index_map
    from photon_ml_tpu_torch.data.index_map import INTERCEPT_KEY, feature_key
    from photon_ml_tpu_torch.data.paldb import (
        load_feature_index_maps,
        read_paldb_store,
    )
    from photon_ml_tpu_torch.io.model_io import load_game_model
    from photon_ml_tpu_torch.ops import DenseFeatures, GLMObjective
    from photon_ml_tpu_torch.ops import entity_solver
    from photon_ml_tpu_torch.ops.glm_objective import make_batch
    from photon_ml_tpu_torch.optimization import minimize_newton

    t_path = time.perf_counter()
    # ---- (a) the indexing job, run_game_full.sh:20-23's flags and JSON --
    stores = {"paldb": root / "p16-paldb", "json": root / "p16-json"}
    t0 = time.perf_counter()
    for fmt, out in stores.items():
        extra = (["--partition-num", "2"] if fmt == "paldb" else [])
        feature_indexing.run([
            "--data-path", str(root / "train"), "--output-dir", str(out),
            "--format", fmt, *extra, "--shard-name", "global",
            "--save-name-and-term-sets", "true"])
    index_s = time.perf_counter() - t0
    maps = {fmt: load_feature_index_maps(out) for fmt, out in
            stores.items()}
    names = sorted({feature_key(n) for s in PATH6_NAMES
                    for n in PATH6_NAMES[s]})
    for fmt, m in maps.items():
        keys = dict(m["global"].key_items())
        check(set(m) == {"global"} and set(keys) == set(names)
              | {INTERCEPT_KEY} and len(names) == 238,
              f"path 16 (a) {fmt}: the map holds {len(keys)} names")
        check(sorted(keys.values()) == list(range(len(keys))),
              f"path 16 (a) {fmt}: indices are not contiguous from 0")
    for i in range(2):
        pairs = list(read_paldb_store(
            stores["paldb"] / f"paldb-partition-global-{i}.dat"))
        fwd = {k: v for k, v in pairs if isinstance(k, str)}
        back = {k: v for k, v in pairs if isinstance(k, int)}
        check(len(fwd) > 0 and {v: k for k, v in fwd.items()} == back,
              f"path 16 (a): partition {i} does not hold both directions")
    scanned = build_index_map(root / "train")
    check(dict(maps["json"]["global"].key_items())
          == dict(scanned.key_items()),
          "path 16 (a): the JSON map differs from build_index_map's")
    sets = {fmt: (out / "name-and-term-sets" / "features.txt").read_text()
            for fmt, out in stores.items()}
    check(sets["paldb"] == sets["json"] and sets["json"].splitlines()
          == [f"{n}\x01" for n in sorted(PATH6_NAMES["global"]
                                          + PATH6_NAMES["user"]
                                          + PATH6_NAMES["item"])],
          "path 16 (a): the name-and-term sets differ")
    moved = sum(maps["paldb"]["global"].get_index(n)
                != maps["json"]["global"].get_index(n) for n in names)
    print(f"path 16 (a): the indexing job twice ({index_s:.2f} s): 2 PalDB "
          f"partitions and a JSON map of {len(names)} names + the "
          f"intercept, both directions in each partition, indices 0.."
          f"{len(names)}, the JSON map build_index_map's, equal name-and-"
          f"term sets; {moved} names sit at another column in the PalDB "
          "map", flush=True)

    # ---- (b) training on the PalDB stores and on JSON stores ------------
    # The PalDB map saved as JSON (the same columns) and the scan-order
    # JSON map (other columns: compared by feature name), then the PalDB
    # stores and the scan-order map again with the per-user solves run to
    # convergence.
    stores["paldb-as-json"] = root / "p16-paldb-as-json"
    stores["paldb-as-json"].mkdir()
    maps["paldb-as-json"] = maps["paldb"]
    maps["paldb"]["global"].save(stores["paldb-as-json"] / "global.json")
    runs, launches = {}, collections.Counter()
    t0 = time.perf_counter()
    per_user = {"flags": PATH16_PER_USER[1],
                "converged": PATH16_PER_USER_CONVERGED}
    for fmt, solve in (("paldb", "flags"), ("paldb-as-json", "flags"),
                       ("json", "flags"), ("paldb", "converged"),
                       ("json", "converged")):
        out = root / f"p16-model-{fmt}-{solve}"
        argv = [
            "--train-input-dirs", str(root / "train"),
            "--validate-input-dirs", str(root / "validate"),
            "--feature-index-dir", str(stores[fmt]),
            "--output-dir", str(out),
            "--task-type", "LOGISTIC_REGRESSION",
            "--fixed-effect-data-configurations", "fixed:global",
            "--fixed-effect-optimization-configurations", PATH16_FIXED,
            "--random-effect-data-configurations", PATH16_PER_USER[0],
            "--random-effect-optimization-configurations",
            per_user[solve], "--updating-sequence", "fixed,perUser",
            "--num-iterations", "1", "--evaluators", "AUC"]
        # ---- the main path: counts set to 0 just before, read after ----
        entity_solver.reset_launch_counts()
        t1 = time.perf_counter()
        summary = game_training_driver.run(argv, device=PATH16_DEVICE)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        ran = dict(entity_solver.entity_lbfgs.variants)
        # -----------------------------------------------------------------
        launches.update(ran)
        loaded = load_game_model(out / "best", maps[fmt])
        reasons = json.loads((out / "best" / "model-metadata.json")
                             .read_text())["optimizationTrackers"][
                                 "perUser"][-1]["convergenceReasons"]
        runs[fmt, solve] = dict(
            summary=summary, launches=ran, records=_avro_records(out),
            fixed=_by_name(loaded, maps[fmt], "fixed", names),
            per_user=_by_name(loaded, maps[fmt], "perUser", names))
        print(f"path 16 (b) {fmt} {solve}: {seconds:.2f} s, AUC "
              f"{summary['validationHistory'][-1]['AUC']:.6f}, entity-"
              f"kernel launches {ran}, per-user solves stop {reasons}",
              flush=True)
    train_s = time.perf_counter() - t0
    p, same = runs["paldb", "flags"], runs["paldb-as-json", "flags"]
    check(all(r["launches"] == p["launches"] for r in runs.values())
          and set(p["launches"]) == {"owlqn"} and p["launches"]["owlqn"] > 0,
          "path 16 (b): per-user launches "
          + str({f"{k[0]} {k[1]}": r["launches"] for k, r in runs.items()}))
    check(p["records"] == same["records"]
          and p["summary"]["objectiveHistory"]
          == same["summary"]["objectiveHistory"],
          "path 16 (b): the PalDB stores and their map as JSON trained "
          "different models")
    print("path 16 (b): PalDB stores and their map as JSON: model records "
          "and objective histories bit for bit", flush=True)
    for solve in per_user:
        p, j = runs["paldb", solve], runs["json", solve]
        auc = [r["summary"]["validationHistory"][-1]["AUC"] for r in (p, j)]
        d_auc = abs(auc[0] - auc[1])
        d_fixed = float(np.abs(p["fixed"] - j["fixed"]).max())
        per_entity = np.abs(p["per_user"] - j["per_user"]).max(axis=1)
        q50, q90, q99 = np.quantile(per_entity, [0.5, 0.9, 0.99])
        print(f"path 16 (b) {solve}: PalDB stores against the scan-order "
              f"JSON store by feature name: AUC {auc[0]:.6f} / {auc[1]:.6f}"
              f" (|d| {d_auc:.3g}, atol {PATH16_AUC_ATOL}), fixed "
              f"coefficients |d| <= {d_fixed:.3g} (atol {PATH16_COEF_ATOL})"
              f", per-user |d| <= {float(per_entity.max()):.3g} over "
              f"{len(per_entity)} entities (median {q50:.3g}, 90% "
              f"{q90:.3g}, 99% {q99:.3g}; "
              f"{int((per_entity > PATH16_COEF_ATOL).sum())} entities beyond"
              f" {PATH16_COEF_ATOL})", flush=True)
        check(d_auc <= PATH16_AUC_ATOL,
              f"path 16 (b) {solve}: the AUCs differ")
        check(d_fixed <= PATH16_COEF_ATOL,
              f"path 16 (b) {solve}: the fixed-effect coefficients differ")
        check(p["per_user"].shape == j["per_user"].shape,
              f"path 16 (b) {solve}: the per-user models hold other "
              "entities")
        check(solve == "flags"
              or float(per_entity.max()) <= PATH16_COEF_ATOL,
              f"path 16 (b) {solve}: the per-user coefficients differ")

    # ---- (c) damped Newton on path 1's n_pad 32 per-user bucket ----------
    t0 = time.perf_counter()
    for name, _, kind, block, args, kw in first_update_buckets(
            coordinates_of(train, specs1)):
        if kind == "re" and name == "perUser" and \
                block.x.shape[1] == PATH16_N_PAD:
            break
    loss, x, labels, offsets, weights, c0, l2 = args[:7]
    e, r, d = x.shape
    # Row 1 at path 1's tolerance stops some entities 1e-5 above their
    # optimum, so the reference solution is row 1 run to convergence.
    row1 = entity_solver.entity_lbfgs(*args, **kw)
    row1_conv = entity_solver.entity_lbfgs(*args, **dict(
        kw, tol=PATH16_LBFGS_TOL, max_iter=PATH16_LBFGS_MAX_ITER))
    torch.cuda.synchronize()
    objective = GLMObjective(loss)

    def newton(device):
        xs, ys, os_, ws = (t.to(device, torch.float64) for t in (
            x, labels, offsets, weights))
        batch = make_batch(DenseFeatures(xs), ys, os_, ws)
        return minimize_newton(objective.value, torch.zeros(
            (e, d), dtype=torch.float64, device=device), args=(batch, l2))

    newton(PATH16_DEVICE)  # first call: torch.func's and cuSOLVER's set-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = newton(PATH16_DEVICE)
    torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    ref = newton("cpu")
    cpu_s = time.perf_counter() - t1
    iters = int(res.iterations.max())
    worst = float((res.x.cpu() - ref.x).abs().max())
    rel = ((res.value - row1_conv.value.double()).abs()
           / row1_conv.value.double().abs().clamp_min(1e-30))
    below = float(((res.value - row1.value.double())
                   / row1.value.double().abs()).min())
    worse = int((res.value > row1.value.double()
                 * (1 + PATH16_NEWTON_VALUE_RTOL)).sum())
    print(f"path 16 (c): minimize_newton float64 on {e} entities [{r} x "
          f"{d}] (path 1's per-user bucket, l2 {l2}): iterations "
          f"{np.bincount(res.iterations.cpu().numpy()).tolist()} by count"
          f", reasons {np.bincount(res.reason.cpu().numpy(), minlength=5).tolist()}"
          f"; CPU equal iterations "
          f"{torch.equal(res.iterations.cpu(), ref.iterations)} and reasons"
          f" {torch.equal(res.reason.cpu(), ref.reason)}, coefficients "
          f"within {worst:.3g} (atol {PATH16_NEWTON_ATOL}); objective "
          f"within {float(rel.max()):.3g} of row 1's L-BFGS run to "
          f"convergence (tol {PATH16_LBFGS_TOL}; rtol "
          f"{PATH16_NEWTON_VALUE_RTOL}), down to {below:.3g} below row 1 "
          f"at path 1's tolerance, above it on {worse} entities; "
          f"{1e3 * cuda_s:.1f} ms on the card"
          f" = {1e3 * cuda_s / max(iters, 1):.2f} ms an iteration over "
          f"{iters} (CPU {1e3 * cpu_s:.1f} ms); card {card_line()}",
          flush=True)
    check(torch.equal(res.iterations.cpu(), ref.iterations)
          and torch.equal(res.reason.cpu(), ref.reason),
          "path 16 (c): Newton's iterations or reasons differ on the CPU")
    check(worst <= PATH16_NEWTON_ATOL,
          f"path 16 (c): Newton's coefficients differ by {worst}")
    check(float(rel.max()) <= PATH16_NEWTON_VALUE_RTOL and worse == 0,
          f"path 16 (c): Newton's objective {float(rel.max())} from row 1,"
          f" above row 1 at path 1's tolerance on {worse} entities")
    newton_s = time.perf_counter() - t0
    print(f"path 16: {time.perf_counter() - t_path:.1f} s ((a) "
          f"{index_s:.1f}, (b) {train_s:.1f}, (c) {newton_s:.1f}), "
          f"per-user launches {dict(launches)}", flush=True)
    return dict(launches)


def order_contract_check() -> None:
    """The kernels' order contract (csrc/csr_order.cuh): a row of 3,
    L - 1, L, L + 1 and 3L + 5 entries (L the chunk), first in one CSR
    and last in another with other neighbours, gives the same bits in
    both, in row 9 and in row 10 (n = 4 and 20), and those bits are the
    contract's (spmv.csr_order_reference)."""
    import torch

    from photon_ml_tpu_torch.ops import spmv

    chunk = spmv.chunk_entries()
    n_cols = 4 * chunk
    rng = np.random.default_rng(11)

    def csr(lengths, fixed, where):
        crow = np.zeros(len(lengths) + 1, np.int32)
        crow[1:] = np.cumsum(lengths)
        cols, vals = [], []
        for i, m in enumerate(lengths):
            if i == where:
                cols.append(fixed[0])
                vals.append(fixed[1])
            else:
                cols.append(np.sort(rng.choice(n_cols, m, replace=False)))
                vals.append(rng.normal(size=m))
        return crow, np.concatenate(cols).astype(np.int32), \
            np.concatenate(vals).astype(np.float32)

    x = rng.normal(size=(n_cols, 20)).astype(np.float32)
    results = {}
    for m in (3, chunk - 1, chunk, chunk + 1, 3 * chunk + 5):
        row = (np.sort(rng.choice(n_cols, m, replace=False)),
               rng.normal(size=m))
        first = csr([m, 5, 2 * chunk, 40], row, 0)
        last = csr([7, 3 * chunk, 1, m], row, 3)
        want = spmv.csr_order_reference(*first, x, chunk)[0]
        same = True
        for cols in (1, 4, 20):
            got = []
            for parts, at in ((first, 0), (last, -1)):
                t = [torch.as_tensor(a, device="cuda") for a in parts]
                xx = torch.as_tensor(x[:, :cols], device="cuda").contiguous()
                if cols == 1:
                    y = spmv.csr_matvec(*t, xx[:, 0].contiguous(),
                                        n_cols)[:, None]
                else:
                    y = spmv.csr_matmul(*t, xx, n_cols)
                got.append(y[at].cpu().numpy())
            same &= bool(np.array_equal(got[0], got[1])
                         and np.array_equal(got[0], want[:cols]))
        results[m] = same
    print(f"order contract (chunk {chunk}): a row first in one CSR and last "
          f"in another gives the same bits, the contract's, in row 9 and "
          f"row 10 (n = 4, 20), by row length: {results}", flush=True)
    check(all(results.values()), f"order contract broken: {results}")


def repeatability_checks(train) -> None:
    """The batched ridge solve of streamed MF (torch.linalg.solve on
    [u, k, k], config 5's k = 4 over 2,048 entities, float32 and
    float64) and the in-core CSRFeatures' four products (bench.py's
    training fixed shard as CSR on the card, through row 9), each 20
    calls bit for bit."""
    import torch

    from photon_ml_tpu_torch.ops.features import csr_from_scipy

    g = torch.Generator(device="cuda").manual_seed(3)
    solves = {}
    for dtype in (torch.float32, torch.float64):
        v = torch.randn((2048, 20, MF_FACTORS), generator=g, device="cuda",
                        dtype=dtype)
        a = torch.einsum("uni,unj->uij", v, v) + torch.eye(
            MF_FACTORS, device="cuda", dtype=dtype)
        b = torch.randn((2048, MF_FACTORS, 1), generator=g, device="cuda",
                        dtype=dtype)
        first = torch.linalg.solve(a, b)
        solves[str(dtype)[6:]] = all(
            torch.equal(torch.linalg.solve(a, b), first) for _ in range(20))
    feats = csr_from_scipy(train.feature_shards["global"], device="cuda")
    x = torch.randn(feats.n_features, generator=g, device="cuda")
    u = torch.randn(feats.n_rows, generator=g, device="cuda")
    products = {}
    for name, call in (("matvec", lambda: feats.matvec(x)),
                       ("rmatvec", lambda: feats.rmatvec(u)),
                       ("row_sq_matvec", lambda: feats.row_sq_matvec(x)),
                       ("sq_rmatvec", lambda: feats.sq_rmatvec(u))):
        first = call()
        products[name] = all(torch.equal(call(), first) for _ in range(20))
    print(f"repeatability, 20 calls bit for bit: batched ridge solve "
          f"[2048, {MF_FACTORS}, {MF_FACTORS}] {solves}; in-core CSR "
          f"products ({feats.n_rows} x {feats.n_features}, row 9) "
          f"{products}", flush=True)
    check(all(solves.values()), "the batched solve does not repeat")
    check(all(products.values()), "an in-core CSR product does not repeat")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--entity-buckets", action="store_true",
                    help="only time the entity-solver kernel per bucket of "
                         "paths 1-5's first updates (an A/B of two trees)")
    ap.add_argument("--fit-digests", action="store_true",
                    help="only fit paths 1-5 and print each fit's digest "
                         "(an A/B of two trees)")
    ap.add_argument("--tree", default=None,
                    help="with --entity-buckets or --fit-digests: the "
                         "repository checkout whose photon_ml_tpu_torch is "
                         "imported and built")
    args = ap.parse_args(argv)
    if args.tree is not None:
        sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    try:
        from photon_ml_tpu_torch.algorithm.coordinates import (
            _gather_block_bounds,
        )
        from photon_ml_tpu_torch.ops import entity_solver
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
    build_kernels()
    if args.entity_buckets:
        entity_buckets(args.tree or ".")
        print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.fit_digests:
        fit_digests()
        print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    train, val = split_data()

    # ---------------- path 1: the headline GLMix, L-BFGS/L2 ----------------
    specs, boxes = path_specs(train)
    specs1 = specs[1]
    result1, launches1, buckets1 = fit_path("path 1", specs1, train, val)
    want1 = {"lbfgs": buckets1["perUser"] * CD_ITERATIONS}
    check(launches1 == want1, f"path 1 launches {launches1} != {want1}")
    check_model(result1, val, "path 1")

    def float32_compute(name, block, args, kw, res_k):
        # The kernel against the plain version, both computing in float32.
        kw32 = dict(kw, compute_dtype=torch.float32)
        k32 = entity_solver.entity_lbfgs(*args, **kw32)
        p32 = entity_solver.entity_lbfgs_plain(*args, **kw32)
        torch.cuda.synchronize()
        return dict(
            kernel_f32_ms=cuda_ms(
                lambda: entity_solver.entity_lbfgs(*args, **kw32), 10),
            device_f32_ms=device_ms(
                lambda: entity_solver.entity_lbfgs(*args, **kw32)),
            f32_reasons_differ=int((k32.reason != p32.reason).sum()),
            f32_iterations_differ=int(
                (k32.iterations != p32.iterations).sum()),
            f32_vs_f64_reasons_differ=int((k32.reason != res_k.reason).sum()))

    rows1 = replay_first_updates("path 1", coordinates_of(train, specs1),
                                 result1.trackers,
                                 extra=float32_compute)["perUser"]
    print("float32 compute, kernel vs plain: "
          f"{sum(r['f32_reasons_differ'] for r in rows1)} of {N_USERS} "
          "entities stop for different reasons, "
          f"{sum(r['f32_iterations_differ'] for r in rows1)} after "
          "different iteration counts; float32 kernel "
          f"{sum(r['kernel_f32_ms'] for r in rows1):.4f} ms a call "
          f"({sum(r['device_f32_ms'] for r in rows1):.4f} ms on the device) "
          f"vs float64 {sum(r['kernel_ms'] for r in rows1):.4f} ms "
          f"({sum(r['device_ms'] for r in rows1):.4f} ms)", flush=True)

    # ------- path 2: TRON fixed effect, elastic-net per-user effect, -------
    # ------- both standardized --------------------------------------------
    specs2 = specs[2]
    result2, launches2, buckets2 = fit_path("path 2", specs2, train, val)
    want2 = {"owlqn+normalized": buckets2["perUser"] * CD_ITERATIONS}
    check(launches2 == want2, f"path 2 launches {launches2} != {want2}")
    check_model(result2, val, "path 2")
    re2 = result2.model.models["perUser"]
    real = [f >= 0 for f in re2.feat_idx]
    zeros = sum(int(((c == 0) & m).sum())
                for c, m in zip(re2.local_coefs, real))
    total = sum(int(m.sum()) for m in real)
    print(f"path 2 per-user coefficients exactly zero: {zeros} of {total}",
          flush=True)
    check(zeros > 0, "path 2: the elastic net gave no exact zeros")
    fold_rows = []

    def lbfgs_with_the_fold(name, block, args, kw, res_k):
        # L-BFGS mode on the same gathered factors and shifts: the fold
        # without OWL-QN (row 2).
        _, _, row = hold_against_plain(
            f"path 2 {name} bucket {len(fold_rows)} lbfgs", args,
            dict(kw, mode="lbfgs"), check_zeros=True)
        row.update(bucket=len(fold_rows), mode="lbfgs+normalized")
        print("bucket " + json.dumps(row), flush=True)
        fold_rows.append(row)

    rows2 = {"owlqn": replay_first_updates(
        "path 2", coordinates_of(train, specs2), result2.trackers,
        extra=lbfgs_with_the_fold, check_zeros=True)["perUser"],
        "lbfgs": fold_rows}

    # ------- path 3: per-entity TRON on fixed, per-user, per-item --------
    specs3 = specs[3]
    result3, launches3, buckets3 = fit_path("path 3", specs3, train, val)
    want3 = {"tron+normalized": buckets3["perUser"] * CD_ITERATIONS,
             "tron": buckets3["perItem"] * CD_ITERATIONS}
    check(launches3 == want3, f"path 3 launches {launches3} != {want3}")
    entities = (("perUser", N_USERS), ("perItem", N_ITEMS))
    check_model(result3, val, "path 3", entities)
    u_lo, u_hi = boxes["perUser"]
    fold_box_rows = []

    def fold_and_box(name, block, args, kw, res_k):
        # TRON with the fold and path 4's per-user box: no path launches
        # this variant, so it is held against the plain version here.
        if name != "perUser":
            return
        bounds = _gather_block_bounds(u_lo, u_hi, block)
        _, _, row = hold_against_plain(
            f"path 3 perUser bucket {len(fold_box_rows)} tron+fold+box",
            args[:10] + bounds, kw)
        row.update(mode="tron+normalized+bounded")
        print("bucket " + json.dumps(row), flush=True)
        fold_box_rows.append(row)

    rows3 = replay_first_updates("path 3", coordinates_of(train, specs3),
                                 result3.trackers, extra=fold_and_box)

    # ------- path 4: box constraints on all three coordinates -------------
    specs4 = specs[4]
    result4, launches4, buckets4 = fit_path("path 4", specs4, train, val)
    want4 = {"lbfgs+bounded": buckets4["perUser"] * CD_ITERATIONS,
             "tron+bounded": buckets4["perItem"] * CD_ITERATIONS}
    check(launches4 == want4, f"path 4 launches {launches4} != {want4}")
    check_model(result4, val, "path 4", entities)
    count_at_bounds("path 4", result4.model, boxes)
    rows4 = replay_first_updates("path 4", coordinates_of(train, specs4),
                                 result4.trackers)

    # ------- path 5: bench.py's full GAME, with the factored effect -------
    specs5 = specs[5]
    result5, launches5, buckets5 = fit_path("path 5", specs5, train, val)
    want5 = {"lbfgs": (buckets5["perUser"] + buckets5["perItem"]
                       + buckets5["itemFactors"] * MF_ITERATIONS)
             * CD_ITERATIONS}
    check(launches5 == want5, f"path 5 launches {launches5} != {want5}")
    check_model(result5, val, "path 5", entities + (("itemFactors",
                                                     N_ITEMS),))
    B = result5.model.models["itemFactors"].projection_matrix
    check(tuple(B.shape) == (MF_FACTORS, D_ITEM)
          and bool(torch.isfinite(B).all()), "path 5: B")
    rows5 = replay_first_updates("path 5", coordinates_of(train, specs5),
                                 result5.trackers)
    latent_shapes = [(r["entities"], r["n_pad"], r["d_pad"])
                     for r in rows5["itemFactors"]]
    print(f"path 5 final: AUC {result5.validation_history[-1]['AUC']:.6f}, "
          f"objective {result5.objective_history[-1]:.6f}, latent buckets "
          f"{latent_shapes}", flush=True)

    # ------- path 15: paths 1-5 through the eager plain loop ---------------
    t0 = time.perf_counter()
    path15(train, val, specs, {
        1: (result1, launches1), 2: (result2, launches2),
        3: (result3, launches3), 4: (result4, launches4),
        5: (result5, launches5)})
    print(f"path 15: {time.perf_counter() - t0:.1f} s", flush=True)

    # ------- paths 6 and 7: the drivers on Avro (rows cut) -----------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_avro_") as tmp:
        t0 = time.perf_counter()
        launches6, rows6 = path6(train, val, specs5, Path(tmp))
        latent_shapes6 = [(r["entities"], r["n_pad"], r["d_pad"])
                          for r in rows6["itemFactors"]]
        print(f"path 6 latent buckets {latent_shapes6}", flush=True)
        print(f"path 6: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        glm_phases = path7(Path(tmp))
        print(f"path 7: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        launches8, p8 = path8(Path(tmp))
        print(f"path 8: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        launches9, mf_held = path9(Path(tmp), p8, glm_phases)
        print(f"path 9: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        launches10, per_graph, figures10 = path10(Path(tmp))
        print(f"path 10: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        launches11 = path11(Path(tmp), val)
        print(f"path 11: {time.perf_counter() - t0:.1f} s", flush=True)
        launches12 = path12(Path(tmp), per_graph, figures10)
        launches13 = path13(Path(tmp), p8, train, val, specs5, result5)
        launches14 = path14(Path(tmp), p8, train, val, specs5, result5)
        launches16 = path16(Path(tmp), train, specs1)
    t0 = time.perf_counter()
    glm_full_width(train)
    print(f"glm full width: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches_stream, block = stream_full_width(train)
    spmv_row = spmv_entry(block, launches8 + launches_stream + launches10
                          + launches11 + launches12 + launches13["row9"]
                          + launches14["row9"])
    print(f"stream full width: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches_grid, block = grid_full_width(train)
    spmm_row = spmm_entry(block, launches9 + launches_grid
                          + launches13["row10"] + launches14["row10"],
                          mf_held)
    order_contract_check()
    repeatability_checks(train)
    print(f"grid full width: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    gather_entries = gather_phase()
    print(f"gather phase: {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = [
        kernel_entry("entity_lbfgs[lbfgs] (row 1)", rows1,
                     launches1.get("lbfgs", 0) + launches5.get("lbfgs", 0)
                     + launches6 + launches13["entity"].get("lbfgs", 0)
                     + launches14["entity"].get("lbfgs", 0)),
        kernel_entry("entity_lbfgs[normalization fold] (row 2)",
                     rows2["lbfgs"],
                     sum(n for launches in (launches2, launches3)
                         for v, n in launches.items()
                         if "+normalized" in v)),
        kernel_entry("entity_lbfgs[bounded lbfgs] (row 3)",
                     rows4["perUser"], launches4.get("lbfgs+bounded", 0)),
        kernel_entry("entity_lbfgs[owlqn] (row 4)", rows2["owlqn"],
                     launches2.get("owlqn+normalized", 0)
                     + launches16.get("owlqn", 0)),
        kernel_entry("entity_lbfgs[tron] (row 5)",
                     rows3["perUser"] + rows3["perItem"],
                     launches3.get("tron", 0)
                     + launches3.get("tron+normalized", 0)),
        kernel_entry("entity_lbfgs[bounded tron] (row 6)", rows4["perItem"],
                     launches4.get("tron+bounded", 0)),
        *gather_entries,
        spmv_row,
        spmm_row,
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
