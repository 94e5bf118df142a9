#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

Run from the repository root:  python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero before the final line):

1. print the card (``nvidia-smi`` name and power limit) and build every
   CUDA kernel of the port from ``tpu_als_torch/csrc`` (one nvcc per
   source, all started together), then the native bucketizer and CSV
   reader from ``tpu_als_torch/io/native`` (g++), all into
   ``tpu_als_torch/_build/``;
2. K2 (batched SPD solve, rank <= 128), K1 (tiled SPD solve, any rank)
   and K6 (tiled factorization above rank 128, written over its input,
   and its fused solve) against their plain versions on random SPD
   batches ``M Mᵀ/r + 0.5·I``, with b = 0 rows and a near-singular row,
   and x against a float64 solve: K2 at ranks 10, 64, 128; K1 at 10,
   128, 256, 288 (the most one block's shared memory holds), 323 and 384
   (streamed), in batches of 1, 27 and 4,096; K6's L entry by entry at
   136, 256, 288, 289 and 384 (on chip, then streamed), its storage
   holding L afterwards, then the fused entry (the same L in A's storage,
   x against its plain version and float64); then the adaptive ladder
   (``solve_spd(adaptive=True)``, ``solve_spd_checked``, jitter 0)
   through K2 and K1 at rank 128 and K6 at rank 256 on 4,096 systems, 512
   of them hostile (rank-deficient, or indefinite within the last rung):
   the healthy rows bitwise the plain solve, every row within the
   residual rule, 7 NaN rows raising ``SolveUnstable(7, 4096)``, and the
   ladder's time beside the plain solve's on a healthy batch;
3. K5 (fused score GEMM + top-k, ``csrc/topk.cuh``'s scan) against its
   plain version over the full 59,047-item catalog with ~10 % of items
   invalid, at ranks 40, 128, 256 and 320 (the query rows resident in
   shared memory at all four), k = 1, 10 and 128, n = 4,096 and 8,229
   (not a multiple of the 64-row user tile), the catalog split in the
   parts ``topk_parts`` picks, in 1 and in 7; then on a catalog smaller
   than k (sentinel slots exact) at 1 and 3 parts;
4. K3 (gather + Gram) and K4 (gather + Gram + tail + solve) against
   their plain versions (``V[cols]`` + ``torch.bmm``, K2's plain solve)
   at rank 128, then at ranks 200 and 256, then above 256 (the Gram
   staged by strips, the solve on a thread-block cluster above 288) at
   257, 320, 333, 384 and 512 and K3 also at 640: two- and one-sided, f32 and bf16 tables, widths
   24, 100 (rank 128), 512 and a row wider than the trainer's split
   width (K3's split path; K4 above rank 128 too); empty rows, duplicate
   columns and an implicit row with no positive rating (K4: exactly 0);
   K4 and K7 at rank 640 raising ValueError (the reference's
   TileBudgetError bound); K4's cluster solve pass at ranks 289, 320,
   333 (unaligned rows), 384, 448 and 512, f32 and bf16, explicit and
   implicit: its cluster size and shared bytes a block as the card
   reports them (``cudaFuncGetAttributes``, the mirror
   ``cuda_gather_ne._cluster_plan``), x bit for bit K1's streamed entry
   (``stream_solve``) on the A the tail forms from K3's Gram of the same
   rows, the empty and no-positive rows exactly 0; K7 (K4 over S shards in ring order) against
   its plain version at ranks 128, 200 and 256, S = 1, 3 and 4 shards,
   and at 512, S = 1 and 4, explicit and implicit, f32 and bf16, also
   with a split width of 64 below S·w (the width split's three passes,
   the plain version chunked the same way), and at S = 1 and no split
   against K4 bit for bit; K8 (the cross-shard top-k merge) against its plain version and
   the whole-catalog plain top-k, bitwise, on the integer tie corpus at
   4,096 users x 59,047 items, S = 1, 3, 4 and 8, k = 10 and 128, each
   shard in the parts ``topk_parts`` picks, in 1 and in 32 // S, with a
   sparse validity mask and an all-invalid shard; then past 32 shards (S
   = 33 and 64, a shard a part, the merge's lanes holding several
   shards' heads), launched each time (``MERGE_LAUNCHES``);
5. the training slice at the full ML-25M shape (162,541 users x 59,047
   items x 25,000,095 ratings, ``synthetic_movielens``): the bucketed
   layout both ways, by the native bucketizer and by numpy (host
   seconds each, array-equal; the fits train on the native layout;
   numpy's made in the CPU cross-validation's wait after phase 13b (c),
   so its seconds are taken beside that process, the native one timed
   after the wait with no other process at work), each bucket's route; the frame written as a 25M-line ``ratings.csv`` and
   read back by the native reader (equal to the frame) and, on its first
   1M rows, by the Python twin (equal), rows a second each; then
   ``ALS(rank=128, implicitPrefs=True, alpha=40.0, regParam=0.01,
   maxIter=3).fit`` on the card with K1/K3/K4 launch counts read around
   it, per-iteration wall time, finite factors, and one iteration from
   one init through 'auto' (K4 + K3/K1) against 'unfused' (torch gather
   + bmm + K2), row by row, with each route's distance from a float64
   solve of the heaviest rows; then the same at rank 256 (BASELINE
   config 3's width) on the same data and layout: K3/K4/K6 launch
   counts, and 'auto' (K4 + K3/K6) against 'unfused' (torch + K6); then
   sharded training on 4 logical shards on the card: the ring's owner x
   source grid (host seconds, padded entries), ``train_sharded(...,
   strategy='ring')`` with ``solve_backend='gather_fused_ring'`` (K7) for
   2 iterations from the init of a 2-iteration single-device fit, row by
   row against it, and one iteration of the unfused ring (K2); then rank
   512, the widest the reference's K4 takes: ``ALS(rank=512, ...,
   maxIter=2).fit`` (K4 on every narrow bucket, K3 + K6 streamed on the
   wide ones, no K1 or K2: no einsum route, counted), one iteration
   'auto' against 'unfused' (torch + K6), the item half-step's widest
   rows against float64, and K7's item half-step on the 4-shard ring
   grid against K4's from the same init; then ``ALS(rank=320).fit`` on
   a 2000 x 800 x 40000 frame (K4 alone) with one more item half-step
   against a float64 solve; then the guardrails at rank 128: ``guardrails='recover'`` under
   ``solve.gram=corrupt@nth=2`` (one rollback, finite factors, the
   implicit objective within RECOVER_OBJ_REL of the clean fit's, the
   factors row by row against the rollback replayed without the
   guardrails, and two faulty replays shown to fall outside; K3 +
   K1/K2 launched, no K4), ``'warn'`` under the same fault (a trip, no
   rollback; K4 + K3 + K1), a clean ``'recover'`` fit against the
   guardrails-off fit row by row, the iteration wall of each mode, and a
   fit on ratings poisoned with NaN, inf, 1e9 and -2e6, quarantined with
   the exact count;
5b. elastic training and the rest of the sharded path on phase 5's 4
   logical shards at ML-25M, rank 128, implicit (budget 100 s): (a) one
   iteration each of 'all_gather', 'all_gather_chunked' (K2) and
   'all_to_all' (K4, K3 + K1; its plans built with
   ``on_degenerate='build'``, R, padding ratio and degeneracy logged)
   from one injected init, the latter two row by row within TRAIN_REL of
   'all_gather', with 'auto''s pick and each strategy's
   ``comm_bytes_per_iter``; (b) ``ALS(rank=128, maxIter=3, mesh=...,
   gatherStrategy='all_to_all', elastic=True, checkpointDir=...,
   checkpointInterval=1)`` under ``mesh.device_lost=corrupt@nth=3``:
   one ``device_lost``, ``mesh_reformed`` and ``elastic_resume`` each,
   ``train.reformations`` 1, ``lastFitStrategy`` logged, the recovery's
   wall, K4 launched, and the result bitwise (or within RESUME_ABS) a
   fault-free 3-shard fit resumed from the same checkpoint; (c) K7's
   ring step under ``comm.ring_step``: ``FactorsCorrupt`` (corrupt),
   ``InjectedFault`` (raise), the raw step disarmed, the armed wrapper's
   extra wall; (d) ``topk_sharded`` over the full catalog clean (K8),
   then under ``serve.gather=raise@once`` degraded through K5 within
   K5_TOL, ``serve.degraded`` 1, and a fresh mesh (other logical ids)
   raising ``ServeShardLost``;
6. the serving slice at the ML-25M shape (rank 128, implicit, alpha 40,
   regParam 0.01) from seeded random factors: save/load,
   ``FoldInServer.update`` on hourly-style batches of 4,096 users (half
   new), ``update_items`` on 512 items, then ``recommendForUserSubset``,
   ``recommend_arrays`` for all users and ``transform`` on 100k pairs;
   K2/K5 launch counts are read around this run; then at rank 256 the
   fitted factors through ``model_from_arrays``, save/load, two fold-in
   batches of 4,096 users (K6) and recommend-all (K5 at r = 256); then
   ``recommend_arrays(10, mesh=4 logical shards,
   gatherStrategy='merge_ring')`` (K8) for every user of the rank-128
   fit, against the single-device K5 sweep; then k = 200, above K5's
   128 (the scan route, counted), single-device and over the mesh, each
   id earning its score; and k = 0 (empty results, no launch);
7. model selection and evaluation (the Spark ML surface and the fit's
   checkpoint lifecycle): (a) examples/02's workflow at BASELINE config
   1's shape (943 x 1,682 x 100,000, string ids): ``Pipeline([
   StringIndexer, StringIndexer, ALS(maxIter=10)])`` under
   ``CrossValidator(numFolds=3)`` over rank {10, 128} x regParam {0.05,
   1.0} on the card and with ``device='cpu'`` (the CPU's in a process
   started after the build, beside phases 2-4, and waited for before
   phase 5's host work; every fold's metric within
   SELECT_METRIC_REL, the same best index), the CrossValidatorModel saved
   and loaded back as a PipelineModel (transform equal bit for bit),
   ``recommendForAllUsers(10)`` mapped back by ``IndexToString``; (b) the
   headline, RMSE on MovieLens-25M: ``TrainValidationSplit(0.8)`` over
   explicit ``ALS(rank=128, maxIter=3)`` x regParam {0.05, 0.1} on phase
   5's frame (both RMSEs finite and below the training mean's, the best
   the argmin, each fit's log-to-model time), then ``evaluate``'s ranking
   protocol on the validation split (precision@10 above a random
   ranking's); (c) ``legacy.ALS.train(rank=10, iterations=10)`` on the
   card against the CPU, and ``recommendProductsForUsers(10)``; (d) the
   ``tune`` and ``evaluate`` commands, their JSON against this process's;
   (e) ``train`` at rank 128 stopped by ``TPU_ALS_PREEMPT_AT=3`` (exit
   43) and finished by ``--resume auto``, and a torn save
   (``checkpoint.write=corrupt``) quarantined with ``.old`` resumed, both
   against an uninterrupted fit.  K1/K3/K4/K5 launches are counted from 0
   around (a), (b) and (c);
8. the serving engine (``tpu_als_torch/serving``) at the rank-128 fit's
   full width (162,541 users x 59,047 items): the operand shapes
   ``torch._int_mm`` takes on the card; (a) the int8 candidate index
   (shortlist 64) against the exact top-10 on 4,096 users (every id
   earning its score, the surviving rows within SERVE_ULPS of the plain
   f32 top-k and within K5_TOL of K5, the share of K5's top-10 that
   survives; the whole catalog as the shortlist on 8 users), then the
   shortlist GEMM's time beside its bound and the int8 and K5 top-10
   times at 4,096 and 128 users; (b) ``with_updates`` on 512 touched
   and 64 appended items and ``compact``, bitwise a rebuild; (c)
   ``ServingEngine`` ('local'): publish, warmup and the serve-bench
   open loop in process, 3,000 requests at 1,500 a
   second on the int8 route (no K5 launch), then 1,000 on the exact
   route (K5 launched), p50/p99 of ``serving.e2e_seconds`` and
   ``serving.score_seconds`` and the shed count; (d) a torn second
   publish (``serving.publish=corrupt``) answered exact with
   ``serving.fallback_exact`` counted, ``serving.score=raise`` failing
   the waiting ticket; (e) 'sharded' and 'merge_ring' on 4 logical
   shards against the local engines (K8 launched), then one
   ``publish_update`` through the merge-ring scatter; (f)
   ``foldin-bench`` on phase 6's served model (K2 counted in its process)
   and a short ``serve-bench``, as processes, their JSON parsed;
9. the stream and the live loop: (a) and (b) run inside phase 5, while
   its ``ratings.csv`` exists: (a) the 25M-row file through the string-id
   stream reader (``io/stream.py``) as one host and as 4 byte-range hosts
   (``ingest_per_host`` + ``merge_vocabularies``), both equal to the
   native reader's columns row for row once the labels are decoded back
   to integers, rows a second; (b) ``train --data stream:PREFIX`` (the
   first 1M rows) at rank 128, K4 and, on its rows wider than the split
   width, K3 + K1 counted in the process, its ``stream_labels.npz``
   equal to the stream's vocabularies, then ``evaluate`` through the
   sidecar and ``recommend --foldin-data stream:`` on new string ids
   (string ids out, K2 and K5 counted), side by side.  After phase 8:
   (c) ``LiveUpdater`` over ``FoldInServer(keep_history=False)`` on the
   rank-128 fit's factors beside the engine's open loop of 4,500 requests
   at 1,500 a second, 600 rating events at 200 a second, 1 % NaN, once on
   an engine started exact (its first live publish builds the int8
   index, as the reference's ``publish_update`` does) and once on int8
   with ``fold_items`` (every publish a delta): every event folded or
   quarantined, nothing shed, no ``warning`` event, K2 (and on the exact
   start K5) launched, the published U/V bitwise the fold-in model's, 256
   touched users' top-10 ids equal to K5's on the new factors with scores
   within K5_TOL of K5 and SERVE_ULPS of the plain f32 top-k, freshness
   and serving e2e p50/p99 beside phase 8's; (d) two same-shaped tenants
   (the fit's factors, weight 3, and seeded unit rows, weight 1) on the
   exact route behind ``MultiTenantEngine``: one shape class,
   ``serving.score=raise`` failing only the first-picked tenant's
   tickets, then 2,048 requests each under contention (served rows equal,
   virtual time 1:3, K5 launched, each tenant's answers K5's on its own
   catalog, no other batch error or warning); (e) ``serve-bench
   --update-qps 200 --update-items`` and ``serve-bench --tenants 2
   --update-qps 100`` at the full catalog, as processes side by side,
   their JSON keys the reference's (``LIVE_BENCH_SHAPE``,
   ``TENANT_BENCH_SHAPE``);
10. the two-tower model (BASELINE config 5, ``bench.py::run_twotower``'s
   workload) and the rest of ``train``'s command line: 20,000 users x
   4,000 items x 800,000 synthetic ratings, the positives (r >= 3.5) with
   10 % held out; (a) the ALS warm start through ``core.als.train``
   (rank 32, 8 iterations, implicit, alpha 20, regParam 0.005; K4, and
   K3 + K1 on rows wider than the split width, counted); (b)
   ``train_two_tower`` (embed 32 -> hidden 64 -> out 32, batch 4,096)
   warm, then cold, 20 epochs each: filtered recall@10 at epochs 1, 3,
   5, 10 and 20 (warm also with ``serving_bias``), each epoch's wall
   without the evaluation, then the warm model's unfiltered recall@10
   through K5 (counted), and the same users' top-10 by K5 and by the
   plain chunked scan on the card, every id earning its score; (c) the
   warm run's first epoch again on the CPU from the same init and
   permutation, per-step losses within TT_LOSS_RTOL, after one more
   epoch under the profiler (kernels, busy and idle a step); (d)
   ``tt-train`` at that shape (5 epochs, its keys the reference's, its
   save loaded) and ``train --log-file --profile-dir`` at rank 128 on
   phase 9's 1M-row prefix, side by side, then ``observe summarize
   --json`` (three iterations with finite ``probe_rmse``; the
   ``cli.train``, ``data.load``, ``train.block`` and ``train.fit``
   phases) and ``observe tail``, as processes; the profiler's trace
   names K4's kernel;
11. the measurement tools and the sharding flags on phase 5's rank-128
   ML-25M containers and phase 9's 1M-row prefix (budget 60 s): (a)
   ``perf.attribution.measure_attributed`` ('auto': K4, K3 and K1
   counted) with its stages covering at least 90 % of the decomposed
   wall, the gap table against ``perf.roofline.roofline(ne_path='auto')``,
   the production iteration beside phase 5's and the stage model's floor
   beside the real-entry bound; ``observe attribution --obs-dir`` (the
   ``attribution`` event and ``train.stage_seconds`` in its run
   directory) and ``observe roofline --json`` as processes, the two
   timed measurements one after the other with nothing else at work
   (the CLI's processes start after the first, gated: they import
   beside (b) and touch the card only once released);
   (b) ``perf.ne_audit.gather_out_bytes`` on CUDA tensors, exactly
   n·w·r·4 on an 'unfused' item bucket and 0 on a K4 and a K3 bucket,
   and ``kernel_cost_bytes`` equal to the roofline's closed forms summed
   over the calls, whose number is held too; (c)
   ``train --devices 4 --gather-strategy all_gather --elastic`` and
   ``recommend --devices 4 --gather-strategy ring`` as processes (K4, K3
   and K1, then K5, counted in them), the model within TRAIN_REL of the
   same 4-shard fit in this process and every user's top-10 that of
   ``recommend_arrays(mesh=)``;
12. the execution planner on phase 5's rank-128 ML-25M containers, in a
   directory of its own (budget 40 s): (a) a cold ``plan.resolve_kernel_
   config(rank=128, tune=True)`` with the synthetic timer (one
   ``local_half_step`` on ~4.2M entries, min of 3): 8 trials, each with
   its time beside ``autotune.model_seconds`` and K4, K3 and K1 launched
   in each, the bank ``source="device"``; (b) ``plan tune --rank 128
   --obs-dir`` as a gated process started before (a): ``plan_cache_hit``
   and no ``tune_trial`` in its trail, (a)'s config, no kernel launched;
   (c) the fit's own tune (``TPU_ALS_AUTOTUNE=1``, ``core.als.train``
   with no iteration from phase 5's init): 8 trials of one ML-25M
   iteration each, K4, K3 and K1 launched, each beside its model, banked
   under the problem's shape class; then one tuned iteration reading it
   back: each bucket's route at the banked split width (K4 and K3
   counted per bucket and chunk), its time beside phase 5's iterations
   and an untuned iteration's in the same phase, its factors within
   TRAIN_REL of the untuned iteration; (d) a planner-off iteration
   (``TPU_ALS_PLAN_CACHE=off``): phase 5's route labels and launches per
   iteration, and factors bitwise those of an armed iteration with the
   gate off; (e) at rank 256, ``space={"split_width": [8192, 16384]}``:
   2 trials, each launching K4, K3 and K6.  Every process the run starts
   gets a fresh plan cache of its own (so a ladder ``serve-bench`` banks
   never reaches a later phase), except (b), which shares (a)'s;
13. two processes on the one card (budget 90 s): each holds 2 logical
   shards of a 4-position mesh on ``cuda:0`` and an interleaved half of
   phase 5's ML-25M triples, joined over gloo (a ``file://`` store),
   CUDA tensors staged through host memory; started gated (imports and
   loads beside the single-process reference's build, nothing timed
   beside them): (a) ``ALS(mesh=, dataMode='per_host',
   gatherStrategy='all_gather', maxIter=2)`` from phase 5's init (a
   checkpoint at iteration 0) at rank 128, implicit, each process's
   iteration wall, bytes staged a half-step, collective share and
   K4/K3/K1 launches, the gathered factors against the single-process
   4-shard fit of the same triples from the same init (bitwise
   expected); (b) the sharded checkpoint both wrote, read here by
   ``load_factors``, equal to (a)'s factors; (c) ``topk_sharded(...,
   'all_gather')`` for 4,096 users through K5 in both, ids equal to the
   single-process K5's, scores within SERVE_ULPS;
13b. the analysis layer, run beside phase 7(a)'s CPU cross-validation
   once phases 2-4 are done and phase 5's frame is drawn (nothing in
   it is timed against the card), in two parts of 60 s each: (a)
   ``python -m tpu_als_torch.cli lint`` over the port's tree as a
   process, exit 0 (its wall printed), and beside it (b) ``lint
   --contracts`` on the card in this process: each of the ten
   contracts' verdict line, all OK, K1, K3, K4, K7 and K8 launched
   (counted around it), while (c)'s two processes start and block
   their containers, gated; then (c), released: one logical shard each
   on the card, rank 128, implicit, on phase 9's 1M-row prefix (the
   frame's first 1M rows), one iteration of every multi-process
   strategy ('all_gather', 'all_gather_chunked', 'ring', 'all_to_all';
   'ring_overlap' is the ring's own step across processes and is
   audited with it) under ``parallel/comm_audit.py::collective_bytes``,
   the audited bytes printed beside ``comm_bytes_per_iter`` and
   required equal, each iteration's wall beside; and after phase 12,
   (d) ``floor_audit`` against the bank phase 12's ``plan tune``
   process wrote with ``--bank-out``;
13c. K7 and K8 across two processes on the one card over CUDA IPC
   (budget 60 s, in the CPU cross-validation's wait after 13b (c); its
   two processes start gated beside 13b (a)-(b)): 2 logical shards each
   (4 positions), rank 128, implicit, on phase 9's 1M-row prefix from
   an injected init, so every K7 and K8 launch mixes local and mapped
   pointers (``parallel/peer.py``): (a) ``train_multihost(...,
   solve_backend='gather_fused_ring', strategy='ring')``, 2 iterations,
   the gathered factors bitwise the single-process 4-shard K7 fit of
   the same triples (run here first), each process's iteration walls
   and K7 launches beside 13b (c)'s 'ring' and 'all_gather' walls, its
   declared payload (``comm_audit.remote_dma_bytes``) equal to
   ``comm_bytes_per_iter('gather_fused_ring')`` and printed beside
   'ring''s; (b) ``topk_sharded(..., 'merge_ring')`` for 4,096 users,
   k = 10 (K8's scan-to-sets and merge-from-sets), ids and scores
   bitwise the single-process K8's over the same 4 shards, within
   K5_TOL of its plain version; (c) every mapping closed and every
   buffer freed, both processes exiting 0; then each process, in turn,
   times K7 over mapped shards (the item half-step) and K8's two
   halves beside their plain versions, for two rows of the kernels
   line;
14. the scenarios and the soak on the card (budget 100 s), nothing else
   at work beside them (they are judged against wall-clock SLOs): (a)
   ``python -m tpu_als_torch.cli soak --rank 128 --device cuda --obs-dir
   DIR --json`` as a process (started gated; the reference's other
   defaults: 8 windows of 3 s, both CLI chaos children on the card, all
   six injections): exit 0, the verdict passed, all six injections fired
   and recovered, K2, K4 and K5 launched in it, and then the port's
   ``tpu_als_torch/soak/verdict.py DIR`` and the reference's stdlib
   ``tpu_als/soak/verdict.py DIR`` as processes, each exiting 0 with the
   run's own checks; (b) ``run_scenario`` in this process on the card
   for traffic-spike, torn-publish, cold-start and tenant-isolation at
   rank 128 (the reference's other defaults), every assertion held, each
   one's wall and K2/K4/K5 launches printed, and the kernels of its path
   launched (K5 in all four; K2 and K4 where it fits and folds in); (c)
   ``scenario list`` as a process, beside (a)'s import: exit 0, the
   twelve names, no kernel library loaded and CUDA never initialized;
15. timings at the slices' shapes (CUDA events), each kernel beside its
   plain version, its library yardstick and its bound (K5 at ranks 128
   and 256); recommend-all three ways at both ranks (host clock, results
   on the host): ``recommend_arrays(10)`` (one K5 call),
   ``recommendForAllUsers(10)`` (blocks of ``blockSize`` 4,096 users, a
   K5 call each) and the fold-in batch's ``recommendForUserSubset``; K4
   and K3 held
   against their plain versions once more on the item half-step's
   buckets (widths up to 2^13, and the wide rows split), at ranks 128,
   256 and 512; K1 (rank 128) and K6's fused entry (ranks 256 and 512)
   launch by launch on the item half-step's wide buckets, as the fit launches them,
   summed per half-step, and K6's fused entry on the rank-256 fold-in
   batch, each beside the first port's route (K6's factor, then two
   ``solve_triangular``), ``linalg.cholesky`` + ``cholesky_solve`` and K1
   on the same systems; K7 over
   the sharded item half-step's ring grid (each bucket's time, every
   bucket held to K4's band against its plain version chunked the same
   way) beside the unfused ring half-step, at ranks 128 and 512, after K7 == K4 bitwise at one
   shard on the single-device item half-step's K4 buckets and K7 within
   K4's band of the wide route (K3 + tail + K1) on its K3 buckets; K8 at
   the sharded serving shape beside its plain version and a matmul +
   stable sort; where K4's time goes on its buckets at ranks 128, 256 and
   512 (K3's Gram, K1, K6's fused entry up to rank 256, K2 at rank 128,
   and K4 itself, bucket by bucket, the systems built in chunks of at
   most 4 GiB: at rank 512 K1 is ``stream_solve``, the anchor of K4's
   cluster solve pass, whose time is K4's less K3's Gram); each bucket's
   time in both half-steps, and one iteration beside its bound;
16. where the time goes: one training iteration, one more fold-in
    batch and one all-users recommend, one rank-256 iteration and
    fold-in batch, and one rank-512 iteration, then the serving engine's
    batches of 8 on its int8
    and exact routes, under ``torch.profiler`` (wall, device busy, idle
    share, top kernels); then one JSON line with every kernel's numbers
    (K3, K4 and K5 at rank 256 named so, and K3, K4, K6 and K7 at rank
    512; K1's and K6's fit rows in ms per item half-step, K6's fold-in
    row per batch), and the final
    ``{"ok": true, ...}`` line.

Bounds come from ``tpu_als_torch/perf/roofline.py`` (its kernel bounds
count what the inputs need: real entries and real rows), at NVIDIA's
H100 SXM data sheet rates: 3.35 TB/s of HBM, 67 TFLOP/s in float32
outside the tensor cores, and for the Gram that K3, K4 and K7 run and
the score GEMM that K5 and K8 run on the tensor cores in the 3xTF32
form, three TF32 products per f32 product at 495 TFLOP/s (dense TF32);
the int8 shortlist GEMM (a library call, not a kernel of the port) at
1,979 TOP/s (dense int8).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

from tpu_als_torch import _build, obs, plan
from tpu_als_torch.analysis import contracts
from tpu_als_torch.api import legacy
from tpu_als_torch.api.estimator import ALS, ALSModel
from tpu_als_torch.api.evaluation import RegressionEvaluator
from tpu_als_torch.api.pipeline import (IndexToString, Pipeline,
                                        PipelineModel, StringIndexer)
from tpu_als_torch.api.tuning import (CrossValidator, CrossValidatorModel,
                                      ParamGridBuilder, TrainValidationSplit)
from tpu_als_torch.cli import open_loop, ranking_eval
from tpu_als_torch.convert import entity_rows, model_from_arrays, slot_rows
from tpu_als_torch.core import als as core_als
from tpu_als_torch.core.foldin import normal_eqs
from tpu_als_torch.core.ratings import IdMap, build_csr_buckets, remap_ids
from tpu_als_torch.io import _native_build, fastbucket, fastcsv
from tpu_als_torch.io.movielens import (ML25M_SHAPE, load_movielens_csv,
                                        synthetic_movielens)
from tpu_als_torch.io.ratings_csv import load_ratings_csv as csv_twin
from tpu_als_torch.io.stream import ingest_per_host, stream_ingest
from tpu_als_torch.live import LiveUpdater
from tpu_als_torch.ops import cuda_gather_ne, cuda_lanes, cuda_solve
from tpu_als_torch.ops import cuda_lanes_blocked, cuda_topk
from tpu_als_torch.ops import solve as ops_solve
from tpu_als_torch.ops.solve import (compute_yty, implicit_weights,
                                     regularize, solve_spd)
from tpu_als_torch.ops.topk import NEG_INF, chunked_topk_scores
from tpu_als_torch.parallel import comm_audit, serve
from tpu_als_torch.parallel.a2a import build_a2a
from tpu_als_torch.parallel.comm import (ring_fused_half_step,
                                         ring_half_step, shard_csr_grid)
from tpu_als_torch.parallel.data import partition_balanced, shard_csr
from tpu_als_torch.parallel.mesh import make_mesh
from tpu_als_torch.perf import autotune
from tpu_als_torch.perf.attribution import (attribution_report,
                                            measure_attributed,
                                            render_attribution)
from tpu_als_torch.perf.ne_audit import gather_out_bytes, kernel_cost_bytes
from tpu_als_torch.perf.roofline import (HBM_BYTES_PER_S, INT8_OPS_PER_S,
                                         bound_note, fused_ne_kernel_bytes,
                                         fused_solve_bound,
                                         fused_solve_bytes,
                                         fused_solve_kernel_bytes, gram_bound,
                                         gram_bytes, gram_flops, gram_work,
                                         roofline, solve_bound, topk_bound)
from tpu_als_torch.parallel.trainer import (FactorsCorrupt,
                                            comm_bytes_per_iter,
                                            make_a2a_step,
                                            make_chunked_gather_step,
                                            make_ring_step,
                                            make_sharded_step,
                                            stacked_counts, train_sharded)
from tpu_als_torch.resilience import elastic, faults, guardrails
from tpu_als_torch.serving import ServingEngine, build_index
from tpu_als_torch.stream.microbatch import FoldInServer, pack_rows
from tpu_als_torch.tenancy import MultiTenantEngine, TenantSpec
from tpu_als_torch.utils.frame import ColumnarFrame
from tpu_als_torch.utils.platform import pin_fp32

N_USERS, N_ITEMS, RANK = 162_541, 59_047, 128   # ML-25M serving shape
RANK256 = 256                                   # BASELINE config 3's width
RANK512 = 512                   # the widest rank the reference's K4 takes
SOLVE_BOUND_RANK = 640          # r_pad 640: past the fused solve's bound
# ranks of K4's cluster solve pass held bit for bit to K1's streamed one:
# its first, two 2-block ranks (333: rows not 16-byte aligned), then
# 4-block ones up to the reference's bound
CLUSTER_RANKS = (289, 320, 333, 384, 448, 512)
SPLIT_CHUNK_BYTES = 1 << 32     # k4_split: systems built at a time
SHARDS = 4                                      # logical shards on the card
NEG_INF32 = float(torch.tensor(NEG_INF, dtype=torch.float32))

# stated tolerances
K2_RTOL, K2_ATOL = 1e-4, 1e-5       # well-conditioned batches (K1, K2,
                                    # K6's L, and x against float64)
# K6 on the fold-in's own systems (implicit, alpha 40: L reaches ~1e2):
# max |L - L_plain| relative to max |L_plain|
K6_REL = 1e-5
K5_TOL = 1e-5                       # scores and each id's own U·V
# K3: |S - S_plain| and |b - b_plain| entry by entry, relative to the sum
# of the magnitudes of the entry's terms (b's terms cancel, so its own
# size is no scale).  The plain side's cuBLAS sums each width chunk (up
# to the trainer's split width of same-sign terms) in sequence, which
# drifts ~eps·sqrt(w/3) of their size; the kernel sums in two levels
K3_REL = 5e-5
# K4: the reference's own band for fused vs unfused solves
K4_RTOL, K4_ATOL = 5e-4, 5e-5
TRAIN_REL = 1e-3                    # 'auto' vs 'unfused', per row / ||x||
                                    # (and sharded vs one device)
# K7 vs its plain version: K4's band (the same Gram and tail over S·w
# entries); at one shard K7 must equal K4 bitwise.  K8 vs its plain
# version: bitwise on the integer tie corpus (every score exact).
# Sharded vs single-device recommend-all scores: within SERVE_ULPS units
# in the last place (K8 and K5 compute each score the same way)
SERVE_ULPS = 4
REG, ALPHA = 0.01, 40.0             # the slice's implicit configuration
FOLDIN_REL = 1e-3                   # per row, relative to ||x||
# the adaptive ladder's own rule: x finite and ||(A0 + rung·I)x - b|| <=
# 1e-2·(||b|| + 1) for some rung (ops.solve._ADAPTIVE_TOL)
LADDER_TOL = 1e-2
# the 'recover' fit (one rollback at iteration 2: perturbed last-good
# factors, regParam x 10 for that iteration) against the clean fit: the
# implicit objective after 3 iterations, relative; the retried iteration
# starts 1e-3 off the clean one and ALS pulls both to the same fixed point.
# A coarse bound only: a recovery without the bump reads closer to the
# clean fit than the sound one, so replay_recovery holds the recovery row
# by row and this bound catches only a recovery that went astray
RECOVER_OBJ_REL = 1e-2
FIT_SEED = 0                        # the guarded fits' ALS(seed=)
CSV_TWIN_ROWS = 1_000_000           # the Python twin parses this prefix
PLAN_ENV = "TPU_ALS_PLAN_CACHE"
# the run's plan caches: PLAN_ROOT/run for this process (set first thing
# in main, before anything resolves), a fresh PLAN_ROOT/proc_* for each
# process the run starts, PLAN_ROOT/planner for phase 12
PLAN_ROOT = None
CSV_HEADER = b"userId,movieId,rating,timestamp\n"


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def timed(fn):
    """``(fn(), milliseconds)`` of one call by CUDA events: a plain
    version is timed on the pass that is also checked, not run again."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def unit_rows(rng, n, r):
    x = rng.standard_normal((n, r), dtype=np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


# -- phase 2 ---------------------------------------------------------------
def spd_batch(rng, N, r, dev):
    """Random SPD ``M Mᵀ/r + 0.5·I`` with rows 0..7 of b zero and row 8 a
    near-singular rank-1-plus-small-ridge system."""
    M = torch.from_numpy(
        rng.standard_normal((N, r, r), dtype=np.float32)).to(dev)
    A = M @ M.transpose(1, 2) / r + 0.5 * torch.eye(r, device=dev)
    b = torch.from_numpy(
        rng.standard_normal((N, r), dtype=np.float32)).to(dev)
    b[:8] = 0.0
    v = torch.from_numpy(rng.standard_normal(r, dtype=np.float32))
    A[8] = (torch.outer(v, v) + 1e-4 * torch.eye(r)).to(dev)
    return A.contiguous(), b


def spd_shape(rng, N, r, dev):
    """``spd_batch`` of N systems; below 9 systems, N regular ones (cut
    from a larger batch past its b = 0 rows and near-singular row)."""
    if N >= 9:
        return spd_batch(rng, N, r, dev)
    A, b = spd_batch(rng, N + 9, r, dev)
    return A[9:].contiguous(), b[9:].contiguous()


def x64_err(x, A, b, ok):
    """max |x - x64| on the rows ``ok``, x64 a float64 solve, and whether
    it is within K2_RTOL/K2_ATOL."""
    x64 = torch.linalg.solve(A[ok].double(), b[ok].double()[..., None])[
        ..., 0]
    return ((x[ok].double() - x64).abs().max().item(),
            torch.allclose(x[ok].double(), x64, rtol=K2_RTOL, atol=K2_ATOL))


def check_spd(name, solve, plain, shapes, rng, dev):
    """Kernel vs plain on ``spd_shape``, and x against float64; the
    caller's A must be left as it was; returns the largest error at
    RANK."""
    worst = 0.0
    for r, N in shapes:
        A, b = spd_shape(rng, N, r, dev)
        A0 = A.clone()
        xk = solve(A, b)
        xp = plain(A, b)
        torch.cuda.synchronize()
        ok = slice(9, None) if N >= 9 else slice(None)
        if N >= 9:
            if not (torch.all(xk[:8] == 0) and torch.all(xp[:8] == 0)):
                fail(f"{name} r={r}: b = 0 rows did not solve to 0")
            if not torch.isfinite(xk[8]).all():
                fail(f"{name} r={r}: near-singular row is not finite")
        if not torch.equal(A, A0):
            fail(f"{name} r={r}: the caller's A was written")
        err = (xk[ok] - xp[ok]).abs().max().item()
        if not torch.allclose(xk[ok], xp[ok], rtol=K2_RTOL, atol=K2_ATOL):
            fail(f"{name} r={r} N={N}: kernel vs plain max |diff| {err:.3e}")
        e64, fine = x64_err(xk, A, b, ok)
        if not fine:
            fail(f"{name} r={r} N={N}: x vs float64 max |diff| {e64:.3e}")
        log(f"{name.lower()} r={r} N={N}: max |kernel - plain| {err:.3e}, "
            f"|x - x64| {e64:.3e} (rtol {K2_RTOL}, atol {K2_ATOL})")
        if r == RANK:
            worst = max(worst, err)
        del A, A0, b, xk, xp
    return worst


def check_k2(rng, dev):
    return check_spd("K2", cuda_lanes.spd_solve_lanes,
                     cuda_lanes.chol_solve_plain,
                     ((10, 4096), (64, 4096), (128, 4096)), rng, dev)


def check_k1(rng, dev):
    """K1 at ranks 10, 128, 256, the 288 one block holds, 323 (the first
    port's reach) and 384 (streamed), in batches of 1, 27 and 4,096."""
    return check_spd("K1", cuda_solve.spd_solve_blocked,
                     cuda_lanes.chol_solve_plain,
                     ((10, 4096), (128, 4096), (128, 27), (128, 1),
                      (256, 512), (256, 1), (288, 27), (323, 256),
                      (384, 27), (384, 1)), rng, dev)


def check_k6(rng, dev):
    """K6's two entries vs their plain versions on ``spd_batch``: the
    factor, L entry by entry (it is written over A, so A's storage must
    hold L afterwards, zeros above the diagonal), then the fused solve:
    the same L in A's storage, x against its plain version and a float64
    solve.  Ranks 136, 256, the on-chip limit 288, one past it (289,
    streamed) and 384; returns the largest error of L at rank 256."""
    worst = 0.0
    lim = cuda_solve.ONCHIP_MAX_RANK
    for r, N in ((136, 512), (256, 4096), (lim, 512), (lim + 1, 256),
                 (384, 256)):
        A, b = spd_batch(rng, N, r, dev)
        Ak = A.clone()
        ptr = Ak.untyped_storage().data_ptr()
        L = cuda_lanes_blocked.chol_lanes_blocked(Ak)
        Lp = cuda_lanes_blocked.chol_lanes_blocked_plain(A.clone())
        torch.cuda.synchronize()
        if L.untyped_storage().data_ptr() != ptr or not torch.equal(L, Ak):
            fail(f"K6 r={r}: L is not in A's storage")
        if not bool((torch.triu(Ak, 1) == 0).all()):
            fail(f"K6 r={r}: A's storage holds non-zeros above the diagonal")
        if not torch.isfinite(Ak[8]).all():
            fail(f"K6 r={r}: near-singular row is not finite")
        ok = slice(9, None)
        err = (Ak[ok] - Lp[ok]).abs().max().item()
        if not torch.allclose(Ak[ok], Lp[ok], rtol=K2_RTOL, atol=K2_ATOL):
            fail(f"K6 r={r}: kernel vs plain max |diff| of L {err:.3e}")
        del Lp
        Af = A.clone()
        x = cuda_lanes_blocked.spd_solve_lanes_blocked(Af, b)
        xp = cuda_lanes_blocked.chol_lanes_blocked_solve_plain(A.clone(), b)
        torch.cuda.synchronize()
        if not torch.equal(Af, Ak):
            fail(f"K6 r={r}: the fused entry's L in A's storage differs "
                 "from the factor entry's")
        if not torch.all(x[:8] == 0) or not torch.isfinite(x[8]).all():
            fail(f"K6 r={r}: b = 0 rows not 0, or the near-singular row "
                 "not finite")
        ex = (x[ok] - xp[ok]).abs().max().item()
        if not torch.allclose(x[ok], xp[ok], rtol=K2_RTOL, atol=K2_ATOL):
            fail(f"K6 r={r}: fused x vs plain max |diff| {ex:.3e}")
        e64, fine = x64_err(x, A, b, ok)
        if not fine:
            fail(f"K6 r={r}: x vs float64 max |diff| {e64:.3e}")
        log(f"k6 r={r} N={N} ({'on chip' if r <= lim else 'streamed'}): "
            f"max |L - L_plain| {err:.3e}; fused: the same L in A's "
            f"storage, max |x - x_plain| {ex:.3e}, |x - x64| {e64:.3e} "
            f"(rtol {K2_RTOL}, atol {K2_ATOL})")
        if r == RANK256:
            worst = err
        del A, Ak, Af, L, x, xp
    return worst


LADDER_N = 4096       # systems a ladder batch
LADDER_NAN = 7        # rows poisoned with NaN in the SolveUnstable check


def ladder_batch(g, N, r, dev, hostile):
    """``M Mᵀ/r + 0.5·I`` systems with b ~ N(0, 1), rows 0-1 empty (count
    0, b 0); with ``hostile``, every 16th row from 3 on rank-deficient
    (rank r/4, no ridge) and every 16th from 11 on indefinite (r/8
    eigenvalues in [-5e-3, -1e-3], the rest in [0.1, 2]: within the last
    rung's 1e-2).  Returns A, b, count and the hostile rows' index."""
    M = torch.randn(N, r, r, generator=g, device=dev) / r ** 0.5
    A = M @ M.transpose(1, 2) + 0.5 * torch.eye(r, device=dev)
    del M
    b = torch.randn(N, r, generator=g, device=dev)
    count = torch.ones(N, device=dev)
    count[:2] = 0.0
    b[:2] = 0.0
    bad = torch.zeros(0, dtype=torch.long, device=dev)
    if hostile:
        deficient = torch.arange(3, N, 16, device=dev)
        indefinite = torch.arange(11, N, 16, device=dev)
        q, m = r // 4, max(1, r // 8)
        Md = torch.randn(len(deficient), r, q, generator=g, device=dev)
        A[deficient] = Md @ Md.transpose(1, 2)
        Q, _ = torch.linalg.qr(torch.randn(len(indefinite), r, r,
                                           generator=g, device=dev))
        ev = 0.1 + 1.9 * torch.rand(len(indefinite), r, generator=g,
                                    device=dev)
        ev[:, :m] = -(1e-3 + 4e-3 * torch.rand(len(indefinite), m,
                                               generator=g, device=dev))
        A[indefinite] = (Q * ev[:, None, :]) @ Q.transpose(1, 2)
        bad = torch.cat([deficient, indefinite])
    return A.contiguous(), b, count, bad


def ladder_passes(A, b, count, x, rungs):
    """Rows whose x satisfies the ladder's rule for some rung, in
    float64: finite, and ||(A0 + rung·I)x - b|| <= 1e-2·(||b|| + 1)."""
    r = A.shape[-1]
    A0 = torch.where((count <= 0)[:, None, None],
                     torch.eye(r, device=A.device), A).double()
    x64, b64 = x.double(), b.double()
    bound = LADDER_TOL * (b64.norm(dim=-1) + 1.0)
    ok = torch.zeros(len(x), dtype=torch.bool, device=x.device)
    for rung in rungs:
        res = (A0 @ x64[..., None])[..., 0] + rung * x64 - b64
        ok |= torch.isfinite(x).all(-1) & (res.norm(dim=-1) <= bound)
    return ok


def check_ladder(dev):
    """The adaptive ladder (``solve_spd(adaptive=True)`` and
    ``solve_spd_checked``, jitter 0) on the card through K2 (rank 128),
    K1 (``backend='pallas'``) and K6 (rank 256): on a batch with hostile
    rows the healthy rows equal the plain solve bit for bit and every
    row passes the rule, the hostile rows escalating through the same
    kernel; NaN rows raise ``SolveUnstable`` with their exact count; the
    ladder's time against the plain solve on a healthy batch."""
    g = torch.Generator(device=dev).manual_seed(9)
    rungs = (0.0,) + ops_solve.ADAPTIVE_JITTER_RUNGS
    counter = {"lanes": (cuda_lanes, "K2"), "pallas": (cuda_solve, "K1"),
               "lanes_blocked": (cuda_lanes_blocked, "K6")}
    for r, backend in ((RANK, "lanes"), (RANK, "pallas"),
                       (RANK256, "lanes_blocked")):
        mod, name = counter[backend]
        A, b, count, bad = ladder_batch(g, LADDER_N, r, dev, hostile=True)
        plain = solve_spd(A, b, count, jitter=0.0, backend=backend)
        before = mod.LAUNCHES
        x = solve_spd(A, b, count, jitter=0.0, backend=backend,
                      adaptive=True)
        torch.cuda.synchronize()
        launches = mod.LAUNCHES - before
        healthy = torch.ones(LADDER_N, dtype=torch.bool, device=dev)
        healthy[bad] = False
        if not torch.equal(x[healthy], plain[healthy]):
            fail(f"ladder {name} r={r}: healthy rows differ from the plain "
                 "solve")
        at_base = ladder_passes(A, b, count, plain, rungs[:1])[bad]
        ok = ladder_passes(A, b, count, x, rungs)
        if not bool(ok.all()):
            fail(f"ladder {name} r={r}: {int((~ok).sum())} rows fail the "
                 "residual rule after the ladder")
        if launches < 2 or bool(at_base.all()):
            fail(f"ladder {name} r={r}: no row escalated ({launches} "
                 "launches)")
        xc = ops_solve.solve_spd_checked(A, b, count, jitter=0.0,
                                         backend=backend)
        if not torch.equal(xc, x):
            fail(f"ladder {name} r={r}: solve_spd_checked differs")
        Anan = A.clone()
        Anan[torch.arange(LADDER_NAN, device=dev) * (LADDER_N // LADDER_NAN)
             + 5, 1, 1] = np.nan
        try:
            ops_solve.solve_spd_checked(Anan, b, count, jitter=0.0,
                                        backend=backend)
        except ops_solve.SolveUnstable as e:
            if (e.bad_rows, e.total_rows) != (LADDER_NAN, LADDER_N):
                fail(f"ladder {name} r={r}: SolveUnstable({e.bad_rows}, "
                     f"{e.total_rows}), expected ({LADDER_NAN}, "
                     f"{LADDER_N})")
        else:
            fail(f"ladder {name} r={r}: NaN rows did not raise")
        del Anan, A, plain, xc
        Ah, bh, ch, _ = ladder_batch(g, LADDER_N, r, dev, hostile=False)
        t_plain = cuda_ms(lambda: solve_spd(Ah, bh, ch, backend=backend), 5)
        t_ladder = cuda_ms(lambda: solve_spd(Ah, bh, ch, backend=backend,
                                             adaptive=True), 5)
        log(f"ladder {name} r={r} ({backend}): {len(bad)} hostile rows of "
            f"{LADDER_N} ({int((~at_base).sum())} failed the base jitter, "
            f"{launches} {name} launches), every row within the rule "
            f"(tol {LADDER_TOL}), healthy rows equal to the plain solve bit "
            f"for bit; {LADDER_NAN} NaN rows -> SolveUnstable; healthy "
            f"batch: plain {t_plain:.4f} ms, ladder {t_ladder:.4f} ms "
            "(CUDA events around the call, its host sync included)")
        del Ah, bh, ch


# -- phase 3 ---------------------------------------------------------------
def earns_scores(U, V, valid, s, ix, where):
    """Each real slot's id is valid, distinct in its row, and U·V[id]
    equals its score within K5_TOL."""
    real = s > NEG_INF32
    if not bool(valid[ix[real]].all()):
        fail(f"{where}: an invalid item was returned")
    own = (U[:, None, :] * V[ix]).sum(-1)
    diff = (own - s)[real].abs().max().item() if real.any() else 0.0
    if diff > K5_TOL:
        fail(f"{where}: an id does not earn its score ({diff:.3e})")
    srt = torch.sort(torch.where(real, ix, -1 - torch.arange(
        ix.shape[1], device=ix.device)), dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        fail(f"{where}: an id repeats within a row")
    if bool((s[:, 1:] > s[:, :-1]).any()):
        fail(f"{where}: scores are not sorted descending")
    return diff


def check_k5(rng, dev):
    """K5 against its plain version (scores within K5_TOL, each id
    earning its score) at ranks 40, 128, 256 and 320, k = 1, 10 and 128,
    n = 4,096 and 8,229, in the parts ``topk_parts`` picks, in 1 and in
    7; then the sentinel slots of a catalog smaller than k.  Returns the
    largest |score - score_plain| at rank 128 and at rank 256."""
    worst = {RANK: 0.0, RANK256: 0.0}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for r in (40, RANK, RANK256, 320):
        V = torch.from_numpy(unit_rows(rng, N_ITEMS, r)).to(dev)
        valid = torch.from_numpy(rng.random(N_ITEMS) >= 0.1).to(dev)
        for n in (4096, 8192 + 37):
            U = torch.from_numpy(unit_rows(rng, n, r)).to(dev)
            auto = cuda_topk.topk_parts(n, N_ITEMS, 1, sms)
            group = 0.0
            for k in (1, 10, 128):
                sp, _ = chunked_topk_scores(U, V, valid, k)
                for P in (None, 1, 7):
                    sk, ik = cuda_topk.topk_scores(U, V, valid, k, parts=P)
                    torch.cuda.synchronize()
                    err = (sk - sp).abs().max().item()
                    where = f"K5 r={r} n={n} k={k} parts={P or auto}"
                    if not torch.allclose(sk, sp, rtol=K5_TOL, atol=K5_TOL):
                        fail(f"{where}: kernel vs plain scores max |diff| "
                             f"{err:.3e}")
                    earns_scores(U, V, valid, sk, ik, where)
                    group = max(group, err)
            if r in worst:
                worst[r] = max(worst[r], group)
            log(f"k5 r={r} n={n} Ni={N_ITEMS} k=1, 10, 128, parts {auto} "
                f"(topk_parts), 1 and 7: max |kernel - plain| {group:.3e} "
                f"(tol {K5_TOL}), ids earn their scores")
        # a catalog smaller than k: exactly n_valid real slots, then
        # (NEG_INF, 0)
        Vs, vs = V[:50].contiguous(), valid[:50].contiguous()
        n_valid = int(vs.sum())
        for P in (1, 3):
            sk, ik = cuda_topk.topk_scores(U[:256].contiguous(), Vs, vs, 128,
                                           parts=P)
            if not (bool((sk[:, n_valid:] == NEG_INF32).all())
                    and bool((ik[:, n_valid:] == 0).all())):
                fail(f"K5 r={r} small catalog parts={P}: surplus slots are "
                     "not exactly (NEG_INF, 0)")
            if not bool((sk[:, :n_valid] > NEG_INF32).all()):
                fail(f"K5 r={r} small catalog: a valid item is missing")
            earns_scores(U[:256], Vs, vs, sk, ik, "K5 small catalog")
        log(f"k5 r={r} small catalog Ni=50 ({n_valid} valid) k=128, parts 1 "
            "and 3: sentinel slots exact")
    return worst


# -- phase 4 ---------------------------------------------------------------
def gather_problem(rng, dev, n, w, dtype, N=N_ITEMS, dup=True, r=RANK):
    """Unit factor rows, half-star ratings with ~20 % padding; row 0 is
    empty, row 1 (with ``dup``) repeats one column in every other slot,
    row 2 has only non-positive ratings."""
    V = torch.from_numpy(unit_rows(rng, N, r)).to(dev).to(dtype)
    cols = rng.integers(0, N, (n, w)).astype(np.int32)
    if dup:
        cols[1, 1::2] = cols[1, 0]
    vals = (rng.integers(1, 11, (n, w)) * 0.5).astype(np.float32)
    mask = (rng.random((n, w)) < 0.8).astype(np.float32)
    mask[0] = 0.0
    vals[2] = -vals[2]
    vals *= mask
    return (V, torch.from_numpy(cols).to(dev),
            torch.from_numpy(vals).to(dev).to(dtype),
            torch.from_numpy(mask).to(dev).to(dtype))


def rel_err(x, ref, scale):
    """max |x - ref| / scale over the entries where scale > 0."""
    ok = scale > 0
    return ((x - ref).abs()[ok] / scale[ok]).max().item()


def check_k3(rng, dev, r=RANK, widths=(24, 100, 512)):
    """K3 vs V[cols] + bmm at rank r, 64 rows of each width and 3 rows
    wider than the split width: returns the largest |S - S_plain| at f32.
    The row wider than the split width has no repeated column: a long
    sum of equal terms drifts in float32 far more than one of varied
    terms in cuBLAS's sequential order, which would be the plain side's
    error, not the kernel's."""
    worst = 0.0
    split = core_als.SPLIT_WIDTH
    for dtype in (torch.float32, torch.bfloat16):
        for n, w in [(64, w) for w in widths] + [(3, 3 * split)]:
            V, cols, vals, mask = gather_problem(rng, dev, n, w, dtype,
                                                 dup=w <= split, r=r)
            conf, pref = implicit_weights(vals, mask, ALPHA)
            for two_sided, aw, bw in ((True, mask, vals * mask),
                                      (False, conf,
                                       (1.0 + conf) * pref * mask)):
                S, b = cuda_gather_ne.gather_gram(
                    V, cols, aw, bw, two_sided=two_sided, split_width=split)
                Sp, bp = cuda_gather_ne.gather_gram_plain(
                    V, cols, aw, bw, two_sided=two_sided, split_width=split)
                Sa, ba = cuda_gather_ne.gather_gram_plain(
                    V.abs(), cols, aw.abs(), bw.abs(), two_sided=two_sided,
                    split_width=split)
                torch.cuda.synchronize()
                es, eb = rel_err(S, Sp, Sa), rel_err(b, bp, ba)
                if not (es <= K3_REL and eb <= K3_REL):
                    fail(f"K3 {dtype} n={n} w={w} two_sided={two_sided}: "
                         f"relative |diff| S {es:.3e}, b {eb:.3e}")
                if dtype == torch.float32:
                    worst = max(worst, (S - Sp).abs().max().item())
            log(f"k3 r={r} {str(dtype)[6:]} n={n} w={w}"
                f"{' (split)' if w > split else ''}: max |kernel - plain| / "
                f"Σ|terms| S {es:.3e}, b {eb:.3e} (tol {K3_REL})")
    return worst


def check_k4(rng, dev, r=RANK, shapes=((256, 24), (256, 100), (64, 512))):
    """K4 vs K3's plain Gram + tail + K2's plain solve at rank r, on
    (rows, width) ``shapes``: returns the largest |x - x_plain| at f32.
    A row wider than the split width has no repeated column (see
    :func:`check_k3`)."""
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for n, w in shapes:
            V, cols, vals, mask = gather_problem(
                rng, dev, n, w, dtype, dup=w <= core_als.SPLIT_WIDTH, r=r)
            YtY = compute_yty(V.float())
            conf, pref = implicit_weights(vals, mask, ALPHA)
            for name, xk, xp in (
                    ("implicit",
                     cuda_gather_ne.gather_fused_solve_implicit(
                         V, cols, vals, mask, REG, ALPHA, YtY),
                     cuda_gather_ne.gather_solve_plain(
                         V, cols, conf, (1.0 + conf) * pref * mask,
                         pref * mask, YtY, two_sided=False, reg=REG)),
                    ("explicit",
                     cuda_gather_ne.gather_fused_solve_explicit(
                         V, cols, vals, mask, REG),
                     cuda_gather_ne.gather_solve_plain(
                         V, cols, mask, vals * mask, mask, two_sided=True,
                         reg=REG))):
                torch.cuda.synchronize()
                zero = (0, 2) if name == "implicit" else (0,)
                if not all(bool((xk[j] == 0).all()) for j in zero):
                    fail(f"K4 {name} {dtype}: rows {zero} (empty, or no "
                         "positive rating) did not solve to exactly 0")
                err = (xk - xp).abs().max().item()
                if not (torch.isfinite(xk).all() and torch.allclose(
                        xk, xp, rtol=K4_RTOL, atol=K4_ATOL)):
                    fail(f"K4 {name} {dtype} n={n} w={w}: kernel vs plain "
                         f"max |diff| {err:.3e}")
                if dtype == torch.float32:
                    worst = max(worst, err)
                log(f"k4 r={r} {name} {str(dtype)[6:]} n={n} w={w}: max "
                    f"|kernel - plain| {err:.3e} (rtol {K4_RTOL}, atol "
                    f"{K4_ATOL})")
    return worst


def ring_problem(rng, dev, S, per, n, w, dtype, r):
    """``gather_problem`` per (owner, source shard): V_shards [S, per, r]
    unit rows, cols/vals/mask [S, S, n, w] shard-local; on every owner row
    0 is empty, row 1 repeats a column, row 2 has no positive rating."""
    V = torch.from_numpy(unit_rows(rng, S * per, r)).to(dev).to(dtype)
    cols = rng.integers(0, per, (S, S, n, w)).astype(np.int32)
    cols[:, :, 1, 1::2] = cols[:, :, 1, :1]
    vals = (rng.integers(1, 11, (S, S, n, w)) * 0.5).astype(np.float32)
    mask = (rng.random((S, S, n, w)) < 0.8).astype(np.float32)
    mask[:, :, 0] = 0.0
    vals[:, :, 2] = -vals[:, :, 2]
    vals *= mask
    return (V.reshape(S, per, r), torch.from_numpy(cols).to(dev),
            torch.from_numpy(vals).to(dev).to(dtype),
            torch.from_numpy(mask).to(dev).to(dtype))


def check_k7(rng, dev, ranks=(RANK, 200, RANK256), shards=(1, 3, SHARDS)):
    """K7 vs its plain version (K4's plain Gram, tail and solve over each
    owner's ring-ordered stream) at ``ranks``, S in ``shards``, explicit
    and implicit, f32 and bf16, within K4's band; at S = 1, K7 == K4 bit
    for bit; and with a split width of 64 below S·w (100, 300 and 400
    entries a row: the width split's three passes, chunks crossing the
    sources' boundaries) against the plain version chunked the same way,
    within K4's band.  Returns the largest |x - x_plain| at f32 by
    rank."""
    worst = dict.fromkeys(ranks, 0.0)
    for r in ranks:
        for S in shards:
            for dtype in (torch.float32, torch.bfloat16):
                for n, w, split in ((64, 24, None), (16, 100, None),
                                    (16, 100, 64)):
                    V, cols, vals, mask = ring_problem(rng, dev, S, 2048, n,
                                                       w, dtype, r)
                    YtY = compute_yty(V.reshape(-1, r).float())
                    conf, pref = implicit_weights(vals, mask, ALPHA)
                    for name, xk, xp in (
                            ("implicit",
                             cuda_gather_ne.gather_fused_ring_implicit(
                                 V, cols, vals, mask, REG, ALPHA, YtY,
                                 split_width=split),
                             cuda_gather_ne.gather_solve_ring_plain(
                                 V, cols, conf, (1.0 + conf) * pref * mask,
                                 pref * mask, YtY, two_sided=False,
                                 reg=REG, split_width=split)),
                            ("explicit",
                             cuda_gather_ne.gather_fused_ring_explicit(
                                 V, cols, vals, mask, REG,
                                 split_width=split),
                             cuda_gather_ne.gather_solve_ring_plain(
                                 V, cols, mask, vals * mask, mask,
                                 two_sided=True, reg=REG,
                                 split_width=split))):
                        torch.cuda.synchronize()
                        zero = (0, 2) if name == "implicit" else (0,)
                        if not all(bool((xk[:, j] == 0).all())
                                   for j in zero):
                            fail(f"K7 {name} r={r} S={S} split={split}: rows "
                                 f"{zero} did not solve to exactly 0")
                        err = (xk - xp).abs().max().item()
                        if not (torch.isfinite(xk).all() and torch.allclose(
                                xk, xp, rtol=K4_RTOL, atol=K4_ATOL)):
                            fail(f"K7 {name} {dtype} r={r} S={S} n={n} "
                                 f"w={w} split={split}: kernel vs plain max "
                                 f"|diff| {err:.3e}")
                        if dtype == torch.float32:
                            worst[r] = max(worst[r], err)
                        if S == 1 and split is None:
                            fused = (cuda_gather_ne.gather_fused_solve_implicit
                                     if name == "implicit" else
                                     cuda_gather_ne.gather_fused_solve_explicit)
                            args = ((V[0], cols[0, 0], vals[0, 0], mask[0, 0],
                                     REG) + ((ALPHA, YtY)
                                             if name == "implicit" else ()))
                            if not torch.equal(xk[0], fused(*args)):
                                fail(f"K7 {name} {dtype} r={r} at one shard "
                                     "is not K4 bit for bit")
            log(f"k7 r={r} S={S}: explicit and implicit, f32 and bf16, "
                f"w 24 and 100, and w 100 split in chunks of 64: within rtol "
                f"{K4_RTOL}, atol {K4_ATOL} of plain"
                + ("; unsplit == K4 bitwise" if S == 1 else ""))
    return worst


def check_solve_bound(rng, dev):
    """Past the fused solve's rank 512 (the reference's TileBudgetError
    bound) K4 and K7 raise on the card, naming it, rather than fall back
    to a plain version or the einsum route; K3 takes the rank
    (:func:`check_k3` at SOLVE_BOUND_RANK)."""
    r = SOLVE_BOUND_RANK
    V, cols, vals, mask = gather_problem(rng, dev, 8, 24, torch.float32,
                                         r=r)
    one = (V[None], cols[None, None], vals[None, None], mask[None, None])
    for name, call in (
            ("K4", lambda: cuda_gather_ne.gather_fused_solve_explicit(
                V, cols, vals, mask, REG)),
            ("K7", lambda: cuda_gather_ne.gather_fused_ring_explicit(
                *one, REG))):
        try:
            call()
        except ValueError as e:
            if "TileBudgetError" not in str(e):
                fail(f"{name} at rank {r} raised, but not the fused "
                     f"solve's bound: {e}")
        else:
            fail(f"{name} at rank {r} did not raise")
    log(f"k4, k7 at rank {r}: ValueError (the reference's TileBudgetError "
        "bound, r_pad 512); K3 takes the rank")


def check_cluster_solve(rng, dev, ranks=CLUSTER_RANKS,
                        shapes=((48, 24), (16, 512))):
    """K4's solve pass above rank 288 (``csrc/chol_cluster.cuh``, a
    thread-block cluster a row) at ``ranks``: the cluster size and a
    block's shared bytes as the card reports them against the launcher's
    plan (``cuda_gather_ne._cluster_plan``); then, f32 and bf16,
    explicit and implicit, K4's x bit for bit K1's streamed entry
    (``stream_solve``) on the A the tail forms (``tail_system``) from
    K3's unsplit Gram of the same rows (the block body of K4's first
    pass), and the empty and no-positive rows exactly 0."""
    for r in ranks:
        info = cuda_gather_ne.cluster_info(r)
        plan = cuda_gather_ne._cluster_plan(r)
        if (info["size"], info["dynamic_smem"]) != (plan.size,
                                                     plan.smem_bytes) \
                or info["max_active_clusters"] < 1:
            fail(f"K4 r={r}: the card's cluster launch {info} is not the "
                 f"plan ({plan.size} blocks, {plan.smem_bytes} B a block)")
        log(f"k4 r={r} cluster solve: {info['size']} blocks a cluster, "
            f"{info['dynamic_smem']} B dynamic + {info['static_smem']} B "
            f"static shared a block, {info['registers']} registers a "
            f"thread, at most {info['max_active_clusters']} clusters "
            f"active (tiles a block {plan.tiles})")
        for dtype in (torch.float32, torch.bfloat16):
            for n, w in shapes:
                V, cols, vals, mask = gather_problem(rng, dev, n, w, dtype,
                                                     r=r)
                YtY = compute_yty(V.float())
                conf, pref = implicit_weights(vals, mask, ALPHA)
                for name, aw, bw, cw, two, yty in (
                        ("implicit", conf, (1.0 + conf) * pref * mask,
                         pref * mask, False, YtY),
                        ("explicit", mask, vals * mask, mask, True, None)):
                    xk = cuda_gather_ne.gather_solve(
                        V, cols, aw, bw, cw, yty, two_sided=two, reg=REG)
                    S, b = cuda_gather_ne.gather_gram(V, cols, aw, bw,
                                                      two_sided=two)
                    A = cuda_gather_ne.tail_system(S, cw.float().sum(-1),
                                                   dtype, yty, REG)
                    x1 = cuda_solve.spd_solve_blocked(A.contiguous(), b)
                    torch.cuda.synchronize()
                    zero = (0, 2) if name == "implicit" else (0,)
                    if not all(bool((xk[j] == 0).all()) for j in zero):
                        fail(f"K4 r={r} {name} {dtype}: rows {zero} did not "
                             "solve to exactly 0")
                    if not (torch.isfinite(xk).all()
                            and torch.equal(xk, x1)):
                        fail(f"K4 r={r} {name} {dtype} n={n} w={w}: the "
                             "cluster solve is not K1's streamed solve bit "
                             f"for bit (max |diff| "
                             f"{(xk - x1).abs().max().item():.3e})")
                    del S, b, A
        log(f"k4 r={r}: x == K1's streamed solve (stream_solve) bit for "
            "bit on the tail's A, explicit and implicit, f32 and bf16, "
            f"widths {[w for _, w in shapes]}; empty rows exactly 0")


def tie_corpus(rng, n, ni, r, pool=7):
    """The reference's integer tie corpus: integer factors, the catalog
    from a ``pool``-row palette: every f32 score is exact, ties abound."""
    base = rng.integers(-3, 4, size=(pool, r)).astype(np.float32)
    V = base[rng.integers(0, pool, ni)]
    U = rng.integers(-3, 4, size=(n, r)).astype(np.float32)
    return U, V


def check_k8(rng, dev):
    """K8 vs its plain version, bitwise (scores and ids), and both vs the
    plain top-k over the whole concatenated catalog, on the integer tie
    corpus at 4,096 users x the 59,047-item catalog, r = 16, S = 1, 3, 4
    and 8 shards, k = 10 and 128, each shard in the parts ``topk_parts``
    picks, in 1 and in 32 // S, ~30 % of items valid and (S > 1) shard 1
    all invalid.  Returns the largest |score - score_plain| (0.0)."""
    U, V = tie_corpus(rng, 4096, N_ITEMS, 16)
    U, V = torch.from_numpy(U).to(dev), torch.from_numpy(V).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for S in (1, 3, SHARDS, 8):
        ni_loc = -(-N_ITEMS // S)
        Vp = torch.zeros(S * ni_loc, 16, device=dev)
        Vp[:N_ITEMS] = V
        validp = torch.zeros(S * ni_loc, dtype=torch.bool, device=dev)
        validp[:N_ITEMS] = torch.from_numpy(rng.random(N_ITEMS) < 0.3)
        if S > 1:
            validp[ni_loc:2 * ni_loc] = False
        Vs, vs = Vp.reshape(S, ni_loc, 16), validp.reshape(S, ni_loc)
        for k in (10, 128):
            sp, ip = cuda_topk.topk_merge_ring_plain(U, Vs, vs, k, 32 // S)
            sc, ic = chunked_topk_scores(U, Vp, validp, k)
            for P in (None, 1, 32 // S):
                sk, ik = cuda_topk.topk_merge_ring(U, Vs, vs, k, parts=P)
                torch.cuda.synchronize()
                for what, (s, i) in (("plain", (sp, ip)),
                                     ("the whole-catalog top-k", (sc, ic))):
                    if not (torch.equal(sk, s) and torch.equal(ik, i)):
                        bad = int((ik != i).any(dim=1).sum())
                        fail(f"K8 S={S} k={k} parts={P}: not bitwise {what} "
                             f"(scores max |diff| "
                             f"{(sk - s).abs().max().item():.3e}, {bad} rows "
                             "with other ids)")
                if S > 1 and bool(((ik >= ni_loc) & (ik < 2 * ni_loc)
                                   & (sk > NEG_INF32)).any()):
                    fail(f"K8 S={S}: an item of the all-invalid shard came "
                         "back")
        log(f"k8 S={S} n=4096 Ni={N_ITEMS} r=16 k=10 and 128, parts "
            f"{cuda_topk.topk_parts(4096, ni_loc, S, sms)} "
            f"(topk_parts), 1 and {32 // S}: bitwise plain and the "
            "whole-catalog top-k (tie corpus)")
    return 0.0


def check_k8_many(rng, dev, shards=(33, 64)):
    """K8 past 32 shards (the merge's lanes each holding several shards'
    heads), bitwise its plain version and the whole-catalog plain top-k
    on the integer tie corpus at 4,096 users x the 59,047-item catalog,
    r = 16, k = 10 and 128, ~30 % of items valid and shard 1 all invalid,
    each shard one part (by default and forced); K8 launched each time
    (``MERGE_LAUNCHES``), where it once raised NotImplementedError.
    Returns the largest S checked."""
    U, V = tie_corpus(rng, 4096, N_ITEMS, 16)
    U, V = torch.from_numpy(U).to(dev), torch.from_numpy(V).to(dev)
    for S in shards:
        ni_loc = -(-N_ITEMS // S)
        Vp = torch.zeros(S * ni_loc, 16, device=dev)
        Vp[:N_ITEMS] = V
        validp = torch.zeros(S * ni_loc, dtype=torch.bool, device=dev)
        validp[:N_ITEMS] = torch.from_numpy(rng.random(N_ITEMS) < 0.3)
        validp[ni_loc:2 * ni_loc] = False
        Vs, vs = Vp.reshape(S, ni_loc, 16), validp.reshape(S, ni_loc)
        for k in (10, 128):
            sp, ip = cuda_topk.topk_merge_ring_plain(U, Vs, vs, k, 1)
            sc, ic = chunked_topk_scores(U, Vp, validp, k)
            for P in (None, 1):
                before = cuda_topk.MERGE_LAUNCHES
                t0 = time.perf_counter()
                sk, ik = cuda_topk.topk_merge_ring(U, Vs, vs, k, parts=P)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if cuda_topk.MERGE_LAUNCHES != before + 1:
                    fail(f"K8 S={S} k={k}: no launch counted")
                for what, (s, i) in (("plain", (sp, ip)),
                                     ("the whole-catalog top-k", (sc, ic))):
                    if not (torch.equal(sk, s) and torch.equal(ik, i)):
                        bad = int((ik != i).any(dim=1).sum())
                        fail(f"K8 S={S} k={k} parts={P}: not bitwise {what} "
                             f"(scores max |diff| "
                             f"{(sk - s).abs().max().item():.3e}, {bad} rows "
                             "with other ids)")
                if bool(((ik >= ni_loc) & (ik < 2 * ni_loc)
                         & (sk > NEG_INF32)).any()):
                    fail(f"K8 S={S}: an item of the all-invalid shard came "
                         "back")
            log(f"k8 S={S} n=4096 Ni={N_ITEMS} r=16 k={k}, one part a "
                f"shard: launched, bitwise plain and the whole-catalog "
                f"top-k (tie corpus); last call {ms:.1f} ms host wall")
    return max(shards)


# -- phase 5 ---------------------------------------------------------------
def layout(csr, side):
    widths = [(b.width, int((b.rows < csr.num_rows).sum()))
              for b in csr.buckets]
    log(f"{side}: {csr.num_rows} rows, padded nnz {csr.padded_nnz}, "
        f"{len(csr.buckets)} buckets, widest (width, rows) {widths[-4:]}, "
        f"max degree {int(csr.counts.max())}")
    for r in (RANK, RANK256, RANK512):
        cfg = core_als.AlsConfig(rank=r, implicit_prefs=True)
        routes = {}
        for w, _ in widths:
            routes.setdefault(core_als.resolve_solve_path(cfg, r, w),
                              []).append(w)
        for label, ws in routes.items():
            log(f"  rank {r} route {label}: widths {ws}")


def row_rel(x, ref):
    return ((x - ref).norm(dim=1)
            / ref.norm(dim=1).clamp(min=1e-30)).max().item()


def f64_rel(x, V, csr):
    """max |x[row] - x64| / |x64| over the heaviest row of every bucket of
    width >= 8192, where x64 solves the same implicit normal equations
    against the same V in float64: the error of a route, not a
    difference between two routes."""
    dev = V.device
    V64 = V.double()
    Y64 = V64.T @ V64
    eye = torch.eye(V.shape[1], dtype=torch.float64, device=dev)
    worst = 0.0
    for b in csr.buckets:
        pos = np.flatnonzero(b.rows < csr.num_rows)
        if b.width < 8192 or not len(pos):
            continue
        k = pos[np.argmax(csr.counts[b.rows[pos]])]
        Vg = V64[torch.from_numpy(b.cols[k].astype(np.int64)).to(dev)]
        vals = torch.from_numpy(b.vals[k]).to(dev).double()
        mask = torch.from_numpy(b.mask[k]).to(dev).double()
        conf, pref = ALPHA * vals.abs() * mask, (vals > 0).double()
        A = (Vg * conf[:, None]).T @ Vg + Y64 \
            + (REG * (pref * mask).sum() + 1e-6) * eye
        x64 = torch.linalg.solve(A, ((1.0 + conf) * pref * mask) @ Vg)
        worst = max(worst, ((x[int(b.rows[k])].double() - x64).norm()
                            / x64.norm()).item())
    return worst


def same_layout(a, b, side):
    """Fail unless two bucketed layouts are array-equal: counts, bucket
    order, and every bucket's rows, cols, vals and mask with dtypes."""
    if len(a.buckets) != len(b.buckets) or not np.array_equal(a.counts,
                                                              b.counts):
        fail(f"native and numpy blocking differ ({side}): buckets or counts")
    for x, y in zip(a.buckets, b.buckets):
        for name in ("rows", "cols", "vals", "mask"):
            p, q = getattr(x, name), getattr(y, name)
            if p.dtype != q.dtype or not np.array_equal(p, q):
                fail(f"native and numpy blocking differ ({side}): {name} "
                     f"of the width-{x.width} bucket")


def digits(x, width):
    """Zero-padded decimal digits of non-negative ints, [n, width] uint8."""
    x = np.asarray(x, dtype=np.int64)
    if len(x) and (x.min() < 0 or x.max() >= 10 ** width):
        fail(f"digits: values outside [0, 1e{width})")
    out = np.empty((len(x), width), dtype=np.uint8)
    for k in range(width):
        out[:, width - 1 - k] = (x // 10 ** k) % 10 + ord("0")
    return out


def write_ratings_csv(path, frame):
    """The frame as a MovieLens ``ratings.csv``: the header, then
    ``user,item,rating,timestamp`` a line, ids and stamps zero-padded to
    fixed widths, the half-star rating as ``d.d``; vectorized, so the
    25M lines take seconds."""
    r2 = np.asarray(frame["rating"], np.float64) * 2
    if not np.array_equal(r2, np.round(r2)) or r2.min() < 0 or r2.max() > 18:
        fail("write_ratings_csv: ratings off the half-star grid")
    r2 = r2.astype(np.int64)
    n = len(r2)
    col = lambda ch: np.full((n, 1), ord(ch), np.uint8)  # noqa: E731
    body = np.concatenate([
        digits(frame["user"], 6), col(","), digits(frame["item"], 6),
        col(","), digits(r2 // 2, 1), col("."), digits(r2 % 2 * 5, 1),
        col(","), digits(frame["timestamp"], 10), col("\n")], axis=1)
    with open(path, "wb") as f:
        f.write(CSV_HEADER)
        body.tofile(f)
    return body.shape[1]   # bytes a line


def csv_phase(frame, seed, keep):
    """Parse a ``ratings.csv`` written from the synthetic frame with the
    native reader (``load_movielens_csv``, every row) and with its Python
    twin (the first CSV_TWIN_ROWS rows): each equal to the frame, rows a
    second on the host's clock.  Phase 9's (a) and (b) run here, on the
    same file and prefix while they exist; returns their seconds.  The
    prefix is copied to ``keep/prefix.csv`` for phase 10(d)."""
    n = len(frame["user"])
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/ratings.csv"
        t0 = time.perf_counter()
        line = write_ratings_csv(path, frame)
        t_write = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        got = load_movielens_csv(path)
        t_native = time.perf_counter() - t0
        for c in ("user", "item", "rating", "timestamp"):
            want = np.asarray(frame[c]).astype(got[c].dtype)
            if not np.array_equal(got[c], want):
                fail(f"native CSV reader: column {c} differs from the frame")
        prefix = f"{tmp}/prefix.csv"
        with open(path, "rb") as f, open(prefix, "wb") as g:
            g.write(f.read(len(CSV_HEADER) + CSV_TWIN_ROWS * line))
        t0 = time.perf_counter()
        twin = csv_twin(prefix)
        t_twin = time.perf_counter() - t0
        for c in ("user", "item", "rating", "timestamp"):
            if not np.array_equal(twin[c], got[c][:CSV_TWIN_ROWS]) \
                    or twin[c].dtype != got[c].dtype:
                fail(f"CSV twin: column {c} differs from the native reader")
        del twin
        shutil.copy(prefix, os.path.join(keep, "prefix.csv"))
        t9 = time.perf_counter()
        stream_ingest_phase(path, got)
        del got
        stream_cli_phase(prefix, tmp, seed)
        t9 = time.perf_counter() - t9
    log(f"ratings.csv of {n} rows ({size / 1e6:.1f} MB) written in "
        f"{t_write:.2f} s; native reader {t_native:.2f} s "
        f"({n / t_native:.4g} rows/s), equal to the frame; Python twin on "
        f"the first {CSV_TWIN_ROWS} rows {t_twin:.2f} s "
        f"({CSV_TWIN_ROWS / t_twin:.4g} rows/s), equal to the native "
        "reader's (host clock)")
    log(f"stream phase (a)-(b): {t9:.1f} s")
    return t9


def ml25m_frame(seed):
    """The ML-25M-shaped synthetic ratings, drawn once: phase 13b's (c)
    takes its first 1M rows (phase 9's prefix) beside the CPU
    cross-validation, and :func:`prepare` the whole."""
    t0 = time.perf_counter()
    frame = synthetic_movielens(*ML25M_SHAPE, seed=seed)
    log(f"synthetic_movielens{ML25M_SHAPE}: "
        f"{time.perf_counter() - t0:.1f} s (host)")
    return frame


def block_numpy(frame):
    """The numpy bucketizer's layout of ``frame`` (:func:`ml25m_frame`)
    both ways, for :func:`prepare` to hold the native layout to.  It runs
    in the CPU cross-validation's wait, so its seconds are taken beside
    that process and are logged as such."""
    u_idx, umap = remap_ids(frame["user"])
    i_idx, imap = remap_ids(frame["item"])
    r = frame["rating"]
    t0 = time.perf_counter()
    u = build_csr_buckets(u_idx, i_idx, r, len(umap), native=False)
    t1 = time.perf_counter()
    i = build_csr_buckets(i_idx, u_idx, r, len(imap), native=False)
    t2 = time.perf_counter()
    log(f"host blocking (numpy, beside the CPU cross-validation process): "
        f"users {t1 - t0:.2f} s, items {t2 - t1:.2f} s")
    return {"u_idx": u_idx, "i_idx": i_idx, "r": r, "umap": umap,
            "imap": imap, "ucsr": u, "icsr": i}


def prepare(frame, nb, dev):
    """The native bucketizer's layout of ``frame`` both ways, timed on a
    host with no other process at work, held array-equal to
    :func:`block_numpy`'s ``nb``; made once for the training slices at
    both ranks."""
    u_idx, i_idx, r = nb["u_idx"], nb["i_idx"], nb["r"]
    umap, imap = nb["umap"], nb["imap"]
    t0 = time.perf_counter()
    ucsr = build_csr_buckets(u_idx, i_idx, r, len(umap), native=True)
    t1 = time.perf_counter()
    icsr = build_csr_buckets(i_idx, u_idx, r, len(imap), native=True)
    t2 = time.perf_counter()
    log(f"host blocking (native, threaded C++): users {t1 - t0:.2f} s, "
        f"items {t2 - t1:.2f} s; array-equal to numpy's; the fits train "
        "on the native layout")
    same_layout(ucsr, nb["ucsr"], "users")
    same_layout(icsr, nb["icsr"], "items")
    layout(ucsr, "users")
    layout(icsr, "items")
    return {"frame": frame, "ucsr": ucsr, "icsr": icsr,
            "ub": ucsr.to(dev), "ib": icsr.to(dev),
            "n_users": len(umap), "n_items": len(imap),
            "u_idx": u_idx, "i_idx": i_idx, "r": r, "umap": umap,
            "imap": imap}


def _launch_counts():
    return {"k1": cuda_solve.LAUNCHES, "k2": cuda_lanes.LAUNCHES,
            "k3": cuda_gather_ne.GRAM_LAUNCHES,
            "k4": cuda_gather_ne.SOLVE_LAUNCHES,
            "k6": cuda_lanes_blocked.LAUNCHES, "k5": cuda_topk.LAUNCHES,
            "k7": cuda_gather_ne.RING_LAUNCHES,
            "k8": cuda_topk.MERGE_LAUNCHES,
            "k8_sets": cuda_topk.SETS_LAUNCHES,
            "k8_merge_sets": cuda_topk.MERGE_SETS_LAUNCHES}


def _zero_launches():
    cuda_solve.LAUNCHES = cuda_lanes.LAUNCHES = 0
    cuda_gather_ne.GRAM_LAUNCHES = cuda_gather_ne.SOLVE_LAUNCHES = 0
    cuda_lanes_blocked.LAUNCHES = cuda_topk.LAUNCHES = 0
    cuda_gather_ne.RING_LAUNCHES = cuda_topk.MERGE_LAUNCHES = 0
    cuda_topk.SETS_LAUNCHES = cuda_topk.MERGE_SETS_LAUNCHES = 0


def train_slice(data, r, seed, dev, max_iter=3):
    """The training slice at the full ML-25M shape and rank r (the
    kernels of the path: K4, K3 and K1 at rank 128; K4, K3 and K6 above):
    ``ALS.fit`` for ``max_iter`` iterations, K4 launched once per narrow
    bucket and iteration and nothing outside the path launched (no
    einsum route); one iteration from one init through 'auto' and
    'unfused', row by row, and each route's heaviest rows against
    float64.  Returns what the timings and the profile reuse, with the
    two routes' item half-steps."""
    path = ("k1", "k3", "k4") if r <= 128 else ("k3", "k4", "k6")
    n_users, n_items = data["n_users"], data["n_items"]
    cfg = core_als.AlsConfig(rank=r, implicit_prefs=True, alpha=ALPHA,
                             reg_param=REG)
    narrow = sum(core_als.resolve_solve_path(cfg, r, b.width)
                 == "gatherfused_solve"
                 for csr in (data["ucsr"], data["icsr"]) for b in csr.buckets)
    ticks = []

    def tick(it, U, V):
        torch.cuda.synchronize()
        ticks.append(time.perf_counter())

    est = ALS(rank=r, implicitPrefs=True, alpha=ALPHA, regParam=REG,
              maxIter=max_iter, fitCallback=tick)
    _zero_launches()
    t0 = time.perf_counter()
    model = est.fit(data["frame"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = _launch_counts()
    launches = {k: counts[k] for k in path}
    log(f"rank {r} fit launches: " + ", ".join(
        f"{k.upper()} {v}" for k, v in counts.items() if v)
        + f" ({narrow} narrow buckets on the two sides)")
    if min(launches.values()) == 0:
        fail(f"a kernel of the rank-{r} training path never launched: "
             f"{launches}")
    if counts["k4"] != max_iter * narrow or sum(launches.values()) != sum(
            counts.values()):
        fail(f"rank {r}: not K4 on every narrow bucket and only the path's "
             f"kernels: {counts}")
    iter_s = [b - a for a, b in zip(ticks, ticks[1:])]
    log(f"rank {r} fit: {fit_s:.2f} s wall (host remap and blocking "
        f"included); iteration{'s' if max_iter > 2 else ''} "
        f"2{f'-{max_iter}' if max_iter > 2 else ''} wall "
        f"{', '.join(f'{x * 1e3:.1f}' for x in iter_s)} ms")
    if not (torch.isfinite(model._U).all() and torch.isfinite(model._V).all()):
        fail(f"the rank-{r} fitted factors are not finite")
    if model._U.shape != (n_users, r) or model._V.shape != (n_items, r):
        fail(f"factor shapes {tuple(model._U.shape)}, {tuple(model._V.shape)}")

    # one iteration from one init: 'auto' (K4 + K3/K1 or K3/K6) vs
    # 'unfused' (torch normal equations + K2 or K6)
    ub, ib = data["ub"], data["ib"]
    g = torch.Generator().manual_seed(seed)
    U0 = core_als.init_factors(n_users, r, g).to(dev)
    V0 = core_als.init_factors(n_items, r, g).to(dev)
    out, wall = {}, {}
    for backend in ("auto", "unfused"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[backend] = core_als.als_step(
            U0, V0, ub, ib, n_users, n_items,
            dataclasses.replace(cfg, solve_backend=backend))
        torch.cuda.synchronize()
        wall[backend] = time.perf_counter() - t0
    (Ua, Va), (Uu, Vu) = out["auto"], out["unfused"]
    eu, ev = row_rel(Ua, Uu), row_rel(Va, Vu)
    log(f"rank {r}: one iteration 'auto' ({wall['auto'] * 1e3:.1f} ms) vs "
        f"'unfused' ({wall['unfused'] * 1e3:.1f} ms): max per-row "
        f"|diff|/|x| users {eu:.3e}, items {ev:.3e} (tol {TRAIN_REL})")
    icsr, ucsr = data["icsr"], data["ucsr"]
    e64 = {"items auto": f64_rel(Va, U0, icsr),
           "items unfused": f64_rel(Vu, U0, icsr),
           "users auto": f64_rel(Ua, Va, ucsr),
           "users unfused": f64_rel(Uu, Vu, ucsr)}
    log(f"rank {r}: heaviest rows of the buckets of width >= 8192 vs "
        "float64: " + ", ".join(f"{k} {v:.3e}" for k, v in e64.items())
        + f" (tol {TRAIN_REL})")
    if not (eu <= TRAIN_REL and ev <= TRAIN_REL):
        fail(f"rank {r}: 'auto' and 'unfused' disagree: users {eu:.3e}, "
             f"items {ev:.3e}")
    if max(e64.values()) > TRAIN_REL:
        fail(f"rank {r}: a route is off the float64 solution: {e64}")
    return {"launches": launches, "iter_s": iter_s, "ub": ub, "ib": ib,
            "max_iter": max_iter, "U0": U0, "V0": V0, "cfg": cfg,
            "n_items": n_items,
            "n_users": n_users, "model": model,
            "items": {"auto": Va, "unfused": Vu}}


def sharded_train_slice(data, seed, dev):
    """Sharded training at the ML-25M shape, rank 128, implicit: SHARDS
    logical shards on the card, the ring's owner x source grid (host
    seconds, padded entries), then ``train_sharded(strategy='ring')`` with
    ``solve_backend='gather_fused_ring'`` (K7) for 2 iterations from the
    injected init of a 2-iteration single-device fit, row by row within
    TRAIN_REL of it (and both against float64 on the heaviest users), and
    one iteration of the unfused ring (torch normal equations + K2) on the
    same grid against the fused ring's first.  Returns what the timings
    reuse."""
    mesh = make_mesh(devices=[dev] * SHARDS)
    u_idx, i_idx, r = data["u_idx"], data["i_idx"], data["r"]
    n_users, n_items = data["n_users"], data["n_items"]
    upart = partition_balanced(np.bincount(u_idx, minlength=n_users), SHARDS)
    ipart = partition_balanced(np.bincount(i_idx, minlength=n_items), SHARDS)
    t0 = time.perf_counter()
    ush = shard_csr_grid(upart, ipart, u_idx, i_idx, r)
    t1 = time.perf_counter()
    ish = shard_csr_grid(ipart, upart, i_idx, u_idx, r)
    t2 = time.perf_counter()
    counts = (stacked_counts(upart, u_idx, r, positive_only=True),
              stacked_counts(ipart, i_idx, r, positive_only=True))
    for side, g, sd in (("users", ush, t1 - t0), ("items", ish, t2 - t1)):
        widest = g.buckets[-1]
        log(f"ring grid {side} ({SHARDS} shards): shard_csr_grid {sd:.2f} s "
            f"(host), {g.padded_nnz} padded entries for {g.nnz} ratings in "
            f"{len(g.buckets)} buckets, widest {SHARDS} x "
            f"{widest.cols.shape[-1]} entries per row")
    g = torch.Generator().manual_seed(seed)
    U0 = core_als.init_factors(n_users, RANK, g)
    V0 = core_als.init_factors(n_items, RANK, g)
    cfg = core_als.AlsConfig(rank=RANK, max_iter=2, implicit_prefs=True,
                             alpha=ALPHA, reg_param=REG,
                             solve_backend="gather_fused_ring")
    ticks, first = [time.perf_counter()], {}

    def tick(it, U, V):
        torch.cuda.synchronize()
        ticks.append(time.perf_counter())
        if it == 1:
            first["U"], first["V"] = U.clone(), V.clone()

    _zero_launches()
    ticks[0] = time.perf_counter()
    Us, Vs = train_sharded(mesh, upart, ipart, ush, ish, cfg, callback=tick,
                           strategy="ring", ring_counts=counts,
                           init=(U0, V0))
    torch.cuda.synchronize()
    launches = _launch_counts()
    log("sharded fit launches: " + ", ".join(
        f"{k.upper()} {v}" for k, v in launches.items() if v))
    if launches["k7"] == 0:
        fail(f"K7 never launched on the sharded training path: {launches}")
    iter_s = [b - a for a, b in zip(ticks, ticks[1:])]
    log(f"sharded fit ({SHARDS} logical shards, ring, gather_fused_ring): "
        f"iterations 1-2 wall {', '.join(f'{x * 1e3:.1f}' for x in iter_s)}"
        " ms (iteration 1 includes moving the grid to the card)")
    U, V = entity_rows(upart, Us), entity_rows(ipart, Vs)
    if not (torch.isfinite(U).all() and torch.isfinite(V).all()):
        fail("the sharded fit's factors are not finite")
    # the single-device fit from the same init
    one = dataclasses.replace(cfg, solve_backend="auto")
    U1, V1 = U0.to(dev), V0.to(dev)
    for _ in range(2):
        U1, V1 = core_als.als_step(U1, V1, data["ub"], data["ib"], n_users,
                                   n_items, one)
    eu, ev = row_rel(U, U1), row_rel(V, V1)
    e64 = {"sharded": f64_rel(U, V, data["ucsr"]),
           "single-device": f64_rel(U1, V1, data["ucsr"])}
    log(f"sharded vs single-device fit, 2 iterations: max per-row "
        f"|diff|/|x| users {eu:.3e}, items {ev:.3e} (tol {TRAIN_REL}); "
        "heaviest users vs float64: " + ", ".join(
            f"{k} {v:.3e}" for k, v in e64.items())
        + f" (sharded / single-device "
        f"{e64['sharded'] / max(e64['single-device'], 1e-30):.2f})")
    if not (eu <= TRAIN_REL and ev <= TRAIN_REL):
        fail(f"the sharded fit is off the single-device fit: users "
             f"{eu:.3e}, items {ev:.3e}; float64: {e64}")
    # the unfused ring, one iteration on the same grid
    unfused = dataclasses.replace(cfg, max_iter=1, solve_backend="auto")
    _zero_launches()
    Uu, Vu = train_sharded(mesh, upart, ipart, ush, ish, unfused,
                           strategy="ring", ring_counts=counts,
                           init=(U0, V0))
    torch.cuda.synchronize()
    unf = _launch_counts()
    if unf["k2"] == 0 or unf["k7"] != 0:
        fail(f"the unfused ring's launches: {unf}")
    eu1, ev1 = row_rel(Uu, first["U"]), row_rel(Vu, first["V"])
    log(f"unfused ring (K2 {unf['k2']} launches) vs the fused ring, one "
        f"iteration: max per-row |diff|/|x| users {eu1:.3e}, items "
        f"{ev1:.3e} (tol {TRAIN_REL})")
    if not (eu1 <= TRAIN_REL and ev1 <= TRAIN_REL):
        fail(f"the unfused and fused rings disagree: {eu1:.3e}, {ev1:.3e}")
    return {"launches": launches, "iter_s": iter_s, "ish": ish,
            "icounts": counts[1], "U0": slot_rows(upart, U0.to(dev)),
            "V0": slot_rows(ipart, V0.to(dev)), "ush": ush,
            "ucounts": counts[0], "mesh": mesh, "upart": upart,
            "ipart": ipart}


def strategies_slice(data, sh, seed, dev):
    """(a) One iteration of 'all_gather', 'all_gather_chunked' and
    'all_to_all' on phase 5's partitions (SHARDS logical shards) from one
    injected init, the other two held row by row within TRAIN_REL of
    'all_gather'; the a2a plans built with ``on_degenerate='build'`` so
    that the a2a path runs whatever R is; launches counted per strategy
    (K2 for chunked, K4 and K3 + K1 for a2a); 'auto''s pick and
    ``comm_bytes_per_iter`` of each."""
    mesh, upart, ipart = sh["mesh"], sh["upart"], sh["ipart"]
    u_idx, i_idx, r = data["u_idx"], data["i_idx"], data["r"]
    t0 = time.perf_counter()
    ush = shard_csr(upart, ipart, u_idx, i_idx, r)
    ish = shard_csr(ipart, upart, i_idx, u_idx, r)
    t1 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a degenerate plan warns
        ua = build_a2a(upart, ipart, u_idx, i_idx, r, on_degenerate="build")
        ia = build_a2a(ipart, upart, i_idx, u_idx, r, on_degenerate="build")
    t2 = time.perf_counter()
    log(f"host: shard_csr both sides {t1 - t0:.2f} s, build_a2a both "
        f"sides {t2 - t1:.2f} s")
    for side, a, part in (("users", ua, ipart), ("items", ia, upart)):
        log(f"a2a plan {side}: R {a.request_budget} (opposite rows a shard "
            f"{part.rows_per_shard}), padding_ratio {a.padding_ratio:.4f}, "
            f"degenerate {a.degenerate}")
    cfg = core_als.AlsConfig(rank=RANK, max_iter=1, implicit_prefs=True,
                             alpha=ALPHA, reg_param=REG)
    bytes_ = {
        s: comm_bytes_per_iter(s, upart, ipart, RANK, *c, implicit=True)
        for s, c in (("all_gather", (ush, ish)),
                     ("all_gather_chunked", (ush, ish)),
                     ("all_to_all", (ua, ia)),
                     ("ring", (sh["ush"], sh["ish"])),
                     ("gather_fused_ring", (sh["ush"], sh["ish"])))}
    auto = plan.resolve_gather_strategy(
        requested="auto", n_users=data["n_users"], n_items=data["n_items"],
        rank=RANK, n_devices=SHARDS, implicit=True)
    log(f"'auto' picks {auto!r}; comm_bytes_per_iter: " + ", ".join(
        f"{k} {v}" for k, v in bytes_.items()))
    make_step = {
        "all_gather": lambda: make_sharded_step(mesh, ush, ish, cfg),
        "all_gather_chunked": lambda: make_chunked_gather_step(
            mesh, ush, ish, cfg),
        "all_to_all": lambda: make_a2a_step(mesh, ua, ia, cfg)}
    out, walls, counts = {}, {}, {}
    for name, build in make_step.items():
        step = build()  # the containers moved to the card
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        U, V = step(sh["U0"], sh["V0"])
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3
        counts[name] = _launch_counts()
        if not (torch.isfinite(U).all() and torch.isfinite(V).all()):
            fail(f"{name}: non-finite factors")
        out[name] = (U, V)
        del step
    Ug, Vg = out["all_gather"]
    for name in ("all_gather_chunked", "all_to_all"):
        eu, ev = row_rel(out[name][0], Ug), row_rel(out[name][1], Vg)
        log(f"{name}: one iteration {walls[name]:.1f} ms (all_gather "
            f"{walls['all_gather']:.1f} ms); launches " + ", ".join(
                f"{k.upper()} {v}" for k, v in counts[name].items() if v)
            + f"; vs all_gather max per-row |diff|/|x| users {eu:.3e}, "
            f"items {ev:.3e} (tol {TRAIN_REL})")
        if not (eu <= TRAIN_REL and ev <= TRAIN_REL):
            fail(f"{name} is off all_gather: users {eu:.3e}, items {ev:.3e}")
    c, a = counts["all_gather_chunked"], counts["all_to_all"]
    if c["k2"] == 0 or c["k4"] or c["k3"]:
        fail(f"all_gather_chunked's launches: {c}")
    if a["k4"] == 0 or a["k3"] == 0 or a["k1"] == 0:
        fail(f"all_to_all's launches: {a}")
    return {"walls": walls, "counts": counts, "bytes": bytes_,
            "auto": auto}


def elastic_slice(data, sh, work, dev):
    """(b) ``ALS(rank=128, maxIter=3, mesh=SHARDS logical shards,
    gatherStrategy='all_to_all', elastic=True, checkpointDir=...,
    checkpointInterval=1)`` under ``mesh.device_lost=corrupt@nth=3``: it
    completes on SHARDS - 1 shards with one ``device_lost``, one
    ``mesh_reformed`` and one ``elastic_resume`` (from the iteration-2
    checkpoint) and ``train.reformations`` 1; the effective strategy
    (``lastFitStrategy``) and its traffic logged; then a fault-free fit
    on SHARDS - 1 shards resumed from that same checkpoint (copied aside
    by a ``fitCallback`` before the next save replaced it) equals it bit
    for bit, or within RESUME_ABS.  The recovery's wall: the injected
    fault to the resume event."""
    ck = os.path.join(work, "elastic_ck")
    kept = os.path.join(work, "elastic_kept")

    def keep(it, U, V):
        src = os.path.join(ck, "als_checkpoint")
        dst = os.path.join(kept, str(it - 1))
        if os.path.isdir(src) and not os.path.exists(dst):
            shutil.copytree(src, dst)

    kw = dict(rank=RANK, maxIter=3, implicitPrefs=True, alpha=ALPHA,
              regParam=REG, seed=FIT_SEED, gatherStrategy="all_to_all")
    obs.reset()
    elastic.clear_lost()
    faults.install("mesh.device_lost=corrupt@nth=3")
    _zero_launches()
    est = ALS(mesh=sh["mesh"], elastic=True, checkpointDir=ck,
              checkpointInterval=1, fitCallback=keep, **kw)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = est.fit(data["frame"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    faults.clear()
    launches = _launch_counts()
    ev = {t: obs.events(t) for t in ("fault_injected", "device_lost",
                                     "mesh_reformed", "elastic_resume")}
    reforms = obs.counter_value("train.reformations")
    if [len(ev[t]) for t in ev] != [1, 1, 1, 1] or reforms != 1:
        fail(f"elastic fit: events {[(t, len(v)) for t, v in ev.items()]}, "
             f"train.reformations {reforms}")
    res = ev["elastic_resume"][0]
    if (res["source"], res["iteration"], res["devices"]) != (
            "checkpoint", 2, SHARDS - 1) or ev["device_lost"][0]["lost"] != [
            SHARDS - 1]:
        fail(f"elastic fit: {ev['device_lost'][0]}, {res}")
    recovery = res["ts"] - ev["fault_injected"][0]["ts"]
    if not (torch.isfinite(model._U).all() and torch.isfinite(model._V).all()):
        fail("the elastic fit's factors are not finite")
    log(f"elastic fit ({SHARDS} -> {SHARDS - 1} logical shards, "
        f"lastFitStrategy {est.lastFitStrategy!r}, lastFitCommBytes "
        f"{est.lastFitCommBytes}): {fit_s:.2f} s wall (host work of two "
        f"passes included); recovery (fault -> resume) {recovery * 1e3:.1f}"
        " ms; launches " + ", ".join(
            f"{k.upper()} {v}" for k, v in launches.items() if v))
    if launches["k4"] == 0:
        fail(f"K4 never launched in the elastic fit: {launches}")
    elastic.clear_lost()
    ref = ALS(mesh=make_mesh(devices=[dev] * (SHARDS - 1)),
              resumeFrom=os.path.join(kept, str(res["iteration"])), **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m3 = ref.fit(data["frame"])
    torch.cuda.synchronize()
    exact = (torch.equal(m3._U, model._U) and torch.equal(m3._V, model._V))
    diff = max((m3._U - model._U).abs().max().item(),
               (m3._V - model._V).abs().max().item())
    log(f"elastic fit vs a fault-free {SHARDS - 1}-shard fit resumed from "
        f"the same checkpoint: max |diff| {diff:.3e}"
        + (" (bit for bit)" if exact else f" (tol {RESUME_ABS})"))
    if not diff <= RESUME_ABS:
        fail(f"the elastic fit is off the resumed fit: {diff:.3e}")
    return {"fit_s": fit_s, "recovery_s": recovery, "launches": launches,
            "exact": exact}


def ring_fault_slice(sh, dev):
    """(c) The ring step with K7 (``gather_fused_ring``) on phase 5's
    grid: disarmed ``make_ring_step`` returns the raw step; armed
    (``comm.ring_step``) the wrapper, whose overhead with the point not
    due is its finiteness check, a host read; ``corrupt@nth=1`` raises
    ``FactorsCorrupt`` and ``raise@nth=1`` ``InjectedFault``."""
    mesh = sh["mesh"]
    cfg = core_als.AlsConfig(rank=RANK, implicit_prefs=True, alpha=ALPHA,
                             reg_param=REG,
                             solve_backend="gather_fused_ring")
    counts = (sh["ucounts"], sh["icounts"])
    raw = make_ring_step(mesh, sh["ush"], sh["ish"], cfg, counts)
    if raw.__name__ != "ring_step":
        fail(f"disarmed make_ring_step gave {raw.__name__}")
    faults.install("comm.ring_step=raise@nth=1000000")  # armed, not due
    armed = make_ring_step(mesh, sh["ush"], sh["ish"], cfg, counts)
    if armed.__name__ != "chaos_step":
        fail(f"armed make_ring_step gave {armed.__name__}")
    walls = {}
    for name, step in (("raw", raw), ("armed", armed), ("raw", raw),
                       ("armed", armed)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(sh["U0"], sh["V0"])
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3  # the second call
    before = cuda_gather_ne.RING_LAUNCHES
    faults.install("comm.ring_step=corrupt@nth=1")
    try:
        armed(sh["U0"], sh["V0"])
        fail("comm.ring_step=corrupt did not raise FactorsCorrupt")
    except FactorsCorrupt:
        pass
    if cuda_gather_ne.RING_LAUNCHES == before:
        fail("the corrupted ring step launched no K7")
    faults.install("comm.ring_step=raise@nth=1")
    try:
        armed(sh["U0"], sh["V0"])
        fail("comm.ring_step=raise did not raise InjectedFault")
    except faults.InjectedFault:
        pass
    faults.clear()
    log(f"ring step (K7): raw {walls['raw']:.1f} ms, armed (the wrapper, "
        f"not due) {walls['armed']:.1f} ms, extra "
        f"{walls['armed'] - walls['raw']:.1f} ms; corrupt -> FactorsCorrupt,"
        " raise -> InjectedFault, disarmed -> the raw step")
    return walls


def degraded_serve_slice(model, sh, dev):
    """(d) ``topk_sharded`` over the full catalog on the SHARDS-shard mesh,
    clean ('merge_ring', K8), then under ``serve.gather=raise@once``:
    answered degraded from the last-good catalog through K5, within
    K5_TOL of the clean scores, ``serve.degraded`` 1; a fresh mesh (other
    logical ids) with no last-good raises ``ServeShardLost``."""
    mesh = sh["mesh"]
    U, V = model._U, model._V
    serve.reset_last_good()
    obs.reset()
    walls = {}
    t0 = time.perf_counter()
    s0, i0 = serve.topk_sharded(U, V, 10, mesh, strategy="merge_ring")
    torch.cuda.synchronize()
    walls["clean"] = (time.perf_counter() - t0) * 1e3
    faults.install("serve.gather=raise@once")
    k5, k8 = cuda_topk.LAUNCHES, cuda_topk.MERGE_LAUNCHES
    t0 = time.perf_counter()
    s1, i1, info = serve.topk_sharded(U, V, 10, mesh, strategy="merge_ring",
                                      return_info=True)
    torch.cuda.synchronize()
    walls["degraded"] = (time.perf_counter() - t0) * 1e3
    faults.clear()
    if not info["degraded"] or cuda_topk.LAUNCHES != k5 + 1 \
            or cuda_topk.MERGE_LAUNCHES != k8:
        fail(f"the degraded serve: {info}, K5 +{cuda_topk.LAUNCHES - k5}, "
             f"K8 +{cuda_topk.MERGE_LAUNCHES - k8}")
    if obs.counter_value("serve.degraded") != 1:
        fail("serve.degraded is not 1")
    if not torch.allclose(s1, s0, rtol=K5_TOL, atol=K5_TOL):
        fail(f"degraded scores {(s1 - s0).abs().max().item():.3e} off the "
             "clean ones")
    fresh = make_mesh(devices=[dev] * SHARDS,
                      ids=range(SHARDS, 2 * SHARDS))
    faults.install("serve.gather=raise@once")
    try:
        serve.topk_sharded(U, V, 10, fresh)
        fail("a mesh with no last-good catalog did not raise "
             "ServeShardLost")
    except serve.ServeShardLost:
        pass
    faults.clear()
    log(f"degraded serve ({U.shape[0]} users x {V.shape[0]} items, k=10): "
        f"clean (K8) {walls['clean']:.1f} ms, degraded (K5) "
        f"{walls['degraded']:.1f} ms, scores max |diff| "
        f"{(s1 - s0).abs().max().item():.3e} (tol {K5_TOL}), ids differing "
        f"in {int((i1 != i0).any(dim=1).sum())} rows; serve.degraded 1; a "
        "fresh mesh raises ServeShardLost")
    return walls


def sharded_resilience_phase(data, sh, model, work, seed, dev):
    """Phase 5b: the strategies, elastic training, the ring step's fault
    point and the degraded serve on phase 5's SHARDS logical shards."""
    t0 = time.perf_counter()
    out = {"strategies": strategies_slice(data, sh, seed, dev)}
    out["elastic"] = elastic_slice(data, sh, work, dev)
    out["ring"] = ring_fault_slice(sh, dev)
    out["serve"] = degraded_serve_slice(model, sh, dev)
    secs = time.perf_counter() - t0
    if secs > 100:
        fail(f"phase 5b took {secs:.1f} s, over its 100-s budget")
    log(f"phase 5b (strategies, elastic, ring-step and serve-gather faults)"
        f": {secs:.1f} s, within its 100-s budget")
    return out


def widest_rows_f64(xs, F, data, n_widest=4):
    """``({name: max per-row |x - x64| / |x64|}, rows)`` for the item
    half-steps ``xs`` [n_items, r] against the user factors F, over every
    real row of the ``n_widest`` widest item buckets and the heaviest row
    of every other bucket; x64 is the dense float64 half-step
    (:func:`dense_half_step_f64`) on those rows' ratings alone."""
    icsr = data["icsr"]
    pick = set()
    for k, b in enumerate(icsr.buckets):
        real = b.rows[b.rows < icsr.num_rows]
        if k >= len(icsr.buckets) - n_widest:
            pick.update(int(i) for i in real)
        elif len(real):
            pick.add(int(real[np.argmax(icsr.counts[real])]))
    pick = np.asarray(sorted(pick))
    local = np.full(icsr.num_rows, -1, dtype=np.int64)
    local[pick] = np.arange(len(pick))
    li = local[data["i_idx"]]
    sel = li >= 0
    x64 = dense_half_step_f64(F, li[sel], data["u_idx"][sel], data["r"][sel],
                              len(pick), REG, ALPHA)
    rows = torch.from_numpy(pick).to(F.device)
    return ({k: row_rel(x[rows].double(), x64) for k, x in xs.items()},
            len(pick))


def rank512_slice(data, sh, seed, dev):
    """Phase 5 at rank 512, the widest rank the reference's K4 takes
    (r_pad 512): :func:`train_slice` for 2 iterations (K4 on every narrow
    bucket, K3 + K6 streamed on the wide ones, nothing else: no einsum
    route), then the item half-step's widest rows
    (:func:`widest_rows_f64`) against float64, and K7's item half-step
    on phase 5's 4-shard ring grid against K4's (every bucket forced
    through K4) from the same init.  Then :func:`rank320_fit`.  Returns
    what the timings reuse."""
    r = RANK512
    tr = train_slice(data, r, seed, dev, max_iter=2)
    items = tr.pop("items")
    U0, ib, cfg = tr["U0"], tr["ib"], tr["cfg"]
    e64, nrows = widest_rows_f64(items, U0, data)
    log(f"rank {r}: the item half-step's widest rows ({nrows}: every row of "
        "the 4 widest buckets, the heaviest of the others) vs dense "
        "float64: " + ", ".join(f"{k} {v:.3e}" for k, v in e64.items())
        + f" (tol {TRAIN_REL})")
    if max(e64.values()) > TRAIN_REL:
        fail(f"rank {r}: a route is off the float64 solution: {e64}")

    # K7's item half-step on the ring grid, against K4's
    YtY = compute_yty(U0)
    Us = slot_rows(sh["upart"], U0)
    ish = sh["ish"].to(dev)
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x7 = ring_fused_half_step(
        Us, ish, sh["ish"].rows_per_shard, SHARDS,
        dataclasses.replace(cfg, solve_backend="gather_fused_ring"), YtY)
    torch.cuda.synchronize()
    w7 = time.perf_counter() - t0
    k7 = _launch_counts()
    if not k7["k7"] or sum(k7.values()) != k7["k7"]:
        fail(f"rank {r}: the ring half-step's launches: {k7}")
    V7 = entity_rows(sh["ipart"], x7)
    del x7, ish
    t0 = time.perf_counter()
    V4 = core_als.local_half_step(
        U0, ib, tr["n_items"],
        dataclasses.replace(cfg, solve_backend="gather_fused_solve"), YtY)
    torch.cuda.synchronize()
    w4 = time.perf_counter() - t0
    e7, e4 = row_rel(V7, V4), row_rel(V4, items["auto"])
    log(f"rank {r}: K7's item half-step on the {SHARDS}-shard ring grid "
        f"({k7['k7']} launches, {w7 * 1e3:.1f} ms) vs K4's on every "
        f"bucket ({w4 * 1e3:.1f} ms): max per-row |diff|/|x| {e7:.3e}; K4's "
        f"vs 'auto' {e4:.3e} (tol {TRAIN_REL})")
    if not (torch.isfinite(V7).all() and e7 <= TRAIN_REL
            and e4 <= TRAIN_REL):
        fail(f"rank {r}: K7's half-step is off K4's: {e7:.3e} ({e4:.3e})")
    del V4, V7, items
    rank320_fit(seed, dev)
    tr["ring"] = {"ish": sh["ish"], "icounts": sh["icounts"], "U0": Us,
                  "launches": {"k7": k7["k7"]}}
    return tr


def implicit_objective(model, frame, factors=None, chunk=1 << 21):
    """The implicit ALS objective (Hu–Koren–Volinsky, weighted λ, the
    quantity the fit's normal equations minimize), in float64 on the
    card: Σ over all pairs of (u·v)², plus over each rating c·(p - u·v)²
    - (u·v)² with c = 1 + α|r| and p = [r > 0], plus λ·(Σ n_u |u|² +
    Σ n_i |v|²) with n counting the positive ratings.  ``factors``:
    ``(U, V)`` in the model's row order instead of the model's own."""
    U, V = factors if factors is not None else (model._U, model._V)
    U, V = U.double(), V.double()
    dev = U.device
    u = torch.from_numpy(model._user_map.to_dense(frame["user"])).to(dev)
    i = torch.from_numpy(model._item_map.to_dense(frame["item"])).to(dev)
    r = torch.from_numpy(np.asarray(frame["rating"])).to(dev).double()
    total = ((U.T @ U) * (V.T @ V)).sum()
    for s0 in range(0, len(r), chunk):
        sl = slice(s0, s0 + chunk)
        sc = (U[u[sl]] * V[i[sl]]).sum(1)
        c = 1.0 + ALPHA * r[sl].abs()
        total += (c * ((r[sl] > 0).double() - sc) ** 2 - sc ** 2).sum()
    pos = r > 0
    nu = torch.bincount(u[pos], minlength=U.shape[0]).double()
    ni = torch.bincount(i[pos], minlength=V.shape[0]).double()
    total += REG * ((nu * (U * U).sum(1)).sum()
                    + (ni * (V * V).sum(1)).sum())
    return float(total)


def guarded_fit(frame, mode, spec, max_iter=3, keep=None):
    """``ALS(rank=128, implicit, alpha 40, regParam 0.01, seed FIT_SEED)
    .fit`` with ``guardrails=mode`` under the fault ``spec``, on a fresh
    obs registry, its launches counted: (model, launches, iteration walls
    in ms between fitCallback calls, obs registry).  ``keep``: a dict
    that receives a copy of the factors after iteration 1 as
    ``keep["it1"]``."""
    ticks = []

    def tick(it, U, V):
        torch.cuda.synchronize()
        ticks.append(time.perf_counter())
        if keep is not None and it == 1:
            keep["it1"] = (U.clone(), V.clone())

    faults.clear()
    if spec:
        faults.install(spec)
    reg = obs.reset()
    est = ALS(rank=RANK, implicitPrefs=True, alpha=ALPHA, regParam=REG,
              maxIter=max_iter, seed=FIT_SEED, guardrails=mode,
              fitCallback=tick)
    _zero_launches()
    try:
        model = est.fit(frame)
        torch.cuda.synchronize()
    finally:
        faults.clear()
    walls = [(b - a) * 1e3 for a, b in zip(ticks, ticks[1:])]
    return model, _launch_counts(), walls, reg


def replay_recovery(model, it1, data, frame, clean_obj):
    """The 'recover' fit's rollback replayed without the guardrails, row
    by row: the factors after iteration 1 (the clean snapshot) perturbed
    by the rollback's seeded draw, then iteration 2 at regParam x
    REG_BUMP_FACTOR and iteration 3 at regParam, through 'auto' (K4).
    The recovered factors must lie within TRAIN_REL of that replay, and
    two faulty recoveries (the bump left in place for iteration 3; no
    bump at all) must not: they show what the check and the objective
    tell apart."""
    U1, V1 = it1
    dev = U1.device
    g = torch.Generator(device=dev).manual_seed(
        (FIT_SEED * 1_000_003 + 2 * 101 + 1) & 0x7FFFFFFF)
    Up = U1 + guardrails.PERTURB_SCALE * torch.randn(
        U1.shape, generator=g, device=dev, dtype=U1.dtype)
    Vp = V1 + guardrails.PERTURB_SCALE * torch.randn(
        V1.shape, generator=g, device=dev, dtype=V1.dtype)
    cfg = core_als.AlsConfig(rank=RANK, implicit_prefs=True, alpha=ALPHA,
                             reg_param=REG)
    bump = REG * guardrails.REG_BUMP_FACTOR
    dist = {}
    for name, regs in (("sound", (bump, REG)),
                       ("bump kept for iteration 3", (bump, bump)),
                       ("no bump", (REG, REG))):
        U, V = Up, Vp
        for reg in regs:
            U, V = core_als.als_step(
                U, V, data["ub"], data["ib"], data["n_users"],
                data["n_items"], dataclasses.replace(cfg, reg_param=reg))
        torch.cuda.synchronize()
        obj = implicit_objective(model, frame, factors=(U, V))
        dist[name] = (max(row_rel(model._U, U), row_rel(model._V, V)),
                      abs(obj - clean_obj) / clean_obj)
        del U, V
    log("recover fit vs its replay without the guardrails (max per-row "
        "|diff|/|x|; the replay's objective off the clean fit's): "
        + "; ".join(f"{k} {d:.3e}, objective {o:.3e}"
                    for k, (d, o) in dist.items())
        + f" (tol {TRAIN_REL}, the faulty ones must exceed it)")
    if not dist["sound"][0] <= TRAIN_REL:
        fail(f"recover: the factors are {dist['sound'][0]:.3e} off the "
             "replayed recovery")
    for k, (d, _) in dist.items():
        if k != "sound" and not d > TRAIN_REL:
            fail(f"recover: the row check cannot tell the faulty recovery "
                 f"'{k}' ({d:.3e}) from the sound one")


def guardrail_fits(data, tr, dev):
    """The guardrails at the ML-25M shape, rank 128: 'recover' under
    ``solve.gram=corrupt@nth=2`` (exactly one rollback, finite factors,
    the implicit objective within RECOVER_OBJ_REL of the clean fit's);
    'warn' under the same fault (a trip and no rollback); a clean
    'recover' fit (the armed iteration: K3 + the laddered K2 for K4's
    buckets, against the clean fit row by row); then ratings poisoned
    with NaN, inf, 1e9 and 2e6 quarantined with the exact count.  Each
    fit's launches are counted from 0."""
    frame = data["frame"]
    spec = "solve.gram=corrupt@nth=2"
    clean_obj = implicit_objective(tr["model"], frame)
    off_walls = [x * 1e3 for x in tr["iter_s"]]

    keep = {}
    model, launches, rec_walls, reg = guarded_fit(frame, "recover", spec,
                                                  keep=keep)
    trips = [(e["iteration"], e["sentinel"])
             for e in reg.events("guardrail_tripped")]
    rollbacks = reg.counter_value("train.rollbacks")
    log(f"recover + {spec}: launches " + ", ".join(
        f"{k.upper()} {v}" for k, v in launches.items() if v)
        + f"; trips {trips}, rollbacks {rollbacks}; iterations (ms) "
        + ", ".join(f"{w:.1f}" for w in rec_walls))
    if rollbacks != 1 or trips != [(2, "nonfinite")] or \
            len(reg.events("train_rollback")) != 1:
        fail(f"recover: expected one rollback at iteration 2, got trips "
             f"{trips}, {rollbacks} rollbacks")
    if min(launches[k] for k in ("k1", "k2", "k3")) == 0 or launches["k4"]:
        fail(f"recover: the armed path is K3 + K1/K2, not K4: {launches}")
    if not (torch.isfinite(model._U).all() and torch.isfinite(model._V).all()):
        fail("recover: the factors are not finite")
    obj = implicit_objective(model, frame)
    rel = abs(obj - clean_obj) / clean_obj
    log(f"implicit objective: clean fit {clean_obj:.8e}, recover fit "
        f"{obj:.8e}, relative difference {rel:.3e} (tol {RECOVER_OBJ_REL})")
    if not rel <= RECOVER_OBJ_REL:
        fail(f"recover: objective {rel:.3e} off the clean fit's")
    replay_recovery(model, keep["it1"], data, frame, clean_obj)
    del model, keep

    model, launches, warn_walls, reg = guarded_fit(frame, "warn", spec)
    trips = [(e["iteration"], e["sentinel"])
             for e in reg.events("guardrail_tripped")]
    log(f"warn + {spec}: launches " + ", ".join(
        f"{k.upper()} {v}" for k, v in launches.items() if v)
        + f"; trips {trips}, rollbacks "
        f"{reg.counter_value('train.rollbacks')}; iterations (ms) "
        + ", ".join(f"{w:.1f}" for w in warn_walls)
        + " (iteration 3 runs on the poisoned factors)")
    if not trips or trips[0] != (2, "nonfinite") or \
            reg.counter_value("train.rollbacks") or \
            reg.events("train_rollback"):
        fail(f"warn: expected a trip at iteration 2 and no rollback: {trips}")
    if min(launches[k] for k in ("k1", "k3", "k4")) == 0:
        fail(f"warn: the fit's path is K4 + K3 + K1: {launches}")
    del model

    model, launches, arm_walls, reg = guarded_fit(frame, "recover", None)
    if reg.events("guardrail_tripped") or \
            min(launches[k] for k in ("k1", "k2", "k3")) == 0:
        fail(f"clean recover fit: trips or launches {launches}")
    eu = row_rel(model._U, tr["model"]._U)
    ev = row_rel(model._V, tr["model"]._V)
    log(f"clean recover fit vs the guardrails-off fit: max per-row "
        f"|diff|/|x| users {eu:.3e}, items {ev:.3e} (tol {TRAIN_REL})")
    if not (eu <= TRAIN_REL and ev <= TRAIN_REL):
        fail(f"clean recover fit off the plain fit: {eu:.3e}, {ev:.3e}")
    del model
    log(f"iteration wall by guardrails mode, rank {RANK}, iterations 2-3 "
        "(ms): "
        f"off {', '.join(f'{w:.1f}' for w in off_walls)}; warn "
        f"{warn_walls[0]:.1f} (iteration 2); recover "
        f"{', '.join(f'{w:.1f}' for w in arm_walls)} (armed cost "
        f"{np.mean(arm_walls) - np.mean(off_walls):+.1f} ms an iteration)")

    # poisoned ratings: quarantined, not fit
    r = np.array(frame["rating"], dtype=np.float32)
    bad = np.arange(17, len(r), 1_000_003)
    r[bad] = np.resize(np.array([np.nan, np.inf, 1e9, -2e6], np.float32),
                       len(bad))
    poisoned = {"user": frame["user"], "item": frame["item"], "rating": r}
    model, launches, _, reg = guarded_fit(poisoned, "warn", None,
                                          max_iter=1)
    got = reg.counter_value("ingest.quarantined_rows")
    ev = reg.events("ingest_quarantined")
    log(f"poisoned fit ({len(bad)} of {len(r)} ratings NaN/inf/1e9/-2e6, "
        f"guardrails='warn', 1 iteration): quarantined {got}, reasons "
        f"{ev[0]['reasons'] if ev else None}")
    if got != len(bad) or len(ev) != 1:
        fail(f"poisoned fit: quarantined {got}, expected {len(bad)}")
    if not (torch.isfinite(model._U).all() and torch.isfinite(model._V).all()):
        fail("poisoned fit: the factors are not finite")


# -- phase 6 ---------------------------------------------------------------
def foldin_batch(rng, n_users, existing, first_new, items):
    """Hourly-style batch: ``n_users`` distinct ids, half of them new,
    power-law rating counts capped at 256, half-star ratings of ids drawn
    from ``items``."""
    half = n_users // 2
    users = np.concatenate([
        rng.choice(existing, half, replace=False),
        first_new + np.arange(n_users - half)])
    counts = np.minimum(256, 1 + (rng.pareto(0.8, n_users) * 4)
                        .astype(np.int64))
    u = np.repeat(users, counts)
    i = rng.choice(items, len(u))
    r = (rng.integers(1, 11, len(u)) * 0.5).astype(np.float32)
    return {"user": u, "item": i, "rating": r}, users


def run_slice(rng, dev):
    U0 = unit_rows(rng, N_USERS, RANK)
    V0 = unit_rows(rng, N_ITEMS, RANK)
    params = {"rank": RANK, "implicitPrefs": True, "alpha": 40.0,
              "regParam": 0.01, "nonnegative": False, "userCol": "user",
              "itemCol": "item", "ratingCol": "rating",
              "predictionCol": "prediction", "coldStartStrategy": "nan",
              "blockSize": 4096}
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/model"
        model_from_arrays(RANK, np.arange(N_USERS), U0, np.arange(N_ITEMS),
                          V0, params, device=dev).save(path)
        model = ALSModel.load(path)            # device=None -> cuda
    if model.device.type != dev.type or not torch.equal(
            model._U.cpu(), torch.from_numpy(U0)):
        fail("save/load did not round-trip the user factors onto the card")

    batch1, users1 = foldin_batch(rng, 4096, np.arange(N_USERS), N_USERS,
                                  np.arange(N_ITEMS))
    # the plain reference for batch 1, before any fold-in moves the model
    touched_ref, cols, vals, mask = pack_rows(
        batch1["user"], batch1["item"], batch1["rating"])
    A, b, count = normal_eqs(
        model._V, torch.from_numpy(cols).to(dev),
        torch.from_numpy(vals).to(dev), torch.from_numpy(mask).to(dev),
        0.01, implicit_prefs=True, alpha=40.0, YtY=compute_yty(model._V))
    A_slice, b_slice = regularize(A, count), b.contiguous()
    x_ref = cuda_lanes.chol_solve_plain(A_slice, b_slice)
    del A, b

    srv = FoldInServer(model)
    srv.prewarm(rows=(4096,), widths=(256,))
    later = [foldin_batch(rng, 4096, np.arange(N_USERS),
                          N_USERS + 4096 * (j + 1), np.arange(N_ITEMS))[0]
             for j in range(4)]
    ib = {"user": rng.integers(0, N_USERS, 8192),
          "item": np.repeat(np.concatenate([
              rng.choice(N_ITEMS, 256, replace=False),
              N_ITEMS + np.arange(256)]), 16),
          "rating": (rng.integers(1, 11, 8192) * 0.5).astype(np.float32)}
    pairs = {"user": rng.integers(0, N_USERS + 8192, 100_000),
             "item": rng.integers(0, N_ITEMS + 512, 100_000)}

    cuda_lanes.LAUNCHES = 0
    cuda_topk.LAUNCHES = 0
    touched = srv.update(batch1)
    x1 = model._U[torch.from_numpy(
        model._user_map.to_dense(touched)).to(dev)].clone()
    for bt in later:
        srv.update(bt)
    # before update_items, whose batch also lands in srv.stats
    n_user_batches, p50 = len(srv.stats), srv.latency(0.5)
    items_touched = srv.update_items(ib)
    recs = model.recommendForUserSubset({"user": users1}, 10)
    t0 = time.perf_counter()
    _, rec_ids, rec_scores = model.recommend_arrays(10)
    rec_wall = time.perf_counter() - t0
    preds = model.transform(pairs)["prediction"]
    launches = {"k2": cuda_lanes.LAUNCHES, "k5": cuda_topk.LAUNCHES}
    log(f"slice launches: K2 {launches['k2']}, K5 {launches['k5']}")
    if launches["k2"] == 0 or launches["k5"] == 0:
        fail(f"a kernel of the serving path never launched: {launches}")

    # checks on what came out
    if not np.array_equal(touched, touched_ref):
        fail("fold-in touched set differs from the packed batch")
    rel = ((x1 - x_ref).norm(dim=1) / x_ref.norm(dim=1).clamp(min=1e-30))
    rel_max = rel.max().item()
    if not torch.isfinite(x1).all() or rel_max > FOLDIN_REL:
        fail(f"fold-in vs plain on the card: max rel err {rel_max:.3e}")
    log(f"fold-in batch 1 ({len(touched)} users, "
        f"{len(batch1['user'])} ratings): max |x - x_plain|/|x_plain| "
        f"{rel_max:.3e} (tol {FOLDIN_REL})")
    if len(items_touched) != 512 or len(model._item_map) != N_ITEMS + 256:
        fail("update_items did not fold in 512 items (256 new)")
    new_users = set(users1[users1 >= N_USERS].tolist())
    rows = [j for j, u in enumerate(recs["user"]) if int(u) in new_users]
    if len(rows) != len(new_users):
        fail("a new user is missing from recommendForUserSubset")
    sc = recs["recommendations"]["rating"][rows]
    if not (np.isfinite(sc).all() and (np.diff(sc, axis=1) <= 0).all()):
        fail("new users' scores are not finite and sorted")
    n_all = model._U.shape[0]
    check_recommend_all(model, rec_ids, rec_scores, rng, dev,
                        "recommend_arrays")
    known = ((model._user_map.to_dense(pairs["user"]) >= 0)
             & (model._item_map.to_dense(pairs["item"]) >= 0))
    if not (np.isfinite(preds[known]).all() and np.isnan(preds[~known]).all()):
        fail("transform: NaN exactly where an id is unknown was violated")
    log(f"recommend_arrays: {n_all} users x k=10 in {rec_wall * 1e3:.1f} ms "
        "(host clock, results on the host)")
    log(f"fold-in p50 latency: {p50 * 1e3:.1f} ms over "
        f"{n_user_batches} user batches of 4096 users")
    return model, launches, A_slice, b_slice, users1


def check_recommend_all(model, rec_ids, rec_scores, rng, dev, where):
    """recommend_arrays' scores against the plain top-k on 2,048 sampled
    users, and each id earning its score."""
    n_all = model._U.shape[0]
    if rec_ids.shape != (n_all, 10) or not np.isfinite(rec_scores).all():
        fail(f"{where}: recommend_arrays shape {rec_ids.shape} for {n_all} "
             "users")
    sample = torch.from_numpy(rng.choice(n_all, 2048, replace=False)).to(dev)
    Us = model._U[sample]
    valid_all = torch.ones(model._V.shape[0], dtype=torch.bool, device=dev)
    sp, _ = chunked_topk_scores(Us, model._V, valid_all, 10)
    dense_ids = torch.from_numpy(
        model._item_map.to_dense(rec_ids[sample.cpu().numpy()])).to(dev)
    got = torch.from_numpy(rec_scores[sample.cpu().numpy()]).to(dev)
    if not torch.allclose(got, sp, rtol=K5_TOL, atol=K5_TOL):
        fail(f"{where}: recommend_arrays scores differ from the plain top-k")
    earns_scores(Us, model._V, valid_all, got, dense_ids, where)


def serve_slice_256(fitted, rng, dev):
    """Serving at rank 256: the rank-256 fit's factors carried by
    ``model_from_arrays`` through save/load, ``FoldInServer.update`` on
    two hourly-style batches of 4,096 users, half new (K6), then
    ``recommendForUserSubset`` and ``recommend_arrays`` for all users (K5
    at r = 256), with K6/K5 launch counts read around the run.  Returns
    the model, the launches and batch 1's regularized systems."""
    r = RANK256
    uids, iids = fitted._user_map.ids, fitted._item_map.ids
    U0, V0 = fitted._U.cpu().numpy(), fitted._V.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/model"
        model_from_arrays(r, uids, U0, iids, V0, fitted._params,
                          device=dev).save(path)
        model = ALSModel.load(path)            # device=None -> cuda
    if model.rank != r or not torch.equal(model._U.cpu(),
                                          torch.from_numpy(U0)):
        fail("rank 256: save/load did not round-trip the user factors")
    first_new = int(uids.max()) + 1
    batches = [foldin_batch(rng, 4096, uids, first_new + 4096 * j, iids)
               for j in range(2)]
    batch1, users1 = batches[0]
    touched_ref, cols, vals, mask = pack_rows(
        batch1["user"], model._item_map.to_dense(batch1["item"]),
        batch1["rating"])
    A, b, count = normal_eqs(
        model._V, torch.from_numpy(cols).to(dev),
        torch.from_numpy(vals).to(dev), torch.from_numpy(mask).to(dev),
        REG, implicit_prefs=True, alpha=ALPHA, YtY=compute_yty(model._V))
    A_slice, b_slice = regularize(A, count), b.contiguous()
    del A, b
    x_ref = cuda_lanes_blocked.chol_lanes_blocked_solve_plain(
        A_slice.clone(), b_slice)

    srv = FoldInServer(model)
    _zero_launches()
    touched = srv.update(batch1)
    x1 = model._U[torch.from_numpy(
        model._user_map.to_dense(touched)).to(dev)].clone()
    srv.update(batches[1][0])
    p50 = srv.latency(0.5)
    recs = model.recommendForUserSubset({"user": users1}, 10)
    t0 = time.perf_counter()
    _, rec_ids, rec_scores = model.recommend_arrays(10)
    rec_wall = time.perf_counter() - t0
    launches = {"k6": cuda_lanes_blocked.LAUNCHES, "k5": cuda_topk.LAUNCHES}
    log(f"rank 256 serving launches: K6 {launches['k6']}, K5 "
        f"{launches['k5']} (K2 {cuda_lanes.LAUNCHES}, K1 "
        f"{cuda_solve.LAUNCHES})")
    if launches["k6"] == 0 or launches["k5"] == 0:
        fail(f"a kernel of the rank-256 serving path never launched: "
             f"{launches}")

    if not np.array_equal(touched, touched_ref):
        fail("rank 256: fold-in touched set differs from the packed batch")
    rel = ((x1 - x_ref).norm(dim=1) / x_ref.norm(dim=1).clamp(min=1e-30))
    rel_max = rel.max().item()
    if not torch.isfinite(x1).all() or rel_max > FOLDIN_REL:
        fail(f"rank 256 fold-in vs plain on the card: max rel err "
             f"{rel_max:.3e}")
    log(f"rank 256 fold-in batch 1 ({len(touched)} users, "
        f"{len(batch1['user'])} ratings): max |x - x_plain|/|x_plain| "
        f"{rel_max:.3e} (tol {FOLDIN_REL})")
    new_users = set(users1[users1 >= first_new].tolist())
    rows = [j for j, u in enumerate(recs["user"]) if int(u) in new_users]
    sc = recs["recommendations"]["rating"][rows]
    if len(rows) != len(new_users) or not (
            np.isfinite(sc).all() and (np.diff(sc, axis=1) <= 0).all()):
        fail("rank 256: new users' recommendations missing, not finite or "
             "not sorted")
    check_recommend_all(model, rec_ids, rec_scores, rng, dev,
                        "rank 256 recommend_arrays")
    log(f"rank 256 recommend_arrays: {model._U.shape[0]} users x k=10 in "
        f"{rec_wall * 1e3:.1f} ms (host clock, results on the host)")
    log(f"rank 256 fold-in p50 latency: {p50 * 1e3:.1f} ms over "
        f"{len(srv.stats)} user batches of 4096 users")
    return model, launches, A_slice, b_slice, users1


def sharded_serve_slice(model, mesh, dev):
    """recommend-all through ``recommend_arrays(10, mesh=...,
    gatherStrategy='merge_ring')`` (K8) for every user of ``model``, with
    K8's launches read around it, its wall and device time, then its
    scores against the single-device K5 sweep (within SERVE_ULPS ulp),
    each id earning its score, and the ids that differ from K5's
    counted."""
    _zero_launches()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    _, ids, scores = model.recommend_arrays(10, mesh=mesh,
                                            gatherStrategy="merge_ring")
    e1.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = _launch_counts()
    log(f"sharded serving launches: K8 {launches['k8']} (K5 "
        f"{launches['k5']})")
    if launches["k8"] == 0:
        fail(f"K8 never launched on the sharded serving path: {launches}")
    n = model._U.shape[0]
    _, ids1, sc1 = model.recommend_arrays(10)  # single device: K5
    if ids.shape != (n, 10) or not np.isfinite(scores).all():
        fail(f"sharded recommend_arrays: shape {ids.shape} for {n} users")
    ulps = np.abs(scores - sc1) / np.spacing(np.abs(sc1))
    if ulps.max() > SERVE_ULPS:
        fail(f"sharded scores {ulps.max():.1f} ulp off the K5 sweep")
    dense = torch.from_numpy(model._item_map.to_dense(ids)).to(dev)
    valid = torch.ones(model._V.shape[0], dtype=torch.bool, device=dev)
    err = earns_scores(model._U, model._V, valid,
                       torch.from_numpy(scores).to(dev), dense,
                       "sharded recommend_arrays")
    log(f"sharded recommend_arrays ({SHARDS} logical shards, merge_ring): "
        f"{n} users x k=10 in {wall:.1f} ms wall, {e0.elapsed_time(e1):.1f} "
        f"ms by CUDA events (results on the host); scores vs the K5 sweep "
        f"max {ulps.max():.1f} ulp (tol {SERVE_ULPS}), each id earns its "
        f"score ({err:.3e}); rows whose ids differ from K5's: "
        f"{int((ids != ids1).any(axis=1).sum())}")
    return launches


def topk_k200(model, mesh, rng, dev):
    """k = 200, above K5's 128 candidates, on the card: the scan route
    (``chunked_topk_scores``) behind ``topk_scores``, single-device
    (``recommendForUserSubset`` of 8,192 users, blocks of 4,096) and over
    the mesh (``recommend_arrays(200, mesh=..., 'merge_ring')``, which
    takes the ring strategy above 128), each id earning its score, and
    the first 128 scores against K5's k = 128 on the same users."""
    _zero_launches()
    cuda_topk.SCAN_CALLS = 0
    users = np.sort(rng.choice(model._user_map.ids, 8192, replace=False))
    recs = model.recommendForUserSubset({"user": users}, 200)
    single = cuda_topk.SCAN_CALLS
    _, ids, scores = model.recommend_arrays(200, mesh=mesh,
                                            gatherStrategy="merge_ring")
    launches = _launch_counts()
    log(f"k=200 recommend: scan route calls {single} single-device, "
        f"{cuda_topk.SCAN_CALLS - single} over the mesh (K5 "
        f"{launches['k5']}, K8 {launches['k8']})")
    if single == 0 or cuda_topk.SCAN_CALLS == single:
        fail("k = 200 did not take the scan route on the card")
    valid = torch.ones(model._V.shape[0], dtype=torch.bool, device=dev)
    rows = torch.from_numpy(model._user_map.to_dense(users)).to(dev)
    Q = model._U[rows]
    got = torch.from_numpy(np.ascontiguousarray(
        recs["recommendations"]["rating"])).to(dev)
    dense = torch.from_numpy(model._item_map.to_dense(
        recs["recommendations"]["item"])).to(dev)
    if got.shape != (8192, 200) or not torch.isfinite(got).all():
        fail(f"k=200 recommendForUserSubset: shape {tuple(got.shape)}")
    e1 = earns_scores(Q, model._V, valid, got, dense,
                      "k=200 recommendForUserSubset")
    s128, _ = cuda_topk.topk_scores(Q.contiguous(), model._V, valid, 128)
    if not torch.allclose(got[:, :128], s128, rtol=K5_TOL, atol=K5_TOL):
        fail("k=200: the first 128 scores differ from K5's k = 128")
    n = model._U.shape[0]
    if ids.shape != (n, 200) or not np.isfinite(scores).all():
        fail(f"k=200 over the mesh: shape {ids.shape} for {n} users")
    sample = rng.choice(n, 8192, replace=False)
    e2 = earns_scores(model._U[torch.from_numpy(sample).to(dev)], model._V,
                      valid, torch.from_numpy(scores[sample]).to(dev),
                      torch.from_numpy(model._item_map.to_dense(
                          ids[sample])).to(dev),
                      "k=200 recommend_arrays over the mesh")
    log(f"k=200: recommendForUserSubset of 8192 users and recommend_arrays "
        f"of {n} users over {SHARDS} logical shards: each id earns its "
        f"score ({e1:.3e}, {e2:.3e}; tol {K5_TOL}); the first 128 within "
        f"{K5_TOL} of K5's k = 128")


def recommend_zero(model):
    """k = 0: empty [n, 0] results, no launch."""
    _zero_launches()
    q, ids, scores = model.recommend_arrays(0)
    recs = model.recommendForAllItems(0)
    if ids.shape != (len(q), 0) or scores.shape != (len(q), 0) \
            or scores.dtype != np.float32 \
            or recs["recommendations"].shape != (len(model._item_map), 0):
        fail(f"k=0: shapes {ids.shape}, {scores.shape}, "
             f"{recs['recommendations'].shape}")
    if any(_launch_counts().values()):
        fail(f"k=0 launched a kernel: {_launch_counts()}")
    log(f"k=0: recommend_arrays gives ids {ids.shape} {ids.dtype} and "
        f"scores {scores.shape} {scores.dtype}, recommendForAllItems "
        f"{recs['recommendations'].shape}; no launch")


def dense_half_step_f64(F, rows, cols, vals, n_rows, reg, alpha):
    """One implicit half-step against the factors ``F`` in float64,
    densely, on F's device: W[i, u] sums the confidences of row i's
    ratings by column u (duplicates add, as the gathered entries do)."""
    dev, r = F.device, F.shape[1]
    F64 = F.double()
    rows = torch.as_tensor(np.asarray(rows), device=dev).long()
    cols = torch.as_tensor(np.asarray(cols), device=dev).long()
    vals = torch.as_tensor(np.asarray(vals), device=dev).double()
    conf, pref = alpha * vals.abs(), (vals > 0).double()
    W = torch.zeros(n_rows, F.shape[0], dtype=torch.float64, device=dev)
    P = torch.zeros_like(W)
    W.index_put_((rows, cols), conf, accumulate=True)
    P.index_put_((rows, cols), (1.0 + conf) * pref, accumulate=True)
    cnt = torch.zeros(n_rows, dtype=torch.float64, device=dev)
    cnt.index_put_((rows,), pref, accumulate=True)
    eye = torch.eye(r, dtype=torch.float64, device=dev)
    FtF = F64.T @ F64
    x64 = torch.empty(n_rows, r, dtype=torch.float64, device=dev)
    step = max(1, (1 << 26) // (F.shape[0] * r))   # 512 MB of W * F a step
    for s0 in range(0, n_rows, step):
        sl = slice(s0, s0 + step)
        A = (W[sl, :, None] * F64[None]).transpose(1, 2) @ F64 \
            + FtF + (reg * cnt[sl] + 1e-6)[:, None, None] * eye
        x64[sl] = torch.linalg.solve(A, (P[sl] @ F64)[..., None])[..., 0]
    return x64


def rank320_fit(seed, dev):
    """``ALS(rank=320).fit`` on the card: every bucket of this frame is
    narrow, so 'auto' takes K4 (its Gram staged by strips, its solve on a
    thread-block cluster above rank 288) and nothing else.  Then one more item
    half-step on the card against a float64 solve of the same normal
    equations, row by row."""
    frame = synthetic_movielens(2000, 800, 40_000, seed=seed)
    _zero_launches()
    t0 = time.perf_counter()
    model = ALS(rank=320, maxIter=2, implicitPrefs=True, alpha=ALPHA,
                regParam=REG).fit(frame)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    log(f"rank 320 fit (2000 x 800 x 40000, 2 iterations): {wall:.2f} s "
        "wall; launches " + ", ".join(f"{k.upper()} {v}"
                                      for k, v in launches.items() if v))
    if launches["k4"] == 0 or sum(launches.values()) != launches["k4"]:
        fail(f"rank 320 did not take K4 alone: {launches}")
    U, V = model._U, model._V
    if not (torch.isfinite(U).all() and torch.isfinite(V).all()) \
            or U.shape[1] != 320:
        fail("rank 320: the fitted factors are not finite")
    i_idx, imap = remap_ids(frame["item"])
    u_idx, _ = remap_ids(frame["user"])
    icsr = build_csr_buckets(i_idx, u_idx, frame["rating"], len(imap))
    cfg = core_als.AlsConfig(rank=320, implicit_prefs=True, alpha=ALPHA,
                             reg_param=REG)
    x = core_als.local_half_step(U, icsr.to(dev), len(imap), cfg,
                                 compute_yty(U))
    x64 = dense_half_step_f64(U, i_idx, u_idx, frame["rating"], len(imap),
                              REG, ALPHA)
    err = row_rel(x.double(), x64)
    log(f"rank 320: one item half-step on the card vs float64: max "
        f"per-row |diff|/|x| {err:.3e} (tol {TRAIN_REL})")
    if not err <= TRAIN_REL:
        fail(f"rank 320: the half-step is {err:.3e} off float64")


# -- phase 7: model selection and evaluation ---------------------------------
ML100K_SHAPE = (943, 1682, 100_000)     # BASELINE config 1's shape
SELECT_RANKS, SELECT_REGS = (10, 128), (0.05, 1.0)
# the card's fold metrics against the CPU's (the same port, the same init
# from a CPU generator; the kernels against their plain versions)
SELECT_METRIC_REL = 1e-4
# the legacy fit (rank 10, 10 iterations at its default lambda 0.01) on
# the card against the CPU: max over rows of |x - x_cpu| / |x_cpu|, and
# the recommendation scores relative to the CPU's; the repo's band for
# two solve routes (rtol 5e-3): this fit amplifies the routes' f32
# rounding over its 10 iterations
LEGACY_ROW_REL = 5e-3
LEGACY_SCORE_REL = 5e-3
# a resumed fit against the uninterrupted one when the kernels are not
# run-to-run deterministic
RESUME_ABS = 1e-5


def string_frame(seed):
    """ML-100K-shaped ratings with the ids turned into strings, the
    shape of a production log (examples/02_pipeline_string_ids.py)."""
    raw = synthetic_movielens(*ML100K_SHAPE, seed=seed)
    return ColumnarFrame({
        "userName": np.array([f"u{k:05d}" for k in raw["user"]], object),
        "movie": np.array([f"m{k:05d}" for k in raw["item"]], object),
        "rating": raw["rating"]})


def selection_cv(frame, seed, device):
    """``Pipeline([StringIndexer, StringIndexer, ALS])`` cross-validated
    over rank x regParam in 3 folds on ``device``."""
    als = ALS(userCol="user", itemCol="item", maxIter=10,
              coldStartStrategy="drop", seed=seed, device=device)
    pipe = Pipeline(stages=[
        StringIndexer(inputCol="userName", outputCol="user",
                      handleInvalid="skip"),
        StringIndexer(inputCol="movie", outputCol="item",
                      handleInvalid="skip"),
        als])
    grid = (ParamGridBuilder().addGrid(als.rank, list(SELECT_RANKS))
            .addGrid(als.regParam, list(SELECT_REGS)).build())
    cv = CrossValidator(estimator=pipe, estimatorParamMaps=grid,
                        evaluator=RegressionEvaluator(labelCol="rating"),
                        numFolds=3, seed=seed)
    t0 = time.perf_counter()
    model = cv.fit(frame)
    return model, time.perf_counter() - t0


_CPU_CV = (
    "import json, sys\n"
    "import chip_smoke as cs\n"
    "seed = int(sys.argv[1])\n"
    "m, wall = cs.selection_cv(cs.string_frame(seed), seed, 'cpu')\n"
    "print(json.dumps({'fold': [[float(x) for x in f] for f in\n"
    "    m.foldMetrics], 'avg': [float(x) for x in m.avgMetrics],\n"
    "    'wall': wall}))\n")


def start_cpu_cv(seed):
    """(a)'s cross-validation with ``device='cpu'``, as a process: it runs
    beside phases 2-4 (kernel checks on the card, no timing), started
    after the build and waited for before phase 5's host work."""
    return subprocess.Popen(
        [sys.executable, "-c", _CPU_CV, str(seed)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)), env=proc_env())


def finish_cpu_cv(p):
    """The CPU cross-validation's fold and average metrics and its wall
    (a failure, or no exit within 900 s, fails the run)."""
    t0 = time.perf_counter()
    try:
        out, err = p.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        fail("the CPU cross-validation: no exit within 900 s")
    if p.returncode != 0:
        fail(f"the CPU cross-validation exited {p.returncode}: {err[-2000:]}")
    log(f"the CPU cross-validation (phase 7(a)) ran beside phases 2-4; "
        f"waited {time.perf_counter() - t0:.1f} s more for it")
    return json.loads(out.strip().splitlines()[-1])


def pipeline_selection(seed, dev, tmp, cpu):
    """(a) examples/02's workflow at BASELINE config 1's scale: the
    pipeline cross-validated on the card and on the CPU (``cpu``:
    :func:`finish_cpu_cv`'s; every fold's metric within
    SELECT_METRIC_REL, the same best index), the CrossValidatorModel
    saved and loaded back as a PipelineModel (transform equal bit for
    bit), recommendForAllUsers(10) (K5) mapped back with IndexToString.
    Launches counted from 0 around the card's part."""
    frame = string_frame(seed)
    _zero_launches()
    cvm, wall = selection_cv(frame, seed, dev)
    best = cvm.bestModel
    recs_t0 = time.perf_counter()
    als_model = best.stages[-1]
    recs = als_model.recommendForAllUsers(10)
    recs_s = time.perf_counter() - recs_t0
    launches = _launch_counts()
    cpu_wall = cpu["wall"]
    fold = np.asarray(cvm.foldMetrics)
    fold_cpu = np.asarray(cpu["fold"])
    rel = float(np.max(np.abs(fold - fold_cpu) / np.abs(fold_cpu)))
    bi, bi_cpu = int(np.argmin(cvm.avgMetrics)), int(np.argmin(cpu["avg"]))
    log(f"(a) CrossValidator(3 folds) over rank {SELECT_RANKS} x regParam "
        f"{SELECT_REGS}, Pipeline(StringIndexer x2, ALS(maxIter=10)) at "
        f"ML-100K {ML100K_SHAPE}: card {wall:.2f} s, CPU {cpu_wall:.2f} s "
        f"measured beside phases 2-4, on a shared host (host clock, 12 "
        f"fits + the refit; not comparable with a CPU wall taken alone); "
        f"avg RMSE card "
        + ", ".join(f"{m:.6f}" for m in cvm.avgMetrics) + "; CPU "
        + ", ".join(f"{m:.6f}" for m in cpu["avg"])
        + f"; fold metrics max rel diff {rel:.3e} (tol {SELECT_METRIC_REL});"
        f" best index card {bi}, CPU {bi_cpu}")
    if not rel <= SELECT_METRIC_REL:
        fail(f"(a) the card's fold metrics are {rel:.3e} off the CPU's")
    if bi != bi_cpu:
        fail(f"(a) best index {bi} on the card, {bi_cpu} on the CPU")
    path = os.path.join(tmp, "cv")
    cvm.save(path)
    back = PipelineModel.load(os.path.join(path, "bestModel"), device=dev)
    back_cv = CrossValidatorModel.load(path, device=dev)
    pred = best.transform(frame)["prediction"]
    pred_back = back.transform(frame)["prediction"]
    if back_cv.avgMetrics != cvm.avgMetrics or \
            not np.array_equal(pred, pred_back):
        fail("(a) the saved CrossValidatorModel does not load back to the "
             "same predictions")
    users = IndexToString(inputCol="user", outputCol="userName",
                          labels=best.stages[0].labels).transform(
        ColumnarFrame({"user": recs["user"]}))["userName"]
    items = IndexToString(inputCol="item", outputCol="movie",
                          labels=best.stages[1].labels).transform(
        ColumnarFrame({"item": recs["recommendations"]["item"].ravel()})
    )["movie"]
    if set(users) != set(frame["userName"]) or \
            not set(items) <= set(frame["movie"]) or \
            recs["recommendations"].shape != (len(users), 10):
        fail("(a) recommendForAllUsers mapped back to labels the fit "
             "never saw")
    log(f"(a) saved and loaded: transform equal bit for bit on "
        f"{len(pred):,} rows; recommendForAllUsers(10) for {len(users)} "
        f"users {recs_s * 1e3:.1f} ms, mapped back by IndexToString; "
        "launches " + ", ".join(f"{k.upper()} {launches[k]}"
                                for k in ("k1", "k3", "k4", "k5")))
    if launches["k4"] == 0 or launches["k5"] == 0:
        fail(f"(a) the card's path did not launch K4 and K5: {launches}")
    return {"launches": launches, "wall": wall, "best": bi,
            "params": best.stages[-1]._params}


class TimedALS(ALS):
    """``ALS`` whose every fit records its log-to-model wall (host clock,
    ending in a device sync) in the class list ``walls``."""
    walls = []

    def _fit(self, dataset):
        t0 = time.perf_counter()
        model = super()._fit(dataset)
        torch.cuda.synchronize()
        TimedALS.walls.append(time.perf_counter() - t0)
        return model


def headline_rmse(frame, seed, dev):
    """(b) The headline, RMSE on MovieLens-25M: TrainValidationSplit(0.8)
    over explicit ALS(rank=128, maxIter=3) x regParam {0.05, 0.1} on the
    phase-5 frame; both RMSEs finite and below the training mean's, the
    best model the argmin, the refit finite; then the ranking protocol of
    ``evaluate`` on the validation split (recommendForUserSubset, K5)."""
    TimedALS.walls = []
    als = TimedALS(rank=RANK, maxIter=3, coldStartStrategy="drop",
                   seed=seed, device=dev)
    grid = ParamGridBuilder().addGrid(als.regParam, [0.05, 0.1]).build()
    tvs = TrainValidationSplit(
        estimator=als, estimatorParamMaps=grid, trainRatio=0.8, seed=seed,
        evaluator=RegressionEvaluator(labelCol="rating"))
    _zero_launches()
    t0 = time.perf_counter()
    model = tvs.fit(frame)
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    train, val = frame.randomSplit([0.8, 0.2], seed=seed)
    mean = float(np.mean(train["rating"], dtype=np.float64))
    base = float(np.sqrt(np.mean(
        (val["rating"].astype(np.float64) - mean) ** 2)))
    rmse = model.validationMetrics
    best = model.bestModel
    log(f"(b) TrainValidationSplit(0.8) over ALS(rank={RANK}, maxIter=3) "
        f"x regParam (0.05, 0.1) at ML-25M: validation RMSE "
        + ", ".join(f"{m:.6f}" for m in rmse)
        + f"; the training mean's {base:.6f}; best regParam "
        f"{best._params['regParam']}; fits (log-to-model, s) "
        + ", ".join(f"{w:.2f}" for w in TimedALS.walls)
        + f"; tuner {wall:.2f} s; launches " + ", ".join(
            f"{k.upper()} {launches[k]}" for k in ("k1", "k3", "k4", "k5")))
    if not all(np.isfinite(m) and m < base for m in rmse):
        fail(f"(b) validation RMSE {rmse} not finite or not below the "
             f"training mean's {base:.4f}")
    if best._params["regParam"] != [0.05, 0.1][int(np.argmin(rmse))]:
        fail("(b) the best model is not the argmin")
    if not (torch.isfinite(best._U).all() and torch.isfinite(best._V).all()):
        fail("(b) the refit's factors are not finite")
    if launches["k4"] == 0:
        fail(f"(b) the fits did not launch K4: {launches}")
    _zero_launches()
    t0 = time.perf_counter()
    rk = ranking_eval(best, val, 10, 3.5)
    ev_s = time.perf_counter() - t0
    k5 = _launch_counts()["k5"]
    # a random ranking of the catalog's expected precision@10: each
    # user's share of positive items in the catalog, averaged.  The
    # synthetic frame draws which items a user rates from popularity
    # alone, independent of the planted factors, so no model's top 10 of
    # the catalog beats this by more than noise: it is printed, and the
    # rankings' signal is checked on each user's own validation items
    pos = val["rating"] >= 3.5
    per_user = np.bincount(val["user"][pos])
    per_user = per_user[per_user > 0]
    chance = float(np.mean(per_user / best._V.shape[0]))
    own, own_chance = own_items_precision(best, val, 10, 3.5)
    log(f"(b) ranking on the validation split (rated >= 3.5 is the truth, "
        f"{rk['ranking_users']:,} users, {rk['ranking_users_cold']} cold): "
        f"precision@10 {rk['precision_at_10']:.6f} (a random ranking of "
        f"the catalog's {chance:.6f}), recall@10 {rk['recall_at_10']:.6f}, "
        f"MAP {rk['map']:.6f}, NDCG@10 {rk['ndcg_at_10']:.6f}; wall "
        f"{ev_s:.2f} s, K5 launches {k5}; each user's own validation items "
        f"ranked by the model: precision@10 {own:.6f}, a random order's "
        f"{own_chance:.6f}")
    if not all(0.0 <= rk[k] <= 1.0 for k in
               ("precision_at_10", "recall_at_10", "map", "ndcg_at_10")):
        fail(f"(b) a ranking metric outside [0, 1]: {rk}")
    if not own > own_chance:
        fail(f"(b) the model's order of each user's own items ({own:.6f}) "
             f"is not above a random order's ({own_chance:.6f})")
    if k5 == 0:
        fail("(b) the ranking protocol did not launch K5")
    return {"launches": launches, "walls": list(TimedALS.walls),
            "tuner": wall, "eval_s": ev_s, "k5": k5}


def own_items_precision(model, val, k, threshold):
    """(precision@k, a random order's expectation) when each validation
    user's own validation items are ranked by the model's score, the
    truth being those rated >= ``threshold``; users with no positive item
    and rows the model cannot score are left out."""
    out = model.transform(val)
    u = out["user"]
    pos = (out["rating"] >= threshold).astype(np.float64)
    order = np.lexsort((-out["prediction"], u))
    u, pos = u[order], pos[order]
    start = np.r_[0, np.flatnonzero(np.diff(u)) + 1]
    n = np.diff(np.r_[start, len(u)])
    rank = np.arange(len(u)) - np.repeat(start, n)
    hits = np.add.reduceat(np.where(rank < k, pos, 0.0), start)
    npos = np.add.reduceat(pos, start)
    keep = npos > 0
    prec = hits[keep] / k
    chance = npos[keep] / n[keep] * np.minimum(n[keep], k) / k
    return float(prec.mean()), float(chance.mean())


def legacy_fits(seed, dev):
    """(c) ``legacy.ALS.train(rank=10, iterations=10)`` at the ML-100K
    shape on the card and on the CPU: the factors row by row, and
    ``recommendProductsForUsers(10)`` (K5) against the CPU's."""
    raw = synthetic_movielens(*ML100K_SHAPE, seed=seed)
    ratings = list(zip(raw["user"].tolist(), raw["item"].tolist(),
                       raw["rating"].tolist()))
    _zero_launches()
    t0 = time.perf_counter()
    card = legacy.ALS.train(ratings, rank=10, iterations=10, seed=seed,
                            device=dev)
    recs = card.recommendProductsForUsers(10)
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    cpu = legacy.ALS.train(ratings, rank=10, iterations=10, seed=seed,
                           device="cpu")
    recs_cpu = cpu.recommendProductsForUsers(10)
    worst = 0.0
    for get in ("userFeatures", "productFeatures"):
        a, b = getattr(card, get)(), getattr(cpu, get)()
        if [i for i, _ in a] != [i for i, _ in b]:
            fail(f"(c) {get}: the ids differ")
        x = np.stack([f for _, f in a]).astype(np.float64)
        y = np.stack([f for _, f in b]).astype(np.float64)
        worst = max(worst, float(np.max(np.linalg.norm(x - y, axis=1)
                                        / np.linalg.norm(y, axis=1))))
    U = dict(card.userFeatures())
    P = dict(card.productFeatures())
    score_err, earn_err = 0.0, 0.0
    for (u, rs), (u2, rs2) in zip(recs, recs_cpu):
        if u != u2 or len(rs) != 10:
            fail("(c) recommendProductsForUsers: users or lengths differ")
        score_err = max(score_err, max(abs(a.rating - b.rating)
                                       / abs(b.rating)
                                       for a, b in zip(rs, rs2)))
        earn_err = max(earn_err, max(abs(float(U[u] @ P[a.product])
                                         - a.rating) for a in rs))
    log(f"(c) legacy ALS.train(rank=10, iterations=10) at ML-100K: card "
        f"{wall:.2f} s with recommendProductsForUsers(10); factors vs CPU "
        f"max row rel {worst:.3e} (tol {LEGACY_ROW_REL}); scores vs CPU "
        f"rel {score_err:.3e} (tol {LEGACY_SCORE_REL}), each id's own score "
        f"{earn_err:.3e}; launches " + ", ".join(
            f"{k.upper()} {launches[k]}" for k in ("k1", "k3", "k4", "k5")))
    if not worst <= LEGACY_ROW_REL:
        fail(f"(c) legacy factors {worst:.3e} off the CPU's")
    if not (score_err <= LEGACY_SCORE_REL and earn_err <= 1e-4):
        fail(f"(c) legacy recommendations off: {score_err:.3e}, "
             f"{earn_err:.3e}")
    if launches["k4"] == 0 or launches["k5"] == 0:
        fail(f"(c) the legacy path did not launch K4 and K5: {launches}")
    return {"launches": launches}


def proc_env(plan_dir=None):
    """The environment of a process the run starts: a fresh plan cache of
    its own unless ``plan_dir`` names one to share, so nothing a process
    banks (``serve-bench``'s observed ladder) steers another phase."""
    if plan_dir is None:
        plan_dir = tempfile.mkdtemp(prefix="proc_", dir=PLAN_ROOT)
    return {**os.environ, PLAN_ENV: plan_dir}


def run_cli(args, timeout=600):
    """``python -m tpu_als_torch.cli ARGS`` from the repository root;
    its last stdout line parsed as JSON."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "tpu_als_torch.cli", *args],
                         capture_output=True, text=True, timeout=timeout,
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         env=proc_env())
    if out.returncode != 0:
        fail(f"cli {args[0]} exited {out.returncode}: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1]), \
        time.perf_counter() - t0


_PROBE = (
    "import json, sys\n"
    "from tpu_als_torch import cli\n"
    "from tpu_als_torch.ops import (cuda_gather_ne, cuda_lanes,\n"
    "    cuda_lanes_blocked, cuda_solve, cuda_topk)\n"
    "if sys.argv[1] == '--gated':\n"
    "    del sys.argv[1]\n"
    "    print('ready', file=sys.stderr, flush=True)\n"
    "    go = sys.stdin.readline().split(' ', 1)\n"
    "    if go[0].strip() != 'go':\n"
    "        sys.exit(1)\n"
    "    sys.argv += json.loads(go[1]) if len(go) > 1 else []\n"
    "cli.main(sys.argv[1:])\n"
    "print(json.dumps({'k1': cuda_solve.LAUNCHES,\n"
    "    'k2': cuda_lanes.LAUNCHES, 'k3': cuda_gather_ne.GRAM_LAUNCHES,\n"
    "    'k4': cuda_gather_ne.SOLVE_LAUNCHES, 'k5': cuda_topk.LAUNCHES,\n"
    "    'k6': cuda_lanes_blocked.LAUNCHES}))\n")


def start_probe(args, gated=False, plan_dir=None):
    """``python -m tpu_als_torch.cli ARGS`` as a process that prints the
    kernels' launch counts after the command's own output.  ``gated``:
    the process imports torch and the package (host work, no CUDA call),
    says so on stderr, and waits for :func:`release_probe` before it runs
    the command.  ``plan_dir``: the plan cache it shares (default: a
    fresh one, :func:`proc_env`)."""
    return subprocess.Popen(
        [sys.executable, "-c", _PROBE, *(["--gated"] if gated else []),
         *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        stdin=subprocess.PIPE if gated else None, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=proc_env(plan_dir))


def probe_ready(p, what, timeout=120):
    """Wait until a gated probe has done its imports (what it wrote to
    stderr before is dropped)."""
    seen = []

    def read():
        for line in iter(p.stderr.readline, ""):
            seen.append(line)
            if line == "ready\n":
                return

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout)
    if not seen or seen[-1] != "ready\n":
        p.kill()
        fail(f"{what}: not ready within {timeout} s: {''.join(seen)[-2000:]}")


def release_probe(p, extra=()):
    """Let a gated probe run its command, with the arguments ``extra``
    appended."""
    p.stdin.write(f"go {json.dumps(list(extra))}\n" if extra else "go\n")
    p.stdin.flush()     # finish_probe's communicate() closes it


def finish_probe(p, what, timeout=600):
    """The command's stdout lines and its launch counts; a failure, or a
    process past ``timeout``, fails the run (the process is killed)."""
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        fail(f"{what}: no exit within {timeout} s")
    if p.returncode != 0:
        fail(f"{what} exited {p.returncode}: {err[-2000:]}")
    lines = out.strip().splitlines()
    return lines[:-1], json.loads(lines[-1])


def cli_selection(seed, tmp, dev):
    """(d) ``tune`` at (a)'s shape and grid, then ``evaluate --ranking-k
    10`` on its best model; both exit 0, and their JSON agrees with the
    saved CrossValidatorModel's metrics and with the same evaluation
    computed in this process."""
    spec = "synthetic:{}x{}x{}".format(*ML100K_SHAPE)
    out = os.path.join(tmp, "tune")
    # evaluate imports beside tune (gated), and runs once tune's model is
    # saved: one process start-up on the clock instead of two
    pe = start_probe(["evaluate", "--model", os.path.join(out, "bestModel"),
                      "--data", spec, "--ranking-k", "10", "--device",
                      str(dev)], gated=True)
    t0 = time.perf_counter()
    lines, _ = finish_probe(start_probe(
        ["tune", "--data", spec, "--ranks", ",".join(map(str, SELECT_RANKS)),
         "--reg-params", ",".join(map(str, SELECT_REGS)), "--folds", "3",
         "--max-iter", "10", "--seed", str(seed), "--output", out,
         "--device", str(dev)]), "cli tune")
    tune, tune_s = json.loads(lines[-1]), time.perf_counter() - t0
    probe_ready(pe, "cli evaluate")
    t0 = time.perf_counter()
    release_probe(pe)
    lines, _ = finish_probe(pe, "cli evaluate")
    ev, ev_s = json.loads(lines[-1]), time.perf_counter() - t0
    cvm = CrossValidatorModel.load(out, device=dev)
    best = cvm.bestModel
    mine = {"best_rank": int(best._params["rank"]),
            "best_regParam": float(best._params["regParam"]),
            "avg_metrics": [round(float(m), 4) for m in cvm.avgMetrics],
            "grid_size": len(SELECT_RANKS) * len(SELECT_REGS)}
    frame = synthetic_movielens(*ML100K_SHAPE)
    pred = best.transform(frame)
    mine_ev = {m: round(RegressionEvaluator(labelCol="rating",
                                            metricName=m).evaluate(pred), 4)
               for m in ("rmse", "mae", "r2")}
    mine_ev.update({k: v if isinstance(v, int) else round(v, 4)
                    for k, v in ranking_eval(best, frame, 10).items()})
    log(f"(d) cli tune {tune_s:.1f} s: {json.dumps(tune)}; cli evaluate "
        f"{ev_s:.1f} s once released: {json.dumps(ev)}")
    if tune != mine or ev != mine_ev:
        fail(f"(d) the CLI's JSON disagrees with this process: tune "
             f"{tune} vs {mine}, evaluate {ev} vs {mine_ev}")


def checkpoint_lifecycle(seed, tmp, dev):
    """(e) ``train`` at the ML-100K shape, rank 128, 6 iterations, a
    checkpoint every 2: TPU_ALS_PREEMPT_AT=3 exits 43 with a checkpoint
    at iteration 3, ``--resume auto`` finishes it; then a torn save
    (``checkpoint.write=corrupt@nth=2``, iteration 4) beside an
    iteration-2 ``.old`` is quarantined to ``.corrupt/`` and ``.old``
    resumed.  Both resumed fits against an uninterrupted one, row by
    row: bit for bit, or within RESUME_ABS."""
    from tpu_als_torch.cli import main as cli_main
    from tpu_als_torch.io.checkpoint import load_factors
    from tpu_als_torch.resilience import preempt

    spec = "synthetic:{}x{}x{}".format(*ML100K_SHAPE)
    base = ["train", "--data", spec, "--rank", str(RANK), "--max-iter", "6",
            "--seed", str(seed), "--device", str(dev)]

    def train(*extra, env=None):
        os.environ.update(env or {})
        try:
            cli_main(base + list(extra))
            return 0
        except SystemExit as e:
            return e.code
        finally:
            for k in env or {}:
                del os.environ[k]
            faults.clear()

    def factors(d):
        return [np.load(os.path.join(d, s))["factors"]
                for s in ("user_factors.npz", "item_factors.npz")]

    d = {k: os.path.join(tmp, k) for k in ("full", "ck", "res", "ck2",
                                           "ck3", "res2")}
    t0 = time.perf_counter()
    if train("--output", d["full"]) != 0:
        fail("(e) the uninterrupted fit failed")
    rc = train("--checkpoint-dir", d["ck"], "--checkpoint-interval", "2",
               env={preempt.ENV_PREEMPT_AT: "3"})
    ck = os.path.join(d["ck"], "als_checkpoint")
    it = load_factors(ck)[0]["iteration"] if os.path.isdir(ck) else None
    if rc != preempt.EXIT_PREEMPTED or it != 3:
        fail(f"(e) TPU_ALS_PREEMPT_AT=3: exit {rc}, checkpoint at {it}")
    if train("--checkpoint-dir", d["ck"], "--resume", "auto",
             "--output", d["res"]) != 0:
        fail("(e) --resume auto failed")
    rc = train("--checkpoint-dir", d["ck2"], "--checkpoint-interval", "2",
               env={preempt.ENV_PREEMPT_AT: "4",
                    faults.ENV_VAR: "checkpoint.write=corrupt@nth=2"})
    if rc != preempt.EXIT_PREEMPTED:
        fail(f"(e) the torn run exited {rc}")
    train("--max-iter", "2", "--checkpoint-dir", d["ck3"],
          "--checkpoint-interval", "2")
    primary = os.path.join(d["ck2"], "als_checkpoint")
    shutil.move(os.path.join(d["ck3"], "als_checkpoint"), primary + ".old")
    obs.reset()
    if train("--checkpoint-dir", d["ck2"], "--resume", "auto",
             "--output", d["res2"]) != 0:
        fail("(e) --resume auto after the torn save failed")
    quarantined = obs.events("checkpoint_quarantined")
    qdir = os.path.join(d["ck2"], ".corrupt")
    loaded = [e["path"] for e in obs.events("checkpoint_load")]
    if len(quarantined) != 1 or not os.listdir(qdir) or \
            not any(p.endswith("als_checkpoint.old") for p in loaded):
        fail(f"(e) the torn save was not quarantined and .old loaded: "
             f"{quarantined}, {loaded}")
    full = factors(d["full"])
    diffs = []
    for res in (d["res"], d["res2"]):
        diffs.append(max(float(np.max(np.abs(a - b)))
                         for a, b in zip(factors(res), full)))
    exact = all(x == 0.0 for x in diffs)
    log(f"(e) train at ML-100K, rank {RANK}, 6 iterations: preempted at 3 "
        f"(exit {preempt.EXIT_PREEMPTED}), resumed; torn save at 4 "
        f"quarantined to .corrupt/, resumed from .old (iteration 2); "
        f"resumed vs uninterrupted max |diff| "
        + ", ".join(f"{x:.3e}" for x in diffs)
        + (" (bit for bit)" if exact else f" (tol {RESUME_ABS})")
        + f"; {time.perf_counter() - t0:.1f} s for the 6 runs")
    if not max(diffs) <= RESUME_ABS:
        fail(f"(e) a resumed fit is {max(diffs):.3e} off the uninterrupted")
    return exact


def model_selection_phase(frame, seed, dev, cpu_cv):
    """The Spark ML surface and the fit's checkpoint lifecycle on the
    card, (a)-(e); ``cpu_cv``: (a)'s CPU cross-validation, run earlier
    (:func:`start_cpu_cv`)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        a = pipeline_selection(seed, dev, tmp, cpu_cv)
        b = headline_rmse(frame, seed, dev)
        c = legacy_fits(seed, dev)
        cli_selection(seed, tmp, dev)
        exact = checkpoint_lifecycle(seed, tmp, dev)
    log(f"model selection and evaluation: {time.perf_counter() - t0:.1f} s")
    return {"a": a, "b": b, "c": c, "resume_exact": exact}


# -- phase 8: the serving engine ---------------------------------------------
SERVE_USERS = 4096          # (a)/(b): users scored at once
SERVE_SK = 64               # the engine's default shortlist
SERVE_REQS, SERVE_QPS = 3000, 1500.0    # (c): the int8 open loop, 2 s
EXACT_REQS = 1000                       # (c): the exact open loop, 0.67 s


def ulps_off(a, b):
    """Max |a - b| in units in the last place of ``b`` (float32)."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    return float((np.abs(a - b) / np.spacing(np.abs(b))).max()) \
        if a.size else 0.0


def int_mm_shapes(dev):
    """Which operand shapes ``torch._int_mm`` takes on this card: the
    padding in ``serving/index.py::_int8_mm`` rests on these."""
    def takes(m, k, n):
        a = torch.ones((m, k), dtype=torch.int8, device=dev)
        b = torch.ones((n, k), dtype=torch.int8, device=dev)
        try:
            out = torch._int_mm(a, b.T)
        except RuntimeError:
            return False
        torch.cuda.synchronize()
        if not bool((out == k).all()):
            fail(f"torch._int_mm({m}x{k} @ {k}x{n}) gave a wrong sum")
        return True

    probes = {"m=16": (16, 32, 64), "m=17": (17, 32, 64),
              "m=24": (24, 32, 64), "k=12": (32, 12, 64),
              "n=12": (32, 32, 12), "k=n=8": (32, 8, 8)}
    got = {name: takes(*shape) for name, shape in probes.items()}
    log(f"torch._int_mm on the card takes {got}")
    if not (got["m=24"] and got["k=n=8"]):
        fail("torch._int_mm refuses the shapes the index pads to")
    return got


def max_abs(a, b):
    return float((a - b).abs().max()) if a.numel() else 0.0


def index_vs_k5(U, V, valid, rng, dev):
    """(a) the int8 index against the exact top-10 on 4,096 users: every
    id earns its score; on the rows whose top-10 survived the shortlist,
    the scores within SERVE_ULPS of the plain f32 top-k (cuBLAS f32, as
    the rescore) and within K5_TOL of K5 (3xTF32: K5's own band against
    that plain top-k); the share of K5's top-10 that survived; with the
    shortlist the whole catalog (8 users), the same score sets."""
    idx = build_index(V, shortlist_k=SERVE_SK)
    users = torch.from_numpy(rng.choice(U.shape[0], SERVE_USERS,
                                        replace=False)).to(dev)
    Uq = U[users].contiguous()
    k5_before = cuda_topk.LAUNCHES
    s8, i8 = idx.topk(Uq, 10)
    if cuda_topk.LAUNCHES != k5_before:
        fail("the int8 index launched K5")
    se, ie = cuda_topk.topk_scores(Uq, V, valid, 10)
    sp, _ = chunked_topk_scores(Uq, V, valid, 10)
    earns_scores(Uq, V, valid, s8, i8, "int8 index")
    same = (torch.sort(i8, 1).values == torch.sort(ie, 1).values).all(1)
    survived = float(np.mean([len(set(a) & set(b)) for a, b in
                              zip(ie.tolist(), i8.tolist())])) / 10
    ulp_p, ulp_k5 = ulps_off(s8[same], sp[same]), ulps_off(s8[same],
                                                           se[same])
    err_k5 = max_abs(s8[same], se[same])
    full = build_index(V, shortlist_k=V.shape[0])
    fs, _ = full.topk(Uq[:8], 10)
    ulp_full, err_full = ulps_off(fs, sp[:8]), max_abs(fs, se[:8])
    log(f"int8 index (shortlist {SERVE_SK}) vs the exact top-10 on "
        f"{SERVE_USERS} users: share of K5's top-10 that survives the "
        f"shortlist {survived:.4f}, rows with the whole top-10 "
        f"{int(same.sum())}; their scores {ulp_p:.2f} ulp off the plain "
        f"f32 top-k (tol {SERVE_ULPS}), {ulp_k5:.2f} ulp / {err_k5:.3e} "
        f"off K5 (tol {K5_TOL}); shortlist = catalog (8 users): "
        f"{ulp_full:.2f} ulp off plain, {err_full:.3e} off K5")
    if ulp_p > SERVE_ULPS or ulp_full > SERVE_ULPS:
        fail("int8 index scores off the plain f32 top-k beyond "
             f"{SERVE_ULPS} ulp")
    if err_k5 > K5_TOL or err_full > K5_TOL:
        fail(f"int8 index scores off K5's beyond {K5_TOL}")
    return idx, Uq, survived


def int8_gemm_line(idx, Uq, V, valid, smi):
    """The shortlist GEMM at the full catalog (a library call, not a
    kernel of the port) beside its bound and K5 on the same users, and
    the whole int8 top-k beside K5, at 4,096 users and at the largest
    bucket (128)."""
    import torch.nn.functional as F

    from tpu_als_torch.serving.index import _quantize_rows

    Ni, r = idx.Vq.shape
    # the operands as serving/index.py::_int8_mm pads them (Ni to a
    # multiple of 8), padded outside the timed call
    rhs = F.pad(idx.Vq, (0, 0, 0, -Ni % 8))
    for n in (SERVE_USERS, 128):
        Q = Uq[:n].contiguous()
        Qq, _ = _quantize_rows(Q)
        g_ms = cuda_ms(lambda: torch._int_mm(Qq, rhs.T), 20)
        nbytes = n * r + Ni * r + n * Ni * 4
        b_ms = max(nbytes / HBM_BYTES_PER_S, 2 * n * Ni * r
                   / INT8_OPS_PER_S) * 1e3
        by = ("bytes" if nbytes / HBM_BYTES_PER_S
              >= 2 * n * Ni * r / INT8_OPS_PER_S else "operations")
        t_ms = cuda_ms(lambda: idx.topk(Q, 10), 5)
        k_ms = cuda_ms(lambda: cuda_topk.topk_scores(Q, V, valid, 10), 5)
        log(f"int8 shortlist GEMM ({smi}): {n} users x {Ni} items x rank "
            f"{r}: {g_ms:.4f} ms (bound {b_ms:.4f} ms by {by}); int8 top-10 "
            f"whole {t_ms:.4f} ms; K5 top-10 on the same users "
            f"{k_ms:.4f} ms")


def delta_vs_rebuild(idx, Uq, V, rng, dev):
    """(b) ``with_updates`` on 512 touched and 64 appended items, then
    ``compact``: both bitwise a ``build_index`` of the updated catalog."""
    touched = rng.choice(V.shape[0], 512, replace=False)
    new = unit_rows(rng, 64, V.shape[1])
    V2 = torch.cat([V, torch.from_numpy(new).to(dev)])
    V2[torch.from_numpy(touched).to(dev)] = torch.from_numpy(
        unit_rows(rng, 512, V.shape[1])).to(dev)
    rows = np.concatenate([touched, V.shape[0] + np.arange(64)])
    t0 = time.perf_counter()
    delta = idx.with_updates(rows, V2[torch.from_numpy(rows).to(dev)]
                             .cpu().numpy(), seq=1)
    t_delta = time.perf_counter() - t0
    compact = delta.compact()
    t0 = time.perf_counter()
    rebuilt = build_index(V2, shortlist_k=SERVE_SK)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    ref_s, ref_i = rebuilt.topk(Uq, 10)
    for name, ix in (("delta", delta), ("compact", compact)):
        s, i = ix.topk(Uq, 10)
        if not torch.equal(s, ref_s):
            fail(f"{name} index top-10 scores differ from a rebuild")
        tied = (ref_s[:, 1:] == ref_s[:, :-1]).any(1)
        if not torch.equal(i[~tied], ref_i[~tied]):
            fail(f"{name} index ids differ from a rebuild on untied rows")
    for a in ("V", "Vq", "sv", "valid"):
        if not torch.equal(getattr(compact, a), getattr(rebuilt, a)):
            fail(f"compacted index {a} differs from a rebuild")
    log(f"delta index (512 touched + 64 appended) and its compaction: "
        f"top-10 bitwise a rebuild on {SERVE_USERS} users; with_updates "
        f"{t_delta * 1e3:.2f} ms vs build_index {t_full * 1e3:.2f} ms "
        "(host clock)")
    return V2, touched


def serve_quantiles(path):
    return {"e2e_p50_ms": obs.histogram_quantile("serving.e2e_seconds",
                                                 0.5) * 1e3,
            "e2e_p99_ms": obs.histogram_quantile("serving.e2e_seconds",
                                                 0.99) * 1e3,
            "score_p50_ms": obs.histogram_quantile(
                "serving.score_seconds", 0.5, path=path) * 1e3,
            "score_p99_ms": obs.histogram_quantile(
                "serving.score_seconds", 0.99, path=path) * 1e3,
            "scored": obs.histogram_count("serving.e2e_seconds"),
            "shed": obs.counter_value("serving.shed")}


def engine_open_loop(U, V, rng, dev, smi):
    """(c) ``ServingEngine`` ('local'): publish, warmup, then the
    serve-bench open loop in process: int8 (no K5 launch), then exact
    (K5) after a ``quantize=False`` publish."""
    out = {}
    for path, n_req, quantize in (("int8", SERVE_REQS, True),
                                  ("exact", EXACT_REQS, False)):
        eng = ServingEngine(k=10, shortlist_k=SERVE_SK, max_wait_s=0.002,
                            device=dev)
        eng.publish(U, V, quantize=quantize)
        eng.warmup()
        uids = rng.integers(0, U.shape[0], n_req)
        obs.reset()
        cuda_topk.LAUNCHES = 0
        with eng:
            shed = open_loop(eng, [int(u) for u in uids], SERVE_QPS, 30.0)
        k5 = cuda_topk.LAUNCHES
        q = serve_quantiles(path)
        if q["scored"] + shed != n_req or \
                obs.counter_value("serving.expired"):
            fail(f"engine ({path}): {q['scored']} scored + {shed} shed of "
                 f"{n_req} requests")
        if (path == "int8") != (k5 == 0):
            fail(f"engine ({path}) launched K5 {k5} times")
        log(f"engine 'local' {path} ({smi}): {n_req} requests at "
            f"{SERVE_QPS:g} rps open loop over {U.shape[0]} users x "
            f"{V.shape[0]} items, rank {U.shape[1]}: e2e p50 "
            f"{q['e2e_p50_ms']:.3f} / p99 {q['e2e_p99_ms']:.3f} ms, score "
            f"p50 {q['score_p50_ms']:.3f} / p99 {q['score_p99_ms']:.3f} ms "
            f"(bucketed upper bounds), shed {shed}, K5 launches {k5}")
        out[path] = q
    return out


def engine_faults(U, V, dev):
    """(d) ``serving.publish=corrupt`` on the second publish answers
    exact with ``fallback_exact`` counted; ``serving.score=raise`` fails
    the waiting tickets and the loop serves on."""
    obs.reset()
    eng = ServingEngine(k=10, shortlist_k=SERVE_SK, max_wait_s=0.0,
                        device=dev)
    eng.publish(U, V)
    first = eng.published_index
    faults.install("serving.publish=corrupt@nth=1")
    try:
        eng.publish(U, V)
        if eng.published_index is not first:
            fail("a torn publish did not carry the previous index")
        t = eng.submit(5)
        eng.serve_batch(eng.batcher.next_batch(timeout=1.0))
        s, ix = t.result(timeout=5.0)
        valid = torch.ones(V.shape[0], dtype=torch.bool, device=dev)
        se, _ = cuda_topk.topk_scores(U[5:6], V, valid, 10)
        s = torch.from_numpy(s[None]).to(dev)
        earns_scores(U[5:6], V, valid, s, torch.from_numpy(ix[None]).to(
            dev).long(), "torn publish")
        if ulps_off(s, se) > SERVE_ULPS:
            fail("a torn publish was not answered on the exact route")
        if obs.counter_value("serving.fallback_exact") != 1:
            fail("the torn publish's exact answer was not counted")
    finally:
        faults.clear()
    faults.install("serving.score=raise@nth=1")
    try:
        with eng:
            try:
                eng.submit(0).result(timeout=10.0)
                fail("serving.score=raise did not fail the waiting ticket")
            except faults.InjectedFault:
                pass
            eng.recommend(1, timeout=10.0)
    finally:
        faults.clear()
    log("engine faults: a torn publish answered exact (fallback_exact 1); "
        "serving.score=raise failed the waiting ticket, the next was served")


def engine_mesh(U, V, V2, touched, rng, dev):
    """(e) 'sharded' and 'merge_ring' on 4 logical shards against the
    local engines: K8 launched, scores by the ulp rule; then one
    ``publish_update`` of (b)'s 512 touched items through the merge-ring
    scatter (the 64 appended would outgrow the padded shards: a full
    re-place)."""
    mesh = make_mesh(devices=[dev] * SHARDS)
    users = rng.choice(U.shape[0], 128, replace=False)

    def answer(eng):
        tickets = [eng.submit(int(u)) for u in users]
        eng.serve_batch(eng.batcher.next_batch(timeout=1.0))
        res = [t.result(timeout=5.0) for t in tickets]
        return (torch.from_numpy(np.stack([r[0] for r in res])).to(dev),
                torch.from_numpy(np.stack([r[1] for r in res])).to(dev)
                .long())

    def engine(**kw):
        eng = ServingEngine(k=10, shortlist_k=SERVE_SK, max_wait_s=0.0,
                            buckets=(128,), device=dev, **kw)
        eng.publish(U, V)
        return eng

    Uu = U[torch.from_numpy(users).to(dev)]
    valid = torch.ones(V.shape[0], dtype=torch.bool, device=dev)
    loc_s, loc_i = answer(engine())
    ex_s, _ = cuda_topk.topk_scores(Uu, V, valid, 10)
    sh_s, sh_i = answer(engine(mesh=mesh, serve_backend="sharded"))
    earns_scores(Uu, V, valid, sh_s, sh_i, "engine 'sharded'")
    same = (torch.sort(sh_i, 1).values == torch.sort(loc_i, 1).values).all(1)
    ulp_sh = ulps_off(sh_s[same], loc_s[same])
    cuda_topk.MERGE_LAUNCHES = 0
    mr = engine(mesh=mesh, serve_backend="merge_ring")
    mr_s, mr_i = answer(mr)
    k8 = cuda_topk.MERGE_LAUNCHES
    if k8 == 0:
        fail("engine 'merge_ring' never launched K8")
    earns_scores(Uu, V, valid, mr_s, mr_i, "engine 'merge_ring'")
    ulp_mr = ulps_off(mr_s, ex_s)
    if max(ulp_sh, ulp_mr) > SERVE_ULPS:
        fail(f"mesh engines off: sharded {ulp_sh:.1f}, merge_ring "
             f"{ulp_mr:.1f} ulp")
    V3 = V2[:V.shape[0]].contiguous()        # touched rows, no appends
    seq, mode = mr.publish_update(U, V3, touched_items=touched)
    if mode != "delta":
        fail(f"merge-ring publish_update took mode {mode!r}, not 'delta'")
    up_s, up_i = answer(mr)
    ex2, _ = cuda_topk.topk_scores(Uu, V3, valid, 10)
    earns_scores(Uu, V3, valid, up_s, up_i, "merge_ring after the delta")
    ulp_up = ulps_off(up_s, ex2)
    if ulp_up > SERVE_ULPS:
        fail(f"merge_ring after the delta publish: {ulp_up:.1f} ulp off K5")
    log(f"mesh engines ({SHARDS} logical shards, 128 users): 'sharded' "
        f"{ulp_sh:.2f} ulp off 'local' on {int(same.sum())} rows with the "
        f"same top-10; 'merge_ring' {ulp_mr:.2f} ulp off K5, K8 launches "
        f"{k8}; publish_update (512 touched) seq {seq} mode "
        f"{mode}, then {ulp_up:.2f} ulp off K5 on the new catalog")


def serving_clis(model, tmp):
    """(f) ``foldin-bench`` on phase 6's saved model (K2 counted in its
    process) and a short ``serve-bench``, as processes; JSON parsed."""
    path = os.path.join(tmp, "served_model")
    model.save(path)
    t0 = time.perf_counter()
    # serve-bench imports beside foldin-bench (gated: it touches the card
    # only once foldin-bench has exited)
    ps = start_probe(["serve-bench", "--users", str(N_USERS), "--items",
                      str(N_ITEMS), "--rank", str(RANK), "--qps", "1000",
                      "--duration", "1", "--slo-ms", "50"], gated=True)
    lines, launches = finish_probe(
        start_probe(["foldin-bench", "--model", path]), "foldin-bench",
        timeout=300)
    fb, k2 = json.loads(lines[-1]), launches["k2"]
    if k2 == 0 or fb["metric"] != "foldin_p50_latency":
        fail(f"foldin-bench: {fb}, K2 launches {k2}")
    fb_s = time.perf_counter() - t0
    probe_ready(ps, "serve-bench")
    t0 = time.perf_counter()
    release_probe(ps)
    lines, _ = finish_probe(ps, "serve-bench")
    sb, sb_s = json.loads(lines[-1]), time.perf_counter() - t0
    if sb["scored"] == 0 or sb["config"]["path"] != "int8":
        fail(f"serve-bench: {sb}")
    log(f"foldin-bench: p50 {fb['value']} s over {fb['batches']} batches "
        f"of {fb['batch_size']}, K2 launches {k2} ({fb_s:.1f} s process); "
        f"serve-bench: {json.dumps(sb)} ({sb_s:.1f} s once released)")


def serving_engine_phase(fitted, served, rng, dev, smi):
    """Phase 8, (a)-(f), on the rank-128 fit's factors (162,541 users x
    59,047 items) and phase 6's served model."""
    t0 = time.perf_counter()
    log(f"serving engine phase on {smi}")
    U, V = fitted._U, fitted._V
    valid = torch.ones(V.shape[0], dtype=torch.bool, device=dev)
    int_mm_shapes(dev)
    idx, Uq, _ = index_vs_k5(U, V, valid, rng, dev)
    int8_gemm_line(idx, Uq, V, valid, smi)
    V2, touched = delta_vs_rebuild(idx, Uq, V, rng, dev)
    del idx
    p8 = engine_open_loop(U, V, rng, dev, smi)
    engine_faults(U, V, dev)
    engine_mesh(U, V, V2, touched, rng, dev)
    with tempfile.TemporaryDirectory() as tmp:
        serving_clis(served, tmp)
    obs.reset()
    log(f"serving engine phase: {time.perf_counter() - t0:.1f} s")
    return p8


# -- phase 9: the stream and the live loop ----------------------------------
STREAM_HOSTS = 4                    # (a): byte-range hosts of one file
LIVE_EVENTS_QPS, LIVE_SECONDS = 200.0, 3.0   # (c): the rating stream
LIVE_POISON = 0.01                  # (c): share of NaN ratings
LIVE_CHECK_USERS = 256              # (c): touched users held to K5
FRESHNESS_SLO_S = 5.0               # serve-bench's default freshness SLO
TENANT_REQS = 2048                  # (d): requests per tenant, contended
NEW_STREAM_USERS = 8                # (b): new string ids folded in
def key_shape(d):
    """The key structure of a ``serve-bench`` JSON line: nested dicts by
    key, leaves None; ``publish_modes`` (keyed by the modes a run saw)
    left out, ``shape_classes`` (keyed by class) a leaf, the per-tenant
    dicts merged under ``"*"``."""
    out = {}
    for k, v in d.items():
        if k == "publish_modes":
            continue
        if k == "shape_classes":
            out[k] = None
            continue
        if k == "tenants" and isinstance(v, dict):
            merged = {}
            for t in v.values():
                merged.update(key_shape(t))
            out[k] = {"*": merged}
        else:
            out[k] = key_shape(v) if isinstance(v, dict) else None
    return out


_SB_CONFIG = dict.fromkeys(
    ("path", "users", "items", "rank", "k", "shortlist_k", "qps",
     "duration_s", "buckets", "max_queue", "max_wait_ms", "deadline_ms",
     "foldin_frac"))
# the reference's serve-bench JSON (tpu_als/cli.py), as key_shape gives
# it; tests/test_torch_cli_live.py holds these to the reference's output
LIVE_BENCH_SHAPE = {
    **dict.fromkeys(("metric", "value", "unit", "slo_ms", "slo_met",
                     "p50_ms", "shed_rate", "expired", "scored",
                     "queue_wait_p99_ms", "flight_records",
                     "derived_buckets")),
    "config": {**_SB_CONFIG, **dict.fromkeys(
        ("update_qps", "update_items", "update_poison_frac",
         "update_max_batch", "update_max_wait_ms"))},
    "serve": dict.fromkeys(("p99_ms", "p50_ms", "slo_ms", "slo_met")),
    "live": dict.fromkeys(("events_scored", "updates_shed",
                           "quarantined_rows", "publish_delta_ms",
                           "publish_full_ms", "publish_speedup",
                           "probe_rows", "catalog_rows")),
}
TENANT_BENCH_SHAPE = {
    **dict.fromkeys(("metric", "value", "unit", "slo_ms", "fairness_ratio",
                     "fairness_bound", "fairness_judged", "slo_met")),
    "tenants": {"*": dict.fromkeys(("p50_ms", "p99_ms", "slo_met",
                                    "scored", "shed_rate", "served_rows",
                                    "weight"))},
    "shape_classes": None,
    "config": dict.fromkeys(
        ("path", "tenants", "tenant_weights", "users", "items", "rank",
         "k", "shortlist_k", "qps", "qps_per_tenant", "duration_s",
         "max_queue", "max_wait_ms", "deadline_ms", "update_qps")),
}


def stream_ingest_phase(path, got):
    """9(a) the ML-25M ``ratings.csv`` through the string-id stream
    reader, as one host and as STREAM_HOSTS byte-range hosts
    (``ingest_per_host`` + ``merge_vocabularies``): after the labels are
    decoded back to integers, both equal the native reader's columns
    (``got``) row for row; rows a second on the host's clock."""
    n = len(got["user"])
    t0 = time.perf_counter()
    u, i, r, ul, il = stream_ingest(path, require_cols=4, skip_header=1)
    t_one = time.perf_counter() - t0
    one = (ul.astype(np.int64)[u], il.astype(np.int64)[i], r)
    del u, i, r
    t0 = time.perf_counter()
    splits, gul, gil = ingest_per_host(path, STREAM_HOSTS, require_cols=4,
                                       skip_header=1)
    t_hosts = time.perf_counter() - t0
    hosts = (gul.astype(np.int64)[np.concatenate([s[0] for s in splits])],
             gil.astype(np.int64)[np.concatenate([s[1] for s in splits])],
             np.concatenate([s[2] for s in splits]))
    del splits
    for name, cols in (("one host", one), (f"{STREAM_HOSTS} hosts", hosts)):
        for c, x in zip(("user", "item", "rating"), cols):
            if not np.array_equal(x, got[c]):
                fail(f"stream ingest ({name}): column {c} differs from the "
                     "native CSV reader's")
    log(f"(a) stream ingest of {n} rows (string ids): one host "
        f"{t_one:.2f} s ({n / t_one:.4g} rows/s); {STREAM_HOSTS} byte-range "
        f"hosts + merge_vocabularies {t_hosts:.2f} s ({n / t_hosts:.4g} "
        f"rows/s); both equal the native reader row for row, "
        f"{len(gul)} users x {len(gil)} items (host clock)")
    return {"rows": n, "one_s": t_one, "hosts_s": t_hosts}


def stream_cli_phase(prefix, tmp, seed):
    """9(b) ``train --data stream:PREFIX`` at rank 128 (the first
    CSV_TWIN_ROWS rows), then ``evaluate`` through the model's
    ``stream_labels.npz`` and ``recommend --foldin-data stream:`` on new
    string ids, as processes (the last two side by side)."""
    from tpu_als_torch.cli import _load_stream

    t0 = time.perf_counter()
    out = os.path.join(tmp, "stream_model")
    spec = f"stream:{prefix}"
    new = os.path.join(tmp, "new_users.csv")
    # evaluate and recommend import beside train (gated) and run once the
    # model and the new users' file are written (recommend's --users,
    # which name one of the model's users, go with its release)
    pe = start_probe(["evaluate", "--model", out, "--data", spec],
                     gated=True)
    pr = start_probe(["recommend", "--model", out, "--foldin-data",
                      f"stream:{new}", "--k", "10"], gated=True)
    _, tl = finish_probe(start_probe(
        ["train", "--data", spec, "--rank", str(RANK), "--max-iter", "3",
         "--reg-param", "0.05", "--seed", str(seed), "--output", out]),
        "train --data stream:")
    side = np.load(os.path.join(out, "stream_labels.npz"))
    frame, g_ul, g_il = _load_stream(prefix)
    if not (np.array_equal(side["users"], g_ul)
            and np.array_equal(side["items"], g_il)):
        fail("stream_labels.npz differs from the stream's vocabularies")
    train, _ = frame.randomSplit([0.8, 0.2], seed=seed)
    widest = max(np.bincount(train["user"]).max(),
                 np.bincount(train["item"]).max())
    wide = widest > core_als.SPLIT_WIDTH
    if tl["k4"] == 0 or (wide and (tl["k3"] == 0 or tl["k1"] == 0)):
        fail(f"train --data stream: launches {tl} (widest row {widest})")
    rng = np.random.default_rng(seed)
    items = rng.choice(side["items"], 5 * NEW_STREAM_USERS)
    with open(new, "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        for k, it in enumerate(items):
            f.write(f"newcomer-{k % NEW_STREAM_USERS},{it.decode()},"
                    f"{rng.integers(1, 11) * 0.5},1700000000\n")
        f.write("newcomer-0,no-such-item,4.0,1700000000\n")
    asked = ["newcomer-0", "newcomer-5", side["users"][3].decode()]
    for p, what in ((pe, "evaluate --data stream:"),
                    (pr, "recommend --foldin-data stream:")):
        probe_ready(p, what)
    release_probe(pe)
    release_probe(pr, ["--users", ",".join(asked)])
    ev_lines, el = finish_probe(pe, "evaluate --data stream:")
    rec_lines, rl = finish_probe(pr, "recommend --foldin-data stream:")
    ev = json.loads(ev_lines[-1])
    recs = [json.loads(x) for x in rec_lines if x.startswith("{")]
    known = set(side["items"].tolist())
    if not (ev["rmse"] is not None and math.isfinite(ev["rmse"])):
        fail(f"evaluate --data stream: {ev}")
    if sorted(x["user_id"] for x in recs) != sorted(asked) or any(
            len(x["item_ids"]) != 10 or not all(
                s.encode() in known for s in x["item_ids"]) for x in recs):
        fail(f"recommend --foldin-data stream: {recs}")
    if rl["k2"] == 0 or rl["k5"] == 0:
        fail(f"recommend --foldin-data stream: launches {rl}")
    log(f"(b) stream CLI on the first {CSV_TWIN_ROWS} rows: train rank "
        f"{RANK} launches K4 {tl['k4']}, K3 {tl['k3']}, K1 {tl['k1']} "
        f"(widest row {widest}); sidecar {len(side['users'])} users x "
        f"{len(side['items'])} items; evaluate {json.dumps(ev)}; recommend "
        f"for {asked}: string ids, K2 {rl['k2']}, K5 {rl['k5']} launches "
        f"({time.perf_counter() - t0:.1f} s, three processes)")


def live_route(fitted, route, rng, dev):
    """One open loop of 1,500 requests a second for LIVE_SECONDS beside a
    LiveUpdater stream of LIVE_EVENTS_QPS rating events a second
    (LIVE_POISON of them NaN), on 'route': 'exact' (a quantize=False
    publish; the first live publish builds the index, as the reference's
    publish_update does) or 'int8' with fold_items (delta publishes)."""
    fold_items = route == "int8"
    eng = ServingEngine(k=10, shortlist_k=SERVE_SK, max_wait_s=0.002,
                        device=dev)
    eng.publish(fitted._U.clone(), fitted._V.clone(),
                quantize=route == "int8")
    eng.warmup()
    # the fold-in writes its tables in place: the model holds copies
    model = ALSModel(fitted.rank, IdMap(ids=fitted._user_map.ids),
                     IdMap(ids=fitted._item_map.ids), fitted._U.clone(),
                     fitted._V.clone(), fitted._params, device=dev)
    srv = FoldInServer(model, keep_history=False)
    upd = LiveUpdater(eng, srv, slo_s=FRESHNESS_SLO_S,
                      fold_items=fold_items, device=dev)
    from tpu_als_torch.cli import _prewarm_ladder

    n_ev = int(LIVE_EVENTS_QPS * LIVE_SECONDS)
    srv.prewarm(rows=_prewarm_ladder(upd.max_batch), widths=(1, 2),
                sides=("user", "item") if fold_items else ("user",))
    if fold_items:
        eng.warmup_live(max_delta_rows=n_ev)
    ev_u = rng.choice(model._user_map.ids, n_ev)
    ev_i = rng.choice(model._item_map.ids, n_ev)
    ev_r = (rng.integers(1, 11, n_ev) * 0.5).astype(np.float32)
    ev_r[rng.random(n_ev) < LIVE_POISON] = np.nan
    n_req = int(SERVE_QPS * LIVE_SECONDS)
    uids = rng.integers(0, N_USERS, n_req)
    obs.reset()
    _zero_launches()
    shed_ev = []

    def stream():
        t0 = time.perf_counter()
        for j in range(n_ev):
            delay = t0 + j / LIVE_EVENTS_QPS - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            try:
                upd.submit(int(ev_u[j]), int(ev_i[j]), float(ev_r[j]))
            except Exception as e:  # noqa: BLE001 — counted, then failed
                shed_ev.append(repr(e))

    t0 = time.perf_counter()
    eng.start()
    upd.start()
    th = threading.Thread(target=stream, name="chip-smoke-live-events")
    th.start()
    shed = open_loop(eng, [int(u) for u in uids], SERVE_QPS, 30.0)
    th.join()
    upd.stop(drain_timeout_s=60.0)
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    folded = sum(e["events"] for e in obs.events("live_update"))
    quarantined = obs.counter_value("ingest.quarantined_rows")
    warnings = obs.events("warning")
    if shed_ev or obs.counter_value("live.shed"):
        fail(f"live ({route}): rating events shed: {shed_ev[:3]}")
    if folded + quarantined != n_ev or \
            obs.histogram_count("live.freshness_seconds") != folded:
        fail(f"live ({route}): {folded} folded + {quarantined} quarantined "
             f"of {n_ev} events")
    if quarantined != int(np.isnan(ev_r).sum()):
        fail(f"live ({route}): {quarantined} quarantined, "
             f"{int(np.isnan(ev_r).sum())} NaN events")
    if warnings:
        fail(f"live ({route}): warning events {warnings[:3]}")
    if launches["k2"] == 0 or (route == "exact" and launches["k5"] == 0):
        fail(f"live ({route}): launches {launches}")
    modes = {m: obs.histogram_count("serving.publish_seconds", mode=m)
             for m in ("full", "retag", "delta", "compact", "none")}
    modes = {m: c for m, c in modes.items() if c}
    if route == "int8" and set(modes) != {"delta"}:
        fail(f"live (int8, fold_items): publish modes {modes}, not only "
             "delta")
    m = eng._model
    if not (torch.equal(m.U, model._U) and torch.equal(m.V, model._V)):
        fail(f"live ({route}): the published generation is not the "
             "fold-in model's factors")
    touched = model._user_map.to_dense(np.unique(ev_u[~np.isnan(ev_r)]))
    users = rng.choice(touched, LIVE_CHECK_USERS, replace=False)
    tickets = [eng.submit(int(u)) for u in users]
    res = [t.result(timeout=30.0) for t in tickets]
    eng.stop()
    s = torch.from_numpy(np.stack([x[0] for x in res])).to(dev)
    ix = torch.from_numpy(np.stack([x[1] for x in res])).to(dev).long()
    Uq = model._U[torch.from_numpy(users).to(dev)]
    valid = torch.ones(model._V.shape[0], dtype=torch.bool, device=dev)
    earns_scores(Uq, model._V, valid, s, ix, f"live ({route})")
    se, ie = cuda_topk.topk_scores(Uq, model._V, valid, 10)
    sp, _ = chunked_topk_scores(Uq, model._V, valid, 10)
    same = (torch.sort(ix, 1).values == torch.sort(ie, 1).values).all(1)
    if not bool(same.all()):
        fail(f"live ({route}): {int((~same).sum())} of {LIVE_CHECK_USERS} "
             "touched users' top-10 differ from K5's")
    ulp_k5, err_k5 = ulps_off(s, se), max_abs(s, se)
    ulp_p = ulps_off(s, sp)
    if err_k5 > K5_TOL or ulp_p > SERVE_ULPS:
        fail(f"live ({route}): scores {err_k5:.3e} off K5 (tol {K5_TOL}), "
             f"{ulp_p:.2f} ulp off the plain f32 top-k")
    q = {"fresh_p50_ms": obs.histogram_quantile("live.freshness_seconds",
                                                0.5) * 1e3,
         "fresh_p99_ms": obs.histogram_quantile("live.freshness_seconds",
                                                0.99) * 1e3,
         **serve_quantiles(route), "modes": modes, "launches": launches,
         "folded": folded, "quarantined": quarantined, "shed": shed,
         "ulp_k5": ulp_k5, "err_k5": err_k5, "ulp_plain": ulp_p,
         "wall_s": wall}
    return q


def live_loop_phase(fitted, rng, dev, smi, p8):
    """9(c) the live loop at the rank-128 fit's full width on both
    routes; phase 8's open loop (``p8``) is the same traffic without the
    update stream."""
    for route in ("exact", "int8"):
        q = live_route(fitted, route, rng, dev)
        b = p8[route]
        log(f"(c) live loop, engine '{route}' start ({smi}): "
            f"{int(SERVE_QPS * LIVE_SECONDS)} requests at {SERVE_QPS:g} rps "
            f"beside {int(LIVE_EVENTS_QPS * LIVE_SECONDS)} rating events "
            f"at {LIVE_EVENTS_QPS:g}/s ({LIVE_POISON:.0%} NaN): folded "
            f"{q['folded']} + quarantined {q['quarantined']}, requests shed "
            f"{q['shed']}; freshness p50 {q['fresh_p50_ms']:.3f} / p99 "
            f"{q['fresh_p99_ms']:.3f} ms; serving e2e p50 "
            f"{q['e2e_p50_ms']:.3f} / p99 {q['e2e_p99_ms']:.3f} ms with the "
            f"stream, {b['e2e_p50_ms']:.3f} / {b['e2e_p99_ms']:.3f} ms "
            f"without (phase 8) (bucketed upper bounds); publish modes "
            f"{q['modes']}; launches K2 {q['launches']['k2']}, K5 "
            f"{q['launches']['k5']}; published U/V bitwise the fold-in "
            f"model's; {LIVE_CHECK_USERS} touched users' top-10 = K5's ids, "
            f"{q['ulp_k5']:.2f} ulp / {q['err_k5']:.3e} off K5, "
            f"{q['ulp_plain']:.2f} ulp off the plain f32 top-k "
            f"({q['wall_s']:.1f} s)")


def tenancy_phase(fitted, rng, dev, smi):
    """9(d) two same-shaped tenants on the exact route (K5), weights 3
    and 1: the fit's factors and a seeded catalog of unit rows.  First a
    ``serving.score`` fault on the first pick (tenant 'fit', by name at
    equal virtual time) fails only its tickets; then TENANT_REQS
    requests per tenant under contention."""
    U2 = torch.from_numpy(unit_rows(rng, N_USERS, RANK)).to(dev)
    V2 = torch.from_numpy(unit_rows(rng, N_ITEMS, RANK)).to(dev)
    cats = {"fit": (fitted._U, fitted._V), "second": (U2, V2)}
    eng = MultiTenantEngine(device=dev)
    for name, w in (("fit", 3.0), ("second", 1.0)):
        eng.add_tenant(TenantSpec(name=name, weight=w, k=10,
                                  max_queue=2 * TENANT_REQS),
                       *cats[name], quantize=False)
    eng.warmup()
    classes = eng.registry.shape_classes()
    if list(classes.values()) != [["fit", "second"]]:
        fail(f"tenancy: shape classes {classes}")
    obs.reset()
    faults.install("serving.score=raise@nth=1")
    try:
        ta = [eng.submit("fit", u) for u in range(8)]
        tb = [eng.submit("second", u) for u in range(8)]
        eng._drain_round()
    finally:
        faults.clear()
    for t in ta:
        try:
            t.result(timeout=10.0)
            fail("tenancy: serving.score=raise did not fail tenant 'fit'")
        except faults.InjectedFault:
            pass
    for t in tb:
        t.result(timeout=10.0)
    errs = {n: obs.counter_value("tenancy.batch_errors", tenant=n)
            for n in cats}
    if errs != {"fit": 1, "second": 0}:
        fail(f"tenancy: batch errors {errs} after one injected fault")
    _zero_launches()
    users = rng.integers(0, N_USERS, TENANT_REQS)
    t0 = time.perf_counter()
    with eng:
        tickets = [(n, eng.submit(n, int(u))) for u in users
                   for n in cats]
        res = {n: [] for n in cats}
        for n, t in tickets:
            res[n].append(t.result(timeout=60.0))
    wall = time.perf_counter() - t0
    k5 = cuda_topk.LAUNCHES
    warnings = obs.events("warning")
    if warnings or obs.counter_value("tenancy.batch_errors", tenant="fit") \
            != 1 or obs.counter_value("tenancy.batch_errors",
                                      tenant="second"):
        fail(f"tenancy: warnings {warnings[:3]}, batch errors beyond the "
             "injected one")
    fit, sec = eng.tenant("fit"), eng.tenant("second")
    if fit.served_rows != sec.served_rows or \
            abs(3.0 * fit.vtime - sec.vtime) > 1e-9 * sec.vtime:
        fail(f"tenancy: served rows {fit.served_rows} / {sec.served_rows},"
             f" vtime {fit.vtime} / {sec.vtime} (want equal rows, 1:3)")
    if k5 == 0:
        fail("tenancy: the exact route never launched K5")
    uq = torch.from_numpy(users).to(dev)
    worst = {}
    for n, (U, V) in cats.items():
        s = torch.from_numpy(np.stack([x[0] for x in res[n]])).to(dev)
        ix = torch.from_numpy(np.stack([x[1] for x in res[n]])).to(
            dev).long()
        valid = torch.ones(V.shape[0], dtype=torch.bool, device=dev)
        earns_scores(U[uq], V, valid, s, ix, f"tenant {n!r}")
        se, ie = cuda_topk.topk_scores(U[uq], V, valid, 10)
        if not torch.equal(torch.sort(ix, 1).values,
                           torch.sort(ie, 1).values):
            fail(f"tenant {n!r}: ids differ from K5 on its own catalog")
        worst[n] = (ulps_off(s, se), max_abs(s, se))
        if worst[n][1] > K5_TOL:
            fail(f"tenant {n!r}: scores {worst[n][1]:.3e} off K5")
    log(f"(d) tenancy ({smi}): 2 tenants x {N_USERS} users x {N_ITEMS} "
        f"items, one shape class; serving.score=raise failed only tenant "
        f"'fit' (batch errors {errs}); {TENANT_REQS} requests each under "
        f"contention: served rows {fit.served_rows} / {sec.served_rows}, "
        f"vtime {fit.vtime:.4f} / {sec.vtime:.4f} (weights 3:1), K5 "
        f"launches {k5}; each tenant's answers = K5 on its own catalog "
        f"(ulp / abs: {worst}) ({wall:.2f} s)")


def live_bench_clis():
    """9(e) ``serve-bench --update-qps 200 --update-items`` and
    ``serve-bench --tenants 2 --update-qps 100`` at the full catalog, as
    processes side by side; the reference's key sets, ``slo_met``."""
    t0 = time.perf_counter()
    base = ["serve-bench", "--users", str(N_USERS), "--items",
            str(N_ITEMS), "--rank", str(RANK), "--duration", "2"]
    runs = {"live": (base + ["--update-qps", "200", "--update-items"],
                     LIVE_BENCH_SHAPE),
            "tenants": (base + ["--tenants", "2", "--update-qps", "100"],
                        TENANT_BENCH_SHAPE)}
    procs = {k: start_probe(a) for k, (a, _) in runs.items()}
    for k, (_, shape) in runs.items():
        lines, launches = finish_probe(procs[k], f"serve-bench ({k})")
        out = json.loads(lines[-1])
        if key_shape(out) != shape or "slo_met" not in out:
            fail(f"serve-bench ({k}): keys {key_shape(out)}")
        if launches["k2"] == 0:
            fail(f"serve-bench ({k}): no K2 launch")
        log(f"(e) serve-bench {' '.join(runs[k][0][1:])}: "
            f"{json.dumps(out)}; launches {launches}")
    log(f"(e) {time.perf_counter() - t0:.1f} s (two processes)")


def live_tenancy_phase(fitted, rng, dev, smi, p8):
    """Phase 9 (c)-(e); (a) and (b) run inside phase 5's csv_phase, while
    its ratings.csv exists."""
    t0 = time.perf_counter()
    live_loop_phase(fitted, rng, dev, smi, p8)
    tenancy_phase(fitted, rng, dev, smi)
    live_bench_clis()
    obs.reset()
    secs = time.perf_counter() - t0
    log(f"live loop and tenancy phase (c)-(e): {secs:.1f} s")
    return secs


# -- phase 10: the two-tower model and train's observability ---------------
TT_SHAPE = (20_000, 4_000, 800_000)     # bench.py run_twotower (config 5)
TT_EPOCHS = 20
TT_MILESTONES = (1, 3, 5, 10, 20)       # the recall curve's epochs
TT_CLI_EPOCHS = 5                       # (d): tt-train as a process
TT_ALS = dict(rank=32, max_iter=8, reg_param=0.005, implicit_prefs=True,
              alpha=20.0)               # the warm start, as tt-train's
# (c): the first epoch's per-step losses, the card against the CPU from
# one init and one permutation, relative: tests/test_torch_two_tower.py's
# band for the port against the reference (epoch losses, 1e-5)
TT_LOSS_RTOL = 1e-5
TT_KEYS = {"filtered_recall_at_10", "train_pairs", "test_pairs", "users",
           "items", "epochs", "warm_start", "saved"}
TRAIN_PHASES = {"cli.train", "cli.train/data.load",
                "cli.train/train.block", "cli.train/train.fit"}
K4_KERNEL = "row_gram_kernel"           # K4's first pass, csrc/gather_solve.cu


def tt_data(seed):
    """bench.py's config-5 data: positives (r >= 3.5) of the synthetic
    ratings, 10 % held out by ``default_rng(2)``, the held-out pairs that
    are also training pairs dropped."""
    nU, nI, nnz = TT_SHAPE
    frame = synthetic_movielens(nU, nI, nnz, seed=seed)
    u, i, r = (np.asarray(frame[c]) for c in ("user", "item", "rating"))
    pos = r >= 3.5
    u, i, r = u[pos], i[pos], r[pos]
    test = np.random.default_rng(2).random(len(u)) < 0.1
    ut, it_ = u[test], i[test]
    u2, i2, r2 = u[~test], i[~test], r[~test]
    fresh = ~np.isin(ut.astype(np.int64) * nI + it_,
                     np.unique(u2.astype(np.int64) * nI + i2))
    return {"u2": u2, "i2": i2, "r2": r2, "ut": ut[fresh],
            "it": it_[fresh], "nU": nU, "nI": nI}


def tt_half_steps_vs_f64(U, V, ucsr, icsr, d, dev):
    """(a) the warm start's kernels at rank 32, against float64: one item
    half-step from the fitted U and one user half-step from the fitted V,
    through the same route as the fit (K4; K3 and K1 on a side with a
    row wider than SPLIT_WIDTH), each row held to its dense float64 solve
    of the same normal equations within TRAIN_REL."""
    cfg = core_als.AlsConfig(**TT_ALS)
    for side, F, csr, rows, cols, n in (
            ("item", U, icsr, d["i2"], d["u2"], d["nI"]),
            ("user", V, ucsr, d["u2"], d["i2"], d["nU"])):
        _zero_launches()
        x = core_als.local_half_step(F, csr.to(dev), n, cfg, compute_yty(F))
        torch.cuda.synchronize()
        got = _launch_counts()
        wide = int(np.bincount(rows).max()) > core_als.SPLIT_WIDTH
        if got["k4"] == 0 or (wide and (got["k3"] == 0 or got["k1"] == 0)):
            fail(f"two-tower {side} half-step: launches {got}")
        err = row_rel(x.double(), dense_half_step_f64(
            F, rows, cols, d["r2"], n, TT_ALS["reg_param"],
            TT_ALS["alpha"]))
        log(f"(a) one {side} half-step at rank {TT_ALS['rank']} (K4 "
            f"{got['k4']}, K3 {got['k3']}, K1 {got['k1']} launches) vs "
            f"float64: max per-row |diff|/|x| {err:.3e} (tol {TRAIN_REL})")
        if not err <= TRAIN_REL:
            fail(f"two-tower {side} half-step: {err:.3e} off float64")


@contextlib.contextmanager
def recording_losses(out):
    """Append every step's loss of ``train_two_tower`` (detached) to
    ``out`` while the block runs."""
    from tpu_als_torch.models import two_tower as tt

    orig = tt.in_batch_softmax_loss

    def recorded(*a, **k):
        loss = orig(*a, **k)
        out.append(loss.detach())
        return loss

    tt.in_batch_softmax_loss = recorded
    try:
        yield out
    finally:
        tt.in_batch_softmax_loss = orig


def tt_fit(d, cfg, init, dev, tag, step_losses):
    """``train_two_tower`` on the card from ``init``: each epoch's wall
    (host clock, evaluation excluded), filtered recall@10 at the
    milestones (and for the warm run with ``serving_bias``), the
    per-step losses of every step into ``step_losses``."""
    from tpu_als_torch.models import two_tower as tt

    excl = (d["u2"], d["i2"])
    bias = tt.serving_bias(np.bincount(d["i2"], minlength=d["nI"]),
                           cfg.temperature)
    walls, curve = [], {}
    clock = [0.0]

    def cb(epoch, loss, params):
        walls.append(time.perf_counter() - clock[0])
        if epoch in TT_MILESTONES:
            rec = tt.recall_at_k(params, d["ut"], d["it"], k=10,
                                 exclude=excl)
            prior = (tt.recall_at_k(params, d["ut"], d["it"], k=10,
                                    exclude=excl, item_bias=bias)
                     if tag == "warm" else None)
            curve[epoch] = (rec, prior)
            log(f"(b) {tag} epoch {epoch}: loss {loss:.6f}, filtered "
                f"recall@10 {rec:.4f}"
                + (f" (with serving_bias {prior:.4f})" if prior is not None
                   else "")
                + f", epoch wall {walls[-1] * 1e3:.1f} ms")
        clock[0] = time.perf_counter()

    with recording_losses(step_losses):
        clock[0] = time.perf_counter()
        params = tt.train_two_tower(d["u2"], d["i2"], d["nU"], d["nI"], cfg,
                                    callback=cb, init=init, device=dev)
    return params, walls, curve


def tt_top10_vs_plain(params, d, dev, rec):
    """The users of the unfiltered recall (``rec``, through K5): their
    top-10 by K5 and by the plain chunked scan on the card, every id of
    both earning its score, the sorted scores within K5_TOL, the recall
    of each."""
    from tpu_als_torch.models import two_tower as tt

    users, inv = np.unique(d["ut"], return_inverse=True)
    with torch.no_grad():
        zu = tt.user_repr(params, torch.as_tensor(users, device=dev))
        zi = tt.item_repr(params, torch.arange(d["nI"], device=dev))
    valid = torch.ones(d["nI"], dtype=torch.bool, device=dev)
    recs = {}
    for name, fn in (("K5", cuda_topk.topk_scores),
                     ("plain scan", chunked_topk_scores)):
        s, ix = fn(zu, zi, valid, 10)
        err = earns_scores(zu, zi, valid, s, ix, f"two-tower top-10 ({name})")
        hits = (ix.cpu().numpy()[inv] == d["it"][:, None]).any(axis=1)
        recs[name] = (float(hits.mean()), err, s)
    if recs["K5"][0] != rec:
        fail(f"two-tower unfiltered recall {rec} != K5's own ids' "
             f"{recs['K5'][0]}")
    gap = (recs["K5"][2] - recs["plain scan"][2]).abs().max().item()
    if gap > K5_TOL:
        fail(f"two-tower top-10 scores: K5 vs the plain scan {gap:.3e}")
    return recs, gap


def tt_first_epoch_cpu(d, cfg, init, card_losses):
    """(c) the warm run's first epoch on the CPU from the same init and
    permutation: its per-step losses against the card's."""
    from tpu_als_torch.models import two_tower as tt

    cpu_losses = []
    t0 = time.perf_counter()
    with recording_losses(cpu_losses):
        tt.train_two_tower(d["u2"], d["i2"], d["nU"], d["nI"],
                           dataclasses.replace(cfg, epochs=1),
                           init=init, device="cpu")
    cpu = np.array([x.item() for x in cpu_losses])
    card = np.array([x.item() for x in card_losses[:len(cpu)]])
    rel = np.abs(card - cpu) / np.abs(cpu)
    if len(card) != len(cpu) or not np.isfinite(card).all() \
            or rel.max() > TT_LOSS_RTOL:
        fail(f"two-tower first epoch: card vs CPU losses off by "
             f"{rel.max():.3e} relative (step {int(rel.argmax())}), "
             f"band {TT_LOSS_RTOL}")
    log(f"(c) the warm run's first epoch on the CPU ({len(cpu)} steps, "
        f"{time.perf_counter() - t0:.1f} s): per-step losses within "
        f"{rel.max():.3e} relative of the card's (band {TT_LOSS_RTOL}; "
        f"step 1 {cpu[0]:.6f}, step {len(cpu)} {cpu[-1]:.6f})")


def _trace_kernels(prof_dir, name):
    """Kernel events in the Chrome traces under ``prof_dir`` whose name
    holds ``name``."""
    import glob

    n, files = 0, sorted(glob.glob(os.path.join(prof_dir, "*.json")))
    for path in files:
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
        n += sum(1 for e in evs if e.get("cat") == "kernel"
                 and name in e.get("name", ""))
    return n, files


def start_tt_clis(keep, tmp, seed):
    """(d) ``tt-train`` at config 5's shape and ``train --log-file
    --profile-dir`` on phase 9's 1M-row prefix at rank 128, started side
    by side (:func:`check_tt_clis` waits for them)."""
    T, O = os.path.join(tmp, "tt"), os.path.join(tmp, "tt_obs")
    M, L, P = (os.path.join(tmp, x) for x in ("m", "log.jsonl", "prof"))
    nU, nI, nnz = TT_SHAPE
    pt = start_probe(["tt-train", "--data", f"synthetic:{nU}x{nI}x{nnz}",
                      "--epochs", str(TT_CLI_EPOCHS), "--seed", str(seed),
                      "--output", T, "--obs-dir", O])
    pm = start_probe(["train", "--data",
                      f"csv:{os.path.join(keep, 'prefix.csv')}",
                      "--rank", str(RANK), "--max-iter", "3", "--seed",
                      str(seed), "--log-file", L, "--profile-dir", P,
                      "--output", M])
    return pt, pm, (T, M, L, P), time.perf_counter()


def check_tt_clis(pt, pm, paths, t0):
    """(d) the two processes' results, then ``observe summarize --json``
    and ``observe tail`` on the train run, as processes."""
    from tpu_als_torch.models import two_tower as tt

    T, M, L, P = paths
    tl, tk = finish_probe(pt, "tt-train")
    ml, mk = finish_probe(pm, "train --log-file --profile-dir")
    out = json.loads(tl[-1])
    if set(out) != TT_KEYS or out["epochs"] != TT_CLI_EPOCHS \
            or out["warm_start"] is not True \
            or not 0.0 <= out["filtered_recall_at_10"] <= 1.0:
        fail(f"tt-train: {out}")
    m, cfg, nu, ni = tt.load_two_tower(T)
    with torch.no_grad():
        z = tt.user_repr(m, torch.arange(nu, device=m.user_embed.device))
    if (nu, ni) != (out["users"], out["items"]) or cfg.epochs != \
            TT_CLI_EPOCHS or not bool(torch.isfinite(z).all()):
        fail(f"tt-train's save: {(nu, ni)}, {cfg}")
    if tk["k4"] == 0 or mk["k4"] == 0:
        fail(f"tt-train / train launches {tk} / {mk}: no K4")
    holdout = json.loads(ml[-1])["holdout_rmse"]
    procs = {"summarize": ["observe", "summarize", M, "--json"],
             "tail": ["observe", "tail", M, "-n", "5"]}
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", "tpu_als_torch.cli", *a],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
        for k, a in procs.items()}
    res = {}
    for k, p in procs.items():
        try:
            so, se = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            fail(f"observe {k}: no exit within 120 s")
        if p.returncode != 0:
            fail(f"observe {k} exited {p.returncode}: {se[-2000:]}")
        res[k] = so
    summ = json.loads(res["summarize"])
    its = summ["iterations"]
    if [e["iteration"] for e in its] != [1, 2, 3] or not all(
            math.isfinite(e.get("probe_rmse", math.nan)) for e in its):
        fail(f"observe summarize: iterations {its}")
    if not TRAIN_PHASES <= set(summ["phases"]):
        fail(f"observe summarize: phases {sorted(summ['phases'])}")
    tail = [json.loads(x) for x in res["tail"].splitlines()]
    if len(tail) != 5 or tail[-1]["type"] != "snapshot":
        fail(f"observe tail: {tail}")
    with open(L) as f:
        logged = [json.loads(x) for x in f]
    if [r["iteration"] for r in logged] != [1, 2, 3]:
        fail(f"--log-file: {logged}")
    k4_events, files = _trace_kernels(P, K4_KERNEL)
    if k4_events == 0:
        fail(f"--profile-dir: no {K4_KERNEL} kernel in {files}")
    size = sum(os.path.getsize(f) for f in files)
    log(f"(d) tt-train (config 5's shape, {TT_CLI_EPOCHS} epochs): "
        f"{json.dumps(out)}; launches {tk}; its save loads")
    log(f"(d) train --log-file --profile-dir (rank {RANK}, 3 iterations, "
        f"{CSV_TWIN_ROWS} rows): holdout_rmse {holdout}, launches {mk}; "
        f"probe_rmse {[round(e['probe_rmse'], 4) for e in its]}; phases "
        + ", ".join(f"{p} {summ['phases'][p]['total_seconds']:.3f} s"
                    for p in sorted(TRAIN_PHASES))
        + f"; the trace ({len(files)} file, {size / 1e6:.1f} MB under "
        f"--profile-dir) holds {k4_events} {K4_KERNEL} (K4) kernels; "
        f"observe tail ends with a snapshot ({time.perf_counter() - t0:.1f}"
        " s, four processes, beside (c))")


def tt_profile_epoch(d, cfg, params, dev):
    """One more epoch from the warm model under the profiler: the wall
    and device busy time a step, the device's idle share, the kernels a
    step and the top kernels (eager torch: no kernel of the port runs in
    a step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_als_torch.models import two_tower as tt

    steps = len(d["u2"]) // cfg.batch_size
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tt.train_two_tower(d["u2"], d["i2"], d["nU"], d["nI"],
                           dataclasses.replace(cfg, epochs=1), init=params,
                           device=dev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    # kernels and copies only: the optimizer's record_function range
    # also lands on the device's timeline, over its kernels
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0
          and not getattr(e, "is_user_annotation", False)
          and not e.key.startswith("Activity Buffer")]
    busy = sum(e.self_device_time_total for e in ev) / 1e3 / steps
    log(f"profile two-tower epoch ({steps} steps): wall_ms a step "
        f"{wall:.3f}, device_busy_ms {busy:.3f}, device_idle_share "
        f"{1 - busy / wall:.3f}, kernels a step "
        f"{sum(e.count for e in ev) / steps:.1f}")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:5]:
        log(f"  {e.self_device_time_total / 1e3 / steps:9.4f} ms  "
            f"x{e.count / steps:<5.1f} {e.key[:90]}")


def two_tower_phase(dev, keep, seed, smi):
    """Phase 10: config 5 on the card, then train's observability and the
    run-directory readers as processes."""
    from tpu_als_torch.models import two_tower as tt

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    d = tt_data(seed)
    log(f"two-tower data {TT_SHAPE}: {len(d['u2'])} training pairs, "
        f"{len(d['ut'])} test pairs ({time.perf_counter() - t0:.1f} s, "
        "host)")
    _zero_launches()
    # (a) the ALS warm start through the port's trainer (K4)
    t0 = time.perf_counter()
    ucsr = build_csr_buckets(d["u2"], d["i2"], d["r2"], d["nU"])
    icsr = build_csr_buckets(d["i2"], d["u2"], d["r2"], d["nI"])
    t_block = time.perf_counter() - t0
    t0 = time.perf_counter()
    U, V = core_als.train(ucsr, icsr, core_als.AlsConfig(seed=seed, **TT_ALS),
                          device=dev)
    torch.cuda.synchronize()
    t_als = time.perf_counter() - t0
    if not (bool(torch.isfinite(U).all()) and bool(torch.isfinite(V).all())):
        fail("two-tower warm start: non-finite ALS factors")
    widest = int(max(np.bincount(d["u2"]).max(), np.bincount(d["i2"]).max()))
    als_launches = _launch_counts()
    wide = widest > core_als.SPLIT_WIDTH
    if als_launches["k4"] == 0 or (wide and (als_launches["k3"] == 0
                                             or als_launches["k1"] == 0)):
        fail(f"two-tower warm start: launches {als_launches} (widest row "
             f"{widest})")
    log(f"(a) ALS warm start (rank {TT_ALS['rank']}, {TT_ALS['max_iter']} "
        f"iterations, implicit, alpha {TT_ALS['alpha']}): blocking "
        f"{t_block:.2f} s (host), fit {t_als:.2f} s; K4 "
        f"{als_launches['k4']}, K3 {als_launches['k3']}, K1 "
        f"{als_launches['k1']} launches (widest row {widest})")
    tt_half_steps_vs_f64(U, V, ucsr, icsr, d, dev)
    _zero_launches()
    # (b) warm, then cold, 20 epochs each
    cfg = tt.TwoTowerConfig(embed_dim=32, hidden=(64,), out_dim=32,
                            batch_size=4096, epochs=TT_EPOCHS, seed=seed)
    init = tt.init_params(d["nU"], d["nI"], cfg, U.cpu().numpy(),
                          V.cpu().numpy(), device="cpu")
    card_losses = []
    warm, walls_w, curve_w = tt_fit(d, cfg, init, dev, "warm", card_losses)
    k5 = cuda_topk.LAUNCHES
    rec_unf = tt.recall_at_k(warm, d["ut"], d["it"], k=10)
    k5_main = cuda_topk.LAUNCHES - k5
    cold_init = tt.init_params(d["nU"], d["nI"], cfg, device="cpu")
    _, walls_c, curve_c = tt_fit(d, cfg, cold_init, dev, "cold", [])
    launches = _launch_counts()
    if launches["k5"] == 0 or k5_main == 0:
        fail(f"two-tower phase: launches {launches}, K5 in recall "
             f"{k5_main}")
    recs, gap = tt_top10_vs_plain(warm, d, dev, rec_unf)
    steps = len(d["u2"]) // cfg.batch_size
    for tag, walls in (("warm", walls_w), ("cold", walls_c)):
        w = np.array(walls[1:]) * 1e3   # epoch 1 also builds the optimizer
        log(f"(b) {tag}: {TT_EPOCHS} epochs of {steps} steps, epoch wall "
            f"first {walls[0] * 1e3:.1f} ms, then median {np.median(w):.1f}"
            f" (min {w.min():.1f}, max {w.max():.1f}) ms, "
            f"{np.median(w) / steps:.3f} ms a step; {sum(walls):.2f} s "
            "of training (host clock, evaluation excluded)")
    log(f"(b) filtered recall@10 at epochs {TT_MILESTONES}: warm "
        f"{[round(curve_w[e][0], 4) for e in TT_MILESTONES]}, with "
        f"serving_bias {[round(curve_w[e][1], 4) for e in TT_MILESTONES]}"
        f", cold {[round(curve_c[e][0], 4) for e in TT_MILESTONES]}")
    log(f"(b) unfiltered warm recall@10 through K5 {rec_unf:.4f} (K5 "
        f"{k5_main} launch), the plain chunked scan on the card "
        f"{recs['plain scan'][0]:.4f}; ids earn their scores (K5 "
        f"{recs['K5'][1]:.2e}, plain {recs['plain scan'][1]:.2e}), sorted "
        f"scores within {gap:.2e}; launches in (b) {launches}")
    tt_profile_epoch(d, cfg, warm, dev)
    with tempfile.TemporaryDirectory() as tmp:
        clis = start_tt_clis(keep, tmp, seed)
        # (c) on this process's CPU while (d)'s processes run
        tt_first_epoch_cpu(d, cfg, init, card_losses)
        check_tt_clis(*clis)
    obs.reset()
    secs = time.perf_counter() - t_phase
    log(f"phase 10 (the two-tower model and train's observability): "
        f"{secs:.1f} s on {smi}")
    return secs


# -- phase 11: the measurement tools and the sharding flags -----------------
ATTR_ITERS, ATTR_WARMUP = 3, 1
ATTR_COVERAGE = 0.9     # stage sums over the decomposed twin's wall
PHASE11_BUDGET_S = 60.0
REC_SCORE_TOL = 5e-5    # the CLI prints scores rounded to 4 decimals


def attribution_phase(csrs, tr, dev, smi):
    """(a) ``measure_attributed`` on phase 5's rank-128 ML-25M containers
    ('auto': K4 on the narrow buckets, K3 + K1 on the wide ones, each
    counted): stage sums within ATTR_COVERAGE of the decomposed wall,
    the gap table against ``roofline(ne_path='auto')``, the production
    iteration beside phase 5's, and the stage model's floor (padded
    entries) beside the real-entry bound of the same iteration."""
    ucsr, icsr = csrs
    cfg = tr["cfg"]
    _zero_launches()
    m = measure_attributed(ucsr, icsr, cfg, iters=ATTR_ITERS,
                           warmup=ATTR_WARMUP, device=dev)
    counts = _launch_counts()
    if min(counts[k] for k in ("k1", "k3", "k4")) == 0:
        fail(f"(a) the attributed iteration did not launch K4, K3 and K1: "
             f"{counts}")
    rl = roofline(ucsr.num_rows, icsr.num_rows, ucsr.nnz, RANK,
                  implicit=True, ne_path=m["ne_path"], cfg=cfg,
                  user_counts=ucsr.counts, item_counts=icsr.counts)
    rep = attribution_report(m, rl)
    log(render_attribution(rep))
    real = 0.0
    for bks, n in ((tr["ib"], tr["n_items"]), (tr["ub"], tr["n_users"])):
        real += fused_solve_bound(*gram_work(bks, n), RANK)[0]
    floor = rl["roofline_floor_s_per_iter"] * 1e3
    log(f"(a) attribution ({smi}): routes {m['routes']}, launches "
        f"{counts}; coverage {m['coverage']:.4f} (>= {ATTR_COVERAGE}); "
        f"twin {m['wall_s_per_iter'] * 1e3:.1f} ms, production iteration "
        f"{m['fused_s_per_iter'] * 1e3:.1f} ms beside phase 5's "
        + ", ".join(f"{x * 1e3:.1f}" for x in tr["iter_s"])
        + f" ms; stage-model floor {floor:.2f} ms (padding waste "
        f"{rl['config']['padding_waste']:.4f}, derived) against the "
        f"real-entry bound {real:.2f} ms ({floor / real:.2f}x)")
    if not m["coverage"] >= ATTR_COVERAGE:
        fail(f"(a) the stages cover {m['coverage']:.4f} of the attributed "
             f"wall, below {ATTR_COVERAGE}")
    return counts


def gather_audit(tr):
    """(b) ``gather_out_bytes`` on CUDA tensors, one item bucket per
    route of the rank-128 half-step: exactly n·w·r·4 on 'unfused' (its
    ``V[cols]``), 0 on K4's and on K3's (the kernels gather inside); and
    ``kernel_cost_bytes`` equal to the roofline's closed form summed over
    the calls the half-step makes, whose number is held too (one K4 call
    for the whole bucket, one K3 call a chunk of ``core.als._chunk_rows``,
    none unfused).  The declared bytes are the model's at the wrappers'
    shapes, not a measurement of the kernels' traffic."""
    cfg, U0, n_items = tr["cfg"], tr["U0"], tr["n_items"]
    yU = compute_yty(U0)
    k4_b = next(b for b in tr["ib"] if core_als.resolve_solve_path(
        cfg, RANK, b.width) == "gatherfused_solve")
    k3_b = next(b for b in tr["ib"] if core_als.resolve_solve_path(
        cfg, RANK, b.width).startswith("gatherfused+"))
    cases = (("unfused", k4_b, "unfused"), ("K4", k4_b, "auto"),
             ("K3", k3_b, "auto"))
    got = {}
    for name, b, backend in cases:
        c = dataclasses.replace(cfg, solve_backend=backend)

        def half(b=b, c=c):
            return core_als.local_half_step(U0, [b], n_items, c, yU)

        n, w = b.cols.shape
        gb = gather_out_bytes(half)[0]
        kb, calls = kernel_cost_bytes(half)
        torch.cuda.synchronize()
        if name == "K3":
            step = core_als._chunk_rows(core_als.resolve_solve_path(
                c, RANK, w), n, w, RANK, 1 << 19)
            rows = [min(step, n - s) for s in range(0, n, step)]
            want = (0, sum(fused_ne_kernel_bytes(m * w, m, RANK, 4)
                           for m in rows), len(rows))
        else:
            want = {"unfused": (n * w * RANK * 4, 0, 0),
                    "K4": (0, fused_solve_kernel_bytes(n * w, n, RANK, 4),
                           1)}[name]
        got[name] = (n, w, gb, kb, calls)
        if (gb, kb, calls) != want:
            fail(f"(b) {name} bucket {n} x {w}: gathered {gb} B, declared "
                 f"{kb} B in {calls} calls; expected {want}")
    log("(b) gather audit on the card, rank 128 item buckets: " + "; ".join(
        f"{k} {n} x {w}: gathered {gb} B, kernels declared {kb} B in "
        f"{calls} calls" for k, (n, w, gb, kb, calls) in got.items()))


def start_sharded_train(prefix, M, seed, dev):
    """(c) ``train --devices 4 --gather-strategy all_gather --elastic`` on
    phase 9's 1M-row prefix at rank 128, a gated process with its kernels
    counted in it (:func:`sharded_clis` releases it)."""
    return start_probe(
        ["train", "--data", f"csv:{prefix}", "--rank", str(RANK),
         "--max-iter", "3", "--implicit", "--alpha", str(ALPHA),
         "--reg-param", str(REG), "--seed", str(seed), "--device", str(dev),
         "--devices", str(SHARDS), "--gather-strategy", "all_gather",
         "--elastic", "--output", M], gated=True)


def start_sharded_recommend(M, dev):
    """(c) ``recommend --devices 4 --gather-strategy ring`` on the model
    the sharded ``train`` writes, gated until that model is there."""
    return start_probe(["recommend", "--model", M, "--devices", str(SHARDS),
                        "--gather-strategy", "ring", "--k", "10", "--limit",
                        "0", "--device", str(dev)], gated=True)


def sharded_clis(pt, pr, M, prefix, seed, dev):
    """(c) the sharded ``train`` process's model within TRAIN_REL of the
    same fit in this process on 4 logical shards (same data, split and
    seed), then the ``recommend`` process on it (K5 counted), every
    user's top-10 equal to ``recommend_arrays(mesh=)``'s."""
    from tpu_als_torch.cli import _load_train_data

    release_probe(pt)
    frame, _ = _load_train_data(f"csv:{prefix}")
    train, _ = frame.randomSplit([0.8, 0.2], seed=seed)
    mesh = make_mesh(devices=[dev] * SHARDS)
    mine = ALS(rank=RANK, maxIter=3, regParam=REG, implicitPrefs=True,
               alpha=ALPHA, seed=seed, coldStartStrategy="drop", mesh=mesh,
               gatherStrategy="all_gather").fit(train)
    tl, tk = finish_probe(pt, "train --devices 4", timeout=120)
    if min(tk[k] for k in ("k1", "k3", "k4")) == 0:
        fail(f"(c) train --devices {SHARDS}: launches {tk}")
    release_probe(pr)
    saved = ALSModel.load(M, device=dev)
    if not (np.array_equal(saved._user_map.ids, mine._user_map.ids)
            and np.array_equal(saved._item_map.ids, mine._item_map.ids)):
        fail("(c) the CLI's sharded model holds other ids than this "
             "process's fit")
    eu, ev = row_rel(saved._U, mine._U), row_rel(saved._V, mine._V)
    if not (eu <= TRAIN_REL and ev <= TRAIN_REL):
        fail(f"(c) the CLI's sharded fit vs this process's: users "
             f"{eu:.3e}, items {ev:.3e} (tol {TRAIN_REL})")
    users, ids, scores = saved.recommend_arrays(10, mesh=mesh,
                                                gatherStrategy="ring")
    rl, rk = finish_probe(pr, "recommend --devices 4", timeout=120)
    recs = [json.loads(x) for x in rl if x.startswith("{")]
    if rk["k5"] == 0 or len(recs) != len(users):
        fail(f"(c) recommend --devices {SHARDS}: {len(recs)} users of "
             f"{len(users)}, launches {rk}")
    worst = 0.0
    for j, rec in enumerate(recs):
        got_ids = [i for i, _ in rec["items"]]
        got_s = np.array([s for _, s in rec["items"]])
        worst = max(worst, float(np.abs(got_s - scores[j]).max()))
        if rec["user"] != int(users[j]) or got_ids != ids[j].tolist():
            fail(f"(c) recommend --devices {SHARDS}, user {rec['user']}: "
                 f"{got_ids} vs recommend_arrays' {ids[j].tolist()}")
    if worst > REC_SCORE_TOL:
        fail(f"(c) recommend scores off recommend_arrays' by {worst:.3e}")
    log(f"(c) train --devices {SHARDS} --gather-strategy all_gather "
        f"--elastic (rank {RANK}, 3 iterations, {CSV_TWIN_ROWS} rows): "
        f"{tl[-1]}, launches {tk}; vs this process's 4-shard fit: max "
        f"per-row |diff|/|x| users {eu:.3e}, items {ev:.3e} (tol "
        f"{TRAIN_REL}); recommend --devices {SHARDS} --gather-strategy "
        f"ring: {len(recs)} users, ids equal to recommend_arrays', scores "
        f"within {worst:.1e}, launches {rk}")


def start_observe_attribution(prefix, run, dev):
    """(a) ``observe attribution --obs-dir`` on phase 9's prefix, a gated
    process."""
    return start_probe(["observe", "attribution", "--data", f"csv:{prefix}",
                        "--rank", str(RANK), "--alpha", str(ALPHA), "--reg",
                        str(REG), "--iters", "2", "--json", "--obs-dir", run,
                        "--device", str(dev)], gated=True)


def check_observe_attribution(p, run):
    """Release the ``observe attribution`` process and wait for it while
    nothing else runs, since it times its stages: coverage at least
    ATTR_COVERAGE, and the run directory holds the ``attribution`` event
    and ``train.stage_seconds``."""
    release_probe(p)
    att = json.loads(finish_probe(p, "observe attribution",
                                  timeout=120)[0][-1])
    with open(os.path.join(run, "events.jsonl")) as f:
        events = [json.loads(x) for x in f if x.strip()]
    attr = [e for e in events if e["type"] == "attribution"]
    snap = [e for e in events if e["type"] == "snapshot"]
    if len(attr) != 1 or not snap or not any(
            h.startswith("train.stage_seconds")
            for h in snap[-1]["histograms"]):
        fail(f"observe attribution --obs-dir: {len(attr)} attribution "
             "events, stage histograms missing")
    if not att["coverage"] >= ATTR_COVERAGE:
        fail(f"observe attribution: coverage {att['coverage']}")
    log(f"(a) observe attribution (rank {RANK}, {CSV_TWIN_ROWS} rows, the "
        f"only process at work): routes {att.get('routes')}, coverage "
        f"{att['coverage']:.4f}, twin {att['wall_s_per_iter'] * 1e3:.2f} "
        f"ms, production {att['fused_s_per_iter'] * 1e3:.2f} ms; the run "
        f"directory holds the attribution event and train.stage_seconds")


def start_observe_roofline():
    """(a) ``observe roofline --json`` as a process (host work only)."""
    return start_probe(["observe", "roofline", "--ne-path",
                        "gather_fused_solve", "--json"])


def check_observe_roofline(p):
    """The roofline prices K4's stages at the card's rates."""
    rl = json.loads(finish_probe(p, "observe roofline", timeout=120)[0][-1])
    if [s["name"] for s in rl["stages"]] != ["gather_fused_solve",
                                              "scatter", "yty"] or \
            rl["config"]["hbm_gbps"] != HBM_BYTES_PER_S / 1e9:
        fail(f"observe roofline --json: {rl}")
    log(f"(a) observe roofline (the headline, K4): floor "
        f"{rl['roofline_floor_s_per_iter'] * 1e3:.3f} ms, HBM floor "
        f"{rl['hbm_floor_s_per_iter'] * 1e3:.3f} ms")


def measurement_phase(csrs, tr, keep, seed, dev, smi):
    """Phase 11: the measurement tools and the sharding flags on phase
    5's rank-128 containers and phase 9's prefix (budget
    PHASE11_BUDGET_S).  The two timed measurements run one after the
    other with nothing else at work, on the card or on the host: (a) in
    this process before any other is started, then ``observe
    attribution``.  The phase's processes start after (a) and do their
    imports beside (b) and one another; each of the CLI's commands is
    gated, so none touches the card before it is released, and the
    other gated ones wait idle while ``observe attribution`` runs."""
    t0 = time.perf_counter()
    prefix = os.path.join(keep, "prefix.csv")
    M = os.path.join(keep, "sharded_model")
    run = os.path.join(keep, "attribution_obs")
    counts = attribution_phase(csrs, tr, dev, smi)
    gated = {"observe attribution": start_observe_attribution(prefix, run,
                                                              dev),
             "train --devices 4": start_sharded_train(prefix, M, seed, dev),
             "recommend --devices 4": start_sharded_recommend(M, dev)}
    prl = start_observe_roofline()
    gather_audit(tr)
    check_observe_roofline(prl)
    for what, p in gated.items():
        probe_ready(p, what)
    check_observe_attribution(gated["observe attribution"], run)
    sharded_clis(gated["train --devices 4"],
                 gated["recommend --devices 4"], M, prefix, seed, dev)
    secs = time.perf_counter() - t0
    log(f"phase 11 (the measurement tools and the sharding flags): "
        f"{secs:.1f} s on {smi}")
    if secs > PHASE11_BUDGET_S:
        fail(f"phase 11 took {secs:.1f} s, over its {PHASE11_BUDGET_S} s")
    return counts


# -- phase 12: the execution planner ----------------------------------------
PHASE12_BUDGET_S = 40.0


def counting_timer(rank, dev, launches):
    """The default timer (``autotune.make_timer`` on the card), each
    trial's launch counts appended to ``launches``."""
    timer = autotune.make_timer(rank, "float32", device=dev)

    def counted(config):
        _zero_launches()
        seconds = timer(config)
        launches.append(_launch_counts())
        return seconds

    counted.source = timer.source
    counted.shapes, counted.shape = timer.shapes, timer.shape
    return counted


def banked_kernel_config(rank, dev, shape_class="generic"):
    """The ``kernel_config`` component banked for ``rank`` on ``dev``
    under ``shape_class``."""
    from tpu_als_torch.plan import cache as plan_cache

    entry = plan_cache.load_entry(plan.plan_key(
        rank=rank, dtype="float32", device=dev, shape_class=shape_class))
    comp = (entry or {}).get("components", {}).get("kernel_config")
    if comp is None:
        fail(f"no kernel_config banked at rank {rank} ({shape_class})")
    return comp


def tune_on_card(rank, dev, smi, tag, path, space=None, trials=None):
    """A cold ``resolve_kernel_config(tune=True)`` with the default timer:
    ``trials`` trials, each launching every kernel of ``path``, each
    printed beside ``autotune.model_seconds``; the bank ``source=
    "device"``.  Returns the winning config."""
    launches = []
    n0 = len(obs.events("tune_trial"))
    t0 = time.perf_counter()
    config = plan.resolve_kernel_config(
        rank=rank, tune=True, space=space, device=dev,
        timer=counting_timer(rank, dev, launches))
    secs = time.perf_counter() - t0
    comp = banked_kernel_config(rank, dev)
    prov = comp["provenance"]
    shape = prov["model"]["shape"]
    done = obs.events("tune_trial")[n0:]
    shapes = autotune.synthetic_shapes(shape["n"], shape["w"],
                                       shape["max_w"])
    for ev, counts in zip(done, launches):
        model = autotune.model_seconds(ev["config"], rank, shapes)
        log(f"({tag}) trial {ev['config']}: {ev['seconds'] * 1e3:.3f} ms "
            f"(min of {shape['k']}), model {model * 1e3:.3f} ms "
            f"({ev['seconds'] / model:.2f}x); launches "
            + ", ".join(f"{k.upper()} {counts[k]}" for k in path))
    if len(done) != trials or len(launches) != trials:
        fail(f"({tag}) {len(done)} trials, expected {trials}")
    if any(min(c[k] for k in path) == 0 for c in launches):
        fail(f"({tag}) a trial did not launch all of {path}: {launches}")
    if prov.get("source") != "device" or comp["resolved"] != config:
        fail(f"({tag}) banked {comp}, resolved {config}")
    log(f"({tag}) rank {rank} on {smi}: winner {config}, default "
        f"{prov['default_seconds'] * 1e3:.3f} ms / measured "
        f"{prov['measured_seconds'] * 1e3:.3f} ms = "
        f"{prov['default_seconds'] / prov['measured_seconds']:.3f}x, model "
        f"{prov['model_seconds'] * 1e3:.3f} ms (measured/model "
        f"{prov['ratio']:.2f}); tune {secs:.1f} s (timer's instance "
        f"{shape})")
    return config


def planner_warm_process(p, run, config):
    """(b) the gated ``plan tune`` process reads (a)'s bank: its trail
    has ``plan_cache_hit`` and no ``tune_trial``, its config is (a)'s,
    and it launches no kernel."""
    probe_ready(p, "plan tune")
    t0 = time.perf_counter()
    release_probe(p)
    lines, counts = finish_probe(p, "plan tune", timeout=120)
    out = json.loads(lines[-1])
    with open(os.path.join(run, "events.jsonl")) as f:
        types = [json.loads(x)["type"] for x in f if x.strip()]
    log(f"(b) plan tune as a process ({time.perf_counter() - t0:.1f} s once "
        f"released): config {out['config']}, trail "
        f"{[t for t in types if t.startswith(('plan_', 'tune_'))]}, "
        f"launches {counts}")
    if out["config"] != config or "plan_cache_hit" not in types \
            or "tune_trial" in types or any(counts.values()):
        fail(f"(b) the warm process: {out}, trail {types}, launches {counts}")


def route_launches(csrs, cfg, r, split):
    """K4 and K3 launches of one iteration at ``split``: one K4 call a
    bucket at or below it, one K3 call a row chunk of each wider one."""
    k4 = k3 = 0
    for csr in csrs:
        for b in csr.buckets:
            nb, w = b.cols.shape
            path = core_als.resolve_solve_path(cfg, r, w, split)
            if path in core_als._K4_PATHS:
                k4 += 1
            else:
                k3 += -(-nb // core_als._chunk_rows(path, nb, w, r,
                                                     csr.chunk_elems, split))
    return {"k4": k4, "k3": k3}


def fit_tune_on_card(csrs, tr, dev, smi, synthetic):
    """(c) the fit's own tune: ``core.als.train`` with
    ``TPU_ALS_AUTOTUNE=1`` and no iteration, from phase 5's init, misses
    its own key (the problem's shape class, not the synthetic timer's
    ``"generic"``) and times 8 trials of one iteration of itself, K4, K3
    and K1 launched; each trial is printed beside ``autotune.
    model_seconds`` over the fit's buckets, the winner beside the
    synthetic timer's.  Returns the fit's banked config."""
    ucsr, icsr = csrs
    n0 = len(obs.events("tune_trial"))
    _zero_launches()
    os.environ[plan.AUTOTUNE_ENV] = "1"
    t0 = time.perf_counter()
    try:
        core_als.train(ucsr, icsr,
                       dataclasses.replace(tr["cfg"], max_iter=0),
                       init=(tr["U0"], tr["V0"]), device=dev)
    finally:
        del os.environ[plan.AUTOTUNE_ENV]
    secs = time.perf_counter() - t0
    counts = _launch_counts()
    done = obs.events("tune_trial")[n0:]
    sc = plan.shape_class(ucsr.num_rows, icsr.num_rows, ucsr.nnz)
    comp = banked_kernel_config(RANK, dev, sc)
    prov, config = comp["provenance"], comp["resolved"]
    shapes = autotune.data_shapes(ucsr, icsr)
    for ev in done:
        model = autotune.model_seconds(ev["config"], RANK, shapes)
        log(f"(c) fit trial {ev['config']}: {ev['seconds'] * 1e3:.3f} ms an "
            f"iteration (min of 3), model {model * 1e3:.3f} ms "
            f"({ev['seconds'] / model:.2f}x)")
    log(f"(c) the fit's own tune ({sc}, {smi}): winner {config}, default "
        f"{prov['default_seconds'] * 1e3:.3f} ms / measured "
        f"{prov['measured_seconds'] * 1e3:.3f} ms = "
        f"{prov['default_seconds'] / prov['measured_seconds']:.3f}x, model "
        f"{prov['model_seconds'] * 1e3:.3f} ms; the synthetic timer's "
        f"winner {synthetic}; launches "
        + ", ".join(f"{k.upper()} {counts[k]}" for k in ("k1", "k3", "k4"))
        + f"; {secs:.1f} s")
    if len(done) != 8 or prov.get("source") != "device" or \
            min(counts[k] for k in ("k1", "k3", "k4")) == 0:
        fail(f"(c) the fit's own tune: {len(done)} trials, provenance "
             f"{prov}, launches {counts}")
    return config


def planner_fits(csrs, tr, config, dev, smi):
    """(c) two tuned iterations, reading the fit's banked ``config``,
    (d) two armed ones with the gate off and one planner-off, all from
    phase 5's init: the factors after the first iteration, the second
    one's wall, the launches per iteration."""
    ucsr, icsr = csrs
    cfg, init = tr["cfg"], (tr["U0"], tr["V0"])

    def fit(iters):
        ticks, first = [], {}

        def tick(it, U, V):
            torch.cuda.synchronize()
            ticks.append(time.perf_counter())
            if it == 1:
                first["U"], first["V"] = U.clone(), V.clone()

        _zero_launches()
        core_als.train(ucsr, icsr, dataclasses.replace(cfg, max_iter=iters),
                       callback=tick, init=init, device=dev)
        per = {k: v / iters for k, v in _launch_counts().items()}
        wall = ticks[1] - ticks[0] if iters > 1 else None
        return first["U"], first["V"], per, wall

    n0 = len(obs.events("plan_resolved"))
    os.environ[plan.AUTOTUNE_ENV] = "1"
    try:
        Ut, Vt, tuned, t_ms = fit(2)
    finally:
        del os.environ[plan.AUTOTUNE_ENV]
    sources = [(e["component"], e["source"])
               for e in obs.events("plan_resolved")[n0:]]
    Ua, Va, armed, a_ms = fit(2)
    split = config["split_width"]
    want = route_launches(csrs, cfg, RANK, split)
    log(f"(c) tuned iteration ({smi}): {t_ms * 1e3:.1f} ms beside the "
        f"untuned {a_ms * 1e3:.1f} ms (each an iteration 2; phase 5's "
        + ", ".join(f"{x * 1e3:.1f}" for x in tr["iter_s"])
        + f" ms); per iteration K4 {tuned['k4']:g}, K3 {tuned['k3']:g}, K1 "
        f"{tuned['k1']:g} (at split {split}: K4 {want['k4']}, K3 "
        f"{want['k3']}) beside phase 5's "
        + ", ".join(f"{k.upper()} {v / tr['max_iter']:g}"
                    for k, v in tr["launches"].items())
        + f"; planner {sources}")
    if ("kernel_config", "cache") not in sources or \
            (tuned["k4"], tuned["k3"]) != (want["k4"], want["k3"]) or \
            (want["k3"] and tuned["k1"] == 0):
        fail(f"(c) the tuned iteration's launches {tuned} are not the routes "
             f"at split {split} ({want}), or its config was not read: "
             f"{sources}")
    n0 = len(obs.events())
    os.environ[PLAN_ENV] = "off"
    try:
        Uo, Vo, off, _ = fit(1)
    finally:
        os.environ[PLAN_ENV] = os.path.join(PLAN_ROOT, "planner")
    stray = [e["type"] for e in obs.events()[n0:]
             if e["type"].startswith(("plan_", "tune_"))]
    phase5 = {k: v / tr["max_iter"] for k, v in tr["launches"].items()}
    want = route_launches(csrs, cfg, RANK, core_als.SPLIT_WIDTH)
    bitwise = torch.equal(Ua, Uo) and torch.equal(Va, Vo)
    log(f"(d) planner off: launches {off}, armed with the gate off "
        f"{armed}, phase 5 per iteration {phase5}; factors bitwise equal "
        f"{bitwise}; plan events while off {stray}")
    if off != armed or any(off[k] != v for k, v in phase5.items()) or \
            sum(off.values()) != sum(phase5.values()) or \
            off["k4"] != want["k4"] or not bitwise or stray:
        fail(f"(d) off is not free: launches off {off}, armed {armed}, "
             f"phase 5 {phase5}, routes {want}, bitwise {bitwise}, events "
             f"{stray}")
    eu, ev = row_rel(Ut, Ua), row_rel(Vt, Va)
    log(f"(c) tuned vs untuned iteration: max per-row |diff|/|x| users "
        f"{eu:.3e}, items {ev:.3e} (tol {TRAIN_REL})")
    if not (eu <= TRAIN_REL and ev <= TRAIN_REL):
        fail(f"(c) the tuned iteration is off the untuned one: users {eu:.3e}"
             f", items {ev:.3e} (tol {TRAIN_REL})")


def planner_phase(csrs, tr, dev, smi):
    """Phase 12: the execution planner in a plan cache of its own (budget
    PHASE12_BUDGET_S): (b)'s process imports beside (a) and runs once
    (a) has banked, and writes the bank (``--bank-out``) that phase 13b
    audits.  Returns the bank's path."""
    t0 = time.perf_counter()
    root = os.path.join(PLAN_ROOT, "planner")
    run_root = os.environ[PLAN_ENV]
    os.environ[PLAN_ENV] = root
    try:
        run = os.path.join(root, "tune_obs")
        bank = os.path.join(root, "bank.json")
        p = start_probe(["plan", "tune", "--rank", str(RANK), "--obs-dir",
                         run, "--device", str(dev), "--bank-out", bank],
                        gated=True, plan_dir=root)
        config = tune_on_card(RANK, dev, smi, "a", ("k1", "k3", "k4"),
                              trials=8)
        planner_warm_process(p, run, config)
        planner_fits(csrs, tr, fit_tune_on_card(csrs, tr, dev, smi, config),
                     dev, smi)
        tune_on_card(RANK256, dev, smi, "e", ("k3", "k4", "k6"),
                     space={"split_width": [8192, 16384]}, trials=2)
    finally:
        os.environ[PLAN_ENV] = run_root
    secs = time.perf_counter() - t0
    log(f"phase 12 (the execution planner): {secs:.1f} s on {smi}")
    if secs > PHASE12_BUDGET_S:
        fail(f"phase 12 took {secs:.1f} s, over its {PHASE12_BUDGET_S} s")
    if not os.path.exists(bank):
        fail("(b) plan tune --bank-out wrote no bank")
    return bank


# -- phase 13: timings -----------------------------------------------------
# -- phase 13: two processes on the one card --------------------------------

PHASE13_BUDGET_S = 90.0
MH_PROCS, MH_SHARDS = 2, 2      # processes, logical shards each: 4 positions
MH_SERVE_USERS = 4096


def mh_worker(work, init_method):
    """One process of phase 13 (``chip_smoke.py --mh-worker WORK``, with
    torch's launcher variables set by the run): load this process's
    interleaved half of the ML-25M triples, say ``ready`` on stderr and
    wait for ``go``; then (a) ``ALS(mesh=2 logical shards of cuda:0,
    dataMode='per_host', gatherStrategy='all_gather', maxIter=2)`` from
    phase 5's init (a checkpoint at iteration 0, ``resumeFrom``), each
    iteration timed around the step the fit builds (device synced, the
    processes lined up by a barrier first) with the multihost
    transport's counts (``multihost.COMM``) read around it, (b) a sharded checkpoint at iteration 2 (``checkpointSharded``),
    (c) ``topk_sharded(U[:4096], V, 10, mesh, 'all_gather')`` (K5).
    Process 0 saves the fit's factors; each process its top-k rows.  The
    last stdout line: this process's JSON (walls, counts, launches)."""
    from tpu_als_torch.parallel import multihost, trainer

    pin_fp32()
    pid = int(os.environ["RANK"])
    local = ColumnarFrame({k: np.load(os.path.join(work, f"{k}{pid}.npy"))
                           for k in ("user", "item", "rating")})
    print("ready", file=sys.stderr, flush=True)
    if sys.stdin.readline().strip() != "go":
        sys.exit(1)
    multihost.init_distributed(init_method=init_method)
    mesh = make_mesh(devices=["cuda:0"] * MH_SHARDS)
    iters = []
    make_step = trainer.make_process_step

    def timed_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(U, V):
            torch.cuda.synchronize()
            multihost.barrier()  # both processes start the step together
            c0, t0 = dict(multihost.COMM), time.perf_counter()
            U, V = step(U, V)
            torch.cuda.synchronize()
            iters.append({"wall_s": time.perf_counter() - t0,
                          **{k: multihost.COMM[k] - c0[k] for k in c0}})
            return U, V
        return run

    trainer.make_process_step = timed_step
    est = ALS(rank=RANK, implicitPrefs=True, alpha=ALPHA, regParam=REG,
              maxIter=2, mesh=mesh, dataMode="per_host",
              gatherStrategy="all_gather",
              resumeFrom=os.path.join(work, "init"),
              checkpointDir=os.path.join(work, "ckpt"), checkpointInterval=2,
              checkpointSharded=True)
    _zero_launches()
    t0 = time.perf_counter()
    model = est.fit(local)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = _launch_counts()
    if pid == 0:
        np.save(os.path.join(work, "U.npy"), model._U.cpu().numpy())
        np.save(os.path.join(work, "V.npy"), model._V.cpu().numpy())
    _zero_launches()
    t0 = time.perf_counter()
    sc, ix, off = serve.topk_sharded(model._U[:MH_SERVE_USERS], model._V,
                                     10, mesh, strategy="all_gather")
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    np.save(os.path.join(work, f"serve_s{pid}.npy"), sc.cpu().numpy())
    np.save(os.path.join(work, f"serve_i{pid}.npy"), ix.cpu().numpy())
    print(json.dumps({"pid": pid, "positions": list(mesh.positions),
                      "iters": iters, "fit_s": fit_s,
                      "fit_launches": fit_launches, "serve_s": serve_s,
                      "serve_k5": cuda_topk.LAUNCHES, "serve_offset": off,
                      "serve_rows": int(sc.shape[0]),
                      "route": multihost.ROUTE}))


def _reordered(data):
    """Phase 13's triples in the order its exchange leaves them: process
    0's interleaved half, then process 1's."""
    return [np.concatenate([x[p::MH_PROCS] for p in range(MH_PROCS)])
            for x in (data["u_idx"], data["i_idx"], data["r"])]


def mh_reference(data, U0, V0, dev):
    """The single-process 4-shard 'all_gather' fit of phase 13's
    triples (in the exchanged order) from the same init: 2 iterations,
    entity space."""
    u, i, r = _reordered(data)
    nu, ni = data["n_users"], data["n_items"]
    S = MH_PROCS * MH_SHARDS
    up = partition_balanced(np.bincount(u, minlength=nu), S)
    ip = partition_balanced(np.bincount(i, minlength=ni), S)
    cfg = core_als.AlsConfig(rank=RANK, max_iter=2, implicit_prefs=True,
                             alpha=ALPHA, reg_param=REG)
    Us, Vs = train_sharded(make_mesh(devices=[dev] * S), up, ip,
                           shard_csr(up, ip, u, i, r),
                           shard_csr(ip, up, i, u, r), cfg, init=(U0, V0))
    return entity_rows(up, Us), entity_rows(ip, Vs)


def start_mh_workers(work, mode="--mh-worker"):
    """Phase 13's (or, ``mode='--ipc-worker'``, 13c's) processes, gated:
    each imports and loads, then waits for ``go``.  Joined over gloo by
    a ``file://`` rendezvous in ``work`` (no port to collide with another
    group's)."""
    from tpu_als_torch.parallel import multihost

    init = multihost.file_init_method(work)
    procs = []
    for pid in range(MH_PROCS):
        env = {**proc_env(), "WORLD_SIZE": str(MH_PROCS), "RANK": str(pid),
               "LOCAL_RANK": str(pid), "PYTHONWARNINGS": "ignore"}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, work,
             "--init-method", init],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            stdin=subprocess.PIPE, text=True, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__))))
    return procs


def finish_mh_workers(procs, timeout=120, what="phase 13"):
    """Each process's JSON line; a failure or a hang in any of them kills
    every one and fails the run."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                fail(f"{what} process exited {p.returncode}: "
                     f"{err[-2000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    except subprocess.TimeoutExpired:
        fail(f"{what}: a process did not finish within {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def multiprocess_phase(data, seed, dev, smi):
    """Phase 13: two processes on the one H100, 2 logical shards each of
    a 4-position mesh, over gloo with CUDA tensors staged through host
    memory (budget 90 s; no timed phase runs beside its processes: they
    import and load gated, while this process builds the single-process
    reference, and run once it is done).  Each process keeps an
    interleaved half of the ML-25M triples (``dataMode='per_host'``):
    (a) 'all_gather', 2 iterations from phase 5's init, the gathered
    factors against the single-process 4-shard fit of the same triples
    (in the exchanged order) from the same init: bitwise expected (the
    shards' partial YᵀY summed in position order in both), TRAIN_REL per
    row required; per process
    the iteration wall, the bytes staged through host memory a
    half-step, the collective's share of the iteration and K4/K3/K1
    launches; (b) the sharded checkpoint both processes wrote, read by
    ``load_factors`` here, equal to (a)'s factors; (c) the processes'
    ``topk_sharded('all_gather')`` rows for 4,096 users through K5, ids
    equal to the single-process K5's and scores within SERVE_ULPS."""
    from tpu_als_torch.io.checkpoint import load_factors, save_factors

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_mh_")
    try:
        frame = data["frame"]
        for p in range(MH_PROCS):
            for k in ("user", "item", "rating"):
                np.save(os.path.join(work, f"{k}{p}.npy"),
                        np.asarray(frame[k])[p::MH_PROCS])
        g = torch.Generator().manual_seed(seed)     # phase 5's init
        U0 = core_als.init_factors(data["n_users"], RANK, g)
        V0 = core_als.init_factors(data["n_items"], RANK, g)
        params = ALS(rank=RANK, implicitPrefs=True, alpha=ALPHA,
                     regParam=REG, maxIter=2)._ckpt_params()
        save_factors(os.path.join(work, "init"), data["umap"].ids,
                     U0.numpy(), data["imap"].ids, V0.numpy(),
                     params=params, iteration=0)
        torch.cuda.empty_cache()
        procs = start_mh_workers(work)
        t0 = time.perf_counter()
        Ur, Vr = mh_reference(data, U0, V0, dev)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        for p in procs:
            probe_ready(p, "phase 13 process")
        t_run = time.perf_counter()
        for p in procs:
            release_probe(p)
        outs = finish_mh_workers(procs)
        run_s = time.perf_counter() - t_run
        for o in outs:
            it = o["iters"]
            walls = [x["wall_s"] * 1e3 for x in it]
            staged = [x["staged_bytes"] / 2 for x in it]
            share = [x["seconds"] / x["wall_s"] for x in it]
            fl = o["fit_launches"]
            log(f"phase 13 process {o['pid']} (positions {o['positions']}): "
                f"iteration walls {', '.join(f'{w:.1f}' for w in walls)} ms; "
                f"staged through host a half-step "
                f"{', '.join(f'{b:.0f}' for b in staged)} B; collective "
                f"share {', '.join(f'{x:.3f}' for x in share)}; collectives "
                f"{sum(x['collectives'] for x in it)}; fit {o['fit_s']:.2f} s;"
                f" launches K4 {fl['k4']}, K3 {fl['k3']}, K1 {fl['k1']}; "
                f"serve {o['serve_s'] * 1e3:.1f} ms, K5 {o['serve_k5']}, "
                f"rows {o['serve_offset']}..{o['serve_offset'] + o['serve_rows']}"
                f" on {smi}")
            if min(fl["k4"], fl["k3"], fl["k1"]) == 0 or o["serve_k5"] == 0:
                fail(f"phase 13 process {o['pid']}: a kernel of its path "
                     f"never launched: {fl}, K5 {o['serve_k5']}")
            if len(it) != 2 or min(staged) <= 0:
                fail(f"phase 13: iterations or staged bytes missing: {it}")
        log(f"phase 13 route: {outs[0]['route']}")
        # (a) the gathered factors against the single-process fit
        U = torch.from_numpy(np.load(os.path.join(work, "U.npy"))).to(dev)
        V = torch.from_numpy(np.load(os.path.join(work, "V.npy"))).to(dev)
        eu, ev = row_rel(U, Ur), row_rel(V, Vr)
        bitwise = bool(torch.equal(U, Ur) and torch.equal(V, Vr))
        log(f"phase 13 (a): two-process fit vs the single-process 4-shard "
            f"fit ({ref_s:.1f} s to build and run), 2 iterations: max "
            f"per-row |diff|/|x| users {eu:.3e}, items {ev:.3e}, bitwise "
            f"{bitwise} (tol {TRAIN_REL}; bitwise expected)")
        if not (eu <= TRAIN_REL and ev <= TRAIN_REL):
            fail(f"phase 13: the two-process fit is off the single-process "
                 f"fit: users {eu:.3e}, items {ev:.3e}")
        # (b) the sharded checkpoint, read here
        m, cu, cU, ci, cV = load_factors(os.path.join(work, "ckpt",
                                                      "als_checkpoint"))
        same = (m.get("sharded") and m.get("iteration") == 2
                and np.array_equal(cu, data["umap"].ids)
                and np.array_equal(cU, U.cpu().numpy())
                and np.array_equal(cV, V.cpu().numpy()))
        log(f"phase 13 (b): the sharded checkpoint ({m.get('n_shards')} "
            f"position files) loads equal to (a)'s factors: {bool(same)}")
        if not same:
            fail("phase 13: the sharded checkpoint differs from the fit")
        # (c) the processes' top-k rows against the single-process K5
        s = torch.from_numpy(np.concatenate(
            [np.load(os.path.join(work, f"serve_s{p}.npy"))
             for p in range(MH_PROCS)])).to(dev)
        ix = torch.from_numpy(np.concatenate(
            [np.load(os.path.join(work, f"serve_i{p}.npy"))
             for p in range(MH_PROCS)])).to(dev)
        Q = U[:MH_SERVE_USERS].contiguous()
        s1, i1 = cuda_topk.topk_scores(
            Q, V, torch.ones(V.shape[0], dtype=torch.bool, device=dev), 10)
        ids_eq = bool(torch.equal(ix, i1))
        ulps = ulps_off(s, s1)
        log(f"phase 13 (c): {s.shape[0]} users' top-10 across the "
            f"processes vs the single-process K5: ids equal {ids_eq}, "
            f"scores {ulps} ulp apart at most (tol {SERVE_ULPS})")
        if s.shape[0] != MH_SERVE_USERS or not ids_eq or ulps > SERVE_ULPS:
            fail("phase 13: the two-process top-k is not the single-process "
                 "K5's")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    log(f"phase 13 (two processes on one card, per-host data, 4 positions): "
        f"{secs:.1f} s ({run_s:.1f} s after release) on {smi}")
    if secs > PHASE13_BUDGET_S:
        fail(f"phase 13 took {secs:.1f} s, over its {PHASE13_BUDGET_S} s")


# -- phase 13b: the analysis layer -------------------------------------------

PHASE13B_BUDGET_S = 60.0


def analysis_phase(dev, smi):
    """Phase 13b (a) and (b), run beside phase 7(a)'s CPU cross-validation
    once phases 2-4 are done (nothing in them is timed against the card;
    budget PHASE13B_BUDGET_S): (a) ``python -m tpu_als_torch.cli lint``
    over the port's tree as a process, exit 0; (b) beside it, in this
    process, ``lint --contracts`` on the card: every contract's verdict,
    K1/K3/K4/K7/K8 launches counted around it (its ``floor_audit`` tunes
    a bank of its own).  (c)'s processes start and block beside them
    (:func:`start_comm_audit`) and run after them
    (:func:`comm_audit_phase`); (d) runs after phase 12
    (:func:`floor_audit_phase12`)."""
    from tpu_als_torch.cli import main as cli_main

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    pl = subprocess.Popen([sys.executable, "-m", "tpu_als_torch.cli",
                           "lint"], cwd=repo, env=proc_env(),
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True)
    lint_out = {}

    def lint_wait():
        lint_out["out"] = pl.communicate(timeout=300)
        lint_out["secs"] = time.perf_counter() - t_phase

    tl = threading.Thread(target=lint_wait)
    tl.start()
    try:
        _zero_launches()
        t0 = time.perf_counter()
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli_main(["lint", "--paths", os.path.join(
                    repo, "tpu_als_torch", "analysis"), "--contracts",
                    "--device", str(dev)])
        except SystemExit as e:
            rc = e.code
        torch.cuda.synchronize()
        secs_b = time.perf_counter() - t0
        counts = _launch_counts()
        for line in buf.getvalue().splitlines():
            log(f"(b) {line}")
        log(f"(b) lint --contracts on {dev}: {secs_b:.1f} s; launches "
            + ", ".join(f"{k.upper()} {v}" for k, v in sorted(counts.items())))
        verdicts = [x for x in buf.getvalue().splitlines()
                    if x.startswith("contract ")]
        if rc != 0 or len(verdicts) != len(contracts.names()) \
                or any(": OK" not in x for x in verdicts):
            fail(f"(b) lint --contracts failed (rc {rc}): {verdicts}")
        if min(counts[k] for k in ("k1", "k3", "k4", "k7", "k8")) == 0:
            fail(f"(b) a kernel of the contracts' path never launched: "
                 f"{counts}")
    finally:
        tl.join()
        if pl.poll() is None:
            pl.kill()
    out, err = lint_out.get("out", ("", "lint did not finish"))
    log(f"(a) python -m tpu_als_torch.cli lint: exit {pl.returncode}, "
        f"{out.strip().splitlines()[-1] if out.strip() else err[-300:]} "
        f"({lint_out.get('secs', float('nan')):.1f} s of wall to its "
        "exit, process start included, beside (b))")
    if pl.returncode != 0:
        fail(f"(a) lint found something: {err[-2000:]}")
    secs = time.perf_counter() - t_phase
    log(f"phase 13b (a)-(b) (the linter and the contracts, beside the CPU "
        f"cross-validation): {secs:.1f} s on {smi}")
    if secs > PHASE13B_BUDGET_S:
        fail(f"phase 13b (a)-(b) took {secs:.1f} s, over its "
             f"{PHASE13B_BUDGET_S} s")


def start_comm_audit(frame, dev):
    """Phase 13b (c)'s two processes, gated (:func:`comm_audit_phase`):
    started in a thread before (a) and (b), they import, join and block
    phase 9's 1M-row prefix (the first CSV_TWIN_ROWS rows of ``frame``,
    what phase 9 writes as ``prefix.csv``) beside them, then wait.
    Returns ``(gate, out, thread)``."""
    u_ids, u = np.unique(np.asarray(frame["user"])[:CSV_TWIN_ROWS],
                         return_inverse=True)
    i_ids, i = np.unique(np.asarray(frame["item"])[:CSV_TWIN_ROWS],
                         return_inverse=True)
    r = np.asarray(frame["rating"], np.float32)[:CSV_TWIN_ROWS]
    gate, out = threading.Event(), {"shape": (len(u_ids), len(i_ids),
                                              len(u))}

    def run():
        try:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_audit_") \
                    as td:
                out["rows"] = comm_audit.spawn(
                    td, u, i, r, len(u_ids), len(i_ids), RANK, nproc=2,
                    device=str(dev), implicit=(True,), min_width=8,
                    threads=1, env=proc_env(), timeout=300, gate=gate)
        except BaseException as e:  # noqa: BLE001 — re-raised by the caller
            out["error"] = e

    th = threading.Thread(target=run)
    th.start()
    return gate, out, th


def comm_audit_phase(started, smi):
    """Phase 13b (c), beside phase 7(a)'s CPU cross-validation after (a)
    and (b) (budget PHASE13B_BUDGET_S, from the release): the gated
    processes of :func:`start_comm_audit`, one logical shard each on the
    card, run every multi-process strategy for one iteration at rank
    128, implicit, under ``comm_audit.collective_bytes``, the audited
    bytes beside ``comm_bytes_per_iter`` and equal ('ring_overlap',
    across processes the ring's own step, is audited once with it)."""
    gate, out, th = started
    t_phase = time.perf_counter()
    gate.set()
    th.join()
    if "error" in out:
        fail(f"(c) the comm audit failed: {out['error']}")
    rows = out["rows"]
    bad = []
    for p, prows in enumerate(rows):
        for x in prows:
            ran = (f"the iteration {x['seconds']:.2f} s"
                   if x.get("same_step_as") is None else
                   f"the {x['same_step_as']} step's audit, not run again")
            log(f"(c) process {p}: {x['strategy']:18s} implicit: audited "
                f"{x['audited']} B, comm_bytes_per_iter {x['model']} B "
                f"({x['breakdown']}); {ran}")
            if x["audited"] != x["model"]:
                bad.append((p, x["strategy"]))
    if bad or len(rows) != 2 \
            or len(rows[0]) != len(comm_audit.PROCESS_STRATEGIES):
        fail(f"(c) audited bytes off comm_bytes_per_iter: {bad}")
    secs = time.perf_counter() - t_phase
    nu, ni, n = out["shape"]
    log(f"phase 13b (c) (the comm audit, {nu} x {ni} x {n}, phase 9's "
        f"prefix; beside the CPU cross-validation, the processes' start "
        f"and blocking beside (a)-(b)): {secs:.1f} s from the release on "
        f"{smi}")
    if secs > PHASE13B_BUDGET_S:
        fail(f"phase 13b (c) took {secs:.1f} s, over its "
             f"{PHASE13B_BUDGET_S} s")
    return rows[0]


# -- phase 13c: K7 and K8 across processes over CUDA IPC -------------------

PHASE13C_BUDGET_S = 60.0
IPC_ITERS = 2


def ipc_worker(work, init_method):
    """One process of phase 13c (``chip_smoke.py --ipc-worker WORK
    --init-method INIT``, ``WORLD_SIZE``/``RANK`` set by the run): load
    phase 9's 1M-row prefix and the injected init, load the kernels'
    libraries, say ``ready`` on stderr and wait for ``go``; then, on 2
    logical shards of ``cuda:0`` (positions 2·pid, 2·pid + 1 of 4), (a)
    ``train_multihost(..., solve_backend='gather_fused_ring',
    strategy='ring', replicated=True)`` for IPC_ITERS iterations (K7
    reading the peer's shards through its mapped buffer), each iteration
    timed around the step (device synced, the processes lined up by a
    barrier first) with its K7 launches and ``multihost.COMM``, the
    declared cross-shard payload read by ``comm_audit.remote_dma_bytes``;
    (b) ``topk_sharded(U[:4096], V, 10, mesh, 'merge_ring')`` on the
    fitted factors (K8's scan-to-sets and merge-from-sets, the sets in
    mapped buffers), its declared payload; (c) the peer buffers left
    open (``peer.OPEN``).  Process 0 saves the gathered factors; each
    process its top-k rows.  The last stdout line: this process's
    JSON."""
    from tpu_als_torch.parallel import multihost, peer, trainer

    pin_fp32()
    pid = int(os.environ["RANK"])
    d = np.load(os.path.join(work, "prefix.npz"))
    for name in ("gather_solve_ring", "topk_sets", "topk_merge_sets",
                 "peer_alloc", "peer_export", "peer_open", "peer_close",
                 "peer_free", "peer_handle_bytes"):
        _build.load(name)
    print("ready", file=sys.stderr, flush=True)
    if sys.stdin.readline().strip() != "go":
        sys.exit(1)
    multihost.init_distributed(init_method=init_method)
    mesh = make_mesh(devices=["cuda:0"] * MH_SHARDS)
    cfg = core_als.AlsConfig(rank=RANK, max_iter=IPC_ITERS,
                             implicit_prefs=True, alpha=ALPHA, reg_param=REG,
                             solve_backend="gather_fused_ring")
    iters = []
    make_step = trainer.make_process_step

    def timed_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(U, V):
            torch.cuda.synchronize()
            multihost.barrier()  # both processes start the step together
            c0, k0 = dict(multihost.COMM), cuda_gather_ne.RING_LAUNCHES
            t0 = time.perf_counter()
            U, V = step(U, V)
            torch.cuda.synchronize()
            iters.append({"wall_s": time.perf_counter() - t0,
                          "k7": cuda_gather_ne.RING_LAUNCHES - k0,
                          **{k: multihost.COMM[k] - c0[k] for k in c0}})
            return U, V

        run.close = step.close  # the mapped buffers, released at the end
        return run

    trainer.make_process_step = timed_step
    _zero_launches()
    fit = {}

    def fused_fit():
        fit["out"] = multihost.train_multihost(
            d["u"], d["i"], d["r"], int(d["nu"]), int(d["ni"]), cfg,
            mesh=mesh, replicated=True, strategy="ring",
            init=(d["U0"], d["V0"]))

    t0 = time.perf_counter()
    fit_declared, _ = comm_audit.remote_dma_bytes(fused_fit)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    Us, Vs, up, ip = fit["out"]
    U = multihost.gather_entity_factors(Us, up, mesh)
    V = multihost.gather_entity_factors(Vs, ip, mesh)
    if pid == 0:
        np.save(os.path.join(work, "U.npy"), U.cpu().numpy())
        np.save(os.path.join(work, "V.npy"), V.cpu().numpy())
    open_after_fit = dict(peer.OPEN)
    got = {}

    def merge_serve():
        got["out"] = serve.topk_sharded(U[:MH_SERVE_USERS].contiguous(), V,
                                        10, mesh, strategy="merge_ring")

    torch.cuda.synchronize()
    multihost.barrier()
    t0 = time.perf_counter()
    serve_declared, _ = comm_audit.remote_dma_bytes(
        merge_serve, fires=lambda g: g[0] * (g[1] - 1))
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    sc, ix, off = got["out"]
    np.save(os.path.join(work, f"serve_s{pid}.npy"), sc.cpu().numpy())
    np.save(os.path.join(work, f"serve_i{pid}.npy"), ix.cpu().numpy())
    launches = {"k7": cuda_gather_ne.RING_LAUNCHES,
                "sets": cuda_topk.SETS_LAUNCHES,
                "merge_sets": cuda_topk.MERGE_SETS_LAUNCHES}
    times = ipc_kernel_times(d, mesh, cfg, Us, up, ip,
                             U[:MH_SERVE_USERS].contiguous(), V)
    print(json.dumps({
        "pid": pid, "positions": list(mesh.positions), "iters": iters,
        "fit_s": fit_s, "k7": launches["k7"],
        "fit_declared": fit_declared, "open_after_fit": open_after_fit,
        "serve_s": serve_s, "sets": launches["sets"],
        "merge_sets": launches["merge_sets"],
        "k8_one_launch": cuda_topk.MERGE_LAUNCHES,
        "serve_declared": serve_declared, "serve_offset": off,
        "serve_rows": int(sc.shape[0]), "times": times,
        "open": dict(peer.OPEN)}))


def ipc_kernel_times(d, mesh, cfg, Us, up, ip, Q, V):
    """Phase 13c's kernel timings, in each worker, at 13c's shapes: K7's
    mapped entry over this process's owners of the item half-step's ring
    grid (rolled to its first position) from the fitted U, the peer's
    shards mapped; K8's scan-to-sets of ``Q`` against this process's
    catalog shards and its merge-from-sets of this process's rows over
    both processes' sets (mapped).  The processes take turns (a barrier
    between), so each times its own launches on an otherwise idle card;
    each beside its plain version on the same inputs (K7: the gathered
    shards, chunked as :func:`ring_timings` chunks it; K8: the gathered
    sets), with the work its bound counts."""
    from tpu_als_torch.parallel import comm, multihost, peer, trainer

    dev, r = Us.device, RANK
    P, pid = multihost.process_count(), multihost.process_index()
    S, L, first = mesh.global_size, mesh.size, mesh.positions[0]
    split = core_als.SPLIT_WIDTH
    ig = shard_csr_grid(ip, up, d["i"], d["u"], d["r"],
                        positions=mesh.positions)
    ib = comm.roll_sources(ig.to(dev), first)
    src = comm.ProcessSources(mesh, up.rows_per_shard, r, torch.float32)
    mapped = src.publish(Us)
    gathered = torch.roll(multihost.all_gather(Us.reshape(L, -1, r)),
                          -first, 0)
    YtY = trainer._yty(mesh, Us)
    pre = []
    for b in ib:
        conf, pref = implicit_weights(b.vals, b.mask, ALPHA)
        pre.append((b, conf, (1.0 + conf) * pref * b.mask, pref * b.mask))

    def k7():
        return [cuda_gather_ne.gather_solve_ring(
            mapped, b.cols, aw, bw, cw, YtY, two_sided=False, reg=REG,
            split_width=split) for b, aw, bw, cw in pre]

    def k7_plain():
        xs = []
        for b, aw, bw, cw in pre:
            step = max(1, (1 << 28) // (S * min(b.width, split) * r))
            xs.append(torch.cat([cuda_gather_ne.gather_solve_ring_plain(
                gathered, b.cols[:, :, sl], aw[:, :, sl], bw[:, :, sl],
                cw[:, :, sl], YtY, two_sided=False, reg=REG,
                split_width=split)
                for sl in (slice(s0, s0 + step)
                           for s0 in range(0, b.cols.shape[2], step))],
                dim=1))
        return xs

    # K8's halves: this process's catalog shards and a sets buffer the
    # peer maps, written once before the turns
    n, k = Q.shape[0], 10
    ni_loc = -(-V.shape[0] // S)
    Vp = torch.zeros(S * ni_loc, r, device=dev)
    Vp[:V.shape[0]] = V
    vp = torch.zeros(S * ni_loc, dtype=torch.bool, device=dev)
    vp[:V.shape[0]] = True
    blk = slice(first * ni_loc, (first + L) * ni_loc)
    Vl, vl = Vp[blk].reshape(L, ni_loc, r), vp[blk].reshape(L, ni_loc)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    parts = cuda_topk.topk_parts(n, ni_loc, S, sms)
    shape = (-(-n // cuda_topk.TILE_U), L * parts, cuda_topk.TILE_U, k)
    n_el = int(np.prod(shape))
    buf = peer.PeerBuffer(n_el * 12, dev)
    cs = buf.local(shape, torch.float32)
    ci = buf.local(shape, torch.int64, offset=n_el * 4)

    def sets():
        cuda_topk.topk_sets(Q, Vl, vl, k, parts=parts, first=first,
                            coll_s=cs, coll_i=ci, n_shards=S)

    sets()
    peer.publish()
    mapped_sets = cuda_topk.MappedSets(
        torch.tensor(buf.ptrs, dtype=torch.int64, device=dev),
        torch.tensor([q + n_el * 4 for q in buf.ptrs], dtype=torch.int64,
                     device=dev), L * parts)
    lo, hi = serve._process_rows(n, mesh)
    ps = torch.empty(shape, device=dev)
    pi = torch.empty(shape, dtype=torch.int64, device=dev)

    def sets_plain():
        cuda_topk.topk_sets_plain(Q, Vl, vl, k, parts, first, ps, pi)

    sets_plain()

    def every(t):
        g = multihost.all_gather(t).reshape(P, *t.shape)
        return g.permute(1, 0, 2, 3, 4).reshape(shape[0], P * L * parts,
                                                shape[2], k)

    every_s, every_i = every(ps), every(pi)
    out = {}
    for turn in range(P):
        torch.cuda.synchronize()
        multihost.barrier()
        if turn != pid:
            continue
        xp, p7 = timed(k7_plain)
        xk = k7()
        torch.cuda.synchronize()
        out["k7_err"] = max((x - y).abs().max().item()
                            for x, y in zip(xk, xp))
        out["k7_close"] = all(bool(torch.isfinite(x).all()) and bool(
            torch.allclose(x, y, rtol=K4_RTOL, atol=K4_ATOL))
            for x, y in zip(xk, xp))
        del xk, xp
        out["k7_ms"], out["k7_plain_ms"] = cuda_ms(k7, 3), p7
        out["k7_work"] = gram_work(ib, ip.rows_per_shard)
        _, p_sets = timed(sets_plain)
        (ms_, _), p_merge = timed(lambda: cuda_topk.topk_merge_sets_plain(
            every_s, every_i, k, lo, hi - lo))
        ks, ki = cuda_topk.topk_merge_sets(mapped_sets, k, lo, hi - lo)
        out["k8_err"] = (ks - ms_).abs().max().item()
        out["sets_ms"] = cuda_ms(sets, 3)
        out["merge_ms"] = cuda_ms(lambda: cuda_topk.topk_merge_sets(
            mapped_sets, k, lo, hi - lo), 3)
        out["k8_plain_ms"] = p_sets + p_merge
    torch.cuda.synchronize()
    multihost.barrier()
    buf.close()
    src.close()
    out.update(n=n, ni=S * ni_loc, k=k, parts=parts)
    return out


def start_ipc_phase(frame):
    """Phase 13c's processes, gated, started beside 13b's (a)-(b): the
    prefix of :func:`start_comm_audit` and an injected init written to
    a work directory, then the two processes import, load and wait.
    Returns ``(work, procs, (u, i, r, nu, ni, U0, V0))``."""
    u_ids, u = np.unique(np.asarray(frame["user"])[:CSV_TWIN_ROWS],
                         return_inverse=True)
    i_ids, i = np.unique(np.asarray(frame["item"])[:CSV_TWIN_ROWS],
                         return_inverse=True)
    r = np.asarray(frame["rating"], np.float32)[:CSV_TWIN_ROWS]
    g = torch.Generator().manual_seed(13)
    U0 = core_als.init_factors(len(u_ids), RANK, g).numpy()
    V0 = core_als.init_factors(len(i_ids), RANK, g).numpy()
    work = tempfile.mkdtemp(prefix="chip_smoke_ipc_")
    np.savez(os.path.join(work, "prefix.npz"), u=u, i=i, r=r,
             nu=len(u_ids), ni=len(i_ids), U0=U0, V0=V0)
    procs = start_mh_workers(work, mode="--ipc-worker")
    return work, procs, (u, i, r, len(u_ids), len(i_ids), U0, V0)


def ipc_phase(started, audit_rows, dev, smi):
    """Phase 13c, in the CPU cross-validation's wait after 13b (c)
    (budget PHASE13C_BUDGET_S from here): K7 and K8 across two processes
    on the one card, 2 logical shards each (4 positions), the peers'
    shards and candidate sets reached through CUDA IPC mappings
    (``parallel/peer.py``), so every K7 and K8 launch mixes local and
    mapped pointers.  First the single-process 4-shard K7 fit of the
    same triples in the same order from the same init, here on the card;
    then the gated processes (:func:`ipc_worker`) run: (a) the
    two-process fused-ring fit, its gathered factors bitwise the
    single-process fit's, each process's iteration walls and K7 launches
    beside 13b (c)'s 'ring' and 'all_gather' walls, its declared payload
    beside ``comm_bytes_per_iter('ring' | 'gather_fused_ring')``; (b)
    ``'merge_ring'`` for 4,096 users, k = 10, ids and scores bitwise the
    single-process K8's over the same 4 shards (and within K5_TOL of
    its plain version), both entries launched in both processes; (c)
    every mapping closed and every buffer freed, both processes exiting
    0."""
    work, procs, (u, i, r, nu, ni, U0, V0) = started
    t_phase = time.perf_counter()
    try:
        S = MH_PROCS * MH_SHARDS
        cfg = core_als.AlsConfig(rank=RANK, max_iter=IPC_ITERS,
                                 implicit_prefs=True, alpha=ALPHA,
                                 reg_param=REG,
                                 solve_backend="gather_fused_ring")
        up = partition_balanced(np.bincount(u, minlength=nu), S)
        ip = partition_balanced(np.bincount(i, minlength=ni), S)
        ug = shard_csr_grid(up, ip, u, i, r)
        ig = shard_csr_grid(ip, up, i, u, r)
        rc = (stacked_counts(up, u, r, positive_only=True),
              stacked_counts(ip, i, r, positive_only=True))
        t0 = time.perf_counter()
        k7_0 = cuda_gather_ne.RING_LAUNCHES
        Us, Vs = train_sharded(make_mesh(devices=[dev] * S), up, ip, ug, ig,
                               cfg, strategy="ring", ring_counts=rc,
                               init=(U0, V0))
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        if cuda_gather_ne.RING_LAUNCHES == k7_0:
            fail("phase 13c: the single-process K7 fit launched no K7")
        Ur, Vr = entity_rows(up, Us), entity_rows(ip, Vs)
        for p in procs:
            probe_ready(p, "phase 13c process")
        t_run = time.perf_counter()
        for p in procs:
            release_probe(p)
        outs = finish_mh_workers(procs, what="phase 13c")
        run_s = time.perf_counter() - t_run
        walls = {x["strategy"]: x["seconds"] for x in audit_rows
                 if x.get("seconds") is not None}
        ring_model = comm_bytes_per_iter("ring", up, ip, RANK,
                                         user_container=ug,
                                         item_container=ig, implicit=True)
        fused_model = comm_bytes_per_iter(
            "gather_fused_ring", up, ip, RANK, user_container=ug,
            item_container=ig, implicit=False)
        for o in outs:
            it = o["iters"]
            it_ms = ", ".join("%.1f" % (x["wall_s"] * 1e3) for x in it)
            it_k7 = ", ".join(str(x["k7"]) for x in it)
            it_staged = ", ".join(str(x["staged_bytes"]) for x in it)
            log(f"phase 13c process {o['pid']} (positions "
                f"{o['positions']}): fused-ring iteration walls {it_ms} ms, "
                f"K7 launches {it_k7} ({o['k7']} in the fit), staged "
                f"through host {it_staged} B (YᵀY only), fit "
                f"{o['fit_s']:.2f} s; beside 13b (c) on this "
                f"prefix (one shard a process): 'ring' "
                f"{walls.get('ring', float('nan')) * 1e3:.1f} ms, "
                f"'all_gather' {walls.get('all_gather', float('nan')) * 1e3:.1f}"
                f" ms an iteration; declared K7 payload {o['fit_declared']} "
                f"B for {IPC_ITERS} iterations (comm_bytes_per_iter "
                f"'gather_fused_ring' {fused_model} B, 'ring' {ring_model} B "
                f"an iteration) on {smi}")
            if len(it) != IPC_ITERS or min(x["k7"] for x in it) == 0:
                fail(f"phase 13c process {o['pid']}: K7 did not launch in "
                     f"every iteration: {it}")
            if o["fit_declared"] != IPC_ITERS * fused_model:
                fail(f"phase 13c: declared K7 payload {o['fit_declared']} "
                     f"!= {IPC_ITERS} x {fused_model}")
        # (a) the gathered factors against the single-process fit
        U = torch.from_numpy(np.load(os.path.join(work, "U.npy"))).to(dev)
        V = torch.from_numpy(np.load(os.path.join(work, "V.npy"))).to(dev)
        eu, ev = row_rel(U, Ur), row_rel(V, Vr)
        bitwise = bool(torch.equal(U, Ur) and torch.equal(V, Vr))
        log(f"phase 13c (a): two-process fused ring (K7 over mapped peer "
            f"shards) vs the single-process 4-shard K7 fit ({ref_s:.1f} s "
            f"here), {IPC_ITERS} iterations at rank {RANK}, {nu} x {ni} x "
            f"{len(u)}: bitwise {bitwise}, max per-row |diff|/|x| users "
            f"{eu:.3e}, items {ev:.3e}")
        if not bitwise:
            fail("phase 13c (a): the two-process fused-ring fit is not the "
                 "single-process K7 fit bit for bit")
        # (b) the processes' top-k rows against the single-process K8
        s = torch.from_numpy(np.concatenate(
            [np.load(os.path.join(work, f"serve_s{p}.npy"))
             for p in range(MH_PROCS)])).to(dev)
        ix = torch.from_numpy(np.concatenate(
            [np.load(os.path.join(work, f"serve_i{p}.npy"))
             for p in range(MH_PROCS)])).to(dev)
        Q = U[:MH_SERVE_USERS].contiguous()
        ni_loc = -(-V.shape[0] // S)
        Vp = torch.zeros(S * ni_loc, RANK, device=dev)
        Vp[:V.shape[0]] = V
        vp = torch.zeros(S * ni_loc, dtype=torch.bool, device=dev)
        vp[:V.shape[0]] = True
        Vs4, vs4 = Vp.reshape(S, ni_loc, RANK), vp.reshape(S, ni_loc)
        s1, i1 = cuda_topk.topk_merge_ring(Q, Vs4, vs4, 10)
        sp, _ = cuda_topk.topk_merge_ring_plain(Q, Vs4, vs4, 10)
        same = bool(torch.equal(s, s1) and torch.equal(ix, i1))
        e_plain = (s - sp).abs().max().item()
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for o in outs:
            log(f"phase 13c (b) process {o['pid']}: merge_ring serve "
                f"{o['serve_s'] * 1e3:.1f} ms, rows {o['serve_offset']}.."
                f"{o['serve_offset'] + o['serve_rows']}, scan-to-sets "
                f"launches {o['sets']}, merge-from-sets {o['merge_sets']}, "
                f"one-process K8 {o['k8_one_launch']}; declared payload "
                f"{o['serve_declared']} B (the candidate sets; the catalog "
                "never moves)")
            if min(o["sets"], o["merge_sets"]) == 0:
                fail(f"phase 13c process {o['pid']}: an entry of K8 across "
                     "processes never launched")
        log(f"phase 13c (b): {s.shape[0]} users' top-10 across the "
            f"processes vs the single-process K8 over the same {S} shards "
            f"(parts {cuda_topk.topk_parts(MH_SERVE_USERS, ni_loc, S, sms)}"
            f"): bitwise {same}; max |scores - plain| {e_plain:.3e} (tol "
            f"{K5_TOL})")
        if s.shape[0] != MH_SERVE_USERS or not same or e_plain > K5_TOL:
            fail("phase 13c (b): the two-process merge_ring is not the "
                 "single-process K8's")
        rows = ipc_kernel_rows(outs, smi)
        # (c) the teardown
        opened = [o["open"] for o in outs]
        log(f"phase 13c (c): peer buffers open at the end {opened} (after "
            f"the fit {[o['open_after_fit'] for o in outs]}); both "
            "processes exited 0")
        if any(x != {"mapped": 0, "exported": 0} for x in opened
               + [o["open_after_fit"] for o in outs]):
            fail("phase 13c (c): a peer buffer was left open")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(work, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    log(f"phase 13c (K7 and K8 across two processes on one card over CUDA "
        f"IPC): {secs:.1f} s ({run_s:.1f} s after release) on {smi}")
    if secs > PHASE13C_BUDGET_S:
        fail(f"phase 13c took {secs:.1f} s, over its {PHASE13C_BUDGET_S} s")
    return rows


def ipc_kernel_rows(outs, smi):
    """The ``kernels`` rows of K7's and K8's cross-process entries from
    the workers' timings (:func:`ipc_kernel_times`): the card runs both
    processes' launches, so each row's times are the two processes'
    summed, its bound that of the whole work (every owner of the item
    half-step; every query row against the whole catalog), and its
    launches those of 13c's fit (K7) and serve (K8's two entries)."""
    t = [o["times"] for o in outs]
    for o, x in zip(outs, t):
        log(f"phase 13c timing process {o['pid']}: K7 mapped "
            f"{x['k7_ms']:.4f} ms (plain {x['k7_plain_ms']:.4f} ms, max "
            f"|diff| {x['k7_err']:.3e}); K8 scan-to-sets {x['sets_ms']:.4f}"
            f" ms, merge-from-sets {x['merge_ms']:.4f} ms (plain "
            f"{x['k8_plain_ms']:.4f} ms, max |diff| {x['k8_err']:.3e}) on "
            f"{smi}")
        if not x["k7_close"]:
            fail(f"phase 13c: K7 over mapped shards vs its plain version "
                 f"max |diff| {x['k7_err']:.3e} (rtol {K4_RTOL}, atol "
                 f"{K4_ATOL})")
        if x["k8_err"] > K5_TOL:
            fail(f"phase 13c: K8's merge-from-sets vs its plain version max"
                 f" |diff| {x['k8_err']:.3e} (tol {K5_TOL})")
    P, E, n = (sum(x["k7_work"][j] for x in t) for j in range(3))
    b7, by7 = fused_solve_bound(P, E, n, RANK)
    (b8, by8), note8 = topk_bound(t[0]["n"], t[0]["ni"], RANK, t[0]["k"])
    ms7 = sum(x["k7_ms"] for x in t)
    ms8 = sum(x["sets_ms"] + x["merge_ms"] for x in t)
    log(f"timing K7 across processes (mapped peer shards) r={RANK} item "
        f"half-step, {n} real rows, {E} real of {P} padded entries: "
        f"kernel_ms={ms7:.4f} plain_ms="
        f"{sum(x['k7_plain_ms'] for x in t):.4f} bound_ms={b7:.4f} ({by7})")
    log(f"timing K8 across processes (scan-to-sets + merge-from-sets) "
        f"n={t[0]['n']} Ni={t[0]['ni']} parts {t[0]['parts']} k="
        f"{t[0]['k']}: kernel_ms={ms8:.4f} plain_ms="
        f"{sum(x['k8_plain_ms'] for x in t):.4f} bound_ms={b8:.4f} ({by8};"
        f" {note8})")
    return [
        {"name": "gather_solve_ring across processes (K7, mapped peer "
                 "shards)", "route": "cuda",
         "source": "tpu_als_torch/csrc/gather_solve_ring.cu",
         "replaces": "tpu_als/ops/pallas_gather_ne.py:708",
         "launches": sum(o["k7"] for o in outs),
         "max_abs_err": max(x["k7_err"] for x in t), "ms": ms7,
         "plain_ms": sum(x["k7_plain_ms"] for x in t), "bound_ms": b7,
         "bound_by": by7, "library_ms": None},
        {"name": "topk_merge_ring across processes (K8, scan-to-sets + "
                 "merge-from-sets)", "route": "cuda",
         "source": "tpu_als_torch/csrc/topk_merge_ring.cu",
         "replaces": "tpu_als/ops/pallas_topk.py:346",
         "launches": sum(o["sets"] + o["merge_sets"] for o in outs),
         "max_abs_err": max(x["k8_err"] for x in t), "ms": ms8,
         "plain_ms": sum(x["k8_plain_ms"] for x in t), "bound_ms": b8,
         "bound_by": by8, "library_ms": None}]


def floor_audit_phase12(bank, dev):
    """Phase 13b (d): ``floor_audit`` against the bank phase 12's ``plan
    tune`` process wrote with ``--bank-out``."""
    os.environ[contracts.FLOOR_AUDIT_BANK_ENV] = bank
    try:
        r = contracts.verify("floor_audit", device=dev)
    finally:
        os.environ.pop(contracts.FLOOR_AUDIT_BANK_ENV, None)
    log(f"(d) floor_audit on phase 12's bank: "
        f"{'OK' if r.ok else 'FAIL'} — {r.detail}")
    if not r.ok:
        fail(f"(d) floor_audit: {r.detail}")


# -- phase 14: the scenarios and the soak on the card -------------------------

PHASE14_BUDGET_S = 100.0
# the scenarios (b) runs in this process, each with the reference's
# defaults but the rank
PHASE14_SCENARIOS = ("traffic-spike", "torn-publish", "cold-start",
                     "tenant-isolation")
SCENARIO_COUNT = 12                 # the reference's twelve
SOAK_INJECTIONS = 6                 # the default schedule, children too
# (c): ``scenario list`` as a process, then what it loaded
_SCENARIO_LIST = (
    "import json, sys\n"
    "from tpu_als_torch import _build, cli\n"
    "cli.main(['scenario', 'list'])\n"
    "torch = sys.modules.get('torch')\n"
    "print(json.dumps({'libs': sorted(_build._LIBS), 'cuda_initialized':\n"
    "    bool(torch is not None and torch.cuda.is_initialized())}))\n")


def start_scenario_list():
    return subprocess.Popen(
        [sys.executable, "-c", _SCENARIO_LIST], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)), env=proc_env())


def check_scenario_list(p):
    """(c): exit 0, the twelve names, no kernel library loaded and CUDA
    never initialized."""
    out, err = p.communicate(timeout=120)
    if p.returncode != 0:
        fail(f"(c) scenario list exited {p.returncode}: {err[-2000:]}")
    lines = out.strip().splitlines()
    seen = json.loads(lines[-1])
    names = [ln.split()[0] for ln in lines[:-1] if ln and not ln[0].isspace()]
    log(f"(c) scenario list: {len(names)} scenarios ({', '.join(names)}); "
        f"kernel libraries loaded {seen['libs']}, CUDA initialized "
        f"{seen['cuda_initialized']}")
    if len(names) != SCENARIO_COUNT or len(set(names)) != SCENARIO_COUNT:
        fail(f"(c) scenario list printed {names}, not twelve names")
    if seen["libs"] or seen["cuda_initialized"]:
        fail("(c) scenario list built or loaded a kernel, or touched the "
             "card")


def rederive_verdict(script, obs_dir, checks):
    """Judge the soak's trail with the stdlib ``script`` as a process:
    exit 0 and the run's own checks."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.join(here, script),
                        obs_dir, "--json"], capture_output=True, text=True,
                       timeout=120, cwd=here)
    secs = time.perf_counter() - t0
    if p.returncode != 0:
        fail(f"(a) {script} exited {p.returncode}: {p.stderr[-2000:]}")
    again = json.loads(p.stdout)
    log(f"(a) {script} on the trail: passed {again['passed']}, the run's "
        f"checks {'re-derived' if again['checks'] == checks else 'NOT re-derived'} "
        f"({secs:.2f} s)")
    if again["checks"] != checks:
        fail(f"(a) {script} judged other checks than the soak: "
             f"{again['checks']} against {checks}")


def soak_on_card(p, obs_dir):
    """(a): the soak process's verdict, its six injections fired and
    recovered, its K2/K4/K5 launches, then both stdlib judges on its
    trail."""
    lines, launches = finish_probe(p, "(a) soak", timeout=600)
    res = json.loads(lines[-1])
    checks = res["checks"]
    log(f"(a) soak --rank {RANK}: passed {res['passed']}, "
        f"{res['windows']} windows, {res['answered']}/{res['offered']} "
        f"answered, worst victim-free p99 {res['worst_window_p99_ms']} ms, "
        f"freshness p99 {res['freshness_p99_ms']} ms, fairness "
        f"{res['fairness_ratio']}, shed {res['shed_rate']}, injections "
        f"{res['injections']} fired {res['recoveries']} recovered, wall "
        f"{res['wall_seconds']} s; launches K2 {launches['k2']}, K4 "
        f"{launches['k4']}, K5 {launches['k5']}")
    for rec in res["injection_records"]:
        log(f"    window {rec['window']} {rec['name']}: fired "
            f"{rec['fired']}, recovered {rec['recovered']}")
    for w in res["window_records"]:
        log(f"    window {w['window']}: {w['seconds']} s, "
            f"{w['answered']}/{w['offered']} answered, p99 ms "
            + ", ".join(f"{n} {t['p99_ms']}" for n, t in w["tenants"].items()))
    if not res["passed"]:
        fail(f"(a) the soak's verdict failed: "
             f"{[c for c in checks if not c['ok']]}")
    if res["injections"] != SOAK_INJECTIONS or \
            res["recoveries"] != SOAK_INJECTIONS or \
            not all(r["fired"] and r["recovered"]
                    for r in res["injection_records"]):
        fail(f"(a) not every one of the {SOAK_INJECTIONS} injections fired "
             f"and recovered: {res['injection_records']}")
    for k in ("k2", "k4", "k5"):
        if launches[k] <= 0:
            fail(f"(a) the soak launched no {k.upper()}")
    rederive_verdict(os.path.join("tpu_als_torch", "soak", "verdict.py"),
                     obs_dir, checks)
    rederive_verdict(os.path.join("tpu_als", "soak", "verdict.py"),
                     obs_dir, checks)


# the kernels each scenario's path runs: traffic-spike and torn-publish
# serve factors drawn at random (no fit, no fold-in)
SCENARIO_KERNELS = {"traffic-spike": ("k5",), "torn-publish": ("k5",),
                    "cold-start": ("k2", "k4", "k5"),
                    "tenant-isolation": ("k2", "k4", "k5")}


def scenarios_on_card(dev):
    """(b): each scenario in this process on the card at rank 128, every
    assertion held; its wall and K2/K4/K5 launches."""
    from tpu_als_torch import scenario

    for name in PHASE14_SCENARIOS:
        obs.reset()
        faults.clear()
        guardrails.clear_mode()
        serve.reset_last_good()
        _zero_launches()
        t0 = time.perf_counter()
        try:
            res = scenario.run_scenario(scenario.get_scenario(name),
                                        config={"rank": RANK}, device=dev)
        except scenario.PhaseFailed as e:
            fail(f"(b) {name}: {e}")
        secs = time.perf_counter() - t0
        n = _launch_counts()
        log(f"(b) {name} at rank {RANK}: "
            f"{'PASS' if res['passed'] else 'FAIL'} in {secs:.2f} s "
            f"(phases " + ", ".join(f"{p['phase']} {p['seconds']:.3f}"
                                   for p in res["phases"])
            + f"); launches K2 {n['k2']}, K4 {n['k4']}, K5 {n['k5']}")
        for a in res["assertions"]:
            log(f"    {'ok  ' if a['ok'] else 'FAIL'} {a['check']}: "
                f"{a['observed']} {a['op']} {a['expected']}")
        if not res["passed"]:
            fail(f"(b) {name}: {[a for a in res['assertions'] if not a['ok']]}")
        for k in SCENARIO_KERNELS[name]:
            if n[k] <= 0:
                fail(f"(b) {name} launched no {k.upper()}")
    obs.reset()
    faults.clear()


def scenario_soak_phase(dev, smi):
    """Phase 14: the production-week soak as a process (a), four
    scenarios in this process (b) and ``scenario list`` as a process
    (c), budget PHASE14_BUDGET_S.  The runs are judged against
    wall-clock SLOs, so nothing else works beside them: (c) and the
    soak's import overlap, the soak runs alone, then (b)."""
    t0 = time.perf_counter()
    obs_dir = tempfile.mkdtemp(prefix="soak_obs_", dir=PLAN_ROOT)
    pc = start_scenario_list()
    ps = start_probe(["soak", "--rank", str(RANK), "--device", str(dev),
                      "--obs-dir", obs_dir, "--json"], gated=True)
    check_scenario_list(pc)
    probe_ready(ps, "(a) soak")
    release_probe(ps)
    soak_on_card(ps, obs_dir)
    t_soak = time.perf_counter() - t0
    scenarios_on_card(dev)
    secs = time.perf_counter() - t0
    log(f"phase 14 (the scenarios and the soak on the card): {secs:.1f} s "
        f"((a) with (c) {t_soak:.1f} s) on {smi}")
    if secs > PHASE14_BUDGET_S:
        fail(f"phase 14 took {secs:.1f} s, over its {PHASE14_BUDGET_S} s")


def timings(model, launches, A, b, errs, dev):
    out = []
    N, r = b.shape
    k_ms = cuda_ms(lambda: cuda_lanes.spd_solve_lanes(A, b), 20)
    p_ms = cuda_ms(lambda: cuda_lanes.chol_solve_plain(A, b), 2)
    l_ms = cuda_ms(lambda: torch.cholesky_solve(
        b[..., None], torch.linalg.cholesky(A)), 20)
    # the kernel reads only A's lower triangle, then b, and writes x
    b_ms, by = solve_bound(N, r)
    out.append({"name": "spd_solve_lanes (K2)", "route": "cuda",
                "source": "tpu_als_torch/csrc/chol_solve.cu",
                "replaces": "tpu_als/ops/pallas_lanes.py:199",
                "launches": launches["k2"], "max_abs_err": errs["k2"],
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": by, "library_ms": l_ms})

    log(f"timing K2 N={N} r={r}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
        f"library_ms={l_ms:.4f} bound_ms={b_ms:.4f} ({by}) "
        f"launches={launches['k2']}")
    log(f"timing K1 on the same systems: kernel_ms="
        f"{cuda_ms(lambda: cuda_solve.spd_solve_blocked(A, b), 20):.4f}")
    out.append(k5_timing(model, launches["k5"], errs["k5"], dev))
    return out


def k5_timing(model, launches, err, dev):
    """K5 for every user of ``model`` against its catalog, k = 10, beside
    its plain version, a blocked ``matmul`` + ``topk`` and its bound."""
    U, V = model._U, model._V
    (n, r), Ni, k = U.shape, V.shape[0], 10
    valid = torch.ones(Ni, dtype=torch.bool, device=dev)

    def library():
        for s in range(0, n, 16384):
            torch.topk(U[s:s + 16384] @ V.T, k, dim=1)

    k_ms = cuda_ms(lambda: cuda_topk.topk_scores(U, V, valid, k), 3)
    p_ms = cuda_ms(lambda: chunked_topk_scores(U, V, valid, k), 1)
    l_ms = cuda_ms(library, 1)
    (b_ms, by), note = topk_bound(n, Ni, r, k)
    tag = "" if r == RANK else f", rank {r}"
    log(f"timing K5{tag} n={n} Ni={Ni} r={r} k={k}: kernel_ms={k_ms:.4f} "
        f"plain_ms={p_ms:.4f} library_ms={l_ms:.4f} bound_ms={b_ms:.4f} "
        f"({by}; {note}) launches={launches}")
    return {"name": f"topk_scores_pallas (K5{tag})", "route": "cuda",
            "source": "tpu_als_torch/csrc/topk.cu",
            "replaces": "tpu_als/ops/pallas_topk.py:119",
            "launches": launches, "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": l_ms}


def sweep_timings(model, users):
    """recommend-all three ways on the card, each the host clock around
    the call with its results on the host (the second of two calls):
    ``recommend_arrays(10)`` (one K5 call over every user),
    ``recommendForAllUsers(10)`` (``blockSize`` users a K5 call) and
    ``recommendForUserSubset`` of the fold-in batch's ``users``; with
    K5's launches per call."""
    calls = (("recommend_arrays(10)", lambda: model.recommend_arrays(10)),
             (f"recommendForAllUsers(10), blockSize "
              f"{model._get('blockSize')}",
              lambda: model.recommendForAllUsers(10)),
             (f"recommendForUserSubset({len(users)} fold-in users, 10)",
              lambda: model.recommendForUserSubset({"user": users}, 10)))
    base = None
    for what, fn in calls:
        for _ in range(2):
            before = cuda_topk.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        base = base or ms
        log(f"sweep rank {model.rank} {what}: {ms:.3f} ms wall "
            f"({ms / base:.3f}x recommend_arrays), K5 launches "
            f"{cuda_topk.LAUNCHES - before}")


def train_timings(tr, errs, dev):
    """K3, K4 and the wide rows' solve kernel (K1 at rank 128, K6 at
    rank 256) at the training slice's shapes: every bucket of the item
    half-step (from the seeded init) that each kernel takes.  One pass of
    K4 and of K3 over those buckets is also held against its plain
    version (K4_RTOL/K4_ATOL, K3_REL), and the larger of that error and
    phase 4's is the kernel's ``max_abs_err``."""
    out = []
    ib, U0, cfg = tr["ib"], tr["U0"], tr["cfg"]
    r = U0.shape[1]
    tag = "" if r == RANK else f", rank {r}"
    sfx = "" if r == RANK else f"_{r}"
    n_items = tr["n_items"]
    YtY = compute_yty(U0)
    split = core_als.SPLIT_WIDTH

    def route(b):
        return core_als.resolve_solve_path(cfg, r, b.width)

    k4_b = [b for b in ib if route(b) == "gatherfused_solve"]
    k3_b = [b for b in ib if route(b).startswith("gatherfused+")]

    # K4: one launch per K4 bucket; yardstick: the 'unfused' half-step
    # over the same buckets (V[cols], torch normal equations, K2)
    def k4():
        return [cuda_gather_ne.gather_fused_solve_implicit(
            U0, b.cols, b.vals, b.mask, REG, ALPHA, YtY) for b in k4_b]

    def k4_plain():
        xs = []
        for b in k4_b:
            conf, pref = implicit_weights(b.vals, b.mask, ALPHA)
            bw, cw = (1.0 + conf) * pref * b.mask, pref * b.mask
            step = max(1, min(4096, (1 << 28) // (b.width * r)))
            for s in range(0, b.cols.shape[0], step):
                sl = slice(s, s + step)
                xs.append(cuda_gather_ne.gather_solve_plain(
                    U0, b.cols[sl], conf[sl], bw[sl], cw[sl], YtY,
                    two_sided=False, reg=REG))
        return xs

    unfused = dataclasses.replace(cfg, solve_backend="unfused")

    def k4_lib():
        core_als.local_half_step(U0, k4_b, n_items, unfused, YtY)

    xp, p4 = timed(lambda: torch.cat(k4_plain()))
    xk = torch.cat(k4())
    torch.cuda.synchronize()
    e4 = (xk - xp).abs().max().item()
    if not (torch.isfinite(xk).all() and torch.allclose(
            xk, xp, rtol=K4_RTOL, atol=K4_ATOL)):
        fail(f"K4 on the item half-step's buckets: kernel vs plain max "
             f"|diff| {e4:.3e}")
    log(f"k4 r={r} item half-step ({len(k4_b)} buckets, widths up to "
        f"{k4_b[-1].width}): max |kernel - plain| {e4:.3e} (rtol "
        f"{K4_RTOL}, atol {K4_ATOL})")
    del xk, xp

    P, E, n = gram_work(k4_b, n_items)
    ms4 = cuda_ms(k4, 3)
    nb4, fl4 = fused_solve_bytes(P, E, n, r), gram_flops(E, n, r)
    b4, by4 = fused_solve_bound(P, E, n, r)
    l4 = cuda_ms(k4_lib, 1)
    out.append({"name": f"gather_solve (K4{tag})", "route": "cuda",
                "source": "tpu_als_torch/csrc/gather_solve.cu",
                "replaces": "tpu_als/ops/pallas_gather_ne.py:396",
                "launches": tr["launches"]["k4"],
                "max_abs_err": max(errs["k4" + sfx], e4),
                "ms": ms4, "plain_ms": p4, "bound_ms": b4, "bound_by": by4,
                "library_ms": l4})
    log(f"timing K4 r={r} item half-step, {len(k4_b)} buckets, {n} real "
        f"rows, {E} real of {P} padded entries: kernel_ms={ms4:.4f} "
        f"plain_ms={p4:.4f} library_ms={l4:.4f} (unfused half-step) "
        f"bound_ms={b4:.4f} ({by4}: {bound_note(nb4, *fl4)}) "
        f"launches/fit={tr['launches']['k4']}")

    # K3: the wide buckets, width split over blocks; yardstick V[cols] +
    # bmm
    pre = []
    for b in k3_b:
        conf, pref = implicit_weights(b.vals, b.mask, ALPHA)
        pre.append((b.cols, conf, (1.0 + conf) * pref * b.mask))

    def k3():
        return [cuda_gather_ne.gather_gram(U0, c, aw, bw, two_sided=False,
                                           split_width=split)
                for c, aw, bw in pre]

    def k3_plain(V=U0):
        return [cuda_gather_ne.gather_gram_plain(
            V, c, aw, bw, two_sided=False, split_width=split)
            for c, aw, bw in pre]

    def k3_lib():
        for c, aw, bw in pre:
            Vg = U0[c.long()]
            torch.bmm((Vg * aw[..., None]).transpose(1, 2), Vg)
            torch.bmm(bw[:, None, :], Vg)

    # the weights are >= 0, so |V| alone gives each entry's Σ|terms|
    e3 = {"S": 0.0, "b": 0.0}
    worst3 = 0.0
    plain3, p3 = timed(k3_plain)
    for (S, b), (Sp, bp), (Sa, ba) in zip(k3(), plain3, k3_plain(
            U0.abs())):
        e3["S"] = max(e3["S"], rel_err(S, Sp, Sa))
        e3["b"] = max(e3["b"], rel_err(b, bp, ba))
        worst3 = max(worst3, (S - Sp).abs().max().item())
    del plain3
    if not max(e3.values()) <= K3_REL:
        fail(f"K3 on the item half-step's wide buckets: relative |diff| "
             f"S {e3['S']:.3e}, b {e3['b']:.3e}")
    log(f"k3 r={r} item half-step ({len(k3_b)} wide buckets, widths up to "
        f"{k3_b[-1].width}): max |kernel - plain| / Σ|terms| S "
        f"{e3['S']:.3e}, b {e3['b']:.3e} (tol {K3_REL}); max |kernel - "
        f"plain| {worst3:.3e}")

    P3, E3, n3 = gram_work(k3_b, n_items)
    ms3 = cuda_ms(k3, 3)
    l3 = cuda_ms(k3_lib, 1)
    # the Gram on the tensor cores (3xTF32), b at the FMA rate
    by_3 = gram_bytes(P3, E3, n3, r)
    fl_3 = (E3 * 2 * r, E3 * r * (r + 1))
    b3, by3 = gram_bound(P3, E3, n3, r)
    out.append({"name": f"gather_gram (K3{tag})", "route": "cuda",
                "source": "tpu_als_torch/csrc/gather_gram.cu",
                "replaces": "tpu_als/ops/pallas_gather_ne.py:167",
                "launches": tr["launches"]["k3"],
                "max_abs_err": max(errs["k3" + sfx], worst3),
                "ms": ms3, "plain_ms": p3, "bound_ms": b3, "bound_by": by3,
                "library_ms": l3})
    log(f"timing K3 r={r} item half-step, {len(k3_b)} wide buckets, {n3} real "
        f"rows, {E3} real of {P3} padded entries: kernel_ms={ms3:.4f} "
        f"plain_ms={p3:.4f} library_ms={l3:.4f} (V[cols] + bmm) "
        f"bound_ms={b3:.4f} ({by3}: {bound_note(by_3, *fl_3)}) "
        f"launches/fit={tr['launches']['k3']}")

    # the solve launches of those wide buckets, as local_half_step issues
    # them at this shape (a bucket a launch, its padding rows included):
    # K1 at rank 128, K6's fused entry at rank 256
    launches = []
    for b in k3_b:
        A, rhs, count = cuda_gather_ne.gather_normal_eq_implicit(
            U0, b.cols, b.vals, b.mask, REG, ALPHA, YtY, split_width=split)
        launches.append((regularize(A, count), rhs.contiguous(),
                         int((b.rows < n_items).sum())))
        del A, count
    if r > RANK:
        out.append(k6_timings(launches, tr["launches"]["k6"], errs["k6"],
                              "fit"))
        return out
    out.append(k1_timings(launches, tr["launches"]["k1"], errs["k1"]))
    return out


def per_launch(launches, fn, reps):
    """Each launch's ms (``fn(A, b)`` over ``reps`` calls, CUDA events)."""
    return [cuda_ms(lambda A=A, b=b: fn(A, b), reps)
            for A, b, _ in launches]


def k1_timings(launches, fit_launches, err):
    """K1 on the item half-step's wide buckets, launch by launch (a few
    dozen systems each: the latency of one system), beside its plain
    version, ``linalg.cholesky`` + ``cholesky_solve`` and K2 on the same
    systems, summed per half-step.  Returns K1's row: the kernel's time
    per half-step on the card (``kernel_ms_each``, primed)."""
    r = launches[0][1].shape[1]
    ms, ev = ([kernel_ms_each(lambda: None, lambda A=A, b=b:
                              cuda_solve.spd_solve_blocked(A, b), 20,
                              primed=p) for A, b, _ in launches]
              for p in (True, False))
    k2 = per_launch(launches, cuda_lanes.spd_solve_lanes, 20)
    lib = per_launch(launches, lambda A, b: torch.cholesky_solve(
        b[..., None], torch.linalg.cholesky(A)), 20)
    plain = per_launch(launches, cuda_lanes.chol_solve_plain, 1)
    rows = sum(n for _, _, n in launches)
    b_ms, by = solve_bound(rows, r)
    sizes = [b.shape[0] for _, b, _ in launches]
    log(f"timing K1 r={r} item half-step, {len(launches)} launches "
        f"(systems {sizes}, {rows} real): kernel_ms={sum(ms):.4f} per "
        f"half-step on the card ({sum(ms) / len(ms):.4f} a launch; by "
        "launch " + ", ".join(f"{t:.4f}" for t in ms) + f"); with the "
        f"host's enqueue {sum(ev):.4f} (CUDA events; "
        + ", ".join(f"{t:.4f}" for t in ev) + f") plain_ms={sum(plain):.4f} "
        f"library_ms={sum(lib):.4f} K2_ms={sum(k2):.4f} "
        f"bound_ms={b_ms:.4f} ({by}) launches/fit={fit_launches}")
    return {"name": "spd_solve_pallas (K1)", "route": "cuda",
            "source": "tpu_als_torch/csrc/chol_blocked.cu",
            "replaces": "tpu_als/ops/pallas_solve.py:199",
            "launches": fit_launches, "max_abs_err": err,
            "ms": sum(ms), "plain_ms": sum(plain), "bound_ms": b_ms,
            "bound_by": by, "library_ms": sum(lib)}


def iteration_logger_cost(tr, rng, smi, reps=3):
    """What ``train --log-file`` (or any ``train`` with a live run
    directory) adds to an iteration at the ML-25M shape: the
    ``IterationLogger`` record ``_iteration_cb`` takes between two
    iterations (U and V to the host, their norms, a probe of the CLI's
    100,000-row cap), beside the fit's own iteration wall."""
    from tpu_als_torch.utils.observe import IterationLogger

    U, V = tr["model"]._U, tr["model"]._V
    n = 100_000
    probe = (rng.integers(0, U.shape[0], n), rng.integers(0, V.shape[0], n),
             rng.uniform(0.5, 5.0, n).astype(np.float32))
    logger = IterationLogger(probe=probe, stream=None)
    walls = []
    for it in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logger(it + 1, U, V)
        walls.append((time.perf_counter() - t0) * 1e3)
    it_ms = float(np.median(tr["iter_s"])) * 1e3
    mb = (U.numel() + V.numel()) * 4 / 1e6
    log(f"rank {U.shape[1]}: the iteration logger's record (U and V, "
        f"{mb:.1f} MB, to the host, norms, probe of {n} rows): "
        f"{', '.join(f'{w:.1f}' for w in walls)} ms, median "
        f"{np.median(walls):.1f} ms beside an iteration wall of "
        f"{it_ms:.1f} ms (logger off) on {smi}")


def k4_split(tr, smi):
    """Where K4's time goes, on the rows it times (the item half-step's
    K4 buckets from the seeded init), bucket by bucket: (a) K3's Gram on
    those rows (one block a row, no width split), (b) K1 on their
    regularized systems (above rank 288 ``stream_solve``, the anchor of
    K4's cluster solve pass), (c) up to rank 256 K6's fused
    factorization and solve on the same systems, (d) K4 itself; at rank
    <= 128 also (e) K2 on them.  Each bucket's systems are built, timed
    and freed in chunks of at most SPLIT_CHUNK_BYTES (4 GiB: 4,096 rows
    at rank 512, with K1's copy 8.6 GB on the card), K4 on the whole
    bucket as the fit calls it.  K4's solve pass is K4 less K3's Gram.
    Returns the sums in ms by name."""
    ib, U0, cfg = tr["ib"], tr["U0"], tr["cfg"]
    r = U0.shape[1]
    YtY = compute_yty(U0)
    t = {"gram (K3)": 0.0, "K1": 0.0, "K4": 0.0}
    if r <= RANK256:
        t["K6 fused"] = 0.0
    if r <= cuda_lanes.MAX_RANK:
        t["K2"] = 0.0
    step = max(1, SPLIT_CHUNK_BYTES // (4 * r * r))
    rows = 0
    t0 = time.perf_counter()
    for b in ib:
        if core_als.resolve_solve_path(cfg, r, b.width) != \
                "gatherfused_solve":
            continue
        rows += int((b.rows < tr["n_items"]).sum())
        for c0 in range(0, b.cols.shape[0], step):
            cols, vals, mask = (a[c0:c0 + step] for a in (b.cols, b.vals,
                                                          b.mask))
            conf, pref = implicit_weights(vals, mask, ALPHA)
            bw = (1.0 + conf) * pref * mask
            t["gram (K3)"] += cuda_ms(lambda: cuda_gather_ne.gather_gram(
                U0, cols, conf, bw, two_sided=False), 1)
            A, rhs, count = cuda_gather_ne.gather_normal_eq_implicit(
                U0, cols, vals, mask, REG, ALPHA, YtY)
            A = regularize(A, count)
            del count
            t["K1"] += cuda_ms(lambda: cuda_solve.spd_solve_blocked(A, rhs),
                               1)
            if "K2" in t:
                t["K2"] += cuda_ms(lambda: cuda_lanes.spd_solve_lanes(A, rhs),
                                   1)
            if "K6 fused" in t:
                Aw = torch.empty_like(A)
                t["K6 fused"] += kernel_ms_each(
                    lambda: Aw.copy_(A),
                    lambda: cuda_lanes_blocked.spd_solve_lanes_blocked(
                        Aw, rhs), 1)
                del Aw
            del A, rhs
        t["K4"] += cuda_ms(lambda: cuda_gather_ne.gather_fused_solve_implicit(
            U0, b.cols, b.vals, b.mask, REG, ALPHA, YtY), 1)
    t["K4 solve pass"] = t["K4"] - t["gram (K3)"]
    b_ms, by = solve_bound(rows, r)
    log(f"k4 split r={r} (the item half-step's K4 buckets, {rows} real "
        f"rows; {smi}): " + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
        + f" (K4 less K3's Gram; its bound {b_ms:.4f} ms, {by})"
        + (f"; K3's Gram + K6 fused {t['gram (K3)'] + t['K6 fused']:.4f} ms"
           if "K6 fused" in t else "")
        + f"; {time.perf_counter() - t0:.1f} s")
    return t


# cycles the card spins before a primed timed call: ~50 µs at the
# H100's 1.98 GHz, longer than the host takes to enqueue the call
PRIME_CYCLES = 100_000


def kernel_ms_each(setup, fn, reps, primed=True):
    """Mean milliseconds of ``fn`` alone over ``reps`` calls, each after
    an untimed ``setup()`` (K6 writes over its input, which is restored
    before every call), after one warm-up.  ``primed``: the card spins
    (``torch.cuda._sleep``) while the host enqueues the call, so its CUDA
    events time the card's work alone; else they also hold the host's
    enqueue, as a caller waits for it (a launch of a few systems takes
    about as long as the enqueue)."""
    setup()
    fn()
    total = 0.0
    for _ in range(reps):
        setup()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        if primed:
            torch.cuda._sleep(PRIME_CYCLES)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        total += t0.elapsed_time(t1)
    return total / reps


def triangular(L, b):
    """The first port's substitutions after K6: two batched
    ``torch.linalg.solve_triangular`` (a yardstick; the port runs K6's
    fused entry)."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(1, 2), y,
                                         upper=True)[..., 0]


def k6_timings(launches, fit_launches, err, what):
    """K6 on the regularized systems ``launches`` [(A, b, real rows)]
    ('fit': the rank-256 item half-step's wide buckets, a launch each;
    'fold-in': one batch of 4,096 users): the fused entry (what the
    routes run), launch by launch, beside the first port's route (the
    factor entry, then two ``solve_triangular``), ``linalg.cholesky`` +
    ``cholesky_solve``, K1 and the plain version, summed over the
    launches, and its bound (the lower triangle and b read once, L's
    square and x written once).  The fused entry and the first port's
    route are timed on a primed card (``kernel_ms_each``), the fused
    entry also as a caller waits for it.  The fused entry is held
    against its plain version: L within K6_REL of max |L|, x within
    FOLDIN_REL a row.  Returns K6's row."""
    r = launches[0][1].shape[1]
    e6 = ex = 0.0
    t = {"fused": [], "fused, events": [], "factor + solve_triangular": [],
         "library": [], "K1": [], "plain": []}
    for A, b, _ in launches:
        L = A.clone()
        x = cuda_lanes_blocked.spd_solve_lanes_blocked(L, b)
        Lp = A.clone()
        xp, p = timed(
            lambda: cuda_lanes_blocked.chol_lanes_blocked_solve_plain(Lp, b))
        e = (L - Lp).abs().max().item()
        rel, rx = e / Lp.abs().max().item(), row_rel(x, xp)
        if not (torch.isfinite(L).all() and torch.isfinite(x).all()
                and rel <= K6_REL and rx <= FOLDIN_REL):
            fail(f"K6 on the {what} systems (N={b.shape[0]}): max |L - "
                 f"L_plain| {e:.3e}, {rel:.3e} of max |L|; x {rx:.3e} of "
                 "|x| a row")
        e6, ex = max(e6, e), max(ex, rx)
        del L, Lp, x, xp
        Aw = torch.empty_like(A)
        t["plain"].append(p)
        for key, primed in (("fused", True), ("fused, events", False)):
            t[key].append(kernel_ms_each(
                lambda: Aw.copy_(A),
                lambda: cuda_lanes_blocked.spd_solve_lanes_blocked(Aw, b), 10,
                primed=primed))
        t["factor + solve_triangular"].append(kernel_ms_each(
            lambda: Aw.copy_(A),
            lambda: triangular(cuda_lanes_blocked.chol_lanes_blocked(Aw), b),
            10))
        t["library"].append(cuda_ms(lambda: torch.cholesky_solve(
            b[..., None], torch.linalg.cholesky(A)), 10))
        t["K1"].append(cuda_ms(
            lambda: cuda_solve.spd_solve_blocked(A, b), 10))
        del Aw
    rows = sum(n for _, _, n in launches)
    b6, by6 = solve_bound(rows, r, store_l=True)
    ms = {k: sum(v) for k, v in t.items()}
    per = "" if len(launches) == 1 else (
        f" ({ms['fused'] / len(launches):.4f} a launch; by launch "
        + ", ".join(f"{v:.4f}" for v in t["fused"]) + ")")
    log(f"timing K6 r={r} ({what}: {len(launches)} launch(es), systems "
        f"{[b.shape[0] for _, b, _ in launches]}, {rows} real): fused "
        f"kernel_ms={ms['fused']:.4f} on the card{per}; with the host's "
        f"enqueue {ms['fused, events']:.4f} (CUDA events) "
        f"plain_ms={ms['plain']:.4f} "
        f"library_ms={ms['library']:.4f} (linalg.cholesky + "
        f"cholesky_solve) factor + two solve_triangular "
        f"{ms['factor + solve_triangular']:.4f} K1 {ms['K1']:.4f} "
        f"bound_ms={b6:.4f} ({by6}) launches={fit_launches}; max |L - "
        f"L_plain| {e6:.3e}, x {ex:.3e} of |x| a row")
    return {"name": f"chol_lanes_blocked (K6, rank {r}, {what})",
            "route": "cuda",
            "source": "tpu_als_torch/csrc/chol_lanes_blocked.cu",
            "replaces": "tpu_als/ops/pallas_lanes_blocked.py:181",
            "launches": fit_launches, "max_abs_err": max(err, e6),
            "ms": ms["fused"], "plain_ms": ms["plain"], "bound_ms": b6,
            "bound_by": by6, "library_ms": ms["library"]}


def ring_timings(sh, tr, errs, dev):
    """K7 at the sharded slice's shapes: every bucket of the item
    half-step's ring grid (the ring routes every width through K7, the
    rows longer than the split width over blocks) from the seeded init,
    with each bucket's time and the widest bucket's share; its plain
    version on the same pass, chunked the same way, every bucket held to
    K4's band; the unfused ring half-step as the yardstick; the bound in
    K4's closed form on the real entries and rows, the Gram on the
    tensor cores.  First, at one shard on the single-device
    item half-step: K7 against K4 bit for bit on its K4 buckets, and
    against the wide route (K3 + tail + K1) within K4's band on its K3
    buckets.  The rank is the single-device slice's ``tr``; ``sh``'s
    init is the same one in slot space."""
    U1 = tr["U0"]
    r = U1.shape[1]
    tag = "" if r == RANK else f", rank {r}"
    sfx = "" if r == RANK else f"_{r}"
    Y1 = compute_yty(U1)
    split = core_als.SPLIT_WIDTH

    def one_shard(b):
        return cuda_gather_ne.gather_fused_ring_implicit(
            U1[None], b.cols[None, None], b.vals[None, None],
            b.mask[None, None], REG, ALPHA, Y1, split_width=split)[0]

    k4_b, k3_b = [], []
    for b in tr["ib"]:
        route = core_als.resolve_solve_path(tr["cfg"], r, b.width)
        (k4_b if route == "gatherfused_solve" else k3_b).append(b)
    for b in k4_b:
        x4 = cuda_gather_ne.gather_fused_solve_implicit(
            U1, b.cols, b.vals, b.mask, REG, ALPHA, Y1)
        if not torch.equal(one_shard(b), x4):
            fail(f"K7 at one shard is not K4 bit for bit on the item "
                 f"half-step's bucket of width {b.width}")
    e_wide = 0.0
    for b in k3_b:
        A, rhs, count = cuda_gather_ne.gather_normal_eq_implicit(
            U1, b.cols, b.vals, b.mask, REG, ALPHA, Y1, split_width=split)
        xw = solve_spd(A, rhs, count, backend="pallas")
        x7 = one_shard(b)
        torch.cuda.synchronize()
        e_wide = max(e_wide, (x7 - xw).abs().max().item())
        if not (torch.isfinite(x7).all() and torch.allclose(
                x7, xw, rtol=K4_RTOL, atol=K4_ATOL)):
            fail(f"K7 at one shard vs the wide route (K3 + tail + K1) on "
                 f"the bucket of width {b.width}: max |diff| "
                 f"{(x7 - xw).abs().max():.3e}")
    log(f"k7 r={r} at one shard == K4 bitwise on the item half-step's "
        f"{len(k4_b)} K4 buckets; vs the wide route (K3 + tail + K1) on its "
        f"{len(k3_b)} K3 buckets max |diff| {e_wide:.3e} (rtol {K4_RTOL}, "
        f"atol {K4_ATOL})")

    ib, Us0 = sh["ish"].to(dev), sh["U0"]
    S = SHARDS
    Vsh = Us0.reshape(S, -1, r)
    YtY = compute_yty(Us0)
    pre = []
    for b in ib:
        conf, pref = implicit_weights(b.vals, b.mask, ALPHA)
        pre.append((b, conf, (1.0 + conf) * pref * b.mask, pref * b.mask))

    def k7_one(b, aw, bw, cw):
        return cuda_gather_ne.gather_solve_ring(
            Vsh, b.cols, aw, bw, cw, YtY, two_sided=False, reg=REG,
            split_width=split)

    def k7():
        return [k7_one(*p) for p in pre]

    def k7_plain():
        xs = []
        for b, aw, bw, cw in pre:
            step = max(1, (1 << 28) // (S * min(b.width, split) * r))
            xs.append(torch.cat([cuda_gather_ne.gather_solve_ring_plain(
                Vsh, b.cols[:, :, sl], aw[:, :, sl], bw[:, :, sl],
                cw[:, :, sl], YtY, two_sided=False, reg=REG,
                split_width=split)
                for sl in (slice(s0, s0 + step)
                           for s0 in range(0, b.cols.shape[2], step))],
                dim=1))
        return xs

    xp, p7 = timed(k7_plain)
    xk = k7()
    torch.cuda.synchronize()
    e7 = {"unsplit": 0.0, "split": 0.0}
    for (b, *_), x, y in zip(pre, xk, xp):
        err = (x - y).abs().max().item()
        kind = "split" if S * b.width > split else "unsplit"
        e7[kind] = max(e7[kind], err)
        if not (torch.isfinite(x).all() and torch.allclose(
                x, y, rtol=K4_RTOL, atol=K4_ATOL)):
            fail(f"K7 on the ring grid's bucket of S x width {S}x{b.width} "
                 f"({kind}): kernel vs plain max |diff| {err:.3e}")
    log(f"k7 r={r} item half-step ring grid ({len(ib)} buckets, every one "
        f"gated): max |kernel - plain| {e7['unsplit']:.3e} on the buckets "
        f"of S x width <= {split} (unsplit), {e7['split']:.3e} on "
        f"the longer ones (split in chunks of {split}, the plain version "
        f"chunked the same way) (rtol {K4_RTOL}, atol {K4_ATOL})")
    del xk, xp

    per = [(p[0].width, cuda_ms(lambda p=p: k7_one(*p), 1)) for p in pre]
    total = sum(t for _, t in per)
    ms7 = cuda_ms(k7, 3)
    unfused = core_als.AlsConfig(rank=r, implicit_prefs=True, alpha=ALPHA,
                                 reg_param=REG)
    ic = torch.from_numpy(sh["icounts"]).to(dev)
    l7 = cuda_ms(lambda: ring_half_step(
        Us0, ib, ic, sh["ish"].rows_per_shard, S, unfused,
        sh["ish"].chunk_elems, YtY), 1)
    P, E, n = gram_work(ib, sh["ish"].rows_per_shard)
    nb7, fl7 = fused_solve_bytes(P, E, n, r), gram_flops(E, n, r)
    b7, by7 = fused_solve_bound(P, E, n, r)
    split_ms = sum(t for w, t in per if S * w > split)
    log(f"k7 item half-step by bucket (S x width: ms): " + ", ".join(
        f"{S}x{w}: {t:.2f}" for w, t in per) + f"; widest bucket's share "
        f"{per[-1][1] / total:.3f}; the split buckets {split_ms:.2f} of "
        f"{total:.2f} ms")
    log(f"timing K7 r={r} item half-step, {S} shards, {len(ib)} buckets, "
        f"{n} real rows, {E} real of {P} padded entries: kernel_ms="
        f"{ms7:.4f} plain_ms={p7:.4f} library_ms={l7:.4f} (unfused ring "
        f"half-step) bound_ms={b7:.4f} ({by7}: {bound_note(nb7, *fl7)}) "
        f"launches/fit={sh['launches']['k7']}")
    return {"name": f"gather_solve_ring (K7{tag})", "route": "cuda",
            "source": "tpu_als_torch/csrc/gather_solve_ring.cu",
            "replaces": "tpu_als/ops/pallas_gather_ne.py:708",
            "launches": sh["launches"]["k7"],
            "max_abs_err": max(errs["k7" + sfx], *e7.values()),
            "ms": ms7, "plain_ms": p7, "bound_ms": b7, "bound_by": by7,
            "library_ms": l7}


def merge_timings(model, launches, dev):
    """K8 at the sharded serving shape (every user, the catalog in SHARDS
    shards, k = 10) beside its plain version (held to K5_TOL on the
    scores: real factors, so no bitwise bar), the bound in K5's closed
    form, and a blocked ``matmul`` + stable ``sort`` over the whole
    catalog as the yardstick."""
    U, V = model._U, model._V
    (n, r), Ni, k = U.shape, V.shape[0], 10
    ni_loc = -(-Ni // SHARDS)
    Vp = torch.zeros(SHARDS * ni_loc, r, device=dev)
    Vp[:Ni] = V
    vp = torch.zeros(SHARDS * ni_loc, dtype=torch.bool, device=dev)
    vp[:Ni] = True
    Vs, vs = Vp.reshape(SHARDS, ni_loc, r), vp.reshape(SHARDS, ni_loc)
    sk, _ = cuda_topk.topk_merge_ring(U, Vs, vs, k)
    (sp, _), p8 = timed(lambda: cuda_topk.topk_merge_ring_plain(U, Vs, vs,
                                                                 k))
    e8 = (sk - sp).abs().max().item()
    if not torch.allclose(sk, sp, rtol=K5_TOL, atol=K5_TOL):
        fail(f"K8 at the serving shape: kernel vs plain scores max |diff| "
             f"{e8:.3e}")
    del sk, sp
    ms8 = cuda_ms(lambda: cuda_topk.topk_merge_ring(U, Vs, vs, k), 3)

    def library():
        for s in range(0, n, 8192):
            torch.sort(U[s:s + 8192] @ V.T, dim=1, descending=True,
                       stable=True)

    l8 = cuda_ms(library, 1)
    (b8, by8), note = topk_bound(n, Ni, r, k)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"timing K8 n={n} Ni={Ni} ({SHARDS} shards, parts "
        f"{cuda_topk.topk_parts(n, ni_loc, SHARDS, sms)}) "
        f"r={r} k={k}: kernel_ms={ms8:.4f} plain_ms={p8:.4f} "
        f"library_ms={l8:.4f} (matmul + stable sort) bound_ms={b8:.4f} "
        f"({by8}; {note}) launches={launches['k8']}; max |kernel - plain| "
        f"{e8:.3e}")
    return {"name": "topk_merge_ring (K8)", "route": "cuda",
            "source": "tpu_als_torch/csrc/topk_merge_ring.cu",
            "replaces": "tpu_als/ops/pallas_topk.py:346",
            "launches": launches["k8"], "max_abs_err": e8,
            "ms": ms8, "plain_ms": p8, "bound_ms": b8, "bound_by": by8,
            "library_ms": l8}


def bucket_times(tr):
    """Each bucket's share of the two half-steps from the seeded init
    (CUDA events), and one iteration beside its bound."""
    cfg, U0, r = tr["cfg"], tr["U0"], RANK
    yU = compute_yty(U0)
    V1 = core_als.local_half_step(U0, tr["ib"], tr["n_items"], cfg, yU)
    iter_bound = 0.0
    for side, Y, bks, n, yty in (
            ("items", U0, tr["ib"], tr["n_items"], yU),
            ("users", V1, tr["ub"], tr["n_users"], compute_yty(V1))):
        per = [(b.width, cuda_ms(lambda b=b: core_als.local_half_step(
            Y, [b], n, cfg, yty), 1), b.cols.shape[0]) for b in bks]
        total = sum(t for _, t, _ in per)
        # the half-step's bound: cols and weights read per padded entry, a
        # gathered row, the lower-triangle Gram and b per real entry, a
        # solve and x written per real row
        P, E, rows = gram_work(bks, n)
        b_ms, by = fused_solve_bound(P, E, rows, r)
        iter_bound += b_ms
        log(f"{side} half-step by bucket (width: ms, rows): "
            + ", ".join(f"{w}: {t:.2f}, {n_b}" for w, t, n_b in per)
            + f"; sum {total:.1f} ms, widest bucket's share "
            f"{per[-1][1] / total:.3f}; {E} real of {P} padded entries, "
            f"{rows} real rows; bound {b_ms:.2f} ms ({by})")

    def iteration():
        core_als.als_step(U0, tr["V0"], tr["ub"], tr["ib"], tr["n_users"],
                          tr["n_items"], cfg)

    ms = cuda_ms(iteration, 2)
    log(f"one iteration at SPLIT_WIDTH {core_als.SPLIT_WIDTH}: {ms:.1f} ms "
        f"({ms / iter_bound:.1f}x its bound {iter_bound:.2f} ms)")


def profiled(r, what, fn, note=""):
    """``fn()`` once under the profiler: wall time, device busy time (sum
    of kernel times), the device's idle share and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): a CPU op's self device
    # time repeats its kernels' time
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0
          and not e.key.startswith("Activity Buffer")]
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:5]
    log(f"profile rank {r} {what}: wall_ms={wall:.3f} "
        f"device_busy_ms={busy:.3f} device_idle_share={1 - busy / wall:.3f}"
        + note)
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d}"
            f" {e.key[:90]}")


def training_iteration(tr):
    """One 'auto' iteration from the slice ``tr``'s seeded init."""
    return lambda: core_als.als_step(tr["U0"], tr["V0"], tr["ub"], tr["ib"],
                                     tr["n_users"], tr["n_items"], tr["cfg"])


def where_time_goes(model, rng, tr, users, items):
    """One training iteration, one more fold-in batch (of ``users`` and
    new ones, rating ``items``) and one all-users recommend under the
    profiler (:func:`profiled`), at the rank of ``tr`` and ``model``,
    and the host's packing time of the batch."""
    r = model.rank
    batch, _ = foldin_batch(rng, 4096, users,
                            int(model._user_map.ids.max()) + 1, items)
    t0 = time.perf_counter()
    fixed = model._item_map.to_dense(batch["item"])
    pack_rows(batch["user"], fixed, batch["rating"])
    pack_ms = (time.perf_counter() - t0) * 1e3
    srv = FoldInServer(model)
    profiled(r, "training iteration", training_iteration(tr))
    profiled(r, "fold-in update", lambda: srv.update(batch),
             f" host_pack_ms={pack_ms:.3f}")
    profiled(r, "recommend_arrays", lambda: model.recommend_arrays(10))


def profile_engine_batches(fitted, rng, dev, reps=20):
    """Phase 15's serving rows: for the int8 and the exact route of a
    'local' engine on the rank-128 fit, ``reps`` synchronous
    ``serve_batch`` calls of 8 requests (one bucket) under the profiler:
    wall and device busy time per batch, the device's idle share and the
    top kernels.  Last of the profiles, so the earlier ones read as they
    did before the serving phase existed."""
    users = rng.integers(0, fitted._U.shape[0], 8 * (reps + 1))
    for path, quantize in (("int8", True), ("exact", False)):
        eng = ServingEngine(k=10, shortlist_k=SERVE_SK, max_wait_s=0.0,
                            device=dev)
        eng.publish(fitted._U, fitted._V, quantize=quantize)
        eng.warmup()
        profile_engine_batch(eng, users, path, reps)


def profile_engine_batch(eng, users, path, reps):
    """One route's profiled batches (:func:`profile_engine_batches`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def batch(j):
        for u in users[8 * j:8 * j + 8]:
            eng.submit(int(u))
        eng.serve_batch(eng.batcher.next_batch(timeout=1.0))

    batch(reps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for j in range(reps):
            batch(j)
        wall = (time.perf_counter() - t0) * 1e3 / reps
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0
          and not e.key.startswith("Activity Buffer")]
    busy = sum(e.self_device_time_total for e in ev) / 1e3 / reps
    log(f"profile engine {path} batch of 8: wall_ms={wall:.3f} "
        f"device_busy_ms={busy:.3f} device_idle_share={1 - busy / wall:.3f}"
        f" kernels_per_batch={sum(e.count for e in ev) / reps:.1f}")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:5]:
        log(f"  {e.self_device_time_total / 1e3 / reps:9.4f} ms  "
            f"x{e.count / reps:<5.1f} {e.key[:90]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mh-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ipc-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    if args.mh_worker:
        return mh_worker(args.mh_worker, args.init_method)
    if args.ipc_worker:
        return ipc_worker(args.ipc_worker, args.init_method)
    if not _native_build.have_compiler():
        fail("g++ is not on the PATH: the native bucketizer and CSV reader "
             "are built with it")
    # a fresh plan cache for this run, before anything resolves (a ladder
    # or a kernel config banked by another run would steer this one)
    global PLAN_ROOT
    plan_root = tempfile.TemporaryDirectory(prefix="chip_smoke_plan_")
    PLAN_ROOT = plan_root.name
    os.environ[PLAN_ENV] = os.path.join(PLAN_ROOT, "run")
    os.environ.pop(plan.AUTOTUNE_ENV, None)
    pin_fp32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {smi}")
    t0 = time.perf_counter()
    libs = _build.load_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fastbucket.load()
    fastcsv.load()
    log(f"built the native bucketizer and CSV reader (g++) in "
        f"{time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    t_checks = time.perf_counter()
    pcv = start_cpu_cv(args.seed)
    split = core_als.SPLIT_WIDTH
    errs = {"k2": check_k2(rng, dev), "k1": check_k1(rng, dev),
            "k6": check_k6(rng, dev)}
    k5 = check_k5(rng, dev)
    errs.update(k5=k5[RANK], k5_256=k5[RANK256], k3=check_k3(rng, dev),
                k4=check_k4(rng, dev))
    # the larger error of the ranks of a class: 200 and 256 (gram_sm90.cuh
    # cut over blocks), 257 to 512 (gram_strips.cuh; 257: the solve's 9
    # tiles on chip, a one-column last strip in a one-strip group; above
    # 288 the solve on a thread-block cluster; 333: 4- and 2-byte copies,
    # the cluster solve's scalar loads; K3 also at 640)
    for cls, ranks in (("256", (200, RANK256)),
                       ("512", (257, 320, 333, 384, RANK512,
                                SOLVE_BOUND_RANK))):
        for r in ranks:
            e = {"k3": check_k3(rng, dev, r, (24, 512))}
            if r <= RANK512:
                e["k4"] = check_k4(rng, dev, r, ((256, 24), (64, 512),
                                                 (3, 2 * split)))
            for k, v in e.items():
                errs[f"{k}_{cls}"] = max(errs.get(f"{k}_{cls}", 0.0), v)
    check_solve_bound(rng, dev)
    check_cluster_solve(rng, dev)
    errs["k7"] = check_k7(rng, dev)[RANK]
    errs["k7_512"] = check_k7(rng, dev, (RANK512,), (1, SHARDS))[RANK512]
    errs["k8"] = check_k8(rng, dev)
    check_k8_many(rng, dev)
    check_ladder(dev)
    log(f"phases 2-4 (the kernels against their plain versions): "
        f"{time.perf_counter() - t_checks:.1f} s")
    frame = ml25m_frame(args.seed)
    audit = start_comm_audit(frame, dev)
    ipc = start_ipc_phase(frame)
    try:
        analysis_phase(dev, smi)
    finally:
        audit_rows = comm_audit_phase(audit, smi)  # releases its processes
    ipc_rows = ipc_phase(ipc, audit_rows, dev, smi)
    # the numpy blocking in the CV's wait; the native one timed after it
    nb = block_numpy(frame)
    cpu_cv = finish_cpu_cv(pcv)
    data = prepare(frame, nb, dev)
    del frame, nb
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    s9 = csv_phase(data["frame"], args.seed, work.name)
    tr = train_slice(data, RANK, args.seed, dev)
    tr256 = train_slice(data, RANK256, args.seed, dev)
    del tr["items"], tr256["items"]
    sh = sharded_train_slice(data, args.seed, dev)
    sharded_resilience_phase(data, sh, tr["model"], work.name, args.seed,
                             dev)
    multiprocess_phase(data, args.seed, dev, smi)
    tr512 = rank512_slice(data, sh, args.seed, dev)
    guardrail_fits(data, tr, dev)
    frame25m, csrs = data["frame"], (data["ucsr"], data["icsr"])
    del data
    model, launches, A, b, users = run_slice(rng, dev)
    model256, launches256, A256, b256, users256 = serve_slice_256(
        tr256["model"], rng, dev)
    launches8 = sharded_serve_slice(tr["model"], sh["mesh"], dev)
    topk_k200(tr["model"], sh["mesh"], rng, dev)
    recommend_zero(model)
    model_selection_phase(frame25m, args.seed, dev, cpu_cv)
    del frame25m
    p8 = serving_engine_phase(tr["model"], model, rng, dev, smi)
    s9 += live_tenancy_phase(tr["model"], rng, dev, smi, p8)
    log(f"phase 9 (the stream, the live loop and tenancy): {s9:.1f} s")
    two_tower_phase(dev, work.name, args.seed, smi)
    measurement_phase(csrs, tr, work.name, args.seed, dev, smi)
    floor_audit_phase12(planner_phase(csrs, tr, dev, smi), dev)
    del csrs
    work.cleanup()
    scenario_soak_phase(dev, smi)
    kernels = timings(model, launches, A, b, errs, dev)
    kernels.append(k5_timing(model256, launches256["k5"], errs["k5_256"],
                             dev))
    sweep_timings(model, users)
    sweep_timings(model256, users256)
    kernels += train_timings(tr, errs, dev)
    kernels += train_timings(tr256, errs, dev)
    kernels += train_timings(tr512, errs, dev)
    k4_split(tr, smi)
    k4_split(tr256, smi)
    t0 = time.perf_counter()
    k4_split(tr512, smi)   # its budget: 30 s
    log(f"k4 split at rank {RANK512}: {time.perf_counter() - t0:.1f} s "
        "(budget 30 s)")
    iteration_logger_cost(tr, rng, smi)
    kernels.append(ring_timings(sh, tr, errs, dev))
    kernels.append(ring_timings(tr512.pop("ring"), tr512, errs, dev))
    del sh
    kernels.append(merge_timings(tr["model"], launches8, dev))
    kernels.append(k6_timings([(A256, b256, b256.shape[0])],
                              launches256["k6"], errs["k6"], "fold-in"))
    kernels += ipc_rows
    del A256, b256
    kernels.sort(key=lambda k: k["name"].split("(K")[1])
    bucket_times(tr)
    where_time_goes(model, rng, tr, np.arange(N_USERS), np.arange(N_ITEMS))
    where_time_goes(model256, rng, tr256, tr256["model"]._user_map.ids,
                    model256._item_map.ids)
    profiled(RANK512, "training iteration", training_iteration(tr512))
    profile_engine_batches(tr["model"], rng, dev)
    plan_root.cleanup()
    log(f"device: {smi}")   # again, beside the results at the tail
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
