#!/usr/bin/env python3
"""Drive the torch port on one NVIDIA card: online MF (bare, through the
job envelope, answering top-K queries while it trains, through the
parameter-server cluster and the mesh store, resharded live by the
elastic driver, failed over across replica chains, watched by the
telemetry plane's hot-key sketches, SLOs and timeline, served through
the hot-key lease cache with ``/metrics``, the run report and the lock
witness live, steered around a lagged worker by the adaptive runtime,
kept in the two-tier store with its hot tier on the card, and put through
the nemesis fault-injection harness's corpus, shrinker and full-width
schedules, fed by the native loader and a reconnecting socket, held
under an open-loop soak at twice its capacity, and row-blocked over a
mesh of ranks), the registered
workloads (MF, PA, count-min) through the cluster with their serving
verbs, the other batched workloads (passive-aggressive, the sketches,
word2vec, the factorization machine), the event API and its hybrid
backend, and Transformer LM training through the dense parameter server,
dense and with switch-MoE layers, on one device and data-parallel across
ranks (replicated, ZeRO-1, FSDP), and the mesh store's row blocks.

Run from the repository root on a machine with one CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package.  Phases, one
line each; any failure exits non-zero before the last line:

  1. build   compile every CUDA kernel (one nvcc per source, all at once)
             into build/kernels/.
  2. check   each kernel against its plain torch version on the card: the
             MF kernels at the MF path's full width (131,072 items,
             65,536-lane Zipf microbatch), float32, bfloat16, int32 and
             packed tables, and in float32 twice on the same inputs, which
             must agree bit for bit; the flash-attention forward, dQ and dK/dV at
             the LM's shape (B 16, T 512, H 8, D 64, bfloat16), at a dp-4
             and a tp-4 rank's shares of it in float32, at B 2, T 1024,
             H 8, D 128 in float32, at head_dim 256 (B 2, T 1024, H 4) in
             both dtypes, and at head_dim 320 and 512 (B 2, T 1024, H 2;
             the column-split kernels) in both dtypes; for each bfloat16
             output the error of scaled_dot_product_attention against the
             same plain version is printed beside the kernel's, as a
             yardstick.  A ``route:`` line for each dtype and head width
             names the three kernels it launched, read from torch.profiler
             (float32 dQ and dK/dV at head_dim 64-256 must take the 3xTF32
             kernels, every other pair its own).
  determinism  ``ps_online_mf`` twice on the same full-width stream (8
             microbatches) under each ``scatter_impl``: the item table and
             the user state must agree bit for bit; ``index_add_`` and
             ``index_put_(accumulate=True)`` twice on the user scatter's
             inputs, repeatable or not, and their times.
  driver     the job envelope at the MF path's full width (24 microbatches,
             dim 64, ``scatter_impl="pallas"``): an uninterrupted
             ``StreamingDriver`` run (K1 once a step and no other kernel),
             the same stream through ``RecoveringDriver`` with a crash at
             step 13 (restore step 8, replay the WAL tail) bitwise equal to
             it, ``load_model`` of the final checkpoint, the corrupt-latest
             fallback, the NaN guard, and the envelope's costs (updates/s
             against bare ``transform_batched``, a checkpoint save, a WAL
             append, the NaN check), each beside the card's name and power
             limit.  A ``profile_dir`` run comes last of the whole script.
  serving    train-while-serve at the same width: ``StreamingDriver(...)
             .serve_with(publish_every=4, max_batch=64, ...)`` trains 400 steps
             over a pool of 32 seeded microbatches while 8 client threads
             send ``top_k(k=10)`` (half with 50 excluded ids).  K1 once a
             step and no other kernel; 32 answers sampled over the run
             held against a float64 CPU oracle on their own snapshots; the
             final answer equal to ``query_topk`` on the trained store; a
             TCP round trip; no dispatch error; a snapshot bitwise frozen
             while K1 writes 8 more steps; ``make_mf_topk_step`` against
             ``dense_topk`` on the pre-push table.  ``serving:`` lines
             give QPS, latency, staleness, fill, publish ms, the 64-query
             top-K batch's device ms beside its bound, and updates/s with
             and without serving (3 runs each, in turns).
  workloads  the other batched workloads at full width, each through
             ``transform_batched`` over its logic's store with
             ``scatter_impl="pallas"`` (K1 a push): PA binary (2,000,000
             features, 65,536 examples of 32, Zipf 1.3; dense and packed
             tables), PA multiclass (4 classes, dense), SGNS (1,000,000 x
             (2, 128), 32,768 pairs, 5 negatives), the FM (4,194,304 x 17,
             32,768 examples of 39, Zipf 1.2; packed and dense) and the
             count-min 8,192 x 4, Bloom-pair 32,768 x 4 and tug-of-war 8 x
             32 sketches over 65,536-token microbatches (dense and packed).
             Each arm: K1 against its plain version on its first push and
             on random deltas, twice, bitwise; 8 counted steps (K1 once a
             step, no other kernel); the learning check (the loss falls;
             sketch tables equal a numpy oracle, count-min never under the
             true count); the rate and K1's time beside its bound, with the
             card's name and power limit.  Then the same stream with
             ``scatter_impl="xla"`` against each pallas arm (sketch tables
             exact after 8 steps; float tables after the first step, at K1's
             bar plus the xla arm's own float32 error against float64 sums),
             each workload at reduced width on the card against the CPU, and
             the event API's MF job (``MFWorkerLogic``, 2,000 ratings) on the
             card against the CPU.  A torch.profiler trace of
             4 steps of each workload runs after every counted run.
  cluster    the parameter-server cluster at the MF path's full width
             (100,000 users x 131,072 items, dim 64, lr 0.01, 12
             microbatches of 65,536 Zipf-1.2 ratings; only the run length
             is cut) through ``ClusterDriver``: socket BSP, 4 shards x 2
             workers, range and hash partitions (every shard's slice a
             CUDA tensor), held at the reference's bar (rtol 1e-4, atol
             1e-6) against the single-process ``transform_batched``; 1
             worker twice, bitwise; a supervised shard crash at round 6
             over a WAL, bitwise against the uninterrupted run; SSP bound
             2 with a worker held back (the fast one stops 2 rounds
             ahead), and async; 2 shard processes against the
             thread-backed run over one ``hashed_uniform`` init, bitwise;
             the mesh store (``store_backend="mesh"``: the table and the
             rows the step gets are CUDA tensors; 1 worker twice bitwise;
             2 workers BSP at the bar; a store rebuilt over the WAL
             bitwise, ``verify_against_log()``).  No kernel of the port
             launches (the cluster takes the store's ``"xla"`` arm, as
             the reference does).  ``cluster:`` lines give rounds/s and
             updates/s of each arm, the frames' phases, the client's round
             trips (p50, p99), the host-mirror rebuild and the mesh
             scatter, and, from a separate range run with a synchronize
             after each step, a worker's round split into pull, step and
             push, beside the card's name and power limit.
  shmem      the shared-memory transport (``wire_proto="shm"``) at the
             cluster phase's width and stream: (1) socket BSP 4 shards x 2
             workers with ``push_aggregate`` (one merged push a round, so two
             runs are bitwise comparable), range partition, slices on the
             card, in turns over binary TCP, shm, shm, TCP (the transport
             A/B, its rate counted after 2 warm-up rounds): every turn
             bitwise the first, the shm table at the reference's bar
             against the single-process one; (2) 2 shard processes x 1
             worker over the ``hashed_uniform`` init, shm against TCP,
             bitwise, each child's ready message advertising shm; (3) the
             arm of (1) with a fault-free ``ChaosProxy`` in front of shard
             0: that shard's connections fall back to binary TCP
             (``hello-refused`` once a dial through the proxy), bitwise the
             TCP arm; (4) ``hot_cache=True`` SSP 4 x 2 with
             ``push_aggregate`` and a fixed lease set (the stream's 256
             most frequent items) over shm against TCP: values and cache
             hit counts equal.  Every shm arm: every connection on
             ``wire == "shm"``, no fallback; the rings' bytes fit
             ``/dev/shm``; after the phase no ``fps-ring-*`` segment and no
             ``shm-beat-*`` or ``*-shm-pump`` thread is left.  No kernel
             launches.  ``shmem:`` lines give each arm's rounds/s,
             updates/s, ``push_batch`` and ``pull_batch`` p50 / p99 ms,
             seconds, ring bytes, borrows, spills and oversize detours, and
             ``/dev/shm``'s size, beside the card's name and power limit.
  elastic    registered workloads and live resharding through the entry
             points a user calls (``workloads.build_cluster_driver``,
             ``elastic.ElasticClusterDriver``).  ``MFWorkload`` at the MF
             path's width (100,000 users x 131,072 items, dim 64, its own
             logic, init and seeded stream of 65,536-rating microbatches, 12
             rounds; only the run length is cut): a single-process
             ``StreamingDriver`` anchor over a ``scatter_impl="pallas"``
             store (K1 once a step and no other kernel); socket BSP 4 shards
             x 2 workers at the reference's bar (rtol 1e-4, atol 1e-6)
             against it; under 2-worker BSP traffic over a WAL, a live
             scale-out 2 -> 3 and a live scale-in 3 -> 2 (each fired when
             ``cluster_worker_rounds_total`` reaches 4; migration verified
             bitwise with 0 mismatches, rows moved, the retired shard fully
             drained) and shard 1 killed and replaced from its WAL, each
             with the ledger balanced (acked == applied) and at the bar
             against the static hash run of its final shard count; a hedged
             pull against a shard that stalls one frame 0.5 s (the hedge
             wins; one push applied once).  PA (8,192 features, 1,024
             examples a round, 12 rounds; its stream is a dense host
             matrix, ~400 MB) through ``build_cluster_driver("pa")``: 2
             shards x 1 worker twice, bitwise ``oracle_values()``, and
             ``predict`` over TCP equal to the table's dot products; 2
             shards x 2 workers within rtol 1e-5 / atol 1e-6 (each worker's
             combined row lands as its own float32 add).  The count-min
             sketch (8,192 x 4, 65,536 tokens a round, 12 rounds, q8
             requested) through ``build_cluster_driver("sketch")``, SSP 2
             shards x 2 workers: q8 downgraded to float32, the table equal
             to the numpy bincount, ``query`` and ``topk`` over TCP equal to
             numpy estimates over the same table.  No cluster or elastic run
             launches a kernel of the port.  ``elastic:`` lines give rounds/s
             and updates/s of every run and before, during and after each
             resize, each migration's rows, bytes and ms, the epoch flip's
             ms, the hedges fired and won, each workload's rate and the
             phase's seconds, beside the card's name and power limit.
  replication  replica chains at the same MF width (``MFWorkload``,
             100,000 x 131,072, dim 64, lr 0.05, the seed-3 stream of
             65,536-rating microbatches, 12 rounds) through
             ``build_cluster_driver(..., driver_cls=ReplicatedClusterDriver)``:
             2 shards, 1 follower each, 1 BSP worker, while a
             ``FollowerLookupService`` reader pulls 2,048 rows at a time
             through the chains.  Before round 4 each follower must be
             caught up and bitwise its primary; then shard 0's primary is
             killed and ``ElasticController`` promotes its follower.  The
             promoted shard bitwise its own log (``verify_against_log`` on
             the card), the final table bitwise an uninterrupted static
             2-shard run, no read error, no kernel launch.  ``replication:``
             lines give failover ms (kill -> membership publish), reads
             served during the failover, lag, catch-up and salvage counts,
             each follower's host-mirror rebuilds and their ms, and
             ``replace_shard`` ms for shard 1 afterwards (the O(log)
             rebuild), beside the card's name and power limit.
  telemetry  the telemetry plane's detection half at the cluster phase's
             MF width (socket BSP 4 shards x 2 workers, 12 rounds of
             ``zipf_stream(9, 12)``): four timed runs with ``hot_keys`` off,
             on, on, off; a checked ``hot_keys=True`` run whose shard
             sketches also count exactly: the aggregator's ``top_k(10)``
             ranked by ``dense_topk`` on the card equal to a CPU
             aggregator's and a host sort of ``candidates()``, every count
             within the reference's bounds, a sketch over the raw item
             stream naming its 10 most-observed keys, ``stop()``
             unregistering every sketch; a ``TimelineRecorder`` (a
             ``SkewTracker`` over the per-shard pull round trips, an EWMA
             detector) and an ``SLOEngine`` over ``default_slos()`` sampled
             once a round; then ``ElasticController(slo=)`` on a 2-shard
             ``ElasticClusterDriver`` (``MFWorkload``), its pull objective a
             tenth of the run's early p50, firing exactly one scale-out 2 ->
             3 with the migration verified bitwise.  ``telemetry:`` lines
             give rounds/s with and without ``hot_keys``, flush ms,
             ``top_k``'s and ``candidates()``' ms, the recorder's sample ms
             and the SLO verdicts, beside the card's name and power limit.
  hotcache   the hot-key lease cache and the telemetry surfaces.  (a) The
             reference's hot-key storm (``benchmarks/hotcache_storm.py``: 1 %
             of the keys take 90 % of the requests, 4 ids a request, lease
             bound 64, one closed-loop reader, a writer pushing hot ids) at
             131,072 x 64 on a 2-shard cluster whose slices are on the card,
             arms off, on (5,000 warm-up and 1,500 measured
             requests an arm; reader and writer behind a ``ChaosProxy``
             that delays each request frame 1 ms, as the reference's
             storm): ``check_lease_staleness`` with hits;
             then ``CachedLookupService.top_k`` over every id, ranked on the
             card, equal to a float64 numpy ranking of the shards' rows.  (b)
             The cluster phase's MF under SSP bound 2 (4 shards x 2 workers)
             with ``hot_cache`` off, on; a checked ``hot_cache=True``
             run (the final table the shards' rows bitwise, every worker
             cache within its bound, a card-side ``CachedLookupService``
             reader of the stream's 32 hottest items held to
             ``check_lease_staleness``); BSP 4 shards x 1 worker with the
             cache bitwise without it.  (c) A strict HTTP scrape of
             ``/metrics`` and ``/hot``, ``/hotkeys``, ``/timeline``,
             ``/healthz`` mid-run, the run report written under a temporary
             directory (platform ``gpu``), 3 rounds under
             ``lockwitness.capture()`` with no inversion.  No kernel
             launches.  ``hotcache:`` lines give each storm arm's p50/p99,
             wire bytes a request, hit rate, leases and invalidations, the
             top-K's ms, rounds/s with and without the cache, the caches'
             counts, scrape, report and witness costs, beside the card's
             name and power limit.
  adaptive   the straggler-adaptive runtime (``benchmarks/straggler_ab.py``'s
             scenario): an ``ElasticClusterDriver``, 4 workers x 2 shards, hash
             partition, SSP bound 2 (ceiling 5), slices on the card, worker 0
             reaching every shard through a ``ChaosProxy`` that delays each
             frame 25 ms both ways.  Per workload (MF at 100,000 x
             131,072, dim 64, 65,536 ratings a round, lr 0.01; PA at 8,192
             features x 1,024 examples a round) a fixed arm and an adaptive arm
             (``adaptive=True``, push hedging after 10 ms, a timeline
             ``SkewTracker`` on the workers' pull p50, ``AdaptiveRuntime`` with
             a ``RebalancePolicy``, the bound envelope sampled every 2 ms), each
             under ``run(deadline_s=6)`` after one unmeasured round: the
             envelope holds, a mechanism fired, adaptive RMSE <= fixed x 1.10
             against the fault-free oracle, acked == applied.  Then
             ``drain_shard(0)`` on a 3-shard card cluster, every row bitwise;
             ``/adaptive`` and the run report's section equal to
             ``rt.payload()``.  ``adaptive:`` lines give goodput, RMSE, the
             mechanisms' counts and the drain's rows and ms.  No kernel.
  tierstore  the two-tier store: (a) ``benchmarks/tierstore_soak.py`` at its
             size (2**24 x 16 float32, a 2**20-row hot tier, 8,192
             log-uniform ids a round deduplicated as the client does, 100 +
             400 rounds) in three arms (the torch store on the card, the hot
             tier on the card, the hot tier on the host): residency in every
             round, both tiered tables the dense one's bitwise, the
             card-tier's peak on the card within the hot tier + 16 MiB; (b)
             its recovery legs on card-backed tiered shards (parity, WAL
             replay, a follower promoted and audited, migration), bitwise;
             (c) MF at full width, BSP 4 x 2 with ``push_aggregate``, tiered
             (a quarter of each shard hot) against socket, bitwise, ``/tiers``
             naming both shards.  ``tierstore:`` lines give pull and push
             p50/p99, hit rate, promotes, demotes, spills, eviction scans,
             card peak memory, host RSS growth and rounds/s.  No kernel.
  nemesis    the fault-injection harness (``nemesis/``) with every shard
             slice, workload and oracle on the card and every shard link
             behind a ``ChaosProxy``: (a) the committed corpus's 15 schedules
             at their own shapes (``two_way_partition_heal`` witnessed), held
             to the reference's acceptance checks (>= 8 passing, all ok; the
             anchors ran every op; the seven fault classes injected; the
             seeded corruption caught by parity alone, its artifacts linted);
             (b) ``shrink`` of the seeded violation to the committed
             one-op schedule, byte for byte; (c) ``kill_primary_under_
             partition`` and ``promote_while_client_partitioned`` at MF
             100,000 x 131,072, dim 64, 65,536 ratings a round, and
             ``sketch_full_stack`` at the elastic phase's count-min width, 12
             rounds each, every invariant passing, each oracle finite.
             ``nemesis:`` lines give each run's verdicts, faults, rounds,
             seconds and rounds/s.  No kernel.
  loadgen    the record sources and the open-loop soak: MF at the main
             path's full width (``scatter_impl="pallas"``) over its first
             two 65,536-rating microbatches written to a MovieLens file,
             fed by the native loader (built with g++ under build/native/,
             its columns and the tables bitwise the in-memory feed's) and,
             through ``StreamingDriver``, by ``socket_text_stream`` from a
             ``ChaosLineServer`` that resets the connection every 50,000
             lines (reconnects, every record once, the tables bitwise); K1
             twice in each source-fed run, and those 4 launches join the
             kernels line's K1 count.  Then ``benchmarks/soak_capacity.py``'s
             headline (2 shards x replication 1, the MF workload at
             131,072 x 64, 100,000 users): ``closed_loop_capacity`` and the
             control-on arm at twice that capacity for 15 s over the
             nemesis schedule (every verdict, the ledger balanced, no
             error, a promote).  ``loadgen:`` lines give records/s of each
             feed, the capacity with its closed p50/p99, goodput, its share
             of capacity, admitted p50/p99, sheds, lates, budget
             exhaustions, breaker opens and brownouts.
  parallel   the parameter server across devices: (a) in this process
             over a one-rank NCCL group, (b) and (c) in child processes of
             this script (``--parallel-rank``) under a 300 s limit: (a) a
             1 x 1 NCCL mesh, MF at the main path's full width
             over 4 Zipf microbatches, tables, pulls and the top-K bitwise
             the unsharded run; (b) a 2 x 2 mesh of 4 ranks on ``cuda:0``
             over gloo with CUDA tensors (NCCL takes one rank a card), the
             tables within rtol 1e-5 / atol 1e-6 of (a), pulls and the
             sharded top-K bitwise the whole table's; (c) the same ranks as
             a 1 x 4 ps-only mesh, ``fused_mf_sgd_sharded`` at dim 128
             within the same bar of the unsharded fused step.  K1 once a
             rank a step, K2 likewise; the ranks' launches join the kernels
             line's counts.  ``parallel:`` lines give the backend, each
             rank's pull and push ms and the all-reduce / all-gather ms.
  dense_dp   the dense LM across ranks and the mesh store's row blocks,
             laid out as ``parallel``: (a) a one-rank NCCL
             ``("dp",)`` mesh, Transformer-base (bfloat16, flash "on", 16 x
             512) for 3 steps of ``transform_dense`` replicated, ZeRO-1 and
             FSDP, each bitwise the unsharded run, K3a/b/c once a layer a
             step; (b) dp 4 as 4 gloo ranks on ``cuda:0``, the same model
             in float32 under SGD with momentum for 2 steps (one
             row-masked batch, unequal valid rows a rank) in the three
             regimes within rtol 1e-5 / atol 1e-6 of (a)'s unsharded
             float32 run, ZeRO-1's optimizer bytes
             and FSDP's parameter plus optimizer bytes at ~1/4 of
             replicated, the masked loss equal to the unsharded one, each
             collective's ms; (c) ``store_backend="mesh"`` with 4 row
             blocks on the card bitwise one block at the MF path's width,
             ``verify_against_log()``, the momentum velocity 1/4 a block.
             Then expert parallelism in the same processes: (a) the MoE LM
             (bfloat16, 8 experts) on a one-rank ``("dp", "ep")`` NCCL
             mesh bitwise the mesh-less run; (b) ep 4 on the 4 gloo ranks
             in float32 within the same bar of the mesh-less run, an ep x
             expert gradient past it; the dp-only mesh routing the global
             batch, per-rank routing past the bar; ``moe_apply`` at
             (2, 2) against its oracle; the all-to-all's ms and bytes.
             Then tensor, sequence and pipeline parallelism there too: (a)
             one-rank ``("dp", "sp", "tp")`` (flash "on") and ``("dp",
             "pp")`` (``forward_pipelined``) NCCL meshes bitwise the
             mesh-less run; (b) tp 4 (K3a/b/c on each rank's 2 heads), sp 4
             (the ring) and pp 2 x sp 2 in float32 within the same bar,
             each with a planted fault past it; K3a/b/c against their plain
             versions at a tp rank's shape on every rank; the tp
             all-reduce's and the ppermutes' ms.
             The ranks' flash launches join the kernels line's counts.
  3. main   ``ps_online_mf(..., dim=64, scatter_impl="pallas")`` through
             ``transform_batched``, then ``make_fused_mf_train_step`` at
             dim 128, over 100,000 users x 131,072 items; then the LM:
             Transformer-base (vocab 32,000, d_model 512, 8 heads, 6
             layers, d_ff 2,048, bfloat16, ``flash_attention="on"``)
             through ``DenseParameterServer(init_params(...), adamw(3e-3))``
             and ``transform_dense`` for 20 steps of 16 x 512 bigram tokens.
             The launch counts are zeroed just before each path and read
             just after it: each path must launch its own kernels (once a
             step for MF, once a layer a step for the LM) and no other.
             A small run of each path is held against the CPU (plain) path
             first, and after the counted runs a few more steps of each
             path (the LM, ps_online_mf, the fused step) are traced with
             torch.profiler.
             Before the LM, small LMs at head_dim 320 (d_model 640, 2
             heads, ``flash_attention="auto"``) in both dtypes must launch
             the three flash kernels and match ``"off"``.  After it, the
             MoE LM: the same Transformer-base with ``num_experts=8`` on
             every layer and capacity 1,280 an expert (1.25 x 8,192 / 8), 20
             steps (120 launches of each flash kernel, the loss falls, the
             first 3 losses within rtol 2e-2 of a ``"off"`` run from the same
             weights), its tokens/s, step ms and the MoE layers' share of
             the step.  Then the hybrid backend: the event API's
             ``MFWorkerLogic`` under ``transform_hybrid`` against a
             ``scatter_impl="pallas"`` store of 131,072 x 64, two chunks of
             1,024 ratings (cut from 65,536 for the callbacks' time; K1 once
             a chunk, the table within rtol 1e-5 / atol 1e-6 of
             ``index_add_`` of the same pushes), and ``chunk_size=1`` over
             256 ratings against the event backend (atol 1e-5).  Their
             launches join the kernels line's counts.
  4. timing  each kernel's median time beside its bound, its plain
             version's time and the library call's (``index_add_`` for
             the scatter-add, ``scaled_dot_product_attention`` forward and
             backward for the flash kernels; K3b + K3c beside the whole
             backward); the column-split kernels' times at head_dim 320
             and 512 in both dtypes beside their bounds and SDPA's
             forward and whole backward (K3a beside the one, K3b + K3c
             beside the other); the float32 kernels at a dp-4
             and a tp-4 rank's shares of the LM (head_dim 64) and at a
             dp-4 share's width in heads of 128 and 256, beside their
             bounds (3xTF32 on the tensor cores, and the CUDA cores'
             figure) and SDPA's float32 forward and whole backward.

The line before the last is the card's name and power limit, the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

NUM_USERS, NUM_ITEMS, BATCH = 100_000, 131_072, 65_536  # bench.py's main-path shape
DIM_UNFUSED, DIM_FUSED = 64, 128
LEARNING_RATE = 0.01
BATCHES_PER_EPOCH, EPOCHS = 2, 6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM, TF32 tensor cores, dense: a float32 product in 3xTF32 takes three
BF16_OPS_PER_S = 989e12  # H100 SXM, bfloat16 tensor cores, dense
LM_B, LM_T, LM_H, LM_D = 16, 512, 8, 64  # bench_lm's TPU shape; Transformer-base heads
LM_STEPS, LM_WARMUP, LM_TRACED = 20, 5, 4
MOE_EXPERTS = 8  # examples/transformer_lm.py's MoE setting, on every layer
MOE_CAPACITY = 1280  # 1.25 x 8,192 tokens / 8 experts: Switch Transformer's training capacity factor
MF_TRACED = 4  # MF steps under torch.profiler, after the counted runs
LM_FAMILIES = (("flash", ("fps::flash_",)), ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "matmul")),
               ("softmax", ("softmax",)), ("optimizer", ("multi_tensor",)), ("copy", ("copy",)))
MF_FAMILIES = (("K1/K2 pass 1", ("scatter_tile_pass", "mf_tile_pass")),
               ("K1/K2 pass 2", ("combine_spanning_runs",)), ("sort", ("sort", "radix")),
               ("gather/scatter", ("index", "gather", "scatter")), ("copy", ("copy", "memcpy", "memset")))
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
SPLIT_DS = (320, 512)  # head widths past 256: the column-split kernels
# wider splits, checked only: two forward slices (640), and q streamed beside k where its rows no longer
# fit whole (1,344 in float32, 2,496 in bfloat16)
SPLIT_WIDE = ((640, "bfloat16"), (640, "float32"), (1344, "float32"), (2496, "bfloat16"))
TENSOR_CORES, SIMT = "tensor cores (bf16 mma.sync)", "SIMT (float32 FMA)"
TF32 = "tensor cores (3xTF32 mma.sync)"
SPLIT_TC = "column-split, tensor cores ({})"  # the three kernels past head_dim 256, by dtype
FWD_ROUTES = "tensor cores: bf16 mma.sync, float32 3xTF32 mma.sync, column-split past head_dim 256 in both"
FLASH_OWN_DS = (64, 128, 192, 256)  # head widths with a template of their own
REPO = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def gpu_ms(torch, fn, flush, reps: int = 15) -> float:
    """Median time of ``fn()`` on the card from CUDA events, L2 flushed
    before each call.  A sleep first holds the stream so calls queue
    behind it and the events time the card, not the host's launches."""
    fn()
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def zipf_batch(rng):
    """bench.py's microbatch: items first, then users and ratings."""
    items = ((rng.zipf(1.2, BATCH) - 1) % NUM_ITEMS).astype(np.int64)
    users = rng.integers(0, NUM_USERS, BATCH).astype(np.int64)
    ratings = rng.normal(0, 1, BATCH).astype(np.float32)
    return items, users, ratings


def zipf_stream(seed: int, n: int) -> list:
    """``n`` microbatches of :func:`zipf_batch`, made from ``seed``: a list,
    so the same stream can be fed again from the start."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        items, users, ratings = zipf_batch(rng)
        out.append({"user": users.astype(np.int32), "item": items.astype(np.int32), "rating": ratings,
                    "mask": np.ones(BATCH, bool)})
    return out


def phase_determinism(torch, dev):
    """Two runs of ``ps_online_mf`` on the same full-width stream (8
    microbatches) under each ``scatter_impl``, with
    ``torch.use_deterministic_algorithms`` left off: the item table and the
    user state must agree bit for bit (crash recovery rests on it).  Beside
    them, ``index_add_`` itself twice on the user scatter's inputs (65,536
    lanes into 100,000 x 64 float32), whether its bits agree, and its time
    against ``index_put_(accumulate=True)``, the form the port's row
    scatter-add takes on the card."""
    from flink_parameter_server_tpu_torch import ps_online_mf

    check(not torch.are_deterministic_algorithms_enabled(), "deterministic mode is on")
    stream = zipf_stream(1, 8)
    differ = []
    for impl in ("pallas", "xla_sorted", "xla"):
        runs = [ps_online_mf(iter(stream), num_users=NUM_USERS, num_items=NUM_ITEMS, dim=DIM_UNFUSED,
                             learning_rate=LEARNING_RATE, scatter_impl=impl, device=dev,
                             collect_outputs=False, dump_model=False) for _ in range(2)]
        torch.cuda.synchronize()
        same = {}
        for what in ("item table", "user state"):
            a, b = ((r.store.values() if what == "item table" else r.worker_state) for r in runs)
            same[what] = bool(torch.equal(a, b))
            print(f"determinism: ps_online_mf scatter_impl={impl} dim {DIM_UNFUSED}, 8 microbatches twice: "
                  f"{what} bitwise equal: {'yes' if same[what] else 'NO'}, "
                  f"largest difference {float((a - b).abs().max()):.3e}")
        differ += [impl] if not all(same.values()) else []
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    users = torch.from_numpy(stream[0]["user"]).to(dev).long()
    deltas = torch.randn(BATCH, DIM_UNFUSED, generator=gen, device=dev) * 0.01
    table = torch.randn(NUM_USERS, DIM_UNFUSED, generator=gen, device=dev) * 0.1
    forms = {"index_add_": lambda t: t.index_add_(0, users, deltas),
             "index_put_(accumulate=True)": lambda t: t.index_put_((users,), deltas, accumulate=True)}
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    for name, fn in forms.items():
        a, b = fn(table.clone()), fn(table.clone())
        ms = gpu_ms(torch, lambda: fn(table), flush)
        print(f"determinism: {name} ({BATCH} lanes into ({NUM_USERS},{DIM_UNFUSED}) f32, uniform users): "
              f"two calls bitwise equal: {'yes' if torch.equal(a, b) else 'no'}, "
              f"largest difference {float((a - b).abs().max()):.3e}, {ms:.4f} ms")
    check(not differ, f"two runs on the same stream differ under scatter_impl {differ}")


DRIVER_STEPS, DRIVER_CKPT_EVERY, DRIVER_CRASH_AT = 24, 8, 13
DRIVER_REPEATS = 5  # timed runs of each loop (after one untimed run of each)


def _driver_parts(torch, dev, **cfg):
    """The driver phase's job: MF at dim 64 over the main path's tables,
    SGDUpdater(0.01), scatter_impl="pallas", no model dump."""
    from flink_parameter_server_tpu_torch import (
        OnlineMatrixFactorization, SGDUpdater, ShardedParamStore, ranged_random_factor,
    )
    from flink_parameter_server_tpu_torch.training.driver import DriverConfig, StreamingDriver

    logic = OnlineMatrixFactorization(NUM_USERS, DIM_UNFUSED, updater=SGDUpdater(LEARNING_RATE), seed=0,
                                      device=dev)
    store = ShardedParamStore.create(NUM_ITEMS, (DIM_UNFUSED,), init_fn=ranged_random_factor(1, (DIM_UNFUSED,)),
                                     scatter_impl="pallas", device=dev)
    return logic, store, StreamingDriver(logic, store, config=DriverConfig(dump_model=False, **cfg))


def _same(torch, what, a, b, phase="driver"):
    equal = bool(torch.equal(a, b))
    print(f"{phase}: {what}: bitwise equal: {'yes' if equal else 'NO'}, "
          f"largest difference {float((a.double() - b.double()).abs().max()):.3e}")
    check(equal, f"{what} differ")


def phase_driver(torch, dev, card):
    """The job envelope at the main path's full width (100,000 users x
    131,072 items, dim 64, 24 microbatches of 65,536 Zipf-1.2 ratings from a
    seeded stream): an uninterrupted StreamingDriver run (K1 counted: once a
    step, no other kernel), then the same stream through RecoveringDriver
    with a crash at step 13 (restore step 8, replay the WAL tail, finish)
    held bit for bit against it; load_model of the final checkpoint; the
    corrupt-latest fallback; the NaN guard; and the envelope's costs, each
    printed beside the card's name and power limit."""
    import tempfile
    import warnings

    from flink_parameter_server_tpu_torch.core.transform import transform_batched
    from flink_parameter_server_tpu_torch.resilience import (
        FaultPlan, RecoveringDriver, RestartPolicy, corrupt_latest_checkpoint,
    )
    from flink_parameter_server_tpu_torch.training import checkpoint as ckpt
    from flink_parameter_server_tpu_torch.training.driver import TrainingDiverged

    stream = zipf_stream(2, DRIVER_STEPS)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="driver-", dir=os.path.join(REPO, "build")) as tmp:
        # 1. the oracle, K1 counted
        _, _, oracle_drv = _driver_parts(torch, dev)
        snaps = {}

        def snapshot(step, n, table, state, outs):  # the oracle's tables at the fallback step
            if step == 2 * DRIVER_CKPT_EVERY:
                snaps["table"], snaps["state"] = table[:NUM_ITEMS].clone(), state.clone()

        oracle_drv.add_group_hook(snapshot)
        zero_counts()
        oracle = oracle_drv.run(iter(stream))
        torch.cuda.synchronize()
        read_counts("StreamingDriver (oracle)", {"scatter_add": DRIVER_STEPS})
        check(oracle_drv.step_idx == DRIVER_STEPS, "the oracle ran the wrong number of steps")
        check(bool(torch.isfinite(oracle.store.values()).all()), "non-finite oracle table")

        # 2. crash at step 13, restore, replay, finish
        ck, wal = os.path.join(tmp, "ckpt"), os.path.join(tmp, "wal")
        _, _, drv = _driver_parts(torch, dev, checkpoint_every=DRIVER_CKPT_EVERY, checkpoint_dir=ck,
                                  wal_dir=wal, metrics_every=DRIVER_CKPT_EVERY)
        drv.metrics_sink = open(os.devnull, "w")
        drv.add_group_hook(FaultPlan().crash_at(DRIVER_CRASH_AT).driver_hook())
        rec = RecoveringDriver(drv, lambda: iter(stream), policy=RestartPolicy(jitter=0.0, backoff_base_s=0.0))
        zero_counts()
        t0 = time.perf_counter()
        res = rec.run()
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        drv.metrics_sink.close()
        event = rec.events[0]
        print(f"driver: recovery: {rec.restarts} restart ({event['failure']}), restored step "
              f"{event.get('restored_step')}, replayed {event.get('replayed_steps')} WAL steps, "
              f"{drv.step_idx} steps in all, {rec_s:.3f} s; retained checkpoints {drv._ckpt_mgr.all_steps()}")
        check(rec.restarts == 1 and event["failure"] == "device", "recovery did not restart exactly once")
        check(event.get("restored_step") == DRIVER_CKPT_EVERY, "recovery did not restore step 8")
        check(event.get("replayed_steps", 0) >= 1, "recovery replayed no WAL step")
        check(drv.step_idx == DRIVER_STEPS, "recovery ended at the wrong step")
        # K1 once a step, replays included: 13 steps, steps 9..T replayed, T+1..24
        read_counts("RecoveringDriver", {"scatter_add": DRIVER_STEPS + DRIVER_CRASH_AT - DRIVER_CKPT_EVERY})
        _same(torch, "recovered item table vs the uninterrupted run", res.store.values(), oracle.store.values())
        _same(torch, "recovered user state vs the uninterrupted run", res.worker_state, oracle.worker_state)

        # 5. load_model of the final checkpoint
        final = ckpt.load_model(ck, device=dev, scatter_impl="pallas")
        _same(torch, f"load_model of step {drv._ckpt_mgr.latest_step()} vs the uninterrupted run",
              final.values(), oracle.store.values())

        # 4. the corrupt latest: a fresh driver falls back one step
        corrupt_latest_checkpoint(ck, seed=0)
        _, _, fresh = _driver_parts(torch, dev, checkpoint_dir=ck)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            check(fresh.resume(), "resume() after the corruption restored nothing")
        fell_back = [w for w in caught if "falling back" in str(w.message)]
        print(f"driver: corrupt latest checkpoint: resume() warned {len(fell_back)} time(s) and restored "
              f"step {fresh.step_idx}")
        check(len(fell_back) == 1 and fresh.step_idx == 2 * DRIVER_CKPT_EVERY, "no fallback to step 16")
        _same(torch, "fallback table vs the uninterrupted run's at step 16", fresh.store.values(), snaps["table"])
        _same(torch, "fallback user state vs the uninterrupted run's at step 16", fresh._state, snaps["state"])

        # 6. the NaN guard: a table poisoned at step 10 is never checkpointed
        nan_dir = os.path.join(tmp, "nan")
        _, _, guarded = _driver_parts(torch, dev, checkpoint_every=5, nan_check_every=5, checkpoint_dir=nan_dir)

        def poison(step, n, table, state, outs):
            if step == 10:
                table[0, 0] = float("nan")

        guarded.add_group_hook(poison)
        try:
            guarded.run(iter(stream[:12]))
            raised = None
        except TrainingDiverged as e:
            raised = e
        steps = guarded._ckpt_mgr.all_steps()
        print(f"driver: NaN guard: {type(raised).__name__ if raised else 'nothing'} raised at step "
              f"{getattr(raised, 'step', None)}; checkpoints on disk {steps}")
        check(raised is not None and raised.step == 10, "the NaN guard did not fire at step 10")
        check(steps == [5], "a checkpoint after the poisoned step was written")

        _driver_costs(torch, dev, card, stream, tmp, transform_batched, ckpt)


def _driver_costs(torch, dev, card, stream, tmp, transform_batched, ckpt):
    """updates/s through StreamingDriver (with and without its prefetch
    thread) against bare transform_batched on the same stream (one untimed
    run of each, then DRIVER_REPEATS of each in turns, no profiler), one
    checkpoint save (sync and async), one WAL
    append, and the NaN guard's reduction."""
    from flink_parameter_server_tpu_torch import ShardedParamStore
    from flink_parameter_server_tpu_torch.resilience import UpdateWAL
    from flink_parameter_server_tpu_torch.training.driver import _all_finite

    updates = DRIVER_STEPS * BATCH
    # the driver as configured by default, the driver without its prefetch
    # thread, and the bare loop
    arms = {"StreamingDriver": {}, "StreamingDriver prefetch=0": {"prefetch": 0}, "transform_batched": None}
    rates = {name: [] for name in arms}
    for i in range(DRIVER_REPEATS + 1):
        for name, cfg in arms.items():
            logic, store, drv = _driver_parts(torch, dev, **(cfg or {}))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if cfg is not None:
                result = drv.run(iter(stream))
            else:
                result = transform_batched(iter(stream), logic, store, collect_outputs=False, dump_model=False)
            torch.cuda.synchronize()
            if i:  # the first run of each warms up
                rates[name].append(updates / (time.perf_counter() - t0))
    for name, r in rates.items():
        print(f"driver: {name}: {DRIVER_STEPS} microbatches of {BATCH} (tables built and copied in the "
              f"timed call), median {statistics.median(r):.0f} updates/s, spread {min(r):.0f}-{max(r):.0f} "
              f"over {len(r)} runs; {card}")

    table_mb = result.store.values().numel() * 4 / 2**20
    state_mb = result.worker_state.numel() * 4 / 2**20
    for use_async in (False, True):
        mgr = ckpt.JobCheckpointManager(os.path.join(tmp, f"save-{use_async}"), use_async=use_async)
        returned, durable = [], []
        for step in range(1, 4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(step, result.store, result.worker_state)
            returned.append((time.perf_counter() - t0) * 1e3)
            mgr.wait()
            durable.append((time.perf_counter() - t0) * 1e3)
        mode = "async" if use_async else "sync"
        print(f"driver: checkpoint save ({mode}, {table_mb:.1f} MiB table + {state_mb:.1f} MiB user state): "
              f"median {statistics.median(returned):.2f} ms until save() returns, "
              f"{statistics.median(durable):.2f} ms until durable, over 3 saves; {card}")
    wal = UpdateWAL(os.path.join(tmp, "wal-cost"))
    times = []
    for i, batch in enumerate(stream[:8]):
        t0 = time.perf_counter()
        wal.append(i, 1, batch)
        times.append((time.perf_counter() - t0) * 1e3)
    wal.close()
    print(f"driver: WAL append of one {BATCH}-rating batch ({wal.bytes_written // 8} bytes, fsync each): "
          f"median {statistics.median(times):.3f} ms, spread {min(times):.3f}-{max(times):.3f} over 8; {card}")
    outs = {"prediction": torch.zeros(BATCH, device=dev), "error": torch.zeros(BATCH, device=dev)}
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(bool(_all_finite(outs, result.store.table, result.worker_state)), "finite tables read as not")
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"driver: nan_check (one reduction over the outputs, the item table and the user state, one "
          f"host read): median {statistics.median(times[2:]):.3f} ms over 18; {card}")


def phase_driver_trace(torch, dev):
    """A StreamingDriver run with profile_dir (steps 3-5 of 8 traced), last
    of all: the chrome trace it writes must hold K1's kernel events."""
    import tempfile

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="profile-", dir=os.path.join(REPO, "build")) as tmp:
        _, _, drv = _driver_parts(torch, dev, profile_dir=tmp, profile_steps=(2, 5))
        drv.run(iter(zipf_stream(3, 8)))
        torch.cuda.synchronize()
        traces = [f for f in os.listdir(tmp) if f.endswith(".json")]
        check(len(traces) == 1, f"profile_dir holds {traces}")
        with open(os.path.join(tmp, traces[0])) as fh:
            events = json.load(fh)["traceEvents"]
        k1 = [ev for ev in events if ev.get("cat") == "kernel" and "scatter_tile_pass" in ev.get("name", "")]
        print(f"driver: profile_dir trace: {len(events)} events, {len(k1)} of K1's pass-1 kernel "
              f"(fps::scatter_tile_pass) over the traced steps")
        check(len(k1) >= 1, "the driver's trace holds no K1 kernel event")


# The counted train-while-serve run is a step count, not a time: this job
# (plain SGD at lr 0.01, duplicate items' deltas summed) turns its tables
# non-finite between steps 800 and 850 of the cycled pool, in the reference
# and the port alike, so a run bounded by the clock could diverge on a card
# that steps faster.  400 steps take about 3 s beside the clients on an
# H100.
SERVE_POOL, SERVE_STEPS = 32, 400  # seeded microbatches, cycled; the train-while-serve run's length
SERVE_KW = dict(publish_every=4, max_batch=64, max_delay_ms=2.0, max_queue=512)  # benchmarks/serving_qps.py
SERVE_CLIENTS, SERVE_K, SERVE_EXCLUDE, SERVE_USERS = 8, 10, 50, 256
SERVE_MAX_B = SERVE_KW["max_batch"]  # the top-K batch timed on its own
SERVE_CHECKED = 4  # answers each client keeps for the oracle, so 32 in all
SERVE_RATE_STEPS, SERVE_RATE_REPEATS = 128, 3
ISOLATION_AT, ISOLATION_STEPS = 4, 8  # publish at step 4, compare after 8 more steps
# The oracle's float64 scores against the engine's (float64 sums rounded
# once to float32): scores rtol 1e-6 and atol 1e-6 of the largest |score|;
# ids must agree wherever neighbouring oracle scores are further apart
# than 1e-6 of the largest |score| (closer ones may round to one float32).
SERVE_RTOL, SERVE_GAP = 1e-6, 1e-6


def _serving_clients(service, users, excluded, done, seed):
    """SERVE_CLIENTS threads sending ``top_k(k=SERVE_K)`` in a closed loop
    until ``done`` is set, every other query with a (SERVE_EXCLUDE,)
    exclusion list (the user's top items on the pre-training tables).
    Returns (threads, record): ``record`` gathers each answer's latency,
    version and staleness; a uniform sample of SERVE_CHECKED answers a
    client, each with the snapshot it was answered from (answers for which
    the latest snapshot was the same object before the query and after the
    answer, with the answer's version); and any exception a query raised."""
    import threading

    record = {"lat": [], "version": [], "stale": [], "checked": [], "errors": []}
    lock = threading.Lock()

    def loop(i):
        rng = np.random.default_rng(seed + i)
        client = service.client()
        n, eligible, kept = 0, 0, []
        try:
            while not done.is_set():
                j = int(rng.integers(len(users)))
                exclude = tuple(excluded[j]) if n % 2 else ()
                before = service.snapshots.latest()
                t0 = time.perf_counter()
                ans = client.top_k(int(users[j]), SERVE_K, exclude=exclude, timeout=60)
                lat = time.perf_counter() - t0
                after = service.snapshots.latest()
                with lock:
                    record["lat"].append(lat)
                    record["version"].append(ans.version)
                    record["stale"].append(ans.staleness)
                if before is after and ans.version == before.version:
                    # a reservoir sample of the client's answers over the run
                    eligible += 1
                    slot = len(kept) if len(kept) < SERVE_CHECKED else int(rng.integers(eligible))
                    if slot < SERVE_CHECKED:
                        kept[slot:slot + 1] = [(int(users[j]), exclude, ans, before)]
                n += 1
        except BaseException as e:  # noqa: BLE001 — re-raised by the caller
            with lock:
                record["errors"].append(e)
        with lock:
            record["checked"] += kept

    threads = [threading.Thread(target=loop, args=(i,), name=f"serving-client-{i}") for i in range(SERVE_CLIENTS)]
    return threads, record


def _train_while_serving(torch, dev, users, excluded, stream, serve=True):
    """One StreamingDriver run over ``stream`` at the main path's width, with
    a service and SERVE_CLIENTS clients (``serve``) or without.  Returns
    (driver, service or None, result, seconds run() took, client record,
    seconds the clients ran, {span name: median ms} of the driver's host
    spans in this run)."""
    import threading

    from flink_parameter_server_tpu_torch.telemetry import get_tracer

    _, _, drv = _driver_parts(torch, dev)
    get_tracer().clear()
    service = drv.serve_with(**SERVE_KW) if serve else None
    out, failure = {}, []

    def train():
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out["result"] = drv.run(stream)
            torch.cuda.synchronize()
            out["seconds"] = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 — re-raised below
            failure.append(e)

    trainer = threading.Thread(target=train, name="trainer")
    done = threading.Event()
    threads, record = [], None
    trainer.start()
    try:
        if serve:
            check(service.wait_for_snapshot(120, min_version=2), "no mid-training snapshot within 120 s")
            threads, record = _serving_clients(service, users, excluded, done, seed=100)
            t0 = time.perf_counter()
            for t in threads:
                t.start()
    finally:
        trainer.join(timeout=600)
        done.set()
        for t in threads:
            t.join(timeout=120)
    client_s = time.perf_counter() - t0 if serve else 0.0
    check(not trainer.is_alive() and not any(t.is_alive() for t in threads), "a thread did not finish")
    if failure:
        raise SmokeFailure(f"the training thread raised {type(failure[0]).__name__}: {failure[0]}")
    if record is not None and record["errors"]:
        e = record["errors"][0]
        raise SmokeFailure(f"{len(record['errors'])} queries raised, first {type(e).__name__}: {e}")
    if service is not None:
        check(service.dispatch_errors == 0, f"the dispatch loop failed {service.dispatch_errors} batches")
    spans = {}
    for sp in get_tracer().spans():
        spans.setdefault(sp["name"], []).append(sp["dur"] * 1e3)
    medians = {name: statistics.median(d) for name, d in spans.items()}
    return drv, service, out["result"], out["seconds"], record, client_s, medians


def _against_oracle(ans, table, uvec, exclude) -> bool:
    """One top-K answer against the float64 oracle on the CPU: ``table`` and
    ``uvec`` are the snapshot's item table and the user's vector as float64
    numpy; excluded ids are masked, then a stable descending sort.  Returns
    whether the exclusions removed an item of the unexcluded top-k."""
    check(not set(exclude) & set(int(i) for i in ans.item_ids), "an excluded id was answered")
    s = table @ uvec
    plain = np.argsort(-s, kind="stable")[:SERVE_K]
    if exclude:
        s[list(exclude)] = -np.inf
    order = np.argsort(-s, kind="stable")[:SERVE_K + 1]
    top = s[order]
    scale = float(np.abs(top).max())
    check(np.allclose(ans.scores, top[:SERVE_K], rtol=SERVE_RTOL, atol=SERVE_RTOL * scale),
          f"answer scores {ans.scores} differ from the oracle's {top[:SERVE_K]}")
    gaps = np.abs(np.diff(top)) > SERVE_GAP * scale
    for j in range(SERVE_K):
        if gaps[j] and (j == 0 or gaps[j - 1]):
            check(int(ans.item_ids[j]) == int(order[j]), f"answer ids {ans.item_ids} vs oracle {order[:SERVE_K]}")
    if gaps[SERVE_K - 1]:
        check(set(int(i) for i in ans.item_ids) == set(order[:SERVE_K].tolist()), "answer id set differs")
    return bool(set(plain.tolist()) & set(exclude))


def _oracle_check(record):
    """Each kept mid-training answer against the oracle over ITS OWN
    snapshot."""
    table, version, versions, checked, bitten = None, None, set(), 0, 0
    for user, exclude, ans, snap in sorted(record["checked"], key=lambda c: c[2].version):
        check(ans.version >= 2 and ans.staleness >= 0, f"answer version {ans.version} staleness {ans.staleness}")
        if snap.version != version:
            table, version = snap.table[:NUM_ITEMS].cpu().double().numpy(), snap.version
            versions.add(version)
            check(np.isfinite(table).all(), f"snapshot v{version}'s item table is not finite: the job diverged")
        uvec = snap.aux[user].cpu().double().numpy()
        check(np.isfinite(uvec).all(), f"snapshot v{snap.version}'s vector of user {user} is not finite")
        bitten += _against_oracle(ans, table, uvec, exclude)
        checked += 1
    check(checked >= 20, f"only {checked} mid-training answers were checked against the oracle")
    return checked, len(versions), bitten


def _serving_breakdown(torch, service, store, user_vectors, users, exclude, card):
    """Where a served batch's time goes, with no trainer beside it: the
    admission-to-answer latency the service recorded in the counted run;
    the host time of ``QueryEngine.top_k`` for 64 users (the answer read
    back included), with and without exclusions; and the device time of
    one 64-query top-K batch by kernel (torch.profiler, 8 batches)."""
    from torch.profiler import ProfilerActivity, profile

    from flink_parameter_server_tpu_torch.models.topk_recommender import query_topk

    lat = service.metrics.latency_percentiles()
    host = {}
    for name, excl in (("plain", None), ("excluding", exclude.cpu().numpy())):
        times = []
        for _ in range(12):
            t0 = time.perf_counter()
            service.engine.top_k(users.cpu().numpy(), SERVE_K, exclude=excl)
            times.append((time.perf_counter() - t0) * 1e3)
        host[name] = statistics.median(times[2:])
    print(f"serving: admission to answer in the counted run (the service's last {service.metrics.window}): "
          f"p50 {lat['p50'] * 1e3:.3f} ms p99 {lat['p99'] * 1e3:.3f} ms; QueryEngine.top_k of {users.numel()} "
          f"users alone, host clock to the answer on the host: {host['plain']:.3f} ms, excluding "
          f"{host['excluding']:.3f} ms; {card}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            query_topk(store, user_vectors, users, SERVE_K, exclude=exclude)
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages() if ev.self_device_time_total > 0 and "#" not in ev.key]
    busy = sum(ev.self_device_time_total for ev in kernels) / 1e3 / 8
    print(f"serving: device time of one excluding top-{SERVE_K} batch by kernel (torch.profiler, 8 batches): "
          f"{busy:.4f} ms in all")
    for ev in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"serving:   device {ev.self_device_time_total / 1e3 / 8:8.4f} ms a batch  {ev.count // 8:3d}x  "
              f"{ev.key[:90]}")


def phase_serving(torch, dev, card):
    """Train-while-serve at the main path's full width: StreamingDriver
    (100,000 x 131,072, dim 64, scatter_impl="pallas", SGDUpdater(0.01))
    over a pool of 32 seeded 65,536-rating Zipf microbatches cycled for
    400 steps, through ``serve_with(publish_every=4, max_batch=64,
    max_delay_ms=2.0, max_queue=512)``, with 8 client threads sending
    ``top_k(k=10)``, half of them with a 50-id exclusion list.  Checks:
    mid-training answers against a float64 oracle on their own snapshots,
    snapshot isolation while K1 writes the live table, the final answer
    against query_topk, make_mf_topk_step at full width against
    dense_topk, a TCP round trip, no dispatch error, K1 once a step and no
    other kernel.  Prints QPS, latency, staleness, fill, rejections,
    publish ms, the top-K batch's device ms beside its bound, and updates/s
    with and without serving (3 runs of each, in turns)."""
    from flink_parameter_server_tpu_torch.core.transform import to_device
    from flink_parameter_server_tpu_torch.models.topk_recommender import make_mf_topk_step, query_topk
    from flink_parameter_server_tpu_torch.ops.rows import take_rows
    from flink_parameter_server_tpu_torch.ops.topk import dense_topk
    from flink_parameter_server_tpu_torch.serving import ServingServer, SnapshotManager
    from flink_parameter_server_tpu_torch.serving.server import tcp_request

    pool = zipf_stream(4, SERVE_POOL)
    rng = np.random.default_rng(5)
    users = rng.choice(NUM_USERS, SERVE_USERS, replace=False)
    # exclusion lists: each user's top-50 on the pre-training tables, so
    # that an exclusion removes items that would have been answered
    logic, store, _ = _driver_parts(torch, dev)
    _, top50 = query_topk(store, logic.init_state(), torch.from_numpy(users).to(dev), SERVE_EXCLUDE)
    excluded = top50.cpu().numpy()

    # 1. the counted run: K1 once a step, no other kernel
    zero_counts()
    drv, service, result, run_s, record, client_s, spans = _train_while_serving(
        torch, dev, users, excluded, itertools.islice(itertools.cycle(pool), SERVE_STEPS))
    steps = drv.step_idx
    read_counts("train-while-serve", {"scatter_add": steps})
    n = len(record["lat"])
    lat = np.array(record["lat"]) * 1e3
    stale = np.array(record["stale"])
    metrics = service.metrics
    print(f"serving: train-while-serve {steps} steps of {BATCH} in {run_s:.3f} s "
          f"({steps * BATCH / run_s:.0f} updates/s), {n} top_k(k={SERVE_K}) answers from {SERVE_CLIENTS} clients "
          f"in {client_s:.3f} s: {n / client_s:.1f} queries/s; latency p50 {np.percentile(lat, 50):.3f} ms "
          f"p99 {np.percentile(lat, 99):.3f} ms (client side); {card}")
    print(f"serving: staleness mean {stale.mean():.3f} max {int(stale.max())} steps; versions "
          f"{min(record['version'])}-{max(record['version'])} of {service.snapshots.latest().version}; "
          f"{metrics.total_batches} batches, fill {metrics.batch_fill():.3f} (last {metrics.window}), "
          f"{n / max(1, metrics.total_batches):.2f} queries a batch, {metrics.total_rejected} rejected, "
          f"dispatch errors {service.dispatch_errors}; {card}")
    print(f"serving: the trainer's host spans in that run, medians: "
          f"{', '.join(f'{k} {v:.3f} ms' for k, v in sorted(spans.items()))}; {card}")
    checked, snaps, bitten = _oracle_check(record)
    print(f"serving: {checked} mid-training answers over {snaps} snapshots match the float64 oracle on "
          f"their own snapshot (rtol {SERVE_RTOL:g}, ids where gaps > {SERVE_GAP:g} of the top score); "
          f"{bitten} of the excluding ones lost an item of their unexcluded top-{SERVE_K}")

    # 2. the final answer: query_topk on the trained store and state, and
    # the oracle; the exclusions are each user's top-50 on the final table
    client = service.client()
    final = drv.store.values().cpu().double().numpy()
    for j in range(4):
        u = int(users[j])
        exclude = ()
        if j % 2:
            _, top50 = query_topk(drv.store, result.worker_state, torch.tensor([u], device=dev), SERVE_EXCLUDE)
            exclude = tuple(top50[0].tolist())
        got = client.top_k(u, SERVE_K, exclude=exclude)
        want_s, want_i = query_topk(drv.store, result.worker_state, torch.tensor([u], device=dev), SERVE_K,
                                    exclude=torch.tensor([exclude], device=dev) if exclude else None)
        check(np.array_equal(got.item_ids, want_i[0].cpu().numpy())
              and np.array_equal(got.scores, want_s[0].cpu().numpy()) and got.staleness == 0,
              f"the final answer for user {u} differs from query_topk on the trained store")
        bit = _against_oracle(got, final, result.worker_state[u].cpu().double().numpy(), exclude)
        check(bit == bool(exclude), "a final exclusion list did not remove the user's top items")
    print("serving: 4 final answers (2 excluding the user's top-50) equal query_topk on the trained store "
          "and the float64 oracle, staleness 0")

    # 3. one TCP round trip on 127.0.0.1
    server = ServingServer(service).start()
    try:
        u, exclude = int(users[1]), excluded[1]
        resp = tcp_request(server.host, server.port, f"topk {u} {SERVE_K} {','.join(str(e) for e in exclude)}")
        want = client.top_k(u, SERVE_K, exclude=tuple(exclude))
        check(resp["ok"] and resp["item_ids"] == want.item_ids.tolist()
              and np.allclose(resp["scores"], want.scores, rtol=1e-5), f"TCP topk answered {resp}")
        rows = [0, 17, NUM_ITEMS - 1]
        pulled = tcp_request(server.host, server.port, "pull " + ",".join(map(str, rows)))
        table = service.snapshots.latest().table
        check(pulled["ok"] and np.allclose(np.array(pulled["values"]), table[rows].cpu().numpy(), rtol=1e-5),
              "TCP pull differs from the snapshot's rows")
    finally:
        server.stop()
    print(f"serving: TCP on 127.0.0.1:{server.port}: topk with {len(exclude)} exclusions and pull of 3 rows "
          f"answered as the in-process client and the snapshot")

    # 4. costs: a publish (clone of the table and the user state, then the
    # sync), and one 64-query top-K batch on the card beside its bound
    snap = service.snapshots.latest()
    mgr = SnapshotManager(drv.store.spec)
    times = []
    for i in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.publish(drv.store.table, i, aux=result.worker_state)
        times.append((time.perf_counter() - t0) * 1e3)
    mib = (drv.store.table.numel() + result.worker_state.numel()) * 4 / 2**20
    print(f"serving: publish (clone of the {drv.store.table.numel() * 4 / 2**20:.1f} MiB table and the "
          f"{result.worker_state.numel() * 4 / 2**20:.1f} MiB user state, then the stream sync): median "
          f"{statistics.median(times[2:]):.3f} ms, spread {min(times[2:]):.3f}-{max(times[2:]):.3f} over 10 "
          f"({mib:.1f} MiB copied); {card}")
    del mgr
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    q_users = torch.from_numpy(users[:SERVE_MAX_B]).to(dev)
    q_excl = torch.from_numpy(excluded[:SERVE_MAX_B]).to(dev)
    snap_store = snap.store()
    plain_ms = gpu_ms(torch, lambda: query_topk(snap_store, snap.aux, q_users, SERVE_K), flush)
    excl_ms = gpu_ms(torch, lambda: query_topk(snap_store, snap.aux, q_users, SERVE_K, exclude=q_excl), flush)
    queries = take_rows(snap.aux, q_users)
    f32_ms = gpu_ms(torch, lambda: torch.topk(queries @ snap.table.T, SERVE_K), flush)
    nbytes = snap.table.numel() * 4
    flops = 2 * SERVE_MAX_B * DIM_UNFUSED * NUM_ITEMS
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_OPS_PER_S) * 1e3
    print(f"serving: one {SERVE_MAX_B}-query top-{SERVE_K} batch over ({NUM_ITEMS},{DIM_UNFUSED}) f32 on the "
          f"card: {plain_ms:.4f} ms, with ({SERVE_MAX_B},{SERVE_EXCLUDE}) exclusions {excl_ms:.4f} ms; bound "
          f"{bound:.4f} ms (larger of {nbytes} B at 3.35 TB/s and {flops} flop at 67 TFLOP/s); yardstick "
          f"float32 torch.matmul + torch.topk (no float64 sums, no tie order) {f32_ms:.4f} ms; {card}")
    del flush
    _serving_breakdown(torch, service, snap_store, snap.aux, q_users, q_excl, card)

    # 5. snapshot isolation: publish at step 4, clone the live tensors then,
    # and after 8 more K1 steps the snapshot equals the clone, not the live
    held = {}

    def isolation(step, n_steps, table, state, outs):
        if step == ISOLATION_AT:
            held["snap"] = service_i.snapshots.latest()
            held["table"], held["state"] = table.clone(), state.clone()
        elif step == ISOLATION_AT + ISOLATION_STEPS:
            snap_i = held["snap"]
            held["frozen"] = torch.equal(snap_i.table, held["table"]) and torch.equal(snap_i.aux, held["state"])
            held["moved"] = not torch.equal(snap_i.table, table) and not torch.equal(snap_i.aux, state)
            held["version"], held["train_step"] = snap_i.version, snap_i.train_step

    _, _, drv_i = _driver_parts(torch, dev)
    service_i = drv_i.serve_with(**SERVE_KW)
    drv_i.add_group_hook(isolation)
    zero_counts()
    drv_i.run(iter(pool[:ISOLATION_AT + ISOLATION_STEPS]))
    torch.cuda.synchronize()
    service_i.stop()
    read_counts("snapshot isolation run", {"scatter_add": ISOLATION_AT + ISOLATION_STEPS})
    check("frozen" in held, "the isolation hook never reached its second step")
    print(f"serving: snapshot v{held['version']} (step {held['train_step']}) after {ISOLATION_STEPS} more K1 "
          f"steps: bitwise equal to the clone taken at publish: {'yes' if held['frozen'] else 'NO'}; differs "
          f"from the live table and state: {'yes' if held['moved'] else 'NO'}")
    check(held["train_step"] == ISOLATION_AT and held["frozen"] and held["moved"], "snapshot isolation failed")

    # 6. make_mf_topk_step at full width: answers from the pre-push table
    logic, store, _ = _driver_parts(torch, dev)
    state = logic.init_state()
    step = make_mf_topk_step(logic, store.spec, SERVE_K)
    batch = dict(to_device(pool[0], dev), query_user=q_users)
    table = store.table
    pre = table.clone()
    zero_counts()
    table, state, out = step(table, state, batch)
    torch.cuda.synchronize()
    read_counts("make_mf_topk_step", {"scatter_add": 1})
    want_s, want_i = dense_topk(pre, take_rows(state, q_users), SERVE_K, valid_rows=NUM_ITEMS)
    same = torch.equal(out["topk_ids"], want_i) and torch.equal(out["topk_scores"], want_s)
    print(f"serving: make_mf_topk_step ({SERVE_MAX_B} query users, one {BATCH}-rating step): top-{SERVE_K} "
          f"equal to dense_topk on the pre-push table: {'yes' if same else 'NO'}; table pushed: "
          f"{'yes' if not torch.equal(pre, table) else 'NO'}")
    check(same and not torch.equal(pre, table), "make_mf_topk_step disagrees with dense_topk on the pre-push table")
    service.stop()

    # 7. updates/s with serving against the same steps without, in turns
    rates = {"with serving": [], "without serving": []}
    step_spans = {"with serving": [], "without serving": []}
    for i in range(SERVE_RATE_REPEATS):
        order = (True, False) if i % 2 == 0 else (False, True)
        for serve in order:
            stream = iter([pool[j % SERVE_POOL] for j in range(SERVE_RATE_STEPS)])
            _, svc, _, secs, rec, c_s, spans = _train_while_serving(torch, dev, users, excluded, stream, serve)
            rates["with serving" if serve else "without serving"].append(SERVE_RATE_STEPS * BATCH / secs)
            step_spans["with serving" if serve else "without serving"].append(spans["pull_compute_push"])
            if svc is not None:
                print(f"serving: rate run {i}: {len(rec['lat'])} answers in {c_s:.3f} s beside "
                      f"{SERVE_RATE_STEPS} steps in {secs:.3f} s")
                svc.stop()
    for name, r in rates.items():
        print(f"serving: trainer {name}: {SERVE_RATE_STEPS} steps of {BATCH}, median {statistics.median(r):.0f} "
              f"updates/s, spread {min(r):.0f}-{max(r):.0f} over {len(r)} runs; median pull_compute_push span "
              f"by run {[round(x, 3) for x in step_spans[name]]} ms; {card}")


WL_STEPS, WL_TRACED = 8, 4  # counted steps an arm; steps traced with torch.profiler, last of the script
# BASELINE configs 2-4 at the shapes benchmarks/baseline_configs.py gives the TPU, and the sketches at
# examples/streaming_sketches.py:115-133's widths over 65,536-token microbatches
WL_FULL = dict(
    pa=dict(F=2_000_000, B=65_536, K=32, C=4),  # :137-176; C = tests/test_passive_aggressive.py's class count
    sgns=dict(V=1_000_000, dim=128, B=32_768, N=5),  # :179-215
    fm=dict(F=4_194_304, dim=16, K=39, B=32_768),  # :218-256, Criteo's 39 fields
    sketch=dict(vocab=1_000_000, T=65_536, cm=(8192, 4), bloom=(1 << 15, 4), tow=(8, 32)),
)
WL_SMALL = dict(  # the reduced widths held against the CPU
    pa=dict(F=5_000, B=1_024, K=8, C=4),
    sgns=dict(V=3_000, dim=16, B=512, N=5),
    fm=dict(F=10_000, dim=4, K=6, B=512),
    sketch=dict(vocab=5_000, T=2_048, cm=(256, 4), bloom=(1024, 4), tow=(4, 8)),
)
# Step sizes: every duplicate id's deltas in a microbatch are summed, so at these widths the bench's
# PA-I C=1, FM lr 0.01 and SGNS lr 0.025 move a Zipf-hot row by its count times one example's step and
# diverge in a few steps.  These keep 8 steps stable: PA-I's aggressiveness, FM's and SGNS's rates.
PA_AGGR, FM_LR, SG_LR = 2e-6, 1e-5, 0.005
WL_FAMILIES = (("K1 pass 1", ("scatter_tile_pass",)), ("K1 pass 2", ("combine_spanning_runs",)),
               ("sort", ("sort", "radix")), ("gather/scatter", ("index", "gather", "scatter")),
               ("copy", ("copy", "memcpy", "memset")))


def _planted_sparse(rng, B, K, F, zipf_a, w_true, steps, classes=0):
    """Sparse examples (Zipf ids, normal values) labelled by a planted
    linear model: ±1 by the sign of the score, or the argmax class."""
    out = []
    for _ in range(steps):
        ids = ((rng.zipf(zipf_a, (B, K)) - 1) % F).astype(np.int32)
        x = rng.normal(0, 1, (B, K)).astype(np.float32)
        score = np.einsum("bk,bk...->b...", x, w_true[ids])
        label = score.argmax(1).astype(np.int32) if classes else np.where(score >= 0, 1.0, -1.0).astype(np.float32)
        out.append({"ids": ids, "values": x, "feat_mask": np.ones((B, K), bool), "label": label,
                    "mask": np.ones(B, bool)})
    return out


def _workload_specs(size, steps, seed=0):
    """Each workload as its users build it: logic, store factory, seeded
    stream, pallas layouts, unit, and the check that it learned."""
    from flink_parameter_server_tpu_torch import ShardedParamStore
    from flink_parameter_server_tpu_torch.data.text import cooccurrence_pairs, synthetic_corpus
    from flink_parameter_server_tpu_torch.models import factorization_machine as fm
    from flink_parameter_server_tpu_torch.models import passive_aggressive as pa
    from flink_parameter_server_tpu_torch.models import sketches as sk
    from flink_parameter_server_tpu_torch.models import word2vec as w2v
    from flink_parameter_server_tpu_torch.utils.initializers import zeros

    rng = np.random.default_rng(seed)
    p, s, f, t = size["pa"], size["sgns"], size["fm"], size["sketch"]
    rule = pa.PARule("PA-I", C=PA_AGGR)
    fm_cfg = fm.FMConfig(num_features=f["F"], dim=f["dim"], learning_rate=FM_LR)
    tokens = synthetic_corpus(t["vocab"], steps * t["T"], zipf_a=1.3, seed=seed)
    token_batches = [{"key": tokens[i * t["T"]:(i + 1) * t["T"]], "mask": np.ones(t["T"], bool)} for i in range(steps)]
    pairs = list(itertools.islice(cooccurrence_pairs(tokens[:steps * t["T"] // 2 + 2], window=2, batch_size=t["T"]),
                                  steps))
    cm = sk.CountMinSketch(sk.CountMinConfig(width=t["cm"][0], depth=t["cm"][1], seed=0))
    bloom = sk.BloomCooccurrence(sk.CountMinConfig(width=t["bloom"][0], depth=t["bloom"][1], seed=1))
    tow = sk.TugOfWarSketch(sk.TugOfWarConfig(groups=t["tow"][0], per_group=t["tow"][1], seed=2))
    both = ("dense", "packed")
    return [
        dict(name="PA binary", unit="examples", per_step=p["B"], layouts=both, learn="loss",
             logic=pa.PassiveAggressiveBinary(rule),
             store=lambda impl, layout, dev: ShardedParamStore.create(
                 p["F"], (), init_fn=zeros(()), scatter_impl=impl, layout=layout, device=dev),
             stream=_planted_sparse(rng, p["B"], p["K"], p["F"], 1.3, rng.normal(0, 1, p["F"]).astype(np.float32),
                                    steps)),
        dict(name=f"PA multiclass C={p['C']}", unit="examples", per_step=p["B"], layouts=("dense",), learn="loss",
             classes=p["C"],
             logic=pa.PassiveAggressiveMulticlass(p["C"], rule),
             store=lambda impl, layout, dev: ShardedParamStore.create(
                 p["F"], (p["C"],), init_fn=zeros((p["C"],)), scatter_impl=impl, layout=layout, device=dev),
             stream=_planted_sparse(rng, p["B"], p["K"], p["F"], 1.3,
                                    rng.normal(0, 1, (p["F"], p["C"])).astype(np.float32), steps, classes=p["C"])),
        dict(name="SGNS", unit="pairs", per_step=s["B"], layouts=("dense",), learn="loss",
             logic=w2v.SkipGramNS(SG_LR),
             store=lambda impl, layout, dev: w2v.make_store(s["V"], s["dim"], seed=0, scatter_impl=impl,
                                                            layout=layout, device=dev),
             stream=[{"center": ((rng.zipf(1.3, s["B"]) - 1) % s["V"]).astype(np.int32),
                      "context": ((rng.zipf(1.3, s["B"]) - 1) % s["V"]).astype(np.int32),
                      "negatives": rng.integers(0, s["V"], (s["B"], s["N"])).astype(np.int32),
                      "mask": np.ones(s["B"], bool)} for _ in range(steps)]),
        dict(name="FM", unit="examples", per_step=f["B"], layouts=("packed", "dense"), learn="loss",
             logic=fm.FactorizationMachine(fm_cfg),
             store=lambda impl, layout, dev: fm.make_store(fm_cfg, seed=0, scatter_impl=impl, layout=layout,
                                                           device=dev),
             stream=_planted_sparse(rng, f["B"], f["K"], f["F"], 1.2, rng.normal(0, 1, f["F"]).astype(np.float32),
                                    steps)),
        dict(name="count-min", unit="tokens", per_step=t["T"], layouts=both, learn="counts", logic=cm,
             store=lambda impl, layout, dev: cm.make_store(scatter_impl=impl, layout=layout, device=dev),
             stream=token_batches),
        dict(name="Bloom pairs", unit="pairs", per_step=t["T"], layouts=both, learn="cells", logic=bloom,
             store=lambda impl, layout, dev: bloom.make_store(scatter_impl=impl, layout=layout, device=dev),
             stream=pairs),
        dict(name="tug-of-war", unit="tokens", per_step=t["T"], layouts=both, learn="signs", logic=tow,
             store=lambda impl, layout, dev: tow.make_store(scatter_impl=impl, layout=layout, device=dev),
             stream=token_batches),
    ]


def _exact(spec) -> bool:
    return spec["learn"] in ("counts", "cells", "signs")


def _learned(torch, spec, store, losses, accuracy, dev):
    """The learning check of each workload after its counted run: the
    mean loss of the last step below the first's (for the multiclass PA
    also the accuracy of the last step's predictions, taken before its
    update, above the first's); sketch tables equal to a numpy oracle."""
    from flink_parameter_server_tpu_torch.ops.hashing import sign_hash

    name, logic, stream = spec["name"], spec["logic"], spec["stream"]
    if spec["learn"] == "loss":
        ok = all(np.isfinite(losses)) and losses[-1] < losses[0]
        print(f"workloads: {name}: mean loss by step {[round(x, 5) for x in losses]} "
              f"{'falls' if ok else 'DOES NOT FALL'}")
        check(ok, f"{name} loss did not fall")
        if accuracy:
            ok = accuracy[-1] > accuracy[0]
            print(f"workloads: {name}: accuracy by step {[round(x, 4) for x in accuracy]} "
                  f"{'rises' if ok else 'DOES NOT RISE'}")
            check(ok, f"{name} accuracy did not rise")
        return
    table = store.values().double().cpu().numpy()
    oracle = np.zeros(table.shape, np.float64)
    if spec["learn"] == "signs":  # z_j = sum over tokens of s_j(token)
        for b in stream:
            oracle += sign_hash(torch.from_numpy(b["key"]).to(dev), logic._a, logic._b).double().sum(0).cpu().numpy()
        counts = np.bincount(np.concatenate([b["key"] for b in stream])).astype(np.float64)
        print(f"workloads: {name}: F2 estimate {float(logic.estimate_f2(store)):.6g} against the stream's "
              f"{float((counts**2).sum()):.6g}")
    else:  # one count per token (pair) in each depth row's cell
        for b in stream:
            cells = logic.keys({k: torch.from_numpy(v).to(dev) for k, v in b.items()}).cpu().numpy()
            np.add.at(oracle, cells[b["mask"]].ravel(), 1.0)
    same = bool(np.array_equal(table, oracle))
    print(f"workloads: {name}: table equal to a numpy np.add.at oracle over the port's own hashed cells: "
          f"{'yes' if same else 'NO'} ({int(oracle.sum())} total)")
    check(same, f"{name} table differs from its oracle")
    if spec["learn"] == "counts":
        keys = np.concatenate([b["key"] for b in stream])
        uniq, true = np.unique(keys, return_counts=True)
        est = logic.query(store, torch.from_numpy(uniq).to(dev)).cpu().numpy()
        ok = bool((est >= true).all())
        print(f"workloads: {name}: estimates of all {len(uniq)} distinct tokens >= their true counts: "
              f"{'yes' if ok else 'NO'} (largest overestimate {float((est - true).max()):.0f})")
        check(ok, f"{name} underestimates a count")


def _arms_agree(torch, what, got, want, ref64):
    """The pallas arm's table after its first step against the xla arm's,
    at K1's bar plus the xla arm's own distance from the float64 sums of
    that push (``ref64``): the xla arm sums a hot run in float32 in one
    long sequence, which errs past the bar at these run lengths, while
    K1's partial sums stay within it (``_k1_checks``)."""
    check(got.shape == want.shape == ref64.shape, f"{what}: table shapes differ")
    got, want, ref64 = got.double().cpu(), want.double().cpu(), ref64.cpu()
    slack = (want - ref64).abs()
    diff = (got - want).abs()
    ok = bool((diff <= 1e-5 * want.abs() + 1e-5 * float(want.abs().max()) + slack).all())
    print(f"workloads: {what}: max_abs_err={float(diff.max()):.3e} (rtol=1e-5 atol=1e-5 of max, plus the xla arm's "
          f"own error against float64 sums, at most {float(slack.max()):.3e}; K1's "
          f"{float((got - ref64).abs().max()):.3e}) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{what} disagree")


def _capture_k1(torch, fn):
    """The (table before, sorted ids, sorted deltas, sub_k) of each K1
    call ``fn`` makes: its real inputs, for the checks and the timings."""
    from flink_parameter_server_tpu_torch.ops import scatter_kernel

    orig, seen = scatter_kernel.sorted_scatter_add, []

    def spy(table, ids, deltas, *, sub_k=1):
        seen.append((table.clone(), ids.clone(), deltas.clone(), sub_k))
        return orig(table, ids, deltas, sub_k=sub_k)

    # the wrapper counts on the module's name, which is the spy meanwhile
    spy.launches = orig.launches
    scatter_kernel.sorted_scatter_add = spy
    try:
        fn()
    finally:
        scatter_kernel.sorted_scatter_add = orig
        orig.launches = spy.launches
    torch.cuda.synchronize()
    return seen


def _sum64(torch, table, ids, deltas, sub_k):
    """The scatter-add in float64: each touched row slice plus its deltas,
    summed by ``index_add_`` at float64 precision (its atomics' order moves
    the float64 sums by far less than a float32 unit)."""
    from flink_parameter_server_tpu_torch.ops import scatter_kernel

    out = table.double()
    cols = scatter_kernel._row_columns(ids, sub_k, deltas.shape[1], table.shape[1]).reshape(-1)
    out.view(-1).index_add_(0, cols, deltas.double().reshape(-1))
    return out


def _k1_checks(torch, gen, label, table, ids, deltas, sub_k, exact):
    """K1 against its plain version on the card at one shape, twice each:
    on the main path's own first push, then phase_kernels' style (random
    deltas, whole numbers for a sketch, the same ids permuted, 64 lanes
    negative, 64 past the end, 1 % masked, through sort_lanes).

    Float shapes are held at K1's bar (rtol 1e-5, atol 1e-5 of the largest
    value) against the same sums taken in float64 and rounded once: these
    pushes put up to half a million lanes on one row (a Zipf-hot feature),
    and the plain version's own float32 sums of such a run, in
    ``index_add_``'s order, err past that bar.  Its distance from the
    float64 sums and from K1 is printed beside.  Sketch shapes (whole
    numbers) are exact against the plain version."""
    from flink_parameter_server_tpu_torch.ops import scatter_kernel

    err = 0.0
    n, d = deltas.shape
    rows = table.shape[0]
    perm = torch.randperm(n, generator=gen, device=ids.device)
    raw = ids.long()[perm]
    raw[:64] = -1
    raw[64:128] = rows * sub_k + 5
    if exact:
        synth = torch.randint(-1, 2, (n, d), generator=gen, device=ids.device).to(table.dtype)
    else:
        synth = (torch.randn(n, d, generator=gen, device=ids.device) * float(deltas.abs().max() + 1e-3)).to(table.dtype)
    mask = torch.rand(n, generator=gen, device=ids.device) > 0.01
    s_ids, s_d = scatter_kernel.sort_lanes(raw, synth, mask, rows * sub_k, table.dtype)
    for what, (i, v) in (("first microbatch", (ids, deltas)), ("random deltas", (s_ids, s_d))):
        runs = [scatter_kernel.sorted_scatter_add(table.clone(), i, v, sub_k=sub_k) for _ in range(2)]
        want = scatter_kernel.run_sum_write_plain(table.clone(), i, v, sub_k=sub_k)
        torch.cuda.synchronize()
        same = bool(torch.equal(runs[0], runs[1]))
        print(f"check: scatter_add {label} ({what}): two runs on the same inputs bitwise equal: "
              f"{'ok' if same else 'MISMATCH'}")
        check(same, f"scatter_add {label} differs between two runs on the same inputs")
        if exact:
            err = max(err, _compare(torch, f"scatter_add {label} ({what})", runs[0], want, 0, 0, exact=True))
            continue
        exact64 = _sum64(torch, table, i, v, sub_k)
        err = max(err, _compare(torch, f"scatter_add {label} ({what}) vs float64 sums", runs[0],
                                exact64.float(), rtol=1e-5, atol=1e-5))
        plain = float((want.double() - exact64).abs().max())
        print(f"check: yardstick scatter_add {label} ({what}): the float32 plain version vs float64 sums "
              f"{plain:.3e}, vs K1 {float((want.double() - runs[0].double()).abs().max()):.3e}")
    return err


def _k1_timing(torch, label, table, ids, deltas, sub_k, flush):
    """K1's median time on the main path's first push, beside its bound
    (each delta and id read once, each touched row slice read and written
    once, over 3.35 TB/s), the plain version and ``index_add_`` on the
    element indices of the same slices (computed beforehand)."""
    from flink_parameter_server_tpu_torch.ops import scatter_kernel

    n, d = deltas.shape
    unique = int(torch.unique_consecutive(ids).numel())
    cols = scatter_kernel._row_columns(ids, sub_k, d, table.shape[1]).reshape(-1)
    flat = deltas.reshape(-1)
    k_ms = gpu_ms(torch, lambda: scatter_kernel.sorted_scatter_add(table, ids, deltas, sub_k=sub_k), flush)
    p_ms = gpu_ms(torch, lambda: scatter_kernel.run_sum_write_plain(table, ids, deltas, sub_k=sub_k), flush, reps=5)
    l_ms = gpu_ms(torch, lambda: table.view(-1).index_add_(0, cols, flat), flush)
    nbytes = n * d * deltas.element_size() + n * 4 + 2 * unique * d * table.element_size()
    ops = n * d + unique * d
    detail = (f"{label}: ({table.shape[0]},{table.shape[1]}) sub_k {sub_k}, {n} lanes of {d}, "
              f"{unique} unique ids")
    return detail, k_ms, p_ms, l_ms, nbytes, ops


def phase_workloads(torch, dev, card):
    """The other batched workloads at full width through their entry point,
    ``transform_batched`` over the logic's store with
    ``scatter_impl="pallas"``: PA binary (2,000,000 features, 65,536
    examples of 32, Zipf 1.3; dense and packed), PA multiclass (4 classes,
    dense), SGNS (1,000,000 x (2, 128), 32,768 pairs, 5 negatives), the FM
    (4,194,304 x 17, 32,768 examples of 39, Zipf 1.2; packed and dense),
    and count-min 8,192 x 4, Bloom pairs 32,768 x 4 and tug-of-war 8 x 32
    over 65,536-token microbatches (Zipf 1.3, vocabulary 1,000,000; dense
    and packed).  Each arm: K1 against its plain version on its first push
    and on random deltas (twice, bitwise); 8 counted steps (K1 once a step,
    no other kernel); the learning check; the rate; K1's time beside its
    bound.  Then the same stream with ``scatter_impl="xla"`` (no kernel),
    held against each pallas arm after the first step (sketches after all
    8, exactly; a float table's 8-step difference is printed, not held:
    the two arms sum hot runs in different orders, and 8 steps of the
    learning dynamics carry that on); a reduced-width run of each workload
    on the card against the CPU; and the event API's MF job on the card
    against the CPU.  Returns the kernels line's rows and the traces to
    take after every counted run of the script."""
    from flink_parameter_server_tpu_torch import ShardedParamStore
    from flink_parameter_server_tpu_torch.core.transform import make_train_step, to_device, transform_batched

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    rows, traces, launches, errs = [], [], {}, {}
    for spec in _workload_specs(WL_FULL, WL_STEPS):
        name, logic, stream, exact = spec["name"], spec["logic"], spec["stream"], _exact(spec)
        finals, firsts, refs = {}, {}, {}
        for impl, layout in [("pallas", lay) for lay in spec["layouts"]] + [("xla", "dense")]:
            arm = f"{name} scatter_impl={impl} layout={layout}"
            store = spec["store"](impl, layout, dev)
            if impl == "pallas":
                step = make_train_step(logic, store.spec)
                table, state = store.table.clone(), logic.init_state(None)
                (k1_in,) = _capture_k1(torch, lambda: step(table, state, to_device(stream[0], dev)))
                del table
                tbl, ids, deltas, sub_k = k1_in
                label = f"{name} {layout} d {deltas.shape[1]}" + (f" sub_k {sub_k}" if sub_k > 1 else "")
                row = f"scatter_add[{label}]"
                errs[row] = _k1_checks(torch, gen, label, tbl, ids, deltas, sub_k, exact)
                t64 = _sum64(torch, tbl, ids, deltas, sub_k).reshape(store.table.shape)
                refs[layout] = ShardedParamStore(store.spec, t64).values()
            losses, accuracy, stamps = [], [], []

            def on_step(i, out):
                if "loss" in out:
                    losses.append(float(out["loss"].float().mean()))  # synchronises
                if spec.get("classes"):
                    accuracy.append(float((out["prediction"].cpu().numpy() == stream[i]["label"]).mean()))
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())

            def first_step(i, table, state, out, spec_=store.spec, key=(impl, layout)):
                if i == 0:
                    firsts[key] = ShardedParamStore(spec_, table).values().clone()

            zero_counts()
            res = transform_batched(iter(stream), logic, store, on_step=on_step, state_callback=first_step,
                                    collect_outputs=False, dump_model=False)
            torch.cuda.synchronize()
            want = {"scatter_add": WL_STEPS} if impl == "pallas" else {}
            counts = read_counts(arm, want)
            rate = spec["per_step"] * (WL_STEPS - 1) / (stamps[-1] - stamps[0])
            step_ms = statistics.median((b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))
            print(f"workloads: {arm}: {WL_STEPS} steps of {spec['per_step']} {spec['unit']}, "
                  f"{rate:.0f} {spec['unit']}/s after the first step, median step {step_ms:.3f} ms; {card}")
            finals[(impl, layout)] = res.store.values()
            if impl == "pallas":
                launches[row] = counts["scatter_add"]
                _learned(torch, spec, res.store, losses, accuracy, dev)
                detail, k_ms, p_ms, l_ms, nbytes, ops = _k1_timing(torch, label, tbl, ids, deltas, sub_k, flush)
                print(f"workloads: {arm}: K1 {k_ms:.4f} ms a step against a bound of "
                      f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} B); {card}")
                rows.append(_row(row, "flink_parameter_server_tpu_torch/csrc/scatter_add.cu",
                                 "flink_parameter_server_tpu/ops/pallas_scatter.py:73", launches, errs,
                                 k_ms, p_ms, l_ms, nbytes, ops / F32_OPS_PER_S, detail))
                del tbl, ids, deltas, k1_in
                if layout == spec["layouts"][0]:
                    traces.append(_workload_trace(torch, spec, layout, dev, step_ms))
            del res, store
        for (impl, layout), vals in finals.items():
            if impl != "pallas":
                continue
            xla, what = finals[("xla", "dense")], f"{name} pallas {layout} vs xla dense"
            if exact:
                _compare(torch, f"{what}, {WL_STEPS} steps", vals, xla, 0, 0, exact=True)
                continue
            _arms_agree(torch, f"{what}, first step", firsts[(impl, layout)], firsts[("xla", "dense")], refs[layout])
            diff = float((vals.double() - xla.double()).abs().max())
            print(f"workloads: {what}, {WL_STEPS} steps (not held): max_abs_err={diff:.3e}, "
                  f"{diff / float(xla.abs().max()):.2e} of the largest value")
        del finals, firsts, refs
        torch.cuda.empty_cache()
    _small_workloads_match_cpu(torch, dev)
    _event_mf_matches_cpu(torch, dev, card)
    print(f"workloads: phase took {time.perf_counter() - t0:.1f} s")
    return rows, traces


def _workload_trace(torch, spec, layout, dev, step_ms):
    """A closure that traces WL_TRACED steps of the arm (after a set-up
    and a warm-up step) with torch.profiler: device time by family, K1's
    share, device busy and idle share against the counted run's median
    step."""
    from flink_parameter_server_tpu_torch.core.transform import transform_batched

    def trace():
        def drive(after_step):
            transform_batched(iter(spec["stream"][:WL_TRACED + 2]), spec["logic"], spec["store"]("pallas", layout, dev),
                              on_step=lambda i, out: after_step(out), collect_outputs=False, dump_model=False)

        _trace_steps(f"{spec['name']} ({layout}, pallas)", drive, step_ms, steps=WL_TRACED,
                        read=lambda out: torch.cuda.synchronize(), rules=WL_FAMILIES)

    return trace


def _small_workloads_match_cpu(torch, dev):
    """Each workload at reduced width, 3 steps with scatter_impl="pallas":
    on the card (K1) against the CPU (K1's plain version)."""
    from flink_parameter_server_tpu_torch.core.transform import transform_batched

    for spec in _workload_specs(WL_SMALL, 3, seed=1):
        layout = spec["layouts"][0]
        vals = [transform_batched(iter(spec["stream"]), spec["logic"], spec["store"]("pallas", layout, d),
                                  collect_outputs=False, dump_model=False).store.values() for d in (dev, "cpu")]
        _compare(torch, f"small {spec['name']} ({layout}) card vs cpu, 3 steps", vals[0].cpu(), vals[1],
                 rtol=1e-5, atol=1e-5, exact=_exact(spec))


EVENT_RATINGS, EVENT_DIM = 2_000, 64


def _event_mf_matches_cpu(torch, dev, card):
    """The event API's MF job: MFWorkerLogic (dim 64, SGDUpdater(0.01))
    over 2,000 ratings through ``transform`` with a SimplePSLogic store,
    on the card and on the CPU.  Predictions, item vectors and user vectors
    at rtol 1e-5 / atol 1e-7; records/s of each (host code: one pull, one
    push and a synchronising read of the prediction a record)."""
    from flink_parameter_server_tpu_torch import MFWorkerLogic, SGDUpdater, ranged_random_factor, transform

    rng = np.random.default_rng(4)
    ratings = [(int(u), int(i), float(r)) for u, i, r in zip(
        rng.integers(0, 500, EVENT_RATINGS), (rng.zipf(1.2, EVENT_RATINGS) - 1) % 4000,
        rng.normal(0, 1, EVENT_RATINGS))]
    init = ranged_random_factor(1, (EVENT_DIM,))
    runs = []
    for d in (dev, torch.device("cpu")):
        worker = MFWorkerLogic(EVENT_DIM, SGDUpdater(LEARNING_RATE), seed=0, device=d)
        t0 = time.perf_counter()
        res = transform(ratings, worker, param_init=lambda i, d=d: init(torch.tensor([i], device=d))[0],
                        param_update=lambda c, delta: c + delta)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(f"workloads: event API MFWorkerLogic dim {EVENT_DIM} on {d.type}: {EVENT_RATINGS} ratings in "
              f"{secs:.3f} s, {EVENT_RATINGS / secs:.0f} records/s; {card}")
        runs.append((res, worker))
    (card_res, card_w), (cpu_res, cpu_w) = runs
    check([o[:2] for o in card_res.worker_outputs] == [o[:2] for o in cpu_res.worker_outputs],
          "event MF outputs in another order on the card")
    pairs = [(torch.tensor([o[2] for o in card_res.worker_outputs]), torch.tensor([o[2] for o in cpu_res.worker_outputs])),
             (torch.stack([v.cpu() for _, v in card_res.server_outputs]), torch.stack([v for _, v in cpu_res.server_outputs])),
             (torch.stack([card_w.user_vectors[u].cpu() for u in sorted(card_w.user_vectors)]),
              torch.stack([cpu_w.user_vectors[u] for u in sorted(cpu_w.user_vectors)]))]
    err = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
    ok = all(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-7)) for a, b in pairs)
    print(f"workloads: event API MF card vs cpu: predictions, item and user vectors max_abs_err={err:.3e} "
          f"(rtol=1e-5 atol=1e-7) {'ok' if ok else 'MISMATCH'}")
    check(ok, "the event API's MF job on the card disagrees with the CPU")


CLUSTER_ROUNDS = 12  # only the run length is cut
CLUSTER_SHARDS, CLUSTER_WORKERS = 4, 2
CLUSTER_CRASH_ROUND, CLUSTER_SSP_BOUND, CLUSTER_PROCS = 6, 2, 2
CLUSTER_PROC_INIT = {"kind": "hashed_uniform", "scale": 0.01, "seed": 11}
CLUSTER_BAR = dict(rtol=1e-4, atol=1e-6)  # the reference's cluster parity bar


def _percentiles(prof, verb, n):
    """p50 / p99 (ms) of the first ``n`` per-frame round trips the
    clients timed on ``prof`` (the training rounds, not the final dump)."""
    vals = sorted(list(prof._site(verb, "rtt")[1])[:n])
    if not vals:
        return float("nan"), float("nan")
    return tuple(float(np.percentile(vals, q)) * 1e3 for q in (50, 99))


def _f64_errors(torch, dev, stream, init, logic, tables, base):
    """Each arm's largest error against a float64 run of the same sums,
    beside the float32 single-process table's: printed when an arm
    breaks the bar, for ROADMAP Queue 3."""
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.core.transform import transform_batched

    store = ShardedParamStore.create(NUM_ITEMS, (DIM_UNFUSED,), dtype=torch.float64,
                                     init_fn=lambda ids: init(ids).double(), device=dev)
    ref = transform_batched(stream, logic(torch.float64), store, dump_model=False,
                            collect_outputs=False).store.values().cpu().numpy()
    for name, vals in [("single-process float32", base)] + list(tables.items()):
        err = float(np.abs(vals.astype(np.float64) - ref).max())
        print(f"cluster: {name} against a float64 run of the same sums: max_abs_err={err:.3e}")


def phase_cluster(torch, dev, card):
    """The parameter-server cluster at the MF path's full width (100,000
    users x 131,072 items, dim 64, lr 0.01, 12 microbatches of 65,536
    Zipf-1.2 ratings, ``ranged_random_factor`` init; only the run length
    is cut), every arm through ``ClusterDriver`` on the card: socket BSP 4
    shards x 2 workers with range and hash partitions (every slice a CUDA
    tensor) held at the reference's bar (rtol 1e-4, atol 1e-6) against the
    single-process ``transform_batched`` of the same logic, init and
    stream; socket at 1 worker twice (bitwise) and with a supervised shard
    crash at round 6 over a WAL (bitwise); SSP bound 2 with a worker held
    back, and async; 2 shard processes against the thread-backed run over
    the same ``hashed_uniform`` init (bitwise); the mesh store (the table
    and the pulled rows CUDA tensors, 1 worker twice bitwise, 2 workers
    BSP at the bar, a store rebuilt over its WAL bitwise and
    ``verify_against_log()``).  A worker's round is split into pull, step
    and push in a separate range run, whose timers would slow the counted
    ones.  No kernel of the port launches: the cluster takes the store's
    ``"xla"`` arm, as the reference does."""
    import shutil
    import tempfile

    from flink_parameter_server_tpu_torch.cluster import ClusterConfig, ClusterDriver
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.core.transform import transform_batched
    from flink_parameter_server_tpu_torch.meshstore import MeshParamStore
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization, SGDUpdater,
    )
    from flink_parameter_server_tpu_torch.telemetry.profiler import PhaseProfiler, set_profiler
    from flink_parameter_server_tpu_torch.telemetry.registry import MetricsRegistry
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    t_phase = time.perf_counter()
    stream = zipf_stream(9, CLUSTER_ROUNDS)
    init = ranged_random_factor(1, (DIM_UNFUSED,))  # ps_online_mf's item init (seed + 1)
    pulled_on, timed = [], {}

    class Logic(OnlineMatrixFactorization):
        def step(self, state, batch, pulled):
            pulled_on.append(pulled.device.type if isinstance(pulled, torch.Tensor) else "host")
            if "step" not in timed:
                return super().step(state, batch, pulled)
            t0 = time.perf_counter()
            out = super().step(state, batch, pulled)
            torch.cuda.synchronize()
            timed["step"].append(time.perf_counter() - t0)
            return out

    def logic(dtype=torch.float32):
        return Logic(NUM_USERS, DIM_UNFUSED, updater=SGDUpdater(LEARNING_RATE), dtype=dtype, device=dev)

    def run(what, registry=False, init_fn=init, hook=None, inspect=None, **cfg):
        driver = ClusterDriver(logic(), capacity=NUM_ITEMS, value_shape=(DIM_UNFUSED,), init_fn=init_fn,
                               config=ClusterConfig(**cfg), registry=registry, device=dev)
        with driver:
            if inspect is not None:
                inspect(driver)
            r = driver.run(stream, round_hook=None if hook is None else (lambda w, t: hook(driver, w, t)))
            if cfg.get("store_backend") == "mesh" and cfg.get("wal_dir"):
                check(driver.mesh_store.verify_against_log(), f"{what}: verify_against_log() is False")
        rate = f"{r.rounds / r.wall_s:.2f} rounds/s, {r.updates_per_sec:.0f} updates/s"
        print(f"cluster: {what}: {r.rounds} rounds in {r.wall_s:.3f} s: {rate}; {card}")
        return r

    def on_card(what, tensors):
        check(all(t.device.type == dev.type for t in tensors), f"{what}: not every table is on {dev.type}")

    failures = []

    def at_bar(what, vals):
        err = float(np.abs(vals.astype(np.float64) - base).max())
        ok = bool(np.allclose(vals, base, **CLUSTER_BAR))
        print(f"cluster: {what} against the single-process table: max_abs_err={err:.3e} "
              f"(rtol=1e-4 atol=1e-6) {'ok' if ok else 'BREAKS THE BAR'}")
        if not ok:
            failures.append(what)

    def bitwise(what, a, b):
        same = a.tobytes() == b.tobytes()
        print(f"cluster: {what}: {'bitwise equal' if same else 'DIFFER'}")
        check(same, f"{what} are not bitwise equal")

    zero_counts()
    # the single-process table: the same logic, init and stream (timed
    # the second time)
    store = ShardedParamStore.create(NUM_ITEMS, (DIM_UNFUSED,), init_fn=init, device=dev)
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single = transform_batched(stream, logic(), store, dump_model=False, collect_outputs=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    base = single.store.values().cpu().numpy()
    del single, store
    print(f"cluster: single-process transform_batched: {CLUSTER_ROUNDS} rounds in {wall:.3f} s: "
          f"{CLUSTER_ROUNDS / wall:.2f} rounds/s, {CLUSTER_ROUNDS * BATCH / wall:.0f} updates/s; {card}")
    check(bool(np.isfinite(base).all()), "the single-process table is not finite")

    tables = {}
    for part in ("range", "hash"):
        what = f"socket {part} BSP {CLUSTER_SHARDS}x{CLUSTER_WORKERS}"
        prof = PhaseProfiler(MetricsRegistry(), reservoir=1 << 16)
        marks = {}

        def inspect(d, what=what, prof=prof, marks=marks):
            on_card(what, [s.store.table for s in d.shards])
            dump = d.final_values

            def final_values():  # mark where the training rounds' frames end
                marks.update({v: len(prof._site(v, "rtt")[1]) for v in ("pull", "push")})
                return dump()

            d.final_values = final_values

        set_profiler(prof)  # the clients time their frames on it
        try:
            r = run(what, registry=MetricsRegistry(), num_shards=CLUSTER_SHARDS, num_workers=CLUSTER_WORKERS,
                    staleness_bound=0, partition=part, inspect=inspect)
        finally:
            set_profiler(None)
        pull, push = _percentiles(prof, "pull", marks["pull"]), _percentiles(prof, "push", marks["push"])
        if part == "range":
            for verb in ("pull", "push"):
                b = prof.budget(verb)
                print(f"cluster: {what}: {verb} frame phases, mean ms over {b['rounds']} frames: " + ", ".join(
                    f"{ph['phase']} {ph['mean_ms']:.3f}" for ph in b["phases"]) + f"; {card}")
        rebuilds = sum(s["mirror_rebuilds"] for s in r.shard_stats)
        rebuild_s = sum(s["mirror_rebuild_s"] for s in r.shard_stats)
        print(f"cluster: {what}: client round trip a frame, pull p50 {pull[0]:.3f} ms p99 {pull[1]:.3f} ms, "
              f"push p50 {push[0]:.3f} ms p99 {push[1]:.3f} ms; host-mirror rebuild "
              f"{rebuild_s / max(1, rebuilds) * 1e3:.3f} ms each ({rebuilds} rebuilds, one copy of a "
              f"{NUM_ITEMS // CLUSTER_SHARDS}-row slice off the card); {card}")
        check(r.clock["clocks"] == [CLUSTER_ROUNDS] * CLUSTER_WORKERS and r.clock["staleness"] == 0,
              f"{what}: the clock did not run BSP: {r.clock}")
        tables[what] = r.values
        at_bar(what, r.values)

    # a round's parts, timed in a run of their own: the timers and the
    # synchronize after each step would slow the counted runs above
    def time_parts(d):
        timed.update(step=[], pull=[], push=[])
        for c in d._clients:
            for verb in ("pull", "push"):
                fn = getattr(c, f"{verb}_batch")

                def call(*a, fn=fn, verb=verb, **k):
                    t0 = time.perf_counter()
                    out = fn(*a, **k)
                    timed[verb].append(time.perf_counter() - t0)
                    return out

                setattr(c, f"{verb}_batch", call)

    what = f"socket range BSP {CLUSTER_SHARDS}x{CLUSTER_WORKERS}, a round's parts timed"
    r = run(what, num_shards=CLUSTER_SHARDS, num_workers=CLUSTER_WORKERS, staleness_bound=0, inspect=time_parts)
    n = CLUSTER_ROUNDS * CLUSTER_WORKERS
    parts = {k: sum(v[:n]) / n * 1e3 for k, v in timed.items()}
    timed.clear()
    rest = r.wall_s / CLUSTER_ROUNDS * 1e3 - sum(parts.values())  # the workers run side by side
    print(f"cluster: {what}: a worker's round, means over {n}: pull_batch {parts['pull']:.3f} ms, step "
          f"{parts['step']:.3f} ms (to its end on the card), push_batch {parts['push']:.3f} ms, the rest "
          f"(batch copy, keys, barrier, clock) {rest:.3f} ms; {card}")
    at_bar(what, r.values)

    one = run("socket 1 worker", num_shards=CLUSTER_SHARDS, num_workers=1).values
    bitwise("socket 1-worker runs", one, run("socket 1 worker, again", num_shards=CLUSTER_SHARDS,
                                            num_workers=1).values)
    tmp = tempfile.mkdtemp(prefix="cluster-", dir=os.path.join(REPO, "build"))
    try:
        def crash(driver, w, t):
            if t == CLUSTER_CRASH_ROUND:
                driver.shards[1].crash()

        r = run(f"socket 1 worker, shard 1 crashed at round {CLUSTER_CRASH_ROUND}", hook=crash,
                num_shards=CLUSTER_SHARDS, num_workers=1, wal_dir=os.path.join(tmp, "socket"))
        check(r.shard_stats[1]["restarts"] == 1, f"the crashed shard restarted {r.shard_stats[1]['restarts']} times")
        bitwise("crash -> supervised restart -> WAL replay against the uninterrupted run", r.values, one)

        held = {}

        def hold(driver, w, t):
            if w == 0 and t == 1:  # worker 0 waits until worker 1 is blocked at the bound
                clock, deadline = driver.clock, time.monotonic() + 120
                while not (clock.clocks()[1] == 1 + CLUSTER_SSP_BOUND + 1 and clock.block_counts[1]):
                    check(time.monotonic() < deadline, "SSP: the fast worker never reached the bound")
                    time.sleep(0.001)
                held["lead"] = clock.clocks()[1] - 1 - clock.clocks()[0]  # rounds started ahead
                held["gauge"] = clock.staleness()
                time.sleep(0.05)
                held["after"] = clock.clocks()[1]

        r = run(f"socket SSP bound {CLUSTER_SSP_BOUND}, worker 0 held at round 1", hook=hold,
                num_shards=CLUSTER_SHARDS, num_workers=2, staleness_bound=CLUSTER_SSP_BOUND)
        print(f"cluster: SSP: the fast worker started at most {held['lead']} rounds ahead and stopped "
              f"(staleness gauge {held['gauge']}, completed rounds then {held['after']}); "
              f"blocks {r.clock['block_counts']}")
        check(held["lead"] == CLUSTER_SSP_BOUND and held["gauge"] == CLUSTER_SSP_BOUND + 1
              and held["after"] == 1 + CLUSTER_SSP_BOUND + 1, f"SSP bound not held: {held}")
        check(r.clock["clocks"] == [CLUSTER_ROUNDS] * 2, f"the SSP run did not complete: {r.clock}")
        check(bool(np.isfinite(r.values).all()), "the SSP table is not finite")
        r = run("socket async", num_shards=CLUSTER_SHARDS, num_workers=2, staleness_bound=None)
        check(r.clock["block_counts"] == [0, 0] and r.clock["clocks"] == [CLUSTER_ROUNDS] * 2,
              f"the async run blocked or stopped: {r.clock}")
        check(bool(np.isfinite(r.values).all()), "the async table is not finite")

        procs = run(f"{CLUSTER_PROCS} shard processes, 1 worker", num_shards=CLUSTER_PROCS, num_workers=1,
                    shard_procs=True, proc_init=CLUSTER_PROC_INIT, init_fn=None)
        check([s["backend"] for s in procs.shard_stats] == ["numpy"] * CLUSTER_PROCS,
              "the shard processes do not run the numpy slice")
        threads = run(f"{CLUSTER_PROCS} shard threads, 1 worker", num_shards=CLUSTER_PROCS, num_workers=1,
                      proc_init=CLUSTER_PROC_INIT, init_fn=None,
                      inspect=lambda d: on_card("thread shards", [s.store.table for s in d.shards]))
        bitwise("shard processes against shard threads", procs.values, threads.values)

        del pulled_on[:]
        reg = MetricsRegistry()
        mesh = run("mesh 1 worker", registry=reg, store_backend="mesh", num_shards=CLUSTER_SHARDS,
                   num_workers=1, inspect=lambda d: on_card("mesh", [d.mesh_store.table]))
        check(set(pulled_on) == {dev.type}, f"the mesh handed the step rows on {set(pulled_on)}")
        scatter = [i for i in reg.instruments() if i.name == "meshstore_scatter_seconds"][0]
        gather = [i for i in reg.instruments() if i.name == "meshstore_gather_seconds"][0]
        print(f"cluster: mesh scatter {scatter.sum / scatter.count * 1e3:.3f} ms a push ({scatter.count}), "
              f"gather {gather.sum / gather.count * 1e3:.3f} ms a pull ({gather.count}), each to the end of "
              f"its device work; {card}")
        wal = os.path.join(tmp, "mesh")
        again = run("mesh 1 worker, again, over a WAL", store_backend="mesh", num_shards=CLUSTER_SHARDS,
                    num_workers=1, wal_dir=tmp)
        bitwise("mesh 1-worker runs", mesh.values, again.values)
        rebuilt = MeshParamStore(NUM_ITEMS, (DIM_UNFUSED,), init_fn=init, wal_dir=wal, registry=False, device=dev)
        bitwise("a MeshParamStore rebuilt over the WAL against the run", rebuilt.values(), again.values)
        check(rebuilt.verify_against_log(), "the rebuilt mesh store fails verify_against_log()")
        rebuilt.close()
        r = run(f"mesh BSP {CLUSTER_WORKERS} workers", store_backend="mesh", num_shards=CLUSTER_SHARDS,
                num_workers=CLUSTER_WORKERS)
        tables[f"mesh BSP {CLUSTER_WORKERS} workers"] = r.values
        at_bar(f"mesh BSP {CLUSTER_WORKERS} workers", r.values)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    read_counts("cluster", {})
    if failures:
        _f64_errors(torch, dev, stream, init, logic, tables, base)
    check(not failures, f"the cluster arms {failures} break the reference's bar (rtol 1e-4, atol 1e-6)")
    print(f"cluster: phase took {time.perf_counter() - t_phase:.1f} s; {card}")


SHMEM_AB = ("auto", "shm", "shm", "auto")  # the transport A/B's turns
SHMEM_WARMUP = 2  # rounds an A/B turn runs before its rate is counted
SHMEM_HOT = 256  # the hot-cache arm's fixed lease set: the stream's most frequent items
SHMEM_BOUND = 2  # the hot-cache arm's SSP bound (the hot-cache phase's)


def _shm_counts(reg) -> dict:
    """The shmem counters of one arm's registry, summed over labels:
    fallbacks by reason, borrows and spills."""
    out = {}
    for i in reg.instruments():
        if i.name == "shmem_fallbacks_total":
            key = f"fallback {i.labels.get('reason')}"
        elif i.name in ("shmem_borrows_total", "shmem_borrow_spills_total"):
            key = i.name[len("shmem_"):-len("_total")]
        else:
            continue
        out[key] = out.get(key, 0) + int(i.value)
    return out


def _dev_shm() -> tuple:
    """``/dev/shm``'s size and free bytes (``os.statvfs``)."""
    st = os.statvfs("/dev/shm")
    return st.f_blocks * st.f_frsize, st.f_bavail * st.f_frsize


def _shm_leftovers(before) -> tuple:
    """Ring segments and shm threads still alive, given the segments
    that were there before."""
    segs = sorted(n for n in os.listdir("/dev/shm") if n.startswith("fps-ring-") and n not in before)
    names = sorted(t.name for t in threading.enumerate()
                   if t.name.startswith("shm-beat-") or t.name.endswith("-shm-pump"))
    return segs, names


def _shmem_driver_cls():
    """A ``ClusterDriver`` whose clients time their ``pull_batch`` /
    ``push_batch`` calls and keep every connection they dial, optionally
    reach shard 0 through a fault-free
    ``ChaosProxy``, and optionally lease a fixed id set (so a hot-cache
    run repeats: the sketch-driven policy re-derives its set on a clock)."""
    from flink_parameter_server_tpu_torch.cluster import ClusterDriver
    from flink_parameter_server_tpu_torch.hotcache import StaticHotSet
    from flink_parameter_server_tpu_torch.nemesis import ChaosProxy

    class ShmemArmDriver(ClusterDriver):
        def __init__(self, logic, *, proxied=False, hot_set=None, **kwargs):
            self.proxied, self.hot_set, self.proxy = proxied, hot_set, None
            self.timed, self.dialed = {"pull": [], "push": []}, []
            super().__init__(logic, **kwargs)

        def _make_client(self, worker=None):
            c = super()._make_client(worker)
            if self.proxied:
                if self.proxy is None:
                    srv = self.servers[0]
                    self.proxy = ChaosProxy(srv.host, srv.port, name="shmem-proxy", registry=False).start()
                c._addresses[0] = (self.proxy.host, self.proxy.port)
            for verb in ("pull", "push"):
                fn = getattr(c, f"{verb}_batch")

                def call(*a, fn=fn, verb=verb, **k):
                    t0 = time.perf_counter()
                    out = fn(*a, **k)
                    self.timed[verb].append(time.perf_counter() - t0)
                    return out

                setattr(c, f"{verb}_batch", call)
            dial = c._dial

            def dial_and_keep(addr):
                conn = dial(addr)
                self.dialed.append(conn)  # every connection, closed ones too
                return conn

            c._dial = dial_and_keep
            return c

        def _attach_hot_cache(self, client, worker):
            super()._attach_hot_cache(client, worker)
            if self.hot_set is not None and client.hotcache is not None:
                client.lease_policy = StaticHotSet(self.hot_set)

        def stop(self):
            try:
                super().stop()
            finally:
                if self.proxy is not None:
                    self.proxy.stop()
                    self.proxy = None

    return ShmemArmDriver


def phase_shmem(torch, dev, card):
    """The shared-memory transport at the cluster phase's full width and
    stream (100,000 users x 131,072 items, dim 64, lr 0.01, 12
    microbatches of 65,536 Zipf-1.2 ratings, ``ranged_random_factor``
    init; only the run length is cut), every arm through ``ClusterDriver``
    on the card: (1) thread shards, BSP 4 x 2 with ``push_aggregate``, in
    turns TCP, shm, shm, TCP (the transport A/B), every turn bitwise the
    first, the shm table at the reference's bar against the single-process
    table; (2) 2 shard processes x 1 worker, shm against TCP, bitwise, each
    child advertising shm; (3) the arm of (1) with a fault-free
    ``ChaosProxy`` in front of shard 0: the proxied connections fall back
    to binary TCP, counted, bitwise the TCP arm; (4) ``hot_cache=True`` SSP
    4 x 2 with ``push_aggregate`` and a fixed lease set over shm against
    TCP: values bitwise, hit counts equal.  Every shm arm holds every
    connection on shm with no fallback; nothing is left in ``/dev/shm`` or
    running afterwards.  No kernel launches: the thread shards take the
    store's ``xla`` arm, the proc shards numpy."""
    from flink_parameter_server_tpu_torch.cluster import ClusterConfig, ClusterDriver
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.core.transform import transform_batched
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization, SGDUpdater,
    )
    from flink_parameter_server_tpu_torch.shmem import DEFAULT_CAPACITY, available
    from flink_parameter_server_tpu_torch.telemetry.registry import MetricsRegistry
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    t_phase = time.perf_counter()
    check(available(), "shmem: shared memory is not available on this machine (/dev/shm missing or read-only)")
    before = set(os.listdir("/dev/shm"))
    size, free = _dev_shm()
    print(f"shmem: /dev/shm {size} bytes, {free} free; a channel's ring pair {2 * DEFAULT_CAPACITY} bytes; {card}")
    stream = zipf_stream(9, CLUSTER_ROUNDS)
    init = ranged_random_factor(1, (DIM_UNFUSED,))
    Driver = _shmem_driver_cls()

    def logic():
        return OnlineMatrixFactorization(NUM_USERS, DIM_UNFUSED, updater=SGDUpdater(LEARNING_RATE), device=dev)

    def fits(what, clients, shards):
        need = clients * shards * 2 * DEFAULT_CAPACITY
        free_now = _dev_shm()[1]
        check(need <= free_now, f"shmem: {what}: its rings take up to {need} bytes and /dev/shm has {free_now} "
              f"free; a tmpfs that fills raises SIGBUS, so the arm is not run")
        return need

    def proc_driver(proto, shards):
        reg = MetricsRegistry()
        return ClusterDriver(logic(), capacity=NUM_ITEMS, value_shape=(DIM_UNFUSED,), init_fn=None,
                             config=ClusterConfig(wire_proto=proto, shard_procs=True, proc_init=CLUSTER_PROC_INIT,
                                                  num_shards=shards, num_workers=1, staleness_bound=0),
                             registry=reg, device=dev), reg

    def run(what, proto, *, procs=None, proxied=False, hot_set=None, **cfg):
        """One arm (``procs``: a shard-process driver built by
        ``proc_driver``); returns its result, shmem counters and facts."""
        reg = MetricsRegistry() if procs is None else procs[1]
        shards, workers = cfg.get("num_shards", CLUSTER_SHARDS), cfg.get("num_workers", CLUSTER_WORKERS)
        ring_bytes = 0
        if proto == "shm":
            ring_bytes = fits(what, workers + bool(cfg.get("push_aggregate")), shards)
        cfg = dict(dict(num_shards=CLUSTER_SHARDS, num_workers=CLUSTER_WORKERS, staleness_bound=0), **cfg)
        stamps, info = [], {}
        t_arm = time.perf_counter()
        if procs:
            d = procs[0]
        else:
            d = Driver(logic(), capacity=NUM_ITEMS, value_shape=(DIM_UNFUSED,), init_fn=init, proxied=proxied,
                       hot_set=hot_set, config=ClusterConfig(wire_proto=proto, **cfg), registry=reg, device=dev)

        def hook(w, t):
            if w == 0:
                stamps.append(time.perf_counter())

        with d:
            if not procs:
                check(all(s.store.table.device.type == dev.type for s in d.shards),
                      f"shmem: {what}: not every slice is on {dev.type}")
            else:
                info["advertised"] = [bool(p.shm) for p in d.servers]
            t_run = time.perf_counter()
            r = d.run(stream, timeout=600, round_hook=hook)
            t_end = time.perf_counter()
            # the combiner's client is closed at the run's end: the arm
            # driver kept every connection as it was dialled
            conns = [cc for c in d._clients for cc in c._conns.values()] if procs else list(d.dialed)
            info["wires"] = [getattr(cc, "wire", "tcp") for cc in conns]
            info["spills"] = sum(getattr(cc, "spills", 0) for cc in conns)
            info["borrows"] = sum(getattr(cc, "borrows", 0) for cc in conns)
            if hot_set is not None:
                info["hits"] = [c.hotcache.stats()["hits"] for c in d._clients]
                info["fills"] = [c.hotcache.stats()["fills"] for c in d._clients]
            if proxied:
                info["downgrades"] = d.proxy.shm_downgrades
                info["proxied"] = [cc.port == d.proxy.port for cc in conns]
                info["proxied_wires"] = [cc.wire for cc in conns if cc.port == d.proxy.port]
            timed = getattr(d, "timed", None)
        t_stop = time.perf_counter()
        counts = _shm_counts(reg)
        n_pull = CLUSTER_ROUNDS * cfg["num_workers"]  # the rounds' pulls; the final dump's comes after
        line = (f"shmem: {what}: {r.rounds} rounds in {r.wall_s:.3f} s: {r.rounds / r.wall_s:.2f} rounds/s, "
                f"{r.updates_per_sec:.0f} updates/s")
        if len(stamps) > SHMEM_WARMUP:
            info["rate"] = (CLUSTER_ROUNDS - SHMEM_WARMUP) / (t_end - stamps[SHMEM_WARMUP])
            line += f", {info['rate']:.2f} rounds/s after {SHMEM_WARMUP} warm-up rounds"
        if timed is not None:
            pulls = np.array(timed["pull"][:n_pull]) * 1e3
            pushes = np.array(timed["push"]) * 1e3
            info["push_ms"] = float(np.mean(pushes))
            line += (f"; pull_batch p50 {np.percentile(pulls, 50):.3f} ms p99 {np.percentile(pulls, 99):.3f} ms, "
                     f"push_batch mean {np.mean(pushes):.3f} ms p50 {np.percentile(pushes, 50):.3f} ms "
                     f"p99 {np.percentile(pushes, 99):.3f} ms ({len(pushes)} pushes)")
        line += (f"; the arm {t_stop - t_arm:.2f} s (built and stopped {t_stop - t_arm - (t_end - t_run):.2f} s, the "
                 f"run and its dump {t_end - t_run:.2f} s)")
        line += (f"; wires {sorted(set(info['wires']))} on {len(info['wires'])} connections, ring bytes up to "
                 f"{ring_bytes}, borrows {info['borrows']}, spills {info['spills']}, counters {counts}; {card}")
        print(line)
        if proto == "shm" and not proxied:
            check(info["wires"] and set(info["wires"]) == {"shm"},
                  f"shmem: {what}: connections not on shm: {info['wires']}")
            fallbacks = {k: v for k, v in counts.items() if k.startswith("fallback")}
            check(not fallbacks, f"shmem: {what}: shm fell back: {fallbacks}")
        if proto != "shm":
            check(set(info["wires"]) == {"tcp"}, f"shmem: {what}: a TCP arm rode {info['wires']}")
        return r, counts, info

    def bitwise(what, a, b):
        same = a.tobytes() == b.tobytes()
        print(f"shmem: {what}: {'bitwise equal' if same else 'DIFFER'}")
        check(same, f"shmem: {what} are not bitwise equal")

    def at_bar(what, vals):
        err = float(np.abs(vals.astype(np.float64) - base).max())
        ok = bool(np.allclose(vals, base, **CLUSTER_BAR))
        print(f"shmem: {what} against the single-process table: max_abs_err={err:.3e} (rtol=1e-4 atol=1e-6) "
              f"{'ok' if ok else 'BREAKS THE BAR'}")
        check(ok, f"shmem: {what} breaks the reference's bar (rtol 1e-4, atol 1e-6)")

    zero_counts()
    store = ShardedParamStore.create(NUM_ITEMS, (DIM_UNFUSED,), init_fn=init, device=dev)
    base = transform_batched(stream, logic(), store, dump_model=False,
                             collect_outputs=False).store.values().cpu().numpy()
    del store
    agg = dict(push_aggregate=True)
    bsp = f"socket range BSP {CLUSTER_SHARDS}x{CLUSTER_WORKERS} push_aggregate"
    # (1) and (5): thread shards in turns auto, shm, shm, auto (the
    # transport A/B in one call), every turn bitwise the first
    ab, tables = [], []
    for proto in SHMEM_AB:
        r, _, info = run(f"(1) {bsp}, {proto}", proto, **agg)
        ab.append((proto, info["rate"], info["push_ms"]))
        tables.append(r.values)
    tcp = tables[0]
    for (proto, _, _), vals in list(zip(ab, tables))[1:]:
        bitwise(f"(1) the {proto} turn's table and the first (auto) turn's", vals, tcp)
    at_bar("(1) the shm table", tables[1])
    rate = {p: statistics.median(x for q, x, _ in ab if q == p) for p in ("auto", "shm")}
    push = {p: statistics.median(x for q, _, x in ab if q == p) for p in ("auto", "shm")}
    print(f"shmem: (5) transport A/B in turns {', '.join(f'{p} {x:.3f} rounds/s push_batch {m:.3f} ms' for p, x, m in ab)}"
          f"; medians shm / auto: {rate['shm'] / rate['auto']:.3f}x rounds/s, push_batch "
          f"{push['shm'] / push['auto']:.3f}x; {card}")
    # (2) shard processes: both arms' children spawn side by side in the
    # background (each imports torch, seconds apiece) while (3) and (4) run
    # in this process; their arms run after (4), one after the other
    pre = {p: proc_driver(p, CLUSTER_PROCS) for p in ("auto", "shm")}
    t0, spawn_errs, spawned = time.perf_counter(), [], {}

    def spawn(p, d):
        try:
            d.start()
            spawned[p] = time.perf_counter() - t0
        except BaseException as e:  # re-raised below
            spawn_errs.append(e)

    starters = [threading.Thread(target=spawn, args=(p, d), name=f"shmem-spawn-{p}") for p, (d, _) in pre.items()]
    for t in starters:
        t.start()
    ok = False
    try:
        # (3) a fault-free proxy in front of shard 0
        px, counts, info = run(f"(3) {bsp}, shm, shard 0 behind a ChaosProxy", "shm", proxied=True, **agg)
        refused = counts.get("fallback hello-refused", 0)
        others = [w for cc_wire, w in zip(info["proxied"], info["wires"]) if not cc_wire]
        print(f"shmem: (3) the proxied connections rode {info['proxied_wires']}; hello-refused {refused}, the proxy's "
              f"downgrades {info['downgrades']}; the other {len(others)} connections rode {sorted(set(others))}; {card}")
        check(info["proxied_wires"] and set(info["proxied_wires"]) == {"tcp"},
              f"shmem: (3) a proxied connection rode {info['proxied_wires']}")
        check(refused == info["downgrades"] == len(info["proxied_wires"]),
              f"shmem: (3) hello-refused {refused}, downgrades {info['downgrades']}, dials "
              f"{len(info['proxied_wires'])}: not one a dial through the proxy")
        check(others and set(others) == {"shm"}, f"shmem: (3) an unproxied connection left shm: {others}")
        check(set(counts) <= {"fallback hello-refused", "borrows", "borrow_spills"},
              f"shmem: (3) fallbacks besides the proxy's: {counts}")
        bitwise("(3) the proxied shm table and the TCP table", px.values, tcp)
        # (4) the hot cache over shm
        items = np.concatenate([b["item"] for b in stream]).astype(np.int64)
        hot = np.lexsort((np.arange(NUM_ITEMS), -np.bincount(items, minlength=NUM_ITEMS)))[:SHMEM_HOT]
        ssp = dict(staleness_bound=SHMEM_BOUND, hot_cache=True, **agg)
        what = f"socket range SSP {SHMEM_BOUND} {CLUSTER_SHARDS}x{CLUSTER_WORKERS} push_aggregate hot_cache"
        ht, _, hinfo_t = run(f"(4) {what}, auto", "auto", hot_set=hot, **ssp)
        hs, _, hinfo_s = run(f"(4) {what}, shm", "shm", hot_set=hot, **ssp)
        print(f"shmem: (4) worker cache hits TCP {hinfo_t['hits']} shm {hinfo_s['hits']}, fills TCP {hinfo_t['fills']} "
              f"shm {hinfo_s['fills']}; {card}")
        bitwise("(4) the hot-cache shm table and its TCP table", hs.values, ht.values)
        check(hinfo_s["hits"] == hinfo_t["hits"] and hinfo_s["fills"] == hinfo_t["fills"],
              f"shmem: (4) the caches' hits or fills differ: {hinfo_t} against {hinfo_s}")
        ok = True
    finally:
        t_join = time.perf_counter()
        for t in starters:
            t.join()
        if not ok or spawn_errs:
            for d, _ in pre.values():
                d.stop()
    if spawn_errs:
        raise spawn_errs[0]
    print(f"shmem: (2) {2 * CLUSTER_PROCS} shard processes spawned side by side behind arms (3) and (4): ready "
          f"{ {p: round(x, 2) for p, x in spawned.items()} } s after the spawn began, the wait after (4) "
          f"{time.perf_counter() - t_join:.2f} s; {card}")
    pt, _, _ = run(f"(2) {CLUSTER_PROCS} shard processes, 1 worker, auto", "auto", procs=pre["auto"],
                   num_shards=CLUSTER_PROCS, num_workers=1)
    ps, _, info = run(f"(2) {CLUSTER_PROCS} shard processes, 1 worker, shm", "shm", procs=pre["shm"],
                      num_shards=CLUSTER_PROCS, num_workers=1)
    check(info["advertised"] == [True] * CLUSTER_PROCS, f"shmem: (2) the children advertised {info['advertised']}")
    check([s["backend"] for s in ps.shard_stats] == ["numpy"] * CLUSTER_PROCS,
          "shmem: (2) the shard processes do not run the numpy slice")
    bitwise("(2) the shard processes' shm table and their TCP table", ps.values, pt.values)
    read_counts("shmem", {})
    deadline = time.monotonic() + 10
    segs, names = _shm_leftovers(before)
    while (segs or names) and time.monotonic() < deadline:
        time.sleep(0.05)
        segs, names = _shm_leftovers(before)
    print(f"shmem: after the phase: ring segments left {segs}, shm threads alive {names}; {card}")
    check(not segs and not names, f"shmem: left behind: segments {segs}, threads {names}")
    print(f"shmem: phase took {time.perf_counter() - t_phase:.1f} s; {card}")


ELASTIC_ROUNDS = 12  # only the run length is cut
ELASTIC_RESIZE_AT = 4  # cluster_worker_rounds_total at which a resize fires (round 2 of 12)
ELASTIC_PA = dict(rounds=12, batch=1024, num_items=8192)  # a dense 12,288 x 8,192 float32 X: ~400 MB
ELASTIC_SKETCH = dict(rounds=12, batch=65_536, num_items=4096)  # count-min 8,192 x 4
ELASTIC_HEDGE_AFTER_S, ELASTIC_HEDGE_DELAY_S = 0.05, 0.5
PA_TOL = dict(rtol=1e-5, atol=1e-6)  # two workers' rows land as two float32 adds


class _SlowOnce:
    """Mixed into a ShardServer: one pull frame waits ``delay_s`` (the
    straggler of the reference's tests/test_elastic.py hedging setup),
    on either framing."""

    def _maybe_stall(self, verb):
        if verb == "pull" and self.slow.is_set():
            self.slow.clear()
            time.sleep(self.delay_s)

    def respond(self, line):
        self._maybe_stall(line.split(None, 1)[0].lower() if line else "")
        return super().respond(line)

    def respond_frame(self, data):
        from flink_parameter_server_tpu_torch.utils import frames

        self._maybe_stall(frames.peek_verb_name(data))
        return super().respond_frame(data)


def _windows(starts, t_run0, t_run1, t0, t1):
    """Global rounds/s before, during and after a resize, from the round
    starts of worker 0 (BSP keeps the workers in lockstep); a round is
    counted in the window its start falls in."""
    marks = sorted(s for s, w, _t in starts if w == 0)
    out = {}
    for name, lo, hi in (("before", t_run0, t0), ("during", t0, t1), ("after", t1, t_run1)):
        n = sum(lo <= s < hi for s in marks)
        out[name] = (n, n / (hi - lo) if hi > lo else float("nan"))
    return out


def phase_elastic(torch, dev, card):
    """Registered workloads and live resharding on the card, through the
    entry points a user calls (``workloads.build_cluster_driver``,
    ``elastic.ElasticClusterDriver``).  MF at the main path's width
    (``MFWorkload``: 100,000 users x 131,072 items, dim 64, its own logic,
    init and seeded stream of 65,536-rating microbatches, 12 rounds; only
    the run length is cut): a single-process ``StreamingDriver`` anchor over
    a ``scatter_impl="pallas"`` store (K1 once a step, no other kernel);
    socket BSP 4 shards x 2 workers at the reference's bar (rtol 1e-4, atol
    1e-6) against it; a live scale-out 2 -> 3, a live scale-in 3 -> 2 and a
    killed shard replaced, each under 2-worker BSP traffic over a WAL, at
    the bar against the static run of the final shard count, migrations
    verified bitwise with 0 mismatches and the ledger balanced; a hedged
    read against a shard that stalls one pull frame.  PA (8,192 features,
    1,024 examples a round, 12 rounds; a host-memory cut) and the count-min
    sketch (8,192 x 4, 65,536 tokens a round, 12 rounds, q8 requested), each
    through ``build_cluster_driver`` with its serving verbs over TCP.  No
    cluster or elastic run launches a kernel of the port (the shards take
    the store's ``"xla"`` arm, as the reference's do)."""
    import shutil
    import tempfile
    import threading

    from flink_parameter_server_tpu_torch.cluster import (
        ClusterClient, ClusterConfig, ParamShard, RangePartitioner, ShardServer,
    )
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.core.transform import to_device, to_host
    from flink_parameter_server_tpu_torch.elastic import (
        ElasticClusterConfig, ElasticClusterDriver, HedgeBudget, Hedger, MembershipService,
    )
    from flink_parameter_server_tpu_torch.elastic import controller as elastic_controller
    from flink_parameter_server_tpu_torch.telemetry.registry import MetricsRegistry
    from flink_parameter_server_tpu_torch.training.driver import DriverConfig, StreamingDriver
    from flink_parameter_server_tpu_torch.workloads import (
        WorkloadParams, WorkloadServingClient, build_cluster_driver, create_workload, serve_workload,
    )

    t_phase = time.perf_counter()
    mf = create_workload("mf", WorkloadParams(rounds=ELASTIC_ROUNDS, batch=BATCH, num_users=NUM_USERS,
                                              num_items=NUM_ITEMS, dim=DIM_UNFUSED), device=dev)
    stream = mf.batches()

    def on_card(what, shards):
        check(all(s.store.table.device.type == dev.type for s in shards),
              f"elastic: {what}: not every shard slice is on {dev.type}")

    def rate(what, r, extra=""):
        print(f"elastic: {what}: {r.rounds} rounds in {r.wall_s:.3f} s: {r.rounds / r.wall_s:.2f} rounds/s, "
              f"{r.updates_per_sec:.0f} updates/s{extra}; {card}")

    def at_bar(what, vals, ref):
        err = float(np.abs(vals.astype(np.float64) - ref).max())
        print(f"elastic: {what}: max_abs_err={err:.3e} (rtol=1e-4 atol=1e-6); {card}")
        check(bool(np.isfinite(vals).all()) and bool(np.allclose(vals, ref, **CLUSTER_BAR)),
              f"elastic: {what} breaks the reference's bar (max_abs_err {err:.3e})")

    # the single-process anchor: StreamingDriver over K1 (the second,
    # counted and timed run is the one kept)
    for counted in (False, True):
        store = ShardedParamStore.create(mf.capacity, mf.value_shape, init_fn=mf.init_fn(),
                                         scatter_impl="pallas", device=dev)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        anchor = StreamingDriver(mf.make_logic(), store,
                                 config=DriverConfig(telemetry=False, dump_model=False)).run(stream)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    read_counts("the elastic phase's single-process MF anchor", {"scatter_add": ELASTIC_ROUNDS})
    base = to_host(anchor.store.values(), copy=True)
    del anchor, store
    check(bool(np.isfinite(base).all()), "elastic: the anchor's table is not finite")
    print(f"elastic: MFWorkload single-process StreamingDriver (pallas, K1 {ELASTIC_ROUNDS} launches): "
          f"{ELASTIC_ROUNDS / wall:.2f} rounds/s, {ELASTIC_ROUNDS * BATCH / wall:.0f} updates/s; {card}")

    def static(what, **cfg):
        zero_counts()
        d = build_cluster_driver(mf, config=ClusterConfig(num_workers=2, staleness_bound=0, **cfg), registry=False)
        with d:
            on_card(what, d.shards)
            r = d.run(stream, timeout=600)
        read_counts(f"elastic: {what}", {})
        rate(what, r)
        return r.values

    four = static("build_cluster_driver('mf') socket BSP 4x2 (range)", num_shards=4)
    at_bar("socket BSP 4x2 against the single-process anchor", four, base)
    statics = {n: static(f"static {n}-shard hash BSP x2", num_shards=n, partition="hash") for n in (2, 3)}
    for n in (2, 3):
        at_bar(f"static {n}-shard hash against the single-process anchor", statics[n], base)

    tmp = tempfile.mkdtemp(prefix="elastic-", dir=os.path.join(REPO, "build"))
    marks = {}
    execute_moves = elastic_controller.execute_moves

    def timed_moves(*a, **k):  # where the data plane ends and the flip begins
        t = time.perf_counter()
        report = execute_moves(*a, **k)
        marks["moves_s"], marks["moves_end"] = time.perf_counter() - t, time.perf_counter()
        return report

    def elastic(what, num_shards, action, name):
        reg = MetricsRegistry()
        d = build_cluster_driver(
            mf, config=ElasticClusterConfig(num_shards=num_shards, num_workers=2, wal_dir=os.path.join(tmp, name)),
            driver_cls=ElasticClusterDriver, registry=reg,
        )
        d.start()
        on_card(what, d.shards)
        publish = d.membership.publish

        def timed_publish(*a, **k):
            out = publish(*a, **k)
            marks["publish_end"] = time.perf_counter()
            return out

        d.membership.publish = timed_publish
        rounds_c = reg.counter("cluster_worker_rounds_total", component="cluster")
        starts, out, errors, win = [], [], [], {}

        def control():
            try:
                deadline = time.monotonic() + 300
                while rounds_c.value < ELASTIC_RESIZE_AT and time.monotonic() < deadline:
                    time.sleep(0.0005)
                check(rounds_c.value >= ELASTIC_RESIZE_AT, f"elastic: {what}: the run never reached the resize")
                win["t0"] = time.perf_counter()
                out.append(action(d))
                win["t1"] = time.perf_counter()
            except BaseException as e:  # re-raised on the main thread below
                errors.append(e)

        marks.clear()
        zero_counts()
        elastic_controller.execute_moves = timed_moves
        th = threading.Thread(target=control, name="elastic-smoke-control", daemon=True)
        try:
            t_run0 = time.perf_counter()
            th.start()
            r = d.run(stream, timeout=600, round_hook=lambda w, t: starts.append((time.perf_counter(), w, t)))
            t_run1 = t_run0 + r.wall_s  # the rounds' end, before the final table's dump
            th.join(timeout=300)
            check(not th.is_alive(), f"elastic: {what}: the resize did not finish")
            if errors:
                raise errors[0]
            on_card(f"{what}, after", d.shards)
            acked = sum(c.rows_pushed for c in d._clients)
            applied = sum(sh.rows_applied for sh in d.all_shards)
            retried = sum(c.frames_retried for c in d._clients)
            stall = [i for i in reg.instruments() if i.name == "elastic_migration_stall_seconds"]
            stall_ms = stall[0].sum / stall[0].count * 1e3 if stall and stall[0].count else float("nan")
            epoch = d.membership.current().epoch
            shards_after = d.partitioner.num_shards
            retired = [sh for sh, _srv in d._retired]
        finally:
            elastic_controller.execute_moves = execute_moves
            d.stop()
        read_counts(f"elastic: {what}", {})
        rate(what, r, f", ledger acked {acked} applied {applied}, {retried} batch replays")
        check(acked == applied and acked > 0, f"elastic: {what}: ledger acked {acked} != applied {applied}")
        w = _windows(starts, t_run0, t_run1, win["t0"], win["t1"])
        print(f"elastic: {what}: rounds/s (updates/s) " + ", ".join(
            f"{k} {v[1]:.2f} ({v[1] * BATCH:.0f}) over {v[0]} rounds" for k, v in w.items())
            + f"; the action took {(win['t1'] - win['t0']) * 1e3:.1f} ms; {card}")
        return out[0], r.values, dict(epoch=epoch, shards=shards_after, retired=retired, marks=dict(marks),
                                      stall_ms=stall_ms)

    def migration_line(what, report, info):
        moved_bytes = report.rows_moved * DIM_UNFUSED * 4
        m = info["marks"]
        flip_ms = (m["publish_end"] - m["moves_end"]) * 1e3
        print(f"elastic: {what}: migration moved {report.rows_moved} rows ({moved_bytes} B) in "
              f"{m['moves_s'] * 1e3:.1f} ms ({report.tail_rows} rows from {report.tail_records} WAL-tail records, "
              f"{report.pairs_handed_off} dedupe pairs handed off), epoch flip {flip_ms:.1f} ms, freeze-to-flip "
              f"stall {info['stall_ms']:.1f} ms, verified {report.verified}, {report.mismatches} mismatches; {card}")
        check(report.verified and report.mismatches == 0 and report.rows_moved > 0,
              f"elastic: {what}: migration not verified: {report}")

    try:
        report, vals, info = elastic("live scale-out 2 -> 3 shards", 2, lambda d: d.scale_out(), "out")
        migration_line("scale-out", report, info)
        check(info["epoch"] == 1 and info["shards"] == 3, f"elastic: scale-out ended at {info}")
        at_bar("live scale-out against the static 3-shard run", vals, statics[3])

        report, vals, info = elastic("live scale-in 3 -> 2 shards", 3, lambda d: d.scale_in(), "in")
        migration_line("scale-in", report, info)
        check(info["epoch"] == 1 and info["shards"] == 2 and len(info["retired"]) == 1,
              f"elastic: scale-in ended at {info}")
        gone = info["retired"][0]
        check(report.rows_moved == len(gone.owned) and gone.stats()["frozen"] == len(gone.owned),
              f"elastic: the retired shard was not fully drained ({report.rows_moved} of {len(gone.owned)} rows)")
        at_bar("live scale-in against the static 2-shard run", vals, statics[2])

        def kill_and_replace(d):
            d.kill_shard(1)
            time.sleep(0.05)  # the window in which workers retry against the dead address
            t = time.perf_counter()
            replayed = d.replace_shard(1)
            print(f"elastic: replace_shard(1): {replayed} WAL records replayed in "
                  f"{(time.perf_counter() - t) * 1e3:.1f} ms; {card}")
            return replayed

        replayed, vals, info = elastic("shard 1 killed and replaced", 2, kill_and_replace, "replace")
        check(replayed > 0 and info["epoch"] == 1, f"elastic: replacement replayed {replayed}, {info}")
        at_bar("kill -> replace against the static 2-shard run", vals, statics[2])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # a hedged read against a shard that stalls one pull frame
    class SlowServer(_SlowOnce, ShardServer):
        pass

    part = RangePartitioner(NUM_ITEMS, 1)
    init = mf.init_fn()
    shard = ParamShard(0, part, (DIM_UNFUSED,), init_fn=init, registry=False, device=dev)
    server = SlowServer(shard, supervised=False).start()
    server.slow, server.delay_s = threading.Event(), ELASTIC_HEDGE_DELAY_S
    reg = MetricsRegistry()
    hedger = Hedger(ELASTIC_HEDGE_AFTER_S, budget=HedgeBudget(1.0, burst=16), registry=reg)
    client = ClusterClient(value_shape=(DIM_UNFUSED,), registry=False, hedge=hedger,
                           membership=MembershipService(part, [(server.host, server.port)], registry=False))
    try:
        ids = np.arange(0, NUM_ITEMS, 16, dtype=np.int64)
        client.pull_batch(ids[:64])  # warm the primary connection
        server.slow.set()
        t0 = time.perf_counter()
        vals = client.pull_batch(ids)
        wall = time.perf_counter() - t0
        want = to_host(init(to_device(ids.astype(np.int32), dev)), copy=True)
        check(np.array_equal(vals, want), "elastic: the hedged pull is not the slice's rows")
        push_ids = ids[:512]
        before = client.pull_batch(push_ids)
        client.push_batch(push_ids, np.ones((len(push_ids), DIM_UNFUSED), np.float32))
        after = client.pull_batch(push_ids)
        counts = {i.name: i.value for i in reg.instruments()}
        print(f"elastic: hedged pull of {len(ids)} rows against a shard stalling one frame {ELASTIC_HEDGE_DELAY_S} s: "
              f"{wall * 1e3:.1f} ms, hedges fired {hedger.hedges_issued} frames, won {hedger.hedges_won} "
              f"(elastic_hedged_pulls_total {counts.get('elastic_hedged_pulls_total')}, "
              f"elastic_hedges_won_total {counts.get('elastic_hedges_won_total')}); the push applied "
              f"{shard.rows_applied} rows for {len(push_ids)} pushed; {card}")
        check(wall < ELASTIC_HEDGE_DELAY_S / 2 and hedger.hedges_won >= 1, "elastic: the hedge did not win")
        check(shard.rows_applied == len(push_ids) and np.array_equal(after, before + np.float32(1.0)),
              "elastic: a push was applied other than once")
    finally:
        client.close()
        server.stop()
        shard.close()

    # PA through build_cluster_driver: bitwise at one worker, twice
    pa = create_workload("pa", WorkloadParams(**ELASTIC_PA), device=dev)
    t0 = time.perf_counter()
    pa_stream = pa.batches()
    pa.batches = lambda: pa_stream  # the oracle and every arm take this one stream
    print(f"elastic: PA stream ({ELASTIC_PA}, {pa_stream[0]['ids'].shape[1]} features a padded example) "
          f"built in {time.perf_counter() - t0:.1f} s; {card}")
    oracle = pa.oracle_values()

    def pa_run(what, workers):
        zero_counts()
        d = build_cluster_driver(pa, config=ClusterConfig(num_shards=2, num_workers=workers, staleness_bound=0),
                                 registry=False)
        with d:
            on_card(what, d.shards)
            r = d.run(pa_stream, timeout=600)
            served = None
            if workers == 1:
                client = d._make_client(worker="serve")
                server = serve_workload(pa, client, registry=False)
                try:
                    sc = WorkloadServingClient(server.host, server.port)
                    rng = np.random.default_rng(0)
                    ex = [[(int(i), float(v)) for i, v in zip(rng.choice(pa.capacity, 5, replace=False),
                                                              rng.standard_normal(5))] for _ in range(8)]
                    served = (ex, sc.predict(ex))
                finally:
                    server.stop()
                    client.close()
        read_counts(f"elastic: {what}", {})
        rate(what, r)
        return r.values, served

    one, served = pa_run("build_cluster_driver('pa') BSP 2 shards x 1 worker", 1)
    again, _ = pa_run("build_cluster_driver('pa') BSP 2 shards x 1 worker, again", 1)
    print(f"elastic: PA 1-worker cluster tables against oracle_values(): "
          f"{'bitwise equal' if one.tobytes() == oracle.tobytes() == again.tobytes() else 'DIFFER'}; {card}")
    check(one.tobytes() == oracle.tobytes() == again.tobytes(), "elastic: PA is not bitwise its oracle")
    ex, margins = served
    # the server's own arithmetic: float32 weights dotted with the values
    # as the client sent them (6 significant digits), answered to 6
    want = [float(f"{float(one[[i for i, _ in e]] @ np.asarray([float(f'{v:.6g}') for _, v in e], np.float32)):.6g}")
            for e in ex]
    check(margins == want, f"elastic: predict over TCP {margins} != the table's dot products {want}")
    two, _ = pa_run("build_cluster_driver('pa') BSP 2 shards x 2 workers", 2)
    err = float(np.abs(two - oracle).max())
    print(f"elastic: PA 2-worker cluster against oracle_values(): max_abs_err={err:.3e} (rtol=1e-5 atol=1e-6: "
          f"each worker's combined row is its own float32 add); {card}")
    check(bool(np.allclose(two, oracle, **PA_TOL)), f"elastic: PA 2-worker table off its oracle by {err:.3e}")

    # the count-min sketch through build_cluster_driver: exact, q8 downgraded
    sk = create_workload("sketch", WorkloadParams(**ELASTIC_SKETCH), device=dev)
    check((sk.width, sk.depth) == (8192, 4), f"elastic: the sketch is {sk.width} x {sk.depth}")
    zero_counts()
    reg = MetricsRegistry()
    d = build_cluster_driver(sk, config=ClusterConfig(num_shards=2, num_workers=2, staleness_bound=2,
                                                      wire_format="q8"), registry=reg)
    with d:
        on_card("sketch", d.shards)
        check(all(c.wire_format == "b64" and c._compressor is None for c in d._clients),
              "elastic: the sketch's q8 request was not downgraded to float32")
        r = d.run(sk.batches(), timeout=600)
        client = d._make_client(worker="serve")
        server = serve_workload(sk, client, registry=reg)
        try:
            sc = WorkloadServingClient(server.host, server.port)
            keys = np.random.default_rng(1).integers(0, sk.vocab, 64)
            est = sc.query(keys)
            top = sc.topk(16)
        finally:
            server.stop()
            client.close()
    read_counts("elastic: sketch", {})
    rate("build_cluster_driver('sketch') SSP 2 shards x 2 workers, q8 requested", r)
    oracle = sk.oracle_values()
    check(np.array_equal(r.values, oracle), "elastic: the sketch table is not the bincount oracle")
    numpy_est = r.values[sk.cells_np(np.arange(sk.vocab))].min(axis=1)
    check(est == [int(numpy_est[k]) for k in keys], "elastic: sketch query over TCP != numpy estimates")
    order = sorted(range(sk.vocab), key=lambda i: (-numpy_est[i], i))[:16]
    check(top == [(i, int(numpy_est[i])) for i in order], "elastic: sketch topk over TCP != numpy ranking")
    print(f"elastic: sketch table equals the numpy bincount ({int(oracle.sum())} counts); 64 queries and a "
          f"top-16 over TCP equal numpy estimates over the same table; {card}")
    print(f"elastic: phase took {time.perf_counter() - t_phase:.1f} s; {card}")


REPL_ROUNDS = 12  # only the run length is cut
REPL_KILL_AT = 4  # the round before which shard 0's primary is killed
REPL_READ_IDS = 2048  # ids a serving lookup reads, every 64th item


def phase_replication(torch, dev, card):
    """Replica chains and failover on the card, through the entry points a
    user calls (``workloads.build_cluster_driver`` with
    ``replication.ReplicatedClusterDriver``, ``serving.FollowerLookupService``
    and ``elastic.ElasticController``): ``MFWorkload`` at the MF path's
    width (100,000 users x 131,072 items, dim 64, lr 0.05, the seed-3
    stream of 65,536-rating microbatches, 12 rounds; only the run length is
    cut), 2 shards with 1 follower each and 1 BSP worker, while a serving
    reader pulls through the chains (``benchmarks/failover_time.py``'s
    scenario).  Before round 4 every follower must be caught up and bitwise
    its primary; then shard 0's primary is killed and the controller
    promotes its follower.  The promoted shard must be bitwise its own
    replayed log (``verify_against_log`` on the card), the final table
    bitwise an uninterrupted static 2-shard run on the same stream, the
    reader must see no error, and no kernel of the port may launch (every
    slice takes the store's ``"xla"`` arm, as the reference's do)."""
    import shutil
    import tempfile
    import threading

    from flink_parameter_server_tpu_torch.cluster import ClusterConfig
    from flink_parameter_server_tpu_torch.elastic import ElasticController, ScalePolicy
    from flink_parameter_server_tpu_torch.replication import ReplicatedClusterConfig, ReplicatedClusterDriver
    from flink_parameter_server_tpu_torch.replication.failover import verify_against_log
    from flink_parameter_server_tpu_torch.serving import FollowerLookupService
    from flink_parameter_server_tpu_torch.telemetry.registry import MetricsRegistry
    from flink_parameter_server_tpu_torch.workloads import WorkloadParams, build_cluster_driver, create_workload

    t_phase = time.perf_counter()
    mf = create_workload("mf", WorkloadParams(rounds=REPL_ROUNDS, batch=BATCH, num_users=NUM_USERS,
                                              num_items=NUM_ITEMS, dim=DIM_UNFUSED), device=dev)
    stream = mf.batches()

    zero_counts()
    static = build_cluster_driver(mf, config=ClusterConfig(num_shards=2, num_workers=1, partition="hash"),
                                  registry=False)
    with static:
        r = static.run(stream, timeout=600)
    read_counts("replication: the static 2-shard run", {})
    base = r.values
    print(f"replication: static 2-shard hash BSP x1 (the uninterrupted run): {r.rounds} rounds in "
          f"{r.wall_s:.3f} s, {r.rounds / r.wall_s:.2f} rounds/s; {card}")

    tmp = tempfile.mkdtemp(prefix="replication-", dir=os.path.join(REPO, "build"))
    reg = MetricsRegistry()
    zero_counts()
    d = build_cluster_driver(
        mf, config=ReplicatedClusterConfig(num_shards=2, num_workers=1, wal_dir=os.path.join(tmp, "wal"),
                                           replication_factor=1, follower_staleness_bound=None,
                                           verify_promotion=True),
        driver_cls=ReplicatedClusterDriver, registry=reg,
    )
    d.start()
    marks, reports, reads, errors, failures = {}, [], [], [], []
    publish = d.membership.publish

    def timed_publish(*a, **k):
        out = publish(*a, **k)
        if "kill" in marks and "publish" not in marks:
            marks["publish"] = time.perf_counter()
        return out

    d.membership.publish = timed_publish
    promote_shard = d.promote_shard

    def recorded_promote(shard_id):
        reports.append(promote_shard(shard_id))
        return reports[-1]

    d.promote_shard = recorded_promote
    controller = ElasticController(d, policy=ScalePolicy(min_shards=2, max_shards=2, min_window_frames=10**9),
                                   registry=reg)
    serve = FollowerLookupService(d.membership, (DIM_UNFUSED,), registry=reg, retry_timeout=60.0, device=dev)
    killed, stop = threading.Event(), threading.Event()
    read_ids = np.arange(0, NUM_ITEMS, NUM_ITEMS // REPL_READ_IDS, dtype=np.int64)
    caught = {}

    def followers():
        return {s: c.followers[0] for s, c in d.chains.chains.items()}

    def kill_hook(w, t):
        if t != REPL_KILL_AT:
            return
        # every record of rounds 0..3 is acked by its primary; wait until
        # each follower has applied all of them, then hold the slices
        deadline = time.monotonic() + 120
        fs = followers()
        while time.monotonic() < deadline and any(
                f.repl_state()["applied"] < d.shards[s].head_seq() for s, f in fs.items()):
            time.sleep(0.002)
        for s, f in fs.items():
            caught[s] = (d.shards[s].head_seq(), f.repl_state()["applied"],
                         d.shards[s].values().tobytes() == f.values().tobytes())
        marks["kill"] = time.perf_counter()
        d.kill_shard(0)
        killed.set()

    def control():
        try:
            killed.wait(600)
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                act = controller.step()
                if act is not None:
                    marks.setdefault("actions", []).append(act)
                    if act["action"] == "promote":
                        return
                time.sleep(0.002)
        except BaseException as e:  # re-raised on the main thread below
            failures.append(e)

    def reader():
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                res = serve.lookup(read_ids)
                if tuple(res.values.shape) != (len(read_ids), DIM_UNFUSED) or res.values.device.type != dev.type:
                    errors.append(f"a lookup answered {tuple(res.values.shape)} on {res.values.device}")
                reads.append((t0, time.perf_counter()))
            except Exception as e:  # noqa: BLE001 — counted and checked below
                errors.append(f"{type(e).__name__}: {e}")
            time.sleep(0.002)

    threads = [threading.Thread(target=fn, name=f"replication-smoke-{fn.__name__}", daemon=True)
               for fn in (control, reader)]
    try:
        on_card = all(s.store.table.device.type == dev.type for s in d.shards) and all(
            f.store.table.device.type == dev.type for f in followers().values())
        check(on_card, f"replication: not every primary and follower slice is on {dev.type}")
        for th in threads:
            th.start()
        r = d.run(stream, timeout=600, round_hook=kill_hook)
        threads[0].join(timeout=180)
        stop.set()
        threads[1].join(timeout=60)
        check(not any(th.is_alive() for th in threads), "replication: the control or reader thread hung")
        if failures:
            raise failures[0]
        torch.cuda.synchronize()
        counts = read_counts("replication: the replicated run with a failover", {})
        # every follower and its mirror (the promoted one is shard 0 now)
        mirrors = [("promoted (was shard 0's follower)", d.shards[0].stats())] + [
            (f"shard {s}'s follower" + (" (re-seeded)" if s == 0 else ""), f.stats())
            for s, f in sorted(followers().items())]
        t = time.perf_counter()
        audit = verify_against_log(d.shards[0])
        audit_ms = (time.perf_counter() - t) * 1e3
        promoted_role, epoch = d.shards[0].role, d.membership.current().epoch
        fallbacks = sum(i.value for i in reg.instruments() if i.name == "replication_follower_fallbacks_total")
        replica_reads = sum(i.value for i in reg.instruments() if i.name == "replication_replica_reads_total")
        # the O(log) yardstick: shard 1 rebuilt from its whole log
        d.kill_shard(1)
        t = time.perf_counter()
        replayed = d.replace_shard(1)
        replace_ms = (time.perf_counter() - t) * 1e3
    finally:
        stop.set()
        serve.close()
        d.stop()
        shutil.rmtree(tmp, ignore_errors=True)

    print(f"replication: ReplicatedClusterDriver 2 shards x 1 follower, 1 BSP worker, {r.rounds} rounds in "
          f"{r.wall_s:.3f} s ({r.rounds / r.wall_s:.2f} rounds/s, {r.updates_per_sec:.0f} updates/s) with a "
          f"primary killed before round {REPL_KILL_AT}; kernel launches {counts}; {card}")
    for s, (head, applied, same) in sorted(caught.items()):
        print(f"replication: before the kill, shard {s}'s follower applied {applied} of its primary's {head} "
              f"records: {'bitwise equal' if same else 'DIFFERS'}; {card}")
        check(applied == head and same, f"replication: shard {s}'s caught-up follower is not its primary")
    check(len(reports) == 1, f"replication: {len(reports)} promotions, actions {marks.get('actions')}")
    rep = reports[0]
    failover_ms = (marks["publish"] - marks["kill"]) * 1e3
    during = [(a, b) for a, b in reads if b >= marks["kill"] and a <= marks["publish"]]
    print(f"replication: failover of shard 0 (kill -> membership publish) {failover_ms:.1f} ms, promote's own "
          f"fence -> publish {rep.failover_seconds * 1e3:.1f} ms; lag at promote {rep.lag_records_at_promote} "
          f"records, caught up {rep.records_caught_up}, salvaged {rep.records_salvaged}; promotion audit "
          f"{rep.verified} in {rep.verify_seconds * 1e3:.1f} ms; epoch {epoch}; {card}")
    print(f"replication: serving reader: {len(reads)} lookups of {len(read_ids)} rows, {len(during)} of them "
          f"during the failover, {len(errors)} errors, {int(replica_reads)} frames answered by followers, "
          f"{int(fallbacks)} fallbacks to a primary; {card}")
    for what, st in mirrors:
        print(f"replication: {what}: {st['pulls']} pulls served, {st['mirror_rebuilds']} host-mirror rebuilds "
              f"in {st['mirror_rebuild_s'] * 1e3:.1f} ms ({st['mirror_rebuild_s'] * 1e3 / max(1, st['mirror_rebuilds']):.2f} "
              f"ms each); {card}")
    print(f"replication: replace_shard(1) afterwards (the O(log) rebuild): {replayed} WAL records replayed in "
          f"{replace_ms:.1f} ms; verify_against_log on the promoted shard {audit_ms:.1f} ms; {card}")
    same = r.values.tobytes() == base.tobytes()
    print(f"replication: final table against the uninterrupted static run: "
          f"{'bitwise equal' if same else 'DIFFERS'}; promoted shard against its own log: "
          f"{'bitwise equal' if audit else 'DIFFERS'}; {card}")
    check(errors == [], f"replication: serving lookups failed: {errors[:3]}")
    check(len(reads) > 0 and len(during) > 0, "replication: no lookup was served during the failover")
    check(promoted_role == "primary" and epoch >= 1 and rep.verified, "replication: the promotion did not flip")
    check(audit, "replication: the promoted shard is not bitwise its replayed log")
    check(same, "replication: the final table is not bitwise the uninterrupted run")
    check(replayed > 0, "replication: replace_shard replayed nothing")
    print(f"replication: phase took {time.perf_counter() - t_phase:.1f} s; {card}")


TELEMETRY_ROUNDS = 12  # only the run length is cut
TELEMETRY_TIMED = (False, True, True, False)  # hot_keys off / on in turns
TELEMETRY_TOP = 10


class _ExactCounts:
    """Wraps each sketch as it registers: ``observe`` also bincounts the
    same ids into an exact per-label array, and each buffered flush is
    timed.  Shards observe from their server threads, hence the lock."""

    def __init__(self, agg, size):
        import threading

        self.size, self.lock = size, threading.Lock()
        self.exact, self.flush_s = {}, []
        register = agg.register

        def counting_register(label, sketch):
            self.wrap(label, sketch)
            return register(label, sketch)

        agg.register = counting_register

    def wrap(self, label, sketch):
        exact = self.exact.setdefault(label, np.zeros(self.size, np.int64))
        observe, flush = sketch.observe, sketch._flush_locked

        def counting(ids, counts=None):
            flat = np.asarray(ids, np.int64).reshape(-1)
            with self.lock:
                exact[:] += np.bincount(flat, weights=counts, minlength=self.size).astype(np.int64)
            return observe(ids, counts)

        def timed_flush():  # only the flushes with ids to fold in
            if not sketch._pending:
                return flush()
            t = time.perf_counter()
            flush()
            self.flush_s.append(time.perf_counter() - t)

        sketch.observe, sketch._flush_locked = counting, timed_flush


def _check_bounds(what, top, exact, bound):
    """tests/test_tracing.py's bar: a reported count never underestimates,
    and overestimates by at most max(its err, the count-min bound)."""
    for t in top:
        true = int(exact[t["key"]])
        check(true <= t["count"] <= true + max(t["err"], bound),
              f"telemetry: {what}: key {t['key']} reported {t['count']} (err {t['err']}), true {true}, "
              f"count-min bound {bound}")


def _pull_p50(reg):
    """p50 of every client's ``cluster_pull_rtt_seconds``, bucket counts
    merged (the registry's in-bin interpolation)."""
    from flink_parameter_server_tpu_torch.telemetry.timeline import percentile_from_counts

    hs = [i for i in reg.instruments() if i.name == "cluster_pull_rtt_seconds" and i.kind == "histogram"]
    merged = [sum(c) for c in zip(*(h.bucket_counts() for h in hs))]
    return percentile_from_counts(hs[0].bounds, merged, 50.0), sum(merged)


def phase_telemetry(torch, dev, card):
    """The telemetry plane's detection half on the card.  The cluster
    phase's MF at full width (100,000 users x 131,072 items, dim 64, lr
    0.01, ``zipf_stream(9, 12)``: 65,536 Zipf-1.2 ratings a round; socket
    BSP 4 shards x 2 workers, range partition; only the run length is cut)
    through ``ClusterDriver``, four timed runs in turns with ``hot_keys``
    off, on, on, off, then one checked run with ``hot_keys=True`` whose
    sketches also count exactly: (a) the aggregator's ``top_k(10)``, ranked
    with ``dense_topk`` on CUDA tensors, equals a CPU aggregator's over the
    same sketches and a stable host sort of every ``candidates()`` record
    by its reported count; (b) every reported count within the
    reference's bounds of the exact count, every key above a shard's N/K
    tracked by that shard's sketch, and a ``HotKeySketch`` over the run's
    raw item stream naming its 10 most-observed keys; (c) ``stop()`` leaves
    the aggregator empty; (d) a ``TimelineRecorder`` with a ``SkewTracker``
    over the per-shard pull round trips and an EWMA detector, sampled by
    hand once a round, yields series for every shard and a JSON payload;
    (e) an ``SLOEngine`` over ``default_slos()`` gives a verdict for each
    objective.  Then (f) ``ElasticController(slo=...)`` on an
    ``ElasticClusterDriver`` built as the elastic phase builds it
    (``MFWorkload``, 2 shards x 2 workers over a WAL), given a pull-latency
    objective a tenth of its p50 after 2 worker rounds, fires exactly one
    scale-out 2 -> 3 whose migration is verified bitwise.  No kernel of the
    port launches."""
    import shutil
    import tempfile
    import threading

    from flink_parameter_server_tpu_torch.cluster import ClusterConfig, ClusterDriver
    from flink_parameter_server_tpu_torch.elastic import (
        ElasticClusterConfig, ElasticClusterDriver, ElasticController, ScalePolicy,
    )
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization, SGDUpdater,
    )
    from flink_parameter_server_tpu_torch.telemetry import hotkeys
    from flink_parameter_server_tpu_torch.telemetry.detectors import EWMADriftDetector
    from flink_parameter_server_tpu_torch.telemetry.registry import MetricsRegistry
    from flink_parameter_server_tpu_torch.telemetry.slo import SLOEngine, default_slos, pull_latency_slo
    from flink_parameter_server_tpu_torch.telemetry.timeline import SkewTracker, TimelineRecorder
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor
    from flink_parameter_server_tpu_torch.workloads import WorkloadParams, build_cluster_driver, create_workload

    t_phase = time.perf_counter()
    stream = zipf_stream(9, TELEMETRY_ROUNDS)
    init = ranged_random_factor(1, (DIM_UNFUSED,))
    cfg = dict(num_shards=CLUSTER_SHARDS, num_workers=CLUSTER_WORKERS, staleness_bound=0)
    ranked_on = []
    dense_topk = hotkeys.dense_topk

    def spy(table, queries, k, **kw):  # where the aggregator ranks
        ranked_on.append(table.device.type)
        return dense_topk(table, queries, k, **kw)

    def driver(reg, hot_keys):
        logic = OnlineMatrixFactorization(NUM_USERS, DIM_UNFUSED, updater=SGDUpdater(LEARNING_RATE), device=dev)
        return ClusterDriver(logic, capacity=NUM_ITEMS, value_shape=(DIM_UNFUSED,), init_fn=init,
                             config=ClusterConfig(hot_keys=hot_keys, **cfg), registry=reg, device=dev)

    old_agg = hotkeys.get_aggregator()
    agg = hotkeys.HotKeyAggregator()  # device=None: the card
    hotkeys.set_aggregator(agg)
    hotkeys.dense_topk = spy
    tmp = tempfile.mkdtemp(prefix="telemetry-", dir=os.path.join(REPO, "build"))
    try:
        rates = {False: [], True: []}
        zero_counts()
        for hot in TELEMETRY_TIMED:
            with driver(MetricsRegistry(), hot) as d:
                r = d.run(stream, timeout=600)
            rates[hot].append(r.rounds / r.wall_s)
            check(agg.labels() == [], f"telemetry: a timed run left sketches {agg.labels()}")
        read_counts("telemetry: the timed hot_keys runs", {})
        off, on = statistics.median(rates[False]), statistics.median(rates[True])
        print(f"telemetry: socket BSP {CLUSTER_SHARDS}x{CLUSTER_WORKERS}, {TELEMETRY_ROUNDS} rounds, in turns "
              f"off/on/on/off: hot_keys off {', '.join(f'{x:.2f}' for x in rates[False])} rounds/s, on "
              f"{', '.join(f'{x:.2f}' for x in rates[True])} rounds/s; medians {off:.2f} / {on:.2f} "
              f"({(on / off - 1) * 100:+.1f} %); {card}")

        # the checked run: exact counts, the recorder and the SLO engine
        exact = _ExactCounts(agg, NUM_ITEMS)
        reg = MetricsRegistry()
        det = EWMADriftDetector("cluster_shard_rtt_seconds", field="p99")
        skew = SkewTracker("cluster_shard_rtt_seconds", entity_label="shard", field="p50", min_points=2)
        rec = TimelineRecorder(reg, detectors=[det], skew=[skew])
        slo = SLOEngine(default_slos(), registry=reg)
        sample_s = []

        def tick(w, t):  # by hand, once a round (worker 0's round start)
            if w == 0:
                t0 = time.perf_counter()
                rec.sample()
                sample_s.append(time.perf_counter() - t0)
                slo.sample()

        zero_counts()
        with driver(reg, True) as d:
            check(agg.labels() == [f"shard-{s}" for s in range(CLUSTER_SHARDS)],
                  f"telemetry: the checked run registered {agg.labels()}")
            check(all(s.store.table.device.type == dev.type for s in d.shards),
                  f"telemetry: not every shard slice is on {dev.type}")
            r = d.run(stream, timeout=600, round_hook=tick)
            tick(0, TELEMETRY_ROUNDS)  # the last round's window
            torch.cuda.synchronize()
            del ranked_on[:]
            top = agg.top_k(TELEMETRY_TOP)
            on_card = list(ranked_on)
            every = agg.candidates(1 << 20)
            cpu = hotkeys.HotKeyAggregator(device="cpu")
            for label in agg.labels():
                cpu.register(label, agg._sketches[label])
            cpu_top = cpu.top_k(TELEMETRY_TOP)
            t_card = []
            for _ in range(20):
                t0 = time.perf_counter()
                agg.top_k(TELEMETRY_TOP)
                t_card.append(time.perf_counter() - t0)
            t_host = []
            for _ in range(20):
                t0 = time.perf_counter()
                agg.candidates(TELEMETRY_TOP)
                t_host.append(time.perf_counter() - t0)
            bound = agg.error_bound()
            shard_sketches = {label: agg._sketches[label] for label in agg.labels()}
            p50, frames = _pull_p50(reg)
        read_counts("telemetry: the checked hot_keys run", {})
        labels_after = agg.labels()

        # (a) the card's ranking
        check(on_card == ["cuda"] and len(top) == TELEMETRY_TOP,
              f"telemetry: top_k ranked on {on_card}, {len(top)} keys")
        host_rank = sorted(every, key=lambda t: -t["count"])[:TELEMETRY_TOP]
        check(top == cpu_top == host_rank,
              f"telemetry: top_k on the card {top} differs from the CPU {cpu_top} / host {host_rank} ranking")
        same10 = [t["count"] for t in top] == [t["count"] for t in every[:TELEMETRY_TOP]]
        print(f"telemetry: (a) top_k({TELEMETRY_TOP}) ranked on the card equals the CPU aggregator's and a host "
              f"sort of all {len(every)} candidates by reported count; candidates({TELEMETRY_TOP}) (space-saving "
              f"order) {'agrees' if same10 else 'differs'} rank for rank; top_k {statistics.median(t_card) * 1e3:.3f} "
              f"ms (merge on the host + dense_topk on the card), candidates() {statistics.median(t_host) * 1e3:.3f} "
              f"ms (host), medians of 20; {card}")

        # (b) the bounds against exact counts
        merged = sum(exact.exact[label] for label in shard_sketches)
        _check_bounds("merged shard sketches", top, merged, bound)
        heavy = 0
        for label, sk in shard_sketches.items():
            tracked = {t["key"] for t in sk.top_k(None)}
            over = np.flatnonzero(exact.exact[label] > sk.total // sk.topk.capacity)
            heavy += len(over)
            check(set(over.tolist()) <= tracked, f"telemetry: {label} lost a key above N/K")
        top_true = int(merged.max())
        print(f"telemetry: (b) every reported count within [true, true + max(err, {bound})]; {heavy} keys above a "
              f"shard's N/K, all tracked; each frame's ids are deduplicated by the client, so a key counts at most "
              f"once a frame: the top true count {top_true} is held by {int((merged == top_true).sum())} keys, and "
              f"the reported 10 have true counts {[int(merged[t['key']]) for t in top]}; {card}")
        raw = hotkeys.HotKeySketch(ClusterConfig.hot_key_k)
        raw_agg = hotkeys.HotKeyAggregator()
        raw_exact = _ExactCounts(raw_agg, NUM_ITEMS)
        raw_agg.register("stream", raw)
        for b in stream:
            raw.observe(b["item"])
        raw_top = raw_agg.top_k(TELEMETRY_TOP)
        truth = raw_exact.exact["stream"]
        order = np.argsort(-truth, kind="stable")
        check(truth[order[TELEMETRY_TOP - 1]] > truth[order[TELEMETRY_TOP]],
              "telemetry: the raw stream's 10th and 11th keys tie")
        check(sorted(t["key"] for t in raw_top) == sorted(order[:TELEMETRY_TOP].tolist()),
              f"telemetry: the raw-stream sketch's top 10 {[t['key'] for t in raw_top]} are not the 10 "
              f"most-observed keys {order[:TELEMETRY_TOP].tolist()}")
        _check_bounds("the raw-stream sketch", raw_top, truth, raw_agg.error_bound())
        print(f"telemetry: (b) a HotKeySketch({ClusterConfig.hot_key_k}) over the run's {int(truth.sum())} raw item "
              f"ids names the 10 most-observed keys {order[:TELEMETRY_TOP].tolist()} (ranked on the card), counts "
              f"{[t['count'] for t in raw_top]} within the bounds; {card}")
        flush = exact.flush_s
        print(f"telemetry: sketch flushes in the checked run: {len(flush)}, "
              f"{statistics.median(flush) * 1e3:.3f} ms median, {max(flush) * 1e3:.3f} ms max; {card}")

        # (c) stop() unregistered every sketch
        check(labels_after == [], f"telemetry: stop() left {labels_after}")

        # (d) the timeline
        payload = json.loads(json.dumps(rec.payload()))
        shards_seen = {s["labels"].get("shard") for s in payload["series"]
                       if s["metric"] == "cluster_shard_rtt_seconds"}
        check(shards_seen == {str(s) for s in range(CLUSTER_SHARDS)},
              f"telemetry: shard round-trip series for {sorted(shards_seen)}")
        check(payload["samples"] == TELEMETRY_ROUNDS + 1 and payload["skew"][0]["last"] is not None,
              f"telemetry: {payload['samples']} samples, skew {payload['skew'][0]['last']}")
        verdict = payload["skew"][0]["last"]
        print(f"telemetry: (d) TimelineRecorder: {payload['samples']} samples by hand, {len(payload['series'])} "
              f"series, sample {statistics.median(sample_s) * 1e3:.3f} ms median ({max(sample_s) * 1e3:.3f} max); "
              f"skew over shard round trips: shard {verdict['entity']} at {verdict['ratio']}x the median "
              f"(flagged {verdict['flagged']}); {len(payload['anomalies'])} anomalies; {card}")

        # (e) the SLO verdicts
        verdicts = slo.verdicts()
        check([v["slo"] for v in verdicts] == [s.name for s in default_slos()]
              and all(v["verdict"] in ("ok", "burning", "breach", "no_data") for v in verdicts),
              f"telemetry: SLO verdicts {verdicts}")
        check(next(v for v in verdicts if v["slo"] == "pull_p99")["window_total"] > 0,
              "telemetry: the pull objective saw no observation")
        print("telemetry: (e) SLO verdicts: " + ", ".join(
            f"{v['slo']} {v['verdict']} (burn {v['burn_short']}/{v['burn_long']})" for v in verdicts)
            + f"; pull p50 {p50 * 1e3:.3f} ms over {frames} frames; {card}")

        # (f) an SLO breach drives exactly one live scale-out
        mf = create_workload("mf", WorkloadParams(rounds=TELEMETRY_ROUNDS, batch=BATCH, num_users=NUM_USERS,
                                                  num_items=NUM_ITEMS, dim=DIM_UNFUSED), device=dev)
        ereg = MetricsRegistry()
        ed = build_cluster_driver(
            mf, config=ElasticClusterConfig(num_shards=2, num_workers=2, wal_dir=os.path.join(tmp, "wal")),
            driver_cls=ElasticClusterDriver, registry=ereg,
        )
        reports, failures, done, made = [], [], threading.Event(), {}
        scale_out = ed.scale_out

        def recorded_scale_out():
            reports.append(scale_out())
            return reports[-1]

        ed.scale_out = recorded_scale_out
        rounds_c = ereg.counter("cluster_worker_rounds_total", component="cluster")

        def control():
            try:
                seen = None
                while not done.is_set():
                    v = rounds_c.value
                    if v >= 2 and v != seen:
                        seen = v
                        if not made:
                            # a tenth of this run's p50 so far (its first frames
                            # are the slowest): most pulls break the objective;
                            # the raw thresholds are parked out of reach, so
                            # only the SLO pressures
                            made["threshold"] = _pull_p50(ereg)[0] / 10
                            made["slo"] = SLOEngine([pull_latency_slo(made["threshold"])], registry=ereg,
                                                    register_gauges=False)
                            made["ctl"] = ElasticController(ed, slo=made["slo"], registry=ereg, policy=ScalePolicy(
                                max_shards=3, scale_out_rtt_p99_s=1e9, min_window_frames=10**9,
                                scale_out_queue_depth=1e9, cooldown_s=0.0))
                        made["ctl"].step()
                    time.sleep(0.001)
            except BaseException as e:  # re-raised on the main thread below
                failures.append(e)

        zero_counts()
        ed.start()
        th = threading.Thread(target=control, name="telemetry-smoke-control", daemon=True)
        try:
            th.start()
            er = ed.run(mf.batches(), timeout=600)
            done.set()
            th.join(timeout=300)
            check(not th.is_alive(), "telemetry: the controller thread hung")
            if failures:
                raise failures[0]
            acked = sum(c.rows_pushed for c in ed._clients)
            applied = sum(sh.rows_applied for sh in ed.all_shards)
            shards_after = ed.partitioner.num_shards
            ep50, _ = _pull_p50(ereg)
        finally:
            done.set()
            ed.stop()
        read_counts("telemetry: the SLO-driven elastic run", {})
        check("ctl" in made, "telemetry: the elastic run ended before the controller was made")
        ctl, engine, threshold = made["ctl"], made["slo"], made["threshold"]
        outs = [e for e in ctl.events if e["action"] == "scale_out"]
        check(len(ctl.events) == 1 and len(outs) == 1 and outs[0]["ok"] and outs[0]["slo_breaches"] == ["pull_p99"],
              f"telemetry: the controller acted {ctl.events}")
        check(shards_after == 3 and len(reports) == 1, f"telemetry: {shards_after} shards, {len(reports)} reports")
        rep = reports[0]
        check(rep.verified and rep.mismatches == 0 and rep.rows_moved > 0,
              f"telemetry: the SLO-driven migration is not verified: {rep}")
        check(acked == applied > 0, f"telemetry: ledger acked {acked} != applied {applied}")
        check(threshold < ep50, f"telemetry: the objective {threshold} is not below the run's p50 {ep50}")
        print(f"telemetry: (f) pull objective {threshold * 1e3:.3f} ms (a tenth of the elastic run's p50 after "
              f"2 worker rounds; its whole-run p50 {ep50 * 1e3:.3f} ms): ElasticController(slo=) fired 1 scale-out 2 -> 3 at "
              f"{outs[0]['frames']} frames, burn {engine.status('pull_p99')['burn_short']}, migration "
              f"{rep.rows_moved} rows verified {rep.verified} with {rep.mismatches} mismatches; "
              f"{er.rounds / er.wall_s:.2f} rounds/s, ledger acked {acked} applied {applied}; {card}")
    finally:
        hotkeys.dense_topk = dense_topk
        hotkeys.set_aggregator(old_agg)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"telemetry: phase took {time.perf_counter() - t_phase:.1f} s; {card}")


HOT_STORM_SHARDS = 2
HOT_STORM_FRAC, HOT_STORM_SHARE, HOT_STORM_IDS = 0.01, 0.9, 4  # 1 % of the keys take 90 % of the requests
HOT_STORM_BOUND = 64  # lease bound in ticks (one tick a request)
HOT_STORM_K = 4096  # shard sketch slots: ~3x the 1,310-key hot set, as the reference's 128 clear its 40
HOT_STORM_WARMUP = 5000  # requests before the measured ones: ~14 sketch counts a hot key (min_count 10)
HOT_STORM_REQUESTS = 1500  # measured requests an arm
HOT_STORM_ARMS = ("off", "on")  # one pair: the second pair (~45 s on the card) went to the shmem phase
HOT_STORM_LINK_MS = 1.0  # the proxied request leg's delay (benchmarks/hotcache_storm.py's link_delay_ms)
HOT_TRAIN_TIMED = (False, True)  # hot_cache off / on: one pair (the second pair went to the dense_dp phase)
HOT_WITNESS_ROUNDS = 3
HOT_TOP = 32  # ClusterConfig.hot_cache_top_n


def _client_wire_bytes(reg):
    """Client-role bytes on the wire, both directions (``net_bytes_total``,
    utils/net.py), from ``reg``."""
    return sum(float(i.value or 0.0) for i in reg.instruments()
               if i.name == "net_bytes_total" and i.labels.get("role") == "client")


def _strict_scrape(host, port):
    """GET /metrics over ``http.client``: status 200, the exposition
    content type, Content-Length equal to the body, and every line a
    ``# TYPE`` line or ``name{labels} value``.  Returns (text, ms)."""
    import http.client
    import re

    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*",?)*\})? '
                        r'(NaN|[+-]Inf|[-+]?[0-9.]+([eE][-+]?[0-9]+)?)$')
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.request("GET", "/metrics")
    resp = conn.getresponse()
    body = resp.read()
    ms = (time.perf_counter() - t0) * 1e3
    conn.close()
    check(resp.status == 200, f"hotcache: GET /metrics answered {resp.status}")
    check(resp.getheader("Content-Type") == "text/plain; version=0.0.4; charset=utf-8",
          f"hotcache: /metrics content type {resp.getheader('Content-Type')}")
    check(len(body) == int(resp.getheader("Content-Length")), "hotcache: /metrics Content-Length differs")
    text = body.decode("utf-8")
    bad = [ln for ln in text.splitlines() if ln and not ln.startswith("# TYPE ") and not sample.match(ln)]
    check(not bad, f"hotcache: /metrics lines that do not parse: {bad[:3]}")
    return text, ms


def _storm_requests(seed, n, hot_ids):
    """benchmarks/hotcache_storm.py's stream: each of a request's ids is
    hot with probability 0.9 (uniform over the hot set), else uniform over
    the table."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        hot = rng.random(HOT_STORM_IDS) < HOT_STORM_SHARE
        ids = np.where(hot, rng.choice(hot_ids, size=HOT_STORM_IDS),
                       rng.integers(0, NUM_ITEMS, size=HOT_STORM_IDS))
        out.append(ids.astype(np.int64))
    return out


def phase_hotcache(torch, dev, card):
    """The hot-key lease cache (``hotcache/``) and the telemetry plane's
    surfaces on the card.  (a) The reference's hot-key storm
    (benchmarks/hotcache_storm.py: 1 % of the keys take 90 % of the
    requests, 4 ids a request, lease bound 64 ticks, one closed-loop
    reader, a writer client pushing 2 hot ids every 50 ms) at the MF item
    table's width, 131,072 x 64 float32 on a 2-shard ``ClusterDriver``
    whose slices are CUDA tensors (the reference runs 4,096 x 32); only
    the request count is cut: 5,000 warm-up requests (so a hot key is seen
    ~14 times, past the policy's min_count 10) and 1,500 measured requests
    an arm, arms off, on.  As in the reference, the reader and the
    writer reach every shard through a ``nemesis.ChaosProxy`` that delays
    each request frame 1 ms (``set_delay(1.0, 0.0, "c2s")``: one LAN round
    trip a request burst).  Then ``CachedLookupService.top_k`` over all
    131,072 ids on the card, over the direct links, against a float64 numpy
    ranking of the shards' rows.  (b) The
    cluster phase's MF (100,000 x 131,072, dim 64, lr 0.01,
    ``zipf_stream(9, 12)``, socket 4 shards x 2 workers, range partition,
    SSP bound 2) with ``hot_cache`` off, on; a checked
    ``hot_cache=True`` run (the final table the shards' own rows bitwise,
    every worker cache within its bound; a worker pushes every id it
    pulls, so its own push drops each leased row in the round it was
    leased and its cache serves no hit; a ``CachedLookupService`` reader
    on the card leasing and reading the stream's 32 hottest items while it
    trains, held to ``check_lease_staleness``); BSP 4 shards x 1 worker
    (one worker: two workers' adds land in arrival order) with
    ``hot_cache=True`` (no client cache) bitwise against ``False``.  (c)
    During the checked run a ``TelemetryServer`` answers a strict HTTP
    scrape of ``/metrics`` and ``/hot``, ``/hotkeys``, ``/timeline``,
    ``/healthz``; after it the run report is built and written under a
    temporary directory; then 3 rounds under ``lockwitness.capture()``
    against the same 3 rounds unwitnessed.  No kernel of the port
    launches."""
    import shutil
    import tempfile
    import threading

    from flink_parameter_server_tpu_torch.cluster import ClusterConfig, ClusterDriver
    from flink_parameter_server_tpu_torch.cluster.client import ClusterClient
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.core.transform import transform_batched
    from flink_parameter_server_tpu_torch.hotcache import (
        CachedLookupService, HotRowCache, LeasePolicy, StaticHotSet, register_cache, unregister_cache,
    )
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization, SGDUpdater,
    )
    from flink_parameter_server_tpu_torch.nemesis import ChaosProxy
    from flink_parameter_server_tpu_torch.nemesis.invariants import check_lease_staleness, check_lock_inversions
    from flink_parameter_server_tpu_torch.telemetry import hotkeys, lockwitness
    from flink_parameter_server_tpu_torch.telemetry import report as report_mod
    from flink_parameter_server_tpu_torch.telemetry.exporter import TelemetryServer, scrape
    from flink_parameter_server_tpu_torch.telemetry.registry import MetricsRegistry, get_registry, set_registry
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    t_phase = time.perf_counter()
    old_agg, old_reg = hotkeys.get_aggregator(), get_registry()
    tmp = tempfile.mkdtemp(prefix="hotcache-", dir=os.path.join(REPO, "build"))
    try:
        # ---- (a) the hot-key storm, the serving half ----------------------
        rng = np.random.default_rng(0)
        n_hot = int(NUM_ITEMS * HOT_STORM_FRAC)
        hot_ids = rng.choice(NUM_ITEMS, size=n_hot, replace=False).astype(np.int64)
        stream = _storm_requests(10, HOT_STORM_WARMUP + HOT_STORM_REQUESTS, hot_ids)
        init = ranged_random_factor(7, (DIM_UNFUSED,))
        arms, leased_sets = [], []

        def storm_driver():
            logic = OnlineMatrixFactorization(64, DIM_UNFUSED, updater=SGDUpdater(0.05), seed=1, device=dev)
            return ClusterDriver(logic, capacity=NUM_ITEMS, value_shape=(DIM_UNFUSED,), init_fn=init,
                                 config=ClusterConfig(num_shards=HOT_STORM_SHARDS, num_workers=1,
                                                      staleness_bound=None, hot_keys=True,
                                                      hot_key_k=HOT_STORM_K),
                                 registry=False, device=dev)

        zero_counts()
        for i, arm in enumerate(HOT_STORM_ARMS):
            reg = MetricsRegistry()
            set_registry(reg)  # the clients' wire ledger lands here
            hotkeys.set_aggregator(hotkeys.HotKeyAggregator())
            d = storm_driver().start()
            check(all(s.store.table.device.type == dev.type for s in d.shards),
                  f"hotcache: storm slices not on {dev.type}")
            direct = [(s.host, s.port) for s in d.servers]
            proxies = []
            for j, (host, port) in enumerate(direct):
                proxies.append(ChaosProxy(host, port, name=f"nemesis-storm-{arm}-{j}", registry=False).start())
                # the request leg only: one delay a request burst, however
                # many frames it pipelines (benchmarks/hotcache_storm.py)
                proxies[-1].set_delay(HOT_STORM_LINK_MS, 0.0, "c2s")
            addrs = [(p.host, p.port) for p in proxies]
            writer = ClusterClient(addrs, d.partitioner, (DIM_UNFUSED,), registry=False, worker="storm-writer")
            reader = ClusterClient(addrs, d.partitioner, (DIM_UNFUSED,), registry=False, worker=f"storm-{arm}")
            cache = policy = None
            if arm == "on":
                policy = LeasePolicy(hotkeys.get_aggregator(), top_n=max(64, 2 * n_hot), min_count=10,
                                     refresh_s=0.05)
                cache = HotRowCache(HOT_STORM_BOUND, capacity=max(64, 2 * n_hot), worker=f"storm-{arm}")
                reader.attach_hotcache(cache, policy, lease_ttl=2 * HOT_STORM_BOUND)
            lat = np.empty(HOT_STORM_REQUESTS)
            stop, writes, errs = threading.Event(), [0], []

            def write_loop():
                wrng = np.random.default_rng(1)
                try:
                    while not stop.is_set():
                        writer.push_batch(wrng.choice(hot_ids, size=2, replace=False),
                                          np.full((2, DIM_UNFUSED), 1e-3, np.float32))
                        writes[0] += 1
                        stop.wait(0.05)
                except BaseException as e:  # re-raised below
                    errs.append(e)

            try:
                for ids in stream[:HOT_STORM_WARMUP]:
                    reader.pull_batch(ids)
                if policy is not None:
                    t0 = time.perf_counter()
                    policy.refresh()
                    refresh_ms = (time.perf_counter() - t0) * 1e3
                    leased_sets.append(set(policy.hot_keys().tolist()))
                    refreshes0 = policy.refreshes
                h0 = None if cache is None else dict(cache.stats())
                bytes0 = _client_wire_bytes(reg)
                wt = threading.Thread(target=write_loop, name="hotcache-storm-writer", daemon=True)
                wt.start()
                t_arm = time.perf_counter()
                for j, ids in enumerate(stream[HOT_STORM_WARMUP:]):
                    t0 = time.perf_counter()
                    reader.pull_batch(ids)
                    lat[j] = time.perf_counter() - t0
                wall = time.perf_counter() - t_arm
                stop.set()
                wt.join(timeout=30)
                check(not wt.is_alive() and not errs, f"hotcache: the storm writer failed: {errs}")
                wire = _client_wire_bytes(reg) - bytes0
                res = {"arm": arm, "p50": float(np.percentile(lat, 50)) * 1e3,
                       "p99": float(np.percentile(lat, 99)) * 1e3, "rps": HOT_STORM_REQUESTS / wall,
                       "bytes": wire / HOT_STORM_REQUESTS, "writes": writes[0]}
                if cache is not None:
                    st = cache.stats()
                    verdict = check_lease_staleness(st, HOT_STORM_BOUND)
                    check(verdict.ok, f"hotcache: storm arm {i}: {verdict.detail}")
                    hits, misses = st["hits"] - h0["hits"], st["misses"] - h0["misses"]
                    res.update(hit_rate=hits / max(1, hits + misses), leases=reader.leases_acquired,
                               refresh_ms=refresh_ms, refreshes=policy.refreshes - refreshes0,
                               revocations=st["revocations"], max_age=st["max_served_age"],
                               queued=sum(s.leases.stats()["invalidations_queued"] for s in d.shards),
                               verdict=verdict.detail)
                arms.append(res)
                if i == len(HOT_STORM_ARMS) - 1:
                    # the cross-shard top-K on the card, as of a flush after
                    # the writer stopped
                    writer.flush()
                    truth = np.empty((NUM_ITEMS, DIM_UNFUSED), np.float32)
                    for s in d.shards:
                        truth[s.owned] = s.values()
                    query = truth[int(np.random.default_rng(3).integers(NUM_ITEMS))]
                    s64 = (truth.astype(np.float64) @ query.astype(np.float64)).astype(np.float32)
                    want = np.lexsort((np.arange(NUM_ITEMS), -s64))[:10]  # ties lowest id first
                    svcs = {k: CachedLookupService(addresses=direct, partitioner=d.partitioner,
                                                   value_shape=(DIM_UNFUSED,), policy=StaticHotSet(hot_ids),
                                                   bound=HOT_STORM_BOUND, hedge_after_s=None, registry=False,
                                                   worker=f"topk-{k}", device=k) for k in ("cuda", "cpu")}
                    try:
                        everything = np.arange(NUM_ITEMS, dtype=np.int64)
                        got = svcs["cuda"].top_k(query, everything, k=10)
                        check(np.array_equal(got[1], want),
                              f"hotcache: top_k on the card {got[1].tolist()} != float64 ranking {want.tolist()}")
                        check(bool(np.allclose(got[0], s64[want], rtol=1e-6, atol=0)),
                              f"hotcache: top_k scores {got[0]} != {s64[want]}")
                        times = {}
                        for k, svc in svcs.items():
                            ts = []
                            for _ in range(5):
                                t0 = time.perf_counter()
                                svc.top_k(query, everything, k=10)
                                ts.append(time.perf_counter() - t0)
                            times[k] = statistics.median(ts) * 1e3
                        ts = []
                        plain = ClusterClient(direct, d.partitioner, (DIM_UNFUSED,), registry=False,
                                              worker="topk-numpy")
                        for _ in range(5):
                            t0 = time.perf_counter()
                            rows = plain.pull_batch(everything)
                            np.argsort(-(rows.astype(np.float64) @ query.astype(np.float64)))[:10]
                            ts.append(time.perf_counter() - t0)
                        plain.close()
                        times["numpy"] = statistics.median(ts) * 1e3
                        ties = int(len(np.unique(s64[want])) < 10)
                    finally:
                        for svc in svcs.values():
                            svc.close()
            finally:
                stop.set()
                reader.close()
                writer.close()
                for p in proxies:
                    p.stop()
                d.stop()
        read_counts("hotcache: the storm arms", {})
        for res in arms:
            line = (f"hotcache: (a) storm {res['arm']} (behind ChaosProxy, {HOT_STORM_LINK_MS} ms on the request "
                    f"leg): {HOT_STORM_REQUESTS} requests, p50 {res['p50']:.3f} ms "
                    f"p99 {res['p99']:.3f} ms, {res['rps']:.1f} requests/s, {res['bytes']:.1f} wire bytes a "
                    f"request (client, both directions), writer pushes {res['writes']}")
            if "hit_rate" in res:
                line += (f"; hit rate {res['hit_rate']:.4f}, leases {res['leases']}, revocations "
                         f"{res['revocations']}, invalidations queued {res['queued']}, worst served age "
                         f"{res['max_age']} (bound {HOT_STORM_BOUND}); the policy's refresh (the sketches' merge "
                         f"and candidate ranking on the host) {res['refresh_ms']:.3f} ms, {res['refreshes']} of them "
                         f"in the measured requests")
            print(line + f"; {card}")
        off_b = statistics.median(r["bytes"] for r in arms if r["arm"] == "off")
        on_b = statistics.median(r["bytes"] for r in arms if r["arm"] == "on")
        hot_set = set(hot_ids.tolist())
        print(f"hotcache: (a) wire bytes a request on/off {on_b / off_b:.4f}; the policy leased "
              f"{[len(s) for s in leased_sets]} keys, {[len(s & hot_set) for s in leased_sets]} of them in the "
              f"{n_hot}-key hot set; {card}")
        print(f"hotcache: (a) CachedLookupService.top_k(query, all {NUM_ITEMS} ids, k=10) on the card equals the "
              f"float64 ranking (ids exact, scores rtol 1e-6; float32 ties in the top 10: {ties}); "
              f"{times['cuda']:.3f} ms on the card, {times['cpu']:.3f} ms with device='cpu', "
              f"{times['numpy']:.3f} ms for a pull of every row and a numpy ranking, medians of 5; {card}")

        # ---- (b) training under the hot cache -----------------------------
        set_registry(old_reg)
        agg = hotkeys.HotKeyAggregator()  # device=None: the card
        hotkeys.set_aggregator(agg)
        mf_stream = zipf_stream(9, CLUSTER_ROUNDS)
        mf_init = ranged_random_factor(1, (DIM_UNFUSED,))
        ssp = dict(num_shards=CLUSTER_SHARDS, num_workers=CLUSTER_WORKERS, staleness_bound=CLUSTER_SSP_BOUND)

        def mf_driver(reg, **cfg):
            logic = OnlineMatrixFactorization(NUM_USERS, DIM_UNFUSED, updater=SGDUpdater(LEARNING_RATE), device=dev)
            return ClusterDriver(logic, capacity=NUM_ITEMS, value_shape=(DIM_UNFUSED,), init_fn=mf_init,
                                 config=ClusterConfig(**cfg), registry=reg, device=dev)

        rates = {False: [], True: []}
        zero_counts()
        for hot in HOT_TRAIN_TIMED:
            with mf_driver(MetricsRegistry(), hot_cache=hot, **ssp) as d:
                r = d.run(mf_stream, timeout=600)
            rates[hot].append(r.rounds / r.wall_s)
        off, on = statistics.median(rates[False]), statistics.median(rates[True])
        print(f"hotcache: (b) socket SSP {CLUSTER_SSP_BOUND} {CLUSTER_SHARDS}x{CLUSTER_WORKERS}, {CLUSTER_ROUNDS} "
              f"rounds, in turns off/on: hot_cache off {', '.join(f'{x:.2f}' for x in rates[False])} "
              f"rounds/s, on {', '.join(f'{x:.2f}' for x in rates[True])} rounds/s; medians {off:.2f} / {on:.2f} "
              f"({(on / off - 1) * 100:+.1f} %); {card}")

        # the checked run, with the surfaces live
        reg = MetricsRegistry()
        items = np.concatenate([b["item"] for b in mf_stream]).astype(np.int64)
        counts = np.bincount(items, minlength=NUM_ITEMS)
        true_top = np.lexsort((np.arange(NUM_ITEMS), -counts))[:HOT_TOP]
        scraped, reader_errs = {}, []
        tel = TelemetryServer(reg, port=0).start()

        def mid_run(w, t):
            if w == 0 and t == CLUSTER_ROUNDS // 2:
                scraped["metrics"], scraped["metrics_ms"] = _strict_scrape(tel.host, tel.port)
                for path in ("hot", "hotkeys", "timeline", "healthz"):
                    t0 = time.perf_counter()
                    scraped[path] = json.loads(scrape(tel.host, tel.port, path, timeout=30))
                    scraped[f"{path}_ms"] = (time.perf_counter() - t0) * 1e3
                scraped["shard_stats"] = [s.stats() for s in d.shards]

        d = mf_driver(reg, hot_cache=True, **ssp)
        svc = None
        try:
            with d:
                check([c.hotcache is not None and c.hotcache.bound == CLUSTER_SSP_BOUND for c in d._clients]
                      == [True] * CLUSTER_WORKERS, "hotcache: the SSP workers did not get a bound-2 cache")
                svc = CachedLookupService(addresses=[(s.host, s.port) for s in d.servers], partitioner=d.partitioner,
                                          value_shape=(DIM_UNFUSED,), policy=StaticHotSet(true_top),
                                          bound=CLUSTER_SSP_BOUND, hedge_after_s=None, registry=reg,
                                          worker="reader", device=dev)
                register_cache("reader", svc.cache)
                done = threading.Event()

                def read_loop():
                    rrng = np.random.default_rng(4)
                    try:
                        while not done.is_set():
                            svc.lookup(rrng.choice(true_top, size=HOT_STORM_IDS))
                    except BaseException as e:  # re-raised below
                        reader_errs.append(e)

                rt = threading.Thread(target=read_loop, name="hotcache-training-reader", daemon=True)
                rt.start()
                try:
                    r = d.run(mf_stream, timeout=600, round_hook=mid_run)
                finally:
                    done.set()
                    rt.join(timeout=60)
                check(not rt.is_alive() and not reader_errs, f"hotcache: the training reader failed: {reader_errs}")
                truth = np.empty((NUM_ITEMS, DIM_UNFUSED), np.float32)
                for s in d.shards:
                    truth[s.owned] = s.values()
                stats = [c.hotcache.stats() for c in d._clients]
                leases = [c.leases_acquired for c in d._clients]
                leased = [set(c.lease_policy.hot_keys().tolist()) for c in d._clients]
                reader_stats = svc.cache.stats()
                shard_stats = [s.stats() for s in d.shards]
                t0 = time.perf_counter()
                report = report_mod.build_run_report(reg, wall_s=r.wall_s)
                platform = report_mod._default_platform()
                paths = report_mod.write_run_report(report, results_dir=os.path.join(tmp, "results", platform))
                report_ms = (time.perf_counter() - t0) * 1e3
        finally:
            if svc is not None:
                svc.close()
                unregister_cache("reader")
            tel.stop()
        read_counts("hotcache: the hot_cache training runs", {})
        check(r.values.tobytes() == truth.tobytes(), "hotcache: the final table is not the shards' own rows bitwise")
        check(bool(np.isfinite(r.values).all()), "hotcache: the SSP hot_cache table is not finite")
        # the anchor phase_cluster's arms are held against: the single-process table
        store = ShardedParamStore.create(NUM_ITEMS, (DIM_UNFUSED,), init_fn=mf_init, device=dev)
        logic = OnlineMatrixFactorization(NUM_USERS, DIM_UNFUSED, updater=SGDUpdater(LEARNING_RATE), device=dev)
        base = transform_batched(mf_stream, logic, store, dump_model=False,
                                 collect_outputs=False).store.values().cpu().numpy()
        err = float(np.abs(r.values.astype(np.float64) - base).max())
        for w, st in enumerate(stats):
            check(st["max_served_age"] <= CLUSTER_SSP_BOUND, f"hotcache: worker {w} served age {st['max_served_age']}")
            check(leases[w] > 0 and st["fills"] == leases[w], f"hotcache: worker {w} leased {leases[w]}, {st}")
        verdict = check_lease_staleness(reader_stats, CLUSTER_SSP_BOUND)
        check(verdict.ok, f"hotcache: the training reader: {verdict.detail}")
        print(f"hotcache: (b) checked hot_cache=True run: {r.rounds / r.wall_s:.2f} rounds/s; the final table is "
              f"the shards' own rows bitwise; max_abs_err against the single-process table {err:.3e} (phase_cluster "
              f"holds its SSP arm to finite values; the same here); {card}")
        for w, st in enumerate(stats):
            print(f"hotcache: (b) worker {w} cache: hits {st['hits']}, misses {st['misses']}, leases {leases[w]}, "
                  f"fills {st['fills']}, revocations {st['revocations']}, entries {st['entries']}, worst served age "
                  f"{st['max_served_age']} (bound {CLUSTER_SSP_BOUND}); {len(leased[w] & set(true_top.tolist()))} "
                  f"of its {len(leased[w])} leased keys are among the stream's true top {HOT_TOP}")
        print(f"hotcache: (b) reader on the card leasing and reading the stream's {HOT_TOP} hottest items "
              f"(4 a lookup) while it trains: "
              f"{verdict.detail}, hit rate {reader_stats['hit_rate']}; shard lease boards: "
              + ", ".join(f"shard {s['shard']} sessions {s['lease_sessions']} active {s['leases_active']}"
                          for s in shard_stats) + f"; {card}")

        # BSP with hot_cache=True: no client cache, the table bitwise
        bsp = dict(num_shards=CLUSTER_SHARDS, num_workers=1, staleness_bound=0)
        zero_counts()
        tables = {}
        for hot in (True, False):
            with mf_driver(False, hot_cache=hot, **bsp) as d:
                if hot:
                    check(all(c.hotcache is None for c in d._clients), "hotcache: a BSP client got a cache")
                tables[hot] = d.run(mf_stream, timeout=600).values
        read_counts("hotcache: the BSP runs", {})
        check(tables[True].tobytes() == tables[False].tobytes(),
              "hotcache: BSP with hot_cache=True is not bitwise the hot_cache=False table")
        print(f"hotcache: (b) BSP {CLUSTER_SHARDS}x1 with hot_cache=True: no client cache, the table bitwise the "
              f"hot_cache=False run's; {card}")

        # ---- (c) the surfaces ----------------------------------------------
        text = scraped["metrics"]
        for name in ("fps_hotcache_hits_total", "fps_hotcache_misses_total", "fps_hotcache_revocations_total",
                     "fps_hotcache_stale_rejects_total", "fps_hotcache_entries", "fps_hotcache_leases_granted_total",
                     "fps_hotcache_invalidations_total", "fps_hotcache_leases_active", "fps_hot_key_traffic",
                     "fps_cluster_pull_rtt_seconds_bucket"):
            check(name in text, f"hotcache: /metrics lacks {name}")
        for s in range(CLUSTER_SHARDS):
            check(f'fps_hotcache_leases_active{{component="hotcache",shard="{s}"}}' in text,
                  f"hotcache: /metrics lacks shard {s}'s leases_active")
        mid = scraped["shard_stats"]
        check(all("lease_sessions" in s and "leases_active" in s for s in mid)
              and sum(s["lease_sessions"] for s in mid) > 0,
              f"hotcache: the shards' stats mid-run {[(s.get('lease_sessions'), s.get('leases_active')) for s in mid]}")
        hot = scraped["hot"]["hot"]
        check(bool(hot["top"]) and {"worker-0", "worker-1", "reader"} <= set(hot["caches"])
              and all("leased" in row for row in hot["top"]), f"hotcache: /hot payload {hot}")
        check(bool(scraped["hotkeys"]["hot_keys"]["top"]), "hotcache: /hotkeys has no top keys")
        check("timeline" in scraped["timeline"] and scraped["healthz"]["status"] == "ok",
              f"hotcache: /timeline or /healthz {scraped['timeline']}, {scraped['healthz']}")
        n_lines = sum(1 for ln in text.splitlines() if ln and not ln.startswith("#"))
        print(f"hotcache: (c) mid-run strict scrape of /metrics: {n_lines} samples parse, "
              f"{scraped['metrics_ms']:.3f} ms; /hot {scraped['hot_ms']:.3f} ms ({len(hot['top'])} top keys, "
              f"{sum(1 for row in hot['top'] if row['leased'])} leased), /hotkeys {scraped['hotkeys_ms']:.3f} ms, "
              f"/timeline {scraped['timeline_ms']:.3f} ms, /healthz {scraped['healthz_ms']:.3f} ms; "
              f"shards' lease_sessions {[s['lease_sessions'] for s in mid]}, leases_active "
              f"{[s['leases_active'] for s in mid]}; {card}")
        with open(paths["json"]) as f:
            written = json.load(f)
        check(platform == "gpu" and os.path.dirname(paths["json"]).endswith(os.path.join("results", "gpu")),
              f"hotcache: the report's platform is {platform}")
        check(written.get("hot_keys") is not None and written.get("hotcache") is not None
              and os.path.getsize(paths["md"]) > 0, "hotcache: the run report lacks its hot-key sections")
        print(f"hotcache: (c) run report: platform {platform}, sections {sorted(written)}, hot-cache hit rate "
              f"{written['hotcache']['hit_rate']}, built and written in {report_ms:.3f} ms; {card}")

        # the lock witness against the same rounds unwitnessed
        short = mf_stream[:HOT_WITNESS_ROUNDS]
        witness_rates = {}
        zero_counts()
        for witnessed in (False, True, True, False):
            if witnessed:
                with lockwitness.capture() as w:
                    with mf_driver(False, hot_cache=True, **ssp) as d:
                        r = d.run(short, timeout=600)
                inv = check_lock_inversions(w.inversions)
                check(inv.ok and w.acquisitions > 0, f"hotcache: lock witness: {inv.detail}, "
                                                     f"{w.acquisitions} acquisitions")
                acquisitions = w.acquisitions
            else:
                with mf_driver(False, hot_cache=True, **ssp) as d:
                    r = d.run(short, timeout=600)
            witness_rates.setdefault(witnessed, []).append(r.rounds / r.wall_s)
        read_counts("hotcache: the lock-witness runs", {})
        wo, wi = statistics.median(witness_rates[False]), statistics.median(witness_rates[True])
        print(f"hotcache: (c) lockwitness.capture() over {HOT_WITNESS_ROUNDS} rounds of the SSP hot_cache run: "
              f"{inv.detail}, {acquisitions} acquisitions witnessed; {', '.join(f'{x:.2f}' for x in witness_rates[True])} "
              f"rounds/s witnessed against {', '.join(f'{x:.2f}' for x in witness_rates[False])} unwitnessed "
              f"(medians {wi:.2f} / {wo:.2f}, {(wi / wo - 1) * 100:+.1f} %); {card}")
    finally:
        set_registry(old_reg)
        hotkeys.set_aggregator(old_agg)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"hotcache: phase took {time.perf_counter() - t_phase:.1f} s; {card}")


ADAPTIVE_WORKERS, ADAPTIVE_SHARDS = 4, 2  # benchmarks/straggler_ab.py's topology
ADAPTIVE_BOUND, ADAPTIVE_SUBGROUPS = 2, 8  # its declared SSP bound and row groups a worker
ADAPTIVE_LAG_MS = 25.0  # worker 0's symmetric per-frame link delay (its --lag-ms 25)
ADAPTIVE_DEADLINE_S = 6.0  # each arm's driver.run(deadline_s=...)
ADAPTIVE_MF_ROUNDS = 24  # more rounds than either MF arm reaches in the deadline (checked; 9-18 on an H100)
ADAPTIVE_PA = dict(ELASTIC_PA, rounds=14)  # ELASTIC_PA's width; rounds past what an arm reaches (checked; 5-9 on an H100)
ADAPTIVE_METRIC = "cluster_pull_rtt_seconds"
ADAPTIVE_RMSE_BAR = 1.10  # adaptive RMSE <= fixed RMSE x 1.10, the reference's bar
ADAPTIVE_DRAIN_SHARDS = 3
ADAPTIVE_REPORT_DECISIONS = 40  # the run report's decision tail (telemetry/report.py)


def _lagged_driver_cls(lag_ms):
    """``benchmarks/straggler_ab.py``'s ``LaggedWorkerDriver``: an elastic
    cluster whose worker 0 reaches every shard through a ``ChaosProxy`` that
    delays each frame ``lag_ms`` both ways (its client is built against a
    membership view whose addresses are the proxies'; the healthy workers
    and the control plane dial direct)."""
    import dataclasses

    from flink_parameter_server_tpu_torch.elastic import ElasticClusterDriver
    from flink_parameter_server_tpu_torch.nemesis import ChaosProxy

    class _LaggedMembership:
        def __init__(self, inner, addresses):
            self._inner, self._addresses = inner, tuple(tuple(a) for a in addresses)

        def current(self):
            return dataclasses.replace(self._inner.current(), addresses=self._addresses, replicas=())

        def __getattr__(self, name):
            return getattr(self._inner, name)

    class LaggedWorkerDriver(ElasticClusterDriver):
        def __init__(self, logic, **kwargs):
            self.lag_proxies = []
            super().__init__(logic, **kwargs)

        def _make_client(self, worker=None):
            if worker != "0":
                return super()._make_client(worker)
            real = self.membership
            for host, port in real.current().addresses:
                p = ChaosProxy(host, port, name=f"lag-{port}", seed=11, registry=False).start()
                p.set_delay(lag_ms, 0.0, "both")
                self.lag_proxies.append(p)
            self.membership = _LaggedMembership(real, [(p.host, p.port) for p in self.lag_proxies])
            try:
                return super()._make_client(worker)
            finally:
                self.membership = real

        def stop(self):
            super().stop()
            for p in self.lag_proxies:
                p.stop()
            self.lag_proxies = []

    return LaggedWorkerDriver


def _rmse(values, oracle) -> float:
    v, o = np.asarray(values, np.float64), np.asarray(oracle, np.float64)
    return float(np.sqrt(np.mean((v - o) ** 2)))


def _adaptive_surfaces(rt, reg, card):
    """With the runtime installed: ``/adaptive`` and the run report's
    adaptive section are non-null and equal ``rt.payload()`` (the report
    keeps the decision ring's tail)."""
    from flink_parameter_server_tpu_torch.adaptive import set_adaptive_runtime
    from flink_parameter_server_tpu_torch.telemetry.exporter import TelemetryServer, scrape
    from flink_parameter_server_tpu_torch.telemetry.report import build_run_report

    set_adaptive_runtime(rt)
    tel = TelemetryServer(reg, port=0).start()
    try:
        t0 = time.perf_counter()
        doc = json.loads(scrape(tel.host, tel.port, "adaptive"))
        scrape_ms = (time.perf_counter() - t0) * 1e3
        section = build_run_report(reg).get("adaptive")
    finally:
        tel.stop()
        set_adaptive_runtime(None)
    payload = json.loads(json.dumps(rt.payload()))
    check(doc.get("adaptive") is not None and section is not None,
          "adaptive: /adaptive or the run report's adaptive section is null with a runtime installed")
    check(doc["adaptive"] == payload, "adaptive: /adaptive differs from rt.payload()")
    decisions = payload["decisions"]
    want = dict(payload, decisions=decisions[-ADAPTIVE_REPORT_DECISIONS:],
                decisions_truncated=max(0, len(decisions) - ADAPTIVE_REPORT_DECISIONS))
    check(json.loads(json.dumps(section)) == want, "adaptive: the run report's adaptive section differs from rt.payload()")
    print(f"adaptive: /adaptive and the run report's section equal rt.payload() ({len(decisions)} decisions, "
          f"{payload['ticks']} ticks; scrape {scrape_ms:.1f} ms); {card}")


def _adaptive_arm(torch, dev, card, wl, batches, oracle, adaptive, surfaces=False):
    """One arm of the straggler A/B (``benchmarks/straggler_ab.py`` run_arm):
    an elastic 4-worker x 2-shard hash cluster at SSP bound 2, worker 0
    lagged, one unmeasured round, then ``driver.run(deadline_s=6)``."""
    from flink_parameter_server_tpu_torch.adaptive import AdaptiveRuntime, RebalancePolicy, WorkRouter
    from flink_parameter_server_tpu_torch.elastic import ElasticClusterConfig
    from flink_parameter_server_tpu_torch.nemesis.invariants import (
        AdaptiveBoundSampler, check_adaptive_bound, check_exactly_once,
    )
    from flink_parameter_server_tpu_torch.telemetry.registry import MetricsRegistry
    from flink_parameter_server_tpu_torch.telemetry.timeline import SkewTracker, TimelineRecorder
    from flink_parameter_server_tpu_torch.workloads import build_cluster_driver

    arm = "adaptive" if adaptive else "fixed"
    reg = MetricsRegistry()
    cfg = ElasticClusterConfig(
        num_shards=ADAPTIVE_SHARDS, num_workers=ADAPTIVE_WORKERS, staleness_bound=ADAPTIVE_BOUND,
        partition="hash", adaptive=adaptive, adaptive_push_hedge_after_s=0.01 if adaptive else None,
    )
    driver = build_cluster_driver(wl, config=cfg, driver_cls=_lagged_driver_cls(ADAPTIVE_LAG_MS), registry=reg)
    tl = rt = None
    with driver:
        check(all(s.store.table.device.type == dev.type for s in driver.shards),
              f"adaptive: {wl.name} {arm}: a shard slice is not on {dev.type}")
        driver.run(batches[:1], timeout=600)  # the same unmeasured round in both arms
        if adaptive:
            tl = TimelineRecorder(
                reg, interval_s=0.04, include=lambda n: n == ADAPTIVE_METRIC,
                skew=[SkewTracker(ADAPTIVE_METRIC, entity_label="worker", field="p50",
                                  min_points=2, warmup_evals=2)],
            ).start()
            router = WorkRouter(ADAPTIVE_WORKERS, subgroups=ADAPTIVE_SUBGROUPS)
            driver.work_router = router
            rt = AdaptiveRuntime(
                driver, tl, interval_s=0.04, registry=reg,
                rebalance=RebalancePolicy(router, persist_evals=2, cooldown_s=0.1,
                                          max_moves=ADAPTIVE_SUBGROUPS, groups_per_move=4, round_delay=2),
            ).start()
        zero_counts()
        try:
            with AdaptiveBoundSampler(driver, interval_s=0.002) as sampler:
                r = driver.run(batches, deadline_s=ADAPTIVE_DEADLINE_S, timeout=600)
        finally:
            if rt is not None:
                rt.stop()
            if tl is not None:
                tl.stop()
        read_counts(f"adaptive: {wl.name} {arm} arm", {})
        acked = sum(c.rows_pushed for c in driver._clients)
        applied = sum(s.rows_applied for s in driver.shards)
        ledger = check_exactly_once(acked, applied)
        check(ledger.ok, f"adaptive: {wl.name} {arm}: {ledger.detail}")
        rounds = max(r.clock["clocks"])
        check(rounds < len(batches), f"adaptive: {wl.name} {arm} ran out of stream ({rounds} rounds): "
                                     f"the deadline no longer bounds the run")
        if surfaces:
            _adaptive_surfaces(rt, reg, card)
    rmse = _rmse(r.values, oracle)
    check(bool(np.isfinite(r.values).all()), f"adaptive: {wl.name} {arm}: the table is not finite")
    print(f"adaptive: {wl.name} {arm}: {r.events} events in {r.wall_s:.3f} s: goodput {r.updates_per_sec:.1f} "
          f"events/s, worker clocks {r.clock['clocks']} of {len(batches)} rounds, RMSE against the fault-free oracle "
          f"{rmse:.6g}, acked == applied == {acked} rows; {card}")
    out = {"goodput": r.updates_per_sec, "rmse": rmse}
    if adaptive:
        p = rt.payload()
        samples = sampler.samples
        verdict = check_adaptive_bound(samples, ADAPTIVE_BOUND, 2 * ADAPTIVE_BOUND + 1)
        mech = dict(widenings=p["counts"]["widenings"], narrowings=p["counts"]["narrowings"],
                    hedged_pushes=p["hedge"]["issued"], push_hedges_won=p["hedge"]["won"],
                    work_moves=p["rebalance"]["moves"])
        print(f"adaptive: {wl.name} adaptive mechanisms: {mech}, {len(p['decisions'])} decisions, "
              f"{p['ticks']} ticks; bound envelope: {verdict.detail}; {card}")
        check(verdict.ok, f"adaptive: {wl.name}: {verdict.detail}")
        check(mech["widenings"] + mech["hedged_pushes"] + mech["work_moves"] > 0,
              f"adaptive: {wl.name}: the adaptive arm fired no mechanism ({mech})")
    return out


def _mf_at_lr(params, dev, lr):
    """``MFWorkload`` with its SGD step size set to ``lr``: the workload's
    own 0.05 diverges at the main path's width after 16-24 rounds of
    65,536 ratings (non-finite by round 32 on the CPU), inside the stream a
    deadline-bound arm needs; the main path's 0.01 stays finite."""
    from flink_parameter_server_tpu_torch.models.matrix_factorization import OnlineMatrixFactorization, SGDUpdater
    from flink_parameter_server_tpu_torch.workloads.mf import MFWorkload

    class _MF(MFWorkload):
        def make_logic(self):
            return OnlineMatrixFactorization(self.params.num_users, self.params.dim,
                                             updater=SGDUpdater(lr), seed=1, device=self.device)

    return _MF(params, device=dev)


def phase_adaptive(torch, dev, card):
    """The straggler-adaptive runtime on the card (``adaptive/``), as
    ``benchmarks/straggler_ab.py`` runs it: an ``ElasticClusterDriver``
    with 4 workers x 2 shards, hash partition, SSP bound 2 (ceiling 5),
    slices on the card; worker 0's links to every shard cross a
    ``ChaosProxy`` that delays each frame 25 ms both ways
    (``set_delay(25, 0, "both")``, as the reference builds the link).  Per workload a fixed arm
    and an adaptive arm (``adaptive=True``, push hedging after 10 ms, a
    ``TimelineRecorder`` at 40 ms with a ``SkewTracker`` on the workers' pull
    round-trip p50, ``AdaptiveRuntime`` at 40 ms with a ``RebalancePolicy``,
    ``AdaptiveBoundSampler`` at 2 ms), each under ``run(deadline_s=6)``
    after one unmeasured round: MF at 100,000 x 131,072, dim 64, 65,536
    ratings a round, lr 0.01 (the workload's 0.05 diverges at this width
    within the stream), then PA at the elastic phase's 8,192 features x
    1,024 examples a round.  Checks: the bound envelope, a mechanism fired,
    adaptive RMSE <= fixed x 1.10 against the fault-free oracle, acked ==
    applied, no kernel launch.  Then ``drain_shard(0)`` on a 3-shard elastic
    MF driver at full width (every row bitwise, shard 0 empty), and
    ``/adaptive`` and the run report's section equal to ``rt.payload()``."""
    import shutil
    import tempfile

    from flink_parameter_server_tpu_torch.elastic import ElasticClusterConfig, ElasticClusterDriver
    from flink_parameter_server_tpu_torch.workloads import WorkloadParams, build_cluster_driver, create_workload

    t_phase = time.perf_counter()
    mf = _mf_at_lr(WorkloadParams(rounds=ADAPTIVE_MF_ROUNDS, batch=BATCH, num_users=NUM_USERS, num_items=NUM_ITEMS,
                                  dim=DIM_UNFUSED, num_workers=ADAPTIVE_WORKERS), dev, LEARNING_RATE)
    pa = create_workload("pa", WorkloadParams(**ADAPTIVE_PA, num_workers=ADAPTIVE_WORKERS), device=dev)
    for wl in (mf, pa):
        t0 = time.perf_counter()
        batches = wl.batches()
        oracle = wl.oracle_values()
        print(f"adaptive: {wl.name} stream ({len(batches)} rounds) and fault-free oracle built in "
              f"{time.perf_counter() - t0:.1f} s")
        fixed = _adaptive_arm(torch, dev, card, wl, batches, oracle, adaptive=False)
        adapt = _adaptive_arm(torch, dev, card, wl, batches, oracle, adaptive=True, surfaces=wl is mf)
        ratio = adapt["goodput"] / fixed["goodput"]
        print(f"adaptive: {wl.name}: goodput adaptive / fixed = {adapt['goodput']:.1f} / {fixed['goodput']:.1f} "
              f"= {ratio:.3f}x; RMSE {adapt['rmse']:.6g} against {fixed['rmse']:.6g} (bar x{ADAPTIVE_RMSE_BAR}); {card}")
        check(adapt["rmse"] <= fixed["rmse"] * ADAPTIVE_RMSE_BAR,
              f"adaptive: {wl.name}: adaptive RMSE {adapt['rmse']:.6g} over the fixed arm's "
              f"{fixed['rmse']:.6g} x {ADAPTIVE_RMSE_BAR}")
        del batches, oracle

    # drain_shard(0) at weight 0 on a 3-shard elastic MF driver at full width
    tmp = tempfile.mkdtemp(prefix="adaptive-", dir=os.path.join(REPO, "build"))
    try:
        drain_mf = create_workload("mf", WorkloadParams(rounds=2, batch=BATCH, num_users=NUM_USERS,
                                                        num_items=NUM_ITEMS, dim=DIM_UNFUSED), device=dev)
        d = build_cluster_driver(
            drain_mf, config=ElasticClusterConfig(num_shards=ADAPTIVE_DRAIN_SHARDS, num_workers=1,
                                                  wal_dir=os.path.join(tmp, "drain")),
            driver_cls=ElasticClusterDriver, registry=False,
        )
        with d:
            zero_counts()
            d.run(drain_mf.batches(), timeout=600)

            def table():
                out = np.empty((NUM_ITEMS, DIM_UNFUSED), np.float32)
                seen = np.zeros(NUM_ITEMS, bool)
                for s in d.shards:
                    out[s.owned] = s.values()
                    seen[s.owned] = True
                check(bool(seen.all()), "adaptive: drain: a row has no owner")
                return out

            before = table()
            t0 = time.perf_counter()
            report = d.drain_shard(0)
            drain_ms = (time.perf_counter() - t0) * 1e3
            after = table()
            read_counts("adaptive: the drain run", {})
            check(report.verified and report.mismatches == 0, f"adaptive: drain: {report}")
            check(len(d.shards[0].owned) == 0 and d.partitioner.owned_ids(0).size == 0,
                  "adaptive: drain: shard 0 still owns keys")
            check(all(s.store.table.device.type == dev.type for s in d.shards), "adaptive: drain: a slice left the card")
            check(before.tobytes() == after.tobytes(), "adaptive: drain: a row changed")
        print(f"adaptive: drain_shard(0) at weight 0 on {ADAPTIVE_DRAIN_SHARDS} card shards ({NUM_ITEMS:,} x "
              f"{DIM_UNFUSED}): {report.rows_moved:,} rows moved in {drain_ms:.1f} ms, verified, 0 mismatches, "
              f"every row bitwise, shard 0 owns 0 keys; {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"adaptive: phase took {time.perf_counter() - t_phase:.1f} s; {card}")


TIER_ROWS, TIER_DIM, TIER_HOT = 1 << 24, 16, 1 << 20  # benchmarks/tierstore_soak.py's defaults
TIER_BATCH, TIER_WARMUP, TIER_ROUNDS = 8192, 100, 400  # its --batch, --warmup, --rounds
TIER_CARD_SLACK = 16 << 20  # a batch's transients beside the hot tier on the card (index and row tensors)
TIER_LEG_ROWS, TIER_LEG_DIM = 1 << 12, 4  # its correctness legs' shapes
TIER_CLUSTER_ROUNDS = 12  # the cluster phase's run length


def _log_uniform(rng, n, batch):
    """benchmarks/tierstore_soak.py's draw: ``id = floor(n^u) - 1``, u ~ U[0, 1)."""
    return np.minimum(np.exp(rng.random(batch) * np.log(n)).astype(np.int64), n - 1)


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _tier_soak_arm(torch, dev, card, arm, stream):
    """One soak arm over the deduplicated stream: per round one pull (rows
    to the host, as a shard answers) and one push, timed to the end of the
    device work; the first ``TIER_WARMUP`` rounds untimed."""
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore, push as store_push
    from flink_parameter_server_tpu_torch.core.transform import to_device, to_host
    from flink_parameter_server_tpu_torch.ops.rows import take_rows
    from flink_parameter_server_tpu_torch.tierstore import TieredStore

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rss0 = _rss_bytes()
    store = st = None
    if arm == "dense":
        store = ShardedParamStore.create(TIER_ROWS, (TIER_DIM,), device=dev)
    else:
        st = TieredStore(TIER_ROWS, (TIER_DIM,), hot_rows=TIER_HOT, name_hint=arm,
                         device=dev if arm == "tiered-card" else "cpu")
    pulls, pushes, samples = [], [], []
    for i, (ids, deltas) in enumerate(stream):
        t = time.perf_counter()
        if store is not None:
            rows = to_host(take_rows(store.table, to_device(ids, dev)))
        else:
            rows = st.gather(ids)
        t_pull = time.perf_counter() - t
        t = time.perf_counter()
        if store is not None:
            store_push(store.spec, store.table, to_device(ids, dev), to_device(deltas, dev))
        else:
            st.push(ids, deltas)
        torch.cuda.synchronize()
        t_push = time.perf_counter() - t
        if i >= TIER_WARMUP:
            pulls.append(t_pull)
            pushes.append(t_push)
        if st is not None:
            # the fields stats() reports, read without its flush of the
            # sketch buffer (which would move the fold out of the timed
            # window)
            samples.append({arm: (st.resident, st.hot_rows)})
        del rows
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    rss = _rss_bytes() - rss0
    t = time.perf_counter()
    values = to_host(store.values(), copy=True) if store is not None else st.values()
    values_s = time.perf_counter() - t
    pct = lambda xs, q: float(np.percentile(np.asarray(xs), q)) * 1e3  # noqa: E731
    out = dict(pull50=pct(pulls, 50), pull99=pct(pulls, 99), push50=pct(pushes, 50), push99=pct(pushes, 99),
               peak=peak, rss=rss, samples=samples)
    line = (f"tierstore: soak {arm}: pull p50 {out['pull50']:.3f} / p99 {out['pull99']:.3f} ms, push p50 "
            f"{out['push50']:.3f} / p99 {out['push99']:.3f} ms ({TIER_ROUNDS} timed rounds after {TIER_WARMUP}); "
            f"card peak {peak / 2**20:.1f} MiB over the arm's start; host RSS +{rss / 2**20:.1f} MiB; "
            f"values() {values_s:.2f} s")
    if st is not None:
        s = st.stats()
        refs = 2 * sum(ids.size for ids, _ in stream)
        out.update(hit_rate=s["hits"] / refs, stats=s)
        scan_ms = s["cum_evict_scan_s"] / max(1, s["evict_scans"]) * 1e3
        line += (f"; hit rate {out['hit_rate']:.4f} ({s['hits']:,} hits, {s['misses']:,} misses of {refs:,} "
                 f"references), promotes {s['promotes']:,}, demotes {s['demotes']:,} ({s['demote_writes']:,} "
                 f"written), spills {s['spills']:,}, {s['evict_scans']} eviction scans ({scan_ms:.1f} ms each, "
                 f"{s['cum_evict_scan_s']:.2f} s in all), slab {s['slab_rows']:,} rows, {s['decays']} decays")
        st.close()
    print(f"{line}; {card}")
    del store, st
    return out, values


def _tier_legs(torch, dev, card, tmp):
    """The soak's correctness legs (``benchmarks/tierstore_soak.py``
    leg_parity_bitwise, leg_wal_replay, the kill -> promote chain,
    leg_migration) on tiered shards whose hot tiers are on the card."""
    from flink_parameter_server_tpu_torch.cluster import ConsistentHashPartitioner, RangePartitioner, ShardServer
    from flink_parameter_server_tpu_torch.cluster.shard import ParamShard
    from flink_parameter_server_tpu_torch.elastic import execute_moves, plan_moves
    from flink_parameter_server_tpu_torch.nemesis.invariants import TierResidencySampler, check_tier_residency
    from flink_parameter_server_tpu_torch.replication import ReplHub, ReplicaShard, WALShipper
    from flink_parameter_server_tpu_torch.replication.failover import verify_against_log
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    R, D = TIER_LEG_ROWS, TIER_LEG_DIM

    def tiered(sid, part, hot, **kw):
        return ParamShard(sid, part, (D,), registry=False, store_backend="tiered", tier_hot_rows=hot,
                          device=dev, **kw)

    t0 = time.perf_counter()
    with TierResidencySampler(interval_s=0.002) as sampler:
        # tiered against the reference leg's dense numpy shard over the same
        # raw pushes (duplicates add in arrival order in both), bitwise
        part, init = RangePartitioner(R, 1), ranged_random_factor(11, (D,))

        def host_init(ids):
            return init(torch.from_numpy(np.asarray(ids, np.int64))).numpy()

        a = tiered(0, part, 64, init_fn=init)
        b = ParamShard(0, part, (D,), init_fn=host_init, registry=False, store_backend="numpy")
        try:
            check(a.store._hot.device.type == dev.type, "tierstore: leg parity: the hot tier is not on the card")
            rng = np.random.default_rng(3)
            for i in range(40):
                ids = _log_uniform(rng, R, 256)
                check(a.pull(ids).tobytes() == b.pull(ids).tobytes(), f"tierstore: leg parity: pull {i} differs")
                deltas = rng.normal(size=(256, D)).astype(np.float32)
                a.push(ids, deltas)
                b.push(ids, deltas)
            check(a.values().tobytes() == b.values().tobytes(), "tierstore: leg parity: values() differ")
        finally:
            a.close()
            b.close()
        # WAL replay through the cold rows
        init = ranged_random_factor(5, (D,))
        wal = os.path.join(tmp, "leg-wal")
        s = tiered(0, part, 48, init_fn=init, wal_dir=wal)
        try:
            rng = np.random.default_rng(9)
            for _ in range(30):
                s.push(_log_uniform(rng, R, 128), rng.normal(size=(128, D)).astype(np.float32))
            before = s.values().copy()
            s.crash()
            check(s.restart() == 30, "tierstore: leg WAL: restart replayed a wrong record count")
            check(s.values().tobytes() == before.tobytes(), "tierstore: leg WAL: the replayed slice differs")
        finally:
            s.close()
        reborn = tiered(0, part, 48, init_fn=init, wal_dir=wal)
        try:
            check(reborn.values().tobytes() == before.tobytes(), "tierstore: leg WAL: a fresh shard over the log differs")
        finally:
            reborn.close()
        # a tiered follower catches up, is promoted and passes the audit
        hpart, init = ConsistentHashPartitioner(R, 1), ranged_random_factor(13, (D,))
        primary = tiered(0, hpart, 48, init_fn=init, wal_dir=os.path.join(tmp, "leg-p"))
        follower = ReplicaShard(0, hpart, (D,), init_fn=init, wal_dir=os.path.join(tmp, "leg-f"), registry=False,
                                store_backend="tiered", tier_hot_rows=48, device=dev)
        fsrv = ShardServer(follower, supervised=False).start()
        hub = ReplHub()
        ship = WALShipper(primary, (fsrv.host, fsrv.port), hub.subscribe(), registry=False).start()
        primary.attach_repl_sink(hub)
        try:
            rng = np.random.default_rng(9)
            for _ in range(20):
                ids = rng.choice(R, 64, replace=False)
                primary.push(ids, rng.normal(size=(64, D)).astype(np.float32))
            deadline = time.monotonic() + 60
            while follower.repl_state()["applied"] != primary.head_seq() and time.monotonic() < deadline:
                time.sleep(0.005)
            check(follower.repl_state()["applied"] == primary.head_seq(), "tierstore: leg chain: the follower never caught up")
            check(primary.values().tobytes() == follower.values().tobytes(), "tierstore: leg chain: follower != primary")
            ship.stop()
            follower.catch_up()
            follower.promote_to_primary(1)
            check(follower.role == "primary" and verify_against_log(follower),
                  "tierstore: leg chain: the promoted follower fails verify_against_log")
        finally:
            ship.stop()
            fsrv.stop()
            primary.close()
            follower.close()
        # plan_moves / execute_moves between tiered shards, bitwise at handoff
        old = ConsistentHashPartitioner(R, 1, seed=2)
        new = old.grown(2)
        init = ranged_random_factor(3, (D,))
        src, dst = tiered(0, old, 64, init_fn=init), tiered(1, new, 64, init_fn=init)
        servers = [ShardServer(src, supervised=False).start(), ShardServer(dst, supervised=False).start()]
        try:
            rng = np.random.default_rng(1)
            for _ in range(10):
                src.push(_log_uniform(rng, R, 256), rng.normal(size=(256, D)).astype(np.float32))
            moves = plan_moves(old, new)
            pre = {mv.dst: src.snapshot_rows(mv.ids)[0] for mv in moves}
            report = execute_moves(moves, {0: src, 1: dst},
                                   {0: (servers[0].host, servers[0].port), 1: (servers[1].host, servers[1].port)},
                                   (D,), verify=True, registry=False)
            check(report.verified and report.mismatches == 0
                  and report.rows_moved == sum(len(m.ids) for m in moves), f"tierstore: leg migration: {report}")
            for mv in moves:
                check(dst.peek_rows(mv.ids).tobytes() == pre[mv.dst].tobytes(),
                      "tierstore: leg migration: a moved row differs at the destination")
        finally:
            for srv in servers:
                srv.stop()
            src.close()
            dst.close()
    verdict = check_tier_residency(sampler.samples)
    check(verdict.ok, f"tierstore: legs: {verdict.detail}")
    print(f"tierstore: (b) legs on card-backed tiered shards ({R:,} x {D}, hot tiers of 48-64 rows): tiered == "
          f"dense numpy bitwise over 40 pulls and raw pushes, WAL replay through cold rows bitwise (restart and a fresh "
          f"shard), a tiered follower caught up bitwise, promoted, verify_against_log, migration verified with "
          f"{report.rows_moved:,} rows bitwise at handoff; residency {verdict.detail}; "
          f"{time.perf_counter() - t0:.1f} s; {card}")


def phase_tierstore(torch, dev, card):
    """The two-tier store on the card (``tierstore/``).  (a) The soak of
    ``benchmarks/tierstore_soak.py`` at its own size: a 2**24-row x dim-16
    float32 slice (1 GiB dense) under its log-uniform draw, 8,192 ids a
    round deduplicated as the client does (``ops/dedup.aggregate_deltas``),
    100 untimed and 400 timed rounds, three arms: ``dense`` (the port's
    store on the card), ``tiered-card`` (a 2**20-row hot tier on the card,
    64 MiB) and ``tiered-host`` (``device="cpu"``, the reference's layout).
    Checks: residency in every round, both tiered arms' ``values()`` the
    dense arm's bitwise, ``tiered-card``'s peak on the card at most the hot
    tier plus 16 MiB.  (b) The soak's recovery legs on card-backed tiered
    shards.  (c) MF at 100,000 x 131,072, dim 64, BSP 4 workers x 2 shards
    with ``push_aggregate=True`` (one merged push per shard a round, so
    both runs apply the same float32 adds in the same order):
    ``store_backend="tiered"`` with a quarter of each shard's rows hot
    against ``"socket"``, bitwise, and ``/tiers`` naming both shards.  No
    kernel launches."""
    import shutil
    import tempfile

    from flink_parameter_server_tpu_torch.cluster import ClusterConfig
    from flink_parameter_server_tpu_torch.nemesis.invariants import TierResidencySampler, check_tier_residency
    from flink_parameter_server_tpu_torch.ops.dedup import aggregate_deltas
    from flink_parameter_server_tpu_torch.telemetry.exporter import TelemetryServer, scrape
    from flink_parameter_server_tpu_torch.telemetry.registry import MetricsRegistry
    from flink_parameter_server_tpu_torch.workloads import WorkloadParams, build_cluster_driver, create_workload

    t_phase = time.perf_counter()
    # (a) the soak
    rng, drng = np.random.default_rng(0), np.random.default_rng(1)
    stream = []
    for _ in range(TIER_WARMUP + TIER_ROUNDS):
        ids = _log_uniform(rng, TIER_ROWS, TIER_BATCH)
        stream.append(aggregate_deltas(ids, drng.normal(size=(TIER_BATCH, TIER_DIM)).astype(np.float32)))
    uniq = np.mean([ids.size for ids, _ in stream])
    print(f"tierstore: soak stream: {len(stream)} rounds of {TIER_BATCH:,} log-uniform ids over {TIER_ROWS:,} "
          f"rows, {uniq:.0f} unique a round on average, built in {time.perf_counter() - t_phase:.1f} s")
    zero_counts()
    arms = {}
    dense, dense_values = _tier_soak_arm(torch, dev, card, "dense", stream)
    for arm in ("tiered-card", "tiered-host"):
        arms[arm], values = _tier_soak_arm(torch, dev, card, arm, stream)
        check(values.tobytes() == dense_values.tobytes(), f"tierstore: soak {arm}: values() differ from dense")
        verdict = check_tier_residency(arms[arm]["samples"])
        check(verdict.ok, f"tierstore: soak {arm}: {verdict.detail}")
        del values
    read_counts("tierstore: the soak", {})
    del dense_values
    hot_bytes = TIER_HOT * TIER_DIM * 4
    card_peak = arms["tiered-card"]["peak"]
    check(card_peak <= hot_bytes + TIER_CARD_SLACK,
          f"tierstore: tiered-card peak {card_peak / 2**20:.1f} MiB over the hot tier's "
          f"{hot_bytes / 2**20:.0f} MiB + {TIER_CARD_SLACK >> 20} MiB")
    print(f"tierstore: soak: pull p50 tiered-card / dense {arms['tiered-card']['pull50'] / dense['pull50']:.2f}x, "
          f"tiered-host / dense {arms['tiered-host']['pull50'] / dense['pull50']:.2f}x (the reference's bar 2x); "
          f"card peak dense {dense['peak'] / 2**20:.1f} / tiered-card {card_peak / 2**20:.1f} / tiered-host "
          f"{arms['tiered-host']['peak'] / 2**20:.1f} MiB; both tiered values() == dense bitwise; residency held "
          f"in every round; {card}")
    del stream

    tmp = tempfile.mkdtemp(prefix="tierstore-", dir=os.path.join(REPO, "build"))
    try:
        # (b) the recovery planes
        zero_counts()
        _tier_legs(torch, dev, card, tmp)
        read_counts("tierstore: the legs", {})

        # (c) a tiered cluster against the socket one
        mf = create_workload("mf", WorkloadParams(rounds=TIER_CLUSTER_ROUNDS, batch=BATCH, num_users=NUM_USERS,
                                                  num_items=NUM_ITEMS, dim=DIM_UNFUSED), device=dev)
        batches = mf.batches()
        hot = NUM_ITEMS // 2 // 4
        vals, rates = {}, {}
        for backend in ("socket", "tiered"):
            reg = MetricsRegistry()
            d = build_cluster_driver(mf, config=ClusterConfig(
                num_shards=2, num_workers=4, staleness_bound=0, push_aggregate=True,
                store_backend=backend, tier_hot_rows=hot), registry=reg)
            zero_counts()
            with d:
                with TierResidencySampler(interval_s=0.005) as sampler:
                    r = d.run(batches, timeout=600)
                if backend == "tiered":
                    check(all(s.store._hot.device.type == dev.type and s.store.hot_rows == hot for s in d.shards),
                          "tierstore: (c) a shard's hot tier is not on the card")
                    tel = TelemetryServer(reg, port=0).start()
                    try:
                        tiers = json.loads(scrape(tel.host, tel.port, "tiers"))["tiers"]
                    finally:
                        tel.stop()
                    check(tiers is not None and {"shard-0", "shard-1"} <= set(tiers),
                          f"tierstore: (c) /tiers names {None if tiers is None else sorted(tiers)}")
                    verdict = check_tier_residency(sampler.samples)
                    check(verdict.ok, f"tierstore: (c) {verdict.detail}")
                    print(f"tierstore: (c) /tiers: " + ", ".join(
                        f"{k}: resident {v['resident_rows']:,}/{v['hot_capacity_rows']:,}, hits {v['hits']:,}, "
                        f"misses {v['misses']:,}, demotes {v['demotes']:,}, slab {v['slab_rows']:,}"
                        for k, v in sorted(tiers.items()) if k in ("shard-0", "shard-1"))
                        + f"; residency {verdict.detail}")
            read_counts(f"tierstore: (c) {backend}", {})
            vals[backend], rates[backend] = r.values, r.rounds / r.wall_s
        check(vals["tiered"].tobytes() == vals["socket"].tobytes(),
              "tierstore: (c) the tiered cluster's table differs from the socket one")
        print(f"tierstore: (c) MF {NUM_USERS:,} x {NUM_ITEMS:,} dim {DIM_UNFUSED}, BSP 4 workers x 2 shards, "
              f"push_aggregate, {TIER_CLUSTER_ROUNDS} rounds: tiered (hot {hot:,} of {NUM_ITEMS // 2:,} rows a "
              f"shard) {rates['tiered']:.2f} rounds/s against socket {rates['socket']:.2f}; final tables bitwise "
              f"equal; {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"tierstore: phase took {time.perf_counter() - t_phase:.1f} s; {card}")



NEMESIS_WITNESSED = "two_way_partition_heal"  # the battery's one scenario under lockwitness.capture()
NEMESIS_ANCHORS = ("asym_partition_during_migration", "kill_primary_under_partition",
                   "promote_while_client_partitioned")
NEMESIS_CLASSES = {"partition_both", "partition_c2s", "partition_s2c", "delay_frame", "drip_frame",
                   "truncate_rst", "half_open"}  # every proxy fault class, injected somewhere in the battery
NEMESIS_MF_FULL = ("kill_primary_under_partition", "promote_while_client_partitioned")
NEMESIS_FULL_ROUNDS = 12  # every op of the three full-width schedules sits at round 4 or 9: all kept
NEMESIS_SHRINK_RUNS = 24  # shrink()'s run budget


@contextlib.contextmanager
def _proxied_slices():
    """While open, records the device type of the slice of every shard the
    nemesis mesh builds (``_NemesisMeshMixin._build_shard``: the nemesis
    runner's drivers and the soak's)."""
    from flink_parameter_server_tpu_torch.nemesis import runner

    slices = []
    build_shard = runner._NemesisMeshMixin._build_shard

    def spy(self, shard_id, partitioner=None):
        shard, server = build_shard(self, shard_id, partitioner)
        table = getattr(shard.store, "table", None)
        slices.append((table if table is not None else shard.store._hot).device.type)
        return shard, server

    runner._NemesisMeshMixin._build_shard = spy
    try:
        yield slices
    finally:
        runner._NemesisMeshMixin._build_shard = build_shard


def _nemesis_line(r) -> str:
    verdicts = " ".join(f"{v.name}={'ok' if v.ok else 'FAIL'}" for v in r.verdicts)
    return (f"{r.scenario.name}: ok {r.ok} (expect {r.scenario.expect}), ops {r.ops_executed}/"
            f"{len(r.scenario.ops)}, rounds {r.rounds}, wall {r.wall_s:.3f} s, faults "
            f"{dict(sorted(r.faults.items()))}; {verdicts}")


def phase_nemesis(torch, dev, card):
    """The nemesis fault-injection harness on the card (``nemesis/``): every
    cluster it builds keeps its shards' slices, the workload's logic and the
    fault-free oracle's run on the card, and every shard link crosses a
    ``ChaosProxy``.  (a) The committed corpus (15 schedules at their own
    shapes) as ``benchmarks/nemesis_battery.py`` runs it,
    ``two_way_partition_heal`` under ``lockwitness.capture()``, failure
    artifacts under a temporary directory in ``build/``, held to the
    reference's acceptance checks: at least 8 passing scenarios, all ok; the
    three anchors ran every op; the seven fault classes injected; the seeded
    corruption fails ``final_table_parity`` alone and leaves its schedule and
    a flight-recorder dump that ``check_flightrec`` passes.  (b) ``shrink``
    of the seeded violation within 24 runs leaves exactly ``corrupt_row``, its
    JSON the committed ``seeded_corruption.json`` byte for byte.  (c) Full
    width: ``kill_primary_under_partition`` (elastic kill and replace under a
    two-way partition, WAL replay on the card) and
    ``promote_while_client_partitioned`` (a replica chain promoted while the
    client is cut off) at MF 100,000 x 131,072, dim 64, 65,536 ratings a
    round, 12 rounds, the workload's lr 0.05; ``sketch_full_stack``
    (replicated, ``q8`` requested, integer-exact) at the elastic phase's
    count-min width (8,192 x 4, 65,536 tokens a round, 12 rounds).  Each
    must satisfy every invariant the runner checks, parity against its
    oracle on the card included; each oracle's table must be finite.  No
    kernel launches (the shards take the store's ``"xla"`` arm)."""
    import dataclasses
    import shutil
    import tempfile

    from flink_parameter_server_tpu_torch.nemesis import runner
    from flink_parameter_server_tpu_torch.nemesis.scenarios import VIOLATION_SCENARIO
    from tools.check_metric_lines import check_flightrec

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="nemesis-", dir=os.path.join(REPO, "build"))
    with _proxied_slices() as slices:
        try:
            # ---- (a) the corpus battery -------------------------------------
            corpus = runner.load_corpus()
            artifacts = os.path.join(tmp, "artifacts")
            zero_counts()
            t0 = time.perf_counter()
            reports = [runner.run_scenario(s, wal_root=tmp, artifact_dir=artifacts, device=dev,
                                           witness=s.name == NEMESIS_WITNESSED) for s in corpus]
            battery_s = time.perf_counter() - t0
            read_counts("nemesis: the corpus battery", {})
            for r in reports:
                print(f"nemesis: (a) {_nemesis_line(r)}")
            by_name = {r.scenario.name: r for r in reports}
            passing = [r for r in reports if r.scenario.expect == "pass"]
            check(len(reports) == 15 and len(passing) >= 8, f"nemesis: {len(reports)} schedules, {len(passing)} passing")
            bad = [(r.scenario.name, [(v.name, v.detail) for v in r.verdicts if not v.ok]) for r in passing if not r.ok]
            check(not bad, f"nemesis: scenarios failed on the card: {bad}")
            for name in NEMESIS_ANCHORS:
                r = by_name[name]
                check(r.ok and r.ops_executed == len(r.scenario.ops),
                      f"nemesis: anchor {name} ran {r.ops_executed} of {len(r.scenario.ops)} ops")
            classes = set().union(*(r.faults for r in reports))
            check(NEMESIS_CLASSES <= classes, f"nemesis: fault classes never injected: {NEMESIS_CLASSES - classes}")
            witnessed = [r for r in reports if any(v.name == "no_lock_inversions" for v in r.verdicts)]
            check([r.scenario.name for r in witnessed] == [NEMESIS_WITNESSED] and witnessed[0].ok,
                  "nemesis: the witnessed scenario is missing or saw an inversion")
            v = by_name["seeded_corruption"]
            check(not v.ok and [x.name for x in v.verdicts if not x.ok] == ["final_table_parity"],
                  f"nemesis: the seeded corruption's failing verdicts {[x.name for x in v.verdicts if not x.ok]}")
            sched = [a for a in v.artifacts if "schedule" in a]
            frec = [a for a in v.artifacts if "flightrec" in a]
            check(bool(sched and frec), f"nemesis: the seeded corruption left artifacts {v.artifacts}")
            with open(sched[0]) as f:
                check(json.loads(f.read())["name"] == "seeded_corruption", "nemesis: the schedule artifact's name")
            with open(frec[0]) as f:
                lint = check_flightrec(json.load(f))
            check(lint == [], f"nemesis: the flight-recorder artifact fails check_flightrec: {lint}")
            check(bool(slices) and set(slices) == {dev.type}, f"nemesis: proxied slices on {sorted(set(slices))}")
            print(f"nemesis: (a) the corpus battery: {len(passing)} passing scenarios all ok, the seeded corruption "
                  f"caught by final_table_parity alone with its schedule and flight-recorder artifacts (check_flightrec "
                  f"clean), fault classes {sorted(classes)}, {len(slices)} proxied shard slices all on {dev.type}, in "
                  f"{battery_s:.1f} s; {card}")

            # ---- (b) the shrinker -------------------------------------------
            zero_counts()
            t0 = time.perf_counter()
            mini, runs = runner.shrink(
                VIOLATION_SCENARIO, lambda s: not runner.run_scenario(s, wal_root=tmp, device=dev).ok,
                max_runs=NEMESIS_SHRINK_RUNS)
            shrink_s = time.perf_counter() - t0
            read_counts("nemesis: the shrinker", {})
            with open(os.path.join(runner.CORPUS_DIR, "seeded_corruption.json")) as f:
                committed = f.read()
            check(runs <= NEMESIS_SHRINK_RUNS and [o.action for o in mini.ops] == ["corrupt_row"],
                  f"nemesis: shrink left {[o.action for o in mini.ops]} after {runs} runs")
            check(mini.to_json() + "\n" == committed, "nemesis: the shrunk schedule differs from seeded_corruption.json")
            print(f"nemesis: (b) shrink({VIOLATION_SCENARIO.name}): {len(VIOLATION_SCENARIO.ops)} ops -> "
                  f"{[o.action for o in mini.ops]} in {runs} runs, {shrink_s:.1f} s; byte-identical to the committed "
                  f"seeded_corruption.json; {card}")

            # ---- (c) full width ---------------------------------------------
            by_name = {s.name: s for s in corpus}
            full = [dataclasses.replace(by_name[n], num_users=NUM_USERS, num_items=NUM_ITEMS, dim=DIM_UNFUSED,
                                        batch=BATCH, rounds=NEMESIS_FULL_ROUNDS) for n in NEMESIS_MF_FULL]
            full.append(dataclasses.replace(by_name["sketch_full_stack"], **ELASTIC_SKETCH))
            for s in full:
                check(max(op.at_round for op in s.ops) < s.rounds, f"nemesis: {s.name}: an op past the run's end")
                t0 = time.perf_counter()
                oracle = runner.oracle_values(s, dev)
                oracle_s = time.perf_counter() - t0
                check(bool(np.isfinite(oracle).all()), f"nemesis: {s.name}: the oracle's table is not finite")
                del slices[:]
                zero_counts()
                r = runner.run_scenario(s, wal_root=tmp, device=dev)
                read_counts(f"nemesis: {s.name} at full width", {})
                print(f"nemesis: (c) {s.workload}, table {oracle.shape}, {s.batch:,} a round: {_nemesis_line(r)}; "
                      f"{r.rounds / r.wall_s:.3f} rounds/s over the run's wall time; oracle on {dev.type} in "
                      f"{oracle_s:.1f} s, its largest |value| {float(np.abs(oracle).max()):.6g}; {card}")
                bad = [(x.name, x.detail) for x in r.verdicts if not x.ok]
                check(r.ok and not bad, f"nemesis: {s.name} at full width: {bad}")
                check(r.ops_executed == len(s.ops) and r.rounds == s.rounds,
                      f"nemesis: {s.name}: {r.ops_executed} of {len(s.ops)} ops, {r.rounds} of {s.rounds} rounds")
                check(bool(slices) and set(slices) == {dev.type}, f"nemesis: {s.name}: slices on {sorted(set(slices))}")
                del oracle
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    print(f"nemesis: phase took {time.perf_counter() - t_phase:.1f} s; {card}")


LOADGEN_RECORDS = BATCHES_PER_EPOCH * BATCH  # phase_main's first epoch: two 65,536-rating microbatches
LOADGEN_DROP_EVERY = 50_000  # the socket producer's RST period: two drops over 131,072 lines
LOADGEN_ARM_S = 15.0  # the control-on arm's length
LOADGEN_CALIB = 100  # closed-loop requests a generator in the calibration
LOADGEN_SHARDS = 2  # benchmarks/soak_capacity.py's headline topology: 2 shards x replication factor 1
# benchmarks/soak_capacity.py's _base_config, with the MF table and the
# population at the main path's width
LOADGEN_SOAK = dict(
    generators=6, num_users=NUM_USERS, num_items=NUM_ITEMS, batch_ids=4, dim=DIM_UNFUSED,
    link_delay_ms=1.0, slo_ms=250.0, cache_bound=48, cache_capacity=512, hot_top_n=64,
    warmup_requests=96, request_timeout=5.0, connect_timeout=2.0, retry_timeout=10.0, seed=0,
    num_shards=LOADGEN_SHARDS, replication_factor=1,
)


def _soak_nemesis(duration_s):
    """benchmarks/soak_capacity.py's _nemesis_schedule: two partitions, a
    delay window and a kill-primary the controller must promote over,
    scaled to the arm's length."""
    from flink_parameter_server_tpu_torch.nemesis.scenarios import NemesisOp

    d = float(duration_s)
    return (
        (0.15 * d, NemesisOp(0, "partition", shard=0, mode="both", ms=500.0)),
        (0.35 * d, NemesisOp(0, "delay", shard=1, ms=3.0, jitter_ms=2.0)),
        (0.45 * d, NemesisOp(0, "clear_delay", shard=1)),
        (0.60 * d, NemesisOp(0, "partition", shard=1, mode="s2c", ms=400.0)),
        (0.80 * d, NemesisOp(0, "kill_shard", shard=0)),
    )


def _rating_lines(data) -> list:
    """MovieLens ``u.data`` lines (user, item, rating, timestamp; tabs), each
    rating in the shortest text that parses back to the same float32."""
    fmt = np.format_float_positional
    return [f"{u}\t{i}\t{fmt(r, unique=True)}\t{n}"
            for n, (u, i, r) in enumerate(zip(data["user"].tolist(), data["item"].tolist(), data["rating"]))]


def _parse_rating(line):
    user, item, rating = line.split("\t")[:3]
    return {"user": np.int32(user), "item": np.int32(item), "rating": np.float32(rating)}


def _loadgen_sources(torch, dev, card, tmp):
    """(1) The record sources at the main path's full width; returns K1's
    launches in the two source-fed runs."""
    from flink_parameter_server_tpu_torch import ps_online_mf
    from flink_parameter_server_tpu_torch.data import native_loader
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.socket import batches_from_records, socket_text_stream
    from flink_parameter_server_tpu_torch.data.streams import microbatches
    from flink_parameter_server_tpu_torch.resilience.chaos import ChaosLineServer

    t0 = time.perf_counter()
    native_loader.get_lib()  # raises NativeUnavailable without g++: nothing falls back here
    build_s = time.perf_counter() - t0
    data = synthetic_ratings(NUM_USERS, NUM_ITEMS, LOADGEN_RECORDS, seed=0)
    lines = _rating_lines(data)
    path = os.path.join(tmp, "u.data")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    cols = native_loader.load_ratings(path, compact_ids=False)
    same = all(np.array_equal(cols[k], data[k]) and cols[k].dtype == data[k].dtype for k in data)
    print(f"loadgen: (1) native library built in {build_s:.1f} s; load_ratings(compact_ids=False) of "
          f"{LOADGEN_RECORDS:,} ratings equal to the arrays bitwise: {'yes' if same else 'NO'}")
    check(same, "loadgen: the native loader's columns differ from the arrays")
    mf = dict(num_users=NUM_USERS, num_items=NUM_ITEMS, dim=DIM_UNFUSED, learning_rate=LEARNING_RATE,
              scatter_impl="pallas", device=dev)

    def timed(what, fn):
        zero_counts()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        k1 = read_counts(f"loadgen: {what}", {"scatter_add": BATCHES_PER_EPOCH})["scatter_add"]
        print(f"loadgen: (1) {what}: {LOADGEN_RECORDS / s:,.0f} records/s, {s:.3f} s wall; {card}")
        return out, k1

    ps_online_mf(microbatches(data, BATCH), **mf)  # untimed: the first run at these shapes pays the allocator
    native, k1_native = timed("ps_online_mf fed by the native loader",
                              lambda: ps_online_mf(native_loader.stream_batches(path, BATCH), **mf))
    memory, _ = timed("ps_online_mf fed from memory", lambda: ps_online_mf(microbatches(data, BATCH), **mf))
    for what, a, b in (("item table", native.store.values(), memory.store.values()),
                       ("user state", native.worker_state, memory.worker_state)):
        check(bool(torch.isfinite(a).all()), f"loadgen: the native-fed {what} is not finite")
        _same(torch, f"native-fed {what} vs the in-memory feed", a, b, "loadgen")

    fed = []

    def tap(batches):
        for b in batches:
            fed.append(b)
            yield b

    server = ChaosLineServer(lines, drop_every=LOADGEN_DROP_EVERY).start()
    try:
        stream = socket_text_stream(server.host, server.port)
        batches = batches_from_records(stream, BATCH, _parse_rating)
        _, _, drv = _driver_parts(torch, dev)
        sock, k1_socket = timed("StreamingDriver fed by the reconnecting socket",
                                lambda: drv.run(tap(batches)))
    finally:
        server.stop()
    _, _, drv = _driver_parts(torch, dev)
    mem_drv, _ = timed("StreamingDriver fed from memory", lambda: drv.run(microbatches(data, BATCH)))
    got = {k: np.concatenate([b[k][b["mask"]] for b in fed]) for k in data}
    once = all(np.array_equal(got[k], data[k]) for k in data)
    print(f"loadgen: (1) socket: {stream.reconnects} reconnects, {server.drops} drops, {batches.dropped} "
          f"undecodable records, {len(fed)} batches, every record delivered once in order: "
          f"{'yes' if once else 'NO'}")
    check(stream.reconnects >= 1 and server.drops >= 1, "loadgen: the socket feed never reconnected")
    check(batches.dropped == 0 and once, "loadgen: the socket feed lost, repeated or reordered records")
    for what, a, b in (("item table", sock.store.values(), mem_drv.store.values()),
                       ("user state", sock.worker_state, mem_drv.worker_state)):
        _same(torch, f"socket-fed {what} vs the in-memory feed", a, b, "loadgen")
    return k1_native + k1_socket


def _loadgen_soak(torch, dev, card):
    """(2) The open-loop soak at full width on the card."""
    import dataclasses

    from flink_parameter_server_tpu_torch.elastic.controller import ScalePolicy
    from flink_parameter_server_tpu_torch.loadgen.soak import SoakConfig, closed_loop_capacity, run_soak

    with _proxied_slices() as slices:
        base = SoakConfig(**LOADGEN_SOAK)
        zero_counts()
        cap = closed_loop_capacity(base, requests_per_generator=LOADGEN_CALIB, device=dev)
        read_counts("loadgen: closed_loop_capacity", {})
        print(f"loadgen: (2a) closed-loop capacity, MF {NUM_ITEMS:,} x {DIM_UNFUSED}, {base.num_users:,} users, "
              f"{LOADGEN_SHARDS} shards x 1 replica: {cap['capacity_rps']} req/s over {cap['requests']} requests, "
              f"closed p50 {cap['closed_p50_ms']} ms, p99 {cap['closed_p99_ms']} ms, {cap['wall_s']} s; {card}")
        check(cap["capacity_rps"] > 0, "loadgen: the calibration served nothing")
        cfg = dataclasses.replace(
            base, duration_s=LOADGEN_ARM_S, offered_rps=2.0 * cap["capacity_rps"], overload_control=True,
            nemesis=_soak_nemesis(LOADGEN_ARM_S),
            controller_policy=ScalePolicy(min_shards=LOADGEN_SHARDS, max_shards=LOADGEN_SHARDS,
                                          min_window_frames=1 << 30, cooldown_s=3600.0),
        )
        zero_counts()
        rep = run_soak(cfg, device=dev)
        read_counts("loadgen: the soak", {})
    s, o = rep.summary, rep.overload
    actions = [e.get("action") for e in rep.controller_events]
    verdicts = " ".join(f"{v.name}={'ok' if v.ok else 'FAIL'}" for v in rep.verdicts)
    print(f"loadgen: (2b) control-on arm at {cfg.offered_rps:.1f} req/s offered (2 x capacity) for "
          f"{LOADGEN_ARM_S:.0f} s: goodput {s['goodput_rps']} req/s ({s['goodput_rps'] / cap['capacity_rps']:.0%} "
          f"of capacity), admitted p50 {s['p50_ms']} ms, p99 {s['p99_ms']} ms; arrivals {s['arrivals']} = ok "
          f"{s['ok']} + late {s['late']} + shed {s['shed']} + error {s['error']}; budget exhaustions "
          f"{o.get('budget_exhausted')}, breaker opens {o.get('breakers_open_transitions')}, brownouts "
          f"{o.get('brownouts')}, client-deadline sheds {o.get('client_deadline_sheds')}, shard-edge sheds "
          f"{o.get('shard_edge_sheds')}; faults {dict(sorted(rep.faults.items()))}; controller {actions}; "
          f"{verdicts}; {len(slices)} proxied shard slices on {sorted(set(slices))}; wall {rep.wall_s:.1f} s; {card}")
    bad = [(v.name, v.detail) for v in rep.verdicts if not v.ok]
    check(not bad, f"loadgen: soak verdicts failed: {bad}")
    check(s["arrivals"] == s["ok"] + s["late"] + s["shed"] + s["error"], "loadgen: the goodput ledger does not balance")
    check(s["error"] == 0, f"loadgen: {s['error']} errors in the control-on arm: {s.get('error_samples')}")
    check(s["latency_anchor"] == "arrival", "loadgen: latency not anchored to the arrival")
    check(rep.faults.get("partition_both", 0) >= 1, "loadgen: the two-way partition never fired")
    check("promote" in actions, f"loadgen: no promote after kill_shard(0): {actions}")
    check(bool(slices) and set(slices) == {dev.type}, f"loadgen: proxied slices on {sorted(set(slices))}")
    json.dumps(rep.as_dict())


def phase_loadgen(torch, dev, card):
    """The open-loop soak and the record sources on the card.  (1) MF at the
    main path's full width (100,000 users x 131,072 items, dim 64, lr 0.01,
    ``scatter_impl="pallas"``) over phase_main's first two 65,536-rating
    microbatches, written to a MovieLens ``u.data`` file: the native loader
    (built with g++ under build/native/; a failed build fails the phase)
    gives columns bitwise the arrays and, through ``stream_batches``, an
    item table and user state bitwise the in-memory feed's; the same lines
    served by a ``ChaosLineServer`` that resets the connection every 50,000
    lines, through ``socket_text_stream`` and ``batches_from_records`` into a
    ``StreamingDriver``, reconnect, deliver every record once and give the
    in-memory driver's tables bitwise.  K1 twice in each run.  (2)
    ``benchmarks/soak_capacity.py``'s headline (2 shards x replication 1,
    6 generators, Zipf population of 100,000 users over the MF workload at
    131,072 x 64, 1 ms request legs through the chaos mesh, SLO 250 ms):
    ``closed_loop_capacity`` with 100 requests a generator, then the
    control-on arm at twice that capacity for 15 s over the nemesis schedule
    (two partitions, a delay window, kill-primary -> promote): every verdict
    ok, the ledger balanced, no error.  No kernel on the soak.  Returns K1's
    launches in the two source-fed runs."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="loadgen-", dir=os.path.join(REPO, "build"))
    try:
        t0 = time.perf_counter()
        k1 = _loadgen_sources(torch, dev, card, tmp)
        print(f"loadgen: (1) the sources took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        _loadgen_soak(torch, dev, card)
        print(f"loadgen: (2) the soak took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"loadgen: phase took {time.perf_counter() - t_phase:.1f} s; {card}")
    return k1


PAR_STEPS = 4  # full-width microbatches each parallel arm trains
PAR_SEED = 19  # the arms' Zipf stream
PAR_QUERIES, PAR_TOPK = 64, 10  # the sharded top-K batch
PAR_TIMEOUT_S = 300  # each spawn's wall-clock limit
PAR_BAR = dict(rtol=1e-5, atol=1e-6)  # ps > 1 against 1 x 1: K1's run sums split at other tile edges
PAR_REPS = 5  # timed repeats of each layer operation (median)


def _par_time_ms(torch, fn) -> float:
    """Median wall ms of ``fn`` on this rank, synchronised with the card
    (a collective's time includes its wait for the other ranks)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(PAR_REPS):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _par_layers(torch, store, batch, mesh, dev) -> dict:
    """This rank's pull and push ms at the step's shapes (its dp slice of the
    microbatch pulled, the whole microbatch's request pushed into a copy of
    its block) and the all-reduce over ps and all-gather over dp of the
    step's (lanes, 64) float32 payloads."""
    from flink_parameter_server_tpu_torch.core import store as store_mod
    from flink_parameter_server_tpu_torch.parallel import collectives as coll
    from flink_parameter_server_tpu_torch.parallel.mesh import axis_index, axis_size

    dp = axis_size(mesh, "dp")
    per = BATCH // dp
    lo = axis_index(mesh, "dp") * per
    ids = torch.from_numpy(batch["item"]).to(dev)
    mine = ids[lo:lo + per]
    deltas = torch.full((BATCH, DIM_UNFUSED), 1e-3, device=dev)
    table = store.table.clone()
    local = torch.ones(per, DIM_UNFUSED, device=dev)
    out = {
        "pull_ms": _par_time_ms(torch, lambda: store_mod.pull(store.spec, store.table, mine)),
        "push_ms": _par_time_ms(torch, lambda: store_mod.push(store.spec, table, ids, deltas)),
        "all_reduce_ms": _par_time_ms(torch, lambda: coll.all_reduce_sum(local, mesh, "ps")),
    }
    if dp > 1:
        out["all_gather_ms"] = _par_time_ms(torch, lambda: coll.all_gather_cat(local, mesh, "dp"))
    return out


def _par_mf(torch, mesh, dev, stream):
    """The main path's MF over ``stream`` on ``mesh`` (None: one device):
    (item table, user table, K1 launches, collective calls, wall s)."""
    from flink_parameter_server_tpu_torch import ps_online_mf
    from flink_parameter_server_tpu_torch.ops import scatter_kernel
    from flink_parameter_server_tpu_torch.parallel import collectives as coll

    if mesh is not None:  # the communicators come up on a first collective, outside the timed run
        coll.all_reduce_sum(torch.zeros(1, device=dev), mesh, "ps")
        coll.all_gather_cat(torch.zeros(1, device=dev), mesh, "dp")
    scatter_kernel.sorted_scatter_add.launches = 0
    coll.reset_collective_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = ps_online_mf(stream, num_users=NUM_USERS, num_items=NUM_ITEMS, dim=DIM_UNFUSED,
                       learning_rate=LEARNING_RATE, scatter_impl="pallas", collect_outputs=False,
                       **({"device": dev} if mesh is None else {"mesh": mesh}))
    items = res.store.values()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return res, items, scatter_kernel.sorted_scatter_add.launches, coll.collective_counts(), wall


def _par_answers(torch, store, users, ids):
    """A pull of ``ids`` and the top-K of the first 64 users through the
    store (sharded on a mesh), beside the 1 x 1 answers from the whole
    table: (bitwise pulls, bitwise top-K ids and scores)."""
    from flink_parameter_server_tpu_torch.models.topk_recommender import query_topk
    from flink_parameter_server_tpu_torch.ops.topk import dense_topk

    whole = store.values()
    uids = torch.arange(PAR_QUERIES, device=ids.device)
    s_sh, i_sh = query_topk(store, users, uids, PAR_TOPK)
    s_1, i_1 = dense_topk(whole, users[:PAR_QUERIES], PAR_TOPK, valid_rows=store.spec.capacity)
    return (bool(torch.equal(store.pull(ids), whole[ids])),
            bool(torch.equal(i_sh, i_1)) and bool(torch.equal(s_sh, s_1)))


def _par_rank_nccl(torch, outdir):
    """(a): a 1 x 1 NCCL mesh at the main path's full width, timed against
    the unsharded run in turns after one untimed run of each."""
    import torch.distributed as dist

    from flink_parameter_server_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, 1, device_type="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = zipf_stream(PAR_SEED, PAR_STEPS)
    for m in (None, mesh):  # untimed: the process's first-use costs
        _par_mf(torch, m, dev, stream)
    walls = {"plain": [], "mesh": []}
    for m in (None, mesh, mesh, None):  # timed in turns
        run = _par_mf(torch, m, dev, stream)
        walls["plain" if m is None else "mesh"].append(run[4])
        if m is None:
            one, one_items = run[0], run[1]
        else:
            res, items, k1, calls = run[:4]
    ids = torch.from_numpy(stream[0]["item"]).to(dev)
    pulls_ok, topk_ok = _par_answers(torch, res.store, res.worker_state, ids)
    torch.save({"items": items.cpu(), "users": res.worker_state.cpu()}, os.path.join(outdir, "nccl_tables.pt"))
    return dict(
        backend=dist.get_backend(), bitwise=bool(torch.equal(items, one_items))
        and bool(torch.equal(res.worker_state, one.worker_state)),
        pulls_bitwise=pulls_ok, topk_bitwise=topk_ok, k1=k1, calls=calls, walls=walls,
        **_par_layers(torch, res.store, stream[0], mesh, dev))


def _par_rank_gloo(torch, outdir):
    """(b) a 2 x 2 mesh and (c) a 1 x 4 ps-only mesh, every rank on card 0,
    over a gloo group with CUDA tensors."""
    import torch.distributed as dist

    from flink_parameter_server_tpu_torch import OnlineMatrixFactorization, ShardedParamStore, ranged_random_factor
    from flink_parameter_server_tpu_torch.ops import mf_kernel
    from flink_parameter_server_tpu_torch.parallel import collectives as coll
    from flink_parameter_server_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"backend": dist.get_backend()}
    # (b)
    mesh = make_mesh(2, 2, device_type="cuda")
    stream = zipf_stream(PAR_SEED, PAR_STEPS)
    res, items, k1, calls, wall = _par_mf(torch, mesh, dev, stream)
    ref = torch.load(os.path.join(outdir, "nccl_tables.pt"))
    ref_items, ref_users = ref["items"].to(dev), ref["users"].to(dev)
    ids = torch.from_numpy(stream[0]["item"]).to(dev)
    pulls_ok, topk_ok = _par_answers(torch, res.store, res.worker_state, ids)
    out.update(
        mf_ok=bool(torch.allclose(items, ref_items, **PAR_BAR))
        and bool(torch.allclose(res.worker_state, ref_users, **PAR_BAR)),
        mf_err=max(float((items - ref_items).abs().max()), float((res.worker_state - ref_users).abs().max())),
        mf_bitwise=bool(torch.equal(items, ref_items)), pulls_bitwise=pulls_ok, topk_bitwise=topk_ok,
        k1=k1, calls=calls, wall_s=wall, block_rows=int(res.store.table.shape[0]),
        **_par_layers(torch, res.store, stream[0], mesh, dev))
    del res, items, ref, ref_items, ref_users
    # (c)
    ps_mesh = make_mesh(1, dist.get_world_size(), device_type="cuda")
    init = ranged_random_factor(1, (DIM_FUSED,))
    block = ShardedParamStore.create(NUM_ITEMS, (DIM_FUSED,), init_fn=init, mesh=ps_mesh).table
    logic = OnlineMatrixFactorization(NUM_USERS, DIM_FUSED, seed=0, device=dev)
    users = logic.init_state()
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in stream]
    mf_kernel.sorted_fused_mf_sgd.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    preds = []
    for b in batches:
        users, block, pred = mf_kernel.fused_mf_sgd_sharded(
            users, block, b["user"], b["item"], b["rating"], b["mask"], mesh=ps_mesh,
            learning_rate=LEARNING_RATE)
        preds.append(pred)
    torch.cuda.synchronize()
    out.update(k2=mf_kernel.sorted_fused_mf_sgd.launches, fused_wall_s=time.perf_counter() - t)
    items = coll.all_gather_cat(block, ps_mesh, "ps")[:NUM_ITEMS]
    if dist.get_rank() == 0:  # the unsharded fused step on the whole table
        whole = ShardedParamStore.create(NUM_ITEMS, (DIM_FUSED,), init_fn=init, device=dev).table
        u1 = logic.init_state()
        errs, ok = [], True
        for b, pred in zip(batches, preds):
            u1, whole, p1 = mf_kernel.fused_mf_sgd(u1, whole, b["user"], b["item"], b["rating"], b["mask"],
                                                   learning_rate=LEARNING_RATE)
            ok &= bool(torch.allclose(pred, p1, **PAR_BAR))
            errs.append(float((pred - p1).abs().max()))
        ok &= bool(torch.allclose(items, whole[:NUM_ITEMS], **PAR_BAR)) and bool(torch.allclose(users, u1, **PAR_BAR))
        errs += [float((items - whole[:NUM_ITEMS]).abs().max()), float((users - u1).abs().max())]
        out.update(fused_ok=ok, fused_err=max(errs))
    dist.barrier()
    return out


DDP_STEPS = 3  # (a)'s steps in each regime, bfloat16
DDP_F32_STEPS = 2  # (b)'s steps in each regime, and (a)'s float32 run for it
DDP_WORLD = 4  # (b)'s gloo ranks, all on cuda:0
DDP_REGIMES = ("replicated", "zero1", "fsdp")
DDP_LR = 3e-3  # phase_lm's adamw(3e-3) in (a)
# (b) and its float32 reference take sgd(0.1, momentum 0.9): at 3e-3 the parameters moved 4.6e-5 at most in
# the 2 steps, so a rank's share of the update sat near the bar's own size (1e-6 + 1e-5 |p|)
DDP_F32_LR = 0.1
# (b) at dp 4 against (a)'s unsharded float32 run: gradients summed in another order.  SGD's update is
# lr x the gradient, so that rounding stays at its own size; Adam divides by the gradient's own magnitude
# and lifts it by up to lr/eps on elements at float32 noise (1e-5 seen in a CPU rehearsal at eps 1e-4)
DDP_F32_BAR = dict(rtol=1e-5, atol=1e-6)
DDP_MASK = (4, 3, 1, 0)  # valid rows of each dp-4 rank's 4 rows in the masked batch
DDP_REPS = 3  # timed repeats of each (b) collective at the step's payload (median)
DDP_BLOCKS, DDP_ROUNDS = 4, 3  # (c): row blocks on cuda:0, BSP rounds


def _ddp_masked(n_rows, counts):
    """A (n_rows,) float mask: each dp rank's contiguous rows hold
    ``counts[r]`` valid rows (the row mask of ``microbatches``)."""
    per = n_rows // len(counts)
    mask = np.zeros(n_rows, np.float32)
    for r, c in enumerate(counts):
        mask[r * per:r * per + c] = 1.0
    return mask


def _ddp_batches(n, vocab, mask_at=None):
    batches = list(bigram_batches(n, LM_B, LM_T, vocab, seed=3))
    if mask_at is not None:
        batches[mask_at]["mask"] = _ddp_masked(LM_B, DDP_MASK)
    return batches


def _ddp_run(torch, cfg, regime, batches, mesh, make_opt, dev, plant=None, loss_kw=None, chunk_rows=None):
    """One regime's ``transform_dense`` of Transformer-base from seed 0
    (``regime`` "unsharded": no mesh): the losses, the whole final model,
    every kernel's launches, the collectives' counts, each step's ms, and
    the bytes of the parameters and of the optimizer state a rank holds at
    the end.  ``plant(model)``, if given, runs on the model the loss
    sees at each step (a planted fault); ``loss_kw`` goes to ``lm_loss``
    (a pipeline model's ``num_microbatches``); ``chunk_rows`` (mesh-less
    only) runs the forward on each ``chunk_rows`` rows of the batch alone,
    so an MoE layer routes each chunk as a pipeline stage routes its
    microbatch (:func:`_chunked_loss`)."""
    from flink_parameter_server_tpu_torch import (
        DenseParameterServer, fsdp_place, init_params, lm_loss, transform_dense,
    )
    from flink_parameter_server_tpu_torch.core.dense import gather_params
    from flink_parameter_server_tpu_torch.parallel import collectives as coll

    t_run = time.perf_counter()
    m = None if regime == "unsharded" else mesh
    # on the ("dp", "ep") mesh each rank keeps its experts of the same draw
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, mesh=m)
    if regime == "fsdp":
        fsdp_place(model, mesh)
    built = []  # the optimizers the factory builds: the last is the run's

    def factory(params):
        built.append(make_opt(params))
        return built[-1]

    server = DenseParameterServer(model, factory)
    stamps = []

    def on_step(i, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    def loss(mm, b):
        if plant is not None:
            plant(mm)
        if chunk_rows:
            return _chunked_loss(torch, mm, b, cfg, chunk_rows)
        return lm_loss(mm, b, cfg, mesh=m, **(loss_kw or {}))

    zero_counts()
    coll.reset_collective_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = transform_dense(batches, loss, server,
                          batch_sharding=m if regime in ("replicated", "zero1") else None,
                          shard_opt_state=regime == "zero1", on_step=on_step)
    launches = {name: fn.launches for name, fn in _counters().items()}
    calls = coll.collective_counts()
    final = res.server_outputs[0]
    held = [(n, list(p.shape)) for n, p in list(final.named_parameters())[2:4]]  # layer 0's attn_norm and wqkv
    opt_state = [t for st in built[-1].state.values() for t in st.values() if isinstance(t, torch.Tensor)]
    out = dict(losses=[float(x) for x in res.worker_outputs], launches=launches, calls=calls,
               steps_ms=[round((b - a) * 1e3, 3) for a, b in zip([t0] + stamps[:-1], stamps)],
               params_bytes=sum(p.numel() * p.element_size() for p in final.parameters()),
               opt_bytes=sum(t.numel() * t.element_size() for t in opt_state), held=held)
    out["final"] = gather_params(final)
    out["run_s"] = round(time.perf_counter() - t_run, 2)
    return out


def _chunked_loss(torch, model, batch, cfg, rows):
    """``lm_loss`` of the mesh-less ``model`` with the forward run on each
    ``rows`` rows of the batch alone and the logits put back together: the
    loss a pipeline computes when its stages route each microbatch."""
    from flink_parameter_server_tpu_torch import forward, next_token_xent

    tokens = torch.as_tensor(batch["tokens"], device=model.embed.device)
    logits = torch.cat([forward(model, t, cfg) for t in tokens.split(rows)])
    return next_token_xent(logits, tokens, batch.get("mask"))


def _lm_leaves(model) -> list:
    """A whole model's tensors in the mesh-less model's parameter order: a
    pipeline model's stacked ``(S, per, ...)`` stages give layer ``s·per +
    j`` as ``[s, j]``."""
    if not hasattr(model, "stages"):
        return [p.detach() for p in model.parameters()]
    from flink_parameter_server_tpu_torch.models.transformer import LAYER_KEYS

    leaves = dict(model.stages.named_parameters())
    # the stages' moe ParameterDict is built as a mesh-less block's is, so it keeps its leaves' order
    moe = model.stages["moe"].keys() if "moe" in model.stages else ()
    keys = [k for k in LAYER_KEYS if k in leaves] + [f"moe.{k}" for k in moe]
    S, per = leaves["wqkv"].shape[:2]
    return [model.embed.detach(), model.final_norm.detach()] + [
        leaves[k].detach()[i // per, i % per] for i in range(S * per) for k in keys]


def _ddp_same(torch, a, b) -> bool:
    """Two whole models bitwise equal (a pipeline model's stages taken as
    its layers)."""
    x, y = _lm_leaves(a), _lm_leaves(b)
    return len(x) == len(y) and all(torch.equal(u, v) for u, v in zip(x, y))


def _ddp_rank_nccl(torch, outdir):
    """(a): a one-rank NCCL ``("dp",)`` mesh, Transformer-base in bfloat16,
    each regime against the unsharded run; then the unsharded float32 run
    that (b) is held against, saved for it."""
    import torch.distributed as dist

    from flink_parameter_server_tpu_torch import TransformerConfig, adamw, sgd
    from flink_parameter_server_tpu_torch.parallel import collectives as coll
    from flink_parameter_server_tpu_torch.parallel.mesh import make_dp_mesh

    mesh = make_dp_mesh(1, device_type="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    coll.all_reduce_sum(torch.zeros(1, device=dev), mesh, "dp")  # the communicator comes up outside the runs
    cfg = TransformerConfig(flash_attention="on")  # Transformer-base, bfloat16, as phase_lm runs it
    batches = _ddp_batches(DDP_STEPS, cfg.vocab_size)
    warm = _ddp_run(torch, cfg, "unsharded", batches[:1], mesh, lambda p: adamw(DDP_LR)(p), dev)  # untimed
    base = _ddp_run(torch, cfg, "unsharded", batches, mesh, lambda p: adamw(DDP_LR)(p), dev)
    out = {"backend": dist.get_backend(), "unsharded_ms": base["steps_ms"], "base_losses": base["losses"],
           "run_s": {"warm-up": warm["run_s"], "unsharded": base["run_s"]}}
    for regime in DDP_REGIMES:
        run = _ddp_run(torch, cfg, regime, batches, mesh, lambda p: adamw(DDP_LR)(p), dev)
        out[regime] = dict(bitwise=run["losses"] == base["losses"] and _ddp_same(torch, run["final"], base["final"]),
                           **{k: run[k] for k in ("losses", "launches", "calls", "steps_ms", "run_s")})
        del run
    cfg32 = TransformerConfig(flash_attention="on", dtype=torch.float32)
    f32 = _ddp_run(torch, cfg32, "unsharded", _ddp_batches(DDP_F32_STEPS, cfg32.vocab_size, mask_at=1), mesh,
                   lambda p: sgd(DDP_F32_LR, momentum=0.9)(p), dev)
    t = time.perf_counter()
    torch.save({"losses": f32["losses"], "params": [p.detach().cpu() for p in f32["final"].parameters()]},
               os.path.join(outdir, "dense_f32.pt"))
    out["f32_losses"] = f32["losses"]
    out["run_s"].update(float32=f32["run_s"], save=round(time.perf_counter() - t, 2))
    return out


def _held(torch, run, ref_params, init):
    """A run's whole final model against a reference's parameters: (within
    DDP_F32_BAR, max |error|, elements past the bar, max |final - init|)."""
    got = _lm_leaves(run["final"])
    past = sum(int((~torch.isclose(a, b, **DDP_F32_BAR)).sum()) for a, b in zip(got, ref_params))
    return (past == 0, max(float((a - b).abs().max()) for a, b in zip(got, ref_params)), past,
            max(float((a - b.detach()).abs().max()) for a, b in zip(got, init)))


def _ddp_rank_gloo(torch, outdir):
    """(b): dp 4 as 4 gloo ranks on ``cuda:0``, Transformer-base in float32,
    each regime against (a)'s unsharded float32 run, with how far the
    parameters moved from their init; the bar's reach: the replicated run
    with rank 0's gradients zeroed must fall outside it; the bytes a rank
    holds; a row-masked batch's loss against the unsharded loss; each
    collective's ms at the step's payload."""
    import torch.distributed as dist

    from flink_parameter_server_tpu_torch import TransformerConfig, init_params, lm_loss, sgd
    from flink_parameter_server_tpu_torch.parallel import collectives as coll
    from flink_parameter_server_tpu_torch.parallel.mesh import make_dp_mesh

    mesh = make_dp_mesh(DDP_WORLD, device_type="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = TransformerConfig(flash_attention="on", dtype=torch.float32)
    ref = torch.load(os.path.join(outdir, "dense_f32.pt"))
    ref_params = [p.to(dev) for p in ref["params"]]
    batches = _ddp_batches(DDP_F32_STEPS, cfg.vocab_size, mask_at=1)
    init = list(init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev).parameters())
    out = {"backend": dist.get_backend(), "rank": dist.get_rank()}

    model = None
    for regime in DDP_REGIMES:
        run = _ddp_run(torch, cfg, regime, batches, mesh, lambda p: sgd(DDP_F32_LR, momentum=0.9)(p), dev)
        ok, err, _, moved = _held(torch, run, ref_params, init)
        loss_ok = bool(np.allclose(run["losses"], ref["losses"], rtol=1e-4))
        out[regime] = dict(ok=ok and loss_ok, err=err, moved=moved, losses=run["losses"], ref_losses=ref["losses"],
                           **{k: run[k] for k in ("launches", "calls", "steps_ms", "params_bytes", "opt_bytes",
                                                  "run_s")})
        model = run["final"]

    hooked = set()

    def drop_rank0(m):  # the planted fault: rank 0's gradients never reach the sum
        for p in m.parameters():
            if dist.get_rank() == 0 and id(p) not in hooked:
                hooked.add(id(p))
                p.register_hook(torch.zeros_like)

    run = _ddp_run(torch, cfg, "replicated", batches, mesh, lambda p: sgd(DDP_F32_LR, momentum=0.9)(p), dev,
                   plant=drop_rank0)
    ok, err, past, _ = _held(torch, run, ref_params, init)
    out["planted"] = dict(caught=not ok, err=err, past=past, elements=sum(p.numel() for p in init))
    del run
    # the row-masked batch's loss on the final weights: this rank's rows
    # through lm_loss(mesh=) against the whole batch's unsharded loss
    masked = {"tokens": torch.from_numpy(batches[1]["tokens"]).to(dev),
              "mask": torch.from_numpy(batches[1]["mask"]).to(dev)}
    with torch.no_grad():
        sharded = float(lm_loss(model, coll.dp_rows(masked, mesh), cfg, mesh=mesh))
        whole = float(lm_loss(model, masked, cfg))
    counts = masked["mask"].reshape(DDP_WORLD, -1).sum(1).tolist()
    out.update(masked=dict(sharded=sharded, whole=whole, rows=counts,
                           ok=bool(np.isclose(sharded, whole, rtol=1e-5, atol=0.0))))
    # each collective at the step's payload: the float32 gradients of every
    # parameter (Transformer-base's leaves all divide by 4)
    n = sum(p.numel() for p in model.parameters())
    flat = torch.ones(n, device=dev)
    own = torch.ones(DDP_WORLD, n // DDP_WORLD, device=dev)
    out["collective_ms"] = {
        "all_reduce": _ddp_time_ms(torch, lambda: coll.all_reduce_sum(flat, mesh, "dp")),
        "reduce_scatter": _ddp_time_ms(torch, lambda: coll.reduce_scatter_sum(own, mesh, "dp")),
        "all_gather": _ddp_time_ms(torch, lambda: coll.all_gather_cat(own[:1], mesh, "dp")),
        "payload_bytes": n * 4,
    }
    del model, flat, own, ref_params, init
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["ep"] = _ep_rank_gloo(torch, outdir)
    out["ep"]["seconds"] = round(time.perf_counter() - t, 2)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["mp"] = _mp_rank_gloo(torch, outdir)
    out["mp"]["seconds"] = round(time.perf_counter() - t, 2)
    dist.barrier()
    return out


def _ddp_time_ms(torch, fn) -> float:
    """Median wall ms of ``fn`` over DDP_REPS runs after one untimed run,
    synchronised with the card."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(DDP_REPS):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


EP_STEPS = 3  # (a)'s MoE LM steps on the one-rank ("dp", "ep") NCCL mesh, bfloat16
EP_F32_STEPS = 2  # (b)'s ep-4 steps, and (a)'s float32 mesh-less run they are held against
EP_WORLD = DDP_WORLD  # (b): the gloo children, again, as a (1, 4) ("dp", "ep") mesh
# (2, 2) at the layer level: 2,048 tokens a dp half, 256 an expert on average, so capacity 192 drops some
EP_LAYER_TOKENS, EP_LAYER_CAPACITY = 4096, 192
EP_LAYER_BAR = 1e-4  # float32 against moe_reference: rtol, and atol x the oracle's largest |value|
# (b)'s dp-only run: the MoE LM on a ("dp",) mesh of the 4 children routes the global batch's 8,192 tokens,
# 1,024 an expert on average, so capacity 1,024 drops some (a rank's 2,048 alone would drop none)
EP_DP_STEPS, EP_DP_CAPACITY = 1, 1024


def _ep_cfg(**kw):
    """phase_moe_lm's MoE LM (Transformer-base, 8 experts a layer, capacity
    1,280) with its experts on the ``ep`` axis of a mesh."""
    from flink_parameter_server_tpu_torch import TransformerConfig

    return TransformerConfig(num_experts=MOE_EXPERTS, moe_capacity=MOE_CAPACITY, ep_axis="ep", **kw)


def _ep_layer_ms(torch, layers, mcfg, mesh, tokens, dev) -> float:
    """``moe_apply``'s forward and backward over every layer's experts at a
    step's shapes (``tokens`` x d_model, the model's dtype), alone: CUDA
    events over 5 runs after one, ms a run."""
    from flink_parameter_server_tpu_torch.models import moe

    gen = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn(tokens, mcfg.d_model, generator=gen, device=dev).to(mcfg.dtype).requires_grad_()
    g = torch.randn(tokens, mcfg.d_model, generator=gen, device=dev).to(mcfg.dtype)

    def run():
        for prm in layers:
            torch.autograd.backward(moe.moe_apply(prm, h, mcfg, mesh=mesh), g)

    run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 5


def _ep_rank_nccl(torch, outdir):
    """(a) of the ep part, in the one-rank NCCL group of (a): the MoE LM on
    a ``("dp", "ep")`` mesh of one rank (bfloat16, flash "on") for
    EP_STEPS steps through ``transform_dense(batch_sharding=mesh)``
    against the same steps without a mesh; the MoE layers' ms alone; the
    all-to-all's ms at a trip's payload; then the float32 mesh-less runs
    that (b) is held against (flash "on", as (b) runs it), saved for it:
    the ep-4 run's, and the dp-only run's at EP_DP_CAPACITY."""
    import dataclasses

    import torch.distributed as dist

    from flink_parameter_server_tpu_torch import adamw, sgd
    from flink_parameter_server_tpu_torch.models import moe
    from flink_parameter_server_tpu_torch.parallel import collectives as coll
    from flink_parameter_server_tpu_torch.parallel.mesh import make_mesh, mesh_device

    mesh = make_mesh(1, 1, device_type="cuda", axis_names=("dp", "ep"))
    dev = mesh_device(mesh)
    cfg = _ep_cfg(flash_attention="on")  # bfloat16, as phase_moe_lm runs it
    batches = list(bigram_batches(EP_STEPS, LM_B, LM_T, cfg.vocab_size, seed=0))
    opt = lambda p: adamw(DDP_LR)(p)  # noqa: E731
    base = _ddp_run(torch, cfg, "unsharded", batches, mesh, opt, dev)
    ep = _ddp_run(torch, cfg, "replicated", batches, mesh, opt, dev)
    out = {"backend": dist.get_backend(), "bitwise": ep["losses"] == base["losses"] and _ddp_same(
        torch, ep["final"], base["final"]), "losses": ep["losses"], "base_losses": base["losses"],
        "max_err": max(float((a.detach().float() - b.detach().float()).abs().max())
                       for a, b in zip(ep["final"].parameters(), base["final"].parameters())),
        **{k: ep[k] for k in ("launches", "calls", "steps_ms", "run_s")}, "base_ms": base["steps_ms"]}
    layers = [{k: v.detach().requires_grad_() for k, v in layer.moe.items()} for layer in ep["final"].layers]
    mcfg = moe.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff, num_experts=MOE_EXPERTS, capacity=MOE_CAPACITY,
                         dtype=cfg.dtype)
    out["moe_ms"] = _ep_layer_ms(torch, layers, mcfg, mesh, LM_B * LM_T, dev)
    del base, ep, layers
    trip = torch.ones(MOE_EXPERTS, MOE_CAPACITY, cfg.d_model, dtype=cfg.dtype, device=dev)
    out["a2a_ms"] = _ddp_time_ms(torch, lambda: coll.all_to_all(trip, mesh, "ep"))
    out["a2a_bytes"] = trip.numel() * trip.element_size()
    cfg32 = _ep_cfg(flash_attention="on", dtype=torch.float32)
    batches32 = list(bigram_batches(EP_F32_STEPS, LM_B, LM_T, cfg32.vocab_size))
    sgd32 = lambda p: sgd(DDP_F32_LR, momentum=0.9)(p)  # noqa: E731
    for name, c, bs in (("moe_f32", cfg32, batches32),
                        ("moe_dp_f32", dataclasses.replace(cfg32, moe_capacity=EP_DP_CAPACITY),
                         batches32[:EP_DP_STEPS])):
        f32 = _ddp_run(torch, c, "unsharded", bs, mesh, sgd32, dev)
        torch.save({"losses": f32["losses"], "params": [p.detach().cpu() for p in f32["final"].parameters()]},
                   os.path.join(outdir, f"{name}.pt"))
        out[f"{name}_s"] = f32["run_s"]
        del f32
    check(moe.local_experts(MOE_EXPERTS, mesh) == slice(0, MOE_EXPERTS), "ep (a): one rank holds every expert")
    return out


def _ep_layer_check(torch, dev):
    """(2, 2) at the layer level: ``moe_apply`` on this rank's dp half of
    EP_LAYER_TOKENS float32 tokens at the LM's width, capacity
    EP_LAYER_CAPACITY a dp half, its output and the gradients of
    ``sum(out * g)`` against ``moe_reference`` on the same half (the
    rank's gradients are its half's: each leaf's, the experts' slice)."""
    from flink_parameter_server_tpu_torch.models import moe
    from flink_parameter_server_tpu_torch.parallel.mesh import axis_index, make_mesh

    mesh = make_mesh(2, 2, device_type="cuda", axis_names=("dp", "ep"))
    cfg = _ep_cfg()
    mcfg = moe.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff, num_experts=MOE_EXPERTS, capacity=EP_LAYER_CAPACITY)
    whole = moe.init_moe_params(torch.Generator(device=dev).manual_seed(5), mcfg, device=dev)
    mine = moe.init_moe_params(torch.Generator(device=dev).manual_seed(5), mcfg, mesh)
    sl = moe.local_experts(MOE_EXPERTS, mesh)
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(EP_LAYER_TOKENS, mcfg.d_model, generator=gen, device=dev)
    g = torch.randn(EP_LAYER_TOKENS, mcfg.d_model, generator=gen, device=dev)
    n = EP_LAYER_TOKENS // 2
    d = axis_index(mesh, "dp")
    half, g_half = x[d * n:(d + 1) * n], g[d * n:(d + 1) * n]
    p = {k: v.clone().requires_grad_() for k, v in mine.items()}
    q = {k: v.clone().requires_grad_() for k, v in whole.items()}
    got = moe.moe_apply(p, half, mcfg, mesh=mesh)
    (got * g_half).sum().backward()
    want = moe.moe_reference(q, half, mcfg)
    (want * g_half).sum().backward()
    pairs = {"out": (got, want), "w_gate": (p["w_gate"].grad, q["w_gate"].grad),
             "w_up": (p["w_up"].grad, q["w_up"].grad[sl]), "w_down": (p["w_down"].grad, q["w_down"].grad[sl])}
    errs = {k: float((a - b).abs().max()) for k, (a, b) in pairs.items()}
    ok = all(torch.allclose(a, b, rtol=EP_LAYER_BAR, atol=EP_LAYER_BAR * float(b.abs().max()))
             for a, b in pairs.values())
    kept = int(moe._route(half, whole["w_gate"], MOE_EXPERTS, EP_LAYER_CAPACITY)[2].sum())
    same_init = all(torch.equal(mine[k], whole[k][slice(None) if k == "w_gate" else sl]) for k in mine)
    return dict(ok=ok and same_init, errs=errs, kept=kept, tokens=n, experts=[sl.start, sl.stop])


def _ep_rank_gloo(torch, outdir):
    """(b) of the ep part, in each gloo child: ep 4 as a (1, 4)
    ``("dp", "ep")`` mesh, each rank holding 2 of the 8 experts, the MoE
    LM in float32 (flash "on": K3a/b/c on the rank's rows) for
    EP_F32_STEPS steps against (a)'s float32 mesh-less run; the planted
    fault (the experts' gradients left ep times large: ``moe_apply``'s
    division by ep taken out) outside that bar.  The same LM on the
    dp-only ``("dp",)`` mesh of the 4 children at EP_DP_CAPACITY, which
    routes the global batch: EP_DP_STEPS steps against (a)'s mesh-less run
    at that capacity, and the rank's logits against the mesh-less forward
    of the whole batch, where the planted per-rank routing must fall
    outside the same bar (a forward: a planted training step would cost
    another all-reduce of every gradient).  Then the (2, 2) layer check
    and the all-to-all's ms at (b)'s trip payload."""
    import dataclasses

    from flink_parameter_server_tpu_torch import forward, init_params, sgd
    from flink_parameter_server_tpu_torch.models import moe
    from flink_parameter_server_tpu_torch.models import transformer as tr
    from flink_parameter_server_tpu_torch.parallel import collectives as coll
    from flink_parameter_server_tpu_torch.parallel.mesh import make_dp_mesh, make_mesh, mesh_device

    mesh = make_mesh(1, EP_WORLD, device_type="cuda", axis_names=("dp", "ep"))
    dev = mesh_device(mesh)
    cfg = _ep_cfg(dtype=torch.float32, flash_attention="on")
    batches = list(bigram_batches(EP_F32_STEPS, LM_B, LM_T, cfg.vocab_size))
    model0 = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    init = [p.detach() for p in model0.parameters()]
    opt = lambda p: sgd(DDP_F32_LR, momentum=0.9)(p)  # noqa: E731

    def load(name):
        ref = torch.load(os.path.join(outdir, f"{name}.pt"))
        return ref, [p.to(dev) for p in ref["params"]]

    def held(run, ref, ref_params):
        ok, err, past, moved = _held(torch, run, ref_params, init)
        return dict(ok=ok and bool(np.allclose(run["losses"], ref["losses"], rtol=1e-4)), err=err, past=past,
                    moved=moved, losses=run["losses"], ref_losses=ref["losses"],
                    **{k: run[k] for k in ("launches", "calls", "steps_ms", "run_s")})

    ref, ref_params = load("moe_f32")
    out = held(_ddp_run(torch, cfg, "replicated", batches, mesh, opt, dev), ref, ref_params)
    out["experts"] = str(moe.local_experts(MOE_EXPERTS, mesh))
    real_copies = moe._EpCopies.apply
    moe._EpCopies.apply = lambda w, ep: w  # the planted fault: each expert sums ep copies of its gradient
    try:
        bad = held(_ddp_run(torch, cfg, "replicated", batches, mesh, opt, dev), ref, ref_params)
    finally:
        moe._EpCopies.apply = real_copies
    out["planted"] = dict(caught=not bad["ok"], err=bad["err"], past=bad["past"], elements=sum(p.numel() for p in init))

    dp_cfg = dataclasses.replace(cfg, moe_capacity=EP_DP_CAPACITY)
    dp_mesh = make_dp_mesh(EP_WORLD, device_type="cuda")
    ref, ref_params = load("moe_dp_f32")
    routed, real_route = [], moe._route

    def spy(x, w, E, C):  # the tokens each routing sees and keeps
        r = real_route(x, w, E, C)
        routed.append((int(r[2].sum()), int(x.shape[0])))
        return r

    moe._route = spy
    try:
        out["dp"] = held(_ddp_run(torch, dp_cfg, "replicated", batches[:EP_DP_STEPS], dp_mesh, opt, dev), ref,
                         ref_params)
    finally:
        moe._route = real_route
    out["dp"]["routed"] = routed
    del ref_params
    real_mlp = tr._moe_mlp

    def per_rank(layer, h, c, m):  # the planted fault: each rank routes its own rows alone
        B, T, d = h.shape
        return moe.moe_dense(layer.moe, h.reshape(B * T, d), tr._moe_config(c)).reshape(B, T, d)

    tokens = torch.from_numpy(batches[0]["tokens"]).to(dev)
    rows = coll.dp_rows(tokens, dp_mesh)
    logits = {}
    with torch.no_grad():
        logits["want"] = coll.dp_rows(forward(model0, tokens, dp_cfg), dp_mesh).clone()
        logits["got"] = forward(model0, rows, dp_cfg, mesh=dp_mesh)
        tr._moe_mlp = per_rank
        try:
            logits["planted"] = forward(model0, rows, dp_cfg, mesh=dp_mesh)
        finally:
            tr._moe_mlp = real_mlp
    want = logits.pop("want")

    def past_in_batch(v):  # elements past the bar over every rank's rows (rank 0's rows route first, so
        # a routing fault may leave them as they were)
        mine = (~torch.isclose(v, want, **DDP_F32_BAR)).sum().to(torch.float64).reshape(1)
        return int(coll.all_reduce_sum(mine, dp_mesh, "dp").item())

    out["dp"]["logits"] = {k: dict(err=float((v - want).abs().max()), past=past_in_batch(v))
                           for k, v in logits.items()}
    out["dp"]["logits"]["elements"] = want.numel() * EP_WORLD
    del logits, want, model0, init
    out["layer"] = _ep_layer_check(torch, dev)
    trip = torch.ones(MOE_EXPERTS, MOE_CAPACITY, cfg.d_model, device=dev)
    out["a2a_ms"] = _ddp_time_ms(torch, lambda: coll.all_to_all(trip, mesh, "ep"))
    out["a2a_bytes"] = trip.numel() * trip.element_size()
    return out


MP_STEPS = DDP_STEPS  # (a)'s steps on each one-rank model-parallel mesh, bfloat16
MP_WORLD = DDP_WORLD  # (b): the gloo children, again, as tp 4, sp 4, pp 2 x sp 2, ... meshes
MP_MICRO = 2  # (b)'s pipeline microbatches: a dp rank's rows in 2
# (b)'s MoE arms (8 experts a layer) route at capacities that must drop tokens under each arm's rule: the
# global batch's 8,192 tokens at tp 4, ep 2 x tp 2 and ep 2 x sp 2 (dp 1) at 896 (8 x 896 < 8,192), a
# pipeline microbatch's 4 x 512 = 2,048 at pp 2 x dp 2 at 224 (8 x 224 < 2,048)
MP_MOE_CAPACITY, MP_PP_CAPACITY = 896, 224
MP_PP_ROWS = LM_B // 2 // MP_MICRO  # the rows of one of pp 2 x dp 2's microbatches
MP_ROUTED = {"moe_tp": LM_B * LM_T, "moe_ep_tp": LM_B * LM_T, "moe_ep_sp": LM_B * LM_T,
             "moe_pp": MP_PP_ROWS * LM_T}  # the tokens each routing call of an MoE arm routes together


def _mp_moe(capacity):
    return dict(num_experts=MOE_EXPERTS, moe_capacity=capacity)


# (b)'s arms: name, the mesh's shape and axes, the config's fields, lm_loss's keywords, the float32 mesh-less
# run it is held to (saved by (a)), the planted fault.  Each is held to DDP_F32_BAR against that run: the dense
# arms against the dense_dp phase's dense_f32 run (flash "on", sgd(0.1, momentum 0.9), 2 steps, the second
# row-masked), the MoE arms against the same steps of the MoE LM at their capacity, routed by their rule (the
# whole batch; the pipeline's each 4-row microbatch alone).  The ring and the pipeline's stages take the plain
# attention (the ring is plain products; the stages pin "off", so the pipeline arms run "auto").  The faults,
# each planted in a second run of the arm's steps that must fall outside that bar: "copy" makes copy_to_tp the identity (the replicated leaves see only the rank's heads),
# "sum" drops the dense step's sum over sp, "scale" drops the pipeline's 1/pp weight on the logits (the
# replicated leaves counted twice), "tp_sum" sums over tp the gradients every tp rank already holds whole
# (the experts', the stages'), "slice" routes each sp rank's positions alone, "shard" routes a pipeline
# stage's MoE over the whole dp shard (1 microbatch) instead of each microbatch
MP_ARMS = (
    ("tp", (1, MP_WORLD), ("dp", "tp"), dict(tp_axis="tp"), {}, "dense_f32", "copy"),
    ("sp", (1, MP_WORLD), ("dp", "sp"), dict(sp_axis="sp", use_ring_attention=True), {}, "dense_f32", "sum"),
    ("pp_sp", (1, 2, 2), ("dp", "pp", "sp"),
     dict(pp_axis="pp", sp_axis="sp", use_ring_attention=True, flash_attention="auto"),
     dict(num_microbatches=MP_MICRO), "dense_f32", "scale"),
    ("moe_tp", (1, MP_WORLD), ("dp", "tp"), dict(tp_axis="tp", **_mp_moe(MP_MOE_CAPACITY)), {}, "moe_mp_f32",
     "tp_sum"),
    ("moe_ep_tp", (1, 2, 2), ("dp", "ep", "tp"), dict(ep_axis="ep", tp_axis="tp", **_mp_moe(MP_MOE_CAPACITY)), {},
     "moe_mp_f32", "tp_sum"),
    ("moe_ep_sp", (1, 2, 2), ("dp", "ep", "sp"),
     dict(ep_axis="ep", sp_axis="sp", use_ring_attention=True, **_mp_moe(MP_MOE_CAPACITY)), {}, "moe_mp_f32",
     "slice"),
    ("moe_pp", (2, 2), ("dp", "pp"), dict(pp_axis="pp", flash_attention="auto", **_mp_moe(MP_PP_CAPACITY)),
     dict(num_microbatches=MP_MICRO), "moe_pp_f32", "shard"),
    ("pp_tp", (1, 2, 2), ("dp", "pp", "tp"), dict(pp_axis="pp", tp_axis="tp", flash_attention="auto"),
     dict(num_microbatches=MP_MICRO), "dense_f32", "tp_sum"),
)
MP_EARLIER = ("tp", "sp", "pp_sp")  # the dense tp, sp and pp x sp arms; the rest came with the MoE and pp x tp layouts
# the float32 mesh-less runs (a) saves for the MoE arms: capacity, the rows each forward routes together
MP_REFERENCES = {"moe_mp_f32": (MP_MOE_CAPACITY, None), "moe_pp_f32": (MP_PP_CAPACITY, MP_PP_ROWS)}


def _mp_flash_arm(axes) -> bool:
    """An arm whose attention is K3a/b/c: tp without the ring or a pipeline."""
    return "tp" in axes and "sp" not in axes and "pp" not in axes


def _mp_rank_nccl(torch, outdir):
    """(a) of the model-parallel part, in the one-rank NCCL group of (a):
    Transformer-base (bfloat16) for MP_STEPS steps through
    ``transform_dense(batch_sharding=mesh)`` on a one-rank ``("dp", "sp",
    "tp")`` mesh (flash "on") and a one-rank ``("dp", "pp")`` mesh
    (``forward_pipelined``, 1 microbatch; the stages' plain attention), and
    the phase's MoE LM (8 experts, capacity 1,280) on a one-rank ``("dp",
    "ep", "tp")`` mesh (flash "on") and a one-rank ``("dp", "pp")`` mesh
    (1 microbatch, flash "auto"), each against the mesh-less run of the
    same attention; then the float32 mesh-less MoE runs (b)'s MoE arms are
    held against (MP_REFERENCES), saved for them."""
    import dataclasses

    import torch.distributed as dist

    from flink_parameter_server_tpu_torch import TransformerConfig, adamw, sgd
    from flink_parameter_server_tpu_torch.parallel.mesh import make_nd_mesh, mesh_device

    meshes = {"sp_tp": make_nd_mesh((1, 1, 1), ("dp", "sp", "tp"), device_type="cuda"),
              "pp": make_nd_mesh((1, 1), ("dp", "pp"), device_type="cuda"),
              "moe_ep_tp": make_nd_mesh((1, 1, 1), ("dp", "ep", "tp"), device_type="cuda")}
    meshes["moe_pp"] = meshes["pp"]
    dev = mesh_device(meshes["pp"])
    opt = lambda p: adamw(DDP_LR)(p)  # noqa: E731
    on = TransformerConfig(flash_attention="on")  # Transformer-base, bfloat16, as phase_lm runs it
    off = dataclasses.replace(on, flash_attention="off")
    moe_on = _ep_cfg(flash_attention="on")  # phase_moe_lm's MoE LM, its experts named on "ep"
    moe_off = dataclasses.replace(moe_on, flash_attention="off")
    batches = _ddp_batches(MP_STEPS, on.vocab_size)
    out = {"backend": dist.get_backend(), "run_s": {}}
    arms = (("sp_tp", on, dataclasses.replace(on, sp_axis="sp", tp_axis="tp"), {}),
            ("pp", off, dataclasses.replace(off, pp_axis="pp"), dict(num_microbatches=1)),
            ("moe_ep_tp", moe_on, dataclasses.replace(moe_on, tp_axis="tp"), {}),
            ("moe_pp", moe_off, dataclasses.replace(moe_on, pp_axis="pp", flash_attention="auto"),
             dict(num_microbatches=1)))
    for name, base_cfg, cfg, kw in arms:
        t = time.perf_counter()
        base = _ddp_run(torch, base_cfg, "unsharded", batches, None, opt, dev)
        run = _ddp_run(torch, cfg, "replicated", batches, meshes[name], opt, dev, loss_kw=kw)
        out[name] = dict(bitwise=run["losses"] == base["losses"] and _ddp_same(torch, run["final"], base["final"]),
                         base_ms=base["steps_ms"], **{k: run[k] for k in ("losses", "launches", "calls", "steps_ms",
                                                                          "run_s")})
        out["run_s"][name] = round(time.perf_counter() - t, 2)
        del base, run
    cfg32 = TransformerConfig(flash_attention="on", dtype=torch.float32)
    batches32 = _ddp_batches(DDP_F32_STEPS, cfg32.vocab_size, mask_at=1)
    for name, (capacity, rows) in MP_REFERENCES.items():
        c = dataclasses.replace(cfg32, **_mp_moe(capacity))
        f32 = _ddp_run(torch, c, "unsharded", batches32, None, lambda p: sgd(DDP_F32_LR, momentum=0.9)(p), dev,
                       chunk_rows=rows)
        torch.save({"losses": f32["losses"], "params": [p.detach().cpu() for p in f32["final"].parameters()]},
                   os.path.join(outdir, f"{name}.pt"))
        out["run_s"][name] = f32["run_s"]
        del f32
    return out


def _mp_rank_gloo(torch, outdir):
    """(b) of the model-parallel part, in each gloo child: the MP_ARMS on
    meshes of the 4 children, Transformer-base (the MoE arms: with 8
    experts a layer) in float32 for DDP_F32_STEPS steps, each against its
    float32 mesh-less run saved by (a) with how far the parameters moved,
    the MoE arms' routing calls (tokens, kept) counted; each arm's planted
    fault in a second run of its steps, which must fall outside that bar.
    On every rank, K3a/b/c against their plain versions at a tp-4
    rank's (16, 512, 2, 64) float32 shape (:func:`_k3_against_plain`: a
    mismatch fails the rank).  The ms of a tp all-reduce at the block's
    (B, T, d) output and of a ppermute at the ring's K/V block and at the
    pipeline's hand-off."""
    import dataclasses

    from flink_parameter_server_tpu_torch import TransformerConfig, init_params, sgd
    from flink_parameter_server_tpu_torch.core import dense
    from flink_parameter_server_tpu_torch.models import moe
    from flink_parameter_server_tpu_torch.models import transformer as tr
    from flink_parameter_server_tpu_torch.parallel import collectives as coll
    from flink_parameter_server_tpu_torch.parallel import pipeline
    from flink_parameter_server_tpu_torch.parallel.mesh import make_nd_mesh, mesh_device

    base = TransformerConfig(flash_attention="on", dtype=torch.float32)
    meshes = {}
    for name, shape, axes, *_ in MP_ARMS:
        meshes.setdefault((shape, axes), make_nd_mesh(shape, axes, device_type="cuda"))
    dev = mesh_device(meshes[(1, MP_WORLD), ("dp", "tp")])
    batches = _ddp_batches(DDP_F32_STEPS, base.vocab_size, mask_at=1)
    opt = lambda p: sgd(DDP_F32_LR, momentum=0.9)(p)  # noqa: E731
    real = {"copy_to_tp": coll.copy_to_tp, "sum": dense._sum_over_model_axes, "scale": pipeline.scale_grad,
            "axes": tr._moe_token_axes, "route": moe._route}
    def tp_sum(named, layout):  # the planted fault: the leaves every tp rank holds whole summed over tp too
        for n, p in named:
            if ".moe." in n or n.startswith("stages."):
                p.grad = coll.all_reduce_sum(p.grad, layout.mesh, "tp")
        real["sum"](named, layout)

    plants = {"copy": lambda: setattr(coll, "copy_to_tp", lambda x, mesh, axis: x),
              "sum": lambda: setattr(dense, "_sum_over_model_axes", lambda named, layout: None),
              "scale": lambda: setattr(pipeline, "scale_grad", lambda x, factor: x),
              "slice": lambda: setattr(tr, "_moe_token_axes", lambda m, c: [
                  a for a in real["axes"](m, c) if a[0] != c.sp_axis]),
              "tp_sum": lambda: setattr(dense, "_sum_over_model_axes", tp_sum), "shard": lambda: None}

    def restore():
        coll.copy_to_tp, dense._sum_over_model_axes, pipeline.scale_grad = (
            real["copy_to_tp"], real["sum"], real["scale"])
        tr._moe_token_axes, moe._route = real["axes"], real["route"]

    routed = []

    def spy(x, w, E, C):  # the tokens each routing call routes together, and keeps
        r = real["route"](x, w, E, C)
        routed.append((int(x.shape[0]), int(r[2].sum())))
        return r

    out, refs = {}, {}
    for name, shape, axes, fields, kw, ref_name, fault in MP_ARMS:
        t = time.perf_counter()
        cfg = dataclasses.replace(base, **fields)
        mesh = meshes[shape, axes]
        if ref_name not in refs:
            ref = torch.load(os.path.join(outdir, f"{ref_name}.pt"))
            capacity = MP_REFERENCES.get(ref_name, (None,))[0]
            ref_cfg = dataclasses.replace(base, **_mp_moe(capacity)) if capacity else base
            init = list(init_params(ref_cfg, torch.Generator(device=dev).manual_seed(0), device=dev).parameters())
            refs[ref_name] = (ref, [p.to(dev) for p in ref["params"]], [p.detach() for p in init])
            del init
        ref, ref_params, init = refs[ref_name]
        routed.clear()
        moe._route = spy
        try:
            run = _ddp_run(torch, cfg, "replicated", batches, mesh, opt, dev, loss_kw=kw)
        finally:
            restore()
        ok, err, past, moved = _held(torch, run, ref_params, init)
        arm = dict(ok=ok and bool(np.allclose(run["losses"], ref["losses"], rtol=1e-4)), err=err, past=past,
                   moved=moved, losses=run["losses"], ref_losses=ref["losses"], routed=sorted(set(routed)),
                   dropped=sum(n - k for n, k in routed), routing_calls=len(routed),
                   **{k: run[k] for k in ("launches", "calls", "steps_ms", "run_s", "held")})
        del run
        plants[fault]()
        try:
            bad = _ddp_run(torch, cfg, "replicated", batches, mesh, opt, dev,
                           loss_kw=dict(kw, num_microbatches=1) if fault == "shard" else kw)
        finally:
            restore()
        ok, err, past, _ = _held(torch, bad, ref_params, init)
        arm["planted"] = dict(caught=not ok, err=err, past=past, elements=sum(p.numel() for p in init))
        del bad
        arm["arm_s"] = round(time.perf_counter() - t, 2)
        out[name] = arm
        torch.cuda.empty_cache()
    del refs
    gen = torch.Generator(device=dev).manual_seed(100 + torch.distributed.get_rank())
    out["tp"]["k3"] = _k3_against_plain(torch, dev, gen, LM_B, LM_T, base.n_heads // MP_WORLD, base.head_dim,
                                        torch.float32)
    x = torch.ones(LM_B, LM_T, base.d_model, device=dev)
    kv = torch.ones(2, LM_B, base.n_heads, LM_T // MP_WORLD, base.head_dim, device=dev)
    hand = torch.ones(LM_B // MP_MICRO, LM_T // 2, base.d_model, device=dev)
    tp_mesh, sp_mesh = meshes[(1, MP_WORLD), ("dp", "tp")], meshes[(1, MP_WORLD), ("dp", "sp")]
    pp_mesh = meshes[(1, 2, 2), ("dp", "pp", "sp")]
    out["collective_ms"] = {
        "tp_all_reduce": _ddp_time_ms(torch, lambda: coll.all_reduce_sum(x, tp_mesh, "tp")),
        "tp_bytes": x.numel() * 4,
        "sp_ppermute": _ddp_time_ms(torch, lambda: coll.ppermute(kv, sp_mesh, "sp")),
        "sp_bytes": kv.numel() * 4,
        "pp_ppermute": _ddp_time_ms(torch, lambda: coll.ppermute(hand, pp_mesh, "pp")),
        "pp_bytes": hand.numel() * 4,
    }
    torch.cuda.empty_cache()
    return out


def _mp_report(a, a_s, b, layers, flash, card):
    """Print and check the model-parallel part of phase_parallel_dense;
    adds the flash launches of (a) and of (b)'s tp ranks to ``flash``."""
    print(f"dense_dp: mp (a) one-rank meshes, backend {a['backend']!r}: Transformer-base bf16 (MoE: {MOE_EXPERTS} "
          f"experts, capacity {MOE_CAPACITY}), {MP_STEPS} steps of {LM_B}x{LM_T}; {card}")
    check(a["backend"] == "nccl", f"dense_dp: mp (a) ran on {a['backend']}, not NCCL")
    on = {name: layers * MP_STEPS for name in FLASH}
    want = {"sp_tp": on, "pp": dict.fromkeys(FLASH, 0), "moe_ep_tp": on, "moe_pp": dict.fromkeys(FLASH, 0)}
    for name, what in (("sp_tp", "('dp', 'sp', 'tp') flash on"),
                       ("pp", "('dp', 'pp') forward_pipelined, 1 microbatch, flash off"),
                       ("moe_ep_tp", "MoE LM on ('dp', 'ep', 'tp') flash on"),
                       ("moe_pp", "MoE LM on ('dp', 'pp') forward_pipelined, 1 microbatch, flash auto")):
        r = a[name]
        got = {k: r["launches"][k] for k in FLASH}
        print(f"dense_dp: mp (a) {what}: {'bitwise' if r['bitwise'] else 'NOT bitwise'} the mesh-less run; losses "
              f"{[round(x, 5) for x in r['losses']]}; step ms {r['steps_ms']} (mesh-less {r['base_ms']}); "
              f"collectives {r['calls']}; flash launches {got}; the run {r['run_s']} s, with the mesh-less one "
              f"{a['run_s'][name]} s")
        check(r["bitwise"], f"dense_dp: mp (a) {name} is not bitwise the mesh-less transform_dense")
        check(got == want[name] and r["launches"]["scatter_add"] == 0,
              f"dense_dp: mp (a) {name} launched {r['launches']}, expected {want[name]}")
        for k in FLASH:
            flash[k] += got[k]
    print(f"dense_dp: mp (a) the float32 mesh-less MoE runs for (b), s: "
          f"{ {k: a['run_s'][k] for k in MP_REFERENCES} }; the part {a_s:.1f} s; {card}")
    for r, res in enumerate(b):
        mp = res["mp"]
        for name, shape, axes, fields, _, ref_name, fault in MP_ARMS:
            arm, pl = mp[name], mp[name]["planted"]
            got = {k: arm["launches"][k] for k in FLASH}
            moe = (f"capacity {fields['moe_capacity']}: {arm['routing_calls']} routing calls of (tokens, kept) "
                   f"{arm['routed']}, {arm['dropped']} tokens dropped; " if "moe_capacity" in fields else "")
            print(f"dense_dp: mp (b) rank {r} {name} on {dict(zip(axes, shape))}: float32 {DDP_F32_STEPS} steps "
                  f"against (a)'s float32 mesh-less run {ref_name} max_abs_err={arm['err']:.3e} (rtol=1e-5 atol=1e-6; "
                  f"the parameters moved up to {arm['moved']:.3e}) losses {[round(x, 6) for x in arm['losses']]} "
                  f"against {[round(x, 6) for x in arm['ref_losses']]} {'ok' if arm['ok'] else 'MISMATCH'}; {moe}"
                  f"holds {arm['held']}; step ms {arm['steps_ms']}; collectives {arm['calls']}; flash launches {got}; "
                  f"the planted fault ({fault}) max_abs_err={pl['err']:.3e}, {pl['past']} of {pl['elements']} "
                  f"elements past the bar: {'caught' if pl['caught'] else 'MISSED'}; the arm {arm['arm_s']} s; {card}")
            check(arm["ok"], f"dense_dp: mp (b) rank {r} {name} is off (a)'s float32 run")
            check(pl["caught"], f"dense_dp: mp (b) rank {r} {name}: the bar does not see the planted fault")
            if name in MP_ROUTED:
                check(arm["dropped"] > 0 and all(n == MP_ROUTED[name] for n, _ in arm["routed"]),
                      f"dense_dp: mp (b) rank {r} {name}: routing calls {arm['routed']} do not route "
                      f"{MP_ROUTED[name]} tokens each with drops")
            want = {k: layers * DDP_F32_STEPS if _mp_flash_arm(axes) else 0 for k in FLASH}
            check(got == want and arm["launches"]["scatter_add"] == 0,
                  f"dense_dp: mp (b) rank {r} {name} launched {arm['launches']}, expected {want}")
            for k in FLASH:
                flash[k] += got[k]
        k3, c = mp["tp"]["k3"], mp["collective_ms"]
        earlier = sum(mp[n]["arm_s"] for n in MP_EARLIER)
        later = sum(mp[n]["arm_s"] for n, *_ in MP_ARMS if n not in MP_EARLIER)
        print(f"dense_dp: mp (b) rank {r} K3a/b/c against their plain versions at a tp rank's (B {LM_B}, T {LM_T}, "
              f"H {LM_H // MP_WORLD}, D {LM_D}) float32: "
              f"max |error| { {k: f'{v:.3e}' for k, v in k3.items()} } (rtol=1e-5, atol=1e-5 x the largest: a "
              f"mismatch fails the rank); gloo over CUDA tensors: tp all_reduce {c['tp_all_reduce']:.2f} ms "
              f"at {c['tp_bytes']} B, sp ppermute {c['sp_ppermute']:.2f} ms at {c['sp_bytes']} B (the ring's K/V "
              f"block), pp ppermute {c['pp_ppermute']:.2f} ms at {c['pp_bytes']} B (the pipeline's hand-off) "
              f"(medians of {DDP_REPS}); the part {mp['seconds']} s, of which the arms {MP_EARLIER} {earlier:.2f} s "
              f"and the later arms {later:.2f} s; {card}")


# part: (the rank's function, the kernels it launches); every part is a gloo group on cuda:0
def _gloo_rank(torch, outdir):
    """One gloo child of phase_parallel_dense: the parameter server's (b)
    and (c), then the dense LM's (b) with the ep part's (b).  One spawn
    serves both, so 4 children's ``import torch`` (about 10 s at once) is
    paid once."""
    t = time.perf_counter()
    par = _par_rank_gloo(torch, outdir)
    par["work_s"] = round(time.perf_counter() - t, 2)
    torch.cuda.empty_cache()
    return {"par": par, "dense": _ddp_rank_gloo(torch, outdir)}


GLOO_LIBRARIES = ("scatter_add", "fused_mf", "flash_attn")  # the kernels a gloo child launches


@contextlib.contextmanager
def _one_rank_group(torch):
    """A one-rank NCCL group in this process, over an in-memory store (no
    port, no child), torn down after: the world of each phase's (a)."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def parallel_rank(argv) -> int:
    """A gloo rank on ``cuda:0`` of ``phase_parallel_dense``:
    ``--parallel-rank <init> <world> <rank> <outdir>``.  Runs :func:`_gloo_rank` and writes ``<outdir>/gloo.r<rank>.json`` (or the
    traceback beside it) and exits non-zero on a failure."""
    import traceback

    t0 = time.perf_counter()
    import torch

    init, world, rank, outdir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    sys.path.insert(0, REPO)
    path = os.path.join(outdir, f"gloo.r{rank}")
    try:
        from flink_parameter_server_tpu_torch.ops import _cuda
        from flink_parameter_server_tpu_torch.parallel import multihost

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)  # every rank on the one card
        t_import = time.perf_counter() - t0
        multihost.initialize(init, world, rank, backend="gloo", device_type="cuda", timeout_s=PAR_TIMEOUT_S)
        for name in GLOO_LIBRARIES:  # built by the parent's phase_build, never here
            check(_cuda.library_path(name).exists(), f"{name} is not built")
        t_group = time.perf_counter() - t0 - t_import
        out = _gloo_rank(torch, outdir)
        out["seconds"] = {"import": round(t_import, 2), "group": round(t_group, 2),
                          "work": round(time.perf_counter() - t0 - t_import - t_group, 2)}
        torch.distributed.destroy_process_group()
        with open(path + ".json", "w") as fh:
            json.dump(out, fh)
        return 0
    except Exception:
        with open(path + ".err", "w") as fh:
            fh.write(traceback.format_exc())
        return 1


def _spawn_ranks(world: int, outdir: str) -> list:
    """Run ``world`` gloo ranks (:func:`parallel_rank`) as child processes of this script,
    each on the one card, under one wall-clock limit; every rank's result,
    or a failure with the ranks' logs."""
    init = "file://" + os.path.join(outdir, "gloo.rendezvous")  # no port to race for
    procs, logs = [], []
    for r in range(world):
        logs.append(os.path.join(outdir, f"gloo.r{r}.log"))
        with open(logs[-1], "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--parallel-rank", init, str(world), str(r),
                 outdir], stdout=fh, stderr=subprocess.STDOUT, cwd=REPO))
    deadline = time.monotonic() + PAR_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results, failures = [], []
    for r, p in enumerate(procs):
        base = os.path.join(outdir, f"gloo.r{r}")
        if p.returncode == 0 and os.path.exists(base + ".json"):
            with open(base + ".json") as fh:
                results.append(json.load(fh))
            continue
        err = open(base + ".err").read() if os.path.exists(base + ".err") else ""
        failures.append(f"rank {r} rc {p.returncode}: {err[-2000:]}\n{open(logs[r]).read()[-2000:]}")
    if failures:
        raise SmokeFailure("the gloo ranks failed:\n" + "\n".join(failures))
    return results


def _parallel_report(a, a_s, b, b_s, card):
    """The parameter server across devices (the ``parallel/`` plane, the
    sharded store with K1 on each shard, the ps-sharded fused step with K2
    on each shard, the sharded top-K): print and check its runs in
    phase_parallel_dense.  (a) ran in this process over a one-rank NCCL
    group (no child to start: its import and first-use costs were most of
    its time), (b) and (c) in the gloo children (:func:`_gloo_rank`).

    (a) A 1 x 1 NCCL mesh (one rank): the main path's MF at full width
        (100,000 x 131,072, dim 64, ``scatter_impl="pallas"``, lr 0.01) over
        4 Zipf 1.2 microbatches of 65,536 ratings: item and user tables
        bitwise ``ps_online_mf`` without a mesh on the same batches (each
        collective a size-1 NCCL call), and pulls and the top-K of 64
        users through the mesh path bitwise the plain answers.
    (b) ps > 1 on the one card: NCCL refuses two ranks on one card, so a
        2 x 2 mesh of 4 ranks, each on ``cuda:0``, runs over a gloo group
        with CUDA tensors (gloo stages them through the host) -- an
        explicit choice of this phase, not a fallback.  The same MF: the
        tables within rtol 1e-5 / atol 1e-6 of (a)'s, pulls and the
        sharded top-K bitwise the answers from the whole table; K1 once a
        rank a step on its ps block.
    (c) The same 4 ranks as a 1 x 4 ps-only mesh: ``fused_mf_sgd_sharded``
        at dim 128 over the same microbatches, K2 once a rank a step, the
        tables and predictions within rtol 1e-5 / atol 1e-6 of the
        unsharded fused step.
    Each rank also times its pull and push and the step's all-reduce and
    all-gather.  Returns the ranks' K1 and K2 launches."""
    print(f"parallel: (a) 1 x 1 mesh, backend {a['backend']!r} (dist.get_backend()): MF {NUM_USERS} x "
          f"{NUM_ITEMS} dim {DIM_UNFUSED} pallas, {PAR_STEPS} microbatches of {BATCH}: tables "
          f"{'bitwise' if a['bitwise'] else 'NOT bitwise'} ps_online_mf without a mesh; pulls "
          f"{'bitwise' if a['pulls_bitwise'] else 'DIFFER'}, top-{PAR_TOPK} of {PAR_QUERIES} users "
          f"{'bitwise' if a['topk_bitwise'] else 'DIFFER'}; K1 {a['k1']} launches; collectives {a['calls']}; "
          f"{PAR_STEPS} steps in turns (without, with, with, without) "
          f"{[round(w, 4) for w in a['walls']['mesh']]} s with the mesh against "
          f"{[round(w, 4) for w in a['walls']['plain']]} s without; pull {a['pull_ms']:.3f} ms, "
          f"push {a['push_ms']:.3f} ms, all_reduce {a['all_reduce_ms']:.3f} ms; spawn and run {a_s:.1f} s; {card}")
    check(a["backend"] == "nccl", f"(a) ran on {a['backend']}, not NCCL")
    check(a["bitwise"] and a["pulls_bitwise"] and a["topk_bitwise"], "(a) the 1 x 1 mesh is not the unsharded run")
    check(a["k1"] == PAR_STEPS, f"(a) K1 launched {a['k1']} times, expected {PAR_STEPS}")
    for r, res in enumerate(b):
        print(f"parallel: (b) 2 x 2 mesh rank {r}, backend {res['backend']!r} over CUDA tensors (every rank on "
              f"cuda:0; NCCL takes one rank a card): tables against (a) max_abs_err={res['mf_err']:.3e} "
              f"(rtol=1e-5 atol=1e-6) {'ok' if res['mf_ok'] else 'MISMATCH'}, bitwise={res['mf_bitwise']}; "
              f"pulls {'bitwise' if res['pulls_bitwise'] else 'DIFFER'}, sharded top-{PAR_TOPK} "
              f"{'bitwise' if res['topk_bitwise'] else 'DIFFER'}; block {res['block_rows']} rows; K1 {res['k1']}; "
              f"collectives {res['calls']}; MF {res['wall_s']:.3f} s; pull {res['pull_ms']:.3f} ms, push "
              f"{res['push_ms']:.3f} ms, all_reduce {res['all_reduce_ms']:.3f} ms, all_gather "
              f"{res['all_gather_ms']:.3f} ms; (c) 1 x 4 fused dim {DIM_FUSED}: K2 {res['k2']}, "
              f"{res['fused_wall_s']:.3f} s" + (f", against the unsharded fused step max_abs_err="
                                                f"{res['fused_err']:.3e} {'ok' if res['fused_ok'] else 'MISMATCH'}"
                                                if "fused_ok" in res else ""))
        check(res["backend"] == "gloo", f"(b) rank {r} ran on {res['backend']}")
        check(res["mf_ok"] and res["pulls_bitwise"] and res["topk_bitwise"], f"(b) rank {r} disagrees")
        check(res["k1"] == PAR_STEPS and res["k2"] == PAR_STEPS, f"(b)/(c) rank {r} launched K1 {res['k1']}, "
              f"K2 {res['k2']} times, expected {PAR_STEPS} each")
    check(b[0]["fused_ok"], "(c) the ps-sharded fused step is off the unsharded one")
    k1 = a["k1"] + sum(res["k1"] for res in b)
    k2 = sum(res["k2"] for res in b)
    print(f"parallel: K1 {k1} launches ({a['k1']} + {len(b)} ranks x {PAR_STEPS}), K2 {k2} ({len(b)} x "
          f"{PAR_STEPS}); (a) {a_s:.1f} s, (b)+(c) {b_s:.1f} s of the children's work; {card}")
    return {"scatter_add": k1, "fused_mf_sgd": k2}


def _ddp_store(torch, dev, card):
    """(c): the cluster's mesh backend with DDP_BLOCKS row blocks on the
    card against one block, at the MF path's width; the store's momentum
    velocity split over the blocks.  Returns the printed timings."""
    import shutil
    import tempfile

    from flink_parameter_server_tpu_torch.cluster import ClusterConfig, ClusterDriver
    from flink_parameter_server_tpu_torch.meshstore import MeshParamStore, make_store_mesh
    from flink_parameter_server_tpu_torch.models.matrix_factorization import OnlineMatrixFactorization, SGDUpdater
    from flink_parameter_server_tpu_torch.telemetry.registry import MetricsRegistry
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    init = ranged_random_factor(1, (DIM_UNFUSED,))
    stream = zipf_stream(PAR_SEED, DDP_ROUNDS)
    tmp = tempfile.mkdtemp(prefix="dense-dp-", dir=os.path.join(REPO, "build"))
    out = {}
    try:
        def run(blocks, wal=None):
            reg = MetricsRegistry()
            logic = OnlineMatrixFactorization(NUM_USERS, DIM_UNFUSED, updater=SGDUpdater(LEARNING_RATE), device=dev)
            cfg = ClusterConfig(store_backend="mesh", mesh_devices=[str(dev)] * blocks, num_shards=CLUSTER_SHARDS,
                                num_workers=1, wal_dir=wal)
            with ClusterDriver(logic, capacity=NUM_ITEMS, value_shape=(DIM_UNFUSED,), init_fn=init, config=cfg,
                               registry=reg, device=dev) as d:
                zero_counts()
                r = d.run(stream, timeout=600)
                read_counts(f"dense_dp: (c) the mesh store at {blocks} blocks", {})
                st = d.mesh_store.stats()
                check(st["devices"] == blocks and all(b.device.type == dev.type for b in d.mesh_store.blocks),
                      f"dense_dp: (c) the store is not {blocks} blocks on the card: {st['block_devices']}")
                check(d.partitioner.rows_per_shard % d.mesh_store.block_rows == 0,
                      "dense_dp: (c) the partitioner is not aligned to the blocks")
                if wal is not None:
                    check(d.mesh_store.verify_against_log(), "dense_dp: (c) verify_against_log() is False")
            hist = {i.name: i for i in reg.instruments() if i.name.startswith("meshstore_") and i.name.endswith("seconds")}
            out[f"pull_ms_{blocks}"] = hist["meshstore_gather_seconds"].sum / hist["meshstore_gather_seconds"].count * 1e3
            out[f"push_ms_{blocks}"] = hist["meshstore_scatter_seconds"].sum / hist["meshstore_scatter_seconds"].count * 1e3
            return r

        one = run(1)
        many = run(DDP_BLOCKS, wal=tmp)
        check(one.values.tobytes() == many.values.tobytes(),
              f"dense_dp: (c) {DDP_BLOCKS} blocks are not bitwise one block")
        # the momentum store: one velocity tensor a block
        ids = torch.from_numpy(stream[0]["item"]).to(dev)
        deltas = torch.full((BATCH, DIM_UNFUSED), 1e-3, device=dev)
        stores = [MeshParamStore(NUM_ITEMS, (DIM_UNFUSED,), init_fn=init, momentum=0.9, registry=False,
                                 mesh=make_store_mesh([dev] * n)) for n in (1, DDP_BLOCKS)]
        for st in stores:
            for _ in range(2):
                st.push(ids, deltas)
        s1, sn = (st.stats() for st in stores)
        split = (sn["opt_state_bytes"] == sn["table_bytes"] == s1["table_bytes"]
                 and sn["bytes_per_device"] * DDP_BLOCKS == sn["table_bytes"] + sn["opt_state_bytes"]
                 and all(v.shape == b.shape and v.device == b.device
                         for v, b in zip(stores[1].opt_state, stores[1].blocks)))
        check(split, f"dense_dp: (c) the velocity is not split over the blocks: {sn}")
        check(stores[0].values().tobytes() == stores[1].values().tobytes(),
              "dense_dp: (c) the momentum store's blocks are not bitwise one block")
        out["velocity"] = (sn["opt_state_bytes"], sn["bytes_per_device"], s1["bytes_per_device"])
        for st in stores:
            st.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"dense_dp: (c) ClusterConfig(store_backend='mesh') MF {NUM_USERS} x {NUM_ITEMS} dim {DIM_UNFUSED}, "
          f"{DDP_ROUNDS} BSP rounds: {DDP_BLOCKS} row blocks on {dev} bitwise 1 block, verify_against_log() over "
          f"the {DDP_BLOCKS}-block WAL; pull {out['pull_ms_1']:.3f} / {out[f'pull_ms_{DDP_BLOCKS}']:.3f} ms, push "
          f"{out['push_ms_1']:.3f} / {out[f'push_ms_{DDP_BLOCKS}']:.3f} ms (1 / {DDP_BLOCKS} blocks, means to the "
          f"end of the device work); momentum 0.9: velocity {out['velocity'][0]} bytes in {DDP_BLOCKS} tensors, "
          f"{out['velocity'][1]} bytes a block holds with its velocity (1 block: {out['velocity'][2]}), 2 pushes bitwise "
          f"1 block; {card}")
    return out


def phase_parallel_dense(torch, dev, card):
    """The parameter server across devices (:func:`_parallel_report`), the
    dense LM across devices with expert
    parallelism, and the mesh store's row blocks.

    (a) A one-rank NCCL ``("dp",)`` mesh: Transformer-base at full width
        (the config defaults, bfloat16, ``flash_attention="on"``, 16 x 512
        bigram tokens, adamw(3e-3)) for 3 steps through ``transform_dense``
        in each regime (``batch_sharding=mesh``; ZeRO-1
        ``shard_opt_state=True``; FSDP ``fsdp_place``), each bitwise the
        unsharded ``transform_dense`` on the same batches (every
        collective a size-1 NCCL call); K3a/b/c once a layer a step.
    (b) dp 4 as 4 gloo ranks on ``cuda:0`` (NCCL takes one rank a card):
        the same model in float32 (sgd(0.1, momentum 0.9): its moment
        buffer is the state ZeRO-1 cuts) for 2 steps, the second's batch
        row-masked so the ranks hold 4, 3, 1 and 0 valid rows, each regime
        within rtol 1e-5 / atol 1e-6 (and losses rtol 1e-4) of (a)'s
        unsharded float32 run, beside how far the parameters moved; the
        replicated run with rank 0's gradients zeroed (a planted fault)
        past that bar; the bytes of parameters and
        optimizer state a rank holds; the masked batch's loss through
        ``lm_loss(mesh=)`` on the ranks' rows equal (rtol 1e-5) to the
        unsharded loss; K3a/b/c on every rank; each collective's ms.
    (c) ``ClusterConfig(store_backend="mesh")`` with 4 row blocks on the
        card (``mesh_devices``) at the MF path's width, bitwise 1 block,
        ``verify_against_log()``; the momentum velocity 1/4 a block.
    ep  Expert parallelism, in the same group and the same children:
        (a) phase_moe_lm's MoE LM (Transformer-base, bfloat16, flash "on",
        8 experts, capacity 1,280) on a one-rank ``("dp", "ep")`` NCCL mesh
        for 3 steps of 16 x 512 through ``transform_dense(batch_sharding=
        mesh)``, bitwise the mesh-less run (ep 1: each all-to-all is a
        size-1 NCCL copy and the expert product the same batched product),
        K3a/b/c once a layer a step; tokens/s, step ms, the MoE layers' ms.
        (b) ep 4 as the 4 gloo children on a (1, 4) mesh: the same model in
        float32 (flash "on") for 2 steps within rtol 1e-5 / atol 1e-6
        (losses rtol 1e-4) of (a)'s float32 mesh-less run, K3a/b/c once a
        layer a step on every rank; the experts' gradients left 4 times
        large (a planted fault) past that bar on every rank; the same
        model on the dp-only mesh of the 4 children at capacity 1,024 for
        1 step, routing the global batch with drops, within that bar of
        the mesh-less run at that capacity, its logits within the bar of
        the mesh-less forward and each rank routing its own rows (a
        planted fault) past it; ``moe_apply`` on a (2, 2) mesh
        against ``moe_reference`` on each dp half, forward and gradients;
        the all-to-all's ms and bytes.
    mp  Tensor, sequence and pipeline parallelism, and MoE layers beside
        them, in the same group and the same children: (a) Transformer-base
        (bfloat16) for 3 steps on a one-rank ``("dp", "sp", "tp")`` NCCL
        mesh (flash "on", K3a/b/c once a layer a step) and a one-rank
        ``("dp", "pp")`` mesh (``forward_pipelined``, 1 microbatch), and
        the MoE LM (8 experts, capacity 1,280) on a one-rank ``("dp",
        "ep", "tp")`` mesh (flash "on") and a one-rank ``("dp", "pp")``
        mesh (1 microbatch, flash "auto"), each bitwise the mesh-less run
        of the same attention.  (b) In float32 for 2 steps (MP_ARMS): the
        dense model at tp 4 (flash "on": K3a/b/c once a layer a step on
        every rank's 2 heads), sp 4 (the ring, 128 positions a rank), pp 2
        x sp 2 and pp 2 x tp 2 (``forward_pipelined``, 2 microbatches),
        and the MoE LM at tp 4 and ep 2 x tp 2 (K3a/b/c on each rank's
        heads), ep 2 x sp 2 and pp 2 x dp 2 (2 microbatches), at
        capacities that drop tokens under each layout's rule; each within
        rtol 1e-5 / atol 1e-6 (losses rtol 1e-4) of its float32 mesh-less
        run, each with a planted fault past that bar; the ms of a tp all-reduce and of a ppermute at the
        ring's and the pipeline's payloads (:func:`_mp_rank_gloo`).
    Returns the parameter server's K1 and K2 launches and the ranks' flash
    launches.

    The parts share their processes: the parameter server's (a), then the
    dense LM's (a), ep (a) and mp (a), run here over one one-rank NCCL
    group, and one spawn of 4 gloo children on ``cuda:0`` runs the
    parameter server's (b) and (c), then the dense LM's (b), ep (b) and mp
    (b) (:func:`_gloo_rank`)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="dense-dp-", dir=os.path.join(REPO, "build"))
    torch.cuda.empty_cache()  # the ranks share the card with this process
    try:
        t = time.perf_counter()
        with _one_rank_group(torch):
            par_a = _par_rank_nccl(torch, tmp)
            par_a_s = time.perf_counter() - t
            a = _ddp_rank_nccl(torch, tmp)
            a_s = time.perf_counter() - t - par_a_s
            ep_a = _ep_rank_nccl(torch, tmp)
            ep_a_s = time.perf_counter() - t - par_a_s - a_s
            mp_a = _mp_rank_nccl(torch, tmp)
        mp_a_s = time.perf_counter() - t - par_a_s - a_s - ep_a_s
        t = time.perf_counter()
        ranks = _spawn_ranks(DDP_WORLD, tmp)
        b_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    parallel = _parallel_report(par_a, par_a_s, [res["par"] for res in ranks],
                                statistics.median(res["par"]["work_s"] for res in ranks), card)
    b = [dict(res["dense"], seconds=res["seconds"]) for res in ranks]
    from flink_parameter_server_tpu_torch import TransformerConfig

    layers = TransformerConfig().n_layers
    per_step = {name: layers * DDP_STEPS for name in FLASH}
    print(f"dense_dp: (a) one-rank mesh, backend {a['backend']!r}: Transformer-base bf16 flash on, {DDP_STEPS} "
          f"steps of {LM_B}x{LM_T}: unsharded losses {[round(x, 5) for x in a['base_losses']]}, step ms "
          f"{a['unsharded_ms']}; runs (s) {a['run_s']}; {card}")
    check(a["backend"] == "nccl", f"dense_dp: (a) ran on {a['backend']}, not NCCL")
    flash = dict.fromkeys(FLASH, 0)
    for regime in DDP_REGIMES:
        r = a[regime]
        print(f"dense_dp: (a) {regime}: {'bitwise' if r['bitwise'] else 'NOT bitwise'} the unsharded run; step ms "
              f"{r['steps_ms']}; collectives {r['calls']}; flash launches "
              f"{ {k: r['launches'][k] for k in FLASH} }; the run {r['run_s']} s")
        check(r["bitwise"], f"dense_dp: (a) {regime} is not bitwise the unsharded transform_dense")
        check({k: r["launches"][k] for k in FLASH} == per_step and r["launches"]["scatter_add"] == 0,
              f"dense_dp: (a) {regime} launched {r['launches']}, expected {per_step}")
        for k in FLASH:
            flash[k] += r["launches"][k]
    per_rank = {name: layers * DDP_F32_STEPS for name in FLASH}
    repl = {res["rank"]: res["replicated"] for res in b}
    for res in b:
        rank = res["rank"]
        check(res["backend"] == "gloo", f"dense_dp: (b) rank {rank} ran on {res['backend']}")
        for regime in DDP_REGIMES:
            r = res[regime]
            z = r["opt_bytes"] / repl[rank]["opt_bytes"]
            total = (r["params_bytes"] + r["opt_bytes"]) / (repl[rank]["params_bytes"] + repl[rank]["opt_bytes"])
            print(f"dense_dp: (b) rank {rank} {regime}: against (a)'s unsharded float32 run max_abs_err="
                  f"{r['err']:.3e} (rtol=1e-5 atol=1e-6; the parameters moved up to {r['moved']:.3e}) losses {[round(x, 6) for x in r['losses']]} "
                  f"against {[round(x, 6) for x in r['ref_losses']]} {'ok' if r['ok'] else 'MISMATCH'}; holds "
                  f"params {r['params_bytes']} B, optimizer state {r['opt_bytes']} B ({z:.4f} / {total:.4f} of "
                  f"replicated's optimizer / total); step ms {r['steps_ms']}; collectives {r['calls']}; the run "
                  f"{r['run_s']} s; {card}")
            check(r["ok"], f"dense_dp: (b) rank {rank} {regime} is off (a)'s float32 run")
            check({k: r["launches"][k] for k in FLASH} == per_rank,
                  f"dense_dp: (b) rank {rank} {regime} launched {r['launches']}, expected {per_rank}")
            for k in FLASH:
                flash[k] += r["launches"][k]
        pl = res["planted"]
        print(f"dense_dp: (b) rank {rank} the bar's reach: replicated with rank 0's gradients zeroed is "
              f"max_abs_err={pl['err']:.3e} off (a)'s run, {pl['past']} of {pl['elements']} elements past "
              f"the bar: {'caught' if pl['caught'] else 'MISSED'}")
        check(pl["caught"], f"dense_dp: (b) rank {rank}: the bar does not see a rank's gradients dropped")
        check(0.9 / DDP_WORLD < res["zero1"]["opt_bytes"] / repl[rank]["opt_bytes"] < 1.5 / DDP_WORLD
              and res["zero1"]["params_bytes"] <= repl[rank]["params_bytes"],
              f"dense_dp: (b) rank {rank}: ZeRO-1 does not hold 1/{DDP_WORLD} of the optimizer state")
        fs = res["fsdp"]
        check(0.9 / DDP_WORLD < (fs["params_bytes"] + fs["opt_bytes"])
              / (repl[rank]["params_bytes"] + repl[rank]["opt_bytes"]) < 1.8 / DDP_WORLD,
              f"dense_dp: (b) rank {rank}: FSDP does not hold 1/{DDP_WORLD} of parameters and optimizer state")
        m = res["masked"]
        c = res["collective_ms"]
        print(f"dense_dp: (b) rank {rank} row-masked batch (valid rows a rank {m['rows']}): lm_loss(mesh=) "
              f"{m['sharded']:.7f} against the unsharded {m['whole']:.7f} {'ok' if m['ok'] else 'MISMATCH'}; "
              f"gloo over CUDA tensors at {c['payload_bytes']} B of float32 gradients: all_reduce "
              f"{c['all_reduce']:.1f} ms, reduce_scatter {c['reduce_scatter']:.1f} ms, all_gather (a quarter each) "
              f"{c['all_gather']:.1f} ms (medians of {DDP_REPS}); {card}")
        check(m["ok"], f"dense_dp: (b) rank {rank}: the masked loss is off the unsharded one")
        check(len(set(m["rows"])) > 1, "dense_dp: (b) the masked batch gives every rank the same count")
    _ep_report(ep_a, ep_a_s, [res["ep"] for res in b], layers, flash, card)
    _mp_report(mp_a, mp_a_s, b, layers, flash, card)
    _ddp_store(torch, dev, card)
    secs = [dict(res["seconds"], parallel=res["par"]["work_s"], ep=res["dense"]["ep"]["seconds"],
                 mp=res["dense"]["mp"]["seconds"]) for res in ranks]
    print(f"dense_dp: the gloo children's seconds (import torch, bring up the group, the work, of which the "
          f"parameter server's, the ep part's and the mp part's): {secs}")
    tp_arms = sum(_mp_flash_arm(axes) for _, _, axes, *_ in MP_ARMS)
    print(f"dense_dp: flash launches {flash} ((a) 3 regimes x {DDP_STEPS} steps x {layers} layers + (b) {DDP_WORLD} "
          f"ranks x 3 regimes x {DDP_F32_STEPS} steps x {layers} layers + ep (a) {EP_STEPS} steps x {layers} layers "
          f"+ ep (b) {EP_WORLD} ranks x ({EP_F32_STEPS} + {EP_DP_STEPS}) steps x {layers} layers + mp (a) 2 arms x "
          f"{MP_STEPS} steps x {layers} layers + mp (b) {MP_WORLD} ranks x {tp_arms} tp arms x {DDP_F32_STEPS} steps "
          f"x {layers} layers); parallel (a) {par_a_s:.1f} s, (a) {a_s:.1f} s, ep (a) {ep_a_s:.1f} s, mp (a) {mp_a_s:.1f} s, "
          f"the children {b_s:.1f} s; phase took {time.perf_counter() - t_phase:.1f} s; {card}")
    return parallel, flash


def _ep_report(a, a_s, b, layers, flash, card):
    """Print and check the ep part of phase_parallel_dense; adds the flash
    launches of (a) and of (b)'s ranks to ``flash``."""
    per_step = {name: layers * EP_STEPS for name in FLASH}
    med = statistics.median(a["steps_ms"][1:])
    print(f"dense_dp: ep (a) one-rank ('dp', 'ep') mesh, backend {a['backend']!r}: MoE LM Transformer-base bf16 "
          f"flash on, {MOE_EXPERTS} experts, capacity {MOE_CAPACITY}, {EP_STEPS} steps of {LM_B}x{LM_T}: "
          f"{'bitwise' if a['bitwise'] else 'NOT bitwise'} the mesh-less run (max |error| {a['max_err']:.3e}); "
          f"losses {[round(x, 5) for x in a['losses']]} against {[round(x, 5) for x in a['base_losses']]}; step ms "
          f"{a['steps_ms']} (mesh-less {a['base_ms']}); {LM_B * LM_T / med * 1e3:,.0f} tokens/s at the median of "
          f"steps 2-{EP_STEPS}; the {layers} MoE layers' forward and backward alone {a['moe_ms']:.3f} ms "
          f"({a['moe_ms'] / med:.1%} of the step); collectives {a['calls']}; all_to_all {a['a2a_ms']:.3f} ms at "
          f"{a['a2a_bytes']} B (bf16 (E, C, d), NCCL, one rank: a copy); flash launches "
          f"{ {k: a['launches'][k] for k in FLASH} }; {a_s:.1f} s; {card}")
    check(a["backend"] == "nccl", f"dense_dp: ep (a) ran on {a['backend']}, not NCCL")
    check(a["bitwise"], "dense_dp: ep (a) the one-rank ep mesh is not bitwise the mesh-less MoE LM")
    check({k: a["launches"][k] for k in FLASH} == per_step and a["launches"]["scatter_add"] == 0,
          f"dense_dp: ep (a) launched {a['launches']}, expected {per_step}")
    check(a["calls"]["all_to_all"] == 4 * layers * EP_STEPS,
          f"dense_dp: ep (a) made {a['calls']['all_to_all']} all-to-all trips, expected 4 a layer a step")
    for k in FLASH:
        flash[k] += a["launches"][k]
    for r, res in enumerate(b):
        pl, ly = res["planted"], res["layer"]
        print(f"dense_dp: ep (b) rank {r} of a (1, {EP_WORLD}) mesh, experts {res['experts']}: float32 MoE LM "
              f"{EP_F32_STEPS} steps against (a)'s float32 mesh-less run max_abs_err={res['err']:.3e} (rtol=1e-5 "
              f"atol=1e-6; the parameters moved up to {res['moved']:.3e}) losses {[round(x, 6) for x in res['losses']]} "
              f"against {[round(x, 6) for x in res['ref_losses']]} {'ok' if res['ok'] else 'MISMATCH'}; step ms "
              f"{res['steps_ms']}; collectives {res['calls']}; the planted fault (experts' gradients x{EP_WORLD}) "
              f"max_abs_err={pl['err']:.3e}, {pl['past']} of {pl['elements']} elements past the bar: "
              f"{'caught' if pl['caught'] else 'MISSED'}; flash launches {res['launches']}; {card}")
        dp, lg = res["dp"], res["dp"]["logits"]
        print(f"dense_dp: ep (b) rank {r} of a ({EP_WORLD},) dp-only mesh: float32 MoE LM at capacity "
              f"{EP_DP_CAPACITY}, {EP_DP_STEPS} step, routed (kept, tokens) a layer {dp['routed']}: against (a)'s "
              f"float32 mesh-less run max_abs_err={dp['err']:.3e} (rtol=1e-5 atol=1e-6; the parameters moved up to "
              f"{dp['moved']:.3e}) losses {[round(x, 6) for x in dp['losses']]} against "
              f"{[round(x, 6) for x in dp['ref_losses']]} {'ok' if dp['ok'] else 'MISMATCH'}; step ms "
              f"{dp['steps_ms']}; collectives {dp['calls']}; flash launches {dp['launches']}; the logits against the "
              f"mesh-less forward of the whole batch: the rank's max_abs_err={lg['got']['err']:.3e}, "
              f"{lg['got']['past']} of the batch's {lg['elements']} past the bar; the planted fault (each rank "
              f"routes its rows alone) the rank's max_abs_err={lg['planted']['err']:.3e}, {lg['planted']['past']} "
              f"of the batch's past the bar: "
              f"{'caught' if lg['planted']['past'] else 'MISSED'}; {card}")
        print(f"dense_dp: ep (b) rank {r} (2, 2) moe_apply, experts {ly['experts']}, {ly['kept']} of {ly['tokens']} "
              f"tokens of its dp half kept at capacity {EP_LAYER_CAPACITY}: max |error| against moe_reference "
              f"{ {k: f'{v:.3e}' for k, v in ly['errs'].items()} } (rtol={EP_LAYER_BAR}, atol={EP_LAYER_BAR} x the "
              f"oracle's largest) {'ok' if ly['ok'] else 'MISMATCH'}; gloo all_to_all over CUDA tensors "
              f"{res['a2a_ms']:.1f} ms at {res['a2a_bytes']} B (float32 (E, C, d), median of {DDP_REPS}); "
              f"the ep part {res['seconds']} s")
        check(res["ok"], f"dense_dp: ep (b) rank {r} is off (a)'s float32 mesh-less run")
        check(pl["caught"], f"dense_dp: ep (b) rank {r}: the bar does not see experts' gradients x{EP_WORLD}")
        for tag, run, steps in (("ep 4", res, EP_F32_STEPS), ("dp-only", res["dp"], EP_DP_STEPS)):
            want = {name: layers * steps for name in FLASH}
            check({k: run["launches"][k] for k in FLASH} == want and run["launches"]["scatter_add"] == 0,
                  f"dense_dp: ep (b) rank {r} {tag} launched {run['launches']}, expected {want}")
            for k in FLASH:
                flash[k] += run["launches"][k]
        check(dp["ok"], f"dense_dp: ep (b) rank {r}: the dp-only MoE LM is off (a)'s float32 mesh-less run")
        check(lg["got"]["past"] == 0, f"dense_dp: ep (b) rank {r}: the dp-only logits are off the mesh-less forward")
        check(lg["planted"]["past"] > 0, f"dense_dp: ep (b) rank {r}: the bar does not see per-rank routing")
        check(all(n == LM_B * LM_T for _, n in dp["routed"]) and any(k < n for k, n in dp["routed"]),
              f"dense_dp: ep (b) rank {r}: the dp-only run did not route the global batch with drops: {dp['routed']}")
        check(ly["ok"], f"dense_dp: ep (b) rank {r}: (2, 2) moe_apply is off moe_reference")
        check(ly["kept"] < ly["tokens"], f"dense_dp: ep (b) rank {r}: no token dropped at capacity {EP_LAYER_CAPACITY}")


def _counters():
    """Every kernel wrapper of the port, by the name the kernels line uses."""
    from flink_parameter_server_tpu_torch.ops import flash_attention as fa
    from flink_parameter_server_tpu_torch.ops import mf_kernel, scatter_kernel

    return {
        "scatter_add": scatter_kernel.sorted_scatter_add,
        "fused_mf_sgd": mf_kernel.sorted_fused_mf_sgd,
        "flash_fwd": fa.flash_fwd,
        "flash_bwd_dq": fa.flash_bwd_dq,
        "flash_bwd_dkv": fa.flash_bwd_dkv,
    }


def zero_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_counts(path: str, want: dict) -> dict:
    """Every kernel's launches since :func:`zero_counts`: those in ``want``
    must have launched exactly that often, every other kernel not at all."""
    counts = {name: fn.launches for name, fn in _counters().items()}
    print(f"main: kernel launches in {path}: {counts}")
    for name, n in counts.items():
        check(n == want.get(name, 0), f"{path} launched {name} {n} times, expected {want.get(name, 0)}")
    return counts


def bigram_batches(n, B, T, vocab, seed=0):
    """examples/transformer_lm.py's token stream: each row follows a fixed
    random permutation from a random first token."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(vocab)
    for _ in range(n):
        toks = np.empty((B, T), np.int32)
        toks[:, 0] = rng.integers(0, vocab, B)
        for t in range(1, T):
            toks[:, t] = perm[toks[:, t - 1]]
        yield {"tokens": toks}


def phase_build():
    from flink_parameter_server_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    built = _cuda.build()
    print(f"build: {', '.join(_cuda.SOURCES)} ready in {time.perf_counter() - t0:.2f} s "
          f"({len(built)} compiled now, the rest found in {_cuda.BUILD_DIR})")
    for name, report in built.items():  # ptxas: registers and spills of each kernel
        kernels = ptxas_report(report)
        for kernel, (regs, spill) in kernels.items():
            print(f"build: {name}: {kernel}: {regs} registers, {spill} bytes spilled")
        spilled = sorted(k for k, (_, b) in kernels.items() if b)
        print(f"build: {name}: {len(kernels)} kernels, {len(spilled)} spill: {spilled or 'none'}")


def ptxas_report(text: str) -> dict:
    """``{kernel: (registers, spill store bytes)}`` from ``-Xptxas -v``."""
    import re

    out, kernel, spill = {}, None, 0
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernel, spill = entry.group(1), 0
        stores = re.search(r"(\d+) bytes spill stores", line)
        if stores:
            spill = int(stores.group(1))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and kernel:
            out[_demangled(kernel)] = (int(regs.group(1)), spill)
    return out


def _demangled(symbol: str) -> str:
    """fps::name<template args> from an Itanium-mangled kernel symbol, as far
    as these kernels need: the name, then each type (f, 13__nv_bfloat16) or
    integer (Li64E) argument."""
    import re

    m = re.match(r"_ZN3fps(\d+)", symbol)
    if not m:
        return symbol
    n = int(m.group(1))
    name = symbol[m.end():m.end() + n]
    rest = symbol[m.end() + n:]
    args = []
    if rest.startswith("I"):
        for tok in re.finditer(r"Li(\d+)E|13__nv_bfloat16|(?<=[IE])f", rest.split("EEv")[0] + "E"):
            args.append(tok.group(1) or ("bf16" if "bfloat" in tok.group(0) else "float"))
    return f"{name}<{', '.join(args)}>" if args else name


def _compare(torch, name, got, want, rtol, atol, exact=False):
    """Kernel vs plain version.  Float tolerances: ``atol`` is relative to
    the result's largest magnitude, since a sum taken in another order errs
    in proportion to the run's scale, not to each element."""
    atol = atol * float(want.float().abs().max()) if want.numel() else atol
    ok = torch.equal(got, want) if exact else bool(
        torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
    )
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    tol = "exact" if exact else f"rtol={rtol:g} atol={atol:g}"
    print(f"check: {name}: max_abs_err={err:.3e} ({tol}) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name} kernel disagrees with its plain version")
    return err


def phase_kernels(torch, dev, gen):
    """Each kernel vs its plain version on identical sorted inputs."""
    from flink_parameter_server_tpu_torch.ops import mf_kernel, scatter_kernel

    rng = np.random.default_rng(0)
    items, users, ratings = zipf_batch(rng)
    ids = torch.from_numpy(items).to(dev)
    ids[:64] = -1  # dropped lanes: negative, past the end, masked
    ids[64:128] = NUM_ITEMS + 5
    mask = torch.rand(BATCH, generator=gen, device=dev) > 0.01
    errs = {}

    def same_twice(label, first, again):
        """The kernel's outputs from a second call on the same inputs: no
        atomics, so every bit agrees."""
        ok = all(bool(torch.equal(a, b)) for a, b in zip(first, again))
        print(f"check: {label}: two runs on the same inputs bitwise equal: {'ok' if ok else 'MISMATCH'}")
        check(ok, f"{label} differs between two runs on the same inputs")

    def k1(label, dtype, rows, width, sub_k=1, twice=False):
        W = 128 if sub_k > 1 else width
        if dtype == torch.int32:
            table = torch.randint(0, 2**30, (rows, W), generator=gen, device=dev, dtype=torch.int32)
            deltas = torch.randint(-3, 4, (BATCH, width), generator=gen, device=dev, dtype=torch.int32)
        else:
            table = (torch.randn(rows, W, generator=gen, device=dev) * 0.1).to(dtype)
            deltas = (torch.randn(BATCH, width, generator=gen, device=dev) * 0.01).to(dtype)
        s_ids, s_d = scatter_kernel.sort_lanes(ids, deltas, mask, rows * sub_k, dtype)
        got = scatter_kernel.sorted_scatter_add(table.clone(), s_ids, s_d, sub_k=sub_k)
        want = scatter_kernel.run_sum_write_plain(table.clone(), s_ids, s_d, sub_k=sub_k)
        if twice:
            again = scatter_kernel.sorted_scatter_add(table.clone(), s_ids, s_d, sub_k=sub_k)
            same_twice(label, [got], [again])
        torch.cuda.synchronize()
        if dtype == torch.int32:
            return _compare(torch, label, got, want, 0, 0, exact=True)
        if dtype == torch.bfloat16:  # one bfloat16 rounding either way
            return _compare(torch, label, got, want, rtol=2**-7, atol=2**-9)
        return _compare(torch, label, got, want, rtol=1e-5, atol=1e-5)

    errs["scatter_add"] = k1(f"scatter_add dense f32 ({NUM_ITEMS},{DIM_UNFUSED})", torch.float32,
                             NUM_ITEMS, DIM_UNFUSED, twice=True)
    k1(f"scatter_add dense bf16 ({NUM_ITEMS},{DIM_UNFUSED})", torch.bfloat16, NUM_ITEMS, DIM_UNFUSED)
    k1(f"scatter_add dense int32 ({NUM_ITEMS},{DIM_UNFUSED})", torch.int32, NUM_ITEMS, DIM_UNFUSED)
    k1(f"scatter_add packed sub_k=2 f32 ({NUM_ITEMS // 2},128)", torch.float32, NUM_ITEMS // 2,
       DIM_UNFUSED, sub_k=2)

    user_table = torch.randn(NUM_USERS, DIM_FUSED, generator=gen, device=dev) * 0.1
    u = torch.from_numpy(users).to(dev)
    r = torch.from_numpy(ratings).to(dev)

    def k2(label, rows, dim, sub_k=1, twice=False):
        W = 128 if sub_k > 1 else dim
        table = torch.randn(rows, W, generator=gen, device=dev) * 0.1
        lanes = mf_kernel.sort_lanes(rows * sub_k, user_table[:, :dim], u, ids, r, mask)
        _, s_items, _, s_r, s_m, s_p = lanes
        kw = dict(learning_rate=LEARNING_RATE, regularization=0.01, sub_k=sub_k)
        got_t = table.clone()
        got_u, got_p = mf_kernel.sorted_fused_mf_sgd(got_t, s_items, s_p, s_r, s_m, **kw)
        want_t = table.clone()
        want_u, want_p = mf_kernel.fused_mf_sgd_plain(want_t, s_items, s_p, s_r, s_m, **kw)
        if twice:
            again_t = table.clone()
            again = mf_kernel.sorted_fused_mf_sgd(again_t, s_items, s_p, s_r, s_m, **kw)
            same_twice(label, [got_t, got_u, got_p], [again_t, *again])
        torch.cuda.synchronize()
        e = _compare(torch, f"{label} item table", got_t, want_t, rtol=1e-5, atol=1e-5)
        e = max(e, _compare(torch, f"{label} user deltas", got_u, want_u, rtol=1e-5, atol=1e-5))
        return max(e, _compare(torch, f"{label} predictions", got_p, want_p, rtol=1e-5, atol=1e-5))

    errs["fused_mf_sgd"] = k2(f"fused_mf_sgd dense f32 ({NUM_ITEMS},{DIM_FUSED})", NUM_ITEMS, DIM_FUSED,
                              twice=True)
    k2(f"fused_mf_sgd packed sub_k=2 f32 ({NUM_ITEMS // 2},128) dim {DIM_UNFUSED}",
       NUM_ITEMS // 2, DIM_UNFUSED, sub_k=2)
    errs.update(_flash_checks(torch, dev, gen))
    return errs


def flash_inputs(torch, dev, gen, B, T, H, D, dtype):
    """q, k, v as the LM hands them to the kernels: q scaled by 1/sqrt(D)
    in float32 and contiguous, k and v strided views of one (B, T, 3, H, D)
    projection; and a random dO."""
    qkv = (torch.randn(B, T, 3, H, D, generator=gen, device=dev) * 0.8).to(dtype)
    q = (qkv[:, :, 0].float() * D**-0.5).to(dtype).contiguous()
    do = torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype)
    return q, qkv[:, :, 1], qkv[:, :, 2], do


def _flash_checks(torch, dev, gen):
    """K3a/b/c vs their plain versions on identical inputs, at the LM's
    shape in bfloat16, at a dp-4, a tp-4 and a tp-2 rank's shares of it in
    float32 (the dense_dp phase's float32 runs), at a longer, wider float32 shape,
    at head_dim 256 in both dtypes (bfloat16 runs the bf16 tensor-core
    kernels, float32 the 3xTF32 ones), at head_dim 320 and 512 in both
    dtypes (the column-split kernels, all three on the tensor cores) and at
    the wider ``SPLIT_WIDE`` (two forward and dQ slices, three dK/dV
    slices; q streamed beside k, and the backward's own rows streamed beside
    each piece); then the route each (dtype, head_dim) takes
    (:func:`_flash_routes`).

    Tolerances.  float32: rtol 1e-5 and atol 1e-5 of the largest value, as
    for K1: both sides sum the same float32 products in another order.
    The 3xTF32 kernels carry each float32 product to about 2**-21 of
    itself, a few units of float32's last place, so they keep that bar.
    bfloat16: the outputs (O, dQ, dK, dV) are rounded to bfloat16 from
    float32 values that differ only in summation order (the forward's P
    split into two bf16 operands carries it to about 2**-16; the dQ kernel
    rounds dS, and the dK/dV kernel P and dS, to bfloat16 as their plain
    versions do), so they may land one bfloat16 unit apart: rtol 2**-7 and
    atol 2**-8 of the largest value (about 2**-8 relative).  L and D stay
    float32 in both, so they keep the float32 bar.  For each bfloat16
    output, scaled_dot_product_attention's own error against the same
    plain version is printed: the bar is no looser than the library's
    error."""
    errs = {}
    shapes = ((LM_B, LM_T, LM_H, LM_D, torch.bfloat16), (LM_B // DDP_WORLD, LM_T, LM_H, LM_D, torch.float32),
              (LM_B, LM_T, LM_H // MP_WORLD, LM_D, torch.float32), (LM_B, LM_T, LM_H // 2, LM_D, torch.float32),
              (2, 1024, 8, 128, torch.float32),
              (2, 1024, 4, 256, torch.bfloat16), (2, 1024, 4, 256, torch.float32)) + tuple(
                  (2, 1024, 2, D, dtype) for D in SPLIT_DS for dtype in (torch.bfloat16, torch.float32)) + tuple(
                  (1, 512, 2, D, getattr(torch, dtype)) for D, dtype in SPLIT_WIDE)
    for B, T, H, D, dtype in shapes:
        found = _k3_against_plain(torch, dev, gen, B, T, H, D, dtype)
        if not errs:  # the LM's shape: the error the kernels line reports
            errs = found
    _flash_routes(torch, dev, gen)
    return errs


def _flash_routes(torch, dev, gen):
    """The kernels each (dtype, head_dim) launches for the forward, dQ and
    dK/dV at (B 1, T 128, H 1), by the names torch.profiler records: a
    ``route:`` line each.  float32 at head_dim 64-256 must take the 3xTF32
    kernels, bfloat16 there the bf16 tensor-core kernels, and every wider
    head the column-split kernels on the tensor cores."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from flink_parameter_server_tpu_torch.ops import flash_attention as fa

    for dtype in (torch.bfloat16, torch.float32):
        for D in FLASH_OWN_DS + SPLIT_DS:
            q, k, v, do = flash_inputs(torch, dev, gen, 1, 128, 1, D, dtype)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                o, lse = fa.flash_fwd(q, k, v)
                _, delta = fa.flash_bwd_dq(q, k, v, o, do, lse)
                fa.flash_bwd_dkv(q, k, v, do, lse, delta)
                torch.cuda.synchronize()
            took = sorted({m.group(1) for ev in prof.key_averages()
                           for m in [re.search(r"fps::(flash_\w+(?:<[^>]*>)?)", ev.key)] if m})
            f32, own = dtype == torch.float32, D in FLASH_OWN_DS
            fwd, bwd = ("tf32_", "tf32_") if f32 else ("mma_", "mma_")
            if not own:
                fwd = bwd = "split_mma_"
            want = {"flash_fwd": f"flash_fwd_{fwd}kernel<", "flash_bwd_dq": f"flash_bwd_dq_{bwd}kernel<",
                    "flash_bwd_dkv": f"flash_bwd_dkv_{bwd}kernel<"}
            label = str(dtype).replace("torch.", "")
            print(f"route: {label} D {D}: {', '.join(took) or 'no kernel names in the trace'}")
            for name, prefix in want.items():
                hits = [t for t in took if t.startswith(name + "_")]
                check(len(hits) == 1 and hits[0].startswith(prefix),
                      f"{label} D {D} {name} took {hits}, not {prefix}...>")


def _k3_against_plain(torch, dev, gen, B, T, H, D, dtype):
    """K3a/b/c and their plain versions on identical inputs of one shape at
    _flash_checks' bars: each kernel's largest error (a mismatch raises);
    for bfloat16, scaled_dot_product_attention's error beside them."""
    from flink_parameter_server_tpu_torch.ops import flash_attention as fa

    q, k, v, do = flash_inputs(torch, dev, gen, B, T, H, D, dtype)
    o, lse = fa.flash_fwd(q, k, v)
    dq, delta = fa.flash_bwd_dq(q, k, v, o, do, lse)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    o_p, lse_p = fa.flash_fwd_plain(q, k, v)
    dq_p, delta_p = fa.flash_bwd_dq_plain(q, k, v, o, do, lse)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta)
    tol = dict(rtol=2**-7, atol=2**-8) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)
    f32 = dict(rtol=1e-5, atol=1e-5)
    label = f"(B {B}, T {T}, H {H}, D {D}) {str(dtype).replace('torch.', '')}"
    found = {
        "flash_fwd": max(_compare(torch, f"flash_fwd O {label}", o, o_p, **tol),
                         _compare(torch, f"flash_fwd L {label}", lse, lse_p, **f32)),
        "flash_bwd_dq": max(_compare(torch, f"flash_bwd_dq dQ {label}", dq, dq_p, **tol),
                            _compare(torch, f"flash_bwd_dq D {label}", delta, delta_p, **f32)),
        "flash_bwd_dkv": max(_compare(torch, f"flash_bwd_dkv dK {label}", dk, dk_p, **tol),
                             _compare(torch, f"flash_bwd_dkv dV {label}", dv, dv_p, **tol)),
    }
    if dtype == torch.bfloat16:
        _sdpa_yardstick(torch, label, q, k, v, do, {"O": o_p, "dQ": dq_p, "dK": dk_p, "dV": dv_p})
    return found


def _sdpa_yardstick(torch, label, q, k, v, do, plain):
    """scaled_dot_product_attention's max error against the plain versions
    on the same bfloat16 inputs (timed nowhere, called nowhere in the port)."""
    import torch.nn.functional as F

    heads = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]  # (B, H, T, D) views
    out = F.scaled_dot_product_attention(*heads, is_causal=True, scale=1.0)
    grads = torch.autograd.grad(out, heads, do.transpose(1, 2))
    lib = {"O": out.detach().transpose(1, 2), "dQ": grads[0].transpose(1, 2), "dK": grads[1].transpose(1, 2),
           "dV": grads[2].transpose(1, 2)}
    errs = ", ".join(f"{n} {float((lib[n].double() - plain[n].double()).abs().max()):.3e}" for n in plain)
    print(f"check: yardstick {label}: scaled_dot_product_attention vs the plain versions: {errs}")


def _small_run_matches_cpu(torch):
    """The main path on a small input, on the card vs the CPU (plain) path."""
    from flink_parameter_server_tpu_torch import ps_online_mf
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import microbatches

    data = synthetic_ratings(64, 96, 6 * 32, seed=3)
    runs = {
        dev: ps_online_mf(microbatches(data, 32), num_users=64, num_items=96, dim=16,
                          scatter_impl="pallas", device=dev)
        for dev in ("cuda", "cpu")
    }
    for what in ("items", "users"):
        a, b = (
            (r.store.values() if what == "items" else r.worker_state).cpu() for r in runs.values()
        )
        err = float((a - b).abs().max())
        print(f"main: small run (64 users, 96 items, dim 16) card vs cpu {what}: "
              f"max_abs_err={err:.3e} (rtol=1e-5 atol=1e-6)")
        check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-6)), f"small run {what} disagree")


def phase_main(torch, dev):
    from flink_parameter_server_tpu_torch import (
        OnlineMatrixFactorization, ShardedParamStore, make_fused_mf_train_step,
        ps_online_mf, ranged_random_factor,
    )
    from flink_parameter_server_tpu_torch.core.transform import to_device
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import microbatches

    _small_run_matches_cpu(torch)
    data = synthetic_ratings(NUM_USERS, NUM_ITEMS, BATCHES_PER_EPOCH * BATCH, seed=0)
    steps = BATCHES_PER_EPOCH * EPOCHS

    def epoch_rmse(errs):
        return [round(statistics.fmean(errs[i:i + BATCHES_PER_EPOCH]), 6)
                for i in range(0, len(errs), BATCHES_PER_EPOCH)]

    errs, stamps = [], []

    def on_step(i, out):
        errs.append(float(out["error"].pow(2).mean().sqrt()))  # synchronises
        stamps.append(time.perf_counter())

    zero_counts()
    result = ps_online_mf(
        microbatches(data, BATCH, epochs=EPOCHS), num_users=NUM_USERS, num_items=NUM_ITEMS,
        dim=DIM_UNFUSED, learning_rate=LEARNING_RATE, scatter_impl="pallas", device=dev,
        on_step=on_step,
    )
    torch.cuda.synchronize()
    launches = {"scatter_add": read_counts("ps_online_mf", {"scatter_add": steps})["scatter_add"]}
    items, users = result.store.values(), result.worker_state
    rate = (steps - BATCHES_PER_EPOCH) * BATCH / (stamps[-1] - stamps[BATCHES_PER_EPOCH - 1])
    curve = epoch_rmse(errs)
    print(f"main: ps_online_mf scatter_impl=pallas dim {DIM_UNFUSED}: {steps} microbatches of {BATCH}, "
          f"training rmse by epoch {curve}, {rate:.0f} updates/s after the first epoch, "
          f"median step {median_step_ms(stamps):.3f} ms")
    check(len(errs) == steps, "ps_online_mf ran the wrong number of steps")
    check(tuple(items.shape) == (NUM_ITEMS, DIM_UNFUSED) and tuple(users.shape) == (NUM_USERS, DIM_UNFUSED),
          "ps_online_mf returned tables of the wrong shape")
    check(bool(torch.isfinite(items).all() and torch.isfinite(users).all()), "non-finite MF tables")
    check(curve[-1] < curve[0], "ps_online_mf training error did not fall")
    unfused_ms = median_step_ms(stamps)

    def drive_unfused(after_step):
        ps_online_mf(
            itertools.islice(microbatches(data, BATCH, epochs=EPOCHS), MF_TRACED + 2), num_users=NUM_USERS,
            num_items=NUM_ITEMS, dim=DIM_UNFUSED, learning_rate=LEARNING_RATE, scatter_impl="pallas",
            device=dev, on_step=lambda i, out: after_step(out),
        )

    store = ShardedParamStore.create(NUM_ITEMS, (DIM_FUSED,), init_fn=ranged_random_factor(1, (DIM_FUSED,)),
                                     device=dev)
    item_t = store.table
    user_t = OnlineMatrixFactorization(NUM_USERS, DIM_FUSED, seed=0, device=dev).init_state()
    step = make_fused_mf_train_step(learning_rate=LEARNING_RATE)
    errs.clear()
    stamps.clear()
    zero_counts()
    for batch in microbatches(data, BATCH, epochs=EPOCHS):
        item_t, user_t, out = step(item_t, user_t, to_device(batch, dev))
        on_step(None, out)
    torch.cuda.synchronize()
    launches["fused_mf_sgd"] = read_counts("the fused step", {"fused_mf_sgd": steps})["fused_mf_sgd"]
    fused_rate = (steps - BATCHES_PER_EPOCH) * BATCH / (stamps[-1] - stamps[BATCHES_PER_EPOCH - 1])
    curve = epoch_rmse(errs)
    print(f"main: make_fused_mf_train_step dim {DIM_FUSED}: {steps} microbatches of {BATCH}, "
          f"training rmse by epoch {curve}, {fused_rate:.0f} updates/s after the first epoch, "
          f"median step {median_step_ms(stamps):.3f} ms")
    check(bool(torch.isfinite(item_t).all() and torch.isfinite(user_t).all()), "non-finite fused tables")
    check(curve[-1] < curve[0], "fused training error did not fall")

    def drive_fused(after_step):
        tables = [item_t, user_t]
        for batch in itertools.islice(microbatches(data, BATCH, epochs=EPOCHS), MF_TRACED + 2):
            tables[0], tables[1], out = step(tables[0], tables[1], to_device(batch, dev))
            after_step(out)

    fused_ms = median_step_ms(stamps)
    launches.update(phase_lm(torch, dev))
    # the new arms' launches join the kernels line's counts
    for name, n in phase_moe_lm(torch, dev).items():
        launches[name] += n
    launches["scatter_add"] += phase_hybrid(torch, dev, card_line())["scatter_add"]
    # after every counted run, so that no counted run follows a profiler
    # session in this process
    _trace_steps("ps_online_mf", drive_unfused, unfused_ms)
    _trace_steps("fused MF", drive_fused, fused_ms)
    return launches


def median_step_ms(stamps) -> float:
    """The counted run's median step after the first epoch, from the
    host's stamps (each taken after a synchronising read of the step)."""
    tail = stamps[BATCHES_PER_EPOCH - 1:]
    return statistics.median((b - a) * 1e3 for a, b in zip(tail, tail[1:]))


def _trace_steps(what, drive, step_ms, steps=MF_TRACED, read=None, rules=MF_FAMILIES):
    """Where a step's time goes, outside the counted run: ``drive`` runs
    ``steps`` + 2 steps, calling its argument after each with the step's
    output; the first two are skipped (set-up, warm-up) and the rest
    recorded by torch.profiler.  Each step ends in the same synchronising
    read as in the counted run (``read``; the MF error by default)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    read = read or (lambda out: float(out["error"].pow(2).mean()))
    found = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=steps, repeat=1),
                 on_trace_ready=lambda p: found.append(p.key_averages())) as prof:
        def after_step(out):
            read(out)
            prof.step()

        drive(after_step)
    if not found:
        print(f"trace: torch.profiler recorded no {what} steps; the step breakdown is not measured")
        return
    _report_trace(found[-1], what, steps, step_ms, rules)


def _report_trace(averages, what, steps, step_ms, rules):
    """Device time a step by kernel family, device busy and idle share
    against ``step_ms`` (the counted run's median step), and the ten device
    kernels and host operators that take the most time."""
    # kernel events only: an operator's row, and a range such as
    # Optimizer.step's, repeat their kernels' time
    kernels = [ev for ev in averages
               if str(ev.device_type).endswith("CUDA") and ev.self_device_time_total > 0
               and not getattr(ev, "is_user_annotation", False) and "#" not in ev.key]
    families = dict.fromkeys([name for name, _ in rules] + ["other"], 0.0)
    for ev in kernels:
        key = ev.key.lower()
        family = next((name for name, marks in rules if any(m in key for m in marks)), "other")
        families[family] += ev.self_device_time_total
    busy = sum(families.values())
    if busy <= 0:
        print(f"trace: torch.profiler showed no device time for {what}; the step breakdown is not measured")
        return
    per_step = busy / 1e3 / steps
    shares = ", ".join(f"{k} {v / 1e3 / steps:.3f} ms ({v / busy:.1%})" for k, v in families.items())
    print(f"trace: {steps} {what} steps, device time a step by family: {shares}; device busy "
          f"{per_step:.3f} ms a step against the counted run's median step {step_ms:.3f} ms "
          f"(idle {1 - per_step / step_ms:.1%})")
    for ev in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"trace:   device {ev.self_device_time_total / 1e3 / steps:9.3f} ms a step  "
              f"{ev.count // steps:4d}x  {ev.key[:90]}")
    host = [ev for ev in averages if not str(ev.device_type).endswith("CUDA")]
    for ev in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"trace:   host {ev.self_cpu_time_total / 1e3 / steps:9.3f} ms a step  "
              f"{ev.count // steps:4d}x  {ev.key[:90]}")


def _small_lm_matches_cpu(torch):
    """A tiny float32 LM (vocab 256, d_model 128, 2 heads, 2 layers, T 128,
    B 4), 3 sgd(0.1) steps from the same weights: on the card with
    flash_attention="on" (the kernels) vs the CPU with "auto" (the reference
    attention).  Tolerance rtol 1e-4 / atol 1e-5: float32 throughout, but
    the card's products, the flash kernels' sums and the CPU's einsum
    attention add in different orders, and three steps carry that on."""
    from flink_parameter_server_tpu_torch import (
        DenseParameterServer, TransformerConfig, init_params, lm_loss, sgd, transform_dense,
    )
    from flink_parameter_server_tpu_torch.interop import transformer_params_to_numpy

    small = dict(vocab_size=256, d_model=128, n_heads=2, n_layers=2, d_ff=256, max_seq=128,
                 dtype=torch.float32)
    runs = {}
    for dev, mode in (("cuda", "on"), ("cpu", "auto")):
        cfg = TransformerConfig(**small, flash_attention=mode)
        model = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
        losses = []
        result = transform_dense(bigram_batches(3, 4, 128, 256, seed=1), lambda m, b, c=cfg: lm_loss(m, b, c),
                                 DenseParameterServer(model, sgd(0.1)),
                                 on_step=lambda i, loss, out=losses: out.append(float(loss)))
        runs[mode] = (np.array(losses), transformer_params_to_numpy(result.server_outputs[0]))
    (card_l, card_p), (cpu_l, cpu_p) = runs["on"], runs["auto"]
    leaves = lambda t: [t["embed"], t["final_norm"]] + [v for layer in t["layers"] for v in layer.values()]  # noqa: E731
    pairs = [(card_l, cpu_l)] + list(zip(leaves(card_p), leaves(cpu_p)))
    err = max(float(np.abs(a - b).max()) for a, b in pairs)
    ok = all(np.allclose(a, b, rtol=1e-4, atol=1e-5) for a, b in pairs)
    print(f"main: small LM (vocab 256, d 128, 2 layers, T 128, B 4, f32, sgd 0.1, 3 steps) card 'on' "
          f"vs cpu 'auto': losses {card_l.round(6).tolist()} vs {cpu_l.round(6).tolist()}, "
          f"max_abs_err over losses and params {err:.3e} (rtol=1e-4 atol=1e-5) {'ok' if ok else 'MISMATCH'}")
    check(ok, "small LM run on the card disagrees with the CPU")


def _wide_lm_matches_off(torch, dev, dtype):
    """A small LM at head_dim 320 (vocab 64, d_model 640, 2 heads, 1 layer,
    T 256, B 2) under flash_attention="auto": one forward and backward must
    launch each flash kernel once (the column-split kernels) and match
    "off" (the reference attention).  Tolerances, those of the card tests:
    float32 loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6; bfloat16 loss
    rtol 1e-2 and each gradient within 2**-4 of its largest magnitude (the
    reference rounds its einsums to bfloat16, the kernels keep float32)."""
    import dataclasses

    from flink_parameter_server_tpu_torch import TransformerConfig, init_params, lm_loss

    cfg = TransformerConfig(vocab_size=64, d_model=640, n_heads=2, n_layers=1, d_ff=128, max_seq=256,
                            dtype=dtype, flash_attention="auto")
    model = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    batch = {"tokens": torch.randint(0, 64, (2, 256), generator=torch.Generator().manual_seed(1)).to(dev)}
    zero_counts()
    loss = lm_loss(model, batch, cfg)
    loss.backward()
    torch.cuda.synchronize()
    name = f"small LM head_dim {cfg.head_dim} {str(dtype).replace('torch.', '')} 'auto'"
    read_counts(name, {n: 1 for n in FLASH})
    got = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    off = lm_loss(model, batch, dataclasses.replace(cfg, flash_attention="off"))
    off.backward()
    pairs = list(zip(got, (p.grad for p in model.parameters())))
    if dtype == torch.float32:
        ok = bool(torch.allclose(loss, off, rtol=1e-5, atol=0)) and all(
            bool(torch.allclose(a, g, rtol=1e-4, atol=1e-6)) for a, g in pairs)
    else:
        ok = bool(torch.allclose(loss.float(), off.float(), rtol=1e-2, atol=0)) and all(
            bool(torch.allclose(a.float(), g.float(), rtol=0, atol=2**-4 * float(g.float().abs().max())))
            for a, g in pairs)
    err = max(float((a.double() - g.double()).abs().max()) for a, g in pairs)
    print(f"main: {name} vs 'off': loss {loss.item():.6f} vs {off.item():.6f}, "
          f"max gradient difference {err:.3e} {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name} disagrees with the reference attention")


def phase_lm(torch, dev):
    """Transformer-base LM training at full width through the dense PS, as
    examples/transformer_lm.py --mode single drives it."""
    from flink_parameter_server_tpu_torch import (
        DenseParameterServer, TransformerConfig, adamw, init_params, lm_loss, transform_dense,
    )

    _small_lm_matches_cpu(torch)
    for dtype in (torch.float32, torch.bfloat16):
        _wide_lm_matches_off(torch, dev, dtype)
    cfg = TransformerConfig(flash_attention="on")  # the defaults are Transformer-base, bfloat16
    check(cfg.head_dim == LM_D and cfg.n_heads == LM_H, "Transformer-base heads changed")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    server = DenseParameterServer(model, adamw(3e-3))
    batches = list(bigram_batches(LM_STEPS + LM_TRACED, LM_B, LM_T, cfg.vocab_size, seed=0))
    loss_fn = lambda m, b: lm_loss(m, b, cfg)  # noqa: E731
    losses, stamps = [], []

    def on_step(i, loss):
        losses.append(float(loss))  # synchronises once a step
        stamps.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    result = transform_dense(batches[:LM_STEPS], loss_fn, server, on_step=on_step)
    torch.cuda.synchronize()
    per_run = cfg.n_layers * LM_STEPS
    counts = read_counts("transform_dense (LM)", {name: per_run for name in FLASH})
    peak = torch.cuda.max_memory_allocated()
    tokens = LM_B * LM_T
    rate = (LM_STEPS - LM_WARMUP) * tokens / (stamps[-1] - stamps[LM_WARMUP - 1])
    steps_ms = [round((b - a) * 1e3, 3) for a, b in zip(stamps[LM_WARMUP - 1:], stamps[LM_WARMUP:])]
    print(f"main: LM Transformer-base ({n_params} params, {str(cfg.dtype).replace('torch.', '')}, "
          f"flash on) {LM_STEPS} steps of "
          f"{LM_B}x{LM_T} tokens, adamw(3e-3): loss by step {[round(x, 4) for x in losses]}")
    print(f"main: LM {rate:.0f} tokens/s after {LM_WARMUP} warm-up steps (one sync a step), "
          f"step ms {steps_ms}, peak memory {peak / 2**30:.2f} GiB")
    check(len(losses) == LM_STEPS and all(np.isfinite(losses)), "LM losses missing or not finite")
    check(statistics.fmean(losses[-5:]) < losses[0], "LM loss did not fall")
    final = result.server_outputs[0]
    check(all(bool(torch.isfinite(p).all()) for p in final.parameters()), "non-finite LM parameters")
    _trace_lm_steps(torch, final, loss_fn, batches[LM_STEPS:], statistics.median(steps_ms))
    return {name: counts[name] for name in FLASH}


MOE_OFF_STEPS = 3  # steps of the flash "off" run held against the counted run's first losses
MOE_OFF_RTOL = 2e-2  # bfloat16: routing is an argmax over gate products that add in another order


def phase_moe_lm(torch, dev):
    """The switch-MoE LM: Transformer-base (bfloat16, ``flash_attention="on"``)
    with ``num_experts=8`` on every layer and capacity 1,280 an expert, 20
    steps of 16 x 512 tokens through ``DenseParameterServer(adamw(3e-3))``.
    The flash kernels launch once a layer a step, the loss falls, and the
    first 3 losses match a ``flash_attention="off"`` run from the same
    weights within rtol 2e-2 (bfloat16 throughout; a token whose top two
    gate probabilities nearly tie may take another expert when the gate
    product adds in another order).  The MoE layers' share of the step is
    their forward and backward timed alone at the step's shapes."""
    import dataclasses

    from flink_parameter_server_tpu_torch import (
        DenseParameterServer, TransformerConfig, adamw, init_params, lm_loss, transform_dense,
    )
    from flink_parameter_server_tpu_torch.models import moe

    cfg = TransformerConfig(flash_attention="on", num_experts=MOE_EXPERTS, moe_capacity=MOE_CAPACITY)
    check(cfg.head_dim == LM_D and cfg.n_heads == LM_H, "Transformer-base heads changed")
    batches = list(bigram_batches(LM_STEPS, LM_B, LM_T, cfg.vocab_size, seed=0))
    runs = {}
    for mode, steps in (("off", MOE_OFF_STEPS), ("on", LM_STEPS)):
        run_cfg = dataclasses.replace(cfg, flash_attention=mode)
        model = init_params(run_cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        losses, stamps = [], []

        def on_step(i, loss, losses=losses, stamps=stamps):
            losses.append(float(loss))  # synchronises once a step
            stamps.append(time.perf_counter())

        zero_counts()
        result = transform_dense(batches[:steps], lambda m, b, c=run_cfg: lm_loss(m, b, c),
                                 DenseParameterServer(model, adamw(3e-3)), on_step=on_step)
        torch.cuda.synchronize()
        per_run = run_cfg.n_layers * steps if mode == "on" else 0
        counts = read_counts(f"transform_dense (MoE LM, flash {mode})", {n: per_run for n in FLASH})
        runs[mode] = (losses, stamps, result.server_outputs[0], counts)
    losses, stamps, final, counts = runs["on"]
    off = runs["off"][0]
    n_params = sum(p.numel() for p in final.parameters())
    tokens = LM_B * LM_T
    rate = (LM_STEPS - LM_WARMUP) * tokens / (stamps[-1] - stamps[LM_WARMUP - 1])
    steps_ms = [round((b - a) * 1e3, 3) for a, b in zip(stamps[LM_WARMUP - 1:], stamps[LM_WARMUP:])]
    step_ms = statistics.median(steps_ms)
    first = np.array(losses[:MOE_OFF_STEPS])
    agree = bool(np.allclose(first, off, rtol=MOE_OFF_RTOL, atol=0))
    print(f"main: MoE LM Transformer-base, {MOE_EXPERTS} experts a layer, capacity {MOE_CAPACITY} ({n_params} "
          f"params, bf16, flash on) {LM_STEPS} steps of {LM_B}x{LM_T} tokens, adamw(3e-3): loss by step "
          f"{[round(x, 4) for x in losses]}")
    print(f"main: MoE LM first {MOE_OFF_STEPS} losses flash on {first.round(5).tolist()} vs off "
          f"{np.round(off, 5).tolist()}: max rel diff {float(np.max(np.abs(first - off) / np.abs(off))):.3e} "
          f"(rtol={MOE_OFF_RTOL}) {'ok' if agree else 'MISMATCH'}")
    check(len(losses) == LM_STEPS and all(np.isfinite(losses)), "MoE LM losses missing or not finite")
    check(statistics.fmean(losses[-5:]) < losses[0], "MoE LM loss did not fall")
    check(agree, "MoE LM flash on disagrees with flash off")
    check(all(bool(torch.isfinite(p).all()) for p in final.parameters()), "non-finite MoE LM parameters")

    # the MoE layers alone: forward and backward of each layer's moe_dense
    # at the step's shapes (B*T tokens of d_model, bfloat16), CUDA events
    mcfg = moe.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff, num_experts=MOE_EXPERTS, capacity=MOE_CAPACITY,
                         dtype=cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn(tokens, cfg.d_model, generator=gen, device=dev).to(cfg.dtype).requires_grad_()
    g = torch.randn(tokens, cfg.d_model, generator=gen, device=dev).to(cfg.dtype)
    layers = [{k: v.detach().requires_grad_() for k, v in layer.moe.items()} for layer in final.layers]

    def moe_layers():
        for prm in layers:
            torch.autograd.backward(moe.moe_dense(prm, h, mcfg), g)

    moe_layers()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        moe_layers()
    end.record()
    torch.cuda.synchronize()
    moe_ms = start.elapsed_time(end) / 5
    dropped = sum(int((~moe._route(h.detach(), prm["w_gate"], MOE_EXPERTS, MOE_CAPACITY)[2]).sum()) for prm in layers)
    print(f"main: MoE LM {rate:.0f} tokens/s after {LM_WARMUP} warm-up steps (one sync a step), step ms "
          f"{steps_ms}; the {cfg.n_layers} MoE layers' forward and backward alone {moe_ms:.3f} ms, "
          f"{moe_ms / step_ms:.1%} of the median step {step_ms:.3f} ms; {dropped} of {cfg.n_layers * tokens} "
          f"token-layers over capacity on random inputs")
    return {name: counts[name] for name in FLASH}


# ratings a chunk, two chunks: cut from 65,536, at which the per-record
# Python callbacks took 190 and 100 s a chunk on the card
HYBRID_CHUNK = 1_024  # the callbacks run ~180 records/s on the card: two chunks take ~11 s
HYBRID_TOL = dict(rtol=1e-5, atol=1e-6)  # K1's ordered run sums against index_add_'s atomics; atol for sums near 0
HYBRID_PREFIX = 256  # ratings of the chunk_size=1 run held against the event backend


def phase_hybrid(torch, dev, card):
    """The hybrid backend: the event API's ``MFWorkerLogic`` (dim 64, its
    per-record callbacks in Python, user vectors on the card) under
    ``transform_hybrid`` against a ``scatter_impl="pallas"`` store at the MF
    path's item table (131,072 x 64), two chunks of 1,024 ratings (cut
    from 65,536, where the callbacks took 100-190 s a chunk, then from
    16,384, where they took 65-75 s, from 8,192, where the arm took
    74 s, and from 4,096, where it took 45.5 s, to pay for the parallel
    phase): K1 once a
    chunk and no other kernel, and the table within rtol 1e-5 / atol 1e-6
    of the same chunks' pushes folded into the initial table with
    ``index_add_`` on the card.  Then ``chunk_size=1`` over the first 256 ratings against the
    event backend (``transform`` with a keyed store) on the card, within
    atol 1e-5 (the reference's bar)."""
    from flink_parameter_server_tpu_torch import MFWorkerLogic, SGDUpdater, SimplePSLogic, transform, transform_hybrid
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    cols = synthetic_ratings(NUM_USERS, NUM_ITEMS, 2 * HYBRID_CHUNK, seed=0)
    records = list(zip(cols["user"].tolist(), cols["item"].tolist(), cols["rating"].tolist()))
    init = ranged_random_factor(1, (DIM_UNFUSED,))
    store = ShardedParamStore.create(NUM_ITEMS, (DIM_UNFUSED,), init_fn=init, scatter_impl="pallas", device=dev)
    table0 = store.table.clone()
    pushed, chunk_s = [], []
    push = ShardedParamStore.push

    def recorded_push(self, ids, deltas, mask=None):
        pushed.append((ids.clone(), deltas.clone()))
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter())
        return push(self, ids, deltas, mask)

    worker = MFWorkerLogic(DIM_UNFUSED, SGDUpdater(LEARNING_RATE), seed=0, device=dev)
    ShardedParamStore.push = recorded_push
    try:
        zero_counts()
        t0 = time.perf_counter()
        result = transform_hybrid(records, worker, store, chunk_size=HYBRID_CHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ShardedParamStore.push = push
    counts = read_counts("transform_hybrid (event MF, pallas store)", {"scatter_add": 2})
    got = result.store.values()
    oracle = table0
    for ids, deltas in pushed:
        oracle = oracle.index_add(0, ids, deltas)
    err = float((got - oracle).abs().max())
    ok = bool(torch.allclose(got, oracle, **HYBRID_TOL))
    callbacks = [b - a for a, b in zip([t0] + chunk_s, chunk_s)]
    print(f"main: transform_hybrid MFWorkerLogic dim {DIM_UNFUSED} on a ({NUM_ITEMS},{DIM_UNFUSED}) pallas store, "
          f"{len(records)} ratings in chunks of {HYBRID_CHUNK}: {wall:.2f} s ({len(records) / wall:.0f} records/s; "
          f"callbacks and pulls before each push {[round(c, 2) for c in callbacks]} s), K1 {counts['scatter_add']} "
          f"launches; table against index_add_ of the same pushes max_abs_err={err:.3e} (rtol=1e-5 atol=1e-6) "
          f"{'ok' if ok else 'MISMATCH'}; {card}")
    check(len(result.worker_outputs) == len(records), "transform_hybrid lost worker outputs")
    check(bool(torch.isfinite(got).all()) and ok, "transform_hybrid's table is off its index_add_ oracle")

    prefix = records[:HYBRID_PREFIX]
    touched = sorted({i for _u, i, _r in prefix})
    hy = transform_hybrid(prefix, MFWorkerLogic(DIM_UNFUSED, SGDUpdater(LEARNING_RATE), seed=0, device=dev),
                          ShardedParamStore.create(NUM_ITEMS, (DIM_UNFUSED,), init_fn=init, scatter_impl="pallas",
                                                   device=dev), chunk_size=1)
    ev = transform(prefix, MFWorkerLogic(DIM_UNFUSED, SGDUpdater(LEARNING_RATE), seed=0, device=dev),
                   SimplePSLogic(init=lambda i: init(torch.tensor([i], device=dev))[0], update=lambda c, dl: c + dl))
    ev_rows = {i: v for i, v in ev.server_outputs}
    got = hy.store.values()[torch.tensor(touched, device=dev)]
    want = torch.stack([ev_rows[i] for i in touched])
    err = float((got - want).abs().max())
    print(f"main: transform_hybrid chunk_size=1 over {HYBRID_PREFIX} ratings against the event backend on the card: "
          f"{len(touched)} rows, max_abs_err={err:.3e} (atol=1e-5); {card}")
    check(bool(torch.allclose(got, want, rtol=0, atol=1e-5)), "transform_hybrid chunk_size=1 != the event backend")
    return {"scatter_add": counts["scatter_add"]}


def _trace_lm_steps(torch, model, loss_fn, batches, step_ms):
    """Where an LM step's time goes, outside the counted run.  First the
    steps with no synchronisation between them (the host may run ahead of
    the card), on the host clock; then the same steps under torch.profiler:
    device time by kernel family (the flash kernels, the matrix products,
    the rest), the device's idle share against ``step_ms`` (the counted
    run's median step), and the host operators that take the most time."""
    from torch.profiler import ProfilerActivity, profile

    from flink_parameter_server_tpu_torch import adamw, make_dense_train_step
    from flink_parameter_server_tpu_torch.core.transform import to_device

    step = make_dense_train_step(loss_fn)
    opt = adamw(3e-3)(model.parameters())
    dev = next(model.parameters()).device

    def run():
        for batch in batches:
            step(model, opt, to_device(batch, dev))
        torch.cuda.synchronize()

    run()  # warm: the optimizer's state
    t0 = time.perf_counter()
    run()
    free_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    print(f"trace: with no synchronisation between LM steps a step takes {free_ms:.3f} ms on the host clock")
    _report_trace(prof.key_averages(), "LM", len(batches), step_ms, LM_FAMILIES)


def phase_timing(torch, dev, gen, launches, errs):
    """Median kernel times at the main path's shapes, beside the bound."""
    from flink_parameter_server_tpu_torch.ops import mf_kernel, scatter_kernel

    rng = np.random.default_rng(0)
    items, users, ratings = zipf_batch(rng)
    ids = torch.from_numpy(items).to(dev)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MiB > the 50 MB L2
    n = BATCH
    rows = []

    # K1: the unfused push, dense float32 dim 64
    d = DIM_UNFUSED
    table = torch.randn(NUM_ITEMS, d, generator=gen, device=dev) * 0.1
    deltas = torch.randn(n, d, generator=gen, device=dev) * 0.01
    s_ids, s_d = scatter_kernel.sort_lanes(ids, deltas, None, NUM_ITEMS, torch.float32)
    unique = int(torch.unique_consecutive(s_ids).numel())
    k_ms = gpu_ms(torch, lambda: scatter_kernel.sorted_scatter_add(table, s_ids, s_d), flush)
    p_ms = gpu_ms(torch, lambda: scatter_kernel.run_sum_write_plain(table, s_ids, s_d), flush)
    l_ms = gpu_ms(torch, lambda: table.index_add_(0, ids, deltas), flush)
    nbytes = n * d * 4 + n * 4 + 2 * unique * d * 4
    ops = n * d + unique * d
    rows.append(_row("scatter_add", "flink_parameter_server_tpu_torch/csrc/scatter_add.cu",
                     "flink_parameter_server_tpu/ops/pallas_scatter.py:73", launches, errs,
                     k_ms, p_ms, l_ms, nbytes, ops / F32_OPS_PER_S,
                     f"({NUM_ITEMS},{d}) f32, {BATCH} lanes, {unique} unique rows"))

    # K2: the fused step, dense float32 dim 128
    d = DIM_FUSED
    table = torch.randn(NUM_ITEMS, d, generator=gen, device=dev) * 0.1
    user_table = torch.randn(NUM_USERS, d, generator=gen, device=dev) * 0.1
    _, s_items, _, s_r, s_m, s_p = mf_kernel.sort_lanes(
        NUM_ITEMS, user_table, torch.from_numpy(users).to(dev), ids,
        torch.from_numpy(ratings).to(dev), None,
    )
    unique = int(torch.unique_consecutive(s_items).numel())
    kw = dict(learning_rate=LEARNING_RATE, regularization=0.0)
    k_ms = gpu_ms(torch, lambda: mf_kernel.sorted_fused_mf_sgd(table, s_items, s_p, s_r, s_m, **kw), flush)
    p_ms = gpu_ms(torch, lambda: mf_kernel.fused_mf_sgd_plain(table, s_items, s_p, s_r, s_m, **kw), flush)
    nbytes = 2 * n * d * 4 + 4 * n * 4 + 2 * unique * d * 4  # p in, udelta out; ids r m pred; rows
    ops = n * (9 * d + 4) + unique * d
    rows.append(_row("fused_mf_sgd", "flink_parameter_server_tpu_torch/csrc/fused_mf.cu",
                     "flink_parameter_server_tpu/ops/pallas_mf.py:65", launches, errs,
                     k_ms, p_ms, None, nbytes, ops / F32_OPS_PER_S,
                     f"({NUM_ITEMS},{d}) f32, {BATCH} lanes, {unique} unique rows"))
    rows += _flash_timing(torch, dev, gen, flush, launches, errs)
    return rows


def _flash_timing(torch, dev, gen, flush, launches, errs):
    """K3a/b/c at the LM's shape (bfloat16).  Bound: the larger of the
    bytes (each input read once, each output written once) over 3.35 TB/s
    and the products over the (query, key) pairs the causal mask keeps
    over the bfloat16 tensor-core peak.  Library: scaled_dot_product_attention,
    forward for K3a and its backward (dQ, dK and dV together) for K3b and
    K3c; it is timed here only and the port never calls it."""
    from flink_parameter_server_tpu_torch.ops import flash_attention as fa

    B, T, H, D = LM_B, LM_T, LM_H, LM_D
    q, k, v, do = flash_inputs(torch, dev, gen, B, T, H, D, torch.bfloat16)
    o, lse = fa.flash_fwd(q, k, v)
    dq, delta = fa.flash_bwd_dq(q, k, v, o, do, lse)
    sdpa = _sdpa_ms(torch, q, k, v, do, flush)
    work = _flash_work(B, T, H, D, q.element_size())
    cases = [
        ("flash_fwd", lambda: fa.flash_fwd(q, k, v), lambda: fa.flash_fwd_plain(q, k, v), sdpa["fwd"],
         ":1137 forward"),
        ("flash_bwd_dq", lambda: fa.flash_bwd_dq(q, k, v, o, do, lse),
         lambda: fa.flash_bwd_dq_plain(q, k, v, o, do, lse), sdpa["bwd"], ":1635 dQ"),
        ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta),
         lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta), sdpa["bwd"], ":2196 dK/dV"),
    ]
    rows = []
    for name, kernel, plain, l_ms, splash in cases:
        nbytes, flops = work[name]
        k_ms = gpu_ms(torch, kernel, flush)
        p_ms = gpu_ms(torch, plain, flush, reps=5)
        rows.append(_row(
            name, "flink_parameter_server_tpu_torch/csrc/flash_attn.cu",
            f"flink_parameter_server_tpu/ops/flash_attention.py:117 (splash_attention_kernel.py{splash})",
            launches, errs, k_ms, p_ms, l_ms, nbytes, flops / BF16_OPS_PER_S,
            f"(B {B}, T {T}, H {H}, D {D}) bf16, {flops} flops in causal pairs, "
            f"{launches[name] // LM_STEPS} launches a step", FWD_ROUTES if name == "flash_fwd" else TENSOR_CORES))
    dq_ms, dkv_ms = rows[1]["ms"], rows[2]["ms"]
    print(f"timing: the backward, K3b + K3c {dq_ms:.4f} + {dkv_ms:.4f} = {dq_ms + dkv_ms:.4f} ms "
          f"against scaled_dot_product_attention's whole backward (dQ, dK, dV) {sdpa['bwd']:.4f} ms "
          f"({(dq_ms + dkv_ms) / sdpa['bwd']:.2f}x)")
    _split_timing(torch, dev, gen, flush)
    _f32_rank_timing(torch, dev, gen, flush)
    return rows


def _flash_bound(nbytes, flops, dtype):
    """``(bound ms, "bytes" or "operations", CUDA-core ms)`` of one flash
    kernel's work: the bytes (each input read once, each output written
    once) over 3.35 TB/s, or the causal pairs' products over the fastest
    rate for the dtype: bfloat16 on its tensor cores, float32 as 3xTF32
    (three TF32 products each) on the TF32 tensor cores.  The third value
    is the products over the CUDA cores' float32 peak, the bound that
    float32 took while its kernels ran on the CUDA cores."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (flops / BF16_OPS_PER_S if dtype == "bf16" else 3 * flops / TF32_OPS_PER_S) * 1e3
    bound, by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    return bound, by, flops / F32_OPS_PER_S * 1e3


def _flash_work(B, T, H, D, elem_bytes):
    """Bytes and flops of K3a, K3b and K3c at (B, T, H, D): the three
    kernels' inputs and outputs, and 2, 3 and 4 products over the T (T +
    1) / 2 (query, key) pairs the causal mask keeps in each head, 2 D flops
    a pair."""
    elems, stat = B * T * H * D * elem_bytes, B * H * T * 4
    product = B * H * T * (T + 1) // 2 * 2 * D
    return {"flash_fwd": (4 * elems + stat, 2 * product),
            "flash_bwd_dq": (6 * elems + 2 * stat, 3 * product),
            "flash_bwd_dkv": (6 * elems + 2 * stat, 4 * product)}


def _sdpa_ms(torch, q, k, v, do, flush):
    """scaled_dot_product_attention's causal forward and whole backward
    (dQ, dK, dV) on the same inputs, timed here only: the port never
    calls it."""
    import torch.nn.functional as F

    heads = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]  # (B, H, T, D) views
    out = F.scaled_dot_product_attention(*heads, is_causal=True, scale=1.0)
    return {"fwd": gpu_ms(torch, lambda: F.scaled_dot_product_attention(
        *(t.detach() for t in heads), is_causal=True, scale=1.0), flush),
        "bwd": gpu_ms(torch, lambda: torch.autograd.grad(out, heads, do.transpose(1, 2), retain_graph=True),
                      flush)}


def _flash_kernel_times(torch, dev, gen, flush, B, T, H, D, dtype, who):
    """The three kernels at one shape: each one's median time beside its
    bound, the share of the bound it reaches (never past 100 %), its
    plain version's time, and SDPA's forward or whole backward in the same
    dtype."""
    from flink_parameter_server_tpu_torch.ops import flash_attention as fa

    q, k, v, do = flash_inputs(torch, dev, gen, B, T, H, D, dtype)
    o, lse = fa.flash_fwd(q, k, v)
    _, delta = fa.flash_bwd_dq(q, k, v, o, do, lse)
    sdpa = _sdpa_ms(torch, q, k, v, do, flush)
    short = "f32" if dtype == torch.float32 else "bf16"
    own = D in FLASH_OWN_DS
    fns = {"flash_fwd": (lambda: fa.flash_fwd(q, k, v), lambda: fa.flash_fwd_plain(q, k, v)),
           "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, o, do, lse),
                            lambda: fa.flash_bwd_dq_plain(q, k, v, o, do, lse)),
           "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta),
                             lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta))}
    times = {}
    for name, (nbytes, flops) in _flash_work(B, T, H, D, q.element_size()).items():
        design = (TENSOR_CORES if short == "bf16" else TF32) if own else SPLIT_TC.format(
            "bf16 mma.sync" if short == "bf16" else "3xTF32 mma.sync")
        kernel, plain = fns[name]
        k_ms = times[name] = gpu_ms(torch, kernel, flush)
        p_ms = gpu_ms(torch, plain, flush, reps=5)
        bound, by, cuda_cores = _flash_bound(nbytes, flops, short)
        lib = "forward" if name == "flash_fwd" else "whole backward"
        print(f"timing: {name} (B {B}, T {T}, H {H}, D {D}) {short}, {design}, {who}: kernel {k_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({by}, {nbytes} B, {flops} flops in causal pairs; {bound / k_ms:.1%} of it "
              f"reached; over the CUDA cores' float32 peak {cuda_cores:.4f} ms), plain {p_ms:.4f} ms, "
              f"scaled_dot_product_attention {short} {lib} {sdpa['fwd' if name == 'flash_fwd' else 'bwd']:.4f} ms")
        check(k_ms >= bound, f"{name} at (B {B}, T {T}, H {H}, D {D}) {short} ran past its bound")
    if short == "f32" or not own:
        what = "the float32 forward" if own else f"the column-split forward in {short}"
        print(f"timing: {what} at (B {B}, T {T}, H {H}, D {D}), {who}: K3a {times['flash_fwd']:.4f} ms "
              f"against scaled_dot_product_attention's {short} forward {sdpa['fwd']:.4f} ms "
              f"({times['flash_fwd'] / sdpa['fwd']:.2f}x)")
        pair = times["flash_bwd_dq"] + times["flash_bwd_dkv"]
        what = "the float32 backward" if own else f"the column-split backward in {short}"
        print(f"timing: {what} at (B {B}, T {T}, H {H}, D {D}), {who}: K3b + K3c "
              f"{times['flash_bwd_dq']:.4f} + {times['flash_bwd_dkv']:.4f} = {pair:.4f} ms against "
              f"scaled_dot_product_attention's whole {short} backward {sdpa['bwd']:.4f} ms "
              f"({pair / sdpa['bwd']:.2f}x)")


def _f32_rank_timing(torch, dev, gen, flush):
    """The float32 instances (the 3xTF32 forward and backward) at
    the shapes the gloo ranks of phase_parallel_dense give them (a dp-4
    rank's (4, 512, 8, 64), a tp-4 rank's (16, 512, 2, 64)), and at a dp-4
    rank's width in heads of 128 and 256 ((4, 512, 4, 128), (4, 512, 2,
    256)), in PERF.md's table's terms."""
    for B, H, D, who in ((LM_B // DDP_WORLD, LM_H, LM_D, "a dp-4 rank's share of the LM"),
                         (LM_B, LM_H // MP_WORLD, LM_D, "a tp-4 rank's share of the LM"),
                         (LM_B // DDP_WORLD, LM_H // 2, 2 * LM_D, "a dp-4 share's width at head_dim 128"),
                         (LM_B // DDP_WORLD, LM_H // 4, 4 * LM_D, "a dp-4 share's width at head_dim 256")):
        _flash_kernel_times(torch, dev, gen, flush, B, LM_T, H, D, torch.float32, who)


def _split_timing(torch, dev, gen, flush):
    """The column-split kernels (head widths past 256) at B 2, T 1024, H 2
    in both dtypes, beside the kernels at head_dim 256 (their own
    templates) for scale: each kernel's time, bound and SDPA's forward or
    whole backward, and the forward against SDPA's in one line."""
    for dtype in (torch.bfloat16, torch.float32):
        for D in (256,) + SPLIT_DS:
            _flash_kernel_times(torch, dev, gen, flush, 2, 1024, 2, D, dtype, "B 2, T 1024, H 2")


def _row(name, source, replaces, launches, errs, k_ms, p_ms, l_ms, nbytes, ops_s, detail, design=SIMT):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_s * 1e3
    bound_ms, bound_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    lib = "n/a" if l_ms is None else f"{l_ms:.4f} ms"
    print(f"timing: {name} {detail}, {design}: kernel {k_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes} B), plain {p_ms:.4f} ms, library {lib}")
    return {
        "name": name, "route": "cuda", "design": design, "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": l_ms,
    }


def main() -> int:
    if sys.argv[1:2] == ["--parallel-rank"]:
        return parallel_rank(sys.argv[2:])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import flink_parameter_server_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase: {name} {time.perf_counter() - t:.1f} s")
        return out

    try:
        phase("build", phase_build)
        errs = phase("kernels", phase_kernels, torch, dev, gen)
        phase("determinism", phase_determinism, torch, dev)
        card = card_line()
        phase("driver", phase_driver, torch, dev, card)
        phase("serving", phase_serving, torch, dev, card)
        wl_rows, wl_traces = phase("workloads", phase_workloads, torch, dev, card)
        phase("cluster", phase_cluster, torch, dev, card)
        phase("shmem", phase_shmem, torch, dev, card)
        phase("elastic", phase_elastic, torch, dev, card)
        phase("replication", phase_replication, torch, dev, card)
        phase("telemetry", phase_telemetry, torch, dev, card)
        phase("hotcache", phase_hotcache, torch, dev, card)
        phase("adaptive", phase_adaptive, torch, dev, card)
        phase("tierstore", phase_tierstore, torch, dev, card)
        phase("nemesis", phase_nemesis, torch, dev, card)
        loadgen_k1 = phase("loadgen", phase_loadgen, torch, dev, card)
        parallel, dense_dp = phase("parallel and dense_dp", phase_parallel_dense, torch, dev, card)
        launches = phase("main (MF, LM, MoE LM, hybrid, MF traces)", phase_main, torch, dev)
        launches["scatter_add"] += loadgen_k1  # the source-fed runs are the main path's MF too
        for name, n in parallel.items():  # the sharded arms' ranks run the main path's MF too
            launches[name] += n
        for name, n in dense_dp.items():  # the dp ranks run the main path's LM too
            launches[name] += n
        rows = phase("timing", phase_timing, torch, dev, gen, launches, errs) + wl_rows

        def traces():
            for trace in wl_traces:  # after every counted run, as the MF traces are
                trace()

        phase("workload traces", traces)
        phase("driver trace", phase_driver_trace, torch, dev)
    except (SmokeFailure, RuntimeError, ValueError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
