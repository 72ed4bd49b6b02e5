#!/usr/bin/env python3
"""Smoke run of the raft_tpu_torch port on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero and prints
no result line):

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every kernel under ``raft_tpu_torch/csrc`` with ``nvcc``, one
   process per source, all started together;
3. kernel vs plain: B1 (``fused_knn``), B2 (``fused_cells_knn``), B3
   (``fused_batch_knn``) and B4 (``pq_fused_scan``) against their plain
   PyTorch versions on the card, on integer-valued data (ids and distances
   must be identical) and Gaussian data (distances within a stated
   tolerance), B1 also on its split-database path (m = 1 and 129 against
   200,000 rows, {0, 1} data with ties across the slices), at each
   queries-per-CTA boundary of k, n < 128 and d in {33, 96, 1024}; B2
   at cells of 8, 64 and 65 rows, k on each selection path (1, 10, 16,
   17, 256), cap off the 128-slot tile and on operands off 16-byte
   alignment; B3 on both of its paths (the tensor-core scan, B2's scan),
   with every row and with live rows; B5 (``stream_extract``) against its
   plain version on Gaussian keys, integer keys with ties, sorted rows, a
   constant batch, +-inf-heavy rows, NaN rows, a batch of 13 x 100,000
   keys, 9 and 33 keys tied at the threshold (its survivor list and its
   eight passes) and signed zeros, each also one float into its storage
   (its 4-byte loads), candidate arrays bit for bit (the sign of a zero
   included), and ``select_k(kStream)`` on those
   keys in f32, bf16 and f16, both polarities, against the plain path on
   the CPU and ``kTopK`` on the card (values and ids bit for bit);
4. the main path, with every launch counter set to 0 just before it and
   read just after: brute-force kNN of 10,000 queries against 1,000,000 x
   128 clustered rows (k=10, through B1), IVF-Flat build with 1024 lists
   (k-means assignments through B1) and IVF-Flat search with 32 probes
   (through B2) at recall@10 >= 0.995 against the brute-force result;
5. timings at the main-path shapes: each kernel, its plain version, and a
   library yardstick (``torch`` matmul + ``torch.topk``, which the port
   never calls), beside the kernel's bound on an H100 SXM; B1 is also held
   against its plain version at every k=1 assignment shape of the build
   (trainset x 32 and x 1024 centers on both tiers, rows x 1024 in f32)
   and timed there beside ``addmm`` + ``argmin``; B2 at k=10 and k=1 with
   its plan, its pre-pass's device-time share and its share of the
   search;
6. the IVF-PQ path on the same rows and queries, the counters again set to
   0 before it and read after each step: build with 1024 lists (pq_dim 64,
   pq_bits 8), the compressed search with 32 probes (through B4, recall@10
   >= 0.80 against brute force), the LUT-scan engine and the recon tier
   (``reconstructed()`` then ``engine="bucketed"``, ``bucket_cap=256``,
   through B3) on the first 1000 queries, each within 0.01 of the
   compressed tier's recall there, and the decode scan (B3), whose ids
   must equal the recon tier's (both searches also timed, median of 5);
   then B3 and B4 held against their plain versions and timed at those
   shapes, each with its launch plan, the device-time share of its
   pre-pass and ptxas' registers and spills; B3 with the buckets' live
   rows, at k=10 and k=1, beside its bound on the live rows and the old
   bound on every bucket slot and slab, also at one decode-scan launch
   (the first block of lists); its library yardstick, a bf16 ``baddbmm``
   + ``torch.topk``, runs over the live rows (lists sorted by them, each
   chunk cut to its most live rows) and over every slot;
7. the select path, counters set to 0 before it and read after:
   ``select_k`` through ``kAuto`` on Gaussian keys made on the card at
   bench.py's shapes (64 x 131,072, k=128; 1000 x 10,000, k=10) and at the
   gate's corners (8 x 65,536, k=64; 1024 x 262,144, k=256): one B5 launch
   per gated call and none at k=10, results equal to ``kTopK``'s; at each
   gated shape B5's candidates bit for bit against its plain version, and
   no row flagged by kStream's audit; then B5 alone (CUDA events, device
   time, and the wrapper's host time a call over 200 calls enqueued
   without a synchronise), the whole kStream select, ``kTopK``'s stable
   sort and ``torch.topk`` (the library yardstick) timed beside B5's
   bound;
8. the serve phase (``raft_tpu_torch.serve``) on phase 4's IVF-Flat and
   phase 6's IVF-PQ indexes and a brute-force ``Searcher`` over the same
   rows, before anything mutates them, counters set to 0 before it and
   read after each drive: ``warmup`` over ``BucketGrid.pow2(512, k_grid=(10,
   100))`` with the ladder (1.0, 0.5, 0.25), twice (the second counts no
   kernel build or load); bench/serve.py's stream (2000 requests of 1-32
   rows, k in {10, 100}, seed 5; queries = rows + N(0, 1)) served one
   ``search`` per request, then by a closed-loop ``BatchScheduler``
   (``max_batch=512``, ``max_wait=0``) under a ``CompileCounter`` that
   must read 0; brute-force and IVF-Flat served ids equal to the
   per-request ids but at near-ties within ``norm_tol`` (counted), IVF-PQ
   recall@10 of both drives within 0.01 of phase 6's, IVF-Flat served
   recall@10 >= 0.995 against the brute-force answers, the batched IVF
   drives launching B2 and B4; in each closed-loop drive, the first full
   batch of each k (brute force: 512 rows over the 1M rows) keeps the
   operands and the answer B1, B2 or B4 gave it, held against the plain
   version on those operands (per-slot recall@k >= 0.999, distances
   within ``norm_tol``); QPS of both drives, the closed loop's p50 / p99
   (queueing: every request is submitted at once), padded waste, and the
   hit rate and per-request p50 / p99 latency of a 30%-repeat open-loop
   stream;
9. the lifecycle path on the 1M indexes of phases 4 and 6, after their
   timings, counters set to 0 before it and read after each step:
   multi-part ``knn`` over 4 parts of 250,000 rows (ids and distances equal
   to phase 4's), ``delete`` of 100,000 seeded ids from both indexes (no
   deleted id returned; IVF-Flat recall@10 >= 0.995 against brute force
   over the survivors; IVF-PQ recall within 0.01 of phase 6's), ``compact``
   (search ids identical to the tombstoned search's), ``compact`` with
   ``shrink_capacity`` (capacity before and after), and an ``upsert`` of
   1000 rows (exactly one epoch bump), with the delete, compact and search
   times;
10. mutations under serving, counters set to 0 before and read after: a
    ``Searcher`` over the compacted IVF-Flat index of phase 9 with a
    cached ``BatchScheduler``; ``Searcher.delete`` of 100,000 more seeded
    live ids (one epoch bump, the cache emptied, no deleted id returned),
    then ``Compactor(searcher).run_once(force=True)`` (ids identical to the
    tombstoned search's), with the delete ms and compact s;
11. the full entry-point surface, counters set to 0 before it and read
    after each step: (a) persistence: ``lifecycle.delete`` of 10,000 more
    seeded live ids from the IVF-Flat index phase 10 leaves and the IVF-PQ
    index phase 9 leaves (so the ``deleted`` key is written), ``save`` of
    each into a temporary directory (its free space checked first),
    ``load`` onto the card, 10,000 queries at 32 probes through both (ids
    and distances bit for bit, B2 / B4 launched on both, no deleted id
    returned), a second ``save`` of the loaded index holding the same
    arrays, with the file bytes, save s, load s and search ms; (b) int64
    ids: ``brute_force.knn`` over phase 9's 4 parts with
    ``idx_dtype=torch.int64`` and ``global_id_offset=2**32`` (ids = phase
    4's + 2^32, distances equal), IVF-Flat and IVF-PQ built with int64 ids
    and no rows, extended with ids ``2**33 + arange(1M)`` (recall@10
    against brute force: IVF-Flat >= 0.995, IVF-PQ within 0.01 of phase
    6's), a widened copy of phase 4's IVF-Flat index from
    ``index_from_numpy`` (ids = the index's own + 2^33, bit for bit), an
    ``upsert`` of 1000 rows and a ``compact`` keeping int64 ids past 2^33,
    and 200 of bench/serve.py's requests through a ``Searcher`` over it
    (ids = the per-call search's); (c) metrics at full width:
    ``brute_force.knn`` with cosine, correlation, l1, linf and canberra, 1000
    queries against the 1M rows, k=10, timed, and held on 100 of them
    against a float64 search (recall@10 >= 0.999 with near-ties within
    the tolerance counted as hits, distances within the tolerance), then
    ``pairwise_distance`` for all 20 metrics at 1000 x 1000 against float64
    numpy on the host;
12. sharding (``raft_tpu_torch.parallel``), counters set to 0 before
    each step and read after it: (a) a NCCL world of one in this process:
    ``sharded_knn`` and ``sharded_ivf_flat_search`` over an index built
    with phase 4's centers, distances bit for bit with phase 4's and ids
    too but for the order of exact ties; (b) a gloo world of 4 ranks on
    the one card (``torch.multiprocessing`` spawn, every shard on
    ``cuda:0``, the kernels built here first): ``sharded_knn`` on every
    merge engine (ids = phase 4's but at near-ties within ``norm_tol``),
    row-placed IVF-Flat on phase 4's centers (likewise against phase 4's
    search) and with ``train_distributed`` (1024 lists, 20 iterations:
    recall@10 >= 0.99 against brute force at 32 probes), and degraded
    serving with rank 3 dead (brute force and IVF-Flat equal to a 3-rank
    search over the survivors, bit for bit; coverage 0.75 for brute force
    and the recomputed live share of the probed rows for IVF-Flat); every
    rank's answers identical; the ranks' launches and wall times;
13. sharding, part 2 (the list placement and sharded IVF-PQ), counters
    set to 0 before each step and read after it: (a) in a NCCL world of
    one, ``sharded_ivf_pq_build`` on both placements over phase 6's
    model, whose searches give phase 6's compressed-tier answers, and the
    list-placed IVF-Flat on phase 4's centers giving phase 4's (distances
    bit for bit, ids too but for the order of exact ties); (b) in phase
    12's world of 4 ranks: the list-placed IVF-Flat (B2 per rank on the
    routed groups) on the allgather, ring and pipelined engines (ids =
    phase 4's but at near-ties within ``norm_tol``), IVF-PQ row- and
    list-placed (B4 per rank; ids = phase 6's but at near-ties), the 32
    most probed lists replicated and a search with rank 3 dead (no query
    routed to it, replicas serving its lists, coverage = the recomputed
    share of probed rows on live copies, the fully covered queries'
    answers the healthy ones), a migration to ``assign_lists`` over the
    observed loads (the same answers), 10,000 rows extended into and
    100,000 ids deleted from the replicated IVF-Flat and IVF-PQ indexes
    (each id counted once, none answered again), and a sharded
    ``Searcher`` over each new index kind with a dispatch hook (the direct
    searches' answers); rank 0's first routed B2, first B4 on each
    placement and first B1 k=1 of its encode held against their plain
    versions; build times, the slowest rank's wall times, the mean
    fan-out, the list pack's bytes and the launches per rank logged;
14. sharding, part 3 (the operations layer), counters set to 0 before
    each step and read after it: (a) in a NCCL world of one, the
    list-placed IVF-Flat on phase 4's centers and IVF-PQ on both
    placements over phase 6's model, 100,000 seeded ids deleted, each
    saved and loaded through a temporary directory (answers bit for bit,
    file bytes, save / load s and GB/s), the IVF-Flat compacted with
    ``shrink_capacity`` (the tombstoned answers); (b) in phase 12's world
    of 4 ranks: the list-placed IVF-Flat with its 32 most probed lists
    replicated and 100,000 ids deleted, and IVF-PQ on both placements,
    saved and loaded (answers bit for bit, bytes, s, GB/s); a snapshot
    torn on rank 2 (every rank raises, under a deadline, no manifest
    written); a ``shrink_capacity`` compaction of the loaded IVF-Flat (the
    tombstoned answers, each deleted id counted once); a
    ``balance_placement`` pass after traffic skewed onto rank 0's quarter
    of the lists (one probe a query, at the list's center; lists
    migrated, the same answers); a ``BatchScheduler``
    on rank 0 serving bench/serve.py's stream over sharded brute force and
    the balanced IVF-Flat while ranks 1-3 follow (ids = one unbatched
    sharded search's but at near-ties; rows/s); a delay scripted on rank 1,
    whose lists are replicated, on the injected clock (the hedge fires and
    wins, coverage 1); a ``RecoveryProber`` re-admitting rank 1, marked
    dead, after 3 clean probes; a transient fault on rank 2 retried by
    every rank (the fault-free answer); rank 0's first B1, B2 and B4 of
    the phase held against their plain versions;
15. durability and operations, counters set to 0 before each step and
    read after it: (a) in a NCCL world of one, the row-placed IVF-PQ
    (B4) on phase 6's model under a fsynced one-part ``MutationLog``
    with a base snapshot: extend 10,000 rows (ids from 1,000,000 up),
    delete 100,000 seeded ids, upsert 10,000, a ``shrink_capacity``
    compaction, the searcher dropped and ``recover``ed (the head epoch;
    the 10,000 queries' answers = the live ones up to exact ties); (b)
    in phase 12's world of 4 ranks, the list-placed IVF-Flat with its 32
    most probed lists replicated under a 4-part log (``snapshot_every``
    4, a base snapshot; free disk checked first, the log's directory
    removed at the end): the same stream, then a delete torn mid-frame
    on rank 0 (every rank raises, none publishes, ``recover`` lands on
    epoch 4, the stream resumes); a ``Follower`` over a second recovery
    refuses a delete, catches up to the primary's answers, and a
    ``PromotionManager`` promotes it on rank 0's scripted death (on
    every rank) at its next poll, its next delete landing at head + 1;
    ``leave_shard(3)`` then ``join_shard(3)`` warmed on the serve grid
    (lists moved, no dispatch reaching rank 3 after the leave, the
    pre-resize answers, a recover replaying both ``migrate`` records to
    the same placement, owner for owner); a ``BatchScheduler`` on rank 0
    with ``RecallProbe(rate=0.05, seed=5)`` serving bench/serve.py's
    stream, its truth searches through the command channel (recall >=
    0.995, equal to the script's own count against a full-probe
    search); one ``MetricsRegistry`` scrape whose counters equal the
    script's (records, snapshots, 2 resizes, 1 promotion, samples
    scanned); append and fsync p50 / p99 ms; rank 0's first B1 k=1 and
    B2 (and (a)'s B4) held against their plain versions;
16. a ``kernels`` line, the card line, and the result line.

The data is made with numpy from a fixed seed: 1000 Gaussian blobs
(centers uniform in [-10, 10], sigma 5), queries = database rows + N(0, 1).
The script imports neither JAX nor raft_tpu.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

SEED = 5
N_ROWS = 1_000_000
DIM = 128
N_BLOBS = 1000
BLOB_STD = 5.0
N_QUERIES = 10_000
K = 10
N_LISTS = 1024
N_PROBES = 32
RECALL_BF = 0.999
RECALL_IVF = 0.995
RECALL_PQ = 0.80          # compressed tier against brute force
RECALL_PQ_V5E = 0.864     # BENCH_r05, TPU v5e, same shape (for reference)
PQ_TIER_GAP = 0.01        # LUT scan and recon tier against compressed
N_SUB = 1000              # queries of the LUT-scan and recon-tier steps
BUCKET_CAP = 256
# The select path: bench.py's select_k rows and the kAuto gate's corners.
SELECT_SHAPES = ((64, 131072, 128), (1000, 10000, 10), (8, 65536, 64),
                 (1024, 262144, 256))
B5_K = 64                 # k of the phase-3 kStream checks
# Phase-3 B1 cases (m, n, d, k, hi), integer data in [0, hi): the slice-1
# cases, the split path (m = 1 and 129 against 200,000 rows; {0, 1} data
# makes ties across the slices), each BQ boundary of k (1, 64 | 65, 128 |
# 129, 256), n < 128, n not a multiple of the slice, d in {33, 96, 1024}.
B1_CASES = ((37, 1000, 32, 1, 8), (100, 5000, 128, 10, 8),
            (64, 3001, 64, 256, 8), (33, 129, 128, 129, 8),
            (1, 200_000, 96, 10, 2), (129, 200_000, 96, 10, 2),
            (129, 200_001, 33, 64, 2), (1, 200_000, 96, 256, 2),
            *((200, 5000, 32, k, 2) for k in (1, 10, 64, 65, 128, 129, 256)),
            (50, 100, 33, 10, 8), (50, 100, 24, 100, 2),
            (100, 3000, 1024, 10, 8), (300, 3000, 33, 129, 2))
# Phase-3 B2 cases (L, cap, d, cells, qrows, k), integer data: cap off the
# 128-slot tile, qrows off and on the row blocks (8, 64, 65), k on each
# selection path (1, 10, 16 | 17, 256), d off the 16-feature chunk.
B2_CASES = ((6, 300, 32, 9, 64, 10), (5, 129, 128, 7, 8, 256),
            (4, 2048, 128, 6, 64, 1), (6, 300, 40, 9, 65, 16),
            (6, 1000, 24, 9, 65, 17))
N_PARTS = 4               # lifecycle: multi-part brute force
N_DELETE = 100_000        # lifecycle: rows deleted from each index
N_UPSERT = 1000           # lifecycle: rows upserted into each index
# The serve phase: bench/serve.py's full stream (bench/serve.py:77-81) and
# a grid whose full batch crosses the IVF engines' kernel gate (a probe
# load n_queries * n_probes / n_lists >= 8 from 256 rows at 32 / 1024).
SERVE_REQUESTS = 2000
SERVE_MAX_ROWS = 32
SERVE_K_GRID = (10, 100)
SERVE_MAX_BATCH = 512
SERVE_REPEAT = 0.3
SERVE_LADDER = (1.0, 0.5, 0.25)
# Phase 11: ids deleted before the saves, the id bases of the int64 steps,
# the upserted rows, the served requests, and the metric searches. A
# search's f32 distance is held to the float64 one within METRIC_RTOL of
# max(1, |d|); a found id outside the float64 top-k counts as a hit when
# its float64 distance is within that of the k-th (a near-tie).
N_DELETE_MORE = 10_000
ID_BASE_BF = 1 << 32
ID_BASE_IVF = 1 << 33
N_SERVE_INT64 = 200
METRIC_SEARCH = ("cosine", "correlation", "l1", "linf", "canberra")
N_METRIC_QUERIES = 1000
N_METRIC_CHECK = 100
METRIC_RTOL = 1e-5
N_PAIRWISE = 1000

# The sharded phase (12): a world of one on NCCL in this process, then a
# gloo world of 4 ranks on the one card (one process each, every shard on
# cuda:0), each rank's shard N_ROWS / 4 rows.
N_RANKS = 4
SHARD_ENGINES = ("allgather", "ring", "ring_bf16", "pipelined",
                 "pipelined_bf16")
RECALL_DIST = 0.99        # train_distributed IVF-Flat against brute force
DEAD_RANK = 3             # the shard marked dead in the degraded checks
RANKS_TIMEOUT = 600       # seconds the parent waits for the 4 ranks
# The routed phase (13) in phase 12's world: the list placement and
# sharded IVF-PQ on phase 4's rows and centers and phase 6's model.
ROUTED_ENGINES = ("allgather", "ring", "pipelined")
N_HOT = 32                # the most probed lists, replicated
N_EXTEND_13 = 10_000      # rows extended into the replicated indexes
N_DELETE_13 = 100_000     # ids then deleted from them
# The operations phase (14), in phase 12's world and a NCCL world of one.
N_DELETE_14 = 100_000     # ids deleted, saved with, then compacted away
N_SKEW_14 = 2_000         # skewed queries, onto rank 0's quarter of lists
BALANCE_14 = 1.5          # the balance pass's trigger (x the mean load)
VICTIM_14 = 1             # the straggling rank, its lists replicated
SERVICE_14 = 0.001        # seconds a dispatch costs on the injected clock
N_WARM_14, N_HEDGE_14 = 16, 40   # searches before and after the delay
CLEAN_14 = 3              # the recovery breaker's clean_threshold
DEADLINE_14 = 120         # seconds the torn save may take on a rank
# The durability phase (15), in phase 12's world and a NCCL world of one.
N_EXTEND_15 = 10_000      # rows extended, ids from N_ROWS up
N_DELETE_15 = 100_000     # seeded ids deleted
N_UPSERT_15 = 10_000      # surviving ids upserted with new rows
N_DELETE_LATE_15 = 1_000  # ids of the torn delete, and of the promoted one
SNAP_EVERY_15 = 4         # the 4-rank log's snapshot cadence
N_CHECK_15 = 2_000        # queries of the recovered / resized answers
PRIMARY_15 = 0            # the rank whose death promotes the follower
LEAVER_15 = 3             # the shard drained, then joined back
PROBE_RATE_15, PROBE_SEED_15 = 0.05, 5

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

# Expanded-L2 cancellation: |q|^2 + |y|^2 - 2 q.y carries f32 rounding of
# the norms' size, summed in another order by the kernel and by cuBLAS.
# Gaussian comparisons allow 2e-6 of the largest |q|^2 + |y|^2 (about 32
# f32 ulps of it); integer-valued data must agree exactly.
REL_NORM_TOL = 2e-6


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_data(n_rows, dim, n_blobs, n_queries, seed=SEED):
    """Clustered rows and queries (rows + unit noise), as float32 numpy."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10.0, 10.0, (n_blobs, dim)).astype(np.float32)
    labels = rng.permutation(np.arange(n_rows) % n_blobs)
    X = centers[labels]
    X += BLOB_STD * rng.standard_normal((n_rows, dim), dtype=np.float32)
    Q = X[:n_queries] + rng.standard_normal((n_queries, dim),
                                            dtype=np.float32)
    return X, Q


def recall(found, truth) -> float:
    """Mean share of each row of ``truth`` that ``found`` contains."""
    hit = (found[:, :, None] == truth[:, None, :]).any(dim=2)
    return float(hit.float().mean())


def norm_tol(q, y) -> float:
    import torch

    qn = float(torch.max(torch.sum(q.float() ** 2, dim=-1)))
    yn = float(torch.max(torch.sum(y.float() ** 2, dim=-1)))
    return REL_NORM_TOL * (qn + yn)


def max_err(a, b) -> float:
    """Largest |a - b| over entries finite in both; the inf patterns must
    agree."""
    import torch

    ia, ib = torch.isinf(a), torch.isinf(b)
    if not torch.equal(ia, ib):
        raise AssertionError("inf patterns differ")
    fin = ~ia
    if not bool(fin.any()):
        return 0.0
    return float(torch.max(torch.abs(a[fin] - b[fin])))


def device_ms(fn, kernel: str, reps: int = 10):
    """Mean device time per call of the kernels whose name holds
    ``kernel``, from a ``torch.profiler`` trace of ``reps`` calls: the
    kernel alone, without the host time a CUDA-event window also spans
    when the wrapper is slower than the kernel. None when the trace holds
    no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0.0)
             for e in prof.key_averages() if kernel in e.key)
    return us / reps / 1e3 if us > 0 else None


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn()`` by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_enqueue_ms(fn, reps: int = 200) -> float:
    """Host milliseconds per call of ``fn`` over ``reps`` calls enqueued
    without a synchronise (the wrapper's own cost; the device may still be
    running when the clock stops)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return host


def check_kernels(dev) -> None:
    """Phase 3: both kernels against their plain versions on the card."""
    import torch

    from raft_tpu_torch.ops import fused_knn as fk

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(SEED)
    for m, n, d, k, hi in B1_CASES:
        for integer in (True, False):
            if integer:
                q = rng.integers(0, hi, (m, d)).astype(np.float32)
                y = rng.integers(0, hi, (n, d)).astype(np.float32)
            else:
                q = rng.standard_normal((m, d), dtype=np.float32)
                y = rng.standard_normal((n, d), dtype=np.float32)
            qt, yt = torch.as_tensor(q, device=dev), torch.as_tensor(y,
                                                                      device=dev)
            for metric in ("l2", "ip"):
                for bf16, qsplit in ((False, False), (True, False),
                                     (True, True)):
                    kd, ki = fk._fused_knn_cuda(qt, yt, k, metric == "l2",
                                                bf16, qsplit)
                    pd, pi = fk._fused_knn_plain(qt, yt, k, metric == "l2",
                                                 bf16, qsplit)
                    torch.cuda.synchronize()
                    tag = (f"B1 m={m} n={n} d={d} k={k} {metric} "
                           f"bf16={bf16} qsplit={qsplit} "
                           f"{'int' if integer else 'gauss'}")
                    if integer:
                        ok = torch.equal(ki, pi) and torch.equal(kd, pd)
                        err = max_err(kd, pd)
                    else:
                        err = max_err(kd, pd)
                        ok = err <= norm_tol(qt, yt)
                    if not ok:
                        raise AssertionError(f"{tag}: kernel != plain "
                                             f"(max err {err})")
        log(f"B1 ok m={m} n={n} d={d} k={k} slices="
            f"{len(fk._b1_plan(m, n, k, n_sm).bounds)} (l2/ip, "
            f"f32/bf16/qsplit, int in [0, {hi}) exact / gauss max err "
            f"within tol)")
    # Contiguous operands that start one float past 16 bytes take the
    # 4-byte copies and must still agree exactly.
    q = rng.integers(0, 2, (129, 96)).astype(np.float32)
    y = rng.integers(0, 2, (200_000, 96)).astype(np.float32)
    qt, yt = torch.as_tensor(q, device=dev), torch.as_tensor(y, device=dev)
    qv = torch.empty(qt.numel() + 1, device=dev)[1:].view(qt.shape)
    yv = torch.empty(yt.numel() + 1, device=dev)[1:].view(yt.shape)
    qv.copy_(qt)
    yv.copy_(yt)
    for metric in ("l2", "ip"):
        for bf16, qsplit in ((False, False), (True, False), (True, True)):
            kd, ki = fk._fused_knn_cuda(qv, yv, 10, metric == "l2", bf16,
                                        qsplit)
            pd, pi = fk._fused_knn_plain(qt, yt, 10, metric == "l2", bf16,
                                         qsplit)
            if not (torch.equal(ki, pi) and torch.equal(kd, pd)):
                raise AssertionError(f"B1 unaligned {metric} bf16={bf16} "
                                     f"qsplit={qsplit}: kernel != plain")
    log("B1 ok on operands off 16-byte alignment (m=129 n=200000 d=96 "
        "k=10, l2/ip, f32/bf16/qsplit, exact)")

    for L, cap, d, C, qrows, k in B2_CASES:
        db = rng.integers(0, 8, (L, cap, d)).astype(np.float32)
        invalid = rng.random((L, cap)) < 0.3
        invalid[1, :] = True            # an empty list
        invalid[2, 3:] = True           # a starved list: 3 valid rows < k
        cells = rng.integers(-1, L, C).astype(np.int32)
        cells[0], cells[1], cells[-1] = 1, 2, -1
        q = rng.integers(0, 8, (C, qrows, d)).astype(np.float32)
        args = [torch.as_tensor(a, device=dev)
                for a in (cells, q, db, invalid)]
        for bf16_db in (False, True):
            a = list(args)
            if bf16_db:
                a[2] = a[2].to(torch.bfloat16)
            for l2 in (True, False):
                kd, ki = fk._fused_cells_knn_cuda(*a, k, l2, bf16_db,
                                                  bf16_db)
                pd, pi = fk._fused_cells_knn_plain(*a, k, l2, bf16_db,
                                                   bf16_db)
                torch.cuda.synchronize()
                if not (torch.equal(ki, pi) and torch.equal(kd, pd)):
                    raise AssertionError(
                        f"B2 L={L} cap={cap} d={d} k={k} l2={l2} "
                        f"bf16_db={bf16_db}: kernel != plain")
            if k > 3 and not bool((ki[1, :, 3:] == -1).all()):
                raise AssertionError("B2 starved list did not report -1")
        log(f"B2 ok L={L} cap={cap} d={d} cells={C} qrows={qrows} k={k} "
            f"rows/CTA={fk._b2_plan(qrows, d, k).bq} (-1 cells, masks, "
            f"starved list, f32/bf16 db, l2/ip)")
    # Contiguous operands one element past 16 bytes take the narrower
    # copies (4-byte f32, 2-byte bf16) and must still agree exactly.
    db = rng.integers(0, 2, (6, 300, 40)).astype(np.float32)
    invalid = rng.random((6, 300)) < 0.3
    cells = np.array([0, 1, -1, 2, 3, 4, 5], np.int32)
    q = rng.integers(0, 2, (7, 65, 40)).astype(np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (cells, q, db, invalid)]
    for bf16_db in (False, True):
        a = list(args)
        if bf16_db:
            a[2] = a[2].to(torch.bfloat16)
        views = []
        for x in (a[1], a[2]):
            v = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:]
            views.append(v.view(x.shape))
            views[-1].copy_(x)
        for l2 in (True, False):
            kd, ki = fk._fused_cells_knn_cuda(a[0], views[0], views[1], a[3],
                                              10, l2, bf16_db, bf16_db)
            pd, pi = fk._fused_cells_knn_plain(*a, 10, l2, bf16_db, bf16_db)
            if not (torch.equal(ki, pi) and torch.equal(kd, pd)):
                raise AssertionError(f"B2 unaligned l2={l2} bf16_db="
                                     f"{bf16_db}: kernel != plain")
    log("B2 ok on operands off 16-byte alignment (qrows=65 d=40 k=10, "
        "l2/ip, f32/bf16 db, exact)")


def _pq_case(rng, bits, integer=True, J=64, L=2, cap=1500, n_cells=9,
             qrows=64):
    """B4 operands: codes of 6 lists (an empty one, a starved one with 5
    valid slots), n_cells cells (one -1). Integer books put a +-127 entry
    in every table row, so the int8 tables dequantize to the same
    integers (scale 1)."""
    import torch

    from raft_tpu_torch.neighbors import ivf_pq

    B = 1 << bits
    if integer:
        books = rng.integers(-3, 4, (J, B, L)).astype(np.float32)
        books[:, 0, :] = 127.0
        books[:, B // 2, :] = -127.0
        q = rng.integers(-4, 5, (n_cells, qrows, J * L)).astype(np.float32)
    else:
        books = rng.standard_normal((J, B, L)).astype(np.float32)
        q = rng.standard_normal((n_cells, qrows, J * L)).astype(np.float32)
    codes = rng.integers(0, B, (6, cap, J)).astype(np.int32)
    packed = ivf_pq.pack_codes(torch.as_tensor(codes), bits).numpy()
    codesT = np.ascontiguousarray(packed.transpose(0, 2, 1))
    invalid = rng.random((6, cap)) < 0.2
    invalid[1, :] = True
    invalid[3, 5:] = True
    cells = rng.integers(0, 6, n_cells).astype(np.int32)
    cells[0], cells[1], cells[2] = 1, 3, -1
    return books, cells, q, codesT, invalid


def check_kernels_b3_b4(dev) -> None:
    """Phase 3 for B3 and B4: kernel against plain version on the card."""
    import torch

    from raft_tpu_torch.ops import fused_knn as fk
    from raft_tpu_torch.ops import pq_scan as ps

    rng = np.random.default_rng(SEED + 1)
    # B3: n > the reference's 2048-row db tile (2500, 3001) and ragged
    # (3001, 129); an empty slab (1) and a starved one (2: 3 valid rows);
    # every row, or live rows 0, 1, a middle count, m, ... per slab; d 1024
    # (B2's scan on every tier).
    for B, m, nn, d, k in ((6, 37, 2500, 64, 10), (5, 70, 3001, 128, 256),
                           (4, 9, 129, 32, 1), (4, 65, 700, 100, 16),
                           (3, 40, 300, 1024, 17)):
        q = rng.integers(0, 8, (B, m, d)).astype(np.float32)
        db = rng.integers(0, 8, (B, nn, d)).astype(np.float32)
        invalid = rng.random((B, nn)) < 0.3
        invalid[1, :] = True
        invalid[2, 3:] = True
        live = np.resize([0, 1, m // 2, m], B).astype(np.int32)
        qt, dbt, inv, lrt = (torch.as_tensor(a, device=dev)
                             for a in (q, db, invalid, live))
        for lr in (None, lrt):
            for l2 in (True, False):
                for bf16, qsplit in ((False, False), (True, False),
                                     (True, True)):
                    y = dbt.to(torch.bfloat16) if bf16 else dbt
                    kd, ki = fk._fused_batch_knn_cuda(qt, y, inv, k, l2,
                                                      bf16, qsplit, lr)
                    pd, pi = fk._fused_batch_knn_plain(qt, y, inv, k, l2,
                                                       bf16, qsplit, lr)
                    torch.cuda.synchronize()
                    if not (torch.equal(ki, pi) and torch.equal(kd, pd)):
                        raise AssertionError(
                            f"B3 B={B} m={m} n={nn} d={d} k={k} l2={l2} "
                            f"bf16={bf16} qsplit={qsplit} live_rows="
                            f"{lr is not None}: kernel != plain")
            if not bool((ki[1] == -1).all()) or (k > 3 and not bool(
                    (ki[2, :, 3:] == -1).all())):
                raise AssertionError("B3 empty/starved slab did not report "
                                     "-1")
        plan = fk._b3_plan(m, d, k, "bf16", "bf16")
        log(f"B3 ok B={B} m={m} n={nn} d={d} k={k} (l2/ip, f32/bf16/qsplit, "
            f"all rows and live rows, empty and starved slabs, "
            f"bit-identical; bf16 store plan {plan.path} {plan.bq} rows)")

    # B4 on integer codebooks and queries: bit-identical.
    for bits in (4, 8):
        for k in (1, 10, 256):
            books, cells, q, codesT, invalid = _pq_case(rng, bits)
            ops = [torch.as_tensor(a, device=dev)
                   for a in (cells, q, codesT, invalid)]
            for int8 in (False, True):
                tabs = [x.to(dev) for x in ps.book_tables(
                    torch.as_tensor(books), bits, int8=int8)]
                scale = tabs[2] if int8 else None
                for is_ip in (False, True):
                    args = (ops[0], ops[1], ops[2], tabs[0], tabs[1],
                            ops[3], k, 64, bits, is_ip, scale)
                    kd, ki = ps._pq_fused_scan_cuda(*args)
                    pd, pi = ps._pq_fused_scan_plain(*args)
                    torch.cuda.synchronize()
                    if not (torch.equal(ki, pi) and torch.equal(kd, pd)):
                        raise AssertionError(
                            f"B4 bits={bits} k={k} int8={int8} "
                            f"ip={is_ip}: kernel != plain")
                    if not (bool((ki[0] == -1).all())
                            and bool((ki[2] == -1).all())
                            and (k <= 5 or bool((ki[1, :, 5:] == -1)
                                                .all()))):
                        raise AssertionError("B4 sentinels missing")
            log(f"B4 ok bits={bits} k={k} (l2/ip, f32/int8 tables, -1 cell, "
                f"empty and starved lists, bit-identical)")

    # B4 on Gaussian data: within 2e-6 of the largest |q|^2 + |cw|^2.
    books, cells, q, codesT, invalid = _pq_case(rng, 8, integer=False)
    ops = [torch.as_tensor(a, device=dev) for a in (cells, q, codesT,
                                                    invalid)]
    lo, hi = (x.to(dev) for x in ps.book_tables(torch.as_tensor(books), 8))
    table = torch.cat([lo[0], hi[0]], dim=1)
    tol = REL_NORM_TOL * (float(torch.max(torch.sum(ops[1] ** 2, dim=-1)))
                          + float(torch.sum(torch.amax(table ** 2, dim=1))))
    for is_ip in (False, True):
        args = (ops[0], ops[1], ops[2], lo, hi, ops[3], 10, 64, 8, is_ip)
        kd, ki = ps._pq_fused_scan_cuda(*args)
        pd, pi = ps._pq_fused_scan_plain(*args)
        err = max_err(kd, pd)
        agree = float((ki == pi).float().mean())
        log(f"B4 gauss ip={is_ip}: max |d| err {err:.3e} (tol {tol:.3e}), "
            f"id agreement {agree:.6f}")
        if err > tol or agree < RECALL_BF:
            raise AssertionError("B4 Gaussian disagrees with plain")


def main_path(dev, X, Q):
    """Phase 4: the port's main path through its user entry points, with
    the launch counters read around it. Returns what phase 5 needs."""
    import torch

    from raft_tpu_torch.neighbors import brute_force, ivf_flat
    from raft_tpu_torch.ops import fused_knn as fk

    _zero_counters()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    bf_d, bf_i = brute_force.knn(X, Q, K)
    torch.cuda.synchronize()
    bf_s = time.perf_counter() - t0
    bf_launches = fk.fused_knn.launches

    t0 = time.perf_counter()
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=N_LISTS), X)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = fk.fused_knn.launches - bf_launches

    sp = ivf_flat.SearchParams(n_probes=N_PROBES)
    t0 = time.perf_counter()
    iv_d, iv_i = ivf_flat.search(sp, index, Q, K)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0

    launches = {"fused_knn": fk.fused_knn.launches,
                "fused_cells_knn": fk.fused_cells_knn.launches}
    log(f"main path: brute force {bf_s:.3f} s ({bf_launches} B1 launch), "
        f"IVF-Flat build {build_s:.3f} s ({build_launches} B1 launches), "
        f"first search {search_s:.3f} s "
        f"({launches['fused_cells_knn']} B2 launch)")
    if bf_launches < 1 or build_launches < 1 \
            or launches["fused_cells_knn"] < 1:
        raise AssertionError(f"a kernel of the main path did not launch: "
                             f"{launches}")

    for name, t in (("bf", bf_d), ("ivf", iv_d)):
        if not bool(torch.isfinite(t).all()) or t.shape != (N_QUERIES, K):
            raise AssertionError(f"{name} distances not finite (q, k)")
    rec = recall(iv_i, bf_i)
    log(f"IVF-Flat recall@{K} vs brute force: {rec:.6f} "
        f"(bar {RECALL_IVF})")
    if rec < RECALL_IVF:
        raise AssertionError(f"IVF-Flat recall {rec} < {RECALL_IVF}")

    search_ms = time_ms(lambda: ivf_flat.search(sp, index, Q, K), reps=5)
    log(f"IVF-Flat search: {search_ms:.3f} ms per {N_QUERIES} queries = "
        f"{N_QUERIES / search_ms * 1e3:.1f} QPS (n_probes={N_PROBES}, "
        f"k={K})")
    log(f"IVF-Flat build: {build_s:.3f} s (n_lists={N_LISTS}, first call)")
    # Phase 12 holds the sharded paths to these answers and these centers
    # (later phases mutate the index).
    return {"bf": (bf_d, bf_i), "index": index, "launches": launches,
            "search_ms": search_ms, "iv": (iv_d, iv_i),
            "centers": index.centers.clone()}


def b1_entry(dev, X, Q, bf):
    """Phase 5 for B1 at the brute-force shape."""
    import torch

    from raft_tpu_torch.ops import fused_knn as fk

    m, n, d = Q.shape[0], X.shape[0], X.shape[1]
    pd, pi = fk._fused_knn_plain(Q, X, K, True, False, False)
    kd, ki = bf
    err = max_err(kd, pd)
    rec = recall(ki, pi)
    log(f"B1 vs plain at main path: recall@{K} {rec:.6f} (bar {RECALL_BF}), "
        f"max |d| err {err:.3e} (tol {norm_tol(Q, X):.3e})")
    if rec < RECALL_BF or err > norm_tol(Q, X):
        raise AssertionError("B1 disagrees with its plain version")

    ms = time_ms(lambda: fk._fused_knn_cuda(Q, X, K, True, False, False), 5)
    plain_ms = time_ms(
        lambda: fk._fused_knn_plain(Q, X, K, True, False, False), 2)
    yn = torch.sum(X * X, dim=1)
    chunk = 2500

    def library():
        for s in range(0, m, chunk):
            g = torch.addmm(yn, Q[s:s + chunk], X.t(), alpha=-2.0)
            torch.topk(g, K, dim=1, largest=False)

    lib_ms = time_ms(library, 3)
    plan = fk._b1_plan(m, n, K, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    ops = 2.0 * m * n * d
    nbytes = 4.0 * (m * d + n * d) + 8.0 * m * K
    bound = max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
    log(f"B1 timing m={m} n={n} d={d} k={K}: kernel {ms:.3f} ms "
        f"({ops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, library "
        f"(addmm + topk over {-(-m // chunk)} query chunks) {lib_ms:.3f} ms, "
        f"bound {bound:.3f} ms (FP32 ops); plan: {plan.bq} queries per CTA, "
        f"{len(plan.bounds)} database slices")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if ops / PEAK_FP32 >= nbytes / PEAK_BYTES
            else "bytes", "library_ms": lib_ms}


def b1_kmeans_shape(dev, X, centers):
    """B1 at the k=1 assignment shapes of the IVF-Flat build, each held
    against its plain version: the trainset (half the rows) against the
    32 mesocluster-sized and the 1024 list-sized center sets on the f32 and
    split-bf16 tiers (the balancing EM runs both), and every row against
    the 1024 centers in f32 (the extend assignment). Arg-min agreement must
    reach RECALL_BF and the distances agree within ``norm_tol``."""
    import torch

    from raft_tpu_torch.ops import fused_knn as fk

    T = X[::2][:N_ROWS // 2].contiguous()
    C1024 = centers.contiguous()
    C32 = centers[::N_LISTS // 32].contiguous()
    cases = [("train", T, C32, "f32", False),
             ("train", T, C32, "split-bf16", True),
             ("train", T, C1024, "f32", False),
             ("train", T, C1024, "split-bf16", True),
             ("extend", X, C1024, "f32", False)]
    for what, A, C, tier, bf16 in cases:
        m, n, d = A.shape[0], C.shape[0], C.shape[1]
        kd, ki = fk._fused_knn_cuda(A, C, 1, True, bf16, bf16)
        pd, pi = fk._fused_knn_plain(A, C, 1, True, bf16, bf16)
        torch.cuda.synchronize()
        agree = float((ki == pi).float().mean())
        err = max_err(kd, pd)
        tol = norm_tol(A, C)
        tag = f"B1 k-means {what} m={m} n={n} d={d} k=1 {tier}"
        log(f"{tag}: arg-min agreement {agree:.6f} (bar {RECALL_BF}), max "
            f"|d| err {err:.3e} (tol {tol:.3e})")
        if agree < RECALL_BF or err > tol:
            raise AssertionError(f"{tag}: kernel disagrees with plain")
        del kd, ki, pd, pi
        ms = time_ms(lambda: fk._fused_knn_cuda(A, C, 1, True, bf16, bf16),
                     5)
        # Split-bf16 makes two products per pair; every tier runs on FMA.
        ops = 2.0 * m * n * d * (2 if bf16 else 1)
        nbytes = 4.0 * (m * d + n * d) + 8.0 * m
        fma = max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
        # The library yardstick of a k=1 scan: one addmm of the expanded
        # L2 (f32) and its row arg-min.
        cn = torch.sum(C * C, dim=1)
        lib_ms = time_ms(lambda: torch.argmin(
            torch.addmm(cn, A, C.t(), alpha=-2.0), dim=1), 3)
        line = (f"{tag}: kernel {ms:.3f} ms, FP32-FMA bound {fma:.3f} ms "
                f"({ops / ms / 1e9:.1f} TFLOP/s), library (addmm + argmin) "
                f"{lib_ms:.3f} ms")
        if bf16:
            tc = max(ops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
            line += (f", bf16 tensor-core bound {tc:.3f} ms (the kernel "
                     f"does not use tensor cores)")
        log(line)


def b2_entry(dev, Q, index, search_ms):
    """Phase 5 for B2 at the IVF-Flat search shape: k=10 and k=1, its
    plan, the device-time share of its pre-pass, its share of the search
    and ptxas' registers and spills."""
    import torch

    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops import fused_knn as fk

    qrows = ivf_flat._CELL_QROWS
    probes = ivf_flat._coarse_probe(Q, index.centers, N_PROBES, True)
    cell_list, bucket, _ = ivf_flat._invert_probe_map_cells(
        probes, index.n_lists, qrows)
    Qc = Q[torch.clamp_min(bucket, 0)].contiguous()
    cap = index.data.shape[1]
    invalid = (torch.arange(cap, device=dev)[None, :]
               >= index.list_sizes[:, None]).contiguous()
    data = index.data
    args = (cell_list, Qc, data, invalid)

    kd, ki = fk._fused_cells_knn_cuda(*args, K, True, False, False)
    pd, pi = fk._fused_cells_knn_plain(*args, K, True, False, False)
    err = max_err(kd, pd)
    live = cell_list >= 0
    rec = recall(ki[live].reshape(-1, K), pi[live].reshape(-1, K))
    log(f"B2 vs plain at main path: per-slot recall@{K} {rec:.6f}, max |d| "
        f"err {err:.3e} (tol {norm_tol(Q, data):.3e})")
    if rec < RECALL_BF or err > norm_tol(Q, data):
        raise AssertionError("B2 disagrees with its plain version")

    ms = time_ms(lambda: fk._fused_cells_knn_cuda(*args, K, True, False,
                                                  False), 5)
    k1_ms = time_ms(lambda: fk._fused_cells_knn_cuda(*args, 1, True, False,
                                                     False), 5)
    plain_ms = time_ms(lambda: fk._fused_cells_knn_plain(*args, K, True,
                                                         False, False), 2)
    # One call is the pre-pass (live tiles, row norms) and the scan.
    pre_ms = device_ms(lambda: fk._fused_cells_knn_cuda(
        *args, K, True, False, False), "b2_norms_kernel", reps=5)
    scan_ms = device_ms(lambda: fk._fused_cells_knn_cuda(
        *args, K, True, False, False), "b2_scan_kernel", reps=5)
    dn = torch.sum(data * data, dim=2)
    step = 512

    def library():
        for s in range(0, cell_list.shape[0], step):
            lst = torch.clamp_min(cell_list[s:s + step], 0).long()
            g = torch.baddbmm(dn[lst][:, None, :], Qc[s:s + step],
                              data[lst].transpose(1, 2), alpha=-2.0)
            g.masked_fill_(invalid[lst][:, None, :], float("inf"))
            torch.topk(g, K, dim=2, largest=False)

    lib_ms = time_ms(library, 3)

    sizes = index.list_sizes.long()
    used = torch.unique(cell_list[live].long())
    pair_rows = float(torch.sum(sizes[probes.long()]))
    ops = 2.0 * DIM * pair_rows
    nbytes = (4.0 * Qc.numel() + 4.0 * DIM * float(torch.sum(sizes[used]))
              + float(used.numel() * cap) + 4.0 * cell_list.numel()
              + 8.0 * kd.numel())
    bound = max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
    log(f"B2 timing cells={cell_list.shape[0]} (used {int(live.sum())}) "
        f"qrows={qrows} cap={cap} d={DIM} k={K}: kernel {ms:.3f} ms "
        f"({ms / search_ms:.1%} of the {search_ms:.3f} ms search; k=1 "
        f"{k1_ms:.3f} ms), plain {plain_ms:.3f} ms, library (gather + "
        f"baddbmm + topk over {step}-cell chunks) {lib_ms:.3f} ms, bound "
        f"{bound:.3f} ms")
    plan = fk._b2_plan(qrows, DIM, K, False)
    log(f"B2 plan: {plan.bq} query rows per CTA, queries staged with every "
        f"chunk, {plan.smem} B of shared memory; device time pre-pass "
        f"{pre_ms} ms + scan {scan_ms} ms" + (
            f" (pre-pass share {pre_ms / (pre_ms + scan_ms):.1%})"
            if pre_ms and scan_ms else " (not traced)"))
    text = _build.BUILD_LOG.get("cells_knn", "")
    log(f"B2 ptxas (registers, spills): "
        f"{[ln.strip() for ln in text.splitlines() if 'registers' in ln or 'spill' in ln]}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if ops / PEAK_FP32 >= nbytes / PEAK_BYTES
            else "bytes", "library_ms": lib_ms}


def _counted():
    """Every kernel wrapper with a launch counter, by kernel name."""
    from raft_tpu_torch.ops import fused_knn as fk
    from raft_tpu_torch.ops import pq_scan as ps
    from raft_tpu_torch.ops import stream_select as ss

    return {"fused_knn": fk.fused_knn,
            "fused_cells_knn": fk.fused_cells_knn,
            "fused_batch_knn": fk.fused_batch_knn,
            "pq_fused_scan": ps.pq_fused_scan,
            "stream_extract": ss.stream_extract}


def _zero_counters() -> None:
    for fn in _counted().values():
        fn.launches = 0


def _launches():
    return {name: fn.launches for name, fn in _counted().items()}


def _step(before):
    """Launches of each kernel since ``before``."""
    now = _launches()
    return {k: now[k] - before[k] for k in now}


def pq_path(dev, X, Q, bf_i):
    """Phase 6: the IVF-PQ path through its entry points, with the launch
    counters set to 0 before it and read around each step."""
    import torch

    from raft_tpu_torch.distance.pairwise import gram
    from raft_tpu_torch.neighbors import ivf_pq

    _zero_counters()
    torch.cuda.synchronize()
    steps = {}

    before = _launches()
    t0 = time.perf_counter()
    index = ivf_pq.build(ivf_pq.IndexParams(n_lists=N_LISTS), X)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    steps["build"] = _step(before)

    sp = ivf_pq.SearchParams(n_probes=N_PROBES)
    before = _launches()
    t0 = time.perf_counter()
    cd, ci = ivf_pq.search(sp, index, Q, K)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    steps["compressed"] = _step(before)
    if not bool(torch.isfinite(cd).all()) or cd.shape != (N_QUERIES, K):
        raise AssertionError("IVF-PQ distances not finite (q, k)")
    rec = recall(ci, bf_i)
    log(f"IVF-PQ build {build_s:.3f} s (n_lists={N_LISTS}, pq_dim "
        f"{index.pq_dim}, pq_bits {index.pq_bits}, cap "
        f"{index.pq_codes.shape[1]}, first call); compressed search recall@"
        f"{K} vs brute force {rec:.6f} (bar {RECALL_PQ}; TPU v5e "
        f"{RECALL_PQ_V5E}), first search {first_s:.3f} s")
    if rec < RECALL_PQ:
        raise AssertionError(f"IVF-PQ recall {rec} < {RECALL_PQ}")
    search_ms = time_ms(lambda: ivf_pq.search(sp, index, Q, K), reps=5)
    log(f"IVF-PQ compressed search: {search_ms:.3f} ms per {N_QUERIES} "
        f"queries = {N_QUERIES / search_ms * 1e3:.1f} QPS")

    Qs, truth = Q[:N_SUB], bf_i[:N_SUB]
    rec_c = recall(ci[:N_SUB], truth)
    before = _launches()
    t0 = time.perf_counter()
    _, li = ivf_pq.search(ivf_pq.SearchParams(n_probes=N_PROBES,
                                              engine="scan"), index, Qs, K)
    torch.cuda.synchronize()
    lut_s = time.perf_counter() - t0
    steps["lut_scan"] = _step(before)
    rec_l = recall(li, truth)

    t0 = time.perf_counter()
    index.reconstructed()
    torch.cuda.synchronize()
    recon_s = time.perf_counter() - t0
    sp_r = ivf_pq.SearchParams(n_probes=N_PROBES, engine="bucketed",
                               bucket_cap=BUCKET_CAP)
    before = _launches()
    t0 = time.perf_counter()
    _, ri = ivf_pq.search(sp_r, index, Qs, K)
    torch.cuda.synchronize()
    recon_search_s = time.perf_counter() - t0
    steps["recon"] = _step(before)
    rec_r = recall(ri, truth)
    recon_ms = time_ms(lambda: ivf_pq.search(sp_r, index, Qs, K), reps=5)

    def decode_search():
        """The search without the cache: the probes, the rotation and the
        decode scan, block by block of lists (as ``search`` runs it when
        the cache would be too large)."""
        pr = ivf_pq._select_clusters(Qs, index.centers, N_PROBES, False)
        return ivf_pq._bucketed_decode_scan(
            gram(Qs, index.rotation_matrix), index.pq_codes,
            index.pq_centers, index.centers_rot(), index.indices,
            index.list_sizes, pr, K, False, False, BUCKET_CAP, index.pq_dim,
            index.pq_bits, index.deleted)

    probes = ivf_pq._select_clusters(Qs, index.centers, N_PROBES, False)
    rotq = gram(Qs, index.rotation_matrix)
    before = _launches()
    t0 = time.perf_counter()
    _, di = decode_search()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    steps["decode_scan"] = _step(before)
    decode_ms = time_ms(decode_search, reps=5)

    log(f"first {N_SUB} queries: recall@{K} compressed {rec_c:.6f}, LUT "
        f"scan {rec_l:.6f} ({lut_s:.3f} s), recon tier {rec_r:.6f} (cache "
        f"{recon_s:.3f} s, first search {recon_search_s:.3f} s, then "
        f"{recon_ms:.3f} ms), decode scan first search {decode_s:.3f} s, "
        f"then {decode_ms:.3f} ms")
    log(f"IVF-PQ launches per step: {steps}")
    if abs(rec_l - rec_c) > PQ_TIER_GAP or abs(rec_r - rec_c) > PQ_TIER_GAP:
        raise AssertionError(f"tier recalls differ by more than "
                             f"{PQ_TIER_GAP}: compressed {rec_c}, LUT scan "
                             f"{rec_l}, recon {rec_r}")
    if not torch.equal(di, ri):
        raise AssertionError("decode scan ids differ from the recon tier's")
    log("decode scan ids equal to the recon tier's")
    if (steps["build"]["fused_knn"] < 1
            or steps["compressed"]["pq_fused_scan"] < 1
            or steps["recon"]["fused_batch_knn"] < 1
            or steps["decode_scan"]["fused_batch_knn"] < 1):
        raise AssertionError(f"a kernel of the IVF-PQ path did not launch: "
                             f"{steps}")
    total = {k: sum(st[k] for st in steps.values())
             for k in steps["build"]}
    return {"index": index, "launches": total, "search_ms": search_ms,
            "probes_sub": probes, "rotq_sub": rotq, "recall": rec,
            "compressed": (cd, ci)}


def b4_entry(dev, Q, index, search_ms):
    """Phase 6 timings for B4 at the compressed-search shape."""
    import torch

    from raft_tpu_torch.distance.pairwise import gram
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops import fused_knn as fk
    from raft_tpu_torch.ops import pq_scan as ps

    codesT, lo, hi, invalid, crot_p = index.compressed_scan_operands()
    J, bits = index.pq_dim, index.pq_bits
    probes = ivf_pq._select_clusters(Q, index.centers, N_PROBES, False)
    rotq_p = ps.permute_subspaces(gram(Q, index.rotation_matrix), J, bits)
    cell_list, bucket, _ = ivf_flat._invert_probe_map_cells(
        probes, index.n_lists, ivf_flat._CELL_QROWS)
    safe = torch.clamp_min(cell_list, 0).long()
    Qc = (rotq_p[torch.clamp_min(bucket, 0)]
          - crot_p[safe][:, None, :]).contiguous()
    args = (cell_list, Qc, codesT, lo, hi, invalid, K, J, bits, False)

    kd, ki = ps._pq_fused_scan_cuda(*args)
    pd, pi = ps._pq_fused_scan_plain(*args)
    table = torch.cat([lo[0], hi[0]], dim=1)
    tol = REL_NORM_TOL * (float(torch.max(torch.sum(Qc ** 2, dim=-1)))
                          + float(torch.sum(torch.amax(table ** 2, dim=1))))
    err = max_err(kd, pd)
    live = cell_list >= 0
    rec = recall(ki[live].reshape(-1, K), pi[live].reshape(-1, K))
    log(f"B4 vs plain at main path: per-slot recall@{K} {rec:.6f}, max |d| "
        f"err {err:.3e} (tol {tol:.3e})")
    if rec < RECALL_BF or err > tol:
        raise AssertionError("B4 disagrees with its plain version")

    ms = time_ms(lambda: ps._pq_fused_scan_cuda(*args), 5)
    plain_ms = time_ms(lambda: ps._pq_fused_scan_plain(*args), 2)
    # One call is the code-norm pre-pass and the scan: their device times.
    pre_ms = device_ms(lambda: ps._pq_fused_scan_cuda(*args),
                       "b4_norms_kernel", reps=5)
    scan_ms = device_ms(lambda: ps._pq_fused_scan_cuda(*args),
                        "b4_scan_kernel", reps=5)
    plan = ps._b4_plan(Qc.shape[1], Qc.shape[2], J, bits, K)
    step = 128

    def library():
        for s in range(0, cell_list.shape[0], step):
            lst = safe[s:s + step]
            cw = ps.decode_codewords(codesT[lst], table, J, bits)
            cwn = torch.sum(cw * cw, dim=1)[:, None, :]
            g = torch.baddbmm(cwn.to(torch.bfloat16),
                              Qc[s:s + step].to(torch.bfloat16),
                              cw.to(torch.bfloat16), alpha=-2.0)
            g.masked_fill_(invalid[lst][:, None, :], float("inf"))
            torch.topk(g, K, dim=2, largest=False)

    lib_ms = time_ms(library, 3)
    # The same cells through B2's bf16 tier over the reconstruction cache:
    # the same tile loop and product, with rows read instead of decoded.
    recon = index.reconstructed()
    b2_ms = time_ms(lambda: fk._fused_cells_knn_cuda(
        cell_list, Qc, recon, invalid[:, :recon.shape[1]].contiguous(), K,
        True, True, False), 5)
    sizes = index.list_sizes.long()
    used = torch.unique(cell_list[live].long())
    rot = Qc.shape[2]
    pair_rows = float(torch.sum(sizes[probes.long()]))
    ops = 2.0 * rot * pair_rows
    nbytes = (4.0 * Qc.numel() + codesT.shape[1] * float(
        torch.sum(sizes[used])) + float(used.numel() * codesT.shape[2])
        + 4.0 * table.numel() + 4.0 * cell_list.numel() + 8.0 * kd.numel())
    bound = max(ops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
    log(f"B4 timing cells={cell_list.shape[0]} (used {int(live.sum())}) "
        f"qrows={Qc.shape[1]} capp={codesT.shape[2]} rot={rot} k={K}: kernel "
        f"{ms:.3f} ms ({ms / search_ms:.1%} of the {search_ms:.3f} ms "
        f"search), plain {plain_ms:.3f} ms, library (decode + bf16 baddbmm + "
        f"topk over {step}-cell chunks) {lib_ms:.3f} ms, bound {bound:.3f} "
        f"ms; B2 on the bf16 recon cache at the same cells {b2_ms:.3f} ms")
    regs = [line.strip() for line in
            _build.BUILD_LOG.get("pq_scan", "").splitlines()
            if "registers" in line or "spill" in line]
    log(f"B4 plan: {plan.bq} query rows per CTA, "
        f"{'sliced' if plan.sliced else 'resident'} table (slice {plan.ks} "
        f"of rot {plan.kp}), {plan.smem} B of shared memory; device time "
        f"pre-pass {pre_ms} ms + scan {scan_ms} ms (pre-pass share "
        f"{pre_ms / (pre_ms + scan_ms):.1%})" if pre_ms and scan_ms else
        f"B4 plan: {plan}; device times not traced (pre-pass {pre_ms}, "
        f"scan {scan_ms})")
    log(f"B4 ptxas (registers, spills): {regs}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if ops / PEAK_BF16 >= nbytes / PEAK_BYTES
            else "bytes", "library_ms": lib_ms}


def _b3_bounds(d, live, sizes, pair_rows, m, cap):
    """B3's bound (ms, what bounds it) on the work its live rows need, and
    the old bound, which counted every bucket slot and every slab: the bf16
    products of the routed (query, row) pairs, or the bytes of the live
    rows' queries, the valid bf16 rows and the mask of the slabs with a live
    row, and the results. A slab with no live row returns sentinels that
    depend on neither its rows nor its mask."""
    ops = 2.0 * d * pair_rows
    used = live > 0
    out = 8.0 * live.numel() * m * K
    new = (4.0 * d * _total(live) + 2.0 * d * _total(sizes[used])
           + cap * _total(used) + out)
    old = (4.0 * d * live.numel() * m + 2.0 * d * _total(sizes)
           + cap * live.numel() + out)
    bound = max(ops / PEAK_BF16, new / PEAK_BYTES) * 1e3
    by = "operations" if ops / PEAK_BF16 >= new / PEAK_BYTES else "bytes"
    return bound, by, max(ops / PEAK_BF16, old / PEAK_BYTES) * 1e3


def _total(x) -> float:
    """The sum of a tensor's entries, as a float."""
    return float(x.double().sum())


def _b3_library(Qb, db, ynb, invalid, live, step, every_slot=False):
    """B3's library yardstick: bf16 ``baddbmm`` + ``torch.topk`` in chunks
    of ``step`` slabs. With ``every_slot`` it scans all of each bucket's
    slots in slab order; else the slabs, sorted by live rows (most first),
    are gathered chunk by chunk and scanned over their chunk's most live
    rows only. Returns the function to time."""
    import torch

    if every_slot:
        plan = [(slice(s, s + step), Qb.shape[1])
                for s in range(0, Qb.shape[0], step)]
    else:
        order = torch.argsort(live, descending=True, stable=True)
        plan = [(order[s:s + step], int(live[order[s]]))
                for s in range(0, Qb.shape[0], step)]

    def library():
        for idx, rows in plan:
            if rows:
                g = torch.baddbmm(ynb[idx, None, :],
                                  Qb[idx, :rows].to(torch.bfloat16),
                                  db[idx].transpose(1, 2), alpha=-2.0)
                g.masked_fill_(invalid[idx, None, :], float("inf"))
                torch.topk(g, K, dim=2, largest=False)
    return library


def _b3_check(what, args, live, tol):
    """B3 against its plain version on the live rows: per-slot recall@K
    >= RECALL_BF and max |d| error within ``tol``; the other rows (inf, -1)
    in both. Returns the max error and the recall."""
    import torch

    from raft_tpu_torch.ops import fused_knn as fk

    kd, ki = fk._fused_batch_knn_cuda(*args)
    pd, pi = fk._fused_batch_knn_plain(*args)
    err = max_err(kd, pd)
    rows = (torch.arange(kd.shape[1], device=kd.device)[None, :]
            < live[:, None])
    rec = recall(ki[rows], pi[rows])
    dead = bool((ki[~rows] == -1).all()) and bool((pi[~rows] == -1).all())
    log(f"B3 vs plain at {what}: per-slot recall@{K} {rec:.6f} over "
        f"{int(rows.sum())} live rows, max |d| err {err:.3e} (tol "
        f"{tol:.3e}), unscanned rows (inf, -1): {dead}")
    if rec < RECALL_BF or err > tol or not dead:
        raise AssertionError(f"B3 disagrees with its plain version at "
                             f"{what}")
    return err, rec


def b3_entry(dev, index, probes, rotq):
    """Phase 6 for B3 at the recon-tier shape (first N_SUB queries,
    bucket_cap 256, the bf16 reconstruction cache), with the live rows the
    bucket engine passes: held against its plain version, timed at k=10
    and k=1 beside its bound (live rows, and the old count of every bucket
    slot), the plain version and the library call (:func:`_b3_library`,
    over the live rows and over every slot); its plan, the device times of its
    pre-pass and scan, and ptxas' registers and spills for ``batch_knn``.
    Then one decode-scan launch (:func:`decode_block`)."""
    import torch

    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops import fused_knn as fk

    recon = index.reconstructed()
    n_lists, cap, d = recon.shape
    bucket, route = ivf_flat._invert_probe_map(probes, n_lists, BUCKET_CAP)
    Qb = rotq[torch.clamp_min(bucket, 0)].contiguous()
    invalid = (torch.arange(cap, device=dev)[None, :]
               >= index.list_sizes[:, None]).contiguous()
    live = (bucket >= 0).sum(1).to(torch.int32)
    args = (Qb, recon, invalid, K, True, True, False, live)
    lsz, lv = index.list_sizes.float(), live.float()
    log(f"B3 operands: valid rows a list min / median / max "
        f"{int(lsz.min())} / {float(lsz.median()):.0f} / {int(lsz.max())}; "
        f"live rows a bucket min / median / mean / max {int(lv.min())} / "
        f"{float(lv.median()):.0f} / {float(lv.mean()):.2f} / "
        f"{int(lv.max())}")
    yn = torch.sum(recon.float() ** 2, dim=2)
    tol = REL_NORM_TOL * (float(torch.max(torch.sum(Qb ** 2, dim=-1)))
                          + float(torch.max(yn)))
    err, _ = _b3_check("the recon shape", args, live, tol)

    ms = time_ms(lambda: fk._fused_batch_knn_cuda(*args), 5)
    k1 = (Qb, recon, invalid, 1, True, True, False, live)
    k1_ms = time_ms(lambda: fk._fused_batch_knn_cuda(*k1), 5)
    plain_ms = time_ms(lambda: fk._fused_batch_knn_plain(*args), 2)
    pre_ms = device_ms(lambda: fk._fused_batch_knn_cuda(*args),
                       "b2_norms_kernel", reps=5)
    scan_ms = device_ms(lambda: fk._fused_batch_knn_cuda(*args),
                        "b3_scan_kernel", reps=5)
    step = 128
    ynb = yn.to(torch.bfloat16)
    all_ms = time_ms(_b3_library(Qb, recon, ynb, invalid, live, step, True),
                     3)
    lib_ms = time_ms(_b3_library(Qb, recon, ynb, invalid, live, step), 3)
    sizes = index.list_sizes.long()
    pair_rows = _total(sizes[route[0][route[2]].long()])
    bound, by, old = _b3_bounds(d, live, sizes, pair_rows, BUCKET_CAP, cap)
    plan = fk._b3_plan(BUCKET_CAP, d, K, "bf16", "bf16")
    log(f"B3 timing batch={n_lists} m={BUCKET_CAP} ({int(live.sum())} live "
        f"rows) n={cap} d={d} k={K} (bf16 db): kernel {ms:.3f} ms (k=1 "
        f"{k1_ms:.3f} ms), plain {plain_ms:.3f} ms, library (bf16 baddbmm + "
        f"topk in {step}-list chunks) {lib_ms:.3f} ms over the live rows "
        f"(lists sorted by them), {all_ms:.3f} ms over every slot, bound "
        f"{bound:.4f} ms ({by}, live rows; counting every bucket slot's "
        f"query bytes as before: {old:.4f} ms)")
    regs = [line.strip() for line in
            _build.BUILD_LOG.get("batch_knn", "").splitlines()
            if "registers" in line or "spill" in line]
    log(f"B3 plan: path {plan.path}, {plan.bq} query rows per CTA, "
        f"{plan.smem} B of shared memory; device time pre-pass {pre_ms} ms "
        f"+ scan {scan_ms} ms" + (
            f" (pre-pass share {pre_ms / (pre_ms + scan_ms):.1%})"
            if pre_ms and scan_ms else " (not traced)"))
    log(f"B3 ptxas (registers, spills): {regs}")
    decode_block(index, Qb, route, invalid, live)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}


def decode_block(index, Qb, route, invalid, live):
    """B3 at the decode-scan shape: one of its launches, the first block
    of lists (as many as ``ivf_pq._bucketed_decode_scan`` decodes at once)
    with their live rows, held against the plain version and timed at k=10
    and k=1 beside its bound (:func:`_b3_bounds`) and the library
    yardstick of one launch (:func:`_b3_library`, over the live rows and
    over every slot), with the
    device times of its pre-pass and scan."""
    import torch

    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import fused_knn as fk

    n_lists, cap, J = index.pq_codes.shape[0], index.pq_codes.shape[1], \
        index.pq_dim
    d = index.rot_dim
    B, L = 1 << index.pq_bits, d // J
    block = max(1, min(n_lists, ivf_pq._DECODE_BLOCK // (cap * d)))
    block = 1 << (block.bit_length() - 1)
    while n_lists % block and block > 1:
        block //= 2
    recon = ivf_pq._decode_lists_block(
        index.pq_codes[:block], index.centers_rot()[:block],
        index.pq_centers.reshape(-1), J, B, L, index.pq_bits, False)
    lr = live[:block].contiguous()
    args = (Qb[:block].contiguous(), recon, invalid[:block].contiguous(), K,
            True, True, False, lr)
    yn = torch.sum(recon.float() ** 2, dim=2)
    tol = REL_NORM_TOL * (float(torch.max(torch.sum(args[0] ** 2, dim=-1)))
                          + float(torch.max(yn)))
    _b3_check("a decode-scan launch", args, lr, tol)
    ms = time_ms(lambda: fk._fused_batch_knn_cuda(*args), 5)
    k1 = args[:3] + (1,) + args[4:]
    k1_ms = time_ms(lambda: fk._fused_batch_knn_cuda(*k1), 5)
    pre_ms = device_ms(lambda: fk._fused_batch_knn_cuda(*args),
                       "b2_norms_kernel", reps=5)
    scan_ms = device_ms(lambda: fk._fused_batch_knn_cuda(*args),
                        "b3_scan_kernel", reps=5)
    ynb = yn.to(torch.bfloat16)
    all_ms = time_ms(_b3_library(*args[:2], ynb, args[2], lr, block, True),
                     5)
    lib_ms = time_ms(_b3_library(*args[:2], ynb, args[2], lr, block), 5)
    sizes = index.list_sizes.long()
    lists = route[0][route[2]].long()
    pair_rows = _total(sizes[lists[lists < block]])
    bound, by, old = _b3_bounds(d, lr, sizes[:block], pair_rows,
                                BUCKET_CAP, cap)
    log(f"B3 decode-scan launch ({block} of {n_lists} lists, "
        f"{n_lists // block} launches per search; m={BUCKET_CAP} "
        f"({int(lr.sum())} live rows) n={cap} d={d} k={K}, bf16 db): kernel "
        f"{ms:.4f} ms (k=1 {k1_ms:.4f} ms), library (bf16 baddbmm + topk) "
        f"{lib_ms:.4f} ms over the live rows (one chunk cut to its most "
        f"live rows), {all_ms:.4f} ms over every slot, bound "
        f"{bound:.4f} ms ({by}, live rows; every slot: {old:.4f} ms); "
        f"device time pre-pass {pre_ms} ms + scan {scan_ms} ms")


def same_bits(a, b) -> bool:
    """Equal shapes and bits, NaN where NaN (a selection has no rounding,
    so kernel and plain version must agree exactly, the sign of a zero
    included; a NaN's payload may differ)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    an, bn = torch.isnan(a), torch.isnan(b)
    ints = {torch.float32: torch.int32, torch.float16: torch.int16,
            torch.bfloat16: torch.int16}[a.dtype]
    return torch.equal(an, bn) and torch.equal(
        a.masked_fill(an, 0).view(ints), b.masked_fill(bn, 0).view(ints))


def max_err_nan(a, b) -> float:
    """:func:`max_err` over the entries that are not NaN; the NaN patterns
    must agree."""
    import torch

    an, bn = torch.isnan(a), torch.isnan(b)
    if not torch.equal(an, bn):
        raise AssertionError("NaN patterns differ")
    return max_err(a.masked_fill(an, 0), b.masked_fill(bn, 0))


def check_b5_candidates(x, what: str) -> float:
    """B5 against its plain version on the card keys ``x``: positions
    equal, values bit for bit. Returns the values' max_err_nan."""
    import torch

    from raft_tpu_torch.ops import stream_select as ss

    kv, ki = ss._stream_extract_cuda(x)
    pv, pi = ss._stream_extract_plain(x)
    torch.cuda.synchronize()
    if not (same_bits(kv, pv) and torch.equal(ki, pi)):
        raise AssertionError(f"B5 {what} {tuple(x.shape)}: kernel "
                             f"candidates != plain")
    return max_err_nan(kv, pv)


def b5_keys(rng, kind):
    """Phase-3 keys for B5: (16, 24576), or (13, 100000), ragged in both
    axes. ``ties`` puts 9 keys (in 9 lanes) at one value in the first half
    of the sub-chunks and 33 in the rest, so the kernel takes its survivor
    list and its eight passes; ``zeros`` mixes -0 and +0 among the
    extracts."""
    if kind == "ragged":
        return rng.standard_normal((13, 100_000)).astype(np.float32)
    x = rng.standard_normal((16, 24576)).astype(np.float32)
    if kind == "ties":
        x = 5 + rng.random(x.shape).astype(np.float32)
        subs = x.reshape(16, 48, 512)
        lanes = np.arange(32) + 32 * (np.arange(32) % 4)
        subs[:, :24, lanes[:9]] = 1.0
        subs[:, 24:, lanes] = 1.0
        subs[:, 24:, 511] = 1.0
    elif kind == "zeros":
        x[rng.random(x.shape) < 0.01] = 0.0
        x[rng.random(x.shape) < 0.01] = -0.0
    elif kind == "int_ties":
        x = rng.integers(0, 3, x.shape).astype(np.float32)
    elif kind == "sorted":
        x[:5] = np.sort(x[:5], axis=1)
        x[5:9] = np.sort(x[5:9], axis=1)[:, ::-1]
    elif kind == "constant":
        x[:] = 2.5
    elif kind == "inf_heavy":
        x[0, :5000] = -np.inf
        x[1, 1000:] = np.inf
        x[2] = np.inf
    elif kind == "nan":
        x[3, 100] = np.nan
        x[7, 8000:8003] = np.nan
    return x


def check_kernel_b5(dev) -> float:
    """Phase 3 for B5: candidates against the plain version on the card,
    bit for bit; then select_k(kStream) on the card against the plain
    path on the CPU and kTopK on the card, values and ids bit for bit.
    Returns the candidates' largest max_err_nan."""
    import torch

    from raft_tpu_torch.matrix.select_k import SelectMethod, select_k

    rng = np.random.default_rng(SEED + 2)
    err = 0.0
    for kind in ("gauss", "int_ties", "sorted", "constant", "inf_heavy",
                 "nan", "ragged", "ties", "zeros"):
        x = torch.as_tensor(b5_keys(rng, kind))
        err = max(err, check_b5_candidates(x.to(dev), kind))
        # One float into its storage: the rows leave 16 bytes, so the
        # kernel takes its 4-byte loads.
        buf = torch.empty(x.numel() + 1, device=dev)
        err = max(err, check_b5_candidates(buf[1:].view(x.shape).copy_(x),
                                           kind + " (4-byte loads)"))
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            # One cast, then a copy: the CPU casts NaN to bf16 as a negative
            # NaN and the card as a positive one.
            xt = x.to(dtype)
            xtd = xt.to(dev)
            for select_min in (True, False):
                v, i = select_k(xtd, B5_K, select_min,
                                method=SelectMethod.kStream)
                pv2, pi2 = select_k(xt, B5_K, select_min,
                                    method=SelectMethod.kStream)
                tv, ti = select_k(xtd, B5_K, select_min,
                                  method=SelectMethod.kTopK)
                for rv, ri, what in ((pv2, pi2, "plain path on the CPU"),
                                     (tv, ti, "kTopK")):
                    if not (torch.equal(i.cpu(), ri.cpu())
                            and same_bits(v.cpu(), rv.cpu())):
                        raise AssertionError(
                            f"kStream {kind} {dtype} select_min="
                            f"{select_min}: != {what}")
        log(f"B5 ok {kind} {tuple(x.shape)} (candidates bit-identical; "
            f"kStream k={B5_K} f32/bf16/f16, min/max = plain path = kTopK)")
    return err


def select_phase(dev, b5_err: float):
    """Phase 7: select_k through kAuto at bench.py's shapes and the gate's
    corners, with the counters set to 0 before and read after; then B5's
    candidates against its plain version and the audit at every gated
    shape, and the timings. Returns B5's kernels-line entry, whose
    max_abs_err is the largest over these shapes and ``b5_err`` (phase
    3's)."""
    import torch

    from raft_tpu_torch.matrix import select_k as sk
    from raft_tpu_torch.matrix.select_k import SelectMethod, select_k
    from raft_tpu_torch.ops import stream_select as ss

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    keys = [torch.randn((b, nn), generator=gen, device=dev)
            for b, nn, _ in SELECT_SHAPES]
    _zero_counters()
    torch.cuda.synchronize()
    per_call = []
    for (b, nn, k), x in zip(SELECT_SHAPES, keys):
        before = ss.stream_extract.launches
        v, i = select_k(x, k)
        torch.cuda.synchronize()
        per_call.append(ss.stream_extract.launches - before)
        gated = sk._stream_supported(b, nn, k, x.dtype, x.device)
        tv, ti = select_k(x, k, method=SelectMethod.kTopK)
        if not (torch.equal(i, ti) and torch.equal(v, tv)):
            raise AssertionError(f"kAuto select {b}x{nn} k={k} != kTopK")
        if per_call[-1] != int(gated):
            raise AssertionError(f"kAuto select {b}x{nn} k={k}: "
                                 f"{per_call[-1]} B5 launches, expected "
                                 f"{int(gated)}")
    launches = _launches()
    log(f"select path: B5 launches per call {per_call} "
        f"(shapes {SELECT_SHAPES}), all equal to kTopK; counters {launches}")
    if launches["stream_extract"] != 3:
        raise AssertionError("B5 did not launch once per gated call")

    # The audit sends a row whose candidates look short to the exact sort,
    # so equality with kTopK alone cannot show that B5's candidates made
    # the answer: hold them against the plain version, and require that
    # the audit flags no row of these Gaussian keys.
    for (b, nn, k), x in zip(SELECT_SHAPES, keys):
        if not sk._stream_supported(b, nn, k, x.dtype, x.device):
            continue
        b5_err = max(b5_err, check_b5_candidates(x, "select path"))
        cand_v, _ = ss._stream_extract_cuda(x)
        n_flagged = int(sk._audit_failures(
            cand_v, sk.stable_top_k(cand_v, k)[0]).sum())
        log(f"select {b}x{nn} k={k}: B5 candidates = plain version, "
            f"audit flags {n_flagged} of {b} rows")
        if n_flagged:
            raise AssertionError(f"kStream audit flagged {n_flagged} rows "
                                 f"of Gaussian keys at {b}x{nn} k={k}")

    entry = None
    for (b, nn, k), x in zip(SELECT_SHAPES, keys):
        auto_ms = time_ms(lambda: select_k(x, k), 5)
        sort_ms = time_ms(lambda: select_k(x, k, method=SelectMethod.kTopK),
                          5)
        lib_ms = time_ms(lambda: torch.topk(x, k, largest=False), 5)
        line = (f"select {b}x{nn} k={k}: kAuto {auto_ms:.3f} ms, kTopK "
                f"(stable sort) {sort_ms:.3f} ms, torch.topk {lib_ms:.3f} ms")
        if sk._stream_supported(b, nn, k, x.dtype, x.device):
            b5_ms = time_ms(lambda: ss._stream_extract_cuda(x), 10)
            dev_ms = device_ms(lambda: ss._stream_extract_cuda(x),
                               "stream_extract_kernel")
            host_ms = host_enqueue_ms(lambda: ss._stream_extract_cuda(x))
            nbytes = 4.0 * b * nn + 8.0 * b * ss.n_candidates(nn)
            bound = nbytes / PEAK_BYTES * 1e3
            dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
            line += (f", B5 alone {b5_ms:.4f} ms by CUDA events (device "
                     f"time by torch.profiler {dev_txt}; wrapper host time "
                     f"{host_ms:.4f} ms a call; bound {bound:.4f} ms, "
                     f"bytes), kStream - B5 = rank + audit "
                     f"{auto_ms - b5_ms:.3f} ms")
            if (b, nn, k) == SELECT_SHAPES[0]:
                plain_ms = time_ms(lambda: ss._stream_extract_plain(x), 3)
                line += f", B5 plain version {plain_ms:.3f} ms"
                entry = {"max_abs_err": b5_err, "ms": b5_ms,
                         "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": "bytes",
                         "library_ms": lib_ms}
        log(line)
    entry["launches"] = launches["stream_extract"]
    return entry


def serve_stream(X, rng, repeat_frac):
    """bench/serve.py's request stream (``_request_stream``,
    bench/serve.py:38-50): SERVE_REQUESTS requests of 1-SERVE_MAX_ROWS
    rows, k uniform over SERVE_K_GRID, a ``repeat_frac`` share of exact
    repeats; each query is a database row plus N(0, 1), as ``make_data``
    makes them. Returns ``[(float32 numpy queries, k)]``."""
    import torch

    plan = []
    for _ in range(SERVE_REQUESTS):
        if plan and rng.random() < repeat_frac:
            plan.append(plan[rng.integers(0, len(plan))])
        else:
            n = int(rng.integers(1, SERVE_MAX_ROWS + 1))
            k = int(SERVE_K_GRID[rng.integers(0, len(SERVE_K_GRID))])
            plan.append((len(plan), rng.integers(0, N_ROWS, n),
                         rng.standard_normal((n, DIM), dtype=np.float32), k))
    fresh = [p for i, p in enumerate(plan) if p[0] == i]
    rows = X[torch.as_tensor(np.concatenate([p[1] for p in fresh]),
                             device=X.device)].cpu().numpy()
    made, at = {}, 0
    for i, r, noise, k in fresh:
        made[i] = (rows[at:at + r.size] + noise, k)
        at += r.size
    return [made[p[0]] for p in plan]


def _stacked(results, k):
    """The first ``k`` ids and distances of every row of ``results``."""
    return (np.concatenate([r.indices[:, :k] for r in results]),
            np.concatenate([r.distances[:, :k] for r in results]))


def _latency_ms(stats, q):
    """Quantile ``q`` over every request's latency window of ``stats``."""
    lat = np.concatenate([np.asarray(w) for w in stats._latency.values()])
    return float(np.quantile(lat, q)) * 1e3


# The kernel each served drive holds against its plain version on the
# operands of one full batch per k: (module, launcher, plain version,
# index of k among the launcher's arguments). Brute force's kept batch
# must also be a whole SERVE_MAX_BATCH rows.
SERVE_KERNELS = {
    "brute_force": ("fused_knn", "_fused_knn_cuda", "_fused_knn_plain", 2),
    "ivf_flat": ("fused_knn", "_fused_cells_knn_cuda",
                 "_fused_cells_knn_plain", 4),
    "ivf_pq": ("pq_scan", "_pq_fused_scan_cuda", "_pq_fused_scan_plain", 6),
}


class _Capture:
    """Within the ``with`` block, keeps the operands and the answer of the
    first launch of ``SERVE_KERNELS[name]``'s launcher for each k (of
    ``full`` query rows when given): the call's own operands and what the
    kernel gave it. The launcher still counts its launch; the wrapper
    launches nothing."""

    def __init__(self, name, full=None):
        import importlib

        mod, self.attr, self.plain, self.k_at = SERVE_KERNELS[name]
        self.mod = importlib.import_module(f"raft_tpu_torch.ops.{mod}")
        self.name = name
        self.full = full
        self.calls = {}

    def __enter__(self):
        launch = self.orig = getattr(self.mod, self.attr)

        def kept(*args):
            out = launch(*args)
            k = args[self.k_at]
            if k not in self.calls and (self.full is None
                                        or args[0].shape[0] == self.full):
                self.calls[k] = (args, tuple(o.clone() for o in out))
            return out

        setattr(self.mod, self.attr, kept)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.orig)


def _recall_rows(found, truth, chunk=4096) -> float:
    """:func:`recall` over row chunks (k=100 rows of a whole batch's cells
    would make one (rows, k, k) comparison of gigabytes)."""
    hits = sum(recall(found[s:s + chunk], truth[s:s + chunk])
               * found[s:s + chunk].shape[0]
               for s in range(0, found.shape[0], chunk))
    return hits / found.shape[0]


def b4_tol(qc, lo, hi) -> float:
    """B4's distance tolerance on its operands (phase 5): REL_NORM_TOL of
    the largest query residual's squared norm plus the codeword table's
    largest squared entries."""
    import torch

    table = torch.cat([lo[0], hi[0]], dim=1)
    return REL_NORM_TOL * (float(torch.max(torch.sum(qc ** 2, dim=-1)))
                           + float(torch.sum(torch.amax(table ** 2, dim=1))))


def serve_batch_checks(name, cap):
    """Holds each kept served batch's kernel answer against the plain
    version on the same operands: ids by per-slot recall@k >= RECALL_BF,
    distances within REL_NORM_TOL of the operands' largest squared norms,
    as the phase-5 and phase-6 entries do. One batch per k of
    SERVE_K_GRID must have been kept."""
    import torch

    if sorted(cap.calls) != sorted(SERVE_K_GRID):
        raise AssertionError(f"serve {name}: full served batches kept for "
                             f"k {sorted(cap.calls)}, not {SERVE_K_GRID}")
    plain = getattr(cap.mod, cap.plain)
    for k, (args, (kd, ki)) in sorted(cap.calls.items()):
        pd, pi = plain(*args)
        if name == "ivf_pq":
            tol = b4_tol(args[1], args[3], args[4])
        else:
            tol = norm_tol(args[1] if name == "ivf_flat" else args[0],
                           args[2] if name == "ivf_flat" else args[1])
        if name == "brute_force":
            rows = f"{args[0].shape[0]} rows x {args[1].shape[0]} db rows"
            rec = _recall_rows(ki, pi)
        else:
            live = args[0] >= 0
            rows = (f"{int(live.sum())} live cells x {args[1].shape[1]} "
                    f"rows")
            rec = _recall_rows(ki[live].reshape(-1, k),
                               pi[live].reshape(-1, k))
        err = max_err(kd, pd)
        log(f"serve {name}: served batch k={k} ({rows}) vs plain: per-slot "
            f"recall@{k} {rec:.6f} (bar {RECALL_BF}), max |d| err "
            f"{err:.3e} (tol {tol:.3e})")
        if rec < RECALL_BF or err > tol:
            raise AssertionError(f"serve {name}: the served batch's kernel "
                                 f"answer disagrees with its plain version "
                                 f"at k={k}")


def serve_drives(name, searcher, reqs, reqs_rep, tol, card):
    """Step 3 of the serve phase for one Searcher: the per-request drive
    and the closed-loop batched drive of ``reqs`` (both under one
    CompileCounter, which must read 0; the closed loop keeps one full
    batch per k for :func:`serve_batch_checks`), then the cache run of
    ``reqs_rep``. Returns the answers of both drives, the near-tie count
    and the launches of each drive."""
    import torch

    from raft_tpu_torch.serve import (BatchPolicy, BatchScheduler,
                                      BucketGrid, CompileCounter,
                                      ResultCache)

    grid = BucketGrid.pow2(SERVE_MAX_BATCH, k_grid=SERVE_K_GRID)
    policy = BatchPolicy(max_batch=SERVE_MAX_BATCH, max_wait=0.0,
                         max_queue=2 * SERVE_REQUESTS)
    rows = sum(q.shape[0] for q, _ in reqs)
    sched = BatchScheduler(searcher, grid, policy)
    torch.cuda.synchronize()
    with CompileCounter() as counter:
        before = _launches()
        t0 = time.perf_counter()
        per = [searcher.search(q, k) for q, k in reqs]
        per_s = time.perf_counter() - t0
        per_launches = _step(before)
        before = _launches()
        with _Capture(name, SERVE_MAX_BATCH if name == "brute_force"
                      else None) as cap:
            t0 = time.perf_counter()
            tickets = [sched.submit(q, k) for q, k in reqs]
            sched.run_until_idle()
            served_s = time.perf_counter() - t0
        served_launches = _step(before)
    served = [t.result() for t in tickets]
    snap = sched.stats.snapshot()["buckets"]
    padded = sum(b["padded_slots"] for b in snap.values())
    batched = sum(b["batched_rows"] for b in snap.values())
    batches = sum(b["batches"] for b in snap.values())
    if counter.count:
        raise AssertionError(f"serve {name}: {counter.count} kernel builds "
                             f"or loads in steady state")
    serve_batch_checks(name, cap)
    for a, b in zip(per, served):
        if a.indices.shape != b.indices.shape or not (
                np.isfinite(a.distances).all()
                and np.isfinite(b.distances).all()):
            raise AssertionError(f"serve {name}: answers not finite (q, k)")
    ties = None
    if name != "ivf_pq":
        # Ids may differ only at near-ties: where the two distances lie
        # within tol of each other.
        ties = 0
        for a, b in zip(per, served):
            diff = a.indices != b.indices
            err = np.abs(a.distances - b.distances)
            if err.max() > tol:
                raise AssertionError(f"serve {name}: served distances "
                                     f"differ by {err.max()} > {tol}")
            ties += int(diff.sum())

    cached = BatchScheduler(searcher, grid, policy,
                            cache=ResultCache(capacity=4096))
    for q, k in reqs_rep:
        cached.submit(q, k)
        cached.flush()
    hit = cached.cache.snapshot()["hit_rate"]
    open_p50 = _latency_ms(cached.stats, 0.5)
    open_p99 = _latency_ms(cached.stats, 0.99)
    log(f"serve {name} [{card}]: per-request {rows / per_s:.1f} QPS "
        f"({per_s:.3f} s, launches {per_launches}); served (closed loop, "
        f"max_batch {SERVE_MAX_BATCH}) {rows / served_s:.1f} QPS "
        f"({served_s:.3f} s, {batches} batches, launches {served_launches}),"
        f" queueing p50 {_latency_ms(sched.stats, 0.5):.3f} ms / p99 "
        f"{_latency_ms(sched.stats, 0.99):.3f} ms (all submitted at once), "
        f"padded waste {100.0 * padded / max(1, padded + batched):.2f}%; "
        f"{SERVE_REPEAT:.0%}-repeat open-loop stream: cache hit rate "
        f"{hit:.4f}, latency p50 {open_p50:.3f} ms / p99 {open_p99:.3f} ms"
        + ("" if ties is None else
           f"; served ids = per-request ids but {ties} near-tie slots "
           f"(tol {tol:.3e})"))
    return {"per": per, "served": served, "ties": ties,
            "per_launches": per_launches,
            "served_launches": served_launches}


def serve_phase(dev, X, card, flat, pq, pq_recall):
    """The serve phase, steps 1-3 (module docstring, phase 8) on phase 4's
    and phase 6's indexes and a brute-force Searcher over ``X``. Returns
    the launches of the phase."""
    import torch

    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
    from raft_tpu_torch.serve import BucketGrid, Searcher, warmup

    searchers = {
        "brute_force": Searcher.brute_force(X),
        "ivf_flat": Searcher.ivf_flat(flat, ivf_flat.SearchParams(
            n_probes=N_PROBES)),
        "ivf_pq": Searcher.ivf_pq(pq, ivf_pq.SearchParams(
            n_probes=N_PROBES)),
    }
    grid = BucketGrid.pow2(SERVE_MAX_BATCH, k_grid=SERVE_K_GRID)
    _zero_counters()
    torch.cuda.synchronize()
    for name, s in searchers.items():
        t0 = time.perf_counter()
        first = warmup(s, grid, degrade_ladder=SERVE_LADDER)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        second = warmup(s, grid, degrade_ladder=SERVE_LADDER)
        log(f"serve {name} warmup [{card}]: {first_s:.3f} s, report {first}; "
            f"second warmup compile_events {second['compile_events']}")
        if second["compile_events"]:
            raise AssertionError(f"serve {name}: the second warmup built or "
                                 f"loaded a kernel")
    warm = _launches()

    rng = np.random.default_rng(SEED)
    reqs = serve_stream(X, rng, 0.0)
    reqs_rep = serve_stream(X, rng, SERVE_REPEAT)
    qmax = max(float(np.max(np.sum(q * q, axis=1))) for q, _ in reqs)
    ymax = float(torch.max(torch.sum(X * X, dim=1)))
    tol = REL_NORM_TOL * (qmax + ymax)
    out = {name: serve_drives(name, s, reqs, reqs_rep, tol, card)
           for name, s in searchers.items()}

    truth, _ = _stacked(out["brute_force"]["per"], K)
    truth = torch.as_tensor(truth)
    rec = {}
    for name in ("ivf_flat", "ivf_pq"):
        for drive in ("per", "served"):
            ids, _ = _stacked(out[name][drive], K)
            rec[name, drive] = recall(torch.as_tensor(ids), truth)
    pq_diff = float(np.mean(np.concatenate(
        [(a.indices != b.indices).ravel() for a, b in zip(
            out["ivf_pq"]["per"], out["ivf_pq"]["served"])])))
    log(f"serve recall@{K} against the brute-force answers: IVF-Flat "
        f"per-request {rec['ivf_flat', 'per']:.6f}, served "
        f"{rec['ivf_flat', 'served']:.6f} (bar {RECALL_IVF}); IVF-PQ "
        f"per-request {rec['ivf_pq', 'per']:.6f}, served "
        f"{rec['ivf_pq', 'served']:.6f} (phase 6: {pq_recall:.6f}, bar "
        f"+-{PQ_TIER_GAP}); IVF-PQ ids differing served vs per-request: "
        f"{pq_diff:.4%}")
    if rec["ivf_flat", "served"] < RECALL_IVF:
        raise AssertionError("served IVF-Flat recall below its bar")
    if any(abs(rec["ivf_pq", d] - pq_recall) > PQ_TIER_GAP
           for d in ("per", "served")):
        raise AssertionError("IVF-PQ serve recall off phase 6's")
    if (out["brute_force"]["per_launches"]["fused_knn"] < SERVE_REQUESTS
            or out["brute_force"]["served_launches"]["fused_knn"] < 1
            or out["ivf_flat"]["served_launches"]["fused_cells_knn"] < 1
            or out["ivf_pq"]["served_launches"]["pq_fused_scan"] < 1):
        raise AssertionError("a kernel of the serve path did not launch")
    total = _launches()
    log(f"serve launches: warmup {warm}, whole phase {total}")
    serve_engine_mix(X, searchers, reqs, card)
    return total


def serve_engine_mix(X, searchers, reqs, card):
    """Where a per-request search spends its time, after the serve phase's
    counted drives: at 16 and 32 rows (k=10) each IVF entry point's auto
    engine (the plain-torch scan; the kernel gate wants 256 rows at 32 /
    1024 probes) against the kernel engine forced with engine="bucketed"
    (B2 / B4), and brute force's whole ``knn`` against B1 alone and its
    ``expects_finite`` pass over the database. Medians by CUDA events."""
    import dataclasses

    import torch

    from raft_tpu_torch.core.error import expects_finite
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
    from raft_tpu_torch.ops import fused_knn as fk

    q = torch.as_tensor(np.concatenate([r for r, _ in reqs])[:32],
                        device=X.device)
    for rows in (16, 32):
        qq = q[:rows].contiguous()
        line = []
        for name, mod in (("ivf_flat", ivf_flat), ("ivf_pq", ivf_pq)):
            s = searchers[name]
            sp = s._params
            forced = dataclasses.replace(sp, engine="bucketed")
            auto_ms = time_ms(lambda: mod.search(sp, s._index, qq, K), 5)
            kern_ms = time_ms(lambda: mod.search(forced, s._index, qq, K), 5)
            line.append(f"{name} auto (scan) {auto_ms:.3f} ms, bucketed "
                        f"({'B2' if name == 'ivf_flat' else 'B4'}) "
                        f"{kern_ms:.3f} ms")
        db = searchers["brute_force"]._db
        whole = time_ms(lambda: searchers["brute_force"]._dispatch(
            qq, K, None), 5)
        b1 = time_ms(lambda: fk._fused_knn_cuda(qq, db, K, True, False,
                                                False), 5)
        fin = time_ms(lambda: expects_finite("db", db), 5)
        log(f"serve engine mix at {rows} rows, k={K} [{card}]: "
            + "; ".join(line) + f"; brute force knn {whole:.3f} ms (B1 "
            f"alone {b1:.3f} ms, expects_finite over the db {fin:.3f} ms)")


def serve_mutations(dev, Q, index, card):
    """The serve phase, step 4 (module docstring, phase 10): delete and
    compact under a serving Searcher over the lifecycle phase's compacted
    IVF-Flat index. Returns the launches of the step and the index the
    Searcher serves after it."""
    import torch

    from raft_tpu_torch.lifecycle import Compactor
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serve import (BatchPolicy, BatchScheduler,
                                      BucketGrid, ResultCache, Searcher)

    s = Searcher.ivf_flat(index, ivf_flat.SearchParams(n_probes=N_PROBES))
    sched = BatchScheduler(
        s, BucketGrid.pow2(SERVE_MAX_BATCH, k_grid=SERVE_K_GRID),
        BatchPolicy(max_batch=SERVE_MAX_BATCH, max_wait=0.0),
        cache=ResultCache(capacity=4096))
    Qh = Q[:N_SUB].cpu().numpy()
    _zero_counters()
    torch.cuda.synchronize()
    for i in range(0, N_SUB, 20):
        sched.submit(Qh[i:i + 20], K)
    sched.flush()
    filled = len(sched.cache)
    slot = torch.arange(index.indices.shape[1], device=dev)
    live = slot[None, :] < index.list_sizes[:, None]
    if index.deleted is not None:
        live &= ~index.deleted
    ids = index.indices[live].cpu().numpy()
    dels = np.random.default_rng(SEED + 4).choice(ids, N_DELETE,
                                                  replace=False)
    e0 = s.epoch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = s.delete(dels)
    torch.cuda.synchronize()
    delete_ms = (time.perf_counter() - t0) * 1e3
    if got != N_DELETE or s.epoch != e0 + 1 or len(sched.cache):
        raise AssertionError(f"Searcher.delete: {got} tombstoned, epoch "
                             f"{e0} -> {s.epoch}, cache {len(sched.cache)}")
    tomb = s.search(Q, K)
    tickets = [sched.submit(Qh[i:i + 20], K) for i in range(0, N_SUB, 20)]
    sched.flush()
    served = np.concatenate([t.result().indices for t in tickets])
    if np.isin(tomb.indices, dels).any() or np.isin(served, dels).any():
        raise AssertionError("a deleted id was returned after "
                             "Searcher.delete")
    n_tomb = s._index.n_deleted
    t0 = time.perf_counter()
    rep = Compactor(s).run_once(force=True)
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    after = s.search(Q, K)
    if (rep is None or rep.reclaimed_slots != n_tomb
            or s.epoch != e0 + 2 or s.tombstone_frac != 0.0):
        raise AssertionError(f"Compactor report {rep}, epoch {s.epoch}")
    if not np.array_equal(after.indices, tomb.indices):
        raise AssertionError("compacted ids differ from the tombstoned ones")
    launches = _launches()
    log(f"serve mutations [{card}]: cache held {filled} answers, emptied by "
        f"the delete; Searcher.delete of {N_DELETE} ids {delete_ms:.3f} ms "
        f"(epoch {e0} -> {e0 + 1}), no deleted id returned ({Q.shape[0]} "
        f"queries searched, {N_SUB} served); Compactor.run_once(force=True) "
        f"{compact_s:.3f} s, {rep.reclaimed_slots} slots reclaimed, ids "
        f"identical to the tombstoned search's; launches {launches}")
    if launches["fused_cells_knn"] < 2:
        raise AssertionError("the searches after delete did not launch B2")
    return launches, s._index


def lifecycle_phase(dev, X, Q, bf, flat, pq, flat_ms, pq_ms, pq_recall):
    """Phase 9: multi-part knn, delete, compact and upsert on the 1M
    indexes, with the counters set to 0 before and read after each step.
    Returns the launches of the phase and the compacted, upserted
    indexes by name."""
    import torch

    from raft_tpu_torch import lifecycle as lc
    from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq

    bf_d, bf_i = bf
    _zero_counters()
    torch.cuda.synchronize()
    steps = {}

    before = _launches()
    part = N_ROWS // N_PARTS
    t0 = time.perf_counter()
    md, mi = brute_force.knn([X[s:s + part] for s in range(0, N_ROWS, part)],
                             Q, K)
    torch.cuda.synchronize()
    mp_s = time.perf_counter() - t0
    steps["multipart_knn"] = _step(before)
    if not (torch.equal(mi, bf_i) and torch.equal(md, bf_d)):
        raise AssertionError("multi-part knn != single-part brute force")
    log(f"multi-part knn over {N_PARTS} parts of {part}: {mp_s:.3f} s, ids "
        f"and distances equal to single-part brute force")

    rng = np.random.default_rng(SEED + 3)
    dels = torch.as_tensor(rng.choice(N_ROWS, N_DELETE, replace=False),
                           device=dev)
    delete_ms = {}
    for name, index in (("ivf_flat", flat), ("ivf_pq", pq)):
        before = _launches()
        e0 = index.epoch
        t0 = time.perf_counter()
        got = lc.delete(index, dels)
        torch.cuda.synchronize()
        delete_ms[name] = (time.perf_counter() - t0) * 1e3
        steps[f"delete_{name}"] = _step(before)
        if got != N_DELETE or index.epoch != e0 + 1:
            raise AssertionError(f"{name}: delete tombstoned {got}, epoch "
                                 f"{e0} -> {index.epoch}")
    is_del = torch.zeros(N_ROWS, dtype=torch.bool, device=dev)
    is_del[dels] = True
    surv = torch.nonzero(~is_del)[:, 0]
    _, si = brute_force.knn(X[surv], Q, K)
    truth = surv[si.long()].to(torch.int32)

    sp = ivf_flat.SearchParams(n_probes=N_PROBES)
    spq = ivf_pq.SearchParams(n_probes=N_PROBES)
    before = _launches()
    fd, fi = ivf_flat.search(sp, flat, Q, K)
    pd, pi = ivf_pq.search(spq, pq, Q, K)
    torch.cuda.synchronize()
    steps["tombstoned_search"] = _step(before)
    rec_f, rec_p = recall(fi, truth), recall(pi, truth)
    for name, ids in (("IVF-Flat", fi), ("IVF-PQ", pi)):
        if bool(torch.isin(ids, dels.to(ids.dtype)).any()):
            raise AssertionError(f"{name} returned a deleted id")
    log(f"delete {N_DELETE} ids: IVF-Flat {delete_ms['ivf_flat']:.3f} ms, "
        f"IVF-PQ {delete_ms['ivf_pq']:.3f} ms; no deleted id returned; "
        f"recall@{K} over the survivors: IVF-Flat {rec_f:.6f} (bar "
        f"{RECALL_IVF}), IVF-PQ {rec_p:.6f} (before the delete "
        f"{pq_recall:.6f}, bar +-{PQ_TIER_GAP})")
    if rec_f < RECALL_IVF or abs(rec_p - pq_recall) > PQ_TIER_GAP:
        raise AssertionError("recall after the delete out of bounds")
    tomb_ms = {"ivf_flat": time_ms(lambda: ivf_flat.search(sp, flat, Q, K),
                                   5),
               "ivf_pq": time_ms(lambda: ivf_pq.search(spq, pq, Q, K), 5)}

    compacted, compact_s, after_ms, caps = {}, {}, {}, {}
    for name, index, search, params, ids in (
            ("ivf_flat", flat, ivf_flat.search, sp, fi),
            ("ivf_pq", pq, ivf_pq.search, spq, pi)):
        before = _launches()
        t0 = time.perf_counter()
        new, rep = lc.compact(index)
        torch.cuda.synchronize()
        compact_s[name] = time.perf_counter() - t0
        _, ci = search(params, new, Q, K)
        if rep.reclaimed_slots != N_DELETE or new.epoch != index.epoch + 1:
            raise AssertionError(f"{name}: compaction report {rep}")
        if not torch.equal(ci, ids):
            raise AssertionError(f"{name}: ids after compact() differ from "
                                 f"the tombstoned search's")
        shrunk, srep = lc.compact(new, lc.CompactionPolicy(
            shrink_capacity=True))
        _, si2 = search(params, shrunk, Q, K)
        torch.cuda.synchronize()
        steps[f"compact_{name}"] = _step(before)
        caps[name] = (srep.cap_before, srep.cap_after,
                      torch.equal(si2, ids))
        compacted[name] = shrunk
        after_ms[name] = time_ms(lambda: search(params, new, Q, K), 5)
        del new
    log(f"compact: IVF-Flat {compact_s['ivf_flat']:.3f} s, IVF-PQ "
        f"{compact_s['ivf_pq']:.3f} s, search ids identical to the "
        f"tombstoned search's; shrink_capacity (cap before, after, ids "
        f"unchanged): {caps}")
    for name, base_ms in (("ivf_flat", flat_ms), ("ivf_pq", pq_ms)):
        log(f"{name} QPS ({N_QUERIES} queries, {N_PROBES} probes): before "
            f"the delete {N_QUERIES / base_ms * 1e3:.1f} ({base_ms:.3f} ms), "
            f"tombstoned {N_QUERIES / tomb_ms[name] * 1e3:.1f} "
            f"({tomb_ms[name]:.3f} ms), compacted "
            f"{N_QUERIES / after_ms[name] * 1e3:.1f} ({after_ms[name]:.3f} "
            f"ms)")

    up = torch.cat([dels[:N_UPSERT // 2], surv[:N_UPSERT // 2]])
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    vecs = X[up] + 0.5 * torch.randn((up.shape[0], DIM), generator=gen,
                                     device=dev)
    for name, module, params in (("ivf_flat", ivf_flat, sp),
                                 ("ivf_pq", ivf_pq, spq)):
        index = compacted[name]
        before = _launches()
        e0 = index.epoch
        index = compacted[name] = lc.upsert(index, vecs, up)
        torch.cuda.synchronize()
        steps[f"upsert_{name}"] = _step(before)
        _, ui = module.search(params, index, vecs, 1)
        self_hit = float((ui[:, 0] == up.to(ui.dtype)).float().mean())
        log(f"upsert {up.shape[0]} rows into {name}: epoch {e0} -> "
            f"{index.epoch}, top-1 is the upserted id for {self_hit:.4f}")
        if index.epoch != e0 + 1:
            raise AssertionError(f"{name}: upsert bumped the epoch "
                                 f"{index.epoch - e0} times")
    log(f"lifecycle launches per step: {steps}")
    if (steps["multipart_knn"]["fused_knn"] < N_PARTS
            or steps["tombstoned_search"]["fused_cells_knn"] < 1
            or steps["tombstoned_search"]["pq_fused_scan"] < 1):
        raise AssertionError(f"a kernel of the lifecycle path did not "
                             f"launch: {steps}")
    return ({k: sum(st[k] for st in steps.values())
             for k in steps["multipart_knn"]}, compacted)


def _live_ids(index):
    """The ids of an IVF index's live slots (below the fill line, not
    tombstoned)."""
    import torch

    slot = torch.arange(index.indices.shape[1], device=index.indices.device)
    live = slot[None, :] < index.list_sizes[:, None]
    if index.deleted is not None:
        live &= ~index.deleted
    return index.indices[live]


def _saved_bytes(index) -> int:
    """Bytes of the arrays ``save`` writes for an IVF index."""
    names = ("centers", "data", "rotation_matrix", "pq_centers", "pq_codes",
             "indices", "list_sizes", "deleted")
    return sum(t.numel() * t.element_size()
               for t in (getattr(index, f, None) for f in names)
               if t is not None)


def _same_npz(a_path, b_path) -> bool:
    """Two npz files hold the same keys, dtypes and arrays."""
    with np.load(a_path) as a, np.load(b_path) as b:
        if sorted(a.files) != sorted(b.files):
            return False
        for f in a.files:
            x, y = a[f], b[f]           # each access reads the file
            if x.dtype != y.dtype or not np.array_equal(x, y):
                return False
        return True


def persistence_step(dev, Q, indexes, card):
    """Phase 11 (a): delete, save, load and search both IVF indexes.
    Returns the launches of the step."""
    import os
    import shutil
    import tempfile

    import torch

    from raft_tpu_torch import lifecycle as lc
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    mods = {"ivf_flat": ivf_flat, "ivf_pq": ivf_pq}
    kernels = {"ivf_flat": "fused_cells_knn", "ivf_pq": "pq_fused_scan"}
    rng = np.random.default_rng(SEED + 5)
    dels = {}
    for name, index in indexes.items():
        dels[name] = rng.choice(_live_ids(index).cpu().numpy(),
                                N_DELETE_MORE, replace=False)
        got = lc.delete(index, dels[name])
        if got != N_DELETE_MORE:
            raise AssertionError(f"{name}: delete tombstoned {got} of "
                                 f"{N_DELETE_MORE}")
    need = 2 * sum(_saved_bytes(i) for i in indexes.values())
    with tempfile.TemporaryDirectory() as tmp:
        free = shutil.disk_usage(tmp).free
        if free < need + (1 << 30):
            raise AssertionError(
                f"the temporary directory {tmp} has {free} bytes free; the "
                f"saves need {need} and 1 GiB to spare: point TMPDIR at a "
                f"larger disk")
        for name, index in indexes.items():
            mod = mods[name]
            sp = mod.SearchParams(n_probes=N_PROBES)
            path = os.path.join(tmp, name)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.save(path, index)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = mod.load(path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            if loaded.centers.device.type != dev.type \
                    or loaded.n_deleted != index.n_deleted:
                raise AssertionError(f"{name}: the loaded index is on "
                                     f"{loaded.centers.device} with "
                                     f"{loaded.n_deleted} tombstones")
            before = _launches()
            d0, i0 = mod.search(sp, index, Q, K)
            d1, i1 = mod.search(sp, loaded, Q, K)
            torch.cuda.synchronize()
            step = _step(before)
            if step[kernels[name]] < 2:
                raise AssertionError(f"{name}: {kernels[name]} did not "
                                     f"launch on both indexes: {step}")
            if not (torch.equal(i0, i1) and torch.equal(d0, d1)):
                raise AssertionError(f"{name}: the loaded index searches "
                                     f"differently from the saved one")
            if np.isin(i1.cpu().numpy(), dels[name]).any():
                raise AssertionError(f"{name}: a deleted id came back "
                                     f"after the load")
            ms = time_ms(lambda: mod.search(sp, loaded, Q, K), reps=3)
            mod.save(path + "_again", loaded)
            if not _same_npz(path + ".npz", path + "_again.npz"):
                raise AssertionError(f"{name}: a save of the loaded index "
                                     f"holds other arrays")
            nbytes = os.path.getsize(path + ".npz")
            os.remove(path + ".npz")
            os.remove(path + "_again.npz")
            log(f"persistence {name} [{card}]: file {nbytes} bytes (cap "
                f"{index.indices.shape[1]}, {index.n_deleted} tombstones), "
                f"save {save_s:.3f} s, load {load_s:.3f} s; search after "
                f"the load {ms:.3f} ms per {Q.shape[0]} queries, ids and "
                f"distances bit for bit the saved index's, no deleted id; "
                f"a second save holds the same arrays; launches {step}")
    return _launches()


def int64_step(dev, X, Q, bf, flat4, pq_recall, card):
    """Phase 11 (b): int64 ids through brute force, both IVF builds, a
    widened copy of phase 4's index, upsert + compact and a Searcher."""
    import torch

    from raft_tpu_torch import lifecycle as lc
    from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
    from raft_tpu_torch.serve import Searcher

    bf_d, bf_i = bf
    steps = {}
    before = _launches()
    part = N_ROWS // N_PARTS
    d, i = brute_force.knn([X[s:s + part] for s in range(0, N_ROWS, part)],
                           Q, K, idx_dtype=torch.int64,
                           global_id_offset=ID_BASE_BF)
    steps["brute_force"] = _step(before)
    if not (i.dtype == torch.int64 and torch.equal(i - ID_BASE_BF,
                                                   bf_i.long())
            and torch.equal(d, bf_d)):
        raise AssertionError("int64 multi-part knn != phase 4's ids + 2^32")

    ids = ID_BASE_IVF + torch.arange(N_ROWS, dtype=torch.int64, device=dev)
    truth = bf_i.long() + ID_BASE_IVF
    sp = ivf_flat.SearchParams(n_probes=N_PROBES)
    spq = ivf_pq.SearchParams(n_probes=N_PROBES)
    built, rec, build_s = {}, {}, {}
    for name, mod, params in (
            ("ivf_flat", ivf_flat, sp), ("ivf_pq", ivf_pq, spq)):
        before = _launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = mod.build(mod.IndexParams(
            n_lists=N_LISTS, idx_dtype=torch.int64,
            add_data_on_build=False), X)
        index = mod.extend(index, X, ids)
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - t0
        _, fi = mod.search(params, index, Q, K)
        steps[f"build_search_{name}"] = _step(before)
        if fi.dtype != torch.int64 or int(fi[fi >= 0].min()) < ID_BASE_IVF:
            raise AssertionError(f"{name}: int64 ids lost: {fi.dtype}")
        built[name], rec[name] = index, recall(fi, truth)
    log(f"int64 [{card}]: multi-part knn ids = phase 4's + 2^32; builds "
        f"with ids 2^33 + arange({N_ROWS}): IVF-Flat "
        f"{build_s['ivf_flat']:.3f} s "
        f"recall@{K} {rec['ivf_flat']:.6f} (bar {RECALL_IVF}), IVF-PQ "
        f"{build_s['ivf_pq']:.3f} s recall@{K} {rec['ivf_pq']:.6f} (phase "
        f"6: {pq_recall:.6f}, bar +-{PQ_TIER_GAP})")
    if rec["ivf_flat"] < RECALL_IVF \
            or abs(rec["ivf_pq"] - pq_recall) > PQ_TIER_GAP:
        raise AssertionError("int64 build recall out of bounds")

    # The widened copy: phase 4's index (with phase 9's tombstones) with
    # every id + 2^33, through index_from_numpy; B2 is deterministic.
    ind = flat4.indices.cpu().numpy()
    wide = ivf_flat.index_from_numpy(
        flat4.centers.cpu().numpy(), flat4.data.cpu().numpy(),
        np.where(ind >= 0, ind.astype(np.int64) + ID_BASE_IVF, -1),
        flat4.list_sizes.cpu().numpy(), flat4.metric,
        deleted=(None if flat4.deleted is None
                 else flat4.deleted.cpu().numpy()), device=dev)
    before = _launches()
    _, ni = ivf_flat.search(sp, flat4, Q, K)
    _, wi = ivf_flat.search(sp, wide, Q, K)
    steps["widened_copy"] = _step(before)
    if not torch.equal(wi, torch.where(ni >= 0, ni.long() + ID_BASE_IVF,
                                       -1)):
        raise AssertionError("the widened copy's ids != phase 4's + 2^33")
    del wide

    flat = built["ivf_flat"]
    half = N_UPSERT // 2
    up = torch.cat([ids[:2 * half:2],
                    ID_BASE_IVF + N_ROWS + torch.arange(half, device=dev)])
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    rows = torch.arange(0, 2 * half, 2, device=dev).repeat(2)
    vecs = X[rows] + 0.5 * torch.randn((up.shape[0], DIM), generator=gen,
                                       device=dev)
    before = _launches()
    e0 = flat.epoch
    flat = lc.upsert(flat, vecs, up)
    new, rep = lc.compact(flat)
    steps["upsert_compact"] = _step(before)
    live = _live_ids(new)
    if (new.indices.dtype != torch.int64 or int(live.min()) < ID_BASE_IVF
            or not bool(torch.isin(up, live).all())
            or rep.reclaimed_slots != half or new.epoch != e0 + 2):
        raise AssertionError(f"int64 upsert + compact: {rep}, ids "
                             f"{new.indices.dtype}, min live "
                             f"{int(live.min())}")

    s = Searcher.ivf_flat(new, sp)
    reqs = serve_stream(X, np.random.default_rng(SEED + 6),
                        0.0)[:N_SERVE_INT64]
    before = _launches()
    for q, k in reqs:
        res = s.search(q, k)
        _, ci = ivf_flat.search(sp, new, torch.as_tensor(q, device=dev), k)
        if res.indices.dtype != np.int64 \
                or not np.array_equal(res.indices, ci.cpu().numpy()):
            raise AssertionError("the int64 Searcher's ids differ from the "
                                 "per-call search's")
    steps["serve"] = _step(before)
    log(f"int64 [{card}]: widened copy of phase 4's index ids = its own + "
        f"2^33; upsert of {up.shape[0]} rows ({half} new ids from 2^33 + "
        f"{N_ROWS}) and compact ({rep.reclaimed_slots} reclaimed) keep int64 "
        f"ids >= 2^33; "
        f"{len(reqs)} requests through a Searcher equal the per-call "
        f"search; launches per step {steps}")
    if steps["brute_force"]["fused_knn"] < N_PARTS \
            or steps["widened_copy"]["fused_cells_knn"] < 2 \
            or steps["build_search_ivf_pq"]["pq_fused_scan"] < 1:
        raise AssertionError(f"a kernel of the int64 steps did not launch: "
                             f"{steps}")
    return _launches()


def _f64_dist(q, y, metric: str):
    """(a, b) float64 distances between the rows of ``q`` and ``y`` for
    the metric searches, in plain torch on the card (100 queries against
    1M rows would take minutes in numpy on the host)."""
    import torch

    q, y = q.double(), y.double()
    if metric == "l1":
        return torch.cdist(q, y, p=1.0)
    if metric == "linf":
        return torch.cdist(q, y, p=float("inf"))
    if metric == "canberra":
        out = torch.empty((q.shape[0], y.shape[0]), dtype=torch.float64,
                          device=q.device)
        step = max(1, (1 << 24) // (q.shape[0] * q.shape[1]))
        for s in range(0, y.shape[0], step):
            yb = y[None, s:s + step]
            den = q.abs()[:, None] + yb.abs()
            num = (q[:, None] - yb).abs()
            out[:, s:s + step] = torch.where(
                den > 0, num / torch.where(den > 0, den, 1.0), 0.0).sum(-1)
        return out
    if metric == "correlation":
        q = q - q.mean(dim=1, keepdim=True)
        y = y - y.mean(dim=1, keepdim=True)
    qn = q / q.norm(dim=1, keepdim=True)
    yn = y / y.norm(dim=1, keepdim=True)
    return 1.0 - qn @ yn.T


def metric_search_step(dev, X, Q, card):
    """Phase 11 (c): brute-force kNN by five more metrics at full width,
    held on N_METRIC_CHECK queries against a float64 search. Returns the
    per-metric seconds."""
    import torch

    from raft_tpu_torch.neighbors import brute_force

    Qm = Q[:N_METRIC_QUERIES]
    Qc = Q[:N_METRIC_CHECK]
    secs = {}
    for metric in METRIC_SEARCH:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, i = brute_force.knn(X, Qm, K, metric=metric)
        torch.cuda.synchronize()
        secs[metric] = time.perf_counter() - t0
        exact = _f64_dist(Qc, X, metric)
        ref_d, ref_i = torch.topk(exact, K, dim=1, largest=False)
        found = torch.gather(exact, 1, i[:N_METRIC_CHECK].long())
        tol = METRIC_RTOL * torch.clamp_min(found.abs(), 1.0)
        kth = ref_d[:, -1:]
        hit = (torch.isin(i[:N_METRIC_CHECK].long(), ref_i)
               | (found <= kth + METRIC_RTOL * torch.clamp_min(kth, 1.0)))
        rec = float(hit.double().mean())
        excess = float(torch.max((d[:N_METRIC_CHECK].double() - found).abs()
                                 - tol))
        err = float(torch.max((d[:N_METRIC_CHECK].double() - found).abs()))
        n_ties = int((hit & ~torch.isin(i[:N_METRIC_CHECK].long(),
                                        ref_i)).sum())
        log(f"metric {metric} [{card}]: {Qm.shape[0]} queries x {N_ROWS} "
            f"rows, k={K}: {secs[metric]:.3f} s; on {N_METRIC_CHECK} "
            f"queries against float64: recall@{K} {rec:.6f} (bar "
            f"{RECALL_BF}, {n_ties} near-tie hits), max |d - d64| {err:.3e} "
            f"(tol {METRIC_RTOL} x max(1, |d64|))")
        if rec < RECALL_BF or excess > 0:
            raise AssertionError(f"metric {metric}: the search disagrees "
                                 f"with float64")
    return secs


def _np_f64(x, y, metric, p):
    """float64 numpy distances of ``pairwise_distance``'s metrics, written
    from their definitions, a block of rows of x at a time."""
    from raft_tpu_torch.distance.distance_types import DistanceType as M

    x, y = x.astype(np.float64), y.astype(np.float64)
    k = x.shape[1]
    if metric == M.Haversine:
        dlat = x[:, None, 0] - y[None, :, 0]
        dlon = x[:, None, 1] - y[None, :, 1]
        a = (np.sin(dlat / 2) ** 2 + np.cos(x[:, None, 0])
             * np.cos(y[None, :, 0]) * np.sin(dlon / 2) ** 2)
        return 2 * np.arcsin(np.sqrt(a))
    xx, yy = (x * x).sum(1), (y * y).sum(1)
    g = x @ y.T
    # In float64 the expanded square of the L2 family cancels ~1e-13 of it.
    l2 = np.maximum(xx[:, None] + yy[None] - 2 * g, 0)
    gram_based = {
        M.L2Expanded: lambda: l2, M.L2Unexpanded: lambda: l2,
        M.L2SqrtExpanded: lambda: np.sqrt(l2),
        M.L2SqrtUnexpanded: lambda: np.sqrt(l2),
        M.InnerProduct: lambda: g,
        M.CosineExpanded: lambda: 1 - g / np.sqrt(np.outer(xx, yy)),
        M.CorrelationExpanded: lambda: 1 - np.corrcoef(x, y)[
            :x.shape[0], x.shape[0]:],
        M.HellingerExpanded: lambda: np.sqrt(np.maximum(
            1 - np.sqrt(x) @ np.sqrt(y).T, 0)),
        M.RusselRaoExpanded: lambda: (k - g) / k,
        M.JaccardExpanded: lambda: 1 - g / (xx[:, None] + yy[None] - g),
        M.DiceExpanded: lambda: 1 - 2 * g / (xx[:, None] + yy[None]),
    }
    if metric in gram_based:
        return gram_based[metric]()
    out = np.empty((x.shape[0], y.shape[0]))
    for s in range(0, x.shape[0], 50):
        a, b = x[s:s + 50, None], y[None]
        diff = np.abs(a - b)
        if metric == M.L1:
            r = diff.sum(-1)
        elif metric == M.Linf:
            r = diff.max(-1)
        elif metric == M.LpUnexpanded:
            r = (diff ** p).sum(-1) ** (1 / p)
        elif metric == M.Canberra:
            r = (diff / (np.abs(a) + np.abs(b))).sum(-1)
        elif metric == M.BrayCurtis:
            r = diff.sum(-1) / np.abs(a + b).sum(-1)
        elif metric == M.HammingUnexpanded:
            r = (a != b).mean(-1)
        elif metric == M.KLDivergence:
            r = 0.5 * (a * np.log(a / b)).sum(-1)
        elif metric == M.JensenShannon:
            m = (a + b) / 2
            r = np.sqrt(0.5 * (a * np.log(a / m) + b * np.log(b / m))
                        .sum(-1))
        else:
            raise AssertionError(f"no float64 reference for {metric!r}")
        out[s:s + 50] = r
    return out


def pairwise_step(dev, card):
    """Phase 11 (c), second half: ``pairwise_distance`` for every metric
    at N_PAIRWISE x N_PAIRWISE against float64 numpy on the host."""
    import torch

    from raft_tpu_torch.distance.distance_types import DistanceType as M
    from raft_tpu_torch.distance.pairwise import pairwise_distance

    rng = np.random.default_rng(SEED + 7)
    gx = rng.standard_normal((N_PAIRWISE, DIM)).astype(np.float32)
    gy = rng.standard_normal((N_PAIRWISE, DIM)).astype(np.float32)
    px, py = (np.abs(a) + 1e-3 for a in (gx, gy))
    px, py = px / px.sum(1, keepdims=True), py / py.sum(1, keepdims=True)
    hx, hy = (rng.uniform(-1.5, 1.5, (N_PAIRWISE, 2)).astype(np.float32)
              for _ in range(2))
    worst = {}
    t0 = time.perf_counter()
    for metric in (m for m in M if m != M.Precomputed):
        x, y = ((px, py) if metric in (M.HellingerExpanded, M.KLDivergence,
                                       M.JensenShannon)
                else (hx, hy) if metric == M.Haversine else (gx, gy))
        got = pairwise_distance(torch.as_tensor(x, device=dev),
                                torch.as_tensor(y, device=dev),
                                metric=metric, p=3.0).cpu().numpy()
        want = _np_f64(x, y, metric, 3.0)
        err = float(np.max(np.abs(got - want)))
        scale = max(1.0, float(np.max(np.abs(want))))
        worst[metric.name] = err / scale
        if not np.isfinite(got).all() or err > METRIC_RTOL * scale:
            raise AssertionError(f"pairwise {metric.name}: max err {err:.3e}"
                                 f" against float64 (scale {scale:.3e})")
    log(f"pairwise_distance [{card}]: all {len(worst)} metrics at "
        f"{N_PAIRWISE} x {N_PAIRWISE} within {METRIC_RTOL} x max(1, |d64|) "
        f"of float64 numpy ({time.perf_counter() - t0:.3f} s with the "
        f"references); worst relative error "
        f"{max(worst.values()):.3e} ({max(worst, key=worst.get)})")


def surface_phase(dev, X, Q, bf, flat4, flat10, pq9, pq_recall, card):
    """Phase 11: persistence, int64 ids and the metrics, with the
    counters set to 0 before it. Returns the launches of the phase."""
    import torch

    _zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    persistence_step(dev, Q, {"ivf_flat": flat10, "ivf_pq": pq9}, card)
    int64_step(dev, X, Q, bf, flat4, pq_recall, card)
    metric_search_step(dev, X, Q, card)
    pairwise_step(dev, card)
    launches = _launches()
    log(f"phase 11: {time.perf_counter() - t0:.3f} s, launches {launches}")
    return launches


def _canonical(d, i):
    """Each row's (distance, id) pairs in lexicographic order: the merge
    orders exact distance ties by id, a single-card engine by slot."""
    import torch

    by_id = torch.argsort(i, dim=1, stable=True)
    d1, i1 = torch.gather(d, 1, by_id), torch.gather(i, 1, by_id)
    order = torch.argsort(d1, dim=1, stable=True)
    return torch.gather(d1, 1, order), torch.gather(i1, 1, order)


def same_up_to_exact_ties(what, d, i, ref_d, ref_i) -> int:
    """Distances bit for bit and ids equal once exact distance ties are
    put in id order. Returns how many rows differ before that."""
    import torch

    if not torch.equal(d, ref_d):
        raise AssertionError(f"{what}: distances differ from the reference")
    cd, ci = _canonical(d, i.long())
    rd, ri = _canonical(ref_d, ref_i.long())
    if not torch.equal(ci, ri):
        raise AssertionError(f"{what}: ids differ beyond exact ties")
    return int((i.long() != ref_i.long()).any(dim=1).sum())


def near_tie_check(what, d, i, ref_d, ref_i, X, Q, tol) -> int:
    """Ids equal to the reference's but at near-ties: every distance
    within ``tol`` of the reference's at its slot, and every id that
    differs is a row at its reported distance (recomputed) within
    ``tol``. Returns the number of differing slots."""
    import torch

    err = max_err(d, ref_d)
    if err > tol:
        raise AssertionError(f"{what}: distance off the reference by {err}")
    diff = i.long() != ref_i.long()
    rows, cols = torch.nonzero(diff, as_tuple=True)
    if rows.numel():
        ids = i.long()[rows, cols]
        if bool((ids < 0).any()):
            raise AssertionError(f"{what}: a padding id where the reference "
                                 "has a row")
        true = torch.sum((Q[rows] - X[ids]) ** 2, dim=1)
        off = float(torch.max(torch.abs(true - d[rows, cols])))
        if off > tol:
            raise AssertionError(f"{what}: a differing id is not at its "
                                 f"reported distance ({off} > {tol})")
    return int(diff.sum())


def sharded_world_of_one(dev, X, Q, bf, iv, centers, card):
    """Phase 12 (a): sharded brute force and IVF-Flat over a NCCL world
    of one in this process; both must be phase 4's answers. Returns the
    launches of the step."""
    import tempfile

    import torch
    import torch.distributed as dist

    from raft_tpu_torch import parallel
    from raft_tpu_torch.neighbors import ivf_flat

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            mesh = parallel.make_mesh(device=dev)
            _zero_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d, i = parallel.sharded_knn(mesh, X, Q, K)
            torch.cuda.synchronize()
            bf_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            index = parallel.sharded_ivf_flat_build(
                mesh, ivf_flat.IndexParams(n_lists=N_LISTS), X,
                centers=centers)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            d2, i2 = parallel.sharded_ivf_flat_search(
                mesh, ivf_flat.SearchParams(n_probes=N_PROBES), index, Q, K)
            torch.cuda.synchronize()
            search_s = time.perf_counter() - t0
            launches = _launches()
        finally:
            dist.destroy_process_group()
    rows_bf = same_up_to_exact_ties("world of one, brute force", d, i, *bf)
    rows_iv = same_up_to_exact_ties("world of one, IVF-Flat", d2, i2, *iv)
    log(f"sharded world of one (NCCL) [{card}]: brute force {bf_s:.3f} s, "
        f"IVF-Flat build (phase 4's centers) {build_s:.3f} s, search "
        f"{search_s:.3f} s; distances bit for bit with phase 4's, ids too "
        f"up to the order of exact ties (rows reordered: brute force "
        f"{rows_bf}, IVF-Flat {rows_iv}); launches {launches}")
    if launches["fused_knn"] < 1 or launches["fused_cells_knn"] < 1:
        raise AssertionError(f"world of one: B1 / B2 not launched "
                             f"({launches})")
    return launches


class _RankRecorder:
    """One rank's bookkeeping in a sharded phase: its answers (sent home
    by rank 0, digested by every rank), wall times, and rank 0's kept
    kernel launches (:class:`_Capture`)."""

    def __init__(self, rank, dev):
        self.rank, self.dev = rank, dev
        self.out, self.ms, self.caps = {}, {}, {}

    def sync(self):
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(self, name, fn, reps=1):
        """``fn()`` ``reps`` times: the wall ms of the first call and the
        median of the others; the last answer."""
        times = []
        for _ in range(reps):
            self.sync()
            t0 = time.perf_counter()
            res = fn()
            self.sync()
            times.append((time.perf_counter() - t0) * 1e3)
        self.ms[name] = times[0]
        if reps > 1:
            self.ms[name + "_steady"] = float(np.median(times[1:]))
        return res

    def keep(self, name, res):
        self.out[name] = tuple(np.asarray(t.cpu() if hasattr(t, "cpu")
                                          else t) for t in res)

    def capture(self, tag, name):
        """Rank 0 keeps the block's first launch per k of
        ``SERVE_KERNELS[name]`` for :func:`rank_plain_checks`."""
        if self.rank != 0:
            return contextlib.nullcontext()
        self.caps[tag] = _Capture(name)
        return self.caps[tag]

    def result(self, launches, **extra):
        import hashlib

        digests = {k: hashlib.sha256(b"".join(a.tobytes() for a in v))
                   .hexdigest() for k, v in self.out.items()}
        return dict(launches=launches, ms=self.ms, digests=digests,
                    out=self.out if self.rank == 0 else None,
                    plain=(rank_plain_checks(self.caps) if self.rank == 0
                           else None), **extra)


def _rank_work(rank, data_dir, cfg):
    """Phase 12 (b) on one rank: every merge engine of sharded brute
    force, IVF-Flat built on phase 4's centers and with train_distributed,
    degraded serving with DEAD_RANK dead, and the survivors' 3-rank
    search on the same engines. Rank 0 returns the answers, every rank
    its digests, wall times and launches."""
    import torch

    from raft_tpu_torch import parallel
    from raft_tpu_torch.comms.comms import Comms
    from raft_tpu_torch.neighbors import ivf_flat

    dev = torch.device(cfg["device"])
    k, n_lists, n_ranks, dead = (cfg["k"], cfg["n_lists"], cfg["n_ranks"],
                                 cfg["dead"])
    X = np.load(f"{data_dir}/X.npy", mmap_mode="c")
    Q = torch.as_tensor(np.load(f"{data_dir}/Q.npy"), device=dev)
    centers = torch.as_tensor(np.load(f"{data_dir}/centers.npy"),
                              device=dev)
    mesh = parallel.make_mesh(device=dev)
    shard = parallel.shard_database(mesh, X)
    sp = ivf_flat.SearchParams(n_probes=cfg["n_probes"])
    params = ivf_flat.IndexParams(n_lists=n_lists)
    rec = _RankRecorder(rank, dev)
    timed, keep, capture = rec.timed, rec.keep, rec.capture

    _zero_counters()
    # The first call loads the libraries and warms the allocator.
    with capture("B1 on the shard", "brute_force"):
        parallel.sharded_knn(mesh, shard, Q, k)
    for engine in SHARD_ENGINES:
        keep(f"bf_{engine}", timed(
            f"bf_{engine}", lambda: parallel.sharded_knn(
                mesh, shard, Q, k, merge_engine=engine), reps=3))
    index = timed("ivf_build", lambda: parallel.sharded_ivf_flat_build(
        mesh, params, shard, centers=centers))
    with capture("B2 on the rank's list slices", "ivf_flat"):
        keep("ivf", timed(
            "ivf_search", lambda: parallel.sharded_ivf_flat_search(
                mesh, sp, index, Q, k), reps=3))
    with capture("B1 k-means assignment in train_distributed",
                 "brute_force"):
        dist_index = timed(
            "dist_build", lambda: parallel.sharded_ivf_flat_build(
                mesh, ivf_flat.IndexParams(n_lists=n_lists,
                                           kmeans_n_iters=20),
                shard, train_distributed=True))
    keep("dist_ivf", timed("dist_search",
                           lambda: parallel.sharded_ivf_flat_search(
                               mesh, sp, dist_index, Q, k), reps=3))
    del dist_index
    live = np.ones(n_ranks, bool)
    live[dead] = False
    # The degraded searches and the survivors' run the same engines, so
    # each live rank launches the same kernels on the same operands.
    keep("bf_degraded", timed("bf_degraded", lambda: parallel.sharded_knn(
        mesh, shard, Q, k, merge_engine="ring", live_mask=live)))
    keep("ivf_degraded", timed(
        "ivf_degraded", lambda: parallel.sharded_ivf_flat_search(
            mesh, sp, index, Q, k, merge_engine="pipelined",
            live_mask=live)))
    launches = _launches()
    sub = Comms(mesh).comm_split(0 if rank != dead else 1)
    if rank != dead:
        m3 = sub.mesh
        rows = X[:X.shape[0] // n_ranks * (n_ranks - 1)]
        keep("bf_survivors", parallel.sharded_knn(m3, rows, Q, k,
                                                  merge_engine="ring"))
        index3 = parallel.sharded_ivf_flat_build(m3, params, rows,
                                                 centers=centers)
        keep("ivf_survivors", parallel.sharded_ivf_flat_search(
            m3, sp, index3, Q, k, merge_engine="pipelined"))
    return rec.result(launches)


def rank_plain_checks(caps):
    """Each launch a rank kept (:class:`_Capture`) against its plain
    version on the same operands, at the phase-5 tolerances: ids by
    per-slot recall@k (the arg-min agreement at k=1), distances within
    :func:`norm_tol` of the operands. Returns ``(what, shape, recall,
    max |d| err, tol)`` per launch; the parent holds them to the bars."""
    rows = []
    for tag, cap in caps.items():
        if not cap.calls:
            raise AssertionError(f"{tag}: no launch kept")
        plain = getattr(cap.mod, cap.plain)
        for k, (args, (kd, ki)) in sorted(cap.calls.items()):
            pd, pi = plain(*args)
            if cap.name in ("ivf_flat", "ivf_pq"):
                live = args[0] >= 0
                shape = (f"{int(live.sum())} live cells x "
                         f"{args[1].shape[1]} rows")
                rec = _recall_rows(ki[live].reshape(-1, k),
                                   pi[live].reshape(-1, k))
                tol = (b4_tol(args[1], args[3], args[4])
                       if cap.name == "ivf_pq" else norm_tol(args[1],
                                                             args[2]))
            else:
                shape = f"{args[0].shape[0]} x {args[1].shape[0]} rows"
                rec = _recall_rows(ki, pi)
                tol = norm_tol(args[0], args[1])
            rows.append((f"{tag}, k={k}", shape, rec, max_err(kd, pd), tol))
    return rows


def _sharded_rank(rank, data_dir, init, cfg, results) -> None:
    """One rank of the gloo world: joins it, works, reports (the error
    text on failure), leaves."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        if cfg["device"].startswith("cuda"):
            torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=cfg["n_ranks"])
        p12 = _rank_work(rank, data_dir, cfg)
        if cfg["device"].startswith("cuda"):
            torch.cuda.empty_cache()
        p13 = _rank_work_routed(rank, data_dir, cfg)
        if cfg["device"].startswith("cuda"):
            torch.cuda.empty_cache()
        p14 = _rank_work_ops(rank, data_dir, cfg)
        if cfg["device"].startswith("cuda"):
            torch.cuda.empty_cache()
        results.put((rank, {"p12": p12, "p13": p13, "p14": p14,
                            "p15": _rank_work_durable(rank, data_dir, cfg)}))
    except Exception:
        results.put((rank, {"error": traceback.format_exc()}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(dev, X, Q, centers, model, stream):
    """The 4-rank gloo world on the one card, which runs phases 12 (b),
    13 (b), 14 (b) and 15 (b) in turn: X, Q, phase 4's centers, phase 6's
    IVF-PQ model and the request stream of phases 14 and 15 go to a
    temporary directory once.
    Returns each rank's results and the wall seconds with the spawn. A
    rank that raises, or ends without answering, fails the phases at
    once; RANKS_TIMEOUT bounds the wait."""
    import multiprocessing as mp
    import queue
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        np.save(f"{tmp}/X.npy", X.cpu().numpy())
        np.save(f"{tmp}/Q.npy", Q.cpu().numpy())
        np.save(f"{tmp}/centers.npy", centers.cpu().numpy())
        for name in ("centers", "rotation_matrix", "pq_centers"):
            np.save(f"{tmp}/pq_{name}.npy",
                    getattr(model, name).cpu().numpy())
        np.savez(f"{tmp}/stream.npz",
                 q=np.concatenate([q for q, _ in stream]),
                 rows=np.asarray([q.shape[0] for q, _ in stream]),
                 k=np.asarray([k for _, k in stream]))
        cfg = dict(device=str(dev), k=K, n_lists=N_LISTS,
                   n_probes=N_PROBES, n_ranks=N_RANKS, dead=DEAD_RANK,
                   pq_bits=model.pq_bits, pq_dim=model.pq_dim,
                   pq_metric=model.metric.value, seed=SEED)
        ctx = mp.get_context("spawn")
        results = ctx.Queue()
        procs = [ctx.Process(target=_sharded_rank,
                             args=(r, tmp, f"file://{tmp}/store", cfg,
                                   results))
                 for r in range(N_RANKS)]
        for p in procs:
            p.start()
        got = {}
        try:
            # A rank that fails leaves the others waiting in a collective:
            # its error, or its end without an answer, ends the wait.
            while len(got) < N_RANKS and not any("error" in v
                                                 for v in got.values()):
                try:
                    rank, res = results.get(timeout=5)
                    got[rank] = res
                except queue.Empty:
                    gone = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if gone or time.perf_counter() - t0 > RANKS_TIMEOUT:
                        missing = sorted(set(range(N_RANKS)) - set(got))
                        raise AssertionError(
                            f"phases 12-15: ranks {missing} did not answer "
                            f"(ended: {gone}; {time.perf_counter() - t0:.0f}"
                            f" s of {RANKS_TIMEOUT} s)")
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.terminate()
                    p.join()
        wall = time.perf_counter() - t0
    errors = [f"rank {r}:\n{res['error']}" for r, res in sorted(got.items())
              if "error" in res]
    if errors:
        raise AssertionError("phases 12-15 rank failed:\n"
                             + "\n".join(errors))
    return got, wall


def sharded_ranks(dev, X, Q, bf, iv, centers, got, wall, card):
    """Phase 12 (b)'s checks of the 4 ranks' results. Returns the ranks'
    launches, summed."""
    import torch

    from raft_tpu_torch.neighbors import ivf_flat

    got = {r: res["p12"] for r, res in got.items()}
    for r in range(1, N_RANKS):
        for key, digest in got[r]["digests"].items():
            if digest != got[0]["digests"].get(key):
                raise AssertionError(f"phase 12: rank {r}'s {key} differs "
                                     "from rank 0's")
    kept = got[0]["plain"]
    if len(kept) != 3:
        raise AssertionError(f"phase 12: rank 0 kept {len(kept)} kernel "
                             "launches, not B1 k=10, B1 k=1 and B2")
    for what, shape, rec, err, tol in kept:
        log(f"4 ranks, rank 0's {what} ({shape}) vs plain: per-slot "
            f"recall {rec:.6f} (bar {RECALL_BF}), max |d| err {err:.3e} "
            f"(tol {tol:.3e})")
        if rec < RECALL_BF or err > tol:
            raise AssertionError(f"phase 12: rank 0's {what} disagrees "
                                 "with its plain version")
    out = {k: tuple(torch.as_tensor(a, device=dev) for a in v)
           for k, v in got[0]["out"].items()}
    tol = norm_tol(Q, X)
    for engine in SHARD_ENGINES:
        d, i = out[f"bf_{engine}"]
        n_diff = near_tie_check(f"4 ranks, brute force, {engine}", d, i,
                                *bf, X, Q, tol)
        same = (torch.equal(d, out["bf_allgather"][0])
                and torch.equal(i, out["bf_allgather"][1]))
        log(f"4 ranks, brute force, {engine}: ids = phase 4's but "
            f"{n_diff} near-tie slots (tol {tol:.3e}); bit for bit with "
            f"allgather: {same}")
    n_diff = near_tie_check("4 ranks, IVF-Flat", *out["ivf"], *iv, X, Q, tol)
    log(f"4 ranks, IVF-Flat on phase 4's centers: ids = phase 4's but "
        f"{n_diff} near-tie slots")
    rec = recall(out["dist_ivf"][1], bf[1])
    log(f"4 ranks, IVF-Flat train_distributed ({N_LISTS} lists, 20 "
        f"iterations): recall@{K} {rec:.6f} against brute force at "
        f"{N_PROBES} probes (bar {RECALL_DIST})")
    if rec < RECALL_DIST:
        raise AssertionError(f"train_distributed recall {rec} < "
                             f"{RECALL_DIST}")
    for kind in ("bf", "ivf"):
        d, i, cov = out[f"{kind}_degraded"]
        sd, si = out[f"{kind}_survivors"]
        if not (torch.equal(d, sd) and torch.equal(i, si)):
            raise AssertionError(f"degraded {kind} != the survivors' "
                                 "3-rank search")
    cov_bf = out["bf_degraded"][2]
    if not bool((cov_bf == 0.75).all()):
        raise AssertionError("degraded brute-force coverage != 0.75")
    # The IVF coverage, recomputed: probed rows on the live ranks over
    # all probed rows, from the lists' members.
    labels = kmeans_labels(centers, X)
    live_rows = torch.arange(X.shape[0], device=dev) < (
        X.shape[0] // N_RANKS * (N_RANKS - 1))
    all_l = torch.bincount(labels, minlength=N_LISTS).float()
    live_l = torch.bincount(labels[live_rows], minlength=N_LISTS).float()
    probes = ivf_flat._coarse_probe(Q, centers, N_PROBES, True).long()
    want = live_l[probes].sum(1) / all_l[probes].sum(1)
    cov_iv = out["ivf_degraded"][2]
    cov_err = float(torch.max(torch.abs(cov_iv - want)))
    if cov_err > 1e-6:
        raise AssertionError(f"degraded IVF coverage off by {cov_err}")
    ms = {k: max(got[r]["ms"][k] for r in got) for k in got[0]["ms"]}
    launches = {k: sum(got[r]["launches"][k] for r in got)
                for k in got[0]["launches"]}
    log(f"4 ranks, degraded (rank {DEAD_RANK} dead): brute force and "
        f"IVF-Flat = the survivors' 3-rank search bit for bit; coverage "
        f"brute force 0.75, IVF-Flat mean {float(cov_iv.mean()):.6f} "
        f"(recomputed, max err {cov_err:.1e})")
    log(f"4 ranks [{card}]: wall ms (slowest rank; first call, and the "
        f"median of 2 more where _steady) "
        + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
    log(f"4 ranks: launches per rank "
        f"{[got[r]['launches'] for r in range(N_RANKS)]}; phases 12 (b) "
        f"and 13 (b) wall {wall:.1f} s with the spawn")
    if launches["fused_knn"] < N_RANKS or launches["fused_cells_knn"] < \
            N_RANKS:
        raise AssertionError(f"4 ranks: B1 / B2 not launched on every "
                             f"rank ({launches})")
    return launches


def tie_check(what, d, i, ref_d, ref_i, tol) -> int:
    """Ids equal to the reference's but at near-ties, for scores that
    cannot be recomputed from the rows (IVF-PQ's): every distance within
    ``tol`` of the reference's at its slot, and every id that differs is
    in the reference's row or at the reference's k-th distance within
    ``tol``. Returns the number of differing slots."""
    import torch

    err = max_err(d, ref_d)
    if err > tol:
        raise AssertionError(f"{what}: distance off the reference by {err}")
    il, ril = i.long(), ref_i.long()
    diff = il != ril
    member = (il[:, :, None] == ril[:, None, :]).any(dim=2)
    boundary = torch.abs(d - ref_d[:, -1:]) <= tol
    bad = diff & ~member & ~boundary
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} ids off the "
                             "reference's row and not at its k-th distance")
    return int(diff.sum())


def routed_world_of_one(dev, X, Q, mp_out, pq_out, card):
    """Phase 13 (a): sharded IVF-PQ on both placements over phase 6's
    model, and the list-placed IVF-Flat on phase 4's centers, over a NCCL
    world of one in this process: phase 6's compressed-tier answers and
    phase 4's answers, distances bit for bit and ids too but for the
    order of exact ties. Returns the launches of the step."""
    import tempfile

    import torch
    import torch.distributed as dist

    from raft_tpu_torch import parallel
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    secs, out = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return res

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            mesh = parallel.make_mesh(device=dev)
            _zero_counters()
            for placement in ("row", "list"):
                index = timed(f"pq {placement} build",
                              lambda: parallel.sharded_ivf_pq_build(
                                  mesh, ivf_pq.IndexParams(n_lists=N_LISTS),
                                  X, model=pq_out["index"],
                                  placement=placement))
                out[f"IVF-PQ {placement}"] = timed(
                    f"pq {placement} search",
                    lambda: parallel.sharded_ivf_pq_search(
                        mesh, ivf_pq.SearchParams(n_probes=N_PROBES), index,
                        Q, K))
                del index
            index = timed("flat list build",
                          lambda: parallel.sharded_ivf_flat_build(
                              mesh, ivf_flat.IndexParams(n_lists=N_LISTS), X,
                              centers=mp_out["centers"], placement="list"))
            out["IVF-Flat list"] = timed(
                "flat list search", lambda: parallel.sharded_ivf_flat_search(
                    mesh, ivf_flat.SearchParams(n_probes=N_PROBES), index,
                    Q, K))
            del index
            launches = _launches()
        finally:
            dist.destroy_process_group()
    rows = {what: same_up_to_exact_ties(
        f"world of one, {what}", *res,
        *(pq_out["compressed"] if what.startswith("IVF-PQ")
          else mp_out["iv"])) for what, res in out.items()}
    log(f"routed world of one (NCCL) [{card}]: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
        + f"; IVF-PQ row and list = phase 6's compressed tier, IVF-Flat list "
        f"= phase 4's: distances bit for bit, ids too up to the order of "
        f"exact ties (rows reordered: {rows}); launches {launches}")
    if launches["fused_knn"] < 1 or launches["pq_fused_scan"] < 2 \
            or launches["fused_cells_knn"] < 1:
        raise AssertionError(f"routed world of one: B1 / B2 / B4 not "
                             f"launched ({launches})")
    return launches


def _rank_pq_model(data_dir, cfg, dev):
    """Phase 6's IVF-PQ model (no rows), from the files of the world."""
    from raft_tpu_torch.neighbors import ivf_pq

    n_lists, J, bits = cfg["n_lists"], cfg["pq_dim"], cfg["pq_bits"]
    return ivf_pq.index_from_numpy(
        *(np.load(f"{data_dir}/pq_{name}.npy") for name in
          ("centers", "rotation_matrix", "pq_centers")),
        np.zeros((n_lists, 1, ivf_pq.packed_row_bytes(J, bits)), np.uint8),
        np.full((n_lists, 1), -1, np.int32), np.zeros(n_lists, np.int32),
        bits, J, 0, cfg["pq_metric"], device=dev)


def _rank_work_routed(rank, data_dir, cfg):
    """Phase 13 (b) on one rank: the list-placed IVF-Flat (B2 per rank)
    on three merge engines, sharded IVF-PQ on both placements (B4 per
    rank, B1 k=1 in the encode), the hottest lists replicated and a
    degraded search with DEAD_RANK dead, a migration to ``assign_lists``
    over the observed loads, extend + delete on the replicated indexes,
    and a sharded Searcher over each index kind with a dispatch hook.
    Rank 0 returns the answers, every rank its digests, wall times and
    launches."""
    import torch

    from raft_tpu_torch import lifecycle, parallel
    from raft_tpu_torch.comms.health import ShardHealth
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
    from raft_tpu_torch.parallel.routing import assign_lists, routing_stats
    from raft_tpu_torch.serve import Searcher

    t_start = time.perf_counter()
    dev = torch.device(cfg["device"])
    k, n_lists, n_ranks, dead = (cfg["k"], cfg["n_lists"], cfg["n_ranks"],
                                 cfg["dead"])
    X = np.load(f"{data_dir}/X.npy", mmap_mode="c")
    Q = torch.as_tensor(np.load(f"{data_dir}/Q.npy"), device=dev)
    centers = torch.as_tensor(np.load(f"{data_dir}/centers.npy"),
                              device=dev)
    J, bits = cfg["pq_dim"], cfg["pq_bits"]
    model = _rank_pq_model(data_dir, cfg, dev)
    mesh = parallel.make_mesh(device=dev)
    shard = parallel.shard_database(mesh, X)
    sp = ivf_flat.SearchParams(n_probes=cfg["n_probes"])
    spq = ivf_pq.SearchParams(n_probes=cfg["n_probes"])
    rec = _RankRecorder(rank, dev)
    timed, keep, capture = rec.timed, rec.keep, rec.capture
    pq_params = ivf_pq.IndexParams(n_lists=n_lists, pq_dim=J, pq_bits=bits)

    _zero_counters()
    routing_stats.reset()
    with capture("B1 k=1 in the rank's encode_rows", "brute_force"):
        pq_row = timed("pq_row_build", lambda: parallel.sharded_ivf_pq_build(
            mesh, pq_params, shard, model=model))
    pq_list = timed("pq_list_build", lambda: parallel.sharded_ivf_pq_build(
        mesh, pq_params, shard, model=model, placement="list"))
    flat = timed("flat_list_build", lambda: parallel.sharded_ivf_flat_build(
        mesh, ivf_flat.IndexParams(n_lists=n_lists), shard, centers=centers,
        placement="list"))
    pack = {"IVF-Flat": flat.pack_bytes, "IVF-PQ": pq_list.pack_bytes}

    def flat_search(index, engine="allgather", **kw):
        return parallel.sharded_ivf_flat_search(mesh, sp, index, Q, k,
                                                merge_engine=engine, **kw)

    for engine in ROUTED_ENGINES:
        with (capture("B2 on the routed group", "ivf_flat")
              if engine == "allgather" else contextlib.nullcontext()):
            keep(f"flat_{engine}", timed(f"flat_list_{engine}",
                                         lambda: flat_search(flat, engine),
                                         reps=3))
    fanout = routing_stats.snapshot()["fanout_mean"]
    for name, index in (("row", pq_row), ("list", pq_list)):
        with capture(f"B4 on the {name}-placed codes", "ivf_pq"):
            keep(f"pq_{name}", timed(f"pq_{name}_search",
                                     lambda: parallel.sharded_ivf_pq_search(
                                         mesh, spq, index, Q, k), reps=3))

    # Replicas of the most probed lists, then rank DEAD_RANK dead.
    hot = np.argsort(-routing_stats.list_loads(flat.placement_map),
                     kind="stable")[:N_HOT]
    hot_pq = np.argsort(-routing_stats.list_loads(pq_list.placement_map),
                        kind="stable")[:N_HOT]
    loads = routing_stats.list_loads(flat.placement_map)
    rep = timed("replicate", lambda: parallel.sharded_replicate_lists(
        mesh, flat, hot))
    live = np.ones(n_ranks, bool)
    live[dead] = False
    routing_stats.reset()
    keep("flat_degraded", timed("flat_list_degraded",
                                lambda: flat_search(rep, live_mask=live)))
    snap = routing_stats.snapshot()
    pm = rep.placement_map
    placement = (pm.owner, pm.replica_owner)

    # A migration to the balance of the observed loads.
    new_owner = assign_lists(loads, n_ranks)
    mig, n_migrated = timed("migrate", lambda: parallel.sharded_migrate_lists(
        mesh, rep, new_owner))
    del rep
    keep("flat_migrated", timed("flat_list_migrated",
                                lambda: flat_search(mig)))

    # Mutations with replicas present: every rank draws the same rows and
    # ids from the seed.
    rng = np.random.default_rng(cfg["seed"] + 13)
    new = (X[np.sort(rng.choice(X.shape[0], N_EXTEND_13, replace=False))]
           + rng.standard_normal((N_EXTEND_13, X.shape[1]))
           .astype(np.float32))
    del_ids = rng.choice(X.shape[0] + N_EXTEND_13, N_DELETE_13,
                         replace=False)
    pq_rep = timed("pq_replicate", lambda: parallel.sharded_replicate_lists(
        mesh, pq_list, hot_pq))
    mutated = {}
    for name, index, extend, search in (
            ("flat", mig, parallel.sharded_ivf_flat_extend, flat_search),
            ("pq", pq_rep, parallel.sharded_ivf_pq_extend,
             lambda index: parallel.sharded_ivf_pq_search(mesh, spq, index,
                                                          Q, k))):
        timed(f"{name}_extend", lambda: extend(mesh, index, new))
        n_del = timed(f"{name}_delete", lambda: lifecycle.delete(
            index, del_ids, mesh=mesh))
        d, i = search(index)
        keep(f"{name}_mutated", (d, i))
        mutated[name] = (n_del, int(np.isin(i.cpu().numpy(), del_ids).sum()),
                         index.size, index.n_deleted)
    del mig, pq_rep

    # A sharded Searcher over each index kind, with a dispatch hook.
    hooks = {}
    for name, make, index, params, engine in (
            ("flat_list", Searcher.ivf_flat, flat, sp, "allgather"),
            ("pq_row", Searcher.ivf_pq, pq_row, spq, "auto"),
            ("pq_list", Searcher.ivf_pq, pq_list, spq, "auto")):
        seen = []
        s = make(index, params, mesh=mesh, health=ShardHealth(n_ranks),
                 merge_engine=engine, dispatch_hook=seen.append)
        res = timed(f"searcher_{name}", lambda: s.search(Q, k))
        keep(f"searcher_{name}", (res.distances, res.indices))
        hooks[name] = [len(r) for r in seen]
    launches = _launches()
    return rec.result(
        launches, pack=pack, fanout=fanout, snap=snap, placement=placement, n_migrated=n_migrated,
        mutated=mutated, hooks=hooks,
        wall_s=time.perf_counter() - t_start)


def routed_ranks(dev, X, Q, mp_out, pq_out, got, card):
    """Phase 13 (b)'s checks of the 4 ranks' results. Returns the ranks'
    launches, summed."""
    import torch

    from raft_tpu_torch.neighbors import ivf_flat

    got = {r: res["p13"] for r, res in got.items()}
    for r in range(1, N_RANKS):
        for key, digest in got[r]["digests"].items():
            if digest != got[0]["digests"].get(key):
                raise AssertionError(f"phase 13: rank {r}'s {key} differs "
                                     "from rank 0's")
    kept = got[0]["plain"]
    if len(kept) != 4:
        raise AssertionError(f"phase 13: rank 0 kept {len(kept)} kernel "
                             "launches, not B1 k=1, B2 and B4 (row, list)")
    for what, shape, rec, err, tol in kept:
        log(f"phase 13, rank 0's {what} ({shape}) vs plain: per-slot "
            f"recall {rec:.6f} (bar {RECALL_BF}), max |d| err {err:.3e} "
            f"(tol {tol:.3e})")
        if rec < RECALL_BF or err > tol:
            raise AssertionError(f"phase 13: rank 0's {what} disagrees "
                                 "with its plain version")
    out = {k: tuple(torch.as_tensor(a, device=dev) for a in v)
           for k, v in got[0]["out"].items()}
    tol = norm_tol(Q, X)
    for engine in ROUTED_ENGINES:
        n_diff = near_tie_check(f"4 ranks, routed IVF-Flat, {engine}",
                                *out[f"flat_{engine}"], *mp_out["iv"], X, Q,
                                tol)
        log(f"4 ranks, list-placed IVF-Flat, {engine}: ids = phase 4's but "
            f"{n_diff} near-tie slots (tol {tol:.3e})")
    for name in ("row", "list"):
        n_diff = tie_check(f"4 ranks, IVF-PQ {name}", *out[f"pq_{name}"],
                           *pq_out["compressed"], tol)
        log(f"4 ranks, {name}-placed IVF-PQ: ids = phase 6's compressed "
            f"tier but {n_diff} near-tie slots (tol {tol:.3e})")

    # Degraded with replicas: recompute the coverage from the lists'
    # members, and the answers of fully covered queries.
    owner, rep_owner = (np.asarray(a) for a in got[0]["placement"])
    reach = torch.as_tensor((owner != DEAD_RANK)
                            | ((rep_owner >= 0) & (rep_owner != DEAD_RANK)),
                            device=dev)
    labels = kmeans_labels(mp_out["centers"], X)
    sizes = torch.bincount(labels, minlength=N_LISTS).float()
    probes = ivf_flat._coarse_probe(Q, mp_out["centers"], N_PROBES,
                                    True).long()
    want = (sizes[probes] * reach[probes]).sum(1) / sizes[probes].sum(1)
    d, i, cov = out["flat_degraded"]
    cov_err = float(torch.max(torch.abs(cov - want)))
    full = cov == 1
    hd, hi = out["flat_allgather"]
    lost = ~reach[labels[torch.clamp_min(i.long(), 0)]] & (i >= 0)
    snap = got[0]["snap"]
    n_rep = int(((rep_owner >= 0) & (owner == DEAD_RANK)).sum())
    log(f"4 ranks, {N_HOT} hottest lists replicated ({n_rep} of them owned "
        f"by rank {DEAD_RANK}), rank {DEAD_RANK} dead: coverage mean "
        f"{float(cov.mean()):.6f} (recomputed, max err {cov_err:.1e}), "
        f"{int(full.sum())} queries fully covered, replica hits "
        f"{snap['replica_hits']}, queries routed to rank {DEAD_RANK}: "
        f"{snap['shard_queries'].get(DEAD_RANK, 0)}")
    if cov_err > 1e-6 or bool(lost.any()) \
            or snap["shard_queries"].get(DEAD_RANK, 0) \
            or (n_rep and not snap["replica_hits"]):
        raise AssertionError("phase 13: the degraded routed search does "
                             "not follow the replicas and the live ranks")
    n_diff = near_tie_check("4 ranks, degraded, fully covered queries",
                            d[full], i[full], hd[full], hi[full], X, Q[full],
                            tol)
    log(f"4 ranks, degraded: the fully covered queries' ids = the healthy "
        f"search's but {n_diff} near-tie slots")
    n_diff = near_tie_check("4 ranks, migrated", *out["flat_migrated"],
                            hd, hi, X, Q, tol)
    same = all(torch.equal(a, b) for a, b in zip(out["flat_migrated"],
                                                 out["flat_allgather"]))
    log(f"4 ranks, migration of {got[0]['n_migrated']} lists to "
        f"assign_lists over the observed loads: ids = the pre-migration "
        f"search's but {n_diff} near-tie slots (bit for bit: {same})")
    for name, (n_del, back, size, n_deleted) in got[0]["mutated"].items():
        log(f"4 ranks, {name} with replicas: extend {N_EXTEND_13} rows, "
            f"delete {N_DELETE_13} ids counted {n_del} (size {size}, "
            f"deleted {n_deleted}); deleted ids in the answers: {back}")
        if n_del != N_DELETE_13 or back or n_deleted != N_DELETE_13 \
                or size != N_ROWS + N_EXTEND_13:
            raise AssertionError(f"phase 13: {name} mutations off")
    for name, direct in (("flat_list", "flat_allgather"),
                         ("pq_row", "pq_row"), ("pq_list", "pq_list")):
        sd, si = out[f"searcher_{name}"]
        if not (torch.equal(sd, out[direct][0])
                and torch.equal(si.long(), out[direct][1].long())):
            raise AssertionError(f"phase 13: the {name} Searcher differs "
                                 "from the direct search")
    hooks = got[0]["hooks"]
    log(f"4 ranks, Searchers = the direct searches; dispatch hook "
        f"participants per dispatch {hooks}")
    if not hooks["flat_list"] or not hooks["pq_list"] or hooks["pq_row"]:
        raise AssertionError("phase 13: the dispatch hook saw the wrong "
                             "dispatches")
    ms = {k: max(got[r]["ms"][k] for r in got) for k in got[0]["ms"]}
    launches = {k: sum(got[r]["launches"][k] for r in got)
                for k in got[0]["launches"]}
    log(f"phase 13, 4 ranks [{card}]: wall ms (slowest rank; first call, "
        f"and the median of 2 more where _steady) "
        + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
    log(f"phase 13, 4 ranks: mean fan-out {got[0]['fanout']:.3f} ranks per "
        f"query; list pack bytes moved (all ranks) {got[0]['pack']}; "
        f"launches per rank {[got[r]['launches'] for r in range(N_RANKS)]}")
    if launches["fused_knn"] < N_RANKS or launches["fused_cells_knn"] < \
            N_RANKS or launches["pq_fused_scan"] < 2 * N_RANKS:
        raise AssertionError(f"phase 13: B1 / B2 / B4 not launched on "
                             f"every rank ({launches})")
    return launches


# ---------------------------------------------------------------------------
# Phase 14: the operations layer of sharding.


class _Clock14:
    """The injected clock of the hedge, recovery and retry steps: a sleep
    advances it."""

    def __init__(self):
        self.now, self.sleeps = 0.0, []

    def monotonic(self):
        return self.now

    def sleep(self, seconds):
        self.sleeps.append(seconds)
        self.now += seconds


class _Straggler14:
    """A dispatch hook: every dispatch costs SERVICE_14 on the clock, and
    while ``slow`` one whose participants include VICTIM_14 costs 10 x
    that more."""

    def __init__(self, clock):
        self.clock, self.slow = clock, False

    def __call__(self, ranks):
        self.clock.sleep(SERVICE_14)
        if self.slow and VICTIM_14 in {int(r) for r in
                                       np.asarray(ranks).reshape(-1)}:
            self.clock.sleep(10 * SERVICE_14)


class _TornWrite14:
    """``FileIO.write_bytes`` that writes 64 bytes of its first payload,
    then raises: a power loss mid-write."""

    def __init__(self):
        self.calls = 0

    def __call__(self, f, data):
        self.calls += 1
        if self.calls == 1:
            f.write(bytes(data)[:64])
            f.flush()
            raise OSError("torn write (scripted)")
        f.write(data)


def _save_load(mesh, rec, name, index, base):
    """``index`` saved at ``base`` and loaded back, both timed (``rec``).
    Returns the loaded index and the snapshot's bytes on disk."""
    import os

    from raft_tpu_torch import parallel

    rec.timed(f"{name}_save",
              lambda: parallel.sharded_ivf_save(mesh, base, index))
    loaded = rec.timed(f"{name}_load",
                       lambda: parallel.sharded_ivf_load(mesh, base))
    names = ["model", "manifest"] + [f"shard{r}" for r in range(mesh.size)]
    return loaded, sum(os.path.getsize(f"{base}.{n}.npz") for n in names)


def _drop_snapshot(comms, base):
    """Every rank done with the files at ``base``: rank 0 removes them."""
    import glob
    import os

    comms.barrier()
    if comms.get_rank() == 0:
        for path in glob.glob(f"{glob.escape(base)}.*"):
            os.remove(path)


def _rank_queries14(centers, owner, rank, j, rng):
    """8 queries about the center of rank ``rank``'s ``j``-th list: at one
    probe, a dispatch whose participants are exactly that rank."""
    import torch

    lists = np.flatnonzero(owner == rank)
    c = centers[int(lists[j % len(lists)])]
    noise = 0.01 * rng.standard_normal((8, c.shape[0])).astype(np.float32)
    return c[None, :] + torch.as_tensor(noise, device=c.device)


def _rank_work_ops(rank, data_dir, cfg):
    """Phase 14 (b) on one rank (the module docstring). Rank 0 returns the
    answers, every rank its digests, wall times, launches and outcomes."""
    import dataclasses
    import faulthandler
    import os

    import torch

    from raft_tpu_torch import lifecycle, parallel, serve
    from raft_tpu_torch.comms.comms import Comms
    from raft_tpu_torch.comms.health import LatencyPolicy, ShardHealth
    from raft_tpu_torch.core.retry import RetryPolicy
    from raft_tpu_torch.lifecycle.compact import _owner_imbalance
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
    from raft_tpu_torch.parallel.routing import routing_stats
    from raft_tpu_torch.util.atomic_io import FileIO

    t_start = time.perf_counter()
    dev = torch.device(cfg["device"])
    k, n_lists, n_ranks = cfg["k"], cfg["n_lists"], cfg["n_ranks"]
    X = np.load(f"{data_dir}/X.npy", mmap_mode="c")
    Q = torch.as_tensor(np.load(f"{data_dir}/Q.npy"), device=dev)
    centers = torch.as_tensor(np.load(f"{data_dir}/centers.npy"),
                              device=dev)
    model = _rank_pq_model(data_dir, cfg, dev)
    mesh = parallel.make_mesh(device=dev)
    comms = Comms(mesh)
    shard = parallel.shard_database(mesh, X)
    sp = ivf_flat.SearchParams(n_probes=cfg["n_probes"])
    spq = ivf_pq.SearchParams(n_probes=cfg["n_probes"])
    rec = _RankRecorder(rank, dev)
    timed, keep, capture = rec.timed, rec.keep, rec.capture
    snap = f"{data_dir}/snap14"
    if rank == 0:
        os.makedirs(snap, exist_ok=True)

    def fsearch(index, q=Q):
        return parallel.sharded_ivf_flat_search(mesh, sp, index, q, k,
                                                merge_engine="allgather")

    def psearch(index):
        return parallel.sharded_ivf_pq_search(mesh, spq, index, Q, k,
                                              merge_engine="allgather")

    _zero_counters()
    routing_stats.reset()
    flat = parallel.sharded_ivf_flat_build(
        mesh, ivf_flat.IndexParams(n_lists=n_lists), shard, centers=centers,
        placement="list")
    pq_params = ivf_pq.IndexParams(n_lists=n_lists, pq_dim=cfg["pq_dim"],
                                   pq_bits=cfg["pq_bits"])
    pqs = {p: parallel.sharded_ivf_pq_build(mesh, pq_params, shard,
                                            model=model, placement=p)
           for p in ("row", "list")}
    # The most probed lists replicated, then the tombstones.
    fsearch(flat)
    hot = np.argsort(-routing_stats.list_loads(flat.placement_map),
                     kind="stable")[:N_HOT]
    flat = parallel.sharded_replicate_lists(mesh, flat, hot)
    rng = np.random.default_rng(cfg["seed"] + 14)
    del_ids = rng.choice(N_ROWS, N_DELETE_14, replace=False)
    indexes = {"flat": flat, "pq_row": pqs["row"], "pq_list": pqs["list"]}
    del flat, pqs
    n_del = {name: lifecycle.delete(index, del_ids, mesh=mesh)
             for name, index in indexes.items()}
    tomb = fsearch(indexes["flat"])
    keep("flat_tomb", tomb)

    # Save and load: the loaded index answers as the saved one.
    io, loaded = {}, None
    for name, cap in (("flat", ("B2 on the loaded IVF-Flat", "ivf_flat")),
                      ("pq_row", ("B4 on the loaded row-placed IVF-PQ",
                                  "ivf_pq")),
                      ("pq_list", None)):
        index = indexes.pop(name)
        search = fsearch if name == "flat" else psearch
        before = tomb if name == "flat" else search(index)
        base = f"{snap}/{name}"
        comms.barrier()
        back, nbytes = _save_load(mesh, rec, name, index, base)
        with (capture(*cap) if cap else contextlib.nullcontext()):
            after = search(back)
        keep(f"{name}_loaded", after)
        io[name] = (nbytes, all(torch.equal(a, b)
                                for a, b in zip(before, after)),
                    n_del[name], back.n_deleted, back.size)
        if name == "flat":
            loaded = back
        elif name == "pq_row":
            torn_src = back
        _drop_snapshot(comms, base)
        del index

    # A snapshot torn on rank 2: every rank raises; a hang fails the
    # rank after DEADLINE_14 seconds (its stacks printed, the process
    # ended), which fails the phase.
    faulthandler.dump_traceback_later(DEADLINE_14, exit=True)
    base = f"{snap}/torn"
    t0 = time.perf_counter()
    try:
        parallel.sharded_ivf_save(
            mesh, base, torn_src, file_io=(FileIO(write_bytes=_TornWrite14())
                                           if rank == 2 else FileIO()))
        torn = None
    except OSError as e:
        torn = (type(e).__name__, str(e))
    torn_s = time.perf_counter() - t0
    faulthandler.cancel_dump_traceback_later()
    comms.barrier()
    torn_files = sorted(f for f in os.listdir(snap) if f.startswith("torn"))
    _drop_snapshot(comms, base)
    del torn_src

    # Compaction of the loaded IVF-Flat, the capacity shrunk.
    new, report = timed("compact", lambda: lifecycle.compact(
        loaded, lifecycle.CompactionPolicy(shrink_capacity=True),
        mesh=mesh))
    keep("flat_compacted", fsearch(new))
    compaction = (dataclasses.astuple(report), loaded.indices.shape[1],
                  new.indices.shape[1])
    del loaded

    # The balancer: traffic skewed onto rank 0's quarter of the lists,
    # one probe a query at a list's own center, so every probe lands on
    # rank 0 (imbalance n_ranks whatever the placement; wider probes
    # spill onto the neighbouring lists of every rank, and the imbalance
    # then hovered around BALANCE_14 from one build to the next).
    quarter = np.flatnonzero(new.placement_map.owner == 0)
    picks = torch.as_tensor(rng.choice(quarter, N_SKEW_14), device=dev)
    routing_stats.reset()
    parallel.sharded_ivf_flat_search(
        mesh, ivf_flat.SearchParams(n_probes=1), new, centers[picks], k,
        merge_engine="allgather")
    loads = routing_stats.list_loads(new.placement_map)
    bal, brep = timed("balance", lambda: lifecycle.compact(
        new, lifecycle.CompactionPolicy(balance_placement=BALANCE_14),
        mesh=mesh))
    keep("flat_balanced", fsearch(bal))
    balance = (None if brep is None else dataclasses.astuple(brep),
               _owner_imbalance(new.placement_map.owner, loads, n_ranks),
               _owner_imbalance(bal.placement_map.owner, loads, n_ranks),
               len(quarter))
    del new

    # A BatchScheduler on rank 0, the other ranks following, over sharded
    # brute force and the balanced IVF-Flat; then one unbatched sharded
    # search per k over all of that k's rows.
    st = np.load(f"{data_dir}/stream.npz")
    reqs = list(zip(np.split(st["q"], np.cumsum(st["rows"])[:-1]),
                    st["k"].tolist()))
    served = {}
    for name, searcher in (
            ("bf", serve.Searcher.brute_force(shard, mesh=mesh)),
            ("flat", serve.Searcher.ivf_flat(bal, sp, mesh=mesh))):
        if rank == 0:
            sched = serve.BatchScheduler(
                searcher, serve.BucketGrid.pow2(SERVE_MAX_BATCH,
                                                k_grid=SERVE_K_GRID),
                serve.BatchPolicy(max_batch=SERVE_MAX_BATCH, max_wait=0.0,
                                  max_queue=2 * len(reqs)))
            with (capture("B1 in the scheduler's sharded brute force",
                          "brute_force") if name == "bf"
                  else contextlib.nullcontext()):
                rec.sync()
                t0 = time.perf_counter()
                tickets = [sched.submit(q, kk) for q, kk in reqs]
                sched.run_until_idle()
                rec.sync()
                sec = time.perf_counter() - t0
            sched.close()
            results = [t.result() for t in tickets]
            by_k = {kk: _stacked([r for r, (_, kr) in zip(results, reqs)
                                  if kr == kk], kk) for kk in SERVE_K_GRID}
            served[name] = (sec, sum(
                b["batches"] for b in sched.stats.snapshot()
                ["buckets"].values()), by_k)
        else:
            served[name] = serve.BatchScheduler.follow(searcher)
        for kk in SERVE_K_GRID:
            qk = np.concatenate([q for q, kq in reqs if kq == kk])
            r = searcher.search(qk, kk)
            keep(f"direct_{name}_{kk}", (r.distances, r.indices))
        del searcher

    # A hedge: rank VICTIM_14's lists replicated, a delay scripted on it.
    hindex = parallel.sharded_replicate_lists(
        mesh, bal, np.flatnonzero(bal.placement_map.owner == VICTIM_14))
    del bal
    clock = _Clock14()
    hook = _Straggler14(clock)
    health = ShardHealth(n_ranks, latency=LatencyPolicy(
        alpha=0.25, window=8, quantile=0.9, multiplier=3.0, min_samples=4))
    hs = serve.Searcher.ivf_flat(
        hindex, ivf_flat.SearchParams(n_probes=1), mesh=mesh, health=health,
        hedge=serve.HedgePolicy(quantile=0.9, multiplier=2.0,
                                min_samples=4),
        dispatch_hook=hook, monotonic=clock.monotonic)
    owner = hindex.placement_map.owner
    qrng = np.random.default_rng(cfg["seed"] + 140)
    for i in range(N_WARM_14):
        hs.search(_rank_queries14(centers, owner, i % n_ranks,
                                  i // n_ranks, qrng), k)
    hook.slow = True
    lats, cov, n_hedged = [], 1.0, 0
    for i in range(N_HEDGE_14):
        t0 = clock.now
        out = hs.search(_rank_queries14(centers, owner, i % n_ranks,
                                        i // n_ranks, qrng), k)
        lats.append(clock.now - t0)
        cov = min(cov, float(out.coverage.min()))
        n_hedged += int(out.hedged)
    hedge = (hs.hedge_stats.snapshot(), cov, n_hedged,
             health.suspect_mask.tolist(), sorted(lats)[-2:])

    # Recovery: the straggler is well again but marked dead.
    hook.slow = False
    health.mark_dead(VICTIM_14)
    prober = serve.RecoveryProber(
        hs, health, _rank_queries14(centers, owner, VICTIM_14, 0,
                                    qrng).cpu().numpy(), k,
        clean_threshold=CLEAN_14, budget=5 * SERVICE_14)
    steps = [prober.step() for _ in range(CLEAN_14)]
    recovery = (steps, health.state(VICTIM_14), prober.snapshot())
    prober.close()
    del hs, hindex

    # A transient fault on rank 2 (its result lost once) under retry.
    rs = serve.Searcher.brute_force(
        shard, mesh=mesh, retry=RetryPolicy(max_attempts=3, base_delay=0.01),
        sleep=clock.sleep, monotonic=clock.monotonic)
    want = rs.search(Q[:1000], k)
    lost = {"n": 1 if rank == 2 else 0}
    real = rs._dispatch

    def flaky(*a, **kw):
        out = real(*a, **kw)
        if lost["n"]:
            lost["n"] -= 1
            raise OSError("result lost (scripted)")
        return out

    rs._dispatch = flaky
    n_sleeps = len(clock.sleeps)
    got = rs.search(Q[:1000], k)
    retry = (bool(np.array_equal(got.indices, want.indices)
                  and np.array_equal(got.distances, want.distances)),
             clock.sleeps[n_sleeps:])
    launches = _launches()
    return rec.result(
        launches, io=io, torn=(torn, torn_files, torn_s),
        compaction=compaction, balance=balance,
        served={n: (v if isinstance(v, int) else v[:2])
                for n, v in served.items()},
        served_by_k={n: v[2] for n, v in served.items()
                     if not isinstance(v, int)},
        hedge=hedge, recovery=recovery, retry=retry,
        wall_s=time.perf_counter() - t_start)


def ops_world_of_one(dev, X, Q, mp_out, pq_out, card):
    """Phase 14 (a): over a NCCL world of one in this process, the
    list-placed IVF-Flat on phase 4's centers and IVF-PQ on both
    placements over phase 6's model, 100,000 seeded ids deleted from
    each, saved and loaded through a temporary directory (the same
    answers, bit for bit), and the loaded IVF-Flat compacted with
    ``shrink_capacity`` (the tombstoned answers). Returns the launches of
    the step."""
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist

    from raft_tpu_torch import lifecycle, parallel
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    secs, out, io = {}, {}, {}
    rec = _RankRecorder(0, dev)
    rng = np.random.default_rng(SEED + 14)
    del_ids = rng.choice(N_ROWS, N_DELETE_14, replace=False)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            mesh = parallel.make_mesh(device=dev)
            sp = ivf_flat.SearchParams(n_probes=N_PROBES)
            spq = ivf_pq.SearchParams(n_probes=N_PROBES)
            _zero_counters()
            indexes = {"flat": parallel.sharded_ivf_flat_build(
                mesh, ivf_flat.IndexParams(n_lists=N_LISTS), X,
                centers=mp_out["centers"], placement="list")}
            for p in ("row", "list"):
                indexes[f"pq_{p}"] = parallel.sharded_ivf_pq_build(
                    mesh, ivf_pq.IndexParams(n_lists=N_LISTS), X,
                    model=pq_out["index"], placement=p)
            loaded = None
            for name in ("flat", "pq_row", "pq_list"):
                index = indexes.pop(name)

                def search(ix, name=name):
                    if name == "flat":
                        return parallel.sharded_ivf_flat_search(
                            mesh, sp, ix, Q, K)
                    return parallel.sharded_ivf_pq_search(mesh, spq, ix, Q,
                                                          K)

                n_del = lifecycle.delete(index, del_ids, mesh=mesh)
                before = search(index)
                back, nbytes = _save_load(mesh, rec, name, index,
                                          f"{tmp}/{name}")
                after = search(back)
                io[name] = (nbytes, n_del)
                if not all(torch.equal(a, b) for a, b in zip(before, after)):
                    raise AssertionError(f"phase 14, world of one: the "
                                         f"loaded {name} answers otherwise")
                if name == "flat":
                    loaded, out["tomb"] = back, before
                del index, back
            t0 = time.perf_counter()
            new, report = lifecycle.compact(
                loaded, lifecycle.CompactionPolicy(shrink_capacity=True),
                mesh=mesh)
            torch.cuda.synchronize()
            secs["compact"] = time.perf_counter() - t0
            out["compacted"] = parallel.sharded_ivf_flat_search(
                mesh, sp, new, Q, K)
            compaction = (dataclasses.astuple(report),
                          loaded.indices.shape[1], new.indices.shape[1])
            del loaded, new
            launches = _launches()
        finally:
            dist.destroy_process_group()
    rows = same_up_to_exact_ties("world of one, compacted IVF-Flat",
                                 *out["compacted"], *out["tomb"])
    rep, cap0, cap1 = compaction
    if rep[0] != N_DELETE_14 or rep[1] != N_ROWS - N_DELETE_14 \
            or cap1 >= cap0:
        raise AssertionError(f"phase 14, world of one: compaction report "
                             f"{rep}, capacity {cap0} -> {cap1}")
    ms = rec.ms
    parts = []
    for name, (b, n) in io.items():
        save_s, load_s = ms[f"{name}_save"] / 1e3, ms[f"{name}_load"] / 1e3
        parts.append(f"{name} {b / 1e9:.3f} GB ({n} ids deleted): save "
                     f"{save_s:.3f} s ({b / save_s / 1e9:.3f} GB/s), load "
                     f"{load_s:.3f} s ({b / load_s / 1e9:.3f} GB/s)")
    log(f"ops world of one (NCCL) [{card}]: " + "; ".join(parts)
        + f"; searches after load bit for bit; compaction "
        f"{secs['compact']:.3f} s (capacity {cap0} -> {cap1}, reclaimed "
        f"{rep[0]}), its answers = the tombstoned ones up to exact ties "
        f"(rows reordered {rows}); launches {launches}")
    if launches["fused_cells_knn"] < 1 or launches["pq_fused_scan"] < 2:
        raise AssertionError(f"ops world of one: B2 / B4 not launched "
                             f"({launches})")
    return launches


def ops_ranks(dev, X, Q, got, stream, card):
    """Phase 14 (b)'s checks of the 4 ranks' results. Returns the ranks'
    launches, summed."""
    import torch

    got = {r: res["p14"] for r, res in got.items()}
    for r in range(1, N_RANKS):
        for key, digest in got[r]["digests"].items():
            if digest != got[0]["digests"].get(key):
                raise AssertionError(f"phase 14: rank {r}'s {key} differs "
                                     "from rank 0's")
    kept = got[0]["plain"]
    if len(kept) != 2 + len(SERVE_K_GRID):
        raise AssertionError(f"phase 14: rank 0 kept {len(kept)} kernel "
                             "launches, not B2, B4 and B1 per k")
    for what, shape, rec, err, tol in kept:
        log(f"phase 14, rank 0's {what} ({shape}) vs plain: per-slot "
            f"recall {rec:.6f} (bar {RECALL_BF}), max |d| err {err:.3e} "
            f"(tol {tol:.3e})")
        if rec < RECALL_BF or err > tol:
            raise AssertionError(f"phase 14: rank 0's {what} disagrees "
                                 "with its plain version")
    ms = {k: max(got[r]["ms"][k] for r in got) for k in got[0]["ms"]}
    g0 = got[0]
    parts = []
    for name, (nbytes, same, n_del, n_del_loaded, size) in g0["io"].items():
        save_s, load_s = ms[f"{name}_save"] / 1e3, ms[f"{name}_load"] / 1e3
        parts.append(f"{name} {nbytes / 1e9:.3f} GB: save {save_s:.3f} s "
                     f"({nbytes / save_s / 1e9:.3f} GB/s), load {load_s:.3f}"
                     f" s ({nbytes / load_s / 1e9:.3f} GB/s)")
        if not same or n_del != N_DELETE_14 or n_del_loaded != N_DELETE_14 \
                or size != N_ROWS:
            raise AssertionError(f"phase 14: {name} save / load off "
                                 f"(same {same}, deleted {n_del} / "
                                 f"{n_del_loaded}, size {size})")
    log(f"phase 14, 4 ranks [{card}]: snapshots (slowest rank) "
        + "; ".join(parts) + "; every loaded index answers bit for bit")
    torns = [got[r]["torn"] for r in range(N_RANKS)]
    first = torns[0][0]
    if first is None or any(t[0] != first for t in torns) \
            or any("torn.manifest.npz" in t[1] for t in torns):
        raise AssertionError(f"phase 14: the torn save did not raise alike "
                             f"on every rank ({torns})")
    log(f"phase 14: torn save on rank 2 raised on every rank {first} in "
        f"{max(t[2] for t in torns):.3f} s (deadline {DEADLINE_14} s); "
        f"left {torns[0][1]}")
    out = {k: tuple(torch.as_tensor(a, device=dev) for a in v)
           for k, v in g0["out"].items()}
    rep, cap0, cap1 = g0["compaction"]
    rows = same_up_to_exact_ties("phase 14, compacted IVF-Flat",
                                 *out["flat_compacted"], *out["flat_tomb"])
    if rep[0] != N_DELETE_14 or rep[1] != N_ROWS - N_DELETE_14 \
            or cap1 >= cap0:
        raise AssertionError(f"phase 14: compaction report {rep}, capacity "
                             f"{cap0} -> {cap1}")
    log(f"phase 14: compaction (shrink_capacity) {ms['compact'] / 1e3:.3f} "
        f"s, reclaimed {rep[0]} (each id once), capacity {cap0} -> {cap1}, "
        f"answers = the tombstoned ones up to exact ties (rows reordered "
        f"{rows})")
    brep, imb0, imb1, n_quarter = g0["balance"]
    if brep is None or brep[9] <= 0:
        raise AssertionError(f"phase 14: the balance pass migrated nothing "
                             f"({brep}, imbalance {imb0})")
    rows = same_up_to_exact_ties("phase 14, balanced IVF-Flat",
                                 *out["flat_balanced"],
                                 *out["flat_compacted"])
    same = all(torch.equal(a, b) for a, b in zip(out["flat_balanced"],
                                                 out["flat_compacted"]))
    log(f"phase 14: balance pass {ms['balance'] / 1e3:.3f} s after "
        f"{N_SKEW_14} queries onto rank 0's {n_quarter} lists: "
        f"{brep[9]} lists migrated, imbalance {imb0:.3f} -> {imb1:.3f}; "
        f"answers bit for bit: {same} (rows reordered {rows})")
    tol = norm_tol(Q, X)
    for name in ("bf", "flat"):
        sec, batches = g0["served"][name]
        followed = [got[r]["served"][name] for r in range(1, N_RANKS)]
        if followed != [batches] * (N_RANKS - 1):
            raise AssertionError(f"phase 14: followers served {followed} "
                                 f"batches, the front rank {batches}")
        n_rows, n_diff = 0, 0
        for kk in SERVE_K_GRID:
            ids, d = g0["served_by_k"][name][kk]
            rd, ri = out[f"direct_{name}_{kk}"]
            qk = torch.as_tensor(np.concatenate(
                [q for q, kq in stream if kq == kk]), device=dev)
            n_diff += near_tie_check(
                f"phase 14, scheduler {name} k={kk}",
                torch.as_tensor(d, device=dev),
                torch.as_tensor(ids, device=dev), rd, ri, X, qk, tol)
            n_rows += ids.shape[0]
        log(f"phase 14, BatchScheduler on rank 0 over sharded {name} "
            f"[{card}]: {SERVE_REQUESTS} requests, {n_rows} rows in "
            f"{sec:.3f} s ({n_rows / sec:.1f} rows/s), {batches} batches, "
            f"ranks 1-3 followed each; ids = one unbatched sharded "
            f"search's but {n_diff} near-tie slots (tol {tol:.3e})")
    snap, cov, n_hedged, suspect, worst = g0["hedge"]
    if snap["fired"] < 1 or snap["won"] < 1 or cov != 1.0 \
            or not suspect[VICTIM_14]:
        raise AssertionError(f"phase 14: hedge {snap}, coverage {cov}, "
                             f"suspect {suspect}")
    if any(got[r]["hedge"][0] != snap for r in got):
        raise AssertionError("phase 14: the ranks' hedge counters differ")
    log(f"phase 14: straggler rank {VICTIM_14} (lists replicated, 10 x "
        f"{SERVICE_14} s scripted): hedge {snap}, {n_hedged} of "
        f"{N_HEDGE_14} answers hedged, coverage {cov}, suspect {suspect}, "
        f"two slowest latencies {worst} s on the injected clock")
    steps, state, psnap = g0["recovery"]
    if steps[-1] != [VICTIM_14] or any(steps[:-1]) or state != "live":
        raise AssertionError(f"phase 14: recovery {steps}, {state}")
    log(f"phase 14: RecoveryProber re-admitted rank {VICTIM_14} after "
        f"{CLEAN_14} clean probes ({steps}; {psnap['probes_sent']} probes)")
    retries = [got[r]["retry"] for r in range(N_RANKS)]
    if not all(ok and sl == retries[0][1] and sl for ok, sl in retries):
        raise AssertionError(f"phase 14: retry {retries}")
    log(f"phase 14: a transient fault on rank 2, retried by every rank "
        f"(backoff {retries[0][1]}), answers the fault-free search")
    log(f"phase 14, 4 ranks [{card}]: wall ms (slowest rank) "
        + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
    launches = {k: sum(got[r]["launches"][k] for r in got)
                for k in got[0]["launches"]}
    log(f"phase 14, 4 ranks: launches per rank "
        f"{[got[r]['launches'] for r in range(N_RANKS)]}")
    if launches["fused_knn"] < N_RANKS or launches["fused_cells_knn"] < \
            N_RANKS or launches["pq_fused_scan"] < 2 * N_RANKS:
        raise AssertionError(f"phase 14: B1 / B2 / B4 not launched on "
                             f"every rank ({launches})")
    return launches


def stream15(rows_of, n_rows, dim, seed):
    """Phase 15's mutation stream (host numpy, the same on every rank from
    the seed): N_EXTEND_15 database rows + N(0, 1) with ids from ``n_rows``
    up, N_DELETE_15 seeded ids deleted, N_UPSERT_15 surviving ids upserted
    with new rows, a ``shrink_capacity`` compaction; then the two later
    deletes (the torn one, repeated after recovery, and the promoted
    follower's first write), N_DELETE_LATE_15 ids each."""
    rng = np.random.default_rng(seed)

    def noisy(idx):
        return (rows_of(idx) + rng.standard_normal((len(idx), dim))
                .astype(np.float32))

    ext = noisy(np.sort(rng.choice(n_rows, N_EXTEND_15, replace=False)))
    dels = rng.choice(n_rows, N_DELETE_15, replace=False)
    alive = np.setdiff1d(np.arange(n_rows), dels)
    picked = rng.choice(alive, N_UPSERT_15 + 2 * N_DELETE_LATE_15,
                        replace=False)
    up_ids = np.sort(picked[:N_UPSERT_15])
    late = picked[N_UPSERT_15:].reshape(2, N_DELETE_LATE_15)
    return ([("extend", ext, np.arange(n_rows, n_rows + N_EXTEND_15)),
             ("delete", dels), ("upsert", noisy(up_ids), up_ids),
             ("compact",)], late)


def apply15(searcher, step):
    """One step of :func:`stream15` through a Searcher."""
    from raft_tpu_torch import lifecycle

    op = step[0]
    if op == "extend":
        searcher.extend(step[1], step[2])
    elif op == "delete":
        searcher.delete(step[1])
    elif op == "upsert":
        searcher.upsert(step[1], step[2])
    else:
        searcher.compact(lifecycle.CompactionPolicy(shrink_capacity=True))


def _scraped(text, name) -> float:
    """The value of the unlabelled series ``name`` in a scrape."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise AssertionError(f"{name} is not on the scrape")


def durable_world_of_one(dev, X, Q, pq_out, card):
    """Phase 15 (a): over a NCCL world of one in this process, the
    row-placed sharded IVF-PQ on phase 6's model under a fsynced one-part
    mutation log with a base snapshot, phase 15's stream through a sharded
    Searcher (extend, delete, upsert, compaction), the searcher dropped,
    ``recover``: the head epoch, and the answers to the 10,000 queries =
    the live index's up to the order of exact ties (B4 on both; rank 0's
    first B4 of the recovered search held against its plain version).
    Returns the launches of the step."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from raft_tpu_torch import lifecycle, parallel, serve
    from raft_tpu_torch.neighbors import ivf_pq

    steps, _ = stream15(lambda idx: X[torch.as_tensor(
        idx, device=X.device)].cpu().numpy(), N_ROWS, DIM, SEED + 15)
    secs = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            mesh = parallel.make_mesh(device=dev)
            spq = ivf_pq.SearchParams(n_probes=N_PROBES)
            _zero_counters()
            index = parallel.sharded_ivf_pq_build(
                mesh, ivf_pq.IndexParams(n_lists=N_LISTS), X,
                model=pq_out["index"], placement="row")
            need = 2 * _saved_bytes(index) + (1 << 30)
            free = shutil.disk_usage(tmp).free
            if free < need:
                raise AssertionError(f"phase 15 (a): {free} bytes free in "
                                     f"{tmp}, the log needs {need}")
            root = f"{tmp}/wal"
            wal = lifecycle.MutationLog(root, n_parts=1, snapshot_every=0,
                                        mesh=mesh)
            wal.snapshot(index, mesh)
            s = serve.Searcher.ivf_pq(index, spq, mesh=mesh, wal=wal)
            for step in steps:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                apply15(s, step)
                torch.cuda.synchronize()
                secs[step[0]] = time.perf_counter() - t0
            head = wal.head_epoch()
            live = s.search(Q, K)
            wal.close()
            del s, index
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec, wal2 = lifecycle.recover(mesh, root, n_parts=1)
            torch.cuda.synchronize()
            secs["recover"] = time.perf_counter() - t0
            cap = _Capture("ivf_pq")
            with cap:
                got = serve.Searcher.ivf_pq(rec, spq, mesh=mesh).search(Q, K)
            epoch, stats = int(rec.epoch), wal.stats
            wal2.close()
            plain = rank_plain_checks({"B4 on the recovered IVF-PQ": cap})
            launches = _launches()
            del rec
        finally:
            dist.destroy_process_group()
    if epoch != head or head != len(steps):
        raise AssertionError(f"phase 15 (a): recovered epoch {epoch}, log "
                             f"head {head}, {len(steps)} mutations")
    rows = same_up_to_exact_ties(
        "phase 15 (a), recovered IVF-PQ", torch.as_tensor(got.distances),
        torch.as_tensor(got.indices), torch.as_tensor(live.distances),
        torch.as_tensor(live.indices))
    for what, shape, rec_, err, tol in plain:
        log(f"phase 15 (a), {what} ({shape}) vs plain: per-slot recall "
            f"{rec_:.6f} (bar {RECALL_BF}), max |d| err {err:.3e} (tol "
            f"{tol:.3e})")
        if rec_ < RECALL_BF or err > tol:
            raise AssertionError(f"phase 15 (a): {what} disagrees with its "
                                 "plain version")
    log(f"durable world of one (NCCL) [{card}]: row-placed IVF-PQ, "
        + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
        + f"; recovered to epoch {epoch} = the head ({stats.records} "
        f"records, {stats.bytes} bytes, {stats.snapshots} snapshot); answers "
        f"= the live index's up to exact ties (rows reordered {rows}); "
        f"launches {launches}")
    if launches["pq_fused_scan"] < 2 or launches["fused_knn"] < 1:
        raise AssertionError(f"phase 15 (a): B4 / B1 not launched "
                             f"({launches})")
    return launches


def _rank_work_durable(rank, data_dir, cfg):
    """Phase 15 (b) on one rank (the module docstring). Rank 0 returns the
    answers, every rank its digests, wall times, launches and outcomes."""
    import dataclasses
    import os
    import shutil

    import torch

    from raft_tpu_torch import lifecycle, obs, parallel, serve
    from raft_tpu_torch.comms.agree import agreed, root_value
    from raft_tpu_torch.comms.comms import Comms, OpT
    from raft_tpu_torch.comms.health import ShardHealth
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.parallel.routing import routing_stats
    from raft_tpu_torch.serve.bucketing import pad_queries
    from raft_tpu_torch.testing.chaos import ChaosMonkey, FaultSpec
    from raft_tpu_torch.util.atomic_io import FileIO

    t_start = time.perf_counter()
    dev = torch.device(cfg["device"])
    k, n_lists, n_ranks = cfg["k"], cfg["n_lists"], cfg["n_ranks"]
    X = np.load(f"{data_dir}/X.npy", mmap_mode="c")
    Q = torch.as_tensor(np.load(f"{data_dir}/Q.npy"), device=dev)
    Qs = Q[:N_CHECK_15]
    centers = torch.as_tensor(np.load(f"{data_dir}/centers.npy"),
                              device=dev)
    mesh = parallel.make_mesh(device=dev)
    comms = Comms(mesh)
    shard = parallel.shard_database(mesh, X)
    sp = ivf_flat.SearchParams(n_probes=cfg["n_probes"])
    rec = _RankRecorder(rank, dev)
    timed, keep, capture = rec.timed, rec.keep, rec.capture
    root = f"{data_dir}/wal15"
    steps, late = stream15(lambda idx: np.asarray(X[idx]), X.shape[0],
                           X.shape[1], cfg["seed"] + 15)
    grid = serve.BucketGrid.pow2(SERVE_MAX_BATCH, k_grid=SERVE_K_GRID)

    _zero_counters()
    routing_stats.reset()
    lifecycle.elastic_stats.reset()
    index = parallel.sharded_ivf_flat_build(
        mesh, ivf_flat.IndexParams(n_lists=n_lists), shard, centers=centers,
        placement="list")
    parallel.sharded_ivf_flat_search(mesh, sp, index, Q, k)
    hot = np.argsort(-routing_stats.list_loads(index.placement_map),
                     kind="stable")[:N_HOT]
    index = parallel.sharded_replicate_lists(mesh, index, hot)
    routing_stats.reset()

    # The disk: the base snapshot and one cadence snapshot of at most the
    # same size, 1 GiB to spare.
    mine = sum(t.numel() * t.element_size() for t in (
        index.data, index.indices, index.list_sizes))
    total = int(comms.allreduce(torch.tensor([mine]), OpT.SUM)[0])
    need = 2 * total + (1 << 30)
    free = None
    with agreed(comms):
        if rank == 0:
            os.makedirs(root, exist_ok=True)
            free = shutil.disk_usage(root).free
            if free < need:
                raise AssertionError(f"phase 15: {free} bytes free under "
                                     f"{root}, the log needs {need}")
    free = root_value(comms, free)

    # The primary: a fsynced 4-part log, a base snapshot, the stream; rank
    # 0's appends timed.
    wal_stats = lifecycle.WalStats()
    chaos = ChaosMonkey(seed=cfg["seed"])
    io = FileIO(write_bytes=chaos.wrap_write("wal"))
    plog = lifecycle.MutationLog(root, n_parts=n_ranks,
                                 snapshot_every=SNAP_EVERY_15, file_io=io,
                                 stats=wal_stats, mesh=mesh)
    append_ms = []

    def time_appends(wal):
        """Rank 0's ms of each successful append to ``wal``."""
        real = wal.append

        def timed_append(*a, **kw):
            t0 = time.perf_counter()
            out = real(*a, **kw)
            append_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        wal.append = timed_append
        return wal

    time_appends(plog)
    timed("base_snapshot", lambda: plog.snapshot(index, mesh))
    primary = serve.Searcher.ivf_flat(index, sp, mesh=mesh, wal=plog)
    base_epoch = index.epoch            # the replication's publish
    del index
    appended = 0
    for step in steps:
        with (capture(f"B1 k=1 in the logged {step[0]}", "brute_force")
              if step[0] == "extend" else contextlib.nullcontext()):
            timed(step[0], lambda: apply15(primary, step))
        appended += 1
    live4 = primary.search(Qs, k)
    keep("live4", (live4.distances, live4.indices))

    # A torn append (rank 0 writes the log): every rank raises the same
    # error, none publishes, and recovery lands on the last epoch.
    # Byte 100 is inside the payload of any frame (the header is 40).
    chaos.script("wal", [FaultSpec(kind="torn_write",
                                   at=(chaos.calls("wal"),), offset=100)])
    torn_epoch = primary.epoch
    try:
        primary.delete(late[0])
        torn = None
    except OSError as e:
        torn = (type(e).__name__, str(e))
    torn = (torn, primary.epoch, torn_epoch)
    plog.close()
    del primary
    r1, log1 = timed("recover", lambda: lifecycle.recover(
        mesh, root, n_parts=n_ranks, snapshot_every=SNAP_EVERY_15,
        stats=wal_stats))
    with capture("B2 on the recovered index", "ivf_flat"):
        got = serve.Searcher.ivf_flat(r1, sp, mesh=mesh).search(Qs, k)
    keep("recovered4", (got.distances, got.indices))
    torn += (int(r1.epoch),)

    # A follower over a second recovery; the primary resumes.
    f_idx, flog = timed("follower_recover", lambda: lifecycle.recover(
        mesh, root, n_parts=n_ranks, snapshot_every=0, stats=wal_stats))
    fol = lifecycle.Follower(serve.Searcher.ivf_flat(f_idx, sp, mesh=mesh,
                                                     wal=flog), flog)
    del f_idx
    try:
        fol.searcher.delete(late[1])
        refused = None
    except Exception as e:          # noqa: BLE001 - the outcome
        refused = (type(e).__name__, str(e))
    primary = serve.Searcher.ivf_flat(r1, sp, mesh=mesh,
                                      wal=time_appends(log1))
    time_appends(flog)
    del r1
    timed("resume", lambda: primary.delete(late[0]))
    appended += 1
    lag = fol.poll()
    applied = timed("catch_up", lambda: fol.catch_up())
    p5 = primary.search(Qs, k)
    f5 = fol.searcher.search(Qs, k)
    keep("primary5", (p5.distances, p5.indices))
    keep("follower5", (f5.distances, f5.indices))
    health = ShardHealth(n_ranks)
    mgr = lifecycle.PromotionManager(fol, health, PRIMARY_15)
    log1.close()
    del primary
    health.mark_dead(PRIMARY_15)         # scripted, on every rank
    t0 = time.perf_counter()
    fol.poll()
    promote_s = time.perf_counter() - t0
    head = fol.log.head_epoch()
    fs = fol.searcher
    fs.delete(late[1])
    appended += 1
    follower = (refused, lag, applied, mgr.promoted, mgr.promotions, head,
                fs.epoch)

    # Elastic: leave, then join, LEAVER_15, each warmed on the serve grid.
    before = fs.search(Qs, k)
    keep("pre_resize", (before.distances, before.indices))
    rep_leave = timed("leave", lambda: lifecycle.leave_shard(
        fs, LEAVER_15, grid=grid))
    appended += 1
    routing_stats.reset()
    mid = fs.search(Qs, k)
    fanout = dict(routing_stats.snapshot()["shard_queries"])
    keep("after_leave", (mid.distances, mid.indices))
    rep_join = timed("join", lambda: lifecycle.join_shard(
        fs, LEAVER_15, grid=grid))
    appended += 1
    after = fs.search(Qs, k)
    keep("after_join", (after.distances, after.indices))
    pm = fs._index.placement_map
    # ``recover``'s three steps, timed apart: the log's open (rank 0's
    # reads and manifest check), the snapshot's load, the replay.
    log3 = timed("log_open", lambda: lifecycle.MutationLog(
        root, n_parts=n_ranks, stats=wal_stats, mesh=mesh))
    snap_epoch, base = log3.latest_snapshot()
    r3 = timed("snapshot_load",
               lambda: parallel.sharded_ivf_load(mesh, base))
    r3.epoch = snap_epoch
    r3 = timed("replay", lambda: lifecycle.replay(mesh, r3, log3))
    pm3 = r3.placement_map
    placement = (bool(np.array_equal(pm3.owner, pm.owner)
                      and np.array_equal(pm3.replica_owner,
                                         pm.replica_owner)),
                 int(r3.epoch), fs.epoch)
    got3 = serve.Searcher.ivf_flat(r3, sp, mesh=mesh).search(Qs, k)
    keep("recovered_resized", (got3.distances, got3.indices))
    log3.close()
    del r3
    elastic = (dataclasses.astuple(rep_leave),
               dataclasses.astuple(rep_join), fanout)

    # The recall probe behind a front rank serving bench/serve.py's stream.
    st = np.load(f"{data_dir}/stream.npz")
    reqs = list(zip(np.split(st["q"], np.cumsum(st["rows"])[:-1]),
                    st["k"].tolist()))
    reg = obs.MetricsRegistry()
    probe_out = None
    if rank == 0:
        probe = obs.RecallProbe(fs, rate=PROBE_RATE_15, seed=PROBE_SEED_15,
                                registry=reg)
        sampled, real_offer = [], probe.offer

        def offer(queries, kk, indices, bucket, epoch):
            hit = real_offer(queries, kk, indices, bucket, epoch)
            if hit:
                sampled.append((queries, np.asarray(indices), bucket))
            return hit

        probe.offer = offer
        sched = serve.BatchScheduler(
            fs, grid, serve.BatchPolicy(max_batch=SERVE_MAX_BATCH,
                                        max_wait=0.0,
                                        max_queue=2 * len(reqs)),
            probe=probe)
        for cls, arg in ((obs.ServeStatsCollector, sched.stats),
                         (obs.ShardHealthCollector, health),
                         (obs.SearcherCollector, fs),
                         (obs.HedgeCollector, fs),
                         (obs.DegradeCollector, sched)):
            cls(reg, arg)
        obs.MergeDispatchCollector(reg)
        obs.RoutingCollector(reg)
        obs.ElasticCollector(reg)
        obs.WalCollector(reg, wal_stats, followers=[fol], promotion=mgr)
        rec.sync()
        t0 = time.perf_counter()
        tickets = [sched.submit(q, kk) for q, kk in reqs]
        sched.run_until_idle()
        rec.sync()
        serve_s = time.perf_counter() - t0
        fsync_ms = [s * 1e3 for s in wal_stats._pending_fsync_s]
        t0 = time.perf_counter()
        scored = probe.run_pending()
        probe_s = time.perf_counter() - t0
        text = reg.prometheus_text()
        sched.close()
        probe_out = dict(snap=probe.snapshot(), recall=probe.recall(),
                         scored=scored, serve_s=serve_s, probe_s=probe_s,
                         text=text, fsync_ms=fsync_ms,
                         served=sum(1 for t in tickets if t.done))
    else:
        serve.BatchScheduler.follow(fs)
    # The script's own recall: the same sampled rows against a full-probe
    # search, outside the probe (every rank runs it on rank 0's samples).
    samples = root_value(comms, [(q, b) for q, _, b in sampled]
                         if rank == 0 else None)
    full = ivf_flat.SearchParams(n_probes=n_lists)
    truth = []
    for q, (qb, kb) in samples:
        _, ti = parallel.sharded_ivf_flat_search(
            mesh, full, fs._index, pad_queries(q, qb), kb)
        truth.append(ti[:q.shape[0]].cpu().numpy())
    if rank == 0:
        windows = {}
        for (q, ids, bucket), t in zip(sampled, truth):
            kq = ids.shape[1]
            windows.setdefault(bucket, []).extend(
                float(np.intersect1d(ids[r][ids[r] >= 0],
                                     t[r, :kq][t[r, :kq] >= 0]).size) / kq
                for r in range(q.shape[0]))
        vals = [v for w in windows.values() for v in w[-512:]]
        probe_out["own_recall"] = float(np.mean(vals)) if vals else \
            float("nan")
        probe_out["own_samples"] = len(vals)
        probe_out["append_ms"] = append_ms
        probe_out["record_bytes"] = wal_stats.bytes
    comms.barrier()
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    launches = _launches()
    return rec.result(
        launches, torn=torn, follower=follower, promote_s=promote_s,
        placement=placement, elastic=elastic, probe=probe_out,
        appended=appended, snapshots=wal_stats.snapshots,
        base_epoch=base_epoch, free=free,
        need=need, wall_s=time.perf_counter() - t_start)


def durable_ranks(dev, got, card):
    """Phase 15 (b)'s checks of the 4 ranks' results. Returns the ranks'
    launches, summed."""
    import torch

    got = {r: res["p15"] for r, res in got.items()}
    for r in range(1, N_RANKS):
        for key, digest in got[r]["digests"].items():
            if digest != got[0]["digests"].get(key):
                raise AssertionError(f"phase 15: rank {r}'s {key} differs "
                                     "from rank 0's")
    g0 = got[0]
    kept = g0["plain"]
    if len(kept) != 2:
        raise AssertionError(f"phase 15: rank 0 kept {len(kept)} kernel "
                             "launches, not B1 k=1 and B2")
    for what, shape, rec, err, tol in kept:
        log(f"phase 15, rank 0's {what} ({shape}) vs plain: per-slot "
            f"recall {rec:.6f} (bar {RECALL_BF}), max |d| err {err:.3e} "
            f"(tol {tol:.3e})")
        if rec < RECALL_BF or err > tol:
            raise AssertionError(f"phase 15: rank 0's {what} disagrees "
                                 "with its plain version")
    out = {k: tuple(torch.as_tensor(a, device=dev) for a in v)
           for k, v in g0["out"].items()}
    ms = {k: max(got[r]["ms"][k] for r in got) for k in g0["ms"]}
    base = g0["base_epoch"]
    n_stream = base + 4                 # the epoch after the stream
    torns = [got[r]["torn"] for r in range(N_RANKS)]
    err0 = torns[0][0]
    if err0 is None or err0[0] != "InjectedFault" or any(
            t != (err0, n_stream, n_stream, n_stream) for t in torns):
        raise AssertionError(f"phase 15: the torn append {torns}")
    rows = same_up_to_exact_ties("phase 15, recovered after the torn "
                                 "append", *out["recovered4"], *out["live4"])
    log(f"phase 15, 4 ranks [{card}]: stream (slowest rank) "
        + ", ".join(f"{s} {ms[s] / 1e3:.3f} s" for s in
                    ("extend", "delete", "upsert", "compact"))
        + f"; base snapshot {ms['base_snapshot'] / 1e3:.3f} s; a torn "
        f"append on rank 0 raised on every rank {err0}, none published "
        f"(epoch {n_stream}); recover {ms['recover'] / 1e3:.3f} s to "
        f"epoch {n_stream}, answers = the live ones up to exact ties (rows "
        f"reordered {rows})")
    refused, lag, applied, promoted, promotions, head, f_epoch = \
        g0["follower"]
    if refused is None or "read-only" not in refused[1] or lag != 1 \
            or applied != 1 or not promoted or promotions != 1 \
            or f_epoch != head + 1 or head != n_stream + 1:
        raise AssertionError(f"phase 15: follower {g0['follower']}")
    if any(got[r]["follower"] != g0["follower"] for r in got):
        raise AssertionError("phase 15: the ranks' followers differ")
    rows = same_up_to_exact_ties("phase 15, follower after catch_up",
                                 *out["follower5"], *out["primary5"])
    log(f"phase 15: follower (second recover "
        f"{ms['follower_recover'] / 1e3:.3f} s) refused a delete "
        f"({refused[0]}), lag {lag}, catch_up {ms['catch_up'] / 1e3:.3f} s "
        f"= the primary's answers (rows reordered {rows}); promoted on "
        f"rank {PRIMARY_15}'s scripted death (every rank) at its next poll "
        f"in {g0['promote_s']:.3f} s, its delete at epoch {f_epoch} = head "
        f"+ 1")
    rep_leave, rep_join, fanout = g0["elastic"]
    if rep_leave[4] <= 0 or rep_join[4] <= 0 or fanout.get(LEAVER_15, 0):
        raise AssertionError(f"phase 15: elastic {g0['elastic']}")
    for key in ("after_leave", "after_join"):
        same_up_to_exact_ties(f"phase 15, {key}", *out[key],
                              *out["pre_resize"])
    same_p, r_epoch, s_epoch = g0["placement"]
    if not same_p or r_epoch != s_epoch:
        raise AssertionError(f"phase 15: recover after the resizes "
                             f"{g0['placement']}")
    rows = same_up_to_exact_ties("phase 15, recovered after the resizes",
                                 *out["recovered_resized"],
                                 *out["after_join"])
    replayed = s_epoch - n_stream       # over the cadence snapshot
    rep_s = ms["replay"] / 1e3
    log(f"phase 15: leave {LEAVER_15} ({rep_leave[4]} lists moved, "
        f"{rep_leave[5]} shapes warmed) {ms['leave'] / 1e3:.3f} s, join "
        f"({rep_join[4]} lists) {ms['join'] / 1e3:.3f} s; after the leave "
        f"no dispatch reached rank {LEAVER_15} (queries per shard "
        f"{fanout}); answers = the pre-resize ones up to exact ties; a "
        f"recovery after both (log open {ms['log_open'] / 1e3:.3f} s, "
        f"snapshot load {ms['snapshot_load'] / 1e3:.3f} s, replay of "
        f"{replayed} records over the epoch-{n_stream} snapshot "
        f"{rep_s:.3f} s = {replayed / rep_s:.1f} records/s) lands on epoch "
        f"{r_epoch} with the same placement, owner for owner (rows "
        f"reordered {rows})")
    p = g0["probe"]
    if not (p["recall"] >= RECALL_IVF) or abs(p["recall"] - p["own_recall"]) \
            > 1e-12 or p["snap"]["scanned"] != p["scored"] \
            or p["scored"] < 1 or p["served"] != SERVE_REQUESTS:
        raise AssertionError(f"phase 15: recall probe {p['snap']}, recall "
                             f"{p['recall']} vs own {p['own_recall']}")
    log(f"phase 15: BatchScheduler on rank 0 with RecallProbe(rate="
        f"{PROBE_RATE_15}, seed={PROBE_SEED_15}) served {SERVE_REQUESTS} "
        f"requests in {p['serve_s']:.3f} s [{card}]; run_pending scored "
        f"{p['scored']} samples ({p['own_samples']} query rows) through the "
        f"command channel in {p['probe_s']:.3f} s: windowed recall "
        f"{p['recall']:.6f} = the script's own {p['own_recall']:.6f} "
        f"against a full-probe search (bar {RECALL_IVF})")
    text = p["text"]
    want = {"raft_wal_records_total": g0["appended"],
            "raft_wal_snapshots_total": g0["snapshots"],
            "raft_wal_promotions_total": 1,
            "raft_recall_scanned_total": p["scored"]}
    scraped = {name: _scraped(text, name) for name in want}
    resizes = (_scraped(text, "raft_elastic_joins_total")
               + _scraped(text, "raft_elastic_leaves_total"))
    if scraped != {k: float(v) for k, v in want.items()} or resizes != 2:
        raise AssertionError(f"phase 15: scrape {scraped}, resizes "
                             f"{resizes}; the script counted {want}")
    lat = np.asarray(p["append_ms"])
    fs_ms = np.asarray(p["fsync_ms"])
    log(f"phase 15: one scrape of {len(text.splitlines())} lines: "
        f"{scraped}, resizes {resizes:.0f} = the script's counts; appends "
        f"(rank 0, {lat.size}) p50 {np.quantile(lat, 0.5):.3f} ms, p99 "
        f"{np.quantile(lat, 0.99):.3f} ms; fsync p50 "
        f"{np.quantile(fs_ms, 0.5):.3f} ms, p99 {np.quantile(fs_ms, 0.99):.3f}"
        f" ms; {p['record_bytes']} record bytes; disk {g0['free']} free, "
        f"{g0['need']} needed")
    launches = {k: sum(got[r]["launches"][k] for r in got)
                for k in g0["launches"]}
    log(f"phase 15, 4 ranks: launches per rank "
        f"{[got[r]['launches'] for r in range(N_RANKS)]}")
    if launches["fused_knn"] < N_RANKS or launches["fused_cells_knn"] < \
            N_RANKS:
        raise AssertionError(f"phase 15: B1 / B2 not launched on every "
                             f"rank ({launches})")
    return launches


def kmeans_labels(centers, X):
    """Each row's nearest center (the lists of an IVF-Flat build)."""
    from raft_tpu_torch.cluster import kmeans_balanced
    from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams

    return kmeans_balanced._predict(KMeansBalancedParams(), centers,
                                    X).long()


def sharded_phase(dev, X, Q, mp_out, pq_out, card):
    """Phases 12 to 15: sharding and durability, with the counters set to
    0 before each step and read after it; one spawned world of 4 ranks
    runs the four phases' (b) steps. Returns the launches of each
    phase."""
    t0 = time.perf_counter()
    a12 = sharded_world_of_one(dev, X, Q, mp_out["bf"], mp_out["iv"],
                               mp_out["centers"], card)
    t1 = time.perf_counter()
    a13 = routed_world_of_one(dev, X, Q, mp_out, pq_out, card)
    a13_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    a14 = ops_world_of_one(dev, X, Q, mp_out, pq_out, card)
    a14_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    a15 = durable_world_of_one(dev, X, Q, pq_out, card)
    a15_s = time.perf_counter() - t1
    stream = serve_stream(X, np.random.default_rng(SEED + 14), 0.0)
    got, wall = spawn_ranks(dev, X, Q, mp_out["centers"], pq_out["index"],
                            stream)
    b12 = sharded_ranks(dev, X, Q, mp_out["bf"], mp_out["iv"],
                        mp_out["centers"], got, wall, card)
    b13 = routed_ranks(dev, X, Q, mp_out, pq_out, got, card)
    b14 = ops_ranks(dev, X, Q, got, stream, card)
    b15 = durable_ranks(dev, got, card)
    p12 = {k: a12[k] + b12[k] for k in a12}
    p13 = {k: a13[k] + b13[k] for k in a13}
    p14 = {k: a14[k] + b14[k] for k in a14}
    p15 = {k: a15[k] + b15[k] for k in a15}
    ranks13 = max(res["p13"]["wall_s"] for res in got.values())
    ranks14 = max(res["p14"]["wall_s"] for res in got.values())
    ranks15 = max(res["p15"]["wall_s"] for res in got.values())
    log(f"phase 12: launches {p12} (world of one {a12}, 4 ranks {b12})")
    log(f"phase 13: {a13_s + ranks13:.3f} s (world of one {a13_s:.3f} s, "
        f"4 ranks {ranks13:.3f} s, the slowest rank), launches {p13} "
        f"(world of one {a13}, 4 ranks {b13})")
    log(f"phase 14: {a14_s + ranks14:.3f} s (world of one {a14_s:.3f} s, "
        f"4 ranks {ranks14:.3f} s, the slowest rank), launches {p14} "
        f"(world of one {a14}, 4 ranks {b14})")
    log(f"phase 15: {a15_s + ranks15:.3f} s (world of one {a15_s:.3f} s, "
        f"4 ranks {ranks15:.3f} s, the slowest rank), launches {p15} "
        f"(world of one {a15}, 4 ranks {b15}); phases 12-15 "
        f"{time.perf_counter() - t0:.3f} s")
    return p12, p13, p14, p15


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    dev = torch.device("cuda")

    from raft_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc per source: {_build.BUILD_SECONDS})")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    check_kernels(dev)
    check_kernels_b3_b4(dev)
    b5_err = check_kernel_b5(dev)

    t0 = time.perf_counter()
    Xh, Qh = make_data(N_ROWS, DIM, N_BLOBS, N_QUERIES)
    X = torch.as_tensor(Xh, device=dev)
    Q = torch.as_tensor(Qh, device=dev)
    del Xh, Qh
    log(f"data: {N_ROWS} x {DIM} rows, {N_QUERIES} queries in "
        f"{time.perf_counter() - t0:.2f} s")

    mp = main_path(dev, X, Q)
    b1 = b1_entry(dev, X, Q, mp["bf"])
    b1_kmeans_shape(dev, X, mp["index"].centers)
    b2 = b2_entry(dev, Q, mp["index"], mp["search_ms"])

    pq = pq_path(dev, X, Q, mp["bf"][1])
    b4 = b4_entry(dev, Q, pq["index"], pq["search_ms"])
    b3 = b3_entry(dev, pq["index"], pq["probes_sub"], pq["rotq_sub"])

    b5 = select_phase(dev, b5_err)
    # Phase 6 left IVF-PQ's reconstruction cache in place, which routes
    # search to the recon tier; the serve and lifecycle phases search the
    # compressed tier (B4), as the main path does.
    pq["index"]._recon = None
    sv = serve_phase(dev, X, card, mp["index"], pq["index"], pq["recall"])
    lc, compacted = lifecycle_phase(
        dev, X, Q, mp["bf"], mp["index"], pq["index"], mp["search_ms"],
        pq["search_ms"], pq["recall"])
    sm, flat_served = serve_mutations(dev, Q, compacted["ivf_flat"], card)
    sf = surface_phase(dev, X, Q, mp["bf"], mp["index"], flat_served,
                       compacted["ivf_pq"], pq["recall"], card)
    sh, rt, ops, du = sharded_phase(dev, X, Q, mp, pq, card)

    kernels = [
        dict(name="fused_knn", route="cuda",
             source="raft_tpu_torch/csrc/knn_gemm.cuh",
             replaces="raft_tpu/ops/fused_knn.py:179",
             launches=mp["launches"]["fused_knn"]
             + pq["launches"]["fused_knn"] + sv["fused_knn"]
             + lc["fused_knn"] + sm["fused_knn"] + sf["fused_knn"]
             + sh["fused_knn"] + rt["fused_knn"] + ops["fused_knn"]
             + du["fused_knn"],
             **b1),
        dict(name="fused_cells_knn", route="cuda",
             source="raft_tpu_torch/csrc/cells_knn.cu",
             replaces="raft_tpu/ops/fused_knn.py:426",
             launches=mp["launches"]["fused_cells_knn"]
             + sv["fused_cells_knn"] + lc["fused_cells_knn"]
             + sm["fused_cells_knn"] + sf["fused_cells_knn"]
             + sh["fused_cells_knn"] + rt["fused_cells_knn"]
             + ops["fused_cells_knn"]
             + du["fused_cells_knn"], **b2),
        dict(name="fused_batch_knn", route="cuda",
             source="raft_tpu_torch/csrc/batch_knn.cu",
             replaces="raft_tpu/ops/fused_knn.py:277",
             launches=pq["launches"]["fused_batch_knn"]
             + sv["fused_batch_knn"] + lc["fused_batch_knn"]
             + sm["fused_batch_knn"] + sf["fused_batch_knn"]
             + sh["fused_batch_knn"] + rt["fused_batch_knn"]
             + ops["fused_batch_knn"]
             + du["fused_batch_knn"], **b3),
        dict(name="pq_fused_scan", route="cuda",
             source="raft_tpu_torch/csrc/pq_scan.cu",
             replaces="raft_tpu/ops/pq_scan.py:440",
             launches=pq["launches"]["pq_fused_scan"] + sv["pq_fused_scan"]
             + lc["pq_fused_scan"] + sm["pq_fused_scan"]
             + sf["pq_fused_scan"] + sh["pq_fused_scan"]
             + rt["pq_fused_scan"] + ops["pq_fused_scan"]
             + du["pq_fused_scan"], **b4),
        dict(name="stream_extract", route="cuda",
             source="raft_tpu_torch/csrc/stream_select.cu",
             replaces="raft_tpu/matrix/select_k.py:218", **b5),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
