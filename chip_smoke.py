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
   17, 256), cap off the 128-slot tile, d in {24, 32, 40, 128, 385,
   1024} and on operands off 16-byte alignment, its f32 tier on f32 rows
   and its bf16 tiers on bf16, u8 and int8 rows; B3 on its paths (its
   tensor-core scan, B2's scans),
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
   and timed there beside ``addmm`` + ``argmin``, with the path each tier
   took (the bf16 tiers' tensor-core scan of ``csrc/knn_mma.cu``, the
   f32 tier's 3xTF32 tensor-core scan of ``csrc/knn_tf32.cu``) and
   ptxas' registers and spills of both scans, and timed at a 16-row
   request against the 1M rows (k=10 and 100); the f32 tier's bound is
   its three TF32 products' (beside the FP32 pipes'); B2's f32 tier at
   k=10 and k=1 with
   its plan, its pre-pass's device-time share and its share of the
   search, and both of its bf16 tiers (the tensor-core scan of
   ``csrc/cells_mma.cu``) on a bf16 copy of the store, each held against
   its plain version and timed beside its bound, plain version and
   library yardstick (gather + bf16 ``baddbmm`` + ``torch.topk``), with
   their plans and ptxas' registers and spills of both scans;
6. the IVF-PQ path on the same rows and queries, the counters again set to
   0 before it and read after each step: build with 1024 lists (pq_dim 64,
   pq_bits 8), the compressed search with 32 probes (through B4, recall@10
   >= 0.80 against brute force), 100 candidates a query from the same
   search for phase 17's ``refine_host``, the LUT-scan engine and the
   recon tier (``reconstructed()`` then ``engine="bucketed"``,
   ``bucket_cap=256``,
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
16. the breadth modules (run after phase 7, while phase 4's index is as
    phase 4 built it), counters set to 0 before its one search and read
    after: (a) ``linalg.rsvd`` of rank 32 of X_r = (X V) V^T (V an
    orthonormal 128 x 32, so X_r has rank 32 exactly), its singular
    values and reconstruction against float64 ``eigvalsh`` of X_r^T X_r;
    (b) ``svd_qr``, ``svd_eig``, ``lstsq_svd`` and ``lstsq_eig`` on X
    with y = X w (singular values against float64, w recovered),
    ``eig_dc`` / ``eig_sel_dc`` on X's 128 x 128 covariance, and
    ``cholesky_rank_one_update`` at 1024 x 1024 against float64
    ``cholesky(A + v v^T)``; (c) ``masked_l2_nn`` as IVF-Flat's probe
    mask (y = phase 4's rows in list order, the groups its 1024 lists,
    each query allowed the 32 lists its coarse step probes) against the
    index's k=1 search with 32 probes (distances within ``norm_tol``,
    ids but at near-ties; one B2 launch) and, on 100 queries, against
    float64 on the card, with its time and tile; (g) its trace ranges
    in a ``torch.profiler`` trace of one call; (d) the linear,
    polynomial, tanh and RBF gram kernels at 10,000 x 10,000 over the
    queries, 100 rows against float64; (e) ``reduce_rows_by_key`` of X
    by IVF list, ``row_norm``, ``normalize`` and ``matrix.argmin`` at 1M
    x 128 against float64; (f) ``synchronize`` on about 1 s of queued
    matmuls, cancelled from a second thread 0.1 s in (raised within 4
    polls, the stream still busy), then an uncancelled one that returns
    with the stream idle;
17. ``random/``, Lloyd k-means, ``refine_host``, ``stats/`` and ``label/``
    (after phase 16, on phase 4's rows and phase 6's candidates), counters
    set to 0 before it and read after its last step: (a) the fourteen
    draws of ``random.rng`` (``uniform`` ... ``rng_fill``), 10M values
    each on the card, means and variances within 6 standard errors of the
    distribution's (its excess kurtosis gives the variance's), supports
    and dtypes kept, ``discrete``'s frequencies (a zero weight never
    drawn); ``sample_without_replacement`` of 100,000 of 1M with half the
    weights 4x (distinct, in range, the heavy share within 6 standard
    errors of the Gumbel-top-k inclusion law), ``permute`` of 1M, and
    ``multi_variable_gaussian`` (both methods) of 1M rows under a 128 x 128
    covariance (every mean and covariance entry within 6 standard
    errors); ``rmat_rectangular_gen`` at 2^20 x 2^20 with 16M edges
    (int32 ids in range, each level's quadrant shares within 6 standard
    errors of theta); (b) ``make_blobs`` of 1M x 128 around 1000 centers
    uniform in [-10, 10] with std 1, Lloyd ``fit`` from
    ``InitMethod.Array`` at those centers (max_iter 20; ARI >= 0.999
    against the blobs' labels, inertia within 1e-5 of float64), its
    first split-bf16 and its final f32 B1 launch held against the plain
    version on their operands, a k-means++ fit at 100,000 x 128 x 64,
    and, after the counters are read, B1 at 1M x 1000 x 128 (k=1) on both
    tiers beside ``addmm`` + ``argmin`` and each tier's bound, with the
    path each tier took and the split tier's plain version (the
    tensor-core scan's figures in the ``kernels`` line); (c)
    ``find_k`` on ``make_blobs(200,000 x 32, 8 centers, std 0.3)`` with
    kmax 16 returns 8; (d) ``refine_host`` of phase 6's 100 IVF-PQ
    candidates for each query to k=10 through the port's native library
    (ids = the card's ``refine`` but at near-ties, distances within
    ``norm_tol``), with its time and the library's build time; (e)
    ``mean``, ``vars_``, ``stddev``, ``cov``, ``weighted_mean`` within
    1e-5 of float64 (of each column's scale), ``minmax`` bit for bit,
    ``histogram`` with at most 1e-5 of the entries across a bin edge,
    ``silhouette_score`` on 20,000 rows and ``trustworthiness_score`` of
    5,000 rows against their rank-32 projection held to float64, the
    label metrics of (b)'s labels against the blobs' (contingency table
    bit for bit, the rest within 1e-5 of float64 and of each other) and
    ``r2_score`` of ``lstsq_svd`` on noise-free ``make_regression`` data
    within 1e-5 of 1; (f) ``get_unique_labels``, ``make_monotonic`` and
    ``merge_labels`` on (b)'s 1M labels against numpy;
18. the sparse layer (after phase 17, on phase 4's rows), counters set
    to 0 before it and read after its last step: (a)
    ``sparse.neighbors.knn_graph`` of the first 250,000 of the 1M x 128
    rows, k=15 (one B1 launch of k=16 per 131,072-query chunk): 15 edges
    a row, no self edge, 1000 sampled rows' ids equal to an exact float64
    kNN on the card but at near-ties and distances within ``norm_tol``,
    the first launch's first 4096 queries held against B1's plain
    version, and, after the counters are read, B1 at the chunk shape
    against all 1M rows beside ``addmm`` + ``topk`` and its bound; (b) on
    that graph, ``symmetrize``,
    ``coo_to_csr`` / ``csr_to_coo``, ``coo_sort``, ``max_duplicates``,
    ``transpose``, ``add`` (A + A^T), ``degree``, both row
    normalisations, both Laplacians, ``slice_csr`` of the middle 100,000
    rows and ``remove_zeros`` after zeroing a seeded 1% of the values,
    each against scipy.sparse in float64 on the host (structures bit for
    bit, values within rtol 1e-5), ``spmv`` and ``spmm`` (16 columns)
    likewise and bit for bit over two runs; (c) ``connected_components``
    of the symmetrised graph against scipy's (each label its component's
    smallest id; its steps printed against the cap of 64),
    ``connect_components`` (every edge across components; 1000 sampled
    rows against a float64 nearest other-component row) and ``mst`` over
    both edge sets (n - C edges, C scipy's count of the union; weight
    within 1e-5 of scipy's ``minimum_spanning_tree`` of the min-reduced
    edges; the host union-find's time on its own line); (d) Lanczos on M
    = D + 1e-3 A_hat (A_hat the graph's normalised adjacency, D a seeded
    diagonal with 8 values planted at each end): the 8 largest and
    smallest eigenvalues within 2e-3 of the planted, float64 residuals
    within 1e-3 ||M||, two runs bit for bit; (e) TF-IDF-shaped rows
    (100,000 x 50,000, row nnz 32-256, Zipf columns, unit-L2 rows, drawn
    with ``random/`` on the card): ``brute_force_knn`` k=10 for
    L2Expanded, CosineExpanded and InnerProduct (x-dense gram engine), L1
    and JensenShannon (semiring), CosineExpanded with 4096 queries
    against the first 20,000 rows (block-packed scan), and
    ``pairwise_distance`` 2048 x 20,000 for L2Expanded and
    HellingerExpanded, each call's engine asserted, 32 queries (kNN) or
    256 rows (pairwise) held to float64 within 1e-4 (ids but at
    near-ties), each call timed;
19. the last modules (after phase 18), counters set to 0 before it and
    read after its last step: (a) ``LinearAssignmentProblem`` on 8 x
    1024 x 1024 integer (in [0, 100)) and uniform float costs and
    ``lap`` on each slice: slices bit for bit equal, permutations,
    integer objectives equal to scipy's optimum, float ones within 4e-6
    n span of it; (b) ``eps_neighbors_l2sq`` on 10,000 x 100,000 x 32
    Gaussian rows at eps^2 = the median of 10,000 float64 pair
    distances, against float64 on the card (entries may differ only
    within 1e-5 of eps^2), degrees and their total; (c) ball cover on
    1M terrain rows (x, y in [-1, 1), z noise 1e-3; L2SqrtUnexpanded)
    and 1M (lat, lon) rows (Haversine): build, 10,000 queries at k=32
    with 1000 held to float64 (L2 squared within the expanded form's
    rounding, haversine within 1e-5; every id clearly inside the float64
    k nearest present, a differing id only at a near-tie), ``eps_nn`` of
    1000 queries, ``all_knn_query`` of 200,000 rows at k=16, and 64
    queries 2000 above the terrain at k=64, which take the dense scan
    through B5 (held bit for bit to the same index on the CPU, and their
    distances to the k smallest of the same f32 distances); (d)
    ``single_linkage``: KNN_GRAPH on 200,000 x 32 rows in 16 blobs far
    apart (ARI 1, heights = its MST's sorted weights, MST weight within
    1e-5 of scipy's over the same edges; B1 in its kNN graph), PAIRWISE
    on 4096 x 32 (heights within 1e-5 of scipy's linkage); (e)
    ``partition`` of 4000 vertices in 8 bridged blobs (ARI >= 0.999,
    residuals within 1e-3 ||L||, ``analyze_partition`` against float64;
    B1 in Lloyd) and ``modularity_maximization`` of a 4096-vertex
    planted partition (ARI >= 0.999, ``analyze_modularity`` against
    float64); (f) every ``spatial.knn`` alias the port's object, its
    ``brute_force_knn`` of 1000 queries = phase 4's but for exact-tie
    order; the phase's seconds and peak device memory;
20. the facades (after phase 19, while phase 4's index is as phase 4
    built it), counters set to 0 before each step and read after it,
    through ``pylibraft_torch`` and ``raft_dask_torch`` calls alone: (a)
    ``brute_force.knn`` of phase 4's queries (B1; ids and distances =
    phase 4's bit for bit) and of 1000 numpy queries with no handle, which
    land on the card; (b) ``ivf_flat.build`` with 1024 lists (B1) and
    ``search`` with 32 probes (B2, recall@10 >= 0.995), and phase 4's
    index wrapped as ``ivf_flat.Index`` answering as phase 4 did, bit for
    bit; (c) ``ivf_pq.build`` (pq_dim 64, pq_bits 8; B1), the compressed
    search with 32 probes (B4, recall@10 >= 0.80) and ``refine`` of its
    100 candidates a query to k=10 (at least the search's recall); (d)
    ``kmeans.fit`` from ``InitMethod.Array`` at 1M x 128 x 1000 blobs
    (B1; ARI >= 0.999 against the blobs and against the port's own fit,
    inertia and ``cluster_cost`` within 1e-5 of float64),
    ``fused_l2_nn_argmin`` (B1; 100,000 rows against float64 but at
    near-ties), ``pairwise_distance`` on five metrics at 1000 x 1000 from
    numpy (within phase 11's bar of float64) and ``rmat`` of 1M edges into
    a ``device_ndarray`` on the card (each level's quadrant shares within
    6 standard errors of theta); (e) ``save`` / ``load`` of (b) and (c),
    the loaded indexes searching bit for bit as the saved ones; (f) a
    ``raft_dask_torch.Comms`` session that starts a NCCL world of one from
    its coordinator address, and one over phase 12's 4 gloo ranks: the
    seven self-tests True on every rank; the phase's seconds, launches and
    peak device memory;
21. the reference bench's configurations the port had not run on the
    card (after phase 20, before the serve phase, IVF-PQ's recon cache
    dropped), counters set to 0 before it, each part's seconds (host
    clock around a synchronise), launches and peak device memory printed
    with the card line: (a) bench.py's SIFT-shaped u8 rows (1M x 128,
    seed 11) written and read back byte for byte through the native
    ``write_bvecs`` / ``read_bvecs``, B1's exact answer, IVF-Flat on the
    u8 rows (storage stays uint8; ``engine="bucketed"`` reaches B2's bf16
    + split-query tier, which must get the index's own uint8 rows, no bf16
    copy; recall@10 >= 0.995; the device split of a search by
    ``torch.profiler``), the same rows shifted by -128 into an int8 store
    (queries and centers alike: ids equal the u8 answer but at near-ties
    within ``norm_tol`` where both frames probe the same lists), IVF-PQ
    (B4, >= 0.80) and its
    ``min_recall=0.95`` recipe over the retained u8 rows (>= 0.99); (b)
    bench.py's uniform queries (N(0, 1) x 10) on phase 4's IVF-Flat (B2:
    at 32 probes every exact neighbour of a probed list found but at
    near-ties, none from another list, and the share of the exact
    neighbours within 32-256 probes printed; recall@10 >= 0.99 at 256
    probes) and phase 6's IVF-PQ (B4, native >= 0.75, ``min_recall=0.86``
    >= 0.86), and the int8 codeword tables on the main path's queries (B4
    launched with int8 tables, recall within 0.02 of phase 6's); (c) both
    scan engines at 10,000 queries and 32 probes (IVF-Flat = phase 4's
    answer but at near-ties within ``norm_tol``; the LUT scan within 0.01
    of the compressed tier's recall; neither launches B2 or B4); (d)
    PER_CLUSTER codebooks at 1M (B3, never B4; recall@10 >= 0.80 on 1000
    queries) and OPQ (``opq_iters=1``; B4 recall within 0.01 of phase
    6's, a lower reconstruction error than phase 6's index); (e) 10M x
    128 rows from ``make_blobs`` on the card (4000 blobs, sigma 5), an
    IVF-PQ of 4096 lists built with ``retain_dataset=False`` (trainset
    fraction 0.05) that keeps no source, the device memory falling by the
    rows' bytes when they are deleted, the compressed search (B4,
    recall@10 >= 0.80), a ``min_recall=0.95`` search that warns and
    answers the native search bit for bit, and the largest list within
    B4's per-list budget; the phase's seconds, launches and peak memory;
22. a ``kernels`` line (B1 twice: its f32 tier's 3xTF32 tensor-core scan
    at the brute-force shape, its bf16 tiers' tensor-core scan at
    Lloyd's; B2 twice: its f32 tier's FMA scan and its split tier's
    tensor-core scan, both at the main-path cells), the card line, and
    the result line.

From phase 3 on, every B1 and B2 launch of this process is held to its
tier's scan (:class:`B1Tiers`, :class:`B2Tiers`): every B1 request and
a bf16 B2 request must go through a tensor-core scan
(``fused_knn.mma_launches``, ``fused_cells_knn.mma_launches``; a B1
f32 request through knn_tf32.cu's, ``fused_knn.tf32_launches``), an f32
B2 request through the FMA scan, checked after each phase; phases 4, 6, 17 and 20 must each run B1's
split-bf16 tier, phases 3, 5 and 21 B2's bf16 tiers.

The data is made with numpy from a fixed seed: 1000 Gaussian blobs
(centers uniform in [-10, 10], sigma 5), queries = database rows + N(0, 1).
The script imports none of JAX, raft_tpu, pylibraft and raft_dask.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
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
# selection path (1, 10, 16 | 17, 256), d off the 16-feature chunk and the
# 64-feature panel (40, 24, 385), d at MAX_DIM (1024).
B2_CASES = ((6, 300, 32, 9, 64, 10), (5, 129, 128, 7, 8, 256),
            (4, 2048, 128, 6, 64, 1), (6, 300, 40, 9, 65, 16),
            (6, 1000, 24, 9, 65, 17), (4, 300, 385, 5, 65, 10),
            (4, 300, 1024, 5, 64, 17))
# B2's (store, bf16, qsplit) combinations: the f32 tier on f32 rows, the
# bf16 tiers on bf16 rows, the split tier on the u8 / int8 stores of 8-bit
# indexes (int8 rows shifted by -4, so that they hold negative values).
B2_STORES = (("f32", False, False), ("bf16", True, False),
             ("bf16", True, True), ("u8", True, True), ("i8", True, True))
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
# Phase 16: the breadth modules (linalg, matrix ops, gram kernels, masked
# nearest neighbor, cancellation, trace ranges).
RANK_16 = 32              # rsvd's rank, and the exact rank of its input
N_CHECK_16 = 100          # rows held to float64 on the card
CHOL_16 = 1024            # order of the Cholesky rank-one update
SYNC_S_16 = 1.0           # seconds of matmuls queued before the cancel
CANCEL_AFTER_16 = 0.1     # seconds from the sync's start to the cancel
POLL_16 = 0.05            # synchronize's poll interval
# Relative tolerances of phase 16, each with its reason in breadth_phase.
SVAL_RTOL_16 = 1e-4       # rsvd / svd_qr singular values
RECON_RTOL_16 = 1e-4      # rsvd's reconstruction (Frobenius)
SVD_EIG_RTOL_16 = 1e-3    # svd_eig (squares the condition number)
LSTSQ_RTOL_16 = 1e-4      # lstsq_svd's w
LSTSQ_EIG_RTOL_16 = 1e-3  # lstsq_eig's w (normal equations)
EIG_RTOL_16 = 1e-3        # eig_dc, of the largest (the reference's test)
CHOL_RTOL_16 = 1e-4       # the updated factor, of its largest entry
KEYSUM_RTOL_16 = 3e-5     # keyed sums, of each key's sum of |x|
EIGVEC_RTOL_16 = 1e-3     # eig_dc's residual |C v - v w|, of |C|
NORM_RTOL_16 = 1e-5       # row norms
UNIT_ATOL_16 = 1e-6       # normalized rows (entries of at most 1)
# Phase 17: random/, Lloyd k-means, refine_host, stats/ and label/.
N_DRAWS_17 = 10_000_000   # values of each rng draw
N_SWOR_17 = 1_000_000     # sample_without_replacement's population ...
N_SAMPLE_17 = 100_000     # ... and its sample
N_MVG_17 = 1_000_000      # multi_variable_gaussian rows (DIM wide)
SE_17 = 6.0               # bar of every moment / frequency, in std errors
RMAT_SCALE_17 = 20        # rmat_rectangular_gen: 2^20 x 2^20 ...
RMAT_EDGES_17 = 16_000_000  # ... with 16M edges
RMAT_THETA_17 = (0.57, 0.19, 0.19, 0.05)
N_CLUSTERS_17 = 1000      # Lloyd k-means (B1 k=1 on every assignment)
BLOB_STD_17 = 1.0
MAX_ITER_17 = 20
ARI_17 = 0.999
N_PP_17, PP_K_17 = 100_000, 64    # the k-means++ fit
FINDK_17 = (200_000, 32, 8, 0.3, 16)  # rows, dim, blobs, std, kmax
N_CAND_17 = 100           # phase 6's candidates per query, refined to K
N_SIL_17 = 20_000         # silhouette sample
N_TRUST_17, TRUST_RANK_17, TRUST_K_17 = 5_000, 32, 10
N_BINS_17 = 64
# Relative tolerances of phase 17, each with its reason where it is used.
INERTIA_RTOL_17 = 1e-5    # inertia against float64
STAT_RTOL_17 = 1e-5       # f32 reductions over 1M rows against float64
HIST_MOVED_17 = 1e-5      # share of entries binned across an edge
METRIC_RTOL_17 = 1e-5     # silhouette, label metrics against float64
TRUST_ATOL_17 = 1e-5      # trustworthiness against float64
R2_ATOL_17 = 1e-5         # 1 - r2 of a noise-free least squares

# Phase 18: the sparse layer.
ROWS_18 = 250_000         # rows of (a)-(d), the first of phase 4's X (cut
                          # from 1M to keep the script under 900 s)
K_18 = 15                 # kNN-graph degree (B1 with k = 16)
N_SAMPLE_18 = 1000        # rows of (a) and (c) held to float64
N_PLAIN_18 = 4096         # queries of the first B1 launch held to plain
N_SLICE_18 = 100_000      # rows of slice_csr
ZERO_FRAC_18 = 0.01       # values zeroed before remove_zeros
SPMM_COLS_18 = 16
VAL_RTOL_18 = 1e-5        # graph ops and the MST weight against scipy
EIG_K_18 = 8              # eigenpairs at each end
EIG_EPS_18 = 1e-3         # M = D + eps A_hat
EIG_TOL_18 = 2e-3         # eigenvalues against the planted ones
RESID_18 = 1e-3           # float64 residuals, of ||M||
TFIDF_18 = (100_000, 50_000, 32, 256)  # rows, columns, row nnz bounds
ZIPF_18 = 1.07            # column weights ~ rank^-1.07
N_TFIDF_Q_18 = 2048       # queries of the x-dense and semiring calls
N_BLOCKED_18 = (4096, 20_000)  # queries x rows of the blocked call
K_TFIDF_18 = 10
N_CHECK_18 = 32           # queries of each kNN call held to float64
N_PAIR_ROWS_18 = 256      # rows of each pairwise call held to float64
SPARSE_TOL_18 = 1e-4      # tests/test_sparse.py's tolerance

# Phase 19: solver/, ball cover, the epsilon neighborhood, single linkage,
# spectral/ and spatial.knn.
LAP_19 = (8, 1024)        # batch x size of the assignment problems
LAP_INT_19 = 100          # integer costs in [0, 100): n * eps_floor < 1
LAP_EPS_19 = 4e-6         # float costs: within 4e-6 n span of scipy's
EPS_SHAPE_19 = (10_000, 100_000, 32)  # eps_neighbors_l2sq: x, y rows, dim
N_EPS_PAIRS_19 = 10_000   # pairs whose float64 median is eps^2
EPS_BAND_19 = 1e-5        # relative band of eps^2 where adjacency may differ
BC_ROWS_19 = 1_000_000    # ball cover: terrain (x, y, z) and (lat, lon) rows
BC_Z_STD_19 = 1e-3        # the terrain's height noise; (x, y) in [-1, 1)^2
BC_QUERIES_19 = 10_000
BC_K_19 = 32
BC_CHECK_19 = 1000        # queries held to float64
BC_ALL_19 = (200_000, 16)  # all_knn_query rows and k
BC_EPS_19 = (1000, 0.01)  # eps_nn queries and radius (~78 rows each)
BC_FAR_19 = (64, 64, 2000.0)  # queries above the terrain, k, height
HAV_TOL_19 = 1e-5         # haversine distances against float64
SL_KNN_19 = (200_000, 32, 16, 15)  # single linkage: rows, dim, blobs, c
SL_BOX_19 = 1000.0        # blob centers uniform in [-1000, 1000]
SL_PAIR_19 = (4096, 32)   # the pairwise connectivity's rows, dim
SL_RTOL_19 = 1e-5         # MST weight and heights against scipy
SPEC_19 = (4000, 16, 8, 15)  # partition: rows (cut from 100,000), dim,
                             # blobs, kNN degree
SPEC_BRIDGES_19 = 600     # unit edges joining consecutive blobs
SPEC_RESID_19 = 1e-3      # float64 residuals, of ||L||
MOD_19 = (4096, 8, 0.05, 0.002)  # planted partition: n, blocks, p_in, p_out
ARI_19 = 0.999

# Phase 20: the pylibraft and raft_dask facades over the port
# (pylibraft_torch, raft_dask_torch), at the main path's shapes.
N_NUMPY_20 = 1000         # numpy queries of (a)'s second call
PQ_DIM_20, PQ_BITS_20 = 64, 8
N_CAND_20 = 100           # IVF-PQ candidates a query, refined to K
N_CHECK_20 = 100_000      # rows of (d)'s arg-min held to float64
N_PAIRWISE_20 = 1000
PAIRWISE_20 = ("euclidean", "sqeuclidean", "cityblock", "cosine",
               "inner_product")
RMAT_SCALE_20 = 20        # rmat: 2^20 x 2^20 ...
RMAT_EDGES_20 = 1_000_000  # ... with 1M edges
DASK_SELF_TESTS_20 = ("perform_test_comms_allreduce",
                      "perform_test_comms_allgather",
                      "perform_test_comms_bcast",
                      "perform_test_comms_reduce",
                      "perform_test_comms_reducescatter",
                      "perform_test_comms_send_recv",
                      "perform_test_comm_split")

# Phase 21: the reference bench's configurations the port had not run on
# the card, at the bench's sizes (bench.py:292-297, :349-380, :452-580).
SIFT_21 = (1_000_000, 128, 1000, 1000)  # u8 rows, dim, centers, queries
SIFT_SEED_21 = 11         # the bench's generator, also of (b)'s queries
RECALL_U8_FLAT_21 = 0.995
RECALL_U8_PQ_21 = 0.80
RECALL_U8_REFINED_21 = 0.99  # min_recall=0.95 over the u8 source
N_UNIFORM_21 = 1000       # uniform queries, N(0, 1) x 10
RECALL_UNI_FLAT_21 = 0.99  # IVF-Flat at UNI_PROBES_21 probes: the exact
UNI_PROBES_21 = 256        # neighbours of such queries spread over more
COVER_PROBES_21 = (32, 64, 128, 256)  # lists than 32 probes reach
RECALL_UNI_PQ_21 = 0.75
MIN_RECALL_UNI_21 = 0.86  # the recall class asked for is its bar
INT8_GAP_21 = 0.02        # int8 tables against phase 6's f32 tables
RECALL_PER_CLUSTER_21 = 0.80
OPQ_GAP_21 = 0.01         # OPQ recall against phase 6's
BIG_21 = (10_000_000, 128, 4000, 1000, 4096)  # rows, dim, blobs, queries,
                                               # lists
BIG_SEEDS_21 = (23, 17)   # make_blobs, query noise (bench.py:552-554)
BIG_TRAIN_FRAC_21 = 0.05
RECALL_BIG_21 = 0.80

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
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

    fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")

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
            f"{len(fk._b1_tf32_plan(m, n, d, k, n_sm).bounds)} (l2/ip, "
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
        for store, bf16, qsplit in B2_STORES:
            a = list(args)
            a[2] = b2_store(a[2], store)
            for l2 in (True, False):
                kd, ki = fk._fused_cells_knn_cuda(*a, k, l2, bf16, qsplit)
                pd, pi = fk._fused_cells_knn_plain(*a, k, l2, bf16, qsplit)
                torch.cuda.synchronize()
                if not (torch.equal(ki, pi) and torch.equal(kd, pd)):
                    raise AssertionError(
                        f"B2 L={L} cap={cap} d={d} k={k} l2={l2} "
                        f"store={store} bf16={bf16} qsplit={qsplit}: "
                        f"kernel != plain")
            if k > 3 and not bool((ki[1, :, 3:] == -1).all()):
                raise AssertionError("B2 starved list did not report -1")
        mma = fk._b2_mma_plan(qrows, d, k, True, "u8")
        log(f"B2 ok L={L} cap={cap} d={d} cells={C} qrows={qrows} k={k} "
            f"rows/CTA f32 tier {fk._b2_plan(qrows, d, k).bq}, "
            f"split tier on u8 {mma.bq} in {mma.pw}-feature panels (-1 "
            f"cells, masks, starved list, f32 / bf16 / u8 / int8 stores on "
            f"their tiers, l2/ip)")
    # Contiguous operands one element past 16 bytes take the narrower
    # copies (4-byte f32, 2-byte bf16, plain loads of 8-bit rows) and must
    # still agree exactly.
    db = rng.integers(0, 2, (6, 300, 40)).astype(np.float32)
    invalid = rng.random((6, 300)) < 0.3
    cells = np.array([0, 1, -1, 2, 3, 4, 5], np.int32)
    q = rng.integers(0, 2, (7, 65, 40)).astype(np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (cells, q, db, invalid)]
    for store, bf16, qsplit in B2_STORES:
        a = list(args)
        a[2] = b2_store(a[2], store)
        views = []
        for x in (a[1], a[2]):
            v = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:]
            views.append(v.view(x.shape))
            views[-1].copy_(x)
        for l2 in (True, False):
            kd, ki = fk._fused_cells_knn_cuda(a[0], views[0], views[1], a[3],
                                              10, l2, bf16, qsplit)
            pd, pi = fk._fused_cells_knn_plain(*a, 10, l2, bf16, qsplit)
            if not (torch.equal(ki, pi) and torch.equal(kd, pd)):
                raise AssertionError(f"B2 unaligned l2={l2} store={store} "
                                     f"bf16={bf16} qsplit={qsplit}: kernel "
                                     f"!= plain")
    log("B2 ok on operands off 16-byte alignment (qrows=65 d=40 k=10, "
        "l2/ip, f32 / bf16 / u8 / int8 stores on their tiers, exact)")


def b2_store(x, store: str):
    """Integer-valued f32 rows as B2's ``store``: f32, bf16, u8, or int8
    shifted by -4 (negative values)."""
    import torch

    return {"f32": lambda: x, "bf16": lambda: x.to(torch.bfloat16),
            "u8": lambda: x.to(torch.uint8),
            "i8": lambda: (x - 4).to(torch.int8)}[store]()


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

    fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")
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
    fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")

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
                "fused_knn_mma": fk.fused_knn.mma_launches,
                "fused_knn_tf32": fk.fused_knn.tf32_launches,
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


def b1_f32_bound(m: int, n: int, d: int, nbytes: float):
    """B1's f32 tier's bound in ms, with what sets it: the larger of its
    three TF32 products (3 x 2*m*n*d operations at the TF32 peak: the split
    the kernel needs to hold an f32 gram) and ``nbytes`` at the memory
    rate; and beside it the FP32 pipes' bound (2*m*n*d at the FP32 peak)
    that a scan outside the tensor cores would have."""
    ops = 2.0 * m * n * d
    tf32, by_bytes = 3.0 * ops / PEAK_TF32, nbytes / PEAK_BYTES
    fp32 = max(ops / PEAK_FP32, by_bytes) * 1e3
    if tf32 >= by_bytes:
        return tf32 * 1e3, "operations, 3xTF32", fp32
    return by_bytes * 1e3, "bytes", fp32


def b1_entry(dev, X, Q, bf):
    """Phase 5 for B1 at the brute-force shape, and at a 16-row request
    against the same rows (k=10 and 100), both on the f32 tier."""
    import torch

    fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")

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
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = fk._b1_tf32_plan(m, n, d, K, n_sm)
    nbytes = 4.0 * (m * d + n * d) + 8.0 * m * K
    bound, by, fp32 = b1_f32_bound(m, n, d, nbytes)
    log(f"B1 timing m={m} n={n} d={d} k={K}: kernel {ms:.3f} ms "
        f"({2.0 * m * n * d / ms / 1e9:.1f} TFLOP/s of the f32 gram), plain "
        f"{plain_ms:.3f} ms, library (addmm + topk over {-(-m // chunk)} "
        f"query chunks) {lib_ms:.3f} ms, bound {bound:.3f} ms ({by}; the "
        f"FP32 pipes' {fp32:.3f} ms); plan: {plan.bq} x {plan.bn} tile, "
        f"{len(plan.bounds)} database slices, {plan.smem} B of shared "
        f"memory")
    Q16 = Q[:16].contiguous()
    for k in (10, 100):
        kd, ki = fk._fused_knn_cuda(Q16, X, k, True, False, False)
        pd, pi = fk._fused_knn_plain(Q16, X, k, True, False, False)
        rq, eq = recall(ki, pi), max_err(kd, pd)
        if rq < RECALL_BF or eq > norm_tol(Q16, X):
            raise AssertionError(f"B1 16-row request k={k} disagrees with "
                                 f"its plain version: recall {rq}, max "
                                 f"err {eq}")
        r_ms = time_ms(lambda: fk._fused_knn_cuda(Q16, X, k, True, False,
                                                  False), 11)
        r_plain = time_ms(lambda: fk._fused_knn_plain(Q16, X, k, True, False,
                                                      False), 5)
        r_lib = time_ms(lambda: torch.topk(torch.addmm(
            yn, Q16, X.t(), alpha=-2.0), k, dim=1, largest=False), 5)
        r_bound, r_by, _ = b1_f32_bound(16, n, d, 4.0 * (16 + n) * d
                                        + 8.0 * 16 * k)
        r_plan = fk._b1_tf32_plan(16, n, d, k, n_sm)
        log(f"B1 16-row request m=16 n={n} d={d} k={k} f32: kernel "
            f"{r_ms:.4f} ms, plain {r_plain:.4f} ms, library (addmm + "
            f"topk) {r_lib:.4f} ms, bound {r_bound:.4f} ms ({r_by}); "
            f"recall@{k} {rq:.6f}, max |d| err {eq:.3e}; plan: "
            f"{r_plan.bq} x {r_plan.bn} tile, {len(r_plan.bounds)} "
            f"slices")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if by == "bytes" else "operations",
            "library_ms": lib_ms}


def b1_k1_bound(m: int, n: int, d: int, bf16: bool):
    """B1's bound at k=1 in ms, with what sets it: the f32 tier's of
    :func:`b1_f32_bound` (its three TF32 products), or for the split tier
    the function's 2*m*n*d operations at the bf16 peak (its two products
    per pair are the kernel's own choice), each against the bytes of the
    f32 rows, the centers and the (distance, id) out."""
    nbytes = 4.0 * (m * d + n * d) + 8.0 * m
    if not bf16:
        bound, by, _ = b1_f32_bound(m, n, d, nbytes)
        return bound, by
    ops = 2.0 * m * n * d
    if ops / PEAK_BF16 >= nbytes / PEAK_BYTES:
        return ops / PEAK_BF16 * 1e3, "operations, bf16"
    return nbytes / PEAK_BYTES * 1e3, "bytes"


def b1_path(m: int, n: int, d: int, bf16: bool) -> str:
    """The scan and launch plan B1 takes at k=1 on a tier
    (``ops/fused_knn.py::_b1_tier_plan``)."""
    import torch

    fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")
    plan = fk._b1_tier_plan(m, n, d, 1, bf16, bf16, torch.cuda.
                            get_device_properties(0).multi_processor_count)
    scan = ("tensor-core scan (knn_mma.cu)" if isinstance(plan, fk.B1MmaPlan)
            else "3xTF32 tensor-core scan (knn_tf32.cu)")
    return (f"{scan}, {plan.bq} x {plan.bn} tile, {len(plan.bounds)} "
            f"slice(s), {plan.smem} B of shared memory")


def ptxas_kernels(lib: str, kernel: str) -> list:
    """ptxas' registers and spill stores of each entry function of
    ``lib`` whose name holds ``kernel``, from the build's log: (entry,
    registers, spill bytes). The template arguments of b1_mma_kernel
    (query rows x tile rows, tier, selection), b1_tf32_kernel (query rows
    x tile rows, selection), b2_mma_kernel (query rows, tier, selection)
    and b2_scan_kernel (query rows, selection) are read out of their
    mangled names."""
    import re

    from raft_tpu_torch.ops import _build

    out, name, spill = [], None, None
    for line in _build.BUILD_LOG.get(lib, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and kernel in name:
            sel = ("k=1", "network", "merge")
            t = re.search(r"b1_mma_kernelILi(\d+)ELi(\d+)ELb([01])ELi(\d)E",
                          name)
            t1 = re.search(r"b1_tf32_kernelILi(\d+)ELi(\d+)ELi(\d)E", name)
            t2 = re.search(r"b2_mma_kernelILi(\d+)ELb([01])ELi(\d)E", name)
            t3 = re.search(r"b2_scan_kernelILi(\d+)ELi(\d)E", name)
            short = re.search(r"(b[12]_\w*?_kernel)", name)
            if t is not None:
                label = (f"{t.group(1)}x{t.group(2)} "
                         f"{'split' if t.group(3) == '1' else 'bf16'} "
                         f"{sel[int(t.group(4))]}")
            elif t1 is not None:
                label = (f"{t1.group(1)}x{t1.group(2)} "
                         f"{sel[int(t1.group(3))]}")
            elif t2 is not None:
                label = (f"{t2.group(1)} rows "
                         f"{'split' if t2.group(2) == '1' else 'bf16'} "
                         f"{sel[int(t2.group(3))]}")
            elif t3 is not None:
                label = f"{t3.group(1)} rows {sel[int(t3.group(2))]}"
            else:
                label = short.group(1) if short else name
            out.append((label, int(m.group(1)), spill))
            name = None
    return out


def b1_kmeans_shape(dev, X, centers):
    """B1 at the k=1 assignment shapes of the IVF-Flat build, each held
    against its plain version: the trainset (half the rows) against the
    32 mesocluster-sized and the 1024 list-sized center sets on the f32 and
    split-bf16 tiers (the balancing EM runs both), and every row against
    the 1024 centers in f32 (the extend assignment). Arg-min agreement must
    reach RECALL_BF and the distances agree within ``norm_tol``; each
    launch must take its tier's tensor-core scan (the split tier
    knn_mma.cu's, the f32 tier knn_tf32.cu's). Logs the path each tier
    took, its time beside its bound (the f32 tier's three TF32 products
    beside the FP32 pipes'), its plain version and ``addmm`` + ``argmin``,
    and ptxas' registers and spills of both scans. Returns the split tier's largest
    distance error."""
    import torch

    fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")

    T = X[::2][:N_ROWS // 2].contiguous()
    C1024 = centers.contiguous()
    C32 = centers[::N_LISTS // 32].contiguous()
    cases = [("train", T, C32, "f32", False),
             ("train", T, C32, "split-bf16", True),
             ("train", T, C1024, "f32", False),
             ("train", T, C1024, "split-bf16", True),
             ("extend", X, C1024, "f32", False)]
    split_err = 0.0
    for what, A, C, tier, bf16 in cases:
        m, n, d = A.shape[0], C.shape[0], C.shape[1]
        before = (fk.fused_knn.mma_launches, fk.fused_knn.tf32_launches)
        kd, ki = fk._fused_knn_cuda(A, C, 1, True, bf16, bf16)
        mma = fk.fused_knn.mma_launches - before[0]
        tf32 = fk.fused_knn.tf32_launches - before[1]
        pd, pi = fk._fused_knn_plain(A, C, 1, True, bf16, bf16)
        torch.cuda.synchronize()
        agree = float((ki == pi).float().mean())
        err = max_err(kd, pd)
        tol = norm_tol(A, C)
        tag = f"B1 k-means {what} m={m} n={n} d={d} k=1 {tier}"
        log(f"{tag}: path {b1_path(m, n, d, bf16)} ({mma} tensor-core "
            f"launch); arg-min agreement {agree:.6f} (bar {RECALL_BF}), max "
            f"|d| err {err:.3e} (tol {tol:.3e})")
        if mma != 1 or tf32 != int(not bf16):
            raise AssertionError(f"{tag}: the launch took the wrong scan")
        if agree < RECALL_BF or err > tol:
            raise AssertionError(f"{tag}: kernel disagrees with plain")
        if bf16:
            split_err = max(split_err, err)
        del kd, ki, pd, pi
        ms = time_ms(lambda: fk._fused_knn_cuda(A, C, 1, True, bf16, bf16),
                     5)
        bound, by = b1_k1_bound(m, n, d, bf16)
        fp32 = ("" if bf16 else f", the FP32 pipes' "
                f"{b1_f32_bound(m, n, d, 4.0 * (m + n) * d + 8.0 * m)[2]:.3f}"
                f" ms")
        plain_ms = time_ms(lambda: fk._fused_knn_plain(A, C, 1, True, bf16,
                                                       bf16), 2)
        # The library yardstick of a k=1 scan: one addmm of the expanded
        # L2 (f32) and its row arg-min.
        cn = torch.sum(C * C, dim=1)
        lib_ms = time_ms(lambda: torch.argmin(
            torch.addmm(cn, A, C.t(), alpha=-2.0), dim=1), 3)
        log(f"{tag}: kernel {ms:.3f} ms, bound {bound:.3f} ms ({by}{fp32}; "
            f"{2.0 * m * n * d / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} "
            f"ms, library (addmm + argmin) {lib_ms:.3f} ms")
    for lib, kern, what in (("knn_mma", "b1_mma", "tier"),
                            ("knn_tf32", "b1_tf32", "f32 tier")):
        regs = ptxas_kernels(lib, kern)
        log(f"B1 tensor-core scan {lib} ptxas (tile, {what}, selection: "
            f"registers, spill bytes): "
            f"{[f'{n}: {r}, {sp}' for n, r, sp in regs]}")
    return split_err


def b2_entry(dev, Q, index, search_ms):
    """Phase 5 for B2 at the IVF-Flat search shape: its f32 tier (the FMA
    scan) at k=10 and k=1, its plan, the device-time share of its pre-pass,
    its share of the search and ptxas' registers and spills; then both bf16
    tiers (the tensor-core scan) on a bf16 copy of the store, each held
    against its plain version and timed beside its bound, plain version and
    library yardstick. Returns the f32 tier's numbers and the split
    tier's."""
    import torch

    from raft_tpu_torch.neighbors import ivf_flat
    fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")

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
    live = cell_list >= 0
    sizes = index.list_sizes.long()
    used = torch.unique(cell_list[live].long())
    pair_rows = float(torch.sum(sizes[probes.long()]))
    step = 512

    def check(tag, a, bf16, qsplit):
        kd, ki = fk._fused_cells_knn_cuda(*a, K, True, bf16, qsplit)
        pd, pi = fk._fused_cells_knn_plain(*a, K, True, bf16, qsplit)
        err = max_err(kd, pd)
        rec = recall(ki[live].reshape(-1, K), pi[live].reshape(-1, K))
        log(f"{tag} vs plain at main path: per-slot recall@{K} {rec:.6f}, "
            f"max |d| err {err:.3e} (tol {norm_tol(Q, data):.3e})")
        if rec < RECALL_BF or err > norm_tol(Q, data):
            raise AssertionError(f"{tag} disagrees with its plain version")
        return err, kd.numel()

    def library(y, yn, qsplit):
        """Gather + baddbmm on the tier's operands + topk, over
        ``step``-cell chunks (the port never calls it)."""
        def run():
            for s in range(0, cell_list.shape[0], step):
                lst = torch.clamp_min(cell_list[s:s + step], 0).long()
                q = Qc[s:s + step]
                yt = y[lst].transpose(1, 2)
                qh = q.to(y.dtype)
                g = torch.baddbmm(yn[lst][:, None, :], qh, yt, alpha=-2.0)
                if qsplit:
                    g.baddbmm_((q - qh.float()).to(y.dtype), yt, alpha=-2.0)
                g.masked_fill_(invalid[lst][:, None, :], float("inf"))
                torch.topk(g, K, dim=2, largest=False)
        return time_ms(run, 3)

    def bounds(row_bytes, ops, peak, n_out):
        nbytes = (4.0 * Qc.numel()
                  + row_bytes * DIM * float(torch.sum(sizes[used]))
                  + float(used.numel() * cap) + 4.0 * cell_list.numel()
                  + 8.0 * n_out)
        bound = max(ops / peak, nbytes / PEAK_BYTES) * 1e3
        return bound, ("operations" if ops / peak >= nbytes / PEAK_BYTES
                       else "bytes")

    err, n_out = check("B2", args, False, False)
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
    lib_ms = library(data, torch.sum(data * data, dim=2), False)
    bound, by = bounds(4.0, 2.0 * DIM * pair_rows, PEAK_FP32, n_out)
    log(f"B2 timing cells={cell_list.shape[0]} (used {int(live.sum())}) "
        f"qrows={qrows} cap={cap} d={DIM} k={K}: kernel {ms:.3f} ms "
        f"({ms / search_ms:.1%} of the {search_ms:.3f} ms search; k=1 "
        f"{k1_ms:.3f} ms), plain {plain_ms:.3f} ms, library (gather + "
        f"baddbmm + topk over {step}-cell chunks) {lib_ms:.3f} ms, bound "
        f"{bound:.3f} ms")
    plan = fk._b2_plan(qrows, DIM, K)
    log(f"B2 plan: {plan.bq} query rows per CTA, queries staged with every "
        f"chunk, {plan.smem} B of shared memory; device time pre-pass "
        f"{pre_ms} ms + scan {scan_ms} ms" + (
            f" (pre-pass share {pre_ms / (pre_ms + scan_ms):.1%})"
            if pre_ms and scan_ms else " (not traced)"))
    log(f"B2 FMA scan ptxas (rows, tier, selection: registers, spill "
        f"bytes): {[f'{n}: {r}, {sp}' for n, r, sp in ptxas_kernels('cells_knn', 'b2_scan')]}")
    f32 = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}

    # The bf16 tiers on a bf16 copy of the store: B2's tensor-core scan.
    data16 = data.to(torch.bfloat16)
    args16 = (cell_list, Qc, data16, invalid)
    yn16 = torch.sum(data16.float() ** 2, dim=2).to(torch.bfloat16)
    split = None
    for tier, qsplit in (("bf16", False), ("split", True)):
        tag = f"B2 {tier} tier"
        before = fk.fused_cells_knn.mma_launches
        err, n_out = check(tag, args16, True, qsplit)
        if fk.fused_cells_knn.mma_launches != before + 1:
            raise AssertionError(f"{tag}: the launch missed the tensor-core "
                                 f"scan")
        ms = time_ms(lambda: fk._fused_cells_knn_cuda(*args16, K, True, True,
                                                      qsplit), 5)
        k1_ms = time_ms(lambda: fk._fused_cells_knn_cuda(
            *args16, 1, True, True, qsplit), 5)
        plain_ms = time_ms(lambda: fk._fused_cells_knn_plain(
            *args16, K, True, True, qsplit), 2)
        pre_ms = device_ms(lambda: fk._fused_cells_knn_cuda(
            *args16, K, True, True, qsplit), "b2_norms_kernel", reps=5)
        scan_ms = device_ms(lambda: fk._fused_cells_knn_cuda(
            *args16, K, True, True, qsplit), "b2_mma_kernel", reps=5)
        lib_ms = library(data16, yn16, qsplit)
        # The function's products: one bf16 gram, two with the split query.
        ops = 2.0 * DIM * pair_rows * (2 if qsplit else 1)
        bound, by = bounds(2.0, ops, PEAK_BF16, n_out)
        plan = fk._b2_mma_plan(qrows, DIM, K, qsplit, "bf16")
        log(f"{tag} timing (bf16 store) cells={cell_list.shape[0]} "
            f"qrows={qrows} cap={cap} d={DIM} k={K}: kernel {ms:.3f} ms "
            f"(k=1 {k1_ms:.3f} ms; {ops / ms / 1e9:.1f} TFLOP/s), plain "
            f"{plain_ms:.3f} ms, library (gather + bf16 baddbmm"
            f"{' x2' if qsplit else ''} + topk over {step}-cell chunks) "
            f"{lib_ms:.3f} ms, bound {bound:.3f} ms ({by}, bf16 tensor "
            f"cores); plan {plan.bq} query rows per CTA, {plan.pw}-feature "
            f"panels, {plan.smem} B of shared memory; device time pre-pass "
            f"{pre_ms} ms + scan {scan_ms} ms")
        if qsplit:
            split = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
    log(f"B2 tensor-core scan ptxas (rows, tier, selection: registers, "
        f"spill bytes): {[f'{n}: {r}, {sp}' for n, r, sp in ptxas_kernels('cells_mma', 'b2_mma')]}")
    return f32, split


def _counted():
    """Every launch counter, by kernel name: the wrapper that keeps it and
    its attribute. ``fused_knn`` counts every B1 launch, ``fused_knn_mma``
    those of a tensor-core scan among them (every one), ``fused_knn_tf32``
    those of its f32 tier's 3xTF32 scan (knn_tf32.cu) among those;
    ``fused_cells_knn`` and ``fused_cells_knn_mma`` every B2 launch and
    those of its bf16 tiers' tensor-core scan."""
    fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")
    from raft_tpu_torch.ops import pq_scan as ps
    from raft_tpu_torch.ops import stream_select as ss

    return {"fused_knn": (fk.fused_knn, "launches"),
            "fused_knn_mma": (fk.fused_knn, "mma_launches"),
            "fused_knn_tf32": (fk.fused_knn, "tf32_launches"),
            "fused_cells_knn": (fk.fused_cells_knn, "launches"),
            "fused_cells_knn_mma": (fk.fused_cells_knn, "mma_launches"),
            "fused_batch_knn": (fk.fused_batch_knn, "launches"),
            "pq_fused_scan": (ps.pq_fused_scan, "launches"),
            "stream_extract": (ss.stream_extract, "launches")}


#: The counters of B1's launches: the phases that "launch B1 and only B1"
#: may show both.
B1_COUNTERS = ("fused_knn", "fused_knn_mma", "fused_knn_tf32")


def _zero_counters() -> None:
    for fn, attr in _counted().values():
        setattr(fn, attr, 0)


def _launches():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counted().items()}


class TierCheck:
    """Wraps a kernel's launcher for the rest of the run and tells each
    launch's requested tier from the scan it took: a bf16 request must add
    one to the wrapper's ``mma_launches`` (its tensor-core scan); an f32
    request must too where ``f32_mma`` (B1's 3xTF32 scan), and must not
    elsewhere (B2's FMA scan). ``take`` checks the launches since the last
    ``take`` and fails on any that went the other way."""

    def __init__(self, kernel: str, launcher: str, wrapper: str,
                 bf16_at: int, f32_mma: bool):
        self.fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")
        self.kernel = kernel
        self.f32_mma = f32_mma
        self.seen = {"bf16": 0, "bf16_mma": 0, "f32": 0, "f32_mma": 0}
        self.mark = dict(self.seen)
        launch = getattr(self.fk, launcher)
        counter = getattr(self.fk, wrapper)

        def counted(*args):
            before = counter.mma_launches
            out = launch(*args)
            tier = "bf16" if args[bf16_at] else "f32"
            self.seen[tier] += 1
            self.seen[tier + "_mma"] += counter.mma_launches - before
            return out

        setattr(self.fk, launcher, counted)

    def take(self, phase: str) -> dict:
        got = {k: self.seen[k] - self.mark[k] for k in self.seen}
        self.mark = dict(self.seen)
        log(f"{phase}: {self.kernel} bf16 launches {got['bf16']}, through "
            f"the tensor-core scan {got['bf16_mma']}; f32 launches "
            f"{got['f32']}, through the tensor-core scan {got['f32_mma']}")
        f32_want = got["f32"] if self.f32_mma else 0
        if got["bf16_mma"] != got["bf16"] or got["f32_mma"] != f32_want:
            raise AssertionError(f"{phase}: a {self.kernel} launch took the "
                                 f"wrong scan for its tier: {got}")
        return got


class B1Tiers(TierCheck):
    """B1's launches: every tier through ``fused_knn.mma_launches`` (the
    bf16 tiers the tensor-core scan of csrc/knn_mma.cu, the f32 tier the
    3xTF32 one of csrc/knn_tf32.cu)."""

    def __init__(self):
        super().__init__("B1", "_fused_knn_cuda", "fused_knn", 4, True)


class B2Tiers(TierCheck):
    """B2's launches: the bf16 tiers through ``fused_cells_knn.
    mma_launches`` (the tensor-core scan of csrc/cells_mma.cu), the f32
    tier through the FMA scan of csrc/cells_knn.cu."""

    def __init__(self):
        super().__init__("B2", "_fused_cells_knn_cuda", "fused_cells_knn",
                         6, False)


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
    # Phase 17 (d) re-ranks these candidates on the host.
    before = _launches()
    _, cand = ivf_pq.search(sp, index, Q, N_CAND_17)
    steps["candidates"] = _step(before)

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
            or steps["candidates"]["pq_fused_scan"] < 1
            or steps["recon"]["fused_batch_knn"] < 1
            or steps["decode_scan"]["fused_batch_knn"] < 1):
        raise AssertionError(f"a kernel of the IVF-PQ path did not launch: "
                             f"{steps}")
    total = {k: sum(st[k] for st in steps.values())
             for k in steps["build"]}
    return {"index": index, "launches": total, "search_ms": search_ms,
            "probes_sub": probes, "rotq_sub": rotq, "recall": rec,
            "compressed": (cd, ci), "candidates": cand}


def b4_entry(dev, Q, index, search_ms):
    """Phase 6 timings for B4 at the compressed-search shape."""
    import torch

    from raft_tpu_torch.distance.pairwise import gram
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
    from raft_tpu_torch.ops import _build
    fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")
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

    fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")

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
    fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")

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
    fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")

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

    sk = importlib.import_module("raft_tpu_torch.matrix.select_k")
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
    fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")

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
        p15 = _rank_work_durable(rank, data_dir, cfg)
        results.put((rank, {"p12": p12, "p13": p13, "p14": p14, "p15": p15,
                            "p20": _rank_work_dask(rank, data_dir, cfg)}))
    except Exception:
        results.put((rank, {"error": traceback.format_exc()}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(dev, X, Q, centers, model, stream):
    """The 4-rank gloo world on the one card, which runs phases 12 (b),
    13 (b), 14 (b), 15 (b) and 20 (f) in turn: X, Q, phase 4's centers, phase 6's
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


# ---------------------------------------------------------------------------
# Phase 16: the breadth modules


def _rel(a, b) -> float:
    """|a - b| / |b| (Frobenius), in float64."""
    import torch

    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _timed(fn):
    """``fn()`` and its seconds, the card synchronised on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def breadth_decomp(dev, X, card) -> dict:
    """Phase 16 (a) and (b): rsvd of an exactly rank-32 corpus, both SVDs,
    both least squares, the eigensolvers and the Cholesky rank-one update,
    each against float64 on the card. Returns the step seconds."""
    import torch

    from raft_tpu_torch import linalg
    from raft_tpu_torch.core.resources import DeviceResources
    from raft_tpu_torch.linalg import decomp

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 16)
    secs = {}
    # (a) X_r = (X V) V^T with V orthonormal (128 x 32) has rank 32 up to
    # f32 rounding: rsvd's 32 components hold all of it, and its 33rd
    # singular value is rounding noise, so no check sits near a threshold.
    V = torch.linalg.qr(torch.randn((DIM, RANK_16), generator=gen,
                                    dtype=torch.float64, device=dev)).Q
    Vf = V.float()
    Xr = (X @ Vf) @ Vf.T
    (u, sv, v), secs["rsvd"] = _timed(lambda: linalg.rsvd(
        Xr, RANK_16, handle=DeviceResources(dev, seed=SEED)))
    Xd = Xr.double()
    true = torch.sqrt(torch.clamp_min(torch.linalg.eigvalsh(Xd.T @ Xd), 0)
                      ).flip(0)
    del Xd
    s_err = float(torch.max(torch.abs(sv.double() - true[:RANK_16])
                            / true[:RANK_16]))
    recon = _rel((u * sv) @ v.T, Xr)
    log(f"phase 16 (a): rsvd({N_ROWS} x {DIM}, k={RANK_16}) "
        f"{secs['rsvd']:.3f} s; singular values off float64 eigvalsh by "
        f"{s_err:.3e} (rel, bar {SVAL_RTOL_16}), reconstruction "
        f"{recon:.3e} (bar {RECON_RTOL_16}), singular value {RANK_16 + 1} "
        f"/ 1: {float(true[RANK_16] / true[0]):.3e} [{card}]")
    if not (s_err <= SVAL_RTOL_16 and recon <= RECON_RTOL_16):
        raise AssertionError("rsvd does not recover the rank-32 corpus")
    del Xr, u, v

    # (b) X is well conditioned (its columns: 1000 blob centers uniform in
    # [-10, 10] plus N(0, 25) noise), so f32 recovers w far inside the
    # bars; the normal equations (svd_eig, lstsq_eig) square the
    # condition number and get a looser bar.
    Xd = X.double()
    true = torch.sqrt(torch.linalg.eigvalsh(Xd.T @ Xd).flip(0))
    w = torch.randn(DIM, generator=gen, dtype=torch.float64, device=dev)
    y = X @ w.float()
    report, failed = [], []
    for name, fn, bar in (("svd_qr", linalg.svd_qr, SVAL_RTOL_16),
                          ("svd_eig", linalg.svd_eig, SVD_EIG_RTOL_16)):
        (u, sv, v), secs[name] = _timed(lambda: fn(X))
        s_err = float(torch.max(torch.abs(sv.double() - true) / true))
        recon = _rel((u * sv) @ v.T, X)
        report.append(f"{name} {secs[name]:.3f} s (singular values "
                      f"{s_err:.3e}, reconstruction {recon:.3e}, bar {bar})")
        if not (s_err <= bar and recon <= bar):
            failed.append(name)
        del u, v
    for name, fn, bar in (("lstsq_svd", linalg.lstsq_svd, LSTSQ_RTOL_16),
                          ("lstsq_eig", linalg.lstsq_eig,
                           LSTSQ_EIG_RTOL_16)):
        got, secs[name] = _timed(lambda: fn(X, y))
        err = _rel(got, w)
        report.append(f"{name} {secs[name]:.3f} s (w off by {err:.3e}, bar "
                      f"{bar})")
        if err > bar:
            failed.append(name)
    C = (X.T @ X) / N_ROWS
    (ew, evec), secs["eig_dc"] = _timed(lambda: linalg.eig_dc(C))
    ref = torch.linalg.eigvalsh(C.double())
    e_err = float(torch.max(torch.abs(ew.double() - ref)) / ref[-1])
    Cd, ed = C.double(), evec.double()
    resid = float(torch.linalg.norm(Cd @ ed - ed * ew.double())
                  / torch.linalg.norm(Cd))
    top = decomp.eig_sel_dc(C, 8, smallest=False)
    report.append(f"eig_dc {secs['eig_dc']:.4f} s (eigenvalues {e_err:.3e} "
                  f"of the largest, bar {EIG_RTOL_16}; residual "
                  f"{resid:.3e}, bar {EIGVEC_RTOL_16})")
    if e_err > EIG_RTOL_16 or resid > EIGVEC_RTOL_16:
        failed.append("eig_dc")
    if not (torch.equal(top[0], ew[-8:]) and torch.equal(top[1],
                                                          evec[:, -8:])):
        failed.append("eig_sel_dc (not eig_dc's top 8)")
    B = torch.randn((CHOL_16, CHOL_16), generator=gen, dtype=torch.float64,
                    device=dev)
    A = B @ B.T / CHOL_16 + torch.eye(CHOL_16, dtype=torch.float64,
                                      device=dev)
    vv = torch.randn(CHOL_16, generator=gen, dtype=torch.float64, device=dev)
    L = torch.linalg.cholesky(A).float()
    up, secs["cholesky_r1"] = _timed(
        lambda: linalg.cholesky_rank_one_update(L, vv.float()))
    ref = torch.linalg.cholesky(A + torch.outer(vv.float().double(),
                                                vv.float().double()))
    c_err = float(torch.max(torch.abs(up.double() - ref))
                  / torch.max(torch.abs(ref)))
    report.append(f"cholesky_rank_one_update {CHOL_16} x {CHOL_16} "
                  f"{secs['cholesky_r1']:.3f} s (off float64 by {c_err:.3e} "
                  f"of the largest entry, bar {CHOL_RTOL_16})")
    if c_err > CHOL_RTOL_16:
        failed.append("cholesky_rank_one_update")
    log(f"phase 16 (b): {'; '.join(report)} [{card}]")
    if failed:
        raise AssertionError(f"off float64 beyond the bar: {failed}")
    return secs


def breadth_masked(dev, X, Q, index, card) -> dict:
    """Phase 16 (c) and (g): ``masked_l2_nn`` as IVF-Flat's probe mask
    over phase 4's index (rows in list order, groups = lists, each query
    allowed the 32 lists its coarse step probes) against the index's own
    k=1 search, 100 queries against float64, and its trace ranges in a
    ``torch.profiler`` trace. Returns the search's launches and the
    times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.distance import masked_l2_nn
    from raft_tpu_torch.neighbors import ivf_flat

    masked_mod = importlib.import_module("raft_tpu_torch.distance.masked_nn")
    sizes = index.list_sizes.long()
    cap = index.data.shape[1]
    valid = torch.arange(cap, device=dev)[None, :] < sizes[:, None]
    y = index.data[valid]                       # rows in list order
    ids = index.indices[valid].long()
    group_idxs = torch.cumsum(sizes, 0)
    probes = ivf_flat._coarse_probe(Q, index.centers, N_PROBES, True)
    adj = torch.zeros((Q.shape[0], index.n_lists), dtype=torch.bool,
                      device=dev)
    adj.scatter_(1, probes.long(), True)

    _zero_counters()
    sp = ivf_flat.SearchParams(n_probes=N_PROBES)
    (sd, si), search_s = _timed(lambda: ivf_flat.search(sp, index, Q, 1))
    launches = _launches()
    (dm, im), first_s = _timed(lambda: masked_l2_nn(Q, y, adj, group_idxs))
    ms = time_ms(lambda: masked_l2_nn(Q, y, adj, group_idxs), reps=3,
                 warmup=0)
    tile = masked_mod.tile_rows(Q.shape[0], y.shape[0])
    got_i = torch.where(im >= 0, ids[im.long().clamp_min(0)], -1)
    tol = norm_tol(Q, y)
    n_diff = near_tie_check("masked_l2_nn against IVF-Flat k=1",
                            dm[:, None], got_i[:, None], sd, si, X, Q, tol)

    # 100 queries against float64 on the card.
    q64, y64 = Q[:N_CHECK_16].double(), y.double()
    d64 = torch.clamp_min((q64 * q64).sum(1)[:, None]
                          + (y64 * y64).sum(1)[None, :]
                          - 2.0 * (q64 @ y64.T), 0.0)
    del y64
    y_group = torch.searchsorted(group_idxs, torch.arange(
        y.shape[0], device=dev), right=True)
    d64.masked_fill_(~adj[:N_CHECK_16][:, y_group], float("inf"))
    ref_d, ref_i = torch.min(d64, dim=1)
    err = float(torch.max(torch.abs(dm[:N_CHECK_16].double() - ref_d)))
    mine = d64.gather(1, im[:N_CHECK_16, None].long().clamp_min(0))[:, 0]
    off = float(torch.max(torch.abs(mine - ref_d)))
    n64 = int((im[:N_CHECK_16].long() != ref_i).sum())
    log(f"phase 16 (c): masked_l2_nn {Q.shape[0]} x {y.shape[0]} "
        f"({N_PROBES} of {index.n_lists} lists a query) {ms:.3f} ms by CUDA "
        f"events (first "
        f"call {first_s:.3f} s), tile {tile} rows of x "
        f"({tile * y.shape[0]} entries); IVF-Flat k=1 search "
        f"{search_s:.3f} s, launches {launches}; distances within "
        f"norm_tol {tol:.4g} of the search's, {n_diff} ids differ at "
        f"near-ties; {N_CHECK_16} rows against float64: distance off by "
        f"{err:.4g}, {n64} ids differ, each within {off:.4g} [{card}]")
    if err > tol or off > tol:
        raise AssertionError("masked_l2_nn off float64")
    if launches["fused_cells_knn"] < 1:
        raise AssertionError("the k=1 IVF-Flat search did not launch B2")

    # (g) The trace ranges of one call.
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        masked_l2_nn(Q, y, adj, group_idxs)
        torch.cuda.synchronize()
    keys = {e.key for e in prof.key_averages()}
    want = {"raft_tpu_torch::masked_nn.masked_l2_nn",
            "raft_tpu_torch::masked_nn.tile"}
    ranges = sorted(k for k in keys if k.startswith("raft_tpu_torch::"))
    log(f"phase 16 (g): trace ranges {ranges} in a torch.profiler trace "
        f"of one masked_l2_nn call")
    if not want <= keys:
        raise AssertionError(f"trace ranges missing: {want - keys}")
    return {"launches": launches, "masked_ms": ms, "search_s": search_s,
            "tile": tile, "labels": (ids, sizes)}


def breadth_gram_reduce(dev, X, Q, labels, card) -> dict:
    """Phase 16 (d) and (e): the four gram kernels at 10,000 x 10,000 over
    the queries, each held on 100 rows to float64; the keyed row sums of
    X by IVF list, row norms, normalized rows and the row arg-min at 1M x
    128, each against float64 on the card. Returns the times."""
    import torch

    from raft_tpu_torch import linalg, matrix
    from raft_tpu_torch.distance import (KernelParams, KernelType,
                                         kernel_factory)

    secs = {}
    qn = (Q.double() ** 2).sum(1)
    gain = 1.0 / float(qn.max())      # keeps gain * x.y within [-1, 1]
    base = norm_tol(Q, Q)             # an f32 gram entry's error bound
    q64, a64 = Q[:N_CHECK_16].double(), Q.double()
    g64 = q64 @ a64.T
    d2 = torch.clamp_min(qn[:N_CHECK_16, None] + qn[None, :] - 2 * g64, 0)
    # (params, float64 value, Lipschitz bound of the epilogue at this
    # scale: |d f / d (x.y)|)
    cases = {
        "linear": (KernelParams(KernelType.LINEAR), g64, 1.0),
        "polynomial": (KernelParams(KernelType.POLYNOMIAL, degree=3,
                                    gamma=gain, coef0=1.0),
                       (gain * g64 + 1.0) ** 3, 3 * 4 * gain),
        "tanh": (KernelParams(KernelType.TANH, gamma=gain, coef0=0.0),
                 torch.tanh(gain * g64), gain),
        "rbf": (KernelParams(KernelType.RBF, gamma=gain),
                torch.exp(-gain * d2), gain),
    }
    report = []
    for name, (params, ref, lip) in cases.items():
        k = kernel_factory(params)
        out, secs[name] = _timed(lambda: k(Q, Q))
        ms = time_ms(lambda: k(Q, Q), reps=3)
        err = float(torch.max(torch.abs(out[:N_CHECK_16].double() - ref)))
        tol = lip * base + 1e-6 * float(torch.max(torch.abs(ref)))
        report.append(f"{name} {ms:.3f} ms (off float64 by {err:.3g}, "
                      f"bar {tol:.3g})")
        if tuple(out.shape) != (Q.shape[0], Q.shape[0]) or err > tol:
            raise AssertionError(f"{name} gram kernel off float64")
        del out
    log(f"phase 16 (d): gram kernels at {Q.shape[0]} x {Q.shape[0]}: "
        f"{'; '.join(report)} [{card}]")

    ids, sizes = labels
    lab = torch.empty(X.shape[0], dtype=torch.long, device=dev)
    lab[ids] = torch.repeat_interleave(
        torch.arange(sizes.shape[0], device=dev), sizes)
    n_keys = sizes.shape[0]
    sums, secs["reduce_rows_by_key"] = _timed(
        lambda: linalg.reduce_rows_by_key(X, lab, n_keys))
    Xd = X.double()
    ref = torch.zeros((n_keys, DIM), dtype=torch.float64,
                      device=dev).index_add_(0, lab, Xd)
    absum = torch.zeros_like(ref).index_add_(0, lab, Xd.abs())
    k_err = float(torch.max(torch.abs(sums.double() - ref)
                            / absum.clamp_min(1e-30)))
    rn, secs["row_norm"] = _timed(lambda: linalg.row_norm(X, linalg.L2Norm))
    rn_ref = (Xd * Xd).sum(1)
    n_err = float(torch.max(torch.abs(rn.double() - rn_ref) / rn_ref))
    nz, secs["normalize"] = _timed(lambda: linalg.normalize(X))
    z_err = float(torch.max(torch.abs(nz.double()
                                      - Xd / torch.sqrt(rn_ref)[:, None])))
    am, secs["argmin"] = _timed(lambda: matrix.argmin(X))
    same = bool(torch.equal(am.long(), torch.argmin(Xd, dim=1)))
    log(f"phase 16 (e): reduce_rows_by_key(X, IVF lists, {n_keys}) "
        f"{secs['reduce_rows_by_key'] * 1e3:.3f} ms (off float64 by "
        f"{k_err:.3e} of each key's sum of |x|, bar {KEYSUM_RTOL_16}); "
        f"row_norm {secs['row_norm'] * 1e3:.3f} ms ({n_err:.3e}, bar "
        f"{NORM_RTOL_16}); normalize {secs['normalize'] * 1e3:.3f} ms "
        f"({z_err:.3e}, bar {UNIT_ATOL_16}); matrix.argmin "
        f"{secs['argmin'] * 1e3:.3f} ms (equal to float64's: {same}) "
        f"[{card}]")
    if k_err > KEYSUM_RTOL_16 or n_err > NORM_RTOL_16 \
            or z_err > UNIT_ATOL_16 or not same:
        raise AssertionError("a row reduction is off float64")
    return secs


def breadth_cancel(dev, card) -> dict:
    """Phase 16 (f): ``synchronize`` on about SYNC_S_16 seconds of queued
    matmuls, cancelled from a second thread after CANCEL_AFTER_16 s,
    raises within a few poll intervals while the stream still runs; a
    second, uncancelled ``synchronize`` returns once the stream is
    idle."""
    import threading

    import torch

    from raft_tpu_torch.core import Interruptible, synchronize
    from raft_tpu_torch.core.interruptible import InterruptedException

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    a = torch.randn((4096, 4096), generator=gen, device=dev)
    one_ms = time_ms(lambda: a @ a, reps=3)
    n_mm = int(np.ceil(SYNC_S_16 * 1e3 / one_ms))
    main = threading.get_ident()
    when = {}

    def cancel():
        time.sleep(CANCEL_AFTER_16)
        when["cancel"] = time.perf_counter()
        Interruptible.cancel_thread(main)

    out = a
    for _ in range(n_mm):
        out = a @ a
    t0 = time.perf_counter()
    th = threading.Thread(target=cancel)
    th.start()
    try:
        synchronize(out, poll_interval=POLL_16)
    except InterruptedException:
        when["raised"] = time.perf_counter()
    th.join()
    busy = not torch.cuda.current_stream().query()
    if "raised" not in when:
        raise AssertionError("synchronize was not interrupted")
    latency = when["raised"] - when["cancel"]
    synchronize(out, poll_interval=POLL_16)
    idle = torch.cuda.current_stream().query()
    rest = time.perf_counter() - when["raised"]
    log(f"phase 16 (f): {n_mm} matmuls of 4096^2 ({one_ms:.3f} ms each) "
        f"queued; cancelled {when['cancel'] - t0:.3f} s into synchronize, "
        f"raised {latency * 1e3:.1f} ms later (poll {POLL_16 * 1e3:.0f} "
        f"ms; stream still busy: {busy}); the second synchronize returned "
        f"{rest:.3f} s after that, stream idle: {idle} [{card}]")
    if latency > 4 * POLL_16 or not busy or not idle:
        raise AssertionError("synchronize did not cancel within 4 polls "
                             "of a busy stream, or returned before idle")
    return {"cancel_ms": latency * 1e3}


def breadth_phase(dev, X, Q, index, card) -> dict:
    """Phase 16: the breadth modules at phase 4's sizes, before any phase
    mutates phase 4's index. Returns its launches (the k=1 IVF-Flat
    search's B2)."""
    import torch

    t0 = time.perf_counter()
    secs = breadth_decomp(dev, X, card)
    mk = breadth_masked(dev, X, Q, index, card)
    secs.update(breadth_gram_reduce(dev, X, Q, mk["labels"], card))
    secs.update(breadth_cancel(dev, card))
    log(f"phase 16: {time.perf_counter() - t0:.3f} s, launches "
        f"{mk['launches']} [{card}]")
    # The spawned ranks of phases 12-15 share this card: hand back the
    # phase's cached blocks (up to ~7 GB at its peak).
    torch.cuda.empty_cache()
    return mk["launches"]


# ---------------------------------------------------------------------------
# Phase 17: random/, Lloyd k-means, refine_host, stats/ and label/


def _moments_17():
    """Each draw of phase 17 (a): name, arguments, and the distribution's
    mean, variance, excess kurtosis and support test."""
    import math

    import torch

    def finite(x):
        return bool(torch.isfinite(x).all())

    def values(x):
        return set(torch.unique(x).tolist())

    g = 0.5772156649015329
    s2 = 0.7 ** 2
    w = np.array([0.1, 0.0, 0.4, 0.5])
    wm = float((w * np.arange(4)).sum())
    wv = float((w * (np.arange(4) - wm) ** 2).sum())
    wk = float((w * (np.arange(4) - wm) ** 4).sum()) / wv ** 2 - 3
    nv = 4.0 + 1 / 12           # a rounded N(3, 4): the normal plus U(-.5, .5)
    nk = (3 * 16 + 6 * 4 / 12 + 1 / 80) / nv ** 2 - 3
    bp = 0.37
    return [
        ("uniform", (-2.0, 3.0), 0.5, 25 / 12, -1.2,
         lambda x: bool(x.min() >= -2.0) and bool(x.max() < 3.0)),
        ("uniformInt", (5, 25), 14.5, 33.25, -6 * 401 / (5 * 399),
         lambda x: x.dtype == torch.int32 and bool(x.min() >= 5)
         and bool(x.max() < 25)),
        ("normal", (1.5, 2.0), 1.5, 4.0, 0.0, finite),
        ("normalInt", (3.0, 2.0), 3.0, nv, nk,
         lambda x: x.dtype == torch.int32),
        ("lognormal", (0.5, 0.7), math.exp(0.5 + s2 / 2),
         (math.exp(s2) - 1) * math.exp(1.0 + s2),
         math.exp(4 * s2) + 2 * math.exp(3 * s2) + 3 * math.exp(2 * s2) - 6,
         lambda x: bool(x.min() > 0) and finite(x)),
        ("laplace", (-0.3, 1.1), -0.3, 2 * 1.1 ** 2, 3.0, finite),
        ("gumbel", (0.4, 1.3), 0.4 + 1.3 * g, math.pi ** 2 * 1.3 ** 2 / 6,
         2.4, finite),
        ("logistic", (0.2, 0.9), 0.2, 0.9 ** 2 * math.pi ** 2 / 3, 1.2,
         finite),
        ("exponential", (1.8,), 1 / 1.8, 1 / 1.8 ** 2, 6.0,
         lambda x: bool(x.min() >= 0) and finite(x)),
        ("rayleigh", (1.6,), 1.6 * math.sqrt(math.pi / 2),
         (4 - math.pi) / 2 * 1.6 ** 2,
         -(6 * math.pi ** 2 - 24 * math.pi + 16) / (4 - math.pi) ** 2,
         lambda x: bool(x.min() > 0) and finite(x)),
        ("bernoulli", (bp,), bp, bp * (1 - bp),
         (1 - 6 * bp * (1 - bp)) / (bp * (1 - bp)),
         lambda x: x.dtype == torch.bool),
        # -scale where u > prob: P(+2) = 0.3.
        ("scaled_bernoulli", (0.3, 2.0), 2.0 * (2 * 0.3 - 1),
         4.0 * 4 * 0.3 * 0.7, (1 - 6 * 0.21) / 0.21,
         lambda x: values(x) == {-2.0, 2.0}),
        ("discrete", (w.astype(np.float32),), wm, wv, wk,
         lambda x: values(x) == {0, 2, 3}),
        ("rng_fill", (2.5,), 2.5, 0.0, 0.0,
         lambda x: bool((x == 2.5).all())),
    ]


def draws_17(dev, card) -> dict:
    """Phase 17 (a): every rng draw on the card, held to its
    distribution. Returns the step seconds."""
    import torch

    from raft_tpu_torch import random as rnd
    from raft_tpu_torch.random import RngState

    secs = {}
    state = RngState(SEED + 17)
    failed, report = [], []
    t0 = time.perf_counter()
    for name, args, mean, var, exk, support in _moments_17():
        x = getattr(rnd, name)(state, N_DRAWS_17, *args, device=dev)
        xd = x.double()
        m = float(xd.mean())
        v = float(((xd - m) ** 2).mean())
        # Standard errors of the sample mean and variance; rng_fill draws
        # nothing, so its moments must be exact.
        se_m = (var / N_DRAWS_17) ** 0.5
        se_v = var * ((exk + 2) / N_DRAWS_17) ** 0.5
        zm = abs(m - mean) / se_m if se_m else (0.0 if m == mean else 1e9)
        zv = abs(v - var) / se_v if se_v else (0.0 if v == var else 1e9)
        ok = support(x) and zm <= SE_17 and zv <= SE_17
        report.append(f"{name} {zm:.2f}/{zv:.2f}")
        if not ok:
            failed.append((name, m, mean, v, var))
    # The discrete draw's frequencies, zero weight never drawn.
    w = np.array([0.1, 0.0, 0.4, 0.5])
    freq = torch.bincount(rnd.discrete(state, N_DRAWS_17, w.astype(np.float32),
                                       device=dev).long(), minlength=4)
    freq = freq.double().cpu().numpy() / N_DRAWS_17
    se = np.sqrt(w * (1 - w) / N_DRAWS_17)
    if freq[1] != 0 or np.any(np.abs(freq - w) > SE_17 * se + 1e-12):
        failed.append(("discrete frequencies", freq))
    torch.cuda.synchronize()
    secs["moments"] = time.perf_counter() - t0
    log(f"phase 17 (a): {len(report)} draws of {N_DRAWS_17} on the card in "
        f"{secs['moments']:.3f} s; |z| of mean / variance (bar {SE_17}): "
        f"{', '.join(report)}; discrete frequencies {np.round(freq, 5)} "
        f"[{card}]")

    # sample_without_replacement: half the population at weight 4. The
    # Gumbel-top-k inclusion probability is 1 - exp(-w a) for the a that
    # makes the expected sample size N_SAMPLE_17.
    t0 = time.perf_counter()
    weights = torch.ones(N_SWOR_17, device=dev)
    weights[N_SWOR_17 // 2:] = 4.0
    _, idx = rnd.sample_without_replacement(state, N_SWOR_17, N_SAMPLE_17,
                                            weights=weights)
    distinct = int(torch.unique(idx).numel())
    share = float((idx >= N_SWOR_17 // 2).double().mean())
    lo, hi = 0.0, 1.0
    for _ in range(100):
        a = (lo + hi) / 2
        got = 0.5 * (1 - np.exp(-a)) + 0.5 * (1 - np.exp(-4 * a))
        lo, hi = (a, hi) if got < N_SAMPLE_17 / N_SWOR_17 else (lo, a)
    p1, p4 = 1 - np.exp(-a), 1 - np.exp(-4 * a)
    want = p4 / (p1 + p4)
    se_share = (want * (1 - want) / N_SAMPLE_17) ** 0.5
    perm = rnd.permute(state, N_SWOR_17, device=dev)
    is_perm = torch.equal(torch.sort(perm.long()).values,
                          torch.arange(N_SWOR_17, device=dev))
    torch.cuda.synchronize()
    secs["sample_permute"] = time.perf_counter() - t0
    log(f"phase 17 (a): sample_without_replacement {N_SAMPLE_17} of "
        f"{N_SWOR_17}: {distinct} distinct, in range "
        f"{bool(idx.min() >= 0) and bool(idx.max() < N_SWOR_17)}, weight-4 "
        f"share {share:.5f} (expected {want:.5f}, |z| "
        f"{abs(share - want) / se_share:.2f}); permute({N_SWOR_17}) is a "
        f"permutation: {is_perm}; {secs['sample_permute']:.3f} s [{card}]")
    if (distinct != N_SAMPLE_17 or idx.dtype != torch.int32
            or not bool(idx.min() >= 0) or not bool(idx.max() < N_SWOR_17)
            or abs(share - want) > SE_17 * se_share or not is_perm):
        failed.append(("sample_without_replacement / permute", distinct,
                       share))

    # multi_variable_gaussian: a 128 x 128 covariance A A^T / 128 + I; each
    # entry of the sample covariance within SE_17 standard errors
    # sqrt((S_ii S_jj + S_ij^2) / N) of the truth, the mean likewise.
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    A = torch.randn((DIM, DIM), generator=gen, dtype=torch.float64,
                    device=dev)
    cov = (A @ A.T / DIM + torch.eye(DIM, dtype=torch.float64,
                                     device=dev)).float()
    mu = torch.randn(DIM, generator=gen, device=dev)
    cd = cov.double()
    se_cov = torch.sqrt((torch.outer(torch.diag(cd), torch.diag(cd))
                         + cd ** 2) / N_MVG_17)
    se_mu = torch.sqrt(torch.diag(cd) / N_MVG_17)
    zs = {}
    for method in ("cholesky", "jacobi"):
        t0 = time.perf_counter()
        x = rnd.multi_variable_gaussian(state, mu, cov, N_MVG_17,
                                        method=method)
        torch.cuda.synchronize()
        secs[f"mvg_{method}"] = time.perf_counter() - t0
        xd = x.double()
        m = xd.mean(0)
        c = (xd - m).T @ (xd - m) / (N_MVG_17 - 1)
        zs[method] = (float(torch.max(torch.abs(m - mu.double()) / se_mu)),
                      float(torch.max(torch.abs(c - cd) / se_cov)))
        del x, xd
        if zs[method][0] > SE_17 or zs[method][1] > SE_17:
            failed.append((f"multi_variable_gaussian {method}", zs[method]))
    log(f"phase 17 (a): multi_variable_gaussian {N_MVG_17} x {DIM}: max |z| "
        f"of mean / covariance entries (bar {SE_17}): "
        + ", ".join(f"{k} {v[0]:.2f} / {v[1]:.2f} "
                    f"({secs['mvg_' + k]:.3f} s)" for k, v in zs.items())
        + f" [{card}]")

    # rmat_rectangular_gen: every level's quadrant shares against theta.
    t0 = time.perf_counter()
    src, dst = rnd.rmat_rectangular_gen(state, list(RMAT_THETA_17),
                                        RMAT_SCALE_17, RMAT_SCALE_17,
                                        RMAT_EDGES_17, device=dev)
    torch.cuda.synchronize()
    secs["rmat"] = time.perf_counter() - t0
    theta = np.asarray(RMAT_THETA_17) / sum(RMAT_THETA_17)
    se = np.sqrt(theta * (1 - theta) / RMAT_EDGES_17)
    worst = 0.0
    s64, d64 = src.long(), dst.long()
    for lvl in range(RMAT_SCALE_17):
        sh = RMAT_SCALE_17 - 1 - lvl
        quad = (((s64 >> sh) & 1) << 1) | ((d64 >> sh) & 1)
        f = torch.bincount(quad, minlength=4).double().cpu().numpy()
        worst = max(worst, float(np.max(np.abs(f / RMAT_EDGES_17 - theta)
                                        / se)))
    in_range = (src.dtype == torch.int32 and bool(src.min() >= 0)
                and bool(src.max() < 1 << RMAT_SCALE_17)
                and bool(dst.min() >= 0)
                and bool(dst.max() < 1 << RMAT_SCALE_17))
    log(f"phase 17 (a): rmat_rectangular_gen 2^{RMAT_SCALE_17} x "
        f"2^{RMAT_SCALE_17}, {RMAT_EDGES_17} edges in {secs['rmat']:.3f} s: "
        f"int32 ids in range {in_range}, max |z| of the {RMAT_SCALE_17} "
        f"levels' quadrant shares {worst:.2f} (bar {SE_17}) [{card}]")
    if worst > SE_17 or not in_range:
        failed.append(("rmat", worst, in_range))
    del src, dst, s64, d64
    if failed:
        raise AssertionError(f"phase 17 (a): off the distribution: {failed}")
    return secs


def _b1_capture():
    """Wraps B1's launcher: keeps the operands and answers of the first
    split-bf16 launch and of the last f32 launch. The launcher still
    counts each launch."""
    fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")
    calls = {}
    launch = fk._fused_knn_cuda

    def kept(*args):
        out = launch(*args)
        tier = "split-bf16" if args[4] else "f32"
        if tier == "f32" or tier not in calls:
            calls[tier] = (args, tuple(o.clone() for o in out))
        return out

    return fk, launch, kept, calls


def lloyd_17(dev, card) -> dict:
    """Phase 17 (b): Lloyd k-means at N_ROWS x DIM, N_CLUSTERS_17 clusters
    from ``InitMethod.Array`` at the blobs' centers (B1 k=1 on every
    assignment), a k-means++ fit, and B1 timed at the shape. Returns what
    (e) and (f) use and the B1 figures."""
    import torch

    from raft_tpu_torch import random as rnd
    from raft_tpu_torch import stats
    from raft_tpu_torch.cluster import InitMethod, KMeansParams, kmeans
    from raft_tpu_torch.random import RngState

    centers = rnd.uniform(RngState(SEED + 170), (N_CLUSTERS_17, DIM), -10.0,
                          10.0, device=dev)
    X, truth = rnd.make_blobs(N_ROWS, DIM, centers=centers,
                              cluster_std=BLOB_STD_17, seed=SEED + 17,
                              device=dev)
    cmin = torch.cdist(centers.double(), centers.double())
    cmin.fill_diagonal_(float("inf"))
    p = KMeansParams(n_clusters=N_CLUSTERS_17, init=InitMethod.Array,
                     max_iter=MAX_ITER_17)
    fk, launch, kept, calls = _b1_capture()
    before = fk.fused_knn.launches
    fk._fused_knn_cuda = kept
    try:
        (C, inertia, it), fit_s = _timed(
            lambda: kmeans.fit(p, X, centroids_init=centers))
    finally:
        fk._fused_knn_cuda = launch
    fit_launches = fk.fused_knn.launches - before
    labels, pred_inertia = kmeans.predict(p, C, X)
    ari = float(stats.adjusted_rand_index(truth, labels))
    ref = float(torch.sum((X.double() - C.double()[labels.long()]) ** 2))
    errs = (abs(float(inertia) - ref) / ref,
            abs(float(pred_inertia) - ref) / ref)
    log(f"phase 17 (b): make_blobs({N_ROWS} x {DIM}, {N_CLUSTERS_17} "
        f"centers, std {BLOB_STD_17}; closest centers "
        f"{float(cmin.min()):.2f} apart); fit from the true centers "
        f"(InitMethod.Array) {fit_s:.3f} s, {it} iterations "
        f"({fit_s / max(it, 1) * 1e3:.1f} ms an iteration, the final f32 "
        f"assignment included), {fit_launches} B1 launches; ARI "
        f"against make_blobs' labels {ari:.6f} (bar {ARI_17}); inertia "
        f"{float(inertia):.6e}, off float64 by {errs[0]:.3e} (fit) / "
        f"{errs[1]:.3e} (predict) (bar {INERTIA_RTOL_17}) [{card}]")
    if ari < ARI_17 or max(errs) > INERTIA_RTOL_17 or fit_launches < it + 1:
        raise AssertionError("phase 17 (b): Lloyd k-means off its bars")

    # The first in-loop launch (split-bf16) and the final f32 launch,
    # held against the plain version on their own operands.
    if set(calls) != {"split-bf16", "f32"}:
        raise AssertionError(f"phase 17 (b): the fit launched B1 on the "
                             f"tiers {sorted(calls)}, not both")
    split_err = 0.0
    for tier in ("split-bf16", "f32"):
        args, (kd, ki) = calls[tier]
        pd, pi = fk._fused_knn_plain(*args)
        torch.cuda.synchronize()
        agree = float((ki == pi).float().mean())
        err = max_err(kd, pd)
        tol = norm_tol(args[0], args[1])
        log(f"phase 17 (b): B1 {tier} launch of the fit ({args[0].shape[0]} "
            f"x {args[1].shape[0]} x {args[0].shape[1]}, k=1) vs plain: "
            f"arg-min agreement {agree:.6f} (bar {RECALL_BF}, "
            f"{int((ki != pi).sum())} rows differ), max |d| err {err:.3e} "
            f"(tol {tol:.3e})")
        if agree < RECALL_BF or err > tol:
            raise AssertionError(f"phase 17 (b): B1 {tier} disagrees with "
                                 "its plain version")
        if tier == "split-bf16":
            split_err = err
        del pd, pi
    calls.clear()

    pp = KMeansParams(n_clusters=PP_K_17, max_iter=MAX_ITER_17,
                      rng_state=RngState(SEED + 17))
    (Cp, pp_inertia, pp_it), pp_s = _timed(
        lambda: kmeans.fit(pp, X[:N_PP_17]))
    log(f"phase 17 (b): k-means++ fit {N_PP_17} x {DIM} x {PP_K_17}: "
        f"{pp_s:.3f} s, {pp_it} iterations, inertia "
        f"{float(pp_inertia):.6e} [{card}]")
    if not (bool(torch.isfinite(Cp).all())
            and 0 < float(pp_inertia) < float("inf") and pp_it >= 1):
        raise AssertionError("phase 17 (b): the k-means++ fit failed")

    return {"X": X, "truth": truth, "labels": labels, "C": C,
            "fit_s": fit_s, "it": it, "fit_launches": fit_launches,
            "pp_s": pp_s, "pp_it": pp_it, "split_err": split_err}


def b1_lloyd_17(X, C, fit, card) -> dict:
    """Phase 17 (b), after the phase's launches are read: B1 at Lloyd's
    shape on both tiers beside ``addmm`` + ``argmin``, with each tier's
    bound (:func:`b1_k1_bound`) and path; every timed launch must take its
    tier's tensor-core scan. The split tier's plain version is timed too:
    these are knn_mma.cu's figures in the ``kernels`` line."""
    import torch

    fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")
    m, n_c, d = X.shape[0], C.shape[0], X.shape[1]
    Cc = C.contiguous()
    b1 = {}
    for tier, bf16 in (("f32", False), ("split-bf16", True)):
        before = (fk.fused_knn.mma_launches, fk.fused_knn.tf32_launches)
        ms = time_ms(lambda: fk._fused_knn_cuda(X, Cc, 1, True, bf16, bf16),
                     5)
        mma = fk.fused_knn.mma_launches - before[0]
        tf32 = fk.fused_knn.tf32_launches - before[1]
        if mma != 6 or tf32 != (0 if bf16 else 6):
            raise AssertionError(f"phase 17 (b): B1 {tier} took the wrong "
                                 f"scan ({mma} tensor-core launches of 6, "
                                 f"{tf32} of knn_tf32.cu's)")
        bound, by = b1_k1_bound(m, n_c, d, bf16)
        b1[tier] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                    "path": b1_path(m, n_c, d, bf16)}
    plain_ms = time_ms(lambda: fk._fused_knn_plain(X, Cc, 1, True, True,
                                                   True), 2)
    cn = torch.sum(Cc * Cc, dim=1)
    lib_ms = time_ms(lambda: torch.argmin(torch.addmm(cn, X, Cc.t(),
                                                      alpha=-2.0), dim=1), 3)
    log(f"phase 17 (b): B1 at Lloyd's shape m={m} n={n_c} d={d} k=1: f32 "
        f"{b1['f32']['ms']:.3f} ms (bound {b1['f32']['bound_ms']:.3f} "
        f"ms, {b1['f32']['bound_by']}; {b1['f32']['path']}), split-bf16 "
        f"{b1['split-bf16']['ms']:.3f} ms (bound "
        f"{b1['split-bf16']['bound_ms']:.3f} ms, "
        f"{b1['split-bf16']['bound_by']}; {b1['split-bf16']['path']}; "
        f"its plain version {plain_ms:.3f} ms), library (addmm + argmin) "
        f"{lib_ms:.3f} ms; fit from the true centers {fit['fit_s']:.3f} s "
        f"for {fit['it']} iterations ({fit['fit_launches']} B1 launches), "
        f"k-means++ fit "
        f"{fit['pp_s']:.3f} s for {fit['pp_it']} [{card}]")
    split = b1["split-bf16"]
    return {"b1": b1, "lib_ms": lib_ms,
            "mma": {"max_abs_err": fit["split_err"], "ms": split["ms"],
                    "plain_ms": plain_ms, "bound_ms": split["bound_ms"],
                    "bound_by": "operations"
                    if split["bound_by"].startswith("operations")
                    else "bytes", "library_ms": lib_ms}}


def find_k_17(dev, card) -> float:
    """Phase 17 (c): ``find_k`` on well-separated blobs finds their
    number. Returns its seconds."""
    from raft_tpu_torch import random as rnd
    from raft_tpu_torch.cluster import kmeans

    rows, dim, blobs, std, kmax = FINDK_17
    Xf, _ = rnd.make_blobs(rows, dim, n_clusters=blobs, cluster_std=std,
                           seed=SEED + 17, device=dev)
    (k, inertia, it), secs = _timed(lambda: kmeans.find_k(Xf, kmax=kmax))
    log(f"phase 17 (c): find_k(make_blobs({rows} x {dim}, {blobs} centers, "
        f"std {std}), kmax={kmax}) = {k} in {secs:.3f} s (inertia "
        f"{float(inertia):.4e}, {it} iterations) [{card}]")
    if k != blobs:
        raise AssertionError(f"phase 17 (c): find_k gave {k}, not {blobs}")
    return secs


def refine_17(dev, X, Q, cand, card) -> dict:
    """Phase 17 (d): phase 6's IVF-PQ candidates re-ranked to K on the
    host through the port's native library, against the card's
    ``neighbors.refine`` on the same candidates."""
    import torch

    from raft_tpu_torch import _native
    from raft_tpu_torch.ops import _build

    rf = importlib.import_module("raft_tpu_torch.neighbors.refine")
    t0 = time.perf_counter()
    _native.get_lib()
    load_s = time.perf_counter() - t0
    Xh, Qh, ch = X.cpu().numpy(), Q.cpu().numpy(), cand.cpu().numpy()
    t0 = time.perf_counter()
    hd, hi = rf.refine_host(Xh, Qh, ch, K)
    host_s = time.perf_counter() - t0
    (dd, di), card_s = _timed(lambda: rf.refine(X, Q, cand, K))
    tol = norm_tol(Q, X)
    diff = near_tie_check("phase 17 (d), refine_host",
                          torch.as_tensor(hd, device=dev),
                          torch.as_tensor(hi, device=dev), dd, di, X, Q, tol)
    built = _build.BUILD_SECONDS.get(_native.LIBRARY)
    log(f"phase 17 (d): refine_host of {cand.shape[0]} x {cand.shape[1]} "
        f"IVF-PQ candidates to k={K} on the host: {host_s:.3f} s (library "
        f"{'built in %.3f s' % built if built is not None else 'cached'}, "
        f"loaded in {load_s:.3f} s); the card's refine {card_s:.3f} s; ids "
        f"equal but {diff} slots at near-ties, distances within {tol:.3e} "
        f"[{card}]")
    return {"host_s": host_s, "build_s": built, "card_s": card_s}


def stats_17(dev, X, truth, labels, card) -> dict:
    """Phase 17 (e): descriptive statistics at N_ROWS x DIM, silhouette,
    trustworthiness, the label metrics and r2, each against float64 on
    the card."""
    import torch

    from raft_tpu_torch import linalg
    from raft_tpu_torch import random as rnd
    from raft_tpu_torch import stats
    from raft_tpu_torch.random import RngState

    state = RngState(SEED + 171)
    secs = {}
    Xd = X.double()
    scale = Xd.abs().mean(0)
    failed, report = [], []

    def held(name, err, bar):
        report.append(f"{name} {err:.3e}")
        if not err <= bar:
            failed.append((name, err, bar))

    # f32 reductions over 1M rows sum in blocks: each is held to float64
    # within STAT_RTOL_17 of the column's scale (mean |x|, the variance,
    # sqrt(var_i var_j) for a covariance entry).
    t0 = time.perf_counter()
    mu64 = Xd.mean(0)
    var64 = Xd.var(0)
    held("mean", float(torch.max((stats.mean(X).double() - mu64).abs()
                                 / scale)), STAT_RTOL_17)
    held("vars_", float(torch.max((stats.vars_(X).double() - var64).abs()
                                  / var64)), STAT_RTOL_17)
    held("stddev", float(torch.max((stats.stddev(X).double()
                                    - var64.sqrt()).abs() / var64.sqrt())),
         STAT_RTOL_17)
    c64 = torch.cov(Xd.T)
    norm = torch.sqrt(torch.outer(torch.diag(c64), torch.diag(c64)))
    held("cov", float(torch.max((stats.cov(X).double() - c64).abs() / norm)),
         STAT_RTOL_17)
    lo, hi = stats.minmax(X)
    if not (torch.equal(lo, Xd.amin(0).float())
            and torch.equal(hi, Xd.amax(0).float())):
        failed.append(("minmax", "not bit for bit"))
    w = rnd.uniform(state, N_ROWS, 0.5, 2.0, device=dev)
    wm64 = (Xd * w.double()[:, None]).sum(0) / w.double().sum()
    held("weighted_mean", float(torch.max(
        (stats.weighted_mean(X, w).double() - wm64).abs() / scale)),
        STAT_RTOL_17)
    h = stats.histogram(X, N_BINS_17)
    lo64, hi64 = float(X.min()), float(X.max())
    width = (hi64 - lo64) / N_BINS_17
    bins64 = torch.clamp(torch.floor((Xd - lo64) / width), 0,
                         N_BINS_17 - 1).long()
    col = torch.arange(DIM, device=dev)
    h64 = torch.bincount((bins64 * DIM + col).reshape(-1),
                         minlength=N_BINS_17 * DIM).reshape(N_BINS_17, DIM)
    del bins64
    moved = int((h.long() - h64).abs().sum()) // 2
    held("histogram (share moved)", moved / X.numel(), HIST_MOVED_17)
    if not bool((h.long().sum(0) == N_ROWS).all()):
        failed.append(("histogram", "columns do not sum to the rows"))
    torch.cuda.synchronize()
    secs["descriptive"] = time.perf_counter() - t0
    del Xd

    # Silhouette of the fit's labels on a sample, against float64 (the
    # distances in float64 are the expanded form, exact to ~1e-12 here).
    t0 = time.perf_counter()
    _, idx = rnd.sample_without_replacement(state, N_ROWS, N_SIL_17,
                                            device=dev)
    Xs, ls = X[idx.long()], labels[idx.long()].long()
    sil = float(stats.silhouette_score(Xs, ls, n_clusters=N_CLUSTERS_17))
    secs["silhouette"] = time.perf_counter() - t0
    S = Xs.double()
    sn = (S * S).sum(1)
    D = torch.clamp_min(sn[:, None] + sn[None, :] - 2 * S @ S.T, 0)
    oh = torch.nn.functional.one_hot(ls, N_CLUSTERS_17).double()
    sums, counts = D @ oh, oh.sum(0)
    del D
    own = oh.bool()
    oc = counts[ls]
    a = torch.where(oc > 1, (sums * oh).sum(1) / torch.clamp_min(oc - 1, 1),
                    0.0)
    other = torch.where(own | (counts[None, :] == 0), float("inf"),
                        sums / torch.clamp_min(counts[None, :], 1))
    b = other.amin(1)
    sil64 = float(torch.where(oc > 1, (b - a) / torch.maximum(a, b),
                              0.0).mean())
    held("silhouette", abs(sil - sil64) / abs(sil64), METRIC_RTOL_17)
    del sums, oh, other

    # Trustworthiness of a rank-32 projection of 5,000 rows.
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    V = torch.linalg.qr(torch.randn((DIM, TRUST_RANK_17), generator=gen,
                                    dtype=torch.float64, device=dev)).Q
    Xt = X[idx[:N_TRUST_17].long()]
    E = Xt @ V.float()
    tw = float(stats.trustworthiness_score(Xt, E, TRUST_K_17))
    secs["trustworthiness"] = time.perf_counter() - t0

    def sq64(A):
        An = (A * A).sum(1)
        return torch.clamp_min(An[:, None] + An[None, :] - 2 * A @ A.T, 0)

    nt, kk = N_TRUST_17, TRUST_K_17
    emb = torch.argsort(sq64(E.double()), dim=1, stable=True)[:, :kk + 1]
    order = torch.argsort(sq64(Xt.double()), dim=1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(nt, device=dev)[None, :]
                   .expand(nt, nt))
    pen = float(torch.clamp_min(torch.gather(ranks, 1, emb) - kk, 0).sum())
    tw64 = 1.0 - 2.0 / (nt * kk * (2.0 * nt - 3.0 * kk - 1.0)) * pen
    held("trustworthiness (abs)", abs(tw - tw64), TRUST_ATOL_17)
    del order, ranks

    # The label metrics of the fit's labels against make_blobs' labels.
    t0 = time.perf_counter()
    kc = N_CLUSTERS_17
    cm = stats.contingency_matrix(truth, labels)
    cm64 = torch.bincount(truth.long() * kc + labels.long(),
                          minlength=kc * kc).reshape(kc, kc)
    if not torch.equal(cm.long(), cm64):
        failed.append(("contingency_matrix", "not bit for bit"))
    cmd = cm64.double()
    nn_ = float(N_ROWS)
    rows_, cols_ = cmd.sum(1), cmd.sum(0)
    ri64 = float(((cmd ** 2).sum() - nn_) / 2 + nn_ * (nn_ - 1) / 2
                 + ((cmd ** 2).sum() - (rows_ ** 2).sum()
                    - (cols_ ** 2).sum() + nn_) / 2) / (nn_ * (nn_ - 1) / 2)
    pij = cmd / nn_
    outer = torch.outer(rows_, cols_) / nn_ ** 2
    mi64 = float(torch.where(pij > 0, pij * torch.log(pij / outer), 0.0)
                 .sum())

    def h64_(c):
        pr = c / nn_
        return float(-torch.where(pr > 0, pr * torch.log(pr), 0.0).sum())

    ht, hp = h64_(rows_), h64_(cols_)
    got = {"rand_index": float(stats.rand_index(truth, labels)),
           "mutual_info_score": float(stats.mutual_info_score(truth,
                                                              labels)),
           "entropy": float(stats.entropy(truth)),
           "homogeneity_score": float(stats.homogeneity_score(truth,
                                                              labels)),
           "completeness_score": float(stats.completeness_score(truth,
                                                                labels)),
           "v_measure": float(stats.v_measure(truth, labels)),
           "accuracy": float(stats.accuracy(labels, truth))}
    want = {"rand_index": ri64, "mutual_info_score": mi64, "entropy": ht,
            "homogeneity_score": mi64 / ht, "completeness_score": mi64 / hp,
            "v_measure": 2 * mi64 / (ht + hp),
            "accuracy": float((labels == truth).double().mean())}
    for name in got:
        held(name, abs(got[name] - want[name]) / abs(want[name]),
             METRIC_RTOL_17)
    hh, cc = got["homogeneity_score"], got["completeness_score"]
    held("v_measure = 2hc / (h + c)",
         abs(got["v_measure"] - 2 * hh * cc / (hh + cc)), 1e-6)
    held("trace / n = accuracy", abs(float(torch.trace(cmd)) / nn_
                                     - got["accuracy"]), 1e-6)
    secs["label_metrics"] = time.perf_counter() - t0

    # r2 of the least-squares fit of noise-free make_regression data.
    t0 = time.perf_counter()
    Xr, yr, _ = rnd.make_regression(N_ROWS, DIM, noise=0.0, seed=SEED + 17,
                                    device=dev)
    wr = linalg.lstsq_svd(Xr, yr)
    r2 = float(stats.r2_score(yr, Xr @ wr))
    secs["r2"] = time.perf_counter() - t0
    held("1 - r2 (abs)", abs(1.0 - r2), R2_ATOL_17)
    log(f"phase 17 (e): statistics against float64 (relative unless "
        f"marked): {', '.join(report)}; silhouette {sil:.6f} on "
        f"{N_SIL_17} rows, trustworthiness {tw:.6f} on {N_TRUST_17} rows "
        f"(k={TRUST_K_17}) against their rank-{TRUST_RANK_17} projection, "
        f"r2 {r2:.8f}; seconds "
        f"{ {k: round(v, 3) for k, v in secs.items()} } [{card}]")
    if failed:
        raise AssertionError(f"phase 17 (e): off float64: {failed}")
    return secs


def labels_17(dev, labels, card) -> float:
    """Phase 17 (f): ``make_monotonic`` and ``get_unique_labels`` of the
    fit's labels, and ``merge_labels`` of two labelings, each against a
    numpy computation on the host (the merge by union-find over the
    classes the masked points join). Returns its seconds."""
    import torch

    from raft_tpu_torch import label
    from raft_tpu_torch import random as rnd
    from raft_tpu_torch.random import RngState

    t0 = time.perf_counter()
    lab = labels.to(torch.int32) * 3 + 7          # not already 0..k - 1
    uniq = label.get_unique_labels(lab)
    mapped, classes = label.make_monotonic(lab)
    one_based, _ = label.make_monotonic(lab, zero_based=False)
    a = labels.to(torch.int32)
    b = (a // 3).to(torch.int32)
    mask = rnd.bernoulli(RngState(SEED + 172), a.shape[0], 0.5, device=dev)
    merged = label.merge_labels(a, b, mask)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0

    lh, ah, bh, mh = (lab.cpu().numpy(), a.cpu().numpy(), b.cpu().numpy(),
                      mask.cpu().numpy())
    want_u = np.unique(lh)
    want_m = np.searchsorted(want_u, lh).astype(np.int32)
    # Union-find over the A classes (ids 0..) and B classes (ids off)
    # that a masked point joins; a masked point then takes the least A
    # label among the masked points of its component.
    off = int(ah.max()) + 1
    parent = list(range(off + int(bh.max()) + 1))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v in set(zip(ah[mh].tolist(), (bh[mh] + off).tolist())):
        parent[find(u)] = find(v)
    roots = np.array([find(x) for x in range(len(parent))])
    least = np.full(len(parent), np.iinfo(np.int64).max)
    np.minimum.at(least, roots[ah[mh]], ah[mh])
    want_merge = np.where(mh, least[roots[ah]], ah).astype(np.int32)
    ok = (np.array_equal(uniq.cpu().numpy(), want_u)
          and np.array_equal(classes.cpu().numpy(), want_u)
          and np.array_equal(mapped.cpu().numpy(), want_m)
          and np.array_equal(one_based.cpu().numpy(), want_m + 1)
          and np.array_equal(merged.cpu().numpy(), want_merge))
    log(f"phase 17 (f): get_unique_labels ({len(want_u)} classes), "
        f"make_monotonic (both bases) and merge_labels ({int(mh.sum())} "
        f"masked of {len(mh)}; {len(np.unique(want_merge))} merged labels) "
        f"on {len(lh)} labels in {secs:.3f} s; equal to numpy: {ok} "
        f"[{card}]")
    if not ok:
        raise AssertionError("phase 17 (f): a label utility differs from "
                             "numpy")
    return secs


def slice17_phase(dev, X, Q, cand, card) -> dict:
    """Phase 17: random/, Lloyd k-means, refine_host, stats/ and label/,
    counters set to 0 before it and read after its last step (B1 is timed
    at Lloyd's shape after that). Returns its launches and the B1
    figures."""
    import torch

    _zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    secs = draws_17(dev, card)
    torch.cuda.empty_cache()
    ll = lloyd_17(dev, card)
    secs["find_k"] = find_k_17(dev, card)
    secs.update({f"refine_{k}": v for k, v in
                 refine_17(dev, X, Q, cand, card).items() if v is not None})
    secs.update(stats_17(dev, ll["X"], ll["truth"], ll["labels"], card))
    secs["labels"] = labels_17(dev, ll["labels"], card)
    launches = _launches()
    total = time.perf_counter() - t0
    log(f"phase 17: {total:.3f} s, launches {launches} [{card}]")
    if launches["fused_knn"] < 1 or any(
            v for k, v in launches.items() if k not in B1_COUNTERS):
        raise AssertionError(f"phase 17 must launch B1 and only B1: "
                             f"{launches}")
    timing = b1_lloyd_17(ll["X"], ll["C"], ll, card)
    del ll["X"]
    torch.cuda.empty_cache()
    return {"launches": launches, "seconds": total,
            "fit_launches": ll["fit_launches"], **timing}


def _f64_l2_knn(X64, rows, k, labels=None):
    """Exact float64 squared-L2 kNN of ``X64[rows]`` among the rows of
    ``X64``, the row itself left out, or with ``labels`` only rows of
    another label; on the card, 100 rows at a time."""
    import torch

    xn = torch.sum(X64 * X64, dim=1)
    out_d, out_i = [], []
    for s in range(0, rows.shape[0], 100):
        r = rows[s:s + 100]
        dd = xn[r][:, None] + xn[None, :] - 2.0 * (X64[r] @ X64.T)
        if labels is None:
            dd[torch.arange(r.shape[0], device=r.device), r] = float("inf")
        else:
            dd.masked_fill_(labels[None, :] == labels[r][:, None],
                            float("inf"))
        d, i = torch.topk(dd, k, dim=1, largest=False)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)


def _ties_18(what, got_d, got_i, ref_d, ref_i, dist_of, tol) -> int:
    """Distances within ``tol`` (a scalar, or one per slot) of the
    reference's slot by slot; an id that differs must be at the
    reference's distance for its slot by ``dist_of(slot rows, ids)``.
    Returns the number of differing slots."""
    import torch

    got_d, ref_d = got_d.double(), ref_d.double()
    off = torch.abs(got_d - ref_d) - tol
    if float(off.max()) > 0:
        raise AssertionError(f"{what}: a distance is off the float64 one by "
                             f"{float(off.max())} past its tolerance")
    diff = got_i.long() != ref_i.long()
    rows, cols = torch.nonzero(diff, as_tuple=True)
    if rows.numel():
        ids = got_i.long()[rows, cols]
        if bool((ids < 0).any()):
            raise AssertionError(f"{what}: a padding id")
        t = tol if not torch.is_tensor(tol) else tol[rows, cols]
        bad = torch.abs(dist_of(rows, ids) - ref_d[rows, cols]) - t
        if float(bad.max()) > 0:
            raise AssertionError(f"{what}: a differing id is not at a "
                                 "near-tie")
    return int(diff.sum())


def graph_18(dev, X, card) -> dict:
    """Phase 18 (a): the kNN graph of X (B1 on every query chunk), held
    to an exact float64 kNN on N_SAMPLE_18 rows, and the first launch's
    first N_PLAIN_18 queries held to B1's plain version."""
    import torch

    from raft_tpu_torch.sparse import neighbors as sn

    fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")
    n = X.shape[0]
    launch = fk._fused_knn_cuda
    kept = {}

    def first(*args):
        out = launch(*args)
        if not kept:
            kept["m"] = args[0].shape[0]
            kept["args"] = (args[0][:N_PLAIN_18].clone(),) + args[1:]
            kept["out"] = tuple(o[:N_PLAIN_18].clone() for o in out)
        return out

    before = fk.fused_knn.launches
    fk._fused_knn_cuda = first
    try:
        g, secs = _timed(lambda: sn.knn_graph(X, K_18))
    finally:
        fk._fused_knn_cuda = launch
    launches = fk.fused_knn.launches - before
    chunks = -(-n // sn._KNN_GRAPH_CHUNK)
    rows0 = torch.arange(n, dtype=torch.int32, device=dev)
    if not (g.nnz == n * K_18 and g.shape == (n, n)
            and torch.equal(g.rows, torch.repeat_interleave(rows0, K_18))
            and bool((g.rows != g.cols).all())
            and bool(((g.cols >= 0) & (g.cols < n)).all())
            and launches == chunks):
        raise AssertionError(f"phase 18 (a): the graph's structure is wrong "
                             f"({g.nnz} edges, {launches} B1 launches)")

    X64 = X.double()
    s = torch.as_tensor(np.sort(np.random.default_rng(SEED + 180).choice(
        n, N_SAMPLE_18, replace=False)), device=dev)
    ref_d, ref_i = _f64_l2_knn(X64, s, K_18)
    got_d = g.vals.view(n, K_18)[s].double() ** 2
    got_i = g.cols.view(n, K_18)[s]
    tol = norm_tol(X, X)
    ties = _ties_18("phase 18 (a), knn_graph", got_d, got_i, ref_d, ref_i,
                    lambda r, i: torch.sum((X64[s[r]] - X64[i]) ** 2, dim=1),
                    tol)

    args, (kd, ki) = kept["args"], kept["out"]
    pd, pi = fk._fused_knn_plain(*args)
    agree = float((ki == pi).float().mean())
    err = max_err(kd, pd)
    ptol = norm_tol(args[0], args[1])
    log(f"phase 18 (a): knn_graph({n} x {X.shape[1]}, k={K_18}, "
        f"L2SqrtExpanded) {secs:.3f} s, {chunks} chunks of "
        f"{sn._KNN_GRAPH_CHUNK} queries, {launches} B1 launches (k "
        f"{args[2]}); {N_SAMPLE_18} rows against float64: ids equal but "
        f"{ties} slots at near-ties, distances within {tol:.3e}; the first "
        f"launch's first {N_PLAIN_18} queries vs plain: id agreement "
        f"{agree:.6f} (bar {RECALL_BF}), max |d| err {err:.3e} (tol "
        f"{ptol:.3e}) [{card}]")
    if agree < RECALL_BF or err > ptol:
        raise AssertionError("phase 18 (a): B1 disagrees with its plain "
                             "version")
    del X64, pd, pi
    return {"graph": g, "chunk": (kept["m"], args[2])}


def _host_csr_18(indptr, indices, vals, shape):
    import scipy.sparse as sp

    return sp.csr_matrix((vals.double().cpu().numpy(),
                          indices.cpu().numpy(), indptr.cpu().numpy()),
                         shape=shape)


def _same_18(what, got_rows, got_cols, got_vals, ref) -> None:
    """A port result, as (row, col, value) entries in (row, col) order,
    against a canonical scipy CSR: structure bit for bit, values within
    VAL_RTOL_18."""
    ref = ref.tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    rows = np.repeat(np.arange(ref.shape[0], dtype=np.int64),
                     np.diff(ref.indptr))
    gr = got_rows.cpu().numpy().astype(np.int64)
    gc = got_cols.cpu().numpy().astype(np.int64)
    if not (np.array_equal(gr, rows) and np.array_equal(gc, ref.indices)):
        raise AssertionError(f"phase 18 (b): {what}: structure differs "
                             "from scipy's")
    gv = got_vals.double().cpu().numpy()
    err = np.abs(gv - ref.data) - VAL_RTOL_18 * np.abs(ref.data)
    if err.size and float(err.max()) > 0:
        raise AssertionError(f"phase 18 (b): {what}: values off scipy's by "
                             f"{float(err.max())} past rtol {VAL_RTOL_18}")


def graph_ops_18(dev, g, card) -> dict:
    """Phase 18 (b): the sparse ops and linalg on the kNN graph, each
    against scipy.sparse in float64 on the host; SpMV and SpMM twice, bit
    for bit. Returns the symmetrised graph (COO and CSR) and scipy's."""
    import scipy.sparse as sp
    import torch

    from raft_tpu_torch import random as rnd
    from raft_tpu_torch.random import RngState
    from raft_tpu_torch.sparse import COO, CSR
    from raft_tpu_torch.sparse import convert as sc
    from raft_tpu_torch.sparse import linalg as sl
    from raft_tpu_torch.sparse import op as so

    n = g.shape[0]
    st = RngState(SEED + 181)
    times = {}

    def timed(name, fn):
        out, times[name] = _timed(fn)
        return out

    S = timed("symmetrize", lambda: sl.symmetrize(g))
    C = timed("coo_to_csr", lambda: sc.coo_to_csr(S))
    back = timed("csr_to_coo", lambda: sc.csr_to_coo(C))
    gs = timed("coo_sort", lambda: so.coo_sort(g))
    both = COO(torch.cat([g.rows, g.cols]), torch.cat([g.cols, g.rows]),
               torch.cat([g.vals, g.vals]), g.shape)
    md = timed("max_duplicates", lambda: so.max_duplicates(both))
    del both
    G = sc.coo_to_csr(gs)
    T = timed("transpose", lambda: sl.transpose(G))
    A2 = timed("add", lambda: sl.add(G, T))
    deg_g = timed("degree", lambda: sl.degree(g))
    deg_s = sl.degree(S)
    N1 = timed("row_normalize_l1", lambda: sl.row_normalize_l1(C))
    Nm = timed("row_normalize_max", lambda: sl.row_normalize_max(C))
    L = timed("laplacian", lambda: sl.laplacian(C))
    Ln = timed("laplacian_normalized", lambda: sl.laplacian(C, True))
    lo = (n - N_SLICE_18) // 2
    SL = timed("slice_csr", lambda: so.slice_csr(C, lo, lo + N_SLICE_18))
    zero = rnd.bernoulli(st, g.nnz, ZERO_FRAC_18, device=dev)
    gz = COO(g.rows, g.cols, torch.where(zero, 0.0, g.vals), g.shape)
    RZ = timed("remove_zeros", lambda: so.remove_zeros(gz))
    x = rnd.uniform(st, (n,), device=dev)
    B = rnd.uniform(st, (n, SPMM_COLS_18), device=dev)
    y1 = timed("spmv", lambda: sl.spmv(C, x))
    y2 = sl.spmv(C, x)
    Y1 = timed("spmm", lambda: sl.spmm(C, B))
    Y2 = sl.spmm(C, B)
    if not (torch.equal(y1, y2) and torch.equal(Y1, Y2)):
        raise AssertionError("phase 18 (b): spmv / spmm differ between two "
                             "runs")

    t0 = time.perf_counter()
    A = sp.csr_matrix((g.vals.double().cpu().numpy(),
                       (g.rows.cpu().numpy(), g.cols.cpu().numpy())),
                      shape=(n, n))
    Sref = ((A + A.T) * 0.5).tocsr()
    Sref.sort_indices()
    _same_18("symmetrize", S.rows, S.cols, S.vals, Sref)
    _same_18("coo_to_csr", C.row_ids(), C.indices, C.vals, Sref)
    if not (np.array_equal(C.indptr.cpu().numpy(), Sref.indptr)
            and torch.equal(back.rows, S.rows)
            and torch.equal(back.cols, S.cols)):
        raise AssertionError("phase 18 (b): csr / coo round trip differs")
    _same_18("coo_sort", gs.rows, gs.cols, gs.vals, A)
    _same_18("max_duplicates", md.rows, md.cols, md.vals, A + A.T)
    _same_18("transpose", T.row_ids(), T.indices, T.vals, A.T)
    _same_18("add", A2.row_ids(), A2.indices, A2.vals, A + A.T)
    counts = np.diff(Sref.indptr)
    if not (bool((deg_g == K_18).all())
            and np.array_equal(deg_s.cpu().numpy(), counts)):
        raise AssertionError("phase 18 (b): degree differs")
    rowsum = np.asarray(abs(Sref).sum(axis=1)).ravel()
    rowmax = np.asarray(abs(Sref).max(axis=1).todense()).ravel()
    _same_18("row_normalize_l1", N1.row_ids(), N1.indices, N1.vals,
             sp.diags(1.0 / rowsum) @ Sref)
    _same_18("row_normalize_max", Nm.row_ids(), Nm.indices, Nm.vals,
             sp.diags(1.0 / rowmax) @ Sref)
    deg = np.asarray(Sref.sum(axis=1)).ravel()
    _same_18("laplacian", L.row_ids(), L.indices, L.vals,
             sp.diags(deg) - Sref)
    dinv = sp.diags(1.0 / np.sqrt(deg))
    _same_18("laplacian (normalized)", Ln.row_ids(), Ln.indices, Ln.vals,
             sp.identity(n) - dinv @ Sref @ dinv)
    _same_18("slice_csr", SL.row_ids(), SL.indices, SL.vals,
             Sref[lo:lo + N_SLICE_18])
    zh = zero.cpu().numpy()
    if not (torch.equal(RZ.rows.cpu(), g.rows.cpu()[~zero.cpu()])
            and torch.equal(RZ.cols.cpu(), g.cols.cpu()[~zero.cpu()])
            and torch.equal(RZ.vals.cpu(), g.vals.cpu()[~zero.cpu()])):
        raise AssertionError("phase 18 (b): remove_zeros differs")
    xh, Bh = x.double().cpu().numpy(), B.double().cpu().numpy()
    for what, got, want in (("spmv", y1, Sref @ xh), ("spmm", Y1, Sref @ Bh)):
        err = np.abs(got.double().cpu().numpy() - want) - VAL_RTOL_18 * \
            np.abs(want)
        if float(err.max()) > 0:
            raise AssertionError(f"phase 18 (b): {what} off scipy's")
    host_s = time.perf_counter() - t0
    log(f"phase 18 (b): on the symmetrised graph ({S.nnz} entries from "
        f"{g.nnz} directed edges): " + ", ".join(
            f"{k} {v * 1e3:.1f} ms" for k, v in times.items())
        + f"; remove_zeros dropped {int(zh.sum())}; every structure equal "
        f"to scipy's, values within rtol {VAL_RTOL_18}, spmv / spmm bit for "
        f"bit over two runs; scipy's checks {host_s:.1f} s on the host "
        f"[{card}]")
    return {"S": S, "C": C, "Sref": Sref}


def components_18(dev, X, g, ops, card) -> None:
    """Phase 18 (c): the components of the symmetrised graph against
    scipy's, the cross-component edges held to a float64 nearest other
    component on N_SAMPLE_18 rows, and the MST over both edge sets
    against scipy's."""
    import scipy.sparse as sp
    import torch
    from scipy.sparse.csgraph import connected_components as sp_cc
    from scipy.sparse.csgraph import minimum_spanning_tree

    from raft_tpu_torch.sparse import neighbors as sn

    # The package exports the function mst, which shadows its module.
    mst_mod = importlib.import_module("raft_tpu_torch.sparse.solver.mst")
    n = X.shape[0]
    S = ops["S"]
    (lab, steps), cc_s = _timed(
        lambda: sn._connected_components(S.rows, S.cols, n))
    n_comp, sp_lab = sp_cc(ops["Sref"], directed=False)
    least = np.full(n_comp, n, np.int64)
    np.minimum.at(least, sp_lab, np.arange(n))
    same = np.array_equal(lab.cpu().numpy(), least[sp_lab])
    log(f"phase 18 (c): connected_components {cc_s:.3f} s: {n_comp} "
        f"components (scipy's), {steps} steps of the cap of "
        f"{sn._CC_MAX_STEPS}; labels = each scipy component's smallest id: "
        f"{same} [{card}]")
    if not same:
        raise AssertionError("phase 18 (c): the components differ from "
                             "scipy's")

    link, link_s = _timed(lambda: sn.connect_components(X, lab))
    if not (link.nnz == n and bool((lab[link.rows.long()]
                                    != lab[link.cols.long()]).all())):
        raise AssertionError("phase 18 (c): a linking edge stays inside its "
                             "component")
    X64 = X.double()
    s = torch.as_tensor(np.sort(np.random.default_rng(SEED + 182).choice(
        n, N_SAMPLE_18, replace=False)), device=dev)
    ref_d, ref_i = _f64_l2_knn(X64, s, 1, labels=lab)
    tol = norm_tol(X, X)
    ties = _ties_18("phase 18 (c), connect_components",
                    link.vals[s][:, None].double() ** 2,
                    link.cols[s][:, None], ref_d, ref_i,
                    lambda r, i: torch.sum((X64[s[r]] - X64[i]) ** 2, dim=1),
                    tol)
    del X64

    rows = torch.cat([g.rows, link.rows])
    cols = torch.cat([g.cols, link.cols])
    w = torch.cat([g.vals, link.vals])
    uf = {}
    union_find = mst_mod._union_find

    def timed_uf(*args):
        t0 = time.perf_counter()
        out = union_find(*args)
        uf["s"] = time.perf_counter() - t0
        uf["edges"] = len(args[0])
        return out

    mst_mod._union_find = timed_uf
    try:
        forest, mst_s = _timed(lambda: mst_mod.mst(rows, cols, w, n))
    finally:
        mst_mod._union_find = union_find
    log(f"phase 18 (c): mst's host union-find {uf['s']:.3f} s over "
        f"{uf['edges']} selected directed edges [{card}]")

    t0 = time.perf_counter()
    rh, ch = rows.cpu().numpy().astype(np.int64), cols.cpu().numpy()
    wh = w.double().cpu().numpy()
    lo, hi = np.minimum(rh, ch), np.maximum(rh, ch)
    key = lo * n + hi
    order = np.argsort(key, kind="stable")
    key, wh = key[order], wh[order]
    start = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    wmin = np.minimum.reduceat(wh, start)
    U = sp.csr_matrix((wmin, (key[start] // n, key[start] % n)),
                      shape=(n, n))
    n_union, _ = sp_cc(U, directed=False)
    want = float(minimum_spanning_tree(U).sum())
    got = float(forest.weights.double().sum())
    scipy_s = time.perf_counter() - t0
    log(f"phase 18 (c): connect_components {link_s:.3f} s ({N_SAMPLE_18} "
        f"rows against float64: ids equal but {ties} at near-ties, "
        f"distances within {tol:.3e}); mst over {rows.shape[0]} edges "
        f"{mst_s:.3f} s: {forest.n_edges} edges (n - C = {n - n_union}), "
        f"weight {got:.6f} against scipy's {want:.6f} (rel "
        f"{abs(got - want) / want:.2e}, bar {VAL_RTOL_18}; scipy "
        f"{scipy_s:.1f} s on the host) [{card}]")
    if forest.n_edges != n - n_union or abs(got - want) > VAL_RTOL_18 * want:
        raise AssertionError("phase 18 (c): the MST differs from scipy's")


def lanczos_18(dev, C, card) -> None:
    """Phase 18 (d): M = D + eps A_hat (A_hat the graph's normalised
    adjacency, ||A_hat|| <= 1; D diagonal, its bulk in [0, 1] and 8
    values planted at each end): the 8 largest and smallest eigenpairs
    within EIG_TOL_18 of the planted values, float64 residuals, and two
    runs bit for bit."""
    import torch

    from raft_tpu_torch import random as rnd
    from raft_tpu_torch.random import RngState
    from raft_tpu_torch.sparse import CSR
    from raft_tpu_torch.sparse import linalg as sl
    from raft_tpu_torch.sparse.solver import (lanczos_largest_eigenpairs,
                                              lanczos_smallest_eigenpairs)

    n = C.shape[0]
    st = RngState(SEED + 183)
    diag = rnd.uniform(st, (n,), 0.0, 1.0, device=dev)
    _, pos = rnd.sample_without_replacement(st, n, 2 * EIG_K_18, device=dev)
    planted = torch.cat([torch.arange(-9.0, -1.0), torch.arange(2.0, 10.0)])
    diag[pos.long()] = planted.to(dev)
    dinv = 1.0 / torch.sqrt(sl.spmv(C, torch.ones(n, device=dev)))
    ahat = C.vals * dinv[C.row_ids().long()] * dinv[C.indices.long()]
    ids = torch.arange(n + 1, dtype=torch.int32, device=dev)
    M = sl.add(CSR(ids, ids[:n], diag, (n, n)),
               CSR(C.indptr, C.indices, EIG_EPS_18 * ahat, (n, n)))
    (wl, Ul), large_s = _timed(
        lambda: lanczos_largest_eigenpairs(M, EIG_K_18, seed=SEED))
    (ws, Us), small_s = _timed(
        lambda: lanczos_smallest_eigenpairs(M, EIG_K_18, seed=SEED))
    wl2, Ul2 = lanczos_largest_eigenpairs(M, EIG_K_18, seed=SEED)
    repeat = torch.equal(wl, wl2) and torch.equal(Ul, Ul2)
    want_l = torch.arange(9.0, 1.0, -1.0, dtype=torch.float64)
    want_s = torch.arange(-9.0, -1.0, dtype=torch.float64)
    err = max(float(torch.max(torch.abs(wl.double().cpu() - want_l))),
              float(torch.max(torch.abs(ws.double().cpu() - want_s))))
    M64 = CSR(M.indptr, M.indices, M.vals.double(), M.shape)
    norm = 9.0 + EIG_EPS_18           # ||M|| <= max|D| + eps ||A_hat||
    resid = max(float(torch.linalg.vector_norm(
        sl.spmv(M64, U[:, j].double()) - float(w[j]) * U[:, j].double()))
        for w, U in ((wl, Ul), (ws, Us)) for j in range(EIG_K_18))
    log(f"phase 18 (d): Lanczos on M = D + {EIG_EPS_18} A_hat ({n} x {n}, "
        f"{M.nnz} entries, ncv 64): largest 8 {large_s:.3f} s, smallest 8 "
        f"{small_s:.3f} s; eigenvalues off the planted by at most {err:.2e} "
        f"(bar {EIG_TOL_18}), float64 residuals at most {resid:.2e} (bar "
        f"{RESID_18 * norm:.2e} = {RESID_18} ||M||); two runs bit for bit: "
        f"{repeat} [{card}]")
    if err > EIG_TOL_18 or resid > RESID_18 * norm or not repeat:
        raise AssertionError("phase 18 (d): Lanczos off its bars")


def tfidf_rows_18(st, rows, dev):
    """A TF-IDF-shaped CSR: TFIDF_18's columns, each row's nnz lognormal
    (mean about 100) clipped to [lo, hi], its columns drawn without
    replacement with Zipf(ZIPF_18) weights (exponential keys over the
    weights, the smallest kept), values tf x idf with rows scaled to unit
    L2, all drawn with the port's random/ on the card."""
    import torch

    from raft_tpu_torch import random as rnd
    from raft_tpu_torch.sparse import CSR

    _, d, lo, hi = TFIDF_18
    w = torch.arange(1, d + 1, dtype=torch.float32, device=dev) ** -ZIPF_18
    p = w / torch.sum(w)
    idf = torch.log(1.0 + 1.0 / (100.0 * p))
    nnz = torch.clamp(torch.round(rnd.lognormal(st, (rows,), 4.5, 0.45,
                                                device=dev)), lo, hi).long()
    cols = []
    slot = torch.arange(hi, device=dev)
    for s in range(0, rows, 2048):
        keys = rnd.exponential(st, (min(2048, rows - s), d),
                               device=dev) / w[None, :]
        top = torch.topk(keys, hi, dim=1, largest=False).indices
        sel = torch.where(slot[None, :] < nnz[s:s + 2048, None], top, d)
        sel = torch.sort(sel, dim=1).values
        cols.append(sel[sel < d])
        del keys
    cols = torch.cat(cols).int()
    tf = 1.0 + torch.floor(2.0 * rnd.exponential(st, (cols.shape[0],),
                                                 device=dev))
    vals = tf * idf[cols.long()]
    rid = torch.repeat_interleave(torch.arange(rows, device=dev), nnz)
    n2 = torch.zeros(rows, device=dev).index_add_(0, rid, vals * vals)
    vals = vals / torch.sqrt(n2)[rid]
    indptr = torch.cat([nnz.new_zeros(1), torch.cumsum(nnz, 0)]).int()
    return CSR(indptr, cols, vals, (rows, d))


def _f64_sparse_18(metric, Qd, Y):
    """Float64 distances (s, n) from the dense query rows ``Qd`` (s, d) to
    the CSR rows of ``Y``, on the card: each entry of Y meets the queries'
    values at its column, and the metric's intersection terms add per
    row (the rest follow from the rows' sums)."""
    import torch

    from raft_tpu_torch.distance.distance_types import DistanceType as M

    n = Y.shape[0]
    rid = Y.row_ids().long()
    col = Y.indices.long()
    v = Y.vals.double()
    acc = torch.zeros((Qd.shape[0], n), dtype=torch.float64,
                      device=Qd.device)
    ln2 = float(np.log(2.0))
    for s in range(0, v.shape[0], 1 << 21):
        a, b = Qd[:, col[s:s + (1 << 21)]], v[s:s + (1 << 21)][None, :]
        if metric == M.L1:
            t = torch.where(a != 0, torch.abs(a - b) - a - b, 0.0)
        elif metric == M.JensenShannon:
            m = 0.5 * (a + b)
            f = -a * (torch.log(m) - torch.log(a)) - b * (torch.log(m)
                                                         - torch.log(b))
            t = torch.where(a != 0, f - (a + b) * ln2, 0.0)
        elif metric == M.HellingerExpanded:
            t = torch.sqrt(a) * torch.sqrt(b)
        else:
            t = a * b
        acc.index_add_(1, rid[s:s + (1 << 21)], t)
    y1 = torch.zeros(n, dtype=torch.float64, device=v.device).index_add_(
        0, rid, v)
    y2 = torch.zeros(n, dtype=torch.float64, device=v.device).index_add_(
        0, rid, v * v)
    q1, q2 = Qd.sum(dim=1)[:, None], (Qd * Qd).sum(dim=1)[:, None]
    if metric == M.L2Expanded:
        return torch.clamp_min(q2 + y2[None, :] - 2.0 * acc, 0.0)
    if metric == M.InnerProduct:
        return acc
    if metric == M.CosineExpanded:
        return 1.0 - acc / (torch.sqrt(q2) * torch.sqrt(y2)[None, :])
    if metric == M.L1:
        return q1 + y1[None, :] + acc
    if metric == M.JensenShannon:
        return torch.sqrt(0.5 * (ln2 * (q1 + y1[None, :]) + acc))
    if metric == M.HellingerExpanded:
        # The squared distance (1 - g, clamped): the square root near 0
        # would multiply f32's rounding past any fixed bar.
        return torch.clamp_min(1.0 - acc, 0.0)
    raise ValueError(metric)


def tfidf_18(dev, card) -> None:
    """Phase 18 (e): sparse kNN and pairwise distances on TF-IDF-shaped
    rows through each engine, the route named, held to float64 on
    N_CHECK_18 queries (kNN) or N_PAIR_ROWS_18 rows (pairwise)."""
    import torch

    from raft_tpu_torch.distance.distance_types import DistanceType as M
    from raft_tpu_torch.random import RngState
    from raft_tpu_torch.sparse import distance as sd
    from raft_tpu_torch.sparse import neighbors as sn
    from raft_tpu_torch.sparse import op as so

    rows, d = TFIDF_18[0], TFIDF_18[1]
    (Y, Q, Qb), gen_s = _timed(lambda: (
        tfidf_rows_18(RngState(SEED + 184), rows, dev),
        tfidf_rows_18(RngState(SEED + 185), N_TFIDF_Q_18, dev),
        tfidf_rows_18(RngState(SEED + 186), N_BLOCKED_18[0], dev)))
    Y20 = so.slice_csr(Y, 0, N_BLOCKED_18[1])
    nnz = torch.diff(Y.indptr).float()
    log(f"phase 18 (e): TF-IDF rows {rows} x {d}, {Y.nnz} entries (row nnz "
        f"{int(nnz.min())}-{int(nnz.max())}, mean {float(nnz.mean()):.1f}), "
        f"queries {N_TFIDF_Q_18} and {N_BLOCKED_18[0]}, made in "
        f"{gen_s:.2f} s [{card}]")
    calls = [("knn", M.L2Expanded, Y, Q, "xdense"),
             ("knn", M.CosineExpanded, Y, Q, "xdense"),
             ("knn", M.InnerProduct, Y, Q, "xdense"),
             ("knn", M.L1, Y, Q, "semiring"),
             ("knn", M.JensenShannon, Y, Q, "semiring"),
             ("knn", M.CosineExpanded, Y20, Qb, "blocked"),
             ("pairwise", M.L2Expanded, Y20, Q, "xdense"),
             ("pairwise", M.HellingerExpanded, Y20, Q, "xdense")]
    pick = np.random.default_rng(SEED + 187)
    for kind, metric, db, q, engine in calls:
        route = sd._route(q, db, metric, knn=kind == "knn")
        if route != engine:
            raise AssertionError(f"phase 18 (e): {kind} {metric.name} routes "
                                 f"to {route}, not {engine}")
        if kind == "knn":
            (gd, gi), secs = _timed(lambda: sn.brute_force_knn(
                db, q, K_TFIDF_18, metric=metric))
            s = torch.as_tensor(np.sort(pick.choice(q.shape[0], N_CHECK_18,
                                                    replace=False)),
                                device=dev)
        else:
            got, secs = _timed(lambda: sd.pairwise_distance(q, db, metric))
            s = torch.as_tensor(np.sort(pick.choice(
                q.shape[0], N_PAIR_ROWS_18, replace=False)), device=dev)
        Qd = q.to_dense()[s].double()
        full = _f64_sparse_18(metric, Qd, db)
        if kind == "knn":
            largest = metric == M.InnerProduct
            ref_d, ref_i = torch.topk(full, K_TFIDF_18, dim=1,
                                      largest=largest)
            tol = SPARSE_TOL_18 * (1.0 + torch.abs(ref_d))
            ties = _ties_18(f"phase 18 (e), {metric.name} kNN", gd[s],
                            gi[s], ref_d, ref_i,
                            lambda r, i: full[r, i], tol)
            note = f"ids equal but {ties} slots at near-ties"
        else:
            g = got[s].double()
            if metric == M.HellingerExpanded:
                g = g * g
            err = torch.abs(g - full) - SPARSE_TOL_18 * (1.0 + torch.abs(full))
            if float(err.max()) > 0:
                raise AssertionError(f"phase 18 (e): pairwise {metric.name} "
                                     "off float64")
            note = f"max |err| {float(torch.abs(g - full).max()):.2e}"
        log(f"phase 18 (e): {kind} {metric.name} {q.shape[0]} x "
            f"{db.shape[0]} ({engine}) {secs:.3f} s; against float64 on "
            f"{s.shape[0]} rows: {note} (tol {SPARSE_TOL_18} x (1 + |d|)) "
            f"[{card}]")
        del full


def b1_graph_18(X, chunk, card) -> dict:
    """Phase 18 (a), after the phase's launches are read: B1 at the kNN
    graph's chunk shape beside ``addmm`` + ``topk`` over 2500-query
    slices, and its bound (:func:`b1_f32_bound`: the three TF32 products,
    beside the FP32 pipes')."""
    import torch

    fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")
    m, k = chunk
    n, d = X.shape
    Qc = X[:m].contiguous()
    ms = time_ms(lambda: fk._fused_knn_cuda(Qc, X, k, True, False, False),
                 1, warmup=0)
    yn = torch.sum(X * X, dim=1)

    def library():
        for s in range(0, m, 2500):
            torch.topk(torch.addmm(yn, Qc[s:s + 2500], X.t(), alpha=-2.0),
                       k, dim=1, largest=False)

    lib_ms = time_ms(library, 1, warmup=0)
    ops = 2.0 * m * n * d
    nbytes = 4.0 * (m * d + n * d) + 8.0 * m * k
    bound, by, fp32 = b1_f32_bound(m, n, d, nbytes)
    log(f"phase 18 (a): B1 at the kNN graph's chunk m={m} n={n} d={d} "
        f"k={k}: {ms:.3f} ms ({ops / ms / 1e9:.1f} TFLOP/s of the f32 "
        f"gram), library (addmm + topk over {-(-m // 2500)} slices) "
        f"{lib_ms:.3f} ms, bound {bound:.3f} ms ({by}; the FP32 pipes' "
        f"{fp32:.3f} ms) [{card}]")
    return {"b1_ms": ms, "lib_ms": lib_ms, "bound_ms": bound}


def slice18_phase(dev, X, card) -> dict:
    """Phase 18: the sparse layer, counters set to 0 before it and read
    after its last step (B1 is timed at the graph's chunk shape after
    that). Returns its launches, its seconds and the B1 figures."""
    import torch

    _zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Xr = X[:ROWS_18]
    a = graph_18(dev, Xr, card)
    b = graph_ops_18(dev, a["graph"], card)
    components_18(dev, Xr, a["graph"], b, card)
    del b["Sref"]
    lanczos_18(dev, b["C"], card)
    del a["graph"], b
    torch.cuda.empty_cache()
    tfidf_18(dev, card)
    launches = _launches()
    total = time.perf_counter() - t0
    log(f"phase 18: {total:.3f} s, launches {launches} [{card}]")
    if launches["fused_knn"] < 1 or any(
            v for k, v in launches.items() if k not in B1_COUNTERS):
        raise AssertionError(f"phase 18 must launch B1 and only B1: "
                             f"{launches}")
    torch.cuda.empty_cache()
    timing = b1_graph_18(X, a["chunk"], card)
    return {"launches": launches, "seconds": total, **timing}

def lap_19(dev, card) -> dict:
    """Phase 19 (a): ``LinearAssignmentProblem`` on 8 x 1024 x 1024 costs
    and ``lap`` on each slice, integer and uniform float costs: every
    slice of the batch equals ``lap`` on it bit for bit, each result is a
    permutation, integer objectives equal scipy's optimum (n * eps_floor
    < 1 makes the auction exact) and float ones lie within 4e-6 n span of
    it (both summed in float64)."""
    import torch
    from scipy.optimize import linear_sum_assignment

    from raft_tpu_torch.solver import LinearAssignmentProblem, lap

    B, n = LAP_19
    rng = np.random.default_rng(SEED + 190)
    out = {}
    for kind in ("integer", "float"):
        if kind == "integer":
            ch = rng.integers(0, LAP_INT_19, (B, n, n)).astype(np.float32)
        else:
            ch = rng.random((B, n, n), dtype=np.float32)
        C = torch.as_tensor(ch, device=dev)
        p = LinearAssignmentProblem(n, B)
        _, batch_s = _timed(lambda: p.solve(C))
        lap_s, worst = 0.0, 0.0
        for b in range(B):
            (a, total), secs = _timed(lambda: lap(C[b]))
            lap_s += secs
            if not torch.equal(a, p.getAssignmentVector(b)):
                raise AssertionError(f"phase 19 (a): {kind} slice {b}: the "
                                     "batch differs from lap")
            ah = a.cpu().numpy()
            if not np.array_equal(np.sort(ah), np.arange(n)):
                raise AssertionError(f"phase 19 (a): {kind} slice {b} is "
                                     "not a permutation")
            c64 = ch[b].astype(np.float64)
            r, c = linear_sum_assignment(ch[b])
            opt = float(c64[r, c].sum())
            got = float(c64[np.arange(n), ah].sum())
            bound = 0.0 if kind == "integer" else (
                LAP_EPS_19 * n * max(float(np.abs(ch[b]).max()), 1.0))
            if not opt <= got <= opt + bound:
                raise AssertionError(f"phase 19 (a): {kind} slice {b}: "
                                     f"objective {got} against scipy's {opt} "
                                     f"(bound {bound})")
            if abs(float(total) - got) > 1e-5 * abs(got):
                raise AssertionError(f"phase 19 (a): {kind} slice {b}: the "
                                     "returned total is off the sum")
            worst = max(worst, got - opt)
        log(f"phase 19 (a): {kind} costs {B} x {n} x {n}: the batch "
            f"{batch_s:.3f} s, lap on each slice {lap_s:.3f} s in all; "
            f"every slice = lap bit for bit, a permutation, objective over "
            f"scipy's optimum by at most {worst:.3e} (bound "
            f"{'0' if kind == 'integer' else f'{bound:.3e}'}) [{card}]")
        out[kind] = batch_s + lap_s
    return out


def eps_19(dev, card) -> float:
    """Phase 19 (b): ``eps_neighbors_l2sq`` on 10,000 x 100,000 x 32
    Gaussian rows, eps^2 the median of 10,000 float64 pair distances:
    the adjacency against float64 on the card (a pair may differ only
    within 1e-5 relative of eps^2), the degrees their row sums and the
    total last."""
    import torch

    from raft_tpu_torch.neighbors import eps_neighbors_l2sq

    m, nn, d = EPS_SHAPE_19
    rng = np.random.default_rng(SEED + 191)
    xh = rng.standard_normal((m, d), dtype=np.float32)
    yh = rng.standard_normal((nn, d), dtype=np.float32)
    i = rng.integers(0, m, N_EPS_PAIRS_19)
    j = rng.integers(0, nn, N_EPS_PAIRS_19)
    pairs = ((xh[i].astype(np.float64) - yh[j]) ** 2).sum(1)
    eps_sq = float(np.float32(np.median(pairs)))
    x = torch.as_tensor(xh, device=dev)
    y = torch.as_tensor(yh, device=dev)
    (adj, vd), secs = _timed(lambda: eps_neighbors_l2sq(x, y, eps_sq))
    x64, y64 = x.double(), y.double()
    yn = torch.sum(y64 * y64, dim=1)
    band = EPS_BAND_19 * eps_sq
    differ = near = 0
    deg64 = torch.zeros(m, dtype=torch.int64, device=dev)
    for s in range(0, m, 1000):
        xb = x64[s:s + 1000]
        d64 = torch.sum(xb * xb, dim=1)[:, None] + yn[None, :] \
            - 2.0 * (xb @ y64.T)
        ref = d64 < eps_sq
        deg64[s:s + 1000] = ref.sum(1)
        diff = adj[s:s + 1000] != ref
        close = torch.abs(d64 - eps_sq) <= band
        if bool((diff & ~close).any()):
            raise AssertionError("phase 19 (b): an adjacency entry differs "
                                 "from float64 off the threshold's band")
        differ += int(diff.sum())
        near += int(close.sum())
    deg = adj.sum(1)
    if not (vd.dtype == torch.int32 and vd.shape == (m + 1,)
            and torch.equal(vd[:m].long(), deg)
            and int(vd[m]) == int(deg.sum())):
        raise AssertionError("phase 19 (b): vd is not the row degrees and "
                             "their total")
    log(f"phase 19 (b): eps_neighbors_l2sq {m} x {nn} x {d} {secs:.3f} s, "
        f"eps^2 {eps_sq:.4f}, {int(vd[m])} pairs within (float64 "
        f"{int(deg64.sum())}); {differ} entries differ from float64, all "
        f"inside the band of {EPS_BAND_19} x eps^2 that holds {near} "
        f"pairs [{card}]")
    return secs


def _terrain_19(rng, rows):
    """Terrain-like 3-D points: (x, y) uniform in [-1, 1)^2, z Gaussian
    with std BC_Z_STD_19."""
    xy = rng.uniform(-1.0, 1.0, (rows, 2))
    z = BC_Z_STD_19 * rng.standard_normal((rows, 1))
    return np.concatenate([xy, z], axis=1).astype(np.float32)


def _lat_lon_19(rng, rows):
    """Points uniform on the sphere as (lat, lon) radians."""
    lat = np.arcsin(rng.uniform(-1.0, 1.0, rows))
    lon = rng.uniform(-np.pi, np.pi, rows)
    return np.stack([lat, lon], axis=1).astype(np.float32)


def _f64_knn_19(X64, Q64, k, haversine=False):
    """Exact float64 kNN of the rows of ``Q64`` among ``X64`` on the card,
    100 queries at a time: squared L2 (unexpanded) or haversine."""
    import torch

    out_d, out_i = [], []
    for s in range(0, Q64.shape[0], 100):
        q = Q64[s:s + 100]
        if haversine:
            s0 = torch.sin(0.5 * (q[:, 0:1] - X64[None, :, 0]))
            s1 = torch.sin(0.5 * (q[:, 1:2] - X64[None, :, 1]))
            r = s0 * s0 + torch.cos(q[:, 0:1]) * torch.cos(X64[None, :, 0]) \
                * s1 * s1
            dd = 2.0 * torch.arcsin(torch.sqrt(r))
        else:
            dd = torch.zeros((q.shape[0], X64.shape[0]), dtype=torch.float64,
                             device=q.device)
            for c in range(q.shape[1]):
                dd += (q[:, c:c + 1] - X64[None, :, c]) ** 2
        d, i = torch.topk(dd, k, dim=1, largest=False)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)


def _expanded_tol_19(Q, X) -> float:
    """The rounding of ball cover's f32 expanded squared L2 |q|^2 + |x|^2
    - 2 q.x on 3-D rows, at most seven roundings of 2^-24 relative to
    the norms' sum (three in each sum of squares and of products, one in
    the total): 7 * 2^-24 * (max |q|^2 + max |x|^2)."""
    import torch

    qn = float(torch.max(torch.sum(Q.double() ** 2, dim=-1)))
    xn = float(torch.max(torch.sum(X.double() ** 2, dim=-1)))
    return 7.0 * 2.0 ** -24 * (qn + xn)


def _bc_check_19(what, d, i, X, Q, k, haversine=False, tol=None):
    """BC_CHECK_19 sampled queries of a ball-cover answer against an exact
    float64 kNN: distances slot by slot within ``tol`` (L2: compared
    squared, within :func:`_expanded_tol_19` by default); each returned
    id at its returned distance within ``tol``, no id twice in a row;
    every float64 neighbour more than ``tol`` inside the k-th distance
    returned; a differing id only at a near-tie. Returns (differing
    slots, largest distance error, tol)."""
    import torch

    n_q = Q.shape[0]
    rng = np.random.default_rng(SEED + 192)
    s = torch.as_tensor(np.sort(rng.choice(n_q, min(BC_CHECK_19, n_q),
                                           replace=False)), device=Q.device)
    X64, Q64 = X.double(), Q[s].double()
    ref_d, ref_i = _f64_knn_19(X64, Q64, k, haversine)
    got = d[s].double() if haversine else d[s].double() ** 2
    if tol is None:
        tol = _expanded_tol_19(Q, X)

    def dist_of(rows, ids):
        if haversine:
            q, x = Q64[rows], X64[ids]
            s0 = torch.sin(0.5 * (q[:, 0] - x[:, 0]))
            s1 = torch.sin(0.5 * (q[:, 1] - x[:, 1]))
            return 2.0 * torch.arcsin(torch.sqrt(
                s0 * s0 + torch.cos(q[:, 0]) * torch.cos(x[:, 0]) * s1 * s1))
        return torch.sum((Q64[rows] - X64[ids]) ** 2, dim=1)

    ties = _ties_18(what, got, i[s], ref_d, ref_i, dist_of, tol)
    gi = i[s].long()
    rows = torch.arange(gi.shape[0], device=gi.device)[:, None].expand_as(gi)
    own = dist_of(rows.reshape(-1), gi.reshape(-1)).reshape(gi.shape)
    if float(torch.max(torch.abs(own - got))) > tol:
        raise AssertionError(f"{what}: an id is not at its distance")
    srt = torch.sort(gi, dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        raise AssertionError(f"{what}: an id twice in one answer")
    inside = ref_d < ref_d[:, -1:] - tol
    present = (ref_i.long()[:, :, None] == gi[:, None, :]).any(dim=2)
    if bool((inside & ~present).any()):
        raise AssertionError(f"{what}: a neighbour clearly inside the k "
                             "nearest is missing")
    return ties, float(torch.max(torch.abs(got - ref_d))), tol


def ball_cover_19(dev, card) -> dict:
    """Phase 19 (c): ball cover on 1M terrain rows (L2SqrtUnexpanded) and
    1M (lat, lon) rows (Haversine): build, 10,000 queries at k=32, 1000
    of them held to float64; ``all_knn_query`` of 200,000 terrain rows at
    k=16; ``eps_nn`` of 1000 queries against float64 (a row may differ
    only within the expanded form's rounding of eps^2); 64 queries 2000
    above the terrain (1000 x its extent) at k=64, where every unprobed
    landmark's ball reaches below the k-th distance, so the probes widen
    to half the landmarks and the rest take the dense scan, whose select
    (64 x 1M, k=64) is B5. Returns the seconds and the far queries' B5
    launches."""
    import torch

    from raft_tpu_torch.distance.distance_types import DistanceType
    from raft_tpu_torch.neighbors import ball_cover as bc
    from raft_tpu_torch.ops import stream_select as ss

    rng = np.random.default_rng(SEED + 193)
    big = {"bytes": 0}
    scan = bc._scan_probed

    def recording(index, queries, probe_ids, k):
        cap, p = index.groups.shape[1], probe_ids.shape[1]
        batch = max(1, bc._QUERY_BYTES // bc._scan_bytes(p * cap, index.n))
        rows = min(queries.shape[0], batch)
        big["bytes"] = max(big["bytes"], rows * p * cap * index.n * 4)
        return scan(index, queries, probe_ids, k)

    out = {}
    bc._scan_probed = recording
    try:
        X = torch.as_tensor(_terrain_19(rng, BC_ROWS_19), device=dev)
        Q = torch.as_tensor(_terrain_19(rng, BC_QUERIES_19), device=dev)
        index, b_s = _timed(lambda: bc.build_index(
            X, DistanceType.L2SqrtUnexpanded, seed=SEED))
        (d, i), q_s = _timed(lambda: bc.knn_query(index, Q, BC_K_19))
        ties, err, tol = _bc_check_19("phase 19 (c), L2 knn_query", d, i, X,
                                      Q, BC_K_19)
        log(f"phase 19 (c): ball cover L2SqrtUnexpanded on {BC_ROWS_19} x 3 "
            f"terrain rows: build {b_s:.3f} s ({index.n_landmarks} "
            f"landmarks, cap {index.groups.shape[1]}), knn_query "
            f"{BC_QUERIES_19} x k={BC_K_19} {q_s:.3f} s; {BC_CHECK_19} "
            f"queries against float64: squared distances within "
            f"{err:.3e} (tol {tol:.3e}), {ties} slots at near-ties [{card}]")
        out.update(l2_build_s=b_s, l2_query_s=q_s,
                   cap=index.groups.shape[1])

        nq, eps = BC_EPS_19
        (adj, vd), e_s = _timed(lambda: bc.eps_nn(index, Q[:nq], eps))
        X64 = X.double()
        band = _expanded_tol_19(Q[:nq], X)
        differ = 0
        for s in range(0, nq, 100):
            q64 = Q[s:s + 100].double()
            d64 = torch.zeros((q64.shape[0], X.shape[0]),
                              dtype=torch.float64, device=dev)
            for c in range(3):
                d64 += (q64[:, c:c + 1] - X64[None, :, c]) ** 2
            diff = adj[s:s + 100] != (d64 <= eps * eps)
            if bool((diff & (torch.abs(d64 - eps * eps) > band)).any()):
                raise AssertionError("phase 19 (c): eps_nn differs from "
                                     "float64 off the threshold's band")
            differ += int(diff.sum())
        if not torch.equal(vd, adj.sum(1).int()):
            raise AssertionError("phase 19 (c): eps_nn's degrees are not "
                                 "its row sums")
        log(f"phase 19 (c): eps_nn {nq} queries x {BC_ROWS_19} rows, eps "
            f"{eps}: {e_s:.3f} s, {int(vd.sum())} pairs, {differ} differ "
            f"from float64, all within {band:.3e} of eps^2 [{card}]")
        del adj, vd

        n_far, k_far, height = BC_FAR_19
        Qf = np.concatenate([rng.uniform(-1.0, 1.0, (n_far, 2)),
                             np.full((n_far, 1), height)], axis=1)
        Qf = torch.as_tensor(Qf.astype(np.float32), device=dev)
        before = ss.stream_extract.launches
        dense = bc._dense
        calls = {"dense_rows": 0}

        def counting(index_, queries, k):
            calls["dense_rows"] += queries.shape[0]
            return dense(index_, queries, k)

        bc._dense = counting
        try:
            (fd, fi), f_s = _timed(lambda: bc.knn_query(index, Qf, k_far))
        finally:
            bc._dense = dense
        b5 = ss.stream_extract.launches - before
        if calls["dense_rows"] != n_far or b5 < 1:
            raise AssertionError("phase 19 (c): the far queries must all "
                                 "take the dense scan through B5")
        # 2000 above the cloud, f32 squared distances (~4e6, a step of
        # 0.25) cannot order rows whose true ones differ by less, so no
        # float64 kNN can judge the answer. The same index on the CPU
        # must give it bit for bit (B5's select against the sort's, ties
        # included), and its distances must be the k smallest of the
        # same f32 distances over every row.
        cpu = dataclasses.replace(index, **{
            f: getattr(index, f).cpu() for f in (
                "X", "landmarks", "groups", "group_indices", "group_sizes",
                "radii")})
        (cd, ci), c_s = _timed(lambda: bc.knn_query(cpu, Qf.cpu(), k_far))
        if not (torch.equal(fd.cpu(), cd) and torch.equal(fi.cpu(), ci)):
            raise AssertionError("phase 19 (c): the far queries' answer "
                                 "differs from the same index's on the CPU")
        del cpu
        dense_d = torch.topk(bc._dist(Qf, X, index.metric), k_far, dim=1,
                             largest=False).values
        if not torch.equal(fd, torch.sqrt(dense_d)):
            raise AssertionError("phase 19 (c): the far queries' distances "
                                 "are not the k smallest f32 ones")
        own = torch.sqrt(bc._dist_rows(Qf, X[fi.long()], index.metric))
        if not torch.equal(fd, own):
            raise AssertionError("phase 19 (c): a far query's id is not at "
                                 "its distance")
        log(f"phase 19 (c): {n_far} queries {height} above the terrain, "
            f"k={k_far}: {f_s:.3f} s, {calls['dense_rows']} took the dense "
            f"scan, {b5} B5 launches; ids and distances = the same index's "
            f"on the CPU ({c_s:.3f} s there), distances = the {k_far} "
            f"smallest f32 ones [{card}]")
        out.update(far_s=f_s, b5=b5)
        del index

        rows, k_all = BC_ALL_19
        Xa = X[:rows].contiguous()
        sub = bc.build_index(Xa, DistanceType.L2SqrtUnexpanded, seed=SEED)
        (ad, ai), a_s = _timed(lambda: bc.all_knn_query(sub, k_all))
        aties, aerr, atol = _bc_check_19("phase 19 (c), all_knn_query", ad,
                                         ai, Xa, Xa, k_all)
        log(f"phase 19 (c): all_knn_query {rows} x 3, k={k_all}: {a_s:.3f} "
            f"s; {BC_CHECK_19} rows against float64 within {aerr:.3e} (tol "
            f"{atol:.3e}), {aties} slots at near-ties [{card}]")
        out["all_s"] = a_s
        del sub, X, Q

        H = torch.as_tensor(_lat_lon_19(rng, BC_ROWS_19), device=dev)
        Qh = torch.as_tensor(_lat_lon_19(rng, BC_QUERIES_19), device=dev)
        hindex, hb_s = _timed(lambda: bc.build_index(
            H, DistanceType.Haversine, seed=SEED))
        (hd, hi), hq_s = _timed(lambda: bc.knn_query(hindex, Qh, BC_K_19))
        hties, herr, _ = _bc_check_19("phase 19 (c), haversine knn_query",
                                      hd, hi, H, Qh, BC_K_19, haversine=True,
                                      tol=HAV_TOL_19)
        log(f"phase 19 (c): ball cover Haversine on {BC_ROWS_19} (lat, lon) "
            f"rows: build {hb_s:.3f} s (cap {hindex.groups.shape[1]}), "
            f"knn_query {BC_QUERIES_19} x k={BC_K_19} {hq_s:.3f} s; "
            f"{BC_CHECK_19} queries against float64: distances within "
            f"{herr:.3e} (tol {HAV_TOL_19}), {hties} slots at near-ties "
            f"[{card}]")
        out.update(hav_build_s=hb_s, hav_query_s=hq_s)
    finally:
        bc._scan_probed = scan
    log(f"phase 19 (c): the largest widening gather {big['bytes']} bytes "
        f"(the scan budget {bc._QUERY_BYTES}) [{card}]")
    out["gather_bytes"] = big["bytes"]
    return out


def _ari_19(a, b) -> float:
    from raft_tpu_torch.stats import adjusted_rand_index

    return float(adjusted_rand_index(a, b))


def linkage_19(dev, card) -> dict:
    """Phase 19 (d): single linkage. KNN_GRAPH on 200,000 x 32 rows in 16
    blobs whose centers lie further apart than four blob radii (checked),
    so the 15 heaviest MST edges join blobs: labels = blobs (ARI 1), the
    dendrogram's heights = the sorted weights of the MST it built, whose
    weight is within 1e-5 of scipy's ``minimum_spanning_tree`` of the same
    edges (min-reduced per pair). PAIRWISE on 4096 x 32 Gaussian rows:
    heights within 1e-5 relative of scipy's single linkage."""
    import importlib as _il

    import scipy.sparse as sp
    import torch
    from scipy.cluster.hierarchy import linkage
    from scipy.sparse.csgraph import minimum_spanning_tree

    from raft_tpu_torch.cluster import LinkageDistance, single_linkage
    from raft_tpu_torch.random import make_blobs

    solver = _il.import_module("raft_tpu_torch.sparse.solver")
    rows, dim, blobs, c = SL_KNN_19
    X, y = make_blobs(rows, dim, blobs, cluster_std=1.0,
                      center_box_min=-SL_BOX_19, center_box_max=SL_BOX_19,
                      seed=SEED + 194, device=dev)
    yl = y.long()
    means = torch.zeros((blobs, dim), device=dev).index_add_(0, yl, X) \
        / torch.bincount(yl, minlength=blobs)[:, None]
    radius = float(torch.max(torch.linalg.vector_norm(X - means[yl], dim=1)))
    gap = float(torch.pdist(means).min())
    if gap <= 4.0 * radius:
        raise AssertionError(f"phase 19 (d): blob centers {gap} apart, not "
                             f"past four radii ({radius})")
    kept = {}
    real = solver.mst

    def capturing(r, cc, w, n_vertices):
        kept["edges"] = (r, cc, w)
        kept["tree"] = real(r, cc, w, n_vertices)
        return kept["tree"]

    solver.mst = capturing
    try:
        out, k_s = _timed(lambda: single_linkage(
            X, blobs, dist_type=LinkageDistance.KNN_GRAPH, c=c))
    finally:
        solver.mst = real
    ari = _ari_19(y, out.labels)
    tree = kept["tree"]
    tw = tree.weights.double().cpu().numpy()
    if not (tree.n_edges == rows - 1 and np.array_equal(
            np.sort(out.distances), np.sort(tw))):
        raise AssertionError("phase 19 (d): the dendrogram's heights are not "
                             "its MST's sorted weights")
    r, cc, w = (t.cpu().numpy() for t in kept["edges"])
    lo, hi = np.minimum(r, cc).astype(np.int64), np.maximum(r, cc)
    order = np.lexsort((w, hi, lo))
    key = lo[order] * rows + hi[order]
    first = np.ones(key.shape[0], bool)
    first[1:] = key[1:] != key[:-1]
    sel = order[first]
    g = sp.csr_matrix((w[sel].astype(np.float64), (lo[sel], hi[sel])),
                      shape=(rows, rows))
    want = float(minimum_spanning_tree(g).sum())
    got = float(tw.sum())
    log(f"phase 19 (d): single_linkage KNN_GRAPH {rows} x {dim}, {blobs} "
        f"blobs (centers {gap:.1f} apart, radius {radius:.1f}), c={c}: "
        f"{k_s:.3f} s; ARI {ari:.6f}; {len(w)} edges, MST weight {got:.6f} "
        f"against scipy's {want:.6f}; heights = the MST's weights [{card}]")
    if ari != 1.0 or abs(got - want) > SL_RTOL_19 * abs(want):
        raise AssertionError("phase 19 (d): the KNN_GRAPH linkage is off")

    n_p, d_p = SL_PAIR_19
    P = np.random.default_rng(SEED + 195).standard_normal(
        (n_p, d_p), dtype=np.float32)
    pout, p_s = _timed(lambda: single_linkage(
        torch.as_tensor(P, device=dev), 1,
        dist_type=LinkageDistance.PAIRWISE))
    ref = linkage(P.astype(np.float64), method="single", metric="euclidean")
    rel = float(np.max(np.abs(np.sort(pout.distances) - np.sort(ref[:, 2]))
                       / np.sort(ref[:, 2])))
    log(f"phase 19 (d): single_linkage PAIRWISE {n_p} x {d_p}: {p_s:.3f} s; "
        f"heights within {rel:.3e} relative of scipy's (bar {SL_RTOL_19}) "
        f"[{card}]")
    if rel > SL_RTOL_19:
        raise AssertionError("phase 19 (d): PAIRWISE heights off scipy's")
    return {"knn_s": k_s, "pairwise_s": p_s}


def _spectral_graph_19(dev):
    """SPEC_19's blobs, their symmetrised kNN graph with unit weights and
    SPEC_BRIDGES_19 seeded unit edges between consecutive blobs: a CSR
    and the blob labels."""
    import torch

    from raft_tpu_torch.random import make_blobs
    from raft_tpu_torch.sparse import convert, linalg as sl
    from raft_tpu_torch.sparse import neighbors as sn
    from raft_tpu_torch.sparse.types import COO

    rows, dim, blobs, k = SPEC_19
    X, y = make_blobs(rows, dim, blobs, cluster_std=1.0,
                      center_box_min=-100.0, center_box_max=100.0,
                      seed=SEED + 196, device=dev)
    g = sn.knn_graph(X, k)
    yh = y.cpu().numpy()
    rng = np.random.default_rng(SEED + 197)
    br = [rng.choice(np.where(yh == b)[0], SPEC_BRIDGES_19)
          for b in range(blobs - 1)]
    bc = [rng.choice(np.where(yh == b + 1)[0], SPEC_BRIDGES_19)
          for b in range(blobs - 1)]
    br = torch.as_tensor(np.concatenate(br).astype(np.int32), device=dev)
    bc = torch.as_tensor(np.concatenate(bc).astype(np.int32), device=dev)
    coo = COO(torch.cat([g.rows, br]), torch.cat([g.cols, bc]),
              torch.ones(g.nnz + br.numel(), device=dev), (rows, rows))
    return convert.coo_to_csr(sl.symmetrize(coo)), y


def _host_sparse_19(a):
    import scipy.sparse as sp

    return sp.csr_matrix((a.vals.double().cpu().numpy(),
                          a.indices.cpu().numpy(), a.indptr.cpu().numpy()),
                         shape=a.shape)


def spectral_19(dev, card) -> dict:
    """Phase 19 (e): ``partition`` of 8 bridged blobs (SPEC_19; its 8
    smallest Laplacian eigenvalues distinct and below half the 9th,
    checked in float64): ARI >= 0.999, every Ritz pair's float64
    residual within 1e-3 ||L||, ``analyze_partition`` against a float64
    count; ``modularity_maximization`` of a 4096-vertex planted partition
    with 8 blocks: ARI >= 0.999, ``analyze_modularity`` within 1e-5 of
    float64."""
    import torch

    from raft_tpu_torch.sparse.types import csr_from_dense
    from raft_tpu_torch.spectral import (analyze_modularity,
                                         analyze_partition,
                                         modularity_maximization, partition)

    A, y = _spectral_graph_19(dev)
    rows, _, blobs, _ = SPEC_19
    Ah = _host_sparse_19(A)
    Lh = np.diag(np.asarray(Ah.sum(1)).ravel()) - Ah.toarray()
    lam = np.linalg.eigvalsh(Lh)
    norm_l = float(lam[-1])
    if not (np.all(np.diff(lam[:blobs]) > 1e-3 * norm_l)
            and lam[blobs - 1] < 0.5 * lam[blobs]):
        raise AssertionError(f"phase 19 (e): the graph's spectrum is not as "
                             f"built: {lam[:blobs + 1]}")
    (labels, w, U), p_s = _timed(lambda: partition(A, blobs))
    ari = _ari_19(y, labels)
    Ud, wd = U.double().cpu().numpy(), w.double().cpu().numpy()
    resid = max(float(np.linalg.norm(Lh @ Ud[:, j] - wd[j] * Ud[:, j]))
                for j in range(blobs)) / norm_l
    lab = labels.cpu().numpy()
    cut, cost = analyze_partition(A, labels, blobs)
    coo = Ah.tocoo()
    cross = lab[coo.row] != lab[coo.col]
    cut64 = float(coo.data[cross].sum()) / 2.0
    cost64 = sum(float(coo.data[cross & (lab[coo.row] == cl)].sum())
                 / max(int((lab == cl).sum()), 1) for cl in range(blobs))
    log(f"phase 19 (e): partition of {rows} vertices ({A.nnz} entries, "
        f"{blobs} blobs bridged by {SPEC_BRIDGES_19} edges each): {p_s:.3f} "
        f"s; ARI {ari:.6f}; eigenvalues {np.round(wd, 5).tolist()} (float64 "
        f"{np.round(lam[:blobs], 5).tolist()}, the 9th {lam[blobs]:.4f}); "
        f"residuals within {resid:.3e} ||L|| (bar {SPEC_RESID_19}); edge cut "
        f"{cut:.4f} / float64 {cut64:.4f}, cost {cost:.6f} / {cost64:.6f} "
        f"[{card}]")
    if (ari < ARI_19 or resid > SPEC_RESID_19
            or abs(cut - cut64) > 1e-5 * max(cut64, 1.0)
            or abs(cost - cost64) > 1e-5 * max(cost64, 1.0)):
        raise AssertionError("phase 19 (e): partition is off its bars")

    n_m, blocks, p_in, p_out = MOD_19
    rng = np.random.default_rng(SEED + 198)
    truth = np.repeat(np.arange(blocks), n_m // blocks)
    same = truth[:, None] == truth[None, :]
    dense = np.triu(rng.random((n_m, n_m)) < np.where(same, p_in, p_out), 1)
    dense = (dense | dense.T).astype(np.float32)
    M = csr_from_dense(torch.as_tensor(dense, device=dev))
    (mlab, mw, _), m_s = _timed(lambda: modularity_maximization(M, blocks))
    mari = _ari_19(torch.as_tensor(truth, device=dev), mlab)
    q = analyze_modularity(M, mlab)
    ml = mlab.cpu().numpy()
    d64 = dense.astype(np.float64)
    deg = d64.sum(1)
    two_m = deg.sum()
    q64 = sum(float(d64[np.ix_(ml == c, ml == c)].sum()) / two_m
              - (float(deg[ml == c].sum()) / two_m) ** 2
              for c in np.unique(ml))
    log(f"phase 19 (e): modularity_maximization of a {n_m}-vertex planted "
        f"partition ({blocks} blocks, p_in {p_in}, p_out {p_out}): {m_s:.3f} "
        f"s; ARI {mari:.6f}; modularity {q:.6f} (float64 {q64:.6f}); "
        f"eigenvalues {np.round(mw.cpu().numpy(), 3).tolist()} [{card}]")
    if mari < ARI_19 or abs(q - q64) > 1e-5:
        raise AssertionError("phase 19 (e): modularity_maximization is off "
                             "its bars")
    return {"partition_s": p_s, "modularity_s": m_s}


def spatial_19(dev, X, Q, bf, card) -> None:
    """Phase 19 (f): every ``spatial.knn`` alias is the port's own object,
    and its ``brute_force_knn`` of 1000 queries (B1) equals phase 4's
    answer but for the order of exact ties."""
    from raft_tpu_torch import neighbors, spatial
    from raft_tpu_torch.neighbors import ball_cover, brute_force
    from raft_tpu_torch.neighbors import epsilon_neighborhood as en

    sk = spatial.knn
    pairs = [(sk.brute_force_knn, brute_force.knn),
             (sk.knn_merge_parts, brute_force.knn_merge_parts),
             (sk.fused_l2_knn, brute_force.fused_l2_knn),
             (sk.rbc_build_index, ball_cover.build_index),
             (sk.rbc_knn_query, ball_cover.knn_query),
             (sk.rbc_all_knn_query, ball_cover.all_knn_query),
             (sk.rbc_eps_nn, ball_cover.eps_nn),
             (sk.BallCoverIndex, ball_cover.BallCoverIndex),
             (sk.epsUnexpL2SqNeighborhood, en.eps_neighbors_l2sq),
             (sk.ivf_flat, neighbors.ivf_flat), (sk.ivf_pq, neighbors.ivf_pq)]
    if not all(a is b for a, b in pairs) or set(sk.__all__) != {
            "BallCoverIndex", "rbc_all_knn_query", "rbc_build_index",
            "rbc_eps_nn", "rbc_knn_query", "fused_l2_knn", "brute_force_knn",
            "knn_merge_parts", "epsUnexpL2SqNeighborhood", "ivf_flat",
            "ivf_pq"}:
        raise AssertionError("phase 19 (f): a spatial.knn alias is not the "
                             "port's object")
    (d, i), secs = _timed(lambda: sk.brute_force_knn(X, Q[:1000], k=K))
    rows = same_up_to_exact_ties("phase 19 (f), spatial.knn.brute_force_knn",
                                 d, i, bf[0][:1000], bf[1][:1000])
    log(f"phase 19 (f): {len(pairs)} spatial.knn aliases are the port's "
        f"objects; brute_force_knn of 1000 queries {secs:.3f} s = phase 4's "
        f"answer ({rows} rows differ only in the order of exact ties) "
        f"[{card}]")


def slice19_phase(dev, X, Q, bf, card) -> dict:
    """Phase 19: solver/, the epsilon neighborhood, ball cover, single
    linkage, spectral/ and spatial.knn, counters set to 0 before it and
    read after its last step. B1 must launch in (d) and (e) (the kNN
    graph, Lloyd), B5 in (c)'s far queries; no other kernel. Returns its
    launches, seconds, peak device memory and step figures."""
    import torch

    _zero_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    a = lap_19(dev, card)
    b = eps_19(dev, card)
    torch.cuda.empty_cache()
    c = ball_cover_19(dev, card)
    torch.cuda.empty_cache()
    before = _launches()
    d = linkage_19(dev, card)
    d_launches = _step(before)
    before = _launches()
    e = spectral_19(dev, card)
    e_launches = _step(before)
    spatial_19(dev, X, Q, bf, card)
    launches = _launches()
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase 19: {total:.3f} s (a {sum(a.values()):.3f}, b {b:.3f}, c "
        f"{sum(v for k, v in c.items() if k.endswith('_s')):.3f}, d "
        f"{sum(d.values()):.3f}, e {sum(e.values()):.3f}), peak device "
        f"memory {peak:.2f} GiB, launches {launches} ((d) {d_launches}, "
        f"(e) {e_launches}) [{card}]")
    if (d_launches["fused_knn"] < 1 or e_launches["fused_knn"] < 1
            or c["b5"] < 1 or any(v for k, v in launches.items()
                                   if k not in (*B1_COUNTERS,
                                                "stream_extract"))):
        raise AssertionError(f"phase 19 must launch B1 in (d) and (e), B5 in "
                             f"(c) and nothing else: {launches}")
    torch.cuda.empty_cache()
    return {"launches": launches, "seconds": total, "peak_gib": peak,
            "lap": a, "eps_s": b, "ball_cover": c, "linkage": d,
            "spectral": e}


# ---------------------------------------------------------------------------
# Phase 20: the pylibraft and raft_dask facades over the port


def _facade_step(what, fn, steps, secs):
    """One step of phase 20: the counters set to 0 just before it and read
    just after; its launches and seconds kept under ``what``."""
    import torch

    _zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs[what] = time.perf_counter() - t0
    steps[what] = _launches()
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def facade_neighbors_20(dev, X, Q, bf, iv, flat4, card, steps, secs):
    """Phase 20 (a)-(c) and (e): brute force, IVF-Flat and IVF-PQ through
    ``pylibraft_torch.neighbors`` on the card, and their save / load."""
    import tempfile

    import torch

    from pylibraft_torch.common import DeviceResources
    from pylibraft_torch.neighbors import brute_force, ivf_flat, ivf_pq
    from pylibraft_torch.neighbors import refine

    handle = DeviceResources()
    # (a) brute force: phase 4's ids bit for bit; numpy queries with no
    # handle land on the card.
    d, i = _facade_step("a_knn", lambda: brute_force.knn(X, Q, k=K,
                                                          handle=handle),
                        steps, secs)
    if not (torch.equal(i.array, bf[1]) and torch.equal(d.array, bf[0])):
        raise AssertionError("phase 20 (a): brute_force.knn != phase 4's "
                             "answer")
    Qh = Q[:N_NUMPY_20].cpu().numpy()
    d2, i2 = _facade_step("a_numpy", lambda: brute_force.knn(X, Qh, k=K),
                          steps, secs)
    if not (i2.array.is_cuda and d2.array.is_cuda):
        raise AssertionError("phase 20 (a): numpy queries did not land on "
                             "the card")
    rows_a = same_up_to_exact_ties("phase 20 (a), numpy queries", d2.array,
                                   i2.array, bf[0][:N_NUMPY_20],
                                   bf[1][:N_NUMPY_20])
    log(f"phase 20 (a): pylibraft_torch brute_force.knn {N_QUERIES} x "
        f"{N_ROWS} x {DIM}, k={K}: {secs['a_knn']:.3f} s, ids and distances "
        f"= phase 4's bit for bit; {N_NUMPY_20} numpy queries with no "
        f"handle on {i2.array.device} in {secs['a_numpy']:.3f} s = phase "
        f"4's ({rows_a} rows differ only in exact-tie order) [{card}]")

    # (b) IVF-Flat: build (B1), search (B2); phase 4's index wrapped.
    index = _facade_step("b_build", lambda: ivf_flat.build(
        ivf_flat.IndexParams(n_lists=N_LISTS), X, handle=handle),
        steps, secs)
    sp = ivf_flat.SearchParams(n_probes=N_PROBES)
    fd, fi = _facade_step("b_search", lambda: ivf_flat.search(
        sp, index, Q, K, handle=handle), steps, secs)
    rec_flat = recall(fi.array, bf[1])
    wrapped = ivf_flat.Index(flat4)
    wd, wi = _facade_step("b_wrapped", lambda: ivf_flat.search(
        sp, wrapped, Q, K, handle=handle), steps, secs)
    log(f"phase 20 (b): ivf_flat.build {secs['b_build']:.3f} s "
        f"({index!r}), search {secs['b_search']:.3f} s, recall@{K} "
        f"{rec_flat:.6f} (bar {RECALL_IVF}); phase 4's index as "
        f"ivf_flat.Index: {secs['b_wrapped']:.3f} s, bit for bit "
        f"{torch.equal(wd.array, iv[0]) and torch.equal(wi.array, iv[1])}"
        f" [{card}]")
    if rec_flat < RECALL_IVF:
        raise AssertionError(f"phase 20 (b): recall {rec_flat}")
    if not (torch.equal(wd.array, iv[0]) and torch.equal(wi.array, iv[1])):
        raise AssertionError("phase 20 (b): phase 4's index wrapped does not "
                             "answer as phase 4 did")

    # (c) IVF-PQ: build (B1), compressed search (B4), refine.
    pq_index = _facade_step("c_build", lambda: ivf_pq.build(
        ivf_pq.IndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM_20,
                           pq_bits=PQ_BITS_20), X, handle=handle),
        steps, secs)
    psp = ivf_pq.SearchParams(n_probes=N_PROBES)
    pd, pi = _facade_step("c_search", lambda: ivf_pq.search(
        psp, pq_index, Q, K, handle=handle), steps, secs)
    rec_pq = recall(pi.array, bf[1])
    _, cand = _facade_step("c_candidates", lambda: ivf_pq.search(
        psp, pq_index, Q, N_CAND_20, handle=handle), steps, secs)
    rd, ri = _facade_step("c_refine", lambda: refine(
        X, Q, cand, k=K, handle=handle), steps, secs)
    rec_ref = recall(ri.array, bf[1])
    log(f"phase 20 (c): ivf_pq.build {secs['c_build']:.3f} s ({pq_index!r})"
        f", compressed search {secs['c_search']:.3f} s, recall@{K} "
        f"{rec_pq:.6f} (bar {RECALL_PQ}); refine of {N_CAND_20} candidates "
        f"a query {secs['c_refine']:.3f} s, recall@{K} {rec_ref:.6f} (bar: "
        f"the search's) [{card}]")
    for name, t in (("search", pd.array), ("refine", rd.array)):
        if not bool(torch.isfinite(t).all()) or t.shape != (N_QUERIES, K):
            raise AssertionError(f"phase 20 (c): {name} distances")
    if rec_pq < RECALL_PQ or rec_ref < rec_pq:
        raise AssertionError(f"phase 20 (c): recall {rec_pq}, refined "
                             f"{rec_ref}")

    # (e) save / load through a temporary directory.
    def save_load(mod, idx, params, name, tmp):
        mod.save(f"{tmp}/{name}", idx)
        loaded = mod.load(f"{tmp}/{name}", handle=handle)
        a = mod.search(params, idx, Q, K, handle=handle)
        b = mod.search(params, loaded, Q, K, handle=handle)
        same = all(torch.equal(x.array, y.array) for x, y in zip(a, b))
        if not same or loaded.size != idx.size:
            raise AssertionError(f"phase 20 (e): the loaded {name} index "
                                 f"does not search as the saved one")
        return loaded

    with tempfile.TemporaryDirectory() as tmp:
        _facade_step("e_flat", lambda: save_load(ivf_flat, index, sp,
                                                 "ivf_flat", tmp), steps,
                     secs)
        _facade_step("e_pq", lambda: save_load(ivf_pq, pq_index, psp,
                                               "ivf_pq", tmp), steps, secs)
    log(f"phase 20 (e): save / load / search of both: IVF-Flat "
        f"{secs['e_flat']:.3f} s, IVF-PQ {secs['e_pq']:.3f} s; the loaded "
        f"indexes search bit for bit as the saved ones [{card}]")


def facade_kmeans_20(dev, card, steps, secs):
    """Phase 20 (d): k-means, the fused arg-min, the cluster cost,
    pairwise distances and R-MAT through ``pylibraft_torch``."""
    import torch

    from pylibraft_torch.cluster import kmeans
    from pylibraft_torch.common import DeviceResources, device_ndarray
    from pylibraft_torch.distance import (DISTANCE_TYPES,
                                          fused_l2_nn_argmin,
                                          pairwise_distance)
    from pylibraft_torch.random import rmat
    from raft_tpu_torch import random as rnd
    from raft_tpu_torch.cluster import InitMethod as PortInit
    from raft_tpu_torch.cluster import KMeansParams as PortParams
    from raft_tpu_torch.cluster import kmeans as port_kmeans
    from raft_tpu_torch.random import RngState

    handle = DeviceResources()
    centers = rnd.uniform(RngState(SEED + 200), (N_CLUSTERS_17, DIM), -10.0,
                          10.0, device=dev)
    Xb, truth = rnd.make_blobs(N_ROWS, DIM, centers=centers,
                               cluster_std=BLOB_STD_17, seed=SEED + 20,
                               device=dev)
    params = kmeans.KMeansParams(n_clusters=N_CLUSTERS_17,
                                 init=kmeans.InitMethod.Array,
                                 max_iter=MAX_ITER_17)
    C, inertia, it = _facade_step("d_fit", lambda: kmeans.fit(
        params, Xb, centroids=centers, handle=handle), steps, secs)
    Cp, inertia_p, it_p = port_kmeans.fit(
        PortParams(n_clusters=N_CLUSTERS_17, init=PortInit.Array,
                   max_iter=MAX_ITER_17), Xb, centroids_init=centers)
    labels = _facade_step("d_argmin", lambda: fused_l2_nn_argmin(
        Xb, C, handle=handle), steps, secs).array
    labels_p = fused_l2_nn_argmin(Xb, Cp, handle=handle).array
    cost = _facade_step("d_cost", lambda: kmeans.cluster_cost(
        Xb, C, handle=handle), steps, secs)
    C64 = C.array.double()
    ref = 0.0
    for s in range(0, N_ROWS, 100_000):
        ref += float(torch.sum((Xb[s:s + 100_000].double()
                                - C64[labels[s:s + 100_000].long()]) ** 2))
    ari = _ari_19(truth, labels)
    ari_p = _ari_19(labels_p, labels)
    errs = {"inertia": abs(inertia - ref) / ref,
            "cluster_cost": abs(cost - ref) / ref,
            "port inertia": abs(inertia - float(inertia_p)) / ref}
    # The arg-min against float64 on N_CHECK_20 rows: a row may differ only
    # at a near-tie (its f32 pick within norm_tol of the best in float64).
    xs = Xb[:N_CHECK_20]
    d64 = torch.cdist(xs.double(), C64) ** 2
    best = torch.argmin(d64, dim=1)
    gap = d64.gather(1, labels[:N_CHECK_20].long()[:, None])[:, 0] \
        - d64.gather(1, best[:, None])[:, 0]
    tol = norm_tol(xs, C.array)
    n_diff = int((best != labels[:N_CHECK_20].long()).sum())
    log(f"phase 20 (d): kmeans.fit {N_ROWS} x {DIM} x {N_CLUSTERS_17} from "
        f"InitMethod.Array {secs['d_fit']:.3f} s, {it} iterations (port "
        f"fit {it_p}); ARI against the blobs {ari:.6f}, against the port's "
        f"fit {ari_p:.6f} (bar {ARI_17}); inertia, cluster_cost and the "
        f"port's inertia off float64 by "
        + ", ".join(f"{v:.3e}" for v in errs.values())
        + f" (bar {INERTIA_RTOL_17}); fused_l2_nn_argmin "
        f"{secs['d_argmin']:.3f} s: {n_diff} of {N_CHECK_20} rows off the "
        f"float64 arg-min, largest gap {float(gap.max()):.3e} (tol "
        f"{tol:.3e}) [{card}]")
    if (min(ari, ari_p) < ARI_17 or max(errs.values()) > INERTIA_RTOL_17
            or float(gap.max()) > tol):
        raise AssertionError("phase 20 (d): k-means off its bars")
    del Xb, truth, d64

    rng = np.random.default_rng(SEED + 20)
    gx = rng.standard_normal((N_PAIRWISE_20, DIM)).astype(np.float32)
    gy = rng.standard_normal((N_PAIRWISE_20, DIM)).astype(np.float32)
    worst = {}
    for metric in PAIRWISE_20:
        got = _facade_step(f"d_pairwise_{metric}", lambda: pairwise_distance(
            gx, gy, metric=metric, handle=handle), steps, secs)
        if not got.array.is_cuda:
            raise AssertionError("phase 20 (d): numpy operands did not land "
                                 "on the card")
        want = _np_f64(gx, gy, DISTANCE_TYPES[metric], 2.0)
        host = got.copy_to_host()
        scale = max(1.0, float(np.max(np.abs(want))))
        worst[metric] = float(np.max(np.abs(host - want))) / scale
        if not np.isfinite(host).all() or worst[metric] > METRIC_RTOL:
            raise AssertionError(f"phase 20 (d): pairwise {metric} off "
                                 f"float64 by {worst[metric]:.3e}")
    log(f"phase 20 (d): pairwise_distance {N_PAIRWISE_20} x {N_PAIRWISE_20} "
        f"from numpy, relative error against float64 "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (bar {METRIC_RTOL}) [{card}]")

    out = device_ndarray.empty((RMAT_EDGES_20, 2), dtype=np.int32)
    theta = np.asarray(RMAT_THETA_17, np.float32)
    edges = _facade_step("d_rmat", lambda: rmat(
        out, theta, RMAT_SCALE_20, RMAT_SCALE_20, seed=SEED + 20,
        handle=handle), steps, secs)
    e = edges.array
    th = theta / theta.sum()
    se = np.sqrt(th * (1 - th) / RMAT_EDGES_20)
    s64, d64 = e[:, 0].long(), e[:, 1].long()
    worst_z = 0.0
    for lvl in range(RMAT_SCALE_20):
        sh = RMAT_SCALE_20 - 1 - lvl
        quad = (((s64 >> sh) & 1) << 1) | ((d64 >> sh) & 1)
        f = torch.bincount(quad, minlength=4).double().cpu().numpy()
        worst_z = max(worst_z, float(np.max(np.abs(f / RMAT_EDGES_20 - th)
                                                / se)))
    in_range = bool(e.min() >= 0) and bool(e.max() < 1 << RMAT_SCALE_20)
    log(f"phase 20 (d): rmat {RMAT_EDGES_20} edges at 2^{RMAT_SCALE_20} x "
        f"2^{RMAT_SCALE_20} into a device_ndarray on {e.device} in "
        f"{secs['d_rmat']:.3f} s: ids in range {in_range}, max |z| of the "
        f"levels' quadrant shares {worst_z:.2f} (bar {SE_17}) [{card}]")
    if edges is not out or not e.is_cuda or not in_range or worst_z > SE_17:
        raise AssertionError("phase 20 (d): rmat off its law")


def facade_session_20(card, secs) -> None:
    """Phase 20 (f), in this process: a ``raft_dask_torch.Comms`` session
    that starts a NCCL world of one from its coordinator address; the
    seven self-tests must pass, and ``destroy`` ends the world."""
    import torch.distributed as dist

    import raft_dask_torch.common as rdt

    t0 = time.perf_counter()
    with rdt.Comms(coordinator_address=f"localhost:{_free_port()}",
                   num_processes=1, process_id=0) as c:
        handle = rdt.local_handle(c.sessionId)
        backend = handle.get_comms().mesh.backend
        got = {name: getattr(rdt, name)(handle)
               for name in DASK_SELF_TESTS_20}
    secs["f_session"] = time.perf_counter() - t0
    log(f"phase 20 (f): raft_dask_torch session over a {backend} world of "
        f"one: {sum(got.values())} of {len(got)} self-tests True, ended "
        f"{not dist.is_initialized()}, {secs['f_session']:.3f} s [{card}]")
    if backend != "nccl" or not all(got.values()) or dist.is_initialized():
        raise AssertionError(f"phase 20 (f): world of one {backend} {got}")


def facade_phase(dev, X, Q, bf, iv, flat4, card) -> dict:
    """Phase 20 (a)-(e) and (f)'s world of one: the facades on the card.
    Returns its launches, seconds and peak device memory; (f)'s four
    ranks run in the spawned world (:func:`_rank_work_dask`)."""
    import torch

    steps, secs = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    facade_neighbors_20(dev, X, Q, bf, iv, flat4, card, steps, secs)
    torch.cuda.empty_cache()
    facade_kmeans_20(dev, card, steps, secs)
    torch.cuda.empty_cache()
    facade_session_20(card, secs)
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: sum(st[k] for st in steps.values())
                for k in next(iter(steps.values()))}
    need = {"a_knn": "fused_knn", "b_build": "fused_knn",
            "b_search": "fused_cells_knn", "c_build": "fused_knn",
            "c_search": "pq_fused_scan", "d_fit": "fused_knn",
            "d_argmin": "fused_knn"}
    missing = [f"{st}: {k}" for st, k in need.items() if steps[st][k] < 1]
    if missing or launches["fused_batch_knn"] or launches["stream_extract"]:
        raise AssertionError(f"phase 20: B1 / B2 / B4 must launch where the "
                             f"path runs them and nothing else ({missing}; "
                             f"{launches})")
    per_step = []
    for k, v in secs.items():
        fired = {n: c for n, c in steps.get(k, {}).items() if c}
        per_step.append(f"{k} {v:.3f} s {fired}" if fired
                        else f"{k} {v:.3f} s")
    log(f"phase 20, this process: {total:.3f} s, peak device memory "
        f"{peak:.2f} GiB, launches {launches}; per step: "
        + ", ".join(per_step) + f" [{card}]")
    return {"launches": launches, "seconds": total, "peak_gib": peak}


def _rank_work_dask(rank, data_dir, cfg):
    """Phase 20 (f) on one of the 4 gloo ranks: a ``raft_dask_torch``
    session over the world and its seven self-tests."""
    import raft_dask_torch.common as rdt

    t0 = time.perf_counter()
    with rdt.Comms(device=cfg["device"]) as c:
        handle = rdt.local_handle(c.sessionId)
        got = {name: getattr(rdt, name)(handle)
               for name in DASK_SELF_TESTS_20}
        info = c.worker_info()
    return {"self_tests": got, "workers": sorted(info),
            "wall_s": time.perf_counter() - t0}


def dask_ranks_20(got, card) -> float:
    """Phase 20 (f), the 4 ranks' side: every rank ran the seven
    self-tests True in a session of 4 workers. Returns the slowest rank's
    seconds."""
    bad = {r: res["p20"] for r, res in got.items()
           if not all(res["p20"]["self_tests"].values())
           or res["p20"]["workers"] != list(range(N_RANKS))}
    wall = max(res["p20"]["wall_s"] for res in got.values())
    log(f"phase 20 (f), 4 gloo ranks on the card: raft_dask_torch session of "
        f"{N_RANKS} workers, the {len(DASK_SELF_TESTS_20)} self-tests True "
        f"on every rank {not bad}, {wall:.3f} s (the slowest rank) [{card}]")
    if bad:
        raise AssertionError(f"phase 20 (f): ranks {bad}")
    return wall


# ---------------------------------------------------------------------------
# Phase 21: the reference bench's configurations the port had not run on
# the card


def sift_rows_21():
    """bench.py's SIFT-shaped u8 recipe (``_family_sift1m_u8``, seed 11):
    rows around 1000 centers uniform in [20, 200] with sigma 18, queries
    around random rows with sigma 6, both clipped to u8 on the host."""
    n, d, n_centers, n_q = SIFT_21
    rng = np.random.default_rng(SIFT_SEED_21)
    centers = rng.uniform(20.0, 200.0, size=(n_centers, d))
    assign = rng.integers(0, n_centers, size=n)
    db = np.clip(centers[assign] + rng.normal(scale=18.0, size=(n, d)),
                 0, 255).astype(np.uint8)
    qsel = rng.integers(0, n, size=n_q)
    q = np.clip(db[qsel].astype(np.float64)
                + rng.normal(scale=6.0, size=(n_q, d)), 0, 255
                ).astype(np.uint8)
    return db, q


def _part_21(what, fn, parts, card):
    """One part of phase 21: ``fn()``, its seconds by the host clock
    around a synchronise, its launches and the peak device memory while
    it ran, kept under ``what`` and printed with the card line."""
    import torch

    before = _launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    fired = _step(before)
    peak = torch.cuda.max_memory_allocated() / 2**30
    parts[what] = {"seconds": secs, "launches": fired, "peak_gib": peak}
    log(f"phase 21 ({what}): {secs:.3f} s, launches "
        f"{ {k: v for k, v in fired.items() if v} }, peak device memory "
        f"{peak:.2f} GiB [{card}]")
    return out


def _need_21(parts, what, fire=(), quiet=()):
    """Fails unless each kernel of ``fire`` launched in part ``what`` and
    none of ``quiet`` did."""
    got = parts[what]["launches"]
    if any(got[k] < 1 for k in fire) or any(got[k] for k in quiet):
        raise AssertionError(f"phase 21 ({what}): {list(fire)} must launch "
                             f"and {list(quiet)} must not: {got}")


def device_split_ms(fn, part: str, reps: int = 3):
    """Per call of ``fn``, from the self device times of one
    ``torch.profiler`` trace of ``reps`` calls: the milliseconds of the
    kernels whose name holds ``part`` (None when none ran), of every
    kernel (None when the trace holds no device time), and the names of
    the three longest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    part_us = sum(e.self_device_time_total for e in evs if part in e.key)
    all_us = sum(e.self_device_time_total for e in evs)
    return (part_us / reps / 1e3 if part_us > 0 else None,
            all_us / reps / 1e3 if all_us > 0 else None,
            [e.key[:60] for e in evs[:3]])


def int8_search_21(flat, Qs, sp, card) -> None:
    """Phase 21 (a)'s first card run of signed int8 storage: the u8
    index's rows shifted by -128 into an int8 store (centers and queries
    shifted alike), searched as the u8 one. L2 is shift-invariant, so
    where both frames probe the same lists the ids must equal the u8
    answer except at near-ties within ``norm_tol`` (near_tie_check);
    queries whose probed lists differ (a coarse near-tie at the 32nd
    probe) are counted and left out."""
    import torch

    from raft_tpu_torch.neighbors import ivf_flat

    flat8 = dataclasses.replace(
        flat, data=(flat.data.to(torch.int16) - 128).to(torch.int8),
        centers=flat.centers - 128.0)
    Q8 = Qs - 128.0
    with _Capture("ivf_flat") as cap:
        d8, i8 = ivf_flat.search(sp, flat8, Q8, K)
    args = cap.calls[K][0]
    if (args[2].dtype, args[6], args[7]) != (torch.int8, True, True):
        raise AssertionError(f"phase 21 (a) int8: B2 ran store "
                             f"{args[2].dtype}, bf16 {args[6]}, qsplit "
                             f"{args[7]}")
    du, iu = ivf_flat.search(sp, flat, Qs, K)
    pu = torch.sort(ivf_flat._coarse_probe(Qs, flat.centers, N_PROBES,
                                           True), dim=1)[0]
    p8 = torch.sort(ivf_flat._coarse_probe(Q8, flat8.centers, N_PROBES,
                                           True), dim=1)[0]
    same = (pu == p8).all(dim=1)
    X = torch.zeros((int(flat.indices.max()) + 1, flat.dim),
                    device=Qs.device)
    valid = flat.indices >= 0
    X[flat.indices[valid].long()] = flat.data[valid].float()
    tol = norm_tol(Qs, X)
    diff = near_tie_check("phase 21 (a) int8 vs u8", d8[same], i8[same],
                          du[same], iu[same], X, Qs[same], tol)
    ms = time_ms(lambda: ivf_flat.search(sp, flat8, Q8, K), reps=5)
    log(f"phase 21 (a) IVF-Flat on int8 (the u8 rows - 128): search "
        f"{ms:.3f} ms per {Qs.shape[0]} queries; B2 took the int8 rows on "
        f"the split tier; on the {int(same.sum())} queries whose probes "
        f"match the u8 frame's, ids equal the u8 answer but at "
        f"{diff} near-tie slots (tol {tol:.3e}); "
        f"{int((~same).sum())} queries probe other lists [{card}]")


def sift_u8_21(dev, card, parts) -> dict:
    """Phase 21 (a): SIFT-shaped u8 rows through the native bvecs IO, B1's
    exact answer, u8-storage IVF-Flat (B2's bf16 + split-query tier) and
    IVF-PQ (B4), and the ``min_recall=0.95`` recipe over the u8 source
    (bench.py:452-533)."""
    import os
    import shutil
    import tempfile

    import torch

    from raft_tpu_torch import _native
    from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq

    def data():
        db, q = sift_rows_21()
        with tempfile.TemporaryDirectory() as tmp:
            need = 2 * (db.nbytes + q.nbytes)
            free = shutil.disk_usage(tmp).free
            if free < need:
                raise AssertionError(f"phase 21 (a): {free} bytes free under "
                                     f"{tmp}, {need} needed")
            paths = [os.path.join(tmp, f) for f in ("base.bvecs",
                                                   "query.bvecs")]
            t0 = time.perf_counter()
            for path, rows in zip(paths, (db, q)):
                _native.write_bvecs(path, rows)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = [_native.read_bvecs(path) for path in paths]
            read_s = time.perf_counter() - t0
            nbytes = os.path.getsize(paths[0])
        if not all(b.dtype == np.uint8 and np.array_equal(b, r)
                   for b, r in zip(back, (db, q))):
            raise AssertionError("phase 21 (a): the bvecs read-back differs "
                                 "from the written rows")
        log(f"phase 21 (a): {db.shape[0]} x {db.shape[1]} u8 rows and "
            f"{q.shape[0]} queries through write_bvecs / read_bvecs "
            f"({nbytes} bytes; write {write_s:.3f} s, read {read_s:.3f} s), "
            f"read back byte for byte")
        return back

    db, q = _part_21("a_data", data, parts, card)
    X = torch.as_tensor(db, device=dev)
    Qs = torch.as_tensor(q, device=dev).float()
    del db, q
    _, truth = _part_21("a_truth",
                        lambda: brute_force.knn(X.float(), Qs, K),
                        parts, card)
    _need_21(parts, "a_truth", ("fused_knn",))

    flat = _part_21("a_flat_build", lambda: ivf_flat.build(
        ivf_flat.IndexParams(n_lists=N_LISTS), X), parts, card)
    _need_21(parts, "a_flat_build", ("fused_knn",))
    if flat.data.dtype != torch.uint8:
        raise AssertionError(f"phase 21 (a): IVF-Flat stores "
                             f"{flat.data.dtype}, not uint8")
    sp = ivf_flat.SearchParams(n_probes=N_PROBES, engine="bucketed")
    with _Capture("ivf_flat") as cap:
        _, fi = _part_21("a_flat_search",
                         lambda: ivf_flat.search(sp, flat, Qs, K),
                         parts, card)
    _need_21(parts, "a_flat_search", ("fused_cells_knn",
                                      "fused_cells_knn_mma"))
    # B2 reads the index's own u8 rows on the split tier: no bf16 copy of
    # the lists is made.
    args = cap.calls[K][0]
    if (args[2].dtype, args[6], args[7]) != (torch.uint8, True, True) \
            or args[2].data_ptr() != flat.data.data_ptr():
        raise AssertionError(f"phase 21 (a): B2 ran store {args[2].dtype}, "
                             f"bf16 {args[6]}, qsplit {args[7]}, not the "
                             f"index's own uint8 rows on the bf16 + "
                             f"split-query tier")
    rec_f = recall(fi, truth)
    flat_ms = time_ms(lambda: ivf_flat.search(sp, flat, Qs, K), reps=5)
    copy_ms, search_dev, top = device_split_ms(
        lambda: ivf_flat.search(sp, flat, Qs, K), "copy_kernel")
    scan_ms, _, _ = device_split_ms(
        lambda: ivf_flat.search(sp, flat, Qs, K), "b2_mma_kernel")
    share = (f"{copy_ms / search_dev:.1%}" if copy_ms and search_dev
             else "none")
    log(f"phase 21 (a) IVF-Flat on u8: recall@{K} {rec_f:.6f} (bar "
        f"{RECALL_U8_FLAT_21}; v5e record 1.000), search {flat_ms:.3f} ms "
        f"per {Qs.shape[0]} queries; B2 took the index's own uint8 rows "
        f"(no cast of the lists); of its {search_dev} ms of device time "
        f"{scan_ms} ms in B2's tensor-core scan, {copy_ms} ms in copy "
        f"kernels ({share}; torch.profiler; longest kernels {top}) "
        f"[{card}]")
    if rec_f < RECALL_U8_FLAT_21:
        raise AssertionError(f"phase 21 (a): IVF-Flat u8 recall {rec_f}")
    int8_search_21(flat, Qs, sp, card)
    del flat

    index = _part_21("a_pq_build", lambda: ivf_pq.build(
        ivf_pq.IndexParams(n_lists=N_LISTS), X), parts, card)
    _need_21(parts, "a_pq_build", ("fused_knn",))
    if index._source is not X:
        raise AssertionError("phase 21 (a): IVF-PQ does not retain its u8 "
                             "rows")
    sp = ivf_pq.SearchParams(n_probes=N_PROBES, engine="bucketed",
                             bucket_cap=BUCKET_CAP)
    _, pi = _part_21("a_pq_search", lambda: ivf_pq.search(sp, index, Qs, K),
                     parts, card)
    _need_21(parts, "a_pq_search", ("pq_fused_scan",))
    spr = dataclasses.replace(sp, min_recall=0.95)
    _, ri = _part_21("a_pq_refined",
                     lambda: ivf_pq.search(spr, index, Qs, K), parts, card)
    _need_21(parts, "a_pq_refined", ("pq_fused_scan",))
    rec_p, rec_r = recall(pi, truth), recall(ri, truth)
    pq_ms = time_ms(lambda: ivf_pq.search(sp, index, Qs, K), reps=5)
    refined_ms = time_ms(lambda: ivf_pq.search(spr, index, Qs, K), reps=5)
    log(f"phase 21 (a) IVF-PQ on u8: recall@{K} {rec_p:.6f} (bar "
        f"{RECALL_U8_PQ_21}; v5e record 0.839), {pq_ms:.3f} ms; "
        f"min_recall=0.95 over the u8 source {rec_r:.6f} (bar "
        f"{RECALL_U8_REFINED_21}; v5e record 0.998), {refined_ms:.3f} ms "
        f"[{card}]")
    if rec_p < RECALL_U8_PQ_21 or rec_r < RECALL_U8_REFINED_21:
        raise AssertionError(f"phase 21 (a): IVF-PQ u8 recall {rec_p}, "
                             f"refined {rec_r}")
    return {"flat": rec_f, "pq": rec_p, "refined": rec_r, "flat_ms": flat_ms,
            "pq_ms": pq_ms, "refined_ms": refined_ms, "copy_ms": copy_ms,
            "scan_ms": scan_ms, "search_device_ms": search_dev}


def uniform_21(dev, X, Q, bf, flat, pq_index, pq_recall, card,
               parts) -> dict:
    """Phase 21 (b): bench.py's uniform queries on phase 4's and phase
    6's 1M indexes (IVF-Flat, IVF-PQ native and ``min_recall=0.86``), and
    the int8 codeword tables on the main path's queries
    (bench.py:292-297, :349-380)."""
    import torch

    from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq

    rng = np.random.default_rng(SIFT_SEED_21)
    rng.normal(size=(N_UNIFORM_21, DIM))   # the bench's clustered noise
    Qu = torch.as_tensor(rng.normal(size=(N_UNIFORM_21, DIM))
                         .astype(np.float32) * 10, device=dev)
    bf_u = _part_21("b_truth", lambda: brute_force.knn(X, Qu, K), parts,
                    card)
    _need_21(parts, "b_truth", ("fused_knn",))
    truth = bf_u[1]
    fd, fi = _part_21("b_flat", lambda: ivf_flat.search(
        ivf_flat.SearchParams(n_probes=N_PROBES), flat, Qu, K), parts, card)
    _need_21(parts, "b_flat", ("fused_cells_knn",))
    sp = ivf_pq.SearchParams(n_probes=N_PROBES, engine="bucketed",
                             bucket_cap=BUCKET_CAP)
    _, pi = _part_21("b_pq_native", lambda: ivf_pq.search(
        sp, pq_index, Qu, K), parts, card)
    _need_21(parts, "b_pq_native", ("pq_fused_scan",))
    if pq_index._source is None:
        raise AssertionError("phase 21 (b): phase 6's index retains no "
                             "source")
    _, ri = _part_21("b_pq_min_recall", lambda: ivf_pq.search(
        dataclasses.replace(sp, min_recall=MIN_RECALL_UNI_21), pq_index, Qu,
        K), parts, card)
    _need_21(parts, "b_pq_min_recall", ("pq_fused_scan",))
    rec_f, rec_p, rec_r = (recall(fi, truth), recall(pi, truth),
                           recall(ri, truth))
    cover, lost = _probed_exactly_21(flat, Qu, fd, fi, bf_u, X)
    wide = ivf_flat.SearchParams(n_probes=UNI_PROBES_21)
    _, wi = _part_21("b_flat_wide", lambda: ivf_flat.search(
        wide, flat, Qu, K), parts, card)
    _need_21(parts, "b_flat_wide", ("fused_cells_knn",))
    rec_w = recall(wi, truth)
    log(f"phase 21 (b) uniform queries (N(0, 1) x 10): IVF-Flat recall@{K} "
        f"at {N_PROBES} probes {rec_f:.6f}, every exact neighbour of the "
        f"probed lists found but {lost} near-tie slots; the probed lists "
        f"hold {', '.join(f'{v:.4f} at {p}' for p, v in cover.items())} "
        f"of the exact neighbours; at {UNI_PROBES_21} probes {rec_w:.6f} "
        f"(bar {RECALL_UNI_FLAT_21}); IVF-PQ native {rec_p:.6f} (bar "
        f"{RECALL_UNI_PQ_21}; v5e record 0.791), min_recall="
        f"{MIN_RECALL_UNI_21} {rec_r:.6f} (v5e record 0.924) [{card}]")
    if (rec_w < RECALL_UNI_FLAT_21 or rec_p < RECALL_UNI_PQ_21
            or rec_r < MIN_RECALL_UNI_21):
        raise AssertionError(f"phase 21 (b): uniform recalls {rec_w}, "
                             f"{rec_p}, {rec_r}")

    sp8 = ivf_pq.SearchParams(n_probes=N_PROBES, compressed_lut_int8=True)
    with _Capture("ivf_pq") as cap:
        _, i8 = _part_21("b_int8_lut", lambda: ivf_pq.search(
            sp8, pq_index, Q, K), parts, card)
    _need_21(parts, "b_int8_lut", ("pq_fused_scan",))
    args = cap.calls[K][0]
    if args[3].dtype != torch.int8 or args[10] is None:
        raise AssertionError(f"phase 21 (b): B4 ran {args[3].dtype} tables, "
                             f"scales {args[10] is not None}, not int8")
    rec_8 = recall(i8, bf[1])
    int8_ms = time_ms(lambda: ivf_pq.search(sp8, pq_index, Q, K), reps=5)
    log(f"phase 21 (b) int8 LUT: recall@{K} {rec_8:.6f} against phase 6's "
        f"f32 tables {pq_recall:.6f} (within {INT8_GAP_21}), {int8_ms:.3f} "
        f"ms per {Q.shape[0]} queries [{card}]")
    if abs(rec_8 - pq_recall) > INT8_GAP_21:
        raise AssertionError(f"phase 21 (b): int8 LUT recall {rec_8}")
    return {"flat": rec_f, "pq": rec_p, "min_recall": rec_r, "int8": rec_8,
            "int8_ms": int8_ms}


def _probed_exactly_21(index, Qu, fd, fi, bf_u, X):
    """IVF-Flat's answer ``(fd, fi)`` at ``N_PROBES`` probes is exact over
    the lists it probed: it holds every exact neighbour ``bf_u`` whose
    list it probed, but at a near-tie with its k-th distance (within
    ``norm_tol``), and none from another list. Returns the share of the
    exact neighbours in the first P lists of each query's probe order,
    for each P of ``COVER_PROBES_21``, and the near-tie slots."""
    import torch

    from raft_tpu_torch.neighbors import ivf_flat

    owner = torch.full((X.shape[0],), -1, dtype=torch.long, device=X.device)
    live = torch.arange(index.data.shape[1], device=X.device)[None, :] \
        < index.list_sizes[:, None]
    lists = torch.arange(index.n_lists, device=X.device)[:, None]
    owner[index.indices[live].long()] = lists.expand_as(live)[live]
    order = ivf_flat._coarse_probe(Qu, index.centers, index.n_lists,
                                   True).long()
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(index.n_lists, device=X.device)
                  .expand_as(order).contiguous())
    r = torch.gather(rank, 1, owner[bf_u[1].long()])
    hit = (bf_u[1][:, :, None] == fi[:, None, :]).any(dim=2)
    probed = r < N_PROBES
    if bool((hit & ~probed).any()):
        raise AssertionError("phase 21 (b): IVF-Flat found a neighbour in a "
                             "list it did not probe")
    lost = probed & ~hit
    if bool(lost.any()):
        gap = float((fd[:, -1:] - bf_u[0]).abs()[lost].max())
        tol = norm_tol(Qu, X)
        if gap > tol:
            raise AssertionError(f"phase 21 (b): IVF-Flat missed an exact "
                                 f"neighbour of a probed list ({gap} from "
                                 f"its k-th distance, tol {tol})")
    cover = {p: float((r < p).float().mean()) for p in COVER_PROBES_21}
    return cover, int(lost.sum())


def scan_engines_21(dev, X, Q, bf, iv, flat, pq_index, pq_recall, card,
                    parts) -> dict:
    """Phase 21 (c): both scan engines at the main path's 10,000 queries
    and 32 probes: IVF-Flat's = phase 4's B2 answer but at near-ties,
    IVF-PQ's LUT scan within 0.01 of the compressed tier's recall."""
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    d, i = _part_21("c_flat_scan", lambda: ivf_flat.search(
        ivf_flat.SearchParams(n_probes=N_PROBES, engine="scan"), flat, Q, K),
        parts, card)
    diff = near_tie_check("phase 21 (c) IVF-Flat scan engine", d, i, iv[0],
                          iv[1], X, Q, norm_tol(Q, X))
    _, li = _part_21("c_pq_lut_scan", lambda: ivf_pq.search(
        ivf_pq.SearchParams(n_probes=N_PROBES, engine="scan"), pq_index, Q,
        K), parts, card)
    rec_l = recall(li, bf[1])
    log(f"phase 21 (c) scan engines at {Q.shape[0]} queries: IVF-Flat = "
        f"phase 4's B2 answer but at {diff} near-tie slots; IVF-PQ LUT scan "
        f"recall@{K} {rec_l:.6f} against the compressed tier's "
        f"{pq_recall:.6f} (within {PQ_TIER_GAP}) [{card}]")
    if abs(rec_l - pq_recall) > PQ_TIER_GAP:
        raise AssertionError(f"phase 21 (c): LUT scan recall {rec_l}")
    for what in ("c_flat_scan", "c_pq_lut_scan"):
        _need_21(parts, what, quiet=("fused_cells_knn", "pq_fused_scan"))
    return {"flat_near_ties": diff, "lut_scan": rec_l}


def _recon_mse_21(index, X) -> float:
    """Mean squared error of the index's f32 reconstruction of each stored
    row against the row rotated (PER_SUBSPACE books; the measure of the
    reference's ``test_opq_reduces_quantization_error``)."""
    import torch

    from raft_tpu_torch.distance.pairwise import gram
    from raft_tpu_torch.neighbors.ivf_pq import unpack_codes

    n_lists, cap, _ = index.pq_codes.shape
    J = index.pq_dim
    crot = index.centers_rot()
    jj = torch.arange(J, device=X.device)
    slot = torch.arange(cap, device=X.device)[None, :]
    step = max(1, (1 << 24) // (cap * index.rot_dim))
    err, cnt = 0.0, 0
    for l0 in range(0, n_lists, step):
        codes = unpack_codes(index.pq_codes[l0:l0 + step], J,
                             index.pq_bits).long()
        rec = (index.pq_centers[jj, codes].reshape(codes.shape[0], cap, -1)
               + crot[l0:l0 + step, None, :])
        valid = slot < index.list_sizes[l0:l0 + step, None]
        rows = gram(X[index.indices[l0:l0 + step][valid].long()],
                    index.rotation_matrix)
        err += float(torch.sum(((rec[valid] - rows) ** 2).double()))
        cnt += int(valid.sum())
    return err / cnt


def codebooks_21(dev, X, Q, bf, pq_index, pq_recall, card, parts) -> dict:
    """Phase 21 (d): PER_CLUSTER codebooks (off the compressed tier: B3,
    never B4) and OPQ (B4; a lower reconstruction error than phase 6's
    index) at 1M on phase 4's rows."""
    import torch

    from raft_tpu_torch.neighbors import ivf_pq

    kind = ivf_pq.CodebookGen.PER_CLUSTER
    # PER_CLUSTER's recall moves with its longest list (ROADMAP C.3) and a
    # build on the card repeats only under deterministic algorithms
    # (index_add_'s atomics): build it so, and every run holds one index
    # to the bar.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        index = _part_21("d_per_cluster_build", lambda: ivf_pq.build(
            ivf_pq.IndexParams(n_lists=N_LISTS, codebook_kind=kind), X),
            parts, card)
    finally:
        torch.use_deterministic_algorithms(False)
    _need_21(parts, "d_per_cluster_build", ("fused_knn",))
    if ivf_pq._compressed_supported(index):
        raise AssertionError("phase 21 (d): PER_CLUSTER passed the "
                             "compressed tier's gate")
    sp = ivf_pq.SearchParams(n_probes=N_PROBES, engine="bucketed",
                             bucket_cap=BUCKET_CAP)
    _, ci = _part_21("d_per_cluster_search", lambda: ivf_pq.search(
        sp, index, Q[:N_SUB], K), parts, card)
    _need_21(parts, "d_per_cluster_search", ("fused_batch_knn",),
             ("pq_fused_scan",))
    b3 = parts["d_per_cluster_search"]["launches"]["fused_batch_knn"]
    tier = "recon tier" if index._recon is not None else "decode scan"
    rec_c = recall(ci, bf[1][:N_SUB])
    books = index.pq_centers
    distinct = [len(torch.unique(books[i], dim=0)) for i in range(
        books.shape[0])]
    log(f"phase 21 (d) PER_CLUSTER (built under deterministic algorithms): "
        f"the {tier} ({b3} B3 launches, no B4), recall@{K} {rec_c:.6f} on "
        f"the first {N_SUB} queries (bar {RECALL_PER_CLUSTER_21}); longest "
        f"list {int(index.list_sizes.max())} rows, distinct codewords a "
        f"list {min(distinct)}-{max(distinct)} of {books.shape[1]} (mean "
        f"{sum(distinct) / len(distinct):.1f}) [{card}]")
    if rec_c < RECALL_PER_CLUSTER_21:
        raise AssertionError(f"phase 21 (d): PER_CLUSTER recall {rec_c}")
    del index

    opq = _part_21("d_opq_build", lambda: ivf_pq.build(
        ivf_pq.IndexParams(n_lists=N_LISTS, opq_iters=1), X), parts, card)
    _need_21(parts, "d_opq_build", ("fused_knn",))
    _, oi = _part_21("d_opq_search", lambda: ivf_pq.search(
        ivf_pq.SearchParams(n_probes=N_PROBES), opq, Q, K), parts, card)
    _need_21(parts, "d_opq_search", ("pq_fused_scan",))
    rec_o = recall(oi, bf[1])
    mse_o, mse_6 = _recon_mse_21(opq, X), _recon_mse_21(pq_index, X)
    log(f"phase 21 (d) OPQ (opq_iters 1): reconstruction MSE {mse_o:.6f} "
        f"against phase 6's {mse_6:.6f}, recall@{K} {rec_o:.6f} against "
        f"phase 6's {pq_recall:.6f} (at least it less {OPQ_GAP_21}) "
        f"[{card}]")
    if mse_o >= mse_6 or rec_o < pq_recall - OPQ_GAP_21:
        raise AssertionError(f"phase 21 (d): OPQ MSE {mse_o} (phase 6 "
                             f"{mse_6}), recall {rec_o}")
    return {"per_cluster": rec_c, "tier": tier, "opq": rec_o,
            "opq_mse": mse_o, "base_mse": mse_6}


def big_pq_21(dev, card, parts) -> dict:
    """Phase 21 (e): bench.py's 10M x 128 compressed-only IVF-PQ
    (:536-580): rows from ``make_blobs`` on the card, a build with
    ``retain_dataset=False`` that holds nothing of them once they are
    deleted, the compressed search (B4), a ``min_recall`` search that
    warns and answers the native one, and the per-list budget."""
    import logging
    import logging.handlers

    import torch

    from raft_tpu_torch.neighbors import brute_force, ivf_pq
    from raft_tpu_torch.random.make_blobs import make_blobs

    n, d, n_blobs, n_q, n_lists = BIG_21

    def data():
        rows, _ = make_blobs(n, d, n_clusters=n_blobs, cluster_std=BLOB_STD,
                             seed=BIG_SEEDS_21[0], device=dev)
        noise = np.random.default_rng(BIG_SEEDS_21[1]).normal(size=(n_q, d))
        return rows, rows[:n_q] + torch.as_tensor(noise.astype(np.float32),
                                                  device=dev)

    X, Qb = _part_21("e_data", data, parts, card)
    _, truth = _part_21("e_truth", lambda: brute_force.knn(X, Qb, K), parts,
                        card)
    _need_21(parts, "e_truth", ("fused_knn",))
    index = _part_21("e_build", lambda: ivf_pq.build(ivf_pq.IndexParams(
        n_lists=n_lists, retain_dataset=False,
        kmeans_trainset_fraction=BIG_TRAIN_FRAC_21), X), parts, card)
    _need_21(parts, "e_build", ("fused_knn",))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    del X
    freed = held - torch.cuda.memory_allocated()
    rows_bytes = n * d * 4
    index_bytes = sum(t.numel() * t.element_size() for t in (
        index.pq_codes, index.indices, index.list_sizes, index.centers,
        index.rotation_matrix, index.pq_centers))
    log(f"phase 21 (e): {n} x {d} rows ({rows_bytes} bytes) deleted, "
        f"{freed} bytes of device memory freed; the index holds "
        f"{index_bytes} bytes (codes and model), source {index._source}")
    if index._source is not None or freed < rows_bytes:
        raise AssertionError(f"phase 21 (e): the index keeps its rows "
                             f"({freed} of {rows_bytes} bytes freed)")

    sp = ivf_pq.SearchParams(n_probes=N_PROBES, engine="bucketed")
    bd, bi = _part_21("e_search", lambda: ivf_pq.search(sp, index, Qb, K),
                      parts, card)
    _need_21(parts, "e_search", ("pq_fused_scan",))
    rec = recall(bi, truth)
    search_ms = time_ms(lambda: ivf_pq.search(sp, index, Qb, K), reps=5)
    seen = logging.handlers.BufferingHandler(64)
    seen.setLevel(logging.WARNING)
    logging.getLogger("raft_tpu_torch").addHandler(seen)
    try:
        md, mi = _part_21("e_min_recall", lambda: ivf_pq.search(
            dataclasses.replace(sp, min_recall=0.95), index, Qb, K), parts,
            card)
    finally:
        logging.getLogger("raft_tpu_torch").removeHandler(seen)
    warned = any("retains no source" in r.getMessage() for r in seen.buffer)
    same = torch.equal(md, bd) and torch.equal(mi, bi)
    cap, nbytes = index.pq_codes.shape[1], index.pq_codes.shape[2]
    largest = int(index.list_sizes.max())
    fits = ivf_pq._compressed_vmem_ok(cap, nbytes, index.rot_dim)
    log(f"phase 21 (e) {n} x {d} compressed-only: recall@{K} {rec:.6f} (bar "
        f"{RECALL_BIG_21}; v5e record 0.856), search {search_ms:.3f} ms per "
        f"{n_q} queries; min_recall=0.95 warned {warned}, answered the "
        f"native search bit for bit {same}; largest list {largest} rows, "
        f"capacity {cap}, B4's {ivf_pq._PQ_CELL_BYTES}-byte per-list budget "
        f"holds it: {fits} [{card}]")
    if rec < RECALL_BIG_21 or not warned or not same or not fits:
        raise AssertionError(f"phase 21 (e): recall {rec}, warned {warned}, "
                             f"same {same}, budget {fits}")
    return {"recall": rec, "search_ms": search_ms, "freed": freed,
            "index_bytes": index_bytes, "largest_list": largest,
            "cap": cap}


def slice21_phase(dev, X, Q, bf, iv, flat, pq_index, pq_recall,
                  card) -> dict:
    """Phase 21: the reference bench's configurations the port had not run
    on the card, after phase 20 and before the serve phase, on phase 4's
    rows, answers and IVF-Flat index and phase 6's IVF-PQ index (its
    recon cache dropped). Counters set to 0 before it; every part's
    launches read around it and checked. Frees what it built. Returns its
    launches, seconds, peak device memory and part figures."""
    import torch

    _zero_counters()
    parts = {}
    t0 = time.perf_counter()
    a = sift_u8_21(dev, card, parts)
    torch.cuda.empty_cache()
    b = uniform_21(dev, X, Q, bf, flat, pq_index, pq_recall, card, parts)
    c = scan_engines_21(dev, X, Q, bf, iv, flat, pq_index, pq_recall, card,
                        parts)
    torch.cuda.empty_cache()
    d = codebooks_21(dev, X, Q, bf, pq_index, pq_recall, card, parts)
    torch.cuda.empty_cache()
    e = big_pq_21(dev, card, parts)
    torch.cuda.empty_cache()
    total = time.perf_counter() - t0
    launches = _launches()
    peak = max(p["peak_gib"] for p in parts.values())
    by_part = {}
    for what, p in parts.items():
        by_part[what[0]] = by_part.get(what[0], 0.0) + p["seconds"]
    log(f"phase 21: {total:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in by_part.items())
        + f"), peak device memory {peak:.2f} GiB, launches {launches} "
        f"[{card}]")
    return {"launches": launches, "seconds": total, "peak_gib": peak,
            "parts": parts, "sift": a, "uniform": b, "scan": c,
            "codebooks": d, "big": e}


def kmeans_labels(centers, X):
    """Each row's nearest center (the lists of an IVF-Flat build)."""
    from raft_tpu_torch.cluster import kmeans_balanced
    from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams

    return kmeans_balanced._predict(KMeansBalancedParams(), centers,
                                    X).long()


def sharded_phase(dev, X, Q, mp_out, pq_out, card):
    """Phases 12 to 15: sharding and durability, with the counters set to
    0 before each step and read after it; one spawned world of 4 ranks
    runs the four phases' (b) steps and phase 20 (f). Returns the
    launches of each phase and the seconds of phase 20 (f) on the
    ranks."""
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
    dask_s = dask_ranks_20(got, card)
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
    return p12, p13, p14, p15, dask_s


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

    # Every B1 and B2 launch from here on is held to its tier's scan.
    b1_tiers, b2_tiers = B1Tiers(), B2Tiers()
    b2_bf16 = {}

    def take(phase):
        b2_bf16[phase] = b2_tiers.take(phase)["bf16"]
        return b1_tiers.take(phase)

    check_kernels(dev)
    take("phase 3")
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
    # The IVF builds of phases 4 and 6, the Lloyd fits of phase 17 and the
    # facades' of phase 20 run B1's split-bf16 tier in their loops.
    tiers_used = {"phase 4": take("phase 4")}
    b1 = b1_entry(dev, X, Q, mp["bf"])
    split_err = b1_kmeans_shape(dev, X, mp["index"].centers)
    b2, b2m = b2_entry(dev, Q, mp["index"], mp["search_ms"])
    take("phase 5")

    pq = pq_path(dev, X, Q, mp["bf"][1])
    b4 = b4_entry(dev, Q, pq["index"], pq["search_ms"])
    b3 = b3_entry(dev, pq["index"], pq["probes_sub"], pq["rotq_sub"])
    tiers_used["phase 6"] = take("phase 6")

    b5 = select_phase(dev, b5_err)
    br = breadth_phase(dev, X, Q, mp["index"], card)
    b5["launches"] += br["stream_extract"]
    take("phases 7 and 16")
    p17 = slice17_phase(dev, X, Q, pq.pop("candidates"), card)
    tiers_used["phase 17"] = take("phase 17")
    p18 = slice18_phase(dev, X, card)
    p19 = slice19_phase(dev, X, Q, mp["bf"], card)
    b5["launches"] += p19["launches"]["stream_extract"]
    take("phases 18 and 19")
    # Phase 20 runs while phase 4's index is as phase 4 built it.
    p20 = facade_phase(dev, X, Q, mp["bf"], mp["iv"], mp["index"], card)
    tiers_used["phase 20"] = take("phase 20")
    idle = [ph for ph, got in tiers_used.items() if got["bf16"] < 1]
    if idle:
        raise AssertionError(f"no split-bf16 B1 launch in {idle}")
    # Phase 6 left IVF-PQ's reconstruction cache in place, which routes
    # search to the recon tier; phase 21 and the serve and lifecycle
    # phases search the compressed tier (B4), as the main path does.
    pq["index"]._recon = None
    p21 = slice21_phase(dev, X, Q, mp["bf"], mp["iv"], mp["index"],
                        pq["index"], pq["recall"], card)
    b5["launches"] += p21["launches"]["stream_extract"]
    sv = serve_phase(dev, X, card, mp["index"], pq["index"], pq["recall"])
    lc, compacted = lifecycle_phase(
        dev, X, Q, mp["bf"], mp["index"], pq["index"], mp["search_ms"],
        pq["search_ms"], pq["recall"])
    sm, flat_served = serve_mutations(dev, Q, compacted["ivf_flat"], card)
    sf = surface_phase(dev, X, Q, mp["bf"], mp["index"], flat_served,
                       compacted["ivf_pq"], pq["recall"], card)
    sh, rt, ops, du, dask_s = sharded_phase(dev, X, Q, mp, pq, card)
    take("phases 21 and 8-15 (this process)")
    idle = [ph for ph in ("phase 3", "phase 5",
                          "phases 21 and 8-15 (this process)")
            if b2_bf16[ph] < 1]
    if idle:
        raise AssertionError(f"no bf16-tier B2 launch in {idle}")
    log(f"phase 21: {p21['seconds']:.3f} s, launches {p21['launches']}, "
        f"peak device memory {p21['peak_gib']:.2f} GiB [{card}]")
    log(f"phase 20: {p20['seconds'] + dask_s:.3f} s (this process "
        f"{p20['seconds']:.3f} s, the 4 ranks' sessions {dask_s:.3f} s), "
        f"launches {p20['launches']}, peak device memory "
        f"{p20['peak_gib']:.2f} GiB [{card}]")

    # B1's launches on the main path's phases: knn_tf32.cu's (the f32
    # tier) and knn_mma.cu's (the bf16 tiers) apart; every one is a
    # tensor-core launch.
    b1_runs = [mp["launches"], pq["launches"], sv, lc, sm, sf, sh, rt, ops,
               du, br, p17["launches"], p18["launches"], p19["launches"],
               p20["launches"], p21["launches"]]
    b1_tf32 = sum(run["fused_knn_tf32"] for run in b1_runs)
    b1_mma = sum(run["fused_knn_mma"] for run in b1_runs) - b1_tf32
    if sum(run["fused_knn_mma"] for run in b1_runs) != sum(
            run["fused_knn"] for run in b1_runs):
        raise AssertionError("a B1 launch missed the tensor-core scans")
    mma = dict(p17["mma"], max_abs_err=max(p17["mma"]["max_abs_err"],
                                           split_err))
    # B2's likewise: the FMA scan's (the f32 tier) and the tensor-core
    # scan's (the bf16 tiers) apart.
    b2_runs = [mp["launches"], sv, lc, sm, sf, sh, rt, ops, du, br,
               p20["launches"], p21["launches"]]
    b2_mma = sum(run.get("fused_cells_knn_mma", 0) for run in b2_runs)
    b2_fma = sum(run["fused_cells_knn"] for run in b2_runs) - b2_mma
    kernels = [
        dict(name="fused_knn_tf32", route="cuda",
             source="raft_tpu_torch/csrc/knn_tf32.cu",
             replaces="raft_tpu/ops/fused_knn.py:179", launches=b1_tf32,
             **b1),
        dict(name="fused_knn_mma", route="cuda",
             source="raft_tpu_torch/csrc/knn_mma.cu",
             replaces="raft_tpu/ops/fused_knn.py:179", launches=b1_mma,
             **mma),
        dict(name="fused_cells_knn", route="cuda",
             source="raft_tpu_torch/csrc/cells_knn.cu",
             replaces="raft_tpu/ops/fused_knn.py:426", launches=b2_fma,
             **b2),
        dict(name="fused_cells_knn_mma", route="cuda",
             source="raft_tpu_torch/csrc/cells_mma.cu",
             replaces="raft_tpu/ops/fused_knn.py:426", launches=b2_mma,
             **b2m),
        dict(name="fused_batch_knn", route="cuda",
             source="raft_tpu_torch/csrc/batch_knn.cu",
             replaces="raft_tpu/ops/fused_knn.py:277",
             launches=pq["launches"]["fused_batch_knn"]
             + sv["fused_batch_knn"] + lc["fused_batch_knn"]
             + sm["fused_batch_knn"] + sf["fused_batch_knn"]
             + sh["fused_batch_knn"] + rt["fused_batch_knn"]
             + ops["fused_batch_knn"]
             + du["fused_batch_knn"] + br["fused_batch_knn"]
             + p21["launches"]["fused_batch_knn"], **b3),
        dict(name="pq_fused_scan", route="cuda",
             source="raft_tpu_torch/csrc/pq_scan.cu",
             replaces="raft_tpu/ops/pq_scan.py:440",
             launches=pq["launches"]["pq_fused_scan"] + sv["pq_fused_scan"]
             + lc["pq_fused_scan"] + sm["pq_fused_scan"]
             + sf["pq_fused_scan"] + sh["pq_fused_scan"]
             + rt["pq_fused_scan"] + ops["pq_fused_scan"]
             + du["pq_fused_scan"] + br["pq_fused_scan"]
             + p20["launches"]["pq_fused_scan"]
             + p21["launches"]["pq_fused_scan"], **b4),
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
