"""Rank-side cases of the durability and operations parity tests (no tests
here): the write-ahead log's streams, kills and recoveries, followers and
promotion, elastic resizes and the recall probe, run on the ranks of a
``test_torch_world.World``. Like ``test_torch_world`` this module imports
neither jax nor raft_tpu, so the ranks never load the reference; the
stream helpers (:func:`wal_steps`, :func:`apply_step`) are shared with
the reference side of the tests, which passes its own classes in.
"""

import os

import numpy as np
import torch

from test_torch_world import (_error, _placement_arrays, _search_params,
                              _sharded_index, np_out, sub_mesh)

N_LISTS = 8
DIMS = {"flat": 8, "pq": 16}


def wal_steps(kind: str):
    """The scripted mutation stream of the reference suite
    (``tests/test_durability.py::_steps``) on integer data of this
    suite's sizes: one record of each kind but migrate. Before the
    compaction, traffic skewed onto rank 0's lists (one probe a query, at
    their centers) makes its balancer migrate lists of a list placement,
    so the compact record carries the placement's outcome."""
    dim, hi = DIMS[kind], (8 if kind == "flat" else 4)
    rng = np.random.default_rng(7)
    ext1 = rng.integers(0, hi, (128, dim)).astype(np.float32)
    up_ids = np.arange(5, 325, 5)
    up_vecs = rng.integers(0, hi, (up_ids.size, dim)).astype(np.float32)
    ext2 = rng.integers(0, hi, (64, dim)).astype(np.float32)
    return [("extend", ext1), ("delete", np.arange(0, 256, 10)),
            ("upsert", up_vecs, up_ids),
            ("compact", dict(trigger_frac=0.01, balance_placement=1.0)),
            ("extend", ext2)]


def apply_step(searcher, step, policy_cls):
    """One mutation of :func:`wal_steps` through a Searcher of either
    package (``policy_cls``: that package's CompactionPolicy)."""
    op = step[0]
    if op == "extend":
        searcher.extend(step[1])
    elif op == "delete":
        searcher.delete(step[1])
    elif op == "upsert":
        searcher.upsert(step[1], step[2])
    else:
        pm = getattr(searcher._index, "placement_map", None)
        if pm is not None:
            centers = searcher._index.centers
            centers = np.asarray(centers.cpu() if isinstance(
                centers, torch.Tensor) else centers)
            searcher.search(centers[pm.owner == 0], 5, n_probes=1)
        searcher.compact(policy_cls(**step[1]))


def _quiet():
    """Suppress the routing and merge telemetry: a test's own searches
    must not become the placement balancer's traffic."""
    import contextlib

    from raft_tpu_torch.comms.topk_merge import merge_dispatch_stats
    from raft_tpu_torch.parallel.routing import routing_stats

    stack = contextlib.ExitStack()
    stack.enter_context(routing_stats.suppress())
    stack.enter_context(merge_dispatch_stats.suppress())
    return stack


def search_all(mesh, kind, index, Q, k):
    """Every list probed, the allgather merge, telemetry suppressed."""
    from raft_tpu_torch import parallel

    fn = (parallel.sharded_ivf_flat_search if kind == "flat"
          else parallel.sharded_ivf_pq_search)
    with _quiet():
        return np_out(fn(mesh, _search_params(kind, "scan", N_LISTS), index,
                         Q, k, merge_engine="allgather"))


def index_arrays(index):
    """This rank's tensors of a sharded index, for array-for-array
    comparison, and the placement."""
    store = index.data if hasattr(index, "data") else index.pq_codes
    out = dict(store=store, indices=index.indices,
               list_sizes=index.list_sizes,
               deleted=(index.deleted if index.deleted is not None
                        and index.n_deleted else None),
               n_rows=index.n_rows, n_deleted=index.n_deleted,
               epoch=index.epoch)
    if index.placement_map is not None:
        out["placement"] = _placement_arrays(index)
    return np_out({k: (np_out(v) if isinstance(v, torch.Tensor) else v)
                   for k, v in out.items()})


def _searcher(mesh, kind, index, wal=None, **kw):
    from raft_tpu_torch.serve import Searcher

    return Searcher("ivf_flat" if kind == "flat" else "ivf_pq", mesh=mesh,
                    index=index,
                    search_params=_search_params(kind, "scan", N_LISTS),
                    wal=wal, **kw)


def _fresh(mesh, kind, X, model, placement, root, n_parts, **log_kw):
    """A new log root holding an epoch-0 snapshot of the base index;
    returns the base index."""
    from raft_tpu_torch.lifecycle import MutationLog
    from raft_tpu_torch.parallel.routing import routing_stats

    routing_stats.reset()
    index = _sharded_index(mesh, kind, X, model, N_LISTS, placement)
    log = MutationLog(root, n_parts=n_parts, fsync=False, mesh=mesh,
                      **log_kw)
    log.snapshot(index, mesh)
    log.close()
    return index


def case_wal_states(n, kind, placement, X, model, Q, k, root,
                    n_parts=2):
    """The uninterrupted stream with a log: after each step (and before
    the first) the epoch, the full-probe search and this rank's arrays;
    then the log's (kind, epoch, seq) records."""
    from raft_tpu_torch.lifecycle import CompactionPolicy, MutationLog

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    index = _fresh(mesh, kind, X, model, placement, root, n_parts)
    log = MutationLog(root, n_parts=n_parts, fsync=False, mesh=mesh)
    s = _searcher(mesh, kind, index, log)
    states = [(s.epoch, search_all(mesh, kind, s._index, Q, k),
               index_arrays(s._index))]
    for step in wal_steps(kind):
        apply_step(s, step, CompactionPolicy)
        states.append((s.epoch, search_all(mesh, kind, s._index, Q, k),
                       index_arrays(s._index)))
    recs = [(r.kind, r.epoch, r.seq) for r in log.records()]
    log.close()
    return states, recs


def case_wal_kill(n, kind, placement, X, model, Q, k, root, kill_step,
                  phase, offset=45, victim=0, n_parts=2, resume=False):
    """The stream with a scripted fault at step ``kill_step`` (1-based):
    "pre" (the log write raises on ``victim``), "torn" (it writes
    ``offset`` bytes and raises), "post" (the record is durable, then
    ``post_append`` raises on ``victim``). Every rank must raise; then
    the log is closed and the index recovered (and with ``resume`` the
    rest of the stream run on it). Returns each rank's error, the live
    searcher's epoch, the recovered epoch, search and arrays."""
    from raft_tpu_torch.lifecycle import (CompactionPolicy, MutationLog,
                                          recover)
    from raft_tpu_torch.testing.chaos import ChaosMonkey, FaultSpec
    from raft_tpu_torch.util.atomic_io import FileIO

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    chaos = ChaosMonkey(seed=0)
    file_io, post_append = FileIO(), None
    at = (kill_step - 1,)                 # one log write per append
    mine = mesh.rank == victim
    if phase in ("pre", "torn") and mine:
        spec = (FaultSpec(kind="raise", at=at) if phase == "pre"
                else FaultSpec(kind="torn_write", at=at, offset=offset))
        file_io = FileIO(write_bytes=chaos.wrap_write("wal", faults=[spec]))
    elif phase == "post":
        post_append = chaos.hook("commit")
        if mine:
            chaos.script("commit", [FaultSpec(kind="raise", at=at)])
    index = _fresh(mesh, kind, X, model, placement, root, n_parts)
    log = MutationLog(root, n_parts=n_parts, fsync=False, mesh=mesh,
                      file_io=file_io, post_append=post_append)
    s = _searcher(mesh, kind, index, log)
    steps = wal_steps(kind)
    for step in steps[:kill_step - 1]:
        apply_step(s, step, CompactionPolicy)
    err = _error(lambda: apply_step(s, steps[kill_step - 1],
                                    CompactionPolicy))
    live_epoch = s.epoch
    log.close()
    rec, log2 = recover(mesh, root, n_parts=n_parts, fsync=False)
    out = dict(err=err, live_epoch=live_epoch, rec_epoch=rec.epoch,
               search=search_all(mesh, kind, rec, Q, k),
               arrays=index_arrays(rec))
    if resume:
        s2 = _searcher(mesh, kind, rec, log2)
        for step in steps[kill_step - 1 if phase != "post" else kill_step:]:
            apply_step(s2, step, CompactionPolicy)
        out.update(end_epoch=s2.epoch,
                   end_search=search_all(mesh, kind, s2._index, Q, k),
                   end_arrays=index_arrays(s2._index))
    log2.close()
    return out


def case_wal_recover(n, kind, root, Q, k, n_parts=2):
    """Recover whatever ``root`` holds (either package's log): the
    snapshot it started from, the epoch, the search and the arrays."""
    from raft_tpu_torch.lifecycle import recover

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    rec, log = recover(mesh, root, n_parts=n_parts, fsync=False)
    out = (log.latest_snapshot()[0], rec.epoch,
           search_all(mesh, kind, rec, Q, k), index_arrays(rec))
    log.close()
    return out


def case_wal_write(n, kind, placement, X, model, root, n_parts=2,
                   snap_after=None, tear_snapshot=False):
    """Write the whole stream's log (for the other package to recover),
    with an extra snapshot after step ``snap_after``; ``tear_snapshot``
    grows that snapshot's first shard file by a byte. Returns the final
    epoch."""
    from raft_tpu_torch.comms.comms import Comms
    from raft_tpu_torch.lifecycle import CompactionPolicy, MutationLog

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    index = _fresh(mesh, kind, X, model, placement, root, n_parts)
    log = MutationLog(root, n_parts=n_parts, fsync=False, mesh=mesh)
    s = _searcher(mesh, kind, index, log)
    for j, step in enumerate(wal_steps(kind), start=1):
        apply_step(s, step, CompactionPolicy)
        if j == snap_after:
            base = log.snapshot(s._index, mesh)
            if tear_snapshot and mesh.rank == 0:
                with open(f"{base}.shard0.npz", "ab") as f:
                    f.write(b"\x00")
            Comms(mesh).barrier()
    log.close()
    return s.epoch


def case_epoch_gap(n, X, model, Q, k, root):
    """The reference's gap script: one part, a segment per record, three
    steps; the epoch-2 record's segment removed (rank 0), then a replay
    onto a fresh build stops at epoch 1."""
    from raft_tpu_torch.comms.comms import Comms
    from raft_tpu_torch.lifecycle import (CompactionPolicy, MutationLog,
                                          replay)

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    index = _fresh(mesh, "flat", X, model, "list", root, 1,
                   segment_bytes=64)
    log = MutationLog(root, n_parts=1, segment_bytes=64, fsync=False,
                      mesh=mesh)
    s = _searcher(mesh, "flat", index, log)
    for step in wal_steps("flat")[:3]:
        apply_step(s, step, CompactionPolicy)
    if mesh.rank == 0:
        os.remove(log._writers[0].segments()[1])
    Comms(mesh).barrier()
    fresh = _sharded_index(mesh, "flat", X, model, N_LISTS, "list")
    replayed = replay(mesh, fresh, log)
    log.close()
    return replayed.epoch, search_all(mesh, "flat", replayed, Q, k)


def case_write_ahead(n, X, model, Q, k, root):
    """The reference suite's TestWriteAhead scripts on one world: the
    read-only refusals (reads still serve), a delete of absent ids
    appends nothing, and the snapshot cadence (snapshot_every=2) with the
    stats feed. Returns what each asserts, per rank."""
    from raft_tpu_torch.lifecycle import CompactionPolicy, MutationLog

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    index = _sharded_index(mesh, "flat", X, model, N_LISTS, "list")
    ro = _searcher(mesh, "flat", index, writable=False)
    dim = DIMS["flat"]
    refusals = [_error(lambda: ro.extend(np.zeros((4, dim), np.float32))),
                _error(lambda: ro.delete(np.arange(4))),
                _error(lambda: ro.upsert(np.zeros((4, dim), np.float32),
                                         np.arange(4))),
                _error(lambda: ro.compact())]
    served = ro.search(Q, k).indices.shape
    log = MutationLog(os.path.join(root, "noop"), n_parts=2, fsync=False,
                      mesh=mesh)
    log.snapshot(index, mesh)
    s = _searcher(mesh, "flat", index, log)
    noop = (s.delete(np.arange(5000, 5004)), log.records(), s.epoch)
    log.close()
    log = MutationLog(os.path.join(root, "cadence"), n_parts=2, fsync=False,
                      snapshot_every=2, mesh=mesh)
    log.snapshot(index, mesh)
    s = _searcher(mesh, "flat", index, log)
    steps = wal_steps("flat")
    apply_step(s, steps[0], CompactionPolicy)
    snaps = [log.stats.snapshots]
    apply_step(s, steps[1], CompactionPolicy)
    snaps += [log.stats.snapshots, log.latest_snapshot()[0]]
    st = log.stats
    stats = (st.records, st.bytes, st.snapshots, st.head_epoch,
             st.last_snapshot_epoch)
    log.close()
    return refusals, served, noop, snaps, stats


def case_follower(n, X, model, Q, k, root, edge_ranks, poll_after=True):
    """The reference suite's follower scripts: a primary and a follower
    (over a second recovery of the same log) on every rank. The follower
    refuses a delete, tails two steps (poll, catch_up), then a
    PromotionManager watches rank 0; ``edge_ranks`` mark rank 0 dead in
    their own registries, and the follower polls. Returns the refusal,
    the tailing, whether it promoted, and (promoted) the delete that
    follows and the log head."""
    from raft_tpu_torch.comms.health import ShardHealth
    from raft_tpu_torch.lifecycle import (CompactionPolicy, Follower,
                                          MutationLog, PromotionManager,
                                          recover)

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    index = _fresh(mesh, "flat", X, model, "list", root, 2)
    plog = MutationLog(root, n_parts=2, fsync=False, mesh=mesh)
    primary = _searcher(mesh, "flat", index, plog)
    fidx, flog = recover(mesh, root, n_parts=2, fsync=False)
    fol = Follower(_searcher(mesh, "flat", fidx, flog), flog)
    refusal = _error(lambda: fol.searcher.delete(np.arange(4)))
    steps = wal_steps("flat")
    apply_step(primary, steps[0], CompactionPolicy)
    apply_step(primary, steps[1], CompactionPolicy)
    lag = fol.poll()
    applied = fol.catch_up()
    tail = (lag, applied, fol.lag, fol.epoch, primary.epoch,
            search_all(mesh, "flat", fol.searcher._index, Q, k),
            search_all(mesh, "flat", primary._index, Q, k))
    for step in steps[2:]:
        apply_step(primary, step, CompactionPolicy)
    health = ShardHealth(n)
    mgr = PromotionManager(fol, health, primary_rank=0)
    if mesh.rank in edge_ranks:
        health.mark_dead(0)
    if poll_after:
        fol.poll()
    promo = (mgr.promoted, mgr.promotions, fol.searcher.writable,
             fol.epoch, primary.epoch)
    after = None
    if mgr.promoted:
        n_del = fol.searcher.delete(np.arange(200, 208))
        after = (n_del, fol.epoch, fol.log.head_epoch(),
                 search_all(mesh, "flat", fol.searcher._index, Q, k),
                 mgr.promote(), mgr.promotions)
    else:
        after = (_error(lambda: fol.searcher.delete(np.arange(4))),
                 fol.catch_up(), fol.epoch)
    mgr.close()
    plog.close()
    flog.close()
    return refusal, tail, promo, after


# ---------------------------------------------------------------------------
# Elastic membership


def _elastic_searcher(mesh, X, centers, replicate=(), **kw):
    from raft_tpu_torch import parallel

    index = _sharded_index(mesh, "flat", X, centers, N_LISTS, "list")
    if len(replicate):
        index = parallel.sharded_replicate_lists(mesh, index,
                                                 list(replicate))
    return _searcher(mesh, "flat", index, **kw)


def _report(rep):
    return (rep.action, rep.rank, rep.active_before, rep.active_after,
            rep.lists_moved, rep.warmed_shapes, rep.epoch)


def case_elastic(n, X, centers, Q, k, script, replicate=(), root=None,
                 grid_max=0, writable=True):
    """Join / leave steps over a list-placed IVF-Flat Searcher: each step
    of ``script`` is ("leave", r) / ("join", r) (the report or the
    error), ("search",) (the full-probe answer through the searcher),
    ("placement",), ("shards",), ("dead", r) / ("live", r) /
    ("suspect", r) on every rank's ShardHealth, ("dead0", r) on rank 0's
    only, ("stats",) (elastic_stats) or ("fanout",) (the routing
    telemetry's per-shard queries since the last reset). With ``root`` a
    log records the resizes and ("recover",) returns the recovered epoch,
    placement and answer; ``grid_max`` warms each resize on
    ``BucketGrid.pow2(grid_max, k_grid=(k,))``; ``writable=False`` builds
    a read-only endpoint."""
    from raft_tpu_torch.comms.health import LatencyPolicy, ShardHealth
    from raft_tpu_torch.lifecycle import (MutationLog, elastic_stats,
                                          join_shard, leave_shard, recover,
                                          serving_shards)
    from raft_tpu_torch.parallel.routing import routing_stats
    from raft_tpu_torch.serve import BucketGrid

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    health = ShardHealth(n, latency=LatencyPolicy())
    routing_stats.reset()
    elastic_stats.reset()
    log = None
    s = _elastic_searcher(mesh, X, centers, replicate, health=health,
                          writable=writable)
    if root is not None:
        log = MutationLog(root, n_parts=2, fsync=False, mesh=mesh)
        log.snapshot(s._index, mesh)
        s.wal = log
    grid = BucketGrid.pow2(grid_max, k_grid=(k,)) if grid_max else None
    outs = []
    for step in script:
        op = step[0]
        if op in ("leave", "join"):
            fn = leave_shard if op == "leave" else join_shard
            err = None
            try:
                out = _report(fn(s, step[1], grid=grid))
            except Exception as e:      # noqa: BLE001 - the outcome
                err = (type(e).__name__, str(e))
            outs.append(out if err is None else err)
        elif op == "search":
            with _quiet():
                res = s.search(Q, k)
            outs.append((res.distances, res.indices, res.coverage))
        elif op == "traffic":
            res = s.search(Q, k)
            outs.append(res.indices)
        elif op == "placement":
            outs.append(_placement_arrays(s._index))
        elif op == "shards":
            outs.append(serving_shards(s._index))
        elif op == "dead":
            health.mark_dead(step[1])
        elif op == "dead0":
            if mesh.rank == 0:
                health.mark_dead(step[1])
        elif op == "live":
            health.mark_live(step[1])
        elif op == "suspect":
            health.mark_suspect(step[1])
        elif op == "stats":
            outs.append(elastic_stats.snapshot())
        elif op == "fanout":
            outs.append(dict(routing_stats.snapshot()["shard_queries"]))
            routing_stats.reset()
        elif op == "recover":
            log.close()
            rec, log = recover(mesh, root, n_parts=2, fsync=False)
            outs.append((rec.epoch, _placement_arrays(rec),
                         search_all(mesh, "flat", rec, Q, k)))
        if op not in ("dead", "dead0", "live", "suspect"):
            outs.append(s.epoch)
    if log is not None:
        log.close()
    return outs


def case_elastic_under_traffic(n, X, centers, dels, reqs, k, resizes):
    """Resizes interleaved with a BatchScheduler's traffic on rank 0 (the
    other ranks follow; each resize closes the front rank's scheduler
    first, so the ranks meet the resize's collectives in order): every
    answer's ids, coverage and the epochs."""
    from raft_tpu_torch.lifecycle import join_shard, leave_shard
    from raft_tpu_torch.serve import (BatchPolicy, BatchScheduler,
                                      BucketGrid, ResultCache)

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    s = _elastic_searcher(mesh, X, centers)
    s.delete(dels)
    grid = BucketGrid.pow2(8, k_grid=(k,))
    answers = []

    def serve(batch):
        if mesh.rank:
            BatchScheduler.follow(s)
            return
        sched = BatchScheduler(s, grid, BatchPolicy(max_batch=8,
                                                    max_wait=0.0),
                               cache=ResultCache(64))
        for q in batch:
            t = sched.submit(q, k)
            sched.run_until_idle()
            res = t.result()
            answers.append((res.indices, res.coverage))
        sched.close()

    chunks = np.array_split(np.arange(len(reqs)), len(resizes) + 1)
    for j, chunk in enumerate(chunks):
        serve([reqs[i] for i in chunk])
        if j < len(resizes):
            op, r = resizes[j]
            (leave_shard if op == "leave" else join_shard)(s, r, grid=grid)
    with _quiet():
        final = s.search(reqs[0], k)
    return answers, s.epoch, (final.distances, final.indices)


# ---------------------------------------------------------------------------
# The recall probe over a sharded front rank


def case_recall_probe(n, X, centers, reqs, k, rate, seed, n_probes):
    """A BatchScheduler on rank 0 over a list-placed IVF-Flat Searcher
    (``n_probes``) with ``probe=RecallProbe(rate, seed)``, the other
    ranks following; rank 0 drives ``reqs`` and runs the probe's truth
    searches through the command channel. Rank 0 returns the probe's
    snapshot and recall, the number scored, the sampled requests (queries
    and served ids) and the registry's scrape; the others their batch
    counts."""
    from raft_tpu_torch.obs import MetricsRegistry, RecallProbe
    from raft_tpu_torch.serve import (BatchPolicy, BatchScheduler,
                                      BucketGrid)

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    index = _sharded_index(mesh, "flat", X, centers, N_LISTS, "list")
    s = _searcher(mesh, "flat", index)
    s._params = _search_params("flat", "scan", n_probes)
    if mesh.rank:
        return BatchScheduler.follow(s)
    reg = MetricsRegistry()
    probe = RecallProbe(s, rate=rate, seed=seed, registry=reg)
    sampled = []
    real_offer = probe.offer

    def offer(queries, kk, indices, bucket, epoch):
        hit = real_offer(queries, kk, indices, bucket, epoch)
        if hit:
            sampled.append((queries, np.asarray(indices)))
        return hit

    probe.offer = offer
    sched = BatchScheduler(s, BucketGrid.pow2(8, k_grid=(k,)),
                           BatchPolicy(max_batch=8, max_wait=0.0),
                           probe=probe)
    for q in reqs:
        sched.submit(q, k)
        sched.run_until_idle()
    scored = probe.run_pending()
    text = reg.prometheus_text()
    sched.close()
    return probe.snapshot(), probe.recall(), scored, sampled, text


# ---------------------------------------------------------------------------
# The durability collectors on a world (the scrape is rank 0's, the log's
# writer)


def case_wal_scrape(n, X, centers, rows, root):
    """The reference suite's WalCollector script: a primary with a
    fsynced log on an injected clock, a follower a delete behind, one
    scrape, a catch-up, a second scrape; then a promotion counter: a
    follower over a fresh one-part log, a scrape, the primary's death on
    every rank and a poll, a scrape. Returns the four scrapes."""
    from raft_tpu_torch.comms.health import ShardHealth
    from raft_tpu_torch.lifecycle import (Follower, MutationLog,
                                          PromotionManager, recover)
    from raft_tpu_torch.obs import MetricsRegistry, WalCollector

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    index = _sharded_index(mesh, "flat", X, centers, N_LISTS, "list")
    clock = iter(np.arange(0.0, 100.0, 0.25))
    log = MutationLog(os.path.join(root, "a"), n_parts=2, fsync=True,
                      monotonic=lambda: float(next(clock)), mesh=mesh)
    log.snapshot(index, mesh)
    primary = _searcher(mesh, "flat", index, log)
    primary.delete(np.arange(16))
    primary.extend(rows)
    fidx, flog = recover(mesh, os.path.join(root, "a"), n_parts=2,
                         fsync=False)
    follower = Follower(_searcher(mesh, "flat", fidx, flog), flog)
    primary.delete(np.arange(16, 24))
    follower.poll()
    reg = MetricsRegistry()
    col = WalCollector(reg, log.stats, followers=[follower])
    texts = [reg.prometheus_text(), reg.prometheus_text()]
    follower.catch_up()
    texts.append(reg.prometheus_text())
    col.close()
    log.close()
    flog.close()

    log = MutationLog(os.path.join(root, "b"), n_parts=1, fsync=False,
                      mesh=mesh)
    log.snapshot(index, mesh)
    log.close()
    fidx, flog = recover(mesh, os.path.join(root, "b"), n_parts=1,
                         fsync=False)
    follower = Follower(_searcher(mesh, "flat", fidx, flog), flog)
    health = ShardHealth(n)
    mgr = PromotionManager(follower, health, primary_rank=0)
    reg = MetricsRegistry()
    WalCollector(reg, flog.stats, followers=[follower], promotion=mgr)
    texts.append(reg.prometheus_text())
    health.mark_dead(0)
    follower.poll()
    texts.append(reg.prometheus_text())
    mgr.close()
    flog.close()
    return texts
