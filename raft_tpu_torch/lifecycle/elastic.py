"""Elastic serving-set membership: live shard join / leave under one
epoch bump.

Port of ``raft_tpu/lifecycle/elastic.py``. The mesh stays fixed (the
``torch.distributed`` ranks of one job) but the SERVING set of shards of
a ``placement="list"`` index is elastic: :func:`join_shard` spreads lists
onto a shard that was idle, :func:`leave_shard` drains one before its
host is retired, both while the searcher keeps answering.

Mechanics (whole-list migration is the rebalance step):

1. re-pack the owner assignment over the post-resize ACTIVE shard set
   (``assign_lists(active=...)``, centroid-affinity packing, so probe
   locality survives the resize);
2. build the copy-on-write successor with
   :func:`~raft_tpu_torch.parallel.ivf.sharded_migrate_lists` (replicated
   lists keep a second live copy, re-placed off a leaver and off dead or
   SUSPECT ranks);
3. warm the successor's routed dispatch shapes against ``grid`` while
   the predecessor keeps serving
   (:func:`~raft_tpu_torch.parallel.ivf.sharded_routed_warmup`, with the
   routing and merge telemetry suppressed: warmup probes on the
   prospective placement must not feed the balancer or the scrape);
4. cut over under ONE published epoch bump (``Searcher.publish_index``),
   logging a ``migrate`` record when a mutation log is attached: a resize
   replays like any other mutation.

A leave is migrate-out then drop: the leaver takes part in the migration
collective (its rows are the ones moving) and only the published
successor stops routing to it.

SPMD: a resize is collective (every rank calls it with the same
arguments). The health gate (no silent revive: a dead or suspect shard
rejoins only after ``mark_live``) and the replica live mask are rank 0's
registry's, agreed before the migration, so a refused resize raises the
same error on every rank and a granted one moves the same lists
everywhere; the list weights (``_routed_sizes_h``) are one allgather,
the same on every rank.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.logger import logger

__all__ = ["ElasticReport", "ElasticStats", "elastic_stats",
           "serving_shards", "join_shard", "leave_shard"]


@dataclass(frozen=True)
class ElasticReport:
    """What one join / leave did (telemetry surface)."""

    action: str               # "join" | "leave"
    rank: int
    active_before: Tuple[int, ...]
    active_after: Tuple[int, ...]
    lists_moved: int
    warmed_shapes: int
    epoch: int                # the published successor's epoch


class ElasticStats:
    """Host-side join / leave counters for the metrics scrape
    (``obs.registry.ElasticCollector``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.joins = 0
        self.leaves = 0
        self.lists_moved = 0
        self.last_epoch = 0

    def record(self, report: ElasticReport) -> None:
        with self._lock:
            if report.action == "join":
                self.joins += 1
            else:
                self.leaves += 1
            self.lists_moved += report.lists_moved
            self.last_epoch = report.epoch

    def snapshot(self) -> dict:
        with self._lock:
            return dict(joins=self.joins, leaves=self.leaves,
                        lists_moved=self.lists_moved,
                        last_epoch=self.last_epoch)

    def reset(self) -> None:
        with self._lock:
            self.joins = self.leaves = self.lists_moved = 0
            self.last_epoch = 0


#: Process-wide elastic telemetry (the scrape adapter reads it).
elastic_stats = ElasticStats()


def serving_shards(index) -> Tuple[int, ...]:
    """The ACTIVE serving set: shards owning at least one list under the
    current placement (sorted ids)."""
    pm = index.placement_map
    expects(pm is not None, "elastic membership needs placement='list'")
    return tuple(int(s) for s in np.unique(pm.owner))


def _gate_and_live(health, rank: int, join: bool, n_dev: int) -> np.ndarray:
    """The health gate (no silent revive: re-admission is ``mark_live``'s
    explicit edge, serve/recovery.py) and the live mask the replicas are
    re-placed against: dead and SUSPECT ranks and a leaver are out (a
    replica parked on a straggler would strand the fault-tolerance copy
    where hedges already route away)."""
    if health is not None:
        expects(not join or health.state(rank) == "live",
                "shard %s is %s — re-admit it via mark_live (after "
                "recovery probes) before joining it back", rank,
                health.state(rank))
    live = np.ones(n_dev, bool)
    if health is not None:
        live &= np.asarray(health.live_mask, bool)
        live &= ~np.asarray(health.suspect_mask, bool)
        live[rank] = join   # the joiner is (checked) live; a leaver is out
    if not join:
        live[rank] = False
    if not live.any():
        live = np.ones(n_dev, bool)   # degenerate: keep the old rules
        if not join:
            live[rank] = False
    return live


def _resize(searcher, rank: int, join: bool, grid=None) -> ElasticReport:
    from raft_tpu_torch.comms.agree import agreed, root_value
    from raft_tpu_torch.comms.comms import Comms
    from raft_tpu_torch.comms.topk_merge import merge_dispatch_stats
    from raft_tpu_torch.parallel.ivf import (_routed_sizes_h,
                                             sharded_migrate_lists,
                                             sharded_routed_warmup)
    from raft_tpu_torch.parallel.routing import assign_lists, routing_stats

    expects(searcher.mesh is not None,
            "elastic join/leave needs a sharded searcher")
    searcher._require_writable()
    index = searcher._index
    pm = index.placement_map
    expects(pm is not None,
            "elastic join/leave needs placement='list' (row placement "
            "has no whole-list migration unit)")
    expects(0 <= rank < pm.n_dev,
            "rank %s outside the mesh's %s shards — the ranks of the job "
            "are fixed; elastic membership moves lists across them", rank,
            pm.n_dev)
    comms = Comms(searcher.mesh)
    live = None
    with agreed(comms):          # rank 0's registry decides for all
        if comms.get_rank() == 0:
            live = _gate_and_live(getattr(searcher, "health", None), rank,
                                  join, pm.n_dev)
    live = root_value(comms, live)
    before = set(serving_shards(index))
    active = set(before)
    if join:
        expects(rank not in active,
                "shard %s already serves lists — nothing to join", rank)
        active.add(rank)
    else:
        expects(rank in active,
                "shard %s serves no lists — nothing to leave", rank)
        active.discard(rank)
        expects(bool(active),
                "cannot drain the last serving shard %s", rank)

    base_epoch = int(index.epoch)
    weights = _routed_sizes_h(comms, index).astype(np.float64)
    centers = index.centers.cpu().numpy()
    new_owner = assign_lists(weights, pm.n_dev, centers=centers,
                             active=sorted(active))
    successor, n_moved = sharded_migrate_lists(searcher.mesh, index,
                                               new_owner, live_mask=live)

    # Warm the successor while the predecessor serves, with the
    # telemetry singletons suppressed (serve.bucketing.warmup's contract).
    warmed = 0
    if grid is not None:
        with contextlib.ExitStack() as stack:
            stack.enter_context(merge_dispatch_stats.suppress())
            stack.enter_context(routing_stats.suppress())
            for qb, kb in grid.shapes():
                warmed += sharded_routed_warmup(
                    searcher.mesh, searcher._params, successor, qb, kb,
                    merge_engine=searcher.merge_engine)

    # ONE published epoch bump cuts the whole resize over; the migrate
    # record makes it replayable (lifecycle/wal.py).
    searcher.publish_index(
        successor,
        record=("migrate", dict(owner=np.asarray(new_owner, np.int32),
                                live=live)),
        expect_base_epoch=base_epoch)
    report = ElasticReport(
        action="join" if join else "leave", rank=rank,
        active_before=tuple(sorted(before)),
        active_after=tuple(sorted(active)),
        lists_moved=n_moved, warmed_shapes=warmed,
        epoch=int(successor.epoch))
    elastic_stats.record(report)
    logger.debug("elastic %s: shard %s, %s lists moved, %s shapes "
                 "warmed, epoch %s", report.action, rank, n_moved,
                 warmed, report.epoch)
    return report


def join_shard(searcher, rank: int, grid=None) -> ElasticReport:
    """Bring ``rank`` into the serving set: migrate lists onto it
    (affinity-aware re-pack over the grown active set), warm the new
    routed shapes against ``grid`` (a
    :class:`~raft_tpu_torch.serve.bucketing.BucketGrid`; None skips the
    warmup), then cut over under one published epoch bump. Collective."""
    return _resize(searcher, rank, join=True, grid=grid)


def leave_shard(searcher, rank: int, grid=None) -> ElasticReport:
    """Drain ``rank`` out of the serving set: migrate its lists to the
    survivors (replicas re-placed off the leaver), warm, cut over. The
    rank stays in the mesh; after the publish no query routes to it.
    Collective."""
    return _resize(searcher, rank, join=False, grid=grid)
