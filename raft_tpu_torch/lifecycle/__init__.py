"""Mutable index lifecycle for the IVF indexes: tombstone delete, upsert
and compaction.

Port of ``raft_tpu/lifecycle`` (``delete.py`` and ``compact.py``):

* :func:`delete` tombstones rows by id. Every scan engine folds the mask
  into its ``invalid`` operand (kernels B2 and B4 take it as is), so the
  results are exact over the survivors at once;
* :func:`upsert` tombstones and extends under one epoch bump;
* :func:`compact` builds a copy-on-write successor at ``epoch + 1`` that
  reclaims the tombstoned slots and, for IVF-Flat, can split overfull
  lists and recluster drifted ones (relabelled by kernel B1 on ``cuda``);
* :class:`Compactor` runs those passes over a serving ``Searcher``
  (``raft_tpu_torch/serve``) at a tombstone fraction or a drift signal,
  publishing each successor with one reference swap.

``delete``, ``upsert`` and ``compact`` also take a sharded IVF-Flat or
IVF-PQ index (row or list placement) with its ``mesh``; ``compact`` with
``balance_placement`` re-balances a list placement by observed load.

* :class:`MutationLog` / :func:`replay` / :func:`recover`: the durable
  write-ahead log (``wal.py``): every committed mutation of a sharded
  ``Searcher`` appends an epoch-stamped record before it publishes,
  periodic snapshots ride ``sharded_ivf_save``, and a crash replays the
  log tail over the newest snapshot;
* :class:`Follower` / :class:`PromotionManager`: read-only endpoints
  tailing the log; a primary loss promotes by catch-up, not rebuild;
* :func:`join_shard` / :func:`leave_shard`: elastic serving-set
  membership over a fixed mesh (``elastic.py``): whole-list migration
  re-packs the placement, the new routed shapes warm, one published
  epoch bump cuts over.
"""

from raft_tpu_torch.lifecycle.compact import (
    CompactionPolicy,
    CompactionReport,
    Compactor,
    compact,
)
from raft_tpu_torch.lifecycle.delete import (
    delete,
    enable_tombstones,
    tombstone_frac,
    upsert,
)
from raft_tpu_torch.lifecycle.elastic import (
    ElasticReport,
    ElasticStats,
    elastic_stats,
    join_shard,
    leave_shard,
    serving_shards,
)
from raft_tpu_torch.lifecycle.wal import (
    Follower,
    MutationLog,
    PromotionManager,
    WalCorruption,
    WalRecord,
    WalStats,
    apply_record,
    recover,
    replay,
)

__all__ = [
    "delete", "upsert", "enable_tombstones", "tombstone_frac",
    "compact", "CompactionPolicy", "CompactionReport", "Compactor",
    "MutationLog", "WalRecord", "WalStats", "WalCorruption",
    "apply_record", "replay", "recover", "Follower", "PromotionManager",
    "ElasticReport", "ElasticStats", "elastic_stats",
    "join_shard", "leave_shard", "serving_shards",
]
