"""Multi-rank algorithms over a ``torch.distributed`` process group.

Port of ``raft_tpu/parallel`` (the raft-dask + cuML multi-node pattern:
shard the data over ranks, combine with the comms collectives). Every
entry point is collective: each rank of the :class:`~raft_tpu_torch.comms.
comms.Mesh` calls it with the same arguments, works on its own shard on
its own device, and gets the same replicated result with global ids.

Sharded brute force, k-means, IVF-Flat and IVF-PQ on the row placement
and on the list placement with its router (``routing``), list migration
and replication, the routed warmup, and crash-safe snapshots
(``sharded_ivf_save`` / ``sharded_ivf_load`` with a CRC manifest).
"""

from raft_tpu_torch.comms.comms import Mesh, make_mesh
from raft_tpu_torch.parallel.degraded import check_live_mask, neutralize_dead
from raft_tpu_torch.parallel.ivf import (
    ShardedIvfFlat,
    ShardedIvfPq,
    sharded_ivf_flat_build,
    sharded_ivf_flat_extend,
    sharded_ivf_flat_search,
    sharded_ivf_load,
    sharded_ivf_pq_build,
    sharded_ivf_pq_extend,
    sharded_ivf_pq_search,
    sharded_ivf_save,
    sharded_migrate_lists,
    sharded_replicate_lists,
    sharded_routed_warmup,
    verify_sharded_manifest,
)
from raft_tpu_torch.parallel.kmeans import (
    sharded_kmeans_balanced_fit,
    sharded_kmeans_fit,
    sharded_kmeans_step,
)
from raft_tpu_torch.parallel.knn import RowShard, shard_database, sharded_knn
from raft_tpu_torch.parallel.routing import (
    ListPlacement,
    RoutePlan,
    RoutingStats,
    assign_lists,
    build_placement,
    participant_ranks,
    plan_route,
    route_shapes,
    routing_stats,
)

__all__ = [
    "Mesh", "make_mesh", "RowShard",
    "sharded_knn", "shard_database", "check_live_mask", "neutralize_dead",
    "sharded_kmeans_fit", "sharded_kmeans_step",
    "sharded_kmeans_balanced_fit",
    "ShardedIvfFlat", "ShardedIvfPq",
    "sharded_ivf_flat_build", "sharded_ivf_flat_search",
    "sharded_ivf_pq_build", "sharded_ivf_pq_search",
    "sharded_ivf_flat_extend", "sharded_ivf_pq_extend",
    "sharded_ivf_save", "sharded_ivf_load", "verify_sharded_manifest",
    "sharded_migrate_lists", "sharded_replicate_lists",
    "sharded_routed_warmup",
    "ListPlacement", "RoutePlan", "RoutingStats", "assign_lists",
    "build_placement", "participant_ranks", "plan_route", "route_shapes",
    "routing_stats",
]
