"""Multi-rank algorithms over a ``torch.distributed`` process group.

Port of ``raft_tpu/parallel`` (the raft-dask + cuML multi-node pattern:
shard the data over ranks, combine with the comms collectives). Every
entry point is collective: each rank of the :class:`~raft_tpu_torch.comms.
comms.Mesh` calls it with the same arguments, works on its own shard on
its own device, and gets the same replicated result with global ids.

This slice has sharded brute force, k-means and row-placed IVF-Flat; the
list placement and its router, sharded IVF-PQ, sharded save / load,
migrate / replicate and routed warmup wait for ROADMAP A.4b.
"""

from raft_tpu_torch.comms.comms import Mesh, make_mesh
from raft_tpu_torch.parallel.degraded import check_live_mask, neutralize_dead
from raft_tpu_torch.parallel.ivf import (
    ShardedIvfFlat,
    sharded_ivf_flat_build,
    sharded_ivf_flat_extend,
    sharded_ivf_flat_search,
)
from raft_tpu_torch.parallel.kmeans import (
    sharded_kmeans_balanced_fit,
    sharded_kmeans_fit,
    sharded_kmeans_step,
)
from raft_tpu_torch.parallel.knn import RowShard, shard_database, sharded_knn

__all__ = [
    "Mesh", "make_mesh", "RowShard",
    "sharded_knn", "shard_database", "check_live_mask", "neutralize_dead",
    "sharded_kmeans_fit", "sharded_kmeans_step",
    "sharded_kmeans_balanced_fit",
    "ShardedIvfFlat", "sharded_ivf_flat_build", "sharded_ivf_flat_search",
    "sharded_ivf_flat_extend",
]
