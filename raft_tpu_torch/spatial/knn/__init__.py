"""Legacy ``raft::spatial::knn`` aliases (the port of
``raft_tpu/spatial/knn``): the pre-``raft::neighbors`` spellings, each
bound to the port's own function or module.
"""

from raft_tpu_torch.neighbors.ball_cover import (
    BallCoverIndex,
    all_knn_query as rbc_all_knn_query,
    build_index as rbc_build_index,
    eps_nn as rbc_eps_nn,
    knn_query as rbc_knn_query,
)
from raft_tpu_torch.neighbors.brute_force import (
    fused_l2_knn,
    knn as brute_force_knn,
    knn_merge_parts,
)
from raft_tpu_torch.neighbors.epsilon_neighborhood import (
    eps_neighbors_l2sq as epsUnexpL2SqNeighborhood,
)
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

__all__ = [
    "BallCoverIndex",
    "rbc_all_knn_query",
    "rbc_build_index",
    "rbc_eps_nn",
    "rbc_knn_query",
    "fused_l2_knn",
    "brute_force_knn",
    "knn_merge_parts",
    "epsUnexpL2SqNeighborhood",
    "ivf_flat",
    "ivf_pq",
]
