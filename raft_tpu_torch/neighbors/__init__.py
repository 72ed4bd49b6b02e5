"""Nearest-neighbor search: brute force, IVF-Flat, IVF-PQ, refine, ball
cover and the epsilon neighborhood.

``refine`` is the function; import its module with
``importlib.import_module("raft_tpu_torch.neighbors.refine")``.
"""

from raft_tpu_torch.neighbors.ann_types import IndexParams, SearchParams
from raft_tpu_torch.neighbors import brute_force
from raft_tpu_torch.neighbors.brute_force import (
    fused_l2_knn,
    knn,
    knn_merge_parts,
    tiled_brute_force_knn,
)
from raft_tpu_torch.neighbors import ball_cover
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.neighbors.ball_cover import BallCoverIndex
from raft_tpu_torch.neighbors.refine import refine
from raft_tpu_torch.neighbors.epsilon_neighborhood import eps_neighbors_l2sq

__all__ = [
    "IndexParams", "SearchParams",
    "BallCoverIndex", "ball_cover",
    "brute_force", "knn", "fused_l2_knn", "knn_merge_parts",
    "tiled_brute_force_knn",
    "ivf_flat", "ivf_pq", "refine", "eps_neighbors_l2sq",
]
