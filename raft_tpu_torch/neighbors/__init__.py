"""Nearest-neighbor search: brute force, IVF-Flat, IVF-PQ and refine.
Ball cover and the epsilon neighborhood come in a later slice.

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
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.neighbors.refine import refine

__all__ = [
    "IndexParams", "SearchParams",
    "brute_force", "knn", "fused_l2_knn", "knn_merge_parts",
    "tiled_brute_force_knn",
    "ivf_flat", "ivf_pq", "refine",
]
