"""Clustering: balanced hierarchical k-means and k-means++ seeding. Lloyd
k-means and single linkage come in later slices."""

from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.cluster import kmeans
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans import init_plus_plus

__all__ = ["KMeansBalancedParams", "kmeans", "kmeans_balanced",
           "init_plus_plus"]
