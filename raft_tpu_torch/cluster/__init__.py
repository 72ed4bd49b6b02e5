"""Clustering: Lloyd k-means, balanced hierarchical k-means and single
linkage."""

from raft_tpu_torch.cluster.kmeans_types import (
    InitMethod,
    KMeansParams,
    KMeansBalancedParams,
)
from raft_tpu_torch.cluster import kmeans
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.single_linkage import (
    LinkageDistance,
    LinkageOutput,
    single_linkage,
)
from raft_tpu_torch.cluster.kmeans import (
    fit,
    predict,
    fit_predict,
    transform,
    cluster_cost,
    min_cluster_and_distance,
    min_cluster_distance,
    update_centroids,
    compute_new_centroids,
    init_plus_plus,
    init_random,
    sample_centroids,
    find_k,
)

__all__ = [
    "InitMethod", "KMeansParams", "KMeansBalancedParams",
    "kmeans", "kmeans_balanced",
    "fit", "predict", "fit_predict", "transform", "cluster_cost",
    "min_cluster_and_distance", "min_cluster_distance", "update_centroids",
    "compute_new_centroids", "init_plus_plus", "init_random",
    "sample_centroids", "find_k",
    "LinkageDistance", "LinkageOutput", "single_linkage",
]
