"""Spectral graph partitioning and analysis (the port of
``raft_tpu/spectral``)."""

from raft_tpu_torch.spectral.partition import (
    EigenSolverConfig,
    ClusterSolverConfig,
    partition,
    analyze_partition,
    modularity_maximization,
    analyze_modularity,
)

__all__ = [
    "EigenSolverConfig", "ClusterSolverConfig", "partition",
    "analyze_partition", "modularity_maximization", "analyze_modularity",
]
