"""The legacy ``raft::spatial`` namespace (the port of
``raft_tpu/spatial``): aliases that forward to
:mod:`raft_tpu_torch.neighbors`."""

from raft_tpu_torch.spatial import knn

__all__ = ["knn"]
