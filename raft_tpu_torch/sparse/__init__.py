"""Sparse formats, ops, distances, kNN and graph solvers: the port of
``raft_tpu/sparse``."""

from raft_tpu_torch.sparse.types import COO, CSR
from raft_tpu_torch.sparse import convert
from raft_tpu_torch.sparse import op
from raft_tpu_torch.sparse import linalg
from raft_tpu_torch.sparse import distance
from raft_tpu_torch.sparse import neighbors
from raft_tpu_torch.sparse import solver

__all__ = ["COO", "CSR", "convert", "op", "linalg", "distance",
           "neighbors", "solver"]
