"""Sparse graph solvers: the minimum spanning forest and the Lanczos
eigensolver (the port of ``raft_tpu/sparse/solver``)."""

from raft_tpu_torch.sparse.solver.mst import Graph_COO, mst
from raft_tpu_torch.sparse.solver.lanczos import (
    lanczos_largest_eigenpairs,
    lanczos_smallest_eigenpairs,
)

__all__ = ["Graph_COO", "mst", "lanczos_smallest_eigenpairs",
           "lanczos_largest_eigenpairs"]
