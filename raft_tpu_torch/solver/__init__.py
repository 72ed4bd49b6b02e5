"""Combinatorial solvers: the batched linear assignment problem (the port
of ``raft_tpu/solver``)."""

from raft_tpu_torch.solver.linear_assignment import LinearAssignmentProblem, lap

__all__ = ["LinearAssignmentProblem", "lap"]
