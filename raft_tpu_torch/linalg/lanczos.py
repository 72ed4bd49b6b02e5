"""The Lanczos eigensolver under its older ``linalg`` path, as in the
reference (``raft_tpu/linalg/lanczos.py``, a re-export of
:mod:`raft_tpu_torch.sparse.solver.lanczos`)."""

from raft_tpu_torch.sparse.solver.lanczos import (  # noqa: F401
    lanczos_largest_eigenpairs,
    lanczos_smallest_eigenpairs,
)

__all__ = ["lanczos_smallest_eigenpairs", "lanczos_largest_eigenpairs"]
