"""Matrix op broadcast vector.

Port of ``raft_tpu/linalg/matrix_vector.py`` (RAFT's
``matrix_vector_op.cuh``): a binary (or ternary) op between each row (or
column) of a matrix and a vector.
"""

from __future__ import annotations

from typing import Callable

from raft_tpu_torch.core.mdarray import as_array


def matrix_vector_op(matrix, vec, op: Callable, along_rows: bool = True,
                     vec2=None):
    """``op(matrix_element, vec_element[, vec2_element])``, with ``vec``
    indexed by column (``along_rows``, length n_cols) or by row."""
    m = as_array(matrix)
    v = as_array(vec, device=m.device)
    v = v[None, :] if along_rows else v[:, None]
    if vec2 is None:
        return op(m, v)
    v2 = as_array(vec2, device=m.device)
    v2 = v2[None, :] if along_rows else v2[:, None]
    return op(m, v, v2)
