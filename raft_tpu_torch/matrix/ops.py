"""Matrix utilities.

Port of ``raft_tpu/matrix/ops.py`` (RAFT's ``argmax.cuh``, ``argmin.cuh``,
``gather.cuh``, ``slice.cuh``, ``copy.cuh``, ``init.cuh``, ``reverse.cuh``,
``sign_flip``, ``linewise_op.cuh``, ``col_wise_sort.cuh``,
``triangular.cuh``, ``shift`` and ``norm.cuh``). Indices come back as
int32, as in the reference; ``argmin`` / ``argmax`` take the first index
on ties, and ``col_wise_sort`` is stable.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch.core.mdarray import as_array, torch_dtype
from raft_tpu_torch.core.resources import DeviceLike, resolve_device


def argmax(x, axis: int = 1) -> torch.Tensor:
    """Per-row (``axis=1``) arg-max, the first index on ties."""
    return torch.argmax(as_array(x), dim=axis).to(torch.int32)


def argmin(x, axis: int = 1) -> torch.Tensor:
    """Per-row (``axis=1``) arg-min, the first index on ties."""
    return torch.argmin(as_array(x), dim=axis).to(torch.int32)


def gather(matrix, indices, map_transform: Optional[Callable] = None
           ) -> torch.Tensor:
    """The rows of ``matrix`` at ``indices`` (after ``map_transform``)."""
    m = as_array(matrix)
    idx = as_array(indices, device=m.device).to(torch.int32)
    if map_transform is not None:
        idx = map_transform(idx)
    return m[idx.long()]


def gather_if(matrix, indices, stencil, pred_op: Callable, fallback=0.0
              ) -> torch.Tensor:
    """:func:`gather`, with ``fallback`` rows where ``pred_op(stencil)``
    is false."""
    m = as_array(matrix)
    idx = as_array(indices, device=m.device).long()
    mask = pred_op(as_array(stencil, device=m.device))
    return torch.where(mask[:, None], m[idx],
                       torch.tensor(fallback, dtype=m.dtype, device=m.device))


def scatter(matrix, indices, rows) -> torch.Tensor:
    """A copy of ``matrix`` with ``rows`` written at ``indices``."""
    out = as_array(matrix).clone()
    out[as_array(indices, device=out.device).long()] = as_array(
        rows, device=out.device).to(out.dtype)
    return out


def slice(matrix, row0: int, col0: int, row1: int,  # noqa: A001
          col1: int) -> torch.Tensor:
    """The submatrix ``[row0, row1) x [col0, col1)`` (a view)."""
    return as_array(matrix)[row0:row1, col0:col1]


def copy(matrix) -> torch.Tensor:
    """A materialized copy."""
    return as_array(matrix).clone()


def init(shape, value, dtype=torch.float32,
         device: DeviceLike = None) -> torch.Tensor:
    """A constant-filled matrix on ``device`` (``cuda`` by default)."""
    return torch.full(tuple(shape), value, dtype=torch_dtype(dtype),
                      device=resolve_device(device))


def reverse(matrix, along_rows: bool = True) -> torch.Tensor:
    """Each row reversed (``along_rows``), or the order of the rows."""
    return torch.flip(as_array(matrix), dims=(1,) if along_rows else (0,))


def sign_flip(matrix) -> torch.Tensor:
    """Columns sign-flipped so each one's largest-magnitude entry is
    positive (to make eigenvectors canonical)."""
    m = as_array(matrix)
    idx = torch.argmax(torch.abs(m), dim=0)
    signs = torch.sign(m[idx, torch.arange(m.shape[1], device=m.device)])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return m * signs[None, :]


def linewise_op(matrix, vecs, op: Callable, along_lines: bool = True
                ) -> torch.Tensor:
    """``op(matrix, *vecs)`` with each vector broadcast along the rows
    (``along_lines``: indexed by column) or the columns."""
    m = as_array(matrix)
    if not isinstance(vecs, (list, tuple)):
        vecs = (vecs,)
    vs = [as_array(v, device=m.device) for v in vecs]
    return op(m, *(v[None, :] if along_lines else v[:, None] for v in vs))


def col_wise_sort(matrix, return_indices: bool = False):
    """Each column sorted ascending (stable; NaN last), with the int32
    source rows when ``return_indices``."""
    m = as_array(matrix)
    s, idx = torch.sort(m, dim=0, stable=True)
    return (s, idx.to(torch.int32)) if return_indices else s


def triangular_upper(matrix) -> torch.Tensor:
    """The upper-triangular part."""
    return torch.triu(as_array(matrix))


def shift_fill(matrix, k: int, fill_value=0.0) -> torch.Tensor:
    """The columns shifted by ``k`` (right when positive), the vacated
    columns filled with ``fill_value``."""
    m = as_array(matrix)
    n = m.shape[1]
    shifted = torch.roll(m, k, dims=1)
    col = torch.arange(n, device=m.device)[None, :]
    vacated = col < k if k >= 0 else col >= n + k
    return torch.where(vacated, torch.tensor(fill_value, dtype=m.dtype,
                                             device=m.device), shifted)


def l2_norm(x) -> torch.Tensor:
    """The Frobenius (L2) norm of the whole matrix, in f32."""
    x = as_array(x).float()
    return torch.sqrt(torch.sum(x * x))
