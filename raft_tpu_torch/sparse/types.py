"""COO / CSR sparse containers.

Port of ``raft_tpu/sparse/types.py``: frozen dataclasses over the tensors
they are given, with the reference's fields, ``shape``, ``nnz``,
``row_ids()`` and ``to_dense()``. Index tensors are int32 (rows, cols,
indptr, indices), widened to int64 only where they index. A COO entry
with row -1 is invalid: ``to_dense`` drops it.

:func:`coo_from_dense` and :func:`csr_from_dense` build from a dense
matrix on its device when it is a tensor, else on ``device`` (``cuda`` by
default), as :func:`core.mdarray.as_array` places inputs.

:func:`_segment_sum` is the layer's sum over contiguous segments (CSR
rows, runs of a sorted key): ``torch.segment_reduce``, which adds each
segment in order on one thread, so a sum repeats bit for bit on the card
where ``index_add_``'s atomics would not. Integer values, which it does
not take, are summed by ``index_add_`` (integer adds are exact in any
order).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import as_array
from raft_tpu_torch.core.resources import DeviceLike


@dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix (``raft::sparse::COO``)."""

    rows: torch.Tensor   # (nnz,) int32
    cols: torch.Tensor   # (nnz,) int32
    vals: torch.Tensor   # (nnz,)
    shape: Tuple[int, int]

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))

    @property
    def nnz(self) -> int:
        return self.rows.shape[0]

    def to_dense(self) -> torch.Tensor:
        """Densify; duplicates add, invalid entries (row < 0) are
        dropped."""
        m, n = self.shape
        out = torch.zeros((m, n), dtype=self.vals.dtype,
                          device=self.vals.device)
        ok = self.rows >= 0
        r = torch.where(ok, self.rows, 0).long()
        c = torch.where(ok, self.cols, 0).long()
        v = torch.where(ok, self.vals, torch.zeros_like(self.vals))
        return out.index_put_((r, c), v, accumulate=True)


@dataclass(frozen=True)
class CSR:
    """Compressed-sparse-row matrix (``raft::sparse::CSR``)."""

    indptr: torch.Tensor   # (m+1,) int32
    indices: torch.Tensor  # (nnz,) int32
    vals: torch.Tensor     # (nnz,)
    shape: Tuple[int, int]

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]

    def row_ids(self) -> torch.Tensor:
        """Each entry's row (int32): indptr expanded."""
        m = self.shape[0]
        counts = torch.diff(self.indptr).long()
        return torch.repeat_interleave(
            torch.arange(m, dtype=torch.int32, device=self.indptr.device),
            counts, output_size=self.nnz)

    def to_dense(self) -> torch.Tensor:
        m, n = self.shape
        out = torch.zeros((m, n), dtype=self.vals.dtype,
                          device=self.vals.device)
        return out.index_put_((self.row_ids().long(), self.indices.long()),
                              self.vals, accumulate=True)


def _segment_sum(data: torch.Tensor, offsets: Optional[torch.Tensor] = None,
                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sums of consecutive segments of ``data`` along dim 0, each added in
    order: ``offsets`` (n_seg + 1 bounds) or ``lengths`` (n_seg sizes,
    zeros allowed; they must cover ``data``). An empty segment sums to
    0."""
    if offsets is not None:
        offsets = offsets.long()
        n_seg = offsets.shape[0] - 1
    else:
        lengths = lengths.long()
        n_seg = lengths.shape[0]
    if data.is_floating_point():
        if n_seg == 0:
            return data.new_zeros((0,) + tuple(data.shape[1:]))
        return torch.segment_reduce(data, "sum", offsets=offsets,
                                    lengths=lengths, axis=0)
    if lengths is None:
        lengths = torch.diff(offsets)
    seg = torch.repeat_interleave(
        torch.arange(n_seg, device=data.device), lengths,
        output_size=data.shape[0])
    out = data.new_zeros((n_seg,) + tuple(data.shape[1:]))
    return out.index_add_(0, seg, data)


def _run_lengths(first: torch.Tensor) -> torch.Tensor:
    """For flags marking the first entry of each run of a sorted array:
    the run's length at its first entry, 0 elsewhere (the ``lengths`` of
    :func:`_segment_sum` that put each run's sum at its first entry)."""
    gid = torch.cumsum(first.long(), 0) - 1
    size = torch.bincount(gid.clamp_min(0), minlength=first.shape[0])
    return torch.where(first, size[gid.clamp_min(0)], 0)


def _lexsort(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """The stable order by (primary, secondary): ``np.lexsort((secondary,
    primary))``."""
    order = torch.argsort(secondary, stable=True)
    return order[torch.argsort(primary[order], stable=True)]


def _nonzero_entries(a, keep_zeros: bool, device: DeviceLike):
    a = as_array(a, device=device)
    expects(a.ndim == 2, "dense input must be a matrix")
    if keep_zeros:
        r, c = torch.meshgrid(torch.arange(a.shape[0], device=a.device),
                              torch.arange(a.shape[1], device=a.device),
                              indexing="ij")
        r, c = r.reshape(-1), c.reshape(-1)
    else:
        r, c = torch.nonzero(a, as_tuple=True)
    return a, r, c


def coo_from_dense(a, keep_zeros: bool = False,
                   device: DeviceLike = None) -> COO:
    """Dense -> COO in row-major order (``keep_zeros`` keeps every
    entry)."""
    a, r, c = _nonzero_entries(a, keep_zeros, device)
    return COO(r.int(), c.int(), a[r, c], tuple(a.shape))


def csr_from_dense(a, keep_zeros: bool = False,
                   device: DeviceLike = None) -> CSR:
    """Dense -> CSR."""
    a, r, c = _nonzero_entries(a, keep_zeros, device)
    counts = torch.bincount(r, minlength=a.shape[0])
    indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).int()
    return CSR(indptr, c.int(), a[r, c], tuple(a.shape))
