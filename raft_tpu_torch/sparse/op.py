"""Element and structure ops over sparse matrices.

Port of ``raft_tpu/sparse/op.py`` (RAFT's ``sparse/op/{sort, filter,
reduce, slice, row_op}.hpp``). :func:`max_duplicates` and
:func:`remove_zeros` read one scalar each, the exact output size, as the
reference does; the duplicate sums add each (row, col) run in order
(:func:`types._segment_sum`).
"""

from __future__ import annotations

from typing import Callable

import torch

from raft_tpu_torch.sparse.types import (
    COO, CSR, _lexsort, _run_lengths, _segment_sum)


def coo_sort(coo: COO) -> COO:
    """Row-major (row, col) sort, stable."""
    order = _lexsort(coo.rows, coo.cols)
    return COO(coo.rows[order], coo.cols[order], coo.vals[order], coo.shape)


def max_duplicates(coo: COO) -> COO:
    """Merge duplicate (row, col) pairs, summing their values, and drop
    invalid entries (row < 0); the result is sorted by (row, col). The
    one scalar read sizes the output."""
    if coo.nnz == 0:
        return coo
    nnz = coo.nnz
    rows, cols, vals = coo.rows, coo.cols, coo.vals
    invalid = rows < 0
    # Stable by (invalid, row, col): valid entries first.
    order = _lexsort(rows, cols)
    order = order[torch.argsort(invalid[order].to(torch.uint8), stable=True)]
    r, c, v = rows[order], cols[order], vals[order]
    iv = invalid[order]
    first = torch.ones_like(iv)
    first[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    first &= ~iv
    k = int(first.sum())
    if k == 0:
        return COO(rows[:0], cols[:0], vals[:0], coo.shape)
    seg = torch.cumsum(first.long(), 0) - 1
    # Invalid entries sort last and add a zero to the last run.
    sums = _segment_sum(torch.where(iv, torch.zeros_like(v), v),
                        lengths=_run_lengths(first))
    dst = torch.where(first, seg, nnz)
    out_r = rows.new_full((nnz + 1,), -1).scatter_(0, dst, r)
    out_c = cols.new_full((nnz + 1,), -1).scatter_(0, dst, c)
    out_v = vals.new_zeros((nnz + 1,)).scatter_(0, dst, sums)
    return COO(out_r[:k], out_c[:k], out_v[:k], coo.shape)


def remove_zeros(coo: COO) -> COO:
    """Drop explicit zeros and invalid entries (row < 0), keeping the
    order of the rest; one scalar read sizes the output."""
    drop = (coo.vals == 0) | (coo.rows < 0)
    order = torch.argsort(drop.to(torch.uint8), stable=True)
    kept = int((~drop).sum())
    keep = order[:kept]
    return COO(coo.rows[keep], coo.cols[keep], coo.vals[keep], coo.shape)


def slice_csr(csr: CSR, start: int, stop: int) -> CSR:
    """Rows [start, stop): the two bounds are read to cut the entries."""
    lo, hi = csr.indptr[[start, stop]].tolist()
    new_ptr = (csr.indptr[start:stop + 1] - lo).int()
    return CSR(new_ptr, csr.indices[lo:hi], csr.vals[lo:hi],
               (stop - start, csr.shape[1]))


def csr_row_op(csr: CSR, fn: Callable) -> CSR:
    """``fn(row_ids, vals) -> vals`` over every entry in one pass."""
    return CSR(csr.indptr, csr.indices, fn(csr.row_ids(), csr.vals),
               csr.shape)
