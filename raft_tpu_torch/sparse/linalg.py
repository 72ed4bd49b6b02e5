"""Sparse linear algebra.

Port of ``raft_tpu/sparse/linalg.py`` (RAFT's ``sparse/linalg/{add,
degree, norm, symmetrize, transpose, spectral}.hpp`` and the cuSPARSE
SpMV / SpMM wrappers). SpMV and SpMM gather ``x`` at each entry's column
and add each CSR row's products in order (:func:`types._segment_sum`), so
two runs on the card agree bit for bit; so do the row sums of the
normalisations and the Laplacian's degrees.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.sparse import convert
from raft_tpu_torch.sparse import op as sparse_op
from raft_tpu_torch.sparse.types import COO, CSR, _segment_sum


def spmv(a: CSR, x: torch.Tensor) -> torch.Tensor:
    """y = A x."""
    return _segment_sum(a.vals * x[a.indices.long()], offsets=a.indptr)


def spmm(a: CSR, b: torch.Tensor) -> torch.Tensor:
    """Y = A B for a dense B."""
    return _segment_sum(a.vals[:, None] * b[a.indices.long()],
                        offsets=a.indptr)


def add(a: CSR, b: CSR) -> CSR:
    """C = A + B: the entries of both, duplicates summed
    (:func:`op.max_duplicates`)."""
    coo_a = convert.csr_to_coo(a)
    coo_b = convert.csr_to_coo(b)
    merged = COO(torch.cat([coo_a.rows, coo_b.rows]),
                 torch.cat([coo_a.cols, coo_b.cols]),
                 torch.cat([coo_a.vals, coo_b.vals]), a.shape)
    return convert.coo_to_csr(sparse_op.max_duplicates(merged))


def transpose(a: CSR) -> CSR:
    """A^T."""
    coo = convert.csr_to_coo(a)
    t = COO(coo.cols, coo.rows, coo.vals, (a.shape[1], a.shape[0]))
    return convert.coo_to_csr(sparse_op.coo_sort(t))


def degree(coo: COO) -> torch.Tensor:
    """Per-row counts of valid entries (int32)."""
    ok = (coo.rows >= 0).int()
    out = torch.zeros(coo.shape[0], dtype=torch.int32, device=ok.device)
    return out.index_add_(0, torch.clamp_min(coo.rows, 0).long(), ok)


def row_normalize_l1(a: CSR) -> CSR:
    """Rows scaled to unit L1 norm (empty and zero rows kept)."""
    sums = _segment_sum(torch.abs(a.vals), offsets=a.indptr)
    denom = torch.where(sums > 0, sums, 1.0)
    return CSR(a.indptr, a.indices, a.vals / denom[a.row_ids().long()],
               a.shape)


def row_normalize_max(a: CSR) -> CSR:
    """Rows scaled by their largest |value|."""
    maxs = torch.segment_reduce(torch.abs(a.vals), "max",
                                offsets=a.indptr.long(), axis=0)
    denom = torch.where(maxs > 0, maxs, 1.0)
    return CSR(a.indptr, a.indices, a.vals / denom[a.row_ids().long()],
               a.shape)


def symmetrize(coo: COO) -> COO:
    """B = (A + A^T) / 2 over the union of the two patterns."""
    rows = torch.cat([coo.rows, coo.cols])
    cols = torch.cat([coo.cols, coo.rows])
    vals = torch.cat([coo.vals, coo.vals]) * 0.5
    return sparse_op.max_duplicates(COO(rows, cols, vals, coo.shape))


def laplacian(adj: CSR, normalized: bool = False) -> CSR:
    """L = D - A, or I - D^-1/2 A D^-1/2 when ``normalized``."""
    coo = convert.csr_to_coo(adj)
    deg = _segment_sum(coo.vals, offsets=adj.indptr)
    n = adj.shape[0]
    if normalized:
        dinv = 1.0 / torch.sqrt(torch.where(deg > 0, deg, 1.0))
        off_vals = -coo.vals * dinv[coo.rows.long()] * dinv[coo.cols.long()]
        diag_vals = torch.ones(n, dtype=coo.vals.dtype,
                               device=coo.vals.device)
    else:
        off_vals = -coo.vals
        diag_vals = deg
    diag = torch.arange(n, dtype=torch.int32, device=coo.rows.device)
    merged = sparse_op.max_duplicates(COO(
        torch.cat([coo.rows, diag]), torch.cat([coo.cols, diag]),
        torch.cat([off_vals, diag_vals]), (n, n)))
    return convert.coo_to_csr(merged)
