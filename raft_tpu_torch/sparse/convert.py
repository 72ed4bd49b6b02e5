"""Format conversions.

Port of ``raft_tpu/sparse/convert.py`` (RAFT's
``sparse/convert/{coo,csr,dense}.hpp``).
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.resources import DeviceLike
from raft_tpu_torch.sparse.types import (
    COO, CSR, coo_from_dense, csr_from_dense)


def coo_to_csr(coo: COO) -> CSR:
    """COO -> CSR; rows need not be sorted (a stable sort groups them). As
    in the reference, an invalid entry (row < 0) is counted in row 0."""
    order = torch.argsort(coo.rows, stable=True)
    rows = coo.rows[order]
    counts = torch.bincount(torch.clamp_min(rows, 0).long(),
                            minlength=coo.shape[0])[:coo.shape[0]]
    indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).int()
    return CSR(indptr, coo.cols[order], coo.vals[order], coo.shape)


def csr_to_coo(csr: CSR) -> COO:
    return COO(csr.row_ids(), csr.indices, csr.vals, csr.shape)


def dense_to_coo(a, device: DeviceLike = None) -> COO:
    return coo_from_dense(a, device=device)


def dense_to_csr(a, device: DeviceLike = None) -> CSR:
    return csr_from_dense(a, device=device)


def coo_to_dense(coo: COO) -> torch.Tensor:
    return coo.to_dense()


def csr_to_dense(csr: CSR) -> torch.Tensor:
    return csr.to_dense()
