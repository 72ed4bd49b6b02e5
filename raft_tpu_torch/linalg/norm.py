"""Row / column norms and normalization.

Port of ``raft_tpu/linalg/norm.py`` (RAFT's ``norm.cuh`` and
``normalize.cuh``). As there, ``L2Norm`` is the *squared* L2 norm unless
a square-root ``fin_op`` is given.
"""

from __future__ import annotations

import enum
from typing import Callable

import torch

from raft_tpu_torch.core import operators as ops
from raft_tpu_torch.core.mdarray import as_array


class NormType(enum.Enum):
    """``raft::linalg::NormType``."""

    L1Norm = 0
    L2Norm = 1
    LinfNorm = 2


L1Norm = NormType.L1Norm
L2Norm = NormType.L2Norm
LinfNorm = NormType.LinfNorm


def norm(x, norm_type: NormType = L2Norm, axis: int = 1,
         fin_op: Callable = ops.identity_op):
    """The norm along ``axis``, then ``fin_op``."""
    x = as_array(x)
    if norm_type == NormType.L1Norm:
        r = torch.sum(torch.abs(x), dim=axis)
    elif norm_type == NormType.L2Norm:
        r = torch.sum(x * x, dim=axis)
    elif norm_type == NormType.LinfNorm:
        r = torch.amax(torch.abs(x), dim=axis)
    else:  # pragma: no cover
        raise ValueError(f"unknown norm type {norm_type}")
    return fin_op(r)


def row_norm(x, norm_type: NormType = L2Norm,
             fin_op: Callable = ops.identity_op):
    """Per-row norm."""
    return norm(x, norm_type, axis=1, fin_op=fin_op)


def col_norm(x, norm_type: NormType = L2Norm,
             fin_op: Callable = ops.identity_op):
    """Per-column norm."""
    return norm(x, norm_type, axis=0, fin_op=fin_op)


def normalize(x, norm_type: NormType = L2Norm, eps: float = 1e-8):
    """Each row divided by its norm (the true, square-rooted L2 norm for
    ``L2Norm``); rows whose norm is below ``eps`` are left as they are."""
    x = as_array(x)
    fin = ops.sqrt_op if norm_type == NormType.L2Norm else ops.identity_op
    n = norm(x, norm_type, axis=1, fin_op=fin)
    n = torch.where(n < eps, torch.ones_like(n), n)
    return x / n[:, None]
