"""Array layout predicates.

Port of ``raft_tpu/util/input_validation.py`` (``raft::is_row_major`` /
``is_col_major`` of ``util/input_validation.hpp``). numpy arrays answer by
their flags and torch tensors by their strides; other objects by a
``flags`` dict when they have one. One-dimensional arrays are both.
"""

from __future__ import annotations

import numpy as np
import torch


def _flag(x, name: str, default: bool) -> bool:
    if isinstance(x, np.ndarray):
        return bool(x.flags[name]) or x.ndim <= 1
    if isinstance(x, torch.Tensor):
        if x.ndim <= 1:
            return True
        if name == "F_CONTIGUOUS":
            x = x.permute(*reversed(range(x.ndim)))
        return x.is_contiguous()
    flags = getattr(x, "flags", None)
    if isinstance(flags, dict) and name in flags:
        return bool(flags[name]) or getattr(x, "ndim", 2) <= 1
    return default


def is_row_major(x) -> bool:
    """True for C-contiguous arrays and tensors (and for objects that
    report no layout)."""
    return _flag(x, "C_CONTIGUOUS", True)


def is_col_major(x) -> bool:
    """True for Fortran-contiguous arrays and tensors (a transposed view
    of a row-major matrix); objects that report no layout are
    column-major only when one-dimensional."""
    return _flag(x, "F_CONTIGUOUS", getattr(x, "ndim", 2) <= 1)
