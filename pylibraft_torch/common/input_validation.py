"""Input validation helpers, ref python/pylibraft/pylibraft/common/
input_validation.py (row/col-major checks over array interfaces).

The port's own copy of ``pylibraft/common/input_validation.py``: numpy
arrays are read through their flags, tensors through
``Tensor.is_contiguous()``.
"""

from __future__ import annotations

import numpy as np
import torch


def _shape_dtype(x):
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return tuple(x.shape), np.dtype(x.dtype)
    arr = np.asarray(x)
    return arr.shape, arr.dtype


def _f_contiguous(t: torch.Tensor) -> bool:
    """A tensor is column-major when its transpose is row-major."""
    return t.ndim <= 1 or t.permute(*reversed(range(t.ndim))).is_contiguous()


def is_c_contiguous(cai) -> bool:
    if isinstance(cai, torch.Tensor):
        return cai.is_contiguous()
    if hasattr(cai, "c_contiguous"):
        return bool(cai.c_contiguous)
    if isinstance(cai, np.ndarray):
        return cai.flags["C_CONTIGUOUS"]
    return True


def is_f_contiguous(cai) -> bool:
    if isinstance(cai, torch.Tensor):
        return _f_contiguous(cai)
    if isinstance(cai, np.ndarray):
        return cai.flags["F_CONTIGUOUS"]
    shape, _ = _shape_dtype(cai)
    return len(shape) <= 1


def do_cols_match(a, b) -> bool:
    sa, _ = _shape_dtype(a)
    sb, _ = _shape_dtype(b)
    return sa[1] == sb[1]


def do_rows_match(a, b) -> bool:
    sa, _ = _shape_dtype(a)
    sb, _ = _shape_dtype(b)
    return sa[0] == sb[0]


def do_shapes_match(a, b) -> bool:
    sa, _ = _shape_dtype(a)
    sb, _ = _shape_dtype(b)
    return sa == sb


def do_dtypes_match(a, b) -> bool:
    _, da = _shape_dtype(a)
    _, db = _shape_dtype(b)
    return da == db
