"""Typed array views, validation and the neighbor-id dtypes.

Port of ``raft_tpu/core/mdarray.py``. The owning container is a
``torch.Tensor``; what the reference's ``mdspan`` / ``mdarray`` contract
leaves is the up-front check of dtype, rank and extents
(:class:`ArraySpec`, :func:`check_matrix`, :func:`check_vector`), the
``make_*`` factories and the memory and layout vocabularies.

:func:`as_array` follows the port's rule for entry points: a tensor stays
where it is; anything else goes to ``device`` (``cuda`` by default), and
float64 maps to float32 as the reference's ``jnp.asarray`` maps it with
x64 off.

The neighbor-id dtype knob (:func:`validate_idx_dtype`) takes int32 or
int64; a torch tensor holds int64 as it is, so the reference's x64
condition has no counterpart here.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import DeviceLike, as_vectors, resolve_device
from raft_tpu_torch.util.input_validation import is_row_major as _is_row_major

_ID_DTYPES = (torch.int32, torch.int64)


def torch_dtype(dtype) -> torch.dtype:
    """``dtype`` (a torch dtype, a numpy dtype, a Python type or a name) as
    a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and isinstance(getattr(torch, dtype, None),
                                             torch.dtype):
        return getattr(torch, dtype)
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


class MemoryType(enum.Enum):
    """Memory kinds (``raft::memory_type``): ``device`` is the card's
    memory, ``host`` and ``pinned`` the host's; ``managed`` is kept for
    parity with the enum."""

    host = 0
    device = 1
    managed = 2
    pinned = 3


class Layout(enum.Enum):
    """Row- and column-major layouts (``layout_c_contiguous`` /
    ``layout_f_contiguous``)."""

    row_major = 0
    col_major = 1


row_major = Layout.row_major
col_major = Layout.col_major


@dataclass(frozen=True)
class ArraySpec:
    """A typed-view contract: dtype and rank, and optionally extents
    (None for any). :meth:`validate` raises ``LogicError`` on a
    mismatch."""

    dtype: Optional[object] = None
    ndim: Optional[int] = None
    shape: Optional[Tuple[Optional[int], ...]] = None

    def validate(self, x, name: str = "array") -> None:
        if self.dtype is not None:
            expects(torch_dtype(x.dtype) == torch_dtype(self.dtype),
                    "%s: expected dtype %s, got %s", name, self.dtype,
                    x.dtype)
        if self.ndim is not None:
            expects(x.ndim == self.ndim, "%s: expected rank %s, got %s",
                    name, self.ndim, x.ndim)
        if self.shape is not None:
            expects(len(self.shape) == x.ndim, "%s: rank mismatch", name)
            for i, (want, got) in enumerate(zip(self.shape, x.shape)):
                if want is not None:
                    expects(want == got, "%s: extent %s expected %s, got %s",
                            name, i, want, got)


def as_array(x, dtype=None, device: DeviceLike = None) -> torch.Tensor:
    """Any array-like as a tensor: tensors stay where they are (zero
    copy), the rest go to ``device`` (``cuda`` by default); float64 maps
    to float32 unless ``dtype`` asks for something else."""
    t = as_vectors(x, device=device)
    return t if dtype is None else t.to(torch_dtype(dtype))


def check_matrix(x, name: str = "matrix", dtype=None,
                 rows: Optional[int] = None, cols: Optional[int] = None,
                 device: DeviceLike = None) -> torch.Tensor:
    """:func:`as_array`, validated as a rank-2 input."""
    arr = as_array(x, device=device)
    ArraySpec(dtype=dtype, ndim=2, shape=(rows, cols)).validate(arr, name)
    return arr


def check_vector(x, name: str = "vector", dtype=None,
                 size: Optional[int] = None,
                 device: DeviceLike = None) -> torch.Tensor:
    """:func:`as_array`, validated as a rank-1 input."""
    arr = as_array(x, device=device)
    ArraySpec(dtype=dtype, ndim=1,
              shape=(size,) if size is not None else None).validate(arr, name)
    return arr


def is_row_major(x) -> bool:
    """Layout probe; see :mod:`raft_tpu_torch.util.input_validation`."""
    return _is_row_major(x)


# -- factories (make_device_matrix / make_device_vector / make_device_scalar)

def make_matrix(rows: int, cols: int, dtype=torch.float32,
                device: DeviceLike = None) -> torch.Tensor:
    return torch.zeros((rows, cols), dtype=torch_dtype(dtype),
                       device=resolve_device(device))


def make_vector(size: int, dtype=torch.float32,
                device: DeviceLike = None) -> torch.Tensor:
    return torch.zeros((size,), dtype=torch_dtype(dtype),
                       device=resolve_device(device))


def make_scalar(value=0, dtype=torch.float32,
                device: DeviceLike = None) -> torch.Tensor:
    return torch.tensor(value, dtype=torch_dtype(dtype),
                        device=resolve_device(device))


def validate_idx_dtype(dtype) -> torch.dtype:
    """The neighbor-id dtype knob (the reference's ``IdxT``): int32 (the
    default) or int64, given as a torch dtype, a numpy dtype or a name;
    returned as a ``torch.dtype``. Anything else raises
    :class:`~raft_tpu_torch.core.error.LogicError`."""
    try:
        dt = torch_dtype(dtype)
    except TypeError:
        dt = None
    expects(dt in _ID_DTYPES,
            "idx_dtype must be int32 or int64, got %s", dtype)
    return dt


def expects_ids_fit(name: str, ids: torch.Tensor, dtype: torch.dtype) -> None:
    """Raise :class:`~raft_tpu_torch.core.error.LogicError` when integer
    ``ids`` hold a value that ``dtype`` (an index's id dtype) cannot: a
    cast would wrap it onto another id."""
    if ids.numel() == 0 or ids.dtype.itemsize <= dtype.itemsize:
        return
    info = torch.iinfo(dtype)
    lo, hi = int(ids.min()), int(ids.max())
    expects(info.min <= lo and hi <= info.max,
            "%s: ids in [%s, %s] do not fit the index's %s ids (build with "
            "idx_dtype=torch.int64)", name, lo, hi, dtype)
