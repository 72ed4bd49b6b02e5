"""Neighbor-id dtypes.

Port of ``raft_tpu/core/mdarray.py::validate_idx_dtype``, the id-dtype
knob of the kNN surface, with the range check an id dtype implies. The
reference's int64 ids need JAX's global x64 switch; a torch tensor holds
int64 as it is, so the port has no such condition. The rest of the
reference module (``ArraySpec``, the ``make_*`` factories, the view
checks) has no caller in the port yet.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.core.error import expects

_ID_DTYPES = (torch.int32, torch.int64)


def validate_idx_dtype(dtype) -> torch.dtype:
    """The neighbor-id dtype knob (the reference's ``IdxT``): int32 (the
    default) or int64, given as a torch dtype, a numpy dtype or a name;
    returned as a ``torch.dtype``. Anything else raises
    :class:`~raft_tpu_torch.core.error.LogicError`."""
    try:
        dt = (dtype if isinstance(dtype, torch.dtype)
              else torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype)
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
