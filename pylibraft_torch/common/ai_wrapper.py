"""Array-interface ingestion wrappers.

Ref: python/pylibraft/pylibraft/common/{ai_wrapper.py,cai_wrapper.py:21}:
the reference wraps ``__array_interface__`` / ``__cuda_array_interface__``
objects for zero-copy pointer access. The port's wrappers hold a
``torch.Tensor``: a tensor or a ``device_ndarray`` stays where it is, with
no copy; anything else (numpy, nested lists) moves to the entry point's
handle's device (``cuda`` when no handle is given).
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.core.resources import as_tensor

from pylibraft_torch.common.device_ndarray import numpy_dtype


class ai_wrapper:
    """Host/device array wrapper with dtype/shape validation hooks."""

    def __init__(self, ai_arr, handle=None):
        if hasattr(ai_arr, "array") and isinstance(ai_arr.array,
                                                   torch.Tensor):
            self._arr = ai_arr.array
        else:
            self._arr = as_tensor(ai_arr, handle)

    @property
    def dtype(self) -> np.dtype:
        return numpy_dtype(self._arr.dtype)

    @property
    def shape(self):
        return tuple(self._arr.shape)

    @property
    def c_contiguous(self) -> bool:
        return self._arr.is_contiguous()

    @property
    def device(self) -> torch.device:
        return self._arr.device

    @property
    def array(self) -> torch.Tensor:
        return self._arr

    def validate_shape_dtype(self, expected_dims=None, expected_dtype=None):
        """Ref cai_wrapper.py ``validate_shape_dtype``."""
        if expected_dims is not None and len(self.shape) != expected_dims:
            raise ValueError(
                f"unexpected shape {self.shape} - expected {expected_dims} dims"
            )
        if expected_dtype is not None and self.dtype != np.dtype(expected_dtype):
            raise ValueError(
                f"unexpected dtype {self.dtype} - expected {expected_dtype}"
            )
        return self


class cai_wrapper(ai_wrapper):
    """Device-array wrapper (ref common/cai_wrapper.py:21); host and device
    inputs both land on the handle's device, so this is ai_wrapper with
    the reference's name kept."""


def check_same_device(*wrappers) -> None:
    """Raise ValueError when the operands lie on more than one device (a
    tensor stays where it is, so a caller can mix them)."""
    devices = {w.device for w in wrappers}
    if len(devices) != 1:
        raise ValueError(f"operands lie on more than one device: "
                         f"{sorted(map(str, devices))}")
