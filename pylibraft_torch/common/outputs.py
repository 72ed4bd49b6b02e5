"""Output auto-conversion, ref python/pylibraft/pylibraft/common/outputs.py.

The reference converts returned device arrays to the user's preferred
array type via a configurable output_as hook; the port keeps the same
surface over tensors: ``"device_ndarray"`` (default), ``"array"`` (the
``torch.Tensor`` itself) or a callable applied to each tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pylibraft_torch.common.device_ndarray import device_ndarray, to_host

_output_config = {"output_as": "device_ndarray"}


def set_output_as(output_as) -> None:
    """Ref common/outputs.py ``set_output_as``: 'device_ndarray', 'array',
    or a callable applied to each returned tensor."""
    _output_config["output_as"] = output_as


def _convert(value):
    out_as = _output_config["output_as"]
    if isinstance(value, torch.Tensor):
        if out_as == "device_ndarray":
            return device_ndarray.from_torch(value)
        if out_as == "array":
            return value
        if callable(out_as):
            return out_as(value)
    if isinstance(value, tuple):
        return tuple(_convert(v) for v in value)
    return value


def auto_convert_output(f):
    """Ref common/outputs.py ``auto_convert_output`` decorator."""

    @functools.wraps(f)
    def wrapper(*args, **kwargs):
        return _convert(f(*args, **kwargs))

    return wrapper


def copy_into(out, value: torch.Tensor):
    """Write ``value`` into a caller's ``out=`` buffer and return it: a
    numpy array receives a host copy, a tensor or a ``device_ndarray`` an
    in-place copy on its device, each cast to the buffer's dtype."""
    if isinstance(out, np.ndarray):
        np.copyto(out, to_host(value).astype(out.dtype, copy=False))
    elif isinstance(out, torch.Tensor):
        out.copy_(value)
    else:
        out.array.copy_(value)
    return out
