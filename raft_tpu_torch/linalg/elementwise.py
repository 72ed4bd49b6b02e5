"""Element-wise operations.

Port of ``raft_tpu/linalg/elementwise.py`` (RAFT's ``add.cuh``,
``subtract.cuh``, ..., ``map.cuh``): each takes tensors or array-likes;
the second operand follows the first onto its device.
"""

from __future__ import annotations

from typing import Callable

import torch

from raft_tpu_torch.core.mdarray import as_array
from raft_tpu_torch.core.resources import DeviceLike, resolve_device


def _arrays(*xs):
    """Every operand as a tensor on the device of the first tensor among
    them (or the default device)."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    return [as_array(x, device=dev) for x in xs]


def add(a, b):
    a, b = _arrays(a, b)
    return torch.add(a, b)


def add_scalar(a, scalar):
    return as_array(a) + scalar


def subtract(a, b):
    a, b = _arrays(a, b)
    return torch.subtract(a, b)


def subtract_scalar(a, scalar):
    return as_array(a) - scalar


def multiply(a, b):
    a, b = _arrays(a, b)
    return torch.multiply(a, b)


def multiply_scalar(a, scalar):
    return as_array(a) * scalar


def divide(a, b):
    a, b = _arrays(a, b)
    return torch.divide(a, b)


def divide_scalar(a, scalar):
    return as_array(a) / scalar


def power(a, b):
    a, b = _arrays(a, b)
    return torch.pow(a, b)


def power_scalar(a, scalar):
    return torch.pow(as_array(a), scalar)


def sqrt(a):
    return torch.sqrt(as_array(a))


def eltwise(op: Callable, *arrays):
    """A generic element-wise op over n arrays."""
    return op(*_arrays(*arrays))


def unary_op(x, op: Callable):
    return op(as_array(x))


def binary_op(a, b, op: Callable):
    return op(*_arrays(a, b))


def ternary_op(a, b, c, op: Callable):
    return op(*_arrays(a, b, c))


def map(op: Callable, *arrays):  # noqa: A001 - mirrors raft::linalg::map
    """Map an n-ary op over arrays."""
    return op(*_arrays(*arrays))


def map_offset(shape, op: Callable, *arrays, device: DeviceLike = None):
    """Map whose first argument is each element's flat offset (int32, on
    the arrays' device, else ``device``, else ``cuda``)."""
    arrays = _arrays(*arrays)
    dev = arrays[0].device if arrays else resolve_device(device)
    size = 1
    for s in shape:
        size *= s
    idx = torch.arange(size, dtype=torch.int32, device=dev).reshape(
        tuple(shape))
    return op(idx, *arrays)
