"""Reductions over rows or columns, and keyed reductions.

Port of ``raft_tpu/linalg/reduce.py`` (RAFT's ``reduce.cuh``,
``coalesced_reduction.cuh``, ``strided_reduction.cuh``,
``map_then_reduce.cuh``, ``reduce_rows_by_key.cuh``,
``reduce_cols_by_key.cuh`` and ``mean_squared_error.cuh``).

Sum, min and max reduce with torch's own reductions; any other reduce op
folds pairwise (a tree of ``op(even, odd)`` over halves), so, as in the
reference, it must be associative. The keyed sums are ``index_add_``
(atomic adds on the card); keys outside ``[0, n_keys)`` are dropped, as
the reference's ``segment_sum`` drops them.
"""

from __future__ import annotations

from typing import Callable

import torch

from raft_tpu_torch.core import operators as ops
from raft_tpu_torch.core.mdarray import as_array


def _fold(op: Callable, x: torch.Tensor, init) -> torch.Tensor:
    """``op`` folded over dim 0 of ``x`` as a tree, ``init`` applied once
    at the end."""
    fill = torch.full_like(x[:1], init)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, fill])
        x = op(x[0::2], x[1::2])
    return op(fill, x)[0] if x.shape[0] else fill[0]


def _sum(x: torch.Tensor, dim) -> torch.Tensor:
    """``torch.sum`` in the input's dtype (torch widens integers to int64;
    the reference keeps int32), bool summed as int32."""
    if x.is_floating_point() or x.is_complex():
        return torch.sum(x, dim=dim)
    dt = torch.int32 if x.dtype == torch.bool else x.dtype
    return torch.sum(x, dim=dim, dtype=dt)


def reduce(x, axis: int = 1, main_op: Callable = ops.identity_op,
           reduce_op: Callable = ops.add_op,
           final_op: Callable = ops.identity_op, init=None):
    """``final_op(reduce_op-fold of main_op(x) along axis)``. ``init``
    joins the fold; None is the op's identity (0 for a custom op, as in
    the reference)."""
    mapped = main_op(as_array(x))
    if reduce_op is ops.add_op:
        red = _sum(mapped, axis)
        if init is not None:
            red = red + torch.tensor(init, dtype=red.dtype)
    elif reduce_op is ops.min_op:
        red = torch.amin(mapped, dim=axis)
        if init is not None:
            red = torch.clamp_max(red, init)
    elif reduce_op is ops.max_op:
        red = torch.amax(mapped, dim=axis)
        if init is not None:
            red = torch.clamp_min(red, init)
    else:
        red = _fold(reduce_op, torch.movedim(mapped, axis, 0),
                    0 if init is None else init)
    return final_op(red)


def coalesced_reduction(x, **kwargs):
    """Reduce along the contiguous (last) dimension."""
    return reduce(x, axis=-1, **kwargs)


def strided_reduction(x, **kwargs):
    """Reduce along the strided (first) dimension."""
    return reduce(x, axis=0, **kwargs)


def map_reduce(op: Callable, reduce_op: Callable, *arrays, init=0):
    """``op`` mapped over n arrays, then folded with ``reduce_op`` to one
    value."""
    arrays = [as_array(a) for a in arrays]
    dev = arrays[0].device
    flat = op(*(a.to(dev) for a in arrays)).reshape(-1)
    if reduce_op is ops.add_op:
        return _sum(flat, 0) + torch.tensor(init, dtype=flat.dtype)
    return _fold(reduce_op, flat, init)


def reduce_rows_by_key(x, keys, n_keys: int, weights=None):
    """The rows of ``x`` summed by their key: ``(n_keys, n_cols)``, the
    k-means centroid update. ``weights`` scales each row first."""
    x = as_array(x)
    keys = as_array(keys, device=x.device).long()
    if weights is not None:
        x = x * as_array(weights, device=x.device)[:, None]
    # Out-of-range keys land on a spare row, which is cut off.
    keys = torch.where((keys >= 0) & (keys < n_keys), keys, n_keys)
    out = torch.zeros((n_keys + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, keys, x)[:n_keys]


def reduce_cols_by_key(x, keys, n_keys: int):
    """The columns of ``x`` summed by their key: ``(n_rows, n_keys)``."""
    x = as_array(x)
    return reduce_rows_by_key(x.T, keys, n_keys).T


def mean_squared_error(a, b, weight: float = 1.0):
    """``weight * mean((a - b)^2)``."""
    a = as_array(a)
    d = a - as_array(b, device=a.device)
    return weight * torch.mean(d * d)
