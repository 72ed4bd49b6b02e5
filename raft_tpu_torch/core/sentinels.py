"""The single definition of the merge/padding sentinel values.

Port of ``raft_tpu/core/sentinels.py``: padding and invalid candidate slots
carry ``PAD_ID`` (-1) and the worst distance of the selection polarity.
"""

from __future__ import annotations

import torch

#: Id sentinel for padding / invalid candidate slots.
PAD_ID = -1


def worst_value(select_min: bool) -> float:
    """The worst-possible float key for one selection polarity: +inf when
    selecting minima, -inf for maxima."""
    return float("inf") if select_min else float("-inf")


def pad_id(dtype=None):
    """``PAD_ID`` as a Python int, or a 0-d tensor of ``dtype`` (an index
    array's int32 / int64)."""
    if dtype is None:
        return PAD_ID
    return torch.tensor(PAD_ID, dtype=dtype)


def dummy_key_val(dtype, select_min: bool):
    """Padding sentinel for a key dtype: +-inf for floats, the dtype's
    extreme value otherwise."""
    if dtype.is_floating_point:
        return torch.tensor(worst_value(select_min), dtype=dtype)
    info = torch.iinfo(dtype)
    return torch.tensor(info.max if select_min else info.min, dtype=dtype)
