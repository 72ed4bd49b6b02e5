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


def dummy_key_val(dtype, select_min: bool):
    """Padding sentinel for a key dtype: +-inf for floats, the dtype's
    extreme value otherwise."""
    if dtype.is_floating_point:
        return torch.tensor(worst_value(select_min), dtype=dtype)
    info = torch.iinfo(dtype)
    return torch.tensor(info.max if select_min else info.min, dtype=dtype)
