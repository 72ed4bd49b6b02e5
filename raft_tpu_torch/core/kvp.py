"""Key-value pair, the result type of the fused arg-min reductions.

Port of ``raft_tpu/core/kvp.py`` (``raft::KeyValuePair``): a ``NamedTuple``
of tensors; ``key`` is usually an index, ``value`` a distance.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class KeyValuePair(NamedTuple):
    """(key, value) pair of tensors."""

    key: torch.Tensor
    value: torch.Tensor
