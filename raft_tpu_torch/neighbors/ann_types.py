"""Base parameter types shared by all ANN indexes.

Port of ``raft_tpu/neighbors/ann_types.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from raft_tpu_torch.distance.distance_types import DistanceType


@dataclass
class IndexParams:
    """Base index parameters."""

    metric: DistanceType = DistanceType.L2Expanded
    metric_arg: float = 2.0
    add_data_on_build: bool = True


@dataclass
class SearchParams:
    """Base search parameters (empty)."""
