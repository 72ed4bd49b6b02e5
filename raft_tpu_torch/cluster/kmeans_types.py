"""Parameter structs for balanced k-means.

Port of ``KMeansBalancedParams`` from ``raft_tpu/cluster/kmeans_types.py``,
same field names and defaults.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.random.rng_state import RngState


@dataclass
class KMeansBalancedParams:
    """n_iters + metric; balancing is algorithmic, not parameterized."""

    n_iters: int = 20
    metric: DistanceType = DistanceType.L2Expanded
    rng_state: RngState = field(default_factory=lambda: RngState(seed=0))
