"""Parameter structs for k-means variants.

Port of ``raft_tpu/cluster/kmeans_types.py``: ``InitMethod``,
``KMeansParams`` and ``KMeansBalancedParams``, with the reference's field
names and defaults.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.random.rng_state import RngState


class InitMethod(enum.Enum):
    """Centroid seeding method."""

    KMeansPlusPlus = 0
    Random = 1
    Array = 2


@dataclass
class KMeansParams:
    """Lloyd k-means parameters. ``batch_samples`` / ``batch_centroids``,
    ``oversampling_factor``, ``verbosity`` and ``inertia_check`` are kept
    for parity with the reference's struct; its fit reads none of them,
    and neither does the port's."""

    n_clusters: int = 8
    init: InitMethod = InitMethod.KMeansPlusPlus
    max_iter: int = 300
    tol: float = 1e-4
    verbosity: int = 0
    rng_state: RngState = field(default_factory=lambda: RngState(seed=0))
    metric: DistanceType = DistanceType.L2Expanded
    n_init: int = 1
    oversampling_factor: float = 2.0
    batch_samples: int = 1 << 15
    batch_centroids: int = 0
    inertia_check: bool = False


@dataclass
class KMeansBalancedParams:
    """n_iters + metric; balancing is algorithmic, not parameterized."""

    n_iters: int = 20
    metric: DistanceType = DistanceType.L2Expanded
    rng_state: RngState = field(default_factory=lambda: RngState(seed=0))
