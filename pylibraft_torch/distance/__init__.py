"""pylibraft_torch.distance: pairwise distances + fused L2 argmin.

Ref: python/pylibraft/pylibraft/distance/__init__.py (exports
``distance``/``pairwise_distance``, ``fused_l2_nn_argmin``,
``DISTANCE_TYPES``).
"""

from pylibraft_torch.distance.pairwise_distance import (
    DISTANCE_TYPES,
    SUPPORTED_DISTANCES,
    distance,
    pairwise_distance,
)
from pylibraft_torch.distance.fused_l2_nn import fused_l2_nn_argmin

__all__ = [
    "DISTANCE_TYPES",
    "SUPPORTED_DISTANCES",
    "distance",
    "fused_l2_nn_argmin",
    "pairwise_distance",
]
