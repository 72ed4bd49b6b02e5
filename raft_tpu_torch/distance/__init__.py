"""Pairwise distances, the fused and masked nearest-neighbor reductions
and gram kernels."""

from raft_tpu_torch.distance.distance_types import (
    DISTANCE_TYPES,
    SUPPORTED_DISTANCES,
    DistanceType,
    KernelType,
    is_min_close,
    resolve_metric,
)
from raft_tpu_torch.distance.pairwise import distance, pairwise_distance
from raft_tpu_torch.distance.fused_l2_nn import (
    fused_l2_nn_argmin,
    fused_l2_nn_min_reduce,
)
from raft_tpu_torch.distance.masked_nn import masked_l2_nn
from raft_tpu_torch.distance.kernels import (
    GramMatrixBase,
    KernelParams,
    PolynomialKernel,
    RBFKernel,
    TanhKernel,
    kernel_factory,
)

__all__ = [
    "DistanceType", "KernelType", "DISTANCE_TYPES", "SUPPORTED_DISTANCES",
    "is_min_close", "resolve_metric",
    "distance", "pairwise_distance",
    "fused_l2_nn_min_reduce", "fused_l2_nn_argmin", "masked_l2_nn",
    "KernelParams", "GramMatrixBase", "PolynomialKernel", "TanhKernel",
    "RBFKernel", "kernel_factory",
]
