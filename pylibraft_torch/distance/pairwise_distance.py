"""Runtime-metric pairwise distance, pylibraft surface.

Ref: python/pylibraft/pylibraft/distance/pairwise_distance.pyx:62-83
(metric-name dict) and :93 (``def distance``) -> raft::runtime::distance::
pairwise_distance (cpp/src/distance/pairwise_distance.cu). Backed by
``raft_tpu_torch.distance.pairwise`` on the handle's device.
"""

from __future__ import annotations

from raft_tpu_torch.distance import pairwise as _pairwise
from raft_tpu_torch.distance.distance_types import DISTANCE_TYPES, DistanceType

from pylibraft_torch.common import auto_convert_output, auto_sync_handle, cai_wrapper
from pylibraft_torch.common.ai_wrapper import check_same_device
from pylibraft_torch.common.outputs import copy_into

SUPPORTED_DISTANCES = [
    "euclidean", "l1", "cityblock", "l2", "inner_product", "chebyshev",
    "minkowski", "canberra", "kl_divergence", "correlation", "russellrao",
    "hellinger", "lp", "hamming", "jensenshannon", "cosine", "sqeuclidean",
]


@auto_sync_handle
@auto_convert_output
def distance(X, Y, out=None, metric="euclidean", p=2.0, handle=None):
    """Compute pairwise distances between X and Y; ref
    distance/pairwise_distance.pyx:93-171. ``out``, when given, receives the
    result (a host copy for numpy outputs) and is returned.

    Examples
    --------
    >>> import numpy as np
    >>> from pylibraft_torch.common import DeviceResources
    >>> from pylibraft_torch.distance import pairwise_distance
    >>> X = np.array([[0.0, 0.0], [3.0, 4.0]], np.float32)
    >>> Y = np.array([[0.0, 0.0]], np.float32)
    >>> h = DeviceResources(device="cpu")
    >>> np.asarray(pairwise_distance(X, Y, metric="euclidean",
    ...                              handle=h)).round(2)
    array([[0.],
           [5.]], dtype=float32)
    """
    if isinstance(metric, str):
        if metric not in DISTANCE_TYPES:
            raise ValueError(f"metric {metric!r} is not supported")
        metric_dt = DISTANCE_TYPES[metric]
    else:
        metric_dt = DistanceType(metric)

    x = cai_wrapper(X, handle)
    y = cai_wrapper(Y, handle)
    check_same_device(x, y)
    if x.shape[1] != y.shape[1]:
        raise ValueError("Inputs must have same number of columns")

    d = _pairwise.distance(x.array, y.array, metric=metric_dt, metric_arg=p,
                           handle=handle)
    if out is not None:
        return copy_into(out, d)
    return d


pairwise_distance = distance
