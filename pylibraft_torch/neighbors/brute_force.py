"""Brute-force exact kNN, pylibraft surface.

Ref: python/pylibraft/pylibraft/neighbors/brute_force.pyx:75 (``knn``) ->
raft::runtime brute-force (cpp/src/neighbors/brute_force_knn_int64_t_float.cu)
-> tiled pairwise + select_k (neighbors/detail/knn_brute_force.cuh:51).
Backed by ``raft_tpu_torch.neighbors.brute_force``: on the card, the L2
and inner-product metrics take the fused kNN kernel from 8192 rows and
k <= 128.
"""

from __future__ import annotations

import numpy as np

from raft_tpu_torch.neighbors import brute_force as _bf

from pylibraft_torch.common import auto_convert_output, auto_sync_handle, cai_wrapper
from pylibraft_torch.common.ai_wrapper import check_same_device
from pylibraft_torch.common.outputs import copy_into
from pylibraft_torch.distance.pairwise_distance import DISTANCE_TYPES


def _n_cols(a) -> int:
    return a.shape[1] if hasattr(a, "shape") else np.asarray(a).shape[1]


def _deduce_k(k, indices, distances) -> int:
    """``k``, or the width of a given output buffer."""
    if k is not None:
        return int(k)
    if indices is not None:
        return _n_cols(indices)
    if distances is not None:
        return _n_cols(distances)
    raise ValueError("k must be given or deducible from indices/distances")


@auto_sync_handle
@auto_convert_output
def knn(dataset, queries, k=None, indices=None, distances=None,
        metric="sqeuclidean", metric_arg=2.0, global_id_offset=0,
        idx_dtype="int32", handle=None):
    """Exact nearest neighbors; returns ``(distances, indices)`` like the
    reference (brute_force.pyx:179). ``idx_dtype="int64"`` gives int64
    ids, as the reference's int64_t binding.

    Examples
    --------
    >>> import numpy as np
    >>> from pylibraft_torch.common import DeviceResources
    >>> from pylibraft_torch.neighbors.brute_force import knn
    >>> db = np.array([[0.0], [1.0], [5.0]], np.float32)
    >>> q = np.array([[0.9]], np.float32)
    >>> d, i = knn(db, q, k=2, handle=DeviceResources(device="cpu"))
    >>> np.asarray(i).tolist()
    [[1, 0]]
    """
    ds = cai_wrapper(dataset, handle)
    q = cai_wrapper(queries, handle)
    check_same_device(ds, q)
    k = _deduce_k(k, indices, distances)
    metric_dt = DISTANCE_TYPES[metric] if isinstance(metric, str) else metric
    d, i = _bf.knn(ds.array, q.array, k, metric=metric_dt,
                   metric_arg=metric_arg, global_id_offset=global_id_offset,
                   idx_dtype=idx_dtype, handle=handle)
    if distances is not None:
        copy_into(distances, d)
    if indices is not None:
        copy_into(indices, i)
    return d, i
