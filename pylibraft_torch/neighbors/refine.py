"""Candidate refinement (exact re-ranking), pylibraft surface.

Ref: python/pylibraft/pylibraft/neighbors/refine.pyx:173 (``refine``) ->
raft::neighbors::refine (neighbors/refine.cuh). Returns
``(distances, indices)`` like the reference (refine.pyx:323).
"""

from __future__ import annotations

from raft_tpu_torch.neighbors.refine import refine as _impl_refine

from pylibraft_torch.common import auto_convert_output, auto_sync_handle, cai_wrapper
from pylibraft_torch.common.ai_wrapper import check_same_device
from pylibraft_torch.common.outputs import copy_into
from pylibraft_torch.neighbors.brute_force import _deduce_k
from pylibraft_torch.neighbors.common import _get_metric


@auto_sync_handle
@auto_convert_output
def refine(dataset, queries, candidates, k=None, indices=None,
           distances=None, metric="sqeuclidean", handle=None):
    ds = cai_wrapper(dataset, handle)
    q = cai_wrapper(queries, handle)
    cand = cai_wrapper(candidates, handle)
    check_same_device(ds, q, cand)
    k = _deduce_k(k, indices, distances)
    d, i = _impl_refine(ds.array, q.array, cand.array, k,
                        metric=_get_metric(metric), handle=handle)
    if distances is not None:
        copy_into(distances, d)
    if indices is not None:
        copy_into(indices, i)
    return d, i
