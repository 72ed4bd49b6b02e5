"""Fused L2 nearest-neighbor argmin, pylibraft surface.

Ref: python/pylibraft/pylibraft/distance/fused_l2_nn.pyx:66
(``fused_l2_nn_argmin(X, Y, out=None, sqrt=True)``) ->
raft::runtime ``fused_l2_nn_min_arg`` (cpp/src/distance/fused_l2_min_arg.cu).
Backed by ``raft_tpu_torch.distance.fused_l2_nn``: on the card, one k=1
launch of the fused kNN kernel.
"""

from __future__ import annotations

from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_argmin as _argmin

from pylibraft_torch.common import auto_convert_output, auto_sync_handle, cai_wrapper
from pylibraft_torch.common.ai_wrapper import check_same_device
from pylibraft_torch.common.outputs import copy_into


@auto_sync_handle
@auto_convert_output
def fused_l2_nn_argmin(X, Y, out=None, sqrt=True, handle=None):
    """For each row of X, the index of the nearest row of Y (int32; ties
    to the lowest index)."""
    x = cai_wrapper(X, handle)
    y = cai_wrapper(Y, handle)
    check_same_device(x, y)
    if x.shape[1] != y.shape[1]:
        raise ValueError("Inputs must have same number of columns")
    idx = _argmin(x.array, y.array, sqrt=sqrt, handle=handle)
    if out is not None:
        return copy_into(out, idx)
    return idx
