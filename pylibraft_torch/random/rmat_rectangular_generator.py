"""RMAT rectangular graph generator, pylibraft surface.

Ref: python/pylibraft/pylibraft/random/rmat_rectangular_generator.pyx:80
(``rmat(out, theta, r_scale, c_scale, seed)``) -> raft::random::
rmat_rectangular_gen (cpp/src/random/rmat_rectangular_generator.cu).
Backed by ``raft_tpu_torch.random.rmat``, whose ``torch.Generator`` draws
differ from the JAX package's for the same seed; both follow theta's law.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.random.rmat import rmat_rectangular_gen as _gen
from raft_tpu_torch.random.rng_state import RngState

from pylibraft_torch.common import auto_convert_output, auto_sync_handle, cai_wrapper
from pylibraft_torch.common.outputs import copy_into


@auto_sync_handle
@auto_convert_output
def rmat(out, theta, r_scale, c_scale, seed=12345, handle=None):
    """Fill ``out`` (n_edges, 2) with RMAT edges; returns out. Same in-place
    contract as the reference (out dtype int32/int64). The edges are drawn
    on ``out``'s device when it is a tensor or a ``device_ndarray``, and
    stay there; a numpy ``out`` is drawn on the handle's device and
    copied to the host."""
    if isinstance(out, torch.Tensor):
        dev = out.device
    elif isinstance(getattr(out, "array", None), torch.Tensor):
        dev = out.array.device
    else:
        dev = handle.device
    t = cai_wrapper(theta, handle).array.to(dev)
    n_edges = out.shape[0] if hasattr(out, "shape") else np.asarray(out).shape[0]
    src, dst = _gen(RngState(seed=int(seed)), t, int(r_scale), int(c_scale),
                    int(n_edges), device=dev)
    edges = torch.stack([src, dst], dim=1)
    if isinstance(out, (np.ndarray, torch.Tensor)) or hasattr(out, "array"):
        return copy_into(out, edges)
    return edges
