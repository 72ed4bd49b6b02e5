"""Epsilon neighborhood: every pair within a radius.

Port of ``raft_tpu/neighbors/epsilon_neighborhood.py`` (RAFT's
``neighbors/epsilon_neighborhood.cuh``, ``epsUnexpL2SqNeighborhood``): a
dense boolean adjacency and the vertex degrees, as DBSCAN consumes them.

The squared distances are ``|x|^2 + |y|^2 - 2 x.y`` in full f32, the
reference's ``Precision.HIGHEST``: the product is ``linalg.blas.gemm`` at
"highest", which holds full f32 whatever TF32 setting the caller made.
Rows of x are taken in blocks of ``_BLOCK_ELEMS`` distances, so the
temporaries stay bounded whatever m x n is; only the (m, n) adjacency is
full size.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import as_array
from raft_tpu_torch.core.nvtx import traced
from raft_tpu_torch.core.resources import DeviceLike
from raft_tpu_torch.linalg.blas import gemm

# Distances per block of x rows (256 MB of f32).
_BLOCK_ELEMS = 1 << 26


@traced
def eps_neighbors_l2sq(x, y, eps_sq: float, device: DeviceLike = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boolean adjacency ``adj[i, j] = |x_i - y_j|^2 < eps_sq`` (the
    radius is squared, as in the reference) and the vertex degrees.

    Returns ``(adj (m, n) bool, vd (m + 1,) int32)``: ``vd[:m]`` the row
    degrees, ``vd[m]`` their total. A tensor stays on its device; other
    inputs go to ``device`` (``cuda`` by default), y to x's."""
    x = as_array(x, device=device)
    y = as_array(y, device=x.device)
    expects(x.ndim == 2 and y.ndim == 2 and x.shape[1] == y.shape[1],
            "x and y must be matrices with matching n_cols")
    if not x.is_floating_point():
        x = x.float()
    if not y.is_floating_point():
        y = y.float()
    m, n = x.shape[0], y.shape[0]
    xn = torch.sum(x * x, dim=1)
    yn = torch.sum(y * y, dim=1)
    adj = torch.empty((m, n), dtype=torch.bool, device=x.device)
    rows = max(1, _BLOCK_ELEMS // max(n, 1))
    for s in range(0, m, rows):
        g = gemm(x[s:s + rows], y, trans_b=True, precision="highest")
        d = torch.clamp_min(xn[s:s + rows, None] + yn[None, :] - 2.0 * g,
                            0.0)
        torch.lt(d, eps_sq, out=adj[s:s + rows])
    deg = torch.sum(adj, dim=1, dtype=torch.int32)
    vd = torch.cat([deg, torch.sum(deg, dim=0, keepdim=True,
                                   dtype=torch.int32)])
    return adj, vd
