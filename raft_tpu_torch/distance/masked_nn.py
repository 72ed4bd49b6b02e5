"""Masked L2 nearest neighbor: the fused L2 arg-min over a group mask.

Port of ``raft_tpu/distance/masked_nn.py`` (RAFT's ``masked_l2_nn``, the
step of single-linkage's ``connect_components``). The rows of ``y`` are
split into groups; ``group_idxs[g]`` is the *end* offset of group g, and
``adj[i, g]`` says whether row i of ``x`` may match group g.

The reference forms the whole (m, n) distance matrix. The port forms it
over tiles of the rows of ``x`` of at most ``_TILE_ELEMS`` entries, so
that memory stays bounded (10,000 x 1,000,000 on one card). Each row's
answer is its own, so the tiling changes no answer, but for the rounding
of the product, which the BLAS may sum in another order for another tile
shape.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import as_array
from raft_tpu_torch.core.nvtx import range_scope, traced
from raft_tpu_torch.distance.pairwise import gram, row_norms_sq
from raft_tpu_torch.linalg.blas import DEFAULT_PRECISION, resolve_precision

# Entries of one tile's (rows, n) distance block: 2^28 f32 (1 GiB), with
# a boolean mask of a quarter of that beside it.
_TILE_ELEMS = 1 << 28


def tile_rows(m: int, n: int) -> int:
    """Rows of ``x`` per tile against ``n`` rows of ``y``."""
    return max(1, min(m, _TILE_ELEMS // max(n, 1)))


@traced
def masked_l2_nn(x, y, adj, group_idxs, sqrt: bool = False,
                 precision=DEFAULT_PRECISION
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of ``x``, ``(min L2 distance, arg-min)`` over the rows
    of ``y`` whose group ``adj`` allows: ``adj`` is (m, num_groups) bool,
    ``group_idxs`` (num_groups,) the groups' end offsets. Distances are
    squared unless ``sqrt``; ties go to the lowest index; a row with no
    allowed group gives ``(+inf, -1)``. ``precision`` takes the
    reference's names; the product is full f32 for each."""
    resolve_precision(precision)
    x = as_array(x)
    y = as_array(y, device=x.device)
    adj = as_array(adj, device=x.device).to(torch.bool)
    group_idxs = as_array(group_idxs, device=x.device).to(torch.int32)
    if not x.is_floating_point():
        x = x.float()
    if not y.is_floating_point():
        y = y.float()
    expects(x.shape[1] == y.shape[1], "x and y must have the same n_cols")
    m, n = x.shape[0], y.shape[0]
    expects(tuple(adj.shape) == (m, group_idxs.shape[0]),
            "adj must be (m, num_groups)")
    # Row j of y is in group g when group_idxs[g-1] <= j < group_idxs[g].
    y_group = torch.searchsorted(
        group_idxs, torch.arange(n, dtype=torch.int32, device=x.device),
        right=True)
    yn = row_norms_sq(y)
    dist = torch.empty(m, dtype=torch.promote_types(x.dtype, y.dtype),
                       device=x.device)
    idx = torch.empty(m, dtype=torch.int32, device=x.device)
    step = tile_rows(m, n)
    for r in range(0, m, step):
        with range_scope("masked_nn.tile"):
            xt = x[r:r + step]
            # In place, and bit for bit max(|x|^2 + |y|^2 - 2 x.y, 0).
            d = (row_norms_sq(xt)[:, None] + yn[None, :]).add_(
                gram(xt, y).mul_(-2.0)).clamp_min_(0.0)
            if sqrt:
                d.sqrt_()
            allowed = adj[r:r + step][:, y_group]
            d.masked_fill_(~allowed, torch.inf)
            best = torch.argmin(d, dim=1)
            dist[r:r + step] = torch.gather(d, 1, best[:, None])[:, 0]
            idx[r:r + step] = torch.where(allowed.any(dim=1), best, -1).to(
                torch.int32)
    return dist, idx
