"""R-MAT recursive random graph generator.

Port of ``raft_tpu/random/rmat.py``: every edge descends the levels of a
2^r_scale x 2^c_scale adjacency matrix at once, from one uniform draw per
(edge, level). At each level the quadrant is the number of the first three
cumulative probabilities of theta below the draw: a (0), b (1), c (2),
d (3); its high bit is the row bit and its low bit the column bit, and a
level past r_scale (c_scale) adds no row (column) bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import DeviceLike, as_tensor, resolve_device
from raft_tpu_torch.random.rng_state import RngState


def _theta_levels(theta, depth: int, device) -> torch.Tensor:
    """theta as (depth, 4) float32 rows that sum to 1: a length-4 vector
    repeated at every level, or the first ``depth`` rows of a per-level
    matrix."""
    theta = as_tensor(theta, device=device).to(device=device,
                                               dtype=torch.float32)
    theta = theta.reshape(-1, 4)
    if theta.shape[0] == 1:
        theta = theta.repeat(depth, 1)
    expects(theta.shape[0] >= depth,
            "theta must provide max(r_scale,c_scale) levels")
    theta = theta[:depth]
    return theta / theta.sum(dim=1, keepdim=True)


def _edges(theta: torch.Tensor, r_scale: int, c_scale: int,
           u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The edges that the uniform draws ``u`` (n_edges, depth) pick under
    the per-level ``theta`` (depth, 4)."""
    cum = torch.cumsum(theta, dim=1)
    src = torch.zeros(u.shape[0], dtype=torch.int64, device=u.device)
    dst = torch.zeros_like(src)
    for lvl in range(u.shape[1]):
        quad = (u[:, lvl, None] > cum[lvl, None, :3]).sum(dim=1)
        if lvl < r_scale:
            src |= (quad >> 1) << (r_scale - 1 - lvl)
        if lvl < c_scale:
            dst |= (quad & 1) << (c_scale - 1 - lvl)
    return src.to(torch.int32), dst.to(torch.int32)


def rmat_rectangular_gen(state: RngState, theta, r_scale: int, c_scale: int,
                         n_edges: int, device: DeviceLike = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(src (n_edges,), dst (n_edges,))`` int32 edge lists. ``theta`` is
    a length-4 (a, b, c, d) vector for every level or a (max(r_scale,
    c_scale), 4) matrix, one row per level; a theta tensor keeps its
    device."""
    if isinstance(theta, torch.Tensor):
        device = theta.device
    dev = resolve_device(device)
    depth = max(r_scale, c_scale)
    levels = _theta_levels(theta, depth, dev)
    u = torch.rand((n_edges, depth), generator=state.next_generator(dev),
                   dtype=torch.float32, device=dev)
    return _edges(levels, r_scale, c_scale, u)
