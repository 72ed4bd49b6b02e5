"""Minimum spanning tree / forest: Borůvka with component contraction.

Port of ``raft_tpu/sparse/solver/mst.py`` (RAFT's
``sparse/solver/mst.cuh``). Each round picks every component's lightest
outgoing edge (a ``scatter_reduce`` minimum over the component colours,
then the smallest edge id among the minima) and contracts the chosen
edges by hooking to the smaller colour and 32 pointer jumps, for at most
``ceil(log2 n) + 2`` rounds. Ties are broken as the reference breaks
them: each weight is altered by a per-undirected-edge epsilon computed in
float32 with the reference's operations in its order (the edge key
``lo * n + hi`` rounds past 2^24 there too, so the same edges win). A host
union-find over the selected edges, lightest first, then drops the
directed duplicates and any cycle a surviving tie made: the reference's
Kruskal pass over the same order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.nvtx import traced
from raft_tpu_torch.core.mdarray import as_array
from raft_tpu_torch.core.resources import DeviceLike


@dataclass
class Graph_COO:
    """The MST's edges (src, dst, weight) and their number."""

    src: torch.Tensor
    dst: torch.Tensor
    weights: torch.Tensor
    n_edges: int


def _boruvka(rows, cols, weights, n_vertices: int, max_rounds: int):
    """Per-edge "in the MST" flags."""
    n_edges = rows.shape[0]
    dev = rows.device
    r, c = rows.long(), cols.long()
    edge_ids = torch.arange(n_edges, dtype=torch.int32, device=dev)
    color = torch.arange(n_vertices, dtype=torch.int32, device=dev)
    in_mst = torch.zeros(n_edges, dtype=torch.bool, device=dev)
    inf = torch.tensor(float("inf"), dtype=weights.dtype, device=dev)
    for _ in range(max_rounds):
        cu, cv = color[r], color[c]
        cul = cu.long()
        valid = cu != cv
        w = torch.where(valid, weights, inf)
        best_w = torch.full((n_vertices,), float("inf"), dtype=w.dtype,
                            device=dev).scatter_reduce(0, cul, w, "amin")
        is_best = valid & (w == best_w[cul]) & torch.isfinite(w)
        best_e = torch.full((n_vertices,), n_edges, dtype=torch.int32,
                            device=dev).scatter_reduce(
            0, cul, torch.where(is_best, edge_ids, n_edges), "amin")
        # A component with no outgoing edge names edge n_edges: dropped.
        chosen = torch.zeros(n_edges + 1, dtype=torch.bool, device=dev)
        chosen[best_e.long()] = True
        chosen = chosen[:n_edges]
        in_mst |= chosen
        lo = torch.minimum(cu, cv)
        hi = torch.maximum(cu, cv)
        new_color = color.scatter_reduce(
            0, torch.where(chosen, hi, 0).long(),
            torch.where(chosen, lo, n_vertices), "amin")
        for _ in range(32):
            new_color = new_color[new_color.long()]
        changed = bool(torch.any(new_color != color))
        color = new_color
        if not changed:
            break
    return in_mst


def _union_find(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                n: int) -> np.ndarray:
    """Kruskal over the given edges in stable weight order: the positions
    of the edges that join two trees, ascending."""
    parent = list(range(n))
    sel = []
    s, d = src.tolist(), dst.tolist()
    for e in np.argsort(w, kind="stable").tolist():
        a = s[e]
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        b = d[e]
        while parent[b] != b:
            parent[b] = parent[parent[b]]
            b = parent[b]
        if a != b:
            parent[a] = b
            sel.append(e)
    return np.sort(np.array(sel, dtype=np.int64))


@traced
def mst(rows, cols, weights, n_vertices: int,
        device: DeviceLike = None) -> Graph_COO:
    """Minimum spanning forest of an undirected weighted graph given as a
    (symmetric or one-sided) edge list: n_vertices - C edges for C
    components. Tensors stay on their device; other inputs go to
    ``device`` (``cuda`` by default)."""
    rows = as_array(rows, device=device).int()
    cols = as_array(cols, device=rows.device).int()
    weights = as_array(weights, device=rows.device).float()
    expects(rows.shape == cols.shape == weights.shape, "ragged edge list")
    # Both directions, so every component sees its outgoing edges.
    rows, cols = torch.cat([rows, cols]), torch.cat([cols, rows])
    weights = torch.cat([weights, weights])

    # The reference's float32 weight alteration, operation for operation.
    n = int(n_vertices)
    lo = torch.minimum(rows, cols)
    hi = torch.maximum(rows, cols)
    ueid = lo.float() * float(n)
    ueid = ueid + hi.float()
    frac = torch.fmod(ueid, 8191.0) / 8191.0
    span = torch.clamp_min(torch.max(torch.abs(weights)), 1.0)
    scale = 1.0 + 4e-6 * frac
    w_alt = weights * scale
    eps = span * 1e-7
    eps = eps * frac
    w_alt = w_alt + eps

    max_rounds = max(2, int(math.ceil(math.log2(max(n, 2)))) + 2)
    in_mst = _boruvka(rows, cols, w_alt, n, max_rounds)

    keep = in_mst.cpu().numpy()
    src = rows.cpu().numpy()[keep]
    dst = cols.cpu().numpy()[keep]
    w = weights.cpu().numpy()[keep]
    sel = _union_find(src, dst, w, n)
    dev = rows.device
    return Graph_COO(torch.as_tensor(src[sel], device=dev),
                     torch.as_tensor(dst[sel], device=dev),
                     torch.as_tensor(w[sel], device=dev), int(len(sel)))
