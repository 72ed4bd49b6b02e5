"""Sparse pairwise distances and blocked sparse kNN.

Port of ``raft_tpu/sparse/distance.py`` (RAFT's
``sparse/distance/distance.cuh``: 20 metrics). :func:`_route` picks one
of four engines from the reference's byte budgets, and both entry points
take its answer:

* ``"dense"``: small operands (the larger side within ``_DENSE_BYTES``
  dense) and Haversine go through ``distance.pairwise.distance`` on the
  densified rows;
* ``"xdense"``: a gram metric whose x side fits ``_XDENSE_BYTES`` dense
  stages x once and scores each packed y block against all of it with
  one full-f32 product (``distance.pairwise.gram``) and the metric's
  epilogue, kNN merging a running top k per block;
* ``"semiring"``: an unexpanded metric on rows whose support is a small
  share of ``d`` takes the support-gather semiring: each pair of row
  blocks adds the metric's per-coordinate term over x's support (y
  gathered there) and over y's support where x is 0, so the work follows
  the row nnz, not ``d``. The row pack coalesces duplicate coordinates
  and drops stored zeros first;
* ``"blocked"``: everything else packs both sides into nnz-padded row
  blocks, groups the blocks by the next power of two of their nnz, and
  stages each block pair dense: a gram tile for the gram metrics, a scan
  over ``d`` in chunks sized by ``_EW_CHUNK_BYTES`` for the unexpanded
  ones.

The reference's ``lax.scan`` loops are Python loops over the blocks
here; its budgets keep their names and values, so a test can force an
engine in both packages by patching the same constant. Row sums are the
layer's fixed-order segment sums (:func:`types._segment_sum`). Top-k
merges go through ``matrix.select_k`` (ties to the earlier candidate),
in the polarity of the values the engines emit: InnerProduct selects the
largest, every other metric, Cosine and Correlation included, the
smallest (``value_form_select_min``).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.logger import logger
from raft_tpu_torch.core.nvtx import traced
from raft_tpu_torch.distance.distance_types import (
    DistanceType, resolve_metric, value_form_select_min)
from raft_tpu_torch.distance.pairwise import distance as dense_distance
from raft_tpu_torch.distance.pairwise import gram
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.sparse.types import (
    CSR, _lexsort, _run_lengths, _segment_sum)
from raft_tpu_torch.util.pow2 import ceildiv, next_pow2

# Densify-and-fuse below this operand footprint (bytes of one dense side).
_DENSE_BYTES = 64 * 1024 * 1024
# Staging-tile budget per side: block_rows ~ budget / (4 d).
_STAGE_TILE_BYTES = 64 * 1024 * 1024
# Elementwise-intermediate budget: dim-chunk ~ budget / (4 bx by).
_EW_CHUNK_BYTES = 64 * 1024 * 1024
# Cap of the (b, b) per-block-pair distance / gram tile.
_PAIR_TILE_BYTES = 64 * 1024 * 1024
# Budget of the dense x side of the x-dense engine.
_XDENSE_BYTES = 512 * 1024 * 1024

SUPPORTED_METRICS = (
    DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
    DistanceType.InnerProduct, DistanceType.L2Unexpanded,
    DistanceType.L2SqrtUnexpanded, DistanceType.CosineExpanded,
    DistanceType.L1, DistanceType.Canberra, DistanceType.Linf,
    DistanceType.LpUnexpanded, DistanceType.JaccardExpanded,
    DistanceType.HellingerExpanded, DistanceType.Haversine,
    DistanceType.BrayCurtis, DistanceType.JensenShannon,
    DistanceType.HammingUnexpanded, DistanceType.KLDivergence,
    DistanceType.RusselRaoExpanded, DistanceType.CorrelationExpanded,
    DistanceType.DiceExpanded,
)

_GRAM_METRICS = frozenset((
    DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
    DistanceType.InnerProduct, DistanceType.CosineExpanded,
    DistanceType.CorrelationExpanded, DistanceType.HellingerExpanded,
    DistanceType.JaccardExpanded, DistanceType.DiceExpanded,
    DistanceType.RusselRaoExpanded,
))

# The Unexpanded L2 variants stay unexpanded (sum of (x - y)^2), as the
# dense kernels keep them.
_EW_METRICS = frozenset((
    DistanceType.L1, DistanceType.Linf, DistanceType.Canberra,
    DistanceType.LpUnexpanded, DistanceType.HammingUnexpanded,
    DistanceType.BrayCurtis, DistanceType.JensenShannon,
    DistanceType.KLDivergence, DistanceType.L2Unexpanded,
    DistanceType.L2SqrtUnexpanded,
))


# ---------------------------------------------------------------------------
# CSR row-block packing and tile staging


def _block_pad_csr(x: CSR, b: int):
    """Pack the entries into ``(n_blocks, cap)`` nnz-padded per-block
    arrays (rloc, cols, vals), padding at rloc = b / col = d, plus the
    per-block row stats ``(n_blocks, 2, b)`` of (sum v, sum v^2); and each
    block's nnz (host array). ``cap`` is the largest block nnz."""
    m, d = x.shape
    nb = ceildiv(m, b)
    dev = x.indices.device
    bounds = x.indptr[torch.clamp_max(
        torch.arange(nb + 1, device=dev) * b, m)].long()
    nnzb = np.diff(bounds.cpu().numpy()).astype(np.int64)
    cap = max(int(nnzb.max()), 1)

    rows = x.row_ids().long()
    blk = rows // b
    pos = torch.arange(x.nnz, device=dev) - bounds[blk]
    rloc = torch.full((nb, cap), b, dtype=torch.int32, device=dev)
    rloc[blk, pos] = (rows % b).int()
    cols = torch.full((nb, cap), d, dtype=torch.int32, device=dev)
    cols[blk, pos] = x.indices.int()
    vals = torch.zeros((nb, cap), dtype=x.vals.dtype, device=dev)
    vals[blk, pos] = x.vals

    s = _segment_sum(x.vals, offsets=x.indptr)
    n2 = _segment_sum(x.vals * x.vals, offsets=x.indptr)
    pad = nb * b - m
    if pad:
        z = s.new_zeros(pad)
        s = torch.cat([s, z])
        n2 = torch.cat([n2, z])
    stats = torch.stack([s.reshape(nb, b), n2.reshape(nb, b)], dim=1)
    return (rloc, cols, vals, stats), nnzb


def _nnz_groups(nnzb: np.ndarray):
    """Block ids grouped by the next power of two of their nnz, so one
    dense block does not pad every other: ``[(cap, ids)]``, ascending
    cap."""
    caps = np.maximum(1, 1 << np.ceil(np.log2(np.maximum(nnzb, 1)))
                      .astype(np.int64))
    return [(int(cap), np.nonzero(caps == cap)[0].astype(np.int32))
            for cap in np.unique(caps)]


def _group_slice(pack, ids: np.ndarray, cap: int):
    """One nnz group of a pack: its blocks, the entry axis cut at the
    group's cap (no real entry lies past it)."""
    rloc, cols, vals, stats = pack
    i = torch.as_tensor(ids, device=rloc.device).long()
    return rloc[i, :cap], cols[i, :cap], vals[i, :cap], stats[i]


def _stage(rloc, cols, vals, b: int, d: int, dpad: int) -> torch.Tensor:
    """One packed block scattered into a dense ``(b, dpad)`` tile."""
    c = torch.where(cols >= d, dpad, cols)
    t = torch.zeros((b + 1, dpad + 1), dtype=vals.dtype, device=vals.device)
    t.index_put_((rloc.long(), c.long()), vals, accumulate=True)
    return t[:b, :dpad]


# ---------------------------------------------------------------------------
# Per-tile-pair distance cores


def _gram_epilogue(metric: DistanceType, g, xst, yst, d: int):
    """Distances from the gram tile and the row stats (sum, sum of
    squares)."""
    xs, x2 = xst[0], xst[1]
    ys, y2 = yst[0], yst[1]
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        out = torch.clamp_min(x2[:, None] + y2[None, :] - 2.0 * g, 0.0)
        if metric == DistanceType.L2SqrtExpanded:
            out = torch.sqrt(out)
        return out
    if metric == DistanceType.InnerProduct:
        return g
    if metric == DistanceType.CosineExpanded:
        return 1.0 - g / (torch.sqrt(x2)[:, None] * torch.sqrt(y2)[None, :])
    if metric == DistanceType.CorrelationExpanded:
        numer = d * g - xs[:, None] * ys[None, :]
        q = d * x2 - xs * xs
        r = d * y2 - ys * ys
        return 1.0 - numer / torch.sqrt(q[:, None] * r[None, :])
    if metric == DistanceType.HellingerExpanded:
        # Tiles are staged with sqrt|v|, so g is already sqrt(x).sqrt(y).
        return torch.sqrt(torch.clamp_min(1.0 - g, 0.0))
    if metric == DistanceType.JaccardExpanded:
        union = x2[:, None] + y2[None, :] - g
        nz = union != 0
        return torch.where(nz, 1.0 - g / torch.where(nz, union, 1.0), 0.0)
    if metric == DistanceType.DiceExpanded:
        denom = x2[:, None] + y2[None, :]
        nz = denom != 0
        return torch.where(nz, 1.0 - 2.0 * g / torch.where(nz, denom, 1.0),
                           0.0)
    if metric == DistanceType.RusselRaoExpanded:
        return (d - g) * (1.0 / d)
    raise ValueError(metric)


def _safe_log(v):
    return torch.log(torch.where(v > 0, v, 1.0))


def _ew_init(metric: DistanceType, bx: int, by: int, like: torch.Tensor):
    z = like.new_zeros((bx, by))
    return (z, z.clone()) if metric == DistanceType.BrayCurtis else z


def _ew_core(metric: DistanceType, a, b, p: float):
    """The per-coordinate term f(a, b) of each unexpanded metric, shared by
    the chunk scan and the semiring; f(0, 0) = 0 for all, so padding adds
    nothing. BrayCurtis gives the (numerator, denominator) pair."""
    if metric == DistanceType.L1 or metric == DistanceType.Linf:
        return torch.abs(a - b)
    if metric in (DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded):
        diff = a - b
        return diff * diff
    if metric == DistanceType.Canberra:
        diff = torch.abs(a - b)
        add = torch.abs(a) + torch.abs(b)
        nz = add != 0
        return torch.where(nz, diff / torch.where(nz, add, 1.0), 0.0)
    if metric == DistanceType.LpUnexpanded:
        return torch.abs(a - b) ** p
    if metric == DistanceType.HammingUnexpanded:
        return (a != b).float()
    if metric == DistanceType.BrayCurtis:
        return torch.abs(a - b), torch.abs(a + b)
    if metric == DistanceType.JensenShannon:
        mm = 0.5 * (a + b)
        logm = _safe_log(mm)
        return -a * (logm - _safe_log(a)) - b * (logm - _safe_log(b))
    if metric == DistanceType.KLDivergence:
        t = a * (_safe_log(a) - torch.where(b != 0, _safe_log(b), 0.0))
        return torch.where(a != 0, t, 0.0)
    raise ValueError(metric)


def _ew_accum(metric: DistanceType, acc, xc, yc, p: float):
    """Fold one (bx, dc) x (by, dc) chunk pair into the accumulator."""
    core = _ew_core(metric, xc[:, None, :], yc[None, :, :], p)
    if metric == DistanceType.Linf:
        return torch.maximum(acc, torch.amax(core, dim=-1))
    if metric == DistanceType.BrayCurtis:
        return acc[0] + core[0].sum(-1), acc[1] + core[1].sum(-1)
    return acc + core.sum(-1)


def _ew_finalize(metric: DistanceType, acc, d: int, p: float):
    if metric == DistanceType.BrayCurtis:
        num, den = acc
        nz = den != 0
        return torch.where(nz, num / torch.where(nz, den, 1.0), 0.0)
    if metric == DistanceType.LpUnexpanded:
        return acc ** (1.0 / p)
    if metric == DistanceType.HammingUnexpanded:
        return acc * (1.0 / d)
    if metric == DistanceType.JensenShannon:
        return torch.sqrt(0.5 * acc)
    if metric == DistanceType.KLDivergence:
        return 0.5 * acc
    if metric == DistanceType.L2SqrtUnexpanded:
        return torch.sqrt(acc)
    return acc


# ---------------------------------------------------------------------------
# The support-gather semiring


def _row_pad_csr(x: CSR, b: int):
    """Per-row padded blocks for the semiring: ``(nb, b, capr)`` cols
    (padding at col d, the staged tile's zero column) and vals, with
    duplicate coordinates summed and zero-valued ones dropped; plus each
    block's largest row nnz (host array). ``capr`` is the largest row nnz.
    Kept on the (frozen) CSR per block size, so repeated calls over one
    matrix pack it once."""
    cache = x.__dict__.get("_rowpad_cache")
    if cache is not None and cache[0] == b:
        return cache[1]
    m, d = x.shape
    nb = ceildiv(m, b)
    rownnz = torch.diff(x.indptr).cpu().numpy().astype(np.int64)
    capr = max(1, int(rownnz.max(initial=1)))
    dev = x.indices.device
    if x.nnz == 0:
        cols_p = torch.full((nb * b, capr), d, dtype=torch.int32, device=dev)
        vals_p = torch.zeros((nb * b, capr), dtype=x.vals.dtype, device=dev)
    else:
        cols_p, vals_p = _row_pad_coalesce(
            x.row_ids(), x.indices, x.vals, m, d, nb * b, capr)
    rpad = np.concatenate([rownnz, np.zeros(nb * b - m, rownnz.dtype)])
    blockcap = np.maximum(rpad.reshape(nb, b).max(axis=1), 1)
    out = (cols_p.reshape(nb, b, capr), vals_p.reshape(nb, b, capr),
           blockcap)
    object.__setattr__(x, "_rowpad_cache", (b, out))
    return out


def _row_pad_coalesce(rows, cols, vals, m: int, d: int, mp: int,
                      capr: int):
    """Sort the entries by (row, col), sum each coordinate's duplicates
    into its first entry (the rest, and coordinates summing to 0, become
    padding) and scatter into ``(mp, capr)``."""
    nnz = rows.shape[0]
    order = _lexsort(rows, cols)
    r_s = rows[order].long()
    c_s = cols[order].int()
    v_s = vals[order]
    first = torch.ones(nnz, dtype=torch.bool, device=rows.device)
    first[1:] = (r_s[1:] != r_s[:-1]) | (c_s[1:] != c_s[:-1])
    sums = _segment_sum(v_s, lengths=_run_lengths(first))
    keep = first & (sums != 0)
    v_new = torch.where(keep, sums, torch.zeros_like(sums))
    c_new = torch.where(keep, c_s, d)
    starts = torch.searchsorted(r_s, torch.arange(m, device=rows.device))
    pos = torch.arange(nnz, device=rows.device) - starts[r_s]
    cols_p = torch.full((mp, capr), d, dtype=torch.int32, device=rows.device)
    cols_p[r_s, pos] = c_new
    vals_p = torch.zeros((mp, capr), dtype=vals.dtype, device=rows.device)
    vals_p[r_s, pos] = v_new
    return cols_p, vals_p


def _stage_rows(cols, vals, b: int, d: int) -> torch.Tensor:
    """One per-row padded block as a dense ``(b, d + 1)`` tile whose last
    column stays 0 (padding gathers 0 there)."""
    r = torch.arange(b, device=cols.device)[:, None].expand(cols.shape)
    t = torch.zeros((b, d + 1), dtype=vals.dtype, device=vals.device)
    return t.index_put_((r, cols.long()), vals, accumulate=True)


def _semiring_reduce(metric: DistanceType, core, mask=None):
    """Reduce a (..., cap) core over the support axis with the metric's
    accumulation (sum, max or a pair of sums)."""
    if mask is not None:
        if metric == DistanceType.BrayCurtis:
            core = (torch.where(mask, core[0], 0.0),
                    torch.where(mask, core[1], 0.0))
        else:
            core = torch.where(mask, core, 0.0)
    if metric == DistanceType.Linf:
        return torch.amax(core, dim=-1)
    if metric == DistanceType.BrayCurtis:
        return core[0].sum(-1), core[1].sum(-1)
    return core.sum(-1)


def _semiring_combine(metric: DistanceType, p1t, p2):
    if metric == DistanceType.Linf:
        return torch.maximum(p1t, p2)
    if metric == DistanceType.BrayCurtis:
        return p1t[0] + p2[0], p1t[1] + p2[1]
    return p1t + p2


def _semiring_pair(metric: DistanceType, p: float, Xt, xc, xv, Yt, yc,
                   yv):
    """(bx, by) unexpanded distance terms between a staged x block and a
    staged y block: f(x, y) over supp(x) with y gathered there, plus
    f(0, y) over supp(y) where the gathered x is 0."""
    bx, by = Xt.shape[0], Yt.shape[0]
    Yg = Yt[:, xc.reshape(-1).long()].reshape(by, bx, xc.shape[1])
    p1 = _semiring_reduce(metric, _ew_core(metric, xv[None], Yg, p))
    Xg = Xt[:, yc.reshape(-1).long()].reshape(bx, by, yc.shape[1])
    zero = torch.zeros((), dtype=yv.dtype, device=yv.device)
    p2 = _semiring_reduce(metric, _ew_core(metric, zero, yv[None], p),
                          mask=Xg == 0)
    if metric == DistanceType.BrayCurtis:
        return _semiring_combine(metric, (p1[0].T, p1[1].T), p2)
    return _semiring_combine(metric, p1.T, p2)


def _scan_semiring(metric: DistanceType, p: float, d: int, b: int,
                   xcols, xvals, ycols, yvals) -> torch.Tensor:
    """Pairwise over every (x block, y block) pair of two groups by the
    semiring: ``(nbx, b, nby * b)``."""
    nby = ycols.shape[0]
    out = xvals.new_empty((xcols.shape[0], b, nby * b))
    for i in range(xcols.shape[0]):
        Xt = _stage_rows(xcols[i], xvals[i], b, d)
        for j in range(nby):
            Yt = _stage_rows(ycols[j], yvals[j], b, d)
            out[i, :, j * b:(j + 1) * b] = _ew_finalize(
                metric, _semiring_pair(metric, p, Xt, xcols[i], xvals[i],
                                       Yt, ycols[j], yvals[j]), d, p)
    return out


def _merge_block(metric: DistanceType, k: int, n: int, bd, bi, dist,
                 base: int):
    """Merge one y block's ``(rows, by)`` distances, ids from ``base``,
    into the running top k ``(bd, bi)``; ids past ``n`` are padding."""
    select_min = value_form_select_min(metric)
    worst = float("inf") if select_min else float("-inf")
    ids = base + torch.arange(dist.shape[1], dtype=torch.int32,
                              device=dist.device)
    valid = ids < n
    dist = torch.where(valid[None, :], dist, worst)
    ids_b = torch.where(valid, ids, -1)[None, :].expand(dist.shape)
    return select_k(torch.cat([bd, dist], dim=1), k, select_min=select_min,
                    indices=torch.cat([bi, ids_b], dim=1))


def _empty_topk(metric: DistanceType, rows: int, k: int, like):
    worst = float("inf") if value_form_select_min(metric) else float("-inf")
    return (like.new_full((rows, k), worst),
            torch.full((rows, k), -1, dtype=torch.int32, device=like.device))


def _scan_knn_semiring(metric: DistanceType, p: float, d: int, b: int,
                       k: int, n: int, xcols, xvals, ycols, yvals,
                       bases: np.ndarray):
    """Top k over the y blocks by the semiring, per x block:
    ``((nbx, b, k), (nbx, b, k))``."""
    out_d, out_i = [], []
    for i in range(xcols.shape[0]):
        Xt = _stage_rows(xcols[i], xvals[i], b, d)
        bd, bi = _empty_topk(metric, b, k, xvals)
        for j in range(ycols.shape[0]):
            Yt = _stage_rows(ycols[j], yvals[j], b, d)
            dist = _ew_finalize(
                metric, _semiring_pair(metric, p, Xt, xcols[i], xvals[i],
                                       Yt, ycols[j], yvals[j]), d, p)
            bd, bi = _merge_block(metric, k, n, bd, bi, dist, int(bases[j]))
        out_d.append(bd)
        out_i.append(bi)
    return torch.stack(out_d), torch.stack(out_i)


# ---------------------------------------------------------------------------
# The block-packed scan


def _block_dist(metric: DistanceType, p: float, d: int, dc: int,
                X, Xc, xst, yr, yc_, yv, yst, b: int):
    """(bx, by) distances between a staged x tile ``X`` (its
    ``(ndc, bx, dc)`` chunk view ``Xc``) and one packed y block."""
    if metric in _GRAM_METRICS:
        Y = _stage(yr, yc_, yv, b, d, d)
        return _gram_epilogue(metric, gram(X, Y), xst, yst, d)
    dpad = Xc.shape[0] * dc
    Yc = _stage(yr, yc_, yv, b, d, dpad).reshape(b, -1, dc).transpose(0, 1)
    acc = _ew_init(metric, Xc.shape[1], b, X)
    for t in range(Xc.shape[0]):
        acc = _ew_accum(metric, acc, Xc[t], Yc[t], p)
    return _ew_finalize(metric, acc, d, p)


def _stage_x(metric: DistanceType, d: int, dc: int, b: int, xr, xc, xv):
    """An x block staged for :func:`_block_dist`: the tile and its chunk
    view."""
    dpad = ceildiv(d, dc) * dc if metric in _EW_METRICS else d
    X = _stage(xr, xc, xv, b, d, dpad)
    if metric == DistanceType.HellingerExpanded:
        X = torch.sqrt(torch.abs(X))
    return X, X.reshape(b, -1, dc).transpose(0, 1)


def _y_vals(metric: DistanceType, v):
    return (torch.sqrt(torch.abs(v))
            if metric == DistanceType.HellingerExpanded else v)


def _scan_pairwise(metric: DistanceType, p: float, d: int, dc: int, b: int,
                   xr, xc, xv, xst, yr, yc_, yv, yst) -> torch.Tensor:
    """Pairwise over every block pair of two groups: ``(nbx, b, nby *
    b)``."""
    nby = yr.shape[0]
    out = xv.new_empty((xr.shape[0], b, nby * b))
    for i in range(xr.shape[0]):
        X, Xc = _stage_x(metric, d, dc, b, xr[i], xc[i], xv[i])
        for j in range(nby):
            out[i, :, j * b:(j + 1) * b] = _block_dist(
                metric, p, d, dc, X, Xc, xst[i], yr[j], yc_[j],
                _y_vals(metric, yv[j]), yst[j], b)
    return out


def _scan_knn(metric: DistanceType, p: float, d: int, dc: int, b: int,
              k: int, n: int, xr, xc, xv, xst, yr, yc_, yv, yst,
              bases: np.ndarray):
    """Top k over the y blocks of a group, per x block (a running
    ``(b, k)`` merged with each ``(b, b)`` block)."""
    out_d, out_i = [], []
    for i in range(xr.shape[0]):
        X, Xc = _stage_x(metric, d, dc, b, xr[i], xc[i], xv[i])
        bd, bi = _empty_topk(metric, b, k, X)
        for j in range(yr.shape[0]):
            dist = _block_dist(metric, p, d, dc, X, Xc, xst[i], yr[j],
                               yc_[j], _y_vals(metric, yv[j]), yst[j], b)
            bd, bi = _merge_block(metric, k, n, bd, bi, dist, int(bases[j]))
        out_d.append(bd)
        out_i.append(bi)
    return torch.stack(out_d), torch.stack(out_i)


# ---------------------------------------------------------------------------
# The x-dense engine


def _pick_block(rows: int, d: int, elementwise: bool) -> int:
    """Block rows bounding the (b, d) staging tile, the (b, b) pair tile
    and, for elementwise metrics, the (b, b, dc >= 128) intermediate."""
    b = max(64, _STAGE_TILE_BYTES // max(4 * (d + 1), 1))
    b = min(b, int((_PAIR_TILE_BYTES // 4) ** 0.5))
    if elementwise:
        b = min(b, int((_EW_CHUNK_BYTES // (4 * 128)) ** 0.5))
    b = max(8, b)
    b = 1 << (b.bit_length() - 1)          # round down to a power of two
    return max(1, min(rows, b))


def _pick_dchunk(d: int, b: int) -> int:
    dc = max(128, _EW_CHUNK_BYTES // max(4 * b * b, 1))
    return int(min(d, dc))


def _dense_x(metric: DistanceType, x: CSR):
    """The x side densified (f32) with its row stats; Hellinger's rows
    as sqrt|x|."""
    Xd = x.to_dense().float()
    xst = torch.stack([torch.sum(Xd, dim=1), torch.sum(Xd * Xd, dim=1)])
    X = (torch.sqrt(torch.abs(Xd))
         if metric == DistanceType.HellingerExpanded else Xd)
    return X, xst


def _scan_pairwise_xdense(metric: DistanceType, d: int, b: int, X, xst,
                          yr, yc_, yv, yst) -> torch.Tensor:
    """Gram-metric pairwise of the dense x side against each packed y
    block, each y tile staged once: ``(m, nby * b)``."""
    return torch.cat([
        _gram_epilogue(metric, gram(X, _stage(yr[j], yc_[j],
                                              _y_vals(metric, yv[j]), b, d,
                                              d)), xst, yst[j], d)
        for j in range(yr.shape[0])], dim=1)


def _scan_knn_xdense(metric: DistanceType, d: int, b: int, k: int, n: int,
                     X, xst, yr, yc_, yv, yst, bases: np.ndarray):
    """kNN of the dense x side over the packed y blocks, a running top k
    merged with each ``(m, b)`` tile."""
    bd, bi = _empty_topk(metric, X.shape[0], k, X)
    for j in range(yr.shape[0]):
        ytile = _stage(yr[j], yc_[j], _y_vals(metric, yv[j]), b, d, d)
        dist = _gram_epilogue(metric, gram(X, ytile), xst, yst[j], d)
        bd, bi = _merge_block(metric, k, n, bd, bi, dist, int(bases[j]))
    return bd, bi


# ---------------------------------------------------------------------------
# Routing and the public API


def _max_row_nnz(x: CSR) -> int:
    counts = torch.diff(x.indptr)
    return max(1, int(counts.max())) if counts.numel() else 1


def _route(x: CSR, y: CSR, metric: DistanceType, knn: bool) -> str:
    """The engine a call takes: "dense", "xdense", "semiring" or
    "blocked". ``x`` is the query side (the rows of the result), ``y``
    the database side; ``knn`` selects :func:`knn_blocked`'s x-dense rule
    (its (m, b) tile must also fit ``_PAIR_TILE_BYTES`` with b >= 128).
    The semiring gate reads each side's largest row nnz."""
    m, d = x.shape
    n = y.shape[0]
    if max(m, n) * d * 4 <= _DENSE_BYTES or metric == DistanceType.Haversine:
        return "dense"
    if metric not in _EW_METRICS:
        if m * d * 4 <= _XDENSE_BYTES and (not knn or _knn_bx(m, n, d) >= 128):
            return "xdense"
        return "blocked"
    b = _pick_block(max(m, n), d, True)
    caprx = next_pow2(_max_row_nnz(x))
    capry = caprx if y is x else next_pow2(_max_row_nnz(y))
    if ((caprx + capry) * 8 <= d
            and 4 * b * b * max(caprx, capry) <= 2 * _EW_CHUNK_BYTES):
        return "semiring"
    return "blocked"


def _knn_bx(m: int, n: int, d: int) -> int:
    """The x-dense kNN's y block rows: the gram metrics' block, cut so the
    (m, bx) tile fits ``_PAIR_TILE_BYTES``."""
    b = _pick_block(max(m, n), d, False)
    return min(b, max(1, (_PAIR_TILE_BYTES // max(4 * m, 1)) // 128 * 128))


def _ids(ids: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(ids, device=device).long()


@traced
def pairwise_distance(
    x: CSR, y: CSR,
    metric: Union[str, DistanceType] = DistanceType.L2Expanded,
    metric_arg: float = 2.0,
) -> torch.Tensor:
    """(m, n) distances between the rows of two CSR matrices, on their
    device, in the engine :func:`_route` picks; no engine forms a dense
    operand past its budget."""
    metric = resolve_metric(metric)
    expects(metric in SUPPORTED_METRICS, f"unsupported sparse metric {metric}")
    expects(x.shape[1] == y.shape[1], "column count mismatch")
    m, d = x.shape
    n = y.shape[0]
    engine = _route(x, y, metric, knn=False)
    if engine == "dense":
        return dense_distance(x.to_dense(), y.to_dense(), metric=metric,
                              metric_arg=metric_arg)
    if engine == "xdense":
        X, xst = _dense_x(metric, x)
        b = _pick_block(n, d, False)
        ypack, ynnz = _block_pad_csr(y, b)
        nby = ypack[0].shape[0]
        parts, yorder = [], []
        for ycap, yids in _nnz_groups(ynnz):
            part = _scan_pairwise_xdense(metric, d, b, X, xst,
                                         *_group_slice(ypack, yids, ycap))
            parts.append(part.reshape(m, len(yids), b))
            yorder.append(yids)
        inv = _ids(np.argsort(np.concatenate(yorder)), X.device)
        return torch.cat(parts, dim=1)[:, inv, :].reshape(m, nby * b)[:, :n]

    b = _pick_block(max(m, n), d, metric in _EW_METRICS)
    p = float(metric_arg)
    if engine == "semiring":
        xcp, xvp, xbc = _row_pad_csr(x, b)
        ycp, yvp, ybc = (xcp, xvp, xbc) if y is x else _row_pad_csr(y, b)
        gx, gy = _nnz_groups(xbc), _nnz_groups(ybc)
        nby = ycp.shape[0]
        logger.debug("sparse pairwise semiring: %d x %d group dispatches",
                     len(gx), len(gy))
        row_parts = [None] * xcp.shape[0]
        for xcap, xids in gx:
            xi = _ids(xids, xcp.device)
            xs = (xcp[xi, :, :xcap], xvp[xi, :, :xcap])
            col_parts, yorder = [], []
            for ycap, yids in gy:
                yi = _ids(yids, ycp.device)
                part = _scan_semiring(metric, p, d, b, *xs,
                                      ycp[yi, :, :ycap], yvp[yi, :, :ycap])
                col_parts.append(part.reshape(len(xids), b, len(yids), b))
                yorder.append(yids)
            inv = _ids(np.argsort(np.concatenate(yorder)), xcp.device)
            cat = torch.cat(col_parts, dim=2)[:, :, inv, :].reshape(
                len(xids), b, nby * b)
            for j, xid in enumerate(xids):
                row_parts[int(xid)] = cat[j]
        return torch.cat(row_parts, dim=0)[:m, :n]

    dc = _pick_dchunk(d, b) if metric in _EW_METRICS else d
    xpack, xnnz = _block_pad_csr(x, b)
    ypack, ynnz = _block_pad_csr(y, b)
    xgroups, ygroups = _nnz_groups(xnnz), _nnz_groups(ynnz)
    nby = ypack[0].shape[0]
    logger.debug("sparse pairwise: %d x-groups x %d y-groups",
                 len(xgroups), len(ygroups))
    row_parts = [None] * xpack[0].shape[0]
    for xcap, xids in xgroups:
        xs = _group_slice(xpack, xids, xcap)
        col_parts, yorder = [], []
        for ycap, yids in ygroups:
            part = _scan_pairwise(metric, p, d, dc, b, *xs,
                                  *_group_slice(ypack, yids, ycap))
            col_parts.append(part.reshape(len(xids), b, len(yids), b))
            yorder.append(yids)
        inv = _ids(np.argsort(np.concatenate(yorder)), xs[0].device)
        cat = torch.cat(col_parts, dim=2)[:, :, inv, :].reshape(
            len(xids), b, nby * b)
        for j, xid in enumerate(xids):
            row_parts[int(xid)] = cat[j]
    return torch.cat(row_parts, dim=0)[:m, :n]


def _merge_groups(metric: DistanceType, k: int, b: int, cand_d, cand_i):
    """Merge the per-y-group top k ``(g, b, k)`` of one x group."""
    if len(cand_d) == 1:
        return cand_d[0], cand_i[0]
    cd = torch.cat(cand_d, dim=2)
    ci = torch.cat(cand_i, dim=2)
    g, kk = cd.shape[0], cd.shape[2]
    bd, bi = select_k(cd.reshape(g * b, kk), k,
                      select_min=value_form_select_min(metric),
                      indices=ci.reshape(g * b, kk))
    return bd.reshape(g, b, k), bi.reshape(g, b, k)


@traced
def knn_blocked(
    idx: CSR, query: CSR, k: int,
    metric: Union[str, DistanceType] = DistanceType.L2Expanded,
    metric_arg: float = 2.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of the ``query`` rows among the ``idx`` rows, in the
    engine :func:`_route` picks, never holding more than a block's
    candidates beside the running top k: ``(distances (m, k), int32 ids
    (m, k))``, k clamped to the index's rows."""
    metric = resolve_metric(metric)
    expects(metric in SUPPORTED_METRICS, f"unsupported sparse metric {metric}")
    expects(idx.shape[1] == query.shape[1], "column count mismatch")
    m, d = query.shape
    n = idx.shape[0]
    k = min(k, n)
    select_min = value_form_select_min(metric)
    engine = _route(query, idx, metric, knn=True)
    if engine == "dense":
        dmat = dense_distance(query.to_dense(), idx.to_dense(), metric=metric,
                              metric_arg=metric_arg)
        return select_k(dmat, k, select_min=select_min)
    if engine == "xdense":
        X, xst = _dense_x(metric, query)
        bx = _knn_bx(m, n, d)
        ypack, ynnz = _block_pad_csr(idx, bx)
        parts_d, parts_i = [], []
        for ycap, yids in _nnz_groups(ynnz):
            gd, gi = _scan_knn_xdense(metric, d, bx, k, n, X, xst,
                                      *_group_slice(ypack, yids, ycap),
                                      yids.astype(np.int64) * bx)
            parts_d.append(gd)
            parts_i.append(gi)
        if len(parts_d) == 1:
            return parts_d[0], parts_i[0]
        return select_k(torch.cat(parts_d, dim=1), k, select_min=select_min,
                        indices=torch.cat(parts_i, dim=1))

    b = _pick_block(max(m, n), d, metric in _EW_METRICS)
    p = float(metric_arg)
    if engine == "semiring":
        xcp, xvp, xbc = _row_pad_csr(query, b)
        ycp, yvp, ybc = _row_pad_csr(idx, b)
        row_d = [None] * xcp.shape[0]
        row_i = [None] * xcp.shape[0]
        for xcap, xids in _nnz_groups(xbc):
            xi = _ids(xids, xcp.device)
            xs = (xcp[xi, :, :xcap], xvp[xi, :, :xcap])
            cand_d, cand_i = [], []
            for ycap, yids in _nnz_groups(ybc):
                yi = _ids(yids, ycp.device)
                bd, bi = _scan_knn_semiring(
                    metric, p, d, b, k, n, *xs, ycp[yi, :, :ycap],
                    yvp[yi, :, :ycap], yids.astype(np.int64) * b)
                cand_d.append(bd)
                cand_i.append(bi)
            bd, bi = _merge_groups(metric, k, b, cand_d, cand_i)
            for j, xid in enumerate(xids):
                row_d[int(xid)] = bd[j]
                row_i[int(xid)] = bi[j]
        return (torch.cat(row_d, dim=0)[:m], torch.cat(row_i, dim=0)[:m])

    dc = _pick_dchunk(d, b) if metric in _EW_METRICS else d
    xpack, xnnz = _block_pad_csr(query, b)
    ypack, ynnz = _block_pad_csr(idx, b)
    row_d = [None] * xpack[0].shape[0]
    row_i = [None] * xpack[0].shape[0]
    for xcap, xids in _nnz_groups(xnnz):
        xs = _group_slice(xpack, xids, xcap)
        cand_d, cand_i = [], []
        for ycap, yids in _nnz_groups(ynnz):
            bd, bi = _scan_knn(metric, p, d, dc, b, k, n, *xs,
                               *_group_slice(ypack, yids, ycap),
                               yids.astype(np.int64) * b)
            cand_d.append(bd)
            cand_i.append(bi)
        bd, bi = _merge_groups(metric, k, b, cand_d, cand_i)
        for j, xid in enumerate(xids):
            row_d[int(xid)] = bd[j]
            row_i[int(xid)] = bi[j]
    return (torch.cat(row_d, dim=0)[:m], torch.cat(row_i, dim=0)[:m])
