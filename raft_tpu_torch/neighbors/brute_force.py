"""Exact brute-force k-nearest-neighbor search.

Port of ``raft_tpu/neighbors/brute_force.py``. The L2 family and the
inner product take one of two engines:

* ``"scan"``: :func:`_tiled_knn_l2`, the reference's ``lax.scan`` over
  database tiles in plain PyTorch (a full-f32 gram per tile, then a stable
  top-k merge into the running best k);
* ``"kernel"``: the fused kNN kernel B1 (``ops/fused_knn.py``), the port of
  the reference's ``method="pallas"``.

``"auto"`` takes the kernel on ``cuda`` for n >= 8192 and k <= 128, the
same rule as the reference's ``_use_pallas`` on ``tpu``. Every other
metric takes the reference's generic path: a pairwise tile
(``distance/pairwise.distance``) per 8192 database rows, ``select_k`` per
tile and a running merge, in the polarity of ``value_form_select_min``.

A database of several parts is searched part by part and merged by
:func:`knn_merge_parts` (``comms/topk_merge.merge_parts``). Ids are int32
or int64 (``idx_dtype``): the engines give int32 positions within a part,
widened before the part offsets are added, so ids past 2^31 need int64.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from raft_tpu_torch.comms.topk_merge import merge_parts
from raft_tpu_torch.core.error import expects, expects_finite
from raft_tpu_torch.core.mdarray import validate_idx_dtype
from raft_tpu_torch.core.resources import as_float, as_tensor
from raft_tpu_torch.core.sentinels import PAD_ID, worst_value
from raft_tpu_torch.distance.distance_types import (
    DistanceType, resolve_metric, value_form_select_min)
from raft_tpu_torch.distance.pairwise import distance, gram, row_norms_sq
from raft_tpu_torch.matrix.select_k import select_k, stable_top_k
from raft_tpu_torch.ops.fused_knn import fused_knn, fused_knn_supported

_TILE_DB = 8192
_KERNEL_MIN_DB = 8192

_L2_IP_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                  DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded,
                  DistanceType.InnerProduct)


def _use_kernel(device: torch.device, n: int, d: int, k: int) -> bool:
    return (device.type == "cuda" and n >= _KERNEL_MIN_DB and k <= 128
            and fused_knn_supported(1, n, d, k))


def _tiled_knn_l2(queries, db, k: int, sqrt: bool, tile_db: int,
                  inner_is_l2: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tiled L2/IP kNN: per-tile full-f32 gram plus a running top-k merge
    (stable, so ties go to the lowest id). ``inner_is_l2=False`` searches
    by max inner product."""
    m = queries.shape[0]
    n = db.shape[0]
    qn = row_norms_sq(queries) if inner_is_l2 else None
    worst = worst_value(select_min=inner_is_l2)
    best_d = torch.full((m, k), worst, dtype=queries.dtype,
                        device=queries.device)
    best_i = torch.full((m, k), PAD_ID, dtype=torch.int64,
                        device=queries.device)
    for s in range(0, n, tile_db):
        yt = db[s:s + tile_db]
        g = gram(queries, yt)
        if inner_is_l2:
            dt = torch.clamp_min(qn[:, None] + row_norms_sq(yt)[None, :]
                                 - 2.0 * g, 0.0)
        else:
            dt = g
        ids = torch.arange(s, s + yt.shape[0], device=queries.device)
        cat_d = torch.cat([best_d, dt], dim=1)
        cat_i = torch.cat([best_i, ids[None, :].expand(m, -1)], dim=1)
        best_d, pos = stable_top_k(cat_d, k, select_min=inner_is_l2)
        best_i = torch.gather(cat_i, 1, pos)
    if inner_is_l2 and sqrt:
        best_d = torch.sqrt(best_d)
    return best_d, best_i.to(torch.int32)


def tiled_brute_force_knn(
    queries,
    db,
    k: int,
    metric: DistanceType = DistanceType.L2Expanded,
    metric_arg: float = 2.0,
    tile_db: int = _TILE_DB,
    method: str = "auto",
    handle=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN of ``queries`` against one database part for any metric.
    ``method`` picks the L2 / inner-product engine: "auto", "scan" (the
    tiled engine) or "kernel" (B1; on CPU tensors its plain version); the
    other metrics take the generic path whatever it says. Returns
    ``(distances (m, k), int32 indices (m, k))``. Rejects non-finite
    inputs."""
    queries = as_float(queries, handle)
    db = as_float(db, handle, queries.device)
    expects_finite("brute_force.knn", queries, db)
    return _knn_one_part(queries, db, k, resolve_metric(metric), metric_arg,
                         tile_db, method)


def _tiled_knn_generic(queries, db, k: int, metric: DistanceType,
                       metric_arg: float, tile_db: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The generic path: a pairwise tile per ``tile_db`` database rows,
    ``select_k`` per tile and a running merge (ties to the lower id)."""
    select_min = value_form_select_min(metric)
    n = db.shape[0]
    if n <= tile_db:
        return select_k(distance(queries, db, metric, metric_arg), k,
                        select_min=select_min)
    best_d = best_i = None
    for start in range(0, n, tile_db):
        tile = db[start:start + tile_db]
        sd, si = select_k(distance(queries, tile, metric, metric_arg),
                          min(k, tile.shape[0]), select_min=select_min)
        si = si + start
        if best_d is None:
            best_d, best_i = sd, si
            continue
        best_d, pos = select_k(torch.cat([best_d, sd], dim=1), k,
                               select_min=select_min)
        best_i = torch.gather(torch.cat([best_i, si], dim=1), 1, pos.long())
    return best_d, best_i


def _knn_one_part(queries, db, k: int, metric: DistanceType,
                  metric_arg: float, tile_db: int,
                  method: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`tiled_brute_force_knn` on checked float tensors."""
    expects(queries.shape[1] == db.shape[1], "dim mismatch")
    expects(method in ("auto", "scan", "kernel"),
            f"unknown method {method!r} (auto|scan|kernel)")
    k = min(k, db.shape[0])
    if metric not in _L2_IP_METRICS:
        return _tiled_knn_generic(queries, db, k, metric, metric_arg,
                                  tile_db)
    is_l2 = metric != DistanceType.InnerProduct
    sqrt = metric in (DistanceType.L2SqrtExpanded,
                      DistanceType.L2SqrtUnexpanded)
    if method == "kernel" or (
            method == "auto"
            and _use_kernel(queries.device, db.shape[0], db.shape[1], k)):
        return fused_knn(queries, db, k, metric="l2" if is_l2 else "ip",
                         sqrt=sqrt)
    return _tiled_knn_l2(queries, db, k, sqrt,
                         min(tile_db, max(db.shape[0], 1)), is_l2)


def knn_merge_parts(in_keys, in_values, n_samples: Optional[int] = None,
                    select_min: bool = True,
                    translations: Optional[Sequence[int]] = None,
                    handle=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-part kNN results ``(n_parts, n_queries, k)`` into the
    global top-k; ``translations`` offsets each part's local ids. Ties go
    to the lower part, then the lower rank within it. Returns ``(keys
    (n_queries, k), values (n_queries, k))``. ``n_samples`` is taken at
    the reference's position, so positional calls line up, and is not
    read, as there."""
    keys = as_tensor(in_keys, handle)
    vals = as_tensor(in_values, handle, keys.device)
    return merge_parts(keys, vals, select_min=select_min,
                       translations=translations)


def knn(
    index: Union[torch.Tensor, Sequence[torch.Tensor]],
    queries,
    k: int,
    metric: Union[str, DistanceType] = DistanceType.L2Expanded,
    metric_arg: float = 2.0,
    global_id_offset: int = 0,
    handle=None,
    method: str = "auto",
    idx_dtype=torch.int32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN over one database part or a list of parts, for any
    metric. Parts are searched one by one and merged; part p's ids start
    at ``global_id_offset`` plus the rows of the parts before it.
    ``idx_dtype`` is ``torch.int32`` or ``torch.int64``; positions are
    widened to it before the offsets are added, so ids past 2^31 need
    int64. Returns ``(distances (n_queries, k), indices (n_queries, k))``
    in ``idx_dtype``."""
    metric = resolve_metric(metric)
    idx_dtype = validate_idx_dtype(idx_dtype)
    parts = list(index) if isinstance(index, (list, tuple)) else [index]
    expects(len(parts) >= 1, "index must contain at least one part")
    queries = as_float(queries, handle)
    parts = [as_float(p, handle, queries.device) for p in parts]
    info = torch.iinfo(idx_dtype)
    n_total = sum(p.shape[0] for p in parts)
    expects(info.min <= global_id_offset
            and global_id_offset + n_total - 1 <= info.max,
            "ids from %s to %s do not fit %s; pass idx_dtype=torch.int64",
            global_id_offset, global_id_offset + n_total - 1, idx_dtype)
    expects_finite("brute_force.knn", queries, *parts)
    if len(parts) == 1:
        d, i = _knn_one_part(queries, parts[0], k, metric, metric_arg,
                             _TILE_DB, method)
        i = i.to(idx_dtype)
        if global_id_offset:
            i = i + global_id_offset
        return d, i

    select_min = value_form_select_min(metric)
    all_d, all_i, offsets = [], [], []
    base = global_id_offset
    for p in parts:
        pd, pi = _knn_one_part(queries, p, min(k, p.shape[0]), metric,
                               metric_arg, _TILE_DB, method)
        pi = pi.to(idx_dtype)
        kk = pd.shape[1]
        if kk < k:
            # A short part pads to k. The merge adds ``base`` to every id,
            # so the pad ids are pre-shifted to come out as PAD_ID.
            pd = torch.cat([pd, torch.full((pd.shape[0], k - kk),
                                            worst_value(select_min),
                                            dtype=pd.dtype,
                                            device=pd.device)], dim=1)
            pi = torch.cat([pi, torch.full((pi.shape[0], k - kk),
                                           PAD_ID - base, dtype=pi.dtype,
                                           device=pi.device)], dim=1)
        all_d.append(pd)
        all_i.append(pi)
        offsets.append(base)
        base += p.shape[0]
    return knn_merge_parts(torch.stack(all_d), torch.stack(all_i),
                           select_min=select_min, translations=offsets)


def fused_l2_knn(index, queries, k: int, sqrt: bool = False, handle=None):
    """L2-only fused kNN."""
    metric = DistanceType.L2SqrtExpanded if sqrt else DistanceType.L2Expanded
    return knn(index, queries, k, metric=metric, handle=handle)
