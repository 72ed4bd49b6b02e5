"""Exact brute-force k-nearest-neighbor search.

Port of ``raft_tpu/neighbors/brute_force.py`` for the L2 and inner-product
metrics, with one database part. Two engines:

* ``"scan"``: :func:`_tiled_knn_l2`, the reference's ``lax.scan`` over
  database tiles in plain PyTorch (a full-f32 gram per tile, then a stable
  top-k merge into the running best k);
* ``"kernel"``: the fused kNN kernel B1 (``ops/fused_knn.py``), the port of
  the reference's ``method="pallas"``.

``"auto"`` takes the kernel on ``cuda`` for n >= 8192 and k <= 128, the
same rule as the reference's ``_use_pallas`` on ``tpu``. A database of
several parts is searched part by part and merged by
:func:`knn_merge_parts` (``comms/topk_merge.merge_parts``). int64 ids and
the other metrics come in a later slice and raise here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from raft_tpu_torch.comms.topk_merge import merge_parts
from raft_tpu_torch.core.error import expects, expects_finite
from raft_tpu_torch.core.resources import as_float, as_tensor
from raft_tpu_torch.core.sentinels import PAD_ID, worst_value
from raft_tpu_torch.distance.distance_types import (
    DistanceType, resolve_metric, value_form_select_min)
from raft_tpu_torch.distance.pairwise import gram, row_norms_sq
from raft_tpu_torch.matrix.select_k import stable_top_k
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
    """kNN by the L2 family or inner product. ``method``: "auto", "scan"
    (the tiled engine) or "kernel" (B1; on CPU tensors its plain version).
    Returns ``(distances (m, k), int32 indices (m, k))``. Rejects
    non-finite inputs."""
    queries = as_float(queries, handle)
    db = as_float(db, handle, queries.device)
    expects_finite("brute_force.knn", queries, db)
    return _knn_one_part(queries, db, k, metric, tile_db, method)


def _knn_one_part(queries, db, k: int, metric: DistanceType, tile_db: int,
                  method: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`tiled_brute_force_knn` on checked float tensors."""
    expects(queries.shape[1] == db.shape[1], "dim mismatch")
    expects(method in ("auto", "scan", "kernel"),
            f"unknown method {method!r} (auto|scan|kernel)")
    expects(metric in _L2_IP_METRICS,
            "metric %s is not ported yet (L2 family and InnerProduct only)",
            getattr(metric, "name", metric))
    k = min(k, db.shape[0])
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


def knn_merge_parts(in_keys, in_values, select_min: bool = True,
                    translations: Optional[Sequence[int]] = None,
                    handle=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-part kNN results ``(n_parts, n_queries, k)`` into the
    global top-k; ``translations`` offsets each part's local ids. Ties go
    to the lower part, then the lower rank within it. Returns ``(keys
    (n_queries, k), values (n_queries, k))``. The reference's
    ``n_samples`` argument, which it does not read either, is not
    taken."""
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN over one database part or a list of parts. Parts are
    searched one by one and merged; part p's ids start at
    ``global_id_offset`` plus the rows of the parts before it. Returns
    ``(distances (n_queries, k), int32 indices (n_queries, k))``."""
    metric = resolve_metric(metric)
    parts = list(index) if isinstance(index, (list, tuple)) else [index]
    expects(len(parts) >= 1, "index must contain at least one part")
    if len(parts) == 1:
        d, i = tiled_brute_force_knn(queries, parts[0], k, metric, metric_arg,
                                     method=method, handle=handle)
        if global_id_offset:
            i = i + global_id_offset
        return d, i

    queries = as_float(queries, handle)
    parts = [as_float(p, handle, queries.device) for p in parts]
    expects_finite("brute_force.knn", queries, *parts)
    select_min = value_form_select_min(metric)
    all_d, all_i, offsets = [], [], []
    base = global_id_offset
    for p in parts:
        pd, pi = _knn_one_part(queries, p, min(k, p.shape[0]), metric,
                               _TILE_DB, method)
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
