"""Refinement: re-rank ANN candidates with exact distances.

Port of ``raft_tpu/neighbors/refine.py``. ``refine``: the candidates are
gathered into a dense (n_queries, n_cand, d) block, scored exactly against
their query and the best k kept. Candidate id -1 (padding) is skipped.
Candidate ids are rows of the dataset: int64 ids stay int64 (the
reference casts every candidate matrix to int32), any other integer
dtype becomes int32. ``refine_host`` re-ranks host numpy arrays on the
port's native runtime (``raft_tpu_torch._native``), L2 metrics only.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import as_float, as_tensor
from raft_tpu_torch.core.sentinels import worst_value
from raft_tpu_torch.distance.distance_types import (
    DistanceType, resolve_metric, value_form_select_min)
from raft_tpu_torch.matrix.select_k import select_k

# Element budget of one gathered candidate block (~256 MB of f32).
_BLOCK = 1 << 26


def _exact(gathered, queries, metric: DistanceType) -> torch.Tensor:
    diffq = gathered - queries[:, None, :]
    if metric in (DistanceType.L2Expanded, DistanceType.L2Unexpanded):
        return torch.sum(diffq * diffq, dim=-1)
    if metric in (DistanceType.L2SqrtExpanded,
                  DistanceType.L2SqrtUnexpanded):
        return torch.sqrt(torch.sum(diffq * diffq, dim=-1))
    if metric == DistanceType.InnerProduct:
        return torch.einsum("qcd,qd->qc", gathered, queries)
    if metric == DistanceType.CosineExpanded:
        num = torch.einsum("qcd,qd->qc", gathered, queries)
        den = (torch.linalg.vector_norm(gathered, dim=-1)
               * torch.linalg.vector_norm(queries, dim=-1)[:, None])
        return 1.0 - num / torch.clamp_min(den, 1e-30)
    if metric == DistanceType.L1:
        return torch.sum(torch.abs(diffq), dim=-1)
    raise ValueError(f"refine: unsupported metric {metric!r}")


def refine(dataset, queries, candidates, k: int,
           metric: Union[str, DistanceType] = DistanceType.L2Expanded,
           handle=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank ``candidates`` (n_queries, n_cand) by exact distance and
    keep the best k. Returns ``(distances (n_queries, k), ids)``: int64
    for int64 candidates, else int32."""
    metric = resolve_metric(metric)
    Q = as_float(queries, handle)
    X = as_float(dataset, handle, Q.device)
    cand = as_tensor(candidates, handle, Q.device)
    if cand.dtype != torch.int64:
        cand = cand.to(torch.int32)
    expects(cand.ndim == 2, "candidates must be (n_queries, n_candidates)")
    expects(k <= cand.shape[1], "k must be <= n_candidates")
    select_min = value_form_select_min(metric)
    rows = max(1, _BLOCK // max(cand.shape[1] * X.shape[1], 1))
    dist, idx = [], []
    for s in range(0, cand.shape[0], rows):
        c = cand[s:s + rows]
        invalid = c < 0
        d = _exact(X[torch.clamp_min(c, 0).long()], Q[s:s + rows], metric)
        d = torch.where(invalid, worst_value(select_min), d)
        dd, pos = select_k(d, k, select_min=select_min)
        dist.append(dd)
        idx.append(torch.gather(c, 1, pos.long()))
    return torch.cat(dist), torch.cat(idx)


def refine_host(dataset, queries, candidates, k: int,
                metric: Union[str, DistanceType] = DistanceType.L2Expanded,
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Re-rank on the host: numpy (or host-copied) inputs through the
    native runtime's threaded exact scan, for the L2 metrics only; the
    Sqrt metrics take the square root of its squared distances. Returns
    numpy ``(distances (q, k) float32, ids (q, k) int64)``."""
    from raft_tpu_torch import _native

    metric = resolve_metric(metric)
    expects(metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                       DistanceType.L2Unexpanded,
                       DistanceType.L2SqrtUnexpanded),
            f"refine_host supports L2 metrics, got {metric!r}")
    d, i = _native.refine_host(_host(dataset), _host(queries),
                               _host(candidates), k)
    if metric in (DistanceType.L2SqrtExpanded,
                  DistanceType.L2SqrtUnexpanded):
        d = np.sqrt(d)
    return d, i


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
