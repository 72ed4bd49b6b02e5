"""Pairwise distances for the expanded (gram-based) metrics.

Port of the expanded half of ``raft_tpu/distance/pairwise.py``: L2Expanded,
L2SqrtExpanded and InnerProduct, which k-means and brute force reach. The
unexpanded and other metrics come in a later slice and raise here.

This module owns the port's float32 matrix products (:func:`gram`). The
reference computes them at ``Precision.HIGHEST`` (full f32); a TF32 tensor
core product keeps about 3 decimal digits and would break parity, so TF32
is switched off here for cuBLAS and cuDNN alike.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import as_float
from raft_tpu_torch.distance.distance_types import DistanceType, resolve_metric

# Full-f32 products, the analog of the reference's Precision.HIGHEST.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EXPANDED_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                    DistanceType.InnerProduct)


def gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y^T`` over the last two axes, in full f32."""
    return torch.matmul(x, y.transpose(-1, -2))


def row_norms_sq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1)


def l2_expanded(x, y, sqrt: bool) -> torch.Tensor:
    """``max(|x|^2 + |y|^2 - 2 x.y, 0)``, optionally square-rooted."""
    d = torch.clamp_min(row_norms_sq(x)[:, None] + row_norms_sq(y)[None, :]
                        - 2.0 * gram(x, y), 0.0)
    return torch.sqrt(d) if sqrt else d


def distance(x, y, metric=DistanceType.L2Expanded, metric_arg: float = 2.0,
             handle=None) -> torch.Tensor:
    """(m, n) distances between the rows of ``x`` and ``y`` for one of the
    expanded metrics; InnerProduct returns raw similarities."""
    metric = resolve_metric(metric)
    expects(metric in EXPANDED_METRICS,
            "metric %s is not ported yet (expanded metrics only: %s)",
            metric.name, [m.name for m in EXPANDED_METRICS])
    x = as_float(x, handle)
    y = as_float(y, handle, x.device)
    expects(x.ndim == 2 and y.ndim == 2 and x.shape[1] == y.shape[1],
            "x and y must be matrices with the same n_cols")
    if metric == DistanceType.InnerProduct:
        return gram(x, y)
    return l2_expanded(x, y, metric == DistanceType.L2SqrtExpanded)
