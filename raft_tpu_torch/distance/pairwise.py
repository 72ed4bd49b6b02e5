"""Pairwise distances between row sets: all 20 metrics of the reference.

Port of ``raft_tpu/distance/pairwise.py``. Two families, as there:

* **expanded** metrics are a gram product plus a norms epilogue:
  L2Expanded and its square root, InnerProduct, Cosine, Correlation,
  Hellinger, RusselRao, Jaccard and Dice;
* **unexpanded** metrics reduce an elementwise function of ``(x_ik,
  y_jk)`` over k. :func:`_blockwise` evaluates them over blocks of rows
  of x and of y, so the broadcast (rows, cols, k) block stays within
  ``_BLOCK_ELEMS`` elements whatever the operands' sizes. L1 and Linf are
  the p = 1 and p = inf norms of ``torch.cdist``, which reduces without
  the broadcast (in f32 for f16 / bf16 rows, which it does not take).

Haversine is its own closed form on 2-column (lat, lon) rows. The
reference leaves all of these to XLA, so stock torch ops serve them; each
edge rule of the reference is kept (0/0 terms of Canberra, Bray-Curtis,
Jaccard and Dice; ``_safe_log``; none in Cosine and Correlation, whose
zero rows give NaN there too).

This module owns the port's float32 distance products (:func:`gram`). The
reference computes them at ``Precision.HIGHEST`` (full f32); a TF32 tensor
core product keeps about 3 decimal digits and would break parity, so each
runs through ``linalg.blas.full_f32_matmul``, which holds full f32 for
the product whatever TF32 setting the caller made.
"""

from __future__ import annotations

import functools

import torch

from raft_tpu_torch.core.error import expects, fail
from raft_tpu_torch.core.nvtx import traced
from raft_tpu_torch.core.resources import as_float
from raft_tpu_torch.distance.distance_types import DistanceType, resolve_metric
from raft_tpu_torch.linalg.blas import (DEFAULT_PRECISION, full_f32_matmul,
                                       resolve_precision)

# Element budget of one broadcast (rows, cols, k) block of the unexpanded
# metrics (64 MB of f32, the reference's budget), and the widest column
# block.
_BLOCK_ELEMS = 1 << 24
_BLOCK_COLS = 8192


def gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y^T`` over the last two axes, in full f32
    (``linalg.blas.full_f32_matmul``)."""
    return full_f32_matmul(x, y.transpose(-1, -2))


def row_norms_sq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1)


# ---------------------------------------------------------------------------
# Expanded (gram-based) metrics


def l2_expanded(x, y, sqrt: bool) -> torch.Tensor:
    """``max(|x|^2 + |y|^2 - 2 x.y, 0)``, optionally square-rooted."""
    d = torch.clamp_min(row_norms_sq(x)[:, None] + row_norms_sq(y)[None, :]
                        - 2.0 * gram(x, y), 0.0)
    return torch.sqrt(d) if sqrt else d


def _cosine(x, y) -> torch.Tensor:
    """``1 - x.y / (|x| |y|)``."""
    xn = torch.sqrt(row_norms_sq(x))
    yn = torch.sqrt(row_norms_sq(y))
    return 1.0 - gram(x, y) / (xn[:, None] * yn[None, :])


def _correlation(x, y) -> torch.Tensor:
    """``1 - (k x.y - sx sy) / sqrt((k x2 - sx^2)(k y2 - sy^2))``."""
    k = x.shape[1]
    sx = torch.sum(x, dim=1)
    sy = torch.sum(y, dim=1)
    numer = k * gram(x, y) - sx[:, None] * sy[None, :]
    q = k * row_norms_sq(x) - sx * sx
    r = k * row_norms_sq(y) - sy * sy
    return 1.0 - numer / torch.sqrt(q[:, None] * r[None, :])


def _hellinger(x, y) -> torch.Tensor:
    """``sqrt(max(1 - sqrt|x| . sqrt|y|, 0))``."""
    g = gram(torch.sqrt(torch.abs(x)), torch.sqrt(torch.abs(y)))
    return torch.sqrt(torch.clamp_min(1.0 - g, 0.0))


def _russelrao(x, y) -> torch.Tensor:
    """``(k - x.y) / k``."""
    k = x.shape[1]
    return (k - gram(x, y)) * (1.0 / k)


def _jaccard(x, y) -> torch.Tensor:
    """``1 - x.y / (|x|^2 + |y|^2 - x.y)``; two empty rows are at 0."""
    g = gram(x, y)
    union = row_norms_sq(x)[:, None] + row_norms_sq(y)[None, :] - g
    nz = union != 0
    return torch.where(nz, 1.0 - g / torch.where(nz, union, 1.0), 0.0)


def _dice(x, y) -> torch.Tensor:
    """``1 - 2 x.y / (|x|^2 + |y|^2)``; two empty rows are at 0."""
    g = gram(x, y)
    denom = row_norms_sq(x)[:, None] + row_norms_sq(y)[None, :]
    nz = denom != 0
    return torch.where(nz, 1.0 - 2.0 * g / torch.where(nz, denom, 1.0), 0.0)


def _haversine(x, y) -> torch.Tensor:
    """Great-circle distance of (lat, lon) radian pairs, unit radius:
    (..., m, 2) x (..., n, 2) -> (..., m, n), the leading axes
    broadcast."""
    expects(x.shape[-1] == 2 and y.shape[-1] == 2,
            "haversine requires 2-d points")
    lat1, lon1 = x[..., 0][..., :, None], x[..., 1][..., :, None]
    lat2, lon2 = y[..., 0][..., None, :], y[..., 1][..., None, :]
    sin_0 = torch.sin(0.5 * (lat1 - lat2))
    sin_1 = torch.sin(0.5 * (lon1 - lon2))
    rdist = sin_0 * sin_0 + torch.cos(lat1) * torch.cos(lat2) * sin_1 * sin_1
    return 2.0 * torch.arcsin(torch.sqrt(rdist))


# ---------------------------------------------------------------------------
# Unexpanded metrics: each core reduces the trailing axis of broadcastable
# (..., k) blocks of x and y.


def _core_l2(xb, yb):
    d = xb - yb
    return torch.sum(d * d, dim=-1)


def _core_canberra(xb, yb):
    """``sum |x - y| / (|x| + |y|)`` with 0/0 := 0."""
    diff = torch.abs(xb - yb)
    add = torch.abs(xb) + torch.abs(yb)
    nz = add != 0
    return torch.sum(torch.where(nz, diff / torch.where(nz, add, 1.0), 0.0),
                     dim=-1)


def _core_lp(xb, yb, p: float):
    return torch.sum(torch.abs(xb - yb) ** p, dim=-1)


def _core_hamming(xb, yb):
    return torch.sum((xb != yb).to(xb.dtype), dim=-1)


def _core_braycurtis(xb, yb):
    """``sum |x - y| / sum |x + y|`` with 0/0 := 0."""
    num = torch.sum(torch.abs(xb - yb), dim=-1)
    den = torch.sum(torch.abs(xb + yb), dim=-1)
    nz = den != 0
    return torch.where(nz, num / torch.where(nz, den, 1.0), 0.0)


def _safe_log(v):
    return torch.log(torch.where(v > 0, v, 1.0))


def _core_jensen_shannon(xb, yb):
    """``sum -x (log m - log x) - y (log m - log y)``, m = (x + y) / 2."""
    m = 0.5 * (xb + yb)
    logm = _safe_log(m)
    t = -xb * (logm - _safe_log(xb)) - yb * (logm - _safe_log(yb))
    return torch.sum(t, dim=-1)


def _core_kl(xb, yb):
    """``sum x (log x - log y)`` over x != 0 (log y taken as 0 at y = 0)."""
    t = xb * (_safe_log(xb) - torch.where(yb != 0, _safe_log(yb), 0.0))
    return torch.sum(torch.where(xb != 0, t, 0.0), dim=-1)


def _blockwise(core, x, y) -> torch.Tensor:
    """``core((rows, 1, k), (1, cols, k)) -> (rows, cols)`` over blocks of
    both operands, each broadcast block within ``_BLOCK_ELEMS``."""
    m, k = x.shape
    n = y.shape[0]
    cols = max(1, min(n, _BLOCK_COLS, _BLOCK_ELEMS // max(k, 1)))
    rows = max(1, min(m, _BLOCK_ELEMS // max(cols * k, 1)))
    out = torch.empty((m, n), dtype=torch.promote_types(x.dtype, y.dtype),
                      device=x.device)
    for c in range(0, n, cols):
        yb = y[None, c:c + cols]
        for r in range(0, m, rows):
            out[r:r + rows, c:c + cols] = core(x[r:r + rows, None], yb)
    return out


# ---------------------------------------------------------------------------
# Public API


@traced
def distance(x, y, metric=DistanceType.L2SqrtExpanded,
             metric_arg: float = 2.0, precision=DEFAULT_PRECISION,
             handle=None) -> torch.Tensor:
    """The (m, n) distances between the rows of ``x`` and ``y``.
    ``metric_arg`` is the Minkowski p of LpUnexpanded. InnerProduct gives
    raw similarities; Cosine and Correlation give ``1 - similarity``.
    ``precision`` takes the reference's names (None, "default", "high",
    "highest"); the port computes at full f32 for each."""
    resolve_precision(precision)
    metric = resolve_metric(metric)
    x = as_float(x, handle)
    y = as_float(y, handle, x.device)
    expects(x.ndim == 2 and y.ndim == 2, "x and y must be matrices")
    expects(x.shape[1] == y.shape[1], "x and y must have the same n_cols")
    M = DistanceType
    if metric in (M.L2Expanded, M.L2SqrtExpanded):
        return l2_expanded(x, y, metric == M.L2SqrtExpanded)
    if metric == M.InnerProduct:
        return gram(x, y)
    expanded = {M.CosineExpanded: _cosine, M.CorrelationExpanded: _correlation,
                M.HellingerExpanded: _hellinger,
                M.RusselRaoExpanded: _russelrao, M.JaccardExpanded: _jaccard,
                M.DiceExpanded: _dice, M.Haversine: _haversine}
    if metric in expanded:
        return expanded[metric](x, y)
    if metric in (M.L1, M.Linf):
        # cdist takes f32 and f64 only: half-precision rows are reduced in
        # f32 and the distances returned in their dtype.
        out = torch.promote_types(x.dtype, y.dtype)
        return torch.cdist(x.float(), y.float(),
                           p=1.0 if metric == M.L1 else float("inf")).to(out)
    if metric in (M.L2Unexpanded, M.L2SqrtUnexpanded):
        d = _blockwise(_core_l2, x, y)
        return torch.sqrt(d) if metric == M.L2SqrtUnexpanded else d
    if metric == M.LpUnexpanded:
        p = float(metric_arg)
        return _blockwise(functools.partial(_core_lp, p=p), x, y) ** (1.0 / p)
    if metric == M.HammingUnexpanded:
        return _blockwise(_core_hamming, x, y) * (1.0 / x.shape[1])
    if metric == M.Canberra:
        return _blockwise(_core_canberra, x, y)
    if metric == M.BrayCurtis:
        return _blockwise(_core_braycurtis, x, y)
    if metric == M.JensenShannon:
        return torch.sqrt(0.5 * _blockwise(_core_jensen_shannon, x, y))
    if metric == M.KLDivergence:
        return 0.5 * _blockwise(_core_kl, x, y)
    fail("unsupported metric %r", metric)


@traced
def pairwise_distance(x, y, metric: str = "euclidean", p: float = 2.0,
                      precision=DEFAULT_PRECISION,
                      handle=None) -> torch.Tensor:
    """Runtime-metric pairwise distance, the pylibraft surface: ``metric``
    is a name of ``DISTANCE_TYPES`` (or a ``DistanceType``), ``p`` the
    Minkowski exponent, ``precision`` as in :func:`distance`."""
    return distance(x, y, metric=resolve_metric(metric), metric_arg=p,
                    precision=precision, handle=handle)
