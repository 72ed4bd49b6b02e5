"""Descriptive statistics over matrices.

Port of ``raft_tpu/stats/descriptive.py``. Data matrices are
``(n_samples, n_features)``; column-wise statistics (one value per
feature, ``axis=0``) are the default. Tensors stay on their device; other
inputs go to ``cuda``. Variances are two-pass (about the mean), as in the
reference; the covariance is one centred product.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.mdarray import as_array


def _on(x, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``like``'s device (and ``dtype``)."""
    return as_array(x, dtype=dtype, device=like.device).to(like.device)


def mean(data, sample: bool = False, axis: int = 0) -> torch.Tensor:
    """Mean along ``axis``; ``sample`` divides by N - 1 instead of N."""
    x = as_array(data)
    n = x.shape[axis]
    return torch.sum(x, dim=axis) / ((n - 1) if sample else n)


def sum_(data, axis: int = 0) -> torch.Tensor:
    """Sum along ``axis``."""
    return torch.sum(as_array(data), dim=axis)


def meanvar(data, sample: bool = True, axis: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mean, var)``; ``sample`` gives the unbiased variance (N - 1)."""
    x = as_array(data)
    n = x.shape[axis]
    mu = torch.mean(x, dim=axis)
    var = torch.sum((x - mu.unsqueeze(axis)) ** 2, dim=axis)
    return mu, var / ((n - 1) if sample else n)


def vars_(data, mu=None, sample: bool = True, axis: int = 0) -> torch.Tensor:
    """Variance along ``axis`` about ``mu`` (the mean when None)."""
    x = as_array(data)
    n = x.shape[axis]
    mu = torch.mean(x, dim=axis) if mu is None else _on(mu, x)
    v = torch.sum((x - mu.unsqueeze(axis)) ** 2, dim=axis)
    return v / ((n - 1) if sample else n)


def stddev(data, mu=None, sample: bool = True, axis: int = 0) -> torch.Tensor:
    """Standard deviation along ``axis``."""
    return torch.sqrt(vars_(data, mu=mu, sample=sample, axis=axis))


def mean_center(data, mu=None, axis: int = 0) -> torch.Tensor:
    """Subtract the mean (or ``mu``) along ``axis``."""
    x = as_array(data)
    mu = torch.mean(x, dim=axis) if mu is None else _on(mu, x)
    return x - mu.unsqueeze(axis)


def mean_add(data, mu, axis: int = 0) -> torch.Tensor:
    """Add ``mu`` back along ``axis``."""
    x = as_array(data)
    return x + _on(mu, x).unsqueeze(axis)


def cov(data, mu=None, sample: bool = True, stable: bool = True
        ) -> torch.Tensor:
    """Covariance of (n_samples, n_features) data: the centred product
    (``stable``) or the expanded form X^T X / denom - n / denom mu mu^T."""
    x = as_array(data)
    n = x.shape[0]
    denom = (n - 1) if sample else n
    if stable:
        xc = mean_center(x, mu=mu)
        return (xc.T @ xc) / denom
    mu = torch.mean(x, dim=0) if mu is None else _on(mu, x)
    return (x.T @ x) / denom - torch.outer(mu, mu) * (n / denom)


def minmax(data, axis: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(min, max)`` along ``axis``."""
    x = as_array(data)
    return torch.amin(x, dim=axis), torch.amax(x, dim=axis)


def weighted_mean(data, weights, axis: int = 0) -> torch.Tensor:
    """Mean along ``axis`` with one weight per entry along it."""
    x = as_array(data)
    w = _on(weights, x, x.dtype)
    wsum = torch.sum(w)
    if x.ndim == 2:
        w = w.unsqueeze(1 - axis)
    return torch.sum(x * w, dim=axis) / wsum


def row_weighted_mean(data, weights) -> torch.Tensor:
    """Each row's mean over columns, weights of length n_cols."""
    x = as_array(data)
    w = _on(weights, x, x.dtype)
    return (x @ w) / torch.sum(w)


def col_weighted_mean(data, weights) -> torch.Tensor:
    """Each column's mean over rows, weights of length n_rows."""
    x = as_array(data)
    w = _on(weights, x, x.dtype)
    return (w @ x) / torch.sum(w)


def histogram(data, n_bins: int, lower: Optional[float] = None,
              upper: Optional[float] = None) -> torch.Tensor:
    """Per-column histogram of (n_samples, n_cols) data (a vector is one
    column): ``n_bins`` equal-width bins over [lower, upper) (the data's
    range when not given), values outside clamped into the end bins.
    Returns (n_bins, n_cols) int32 counts."""
    x = as_array(data)
    if x.ndim == 1:
        x = x[:, None]
    lo = torch.amin(x) if lower is None else torch.tensor(
        lower, dtype=x.dtype, device=x.device)
    hi = torch.amax(x) if upper is None else torch.tensor(
        upper, dtype=x.dtype, device=x.device)
    width = (hi - lo) / n_bins
    width = torch.where(width == 0, torch.ones_like(width), width)
    bins = torch.clamp(((x - lo) / width).to(torch.int32), 0, n_bins - 1)
    n_cols = x.shape[1]
    col = torch.arange(n_cols, device=x.device)
    flat = (bins.long() * n_cols + col[None, :]).reshape(-1)
    counts = torch.bincount(flat, minlength=n_bins * n_cols)
    return counts.reshape(n_bins, n_cols).to(torch.int32)


def dispersion(centroids, cluster_sizes, n_points: Optional[int] = None
               ) -> torch.Tensor:
    """Cluster dispersion for auto-k selection: with the size-weighted
    global centroid mu = sum(size_i c_i) / n_points,
    sqrt(sum_i size_i |c_i - mu|^2)."""
    c = as_array(centroids)
    sizes = _on(cluster_sizes, c).to(c.dtype)
    if n_points is None:
        n_points = torch.sum(sizes)
    mu = (sizes @ c) / n_points
    d2 = torch.sum((c - mu[None, :]) ** 2, dim=1)
    return torch.sqrt(torch.sum(sizes * d2))
