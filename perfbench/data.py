"""The cell's inputs, made on the device from the seed.

Rows are Gaussian blobs: centres uniform in [center_low, center_high],
each row a centre plus N(0, sigma^2) per feature, every blob holding
``n_rows / n_blobs`` rows in a seeded order. Queries are rows picked by
the seed plus N(0, query_noise^2). The same seed gives the same rows and
queries; the port and the reference are handed the same tensors.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on ``device`` for one stream of the seed."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed & _MASK, stream])
                      .generate_state(1, np.uint64)[0]) & _MASK)
    return g


def host_rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one stream of the seed (traffic schedules,
    samples)."""
    return np.random.default_rng([seed & _MASK, stream])


def blobs(cfg: dict, seed: int, device, center_seed=None):
    """``(rows, labels)``: the (n_rows, dim) float32 dataset and each row's
    blob. ``center_seed`` (when given) draws the blob centres instead of
    ``seed``, so that every seed has the same blobs, its rows in another
    order and with other noise."""
    ds = cfg["dataset"]
    n, d, nb = cfg["n_rows"], cfg["dim"], ds["n_blobs"]
    g = generator(seed if center_seed is None else center_seed, 1, device)
    centers = torch.empty((nb, d), device=device).uniform_(
        ds["center_low"], ds["center_high"], generator=g)
    if center_seed is not None:
        g = generator(seed, 1, device)
    labels = torch.randperm(n, generator=g, device=device) % nb
    X = torch.randn((n, d), generator=g, device=device)
    X.mul_(ds["sigma"]).add_(centers[labels])
    return X, labels


def rows(cfg: dict, seed: int, device, center_seed=None) -> torch.Tensor:
    """The (n_rows, dim) float32 dataset of :func:`blobs`."""
    return blobs(cfg, seed, device, center_seed)[0]


def queries(cfg: dict, X: torch.Tensor, n: int, seed: int,
            stream: int = 2) -> torch.Tensor:
    """(n, dim) float32 queries: seeded rows of ``X`` plus unit noise."""
    g = generator(seed, stream, X.device)
    src = torch.randint(0, X.shape[0], (n,), generator=g, device=X.device)
    noise = torch.randn((n, X.shape[1]), generator=g, device=X.device)
    return X[src] + cfg["dataset"]["query_noise"] * noise
