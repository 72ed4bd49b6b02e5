"""Shared helpers of the raft_tpu_torch parity tests (no tests here).

Every parity test makes its inputs with numpy from a seed and feeds the
same arrays to a raft_tpu function (JAX on the CPU, Pallas kernels in
interpret mode) and to its raft_tpu_torch counterpart on CPU tensors.

Tolerances:

* integer-valued data (values in [0, 8)) keeps every gram entry and norm
  exact in f32, so distances must agree exactly and ids bit for bit,
  ties included;
* Gaussian data: the two packages sum in different orders, so squared L2
  and inner products agree to ``GAUSS_TOL`` (rtol 1e-5, atol 1e-4).
"""

import numpy as np
import torch

GAUSS_TOL = dict(rtol=1e-5, atol=1e-4)

# The suite runs several workers side by side; one intra-op thread per
# worker keeps these small tensors from crowding out the timing-sensitive
# JAX tests of the other workers.
torch.set_num_threads(1)


def t(a, dtype=None) -> torch.Tensor:
    """A CPU tensor of the numpy (or JAX) array ``a``."""
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def n(x) -> np.ndarray:
    """numpy view of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def int_data(rng, shape, hi: int = 8) -> np.ndarray:
    """Integer-valued float32 data: exact grams, real ties."""
    return rng.integers(0, hi, size=shape).astype(np.float32)


def gauss(rng, shape) -> np.ndarray:
    return rng.standard_normal(shape).astype(np.float32)


def blobs(rng, n_rows: int, dim: int, n_blobs: int, std: float = 1.0):
    """Gaussian blobs around centers uniform in [-10, 10] (float32)."""
    centers = rng.uniform(-10, 10, (n_blobs, dim)).astype(np.float32)
    labels = rng.permutation(np.arange(n_rows) % n_blobs)
    return (centers[labels]
            + std * rng.standard_normal((n_rows, dim))).astype(np.float32)


def recall(found, truth) -> float:
    """Mean share of each row of ``truth`` present in ``found``."""
    found, truth = n(found), n(truth)
    k = truth.shape[1]
    return float(np.mean([len(np.intersect1d(found[r], truth[r])) / k
                          for r in range(truth.shape[0])]))


def inertia(X, centroids) -> float:
    """Sum of squared distances of rows to their nearest centroid."""
    X = np.asarray(X, np.float64)
    C = np.asarray(centroids, np.float64)
    d = ((X[:, None, :] - C[None, :, :]) ** 2).sum(-1)
    return float(d.min(axis=1).sum())


def cluster_sizes(X, centroids) -> np.ndarray:
    X = np.asarray(X, np.float64)
    C = np.asarray(centroids, np.float64)
    d = ((X[:, None, :] - C[None, :, :]) ** 2).sum(-1)
    return np.bincount(d.argmin(axis=1), minlength=C.shape[0])
