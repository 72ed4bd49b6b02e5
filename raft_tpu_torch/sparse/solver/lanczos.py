"""Lanczos eigensolver for sparse symmetric matrices.

Port of ``raft_tpu/sparse/solver/lanczos.py`` (RAFT's
``sparse/solver/lanczos.cuh``): ``ncv`` Lanczos steps, each one SpMV
(:func:`sparse.linalg.spmv`, fixed-order row sums) and two passes of full
reorthogonalisation against the stored basis; a step whose residual norm
falls below 1e-5 restarts from a random direction orthogonal to the
basis and records beta = 0. The tridiagonal matrix's ``eigh`` gives the
Ritz values, and the Ritz vectors are normalised.

The start vector and the restart directions are drawn from a
``torch.Generator`` seeded with ``seed`` on the matrix's device, so they
differ from the reference's ``jax.random`` draws; :func:`_lanczos_basis`
and :func:`_eigs_from` take them as tensors, which is how the tests hand
both packages the same draws. Two runs with one seed agree bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.sparse.linalg import spmv
from raft_tpu_torch.sparse.types import CSR


def _lanczos_basis(a: CSR, v0: torch.Tensor, R: torch.Tensor, ncv: int):
    """The ``ncv``-step Krylov basis ``V (ncv, n)`` and the tridiagonal
    coefficients ``alpha (ncv,)``, ``beta (ncv,)`` (beta[i] links step i
    to i + 1), from the start vector ``v0`` and one restart direction per
    step (the rows of ``R``)."""
    n = v0.shape[0]
    V = torch.zeros((ncv, n), dtype=v0.dtype, device=v0.device)
    alphas = torch.zeros(ncv, dtype=v0.dtype, device=v0.device)
    betas = torch.zeros(ncv, dtype=v0.dtype, device=v0.device)
    v = v0 / torch.linalg.vector_norm(v0)
    for i in range(ncv):
        w = spmv(a, v)
        alpha = torch.dot(w, v)
        w = w - alpha * v
        w = w - V.T @ (V @ w)
        w = w - V.T @ (V @ w)
        beta = torch.linalg.vector_norm(w)
        V[i] = v
        rv = R[i] - V.T @ (V @ R[i])
        rv = rv - V.T @ (V @ rv)
        rv = rv / torch.clamp_min(torch.linalg.vector_norm(rv), 1e-30)
        small = beta < 1e-5
        v = torch.where(small, rv, w / torch.clamp_min(beta, 1e-30))
        alphas[i] = alpha
        betas[i] = torch.where(small, 0.0, beta)
    return V, alphas, betas


def _ncv(n: int, n_components: int, ncv: Optional[int]) -> int:
    ncv = ncv or min(n, max(4 * n_components + 32, 40))
    return min(ncv, n)


def _eigs_from(csr: CSR, n_components: int, ncv: int, v0: torch.Tensor,
               R: torch.Tensor, largest: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    a = CSR(csr.indptr, csr.indices, csr.vals.float(), csr.shape)
    V, alphas, betas = _lanczos_basis(a, v0, R, ncv)
    T = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    evals, evecs = torch.linalg.eigh(T)       # ascending
    if largest:
        idx = torch.arange(ncv - 1, ncv - n_components - 1, -1,
                           device=T.device)
    else:
        idx = torch.arange(n_components, device=T.device)
    U = V.T @ evecs[:, idx]                   # (n, n_components)
    U = U / torch.clamp_min(torch.linalg.vector_norm(U, dim=0, keepdim=True),
                            1e-30)
    return evals[idx], U


def _eigs(csr: CSR, n_components: int, ncv: Optional[int], seed: int,
          largest: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    n = csr.shape[0]
    expects(csr.shape[0] == csr.shape[1], "matrix must be square")
    expects(n_components < n, "n_components must be < n")
    ncv = _ncv(n, n_components, ncv)
    gen = torch.Generator(device=csr.vals.device).manual_seed(seed)
    v0 = torch.randn(n, generator=gen, device=csr.vals.device)
    R = torch.randn((ncv, n), generator=gen, device=csr.vals.device)
    return _eigs_from(csr, n_components, ncv, v0, R, largest)


def lanczos_smallest_eigenpairs(
    csr: CSR, n_components: int, ncv: Optional[int] = None, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The smallest eigenpairs: (eigenvalues (k,), eigenvectors (n, k))."""
    return _eigs(csr, n_components, ncv, seed, largest=False)


def lanczos_largest_eigenpairs(
    csr: CSR, n_components: int, ncv: Optional[int] = None, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The largest eigenpairs, largest first."""
    return _eigs(csr, n_components, ncv, seed, largest=True)
