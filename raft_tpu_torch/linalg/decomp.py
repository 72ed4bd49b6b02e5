"""Matrix decompositions: QR, eigendecomposition, SVD, randomized SVD,
least squares and the Cholesky rank-one update.

Port of ``raft_tpu/linalg/decomp.py`` (RAFT's ``qr.cuh``, ``eig.cuh``,
``svd.cuh``, ``rsvd.cuh``, ``lstsq.cuh`` and ``cholesky_r1_update.cuh``).
The factorizations are ``torch.linalg``'s (cuSOLVER on the card), as the
reference leaves them to XLA; the randomized SVD keeps its range finder
and power iterations, and the rank-one update its column recurrence.
Products run at full f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.mdarray import as_array
from raft_tpu_torch.core.resources import Resources, ensure_handle


def qr_get_q(x) -> torch.Tensor:
    """The Q factor of a thin QR."""
    return torch.linalg.qr(as_array(x), mode="reduced").Q


def qr_get_qr(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """The thin QR factors ``(Q, R)``."""
    q, r = torch.linalg.qr(as_array(x), mode="reduced")
    return q, r


def eig_dc(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition (``syevd``): eigenvalues ascending,
    eigenvectors as columns."""
    w, v = torch.linalg.eigh(as_array(x))
    return w, v


def eig_jacobi(x, tol: float = 1e-7, sweeps: int = 15
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's Jacobi eigensolver; ``tol`` and ``sweeps`` are kept
    for its signature and the solve is :func:`eig_dc`'s, as there."""
    del tol, sweeps
    return eig_dc(x)


def eig_sel_dc(x, n_eig_vals: int, smallest: bool = True):
    """The ``n_eig_vals`` smallest (or largest) eigenpairs, ascending."""
    w, v = eig_dc(x)
    if smallest:
        return w[:n_eig_vals], v[:, :n_eig_vals]
    return w[-n_eig_vals:], v[:, -n_eig_vals:]


def svd_qr(x, gen_u: bool = True, gen_v: bool = True
           ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                      Optional[torch.Tensor]]:
    """Thin SVD ``(U, S descending, V)``, V holding the right singular
    vectors as columns (not V^T), as in the reference."""
    u, s, vt = torch.linalg.svd(as_array(x), full_matrices=False)
    return (u if gen_u else None), s, (vt.T if gen_v else None)


def svd_eig(x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SVD of a tall matrix through the eigendecomposition of X^T X:
    ``(U, S descending, V)``."""
    x = as_array(x)
    w, v = torch.linalg.eigh(x.T @ x)
    w, v = w.flip(0), v.flip(1)
    s = torch.sqrt(torch.clamp_min(w, 0))
    u = (x @ v) / torch.where(s < 1e-10, 1.0, s)[None, :]
    return u, s, v


def _sketch_generator(handle: Resources, seed: int,
                      device: torch.device) -> torch.Generator:
    """A generator on ``device`` derived from the handle's generator and
    ``seed`` (the reference's ``fold_in``); the handle's own stream does
    not advance."""
    base = handle.get_resource("generator").initial_seed()
    mixed = (base * 0x9E3779B97F4A7C15 + seed) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def rsvd(x, k: int, p: Optional[int] = None, n_iters: int = 2,
         handle: Optional[Resources] = None, seed: int = 0
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Randomized SVD of rank ``k``: a Gaussian sketch of ``k + p``
    columns, ``n_iters`` power iterations with QR re-orthogonalization,
    then the SVD of the small projected matrix. Returns ``(U, S, V)``.
    The sketch is drawn from the handle's generator (a new handle on
    ``x``'s device when None) folded with ``seed``."""
    x = as_array(x)
    m, n = x.shape
    if p is None:
        p = min(2 * k, n - k) if n > k else 0
    ell = min(k + p, min(m, n))
    handle = ensure_handle(handle, x.device)
    gen = _sketch_generator(handle, seed, x.device)
    omega = torch.randn((n, ell), generator=gen, dtype=x.dtype,
                        device=x.device)
    q = torch.linalg.qr(x @ omega).Q
    for _ in range(n_iters):
        q = torch.linalg.qr(x.T @ q).Q
        q = torch.linalg.qr(x @ q).Q
    ub, s, vt = torch.linalg.svd(q.T @ x, full_matrices=False)
    u = q @ ub
    return u[:, :k], s[:k], vt[:k, :].T


def lstsq_svd(a, b) -> torch.Tensor:
    """``argmin |a w - b|`` through the SVD pseudo-inverse (singular
    values below 1e-10 of the largest dropped)."""
    a = as_array(a)
    b = as_array(b, device=a.device)
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    s_inv = torch.where(s > 1e-10 * s[0], 1.0 / s, 0.0)
    utb = u.T @ b
    scaled = s_inv[:, None] * utb if utb.ndim == 2 else s_inv * utb
    return vt.T @ scaled


def lstsq_eig(a, b) -> torch.Tensor:
    """``argmin |a w - b|`` through the eigendecomposition of the normal
    equations (eigenvalues below 1e-10 of the largest dropped)."""
    a = as_array(a)
    b = as_array(b, device=a.device)
    w, v = torch.linalg.eigh(a.T @ a)
    w_inv = torch.where(w > 1e-10 * torch.max(w), 1.0 / w, 0.0)
    vtb = v.T @ (a.T @ b)
    scaled = w_inv[:, None] * vtb if vtb.ndim == 2 else w_inv * vtb
    return v @ scaled


def cholesky_rank_one_update(l, v, lower: bool = True) -> torch.Tensor:
    """``chol(A + v v^T)`` from ``l = chol(A)``: the rotation recurrence
    over the columns, one column a step, as the reference's scan (the
    input is not changed)."""
    l = as_array(l)
    w = as_array(v, device=l.device).to(l.dtype).clone()
    out = (l if lower else l.T).clone()
    for i in range(out.shape[0]):
        lii, wi = out[i, i], w[i]
        r = torch.sqrt(lii * lii + wi * wi)
        c = r / lii
        s = wi / lii
        col = (out[i + 1:, i] + s * w[i + 1:]) / c
        out[i + 1:, i] = col
        out[i, i] = r
        w[i + 1:] = c * w[i + 1:] - s * col
    return out if lower else out.T
