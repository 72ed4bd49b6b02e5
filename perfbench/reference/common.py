"""Plain-PyTorch pieces of the references: float64 distances, exact top-k
over rows in blocks, the lists a query certainly probes, and how the
index's lists hold the rows.

Nothing here imports the port: the index state it reads is the copy the
harness took (``systems/<name>.snapshot``), and the rows and queries are
the harness's own inputs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

#: Elements of one (queries x rows) float64 block.
BLOCK_ELEMS = 1 << 27
#: Rows of one float64 block of the index checks.
_ROW_BLOCK = 1 << 17
#: Relative rounding a sound float32 coarse probe may carry (of |q|^2 +
#: |c|^2); a list within twice this of the cut is not counted as certain.
PROBE_TOL = 1e-5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 stored mantissa bits, to the
    nearest (ties away from zero), as the tensor cores read it."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def sqdist(q: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(m, n) squared L2 distances in the operands' dtype, expanded form."""
    return ((q * q).sum(1)[:, None] + (y * y).sum(1)[None, :]
            - 2.0 * (q @ y.T))


def row_lists(snap: dict, n_rows: int) -> Tuple[torch.Tensor, int]:
    """``(row_list, misplaced)``: the list holding each row id (-1 for
    none) and the number of ids held other than exactly once, out of
    range, or missing."""
    idx, sizes = snap["indices"], snap["list_sizes"]
    n_lists, cap = idx.shape
    dev = idx.device
    valid = torch.arange(cap, device=dev)[None, :] < sizes[:, None].long()
    if snap.get("deleted") is not None:
        valid &= ~snap["deleted"]
    ids = idx[valid].long()
    lists = torch.arange(n_lists, device=dev)[:, None].expand(
        n_lists, cap)[valid]
    ok = (ids >= 0) & (ids < n_rows)
    count = torch.bincount(ids[ok], minlength=n_rows)
    misplaced = int((count != 1).sum()) + int((~ok).sum())
    row_list = torch.full((n_rows,), -1, dtype=torch.int64, device=dev)
    row_list[ids[ok]] = lists[ok]
    return row_list, misplaced


def blob_inertia(X: torch.Tensor, labels: torch.Tensor) -> float:
    """The inertia of the partition the rows were drawn from: the sum over
    rows of the squared distance to the mean of their blob, in float64."""
    nb = int(labels.max()) + 1
    sums = torch.zeros((nb, X.shape[1]), dtype=torch.float64,
                       device=X.device)
    for r0 in range(0, X.shape[0], _ROW_BLOCK):
        sums.index_add_(0, labels[r0:r0 + _ROW_BLOCK],
                        X[r0:r0 + _ROW_BLOCK].double())
    counts = torch.bincount(labels, minlength=nb).double()
    means = sums / counts.clamp_min(1.0)[:, None]
    total = 0.0
    for r0 in range(0, X.shape[0], _ROW_BLOCK):
        x = X[r0:r0 + _ROW_BLOCK].double()
        total += float(((x - means[labels[r0:r0 + _ROW_BLOCK]]) ** 2).sum())
    return total


def inertia_excess(X: torch.Tensor, C: torch.Tensor, row_list: torch.Tensor,
                   blob: float) -> float:
    """How far the index's lists fall short of the blobs as a clustering:
    the sum over placed rows of the squared distance to their list's
    centre, in float64, over ``blob`` (:func:`blob_inertia`), less 1.
    Trained centres sit near the blobs' means (about 0); centres left as
    they were initialised read far above."""
    C64 = C.double()
    total = 0.0
    for r0 in range(0, X.shape[0], _ROW_BLOCK):
        lab = row_list[r0:r0 + _ROW_BLOCK]
        ok = lab >= 0
        x = X[r0:r0 + _ROW_BLOCK][ok].double()
        total += float(((x - C64[lab[ok]]) ** 2).sum())
    return total / blob - 1.0


def certain_lists(Q64: torch.Tensor, C64: torch.Tensor,
                  n_probes: int) -> torch.Tensor:
    """(m, n_lists) mask of the lists that every sound probe of
    ``n_probes`` lists takes: those nearer than the (n_probes + 1)-th
    centre by more than twice the probe's rounding."""
    if n_probes >= C64.shape[0]:
        return torch.ones((Q64.shape[0], C64.shape[0]), dtype=torch.bool,
                          device=Q64.device)
    cd = sqdist(Q64, C64)
    cut = torch.kthvalue(cd, n_probes + 1, dim=1).values
    tol = PROBE_TOL * ((Q64 * Q64).sum(1) + (C64 * C64).sum(1).max())
    return cd < (cut - 2.0 * tol)[:, None]


def topk_rows(Q: torch.Tensor, rows: torch.Tensor, k: int,
              allowed: Optional[torch.Tensor] = None,
              row_list: Optional[torch.Tensor] = None,
              dtype=torch.float64, rounding=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest of ``rows`` to each query, in ``dtype`` (ascending
    distances, row ids; -1 where fewer than k rows are allowed). With
    ``allowed`` (m, n_lists) and ``row_list`` (n,) only rows in a list
    the query is allowed count. ``rounding`` (e.g. :func:`tf32`) rounds
    both operands of the product first."""
    m = Q.shape[0]
    Qd = Q.to(dtype)
    if rounding is not None:
        Qd = rounding(Qd)
    best_d = torch.full((m, k), float("inf"), dtype=dtype, device=Q.device)
    best_i = torch.full((m, k), -1, dtype=torch.int64, device=Q.device)
    step = max(1024, BLOCK_ELEMS // max(m, 1))
    for r0 in range(0, rows.shape[0], step):
        Y = rows[r0:r0 + step].to(dtype)
        if rounding is not None:
            Y = rounding(Y)
        d = sqdist(Qd, Y)
        if allowed is not None:
            lst = row_list[r0:r0 + step]
            ok = allowed[:, lst.clamp_min(0)] & (lst >= 0)[None, :]
            d.masked_fill_(~ok, float("inf"))
        ids = torch.arange(r0, r0 + Y.shape[0], device=Q.device)
        cd = torch.cat([best_d, d], 1)
        ci = torch.cat([best_i, ids[None, :].expand(m, -1)], 1)
        best_d, pos = torch.topk(cd, k, dim=1, largest=False)
        best_i = torch.gather(ci, 1, pos)
    best_i = torch.where(torch.isinf(best_d), -1, best_i)
    return best_d, best_i


def judge_answers(n_rows: int, prog_d: torch.Tensor, prog_i: torch.Tensor,
                  k: int, exact_i: torch.Tensor, dist_of, best_d: torch.Tensor,
                  scale: torch.Tensor) -> dict:
    """Readings of one set of answers against the reference.

    ``prog_d`` / ``prog_i`` (m, k) are the program's answers, ``exact_i``
    (m, k) the exact neighbours over every row, ``dist_of(safe_ids)`` the
    reference's float64 distances (m, k) of the given row ids in the
    metric the program states, ``best_d`` (m, k) the reference's k least of
    those distances over the rows of the lists each query certainly
    probes, ascending, and ``scale`` (m,) each query's scale.

    * ``bad_ids``: returned ids that are out of range, -1, or repeated in
      a row;
    * ``gap``: the widest amount by which the program's j-th nearest is
      farther than the reference's j-th nearest, over the scale;
    * ``dist_err``: the widest gap between a returned distance and the
      reference's distance of its id, over the scale;
    * ``recall``: the share of the exact neighbours returned.
    """
    ids = prog_i.long()
    in_range = (ids >= 0) & (ids < n_rows)
    srt = torch.sort(torch.where(in_range, ids, -1 - torch.arange(
        k, device=ids.device)[None, :]), dim=1).values
    dup = torch.zeros_like(in_range)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    good = ~((~in_range).any(1) | dup.any(1))
    bad = int((~in_range).sum()) + int(dup.sum())
    d64 = dist_of(ids.clamp(0, n_rows - 1))
    err = (prog_d.double() - d64).abs() / scale[:, None]
    excess = (torch.sort(d64, dim=1).values - best_d) / scale[:, None]
    hits = (ids[:, :, None] == exact_i[:, None, :]).any(2).double()
    any_good = bool(good.any())
    return {"bad_ids": bad,
            "gap": float(excess[good].max()) if any_good else 1.0,
            "dist_err": float(err[good].max()) if any_good else 1.0,
            "recall": float(hits.mean())}
