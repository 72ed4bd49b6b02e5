"""Plain reference of the IVF-Flat configurations.

It judges the program's answers in float64 and holds the index that the
program built to what the configuration states:

* the index: every row id held exactly once (``misplaced``), each stored
  row bit for bit the harness's row (``data_mismatch``), each row in
  the list of its nearest centre up to rounding (``assign_gap``), and the
  centres trained (``inertia_excess``: the lists' inertia against that of
  the blobs the rows were drawn from);
* a search: the answers against the exact k nearest of the rows in the
  lists the query certainly probes (``gap``, ``dist_err``, ``bad_ids``),
  and against the exact k nearest of all rows (``recall``).

The centres are the program's: k-means from a seed does not repeat on
the card, so the reference cannot train them again. It takes them, and
the lists' membership, from the index state, and checks that stage by
itself (the placement, assignment and inertia checks) and end to end
(recall).

``control_*`` put the reference in the program's place one precision
below the configuration's: float32 products on TF32-rounded operands.
"""

from __future__ import annotations

import torch

from perfbench.reference.common import (_ROW_BLOCK, certain_lists,
                                        inertia_excess, judge_answers,
                                        row_lists, sqdist, tf32, topk_rows)


def assign_gap(X: torch.Tensor, C: torch.Tensor,
               labels: torch.Tensor) -> float:
    """The widest amount by which a row's list centre is farther than its
    nearest centre, in float64, over |x|^2 + max|c|^2."""
    C64 = C.double()
    cmax = (C64 * C64).sum(1).max()
    worst = 0.0
    for r0 in range(0, X.shape[0], _ROW_BLOCK):
        x = X[r0:r0 + _ROW_BLOCK].double()
        lab = labels[r0:r0 + _ROW_BLOCK].long()
        d = sqdist(x, C64)
        ok = lab >= 0
        own = d.gather(1, lab.clamp_min(0)[:, None])[:, 0]
        g = (own - d.min(1).values) / ((x * x).sum(1) + cmax)
        if bool(ok.any()):
            worst = max(worst, float(g[ok].max()))
    return worst


def data_mismatch(snap: dict, X: torch.Tensor) -> int:
    """Stored rows that differ from the harness's row of their id."""
    idx, sizes, data = snap["indices"], snap["list_sizes"], snap["data"]
    valid = (torch.arange(idx.shape[1], device=idx.device)[None, :]
             < sizes[:, None].long())
    ids = idx[valid].long().clamp(0, X.shape[0] - 1)
    return int((data[valid] != X[ids]).any(1).sum())


def judge_index(snap: dict, X: torch.Tensor, cfg: dict, seed: int,
                blob: float) -> dict:
    """``blob``: the rows' blob inertia (``common.blob_inertia``)."""
    row_list, misplaced = row_lists(snap, X.shape[0])
    out = {"misplaced": misplaced,
           "assign_gap": assign_gap(X, snap["centers"], row_list),
           "inertia_excess": inertia_excess(X, snap["centers"], row_list,
                                            blob)}
    if "data" in snap:
        out["data_mismatch"] = data_mismatch(snap, X)
    return out


def prepare(snap: dict, X: torch.Tensor, cfg: dict) -> dict:
    """What every search judgement of one index shares."""
    row_list, _ = row_lists(snap, X.shape[0])
    return {"row_list": row_list, "C64": snap["centers"].double(),
            "rows": X,
            "row_norm_max": float((X * X).sum(1).max().double())}


def judge_search(prep: dict, Q: torch.Tensor, k: int, prog_d, prog_i,
                 cfg: dict) -> dict:
    X = prep["rows"]
    Q64 = Q.double()
    allowed = certain_lists(Q64, prep["C64"], cfg["n_probes"])
    _, exact_i = topk_rows(Q, X, k)
    best_d, _ = topk_rows(Q, X, k, allowed, prep["row_list"])

    def dist_of(ids):
        y = X[ids.reshape(-1)].double().reshape(ids.shape + (-1,))
        return ((Q64[:, None, :] - y) ** 2).sum(2)

    scale = (Q64 * Q64).sum(1) + prep["row_norm_max"]
    out = judge_answers(X.shape[0], prog_d.to(Q.device),
                        prog_i.to(Q.device), k, exact_i, dist_of, best_d,
                        scale)
    out["n"] = Q.shape[0]
    return out


def control_search(prep: dict, Q: torch.Tensor, k: int, cfg: dict):
    """The reference search in TF32: probe and scan with float32 products
    of TF32-rounded operands, over the lists of the program's index."""
    C = prep["C64"].float()
    cd = sqdist(tf32(Q), tf32(C))
    probe = torch.topk(cd, min(cfg["n_probes"], C.shape[0]), dim=1,
                       largest=False).indices
    allowed = torch.zeros_like(cd, dtype=torch.bool)
    allowed.scatter_(1, probe, True)
    d, i = topk_rows(Q, prep["rows"], k, allowed, prep["row_list"],
                     dtype=torch.float32, rounding=tf32)
    return d, i


def control_labels(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Nearest-centre labels in TF32 (the reference's assignment one
    precision below the configuration's)."""
    Ct = tf32(C.float())
    out = torch.empty(X.shape[0], dtype=torch.int64, device=X.device)
    for r0 in range(0, X.shape[0], _ROW_BLOCK):
        out[r0:r0 + _ROW_BLOCK] = sqdist(tf32(X[r0:r0 + _ROW_BLOCK]),
                                         Ct).argmin(1)
    return out
