"""Plain reference of the IVF-PQ configurations.

The answers are judged by the asymmetric distance in the precision that
the configuration states for the compressed tier: for a row of list l
with codewords cw (one a subspace, concatenated) and the rotated query's
residual r = R q - R c_l,

    d = |r|^2 + |cw|^2 - 2 sum(bf16(r) * bf16(cw)),

r in float32 (the rotated query less the rotated centre), the products
of bfloat16-rounded operands, the sums and norms exact (here float64). The reference decodes the packed codes itself (little-endian
bit fields of ``pq_bits`` a code). It checks the index that the program
built:

* every row id held exactly once (``misplaced``);
* each row in the list of its nearest centre up to rounding
  (``assign_gap``);
* the coarse centres trained (``inertia_excess``, as in ``ivf_flat.py``);
* on a seeded sample of rows, each code the nearest codeword of its
  subspace's residual up to rounding (``code_gap``), and the codebooks
  trained (``book_excess``: the sample's quantization error under the
  program's codebooks against codebooks that the reference trains on
  the same residuals, plain Lloyd in float64 at the configuration's
  iterations).

A search is judged as in ``ivf_flat.py``, with that distance in place of
the true one, and its recall against the exact neighbours of the true
rows. The centres, rotation and codebooks are the program's (trained from
a seed, they do not repeat on the card); the residuals that the
reference trains its codebooks on follow the program's centres and
rotation, which the other checks hold.
"""

from __future__ import annotations

import torch

from perfbench.data import generator
from perfbench.reference.common import (certain_lists, inertia_excess,
                                        judge_answers, row_lists, sqdist,
                                        tf32, topk_rows)
from perfbench.spec import module

_flat = module("reference", "ivf_flat")

CODE_SAMPLE = 1 << 16
_SAMPLE_BLOCK = 4096


def unpack(packed: torch.Tensor, pq_dim: int, bits: int) -> torch.Tensor:
    """(..., bytes) uint8 -> (..., pq_dim) int64 codes: code j is bits
    [j * bits, (j + 1) * bits) of the row's bytes, little-endian."""
    p = packed.long()
    p = torch.cat([p, torch.zeros_like(p[..., :1])], -1)
    start = torch.arange(pq_dim, device=p.device) * bits
    lo, shift = start // 8, start % 8
    word = p[..., lo] | (p[..., lo + 1] << 8)
    return (word >> shift) & ((1 << bits) - 1)


def decode(snap: dict, n_rows: int) -> torch.Tensor:
    """Each row id's concatenated codewords (n_rows, rot_dim) float32, in
    the rotated space, from the packed codes (zeros for an id no list
    holds)."""
    idx, sizes = snap["indices"], snap["list_sizes"]
    books = snap["pq_centers"].float()            # (pq_dim, book, len)
    pq_dim = snap["pq_dim"]
    valid = (torch.arange(idx.shape[1], device=idx.device)[None, :]
             < sizes[:, None].long())
    ids = idx[valid].long()
    codes = unpack(snap["pq_codes"][valid], pq_dim, snap["pq_bits"])
    ok = (ids >= 0) & (ids < n_rows)
    cw = torch.zeros((n_rows, pq_dim * books.shape[2]),
                     dtype=torch.float32, device=idx.device)
    j = torch.arange(pq_dim, device=idx.device)
    for r0 in range(0, ids.shape[0], 1 << 18):
        sl = slice(r0, r0 + (1 << 18))
        c = codes[sl]
        cw[ids[sl][ok[sl]]] = books[j[None, :], c].reshape(
            c.shape[0], -1)[ok[sl]]
    return cw


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).double()


def sample_residuals(snap: dict, X: torch.Tensor, row_list: torch.Tensor,
                     seed: int):
    """``(rows, r)``: ``CODE_SAMPLE`` seeded placed rows and their rotated
    residuals (sample, pq_dim, pq_len) in float64."""
    g = generator(seed, 7, X.device)
    rows = torch.randperm(X.shape[0], generator=g,
                          device=X.device)[:CODE_SAMPLE]
    rows = rows[row_list[rows] >= 0]
    R = snap["rotation"].double()
    pq_dim, _, plen = snap["pq_centers"].shape
    r = (X[rows].double() - snap["centers"].double()[row_list[rows]]) @ R.T
    return rows, r.reshape(-1, pq_dim, plen)


def nearest_codes(r: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """(sample, pq_dim) index of each residual's nearest codeword, in the
    operands' dtype."""
    bn = (books * books).sum(2)[None]
    return torch.cat([
        (bn - 2.0 * torch.einsum("spl,pbl->spb", r[s0:s0 + _SAMPLE_BLOCK],
                                 books)).argmin(2)
        for s0 in range(0, r.shape[0], _SAMPLE_BLOCK)])


def quant_error(r: torch.Tensor, books: torch.Tensor) -> float:
    """Mean squared distance of each residual to its nearest codewords."""
    codes = nearest_codes(r, books)
    j = torch.arange(r.shape[1], device=r.device)[None, :]
    return float(((r - books[j, codes]) ** 2).sum((1, 2)).mean())


def lloyd_books(r: torch.Tensor, book: int, n_iters: int,
                seed: int) -> torch.Tensor:
    """Plain Lloyd codebooks (pq_dim, book, pq_len) of the residuals ``r``,
    float64, from ``book`` seeded residuals; an empty codeword stays."""
    s, pq_dim, plen = r.shape
    g = generator(seed, 8, r.device)
    pick = torch.randperm(s, generator=g, device=r.device)[:book]
    books = r[pick].transpose(0, 1).contiguous()
    base = (torch.arange(pq_dim, device=r.device) * book)[None, :]
    flat_r = r.reshape(-1, plen)
    for _ in range(n_iters):
        slot = (base + nearest_codes(r, books)).reshape(-1)
        sums = torch.zeros((pq_dim * book, plen), dtype=r.dtype,
                           device=r.device).index_add_(0, slot, flat_r)
        counts = torch.bincount(slot, minlength=pq_dim * book).to(r.dtype)
        new = (sums / counts.clamp_min(1.0)[:, None]).reshape(books.shape)
        books = torch.where((counts > 0).reshape(pq_dim, book, 1), new,
                            books)
    return books


def book_excess(snap: dict, X: torch.Tensor, row_list: torch.Tensor,
                cfg: dict, seed: int) -> float:
    """The sampled residuals' quantization error under the program's
    codebooks over that under :func:`lloyd_books` at the configuration's
    iterations, less 1."""
    _, r = sample_residuals(snap, X, row_list, seed)
    ref = lloyd_books(r, snap["pq_centers"].shape[1],
                      cfg["kmeans_n_iters"], seed)
    own = quant_error(r, snap["pq_centers"].double())
    return own / quant_error(r, ref) - 1.0


def code_gap(snap: dict, X: torch.Tensor, row_list: torch.Tensor,
             seed: int) -> float:
    """The widest amount by which a sampled row's codeword is farther from
    its subspace residual than the nearest codeword, in float64, over
    |r_j|^2 + max|b|^2."""
    idx = snap["indices"]
    n = X.shape[0]
    rows, r = sample_residuals(snap, X, row_list, seed)
    books = snap["pq_centers"].double()
    pq_dim, book, plen = books.shape
    valid = (torch.arange(idx.shape[1], device=idx.device)[None, :]
             < snap["list_sizes"][:, None].long())
    slot_of = torch.full((n,), -1, dtype=torch.int64, device=X.device)
    flat = torch.nonzero(valid.reshape(-1))[:, 0]
    slot_of[idx.reshape(-1)[flat].long()] = flat
    packed = snap["pq_codes"].reshape(-1, snap["pq_codes"].shape[2])
    codes = unpack(packed[slot_of[rows]], pq_dim, snap["pq_bits"])
    bmax = (books * books).sum(2).max(1).values[None, :]
    worst = 0.0
    for s0 in range(0, r.shape[0], _SAMPLE_BLOCK):
        rb = r[s0:s0 + _SAMPLE_BLOCK]
        d = ((rb[:, :, None, :] - books[None]) ** 2).sum(3)  # (s, pq, book)
        own = d.gather(2, codes[s0:s0 + _SAMPLE_BLOCK, :, None].long())
        g = (own[:, :, 0] - d.min(2).values) / ((rb * rb).sum(2) + bmax)
        worst = max(worst, float(g.max()))
    return worst


def control_nearest_code(res: torch.Tensor, books: torch.Tensor,
                         books_per_row: bool) -> torch.Tensor:
    """The encoding one precision below the configuration's: each
    residual's nearest codeword by float32 products of TF32-rounded
    operands (uint8 codes; the port's encoder's arguments)."""
    r, b = tf32(res.float()), tf32(books.float())
    if books_per_row:
        dot = torch.bmm(r, b.transpose(1, 2))
        bn = (b * b).sum(2)[:, None, :]
    else:
        dot = torch.einsum("njl,jkl->njk", r, b)
        bn = (b * b).sum(2)[None]
    return (bn - 2.0 * dot).argmin(2).to(torch.uint8)


def judge_index(snap: dict, X: torch.Tensor, cfg: dict, seed: int,
                blob: float) -> dict:
    row_list, misplaced = row_lists(snap, X.shape[0])
    return {"misplaced": misplaced,
            "assign_gap": _flat.assign_gap(X, snap["centers"], row_list),
            "inertia_excess": inertia_excess(X, snap["centers"], row_list,
                                             blob),
            "code_gap": code_gap(snap, X, row_list, seed),
            "book_excess": book_excess(snap, X, row_list, cfg, seed)}


def prepare(snap: dict, X: torch.Tensor, cfg: dict) -> dict:
    row_list, _ = row_lists(snap, X.shape[0])
    R = snap["rotation"].float()
    C64 = snap["centers"].double()
    cw = decode(snap, X.shape[0])
    order = torch.argsort(row_list)
    counts = torch.bincount(row_list.clamp_min(0), minlength=C64.shape[0])
    counts[0] -= int((row_list < 0).sum())
    start = int((row_list < 0).sum())
    return {"row_list": row_list, "C64": C64, "R": R,
            "crot": snap["centers"].float() @ R.T, "rows": X,
            "cwb": _bf16(cw), "cwn": (cw.double() ** 2).sum(1),
            "order": order[start:], "counts": counts.tolist()}


def adc(prep: dict, Qr: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(m, k) distances of the rows ``ids`` (m, k) to the rotated queries
    ``Qr`` (m, rot) float32, in the stated precision."""
    lst = prep["row_list"][ids].clamp_min(0)
    r = Qr[:, None, :] - prep["crot"][lst]
    g = (_bf16(r) * prep["cwb"][ids]).sum(2)
    r = r.double()
    return (r * r).sum(2) + prep["cwn"][ids] - 2.0 * g


def adc_topk(prep: dict, Qr: torch.Tensor, allowed: torch.Tensor,
             k: int) -> torch.Tensor:
    """(m, k) least distances, ascending, over the rows of the lists each
    query is allowed."""
    m = Qr.shape[0]
    best = torch.full((m, k), float("inf"), dtype=torch.float64,
                      device=Qr.device)
    pos = 0
    for l, n in enumerate(prep["counts"]):
        rows = prep["order"][pos:pos + n]
        pos += n
        qs = torch.nonzero(allowed[:, l])[:, 0]
        if n == 0 or qs.numel() == 0:
            continue
        r = Qr[qs] - prep["crot"][l]
        g = _bf16(r) @ prep["cwb"][rows].T
        r = r.double()
        d = (r * r).sum(1)[:, None] + prep["cwn"][rows][None, :] - 2.0 * g
        cand = torch.cat([best[qs], d], 1)
        best[qs] = torch.topk(cand, k, dim=1, largest=False).values
    return best


def judge_search(prep: dict, Q: torch.Tensor, k: int, prog_d, prog_i,
                 cfg: dict) -> dict:
    Q64 = Q.double()
    allowed = certain_lists(Q64, prep["C64"], cfg["n_probes"])
    _, exact_i = topk_rows(Q, prep["rows"], k)
    Qr = Q.float() @ prep["R"].T
    best_d = adc_topk(prep, Qr, allowed, k)
    scale = (sqdist(Qr.double(), prep["crot"].double()).max(1).values
             + prep["cwn"].max())
    out = judge_answers(prep["rows"].shape[0], prog_d.to(Q.device),
                        prog_i.to(Q.device), k, exact_i,
                        lambda ids: adc(prep, Qr, ids), best_d, scale)
    out["n"] = Q.shape[0]
    return out
