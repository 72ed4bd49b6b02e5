"""Fused exact kNN (B1), the packed-cells IVF-Flat scan (B2) and the
batched independent kNN (B3).

Port of ``raft_tpu/ops/fused_knn.py::fused_knn``, ``::fused_cells_knn`` and
``::fused_batch_knn``. The kernels are hand-written CUDA (see the sources'
headers for the design):

* B1 is the register-tiled FP32 scan, norm pre-pass and slice merge of
  ``csrc/knn_gemm.cuh`` (entry point in ``csrc/fused_knn.cu``); it splits
  the database into slices when its query blocks alone cannot fill the
  card (:func:`_b1_plan`);
* B2 is ``csrc/cells_knn.cu``: a pre-pass (live tiles, row norms) and one
  CTA per (cell, block of query rows) on B1's tile, with the cell-level
  selection of ``csrc/cell_select.cuh`` that it shares with B4; its plan
  is :func:`_b2_plan`;
* B3 is ``csrc/batch_knn.cu`` for the bf16 tier on a bf16 store (every
  main-path call): B2's pre-pass and one CTA per (element, block of query
  rows) on the bf16 tensor-core tile and selection of
  ``csrc/mma_tile.cuh``, which it shares with B4; every other tier, and a
  d whose tile does not fit shared memory, runs B2's scan with the
  identity cell map. Its plan is :func:`_b3_plan`.

Beside each kernel is its plain PyTorch version, which repeats the
kernel's arithmetic and tie rules:

* the distance tile of :func:`distance_tile`: a gram in f32 (or on
  operands rounded to bf16 and accumulated in f32, plus the hi/lo split
  query with ``qsplit``), then the clamped expanded L2 with f32 norms, or
  the negated inner product, so that selection is always "min of work";
* a top-k ordered by (distance, id), ties to the lowest id;
* slots whose distance is inf report id -1 (starved cells and lists).

Dispatch: a wrapper takes the plain version only when its tensors lie on
the CPU. For CUDA tensors it launches the kernel or raises; nothing falls
back. ``fused_knn.launches``, ``fused_cells_knn.launches`` and
``fused_batch_knn.launches`` count the kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from raft_tpu_torch.core.error import CudaError, LogicError, expects
from raft_tpu_torch.distance.pairwise import gram
from raft_tpu_torch.matrix.select_k import stable_top_k
from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops._build import check_operands as _check_cuda
from raft_tpu_torch.ops._build import ptr as _ptr
from raft_tpu_torch.ops._build import stream as _stream

#: Widest top-k queue of the kernels (the reference warpsort cap).
MAX_K = 256
MAX_DIM = 1024

# Element budget of one plain-version distance block (~256 MB of f32).
_PLAIN_BLOCK = 1 << 26

# B1's launch geometry (the constants of csrc/knn_gemm.cuh): database rows
# per tile, features per staged chunk, staged chunks in flight, candidate
# slots per CTA, the most slices the merge takes; and the fewest tiles a
# slice gets.
B1_BN = 128
B1_BK = 16
B1_STAGES = 2
B1_CAND = 4096
B1_MAX_SLICES = 256
B1_MIN_SLICE_TILES = 4
#: Shared memory a block may use on the H100 (232,448 bytes).
SMEM_LIMIT = 232448


def fused_knn_supported(m: int, n: int, d: int, k: int) -> bool:
    """The reference's kernel gate: k within the top-k queue, d <= 1024.
    The CUDA kernel itself takes any d (it stages 16-feature chunks)."""
    return k <= MAX_K and d <= MAX_DIM and n >= 1 and m >= 1


class B1Plan(NamedTuple):
    """B1's launch: ``bq`` queries per CTA, and the database slices
    ``bounds`` [(lo, hi), ...], each ``slice_rows`` long but the last."""
    bq: int
    slice_rows: int
    bounds: List[Tuple[int, int]]


def _b1_bq(m: int, k: int) -> int:
    """Queries per CTA: 128, or 64 / 32 when the top-k queue (bq x k x 8
    bytes) needs the room or m is small; k=1 keeps no queue."""
    if k == 1:
        return 128
    cap = 128 if k <= 64 else 64 if k <= 128 else 32
    return min(cap, 32 if m <= 32 else 64 if m <= 64 else 128)


def _b1_smem_bytes(bq: int, k: int, qsplit: bool) -> int:
    """Shared-memory bytes of one B1 CTA, as knn_gemm.cuh's smem_bytes
    counts them (the CPU tests hold them to ``SMEM_LIMIT``): the
    ring of row-major staging chunks (stride BK + 8), the double-buffered
    feature-major query (and lo-half) and row tiles (stride rows + 4),
    then, for k > 1, the queue, the candidate buffer, its counters and the
    bitmask of queries with candidates."""
    stage = 4 * B1_STAGES * (bq + B1_BN) * (B1_BK + 8)
    tiles = 4 * 2 * B1_BK * ((bq + 4) * (2 if qsplit else 1) + B1_BN + 4)
    if k == 1:
        return stage + tiles
    return (stage + tiles + 8 * bq * k + 8 * bq * (B1_CAND // bq) + 4 * bq
            + 4 * (-(-bq // 32)))


def _b1_ctas_per_sm(k: int) -> int:
    """CTAs of B1 an SM holds at once: the minimum blocks of
    b1_scan_kernel's ``__launch_bounds__`` (two for the k = 1 scan, one
    for the k > 1 scan, whose queue and epilogue need the registers)."""
    return 2 if k == 1 else 1


def _b1_plan(m: int, n: int, k: int, n_sm: int) -> B1Plan:
    """Split the database so that the grid (query blocks x slices) covers
    at least two waves where m x n allows it (a wave: ``n_sm`` SMs times
    the CTAs an SM holds). Slices are whole 128-row tiles, at least
    ``B1_MIN_SLICE_TILES`` of them, at most ``B1_MAX_SLICES`` slices; among
    the counts from the two-wave minimum to twice it, the one whose last
    wave is fullest wins (ties to fewer)."""
    bq = _b1_bq(m, k)
    slots = n_sm * _b1_ctas_per_sm(k)
    blocks = -(-m // bq)
    tiles = -(-n // B1_BN)
    most = max(1, min(B1_MAX_SLICES, tiles // B1_MIN_SLICE_TILES))
    per = tiles
    if blocks < 2 * slots and most > 1:
        want = min(most, -(-2 * slots // blocks))
        best = None
        for s in range(want, min(most, 2 * want) + 1):
            p = -(-tiles // s)
            used = -(-tiles // p)
            if used < want and best is not None:
                continue
            ctas = blocks * used
            fill = ctas / (-(-ctas // slots) * slots)
            if best is None or fill > best[0] + 1e-12:
                best = (fill, p)
        per = best[1]
    rows = per * B1_BN
    bounds = [(lo, min(n, lo + rows)) for lo in range(0, n, rows)]
    return B1Plan(bq, rows, bounds)


# B2's launch geometry (the constants of csrc/cells_knn.cu, on B1's tile):
# the query rows a CTA may take, the threads (and per-thread minima) of a
# row, and the widest queue selected by the insertion network.
B2_ROWS = (64, 32, 16)
B2_NE = 16
B2_NET_K = 16


class B2Plan(NamedTuple):
    """B2's launch: ``bq`` query rows per CTA (the queries are staged with
    every chunk of the list's rows) and ``smem`` the bytes of one CTA."""
    bq: int
    smem: int


def _r16(x: int) -> int:
    return -(-x // 16) * 16


def _b2_smem_bytes(bq: int, k: int, qsplit: bool) -> int:
    """Shared-memory bytes of one B2 CTA, region by region as
    cells_knn.cu's ``Layout`` lays them out, each rounded up to 16 bytes:
    B1's staging ring and feature-major tiles (the query's lo half with
    ``qsplit``), the query norms; for k > 1 the queue (bq x k pairs), the
    candidate buffer, its counters and the bitmask of rows with
    candidates, and for k <= 16 the per-thread row minima and the rows'
    first-tile bounds."""
    tile = 4 * 2 * B1_BK * (bq + 4)
    parts = [4 * B1_STAGES * (bq + B1_BN) * (B1_BK + 8), tile,
             tile if qsplit else 0, 4 * 2 * B1_BK * (B1_BN + 4), 4 * bq]
    if k > 1:
        parts += [4 * bq * k, 4 * bq * k, 4 * B1_CAND, 4 * B1_CAND, 4 * bq,
                  4 * (-(-bq // 32))]
        if k <= B2_NET_K:
            parts += [4 * bq * B2_NE, 4 * bq]
    return sum(_r16(p) for p in parts)


def _b2_plan(qrows: int, d: int, k: int, qsplit: bool = True) -> B2Plan:
    """The most query rows per CTA (64, 32 or 16; never more than
    ``qrows`` needs) whose shared memory fits ``SMEM_LIMIT``. The queries
    are staged with every feature chunk of the rows, so ``d`` does not
    change the plan. Raises when nothing fits."""
    expects(1 <= k <= MAX_K and d >= 1 and qrows >= 1,
            "fused_cells_knn: no plan for qrows=%s d=%s k=%s", qrows, d, k)
    most = max(16, min(64, _r16(qrows)))
    for bq in B2_ROWS:
        if bq > most:
            continue
        smem = _b2_smem_bytes(bq, k, qsplit)
        if smem <= SMEM_LIMIT:
            return B2Plan(bq, smem)
    raise LogicError(f"fused_cells_knn: no plan fits shared memory (qrows="
                     f"{qrows}, k={k})")


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def distance_tile(q, y, l2: bool, bf16: bool, qsplit: bool) -> torch.Tensor:
    """Min-order distances of the rows of ``q`` against the rows of ``y``
    (batched over leading axes): the shared arithmetic of both kernels."""
    yf = y.to(torch.float32)
    if bf16:
        yc = _round_bf16(yf)
        qh = _round_bf16(q)
        g = gram(qh, yc)
        if qsplit:
            g = g + gram(_round_bf16(q - qh), yc)
    else:
        g = gram(q, yf)
    if not l2:
        return -g
    qn = torch.sum(q * q, dim=-1)[..., :, None]
    yn = torch.sum(yf * yf, dim=-1)[..., None, :]
    return torch.clamp_min(qn + yn - 2.0 * g, 0.0)


def _starved_to_pad(d: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isinf(d), torch.full_like(i, -1), i)


def _plain_sweep(queries, db, k: int, l2: bool, bf16: bool, qsplit: bool,
                 base: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best min(k, rows) of db rows [base, base + rows), ascending by
    (distance, id), int64 ids. The rows are swept in tiles; each tile's
    best k merge into the running best k with a stable sort. Earlier tiles
    hold lower ids, so positional stability is the (distance, id) order."""
    m, n = queries.shape[0], db.shape[0]
    tile = max(k, min(n, _PLAIN_BLOCK // max(m, 1)))
    best_d = best_i = None
    for s in range(0, n, tile):
        w = distance_tile(queries, db[s:s + tile], l2, bf16, qsplit)
        td, ti = stable_top_k(w, min(k, w.shape[1]))
        part = (td, ti + (base + s))
        best_d, best_i = part if best_d is None else _merge_sorted(
            [(best_d, best_i), part], k)
    return best_d, best_i


def _merge_sorted(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-row lists sorted by (distance, id), whose ids ascend from
    one part to the next, into the best k: the plain version of B1's slice
    merge (a stable selection over the parts laid side by side)."""
    cd = torch.cat([p[0] for p in parts], dim=1)
    ci = torch.cat([p[1] for p in parts], dim=1)
    best_d, pos = stable_top_k(cd, min(k, cd.shape[1]))
    return best_d, torch.gather(ci, 1, pos)


def _fused_knn_plain(queries, db, k: int, l2: bool, bf16: bool,
                     qsplit: bool, bounds: Optional[Sequence[Tuple[int, int]]]
                     = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B1: min-order (m, k) values and int32 ids. With
    ``bounds`` (a plan's slices) each slice is swept alone and the slice
    lists are merged, as the kernel does; the result is the one sweep's."""
    bounds = [(0, db.shape[0])] if bounds is None else bounds
    parts = [_plain_sweep(queries, db[lo:hi], k, l2, bf16, qsplit, lo)
             for lo, hi in bounds]
    best_d, best_i = parts[0] if len(parts) == 1 else _merge_sorted(parts, k)
    best_i = best_i.to(torch.int32)
    return best_d, _starved_to_pad(best_d, best_i)


_KNN_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_CELLS_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])
_BATCH_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _lib():
    lib = _build.load_library("fused_knn")
    if lib.fused_knn_launch.argtypes is None:
        lib.fused_knn_launch.argtypes = _KNN_ARGTYPES
        lib.fused_knn_launch.restype = ctypes.c_int
    return lib


def _batch_lib():
    lib = _build.load_library("batch_knn")
    if lib.fused_batch_knn_launch.argtypes is None:
        lib.fused_batch_knn_launch.argtypes = _BATCH_ARGTYPES
        lib.fused_batch_knn_launch.restype = ctypes.c_int
    return lib


def _cells_lib():
    lib = _build.load_library("cells_knn")
    if lib.fused_cells_knn_launch.argtypes is None:
        lib.fused_cells_knn_launch.argtypes = _CELLS_ARGTYPES
        lib.fused_cells_knn_launch.restype = ctypes.c_int
    return lib


def _fused_knn_cuda(queries, db, k: int, l2: bool, bf16: bool,
                    qsplit: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_cuda("fused_knn", queries, db)
    expects(queries.dtype == torch.float32 and db.dtype == torch.float32,
            "fused_knn: the kernel takes float32 queries and db")
    m, d = queries.shape
    n = db.shape[0]
    expects(1 <= k <= MAX_K and n >= 1,
            "fused_knn: unsupported shape m=%s n=%s d=%s k=%s", m, n, d, k)
    lib = _lib()
    dev = queries.device
    plan = _b1_plan(m, n, k, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    s = len(plan.bounds)
    out_d = torch.empty((m, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((m, k), dtype=torch.int32, device=dev)
    norms = torch.empty(m + n if l2 else 0, dtype=torch.float32, device=dev)
    ws_d = torch.empty((s, m, k) if s > 1 else 0, dtype=torch.float32,
                       device=dev)
    ws_i = torch.empty((s, m, k) if s > 1 else 0, dtype=torch.int32,
                       device=dev)
    with torch.cuda.device(dev):
        err = lib.fused_knn_launch(
            _ptr(queries), _ptr(db), _ptr(norms), _ptr(ws_d), _ptr(ws_i),
            _ptr(out_d), _ptr(out_i), m, n, d, k, int(l2), int(bf16),
            int(qsplit), plan.bq, plan.slice_rows, s, _stream(dev))
    _build.check(err, "fused_knn launch")
    fused_knn.launches += 1
    return out_d, out_i


def fused_knn(queries: torch.Tensor, db: torch.Tensor, k: int, *,
              metric: str = "l2", sqrt: bool = False, bf16: bool = False,
              qsplit: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused exact kNN. ``metric`` is "l2" (squared L2, optionally sqrt'd)
    or "ip" (max inner product). ``bf16`` rounds both operands to bf16
    (f32 accumulation and norms); ``qsplit`` adds the low half of the
    split query on that path. Returns (distances (m, k), int32 ids).
    Operands must be finite (the entry points reject
    non-finite inputs): on the card an L2 NaN comes out of ``fmaxf`` as
    distance 0."""
    expects(metric in ("l2", "ip"), "metric must be 'l2' or 'ip'")
    expects(queries.ndim == 2 and db.ndim == 2
            and queries.shape[1] == db.shape[1],
            "fused_knn: queries (m, d) and db (n, d) expected")
    queries = queries.to(torch.float32)
    db = db.to(torch.float32)
    k = int(min(k, db.shape[0]))
    l2 = metric == "l2"
    qsplit = qsplit and bf16
    if queries.device.type == "cpu" and db.device.type == "cpu":
        outd, outi = _fused_knn_plain(queries, db, k, l2, bf16, qsplit)
    elif queries.device.type == "cuda":
        outd, outi = _fused_knn_cuda(queries.contiguous(), db.contiguous(),
                                     k, l2, bf16, qsplit)
    else:
        raise CudaError(f"fused_knn: no kernel for {queries.device} / "
                        f"{db.device}")
    if l2:
        if sqrt:
            outd = torch.sqrt(outd)
    else:
        outd = -outd  # undo the min-selection negation
    return outd, outi


fused_knn.launches = 0


def _fused_cells_knn_plain(cell_list, queries, db, invalid, k: int,
                           l2: bool, bf16: bool, qsplit: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B2, over blocks of cells: gather each cell's list,
    score it, mask invalid slots to inf, stable-select k; -1 cells and
    starved slots come out as (inf, -1)."""
    n_cells, qrows, _ = queries.shape
    cap = db.shape[1]
    kk = min(k, cap)
    out_d = torch.full((n_cells, qrows, k), float("inf"),
                       dtype=torch.float32, device=queries.device)
    out_i = torch.full((n_cells, qrows, k), -1, dtype=torch.int32,
                       device=queries.device)
    step = max(1, _PLAIN_BLOCK // max(qrows * cap, 1))
    for s in range(0, n_cells, step):
        lists = cell_list[s:s + step].long()
        used = lists >= 0
        safe = torch.clamp_min(lists, 0)
        w = distance_tile(queries[s:s + step], db[safe], l2, bf16, qsplit)
        w = torch.where(invalid[safe][:, None, :], float("inf"), w)
        td, ti = stable_top_k(w, kk)
        ti = _starved_to_pad(td, ti.to(torch.int32))
        td = torch.where(used[:, None, None], td, float("inf"))
        ti = torch.where(used[:, None, None], ti, -1)
        out_d[s:s + step, :, :kk] = td
        out_i[s:s + step, :, :kk] = ti
    return out_d, out_i


def _fused_cells_knn_cuda(cell_list, queries, db, invalid, k: int, l2: bool,
                          bf16: bool, qsplit: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_cuda("fused_cells_knn", cell_list, queries, db, invalid)
    expects(cell_list.dtype == torch.int32 and queries.dtype == torch.float32
            and invalid.dtype == torch.bool
            and db.dtype in (torch.float32, torch.bfloat16),
            "fused_cells_knn: int32 cell_list, f32 queries, f32/bf16 db "
            "and bool invalid expected")
    n_cells, qrows, d = queries.shape
    n_lists, cap, _ = db.shape
    expects(1 <= k <= MAX_K and d <= MAX_DIM,
            "fused_cells_knn: 1 <= k <= %s and d <= %s", MAX_K, MAX_DIM)
    expects(invalid.shape == (n_lists, cap) and cell_list.shape == (n_cells,),
            "fused_cells_knn: shape mismatch")
    qsplit = qsplit and bf16
    dev = queries.device
    out_d = torch.empty((n_cells, qrows, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_cells, qrows, k), dtype=torch.int32, device=dev)
    plan = _b2_plan(qrows, d, k, qsplit)
    # The pre-pass's row norms (NaN for invalid slots) and live-tile
    # flags: one call's scratch.
    capp = -(-cap // B1_BN) * B1_BN
    yn = torch.empty((n_lists, capp), dtype=torch.float32, device=dev)
    live = torch.empty((n_lists, capp // B1_BN), dtype=torch.uint8,
                       device=dev)
    lib = _cells_lib()
    with torch.cuda.device(dev):
        err = lib.fused_cells_knn_launch(
            _ptr(cell_list), _ptr(queries), _ptr(db),
            int(db.dtype == torch.bfloat16), _ptr(invalid), None, _ptr(yn),
            _ptr(live), _ptr(out_d), _ptr(out_i), n_cells, n_lists, qrows,
            cap, d, k, int(l2), int(bf16), int(qsplit), plan.bq, plan.smem,
            _stream(dev))
    _build.check(err, "fused_cells_knn launch")
    fused_cells_knn.launches += 1
    return out_d, out_i


def fused_cells_knn(cell_list, queries, db, invalid, k: int, *,
                    l2: bool = True, bf16: bool = False,
                    qsplit: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed-cells batched kNN: cell c scores ``queries[c]`` (qrows, d)
    against list ``cell_list[c]``'s rows ``db[cell_list[c]]`` (cap, d),
    skipping slots where ``invalid`` (n_lists, cap) is set. Min-selection
    order for both metrics (ip scores negated). Returns (distances
    (n_cells, qrows, k), int32 local slot ids); -1 cells and starved
    slots give (inf, -1). Operands must be finite (the entry points reject
    non-finite inputs): on the card an L2 NaN comes out of ``fmaxf`` as
    distance 0."""
    expects(queries.ndim == 3 and db.ndim == 3 and invalid.ndim == 2,
            "fused_cells_knn: queries (C, qrows, d), db (L, cap, d) and "
            "invalid (L, cap) expected")
    qsplit = qsplit and bf16
    queries = queries.to(torch.float32)
    if db.dtype != torch.bfloat16:
        db = db.to(torch.float32)
    tensors = (cell_list, queries, db, invalid)
    if all(t.device.type == "cpu" for t in tensors):
        return _fused_cells_knn_plain(cell_list, queries, db, invalid, k, l2,
                                      bf16, qsplit)
    if queries.device.type == "cuda":
        return _fused_cells_knn_cuda(
            cell_list.to(torch.int32).contiguous(), queries.contiguous(),
            db.contiguous(), invalid.to(torch.bool).contiguous(), k, l2,
            bf16, qsplit)
    raise CudaError(f"fused_cells_knn: no kernel for {queries.device}")


fused_cells_knn.launches = 0


def _fused_batch_knn_plain(queries, db, invalid, k: int, l2: bool,
                           bf16: bool, qsplit: bool, live_rows=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B3: B2's plain version with the identity cell map
    (element b scores its queries against its own slab); with
    ``live_rows``, rows [live_rows[b], m) of element b give (inf, -1), as
    the kernel, which does not scan them, reports them."""
    cells = torch.arange(queries.shape[0], dtype=torch.int32,
                         device=queries.device)
    out_d, out_i = _fused_cells_knn_plain(cells, queries, db, invalid, k, l2,
                                          bf16, qsplit)
    if live_rows is not None:
        rows = torch.arange(queries.shape[1], device=queries.device)
        dead = (rows[None, :] >= live_rows.to(queries.device)[:, None]
                )[:, :, None]
        out_d = out_d.masked_fill(dead, float("inf"))
        out_i = out_i.masked_fill(dead, -1)
    return out_d, out_i


# B3's launch geometry (the constants of csrc/batch_knn.cu, on the bf16 tile
# of csrc/mma_tile.cuh): slots per tile, candidate slots per CTA, the query
# rows a CTA may take and the widest queue of the insertion network.
B3_BN = 128
B3_CAND = 2048
B3_ROWS = (64, 32, 16)
B3_NET_K = 16


class B3Plan(NamedTuple):
    """B3's launch: ``path`` "mma" (the bf16 tensor-core scan of
    ``csrc/batch_knn.cu``) or "cells" (B2's scan of ``csrc/cells_knn.cu``
    with the identity cell map), ``bq`` query rows per CTA and ``smem``
    the bytes of one CTA."""
    path: str
    bq: int
    smem: int


def _b3_smem_bytes(bq: int, kp: int, k: int) -> int:
    """Shared-memory bytes of one CTA of B3's tensor-core scan, region by
    region as batch_knn.cu's ``Layout`` lays them out, each rounded up to
    16 bytes: the bf16 query operand (bq x (kp + 8)), two bf16 row tiles
    (128 x (kp + 8)), the query norms, two tiles' row norms and valid
    flags; then for k = 1 the cross-warp (min, slot) of each row, else the
    queue (bq x k pairs), the candidate buffer, its counters and the
    bitmask of rows with candidates, and for k <= 16 the per-thread row
    minima and the rows' first-tile bounds."""
    warps_n = 8 // max(1, bq // 32)
    parts = [bq * (kp + 8) * 2, 2 * B3_BN * (kp + 8) * 2, 4 * bq,
             2 * B3_BN * 4, 2 * B3_BN * 4]
    if k == 1:
        parts.append(warps_n * bq * 8)
    else:
        parts += [4 * bq * k, 4 * bq * k, 4 * B3_CAND, 4 * B3_CAND, 4 * bq,
                  4 * (-(-bq // 32))]
        if k <= B3_NET_K:
            parts += [bq * warps_n * 4 * 4, 4 * bq]
    return sum(_r16(p) for p in parts)


def _b3_plan(m: int, d: int, k: int, tier: str, store: str) -> B3Plan:
    """B3's path and launch. ``tier`` is "f32", "bf16" or "qsplit" (the
    bf16 tier with the split query), ``store`` "f32" or "bf16". The bf16
    tier on a bf16 store takes the tensor-core scan with the most query
    rows per CTA (64, 32 or 16; never more than ``m`` needs) whose two
    resident row tiles fit ``SMEM_LIMIT`` (d up to about 384); every other
    tier and store, and a d past that, takes B2's scan on B2's plan.
    Raises when nothing fits."""
    expects(tier in ("f32", "bf16", "qsplit") and store in ("f32", "bf16")
            and 1 <= k <= MAX_K and d >= 1 and m >= 1,
            "fused_batch_knn: no plan for m=%s d=%s k=%s tier=%s store=%s",
            m, d, k, tier, store)
    if tier == "bf16" and store == "bf16":
        most = max(16, min(64, _r16(m)))
        for bq in B3_ROWS:
            if bq > most:
                continue
            smem = _b3_smem_bytes(bq, _r16(d), k)
            if smem <= SMEM_LIMIT:
                return B3Plan("mma", bq, smem)
    plan = _b2_plan(m, d, k, tier == "qsplit")
    return B3Plan("cells", plan.bq, plan.smem)


def _fused_batch_knn_cuda(queries, db, invalid, k: int, l2: bool,
                          bf16: bool, qsplit: bool, live_rows=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    rows = () if live_rows is None else (live_rows,)
    _check_cuda("fused_batch_knn", queries, db, invalid, *rows)
    expects(queries.dtype == torch.float32 and invalid.dtype == torch.bool
            and db.dtype in (torch.float32, torch.bfloat16),
            "fused_batch_knn: f32 queries, f32/bf16 db and bool invalid "
            "expected")
    batch, m, d = queries.shape
    n = db.shape[1]
    expects(db.shape == (batch, n, d) and invalid.shape == (batch, n),
            "fused_batch_knn: shape mismatch")
    expects(live_rows is None or (live_rows.dtype == torch.int32
                                  and live_rows.shape == (batch,)),
            "fused_batch_knn: live_rows must be (B,) int32")
    expects(1 <= k <= min(MAX_K, n),
            "fused_batch_knn: the card kernel's queue holds k <= %s (got "
            "k=%s, n=%s)", MAX_K, k, n)
    expects(batch <= 65535, "fused_batch_knn: at most 65535 slabs a call "
            "(got %s)", batch)
    qsplit = qsplit and bf16
    tier = "qsplit" if qsplit else "bf16" if bf16 else "f32"
    store = "bf16" if db.dtype == torch.bfloat16 else "f32"
    plan = _b3_plan(m, d, k, tier, store)
    lib = _batch_lib() if plan.path == "mma" else _cells_lib()
    dev = queries.device
    out_d = torch.empty((batch, m, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((batch, m, k), dtype=torch.int32, device=dev)
    # The pre-pass's row norms (NaN for invalid slots) and live-tile
    # flags, and the slabs' scan order: one call's scratch.
    capp = -(-n // B3_BN) * B3_BN
    yn = torch.empty((batch, capp), dtype=torch.float32, device=dev)
    live = torch.empty((batch, capp // B3_BN), dtype=torch.uint8, device=dev)
    lr = None if live_rows is None else _ptr(live_rows)
    with torch.cuda.device(dev):
        if plan.path == "mma":
            order = torch.empty(batch, dtype=torch.int32, device=dev)
            err = lib.fused_batch_knn_launch(
                _ptr(queries), _ptr(db), _ptr(invalid), lr, _ptr(yn),
                _ptr(live), _ptr(order), _ptr(out_d), _ptr(out_i), batch, m,
                n, d, k, int(l2), plan.bq, plan.smem, _stream(dev))
        else:
            cells = torch.arange(batch, dtype=torch.int32, device=dev)
            err = lib.fused_cells_knn_launch(
                _ptr(cells), _ptr(queries), _ptr(db),
                int(db.dtype == torch.bfloat16), _ptr(invalid), lr,
                _ptr(yn), _ptr(live), _ptr(out_d), _ptr(out_i), batch,
                batch, m, n, d, k, int(l2), int(bf16), int(qsplit), plan.bq,
                plan.smem, _stream(dev))
    _build.check(err, "fused_batch_knn launch")
    fused_batch_knn.launches += 1
    return out_d, out_i


def fused_batch_knn(queries, db, invalid, k: int, *, metric: str = "l2",
                    sqrt: bool = False, bd: int = 0, bf16: bool = False,
                    qsplit: bool = False, live_rows=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched independent fused kNN: element b searches ``queries[b]``
    (m, d) against ``db[b]`` (n, d), skipping slots where ``invalid[b]``
    (n,) is set. A bf16 ``db`` is taken as is when ``bf16``; otherwise it
    is read as f32. ``bd`` is the reference's db tile width: the result
    does not depend on it, so it is accepted and ignored. Returns
    (distances (B, m, k), int32 local slot ids) with k = min(k, n); short
    results pad with (worst, -1). On the card k is at most 256.

    ``live_rows`` (B,) int32 on the queries' device, or None for every
    row: rows [live_rows[b], m) of element b are not scanned and come back
    as (worst, -1). It is a work-skip for the port's bucket engines, which
    fill each bucket from slot 0 upward and never read the rest; no public
    entry point exposes it, and None is the reference's contract.

    Operands must be finite (the entry points reject
    non-finite inputs): on the card an L2 NaN comes out of ``fmaxf`` as
    distance 0."""
    expects(metric in ("l2", "ip"), "metric must be 'l2' or 'ip'")
    expects(queries.ndim == 3 and db.ndim == 3 and invalid.ndim == 2,
            "fused_batch_knn: queries (B, m, d), db (B, n, d) and invalid "
            "(B, n) expected")
    queries = queries.to(torch.float32)
    if not (bf16 and db.dtype == torch.bfloat16):
        db = db.to(torch.float32)
    k = int(min(k, db.shape[1]))
    l2 = metric == "l2"
    qsplit = qsplit and bf16
    if live_rows is not None:
        live_rows = live_rows.to(torch.int32).contiguous()
    tensors = (queries, db, invalid) + (() if live_rows is None
                                        else (live_rows,))
    if all(t.device.type == "cpu" for t in tensors):
        outd, outi = _fused_batch_knn_plain(queries, db, invalid, k, l2,
                                            bf16, qsplit, live_rows)
    elif queries.device.type == "cuda":
        outd, outi = _fused_batch_knn_cuda(
            queries.contiguous(), db.contiguous(),
            invalid.to(torch.bool).contiguous(), k, l2, bf16, qsplit,
            live_rows)
    else:
        raise CudaError(f"fused_batch_knn: no kernel for {queries.device}")
    if l2:
        if sqrt:
            outd = torch.sqrt(outd)
    else:
        outd = -outd
    return outd, outi


fused_batch_knn.launches = 0
