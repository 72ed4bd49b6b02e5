"""Fused exact kNN (B1), the packed-cells IVF-Flat scan (B2) and the
batched independent kNN (B3).

Port of ``raft_tpu/ops/fused_knn.py::fused_knn``, ``::fused_cells_knn`` and
``::fused_batch_knn``. The kernels are hand-written CUDA (see the sources'
headers for the design):

* B1 runs on tensor cores at every tier, k, d, m and n, with one slice
  merge for all (:func:`_b1_slices`). Its f32 tier is ``csrc/knn_tf32.cu``:
  B1's norm pre-pass, then f32 query and row chunks staged by ``cp.async``
  and split in registers into TF32 hi and lo parts, the f32 gram taken as
  three TF32 ``mma.sync`` products (lo(q) hi(y) + hi(q) lo(y) + hi(q)
  hi(y)), which holds the error of an f32 gram where one TF32 product
  would not (:func:`_b1_tf32_plan`). Its two bf16 tiers are
  ``csrc/knn_mma.cu``: a pre-pass rounds the rows to bf16 once, and the
  staged f32 query chunks are rounded into bf16 operands (the split
  query's lo half a second operand) (:func:`_b1_mma_plan`). Both use the
  ``mma.sync`` tile and selection of ``csrc/mma_tile.cuh``;
* B2 runs on tensor cores at every tier, with a pre-pass (live tiles,
  row norms) and one CTA per (cell, block of query rows). Its f32 tier is
  ``csrc/cells_tf32.cu``: the cell's query block resident in f32, the
  list's f32 or bf16 rows staged in 32-feature chunks by ``cp.async``,
  both split in registers into TF32 hi and lo parts and multiplied as B1's
  f32 tier does, three TF32 ``mma.sync`` products a step
  (:func:`_b2_tf32_plan`). Its two bf16 tiers are ``csrc/cells_mma.cu``:
  the query block resident as bf16 operands (the split query's lo half a
  second operand), the store's rows (bf16, f32, uint8 or int8, read in
  their own type and widened in the kernel) staged in feature panels
  (:func:`_b2_mma_plan`). Both use the ``mma.sync`` tile and selection
  of ``csrc/mma_tile.cuh`` and the cell-level selection of
  ``csrc/cell_select.cuh``, which B3 and B4 share;
* B3 is ``csrc/batch_knn.cu`` for the bf16 tier on a bf16 store (every
  main-path call): B2's pre-pass and one CTA per (element, block of query
  rows) on the bf16 tensor-core tile and selection of
  ``csrc/mma_tile.cuh``, which it shares with B4; every other tier, and a
  d whose tile does not fit shared memory, runs B2's scan of that tier
  with the identity cell map. Its plan is :func:`_b3_plan`.

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
``fused_batch_knn.launches`` count the kernel launches (every B1 and B2
launch is a tensor-core scan); ``fused_knn.tf32_launches`` counts those
of B1's f32 tier (knn_tf32.cu) among them, the rest are its bf16 tiers'
(knn_mma.cu); ``fused_cells_knn.mma_launches`` counts B2's launches of its
bf16 tiers' scan and ``fused_cells_knn.tf32_launches`` those of its f32
tier's (every B2 launch is one of the two).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from raft_tpu_torch.core.error import CudaError, LogicError, expects
from raft_tpu_torch.distance.pairwise import gram
from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops._build import check_operands as _check_cuda
from raft_tpu_torch.ops._build import ptr as _ptr
from raft_tpu_torch.ops._build import stream as _stream

def stable_top_k(values: torch.Tensor, k: int):
    """``matrix.select_k.stable_top_k``, imported at the call: the matrix
    package imports ``ops.stream_select``, whose package ``__init__``
    imports this module, so a module-level import would close a cycle."""
    from raft_tpu_torch.matrix.select_k import stable_top_k as top_k

    return top_k(values, k)


#: Widest top-k queue of the kernels (the reference warpsort cap).
MAX_K = 256
MAX_DIM = 1024

# Element budget of one plain-version distance block (~256 MB of f32).
_PLAIN_BLOCK = 1 << 26

# Database rows (slots) per tile of every scan. B1's slices: the most the
# merge takes, and the fewest tiles a slice gets.
B1_BN = 128
B1_MAX_SLICES = 256
B1_MIN_SLICE_TILES = 4
#: Shared memory a block may use on the H100 (232,448 bytes).
SMEM_LIMIT = 232448


def fused_knn_supported(m: int, n: int, d: int, k: int) -> bool:
    """The reference's kernel gate: k within the top-k queue, d <= 1024.
    The CUDA kernel itself takes any d (it stages 16-feature chunks)."""
    return k <= MAX_K and d <= MAX_DIM and n >= 1 and m >= 1


def _b1_ctas_per_sm(k: int) -> int:
    """CTAs of B1's bf16 tiers an SM holds at once: the minimum blocks of
    the ``__launch_bounds__`` of b1_mma_kernel (two for the k = 1 scans,
    one for the k > 1 scans, whose queue and epilogue need the registers
    and shared memory)."""
    return 2 if k == 1 else 1


def _b1_tf32_ctas_per_sm(k: int) -> int:
    """The same for the f32 tier's scan, b1_tf32_kernel: two CTAs an SM
    up to k = 16 (its insertion network; both fit the SM's shared memory),
    one for the warp merges above."""
    return 2 if k <= B1_MMA_NET_K else 1


def _b1_slices(m: int, n: int, bq: int, slots: int
               ) -> Tuple[int, List[Tuple[int, int]]]:
    """Split the database so that the grid (query blocks of ``bq`` x
    slices) covers at least two waves of ``slots`` CTAs where m x n allows
    it. Slices are whole 128-row tiles, at least ``B1_MIN_SLICE_TILES`` of
    them, at most ``B1_MAX_SLICES`` slices; among the counts from the
    two-wave minimum to twice it, the one whose last wave is fullest wins
    (ties to fewer). Returns (slice rows, bounds)."""
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
    return rows, [(lo, min(n, lo + rows)) for lo in range(0, n, rows)]


# The bf16 tiers' tensor-core scan (the constants of csrc/knn_mma.cu):
# features per staged chunk, chunks in flight, the bf16 operand row
# stride, candidate slots per CTA (mma_tile.cuh's), the widest queue of
# the insertion network.
B1_MMA_BK = 16
B1_MMA_STAGES = 4
B1_MMA_SA = B1_MMA_BK + 8
B1_MMA_CAND = 4096
B1_MMA_NET_K = 16


class B1MmaPlan(NamedTuple):
    """B1's launch on a bf16 tier (the tensor-core scan of
    ``csrc/knn_mma.cu``): ``bq`` query rows per CTA, tiles of ``bn``
    database rows, the database slices ``bounds`` [(lo, hi), ...], each
    ``slice_rows`` long but the last, and ``smem`` the bytes of one
    CTA."""
    bq: int
    bn: int
    slice_rows: int
    bounds: List[Tuple[int, int]]
    smem: int


def _b1_mma_smem_bytes(bq: int, bn: int, k: int, qsplit: bool) -> int:
    """Shared-memory bytes of one CTA of the tensor-core scan, region by
    region as knn_mma.cu's ``Layout`` lays them out, each rounded up to 16
    bytes: the ring of staged f32 query chunks (bq rows of 16 features),
    the ring of bf16 row tiles (bn rows, stride 24), the double-buffered
    bf16 query operand and its lo half with ``qsplit``, two tiles' row
    norms, the query norms; then for k = 1 the cross-warp (min, id) of
    each row, else two tiles' valid flags, the queue (bq x k pairs), the
    candidate buffer, its counters and the bitmask of rows with
    candidates, and for k <= 16 the per-thread row minima and the rows'
    first-tile bounds. d does not enter: the features are staged 16 at a
    time."""
    warps_n = 8 // max(1, bq // 32)
    op = B1_MMA_SA * 2
    parts = [B1_MMA_STAGES * bq * B1_MMA_BK * 4, B1_MMA_STAGES * bn * op,
             2 * bq * op, 2 * bq * op if qsplit else 0, 2 * bn * 4, 4 * bq]
    if k == 1:
        parts.append(warps_n * bq * 8)
    else:
        parts += [2 * bn * 4, 4 * bq * k, 4 * bq * k, 4 * B1_MMA_CAND,
                  4 * B1_MMA_CAND, 4 * bq, 4 * (-(-bq // 32))]
        if k <= B1_MMA_NET_K:
            parts += [bq * warps_n * 4 * 4, 4 * bq]
    return sum(_r16(p) for p in parts)


def _b1_mma_tile(m: int, n: int, k: int) -> Tuple[int, int]:
    """(query rows per CTA, database rows per tile) of the tensor-core
    scan. k = 1: 128 rows against tiles of 128, or of 64 / 32 when n is
    that small (the 32 mesoclusters of a balanced k-means). k > 1: 64 rows
    (32 past k = 128, for the queue's room; 16 / 32 when m is that small)
    against tiles of 128."""
    if k == 1:
        return 128, 32 if n <= 32 else 64 if n <= 64 else 128
    most = 64 if k <= 128 else 32
    return min(most, 16 if m <= 16 else 32 if m <= 32 else 64), 128


def _b1_mma_plan(m: int, n: int, d: int, k: int, qsplit: bool,
                 n_sm: int) -> B1MmaPlan:
    """The tensor-core scan's launch for a bf16 tier: the tile of
    :func:`_b1_mma_tile`, the slices of :func:`_b1_slices` (two CTAs an SM
    at k = 1, one above), and the shared memory, which fits
    ``SMEM_LIMIT`` at every k <= 256 and every d."""
    expects(1 <= k <= MAX_K and m >= 1 and n >= 1 and d >= 1,
            "fused_knn: no plan for m=%s n=%s d=%s k=%s", m, n, d, k)
    bq, bn = _b1_mma_tile(m, n, k)
    rows, bounds = _b1_slices(m, n, bq, n_sm * _b1_ctas_per_sm(k))
    return B1MmaPlan(bq, bn, rows, bounds,
                     _b1_mma_smem_bytes(bq, bn, k, qsplit))


# The f32 tier's tensor-core scan (the constants of csrc/knn_tf32.cu):
# features per staged chunk, chunks in flight, the f32 row stride of a
# staged chunk, candidate slots per CTA.
B1_TF32_BK = 32
B1_TF32_STAGES = 2
B1_TF32_SF = B1_TF32_BK + 8
B1_TF32_CAND = 2048


class B1Tf32Plan(NamedTuple):
    """B1's launch on its f32 tier (the 3xTF32 tensor-core scan of
    ``csrc/knn_tf32.cu``): the fields of :class:`B1MmaPlan`."""
    bq: int
    bn: int
    slice_rows: int
    bounds: List[Tuple[int, int]]
    smem: int


def _b1_tf32_smem_bytes(bq: int, bn: int, k: int) -> int:
    """Shared-memory bytes of one CTA of the f32 tier's scan, region by
    region as knn_tf32.cu's ``Layout`` lays them out, each rounded up to
    16 bytes: the rings of staged f32 query and row chunks (bq and bn rows
    of 32 features, stride 40 floats), two tiles' row norms, the query
    norms; then for k = 1 the cross-warp (min, id) of each row, else the
    k > 1 regions of :func:`_b1_mma_smem_bytes` (with this scan's
    candidate count). d does not enter: the features are staged 32 at a
    time."""
    warps_n = 8 // max(1, bq // 32)
    ring = B1_TF32_STAGES * B1_TF32_SF * 4
    parts = [ring * bq, ring * bn, 2 * bn * 4, 4 * bq]
    if k == 1:
        parts.append(warps_n * bq * 8)
    else:
        parts += [2 * bn * 4, 4 * bq * k, 4 * bq * k, 4 * B1_TF32_CAND,
                  4 * B1_TF32_CAND, 4 * bq, 4 * (-(-bq // 32))]
        if k <= B1_MMA_NET_K:
            parts += [bq * warps_n * 4 * 4, 4 * bq]
    return sum(_r16(p) for p in parts)


def _b1_tf32_tile(m: int, n: int, k: int) -> Tuple[int, int]:
    """(query rows per CTA, database rows per tile) of the f32 tier's
    scan: the bf16 tiers' (:func:`_b1_mma_tile`) but at k = 1 against
    more than 64 rows, where 64 x 128 replaces 128 x 128 (that tile
    spilled at the two-CTA register cap when the split's partial sums
    took a second set of accumulators)."""
    bq, bn = _b1_mma_tile(m, n, k)
    return (64, bn) if k == 1 and bn == 128 else (bq, bn)


def _b1_tf32_plan(m: int, n: int, d: int, k: int, n_sm: int) -> B1Tf32Plan:
    """The f32 tier's launch: the tile of :func:`_b1_tf32_tile`, the
    slices of :func:`_b1_slices` (over :func:`_b1_tf32_ctas_per_sm`), and
    the shared memory, which fits ``SMEM_LIMIT`` at every k <= 256 and
    every d."""
    expects(1 <= k <= MAX_K and m >= 1 and n >= 1 and d >= 1,
            "fused_knn: no plan for m=%s n=%s d=%s k=%s", m, n, d, k)
    bq, bn = _b1_tf32_tile(m, n, k)
    rows, bounds = _b1_slices(m, n, bq, n_sm * _b1_tf32_ctas_per_sm(k))
    return B1Tf32Plan(bq, bn, rows, bounds, _b1_tf32_smem_bytes(bq, bn, k))


def _b1_tier_plan(m: int, n: int, d: int, k: int, bf16: bool, qsplit: bool,
                  n_sm: int) -> Union[B1Tf32Plan, B1MmaPlan]:
    """The plan of one B1 launch, a tensor-core scan at every tier and
    shape: both bf16 tiers take knn_mma.cu's (:func:`_b1_mma_plan`), the
    f32 tier knn_tf32.cu's (:func:`_b1_tf32_plan`)."""
    if bf16:
        return _b1_mma_plan(m, n, d, k, qsplit, n_sm)
    return _b1_tf32_plan(m, n, d, k, n_sm)


# B2's launch geometry: the query rows a CTA may take, and the widest
# queue selected by the insertion network.
B2_ROWS = (64, 32, 16)
B2_NET_K = 16


def _r16(x: int) -> int:
    return -(-x // 16) * 16


# B2's bf16 tiers' tensor-core scan: candidate slots per CTA (CN of
# csrc/cells_mma.cu), the widest feature panel the plan stages, and the
# bytes an element of each store type takes.
B2_MMA_CAND = 2048
B2_MMA_PW = 64
_STORE_BYTES = {"f32": 4, "bf16": 2, "u8": 1, "i8": 1}
#: The store type of each element dtype B2 and B3 read, and its code in
#: the C entry points (cell_norms.cuh's ``Kind``).
_STORES = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.uint8: "u8", torch.int8: "i8"}
_STORE_KIND = {"f32": 0, "bf16": 1, "u8": 2, "i8": 3}


class B2MmaPlan(NamedTuple):
    """B2's launch on a bf16 tier (the tensor-core scan of
    ``csrc/cells_mma.cu``): ``bq`` query rows per CTA, ``pw`` features per
    staged panel of the rows and ``smem`` the bytes of one CTA."""
    bq: int
    pw: int
    smem: int


def _b2_mma_smem_bytes(bq: int, d: int, pw: int, k: int, qsplit: bool,
                       store: str) -> int:
    """Shared-memory bytes of one CTA of B2's tensor-core scan, region by
    region as cells_mma.cu's ``Layout`` lays them out, each rounded up to
    16 bytes: the resident bf16 query operand (bq x (kp + 8), kp = d
    rounded up to 16) and its lo half with ``qsplit``, two bf16 row panels
    (128 x (pw + 8)), the staging buffer of one panel in the store's own
    type (none for a bf16 store, whose rows land in the panels), the query
    norms, two tiles' row norms; then for k = 1 the cross-warp (min, slot)
    of each row, else two tiles' valid flags, the queue (bq x k pairs),
    the candidate buffer, its counters and the bitmask of rows with
    candidates, and for k <= 16 the per-thread row minima and the rows'
    first-tile bounds."""
    kp = _r16(d)
    warps_n = 8 // max(1, bq // 32)
    op = bq * (kp + 8) * 2
    parts = [op, op if qsplit else 0, 2 * B1_BN * (pw + 8) * 2,
             0 if store == "bf16" else B1_BN * pw * _STORE_BYTES[store],
             4 * bq, 2 * B1_BN * 4]
    if k == 1:
        parts.append(warps_n * bq * 8)
    else:
        parts += [2 * B1_BN * 4, 4 * bq * k, 4 * bq * k, 4 * B2_MMA_CAND,
                  4 * B2_MMA_CAND, 4 * bq, 4 * (-(-bq // 32))]
        if k <= B2_NET_K:
            parts += [bq * warps_n * 4 * 4, 4 * bq]
    return sum(_r16(p) for p in parts)


def _b2_mma_plan(qrows: int, d: int, k: int, qsplit: bool,
                 store: str) -> B2MmaPlan:
    """The tensor-core scan's launch for a bf16 tier on a ``store`` of
    "bf16", "f32", "u8" or "i8" elements: panels of ``B2_MMA_PW``
    features (d rounded up to 16 when smaller) and the most query rows per
    CTA (64, 32 or 16; never more than ``qrows`` needs) whose shared memory
    fits ``SMEM_LIMIT``, which 16 rows do at every k <= 256 and d <= 1024.
    Raises when nothing fits."""
    expects(1 <= k <= MAX_K and 1 <= d <= MAX_DIM and qrows >= 1
            and store in _STORE_BYTES,
            "fused_cells_knn: no plan for qrows=%s d=%s k=%s store=%s",
            qrows, d, k, store)
    pw = min(_r16(d), B2_MMA_PW)
    most = max(16, min(64, _r16(qrows)))
    for bq in B2_ROWS:
        if bq > most:
            continue
        smem = _b2_mma_smem_bytes(bq, d, pw, k, qsplit, store)
        if smem <= SMEM_LIMIT:
            return B2MmaPlan(bq, pw, smem)
    raise LogicError(f"fused_cells_knn: no plan fits shared memory (qrows="
                     f"{qrows}, d={d}, k={k})")


# B2's f32 tier's tensor-core scan (the constants of csrc/cells_tf32.cu):
# features per staged chunk, chunks in flight, the row stride of a staged
# chunk in elements (f32 or bf16), candidate slots per CTA.
B2_TF32_BK = 32
B2_TF32_STAGES = 2
B2_TF32_SR = B2_TF32_BK + 8
B2_TF32_CAND = 2048


class B2Tf32Plan(NamedTuple):
    """B2's launch on its f32 tier (the 3xTF32 tensor-core scan of
    ``csrc/cells_tf32.cu``): ``bq`` query rows per CTA and ``smem`` the
    bytes of one CTA."""
    bq: int
    smem: int


def _b2_tf32_smem_bytes(bq: int, d: int, k: int, store: str) -> int:
    """Shared-memory bytes of one CTA of B2's f32 tier, region by region as
    cells_tf32.cu's ``Layout`` lays them out, each rounded up to 16 bytes:
    the resident f32 query block (bq x (kp + 8), kp = d rounded up to 32),
    the ring of staged row chunks (two chunks of 128 rows x 40 elements of
    the store's type, f32 or bf16), the query norms, two tiles' row norms;
    then for k = 1 the cross-warp (min, slot) of each row, else the k > 1
    regions of :func:`_b2_mma_smem_bytes` (with this scan's candidate
    count)."""
    kp = -(-d // B2_TF32_BK) * B2_TF32_BK
    warps_n = 8 // max(1, bq // 32)
    parts = [bq * (kp + 8) * 4,
             B2_TF32_STAGES * B1_BN * B2_TF32_SR * _STORE_BYTES[store],
             4 * bq, 2 * B1_BN * 4]
    if k == 1:
        parts.append(warps_n * bq * 8)
    else:
        parts += [2 * B1_BN * 4, 4 * bq * k, 4 * bq * k, 4 * B2_TF32_CAND,
                  4 * B2_TF32_CAND, 4 * bq, 4 * (-(-bq // 32))]
        if k <= B2_NET_K:
            parts += [bq * warps_n * 4 * 4, 4 * bq]
    return sum(_r16(p) for p in parts)


def _b2_tf32_plan(qrows: int, d: int, k: int, store: str) -> B2Tf32Plan:
    """The f32 tier's launch on a ``store`` of "f32" or "bf16" rows: the
    most query rows per CTA (64, 32 or 16; never more than ``qrows``
    needs) whose shared memory fits ``SMEM_LIMIT``, which 16 rows do at
    every k <= 256 and d <= 1024 (the query block is resident, so d
    enters). Raises when nothing fits."""
    expects(1 <= k <= MAX_K and 1 <= d <= MAX_DIM and qrows >= 1
            and store in ("f32", "bf16"),
            "fused_cells_knn: no f32-tier plan for qrows=%s d=%s k=%s "
            "store=%s", qrows, d, k, store)
    most = max(16, min(64, _r16(qrows)))
    for bq in B2_ROWS:
        if bq > most:
            continue
        smem = _b2_tf32_smem_bytes(bq, d, k, store)
        if smem <= SMEM_LIMIT:
            return B2Tf32Plan(bq, smem)
    raise LogicError(f"fused_cells_knn: no plan fits shared memory (qrows="
                     f"{qrows}, d={d}, k={k})")


def _b2_tier_plan(qrows: int, d: int, k: int, bf16: bool, qsplit: bool,
                  store: str) -> Union[B2Tf32Plan, B2MmaPlan]:
    """The plan of one B2 launch, a tensor-core scan at every tier: both
    bf16 tiers take cells_mma.cu's (:func:`_b2_mma_plan`) on every store,
    the f32 tier cells_tf32.cu's (:func:`_b2_tf32_plan`) on an f32 or bf16
    store."""
    if bf16:
        return _b2_mma_plan(qrows, d, k, qsplit, store)
    return _b2_tf32_plan(qrows, d, k, store)


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


_TF32_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_MMA_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_CELLS_TF32_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                        + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                        + [ctypes.c_void_p])
_CELLS_MMA_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
_BATCH_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _tf32_lib():
    lib = _build.load_library("knn_tf32")
    if lib.fused_knn_tf32_launch.argtypes is None:
        lib.fused_knn_tf32_launch.argtypes = _TF32_ARGTYPES
        lib.fused_knn_tf32_launch.restype = ctypes.c_int
    return lib


def _mma_lib():
    lib = _build.load_library("knn_mma")
    if lib.fused_knn_mma_launch.argtypes is None:
        lib.fused_knn_mma_launch.argtypes = _MMA_ARGTYPES
        lib.fused_knn_mma_launch.restype = ctypes.c_int
    return lib


def _batch_lib():
    lib = _build.load_library("batch_knn")
    if lib.fused_batch_knn_launch.argtypes is None:
        lib.fused_batch_knn_launch.argtypes = _BATCH_ARGTYPES
        lib.fused_batch_knn_launch.restype = ctypes.c_int
    return lib


def _cells_tf32_lib():
    lib = _build.load_library("cells_tf32")
    if lib.fused_cells_tf32_launch.argtypes is None:
        lib.fused_cells_tf32_launch.argtypes = _CELLS_TF32_ARGTYPES
        lib.fused_cells_tf32_launch.restype = ctypes.c_int
    return lib


def _cells_mma_lib():
    lib = _build.load_library("cells_mma")
    if lib.fused_cells_mma_launch.argtypes is None:
        lib.fused_cells_mma_launch.argtypes = _CELLS_MMA_ARGTYPES
        lib.fused_cells_mma_launch.restype = ctypes.c_int
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
    qsplit = qsplit and bf16
    lib = _mma_lib() if bf16 else _tf32_lib()
    dev = queries.device
    plan = _b1_tier_plan(m, n, d, k, bf16, qsplit,
                         torch.cuda.get_device_properties(
                             dev).multi_processor_count)
    s = len(plan.bounds)
    out_d = torch.empty((m, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((m, k), dtype=torch.int32, device=dev)
    # The pre-pass's norms (the queries' and the rows' on the f32 tier, the
    # rows' alone on the bf16 tiers, whose scan sums the queries' from its
    # staged chunks) and, there, the rows rounded to bf16 (d padded to
    # whole chunks with zeros).
    norms = torch.empty((n if bf16 else m + n) if l2 else 0,
                        dtype=torch.float32, device=dev)
    ws_d = torch.empty((s, m, k) if s > 1 else 0, dtype=torch.float32,
                       device=dev)
    ws_i = torch.empty((s, m, k) if s > 1 else 0, dtype=torch.int32,
                       device=dev)
    with torch.cuda.device(dev):
        if bf16:
            kp = -(-d // B1_MMA_BK) * B1_MMA_BK
            ybf = torch.empty((n, kp), dtype=torch.bfloat16, device=dev)
            err = lib.fused_knn_mma_launch(
                _ptr(queries), _ptr(db), _ptr(norms), _ptr(ybf), _ptr(ws_d),
                _ptr(ws_i), _ptr(out_d), _ptr(out_i), m, n, d, k, int(l2),
                int(qsplit), plan.bq, plan.bn, plan.slice_rows, s,
                plan.smem, _stream(dev))
        else:
            err = lib.fused_knn_tf32_launch(
                _ptr(queries), _ptr(db), _ptr(norms), _ptr(ws_d),
                _ptr(ws_i), _ptr(out_d), _ptr(out_i), m, n, d, k, int(l2),
                plan.bq, plan.bn, plan.slice_rows, s, plan.smem,
                _stream(dev))
    _build.check(err, "fused_knn launch")
    fused_knn.launches += 1
    if not bf16:
        fused_knn.tf32_launches += 1
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
fused_knn.tf32_launches = 0


def _as_store(db: torch.Tensor, bf16: bool) -> torch.Tensor:
    """The store as B2 and B3 read it: bf16 as is, uint8 / int8 as is on
    a bf16 tier (exact in bf16, widened in the kernel), anything else as
    f32."""
    if db.dtype == torch.bfloat16 or (
            bf16 and db.dtype in (torch.uint8, torch.int8)):
        return db
    return db.to(torch.float32)


def _fused_cells_knn_plain(cell_list, queries, db, invalid, k: int,
                           l2: bool, bf16: bool, qsplit: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B2, over blocks of cells: gather each cell's list,
    score it, mask invalid slots to inf, stable-select k; -1 cells and
    starved slots come out as (inf, -1). An 8-bit store is widened to f32
    and, on a bf16 tier, rounded to bf16 by :func:`distance_tile`, which
    is exact."""
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


def _b2_scratch(n_lists: int, cap: int, dev):
    """The pre-pass's row norms (NaN for invalid slots) and live-tile
    flags: one call's scratch."""
    capp = -(-cap // B1_BN) * B1_BN
    return (torch.empty((n_lists, capp), dtype=torch.float32, device=dev),
            torch.empty((n_lists, capp // B1_BN), dtype=torch.uint8,
                        device=dev))


def _b2_launch(cell_list, queries, db, invalid, live_rows, k: int, l2: bool,
               bf16: bool, qsplit: bool, out_d, out_i) -> None:
    """One B2 launch into out_d / out_i: the tensor-core scan of
    ``csrc/cells_mma.cu`` for a bf16 tier, the 3xTF32 one of
    ``csrc/cells_tf32.cu`` for the f32 tier, each on its plan; the plan's
    shared-memory count is checked against the kernel's ``Layout`` by the
    C entry point. ``live_rows`` (B3's bucket engines) or None."""
    n_cells, qrows, d = queries.shape
    n_lists, cap, _ = db.shape
    store = _STORES[db.dtype]
    plan = _b2_tier_plan(qrows, d, k, bf16, qsplit, store)
    lib = _cells_mma_lib() if bf16 else _cells_tf32_lib()
    dev = queries.device
    yn, live = _b2_scratch(n_lists, cap, dev)
    lr = None if live_rows is None else _ptr(live_rows)
    with torch.cuda.device(dev):
        if bf16:
            err = lib.fused_cells_mma_launch(
                _ptr(cell_list), _ptr(queries), _ptr(db), _STORE_KIND[store],
                _ptr(invalid), lr, _ptr(yn), _ptr(live), _ptr(out_d),
                _ptr(out_i), n_cells, n_lists, qrows, cap, d, k, int(l2),
                int(qsplit), plan.bq, plan.pw, plan.smem, _stream(dev))
        else:
            err = lib.fused_cells_tf32_launch(
                _ptr(cell_list), _ptr(queries), _ptr(db),
                int(store == "bf16"), _ptr(invalid), lr, _ptr(yn),
                _ptr(live), _ptr(out_d), _ptr(out_i), n_cells, n_lists,
                qrows, cap, d, k, int(l2), plan.bq, plan.smem, _stream(dev))
    _build.check(err, "fused_cells_knn launch")


def _fused_cells_knn_cuda(cell_list, queries, db, invalid, k: int, l2: bool,
                          bf16: bool, qsplit: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_cuda("fused_cells_knn", cell_list, queries, db, invalid)
    expects(cell_list.dtype == torch.int32 and queries.dtype == torch.float32
            and invalid.dtype == torch.bool and db.dtype in _STORES,
            "fused_cells_knn: int32 cell_list, f32 queries, f32 / bf16 / "
            "uint8 / int8 db and bool invalid expected")
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
    _b2_launch(cell_list, queries, db, invalid, None, k, l2, bf16, qsplit,
               out_d, out_i)
    fused_cells_knn.launches += 1
    if bf16:
        fused_cells_knn.mma_launches += 1
    else:
        fused_cells_knn.tf32_launches += 1
    return out_d, out_i


def fused_cells_knn(cell_list, queries, db, invalid, k: int, *,
                    l2: bool = True, bf16: bool = False,
                    qsplit: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed-cells batched kNN: cell c scores ``queries[c]`` (qrows, d)
    against list ``cell_list[c]``'s rows ``db[cell_list[c]]`` (cap, d),
    skipping slots where ``invalid`` (n_lists, cap) is set. Min-selection
    order for both metrics (ip scores negated). A bf16 ``db`` is read as
    is; a uint8 or int8 one too on the bf16 tiers (its values are exact in
    bf16), else as f32. Returns (distances (n_cells, qrows, k), int32
    local slot ids); -1 cells and starved slots give (inf, -1). Operands
    must be finite (the entry points reject non-finite inputs): on the
    card an L2 NaN comes out of ``fmaxf`` as distance 0."""
    expects(queries.ndim == 3 and db.ndim == 3 and invalid.ndim == 2,
            "fused_cells_knn: queries (C, qrows, d), db (L, cap, d) and "
            "invalid (L, cap) expected")
    qsplit = qsplit and bf16
    queries = queries.to(torch.float32)
    db = _as_store(db, bf16)
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
fused_cells_knn.mma_launches = 0
fused_cells_knn.tf32_launches = 0


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
    ``csrc/batch_knn.cu``), "cells_mma" (B2's bf16 tiers' tensor-core scan
    of ``csrc/cells_mma.cu``) or "cells_tf32" (B2's f32 tier, the 3xTF32
    tensor-core scan of ``csrc/cells_tf32.cu``), both of B2 with the
    identity cell map; ``bq``
    query rows per CTA, ``smem`` the bytes of one CTA and, on "cells_mma",
    ``pw`` the features of one staged panel (:class:`B2MmaPlan`)."""
    path: str
    bq: int
    smem: int
    pw: int = 0


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
    bf16 tier with the split query), ``store`` "f32" or "bf16", or "u8" /
    "i8" on a bf16 tier. The bf16 tier on a bf16 store takes B3's
    tensor-core scan with the most query rows per CTA (64, 32 or 16; never
    more than ``m`` needs) whose two resident row tiles fit ``SMEM_LIMIT``
    (d up to about 384); the other bf16 tiers and stores, and a d past
    that, take B2's tensor-core scan on its plan (path "cells_mma"); the
    f32 tier takes B2's 3xTF32 scan on its plan (path "cells_tf32").
    Raises when nothing fits."""
    expects(tier in ("f32", "bf16", "qsplit") and store in _STORE_BYTES
            and (tier != "f32" or store in ("f32", "bf16"))
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
    if tier != "f32":
        plan = _b2_mma_plan(m, d, k, tier == "qsplit", store)
        return B3Plan("cells_mma", plan.bq, plan.smem, plan.pw)
    plan = _b2_tf32_plan(m, d, k, store)
    return B3Plan("cells_tf32", plan.bq, plan.smem)


def _fused_batch_knn_cuda(queries, db, invalid, k: int, l2: bool,
                          bf16: bool, qsplit: bool, live_rows=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    rows = () if live_rows is None else (live_rows,)
    _check_cuda("fused_batch_knn", queries, db, invalid, *rows)
    expects(queries.dtype == torch.float32 and invalid.dtype == torch.bool
            and db.dtype in _STORES,
            "fused_batch_knn: f32 queries, f32 / bf16 / uint8 / int8 db and "
            "bool invalid expected")
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
    plan = _b3_plan(m, d, k, tier, _STORES[db.dtype])
    dev = queries.device
    out_d = torch.empty((batch, m, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((batch, m, k), dtype=torch.int32, device=dev)
    if plan.path != "mma":
        # B2's scan of the tier with the identity cell map.
        cells = torch.arange(batch, dtype=torch.int32, device=dev)
        _b2_launch(cells, queries, db, invalid, live_rows, k, l2, bf16,
                   qsplit, out_d, out_i)
    else:
        # The pre-pass's scratch and the slabs' scan order.
        lib = _batch_lib()
        yn, live = _b2_scratch(batch, n, dev)
        order = torch.empty(batch, dtype=torch.int32, device=dev)
        lr = None if live_rows is None else _ptr(live_rows)
        with torch.cuda.device(dev):
            err = lib.fused_batch_knn_launch(
                _ptr(queries), _ptr(db), _ptr(invalid), lr, _ptr(yn),
                _ptr(live), _ptr(order), _ptr(out_d), _ptr(out_i), batch, m,
                n, d, k, int(l2), plan.bq, plan.smem, _stream(dev))
        _build.check(err, "fused_batch_knn launch")
    fused_batch_knn.launches += 1
    return out_d, out_i


def fused_batch_knn(queries, db, invalid, k: int, *, metric: str = "l2",
                    sqrt: bool = False, bd: int = 0, bf16: bool = False,
                    qsplit: bool = False, live_rows=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched independent fused kNN: element b searches ``queries[b]``
    (m, d) against ``db[b]`` (n, d), skipping slots where ``invalid[b]``
    (n,) is set. A bf16 ``db`` is read as is; a uint8 or int8 one too on
    the bf16 tiers (exact in bf16), else as f32. ``bd`` is the reference's db tile width: the result
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
    db = _as_store(db, bf16)
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
