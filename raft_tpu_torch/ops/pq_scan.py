"""Compressed-domain IVF-PQ probe scan (B4).

Port of ``raft_tpu/ops/pq_scan.py``. Codes are stored transposed per list,
``codesT (n_lists, nbytes, capp)`` u8, and scored against ONE codeword table
shared by every list (:func:`book_tables`): row ``j'·L + s``, column ``b``
holds ``books[perm[j'], b, s]``, split into two 128-column halves (lo, hi).
The caller shifts each cell's query rows by its list's rotated center (L2),
so the scan scores residual-scale operands.

The kernel is hand-written CUDA in ``csrc/pq_scan.cu`` (bf16 ``mma``
tensor-core tiles over codes decoded once per cell through a codeword
table resident in shared memory; see the source's header). One call is a
pre-pass (live tiles, code norms) and the scan, on the launch plan of
:func:`_b4_plan` (query rows per CTA, resident or sliced table). Beside it
is its plain PyTorch version, which repeats ``_pq_scan_cell_body`` step by
step:

* decode: ``cj = codesT[list, :, c]`` (pq_bits 8) or ``[raw & 0xF ; raw >>
  4]`` (pq_bits 4); codeword row ``r = j'·L + s`` is ``table[r, cj[j']]``
  from lo below code 128 and hi above; int8 tables dequantize as
  ``q.float() * scale[r, half]`` first (the hi scale only when B > 128);
* score: ``g = Σ_r bf16(q[r])·bf16(cw[r])`` with f32 sums, then L2
  ``max(qn + cwn - 2g, 0)`` with f32 norms of the unrounded operands, or
  ``-g`` for inner product (min-selection order for both);
* select: the exact top-k of each (cell, row) by (distance, slot), ties to
  the lowest slot, -1 where the distance is inf. The reference's two
  epilogues (legacy k-pass and fused extract/audit) both compute exactly
  this, so neither structure is copied.

Dispatch: the wrapper takes the plain version only for CPU tensors; for
CUDA tensors it launches the kernel or raises. ``pq_fused_scan.launches``
counts the calls (one per call, pre-pass included), and
``pq_fused_scan.launches_by_select`` the same calls by selection path
(:func:`_b4_select`: ``min``, ``regs``, ``merge``).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from raft_tpu_torch.core.error import CudaError, LogicError, expects
from raft_tpu_torch.distance.pairwise import gram
from raft_tpu_torch.matrix.select_k import stable_top_k
from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops.fused_knn import (MAX_K, SMEM_LIMIT, _check_cuda,
                                          _ptr, _r16, _round_bf16,
                                          _starved_to_pad, _stream)
from raft_tpu_torch.util.pow2 import round_up_safe

_LANES = 128
#: The list-capacity granule of the scan operands (the reference's score
#: group width): codesT / invalid are padded to a multiple of it.
_SC = 512

# Element budget of one plain-version block (~256 MB of f32).
_PLAIN_BLOCK = 1 << 26

# B4's launch geometry (the constants of csrc/pq_scan.cu): code slots per
# tile, candidate slots per CTA, the query rows a CTA may take, the table
# slice widths the sliced mode tries (widest first), and the widest k
# selected in registers.
B4_BN = 128
B4_CAND = 4096
B4_ROWS = (64, 32, 16)
B4_SLICES = (512, 256, 128, 64, 32, 16)
B4_REGS_K = 16


class B4Plan(NamedTuple):
    """B4's launch: ``bq`` query rows per CTA; ``sliced`` False keeps the
    whole bf16 codeword table resident in shared memory, True stages it
    in slices of ``ks`` rows of rot in step with the product's K chunks;
    ``kp`` is rot zero-padded to a multiple of 16; ``smem`` the bytes of
    one CTA."""
    bq: int
    sliced: bool
    ks: int
    kp: int
    smem: int


def _b4_select(k: int) -> str:
    """B4's selection path for ``k``: ``min`` (k = 1, a register minimum
    per row), ``regs`` (k <= 16, sorted queues in the registers of the
    threads that hold the distances) or ``merge`` (warp merges of
    shared-memory queues)."""
    return "min" if k == 1 else "regs" if k <= B4_REGS_K else "merge"


def _b4_smem_bytes(bq: int, kp: int, ks: int, pq_bits: int, nbytes: int,
                   k: int, sliced: bool) -> int:
    """Shared-memory bytes of one B4 CTA, region by region as
    pq_scan.cu's ``Layout`` lays them out, each rounded up to 16 bytes:
    the bf16 query operand (bq x (kp + 8)), the bf16 table (2^pq_bits x
    (ks + 2)), the bf16 code tiles (two, or one when sliced; 128 x (ks + 8)),
    two u8 code tiles (nbytes x 128, resident mode only), the K map
    (kp ints), the query norms, two tiles' code norms and valid flags;
    then by :func:`_b4_select`: for ``min`` the cross-warp (min, slot) of
    each row; for ``regs`` the rows' published bounds and the merge of each
    row's queues across warps (k pairs for each of the 16 rows of each of
    the 8 warps); for ``merge`` the queue (bq x k pairs), the candidate
    buffer, its counters and the bitmask of rows with candidates."""
    warps_n = 8 // max(1, bq // 32)
    parts = [bq * (kp + 8) * 2, (1 << pq_bits) * (ks + 2) * 2,
             (1 if sliced else 2) * B4_BN * (ks + 8) * 2,
             0 if sliced else 2 * nbytes * B4_BN, kp * 4, bq * 4,
             2 * B4_BN * 4, 2 * B4_BN * 4]
    path = _b4_select(k)
    if path == "min":
        parts.append(warps_n * bq * 8)
    elif path == "regs":
        parts += [bq * 4, 8 * 16 * k * 8]
    else:
        parts += [bq * k * 4, bq * k * 4, B4_CAND * 4, B4_CAND * 4, bq * 4,
                  4 * (-(-bq // 32))]
    return sum(_r16(p) for p in parts)


def _b4_plan(qrows: int, rot: int, pq_dim: int, pq_bits: int,
             k: int) -> B4Plan:
    """The resident table with the most query rows per CTA that fits
    ``SMEM_LIMIT`` (64, or 32 / 16 as the top-k queue grows; never more
    than ``qrows`` needs), else the sliced table with the most rows, then
    the widest slice. Raises when nothing fits."""
    kp = _r16(rot)
    nbytes = pq_dim if pq_bits == 8 else pq_dim // 2
    most = max(16, min(64, _r16(qrows)))
    rows = [bq for bq in B4_ROWS if bq <= most]
    for bq in rows:
        smem = _b4_smem_bytes(bq, kp, kp, pq_bits, nbytes, k, False)
        if smem <= SMEM_LIMIT:
            return B4Plan(bq, False, kp, kp, smem)
    for bq in rows:
        for ks in B4_SLICES:
            if ks >= kp:
                continue
            smem = _b4_smem_bytes(bq, kp, ks, pq_bits, nbytes, k, True)
            if smem <= SMEM_LIMIT:
                return B4Plan(bq, True, ks, kp, smem)
    raise LogicError(f"pq_fused_scan: no plan fits shared memory (qrows="
                     f"{qrows}, rot={rot}, pq_bits={pq_bits}, k={k})")


def subspace_perm(pq_dim: int, pq_bits: int) -> List[int]:
    """Kernel subspace order: row block j' of the unpacked codes holds
    original subspace ``perm[j']``. pq_bits=8 is the identity; pq_bits=4
    puts every low nibble first, then every high nibble."""
    if pq_bits == 8:
        return list(range(pq_dim))
    nbytes = pq_dim // 2
    return [2 * t for t in range(nbytes)] + [2 * t + 1 for t in range(nbytes)]


def permute_subspaces(x: torch.Tensor, pq_dim: int,
                      pq_bits: int) -> torch.Tensor:
    """Reorder the trailing (rot_dim) axis into the kernel's permuted
    subspace block order (a no-op for pq_bits=8)."""
    if pq_bits == 8:
        return x
    perm = torch.as_tensor(subspace_perm(pq_dim, pq_bits), device=x.device)
    L = x.shape[-1] // pq_dim
    x3 = x.reshape(x.shape[:-1] + (pq_dim, L))
    return x3[..., perm, :].reshape(x.shape)


def book_tables(pq_centers: torch.Tensor, pq_bits: int, int8: bool = False):
    """The shared codeword tables ``(lo, hi)``, each (1, rows, 128) f32:
    ``bt[0, j'·L + s, b] = books[perm[j'], b, s]`` over the code axis,
    split at 128 (B <= 128 pads lo to 128 columns, and hi is a 1-row dummy
    the scan never reads). ``int8=True`` quantizes each table row
    symmetrically (``q = round(v·127/max|v|)``) and returns ``(lo8, hi8,
    scale)`` with ``scale`` (1, rot_dim, 2) f32 (columns: lo, hi)."""
    J, B, L = pq_centers.shape
    perm = torch.as_tensor(subspace_perm(J, pq_bits),
                           device=pq_centers.device)
    bt = pq_centers[perm].transpose(1, 2).reshape(J * L, B)
    if B <= _LANES:
        if B < _LANES:
            bt = F.pad(bt, (0, _LANES - B))
        lo, hi = bt[None], bt[None, :1, :]
    else:
        lo, hi = bt[None, :, :_LANES], bt[None, :, _LANES:]
    lo, hi = lo.contiguous(), hi.contiguous()
    if not int8:
        return lo, hi

    def quant(t):
        amax = torch.amax(torch.abs(t), dim=2, keepdim=True)
        scale = torch.clamp_min(amax, 1e-30) / 127.0
        q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
        return q, scale[0, :, 0]

    lo8, lo_s = quant(lo)
    hi8, hi_s = quant(hi)
    hi_s = F.pad(hi_s, (0, lo_s.shape[0] - hi_s.shape[0]))
    scale = torch.stack([lo_s, hi_s], dim=1)[None]
    return lo8, hi8, scale.contiguous()


def _table(lo, hi, scale, B: int) -> torch.Tensor:
    """The f32 (rot, 128 or 256) codeword table the scan gathers from,
    dequantized as the reference dequantizes its resident tables."""
    if scale is None:
        lo, hi = lo[0], hi[0]
    else:
        lo = lo[0].to(torch.float32) * scale[0, :, 0:1]
        hi = hi[0].to(torch.float32) * scale[0, :, 1:2] if B > _LANES \
            else hi[0].to(torch.float32)
    return torch.cat([lo, hi], dim=1) if B > _LANES else lo


def decode_codewords(codes, table, J: int, pq_bits: int) -> torch.Tensor:
    """(cells, nbytes, slots) u8 codes -> (cells, rot, slots) f32
    codewords in the permuted subspace order."""
    raw = codes.to(torch.int64)
    cj = raw if pq_bits == 8 else torch.cat([raw & 0xF, raw >> 4], dim=1)
    cb, _, slots = cj.shape
    rot = table.shape[0]
    L = rot // J
    idx = cj[:, :, None, :].expand(cb, J, L, slots).reshape(cb, rot, slots)
    idx = torch.clamp(idx, 0, table.shape[1] - 1)
    return torch.gather(table[None].expand(cb, -1, -1), 2, idx)


def _pq_fused_scan_plain(cell_list, rotq_cells, codesT, lo, hi, invalid,
                         k: int, J: int, pq_bits: int, is_ip: bool,
                         scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B4 over blocks of cells (operands already padded:
    capp a multiple of 512)."""
    n_cells, qrows, rot = rotq_cells.shape
    capp = codesT.shape[2]
    table = _table(lo, hi, scale, 1 << pq_bits)
    out_d = torch.full((n_cells, qrows, k), float("inf"),
                       dtype=torch.float32, device=rotq_cells.device)
    out_i = torch.full((n_cells, qrows, k), -1, dtype=torch.int32,
                       device=rotq_cells.device)
    step = max(1, _PLAIN_BLOCK // (max(qrows, rot) * capp))
    for s in range(0, n_cells, step):
        lists = cell_list[s:s + step].long()
        used = lists >= 0
        safe = torch.clamp_min(lists, 0)
        q = rotq_cells[s:s + step]
        cw = decode_codewords(codesT[safe], table, J, pq_bits)
        g = gram(_round_bf16(q), _round_bf16(cw).transpose(1, 2))
        if is_ip:
            w = -g
        else:
            qn = torch.sum(q * q, dim=-1)[:, :, None]
            cwn = torch.sum(cw * cw, dim=1)[:, None, :]
            w = torch.clamp_min(qn + cwn - 2.0 * g, 0.0)
        w = torch.where(invalid[safe][:, None, :], float("inf"), w)
        td, ti = stable_top_k(w, k)
        ti = _starved_to_pad(td, ti.to(torch.int32))
        out_d[s:s + step] = torch.where(used[:, None, None], td,
                                        float("inf"))
        out_i[s:s + step] = torch.where(used[:, None, None], ti, -1)
    return out_d, out_i


_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 14
             + [ctypes.c_void_p])


def _lib():
    lib = _build.load_library("pq_scan")
    if lib.pq_fused_scan_launch.argtypes is None:
        lib.pq_fused_scan_launch.argtypes = _ARGTYPES
        lib.pq_fused_scan_launch.restype = ctypes.c_int
    return lib


def _pq_fused_scan_cuda(cell_list, rotq_cells, codesT, lo, hi, invalid,
                        k: int, J: int, pq_bits: int, is_ip: bool,
                        scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    tensors = [cell_list, rotq_cells, codesT, lo, hi, invalid]
    if scale is not None:
        tensors.append(scale)
    _check_cuda("pq_fused_scan", *tensors)
    table_dtype = torch.float32 if scale is None else torch.int8
    expects(cell_list.dtype == torch.int32
            and rotq_cells.dtype == torch.float32
            and codesT.dtype == torch.uint8 and invalid.dtype == torch.bool
            and lo.dtype == table_dtype and hi.dtype == table_dtype
            and (scale is None or scale.dtype == torch.float32),
            "pq_fused_scan: int32 cell_list, f32 queries, u8 codes, bool "
            "invalid and f32 tables (or int8 tables with f32 scales) "
            "expected")
    n_cells, qrows, rot = rotq_cells.shape
    n_lists, nbytes, capp = codesT.shape
    if capp % B4_BN:
        # The kernel walks whole 128-slot tiles.
        pad = B4_BN - capp % B4_BN
        codesT = F.pad(codesT, (0, pad))
        invalid = F.pad(invalid, (0, pad), value=True)
        capp += pad
    expects(1 <= k <= MAX_K and k <= capp
            and pq_bits in (4, 8) and rot % J == 0
            and nbytes == (J if pq_bits == 8 else J // 2)
            and lo.shape == (1, rot, _LANES)
            and invalid.shape == (n_lists, capp)
            and (pq_bits == 4 or hi.shape == (1, rot, _LANES)),
            "pq_fused_scan: unsupported shape (k=%s, pq_bits=%s, rot=%s)",
            k, pq_bits, rot)
    plan = _b4_plan(qrows, rot, J, pq_bits, k)
    dev = rotq_cells.device
    out_d = torch.empty((n_cells, qrows, k), dtype=torch.float32,
                        device=dev)
    out_i = torch.empty((n_cells, qrows, k), dtype=torch.int32, device=dev)
    # The pre-pass's code norms (L2 only) and live-tile flags: one call's
    # scratch.
    cwn = torch.empty((n_lists, capp) if not is_ip else (1,),
                      dtype=torch.float32, device=dev)
    live = torch.empty((n_lists, capp // B4_BN), dtype=torch.uint8,
                       device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.pq_fused_scan_launch(
            _ptr(cell_list), _ptr(rotq_cells), _ptr(codesT), _ptr(lo),
            _ptr(hi), None if scale is None else _ptr(scale), _ptr(invalid),
            _ptr(cwn), _ptr(live), _ptr(out_d), _ptr(out_i), n_cells,
            n_lists, qrows,
            rot, nbytes, capp, J, pq_bits, k, int(is_ip), plan.bq,
            int(plan.sliced), plan.ks, plan.smem, _stream(dev))
    _build.check(err, "pq_fused_scan launch")
    pq_fused_scan.launches += 1
    pq_fused_scan.launches_by_select[_b4_select(k)] += 1
    return out_d, out_i


def pq_fused_scan(cell_list, rotq_cells, codesT, abs_lo, abs_hi, invalid,
                  k: int, J: int, pq_bits: int, is_ip: bool,
                  int8_lut: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched compressed-domain PQ scan over packed query cells.

    ``cell_list`` (max_cells,) int32: the list each cell scans (-1 =
    unused). ``rotq_cells`` (max_cells, qrows, rot_dim) f32: query rows in
    the permuted subspace order, for L2 already shifted by the cell's
    rotated list center. ``codesT`` (n_lists, nbytes, cap) u8. ``abs_lo`` /
    ``abs_hi``: the (1, rows, 128) tables of :func:`book_tables`, f32, or
    int8 with the (1, rot_dim, 2) scales passed as ``int8_lut``.
    ``invalid`` (n_lists, cap) bool. Returns (min-order distances
    (max_cells, qrows, k), int32 local slots); -1 cells and starved slots
    give (inf, -1). Operands must be finite (the entry points reject
    non-finite inputs): on the card an L2 NaN comes out of ``fmaxf`` as
    distance 0."""
    expects(rotq_cells.ndim == 3 and codesT.ndim == 3 and invalid.ndim == 2,
            "pq_fused_scan: rotq_cells (C, qrows, rot), codesT (L, nbytes, "
            "cap) and invalid (L, cap) expected")
    n_cells, qrows, _ = rotq_cells.shape
    cap = codesT.shape[2]
    capp = round_up_safe(cap, _SC)
    qr = round_up_safe(qrows, 8)
    if capp != cap:
        codesT = F.pad(codesT, (0, capp - cap))
        invalid = F.pad(invalid, (0, capp - cap), value=True)
    rotq_cells = rotq_cells.to(torch.float32)
    if qr != qrows:
        rotq_cells = F.pad(rotq_cells, (0, 0, 0, qr - qrows))
    tensors = [cell_list, rotq_cells, codesT, abs_lo, abs_hi, invalid]
    if int8_lut is not None:
        tensors.append(int8_lut)
    if all(t.device.type == "cpu" for t in tensors):
        outd, outi = _pq_fused_scan_plain(cell_list, rotq_cells, codesT,
                                          abs_lo, abs_hi, invalid, k, J,
                                          pq_bits, is_ip, int8_lut)
    elif rotq_cells.device.type == "cuda":
        outd, outi = _pq_fused_scan_cuda(
            cell_list.to(torch.int32).contiguous(), rotq_cells.contiguous(),
            codesT.contiguous(), abs_lo.contiguous(), abs_hi.contiguous(),
            invalid.to(torch.bool).contiguous(), k, J, pq_bits, is_ip,
            None if int8_lut is None else int8_lut.contiguous())
    else:
        raise CudaError(f"pq_fused_scan: no kernel for {rotq_cells.device}")
    return outd[:, :qrows], outi[:, :qrows]


pq_fused_scan.launches = 0
pq_fused_scan.launches_by_select = {"min": 0, "regs": 0, "merge": 0}
