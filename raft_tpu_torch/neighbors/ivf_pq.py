"""IVF-PQ: product-quantized inverted-file index.

Port of ``raft_tpu/neighbors/ivf_pq.py``. Codes are bit-packed
(``packed_row_bytes`` per row) in the capacity-padded list layout of
IVF-Flat; slot j of list l is valid iff ``j < list_sizes[l]`` and it is not
tombstoned in ``deleted``.

* ``build``: balanced k-means coarse centers on a strided trainset (B1 on
  ``cuda``), an orthonormal rotation (identity-with-padding, or the Q of a
  random normal matrix), optional OPQ alternation, then codebooks trained
  by a batched vector-quantization EM (:func:`_vq_train_batched`, chunked
  over rows with a segment sum, so no (pq_dim, n, book) tensor exists), and
  ``extend`` with the dataset;
* ``extend``: assign (B1), encode in row chunks, pack, then bulk fill or
  append in place;
* ``search`` picks one of four tiers, as the reference does:

  - compressed (kernel B4, ``ops/pq_scan.py``): packed query cells scan the
    bit-packed codes through the shared codeword table. ``"auto"`` takes it
    on ``cuda`` at a probe load >= 8 (the reference: on ``tpu``);
    ``engine="bucketed"`` with ``bucket_cap=0`` forces it;
  - recon (kernel B3): after ``Index.reconstructed()``, bucketed fused kNN
    over the bf16 reconstruction cache;
  - decode scan (kernel B3): the same, decoding blocks of lists on the fly
    (:func:`_bucketed_decode_scan`), for indexes whose cache would be too
    large;
  - LUT scan (:func:`_pq_probe_scan`, plain torch): per probe rank, a
    (q, pq_dim, book) LUT and a gather over the codes, with the lut and
    internal dtypes of ``SearchParams``;
* ``search_refined`` (and ``SearchParams.min_recall``) over-retrieve and
  re-rank exactly with ``neighbors/refine.py``;
* ids are int32 or int64 (``IndexParams.idx_dtype``), translated from the
  kernels' int32 slots through ``indices``;
* ``save`` / ``load`` write and read the reference's npz layout
  (``SERIALIZATION_VERSION`` 4, bit-packed codes). A loaded index holds no
  retained dataset, so ``search_refined`` needs the dataset passed.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.core.error import expects, expects_finite
from raft_tpu_torch.core.mdarray import expects_ids_fit, validate_idx_dtype
from raft_tpu_torch.core.resources import (as_float, as_tensor, as_vectors,
                                           resolve_device)
from raft_tpu_torch.core.sentinels import PAD_ID, worst_value
from raft_tpu_torch.core.serialize import (from_numpy, read_npz, to_numpy,
                                           write_npz)
from raft_tpu_torch.distance.distance_types import DistanceType, resolve_metric
from raft_tpu_torch.distance.pairwise import gram
from raft_tpu_torch.matrix.select_k import select_k, stable_top_k
from raft_tpu_torch.neighbors.ivf_flat import (
    _CELL_QROWS, _CELLS_MAX_K, _append_in_place, _auto_cap_cache,
    _auto_id_base, _bucketed_probe_scan, _chunked_over_queries,
    _invert_probe_map, _invert_probe_map_cells, _pack_lists, _pad_deleted,
    _pick_engine, _route_candidates, _route_candidates_cells,
    _track_next_id)
from raft_tpu_torch.ops.fused_knn import fused_batch_knn
from raft_tpu_torch.ops.pq_scan import (_SC, book_tables, permute_subspaces,
                                        pq_fused_scan)
from raft_tpu_torch.random.rng_state import RngState
from raft_tpu_torch.util.pow2 import ceildiv, next_pow2

logger = logging.getLogger("raft_tpu_torch")


class CodebookGen(enum.Enum):
    """Same members and values as raft_tpu's ``CodebookGen``."""

    PER_SUBSPACE = 0
    PER_CLUSTER = 1


# ---------------------------------------------------------------------------
# Bit-packed code storage: a flat byte stream per row.


def packed_row_bytes(pq_dim: int, pq_bits: int) -> int:
    return ceildiv(pq_dim * pq_bits, 8)


def _bitfield_tables(pq_dim: int, pq_bits: int, device):
    """(byte_idx, shift) of each subspace's field in the row byte stream;
    every field spans at most two bytes (pq_bits <= 8)."""
    bitpos = torch.arange(pq_dim, device=device) * pq_bits
    return bitpos // 8, bitpos % 8


def pack_codes(codes: torch.Tensor, pq_bits: int) -> torch.Tensor:
    """(..., pq_dim) code ids -> (..., packed_row_bytes) uint8. Fields never
    overlap, so the two byte projections of each field add without
    carries."""
    pq_dim = codes.shape[-1]
    nbytes = packed_row_bytes(pq_dim, pq_bits)
    byte_idx, shift = _bitfield_tables(pq_dim, pq_bits, codes.device)
    u = codes.to(torch.int64) << shift
    out = torch.zeros(codes.shape[:-1] + (nbytes + 1,), dtype=torch.int64,
                      device=codes.device)
    out.index_add_(-1, byte_idx, u & 0xFF)
    out.index_add_(-1, byte_idx + 1, u >> 8)
    return out[..., :nbytes].to(torch.uint8)


def unpack_codes(packed: torch.Tensor, pq_dim: int,
                 pq_bits: int) -> torch.Tensor:
    """(..., packed_row_bytes) uint8 -> (..., pq_dim) int32 code ids."""
    byte_idx, shift = _bitfield_tables(pq_dim, pq_bits, packed.device)
    p = packed.to(torch.int64)
    p = torch.cat([p, torch.zeros(p.shape[:-1] + (1,), dtype=p.dtype,
                                  device=p.device)], dim=-1)
    u16 = p[..., byte_idx] | (p[..., byte_idx + 1] << 8)
    return ((u16 >> shift) & ((1 << pq_bits) - 1)).to(torch.int32)


@dataclass
class IndexParams:
    """Same field names and defaults as raft_tpu's ``IndexParams``."""

    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    pq_bits: int = 8
    pq_dim: int = 0
    codebook_kind: CodebookGen = CodebookGen.PER_SUBSPACE
    force_random_rotation: bool = False
    opq_iters: int = 0
    add_data_on_build: bool = True
    conservative_memory_allocation: bool = False
    retain_dataset: bool = True
    idx_dtype: torch.dtype = torch.int32


@dataclass
class SearchParams:
    """Same fields as raft_tpu's ``SearchParams``; the dtypes are torch
    dtypes (or their names). ``engine``: "auto" | "scan" | "bucketed"."""

    n_probes: int = 20
    lut_dtype: object = torch.float32
    internal_distance_dtype: object = torch.float32
    engine: str = "auto"
    bucket_cap: int = 0
    compressed_lut_int8: bool = False
    min_recall: Optional[float] = None


def _torch_dtype(x) -> torch.dtype:
    if isinstance(x, torch.dtype):
        return x
    name = x if isinstance(x, str) else np.dtype(x).name
    dt = getattr(torch, name, None)
    expects(isinstance(dt, torch.dtype), f"unknown dtype {x!r}")
    return dt


def validate_search_dtypes(params: SearchParams):
    """The LUT / score dtype knobs: returns ``(lut_dtype, internal_dtype)``
    as torch dtypes, or raises."""
    internal = _torch_dtype(params.internal_distance_dtype)
    expects(internal in (torch.float32, torch.bfloat16, torch.float16),
            "internal_distance_dtype must be float32, bfloat16 or float16 "
            f"(got {internal})")
    lut = _torch_dtype(params.lut_dtype)
    expects(lut in (torch.float32, torch.bfloat16, torch.float16,
                    torch.uint8),
            f"lut_dtype must be f32/bf16/f16/u8 (got {params.lut_dtype})")
    return lut, internal


@dataclass
class Index:
    """Trained IVF-PQ index. ``pq_centers``: PER_SUBSPACE (pq_dim, 2^bits,
    pq_len); PER_CLUSTER (n_lists, 2^bits, pq_len)."""

    metric: DistanceType
    codebook_kind: CodebookGen
    centers: torch.Tensor          # (n_lists, dim)
    rotation_matrix: torch.Tensor  # (rot_dim, dim)
    pq_centers: torch.Tensor
    pq_codes: torch.Tensor         # (n_lists, cap, packed_row_bytes) uint8
    indices: torch.Tensor          # (n_lists, cap) int32 / int64
    list_sizes: torch.Tensor       # (n_lists,) int32
    pq_bits: int = 8
    pq_dim: int = 0
    conservative_memory_allocation: bool = False
    epoch: int = 0
    _recon: Optional[torch.Tensor] = None
    _scan_ops: Optional[tuple] = None
    _scan_ops_i8: Optional[tuple] = None
    _source: Optional[torch.Tensor] = None
    deleted: Optional[torch.Tensor] = None   # (n_lists, cap) bool
    n_deleted: int = 0
    _next_id: Optional[int] = None

    def __post_init__(self):
        expects(self.pq_dim > 0, "Index requires pq_dim > 0")
        expects(self.pq_codes.shape[0] == self.indices.shape[0]
                == self.list_sizes.shape[0] == self.centers.shape[0],
                "n_lists mismatch across index tensors")
        expects(self.pq_codes.shape[1] == self.indices.shape[1],
                "list capacity mismatch between pq_codes and indices")
        expects(self.pq_codes.shape[2]
                == packed_row_bytes(self.pq_dim, self.pq_bits),
                "pq_codes row bytes inconsistent with pq_dim/pq_bits")

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def rot_dim(self) -> int:
        return self.rotation_matrix.shape[0]

    @property
    def pq_len(self) -> int:
        return self.rot_dim // self.pq_dim

    @property
    def pq_book_size(self) -> int:
        return 1 << self.pq_bits

    @property
    def capacity(self) -> int:
        return self.indices.shape[0] * self.indices.shape[1]

    @property
    def size(self) -> int:
        return int(torch.sum(self.list_sizes))

    @property
    def live_size(self) -> int:
        return self.size - self.n_deleted

    def reset_search_cache(self) -> None:
        """Drop the memoized query-distribution measurements (auto bucket
        capacity, probe concentration); the reconstruction cache stays."""
        self.__dict__.pop("_auto_cap_cache", None)
        self.__dict__.pop("_conc_cache", None)

    def centers_rot(self) -> torch.Tensor:
        """The rotated coarse centers (n_lists, rot_dim), full f32."""
        return gram(self.centers, self.rotation_matrix)

    def compressed_scan_operands(self, int8_lut: bool = False) -> tuple:
        """Cached operands of the compressed scan (B4): ``(codesT, lo, hi,
        invalid, crot_p)``: the transposed codes padded to a multiple of
        512 slots, the shared codeword tables, the slot mask (padding and
        tombstones) and the permuted rotated centers. ``int8_lut`` gives
        the int8 tables with their scales appended; the codes-sized
        operands are shared between the two variants."""
        if int8_lut:
            if self._scan_ops_i8 is None:
                codesT, _, _, invalid, crot_p = \
                    self.compressed_scan_operands()
                lo, hi, scale = book_tables(self.pq_centers, self.pq_bits,
                                            int8=True)
                self._scan_ops_i8 = (codesT, lo, hi, invalid, crot_p, scale)
            return self._scan_ops_i8
        if self._scan_ops is None:
            cap = self.pq_codes.shape[1]
            capp = ceildiv(cap, _SC) * _SC
            codesT = torch.nn.functional.pad(
                self.pq_codes.transpose(1, 2), (0, capp - cap)).contiguous()
            invalid = (torch.arange(capp, device=codesT.device)[None, :]
                       >= self.list_sizes[:, None])
            if self.deleted is not None:
                invalid = invalid | torch.nn.functional.pad(
                    self.deleted, (0, capp - cap))
            crot_p = permute_subspaces(self.centers_rot(), self.pq_dim,
                                       self.pq_bits)
            lo, hi = book_tables(self.pq_centers, self.pq_bits)
            self._scan_ops = (codesT, lo, hi, invalid, crot_p)
        return self._scan_ops

    def reconstructed(self) -> torch.Tensor:
        """Absolute bf16 reconstruction of every stored vector in rotated
        space, ``recon[l, c] = R·center_l + codeword(codes[l, c])``
        (n_lists, cap, rot_dim), decoded in blocks and cached. It trades
        the compression back for speed; a search through it is the recon
        tier."""
        if self._recon is None:
            n_lists, cap, _ = self.pq_codes.shape
            per_cluster = self.codebook_kind == CodebookGen.PER_CLUSTER
            crot = self.centers_rot()
            recon = torch.empty((n_lists, cap, self.rot_dim),
                                dtype=torch.bfloat16,
                                device=self.pq_codes.device)
            step = max(1, _DECODE_BLOCK // max(cap * self.rot_dim, 1))
            for l0 in range(0, n_lists, step):
                books = (self.pq_centers[l0:l0 + step] if per_cluster
                         else self.pq_centers)
                recon[l0:l0 + step] = _decode_lists_block(
                    self.pq_codes[l0:l0 + step], crot[l0:l0 + step],
                    books.reshape(-1), self.pq_dim, self.pq_book_size,
                    self.pq_len, self.pq_bits, per_cluster)
            self._recon = recon
        return self._recon


def index_from_numpy(centers, rotation_matrix, pq_centers, pq_codes,
                     indices, list_sizes, pq_bits: int, pq_dim: int,
                     codebook_kind, metric, deleted=None,
                     device=None) -> Index:
    """A port ``Index`` from the arrays of a raft_tpu IVF-PQ ``Index`` (as
    numpy; int32 or int64 ids), on ``device`` (``cuda`` by default)."""
    dev = resolve_device(device)

    def t(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    ind = np.asarray(indices)
    validate_idx_dtype(ind.dtype)
    del_t = None if deleted is None else t(deleted, torch.bool)
    kind = codebook_kind if isinstance(codebook_kind, CodebookGen) \
        else CodebookGen(int(getattr(codebook_kind, "value", codebook_kind)))
    return Index(metric=resolve_metric(metric), codebook_kind=kind,
                 centers=t(centers, torch.float32),
                 rotation_matrix=t(rotation_matrix, torch.float32),
                 pq_centers=t(pq_centers, torch.float32),
                 pq_codes=t(pq_codes, torch.uint8), indices=t(ind),
                 list_sizes=t(list_sizes, torch.int32), pq_bits=int(pq_bits),
                 pq_dim=int(pq_dim), deleted=del_t,
                 n_deleted=0 if del_t is None else int(del_t.sum()))


# ---------------------------------------------------------------------------
# Decoding codes to codewords.

# Elements of one decoded block: its int64 gather index is 8 bytes each.
_DECODE_BLOCK = 1 << 24


def _decode_lists_block(codes_c, crot_c, books_flat, J: int, B: int, L: int,
                        pq_bits: int, per_cluster: bool) -> torch.Tensor:
    """Packed codes of a block of lists -> absolute bf16 reconstructions
    (lc, cap, J*L): one flat gather from the codebooks, plus the rotated
    center, rounded once. ``books_flat`` is the global flat table
    (PER_SUBSPACE) or this block's own books (PER_CLUSTER)."""
    lc, cap = codes_c.shape[0], codes_c.shape[1]
    dev = codes_c.device
    lp = torch.arange(L, device=dev)
    codes2 = unpack_codes(codes_c, J, pq_bits).reshape(lc * cap, J).long()
    if per_cluster:
        base = torch.repeat_interleave(
            torch.arange(lc, device=dev) * (B * L), cap)[:, None, None]
    else:
        base = (torch.arange(J, device=dev) * B * L)[None, :, None]
    idx = base + codes2[:, :, None] * L + lp[None, None, :]
    cw = books_flat[idx.reshape(lc * cap, J * L)]
    cw = cw.reshape(lc, cap, J * L) + crot_c[:, None, :]
    return cw.to(torch.bfloat16)


def _bucketed_decode_scan(rotq, pq_codes, pq_centers, centers_rot, indices,
                          list_sizes, probe_ids, k: int, is_ip: bool,
                          per_cluster: bool, bucket_cap: int, pq_dim: int,
                          pq_bits: int, deleted=None):
    """Bucketed search that decodes blocks of lists to bf16 on the fly (no
    resident cache) and scores each block's query buckets with B3: the
    same decode and kernel as the recon tier, block by block."""
    q, rot_dim = rotq.shape
    n_lists, cap, _ = pq_codes.shape
    B, L = 1 << pq_bits, rot_dim // pq_dim
    bucket, route = _invert_probe_map(probe_ids, n_lists, bucket_cap)
    Qb = rotq[torch.clamp_min(bucket, 0)]
    invalid = (torch.arange(cap, device=rotq.device)[None, :]
               >= list_sizes[:, None])
    if deleted is not None:
        invalid = invalid | deleted
    # B3 scans only the filled slots of each bucket (see ivf_flat's engine).
    live_rows = (bucket >= 0).sum(1).to(torch.int32)
    block = max(1, min(n_lists, _DECODE_BLOCK // max(cap * rot_dim, 1)))
    block = 1 << (block.bit_length() - 1)
    while n_lists % block and block > 1:
        block //= 2
    flat_books = pq_centers.reshape(-1)
    parts_d, parts_i = [], []
    for l0 in range(0, n_lists, block):
        l1 = l0 + block
        fb = pq_centers[l0:l1].reshape(-1) if per_cluster else flat_books
        recon = _decode_lists_block(pq_codes[l0:l1], centers_rot[l0:l1], fb,
                                    pq_dim, B, L, pq_bits, per_cluster)
        bd_, bi_ = fused_batch_knn(Qb[l0:l1], recon, invalid[l0:l1], k,
                                   metric="ip" if is_ip else "l2",
                                   bf16=True, live_rows=live_rows[l0:l1])
        parts_d.append(bd_)
        parts_i.append(bi_)
    bd_, bi_ = torch.cat(parts_d), torch.cat(parts_i)
    gi = indices[torch.arange(n_lists, device=rotq.device)[:, None, None],
                 torch.clamp_min(bi_, 0).long()]
    gi = torch.where(bi_ < 0, PAD_ID, gi)
    cd, ci = _route_candidates(bd_, gi, route, q, probe_ids.shape[1],
                               bucket_cap, worst_value(not is_ip))
    return select_k(cd, k, select_min=not is_ip, indices=ci)


# ---------------------------------------------------------------------------
# The compressed tier (kernel B4).

# Per-list block budget of the compressed scan (the reference's VMEM gate,
# kept as is: the H100 threshold is not measured).
_PQ_CELL_BYTES = 6 * 1024 * 1024


def _compressed_eligible(params: SearchParams, index: Index, n_probes: int,
                         k_pool: int, n_queries: int, default_dtypes: bool,
                         device: torch.device) -> bool:
    """The compressed-tier dispatch gate of search and search_refined: no
    user recon cache, and :func:`_compressed_tier_ok`."""
    return index._recon is None and _compressed_tier_ok(
        params.engine, _compressed_supported(index), default_dtypes, k_pool,
        index.pq_codes.shape[1], index.pq_codes.shape[2], index.rot_dim,
        n_queries, n_probes, index.n_lists, device)


def _compressed_tier_ok(engine: str, supported: bool, default_dtypes: bool,
                        k_pool: int, cap: int, nbytes: int, rot_dim: int,
                        n_queries: int, n_probes: int, n_lists: int,
                        device: torch.device) -> bool:
    """Engine allows it, supported config, default dtypes, k within the
    kernel's queue, the per-list block within budget, and for "auto" a
    ``cuda`` device with a probe load >= 8."""
    if not (engine in ("auto", "bucketed") and supported
            and default_dtypes and k_pool <= _CELLS_MAX_K):
        return False
    if not _compressed_vmem_ok(cap, nbytes, rot_dim):
        return False
    if engine == "bucketed":
        return True
    load = n_queries * n_probes / max(n_lists, 1)
    return device.type == "cuda" and load >= 8


def _compressed_vmem_ok(cap: int, nbytes: int, rot_dim: int) -> bool:
    capp = ceildiv(max(cap, 1), _SC) * _SC
    return nbytes * capp + capp + 2 * rot_dim * 128 * 4 <= _PQ_CELL_BYTES


def _compressed_supported(index: Index) -> bool:
    """PER_SUBSPACE codebooks with byte-aligned fields: pq_bits 8, or 4
    with an even pq_dim."""
    return (index.codebook_kind == CodebookGen.PER_SUBSPACE
            and (index.pq_bits == 8
                 or (index.pq_bits == 4 and index.pq_dim % 2 == 0)))


def _select_clusters(Q, centers, n_probes: int, is_ip: bool):
    """Coarse top-n_probes: inner products, or ``|c|^2 - 2 q.c``."""
    if is_ip:
        _, probe_ids = select_k(gram(Q, centers), n_probes, select_min=False)
    else:
        cn = torch.sum(centers * centers, dim=1)
        _, probe_ids = select_k(cn[None, :] - 2.0 * gram(Q, centers),
                                n_probes, select_min=True)
    return probe_ids


def _compressed_search(Q, centers, rot, codesT, abs_lo, abs_hi, invalid,
                       indices, crot_p, n_probes: int, k: int, is_ip: bool,
                       J: int, bits: int, qrows: int, cell_k: int = 0,
                       int8_lut=None):
    """The compressed tier: coarse probe, rotation, then
    :func:`_compressed_scan_probes`."""
    probe_ids = _select_clusters(Q, centers, n_probes, is_ip)
    rotq_p = permute_subspaces(gram(Q, rot), J, bits)
    return _compressed_scan_probes(rotq_p, probe_ids, codesT, abs_lo,
                                   abs_hi, invalid, indices, crot_p, k,
                                   is_ip, J, bits, qrows, cell_k=cell_k,
                                   int8_lut=int8_lut)


def _compressed_scan_probes(rotq_p, probe_ids, codesT, abs_lo, abs_hi,
                            invalid, indices, crot_p, k: int, is_ip: bool,
                            J: int, bits: int, qrows: int, cell_k: int = 0,
                            int8_lut=None):
    """Scan the given probed lists with B4: cells inversion, the residual
    query shift (L2), the scan, routing and the per-query merge. Returns
    best-first (q, k) candidates in true metric values, no sqrt.
    ``cell_k`` < k bounds each (query, probe) queue (0 = k)."""
    q, n_lists = rotq_p.shape[0], codesT.shape[0]
    cell_k = cell_k or k
    cell_list, bucket, route = _invert_probe_map_cells(probe_ids, n_lists,
                                                       qrows)
    qsel = torch.clamp_min(bucket, 0)
    safe_cl = torch.clamp_min(cell_list, 0).long()
    Qc = rotq_p[qsel]
    if not is_ip:
        # ||(q - c) - cw||^2 is the absolute ADC distance, scored at
        # residual scale where bf16 rounding is relative to the signal.
        Qc = Qc - crot_p[safe_cl][:, None, :]
    bd_, bi_ = pq_fused_scan(cell_list, Qc, codesT, abs_lo, abs_hi, invalid,
                             cell_k, J, bits, is_ip, int8_lut=int8_lut)
    if is_ip:
        # score = q.c + q.cw; the kernel reports -(q.cw). q.c is constant
        # within a cell, so it is added after the in-cell selection.
        qc = gram(rotq_p, crot_p)                       # (q, n_lists)
        bd_ = bd_ - qc[qsel, safe_cl[:, None]][:, :, None]
    gi = indices[safe_cl[:, None, None], torch.clamp_min(bi_, 0).long()]
    gi = torch.where(bi_ < 0, PAD_ID, gi)
    cd, ci = _route_candidates_cells(bd_, gi, route, q, probe_ids.shape[1])
    best_d, best_i = select_k(cd, k, select_min=True, indices=ci)
    if is_ip:
        best_d = -best_d
    return best_d, best_i


# ---------------------------------------------------------------------------
# Build.


def _calculate_pq_dim(dim: int) -> int:
    """Roughly dim/2, a multiple of 8, at least 1."""
    if dim <= 8:
        return max(1, dim // 2)
    return max(8, (dim // 2 // 8) * 8)


def make_rotation_matrix(generator: Optional[torch.Generator], dim: int,
                         rot_dim: int, force_random: bool,
                         device=None) -> torch.Tensor:
    """(rot_dim, dim) orthonormal transform: identity(-with-zero-pad)
    unless ``force_random``, then the Q factor of a random normal matrix
    drawn from ``generator`` (which draws other numbers than the
    reference's key)."""
    dev = generator.device if generator is not None else device
    if not force_random:
        return torch.eye(rot_dim, dim, dtype=torch.float32, device=dev)
    m = max(rot_dim, dim)
    g = torch.randn((m, m), generator=generator, dtype=torch.float32,
                    device=dev)
    q, _ = torch.linalg.qr(g)
    return q[:rot_dim, :dim].contiguous()


# Element budget of one EM distance block (pq_dim, rows, book): ~256 MB.
_VQ_BLOCK = 1 << 26


def _vq_train_batched(data, weights, book_size: int, n_iters: int,
                      init=None) -> torch.Tensor:
    """Train B codebooks at once: data (B, n, l), weights (B, n) (0 masks
    padded rows) -> (B, book_size, l). Each EM step assigns rows in chunks
    (argmin, ties to the first book entry, as ``jnp.argmin``) and forms
    sums and counts with a segment sum (``index_add_``), so the reference's
    (B, n, book) distance and one-hot tensors never exist. On ``cuda``
    ``index_add_`` adds with atomics in a varying order, so float sums
    are not bit-reproducible there; integer data sums exactly."""
    B, n, l = data.shape
    dev = data.device
    if init is not None:
        centers = init
    else:
        stride = max(n // book_size, 1)
        centers = data[:, ::stride][:, :book_size]
        if centers.shape[1] < book_size:
            reps = ceildiv(book_size, centers.shape[1])
            centers = centers.repeat(1, reps, 1)[:, :book_size]
    xn = torch.sum(data * data, dim=2)
    chunk = max(1, _VQ_BLOCK // max(B * book_size, 1))
    base = (torch.arange(B, device=dev) * book_size)[:, None]
    wd = (data * weights[:, :, None]).reshape(B * n, l)
    wf = weights.reshape(-1).to(data.dtype)
    labels = torch.empty((B, n), dtype=torch.int64, device=dev)
    for _ in range(n_iters):
        cn = torch.sum(centers * centers, dim=2)
        ct = centers.transpose(1, 2)
        for s in range(0, n, chunk):
            d = ((xn[:, s:s + chunk, None] + cn[:, None, :])
                 - 2.0 * torch.bmm(data[:, s:s + chunk], ct))
            labels[:, s:s + chunk] = torch.argmin(d, dim=2)
        flat = (base + labels).reshape(-1)
        sums = torch.zeros((B * book_size, l), dtype=data.dtype,
                           device=dev).index_add_(0, flat, wd)
        counts = torch.zeros((B * book_size,), dtype=data.dtype,
                             device=dev).index_add_(0, flat, wf)
        sums = sums.reshape(B, book_size, l)
        counts = counts.reshape(B, book_size)
        new = sums / torch.clamp_min(counts, 1e-6)[:, :, None]
        centers = torch.where((counts > 0)[:, :, None], new, centers)
    return centers


# Row chunk of encode: the (chunk, pq_dim, book) f32 distance block is 256
# MB at pq_dim=64, book=256.
_ENCODE_CHUNK = 4096
# Row chunk of encode_rows (residual + encode + pack): ~64 MB of residuals.
_ENCODE_ROWS = 1 << 17
# "auto" only takes the recon tier while the bf16 cache stays below this.
_RECON_AUTO_BYTES = 4 * 1024 ** 3
# A min_recall above this runs the exact-refine recipe internally.
_REFINE_RECALL_CLASS = 0.84
# Probe concentration below which the bounded per-cell queue is safe.
_CONC_BOUND_SAFE = 0.5
# Row cap of the OPQ alternation's sub-trainset.
_OPQ_TRAIN_ROWS = 100_000


def _nearest_code(res, books, books_per_row: bool) -> torch.Tensor:
    """argmin over the book of ``|r|^2 + |b|^2 - 2 r.b`` (uint8 ids)."""
    if books_per_row:
        bn = torch.sum(books * books, dim=2)[:, None, :]
        dot = torch.bmm(res, books.transpose(1, 2))
    else:
        bn = torch.sum(books * books, dim=2)[None, :, :]
        dot = torch.einsum("njl,jkl->njk", res, books)
    d = torch.sum(res * res, dim=2)[:, :, None] + bn - 2.0 * dot
    return torch.argmin(d, dim=2).to(torch.uint8)


def _encode(residuals, pq_centers) -> torch.Tensor:
    """Nearest-codeword ids per subspace: residuals (n, pq_dim, l) against
    per-subspace books (pq_dim, book, l) -> (n, pq_dim) uint8."""
    return torch.cat([_nearest_code(residuals[s:s + _ENCODE_CHUNK],
                                    pq_centers, False)
                      for s in range(0, residuals.shape[0], _ENCODE_CHUNK)])


def _encode_per_cluster(residuals, labels, pq_centers) -> torch.Tensor:
    """PER_CLUSTER encode: each row uses its own cluster's book."""
    return torch.cat([
        _nearest_code(residuals[s:s + _ENCODE_CHUNK],
                      pq_centers[labels[s:s + _ENCODE_CHUNK].long()], True)
        for s in range(0, residuals.shape[0], _ENCODE_CHUNK)])


def _residuals(X, labels, centers, rot, pq_dim: int) -> torch.Tensor:
    """Rotated residuals reshaped to (n, pq_dim, pq_len)."""
    rr = gram(X - centers[labels.long()], rot)
    return rr.reshape(rr.shape[0], pq_dim, rot.shape[0] // pq_dim)


def build(params: IndexParams, dataset, handle=None) -> Index:
    """Train the index: trainset -> balanced k-means coarse centers ->
    rotation -> rotated residuals -> codebooks -> extend with the
    dataset (ids ``0..n-1`` in ``params.idx_dtype``)."""
    idx_dtype = validate_idx_dtype(params.idx_dtype)
    X = as_vectors(dataset, handle)
    expects(X.ndim == 2, "dataset must be (n_rows, dim)")
    n, dim = X.shape
    expects(n >= params.n_lists, "need at least n_lists rows")
    expects(4 <= params.pq_bits <= 8, "pq_bits must be in [4, 8]")
    expects_finite("ivf_pq.build", X)
    Xf = as_float(X)
    dev = X.device

    pq_dim = params.pq_dim or _calculate_pq_dim(dim)
    pq_len = ceildiv(dim, pq_dim)
    rot_dim = pq_dim * pq_len
    book_size = 1 << params.pq_bits
    state = RngState(seed=0)

    frac = min(max(params.kmeans_trainset_fraction, 0.0), 1.0)
    n_train = max(params.n_lists * 2, int(n * frac)) if frac < 1.0 else n
    n_train = min(n_train, n)
    stride = max(1, n // n_train)
    trainset = Xf[::stride][:n_train].contiguous()
    kb = KMeansBalancedParams(n_iters=params.kmeans_n_iters,
                              metric=DistanceType.L2Expanded,
                              rng_state=state)
    centers = kmeans_balanced._fit(kb, trainset, params.n_lists)
    rot = make_rotation_matrix(
        state.next_generator(dev) if params.force_random_rotation else None,
        dim, rot_dim, params.force_random_rotation, dev)
    labels = kmeans_balanced._predict(kb, centers, trainset)

    # OPQ alternation: train throwaway books, then the orthogonal
    # Procrustes rotation update R <- U V^T from SVD(Xhat^T Xres), each
    # round warm-started from the previous books.
    books_it = None
    if params.opq_iters > 0:
        stride_o = max(1, trainset.shape[0] // _OPQ_TRAIN_ROWS)
        sub = trainset[::stride_o][:_OPQ_TRAIN_ROWS]
        xres = sub - centers[labels[::stride_o][:_OPQ_TRAIN_ROWS].long()]
        jj = torch.arange(pq_dim, device=dev)[None, :]
        for _ in range(params.opq_iters):
            res = gram(xres, rot).reshape(-1, pq_dim, pq_len)
            data = res.transpose(0, 1).contiguous()
            books_it = _vq_train_batched(
                data, torch.ones(data.shape[:2], device=dev), book_size,
                max(4, params.kmeans_n_iters // 2), init=books_it)
            codes_it = _encode(res, books_it).long()
            cw = books_it[jj, codes_it].reshape(res.shape[0], rot_dim)
            u, _, vt = torch.linalg.svd(cw.T @ xres, full_matrices=False)
            rot = u @ vt
        xres = sub = None

    res = _residuals(trainset, labels, centers, rot, pq_dim)
    if params.codebook_kind == CodebookGen.PER_SUBSPACE:
        data = res.transpose(0, 1).contiguous()       # (pq_dim, nt, l)
        pq_centers = _vq_train_batched(
            data, torch.ones(data.shape[:2], device=dev), book_size,
            params.kmeans_n_iters, init=books_it)
    else:
        # Every sub-vector of a cluster is one VQ training set.
        flat = res.reshape(-1, pq_len)
        flat_labels = torch.repeat_interleave(labels, pq_dim)
        ids = torch.arange(flat.shape[0], dtype=torch.int32, device=dev)
        blocks, _, sizes = _pack_lists(flat, flat_labels, ids,
                                       params.n_lists)
        slot = torch.arange(blocks.shape[1], device=dev)[None, :]
        w = (slot < sizes[:, None]).to(torch.float32)
        pq_centers = _vq_train_batched(blocks, w, book_size,
                                       params.kmeans_n_iters)
    del res

    index = Index(
        metric=params.metric, codebook_kind=params.codebook_kind,
        centers=centers, rotation_matrix=rot, pq_centers=pq_centers,
        pq_codes=torch.zeros((params.n_lists, 1,
                              packed_row_bytes(pq_dim, params.pq_bits)),
                             dtype=torch.uint8, device=dev),
        indices=torch.full((params.n_lists, 1), PAD_ID, dtype=idx_dtype,
                           device=dev),
        list_sizes=torch.zeros((params.n_lists,), dtype=torch.int32,
                               device=dev),
        pq_bits=params.pq_bits, pq_dim=pq_dim,
        conservative_memory_allocation=params.conservative_memory_allocation)
    if params.add_data_on_build:
        index = _extend(index, X, torch.arange(n, dtype=idx_dtype,
                                               device=dev), dev)
        if params.retain_dataset:
            index._source = X
    return index


def _invalidate_caches(index: Index) -> None:
    index._recon = None
    index._scan_ops = None
    index._scan_ops_i8 = None
    index.reset_search_cache()


def encode_rows(model, X) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign (B1 on ``cuda``) and encode rows against a trained model:
    ``(labels, packed code rows)``, in row chunks so only the labels and
    the packed codes ever exist at full n."""
    kb = KMeansBalancedParams(metric=DistanceType.L2Expanded)
    labels = kmeans_balanced._predict(kb, model.centers, X)
    per_cluster = model.codebook_kind == CodebookGen.PER_CLUSTER
    parts = []
    for s in range(0, X.shape[0], _ENCODE_ROWS):
        xc, lc = X[s:s + _ENCODE_ROWS], labels[s:s + _ENCODE_ROWS]
        res = _residuals(xc, lc, model.centers, model.rotation_matrix,
                         model.pq_dim)
        codes = (_encode_per_cluster(res, lc, model.pq_centers)
                 if per_cluster else _encode(res, model.pq_centers))
        parts.append(pack_codes(codes, model.pq_bits))
    return labels, torch.cat(parts)


def extend(index: Index, new_vectors, new_indices=None,
           handle=None) -> Index:
    """Encode and append rows (ids default to ``max id + 1`` onwards). The
    index is mutated and returned: an empty index is packed in bulk,
    otherwise rows go in place at each list's fill offset (capacity grows
    to the next power of two on overflow). Bumps ``epoch`` and drops the
    search caches. Rejects non-finite vectors, and ids the index's id
    dtype cannot hold."""
    dev = handle.device if handle is not None else index.centers.device
    X = as_float(new_vectors, device=dev)
    expects(X.ndim == 2 and X.shape[1] == index.dim, "dim mismatch")
    expects_finite("ivf_pq.extend", X)
    if new_indices is not None:
        new_indices = as_tensor(new_indices, device=dev)
        expects_ids_fit("ivf_pq.extend", new_indices, index.indices.dtype)
    return _extend(index, new_vectors, new_indices, dev)


def _extend(index: Index, new_vectors, new_indices, dev) -> Index:
    """:func:`extend` on vectors its caller has checked."""
    X = as_float(new_vectors, device=dev)
    n_new = X.shape[0]
    if n_new == 0:
        return index
    default_ids = new_indices is None
    default_base = None
    if default_ids:
        default_base = _auto_id_base(index)
        new_indices = torch.arange(default_base, default_base + n_new,
                                   dtype=index.indices.dtype, device=dev)
    else:
        new_indices = as_tensor(new_indices, device=dev).to(
            index.indices.dtype)

    # The retained dataset stays valid only for a default-numbered append
    # onto a same-dtype source.
    if index._source is not None:
        raw = as_vectors(new_vectors, device=dev)
        if (default_ids and index._source.shape[0] == default_base
                and raw.dtype == index._source.dtype):
            index._source = torch.cat([index._source, raw])
        else:
            index._source = None

    labels, codes = encode_rows(index, X)
    if not index.size:
        min_cap = 0
        if not index.conservative_memory_allocation:
            counts = torch.bincount(labels.long(), minlength=index.n_lists)
            min_cap = next_pow2(int(torch.max(counts)))
        packed, ids, sizes = _pack_lists(codes, labels, new_indices,
                                         index.n_lists, min_cap)
        index.pq_codes, index.indices, index.list_sizes = packed, ids, sizes
        index.deleted = (None if index.deleted is None
                         else torch.zeros(ids.shape, dtype=torch.bool,
                                          device=dev))
        index.n_deleted = 0
    else:
        store, ids, sizes, _ = _append_in_place(
            index.pq_codes, index.indices, index.list_sizes, codes,
            new_indices, labels, index.conservative_memory_allocation)
        index.pq_codes, index.indices, index.list_sizes = store, ids, sizes
        index.deleted = _pad_deleted(index.deleted, store.shape[1])
    _track_next_id(index, new_indices, default_base, n_new)
    index.epoch += 1
    _invalidate_caches(index)
    return index


# ---------------------------------------------------------------------------
# The LUT scan engine (plain torch).


def _lut_scores(lut, codes, scale=None, acc_dtype=torch.float32):
    """score[q, c] = sum_j LUT[q, j, codes[q, c, j]] (times the per-subspace
    ``scale`` of the u8 LUT), summed in ``acc_dtype``: the gather form,
    which is the reference's branch off the TPU. Exact LUT values sum
    exactly in any order; the u8 LUT's scaled terms are not exact, and
    their sum differs from the reference's compiled reduction by f32
    rounding (an ulp of the score)."""
    g = torch.gather(lut, 2, codes.transpose(1, 2).long()).to(acc_dtype)
    if scale is not None:
        g = g * scale[:, :, None].to(acc_dtype)
    return torch.sum(g, dim=1)


def _pq_probe_scan(rotq, probe_ids, pq_codes, indices, list_sizes, k: int,
                   is_ip: bool, per_cluster: bool, lut_dtype, pq_dim: int,
                   pq_bits: int, internal_dtype=torch.float32,
                   pq_centers=None, centers_rot=None, deleted=None):
    """LUT-scored probe scan: per probe rank, the residual LUT (q, pq_dim,
    book), the probed lists' codes unpacked, scored by a gather, and a
    running top-k in ``internal_dtype``. ``lut_dtype=uint8`` quantizes the
    LUT per (query, subspace) with an affine u8 code."""
    q, rot_dim = rotq.shape
    cap = pq_codes.shape[1]
    pq_len = rot_dim // pq_dim
    worst = worst_value(not is_ip)
    slot = torch.arange(cap, device=rotq.device)[None, :]
    rq3 = rotq.reshape(q, pq_dim, pq_len)
    bsub = "qkl" if per_cluster else "jkl"
    best_d = torch.full((q, k), worst, dtype=internal_dtype,
                        device=rotq.device)
    best_i = torch.full((q, k), PAD_ID, dtype=indices.dtype,
                        device=rotq.device)
    for j in range(probe_ids.shape[1]):
        lists = probe_ids[:, j].long()
        c3 = centers_rot[lists].reshape(q, pq_dim, pq_len)
        books = pq_centers[lists] if per_cluster else pq_centers
        if is_ip:
            # q.c differs per probed list and must be in the score.
            lut = torch.einsum(f"qjl,{bsub}->qjk", rq3, books)
            qc = torch.sum(rq3 * c3, dim=(1, 2))
        else:
            r = rq3 - c3
            bn = torch.sum(books * books, dim=2)
            bn = bn[:, None, :] if per_cluster else bn[None, :, :]
            lut = (torch.sum(r * r, dim=2)[:, :, None] + bn
                   - 2.0 * torch.einsum(f"qjl,{bsub}->qjk", r, books))
            qc = torch.zeros((q,), dtype=torch.float32, device=rotq.device)
        codes = unpack_codes(pq_codes[lists], pq_dim, pq_bits)
        invalid = slot >= list_sizes[lists][:, None]
        if deleted is not None:
            invalid = invalid | deleted[lists]
        if lut_dtype == torch.uint8:
            lmin = torch.amin(lut, dim=2, keepdim=True)
            scale = (torch.amax(lut, dim=2, keepdim=True) - lmin) / 255.0
            lut_q = torch.round((lut - lmin) / torch.clamp_min(scale, 1e-30)
                                ).to(torch.uint8)
            scores = (_lut_scores(lut_q.to(torch.bfloat16), codes,
                                  scale=scale[..., 0],
                                  acc_dtype=internal_dtype)
                      + torch.sum(lmin[..., 0], dim=1)[:, None]
                      .to(internal_dtype))
        else:
            scores = _lut_scores(lut.to(lut_dtype), codes,
                                 acc_dtype=internal_dtype)
        scores = scores + qc[:, None].to(internal_dtype)
        scores = torch.where(invalid, worst, scores)
        cat_d = torch.cat([best_d, scores], dim=1)
        cat_i = torch.cat([best_i, indices[lists]], dim=1)
        best_d, pos = stable_top_k(cat_d, k, select_min=not is_ip)
        best_i = torch.gather(cat_i, 1, pos)
    return best_d.to(torch.float32), best_i


# ---------------------------------------------------------------------------
# Search.


def _finish(index: Index, best_d, best_i):
    if index.metric == DistanceType.L2SqrtExpanded:
        best_d = torch.sqrt(torch.clamp_min(best_d, 0.0))
    return best_d, best_i


def search(params: SearchParams, index: Index, queries, k: int,
           handle=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate search. Returns ``(distances (q, k), neighbors (q, k))``,
    the neighbors in the index's id dtype; L2 metrics report approximate
    squared (or sqrt'ed) distances from the PQ scores. Rejects non-finite
    queries."""
    dev = handle.device if handle is not None else index.centers.device
    Q = as_float(queries, device=dev)
    expects(Q.ndim == 2 and Q.shape[1] == index.dim, "query dim mismatch")
    expects_finite("ivf_pq.search", Q)
    return _search(params, index, Q, k, handle)


def _search(params: SearchParams, index: Index, Q: torch.Tensor, k: int,
            handle=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`search` on checked queries already on the index's device."""
    lut_dtype, internal_dtype = validate_search_dtypes(params)

    if (params.min_recall is not None
            and params.min_recall > _REFINE_RECALL_CLASS):
        if index._source is not None:
            robust = params.min_recall > 0.9
            sp = dataclasses.replace(
                params, min_recall=None,
                n_probes=max(params.n_probes, 64 if robust else 48))
            return _search_refined(sp, index, index._source, Q, k,
                                   4 if robust else 2, handle,
                                   False if robust else None)
        logger.warning(
            "min_recall=%.2f requested but the index retains no source "
            "dataset - running the native PQ search; use "
            "search_refined(dataset=...) for the exact-refine recipe",
            params.min_recall)

    n_probes = min(params.n_probes, index.n_lists)
    k = min(k, max(index.capacity, 1))
    is_ip = index.metric == DistanceType.InnerProduct
    default_dtypes = (lut_dtype == torch.float32
                      and internal_dtype == torch.float32)
    qrows = min(_CELL_QROWS, max(8, Q.shape[0]))
    if _compressed_eligible(params, index, n_probes, k, Q.shape[0],
                            default_dtypes, Q.device):
        int8 = bool(params.compressed_lut_int8)
        ops = index.compressed_scan_operands(int8_lut=int8)
        codesT, lo, hi, invalid, crot_p = ops[:5]
        return _finish(index, *_compressed_search(
            Q, index.centers, index.rotation_matrix, codesT, lo, hi,
            invalid, index.indices, crot_p, n_probes, k, is_ip,
            index.pq_dim, index.pq_bits, qrows,
            int8_lut=ops[5] if int8 else None))

    probe_ids = _select_clusters(Q, index.centers, n_probes, is_ip)
    rotq = gram(Q, index.rotation_matrix)
    engine, cap_q = _pick_engine(
        params.engine, Q.shape[0], n_probes, index.n_lists, k,
        params.bucket_cap, index.rot_dim, probe_ids, Q.device,
        allow_bucketed=default_dtypes, cap_cache=_auto_cap_cache(index))
    if engine == "bucketed":
        recon_bytes = index.pq_codes.shape[0] * index.pq_codes.shape[1] \
            * index.rot_dim * 2
        if index._recon is not None or recon_bytes <= _RECON_AUTO_BYTES:
            return _finish(index, *_bucketed_probe_scan(
                rotq, index.reconstructed(), index.indices,
                index.list_sizes, probe_ids, k, not is_ip, False, cap_q,
                False, index.deleted))
        return _finish(index, *_bucketed_decode_scan(
            rotq, index.pq_codes, index.pq_centers, index.centers_rot(),
            index.indices, index.list_sizes, probe_ids, k, is_ip,
            index.codebook_kind == CodebookGen.PER_CLUSTER, cap_q,
            index.pq_dim, index.pq_bits, index.deleted))

    centers_rot = index.centers_rot()
    cap = index.pq_codes.shape[1]
    per_q = max(cap * index.pq_dim * 4, index.pq_dim * 256 * 4)
    return _finish(index, *_chunked_over_queries(
        lambda rq, pid: _pq_probe_scan(
            rq, pid, index.pq_codes, index.indices, index.list_sizes, k,
            is_ip, index.codebook_kind == CodebookGen.PER_CLUSTER,
            lut_dtype, index.pq_dim, index.pq_bits, internal_dtype,
            pq_centers=index.pq_centers, centers_rot=centers_rot,
            deleted=index.deleted),
        rotq, probe_ids, per_q, k, index.indices.dtype))


def _probe_concentration(Q, centers) -> float:
    """Median over queries of (d1 - d0) / (d1 + d0) of the two smallest
    coarse L2 distances: near 1 when queries sit inside their best list's
    cluster, near 0 when the two nearest centers are equidistant."""
    cn = torch.sum(centers * centers, dim=1)
    cd = (torch.sum(Q * Q, dim=1)[:, None] + cn[None, :]
          - 2.0 * gram(Q, centers))
    cd = torch.clamp_min(cd, 0.0)
    top2 = -torch.topk(-cd, 2, dim=1).values
    d0, d1 = top2[:, 0], top2[:, 1]
    ratio = torch.sort((d1 - d0) / torch.clamp_min(d1 + d0, 1e-9)).values
    m = ratio.shape[0]
    if m % 2:
        return float(ratio[m // 2])
    return float((ratio[m // 2 - 1] + ratio[m // 2]) / 2.0)


def search_refined(params: SearchParams, index: Index, dataset, queries,
                   k: int, refine_ratio: int = 2, handle=None,
                   bound_queue: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Over-retrieve ``refine_ratio * k`` PQ candidates and re-rank them
    exactly against ``dataset`` (None: the dataset retained by build).
    ``bound_queue`` (compressed tier only): None keeps each (query, probe)
    queue at k when the measured probe concentration says it is safe (L2
    only), True forces it, False keeps the pool-deep queue. Rejects a
    non-finite dataset or queries."""
    if dataset is None:
        dataset = index._source
        expects(dataset is not None,
                "search_refined(dataset=None) needs the build-retained "
                "dataset; this index has none - pass the dataset")
    dev = handle.device if handle is not None else index.centers.device
    Q = as_float(queries, device=dev)
    expects_finite("ivf_pq.search_refined", Q, torch.as_tensor(dataset))
    return _search_refined(params, index, dataset, Q, k, refine_ratio,
                           handle, bound_queue)


def _search_refined(params: SearchParams, index: Index, dataset,
                    Q: torch.Tensor, k: int, refine_ratio: int, handle,
                    bound_queue: Optional[bool]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`search_refined` on a checked dataset and queries."""
    from raft_tpu_torch.neighbors.refine import refine

    expects(refine_ratio >= 1, "refine_ratio must be >= 1")
    if params.min_recall is not None:
        params = dataclasses.replace(params, min_recall=None)
    refine_ratio = int(refine_ratio)
    if refine_ratio == 1:
        return _search(params, index, Q, k, handle)

    lut_dtype, internal_dtype = validate_search_dtypes(params)
    default_dtypes = (lut_dtype == torch.float32
                      and internal_dtype == torch.float32)
    n_probes = min(params.n_probes, index.n_lists)
    is_ip = index.metric == DistanceType.InnerProduct
    k = min(k, max(index.capacity, 1))
    pool = min(refine_ratio * k, max(index.capacity, 1))
    if (pool <= n_probes * k and Q.ndim == 2 and Q.shape[1] == index.dim
            and _compressed_eligible(params, index, n_probes, pool,
                                     Q.shape[0], default_dtypes, Q.device)):
        if bound_queue is None:
            if is_ip or index.n_lists < 2:
                bound_queue = False
            else:
                cache = index.__dict__.setdefault("_conc_cache", {})
                key = tuple(Q.shape)
                if key not in cache:
                    cache[key] = _probe_concentration(Q, index.centers)
                bound_queue = cache[key] < _CONC_BOUND_SAFE
        int8 = bool(params.compressed_lut_int8)
        ops = index.compressed_scan_operands(int8_lut=int8)
        codesT, lo, hi, invalid, crot_p = ops[:5]
        _, i = _compressed_search(
            Q, index.centers, index.rotation_matrix, codesT, lo, hi,
            invalid, index.indices, crot_p, n_probes, pool, is_ip, index.pq_dim, index.pq_bits,
            min(_CELL_QROWS, max(8, Q.shape[0])),
            min(k, pool) if bound_queue else 0,
            int8_lut=ops[5] if int8 else None)
    else:
        _, i = _search(params, index, Q, pool, handle)
    return refine(dataset, Q, i, k, metric=index.metric)


# ---------------------------------------------------------------------------
# Serialization: the reference's npz layout. Version 4 is the bit-packed
# code layout; version 3 files held unpacked codes.

SERIALIZATION_VERSION = 4


def save(filename, index: Index, retry=None) -> None:
    """Write ``index`` to ``filename`` (``.npz`` added) in the reference's
    layout: version, metric, codebook kind, pq_bits, pq_dim and the
    allocation flag as scalars, then ``centers``, ``rotation_matrix``,
    ``pq_centers``, the bit-packed ``pq_codes``, ``indices`` and
    ``list_sizes``, and ``deleted`` only when a slot is tombstoned. The
    write runs under ``with_retry`` (``retry`` or ``DEFAULT_IO_RETRY``).
    Search caches and the retained dataset are not written."""
    payload = dict(
        version=np.int64(SERIALIZATION_VERSION),
        metric=np.int64(index.metric.value),
        codebook_kind=np.int64(index.codebook_kind.value),
        pq_bits=np.int64(index.pq_bits),
        pq_dim=np.int64(index.pq_dim),
        conservative=np.bool_(index.conservative_memory_allocation),
        centers=to_numpy(index.centers),
        rotation_matrix=to_numpy(index.rotation_matrix),
        pq_centers=to_numpy(index.pq_centers),
        pq_codes=to_numpy(index.pq_codes),
        indices=to_numpy(index.indices),
        list_sizes=to_numpy(index.list_sizes),
    )
    if index.n_deleted:
        payload["deleted"] = to_numpy(index.deleted)
    write_npz(filename, payload, retry)


def load(filename, retry=None, device=None) -> Index:
    """Read an index written by :func:`save` (or by the reference) onto
    ``device`` (``cuda`` by default; raises without a card). The read runs
    under ``with_retry``. The index has epoch 0, no search caches and no
    retained dataset."""
    dev = resolve_device(device)
    z = read_npz(filename, retry)
    version = int(z["version"])
    expects(version == SERIALIZATION_VERSION,
            "serialization version mismatch: %s%s", version,
            " (v3 unpacked-codes indexes predate the bit-packed layout; "
            "rebuild or re-save from a v3-era checkout)"
            if version == 3 else "")
    validate_idx_dtype(z["indices"].dtype)
    deleted = z.get("deleted")
    return Index(
        metric=DistanceType(int(z["metric"])),
        codebook_kind=CodebookGen(int(z["codebook_kind"])),
        centers=from_numpy(z["centers"], dev),
        rotation_matrix=from_numpy(z["rotation_matrix"], dev),
        pq_centers=from_numpy(z["pq_centers"], dev),
        pq_codes=from_numpy(z["pq_codes"], dev),
        indices=from_numpy(z["indices"], dev),
        list_sizes=from_numpy(z["list_sizes"], dev),
        pq_bits=int(z["pq_bits"]),
        pq_dim=int(z["pq_dim"]),
        conservative_memory_allocation=bool(z["conservative"]),
        deleted=None if deleted is None else from_numpy(deleted, dev),
        n_deleted=0 if deleted is None else int(deleted.sum()),
    )
