"""Top-k merging: the merge engines of sharded search and the merge core
behind ``knn_merge_parts``.

Port of ``raft_tpu/comms/topk_merge.py``. Sharded search merges each
rank's best candidates into the global top-k; the engines differ in how
the candidates travel (``topk_merge(..., engine=...)``, called by every
rank of a :class:`~raft_tpu_torch.comms.comms.Comms` with its own
``(n_queries, kk)`` candidates and global ids):

* ``"allgather"``: one gather of every rank's candidates, one select;
* ``"ring"``: the select folded into the exchange. On a power-of-two
  group the log-step butterfly (step s swaps the running top-w with rank
  ``r ^ 2^s``); otherwise the linear ring, forwarding each neighbour's
  original candidates and merging at every hop;
* ``"ring_bf16"``: the ring with bf16 distances on the wire (ids stay
  exact), a guard of ``min(2k, n_dev kk)`` survivors, and an exact re-rank:
  each survivor's owner contributes its f32 distance to one MIN (MAX)
  allreduce, so the distances reported are exact;
* ``"pipelined"`` / ``"pipelined_bf16"``: :func:`topk_merge_pipelined`,
  where the producer scans in chunks and each chunk's ring (or bf16 ring)
  exchange is posted as soon as the chunk is scanned and waited, before
  the chunk's merge, once the next chunk is scanned; passed to plain
  :func:`topk_merge` they are the matching ring;
* ``"auto"``: :func:`resolve_merge_engine`'s rules on (q, k, n_dev).

Every engine selects under one total order, the distance then the lowest
id, so pairwise merging is associative even under ties and the exact
engines agree bit for bit with ``"allgather"``. Floats order as
``lax.sort`` orders them (``select_k.order_key``, standardized).

``merge_parts`` is the single-host merge core: candidates ordered by
(key, part-major concatenated position) ascending, where the key maps the
selection polarity onto ascending order. The reference reduces the parts
with a tree of pairwise merges over a two-key ``lax.sort``; on one host
that order is the order of one stable sort of the concatenated keys,
which is what it does.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

from raft_tpu_torch.comms.comms import Comms, OpT
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.sentinels import worst_value
from raft_tpu_torch.matrix.select_k import order_key
from raft_tpu_torch.util.pow2 import is_pow2
from raft_tpu_torch.util.telemetry import SuppressibleStats


def _ascending_keys(v: torch.Tensor, select_min: bool) -> torch.Tensor:
    """Map values so that ascending order is best-first order, in the
    values' own dtype."""
    if select_min:
        return v
    if v.is_floating_point():
        return -v
    if v.dtype == torch.uint8:
        return 255 - v     # negation would wrap: key 0 must rank last
    return torch.bitwise_not(v)


def _sorted_select(d, i, k: int, select_min: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-first top-k of candidate columns by distance, ties to the
    lower column."""
    order = torch.argsort(order_key(_ascending_keys(d, select_min),
                                    standardize=True),
                          dim=1, stable=True)[:, :k]
    return torch.gather(d, 1, order), torch.gather(i, 1, order)


def merge_parts(keys, vals, k: Optional[int] = None, select_min: bool = True,
                translations: Optional[Sequence[int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-host merge of per-part results: ``keys``/``vals`` are
    ``(n_parts, n_queries, kk)``, reduced to the global top-``k`` (default
    ``kk``). Ties go to the lower part-major concatenated position, so the
    result is the concat + select_k output. ``translations`` offsets each
    part's ids, in the ids' own dtype: int64 ids take offsets past
    2^31."""
    expects(keys.ndim == 3 and vals.shape == keys.shape,
            "keys/vals must be (n_parts, n_queries, k)")
    n_parts, n_queries, kk = keys.shape
    if k is None:
        k = kk
    if translations is not None:
        translations = [int(x) for x in translations]
        info = torch.iinfo(vals.dtype)
        expects(all(info.min <= x <= info.max for x in translations),
                "translations %s do not fit the %s ids; widen them first "
                "(idx_dtype=torch.int64)", translations, vals.dtype)
        off = torch.as_tensor(translations, dtype=vals.dtype,
                              device=vals.device).reshape(n_parts, 1, 1)
        vals = vals + off
    return _sorted_select(
        keys.permute(1, 0, 2).reshape(n_queries, n_parts * kk),
        vals.permute(1, 0, 2).reshape(n_queries, n_parts * kk), k,
        select_min)


# ---------------------------------------------------------------------------
# The merge engines of sharded search.

MERGE_ENGINES = ("auto", "allgather", "ring", "ring_bf16", "pipelined",
                 "pipelined_bf16")

#: Engines that chunk the producer scan and overlap the exchange.
PIPELINED_ENGINES = ("pipelined", "pipelined_bf16")

# "auto" crossover: below this many merged candidate scalars the latency
# of a multi-step ring beats its distributed select on the linear
# (non-power-of-two) topology, where the ring moves allgather's bytes.
_RING_MIN_WORK = 1 << 16

# Pipelined-dispatch knobs: "auto" picks the pipelined engine only when
# the scan is long enough to hide the exchange behind (>= 4 probe lists
# per chunk at >= 2 chunks), and each extra chunk re-exchanges up to a
# k-wide partial, so the chunk count is capped.
_PIPELINE_MAX_CHUNKS = 4
_PIPELINE_MIN_CHUNK_PROBES = 4
_PIPELINE_AUTO_MIN_PROBES = 16
_PIPELINE_AUTO_MIN_DEV = 4


def resolve_merge_engine(engine: str, n_queries: int, k: int,
                         n_dev: int, *, n_probes: Optional[int] = None
                         ) -> str:
    """Resolve "auto" to a concrete engine from (q, k, n_dev), by the
    reference's rules: "allgather" on <= 2 ranks; "pipelined" on >= 4
    ranks when the caller's scan iterates >= 16 probe lists
    (``n_probes``) and the merged volume q k n_dev reaches 2^16; else
    "ring" on a power-of-two group, and on other groups only from that
    volume up. "auto" never picks a bf16 engine: a quantized exchange is
    a numerics opt-in."""
    expects(engine in MERGE_ENGINES,
            f"unknown merge engine {engine!r} (one of {MERGE_ENGINES})")
    if engine != "auto":
        return engine
    if n_dev <= 2:
        return "allgather"
    if (n_probes is not None and n_dev >= _PIPELINE_AUTO_MIN_DEV
            and n_probes >= _PIPELINE_AUTO_MIN_PROBES
            and n_queries * k * n_dev >= _RING_MIN_WORK):
        return "pipelined"
    if is_pow2(n_dev):
        return "ring"
    return "ring" if n_queries * k * n_dev >= _RING_MIN_WORK else "allgather"


def resolve_pipeline_chunks(engine: str, n_items: Optional[int],
                            n_dev: int, requested: int = 0) -> int:
    """Chunk count of the pipelined engines (1 = unchunked). ``n_items``
    is what the producer chunks over (probe lists, row ranges);
    ``requested`` > 0 overrides the default of 4 items per chunk, at most
    4 chunks."""
    if engine not in PIPELINED_ENGINES or n_dev <= 1:
        return 1
    if n_items is None or n_items < 2:
        return 1
    if requested > 0:
        return min(requested, n_items)
    return max(1, min(_PIPELINE_MAX_CHUNKS,
                      n_items // _PIPELINE_MIN_CHUNK_PROBES))


def pipeline_chunk_bounds(n_items: int, n_chunks: int):
    """Even split of ``n_items`` into ``n_chunks`` contiguous ``(lo, hi)``
    ranges, the remainder spread over the leading chunks."""
    n_chunks = max(1, min(n_chunks, n_items))
    base, rem = divmod(n_items, n_chunks)
    bounds, lo = [], 0
    for c in range(n_chunks):
        hi = lo + base + (1 if c < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def merge_comm_bytes(engine: str, n_queries: int, k: int, kk: int,
                     n_dev: int, idx_bytes: int = 4,
                     chunk_kks: Optional[Sequence[int]] = None,
                     participants: Optional[int] = None) -> int:
    """Estimated collective bytes RECEIVED per rank for one merge of
    ``kk``-wide candidates. The bf16 engine adds its re-rank (one
    allreduce of the survivor row at the guard width, counted as
    ``2 q cap 4`` bytes). ``chunk_kks`` lists the per-chunk widths of a
    pipelined dispatch, whose estimate sums the per-chunk rings.

    ``participants`` accounts a routed dispatch (list placement): only
    that many ranks contribute real candidates, so the estimate is the
    same merge over ``participants`` ranks (0 or 1 gives 0 bytes),
    capped at the full-mesh volume, since the routed merge can always
    run the full collective with sentinel payloads."""
    if participants is not None:
        p = min(n_dev, max(int(participants), 1))
        full = merge_comm_bytes(engine, n_queries, k, kk, n_dev,
                                idx_bytes, chunk_kks=chunk_kks)
        if p >= n_dev:
            return full
        return min(full, merge_comm_bytes(engine, n_queries, k, kk, p,
                                          idx_bytes, chunk_kks=chunk_kks))
    engine = resolve_merge_engine(engine, n_queries, k, n_dev)
    if n_dev <= 1:
        return 0
    if engine in PIPELINED_ENGINES:
        inner = "ring_bf16" if engine == "pipelined_bf16" else "ring"
        if not chunk_kks:
            chunk_kks = (kk,)
        return sum(merge_comm_bytes(inner, n_queries, k, ck, n_dev,
                                    idx_bytes) for ck in chunk_kks)
    k_out = min(k, n_dev * kk)
    if engine == "allgather":
        return (n_dev - 1) * n_queries * kk * (4 + idx_bytes)
    dist_bytes = 2 if engine == "ring_bf16" else 4
    cap = min(2 * k_out, n_dev * kk) if engine == "ring_bf16" else k_out
    if is_pow2(n_dev):
        total = 0
        w = kk
        for _ in range(n_dev.bit_length() - 1):
            total += n_queries * min(cap, w) * (dist_bytes + idx_bytes)
            w *= 2
    else:
        total = (n_dev - 1) * n_queries * kk * (dist_bytes + idx_bytes)
    if engine == "ring_bf16":
        total += 2 * n_queries * cap * 4  # the exact re-rank's allreduce
    return total


class MergeDispatchStats(SuppressibleStats):
    """Host-side per-engine dispatch accounting: the sharded search entry
    points call :meth:`record` once per dispatch with the resolved engine
    and :func:`merge_comm_bytes`' estimate. A chunked (pipelined) dispatch
    counts once; ``suppress`` drops a thread's shadow traffic."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._dispatches: Dict[str, int] = {}
        self._bytes: Dict[str, int] = {}

    def record(self, engine: str, n_queries: int, k: int, kk: int,
               n_dev: int, idx_bytes: int = 4,
               chunk_kks: Optional[Sequence[int]] = None,
               participants: Optional[int] = None) -> None:
        """One LOGICAL merge dispatch (see :func:`merge_comm_bytes` for
        ``chunk_kks`` and ``participants``)."""
        if self._suppressed():
            return
        est = merge_comm_bytes(engine, n_queries, k, kk, n_dev, idx_bytes,
                               chunk_kks=chunk_kks,
                               participants=participants)
        with self._lock:
            self._dispatches[engine] = self._dispatches.get(engine, 0) + 1
            self._bytes[engine] = self._bytes.get(engine, 0) + est

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {engine: {"dispatches": self._dispatches[engine],
                             "est_bytes": self._bytes.get(engine, 0)}
                    for engine in sorted(self._dispatches)}

    def reset(self) -> None:
        with self._lock:
            self._dispatches.clear()
            self._bytes.clear()


#: Process-wide recorder the sharded entry points feed.
merge_dispatch_stats = MergeDispatchStats()


def _select_by_id(d, i, k: int, select_min: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-first top-k of candidate columns under the shared total order:
    the distance, then the lowest id. ``d`` keeps its dtype (the bf16
    ring sorts bf16)."""
    by_id = torch.argsort(i, dim=1, stable=True)
    keys = torch.gather(order_key(_ascending_keys(d, select_min),
                                  standardize=True), 1, by_id)
    order = torch.gather(by_id, 1,
                         torch.argsort(keys, dim=1, stable=True)[:, :k])
    return torch.gather(d, 1, order), torch.gather(i, 1, order)


def _merge_two(ad, ai, bd, bi, k: int, select_min: bool):
    """Pairwise merge of two best-first candidate sets, shared by every
    engine."""
    return _select_by_id(torch.cat([ad, bd], dim=1),
                         torch.cat([ai, bi], dim=1), k, select_min)


class _RingMerge:
    """One ring merge of this rank's candidates to the top-``cap`` of the
    union, replicated on every rank. The first exchange is posted at
    construction and waited in :meth:`finish`, which runs the rest: the
    caller may scan in between (the pipelined engines)."""

    def __init__(self, dist, idx, cap: int, comms: Comms, select_min: bool):
        n, r = comms.get_size(), comms.get_rank()
        self.comms, self.cap, self.select_min = comms, cap, select_min
        self.kk = dist.shape[1]
        self.pow2 = is_pow2(n)
        self.carry = _select_by_id(dist, idx, min(cap, self.kk), select_min)
        if self.pow2:
            # Butterfly: step s swaps the running top-w with r ^ 2^s.
            self.steps = [(r ^ (1 << s),) * 2
                          for s in range(n.bit_length() - 1)]
            first = self.carry
        else:
            # Linear ring: forward each neighbour's ORIGINAL candidates
            # (store and forward) while merging every hop.
            self.steps = [((r + 1) % n, (r - 1) % n)] * (n - 1)
            first = (dist, idx)
        self.pending = (comms.exchange_start(first, *self.steps[0])
                        if self.steps else None)

    def finish(self) -> Tuple[torch.Tensor, torch.Tensor]:
        carry_d, carry_i = self.carry
        recv = None
        for t, (to, frm) in enumerate(self.steps):
            if t == 0:
                recv = self.pending()
            else:
                payload = (carry_d, carry_i) if self.pow2 else recv
                recv = self.comms.exchange(payload, to, frm)
            w = min(self.cap, self.kk * ((2 << t) if self.pow2 else t + 2))
            carry_d, carry_i = _merge_two(carry_d, carry_i, recv[0], recv[1],
                                          w, self.select_min)
        # Callers cap at n_dev kk, so the last width is exactly cap.
        return carry_d, carry_i


class _Bf16GuardedRing:
    """The ring_bf16 core: the ring over bf16 distances with a guard of
    ``min(2 k_out, n_dev kk)`` survivors, then the exact re-rank. The
    first exchange is posted at construction, as in :class:`_RingMerge`."""

    def __init__(self, dist, idx, k_out: int, comms: Comms,
                 select_min: bool):
        self.dist, self.idx, self.k_out = dist, idx, k_out
        self.comms, self.select_min = comms, select_min
        cap = min(2 * k_out, comms.get_size() * dist.shape[1])
        self.ring = _RingMerge(dist.to(torch.bfloat16), idx, cap, comms,
                               select_min)

    def finish(self) -> Tuple[torch.Tensor, torch.Tensor]:
        _, surv_i = self.ring.finish()
        # Each survivor id lives in exactly one rank's candidates: its
        # owner contributes the exact f32 distance, everyone else the
        # worst value, and one MIN (MAX) allreduce recovers it everywhere.
        owned = surv_i[:, :, None] == self.idx[:, None, :]
        cand = torch.where(owned, self.dist[:, None, :],
                           worst_value(self.select_min))
        if self.select_min:
            exact = self.comms.allreduce(torch.amin(cand, dim=2), OpT.MIN)
        else:
            exact = self.comms.allreduce(torch.amax(cand, dim=2), OpT.MAX)
        return _select_by_id(exact, surv_i, self.k_out, self.select_min)


class _Local:
    """A one-rank merge: the select alone."""

    def __init__(self, dist, idx, k_out: int, select_min: bool):
        self.out = _select_by_id(dist, idx, k_out, select_min)

    def finish(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.out


def topk_merge(dist, idx, k: int, comms: Comms, select_min: bool = True,
               engine: str = "allgather"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge every rank's ``(n_queries, kk)`` candidates (GLOBAL ids,
    unique across ranks) into the global top-k. Collective over
    ``comms``. Returns the same best-first ``(distances, ids)`` of width
    ``min(k, n_dev kk)`` on every rank, ties to the lowest id. The exact
    engines return identical tensors; "ring_bf16" reports exact f32
    distances after its re-rank."""
    expects(dist.ndim == 2 and dist.shape == idx.shape,
            "dist/idx must be (n_queries, kk) per-rank candidates")
    n_dev = comms.get_size()
    q, kk = dist.shape
    k_out = min(k, n_dev * kk)
    engine = resolve_merge_engine(engine, q, k, n_dev)
    if engine in PIPELINED_ENGINES:
        # One unchunked candidate set: nothing to overlap.
        engine = "ring_bf16" if engine == "pipelined_bf16" else "ring"
    if n_dev == 1:
        return _select_by_id(dist, idx, k_out, select_min)
    if engine == "allgather":
        return _select_by_id(comms.allgather(dist, axis=1),
                             comms.allgather(idx, axis=1), k_out, select_min)
    if engine == "ring":
        return _RingMerge(dist, idx, k_out, comms, select_min).finish()
    return _Bf16GuardedRing(dist, idx, k_out, comms, select_min).finish()


def topk_merge_pipelined(scan_chunk, n_chunks: int, k: int, comms: Comms,
                         select_min: bool = True, quantized: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan -> select -> exchange pipeline. ``scan_chunk(c)``
    yields this rank's best-first ``(n_queries, kk_c)`` candidates of
    producer chunk c (global ids; the chunks' candidate sets DISJOINT).
    Chunk c's ring exchange (the bf16 ring with its re-rank when
    ``quantized``) is posted once the chunk is scanned and waited, before
    the chunk's merge, after chunk c + 1 is scanned. The per-chunk results
    fold into a running candidate set under the shared (distance,
    lowest-id) order, so the exact variant is bit-identical to
    ``topk_merge`` of the concatenated chunks with "allgather". Returns
    width ``min(k, sum_c n_dev kk_c)``."""
    n_dev = comms.get_size()
    acc = None
    open_merge = None

    def fold(acc, part):
        if acc is None:
            return part
        return _merge_two(acc[0], acc[1], part[0], part[1],
                          min(k, acc[0].shape[1] + part[0].shape[1]),
                          select_min)

    for c in range(n_chunks):
        d, i = scan_chunk(c)
        expects(d.ndim == 2 and d.shape == i.shape,
                "scan_chunk must yield (n_queries, kk) candidates")
        if open_merge is not None:
            acc = fold(acc, open_merge.finish())
        w_c = min(k, n_dev * d.shape[1])
        if n_dev == 1:
            open_merge = _Local(d, i, w_c, select_min)
        elif quantized:
            open_merge = _Bf16GuardedRing(d, i, w_c, comms, select_min)
        else:
            open_merge = _RingMerge(d, i, w_c, comms, select_min)
    return fold(acc, open_merge.finish())
