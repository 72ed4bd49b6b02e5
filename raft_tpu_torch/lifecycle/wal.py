"""Write-ahead mutation log: durable replay, snapshots, promotion.

Port of ``raft_tpu/lifecycle/wal.py``. Every mutation since the last
``save`` used to die with the process; this log makes the mutable
sharded indexes durable:

* **Record stream**: every committed mutation (extend / delete / upsert /
  compact / migrate) appends ONE CRC-framed, epoch-stamped record before
  the serving reference swaps. The epoch bump is the commit point: a
  record exists iff its epoch was published, so a kill between append
  and swap re-applies on replay (redo) and a kill before the append
  loses a mutation no reader saw (rollback). Epochs advance by exactly
  one per record, so replay detects a torn mid-stream record as an epoch
  gap and stops at the last complete epoch.
* **Segments**: records append to per-part segment files
  (``root/part{p}/seg-*.wal``; a record lands in part ``epoch %
  n_parts``). Appends fsync through the injectable
  :class:`~raft_tpu_torch.util.atomic_io.FileIO` seam (the chaos harness
  tears them at scripted byte offsets); a torn tail is tolerated on each
  part's LAST segment and truncated back to the last clean frame when
  the writer reopens. A torn SEALED segment raises :class:`WalCorruption`.
* **Snapshots**: periodic copy-on-write snapshots through the crash-safe
  :func:`~raft_tpu_torch.parallel.ivf.sharded_ivf_save` under fresh
  ``snapshots/snap-{epoch}`` basenames (manifest last, so a kill
  mid-snapshot leaves the previous snapshot authoritative); :func:`recover`
  loads the newest verifiable snapshot and replays the log tail over it.
* **Followers**: a read-only :class:`Follower` tails the log under the
  snapshot-swap publish contract; :class:`PromotionManager` (fed by
  ``ShardHealth.watch``) catches it up to the head and flips it writable.

The frame bytes are the reference's (``encode_record`` of the same
arrays gives the same bytes, the payload an ``np.savez`` archive with the
reference's keys and dtypes), so a log either package writes replays in
the other. Compaction's placement balancer reads process-local traffic,
so a compact record stores its outcome (the owners and live mask) and
replay migrates to it.

SPMD (one process per rank, ``mesh=``): rank 0 is the log's one writer
and reader, on the file system the ranks share (as the sharded snapshots
assume). It opens, repairs, appends to and decodes every part; the
outcome of each of these is agreed (``comms/agree.py``), so a torn
append on rank 0 raises the same :class:`InjectedFault` (or any error)
on every rank before any rank publishes, and ``records``,
``head_epoch``, ``latest_snapshot`` and ``truncate`` return rank 0's
values on every rank: every rank replays the same records and stops at
the same gap. ``post_append`` fires on every rank after the agreement,
and a fault there on any rank raises on every rank. A snapshot is
collective (``sharded_ivf_save``) and its cadence reads only agreed
epochs, so every rank snapshots at the same publish. With ``mesh=None``
the log is one process's, as in the reference. ``WalStats``' fsync
counters are the writer's (rank 0's); its records, bytes, snapshots and
epochs are the same on every rank.

Promotion over a sharded follower: each rank holds its own
``ShardHealth``, and a callback that ran a collective replay on a rank
whose registry alone saw the primary die would leave that rank waiting
in a collective the others never enter. So there the watch callback only
marks the edge, and the promotion runs at the follower's next
:meth:`Follower.poll` (or ``catch_up``), a collective point, when the
edge reached EVERY rank's registry (a scripted ``mark_dead`` on every
rank, the ``RecoveryProber``'s broadcast verdicts, an agreed failure).
An edge on one rank alone neither promotes nor hangs; it waits for the
others. A follower on one process promotes in the callback, as in the
reference.

Record frame (little-endian)::

    <4s I  I    Q     Q   Q           I    > + payload
    RWAL ver kind  epoch seq payload_len crc32(payload)
"""

from __future__ import annotations

import copy
import dataclasses
import glob
import io
import os
import struct
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.comms.agree import agreed, root_value
from raft_tpu_torch.comms.comms import Comms
from raft_tpu_torch.core.error import RaftError, expects
from raft_tpu_torch.core.logger import logger
from raft_tpu_torch.util.atomic_io import (DEFAULT_IO, FileIO, crc32,
                                          savez_bytes)

_MAGIC = b"RWAL"
WAL_VERSION = 1
#: Record kinds in wire order (the header stores the tuple index).
RECORD_KINDS = ("extend", "delete", "upsert", "compact", "migrate")
_HEADER = struct.Struct("<4sIIQQQI")


class WalCorruption(RaftError):
    """A sealed log segment failed frame validation: unlike a torn tail
    on the open segment (tolerated and repaired), bytes the log already
    durably committed changed under it."""


@dataclass(frozen=True)
class WalRecord:
    """One decoded log record. ``epoch`` is the POST-mutation index
    epoch (the committed version this record produces); ``seq`` is the
    log-global append order (total order across parts)."""

    kind: str
    epoch: int
    seq: int
    payload: bytes

    @property
    def arrays(self) -> Dict[str, np.ndarray]:
        with np.load(io.BytesIO(self.payload), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}


def encode_record(kind: str, epoch: int, seq: int, arrays) -> bytes:
    """Frame one record: header + savez payload, CRC over the payload."""
    expects(kind in RECORD_KINDS, "unknown record kind %r", kind)
    payload = savez_bytes(**arrays)
    header = _HEADER.pack(_MAGIC, WAL_VERSION, RECORD_KINDS.index(kind),
                          int(epoch), int(seq), len(payload),
                          crc32(payload))
    return header + payload


def decode_records(data: bytes, *, tolerate_tail: bool = True
                   ) -> Tuple[List[WalRecord], int]:
    """Decode frames from ``data``; returns ``(records, clean_end)``.

    Stops at the first invalid frame (short header, bad magic / version /
    kind, short payload, CRC mismatch): with ``tolerate_tail`` the valid
    prefix is returned and ``clean_end`` marks where the writer truncates
    and resumes; without it the invalid frame raises
    :class:`WalCorruption` (sealed segments must decode completely)."""
    out: List[WalRecord] = []
    off, n = 0, len(data)
    while off < n:
        bad = None
        if off + _HEADER.size > n:
            bad = "short header"
        else:
            magic, version, kind_i, epoch, seq, plen, crc = \
                _HEADER.unpack_from(data, off)
            if magic != _MAGIC:
                bad = "bad magic"
            elif version != WAL_VERSION:
                bad = f"bad version {version}"
            elif kind_i >= len(RECORD_KINDS):
                bad = f"bad kind {kind_i}"
            elif off + _HEADER.size + plen > n:
                bad = "short payload"
            else:
                payload = bytes(data[off + _HEADER.size:
                                     off + _HEADER.size + plen])
                if crc32(payload) != crc:
                    bad = "payload CRC mismatch"
        if bad is not None:
            if tolerate_tail:
                break
            raise WalCorruption(
                f"invalid frame at byte {off}: {bad} "
                f"(sealed segment must decode completely)")
        out.append(WalRecord(RECORD_KINDS[kind_i], int(epoch), int(seq),
                             payload))
        off += _HEADER.size + plen
    return out, off


@dataclass
class WalStats:
    """Host-side counters one :class:`MutationLog` feeds and the metrics
    scrape (``obs.registry.WalCollector``) reads; a scrape never touches
    files or device state. fsync latencies accumulate in a pending list
    the collector drains into its histogram at scrape time."""

    records: int = 0
    bytes: int = 0
    fsyncs: int = 0
    fsync_total_s: float = 0.0
    snapshots: int = 0
    head_epoch: int = 0
    last_snapshot_epoch: int = 0

    def __post_init__(self):
        self._lock = threading.Lock()
        self._pending_fsync_s: List[float] = []

    def record_append(self, n_bytes: int, epoch: int) -> None:
        with self._lock:
            self.records += 1
            self.bytes += int(n_bytes)
            self.head_epoch = max(self.head_epoch, int(epoch))

    def record_fsync(self, seconds: float) -> None:
        with self._lock:
            self.fsyncs += 1
            self.fsync_total_s += float(seconds)
            self._pending_fsync_s.append(float(seconds))

    def drain_fsyncs(self) -> List[float]:
        """Hand pending fsync latencies to the scrape-side histogram
        (each latency is observed exactly once across scrapes)."""
        with self._lock:
            out, self._pending_fsync_s = self._pending_fsync_s, []
            return out

    def record_snapshot(self, epoch: int) -> None:
        with self._lock:
            self.snapshots += 1
            self.last_snapshot_epoch = int(epoch)
            self.head_epoch = max(self.head_epoch, int(epoch))


class LogWriter:
    """Append-only segment writer for ONE log part directory.

    On open, the newest segment's tail is validated and a torn tail
    (power loss mid-append) is truncated back to the last clean frame;
    the repaired file then keeps appending. Rotation seals a segment at
    ``segment_bytes`` and opens the next; sealed segments are immutable
    and must decode completely. One process's (rank 0's, SPMD)."""

    def __init__(self, part_dir: str, *, file_io: FileIO = DEFAULT_IO,
                 fsync: bool = True, segment_bytes: int = 4 << 20,
                 stats: Optional[WalStats] = None,
                 monotonic: Callable[[], float] = time.monotonic):
        os.makedirs(part_dir, exist_ok=True)
        self.part_dir = part_dir
        self.file_io = file_io
        self.fsync = fsync
        self.segment_bytes = segment_bytes
        self.stats = stats
        self._monotonic = monotonic
        self._f = None
        segs = self.segments()
        if segs:
            self._repair_tail(segs[-1])
            self._seg_index = len(segs) - 1
            self._open(segs[-1])
        else:
            self._seg_index = 0
            self._open(self._seg_path(0))

    def _seg_path(self, i: int) -> str:
        return os.path.join(self.part_dir, f"seg-{i:08d}.wal")

    def segments(self) -> List[str]:
        return sorted(glob.glob(os.path.join(self.part_dir, "seg-*.wal")))

    def _repair_tail(self, path: str) -> None:
        with open(path, "rb") as f:
            data = f.read()
        _, clean_end = decode_records(data, tolerate_tail=True)
        if clean_end < len(data):
            logger.warning("wal: truncating torn tail of %s at byte %s "
                           "(was %s)", path, clean_end, len(data))
            with open(path, "r+b") as f:
                f.truncate(clean_end)

    def _open(self, path: str) -> None:
        self._f = open(path, "ab")

    def append(self, frame: bytes) -> None:
        """Append one encoded frame; rotates first when the open segment
        is full, fsyncs after (the durability point)."""
        if self._f.tell() >= self.segment_bytes:
            self._f.close()
            self._seg_index += 1
            self._open(self._seg_path(self._seg_index))
        self.file_io.write_bytes(self._f, frame)
        if self.fsync:
            t0 = self._monotonic()
            self.file_io.fsync(self._f)
            if self.stats is not None:
                self.stats.record_fsync(self._monotonic() - t0)
        else:
            self._f.flush()

    def read(self) -> List[WalRecord]:
        """All records in this part (file order). The open (last) segment
        tolerates a torn tail; sealed segments raise
        :class:`WalCorruption` on any bad frame."""
        self._f.flush()
        segs = self.segments()
        out: List[WalRecord] = []
        for i, path in enumerate(segs):
            with open(path, "rb") as f:
                data = f.read()
            recs, _ = decode_records(data,
                                     tolerate_tail=(i == len(segs) - 1))
            out.extend(recs)
        return out

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def _snap_basename(root: str, epoch: int) -> str:
    return os.path.join(root, "snapshots", f"snap-{epoch:012d}")


def _files_signature(base: str):
    """(name, size, mtime) of a snapshot's manifest and every file it
    lists, or None when one is missing: the key under which a verified
    manifest stays verified."""
    mpath = f"{base}.manifest.npz"
    try:
        with np.load(mpath) as m:
            names = [str(n) for n in m["files"]]
        sig = []
        for path in [mpath] + [os.path.join(os.path.dirname(base), n)
                               for n in names]:
            st = os.stat(path)
            sig.append((path, st.st_size, st.st_mtime_ns))
        return tuple(sig)
    except (OSError, KeyError, ValueError):
        return None


class MutationLog:
    """The durable mutation log of one sharded index.

    Layout under ``root``::

        root/part{0..n_parts-1}/seg-*.wal    record segments
        root/snapshots/snap-{epoch:012d}.*   sharded_ivf_save file sets

    A record appends to part ``epoch % n_parts`` (pass ``n_parts =
    placement.n_dev`` to spread the log like the list placement spreads
    probe load); readers merge the parts back into total (epoch, seq)
    order.

    ``post_append`` is the chaos hook fired AFTER a record is durable and
    before control returns to the publisher: a fault there simulates a
    kill between commit and the in-memory swap (the redo case).

    ``mesh``: the mesh of the sharded searcher the log serves (SPMD:
    every rank builds the log with the same arguments; rank 0 writes and
    reads, see the module docstring). Every method but ``close`` is then
    collective. None: one process's log.
    """

    def __init__(self, root: str, *, n_parts: int = 1,
                 segment_bytes: int = 4 << 20,
                 file_io: FileIO = DEFAULT_IO, fsync: bool = True,
                 snapshot_every: int = 0, retry=None,
                 stats: Optional[WalStats] = None,
                 post_append: Optional[Callable[[], None]] = None,
                 monotonic: Callable[[], float] = time.monotonic,
                 mesh=None):
        expects(n_parts >= 1, "n_parts must be >= 1, got %s", n_parts)
        self.root = root
        self.n_parts = n_parts
        self.retry = retry
        self.file_io = file_io
        self.snapshot_every = snapshot_every
        self.stats = stats if stats is not None else WalStats()
        self.post_append = post_append
        self.mesh = mesh
        self._comms = None if mesh is None else Comms(mesh)
        self._writes = mesh is None or mesh.rank == 0
        self._lock = threading.Lock()
        self._verified: Dict[str, tuple] = {}
        self._writers: List[LogWriter] = []
        seq = head = 0
        with agreed(self._comms):
            if self._writes:
                existing = sorted(glob.glob(os.path.join(root, "part*")))
                expects(not existing or len(existing) == n_parts,
                        "log at %r has %s parts, opened with n_parts=%s — "
                        "the epoch->part modulus would scatter records",
                        root, len(existing), n_parts)
                self._writers = [
                    LogWriter(os.path.join(root, f"part{p}"),
                              file_io=file_io, fsync=fsync,
                              segment_bytes=segment_bytes, stats=self.stats,
                              monotonic=monotonic)
                    for p in range(n_parts)]
                # Resume seq / head from what survived on disk.
                recs = self._read_all()
                seq = (max(r.seq for r in recs) + 1) if recs else 0
                head = max((r.epoch for r in recs), default=0)
        self._seq, head = self._root((seq, head))
        snap = self.latest_snapshot()
        if snap is not None:
            head = max(head, snap[0])
        self.stats.head_epoch = max(self.stats.head_epoch, head)

    # -- SPMD plumbing -------------------------------------------------------
    def _root(self, value):
        """Rank 0's ``value`` on every rank (itself without a mesh)."""
        return value if self._comms is None else root_value(self._comms,
                                                            value)

    def _read_all(self) -> List[WalRecord]:
        out: List[WalRecord] = []
        for w in self._writers:
            out.extend(w.read())
        return out

    # -- append --------------------------------------------------------------
    def append(self, kind: str, epoch: int, arrays) -> WalRecord:
        """Durably append one record (fsynced before return). The caller
        (``Searcher``) swaps the serving reference only AFTER this returns:
        write-ahead order. SPMD: rank 0 writes; its outcome is agreed, so
        a failed append raises the same error on every rank (the returned
        record's payload is the writer's; empty on the other ranks)."""
        with self._lock:
            seq = self._seq
            self._seq += 1
            frame = b""
            with agreed(self._comms):
                if self._writes:
                    frame = encode_record(kind, epoch, seq, arrays)
                    self._writers[int(epoch) % self.n_parts].append(frame)
            self.stats.record_append(self._root(len(frame)), epoch)
        if self.post_append is not None:
            with agreed(self._comms):
                self.post_append()
        return WalRecord(kind, int(epoch), seq, frame[_HEADER.size:])

    # -- read ----------------------------------------------------------------
    def records(self, *, from_epoch: int = 0,
                to_epoch: Optional[int] = None) -> List[WalRecord]:
        """All surviving records with ``from_epoch <= epoch`` (and ``<=
        to_epoch`` when given), merged across parts into total (epoch,
        seq) order; SPMD: rank 0's, on every rank."""
        out: List[WalRecord] = []
        with agreed(self._comms):
            if self._writes:
                out = sorted(self._read_all(),
                             key=lambda r: (r.epoch, r.seq))
                out = [r for r in out
                       if r.epoch >= from_epoch
                       and (to_epoch is None or r.epoch <= to_epoch)]
        return self._root(out)

    def head_epoch(self) -> int:
        """Newest committed epoch on disk (records or snapshot)."""
        head = 0
        with agreed(self._comms):
            if self._writes:
                head = max((r.epoch for r in self._read_all()), default=0)
        head = self._root(head)
        snap = self.latest_snapshot()
        if snap is not None:
            head = max(head, snap[0])
        return head

    # -- snapshots -----------------------------------------------------------
    def snapshot(self, index, mesh) -> str:
        """Write a full copy-on-write snapshot of ``index`` at its current
        epoch through the crash-safe ``sharded_ivf_save`` (collective; a
        fresh basename per epoch, manifest last: a kill mid-snapshot
        leaves the previous snapshot authoritative)."""
        from raft_tpu_torch.parallel.ivf import sharded_ivf_save

        base = _snap_basename(self.root, int(index.epoch))
        os.makedirs(os.path.dirname(base), exist_ok=True)
        sharded_ivf_save(mesh, base, index, retry=self.retry,
                         file_io=self.file_io)
        self.stats.record_snapshot(int(index.epoch))
        return base

    def maybe_snapshot(self, index, mesh) -> Optional[str]:
        """Snapshot when the index has advanced ``snapshot_every`` epochs
        past the last snapshot (0 = never automatic)."""
        if self.snapshot_every <= 0:
            return None
        if (int(index.epoch) - self.stats.last_snapshot_epoch
                < self.snapshot_every):
            return None
        return self.snapshot(index, mesh)

    def _verified_epoch(self, base: str) -> Optional[int]:
        """``verify_sharded_manifest(base)``, remembered while the files
        keep their sizes and modification times (a verify reads every
        byte of the snapshot)."""
        from raft_tpu_torch.parallel.ivf import verify_sharded_manifest

        sig = _files_signature(base)
        hit = self._verified.get(base)
        if sig is not None and hit is not None and hit[0] == sig:
            return hit[1]
        epoch = verify_sharded_manifest(base)
        if sig is not None:
            self._verified[base] = (sig, epoch)
        return epoch

    def latest_snapshot(self) -> Optional[Tuple[int, str]]:
        """Newest VERIFIABLE snapshot as ``(epoch, basename)``, or None. A
        torn newest snapshot (kill mid-save) fails manifest verification
        and falls back to the next older one. SPMD: rank 0 verifies."""
        found = None
        with agreed(self._comms):
            if self._writes:
                pattern = os.path.join(self.root, "snapshots",
                                       "snap-*.manifest.npz")
                for mpath in sorted(glob.glob(pattern), reverse=True):
                    base = mpath[:-len(".manifest.npz")]
                    try:
                        epoch = self._verified_epoch(base)
                    except RaftError as err:
                        logger.warning("wal: skipping torn snapshot %s "
                                       "(%s)", base, err)
                        continue
                    if epoch is not None:
                        found = (int(epoch), base)
                        break
        return self._root(found)

    def truncate(self, up_to_epoch: int) -> int:
        """Drop SEALED segments whose every record is ``<= up_to_epoch``
        (typically the last snapshot's epoch: replay never needs them
        again). The open segment always survives. Returns segments
        removed."""
        removed = 0
        with agreed(self._comms):
            if self._writes:
                for w in self._writers:
                    for path in w.segments()[:-1]:
                        with open(path, "rb") as f:
                            recs, _ = decode_records(f.read(),
                                                     tolerate_tail=False)
                        if all(r.epoch <= up_to_epoch for r in recs):
                            os.remove(path)
                            removed += 1
        return self._root(removed)

    def close(self) -> None:
        for w in self._writers:
            w.close()


# -- replay -----------------------------------------------------------------

def _policy_payload(policy) -> Dict[str, np.ndarray]:
    """Compaction policy as record arrays (the balancer stripped, see
    the module docstring; None encodes as -1)."""
    return dict(
        trigger_frac=np.float64(policy.trigger_frac),
        shrink_capacity=np.int64(int(policy.shrink_capacity)),
        split_above=np.float64(-1.0 if policy.split_above is None
                               else policy.split_above),
        drift_threshold=np.float64(-1.0 if policy.drift_threshold is None
                                   else policy.drift_threshold),
        min_split_rows=np.int64(policy.min_split_rows))


def _policy_from_payload(a):
    from raft_tpu_torch.lifecycle.compact import CompactionPolicy

    def opt(x):
        x = float(x)
        return None if x < 0 else x

    return CompactionPolicy(
        trigger_frac=float(a["trigger_frac"]),
        shrink_capacity=bool(int(a["shrink_capacity"])),
        split_above=opt(a["split_above"]),
        drift_threshold=opt(a["drift_threshold"]),
        min_split_rows=int(a["min_split_rows"]))


def apply_record(mesh, index, rec: WalRecord):
    """Apply ONE record to a copy-on-write copy of ``index`` through the
    ordinary lifecycle mutators (collective); returns the successor at
    exactly ``rec.epoch`` (checked: a mismatch means the log and the
    index diverged)."""
    from raft_tpu_torch.lifecycle.compact import compact as _compact
    from raft_tpu_torch.lifecycle.delete import delete as _delete
    from raft_tpu_torch.lifecycle.delete import upsert as _upsert
    from raft_tpu_torch.parallel import ivf as _pivf

    a = rec.arrays
    if rec.kind == "extend":
        fn = (_pivf.sharded_ivf_pq_extend
              if isinstance(index, _pivf.ShardedIvfPq)
              else _pivf.sharded_ivf_flat_extend)
        index = copy.copy(index)
        fn(mesh, index, a["vectors"], a["ids"], donate=False)
    elif rec.kind == "delete":
        index = copy.copy(index)
        n = _delete(index, a["ids"], mesh=mesh)
        expects(n > 0, "replayed delete (epoch %s) tombstoned nothing — "
                "the record was only written for a non-empty delete",
                rec.epoch)
    elif rec.kind == "upsert":
        index = copy.copy(index)
        _upsert(index, a["vectors"], a["ids"], mesh=mesh, donate=False)
    elif rec.kind == "compact":
        new, _report = _compact(index, _policy_from_payload(a), mesh=mesh)
        if "owner" in a:
            # The original pass balanced the placement; replay migrates
            # straight to the recorded outcome (the traffic it weighed is
            # gone with the process).
            new, _ = _pivf.sharded_migrate_lists(
                mesh, new, a["owner"],
                live_mask=a["live"] if "live" in a else None)
        # One published bump per pass however many steps replay took, as
        # compact() itself publishes.
        index = dataclasses.replace(new, epoch=rec.epoch, _route_sizes=None)
    elif rec.kind == "migrate":
        index, _ = _pivf.sharded_migrate_lists(
            mesh, index, a["owner"],
            live_mask=a["live"] if "live" in a else None)
    else:  # pragma: no cover - encode_record validates kinds
        raise WalCorruption(f"unknown record kind {rec.kind!r}")
    expects(int(index.epoch) == rec.epoch,
            "replay diverged: record epoch %s produced index epoch %s",
            rec.epoch, int(index.epoch))
    return index


def replay(mesh, index, log: MutationLog, *,
           to_epoch: Optional[int] = None):
    """Re-apply every committed record after ``index.epoch`` (up to
    ``to_epoch`` when given) in total order (collective). Epochs advance
    by exactly one per record, so a gap (a torn record dropped, with later
    parts still holding newer records) stops the replay at the last
    complete epoch: torn mid-stream records roll back, never half-apply."""
    for rec in log.records(from_epoch=int(index.epoch) + 1,
                           to_epoch=to_epoch):
        if rec.epoch != int(index.epoch) + 1:
            logger.warning(
                "wal: epoch gap at record %s (index at %s) — stopping "
                "replay at the last complete epoch", rec.epoch,
                int(index.epoch))
            break
        index = apply_record(mesh, index, rec)
    return index


def recover(mesh, root: str, *, to_epoch: Optional[int] = None,
            retry=None, **log_kwargs):
    """Reconstruct the index at the newest complete epoch (or
    ``to_epoch``): load the newest verifiable snapshot onto ``mesh``,
    replay the log tail over it (collective). Returns ``(index, log)``;
    the log (over ``mesh``) is open for further appends (a promoted
    follower keeps writing to it). ``retry`` retries snapshot file I/O on
    transient ``OSError`` (``sharded_ivf_load(retry=)``)."""
    from raft_tpu_torch.parallel.ivf import sharded_ivf_load

    log_kwargs.setdefault("mesh", mesh)
    log = MutationLog(root, retry=retry, **log_kwargs)
    snap = log.latest_snapshot()
    expects(snap is not None,
            "no snapshot under %r — write one (MutationLog.snapshot) "
            "when the log is created, before mutations append", root)
    snap_epoch, base = snap
    index = sharded_ivf_load(mesh, base, retry=retry)
    # The epoch is process state, not saved in the model file; the
    # snapshot's manifest carries it so replay can line records up.
    index.epoch = snap_epoch
    return replay(mesh, index, log, to_epoch=to_epoch), log


# -- followers + promotion --------------------------------------------------

class Follower:
    """A read-only serving endpoint tailing a :class:`MutationLog`.

    The follower's ``Searcher`` (over a recovered index) is made
    ``writable=False``; :meth:`catch_up` replays newly committed records
    and publishes each advance under the searcher's snapshot-swap
    contract. ``lag`` is epochs behind the head AS OF the last catch-up or
    poll, a host counter the metrics scrape reads without touching files.
    ``poll`` and ``catch_up`` are collective over a sharded searcher."""

    def __init__(self, searcher, log: MutationLog):
        expects(getattr(searcher, "mesh", None) is not None,
                "a follower tails a sharded searcher")
        searcher.writable = False
        self.searcher = searcher
        self.log = log
        self._head_seen = int(searcher._index.epoch)
        # A sharded PromotionManager's edge agreement (module docstring).
        self._edge_check: Optional[Callable[[], None]] = None

    @property
    def epoch(self) -> int:
        return int(self.searcher._index.epoch)

    @property
    def lag(self) -> int:
        """Epochs behind the log head as of the last catch_up / poll."""
        return max(0, self._head_seen - self.epoch)

    def poll(self) -> int:
        """Refresh the head-epoch watermark from disk; returns lag. Over a
        sharded follower watched by a :class:`PromotionManager` this is
        where a primary death seen on every rank promotes."""
        if self._edge_check is not None:
            self._edge_check()
        self._head_seen = max(self._head_seen, self.log.head_epoch())
        return self.lag

    def catch_up(self, *, to_epoch: Optional[int] = None) -> int:
        """Replay committed records past the follower's epoch and publish
        the result; returns how many epochs were applied."""
        self.poll()
        before = self.epoch
        idx = replay(self.searcher.mesh, self.searcher._index, self.log,
                     to_epoch=to_epoch)
        if int(idx.epoch) != before:
            self.searcher.publish_index(idx)
        return int(idx.epoch) - before


class PromotionManager:
    """Promote a follower when the primary's shard goes dead.

    Subscribes to ``ShardHealth.watch``: on the primary rank's live->dead
    edge the follower catches up to the log head and its searcher flips
    writable. Idempotent (one promotion per manager; dead ranks never
    auto-revive). Over a sharded follower the edge is agreed at the
    follower's next poll and promotes only when every rank saw it (module
    docstring); ``promote()`` itself is then collective."""

    def __init__(self, follower: Follower, health, primary_rank: int):
        self.follower = follower
        self.health = health
        self.primary_rank = primary_rank
        self.promotions = 0
        self.promoted = False
        self._lock = threading.Lock()
        mesh = follower.searcher.mesh
        self._comms = Comms(mesh) if mesh.size > 1 else None
        self._edge = False
        if self._comms is not None:
            follower._edge_check = self._agree_edge
        self._unsub = health.watch(primary_rank, self._on_dead)

    def _on_dead(self) -> None:
        if self._comms is None:
            self.promote()
        else:
            self._edge = True       # agreed at the follower's next poll

    def _agree_edge(self) -> None:
        """Collective: promote when every rank's registry saw the edge."""
        if self.promoted:           # the same on every rank
            return
        flags = self._comms.allgather(torch.tensor([int(self._edge)]))
        if bool(flags.all()):
            self.promote()

    def promote(self) -> bool:
        """Catch up and flip writable; returns False when already
        promoted (the idempotent re-entry)."""
        with self._lock:
            if self.promoted:
                return False
            self.promoted = True
        self.follower.catch_up()
        self.follower.searcher.writable = True
        self.promotions += 1
        logger.warning("wal: follower promoted to primary (rank %s "
                       "dead) at epoch %s", self.primary_rank,
                       self.follower.epoch)
        return True

    def close(self) -> None:
        self._unsub()
        if self.follower._edge_check == self._agree_edge:
            self.follower._edge_check = None
