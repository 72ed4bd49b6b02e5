"""Parity of raft_tpu_torch.lifecycle.wal's log format and its one-process
writer with raft_tpu.lifecycle.wal (no world: ``MutationLog(mesh=None)``).

The log is a file format, so the bar is bytes: the port's
``encode_record`` must give the reference's frame for the same arrays,
for every record kind and for int32 and int64 ids; ``decode_records``
must give the same ``(records, clean_end)`` on the other package's bytes,
cut at every sampled offset and with a corrupt payload or a bad magic;
and the segment writer and the mutation log (torn-tail repair, rotation,
the loud sealed segment, the parts merge, reopen, the part-count refusal,
``truncate``) must leave the same files and read the same records as the
reference's on the same directories.
"""

import glob
import os

import numpy as np
import pytest

from raft_tpu.core.error import LogicError as JLogicError
from raft_tpu.lifecycle import wal as jwal
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.lifecycle import wal

KINDS = ("extend", "delete", "upsert", "compact", "migrate")


def _arrays(kind, seed=0, n=64, id_dtype=np.int32):
    """A payload with the keys and dtypes the searcher records for
    ``kind``."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(np.arange(10 * n))[:n].astype(id_dtype)
    vecs = rng.normal(size=(n, 8)).astype(np.float32)
    if kind in ("extend", "upsert"):
        return dict(vectors=vecs, ids=ids)
    if kind == "delete":
        return dict(ids=ids)
    owner = rng.integers(0, 4, 16).astype(np.int32)
    live = np.array([True, True, False, True])
    if kind == "migrate":
        return dict(owner=owner, live=live)
    return dict(trigger_frac=np.float64(0.25), shrink_capacity=np.int64(1),
                split_above=np.float64(-1.0),
                drift_threshold=np.float64(2.5),
                min_split_rows=np.int64(16), owner=owner, live=live)


def _recs(recs):
    return [(r.kind, r.epoch, r.seq, r.payload) for r in recs]


def test_format_constants_equal_the_reference():
    assert wal.WAL_VERSION == jwal.WAL_VERSION
    assert wal.RECORD_KINDS == jwal.RECORD_KINDS
    assert wal._HEADER.format == jwal._HEADER.format
    assert wal._MAGIC == jwal._MAGIC


@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("kind", KINDS)
def test_frame_bytes_equal_the_reference(kind, id_dtype):
    a = _arrays(kind, seed=KINDS.index(kind), id_dtype=id_dtype)
    frame = wal.encode_record(kind, 7, 3, a)
    assert frame == jwal.encode_record(kind, 7, 3, a)
    rec, = wal.decode_records(frame)[0]
    for key, want in a.items():
        got = rec.arrays[key]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_unknown_kind_rejected():
    with pytest.raises(LogicError, match="unknown record kind"):
        wal.encode_record("rename", 1, 0, _arrays("delete"))


def _stream(mod):
    return b"".join(mod.encode_record(k, e, e - 1, _arrays(k, seed=e))
                    for e, k in enumerate(KINDS, start=1))


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_truncation_at_every_sampled_offset(writer):
    """Either package's stream, cut at any sampled byte, decodes to the
    same records and clean end in both (the reference suite's offsets,
    plus every frame boundary +-1)."""
    stream = _stream(wal if writer == "port" else jwal)
    frames = np.cumsum([0] + [len(wal.encode_record(
        k, e, e - 1, _arrays(k, seed=e))) for e, k in enumerate(KINDS, 1)])
    offsets = sorted(set(list(range(0, len(stream), 17))
                         + [int(f) + dd for f in frames for dd in (-1, 0, 1)
                            if 0 <= f + dd <= len(stream)]))
    for cut in offsets:
        got = wal.decode_records(stream[:cut])
        want = jwal.decode_records(stream[:cut])
        assert _recs(got[0]) == _recs(want[0]) and got[1] == want[1], cut
        assert len(got[0]) == int(np.searchsorted(frames, cut,
                                                  side="right")) - 1


def test_corrupt_payload_and_bad_magic():
    frame = bytearray(wal.encode_record("extend", 1, 0, _arrays("extend")))
    frame[wal._HEADER.size + 5] ^= 0xFF
    assert wal.decode_records(bytes(frame)) == ([], 0)
    assert jwal.decode_records(bytes(frame)) == ([], 0)
    with pytest.raises(wal.WalCorruption, match="CRC"):
        wal.decode_records(bytes(frame), tolerate_tail=False)
    junk = b"JUNK" + wal.encode_record("delete", 1, 0,
                                       _arrays("delete"))[4:]
    with pytest.raises(wal.WalCorruption, match="magic"):
        wal.decode_records(junk, tolerate_tail=False)
    good = wal.encode_record("delete", 1, 0, _arrays("delete"))
    for bad in (good[:4] + b"\x09" + good[5:],          # version 9
                good[:8] + b"\x07" + good[9:]):         # kind 7
        assert wal.decode_records(bytes(bad)) == ([], 0)
        assert jwal.decode_records(bytes(bad)) == ([], 0)


# ---------------------------------------------------------------------------
# LogWriter and MutationLog against the reference on the same files


def _files(d):
    return {os.path.relpath(p, d): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(d, "**", "*"),
                                      recursive=True))
            if os.path.isfile(p)}


def _both_dirs(tmp_path):
    return str(tmp_path / "port"), str(tmp_path / "ref")


def test_torn_tail_repaired_on_reopen(tmp_path):
    out = {}
    for side, mod, d in zip(("port", "ref"), (wal, jwal),
                            _both_dirs(tmp_path)):
        w = mod.LogWriter(d, fsync=False)
        for e, k in enumerate(KINDS[:2], start=1):
            w.append(mod.encode_record(k, e, e - 1, _arrays(k, e)))
        w.close()
        f3 = mod.encode_record("upsert", 3, 2, _arrays("upsert", 3))
        path = w.segments()[-1]
        with open(path, "ab") as f:
            f.write(f3[:len(f3) // 2])
        w = mod.LogWriter(d, fsync=False)          # reopen repairs
        first = _recs(w.read())
        w.append(f3)
        out[side] = (first, _recs(w.read()), _files(d))
        w.close()
    assert out["port"] == out["ref"]
    assert [r[1] for r in out["port"][1]] == [1, 2, 3]


def test_rotation_and_the_loud_sealed_segment(tmp_path):
    out = {}
    for side, mod, d in zip(("port", "ref"), (wal, jwal),
                            _both_dirs(tmp_path)):
        w = mod.LogWriter(d, fsync=False, segment_bytes=64)
        for e in range(1, 6):
            w.append(mod.encode_record("extend", e, e - 1,
                                       _arrays("extend", e, n=4)))
        segs = [os.path.basename(p) for p in w.segments()]
        recs = _recs(w.read())
        w.close()
        sealed = w.segments()[0]
        with open(sealed, "r+b") as f:
            f.truncate(os.path.getsize(sealed) - 7)
        w = mod.LogWriter(d, fsync=False, segment_bytes=64)
        with pytest.raises(mod.WalCorruption):
            w.read()
        w.close()
        out[side] = (segs, recs, _files(d))
    assert out["port"] == out["ref"]
    assert len(out["port"][0]) == 5


def test_reading_the_other_package_log(tmp_path):
    """A log either package writes reads the same in the other."""
    for writer, reader in ((wal, jwal), (jwal, wal)):
        d = str(tmp_path / writer.__name__.replace(".", "_"))
        log = writer.MutationLog(d, n_parts=3, fsync=False,
                                 segment_bytes=200)
        for e in range(1, 10):
            k = KINDS[e % 5]
            log.append(k, e, _arrays(k, e, n=4))
        want = _recs(log.records())
        log.close()
        other = reader.MutationLog(d, n_parts=3, fsync=False)
        assert _recs(other.records()) == want
        assert other.head_epoch() == 9
        assert other.append("delete", 10, _arrays("delete")).seq == 9
        other.close()


def test_parts_merge_reopen_and_refusal(tmp_path):
    out = {}
    for side, mod, d in zip(("port", "ref"), (wal, jwal),
                            _both_dirs(tmp_path)):
        log = mod.MutationLog(d, n_parts=3, fsync=False)
        for e in range(1, 10):
            log.append("extend", e, _arrays("extend", e, n=4))
        merged = _recs(log.records())
        window = _recs(log.records(from_epoch=3, to_epoch=6))
        log.close()
        log = mod.MutationLog(d, n_parts=3, fsync=False)
        head = log.head_epoch()
        seq = log.append("delete", 10, _arrays("delete", 10, n=4)).seq
        log.close()
        err = JLogicError if mod is jwal else LogicError
        with pytest.raises(err, match="parts"):
            mod.MutationLog(d, n_parts=2, fsync=False)
        out[side] = (merged, window, head, seq, _files(d))
    assert out["port"] == out["ref"]
    assert [r[1] for r in out["port"][0]] == list(range(1, 10))
    assert out["port"][2:4] == (9, 9)


def test_truncate_drops_only_sealed_covered_segments(tmp_path):
    out = {}
    for side, mod, d in zip(("port", "ref"), (wal, jwal),
                            _both_dirs(tmp_path)):
        log = mod.MutationLog(d, n_parts=1, segment_bytes=64, fsync=False)
        for e in range(1, 6):
            log.append("extend", e, _arrays("extend", e, n=4))
        removed = log.truncate(up_to_epoch=3)
        out[side] = (removed, _recs(log.records()), _files(d))
        log.close()
    assert out["port"] == out["ref"]
    assert out["port"][0] == 3


def test_stats_feed_and_fsync_drain(tmp_path):
    """The reference suite's script on an injected clock: appends count
    records and bytes, each fsync latency drains once."""
    out = {}
    for side, mod, d in zip(("port", "ref"), (wal, jwal),
                            _both_dirs(tmp_path)):
        clock = iter(np.arange(0.0, 10.0, 0.5))
        stats = mod.WalStats()
        log = mod.MutationLog(d, n_parts=1, fsync=True, stats=stats,
                              monotonic=lambda: float(next(clock)))
        log.append("extend", 1, _arrays("extend", 1, n=4))
        log.append("delete", 2, _arrays("delete", 2, n=4))
        out[side] = (stats.records, stats.head_epoch, stats.bytes,
                     stats.fsyncs, stats.drain_fsyncs(),
                     stats.drain_fsyncs())
        log.close()
    assert out["port"] == out["ref"]
    assert out["port"][4] == [0.5, 0.5] and out["port"][5] == []


def test_post_append_fires_after_the_record_is_durable(tmp_path):
    seen = []
    log = wal.MutationLog(str(tmp_path), fsync=False,
                          post_append=lambda: seen.append(
                              [r.epoch for r in log.records()]))
    log.append("delete", 1, _arrays("delete"))
    log.append("delete", 2, _arrays("delete", 2))
    assert seen == [[1], [1, 2]]
    log.close()


def test_policy_payload_round_trip():
    """The compact record's policy arrays are the reference's, and decode
    to the policy less its balancer."""
    from raft_tpu.lifecycle import CompactionPolicy as JPolicy
    from raft_tpu_torch.lifecycle import CompactionPolicy

    for kw in (dict(), dict(trigger_frac=0.5, shrink_capacity=True,
                            split_above=2.0, drift_threshold=1.5,
                            min_split_rows=4, balance_placement=1.2)):
        got = wal._policy_payload(CompactionPolicy(**kw))
        want = jwal._policy_payload(JPolicy(**kw))
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype and got[key] == want[key]
        kw.pop("balance_placement", None)
        assert wal._policy_from_payload(got) == CompactionPolicy(**kw)
