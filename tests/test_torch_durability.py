"""Parity of raft_tpu_torch's write-ahead mutation log (lifecycle/wal.py:
recovery, replay, followers and promotion, the searcher's write-ahead
arms) with raft_tpu's, over the sharded indexes.

The reference runs on ``tests/conftest.py``'s 8-device CPU mesh (its first
4 devices), the port in one gloo world of 4 CPU ranks
(``test_torch_world.World``; rank-side cases in ``torch_durable_cases``).
The same seeded integer data and models go to both, and every search
probes every list through the allgather merge, so ids and distances must
agree bit for bit. On the CPU replay is deterministic, so a recovered
port index must equal the uninterrupted port index array for array, on
every rank.

The log's writer is rank 0 (module docstring of lifecycle/wal.py): a
fault in rank 0's log write, or in ``post_append`` on any one rank, must
raise the same error on every rank and publish nowhere.
"""

import glob
import os

import numpy as np
import pytest

import raft_tpu.lifecycle as jlc
import raft_tpu.parallel as jpar
from raft_tpu.comms.topk_merge import merge_dispatch_stats as jmerge_stats
from raft_tpu.serve import Searcher as JSearcher
from test_topk_merge import _mesh
from test_torch_common import int_data
from test_torch_routed import _eq, _ref_index, _ref_params
from test_torch_sharded_pq import _model
from test_torch_world import World
from torch_durable_cases import (N_LISTS, apply_step, case_epoch_gap,
                                 case_follower, case_wal_kill,
                                 case_wal_recover, case_wal_states,
                                 case_wal_write, case_write_ahead,
                                 wal_steps)

K = 5
STEPS = ("extend", "delete", "upsert", "compact", "extend2")
KIND_PLACEMENTS = [("flat", "list"), ("flat", "row"), ("pq", "list"),
                   ("pq", "row")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("durability_world"))
    yield w
    w.close()


def _data(kind):
    """(X, the port's model, the reference's model, Q) of ``kind``."""
    rng = np.random.default_rng(21)
    if kind == "flat":
        X = int_data(rng, (256, 8))
        centers = X[::32][:N_LISTS]
        return X, centers, centers, int_data(rng, (16, 8))
    model, jmodel = _model(rng)
    return (int_data(rng, (256, 16), hi=4), model, jmodel,
            int_data(rng, (16, 16), hi=4))


DATA = {kind: _data(kind) for kind in ("flat", "pq")}


def ref_search(mesh, kind, index):
    fn = (jpar.sharded_ivf_flat_search if kind == "flat"
          else jpar.sharded_ivf_pq_search)
    with jpar.routing_stats.suppress(), jmerge_stats.suppress():
        out = fn(mesh, _ref_params(kind, "scan", N_LISTS), index,
                 DATA[kind][3], K, merge_engine="allgather")
    return tuple(np.asarray(o) for o in out)


def _ref_searcher(mesh, kind, index, log):
    return JSearcher("ivf_flat" if kind == "flat" else "ivf_pq", mesh=mesh,
                     index=index,
                     search_params=_ref_params(kind, "scan", N_LISTS),
                     wal=log)


def ref_write(kind, placement, root, snap_after=None):
    """The reference's stream with its log (an epoch-0 snapshot first, one
    more after step ``snap_after``): its states (epoch, search) after each
    step and the log's (kind, epoch, seq) records."""
    mesh = _mesh(4)
    jpar.routing_stats.reset()
    X, _, jmodel, _ = DATA[kind]
    index = _ref_index(mesh, kind, X, jmodel, placement)
    log = jlc.MutationLog(root, n_parts=2, fsync=False)
    log.snapshot(index, mesh)
    s = _ref_searcher(mesh, kind, index, log)
    states = [(s.epoch, ref_search(mesh, kind, s._index))]
    for j, step in enumerate(wal_steps(kind), start=1):
        apply_step(s, step, jlc.CompactionPolicy)
        states.append((s.epoch, ref_search(mesh, kind, s._index)))
        if j == snap_after:
            log.snapshot(s._index, mesh)
    recs = [(r.kind, r.epoch, r.seq) for r in log.records()]
    log.close()
    return states, recs


_REF, _PORT = {}, {}


def ref_states(kind, placement, tmp_path_factory):
    key = (kind, placement)
    if key not in _REF:
        _REF[key] = ref_write(kind, placement, str(
            tmp_path_factory.mktemp(f"ref-{kind}-{placement}")))
    return _REF[key]


def port_states(world, kind, placement, tmp_path_factory):
    """The port's uninterrupted stream: per rank, the states and the
    records."""
    key = (kind, placement)
    if key not in _PORT:
        X, model, _, Q = DATA[kind]
        _PORT[key] = world.run(case_wal_states, 4, kind, placement, X,
                               model, Q, K, str(tmp_path_factory.mktemp(
                                   f"port-{kind}-{placement}")))
    return _PORT[key]


@pytest.mark.parametrize("kind,placement", KIND_PLACEMENTS)
def test_stream_equals_the_reference(world, tmp_path_factory, kind,
                                     placement):
    """The logged stream: the same epochs (one per mutation), answers and
    records as the reference's, and every rank the same answers."""
    ref, ref_recs = ref_states(kind, placement, tmp_path_factory)
    port = port_states(world, kind, placement, tmp_path_factory)
    for states, recs in port:
        assert recs == ref_recs
        assert [e for e, _, _ in states] == [e for e, _ in ref]
        for (e, got, _), (_, want) in zip(states, ref):
            _eq(got, want, f"epoch {e}")
    assert ref_recs == [("extend", 1, 0), ("delete", 2, 1),
                        ("upsert", 3, 2), ("compact", 4, 3),
                        ("extend", 5, 4)]


def _check_kill(outs, want_epoch, kill_step, states, ref, what):
    err0 = outs[0]["err"]
    assert err0 is not None and err0[0] == "InjectedFault", err0
    for rank, out in enumerate(outs):
        # The same error on every rank, and no rank published.
        assert out["err"] == err0, (what, rank)
        assert out["live_epoch"] == kill_step - 1, (what, rank)
        assert out["rec_epoch"] == want_epoch, (what, rank)
        _eq(out["search"], ref[want_epoch][1], f"{what} rank {rank}")
        # Array for array the uninterrupted port index at that epoch.
        _eq(out["arrays"], states[rank][0][want_epoch][2],
            f"{what} rank {rank} arrays")


@pytest.mark.parametrize("phase", ["pre", "torn", "post"])
@pytest.mark.parametrize("kill_step", range(1, 6), ids=STEPS)
def test_kill_recover_flat_list(world, tmp_path, tmp_path_factory,
                                kill_step, phase):
    """Kill at every step of the stream: before the append (rollback), a
    torn append (rollback), after it (redo, the fault on rank 2 alone)."""
    kind, placement = "flat", "list"
    ref, _ = ref_states(kind, placement, tmp_path_factory)
    states = port_states(world, kind, placement, tmp_path_factory)
    X, model, _, Q = DATA[kind]
    victim = 2 if phase == "post" else 0
    outs = world.run(case_wal_kill, 4, kind, placement, X, model, Q, K,
                     str(tmp_path), kill_step, phase, 45, victim)
    want = kill_step if phase == "post" else kill_step - 1
    _check_kill(outs, want, kill_step, states, ref, f"{phase}@{kill_step}")


@pytest.mark.parametrize("kill_step", range(1, 6), ids=STEPS)
@pytest.mark.parametrize("kind,placement", KIND_PLACEMENTS[1:])
def test_kill_recover_grid(world, tmp_path, tmp_path_factory, kind,
                           placement, kill_step):
    """The other kinds and placements: a torn append at odd steps, a
    durable record then a fault at even ones."""
    ref, _ = ref_states(kind, placement, tmp_path_factory)
    states = port_states(world, kind, placement, tmp_path_factory)
    X, model, _, Q = DATA[kind]
    phase = "torn" if kill_step % 2 else "post"
    outs = world.run(case_wal_kill, 4, kind, placement, X, model, Q, K,
                     str(tmp_path), kill_step, phase, 45, 0)
    want = kill_step if phase == "post" else kill_step - 1
    _check_kill(outs, want, kill_step, states, ref, f"{phase}@{kill_step}")


@pytest.mark.parametrize("offset", [0, 12, 39])
def test_torn_offsets_inside_the_frame(world, tmp_path, tmp_path_factory,
                                       offset):
    """Tearing at the first byte, mid-header and mid-payload all roll
    back the same way."""
    ref, _ = ref_states("flat", "list", tmp_path_factory)
    states = port_states(world, "flat", "list", tmp_path_factory)
    X, model, _, Q = DATA["flat"]
    outs = world.run(case_wal_kill, 4, "flat", "list", X, model, Q, K,
                     str(tmp_path), 2, "torn", offset, 0)
    _check_kill(outs, 1, 2, states, ref, f"offset {offset}")


def test_resume_stream_after_recovery(world, tmp_path, tmp_path_factory):
    """Recovery hands back a live log: the rest of the stream on the
    recovered index ends where the uninterrupted stream ends."""
    ref, _ = ref_states("flat", "list", tmp_path_factory)
    states = port_states(world, "flat", "list", tmp_path_factory)
    X, model, _, Q = DATA["flat"]
    outs = world.run(case_wal_kill, 4, "flat", "list", X, model, Q, K,
                     str(tmp_path), 3, "pre", 45, 0, 2, True)
    for rank, out in enumerate(outs):
        assert out["end_epoch"] == 5
        _eq(out["end_search"], ref[5][1], f"rank {rank}")
        _eq(out["end_arrays"], states[rank][0][5][2], f"rank {rank}")


@pytest.mark.parametrize("kind,placement", KIND_PLACEMENTS)
def test_reference_log_recovers_in_the_port(world, tmp_path,
                                            tmp_path_factory, kind,
                                            placement):
    """A log and snapshots the reference wrote (a second snapshot after
    step 2) recover in the port to the same epoch and answers."""
    ref, _ = ref_states(kind, placement, tmp_path_factory)
    root = str(tmp_path / "ref")
    ref_write(kind, placement, root, snap_after=2)
    outs = world.run(case_wal_recover, 4, kind, root, DATA[kind][3], K)
    for snap, epoch, got, _ in outs:
        assert (snap, epoch) == (2, 5)
        _eq(got, ref[5][1], kind)


@pytest.mark.parametrize("kind,placement", KIND_PLACEMENTS)
def test_port_log_recovers_in_the_reference(world, tmp_path,
                                            tmp_path_factory, kind,
                                            placement):
    """A log and snapshots the port wrote recover in the reference to the
    same epoch and answers."""
    ref, _ = ref_states(kind, placement, tmp_path_factory)
    X, model, _, _ = DATA[kind]
    root = str(tmp_path / "port")
    assert world.run(case_wal_write, 4, kind, placement, X, model, root,
                     2, 3) == [5] * 4
    mesh = _mesh(4)
    rec, log = jlc.recover(mesh, root, n_parts=2, fsync=False)
    try:
        assert log.latest_snapshot()[0] == 3 and int(rec.epoch) == 5
        _eq(ref_search(mesh, kind, rec), ref[5][1], kind)
    finally:
        log.close()


def test_torn_snapshot_falls_back_to_older(world, tmp_path,
                                           tmp_path_factory):
    """A torn newest snapshot (its first shard grown by a byte): recovery
    falls back to the epoch-0 snapshot and replays all five records, in
    the port and in the reference on the same files."""
    ref, _ = ref_states("flat", "list", tmp_path_factory)
    X, model, _, Q = DATA["flat"]
    root = str(tmp_path)
    world.run(case_wal_write, 4, "flat", "list", X, model, root, 2, 3, True)
    for snap, epoch, got, _ in world.run(case_wal_recover, 4, "flat", root,
                                         Q, K):
        assert (snap, epoch) == (0, 5)
        _eq(got, ref[5][1])
    mesh = _mesh(4)
    rec, log = jlc.recover(mesh, root, n_parts=2, fsync=False)
    try:
        assert log.latest_snapshot()[0] == 0 and int(rec.epoch) == 5
    finally:
        log.close()


def test_replay_stops_at_epoch_gap(world, tmp_path, tmp_path_factory):
    states = port_states(world, "flat", "list", tmp_path_factory)
    X, model, _, Q = DATA["flat"]
    outs = world.run(case_epoch_gap, 4, X, model, Q, K, str(tmp_path))
    for rank, (epoch, got) in enumerate(outs):
        assert epoch == 1
        _eq(got, states[rank][0][1][1])


def test_write_ahead_rules(world, tmp_path):
    """Read-only refusals (reads still serve), a delete of absent ids
    appends nothing, the snapshot cadence, and the stats feed: the
    reference's numbers on the reference's script."""
    X, model, jmodel, Q = DATA["flat"]
    outs = world.run(case_write_ahead, 4, X, model, Q, K, str(tmp_path))
    # The reference's cadence and stats on the same script.
    mesh = _mesh(4)
    index = _ref_index(mesh, "flat", X, jmodel, "list")
    log = jlc.MutationLog(str(tmp_path / "ref"), n_parts=2, fsync=False,
                          snapshot_every=2)
    log.snapshot(index, mesh)
    s = _ref_searcher(mesh, "flat", index, log)
    steps = wal_steps("flat")
    apply_step(s, steps[0], jlc.CompactionPolicy)
    snaps = [log.stats.snapshots]
    apply_step(s, steps[1], jlc.CompactionPolicy)
    snaps += [log.stats.snapshots, log.latest_snapshot()[0]]
    st = log.stats
    want_stats = (st.records, st.bytes, st.snapshots, st.head_epoch,
                  st.last_snapshot_epoch)
    log.close()
    for refusals, served, noop, got_snaps, stats in outs:
        assert all(e[0] == "LogicError" and "read-only" in e[1]
                   for e in refusals)
        assert served == (16, K)
        assert noop == (0, [], 0)
        assert got_snaps == snaps == [1, 2, 2]
        assert stats == want_stats


def test_follower_tails_and_promotes(world, tmp_path, tmp_path_factory):
    """A follower refuses writes, tails the primary (poll, catch_up) to
    its answers; a primary death marked on every rank promotes it at its
    next poll: caught up to the head, writable, and its next delete lands
    at head + 1. Promotion is idempotent."""
    ref, _ = ref_states("flat", "list", tmp_path_factory)
    X, model, _, Q = DATA["flat"]
    outs = world.run(case_follower, 4, X, model, Q, K, str(tmp_path),
                     [0, 1, 2, 3])
    for refusal, tail, promo, after in outs:
        assert refusal[0] == "LogicError" and "read-only" in refusal[1]
        lag, applied, lag_after, epoch, p_epoch, got, want = tail
        assert (lag, applied, lag_after, epoch, p_epoch) == (2, 2, 0, 2, 2)
        _eq(got, want)
        _eq(got, ref[2][1])
        assert promo == (True, 1, True, 5, 5)
        n_del, f_epoch, head, got, again, promotions = after
        assert n_del > 0 and f_epoch == head == 6
        assert again is False and promotions == 1


@pytest.mark.parametrize("edge_ranks", [[2], [0]], ids=["rank2", "rank0"])
def test_a_one_rank_edge_neither_promotes_nor_hangs(world, tmp_path,
                                                    edge_ranks):
    """The primary's death seen by one rank's registry alone: no rank
    promotes, nothing waits, and the follower keeps tailing."""
    X, model, _, Q = DATA["flat"]
    outs = world.run(case_follower, 4, X, model, Q, K, str(tmp_path),
                     edge_ranks)
    for refusal, tail, promo, after in outs:
        assert promo == (False, 0, False, 2, 5)
        err, applied, epoch = after
        assert err[0] == "LogicError" and "read-only" in err[1]
        assert (applied, epoch) == (3, 5)


def test_recovered_index_equals_the_log_files_in_both(world, tmp_path):
    """The part files the port wrote decode, record for record, to the
    reference's records of the same stream (kinds, epochs, seqs and
    payload arrays)."""
    X, model, _, _ = DATA["flat"]
    root = str(tmp_path / "port")
    world.run(case_wal_write, 4, "flat", "list", X, model, root)
    ref_root = str(tmp_path / "ref")
    ref_write("flat", "list", ref_root)
    got = jlc.MutationLog(root, n_parts=2, fsync=False)
    want = jlc.MutationLog(ref_root, n_parts=2, fsync=False)
    try:
        for a, b in zip(got.records(), want.records(), strict=True):
            assert (a.kind, a.epoch, a.seq) == (b.kind, b.epoch, b.seq)
            _eq(a.arrays, b.arrays, a.kind)
    finally:
        got.close()
        want.close()
    assert sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(root, "part*"))) == ["part0", "part1"]
