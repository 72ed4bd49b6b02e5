"""Parity of raft_tpu_torch's sharding operations layer (ROADMAP A.4c) with
raft_tpu's: crash-safe sharded save / load, sharded compaction and the
placement balancer, the agreed retry, hedged dispatch, the recovery
breaker on a sharded searcher, and a BatchScheduler over a sharded
Searcher.

The reference runs on ``tests/conftest.py``'s 8-device CPU mesh (its
first 4 devices), the port in one gloo world of 4 CPU ranks
(``test_torch_world.World``, 120 s to answer each call, so a collective
left waiting fails the test instead of hanging the suite). The same
seeded numpy inputs go to both.

Tolerance: integer-valued rows, centers and codebooks (IVF-PQ with the
identity rotation) keep every distance exact in f32, so ids and
distances must agree bit for bit (``tests/test_torch_routed.py``'s and
``tests/test_torch_sharded_pq.py``'s bar). Snapshot files are compared
array for array (zip timestamps differ). Every asymmetric failure (one
rank's file, error or clock) must raise the same error on every rank.
"""

import dataclasses
import os

import numpy as np
import pytest

import raft_tpu.lifecycle as jlc
import raft_tpu.parallel as jpar
from raft_tpu import serve as jserve
from raft_tpu.comms import LatencyPolicy as JLatencyPolicy
from raft_tpu.comms import ShardHealth as JShardHealth
from raft_tpu.core.retry import RetryPolicy as JRetryPolicy
from raft_tpu.neighbors import ivf_flat as jivf
from test_topk_merge import _mesh
from test_torch_common import int_data
from test_torch_routed import _agree, _eq, _eq_ties, _ref_params, ref_steps
from test_torch_sharded_pq import _model
from test_torch_world import (FakeClock, StragglerHook, World,
                              case_compactor, case_recovery, case_retry,
                              case_scheduler, case_sharded_steps,
                              case_snapshot_faults, case_straggler,
                              drive_stream)

N_LISTS, DIM, K = 8, 8, 5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("sharded_ops_world"))
    yield w
    w.close()


def _flat_data(seed=0, n_rows=256, n_q=16):
    rng = np.random.default_rng(seed)
    X = int_data(rng, (n_rows, DIM))
    return X, X[::n_rows // N_LISTS][:N_LISTS], int_data(rng, (n_q, DIM))


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_files(a, b, n_dev):
    """Two snapshots equal array for array (the manifests but for their
    CRCs, which cover the zip timestamps)."""
    for name in ["model"] + [f"shard{s}" for s in range(n_dev)]:
        _eq(_npz(f"{a}.{name}.npz"), _npz(f"{b}.{name}.npz"), name)
    ma, mb = _npz(f"{a}.manifest.npz"), _npz(f"{b}.manifest.npz")
    ma.pop("crc"), mb.pop("crc")
    _eq(ma, mb, "manifest")


# ---------------------------------------------------------------------------
# Save / load


@pytest.mark.parametrize("placement", ["row", "list"])
@pytest.mark.parametrize("kind", ["flat", "pq"])
def test_save_load_round_trip_and_cross_load(world, tmp_path, kind,
                                             placement):
    """Build, replicate (list), delete, save, load and search, on both
    packages; the port then loads the reference's files and the reference
    the port's: the same searches bit for bit, and the two file sets equal
    array for array."""
    rng = np.random.default_rng(3)
    if kind == "flat":
        X, model, Q = _flat_data()
        jmodel = model
    else:
        model, jmodel = _model(rng)
        X = int_data(rng, (256, 16), hi=4)
        Q = int_data(rng, (16, 16), hi=4)
    port_base, ref_base = (str(tmp_path / side / "snap")
                           for side in ("port", "ref"))
    os.makedirs(os.path.dirname(port_base))
    os.makedirs(os.path.dirname(ref_base))
    search = ("search", "auto", 3, "allgather", None, 0)
    head = ([("replicate", [0, 3], None)] if placement == "list" else [])
    head += [("delete", np.arange(0, 256, 7)), search]

    def steps(own, other):
        return head + [("save", own), ("load", own), search,
                       ("load", other), search]

    ref = ref_steps(4, kind, X, jmodel, Q, K, steps(ref_base, ref_base),
                    placement)
    port = _agree(world.run(case_sharded_steps, 4, kind, X, model, Q, K,
                            steps(port_base, ref_base), N_LISTS, placement),
                  4)
    _eq(port, ref)
    # Every search after a load is the search before it.
    n = len(head)
    for j in (n + 2, n + 4):
        _eq(port[2 * j], port[2 * (n - 1)], f"step {j}")
    _same_files(port_base, ref_base, 4)
    # The reference loads the port's files.
    mesh = _mesh(4)
    loaded = jpar.sharded_ivf_load(mesh, port_base)
    fn = (jpar.sharded_ivf_flat_search if kind == "flat"
          else jpar.sharded_ivf_pq_search)
    got = fn(mesh, _ref_params(kind, "auto", 3), loaded, Q, K,
             merge_engine="allgather")
    _eq(tuple(np.asarray(o) for o in got), port[2 * (n - 1)], "cross")
    assert loaded.n_deleted == port[2 * (n - 1) + 1][1]


_FAULT_TEXT = {
    "version": "version mismatch",
    "shards": "shards but the mesh",
    "missing": "missing",
    "missing_legacy": "missing shard file",
    "dtype": "dtype",
    "size": "bytes, manifest says",
    "crc": "CRC",
}


@pytest.mark.parametrize("fault", sorted(_FAULT_TEXT))
def test_a_refused_load_raises_on_every_rank(world, tmp_path, fault):
    """The reference's robustness cases: version skew, a shard-count
    mismatch, a missing shard (with and without a manifest), shard-dtype
    skew, size and CRC drift. Rank 0 finds the fault; every rank raises
    the same LogicError."""
    outs = world.run(case_snapshot_faults, 4, str(tmp_path / "snap"),
                     fault)
    ranks = 2 if fault == "shards" else 4
    errs = outs[:ranks]
    assert all(e == errs[0] for e in errs), errs
    assert errs[0][0] == "LogicError" and _FAULT_TEXT[fault] in errs[0][1]
    assert all(o is None for o in outs[ranks:])


@pytest.mark.parametrize("fault,left", [
    ("torn", "snap.shard2.npz.tmp"), ("rename", "snap.shard3.npz.tmp")])
def test_a_torn_save_raises_on_every_rank(world, tmp_path, fault, left):
    """One rank's write torn at byte 64, or its rename dropped: every rank
    raises that rank's error, no manifest is written, the torn file never
    takes its final name, and the load refuses the set on every rank."""
    outs = world.run(case_snapshot_faults, 4, str(tmp_path / "snap"), fault)
    for err, files, load_err in outs:
        assert err == ("InjectedFault", outs[0][0][1])
        assert left in files and "snap.manifest.npz" not in files
        assert load_err == outs[0][2] and load_err[0] == "LogicError"
        assert "missing shard file" in load_err[1]


def test_a_transient_write_error_is_retried(world, tmp_path):
    """``retry=`` rides out rank 1's failed first write; the snapshot
    verifies and loads on every rank."""
    outs = world.run(case_snapshot_faults, 4, str(tmp_path / "snap"),
                     "retry")
    assert outs == [256] * 4


# ---------------------------------------------------------------------------
# Compaction and the placement balancer


@pytest.mark.parametrize("kind", ["flat", "pq"])
@pytest.mark.parametrize("placement", ["row", "list"])
def test_compaction_equals_the_reference(world, rng, kind, placement):
    """Tombstones then a pass (shrinking the capacity): the report, the
    answers (those of the tombstoned index) and the placement equal the
    reference's; a second pass has nothing to do."""
    if kind == "flat":
        X, model, Q = _flat_data(5)
        jmodel = model
    else:
        model, jmodel = _model(rng)
        X = int_data(rng, (256, 16), hi=4)
        Q = int_data(rng, (16, 16), hi=4)
    search = ("search", "auto", 3, "allgather", None, 0)
    steps = ([("replicate", [1, 2], None)] if placement == "list" else [])
    steps += [("delete", np.arange(0, 64)), search,
              ("compact", dict(shrink_capacity=True), None), search,
              ("compact", {}, None)]
    port = _agree(world.run(case_sharded_steps, 4, kind, X, model, Q, K,
                            steps, N_LISTS, placement), 4)
    ref = ref_steps(4, kind, X, jmodel, Q, K, steps, placement)
    _eq(port, ref)
    j = len(steps) - 3
    assert port[2 * j][0] == 64 and port[2 * j][9] == 0   # reclaimed
    _eq(port[2 * (j + 1)], port[2 * (j - 1)], "compacted = tombstoned")
    assert port[-2] is None


def test_balance_by_observed_load_and_deferred_while_degraded(world):
    """Every list on rank 0, three searches of traffic: a balance pass is
    deferred while a rank is dead, then migrates by the observed loads
    (one epoch bump, answers bit for bit), as the reference's."""
    X, centers, Q = _flat_data(7)
    search = ("search", "auto", 3, "allgather", None, 0)
    dead = np.array([True, True, False, True])
    steps = [("migrate", np.zeros(N_LISTS, np.int64), None), search,
             ("reset",), search, search, search,
             ("compact", dict(balance_placement=1.5), dead),
             ("compact", dict(balance_placement=1.5), np.ones(4, bool)),
             search, ("placement",)]
    port = _agree(world.run(case_sharded_steps, 4, "flat", X, centers, Q,
                            K, steps, N_LISTS, "list"), 4)
    ref = ref_steps(4, "flat", X, centers, Q, K, steps)
    _eq(port, ref)
    assert port[12] is None                       # deferred
    report = port[14]
    assert report[9] > 0 and report[8] == port[1][2] + 1
    # Lists on other ranks can keep another member of an exact tie at the
    # k-th distance (the reference's answers move the same way).
    _eq_ties(port[16], port[2], "answers across the re-balance")
    assert port[18][0].max() < N_LISTS - 1 or len(set(port[18][0])) > 1


def test_compactor_over_a_sharded_searcher(world):
    """The Compactor's own balance trigger (edge-armed: the next tick has
    nothing to do), then a pass whose pre_publish fails on rank 2 only
    (every rank raises it, none publishes), then a clean pass: reports
    and answers equal the reference's."""
    X, centers, Q = _flat_data(9)
    del_ids = np.arange(10, 40)
    port = _agree(world.run(case_compactor, 4, X, centers, Q, K, del_ids),
                  4)
    mesh = _mesh(4)
    sp = jivf.SearchParams(n_probes=3)
    index = jpar.sharded_ivf_flat_build(
        mesh, jivf.IndexParams(n_lists=N_LISTS), X, centers=centers,
        placement="list")
    index, _ = jpar.sharded_migrate_lists(mesh, index,
                                          np.zeros(N_LISTS, np.int64))
    s = jserve.Searcher.ivf_flat(index, sp, mesh=mesh)
    jpar.routing_stats.reset()
    before = s.search(Q, K)
    comp = jlc.Compactor(s, jlc.CompactionPolicy(balance_placement=1.5))
    rep = comp.run_once()
    again = comp.run_once()
    after = s.search(Q, K)
    n_del = s.delete(del_ids)
    rep2 = s.compact(jlc.CompactionPolicy(shrink_capacity=True))
    compacted = s.search(Q, K)
    _eq(port[0], dataclasses.astuple(rep))
    assert port[1] is None and again is None and not port[2]
    _eq(port[3], s._index.placement_map.owner)
    for got, want in ((port[4], before), (port[5], after),
                      (port[10], compacted)):
        _eq(got, (want.distances, want.indices))
    assert port[6] == n_del == len(del_ids)
    assert port[7] == ("InjectedFault", "pre_publish fault") and port[8]
    _eq(port[9], dataclasses.astuple(rep2))
    assert port[11] == s.epoch


# ---------------------------------------------------------------------------
# Agreed retry


def test_agreed_retry(world):
    """Rank 2 loses its result twice: every rank retries, under the same
    backoff, and answers as the reference's faulted Searcher; five losses
    against three attempts raise the original type on every rank."""
    X, _, Q = _flat_data(11)
    outs = world.run(case_retry, 4, X, Q, K, 2, 3)
    mesh = _mesh(4)
    s = jserve.Searcher.brute_force(X, mesh=mesh, retry=JRetryPolicy(
        max_attempts=3, base_delay=0.01), sleep=lambda _t: None)
    left = {"n": 2}
    real = s._dispatch

    def flaky(*a, **kw):
        if left["n"]:
            left["n"] -= 1
            raise OSError("transient")
        return real(*a, **kw)

    s._dispatch = flaky
    want = s.search(Q, K)
    for (d, i), sleeps in outs:
        np.testing.assert_array_equal(i, want.indices)
        np.testing.assert_array_equal(d, want.distances)
        assert sleeps == [0.01, 0.02]
    outs = world.run(case_retry, 4, X, Q, K, 5, 3)
    assert all(o == (("InjectedFault", "result lost"), [0.01, 0.02])
               for o in outs)


# ---------------------------------------------------------------------------
# Hedging and recovery on a routed searcher with a scripted straggler

SERVICE = 0.001
VICTIM = 1


def _straggler_data():
    rng = np.random.default_rng(91)
    X = int_data(rng, (512, DIM))
    centers = X[::64][:N_LISTS]
    mesh = _mesh(4)
    base = jpar.sharded_ivf_flat_build(mesh, jivf.IndexParams(
        n_lists=N_LISTS), X, centers=centers, placement="list")
    owner = base.placement_map.owner
    return rng, X, centers, mesh, base, owner


def _rank_queries(rng, centers, owner, rank, j=0, m=8):
    """m queries around the center of one list ``rank`` owns (n_probes=1:
    the dispatch's participants are exactly that rank)."""
    lists = np.flatnonzero(owner == rank)
    pick = np.full(m, lists[j % len(lists)])
    return (centers[pick] + 0.25 * rng.integers(-1, 2, (m, DIM))
            ).astype(np.float32)


def _ref_straggler(mesh, base, owner, hedged):
    index = jpar.sharded_replicate_lists(mesh, base,
                                         np.flatnonzero(owner == VICTIM))
    clock = FakeClock()
    hook = StragglerHook(clock, SERVICE)
    kw = dict(mesh=mesh, dispatch_hook=hook, monotonic=clock.monotonic)
    health = None
    if hedged:
        health = JShardHealth(4, latency=JLatencyPolicy(
            alpha=0.25, window=8, quantile=0.9, multiplier=3.0,
            min_samples=4))
        kw.update(health=health, hedge=jserve.HedgePolicy(
            quantile=0.9, multiplier=2.0, min_samples=4))
    s = jserve.Searcher.ivf_flat(index, jivf.SearchParams(n_probes=1), **kw)
    return s, health, clock, hook


@pytest.mark.parametrize("hedged", [False, True])
def test_hedged_straggler_stream_equals_the_reference(world, hedged):
    """The reference's straggler scenario (16 warm-up searches, then 40
    with a 10x delay on every dispatch touching the victim, whose lists
    are replicated): latencies on the injected clock, hedged flags,
    answers, coverage, HedgeStats and the health's masks equal the
    reference's; hedged serving fires and wins, coverage holds."""
    rng, X, centers, mesh, base, owner = _straggler_data()
    warm = [_rank_queries(rng, centers, owner, i % 4, i // 4)
            for i in range(16)]
    stream = [_rank_queries(rng, centers, owner, i % 4, i // 4)
              for i in range(40)]
    port = _agree(world.run(case_straggler, 4, X, centers, VICTIM, SERVICE,
                            warm, stream, 10, hedged), 4)
    s, health, clock, hook = _ref_straggler(mesh, base, owner, hedged)
    for q in warm:
        s.search(q, 10)
    hook.fault = (VICTIM, 10 * SERVICE, None)
    lats, flags, ids, cov = [], [], [], 1.0
    for q in stream:
        t0 = clock.monotonic()
        out = s.search(q, 10)
        lats.append(clock.monotonic() - t0)
        flags.append(out.hedged)
        ids.append(out.indices)
        cov = min(cov, float(out.coverage.min()))
    view = None if health is None else (health.suspect_mask,
                                        health.live_mask)
    _eq(port, (np.asarray(lats), flags, ids, cov, s.hedge_stats.snapshot(),
               view))
    assert port[3] == 1.0
    if hedged:
        assert port[4]["fired"] >= 1 and port[4]["won"] >= 1
        assert any(port[1]) and port[5][0][VICTIM]
        assert np.sort(port[0])[-1] == pytest.approx(12 * SERVICE)
    else:
        assert port[0].max() >= 10 * SERVICE and not any(port[1])


def test_recovery_breaker_on_a_sharded_searcher(world):
    """The reference's scripted flap: the victim dead, its second shadow
    probe slowed past the budget; re-admission after exactly three
    consecutive clean probes, on every rank, as the reference's."""
    from raft_tpu.serve import RecoveryProber as JRecoveryProber

    rng, X, centers, mesh, base, owner = _straggler_data()
    probe_q = _rank_queries(rng, centers, owner, VICTIM)
    port = _agree(world.run(case_recovery, 4, X, centers, VICTIM, SERVICE,
                            probe_q, 10), 4)
    s, health, clock, hook = _ref_straggler(mesh, base, owner, True)
    health.mark_dead(VICTIM)
    prober = JRecoveryProber(s, health, probe_q, 10, clean_threshold=3,
                             budget=5 * SERVICE)
    hook.fault = (VICTIM, 10 * SERVICE, (1,))
    steps = [(prober.step(), prober.state(VICTIM)) for _ in range(5)]
    want = (steps, prober.snapshot(), health.state(VICTIM),
            bool(np.isnan(health.latency_ewma(VICTIM))))
    prober.close()
    _eq(port, want)
    assert port[0][-1] == ([VICTIM], "closed") and port[2] == "live"
    assert port[0][1] == ([], "open") and port[3]


# ---------------------------------------------------------------------------
# The scheduler's front rank


def _stream(seed=13, n_req=24):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n_req):
        if reqs and rng.random() < 0.3:
            reqs.append(reqs[rng.integers(0, len(reqs))])
        else:
            reqs.append((int_data(rng, (int(rng.integers(1, 9)), DIM)),
                         int((3, 5, 10)[rng.integers(0, 3)])))
    return reqs


@pytest.mark.parametrize("kind", ["brute_force", "ivf_flat"])
def test_scheduler_over_a_sharded_searcher(world, kind):
    """Rank 0 runs the BatchScheduler, ranks 1-3 follow: the events,
    answers, ServeStats and cache equal the reference scheduler's over
    its sharded Searcher, and every answer is the unbatched sharded
    search's. IVF-Flat: a Compactor daemon's pass runs through the
    command channel on every rank."""
    X, centers, _ = _flat_data(15)
    reqs = _stream()
    del_ids = np.arange(0, 256, 5)
    outs = world.run(case_scheduler, 4, kind, X, centers, reqs, del_ids)
    mesh = _mesh(4)
    if kind == "brute_force":
        js = jserve.Searcher.brute_force(X, mesh=mesh)
    else:
        js = jserve.Searcher.ivf_flat(jpar.sharded_ivf_flat_build(
            mesh, jivf.IndexParams(n_lists=N_LISTS), X, centers=centers,
            placement="list"), jivf.SearchParams(n_probes=3), mesh=mesh)
    want = drive_stream(jserve, js, reqs, FakeClock())
    front = outs[0][0]
    _eq(front, want)
    assert "Overloaded" in front[0]
    n_batches = sum(b["batches"] for b in front[2]["buckets"].values())
    assert [o[0] for o in outs[1:]] == [n_batches] * 3
    for o in outs:
        for got, (q, k) in zip(o[1], reqs):
            np.testing.assert_array_equal(got, js.search(q, k).indices)
    admitted = [j for j, e in enumerate(e for e in front[0]
                                        if isinstance(e, str)) if e == "ok"]
    for j, res in zip(admitted, front[1]):
        if not isinstance(res, str):
            np.testing.assert_array_equal(res[1], outs[0][1][j])
    if kind == "ivf_flat":
        assert outs[0][2] == 1
        assert all(o[3:] == (outs[0][3], 0) for o in outs), outs
