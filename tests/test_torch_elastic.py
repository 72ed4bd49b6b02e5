"""Parity of raft_tpu_torch.lifecycle.elastic (join / leave of the serving
set) with raft_tpu.lifecycle.elastic.

The reference runs on ``tests/conftest.py``'s 8-device CPU mesh (its first
4 devices), the port in one gloo world of 4 CPU ranks (rank-side cases in
``torch_durable_cases``). Both resize a list-placed IVF-Flat built on the
same integer rows and centers, so the placements must be equal owner for
owner (replicas included) and every answer equal bit for bit (every list
probed, the allgather merge). A resize the health gate refuses must raise
the same error on every rank: the gate is rank 0's registry.
"""

import numpy as np
import pytest

import raft_tpu.lifecycle as jlc
import raft_tpu.parallel as jpar
from raft_tpu.comms import ShardHealth as JShardHealth
from raft_tpu.comms.health import LatencyPolicy as JLatencyPolicy
from raft_tpu.comms.topk_merge import merge_dispatch_stats as jmerge_stats
from raft_tpu.serve import BucketGrid as JBucketGrid
from raft_tpu.serve import Searcher as JSearcher
from test_topk_merge import _mesh
from test_torch_common import int_data
from test_torch_routed import _agree, _eq, _ref_index, _ref_params
from test_torch_world import World
from torch_durable_cases import (N_LISTS, case_elastic,
                                 case_elastic_under_traffic)

K = 5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("elastic_world"))
    yield w
    w.close()


_rng = np.random.default_rng(33)
X = int_data(_rng, (256, 8))
CENTERS = X[::32][:N_LISTS]
Q = int_data(_rng, (16, 8))


def _placement(index):
    pm = index.placement_map
    return (pm.owner, pm.slot, pm.replica_owner, pm.replica_slot,
            pm.n_slots)


def ref_elastic(script, replicate=(), root=None, grid_max=0,
                writable=True):
    """The reference's side of ``case_elastic``, shaped like its output
    (errors as (type name, text))."""
    mesh = _mesh(4)
    jpar.routing_stats.reset()
    jlc.elastic_stats.reset()
    health = JShardHealth(4, latency=JLatencyPolicy())
    index = _ref_index(mesh, "flat", X, CENTERS, "list")
    if replicate:
        index = jpar.sharded_replicate_lists(mesh, index, list(replicate))
    log = None
    if root is not None:
        log = jlc.MutationLog(root, n_parts=2, fsync=False)
        log.snapshot(index, mesh)
    s = JSearcher("ivf_flat", mesh=mesh, index=index,
                  search_params=_ref_params("flat", "scan", N_LISTS),
                  health=health, wal=log, writable=writable)
    grid = JBucketGrid.pow2(grid_max, k_grid=(K,)) if grid_max else None
    outs = []
    for step in script:
        op = step[0]
        if op in ("leave", "join"):
            fn = jlc.leave_shard if op == "leave" else jlc.join_shard
            try:
                rep = fn(s, step[1], grid=grid)
                outs.append((rep.action, rep.rank, rep.active_before,
                             rep.active_after, rep.lists_moved,
                             rep.warmed_shapes, rep.epoch))
            except Exception as e:      # noqa: BLE001 - the outcome
                outs.append((type(e).__name__, str(e)))
        elif op == "search":
            with jpar.routing_stats.suppress(), jmerge_stats.suppress():
                res = s.search(Q, K)
            outs.append((res.distances, res.indices, res.coverage))
        elif op == "traffic":
            outs.append(s.search(Q, K).indices)
        elif op == "placement":
            outs.append(_placement(s._index))
        elif op == "shards":
            outs.append(jlc.serving_shards(s._index))
        elif op in ("dead", "dead0"):
            health.mark_dead(step[1])
        elif op == "live":
            health.mark_live(step[1])
        elif op == "suspect":
            health.mark_suspect(step[1])
        elif op == "stats":
            outs.append(jlc.elastic_stats.snapshot())
        elif op == "fanout":
            outs.append(dict(jpar.routing_stats.snapshot()["shard_queries"]))
            jpar.routing_stats.reset()
        elif op == "recover":
            log.close()
            rec, log = jlc.recover(mesh, root, n_parts=2, fsync=False)
            with jpar.routing_stats.suppress(), jmerge_stats.suppress():
                out = jpar.sharded_ivf_flat_search(
                    mesh, _ref_params("flat", "scan", N_LISTS), rec, Q, K,
                    merge_engine="allgather")
            outs.append((int(rec.epoch), _placement(rec),
                         tuple(np.asarray(o) for o in out)))
        if op not in ("dead", "dead0", "live", "suspect"):
            outs.append(s.epoch)
    if log is not None:
        log.close()
    return outs


def _is_error(x):
    return (isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str)
            and x[0].endswith("Error"))


def check(world, script, match=(), **kw):
    """Run ``script`` on both sides; errors compare by type and by the
    phrase in ``match`` (the texts name each package's own terms), the
    rest exactly. Returns the port's outputs (rank 0's)."""
    root = kw.pop("root", None)
    port = _agree(world.run(case_elastic, 4, X, CENTERS, Q, K, script,
                            kw.get("replicate", ()),
                            None if root is None else str(root / "port"),
                            kw.get("grid_max", 0), kw.get("writable", True)),
                  4)
    ref = ref_elastic(script, kw.get("replicate", ()),
                      None if root is None else str(root / "ref"),
                      kw.get("grid_max", 0), kw.get("writable", True))
    assert len(port) == len(ref)
    errs = iter(match)
    for j, (p, r) in enumerate(zip(port, ref)):
        if _is_error(r):
            assert _is_error(p) and p[0] == r[0], (j, p, r)
            phrase = next(errs)
            assert phrase in p[1] and phrase in r[1], (j, p, r)
        else:
            _eq(p, r, f"output {j}")
    assert next(errs, None) is None
    return port


# ---------------------------------------------------------------------------
# TestJoinLeave


def test_leave_drains_and_preserves_results(world):
    out = check(world, [("search",), ("shards",), ("leave", 3),
                        ("placement",), ("shards",), ("search",)])
    assert out[2] == (0, 1, 2, 3) and out[8] == (0, 1, 2)
    rep = out[4]
    assert rep[:4] == ("leave", 3, (0, 1, 2, 3), (0, 1, 2))
    assert rep[6] == out[5] == 1                  # ONE epoch bump
    assert 3 not in set(out[6][0])
    _eq(out[10], out[0])                          # no row lost or moved


def test_join_restores_the_shard(world):
    out = check(world, [("search",), ("leave", 0), ("join", 0),
                        ("shards",), ("search",)])
    assert out[4][0] == "join" and out[4][3] == (0, 1, 2, 3)
    assert out[4][4] > 0 and out[5] == 2
    _eq(out[8], out[0])


def test_replicas_survive_and_avoid_the_leaver(world):
    mesh = _mesh(4)
    index = jpar.sharded_replicate_lists(
        mesh, _ref_index(mesh, "flat", X, CENTERS, "list"), [0, 1])
    leaver = int(index.placement_map.replica_owner[0])
    out = check(world, [("leave", leaver), ("placement",), ("search",)],
                replicate=(0, 1))
    owner, _, rep_owner, _, _ = out[2]
    for lst in (0, 1):
        assert rep_owner[lst] >= 0 and rep_owner[lst] != leaver
        assert owner[lst] != leaver and rep_owner[lst] != owner[lst]


def test_validation(world):
    """The reference's refusals (on every rank), then a drain to one
    shard that still serves every row."""
    out = check(world, [("join", 2), ("leave", 7), ("leave", 1),
                        ("leave", 1), ("leave", 2), ("leave", 3),
                        ("shards",), ("leave", 0), ("search",)],
                match=("already serves", "outside the mesh", "no lists",
                       "last serving shard"))
    assert out[12] == (0,) and out[16][1].shape == (16, K)


def test_readonly_endpoint_cannot_resize(world):
    check(world, [("leave", 0)], match=("read-only",), writable=False)


def test_stats_feed(world):
    out = check(world, [("leave", 3), ("join", 3), ("stats",)])
    snap = out[4]
    assert snap["joins"] == 1 and snap["leaves"] == 1
    assert snap["lists_moved"] >= 1 and snap["last_epoch"] == 2


def test_resize_replays_from_the_log(world, tmp_path):
    """A join / leave is a logged migrate record: recovery reproduces the
    post-resize placement owner for owner, and the answers, in both."""
    (tmp_path / "port").mkdir()
    out = check(world, [("leave", 2), ("join", 2), ("placement",),
                        ("recover",)], replicate=(0,), root=tmp_path)
    epoch, placement, got = out[6]
    assert epoch == out[7] == 3          # replication, then two resizes
    _eq(placement, out[4])


def test_no_dispatch_reaches_a_drained_shard(world):
    """After a leave the routed fan-out never reaches the leaver, and the
    warmed resize reports its shapes."""
    out = check(world, [("traffic",), ("fanout",), ("leave", 3),
                        ("traffic",), ("fanout",), ("search",)],
                grid_max=8)
    assert out[2].get(3, 0) > 0
    assert out[8].get(3, 0) == 0 and out[4][5] > 0


def test_resize_under_traffic(world):
    """Leaves then joins between batches of a front-rank scheduler's
    traffic over a tombstoned index: no answer holds a deleted id or
    partial coverage, the serving set ends where it started, and every
    answer equals the undisturbed reference's."""
    dels = np.arange(0, 256, 4)
    reqs = [int_data(np.random.default_rng(85 + i), (4, 8))
            for i in range(10)]
    resizes = [("leave", 3), ("leave", 2), ("join", 2), ("join", 3)]
    outs = world.run(case_elastic_under_traffic, 4, X, CENTERS, dels, reqs,
                     K, resizes)
    answers, epoch, final = outs[0]
    mesh = _mesh(4)
    ref = _ref_index(mesh, "flat", X, CENTERS, "list")
    jlc.delete(ref, dels, mesh=mesh)
    params = _ref_params("flat", "scan", N_LISTS)
    assert len(answers) == len(reqs) and epoch == 5
    for (ids, cov), q in zip(answers, reqs):
        assert not np.intersect1d(ids.ravel(), dels).size
        assert (cov == 1.0).all()
        want = jpar.sharded_ivf_flat_search(mesh, params, ref, q, K,
                                            merge_engine="allgather")
        np.testing.assert_array_equal(ids, np.asarray(want[1]))
    for _, e, f in outs[1:]:
        assert e == 5
        _eq(f, final)


# ---------------------------------------------------------------------------
# TestElasticHealthGate


def test_join_of_a_degraded_rank_raises_until_mark_live(world):
    out = check(world, [("leave", 2), ("dead", 2), ("join", 2),
                        ("live", 2), ("suspect", 2), ("join", 2),
                        ("live", 2), ("join", 2), ("shards",)],
                match=("mark_live", "mark_live"))
    assert out[6][3] == (0, 1, 2, 3) and out[8] == (0, 1, 2, 3)


def test_the_gate_is_rank_0s(world):
    """Rank 0's registry alone holds the death: the join raises on every
    rank (the reference's single registry holds it too)."""
    check(world, [("leave", 1), ("dead0", 1), ("join", 1), ("shards",)],
          match=("mark_live",))


def test_resize_places_replicas_off_suspect_members(world):
    out = check(world, [("suspect", 2), ("leave", 3), ("placement",),
                        ("search",)], replicate=(0, 1))
    owner, _, rep_owner, _, _ = out[2]
    for lst in (0, 1):
        assert rep_owner[lst] >= 0 and rep_owner[lst] != owner[lst]
        assert rep_owner[lst] not in (2, 3)


def test_all_degraded_fallback_keeps_old_placement_rules(world):
    out = check(world, [("suspect", 0), ("suspect", 1), ("suspect", 2),
                        ("leave", 3), ("placement",)], replicate=(0, 1))
    owner, _, rep_owner, _, _ = out[2]
    for lst in (0, 1):
        assert rep_owner[lst] >= 0 and rep_owner[lst] != 3
        assert rep_owner[lst] != owner[lst]
