"""Parity of the list placement of raft_tpu_torch.parallel (routed IVF-Flat
search, list migration and replication, routed extend and delete, the
routed warmup) with raft_tpu's.

The reference runs on ``tests/conftest.py``'s 8-device CPU mesh, on the
first ``n_dev`` devices; the port in one gloo world of 4 CPU ranks
(``test_torch_world.World``), on its sub-worlds of 1-4 ranks. The same
seeded numpy inputs go to both.

Tolerance: integer-valued data keeps every distance exact in f32, so ids
and distances must agree bit for bit (``tests/test_torch_ivf_flat.py``'s
bar for both tiers), ties included. The port's pipelined engines are held
to the reference's ``allgather`` result (ROADMAP C.4).
"""

import dataclasses

import numpy as np
import pytest

import raft_tpu.lifecycle as jlc
import raft_tpu.parallel as jpar
from raft_tpu.comms import ShardHealth as JShardHealth
from raft_tpu.comms.topk_merge import merge_dispatch_stats as jmerge_stats
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.serve import BucketGrid as JBucketGrid
from raft_tpu.serve import Searcher as JSearcher
from raft_tpu.serve import warmup as jwarmup
from test_topk_merge import _mesh
from test_torch_common import int_data
from test_torch_world import World, case_routed_searcher, case_sharded_steps

ENGINES = ["allgather", "ring", "ring_bf16", "pipelined", "pipelined_bf16"]
N_LISTS = 8


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("routed_world"))
    yield w
    w.close()


def _data(rng, n_rows=256, dim=8, n_q=16):
    X = int_data(rng, (n_rows, dim))
    return X, X[::n_rows // N_LISTS][:N_LISTS], int_data(rng, (n_q, dim))


def _ref_index(mesh, kind, X, model, placement):
    if kind == "flat":
        return jpar.sharded_ivf_flat_build(
            mesh, jivf.IndexParams(n_lists=N_LISTS), X, centers=model,
            placement=placement)
    return jpar.sharded_ivf_pq_build(
        mesh, jpq.IndexParams(n_lists=model.n_lists, pq_dim=model.pq_dim,
                              pq_bits=model.pq_bits), X, model=model,
        placement=placement)


def _ref_params(kind, engine, n_probes):
    mod = jivf if kind == "flat" else jpq
    return mod.SearchParams(n_probes=n_probes, engine=engine)


def _placement_arrays(index):
    pm = index.placement_map
    return (pm.owner, pm.slot, pm.replica_owner, pm.replica_slot,
            pm.n_slots)


def ref_steps(n_dev, kind, X, model, Q, k, steps, placement="list"):
    """The reference's build + steps, shaped like case_sharded_steps's
    output (``model``: the centers, or the reference's IVF-PQ model).
    Searches run the reference's allgather engine."""
    mesh = _mesh(n_dev)
    jpar.routing_stats.reset()
    jmerge_stats.reset()
    index = _ref_index(mesh, kind, X, model, placement)
    search = (jpar.sharded_ivf_flat_search if kind == "flat"
              else jpar.sharded_ivf_pq_search)
    extend = (jpar.sharded_ivf_flat_extend if kind == "flat"
              else jpar.sharded_ivf_pq_extend)
    outs = []
    for step in steps:
        op = step[0]
        if op == "search":
            _, engine, n_probes, _, live, chunks = step[:6]
            valid = step[6] if len(step) > 6 else None
            outs.append(tuple(np.asarray(o) for o in search(
                mesh, _ref_params(kind, engine, n_probes), index, Q, k,
                merge_engine="allgather", live_mask=live,
                pipeline_chunks=chunks, valid_rows=valid)))
        elif op == "suspect":
            plans = []
            out = search(mesh, _ref_params(kind, "auto", step[1]), index, Q,
                         k, merge_engine="allgather",
                         suspect_mask=np.asarray(step[2][0]),
                         plan_cb=plans.append)
            outs.append((tuple(np.asarray(o) for o in out), plans[0].q_rows,
                         plans[0].probe_slots, plans[0].suspect_avoided))
        elif op == "extend":
            extend(mesh, index, step[1], step[2])
            outs.append(index.indices.shape[2])
        elif op == "delete":
            outs.append(jlc.delete(index, step[1], mesh=mesh))
        elif op == "upsert":
            jlc.upsert(index, step[1], step[2], mesh=mesh)
            outs.append(index.indices.shape[2])
        elif op == "replicate":
            index = jpar.sharded_replicate_lists(mesh, index, step[1],
                                                 live_mask=step[2])
            outs.append(_placement_arrays(index))
        elif op == "migrate":
            index, moved = jpar.sharded_migrate_lists(mesh, index, step[1],
                                                      live_mask=step[2])
            outs.append(moved)
        elif op == "placement":
            outs.append(_placement_arrays(index))
        elif op == "reset":
            jpar.routing_stats.reset()
            jmerge_stats.reset()
            outs.append(None)
        elif op == "stats":
            outs.append((jpar.routing_stats.snapshot(),
                         jmerge_stats.snapshot(),
                         jpar.routing_stats.list_loads(
                             index.placement_map)))
        elif op == "compact":
            index, report = jlc.compact(
                index, jlc.CompactionPolicy(**step[1]), mesh=mesh,
                live_mask=step[2])
            outs.append(None if report is None
                        else dataclasses.astuple(report))
        elif op == "save":
            jpar.sharded_ivf_save(step[1], index)
            outs.append(jpar.verify_sharded_manifest(step[1]))
        elif op == "load":
            index = jpar.sharded_ivf_load(mesh, step[1])
            outs.append(None if index.placement_map is None
                        else _placement_arrays(index))
        else:
            outs.append(jpar.sharded_routed_warmup(
                mesh, _ref_params(kind, "auto", step[2]), index, step[1],
                k))
        outs.append((index.size, index.n_deleted, index.epoch))
    return outs


def _eq(a, b, what=""):
    if isinstance(b, dict):
        assert set(a) == set(b), (what, a, b)
        for key in b:
            _eq(a[key], b[key], f"{what}.{key}")
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b), (what, a, b)
        for j, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{what}[{j}]")
    elif isinstance(b, (np.ndarray, np.generic)) or hasattr(b, "shape"):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)
    elif isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-12), (what, a, b)
    else:
        assert a == b, (what, a, b)


def _eq_ties(a, b, what=""):
    """Search outputs equal up to exact distance ties: distances bit for
    bit, ids equal once each row is put in (distance, id) order, except
    inside the tie group at a row's k-th distance, where an engine that
    selects per probe chunk (the pipelined ones) may keep another member
    of the group."""
    d, i, rd, ri = (np.asarray(x) for x in (a[0], a[1], b[0], b[1]))
    np.testing.assert_array_equal(d, rd, err_msg=what)
    for row in range(d.shape[0]):
        o, ro = np.lexsort((i[row], d[row])), np.lexsort((ri[row], rd[row]))
        inner = d[row][o] < d[row].max()
        np.testing.assert_array_equal(i[row][o][inner], ri[row][ro][inner],
                                      err_msg=what)
    _eq(a[2:], b[2:], what)


def check_steps(port, ref, steps):
    """Step by step: a search on a pipelined engine up to exact ties
    (:func:`_eq_ties`), everything else exactly."""
    assert len(port) == len(ref) == 2 * len(steps)
    for j, step in enumerate(steps):
        p, r = port[2 * j], ref[2 * j]
        if step[0] == "search" and step[3].startswith("pipelined"):
            _eq_ties(p, r, f"step {j}")
        else:
            _eq(p, r, f"step {j}")
        _eq(port[2 * j + 1], ref[2 * j + 1], f"step {j} sizes")


def _agree(outs, n):
    """The n ranks' outputs are identical; returns rank 0's."""
    for o in outs[1:n]:
        _eq(o, outs[0], "rank")
    assert all(o is None for o in outs[n:])
    return outs[0]


def _run(world, n_dev, kind, X, model, jmodel, Q, k, steps, **kw):
    port = _agree(world.run(case_sharded_steps, n_dev, kind, X, model, Q, k,
                            steps, N_LISTS, kw.get("placement", "list")),
                  n_dev)
    ref = ref_steps(n_dev, kind, X, jmodel, Q, k, steps,
                    kw.get("placement", "list"))
    return port, ref


# ---------------------------------------------------------------------------
# Routed search


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
@pytest.mark.parametrize("tier", ["scan", "bucketed"])
def test_routed_flat_every_engine_equals_reference(world, rng, n_dev, tier):
    """Scan and cells tiers, every merge engine, the same placement."""
    X, centers, Q = _data(rng)
    steps = ([("placement",)]
             + [("search", tier, 3, e, None, 2) for e in ENGINES]
             + [("search", tier, N_LISTS, "pipelined", None, 3)])
    port, ref = _run(world, n_dev, "flat", X, centers, centers, Q, 9, steps)
    check_steps(port, ref, steps)


@pytest.mark.parametrize("tier", ["scan", "bucketed"])
def test_routed_flat_k_past_the_candidates(world, rng, tier):
    """k = 200 at one probe: wider than any rank's routed candidates, so
    the merged result pads back to k with (inf, -1)."""
    X, centers, Q = _data(rng)
    steps = [("search", tier, 1, e, None, 0) for e in ("allgather", "ring")]
    port, ref = _run(world, 4, "flat", X, centers, centers, Q, 200, steps)
    check_steps(port, ref, steps)
    assert (port[0][1] == -1).any()


@pytest.mark.parametrize("tier", ["scan", "bucketed"])
def test_routed_flat_mutations(world, rng, tier):
    """Routed extend (auto and explicit ids, capacity growth), tombstones,
    upsert and a zero-row extend: the same capacities, counts, epochs and
    answers."""
    X, centers, Q = _data(rng)
    new = int_data(rng, (37, 8))
    steps = [("extend", new, None),
             ("search", tier, 3, "ring", None, 0),
             ("delete", [3, 70, 260, 280, 999]),
             ("search", tier, 3, "allgather", None, 0),
             ("upsert", int_data(rng, (5, 8)),
              np.array([2, 7, 300, 301, 302])),
             ("extend", np.repeat(X[:1], 300, axis=0), None),
             ("extend", np.zeros((0, 8), np.float32), None),
             ("search", tier, 4, "pipelined", None, 2)]
    port, ref = _run(world, 4, "flat", X, centers, centers, Q, 9, steps)
    check_steps(port, ref, steps)


def test_routed_flat_degraded_replicas_and_migration(world, rng):
    """A dead rank is a routing decision (coverage prices its lists); a
    replica serves a dead primary; a migration round trip keeps the
    answers and the replicas; the successors' placements are the
    reference's."""
    X, centers, Q = _data(rng)
    dead1 = np.array([True, False, True, True])
    steps = [("search", "scan", 3, "allgather", dead1, 0),
             ("replicate", [0, 1, 5], None),
             ("search", "bucketed", 3, "ring", None, 0),
             ("search", "scan", 3, "allgather", dead1, 0),
             ("search", "scan", 3, "pipelined",
              np.array([True, True, False, True]), 2),
             ("delete", [1, 2, 40, 41, 200]),
             ("migrate", [3, 2, 1, 0, 3, 2, 1, 0], None),
             ("placement",),
             ("search", "scan", 3, "allgather", None, 0),
             ("search", "bucketed", 3, "allgather", dead1, 0),
             ("migrate", [1, 1, 1, 1, 1, 1, 1, 1],
              np.array([True, True, True, False]))]
    port, ref = _run(world, 4, "flat", X, centers, centers, Q, 9, steps)
    check_steps(port, ref, steps)
    assert (port[0][2] < 1).any()


def test_replica_serves_every_list_of_a_dead_rank(world, rng):
    """Every list of rank 1 replicated: with rank 1 dead the answers are
    the healthy ones and coverage is 1; no query reaches rank 1."""
    X, centers, Q = _data(rng)
    owner = ref_steps(4, "flat", X, centers, Q, 5, [("placement",)])[0][0]
    victim = 1
    dead = np.ones(4, bool)
    dead[victim] = False
    steps = [("search", "scan", 3, "allgather", None, 0),
             ("replicate", np.flatnonzero(owner == victim), None),
             ("reset",), ("search", "scan", 3, "allgather", dead, 0),
             ("stats",)]
    port, ref = _run(world, 4, "flat", X, centers, centers, Q, 5, steps)
    check_steps(port, ref, steps)
    healthy, degraded = port[0], port[6]
    _eq(degraded[:2], healthy)
    np.testing.assert_array_equal(degraded[2], 1.0)
    assert port[8][0]["shard_queries"].get(victim, 0) == 0


@pytest.mark.parametrize("masks", [
    [[False, True, False, False], [False, False, False, False],
     [True, True, True, False], [False, False, True, True]],
    [[False, False, False, False], [False, True, False, False],
     [False, True, False, False], [False, True, False, False]]])
def test_plan_follows_rank_0(world, rng, masks):
    """The ranks hold different suspect masks: every rank follows rank
    0's plan (the reference's plan under rank 0's mask) and returns the
    same answer."""
    X, centers, Q = _data(rng)
    steps = [("replicate", list(range(N_LISTS)), None),
             ("suspect", 3, masks)]
    outs = world.run(case_sharded_steps, 4, "flat", X, centers, Q, 7, steps)
    _agree(outs, 4)
    ref = ref_steps(4, "flat", X, centers, Q, 7, steps)
    _eq(outs[0], ref)
    if any(masks[0]):
        assert outs[0][2][3] > 0       # rank 0's mask steered lists


def test_participants_accounting_and_telemetry(world, rng):
    """The routed merge records its participating ranks
    (``merge_comm_bytes(participants=)``), and the routing telemetry,
    ``valid_rows`` padding and the per-list loads are the reference's."""
    X, centers, Q = _data(rng)
    steps = [("reset",),
             ("search", "scan", 2, "allgather", None, 0),
             ("search", "scan", 3, "allgather", None, 0, 11),
             ("stats",),
             ("warmup", 16, 3)]
    port, ref = _run(world, 4, "flat", X, centers, centers, Q, 6, steps)
    check_steps(port, ref, steps)
    assert (port[4][1][11:] == -1).all()
    snap, merge, loads = port[6]
    assert snap["queries"] == Q.shape[0] + 11
    assert loads.sum() == Q.shape[0] * 2 + 11 * 3
    # Fewer participants than ranks cost less than the full mesh.
    from raft_tpu_torch.comms.topk_merge import merge_comm_bytes

    full = merge_comm_bytes("allgather", 64, 10, 10, 8)
    assert merge_comm_bytes("allgather", 64, 10, 10, 8,
                            participants=1) == 0
    assert merge_comm_bytes("allgather", 64, 10, 10, 8,
                            participants=4) < full
    assert merge_comm_bytes("allgather", 64, 10, 10, 8,
                            participants=8) == full


def test_list_and_row_placements_agree(world, rng):
    """The row placement and the list placement of one build give the
    same answers (the reference's bit-identity of the placements)."""
    X, centers, Q = _data(rng)
    steps = [("search", "scan", 3, "allgather", None, 0),
             ("search", "bucketed", 3, "ring", None, 0)]
    row = world.run(case_sharded_steps, 4, "flat", X, centers, Q, 9, steps,
                    N_LISTS, "row")[0]
    lst = world.run(case_sharded_steps, 4, "flat", X, centers, Q, 9,
                    steps)[0]
    _eq(lst[0], row[0])
    _eq(lst[2], row[2])


# ---------------------------------------------------------------------------
# The routed sharded Searcher over IVF-Flat


def ref_routed_searcher(kind, X, model, Q, k, dead, suspect, steps,
                        n_probes=3, placement="list"):
    mesh = _mesh(4)
    health = JShardHealth(4)
    for r in dead:
        health.mark_dead(r)
    for r in suspect:
        health.mark_suspect(r)
    seen = []
    index = _ref_index(mesh, kind, X, model, placement)
    make = JSearcher.ivf_flat if kind == "flat" else JSearcher.ivf_pq
    s = make(index, _ref_params(kind, "auto", n_probes), mesh=mesh,
             health=health, dispatch_hook=lambda r: seen.append(list(r)))
    outs = []
    for step in steps:
        if step[0] == "search":
            res = s.search(Q, k, degraded=step[1])
            outs.append((res.distances, res.indices, res.coverage,
                         res.degraded))
        elif step[0] == "extend":
            s.extend(step[1])
        elif step[0] == "delete":
            outs.append(s.delete(step[1]))
        elif step[0] == "warmup":
            rep = jwarmup(s, JBucketGrid.pow2(step[1], k_grid=(k,)))
            outs.append([rep["shapes"], rep["routed_shapes"]])
        elif step[0] == "replicate":
            s._index = jpar.sharded_replicate_lists(mesh, s._index, step[1])
        else:
            s.upsert(step[1], step[2])
        outs.append(s.epoch)
    lat = [bool(np.isfinite(health.latency_ewma(r))) for r in range(4)]
    return outs, seen, lat


def check_searchers(world, kind, X, model, jmodel, Q, k, dead, suspect,
                    steps, placement="list"):
    outs = world.run(case_routed_searcher, 4, kind, X, model, Q, k, dead,
                     suspect, steps, 3, placement)
    for o in outs[1:]:
        _eq(o[0], outs[0][0])
        _eq(o[1], outs[0][1])
    ref = ref_routed_searcher(kind, X, jmodel, Q, k, dead, suspect, steps,
                              placement=placement)
    port = outs[0]
    _eq(port[0], ref[0])
    _eq(port[1], ref[1])           # the dispatch hook's participants
    # Rank 0's registry observed every participant's latency.
    _eq(port[2], ref[2])
    return port


@pytest.mark.parametrize("dead,suspect", [((), ()), ((2,), (1,))])
def test_routed_flat_searcher(world, rng, dead, suspect):
    X, centers, Q = _data(rng)
    steps = [("warmup", 8), ("search", None), ("replicate", [0, 3, 6]),
             ("search", None), ("extend", int_data(rng, (20, 8))),
             ("delete", [1, 2, 3, 200, 270]), ("search", None),
             ("upsert", int_data(rng, (3, 8)), np.array([2, 7, 400])),
             ("search", True)]
    port = check_searchers(world, "flat", X, centers, centers, Q, 6, dead,
                           suspect, steps)
    assert port[1] and all(len(r) >= 1 for r in port[1])
