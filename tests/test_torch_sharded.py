"""Parity of raft_tpu_torch.parallel (sharded brute force, k-means and
row-placed IVF-Flat) and the sharded Searcher with raft_tpu's.

The reference runs on ``tests/conftest.py``'s 8-device CPU mesh
(``shard_map``); the port runs in a gloo world of 4 CPU ranks (one world
for the file, ``test_torch_world.World``), on its sub-worlds of 1-4 ranks,
each rank working on its own shard and returning the replicated result.
The same seeded numpy inputs go to both.

Tolerances: on integer-valued data every distance is exact in f32, so ids
and distances must agree bit for bit; k-means from well-separated
centroids (ROADMAP C.3's trap) must give equal labels and centroids
within 1e-5 relative. The pipelined engines are held to the reference's
``allgather`` result (ROADMAP C.4).
"""

import numpy as np
import pytest

import raft_tpu.lifecycle as jlc
import raft_tpu.parallel as jpar
from raft_tpu.comms import ShardHealth as JShardHealth
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.serve import Searcher as JSearcher
from test_topk_merge import _mesh
from test_torch_common import blobs, int_data
from test_torch_world import (World, case_finite_everywhere,
                              case_ivf_flat, case_ivf_train_distributed,
                              case_ivf_trained_on_rank0, case_kmeans,
                              case_refusals, case_searcher,
                              case_sharded_knn)

ENGINES = ["allgather", "ring", "ring_bf16", "pipelined", "pipelined_bf16"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("sharded_world"))
    yield w
    w.close()


def _agree(outs, n):
    """The n ranks' outputs are identical; returns rank 0's."""
    first = outs[0]
    for o in outs[1:n]:
        for a, b in zip(first, o):
            np.testing.assert_array_equal(a, b)
    assert all(o is None for o in outs[n:])
    return first


def _eq(port, ref):
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# sharded_knn


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_knn_every_engine_equals_reference_allgather(world, rng,
                                                             n_dev, engine):
    db = int_data(rng, (240, 12))
    q = int_data(rng, (21, 12))
    ref = jpar.sharded_knn(_mesh(n_dev), db, q, 7, merge_engine="allgather")
    port = _agree(world.run(case_sharded_knn, n_dev, db, q, 7, engine,
                            None, 3), n_dev)
    _eq(port, ref)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("live", [[True, False, True, True],
                                  [False, True, True, False]])
def test_sharded_knn_degraded_equals_reference(world, rng, engine, live):
    db = int_data(rng, (240, 12))
    q = int_data(rng, (21, 12))
    live = np.array(live)
    ref = jpar.sharded_knn(_mesh(4), db, q, 7, merge_engine="allgather",
                           live_mask=live)
    port = _agree(world.run(case_sharded_knn, 4, db, q, 7, engine, live, 2),
                  4)
    assert len(port) == 3
    _eq(port, ref)
    np.testing.assert_array_equal(port[2], np.full(21, live.mean(),
                                                   np.float32))


def test_sharded_knn_k_past_the_survivors_pads(world, rng):
    """k = 150 over 2 live shards of 60 rows: 120 real slots, then
    (inf, -1), as the reference pads."""
    db = int_data(rng, (240, 6))
    q = int_data(rng, (5, 6))
    live = np.array([True, False, False, True])
    ref = jpar.sharded_knn(_mesh(4), db, q, 150, merge_engine="allgather",
                           live_mask=live)
    for engine in ("allgather", "ring", "pipelined"):
        port = _agree(world.run(case_sharded_knn, 4, db, q, 150, engine,
                                live), 4)
        _eq(port, ref)
        assert (port[1][:, 120:] == -1).all()


def test_sharded_knn_sqrt_and_gaussian(world, rng):
    """sqrt distances; on Gaussian data the engines agree with the port's
    own allgather bit for bit and with the reference's within tolerance."""
    db = int_data(rng, (240, 12))
    q = int_data(rng, (9, 12))
    ref = jpar.sharded_knn(_mesh(4), db, q, 5, sqrt=True,
                           merge_engine="allgather")
    port = _agree(world.run(case_sharded_knn, 4, db, q, 5, "ring", None, 0,
                            True), 4)
    np.testing.assert_array_equal(port[1], np.asarray(ref[1]))
    np.testing.assert_allclose(port[0], np.asarray(ref[0]), rtol=1e-6)
    g = rng.standard_normal((1024, 16)).astype(np.float32)
    gq = rng.standard_normal((32, 16)).astype(np.float32)
    base = world.run(case_sharded_knn, 4, g, gq, 10, "allgather", None)[0]
    ref = jpar.sharded_knn(_mesh(4), g, gq, 10, merge_engine="allgather")
    np.testing.assert_array_equal(base[1], np.asarray(ref[1]))
    np.testing.assert_allclose(base[0], np.asarray(ref[0]), rtol=1e-5,
                               atol=1e-4)
    for engine in ("pipelined", "pipelined_bf16", "ring_bf16"):
        out = world.run(case_sharded_knn, 4, g, gq, 10, engine, None, 3)[0]
        _eq(out, base)


def test_sharded_knn_rejects_non_finite_on_every_rank(world, rng):
    X = int_data(rng, (40, 4))
    X[35, 2] = np.nan          # on rank 3's shard only
    msgs = world.run(case_finite_everywhere, 4, X)
    assert all(m is not None and "finite" in m for m in msgs)


# ---------------------------------------------------------------------------
# k-means


def _separated(rng, n_rows=400, dim=8, k=8):
    """k blobs in contiguous row blocks, far apart: strided rows start one
    centroid in each blob."""
    centers = rng.uniform(-50, 50, (k, dim)).astype(np.float32)
    X = np.repeat(centers, n_rows // k, axis=0)
    return X + rng.standard_normal(X.shape).astype(np.float32), centers


def _labels(X, c):
    return ((X[:, None, :] - np.asarray(c)[None]) ** 2).sum(-1).argmin(1)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_kmeans_step_and_fit(world, rng, n_dev):
    X, centers = _separated(rng)
    c0 = centers + 3.0
    ref_c, ref_in = jpar.sharded_kmeans_step(_mesh(n_dev), X, c0)
    c, inertia = _agree(world.run(case_kmeans, n_dev, "step", X, c0, 0),
                        n_dev)
    np.testing.assert_allclose(c, np.asarray(ref_c), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(inertia, float(ref_in), rtol=1e-5)
    ref_c, ref_in = jpar.sharded_kmeans_fit(_mesh(n_dev), X, c0, n_iters=5)
    c, inertia = _agree(world.run(case_kmeans, n_dev, "fit", X, c0, 5),
                        n_dev)
    np.testing.assert_allclose(c, np.asarray(ref_c), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(inertia, float(ref_in), rtol=1e-5)
    np.testing.assert_array_equal(_labels(X, c), _labels(X, ref_c))


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_sharded_kmeans_balanced_fit(world, rng, n_dev):
    X, _ = _separated(rng, n_rows=480)
    ref = jpar.sharded_kmeans_balanced_fit(_mesh(n_dev), X, 8, n_iters=6)
    c = world.run(case_kmeans, n_dev, "balanced", X, 8, 6)[:n_dev]
    for other in c[1:]:
        np.testing.assert_array_equal(other, c[0])
    np.testing.assert_allclose(c[0], np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_labels(X, c[0]), _labels(X, ref))


def test_sharded_kmeans_balanced_fit_reseeds_as_the_reference(world, rng):
    """16 clusters over 8 blobs of unequal size: the small clusters are
    re-seeded from the global top-cost rows each iteration (the merge
    engine picks them across the ranks)."""
    X, _ = _separated(rng, n_rows=512, dim=4, k=8)
    X = X * np.linspace(1.0, 3.0, 512, dtype=np.float32)[:, None]
    ref = jpar.sharded_kmeans_balanced_fit(_mesh(4), X, 16, n_iters=4)
    c = world.run(case_kmeans, 4, "balanced", X, 16, 4)[0]
    np.testing.assert_allclose(c, np.asarray(ref), rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# Row-placed IVF-Flat


def _flat_ref(n_dev, X, centers, Q, k, steps, n_lists=16):
    """The reference's sharded build + steps, shaped like case_ivf_flat's
    output."""
    mesh = _mesh(n_dev)
    index = jpar.sharded_ivf_flat_build(
        mesh, jivf.IndexParams(n_lists=n_lists), X, centers=centers)
    outs = []
    for step in steps:
        if step[0] == "search":
            _, engine, n_probes, merge_engine, live, chunks = step
            out = jpar.sharded_ivf_flat_search(
                mesh, jivf.SearchParams(n_probes=n_probes, engine=engine),
                index, Q, k, merge_engine=merge_engine, live_mask=live,
                pipeline_chunks=chunks)
            outs.append(tuple(np.asarray(o) for o in out))
        elif step[0] == "extend":
            jpar.sharded_ivf_flat_extend(mesh, index, step[1], step[2])
            outs.append(index.indices.shape[2])
        else:
            outs.append(jlc.delete(index, step[1], mesh=mesh))
        outs.append((index.size, index.n_deleted, index.epoch))
    return outs


def _same_steps(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        if isinstance(r, tuple) and r and isinstance(r[0], np.ndarray):
            _eq(p, r)
        else:
            assert p == r, (p, r)


@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("tier", ["scan", "bucketed"])
def test_sharded_ivf_flat_build_search_extend_delete(world, rng, n_dev,
                                                     tier):
    """Build, search on every engine, extend (auto ids, capacity growth),
    tombstone, search again with and without a dead shard: ids and
    distances bit for bit, and the same sizes, tombstone counts and
    epochs."""
    X = int_data(rng, (256, 8))
    centers = X[::16][:16]
    Q = int_data(rng, (18, 8))
    new = int_data(rng, (64, 8))
    live = np.ones(n_dev, bool)
    live[n_dev // 2] = n_dev == 1
    steps = ([("search", tier, 5, e, None, 2) for e in ENGINES]
             + [("extend", new, None), ("delete", [3, 70, 260, 300, 999]),
                ("search", tier, 5, "allgather", None, 0),
                ("search", tier, 16, "pipelined", None, 3),
                ("search", tier, 5, "ring", live, 0)])
    ref_steps = [s if s[0] != "search" else s[:3] + ("allgather",) + s[4:]
                 for s in steps]
    ref = _flat_ref(n_dev, X, centers, Q, 9, ref_steps)
    port = world.run(case_ivf_flat, n_dev, X, centers, Q, 9, steps)[:n_dev]
    for other in port[1:]:
        _same_steps(other, port[0])
    _same_steps(port[0], ref)


def test_sharded_ivf_flat_explicit_ids_and_int64(world, rng):
    import torch

    X = int_data(rng, (128, 6))
    centers = X[::8][:16]
    Q = int_data(rng, (10, 6))
    new = int_data(rng, (8, 6))
    steps = [("extend", new, np.arange(5000, 5008)),
             ("search", "scan", 6, "ring", None, 0),
             ("delete", [5001, 7]),
             ("search", "scan", 6, "pipelined_bf16", None, 2)]
    ref = _flat_ref(4, X, centers, Q, 6, [
        s if s[0] != "search" else s[:3] + ("allgather",) + s[4:]
        for s in steps])
    port = world.run(case_ivf_flat, 4, X, centers, Q, 6, steps, 16,
                     torch.int64)[0]
    assert port[2][1].dtype == np.int64
    for p, r in zip(port, ref):
        if isinstance(r, tuple) and r and isinstance(r[0], np.ndarray):
            np.testing.assert_array_equal(p[0], r[0])
            np.testing.assert_array_equal(p[1], r[1].astype(np.int64))
        else:
            assert p == r


def test_sharded_ivf_flat_train_distributed(world, rng):
    X = blobs(rng, 1024, 8, 8)
    Q = X[:40] + rng.standard_normal((40, 8)).astype(np.float32) * 0.1
    ref_index = jpar.sharded_ivf_flat_build(
        _mesh(4), jivf.IndexParams(n_lists=8, kmeans_n_iters=5), X,
        train_distributed=True)
    ref = jpar.sharded_ivf_flat_search(
        _mesh(4), jivf.SearchParams(n_probes=3), ref_index, Q, 10)
    outs = world.run(case_ivf_train_distributed, 4, X, Q, 10, 8, 3, 5)
    c, d, i = _agree(outs, 4)
    np.testing.assert_allclose(c, np.asarray(ref_index.centers), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(i, np.asarray(ref[1]))
    np.testing.assert_allclose(d, np.asarray(ref[0]), rtol=1e-5, atol=1e-3)


def test_sharded_ivf_flat_trains_on_rank_0(world, rng):
    """Without centers or train_distributed, rank 0 trains as
    ``ivf_flat.build`` does (the port's own trainer: the packages'
    hierarchical k-means draw from different random streams) and every
    rank gets its centers."""
    X = blobs(rng, 512, 8, 16)
    outs = world.run(case_ivf_trained_on_rank0, 4, X, 16, 5)
    for c, single in outs:
        np.testing.assert_array_equal(c, outs[0][1])


# ---------------------------------------------------------------------------
# The sharded Searcher and the slice as a whole


def _ref_searcher(kind, X, centers, Q, k, dead, steps, n_probes=4):
    from raft_tpu.serve import BucketGrid, warmup

    mesh = _mesh(4)
    health = JShardHealth(4)
    for r in dead:
        health.mark_dead(r)
    if kind == "brute_force":
        s = JSearcher.brute_force(X, mesh=mesh, health=health)
    else:
        index = jpar.sharded_ivf_flat_build(
            mesh, jivf.IndexParams(n_lists=16), X, centers=centers)
        s = JSearcher.ivf_flat(index, jivf.SearchParams(n_probes=n_probes),
                               mesh=mesh, health=health)
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
            rep = warmup(s, BucketGrid.pow2(step[1], k_grid=(k,)),
                         include_degraded=True)
            outs.append([rep["shapes"], rep["degraded"]])
        else:
            s.upsert(step[1], step[2])
        outs.append(s.epoch)
    return outs


def _same_serves(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        if isinstance(r, tuple):
            np.testing.assert_array_equal(p[0], r[0])
            np.testing.assert_array_equal(p[1], r[1])
            np.testing.assert_allclose(p[2], r[2], rtol=1e-6)
            assert p[3] == r[3]
        else:
            assert p == r


@pytest.mark.parametrize("kind", ["brute_force", "ivf_flat"])
@pytest.mark.parametrize("dead", [(), (2,)])
def test_sharded_searcher_healthy_and_degraded(world, rng, kind, dead):
    X = int_data(rng, (256, 8))
    centers = X[::16][:16]
    Q = int_data(rng, (12, 8))
    steps = [("search", None), ("search", True), ("search", False)]
    ref = _ref_searcher(kind, X, centers, Q, 8, dead, steps)
    outs = world.run(case_searcher, 4, kind, X, centers, Q, 8, dead, steps)
    for o in outs[1:]:
        _same_serves(o, outs[0])
    _same_serves(outs[0], ref)


def test_sharded_searcher_mutations(world, rng):
    """Sharded Searcher warmup (with the degraded searches), delete and
    upsert against the reference's, served degraded: epochs, counts and
    results."""
    X = int_data(rng, (256, 8))
    centers = X[::16][:16]
    Q = int_data(rng, (12, 8))
    steps = [("warmup", 8), ("delete", [1, 2, 3, 200]), ("search", None),
             ("upsert", int_data(rng, (4, 8)), np.array([2, 7, 300, 301])),
             ("search", None), ("delete", [1000]), ("search", True)]
    ref = _ref_searcher("ivf_flat", X, centers, Q, 8, (1,), steps)
    port = world.run(case_searcher, 4, "ivf_flat", X, centers, Q, 8, (1,),
                     steps)[0]
    _same_serves(port, ref)


def test_slice_as_a_whole(world, rng):
    """Sharded build, then extend, then a degraded Searcher search (one
    shard dead), brute force and IVF-Flat: ids equal the reference's."""
    X = int_data(rng, (256, 8))
    centers = X[::16][:16]
    Q = int_data(rng, (16, 8))
    steps = [("extend", int_data(rng, (64, 8))), ("search", None),
             ("search", False)]
    for kind in ("ivf_flat", "brute_force"):
        ref = _ref_searcher(kind, X, centers, Q, 10, (3,), steps,
                            n_probes=6)
        port = world.run(case_searcher, 4, kind, X, centers, Q, 10, (3,),
                         steps, 6)[0]
        _same_serves(port, ref)
        assert port[1][3] and not port[3][3]
        assert (port[1][2] < 1).all() and (port[3][2] == 1).all()


def test_what_waits_for_a_4b_raises(world, tmp_path):
    """What was left of A.4b after its data plane (ROADMAP A.4c) waits no
    more: each of its arms runs on a 2-rank mesh and raises nothing."""
    msgs = world.run(case_refusals, 2, str(tmp_path / "index"))[0]
    assert msgs == [None] * 10, msgs
