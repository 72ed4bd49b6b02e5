"""Parity of raft_tpu_torch's merge engines with raft_tpu's.

The reference merges on ``tests/conftest.py``'s 8-device CPU mesh
(``shard_map``); the port merges in a gloo world of 4 CPU ranks (one world
for the file, ``test_torch_world.World``), on its sub-worlds of 1-4 ranks:
the same seeded numpy candidates, row r on rank r. Every engine of the
port must return the reference's ``allgather`` result bit for bit, ids and
distances (the cases of ``tests/test_topk_merge.py``, ties, k past the
total and int64 ids included); the pipelined engines are held to
``allgather`` as well, not to the reference's pipelined output (ROADMAP
C.4). The dispatch rules and the byte estimator are compared over a grid.
"""

import importlib

import numpy as np
import pytest

from test_topk_merge import _merge_on_mesh, _mesh
from test_torch_world import (World, case_topk_merge,
                              case_topk_merge_pipelined)

# The packages' comms/__init__ export the function topk_merge, which
# shadows the module of the same name.
jtm = importlib.import_module("raft_tpu.comms.topk_merge")
tm = importlib.import_module("raft_tpu_torch.comms.topk_merge")

ENGINES = ("allgather", "ring", "ring_bf16", "auto", "pipelined",
           "pipelined_bf16")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("merge_world"))
    yield w
    w.close()


def _candidates(rng, n_dev, q, kk, ints=False):
    if ints:
        dist = rng.integers(0, 3, size=(n_dev, q, kk)).astype(np.float32)
    else:
        dist = rng.normal(size=(n_dev, q, kk)).astype(np.float32)
    idx = rng.permutation(n_dev * q * kk).astype(np.int32) \
        .reshape(n_dev, q, kk)
    return dist, idx


def _port(world, n_dev, dist, idx, k, select_min, engines=ENGINES):
    """Every rank's {engine: (d, i)}; the ranks must agree."""
    outs = world.run(case_topk_merge, n_dev, dist, idx, k, select_min,
                     engines)[:n_dev]
    for r in range(1, n_dev):
        for e in engines:
            np.testing.assert_array_equal(outs[r][e][0], outs[0][e][0])
            np.testing.assert_array_equal(outs[r][e][1], outs[0][e][1])
    return outs[0]


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
@pytest.mark.parametrize("q,kk,k", [(4, 6, 5), (3, 2, 10), (1, 8, 8),
                                    (7, 3, 64)])
@pytest.mark.parametrize("select_min", [True, False])
def test_every_engine_matches_the_reference_allgather(world, rng, n_dev, q,
                                                      kk, k, select_min):
    dist, idx = _candidates(rng, n_dev, q, kk)
    base_d, base_i = _merge_on_mesh(_mesh(n_dev), dist, idx, k, select_min,
                                    "allgather")
    port = _port(world, n_dev, dist, idx, k, select_min)
    for e in ENGINES:
        np.testing.assert_array_equal(port[e][0], base_d, err_msg=e)
        np.testing.assert_array_equal(port[e][1], base_i, err_msg=e)


@pytest.mark.parametrize("n_dev", [2, 3, 4])
def test_ties_resolve_to_the_lowest_id(world, rng, n_dev):
    dist, idx = _candidates(rng, n_dev, 5, 4, ints=True)
    base = _merge_on_mesh(_mesh(n_dev), dist, idx, 9, True, "allgather")
    port = _port(world, n_dev, dist, idx, 9, True)
    for e in ENGINES:
        np.testing.assert_array_equal(port[e][0], base[0], err_msg=e)
        np.testing.assert_array_equal(port[e][1], base[1], err_msg=e)


def test_k_larger_than_total(world, rng):
    dist, idx = _candidates(rng, 4, 3, 2)
    base = _merge_on_mesh(_mesh(4), dist, idx, 50, True, "allgather")
    port = _port(world, 4, dist, idx, 50, True)
    for e in ENGINES:
        assert port[e][0].shape == (3, 8), e
        np.testing.assert_array_equal(port[e][1], base[1], err_msg=e)


@pytest.mark.parametrize("select_min", [True, False])
def test_ring_bf16_reranks_to_exact_distances(world, rng, select_min):
    """bf16 on the wire, exact f32 distances out: equal to the reference's
    ring_bf16 and, on these inputs, to allgather."""
    dist = (rng.normal(size=(4, 16, 32)) ** 2).astype(np.float32)
    idx = rng.permutation(4 * 16 * 32).astype(np.int32).reshape(4, 16, 32)
    mesh = _mesh(4)
    ref_bf = _merge_on_mesh(mesh, dist, idx, 10, select_min, "ring_bf16")
    base = _merge_on_mesh(mesh, dist, idx, 10, select_min, "allgather")
    port = _port(world, 4, dist, idx, 10, select_min,
                 ("ring_bf16", "pipelined_bf16"))
    for e in ("ring_bf16", "pipelined_bf16"):
        np.testing.assert_array_equal(port[e][0], ref_bf[0], err_msg=e)
        np.testing.assert_array_equal(port[e][1], ref_bf[1], err_msg=e)
        np.testing.assert_array_equal(port[e][0], base[0], err_msg=e)


def test_int64_ids_past_2_to_the_31(world, rng):
    """int64 ids keep their order: the port's ids past 2^33 equal the
    reference's int32 ids plus the offset (the reference runs x64 off)."""
    dist, idx = _candidates(rng, 4, 3, 4)
    base = _merge_on_mesh(_mesh(4), dist, idx, 6, True, "allgather")
    big = idx.astype(np.int64) + (1 << 33)
    port = _port(world, 4, dist, big, 6, True)
    for e in ENGINES:
        assert port[e][1].dtype == np.int64, e
        np.testing.assert_array_equal(port[e][1],
                                      base[1].astype(np.int64) + (1 << 33),
                                      err_msg=e)
        np.testing.assert_array_equal(port[e][0], base[0], err_msg=e)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
@pytest.mark.parametrize("q,kk,k,n_chunks", [(4, 6, 5, 2), (3, 7, 10, 3),
                                             (5, 4, 16, 4), (2, 9, 3, 5)])
@pytest.mark.parametrize("select_min", [True, False])
def test_pipelined_matches_the_reference_allgather(world, rng, n_dev, q, kk,
                                                   k, n_chunks, select_min):
    dist, idx = _candidates(rng, n_dev, q, kk)
    base = _merge_on_mesh(_mesh(n_dev), dist, idx, k, select_min,
                          "allgather")
    outs = world.run(case_topk_merge_pipelined, n_dev, dist, idx, k,
                     select_min, n_chunks, False)[:n_dev]
    for d, i in outs:
        np.testing.assert_array_equal(d, base[0])
        np.testing.assert_array_equal(i, base[1])


@pytest.mark.parametrize("n_dev", [2, 4])
def test_pipelined_ties_bit_identical(world, rng, n_dev):
    dist, idx = _candidates(rng, n_dev, 5, 8, ints=True)
    base = _merge_on_mesh(_mesh(n_dev), dist, idx, 9, True, "allgather")
    for n_chunks in (2, 3):
        for quantized in (False, True):
            d, i = world.run(case_topk_merge_pipelined, n_dev, dist, idx, 9,
                             True, n_chunks, quantized)[0]
            np.testing.assert_array_equal(d, base[0])
            np.testing.assert_array_equal(i, base[1])


def test_pipelined_bf16_chunks_rerank_exact(world, rng):
    dist = (rng.normal(size=(4, 16, 32)) ** 2).astype(np.float32)
    idx = rng.permutation(4 * 16 * 32).astype(np.int32).reshape(4, 16, 32)
    base = _merge_on_mesh(_mesh(4), dist, idx, 10, True, "allgather")
    d, i = world.run(case_topk_merge_pipelined, 4, dist, idx, 10, True, 4,
                     True)[0]
    np.testing.assert_array_equal(d, base[0])
    np.testing.assert_array_equal(i, base[1])


_GRID = [(q, k, n, p) for q in (1, 7, 300, 5000) for k in (1, 10, 64)
         for n in (1, 2, 3, 4, 6, 8) for p in (None, 4, 16, 64)]


def test_resolve_merge_engine_matches_the_reference():
    for engine in tm.MERGE_ENGINES:
        for q, k, n, p in _GRID:
            assert tm.resolve_merge_engine(engine, q, k, n, n_probes=p) == \
                jtm.resolve_merge_engine(engine, q, k, n, n_probes=p)
    with pytest.raises(ValueError, match="unknown merge engine"):
        tm.resolve_merge_engine("tree", 1, 1, 2)
    assert tm.MERGE_ENGINES == jtm.MERGE_ENGINES
    assert tm.PIPELINED_ENGINES == jtm.PIPELINED_ENGINES


def test_chunk_rules_match_the_reference():
    for engine in tm.MERGE_ENGINES:
        for items in (None, 1, 2, 7, 16, 33, 250000):
            for n in (1, 2, 4):
                for req in (0, 1, 3, 100):
                    assert tm.resolve_pipeline_chunks(engine, items, n, req) \
                        == jtm.resolve_pipeline_chunks(engine, items, n, req)
    for items in (1, 2, 7, 32, 250000):
        for c in (1, 2, 3, 4, 9):
            assert tm.pipeline_chunk_bounds(items, c) == \
                jtm.pipeline_chunk_bounds(items, c)


def test_merge_comm_bytes_matches_the_reference():
    for engine in tm.MERGE_ENGINES:
        for q, k, n, _ in _GRID:
            for kk in (1, 5, k):
                for idx_bytes in (4, 8):
                    for extra in ({}, {"chunk_kks": (kk, kk, 1)},
                                  {"participants": 1},
                                  {"participants": 3},
                                  {"participants": 2,
                                   "chunk_kks": (kk, 1)}):
                        assert tm.merge_comm_bytes(
                            engine, q, k, kk, n, idx_bytes, **extra) == \
                            jtm.merge_comm_bytes(engine, q, k, kk, n,
                                                 idx_bytes, **extra)


def test_merge_dispatch_stats_match_the_reference():
    ours, theirs = tm.MergeDispatchStats(), jtm.MergeDispatchStats()
    calls = [("ring", 100, 10, 10, 4), ("allgather", 5, 3, 3, 2),
             ("pipelined", 300, 10, 10, 4), ("ring", 7, 64, 8, 3)]
    for stats in (ours, theirs):
        for c in calls:
            stats.record(*c)
        stats.record("pipelined", 300, 10, 10, 4, chunk_kks=(10, 10, 5))
        stats.record("allgather", 64, 10, 10, 4, participants=2)
        with stats.suppress():
            stats.record("ring", 1, 1, 1, 4)
    assert ours.snapshot() == theirs.snapshot()
    ours.reset()
    assert ours.snapshot() == {}
