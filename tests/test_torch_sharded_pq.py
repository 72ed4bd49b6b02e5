"""Parity of raft_tpu_torch.parallel's sharded IVF-PQ (``ShardedIvfPq`` on
the row and the list placement, both search tiers, degraded search,
extend, delete / upsert with the primary-copy count) and of the sharded
``Searcher`` over it with raft_tpu's.

The reference runs on ``tests/conftest.py``'s 8-device CPU mesh, the port
in one gloo world of 4 CPU ranks (``test_torch_world.World``). Both build
on the same trained model: integer centers and codebooks with the
identity rotation, so encoding, every LUT entry, codeword, bf16 product
and sum is exact. Tiers are selected as the reference selects them on
the CPU: ``engine="bucketed"`` = the compressed tier (B4's plain version
here, the reference's Pallas kernel in interpret mode), ``engine="scan"``
= the LUT scan.

Tolerance: ``tests/test_torch_ivf_pq.py``'s bar for these tiers on such
a model: ids and distances bit for bit (L2SqrtExpanded distances to
1e-6 relative, the sqrt's rounding). The pipelined engines are held to
the reference's ``allgather`` result up to exact ties (ROADMAP C.4).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from raft_tpu.distance.distance_types import DistanceType as JDistance
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch.neighbors import ivf_pq
from test_torch_common import int_data
from test_torch_routed import (N_LISTS, _agree, _eq, check_searchers,
                               check_steps, ref_steps)
from test_torch_world import World, case_sharded_steps

DIM, PQ_DIM = 16, 8


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("sharded_pq_world"))
    yield w
    w.close()


def _model(rng, metric="L2Expanded", bits=8):
    """An untrained-free model: the port's ``index_from_numpy`` arguments
    and the reference's ``Index``, both empty."""
    nbytes = ivf_pq.packed_row_bytes(PQ_DIM, bits)
    a = dict(centers=int_data(rng, (N_LISTS, DIM), hi=4),
             rotation_matrix=np.eye(DIM, dtype=np.float32),
             pq_centers=rng.integers(-2, 3, (PQ_DIM, 1 << bits,
                                             DIM // PQ_DIM)
                                     ).astype(np.float32),
             pq_codes=np.zeros((N_LISTS, 1, nbytes), np.uint8),
             indices=np.full((N_LISTS, 1), -1, np.int32),
             list_sizes=np.zeros((N_LISTS,), np.int32),
             pq_bits=bits, pq_dim=PQ_DIM)
    j = jpq.Index(metric=JDistance[metric],
                  codebook_kind=jpq.CodebookGen.PER_SUBSPACE,
                  **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                     for k, v in a.items()})
    return dict(a, codebook_kind=0, metric=JDistance[metric].value), j


def _data(rng, n_rows=256, n_q=16):
    return int_data(rng, (n_rows, DIM), hi=4), int_data(rng, (n_q, DIM),
                                                        hi=4)


def _run(world, n_dev, X, model, jmodel, Q, k, steps, placement):
    port = _agree(world.run(case_sharded_steps, n_dev, "pq", X, model, Q, k,
                            steps, N_LISTS, placement), n_dev)
    ref = ref_steps(n_dev, "pq", X, jmodel, Q, k, steps, placement)
    check_steps(port, ref, steps)
    return port


@pytest.mark.parametrize("placement", ["row", "list"])
@pytest.mark.parametrize("tier", ["bucketed", "scan"])
def test_sharded_pq_equals_reference(world, rng, placement, tier):
    """Both tiers on both placements, through three merge engines, with
    and without a dead rank (row: neutralized; list: routed around)."""
    model, jmodel = _model(rng)
    X, Q = _data(rng)
    live = np.array([True, True, False, True])
    steps = [("search", tier, 3, e, None, 2)
             for e in ("allgather", "ring", "pipelined")]
    steps += [("search", tier, 3, "allgather", live, 0),
              ("search", tier, N_LISTS, "ring", None, 0)]
    port = _run(world, 4, X, model, jmodel, Q, 10, steps, placement)
    assert (port[6][2] < 1).any()


@pytest.mark.parametrize("metric", ["InnerProduct", "L2SqrtExpanded"])
@pytest.mark.parametrize("tier", ["bucketed", "scan"])
def test_sharded_pq_metrics_on_two_ranks(world, rng, metric, tier):
    model, jmodel = _model(rng, metric)
    X, Q = _data(rng)
    steps = [("search", tier, 3, "allgather", None, 0)]
    for placement in ("row", "list"):
        port = _agree(world.run(case_sharded_steps, 2, "pq", X, model, Q, 7,
                                steps, N_LISTS, placement), 2)
        ref = ref_steps(2, "pq", X, jmodel, Q, 7, steps, placement)
        np.testing.assert_array_equal(port[0][1], ref[0][1])
        np.testing.assert_allclose(port[0][0], ref[0][0],
                                   rtol=1e-6 if "Sqrt" in metric else 0)
        _eq(port[1], ref[1])


@pytest.mark.parametrize("placement", ["row", "list"])
@pytest.mark.parametrize("tier", ["bucketed", "scan"])
def test_sharded_pq_mutations(world, rng, placement, tier):
    """Extend (auto and explicit ids, capacity growth), delete and upsert:
    the same capacities, counts, epochs and answers."""
    model, jmodel = _model(rng)
    X, Q = _data(rng)
    steps = [("extend", int_data(rng, (36, DIM), hi=4), None),
             ("search", tier, 3, "ring", None, 0),
             ("delete", [3, 70, 260, 280, 999]),
             ("search", tier, 3, "allgather", None, 0),
             ("upsert", int_data(rng, (4, DIM), hi=4),
              np.array([2, 7, 300, 301])),
             ("extend", np.repeat(X[:1], 400, axis=0), None),
             ("search", tier, 4, "allgather",
              np.array([False, True, True, True]), 0)]
    _run(world, 4, X, model, jmodel, Q, 8, steps, placement)


def test_replicated_delete_counts_each_row_once(world, rng):
    """With replicas present a delete masks both copies and counts each
    id once; extend appends to both copies, so the answers stay those of
    the replicas' owners; a replica serves its dead owner's lists."""
    model, jmodel = _model(rng)
    X, Q = _data(rng)
    dead = np.array([True, False, True, True])
    steps = [("replicate", list(range(N_LISTS)), None),
             ("extend", int_data(rng, (30, DIM), hi=4), None),
             ("delete", np.arange(0, 300, 3)),
             ("delete", np.arange(0, 300, 3)),
             ("search", "bucketed", 3, "allgather", None, 0),
             ("search", "scan", 3, "allgather", dead, 0),
             ("upsert", int_data(rng, (3, DIM), hi=4), np.array([3, 4, 5])),
             ("search", "bucketed", 3, "ring", dead, 0),
             ("migrate", [0, 0, 1, 1, 2, 2, 3, 3], None),
             ("search", "bucketed", 3, "allgather", None, 0)]
    port = _run(world, 4, X, model, jmodel, Q, 8, steps, "list")
    assert port[4] == np.count_nonzero(np.arange(0, 300, 3) < 286)
    assert port[6] == 0
    np.testing.assert_array_equal(port[10][2], 1.0)


@pytest.mark.parametrize("placement", ["row", "list"])
def test_sharded_pq_searcher(world, rng, placement):
    """The sharded Searcher over a ShardedIvfPq: warmup (the routed
    shapes too), degraded serving with a dead rank, a suspect rank, the
    dispatch hook's participants, extend / delete / upsert."""
    model, jmodel = _model(rng)
    X, Q = _data(rng)
    steps = [("warmup", 8), ("search", None),
             ("extend", int_data(rng, (16, DIM), hi=4)),
             ("delete", [1, 2, 3, 200, 265]), ("search", None),
             ("upsert", int_data(rng, (4, DIM), hi=4),
              np.array([2, 7, 400, 401])), ("search", True)]
    port = check_searchers(world, "pq", X, model, jmodel, Q, 6, (3,), (1,),
                           steps, placement)
    assert (len(port[1]) > 0) == (placement == "list")


def test_slice_as_a_whole(world, rng):
    """List-placed IVF-PQ: build, replicate the hottest lists, extend,
    then a degraded Searcher search with one rank dead: ids equal the
    reference's."""
    model, jmodel = _model(rng)
    X, Q = _data(rng)
    steps = [("search", None), ("replicate", [0, 1, 2, 3]),
             ("extend", int_data(rng, (40, DIM), hi=4)), ("search", None),
             ("search", False)]
    port = check_searchers(world, "pq", X, model, jmodel, Q, 10, (2,), (),
                           steps)
    assert port[0][0][3] and not port[0][6][3]
