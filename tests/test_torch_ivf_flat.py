"""IVF-Flat of raft_tpu_torch against raft_tpu's.

Search parity runs both packages on the SAME index: the reference builds
it, its arrays cross over with ``index_from_numpy``, and its centers are
rounded to integers so that, with integer-valued rows and queries, every
distance is exact and ids agree bit for bit. The cells engine is forced on
both sides with ``engine="bucketed"`` and ``bucket_cap=0`` (on the CPU the
reference then runs its Pallas kernel in interpret mode); the scan engine
with ``engine="scan"``. Build + search end to end is held by recall@10
against exact kNN: at least the reference's less 0.02 (their k-means draw
different random numbers). ``extend`` is held to the reference's list
sizes, ids, rows and capacity growth exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance.distance_types import DistanceType as JDistance
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import ivf_flat
from test_torch_common import blobs, int_data, n, recall, t

RECALL_MARGIN = 0.02


def _jax_index(X, n_lists, metric="L2Expanded", **kw):
    idx = jivf.build(jivf.IndexParams(n_lists=n_lists, kmeans_n_iters=5,
                                      metric=JDistance[metric], **kw), X)
    return dataclasses.replace(idx, centers=jnp.round(idx.centers))


def _port_index(jidx, deleted=None):
    return ivf_flat.index_from_numpy(
        n(jidx.centers), n(jidx.data), n(jidx.indices), n(jidx.list_sizes),
        jidx.metric.value, deleted=deleted, device="cpu")


_INT_RNG = np.random.default_rng(7)
_INT_X = int_data(_INT_RNG, (1200, 16))
_INT_Q = int_data(_INT_RNG, (40, 16))
_INT_INDEXES = {}


@pytest.fixture
def int_case():
    return _INT_X, _INT_Q


def _int_index(metric="L2Expanded"):
    """The reference index over the shared integer rows, built once per
    metric."""
    if metric not in _INT_INDEXES:
        _INT_INDEXES[metric] = _jax_index(_INT_X, 12, metric)
    return _INT_INDEXES[metric]


@pytest.mark.parametrize("metric", ["L2Expanded", "L2SqrtExpanded",
                                    "InnerProduct"])
@pytest.mark.parametrize("engine", ["bucketed", "scan"])
@pytest.mark.parametrize("k", [1, 10])
def test_search_parity(int_case, metric, engine, k):
    X, Q = int_case
    jidx = _int_index(metric)
    idx = _port_index(jidx)
    d, i = ivf_flat.search(ivf_flat.SearchParams(n_probes=4, engine=engine),
                           idx, t(Q), k)
    jd, ji = jivf.search(jivf.SearchParams(n_probes=4, engine=engine), jidx,
                         Q, k)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_allclose(n(d), n(jd), rtol=1e-6, atol=0)


@pytest.mark.parametrize("engine", ["bucketed", "scan"])
def test_search_parity_with_deleted_mask(int_case, engine):
    X, Q = int_case
    jidx = _int_index()
    rng = np.random.default_rng(3)
    deleted = rng.random(jidx.indices.shape) < 0.4
    jidx = dataclasses.replace(jidx, deleted=jnp.asarray(deleted),
                               n_deleted=int(deleted.sum()))
    idx = _port_index(jidx, deleted)
    assert idx.n_deleted == int(deleted.sum())
    sp = dict(n_probes=3, engine=engine)
    d, i = ivf_flat.search(ivf_flat.SearchParams(**sp), idx, t(Q), 10)
    jd, ji = jivf.search(jivf.SearchParams(**sp), jidx, Q, 10)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))
    live = set(n(jidx.indices)[~deleted & (n(jidx.indices) >= 0)].tolist())
    assert set(n(i).ravel().tolist()) <= live | {-1}


def test_starved_search_pads_with_sentinels(int_case):
    """k beyond what the probed list holds: (worst, -1) slots, as the
    reference gives them."""
    X, Q = int_case
    jidx = _int_index()
    idx = _port_index(jidx)
    for engine in ("bucketed", "scan"):
        sp = dict(n_probes=1, engine=engine)
        d, i = ivf_flat.search(ivf_flat.SearchParams(**sp), idx, t(Q), 250)
        jd, ji = jivf.search(jivf.SearchParams(**sp), jidx, Q, 250)
        np.testing.assert_array_equal(n(i), n(ji))
        np.testing.assert_array_equal(n(d), n(jd))
        assert (n(i) == -1).any()


def test_cells_inversion_matches_reference():
    rng = np.random.default_rng(11)
    probes = rng.integers(0, 9, (37, 4)).astype(np.int32)
    cl, bucket, route = ivf_flat._invert_probe_map_cells(t(probes), 9, 8)
    jcl, jbucket, jroute = jivf._invert_probe_map_cells(
        jnp.asarray(probes), 9, 8)
    np.testing.assert_array_equal(n(cl), n(jcl))
    np.testing.assert_array_equal(n(bucket), n(jbucket))
    for a, b in zip(route, jroute):
        np.testing.assert_array_equal(n(a), n(b))


def test_build_and_search_recall():
    rng = np.random.default_rng(2)
    X = blobs(rng, 2000, 16, n_blobs=20, std=2.0)
    Q = X[:100] + rng.standard_normal((100, 16)).astype(np.float32)
    params = dict(n_lists=16, kmeans_n_iters=8)
    idx = ivf_flat.build(ivf_flat.IndexParams(**params), t(X))
    jidx = jivf.build(jivf.IndexParams(**params), X)
    assert idx.size == X.shape[0] == jidx.size
    assert sorted(n(idx.indices)[n(idx.indices) >= 0].tolist()) == list(
        range(X.shape[0]))
    _, truth = jbf.knn(X, Q, 10)
    for engine in ("bucketed", "scan"):
        _, i = ivf_flat.search(
            ivf_flat.SearchParams(n_probes=4, engine=engine), idx, t(Q), 10)
        _, ji = jivf.search(
            jivf.SearchParams(n_probes=4, engine=engine), jidx, Q, 10)
        assert recall(i, truth) >= recall(ji, truth) - RECALL_MARGIN


def _empty_indexes(centers, cap=1, **kw):
    L, d = centers.shape
    arrays = dict(centers=centers,
                  data=np.zeros((L, cap, d), np.float32),
                  indices=np.full((L, cap), -1, np.int32),
                  list_sizes=np.zeros((L,), np.int32))
    jidx = jivf.Index(metric=JDistance.L2Expanded,
                      **{k: jnp.asarray(v) for k, v in arrays.items()}, **kw)
    idx = ivf_flat.index_from_numpy(**arrays, metric=0, device="cpu")
    for key, v in kw.items():
        setattr(idx, key, v)
    return idx, jidx


def _same_index(idx, jidx):
    for field in ("list_sizes", "indices", "data", "centers"):
        np.testing.assert_allclose(n(getattr(idx, field)),
                                   n(getattr(jidx, field)), rtol=1e-6,
                                   err_msg=field)
    assert idx.data.shape == tuple(jidx.data.shape)
    assert idx.epoch == jidx.epoch


@pytest.mark.parametrize("conservative", [False, True])
@pytest.mark.parametrize("adaptive", [False, True])
def test_extend_bulk_then_append(conservative, adaptive):
    rng = np.random.default_rng(4)
    centers = int_data(rng, (6, 8))
    kw = dict(conservative_memory_allocation=conservative,
              adaptive_centers=adaptive)
    idx, jidx = _empty_indexes(centers, **kw)
    A = int_data(rng, (50, 8))
    idx = ivf_flat.extend(idx, t(A))
    jidx = jivf.extend(jidx, A)
    _same_index(idx, jidx)
    # Append with default ids (max id + 1 onwards), growing a list.
    B = np.repeat(A[:1], 40, axis=0)
    idx = ivf_flat.extend(idx, t(B))
    jidx = jivf.extend(jidx, B)
    _same_index(idx, jidx)
    # Append with explicit ids that fit without growth.
    C = int_data(rng, (3, 8))
    ids = np.array([900, 901, 902], np.int32)
    idx = ivf_flat.extend(idx, t(C), t(ids))
    jidx = jivf.extend(jidx, C, ids)
    _same_index(idx, jidx)
    assert idx._next_id == jidx._next_id == 903


def test_extend_grows_the_deleted_mask():
    jidx = _int_index()
    deleted = np.zeros(jidx.indices.shape, bool)
    deleted[0, 0] = True
    idx = _port_index(jidx, deleted)
    more = np.repeat(_INT_X[:1], 3 * jidx.indices.shape[1], axis=0)
    idx = ivf_flat.extend(idx, t(more))
    assert idx.deleted.shape == idx.indices.shape
    assert idx.indices.shape[1] > jidx.indices.shape[1]
    assert bool(idx.deleted[0, 0]) and int(idx.deleted.sum()) == 1


def test_auto_engine_on_cpu_is_the_scan(int_case):
    X, Q = int_case
    jidx = _int_index()
    idx = _port_index(jidx)
    d, i = ivf_flat.search(ivf_flat.SearchParams(n_probes=5), idx, t(Q), 10)
    jd, ji = jivf.search(jivf.SearchParams(n_probes=5), jidx, Q, 10)
    np.testing.assert_array_equal(n(i), n(ji))
    assert idx.metric == DistanceType.L2Expanded
    assert i.dtype == torch.int32


def _jax_array(x: torch.Tensor):
    """A port tensor as the reference's array, bf16 bits included."""
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("engine", ["scan", "bucketed"])
def test_low_precision_index_searches_as_the_reference(int_case, dtype,
                                                       engine):
    """ROADMAP C.1: a bf16 / f16 build keeps bf16 / f16 centers, as the
    reference's does, and the port searches it: the coarse probe sums the
    center norms in the centers' dtype, then promotes, with the product in
    f32, as the reference's scan engine does. The reference's index
    searched in both packages, and the port's own build searched in both,
    give the same ids and distances. The reference's packed-cells engine
    probes inside one jitted program, where XLA drops the bf16 / f16
    rounding of the center norms' products (ROADMAP C.2), so both port
    engines are held to its scan engine."""
    X, Q = int_case
    jsp = jivf.SearchParams(n_probes=4, engine="scan")
    sp = ivf_flat.SearchParams(n_probes=4, engine=engine)
    jidx = jivf.build(jivf.IndexParams(n_lists=12, kmeans_n_iters=5),
                      jnp.asarray(X).astype(dtype))
    assert jidx.centers.dtype == dtype and jidx.data.dtype == dtype
    idx = _port_index(jidx)
    assert idx.centers.dtype == getattr(torch, dtype)
    d, i = ivf_flat.search(sp, idx, t(Q), 10)
    jd, ji = jivf.search(jsp, jidx, Q, 10)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_allclose(n(d), n(jd), rtol=1e-6, atol=0)

    own = ivf_flat.build(ivf_flat.IndexParams(n_lists=12, kmeans_n_iters=5),
                         t(X).to(getattr(torch, dtype)))
    assert own.centers.dtype == own.data.dtype == getattr(torch, dtype)
    d, i = ivf_flat.search(sp, own, t(Q), 10)
    jown = dataclasses.replace(
        jidx, centers=_jax_array(own.centers), data=_jax_array(own.data),
        indices=jnp.asarray(n(own.indices)),
        list_sizes=jnp.asarray(n(own.list_sizes)))
    jd, ji = jivf.search(jsp, jown, Q, 10)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_allclose(n(d), n(jd), rtol=1e-6, atol=0)
