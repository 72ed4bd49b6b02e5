"""float64 inputs and empty query batches at the port's entry points.

With x64 off (``tests/conftest.py``) the reference's ``jnp.asarray`` maps
every float64 input to float32, so numpy's default float is searched as
float32. The port does the same at every entry point that takes vectors
(``core/resources.as_vectors``); f16, bf16 and 8-bit inputs keep their
dtype. Each case here hands one operand as float64 to both packages and
holds the port to the reference on integer-valued data, where every
distance is exact: ids bit for bit, distances equal (IVF-Flat within rtol
1e-6, the tolerance of its own parity tests). Builds draw different random
numbers in the two packages, so a float64 build is held to the port's own
float32 build bit for bit, and its stored dtypes to the reference's.

An empty query batch gives (0, k) results in both packages: float32
distances and ids in the index's id dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import lifecycle as jlc
from raft_tpu import serve as jserve
from raft_tpu.distance.distance_types import DistanceType as JDistance
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import lifecycle as lc
from raft_tpu_torch import serve
from raft_tpu_torch.core import resources
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
from test_torch_common import int_data, n, t

DIM, N_LISTS, PQ_DIM, CAP = 16, 8, 8, 96
FLAT_RTOL = 1e-6

_RNG = np.random.default_rng(11)
_X = int_data(_RNG, (600, DIM))
_Q = int_data(_RNG, (20, DIM))
_NEW = int_data(_RNG, (30, DIM))


def f64(a) -> np.ndarray:
    return np.asarray(a, np.float64)


@pytest.fixture(scope="module")
def flat_arrays():
    """The reference's IVF-Flat index over ``_X``, centers rounded to
    integers, as numpy arrays."""
    j = jivf.build(jivf.IndexParams(n_lists=N_LISTS, kmeans_n_iters=3), _X)
    return dict(centers=np.round(n(j.centers)), data=n(j.data),
                indices=n(j.indices), list_sizes=n(j.list_sizes))


def _flat_pair(a):
    j = jivf.Index(metric=JDistance.L2Expanded,
                   **{k: jnp.asarray(v) for k, v in a.items()})
    p = ivf_flat.index_from_numpy(**a, metric=0, device="cpu")
    return p, j


@pytest.fixture(scope="module")
def pq_arrays():
    """A small IVF-PQ index from integer arrays (identity rotation)."""
    rng = np.random.default_rng(5)
    sizes = rng.integers(40, CAP + 1, N_LISTS).astype(np.int32)
    indices = np.full((N_LISTS, CAP), -1, np.int32)
    base = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    for l in range(N_LISTS):
        indices[l, :sizes[l]] = base[l] + np.arange(sizes[l])
    codes = rng.integers(0, 256, (N_LISTS, CAP, PQ_DIM)).astype(np.int32)
    return dict(centers=int_data(rng, (N_LISTS, DIM), hi=4),
                rotation_matrix=np.eye(DIM, dtype=np.float32),
                pq_centers=rng.integers(-2, 3, (PQ_DIM, 256, DIM // PQ_DIM)
                                        ).astype(np.float32),
                pq_codes=n(ivf_pq.pack_codes(t(codes), 8)),
                indices=indices, list_sizes=sizes, pq_bits=8, pq_dim=PQ_DIM)


def _pq_pair(a):
    j = jpq.Index(metric=JDistance.L2Expanded,
                  codebook_kind=jpq.CodebookGen(0),
                  **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                     for k, v in a.items()})
    p = ivf_pq.index_from_numpy(**a, codebook_kind=0, metric=0,
                                device="cpu")
    return p, j


def _same(out, jout, rtol=0.0):
    (d, i), (jd, ji) = out, jout
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_allclose(n(d), n(jd), rtol=rtol, atol=0)
    assert n(d).dtype == np.float32 and n(d).dtype == n(jd).dtype


# ---------------------------------------------------------------------------
# C.1: float64 inputs


def test_as_vectors_maps_only_float64():
    assert resources.as_vectors(np.zeros(3, np.float64),
                                device="cpu").dtype == torch.float32
    for dt in (torch.float32, torch.float16, torch.bfloat16, torch.int8,
               torch.uint8):
        assert resources.as_vectors(torch.zeros(3, dtype=dt)).dtype == dt
    assert resources.as_float(torch.zeros(3, dtype=torch.float64)).dtype \
        == torch.float32
    assert resources.as_float(np.zeros(3, np.int32), device="cpu").dtype \
        == torch.float32


# operand -> (port inputs, reference inputs) of brute_force.knn
_BF_CASES = {
    "queries": lambda: ((t(_X), t(f64(_Q))), (_X, f64(_Q))),
    "db": lambda: ((t(f64(_X)), t(_Q)), (f64(_X), _Q)),
    "numpy_both": lambda: ((f64(_X), f64(_Q)), (f64(_X), f64(_Q))),
    "one_part_of_two": lambda: (([t(_X[:300]), t(f64(_X[300:]))], t(_Q)),
                                ([_X[:300], f64(_X[300:])], _Q)),
}


@pytest.mark.parametrize("operand", sorted(_BF_CASES))
@pytest.mark.parametrize("k", [1, 10])
def test_brute_force_float64(operand, k):
    (db, q), (jdb, jq) = _BF_CASES[operand]()
    if isinstance(db, np.ndarray):
        db, q = t(db), t(q)    # numpy goes to the card: cross as CPU f64
    _same(brute_force.knn(db, q, k), jbf.knn(jdb, jq, k))


@pytest.mark.parametrize("engine", ["auto", "scan", "bucketed"])
def test_ivf_flat_search_float64(flat_arrays, engine):
    p, j = _flat_pair(flat_arrays)
    sp = dict(n_probes=3, engine=engine)
    _same(ivf_flat.search(ivf_flat.SearchParams(**sp), p, t(f64(_Q)), 10),
          jivf.search(jivf.SearchParams(**sp), j, f64(_Q), 10), FLAT_RTOL)


@pytest.mark.parametrize("engine", ["auto", "scan", "bucketed"])
def test_ivf_pq_search_float64(pq_arrays, engine):
    p, j = _pq_pair(pq_arrays)
    sp = dict(n_probes=3, engine=engine)
    q = _Q[:, :DIM] % 4
    _same(ivf_pq.search(ivf_pq.SearchParams(**sp), p, t(f64(q)), 10),
          jpq.search(jpq.SearchParams(**sp), j, f64(q), 10))


@pytest.mark.parametrize("operand", ["queries", "dataset"])
def test_ivf_pq_search_refined_float64(pq_arrays, operand):
    p, j = _pq_pair(pq_arrays)
    ds = int_data(np.random.default_rng(2), (int(p.size) + 1, DIM), hi=4)
    q = _Q % 4
    pds, pq_ = (ds, f64(q)) if operand == "queries" else (f64(ds), q)
    sp = dict(n_probes=4, engine="scan")
    _same(ivf_pq.search_refined(ivf_pq.SearchParams(**sp), p, t(pds),
                                t(pq_), 5),
          jpq.search_refined(jpq.SearchParams(**sp), j, pds, pq_, 5))


def test_ivf_flat_build_float64_gives_a_float32_index():
    params = dict(n_lists=4, kmeans_n_iters=2)
    p64 = ivf_flat.build(ivf_flat.IndexParams(**params), t(f64(_X)))
    p32 = ivf_flat.build(ivf_flat.IndexParams(**params), t(_X))
    j64 = jivf.build(jivf.IndexParams(**params), f64(_X))
    assert p64.data.dtype == p64.centers.dtype == torch.float32
    assert n(p64.data).dtype == n(j64.data).dtype
    assert n(p64.indices).dtype == n(j64.indices).dtype
    for field in ("centers", "data", "indices", "list_sizes"):
        assert torch.equal(getattr(p64, field), getattr(p32, field)), field
    # Every list probed: exact kNN distances (ids may differ at ties).
    d, _ = ivf_flat.search(ivf_flat.SearchParams(n_probes=4), p64, t(_Q), 5)
    np.testing.assert_array_equal(n(d), n(jbf.knn(_X, _Q, 5)[0]))


def test_ivf_pq_build_float64_equals_float32():
    params = dict(n_lists=4, kmeans_n_iters=2, pq_dim=PQ_DIM)
    p64 = ivf_pq.build(ivf_pq.IndexParams(**params), t(f64(_X)))
    p32 = ivf_pq.build(ivf_pq.IndexParams(**params), t(_X))
    j64 = jpq.build(jpq.IndexParams(**params), f64(_X))
    for field in ("centers", "rotation_matrix", "pq_centers", "pq_codes",
                  "indices", "list_sizes"):
        assert torch.equal(getattr(p64, field), getattr(p32, field)), field
        assert n(getattr(p64, field)).dtype == n(getattr(j64, field)).dtype
    # The retained dataset is float32 too, so search_refined(None) runs.
    assert p64._source.dtype == torch.float32
    ivf_pq.search_refined(ivf_pq.SearchParams(n_probes=4), p64, None,
                          t(_Q), 3)


def test_ivf_flat_extend_float64(flat_arrays):
    p, j = _flat_pair(flat_arrays)
    p = ivf_flat.extend(p, t(f64(_NEW)))
    j = jivf.extend(j, f64(_NEW))
    for field in ("data", "indices", "list_sizes"):
        np.testing.assert_array_equal(n(getattr(p, field)),
                                      n(getattr(j, field)), err_msg=field)
    assert p.data.dtype == torch.float32


def test_ivf_pq_extend_float64(pq_arrays):
    p, j = _pq_pair(pq_arrays)
    new = _NEW % 4
    p = ivf_pq.extend(p, t(f64(new)))
    j = jpq.extend(j, f64(new))
    for field in ("pq_codes", "indices", "list_sizes"):
        np.testing.assert_array_equal(n(getattr(p, field)),
                                      n(getattr(j, field)), err_msg=field)


@pytest.mark.parametrize("kind", ["flat", "pq"])
def test_upsert_float64(flat_arrays, pq_arrays, kind):
    p, j = (_flat_pair(flat_arrays) if kind == "flat"
            else _pq_pair(pq_arrays))
    ids = np.arange(1, 41, 4, dtype=np.int32)
    new = f64(_NEW[:ids.size] % 4)
    p = lc.upsert(p, t(new), t(ids))
    j = jlc.upsert(j, new, ids)
    assert (p.epoch, p.n_deleted) == (j.epoch, j.n_deleted)
    mod, jmod = (ivf_flat, jivf) if kind == "flat" else (ivf_pq, jpq)
    sp = dict(n_probes=N_LISTS, engine="scan")
    _same(mod.search(mod.SearchParams(**sp), p, t(_Q % 4), 5),
          jmod.search(jmod.SearchParams(**sp), j, _Q % 4, 5), FLAT_RTOL)


def _searchers(kind, flat_arrays, pq_arrays, db64=False):
    if kind == "brute_force":
        db = f64(_X) if db64 else _X
        return (serve.Searcher.brute_force(t(db)),
                jserve.Searcher.brute_force(db))
    if kind == "ivf_flat":
        p, j = _flat_pair(flat_arrays)
        return (serve.Searcher.ivf_flat(p, ivf_flat.SearchParams(3)),
                jserve.Searcher.ivf_flat(j, jivf.SearchParams(3)))
    p, j = _pq_pair(pq_arrays)
    return (serve.Searcher.ivf_pq(p, ivf_pq.SearchParams(3)),
            jserve.Searcher.ivf_pq(j, jpq.SearchParams(3)))


def _same_result(res, jres, rtol=0.0):
    np.testing.assert_array_equal(res.indices, np.asarray(jres.indices))
    np.testing.assert_allclose(res.distances, np.asarray(jres.distances),
                               rtol=rtol, atol=0)
    assert res.distances.dtype == np.asarray(jres.distances).dtype
    assert res.indices.dtype == np.asarray(jres.indices).dtype


@pytest.mark.parametrize("kind", ["brute_force", "ivf_flat", "ivf_pq"])
def test_searcher_float64_queries(flat_arrays, pq_arrays, kind):
    s, js = _searchers(kind, flat_arrays, pq_arrays)
    q = f64(_Q % 4)
    _same_result(s.search(q, 10), js.search(q, 10), FLAT_RTOL)


def test_brute_force_searcher_float64_db(flat_arrays, pq_arrays):
    s, js = _searchers("brute_force", flat_arrays, pq_arrays, db64=True)
    assert s._db.dtype == torch.float32
    _same_result(s.search(_Q, 10), js.search(_Q, 10))


# ---------------------------------------------------------------------------
# C.2: empty query batches


@pytest.mark.parametrize("kind", ["flat", "pq"])
@pytest.mark.parametrize("engine", ["auto", "scan"])
@pytest.mark.parametrize("k", [1, 10])
def test_ivf_search_zero_queries(flat_arrays, pq_arrays, kind, engine, k):
    p, j = (_flat_pair(flat_arrays) if kind == "flat"
            else _pq_pair(pq_arrays))
    mod, jmod = (ivf_flat, jivf) if kind == "flat" else (ivf_pq, jpq)
    q = np.zeros((0, DIM), np.float32)
    sp = dict(n_probes=3, engine=engine)
    d, i = mod.search(mod.SearchParams(**sp), p, t(q), k)
    jd, ji = jmod.search(jmod.SearchParams(**sp), j, q, k)
    assert tuple(d.shape) == tuple(i.shape) == jd.shape == ji.shape == (0, k)
    assert (n(d).dtype, n(i).dtype) == (n(jd).dtype, n(ji).dtype)
    assert i.dtype == p.indices.dtype


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
@pytest.mark.parametrize("k", [1, 10])
def test_ivf_searcher_zero_queries(flat_arrays, pq_arrays, kind, k):
    s, js = _searchers(kind, flat_arrays, pq_arrays)
    q = np.zeros((0, DIM), np.float32)
    res, jres = s.search(q, k), js.search(q, k)
    assert res.indices.shape == res.distances.shape == (0, k)
    _same_result(res, jres)
    assert res.coverage.shape == np.asarray(jres.coverage).shape == (0,)
