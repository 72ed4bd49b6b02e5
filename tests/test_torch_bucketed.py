"""Kernel B3 (``fused_batch_knn``) and the IVF-Flat legacy bucket-table
engine of raft_tpu_torch against raft_tpu's.

B3's plain version is held to the reference kernel in interpret mode,
with a db tile (``bd``) smaller than n so the reference merges across
tiles. The bucket engine runs both packages on the SAME index (the
reference builds it, its centers are rounded to integers and the arrays
cross over with ``index_from_numpy``); integer rows and queries keep every
distance exact, so ids and distances agree bit for bit. On the CPU the
engine is reached as in the reference: an explicit ``bucket_cap``, or
``engine="bucketed"`` where the cells engine does not apply (k > 256).
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance.distance_types import DistanceType as JDistance
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu_torch.neighbors import ivf_flat
from test_torch_common import GAUSS_TOL, gauss, int_data, n, t

fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")

jfk = importlib.import_module("raft_tpu.ops.fused_knn")

_TIERS = [(False, False), (True, False), (True, True)]


def _slabs(rng, B=4, m=9, nn=300, d=16):
    q = int_data(rng, (B, m, d))
    db = int_data(rng, (B, nn, d))
    invalid = rng.random((B, nn)) < 0.3
    invalid[1, :] = True                 # an empty slab
    invalid[2, 3:] = True                # a starved slab
    return q, db, invalid


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bf16,qsplit", _TIERS)
def test_batch_knn_bit_identical(rng, metric, bf16, qsplit):
    q, db, invalid = _slabs(rng)
    if qsplit:
        q = q + 0.25                     # a query bf16 cannot hold
    dbt, dbj = t(db), jnp.asarray(db)
    if bf16:
        dbt, dbj = dbt.to(torch.bfloat16), dbj.astype(jnp.bfloat16)
    d, i = fk.fused_batch_knn(t(q), dbt, t(invalid), 10, metric=metric,
                              bf16=bf16, qsplit=qsplit)
    jd, ji = jfk.fused_batch_knn(q, dbj, invalid, 10, metric=metric,
                                 bf16=bf16, qsplit=qsplit, bd=128,
                                 interpret=True)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))
    assert (n(i)[1] == -1).all() and (n(i)[2, :, 3:] == -1).all()


@pytest.mark.parametrize("k", [1, 290])
def test_batch_knn_k_one_and_k_near_n(rng, k):
    """k = 290 of n = 300 crosses tiles and starves every slab."""
    q, db, invalid = _slabs(rng)
    d, i = fk.fused_batch_knn(t(q), t(db), t(invalid), k, sqrt=True)
    jd, ji = jfk.fused_batch_knn(q, db, invalid, k, sqrt=True, bd=128,
                                 interpret=True)
    np.testing.assert_array_equal(n(i), n(ji))
    # The squared distances are exact; XLA's compiled sqrt is not always
    # correctly rounded (an ulp off on a few entries).
    np.testing.assert_allclose(n(d), n(jd), rtol=1e-6, atol=0)


def test_batch_knn_gaussian(rng):
    _, _, invalid = _slabs(rng)
    q, db = gauss(rng, (4, 9, 16)), gauss(rng, (4, 300, 16))
    d, _ = fk.fused_batch_knn(t(q), t(db), t(invalid), 8)
    jd, _ = jfk.fused_batch_knn(q, db, invalid, 8, interpret=True)
    np.testing.assert_allclose(n(d), n(jd), **GAUSS_TOL)


def test_batch_knn_rejects_other_devices():
    m = dict(device="meta")
    with pytest.raises(fk.CudaError):
        fk.fused_batch_knn(torch.zeros((2, 4, 8), **m),
                           torch.zeros((2, 5, 8), **m),
                           torch.zeros((2, 5), dtype=torch.bool, **m), 2)


# ---------------------------------------------------------------------------
# The legacy bucket-table engine of IVF-Flat.

_RNG = np.random.default_rng(17)
_X = int_data(_RNG, (1200, 16))
_Q = int_data(_RNG, (40, 16))
_INDEXES = {}


def _indexes(metric="L2Expanded", deleted=None):
    if metric not in _INDEXES:
        j = jivf.build(jivf.IndexParams(n_lists=12, kmeans_n_iters=5,
                                        metric=JDistance[metric]), _X)
        _INDEXES[metric] = dataclasses.replace(j, centers=jnp.round(
            j.centers))
    j = _INDEXES[metric]
    if deleted is not None:
        j = dataclasses.replace(j, deleted=jnp.asarray(deleted),
                                n_deleted=int(deleted.sum()))
    p = ivf_flat.index_from_numpy(n(j.centers), n(j.data), n(j.indices),
                                  n(j.list_sizes), j.metric.value,
                                  deleted=deleted, device="cpu")
    return p, j


def _search_both(p, j, k, **sp):
    d, i = ivf_flat.search(ivf_flat.SearchParams(**sp), p, t(_Q), k)
    jd, ji = jivf.search(jivf.SearchParams(**sp), j, _Q, k)
    return d, i, jd, ji


@pytest.mark.parametrize("metric", ["L2Expanded", "L2SqrtExpanded",
                                    "InnerProduct"])
@pytest.mark.parametrize("engine", ["auto", "bucketed"])
@pytest.mark.parametrize("bucket_cap", [3, 16])
def test_bucket_cap_engine_bit_identical(metric, engine, bucket_cap):
    """An explicit bucket_cap selects the bucket engine; cap 3 drops the
    farthest probes of contended lists, identically on both sides."""
    p, j = _indexes(metric)
    d, i, jd, ji = _search_both(p, j, 10, n_probes=4, engine=engine,
                                bucket_cap=bucket_cap)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))


@pytest.mark.parametrize("metric", ["L2Expanded", "InnerProduct"])
def test_explicit_bucketed_with_k_past_the_cells_queue(metric):
    """engine="bucketed" with k > 256: the cells engine does not take it,
    so the bucket engine runs at a measured capacity."""
    p, j = _indexes(metric)
    d, i, jd, ji = _search_both(p, j, 300, n_probes=6, engine="bucketed")
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))
    assert d.shape == (40, 300)
    assert p.__dict__["_auto_cap_cache"] == j.__dict__["_auto_cap_cache"]


def test_bucket_engine_with_deleted_mask():
    rng = np.random.default_rng(5)
    deleted = rng.random(_indexes()[1].indices.shape) < 0.4
    p, j = _indexes(deleted=deleted)
    d, i, jd, ji = _search_both(p, j, 10, n_probes=3, bucket_cap=16)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))


def test_bucket_engine_on_8bit_storage():
    """uint8 rows run the bf16 tier with the split query, as the
    reference does."""
    _, j = _indexes()
    j8 = dataclasses.replace(j, data=j.data.astype(jnp.uint8))
    p8 = ivf_flat.index_from_numpy(n(j8.centers), n(j8.data), n(j8.indices),
                                   n(j8.list_sizes), 0, device="cpu")
    q = _Q + 0.25
    sp = dict(n_probes=4, bucket_cap=16)
    d, i = ivf_flat.search(ivf_flat.SearchParams(**sp), p8, t(q), 10)
    jd, ji = jivf.search(jivf.SearchParams(**sp), j8, q, 10)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_allclose(n(d), n(jd), rtol=1e-6)


@pytest.mark.parametrize("dtype,shift", [("uint8", 0), ("int8", -4)])
@pytest.mark.parametrize("bucket_cap", [0, 16])
def test_search_hands_the_kernels_the_8bit_store(monkeypatch, dtype, shift,
                                                 bucket_cap):
    """An 8-bit index is scanned on its own store: the packed-cells engine
    (bucket_cap 0) hands B2, the bucket engine B3, the uint8 / int8 rows
    themselves (no bf16 copy) on the bf16 tier with the split query; the
    answer equals the reference's, which casts the rows to bf16."""
    _, j = _indexes()
    j8 = dataclasses.replace(j, data=(j.data + shift).astype(dtype))
    p8 = ivf_flat.index_from_numpy(n(j8.centers), n(j8.data), n(j8.indices),
                                   n(j8.list_sizes), 0, device="cpu")
    seen = []

    def spy(name, pos):
        real = getattr(ivf_flat, name)

        def call(*args, **kw):
            seen.append((name, args[pos].dtype, kw["bf16"], kw["qsplit"]))
            return real(*args, **kw)

        monkeypatch.setattr(ivf_flat, name, call)

    spy("fused_cells_knn", 2)
    spy("fused_batch_knn", 1)
    q = _Q + 0.25
    sp = dict(n_probes=4, engine="bucketed", bucket_cap=bucket_cap)
    d, i = ivf_flat.search(ivf_flat.SearchParams(**sp), p8, t(q), 10)
    jd, ji = jivf.search(jivf.SearchParams(**sp), j8, q, 10)
    kernel = "fused_batch_knn" if bucket_cap else "fused_cells_knn"
    assert seen == [(kernel, getattr(torch, dtype), True, True)]
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_allclose(n(d), n(jd), rtol=1e-6)


def test_probe_map_inversion_and_routing_match_reference():
    rng = np.random.default_rng(11)
    probes = rng.integers(0, 9, (37, 4)).astype(np.int32)
    bucket, route = ivf_flat._invert_probe_map(t(probes), 9, 5)
    jbucket, jroute = jivf._invert_probe_map(jnp.asarray(probes), 9, 5)
    np.testing.assert_array_equal(n(bucket), n(jbucket))
    for a, b in zip(route, jroute):
        np.testing.assert_array_equal(n(a), n(b))
    bd_ = rng.standard_normal((9, 5, 3)).astype(np.float32)
    gi = rng.integers(0, 100, (9, 5, 3)).astype(np.int32)
    cd, ci = ivf_flat._route_candidates(t(bd_), t(gi), route, 37, 4, 5,
                                        float("inf"))
    jcd, jci = jivf._route_candidates(jnp.asarray(bd_), jnp.asarray(gi),
                                      jroute, 37, 4, 5, jnp.inf)
    np.testing.assert_array_equal(n(cd), n(jcd))
    np.testing.assert_array_equal(n(ci), n(jci))


@pytest.mark.parametrize("engine,bucket_cap", [("bucketed", 0),
                                               ("bucketed", 8),
                                               ("auto", 0), ("scan", 0)])
def test_pick_engine_matches_reference_off_the_card(engine, bucket_cap):
    """Off the accelerator both packages resolve "auto" to the scan, and
    the measured capacity (front-rank contention, skew bound) agrees."""
    rng = np.random.default_rng(3)
    probes = rng.integers(0, 16, (200, 6)).astype(np.int32)
    probes[:60, 0] = 2                   # a hot list
    ours = ivf_flat._pick_engine(engine, 200, 6, 16, 10, bucket_cap, 32,
                                 t(probes), torch.device("cpu"))
    ref = jivf._pick_engine(engine, 200, 6, 16, 10, bucket_cap, 32,
                            jnp.asarray(probes))
    assert ours == ref
    assert ivf_flat._front_rank_contention(t(probes), 16) == tuple(
        int(v) for v in n(jivf._front_rank_contention(jnp.asarray(probes),
                                                      16)))


def test_auto_takes_the_bucket_engine_on_cuda():
    """The "auto" gate is the reference's with cuda in place of tpu."""
    probes = torch.zeros((64, 4), dtype=torch.int32)
    engine, cap = ivf_flat._pick_engine("auto", 64, 4, 2, 10, 16, 8, probes,
                                        torch.device("cuda"))
    assert (engine, cap) == ("bucketed", 16)
    engine, _ = ivf_flat._pick_engine("auto", 64, 4, 2, 200, 16, 8, probes,
                                      torch.device("cuda"))
    assert engine == "scan"              # k > 128
