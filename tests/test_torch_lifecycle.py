"""The single-host index lifecycle of raft_tpu_torch against raft_tpu's.

Each case builds the reference index, crosses its arrays over with
``index_from_numpy``, and applies the same deletes, upserts and
compactions in both packages. Rows, queries and centers are integer
valued, so every distance is exact: ids and distances must agree bit for
bit, tombstoned searches must equal a rebuild without the deleted rows,
and pure reclamation must leave the arrays equal to the reference's and
the search results unchanged. The IVF-Flat model pass (split, recluster)
runs on well-separated integer blobs, so no row sits near a tie; its new
centers are means of integer rows, held to 1e-4 against the reference's
(the two sum in different orders), and its labels and ids must be
identical.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import lifecycle as jlc
from raft_tpu.distance.distance_types import DistanceType as JDistance
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import lifecycle as lc
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
from test_torch_common import int_data, n, t

# The package exports the function under the module's name.
compact_mod = importlib.import_module("raft_tpu_torch.lifecycle.compact")

CENTER_TOL = dict(rtol=0, atol=1e-4)


def _empty_flat_pair(centers):
    L, d = centers.shape
    arrays = dict(centers=centers, data=np.zeros((L, 1, d), np.float32),
                  indices=np.full((L, 1), -1, np.int32),
                  list_sizes=np.zeros((L,), np.int32))
    j = jivf.Index(metric=JDistance.L2Expanded,
                   **{k: jnp.asarray(v) for k, v in arrays.items()})
    return ivf_flat.index_from_numpy(**arrays, metric=0, device="cpu"), j


def _flat_pair(seed, n_rows=1024, dim=16, n_lists=8, gaussian=False):
    """The reference's k-means centers, rounded to integers, and the rows
    (ids 0..n-1) added to both packages' empty indexes, so that list
    membership follows the integer centers (as in a rebuild)."""
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n_rows, dim)).astype(np.float32) if gaussian
         else int_data(rng, (n_rows, dim)))
    model = jivf.build(jivf.IndexParams(n_lists=n_lists, kmeans_n_iters=4,
                                        add_data_on_build=False), X)
    p, j = _empty_flat_pair(np.round(n(model.centers)))
    p = ivf_flat.extend(p, t(X))
    j = jivf.extend(j, X)
    return X, p, j


def _same_flat(p, j):
    for field in ("list_sizes", "indices", "data"):
        np.testing.assert_array_equal(n(getattr(p, field)),
                                      n(getattr(j, field)), err_msg=field)
    np.testing.assert_allclose(n(p.centers), n(j.centers), **CENTER_TOL)
    assert p.epoch == j.epoch and p.n_deleted == j.n_deleted


# IVF-PQ: a small index made from integer arrays (identity rotation).
DIM, PQ_DIM, N_LISTS, CAP = 16, 8, 8, 96


def _pq_arrays(rng):
    sizes = rng.integers(40, CAP + 1, N_LISTS).astype(np.int32)
    indices = np.full((N_LISTS, CAP), -1, np.int32)
    base = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    for l in range(N_LISTS):
        indices[l, :sizes[l]] = base[l] + np.arange(sizes[l])
    codes = rng.integers(0, 256, (N_LISTS, CAP, PQ_DIM)).astype(np.int32)
    return dict(
        centers=int_data(rng, (N_LISTS, DIM), hi=4),
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


def _without(a, dels):
    """The same PQ arrays with the deleted rows removed from their lists
    (the rebuild the tombstoned index must equal)."""
    b = {k: (v.copy() if isinstance(v, np.ndarray) else v)
         for k, v in a.items()}
    for l in range(N_LISTS):
        size = a["list_sizes"][l]
        keep = ~np.isin(a["indices"][l, :size], dels)
        m = int(keep.sum())
        b["indices"][l] = -1
        b["indices"][l, :m] = a["indices"][l, :size][keep]
        b["pq_codes"][l] = 0
        b["pq_codes"][l, :m] = a["pq_codes"][l, :size][keep]
        b["list_sizes"][l] = m
    return b


def _no_deleted(ids, dels) -> bool:
    return not np.intersect1d(n(ids).ravel(), np.asarray(dels)).size


# ---------------------------------------------------------------------------
# Delete


@pytest.mark.parametrize("engine", ["scan", "bucketed"])
def test_flat_delete_matches_reference_and_rebuild(engine):
    X, p, j = _flat_pair(10)
    dels = np.arange(0, 1024, 17)
    assert lc.delete(p, dels) == jlc.delete(j, dels) == dels.size
    np.testing.assert_array_equal(n(p.deleted), n(j.deleted))
    assert p.epoch == j.epoch == 2 and p.n_deleted == dels.size  # fill + delete
    sp = dict(n_probes=8, engine=engine)
    Q = X[dels[:16]]                          # probe FOR the deleted rows
    d, i = ivf_flat.search(ivf_flat.SearchParams(**sp), p, t(Q), 10)
    jd, ji = jivf.search(jivf.SearchParams(**sp), j, Q, 10)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))
    assert _no_deleted(i, dels)
    # A rebuild without the deleted rows: same centers, survivors only.
    surv = np.setdiff1d(np.arange(1024), dels).astype(np.int32)
    r, _ = _empty_flat_pair(n(j.centers))
    r = ivf_flat.extend(r, t(X[surv]), t(surv))
    rd, ri = ivf_flat.search(ivf_flat.SearchParams(**sp), r, t(Q), 10)
    np.testing.assert_array_equal(n(i), n(ri))
    np.testing.assert_array_equal(n(d), n(rd))


@pytest.mark.parametrize("engine", ["scan", "bucketed"])
def test_pq_delete_matches_reference_and_rebuild(rng, engine):
    a = _pq_arrays(rng)
    p, j = _pq_pair(a)
    live = a["indices"][a["indices"] >= 0]
    dels = live[::7]
    p.compressed_scan_operands()             # a warm cache must be dropped
    assert lc.delete(p, dels) == jlc.delete(j, dels) == dels.size
    assert p._scan_ops is None
    np.testing.assert_array_equal(n(p.deleted), n(j.deleted))
    Q = int_data(rng, (24, DIM), hi=4)
    sp = dict(n_probes=N_LISTS, engine=engine)
    d, i = ivf_pq.search(ivf_pq.SearchParams(**sp), p, t(Q), 10)
    jd, ji = jpq.search(jpq.SearchParams(**sp), j, Q, 10)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))
    assert _no_deleted(i, dels)
    r, _ = _pq_pair(_without(a, dels))
    rd, ri = ivf_pq.search(ivf_pq.SearchParams(**sp), r, t(Q), 10)
    np.testing.assert_array_equal(n(i), n(ri))
    np.testing.assert_array_equal(n(d), n(rd))


def test_delete_matches_brute_force_truth_over_survivors():
    """Full-probe tombstoned search equals exact kNN over the survivors
    (Gaussian rows: no ties between lists)."""
    X, p, _ = _flat_pair(14, n_rows=512, dim=8, n_lists=4, gaussian=True)
    dels = np.arange(0, 512, 7)
    lc.delete(p, t(dels))                     # ids as a tensor
    surv = np.setdiff1d(np.arange(512), dels)
    Q = X[dels[:8]]
    d, i = ivf_flat.search(ivf_flat.SearchParams(n_probes=4, engine="scan"),
                           p, t(Q), 5)
    td, ti = brute_force.knn(t(X[surv]), t(Q), 5)
    jd, ji = jbf.knn(X[surv], Q, 5)
    np.testing.assert_array_equal(n(ti), n(ji))
    np.testing.assert_array_equal(n(i), surv[n(ti)])
    np.testing.assert_allclose(n(d), n(td), rtol=1e-5, atol=1e-5)


def test_redelete_is_idempotent_and_unknown_ids_ignored():
    _, p, j = _flat_pair(15, n_rows=512, dim=8, n_lists=4)
    for idx, delete in ((p, lc.delete), (j, jlc.delete)):
        assert delete(idx, [3, 5]) == 2
        e = idx.epoch
        assert delete(idx, [3, 5]) == 0
        assert delete(idx, [99999]) == 0
        assert delete(idx, []) == 0
        assert idx.epoch == e and idx.n_deleted == 2
    assert abs(lc.tombstone_frac(p) - 2 / 512) < 1e-12
    assert lc.tombstone_frac(p) == jlc.tombstone_frac(j)


def test_noop_delete_on_fresh_index_changes_nothing():
    _, p, _ = _flat_pair(28, n_rows=512, dim=8, n_lists=4)
    e0 = p.epoch
    assert lc.delete(p, [99999]) == 0
    assert p.deleted is None and p.epoch == e0


def test_enable_tombstones_survives_bulk_extend():
    X = int_data(np.random.default_rng(29), (512, 8))
    p, _ = _empty_flat_pair(int_data(np.random.default_rng(1), (4, 8)))
    e0 = p.epoch
    lc.enable_tombstones(p)
    assert p.epoch == e0 and not bool(p.deleted.any())
    p = ivf_flat.extend(p, t(X))              # bulk path (size was 0)
    assert p.deleted is not None and p.deleted.shape == p.indices.shape
    assert p.n_deleted == 0


def test_sharded_and_foreign_indexes_raise():
    _, p, _ = _flat_pair(16, n_rows=512, dim=8, n_lists=4)
    with pytest.raises(LogicError, match="sharding slice"):
        lc.delete(p, [1], mesh=object())
    with pytest.raises(LogicError, match="sharding slice"):
        lc.compact(p, mesh=object())
    with pytest.raises(LogicError, match="ivf_flat/ivf_pq"):
        lc.delete(object(), [1])
    with pytest.raises(LogicError, match=">= 0"):
        lc.delete(p, [4, -2])
    assert p.n_deleted == 0


# ---------------------------------------------------------------------------
# Upsert


def test_upsert_single_bump_and_no_duplicate_ids():
    X, p, j = _flat_pair(20)
    newv = X[40:44] + 3.0
    e0 = p.epoch
    p = lc.upsert(p, t(newv), np.arange(40, 44))
    j = jlc.upsert(j, newv, np.arange(40, 44))
    assert p.epoch == e0 + 1                  # one bump for the pair
    _same_flat(p, j)
    np.testing.assert_array_equal(n(p.deleted), n(j.deleted))
    sp = ivf_flat.SearchParams(n_probes=8, engine="scan")
    d, i = ivf_flat.search(sp, p, t(newv), 1)
    np.testing.assert_array_equal(n(i)[:, 0], np.arange(40, 44))
    assert (n(d)[:, 0] == 0).all()
    _, i2 = ivf_flat.search(sp, p, t(X[40:44]), 10)
    for row in n(i2):
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)


def test_pure_insert_via_upsert(rng):
    a = _pq_arrays(rng)
    p, j = _pq_pair(a)
    newv = int_data(rng, (4, DIM), hi=4)
    ids = np.array([9000, 9001, 9002, 9003])
    p = lc.upsert(p, t(newv), ids)
    j = jlc.upsert(j, newv, ids)
    assert p.n_deleted == 0 and p.epoch == j.epoch == 1
    for field in ("pq_codes", "indices", "list_sizes"):
        np.testing.assert_array_equal(n(getattr(p, field)),
                                      n(getattr(j, field)), err_msg=field)
    sp = dict(n_probes=N_LISTS, engine="scan")
    _, i = ivf_pq.search(ivf_pq.SearchParams(**sp), p, t(newv), 3)
    _, ji = jpq.search(jpq.SearchParams(**sp), j, newv, 3)
    np.testing.assert_array_equal(n(i), n(ji))


def test_upsert_duplicate_ids_rejected():
    _, p, _ = _flat_pair(24, n_rows=512, dim=8, n_lists=4)
    with pytest.raises(LogicError, match="unique"):
        lc.upsert(p, np.zeros((2, 8), np.float32), np.array([7, 7]))
    assert p.deleted is None and p.n_deleted == 0


def test_upsert_invalid_input_leaves_index_untouched():
    """Every check precedes the tombstone write: a rejected upsert leaves
    no rows deleted under an unchanged epoch."""
    _, p, j = _flat_pair(26, n_rows=512, dim=8, n_lists=4)
    e0 = p.epoch
    with pytest.raises(LogicError, match="dim"):
        lc.upsert(p, np.zeros((2, 16), np.float32), np.array([1, 2]))
    with pytest.raises(Exception, match="dim"):
        jlc.upsert(j, np.zeros((2, 16), np.float32), np.array([1, 2]))
    with pytest.raises(LogicError, match="one id per row"):
        lc.upsert(p, np.zeros((3, 8), np.float32), np.array([1, 2]))
    assert p.epoch == e0 and p.n_deleted == 0 and p.deleted is None


def test_default_ids_after_delete_do_not_reuse_live_ids(rng):
    a = _pq_arrays(rng)
    p, j = _pq_pair(a)
    lc.delete(p, np.arange(64))
    jlc.delete(j, np.arange(64))
    newv = int_data(rng, (8, DIM), hi=4)
    p = ivf_pq.extend(p, t(newv))
    j = jpq.extend(j, newv)
    ids = n(p.indices).ravel()
    ids = ids[ids >= 0]
    assert len(ids) == len(set(ids.tolist()))
    np.testing.assert_array_equal(n(p.indices), n(j.indices))


# ---------------------------------------------------------------------------
# Compaction


def test_reclaim_matches_reference_and_preserves_results():
    X, p, j = _flat_pair(50)
    dels = np.arange(0, 1024, 9)
    lc.delete(p, dels)
    jlc.delete(j, dels)
    Q = int_data(np.random.default_rng(51), (32, 16))
    results = {}
    for engine in ("scan", "bucketed"):
        sp = ivf_flat.SearchParams(n_probes=8, engine=engine)
        results[engine] = ivf_flat.search(sp, p, t(Q), 10)
    new, rep = lc.compact(p)
    jnew, jrep = jlc.compact(j)
    _same_flat(new, jnew)
    assert rep.reclaimed_slots == jrep.reclaimed_slots == dels.size
    assert (rep.cap_before, rep.cap_after, rep.live_rows) == (
        jrep.cap_before, jrep.cap_after, jrep.live_rows)
    assert new.deleted is None and new.n_deleted == 0
    assert new.epoch == p.epoch + 1 and rep.epoch == new.epoch
    assert new.data.shape == p.data.shape     # keep-capacity default
    for engine, (d1, i1) in results.items():
        sp = ivf_flat.SearchParams(n_probes=8, engine=engine)
        d2, i2 = ivf_flat.search(sp, new, t(Q), 10)
        np.testing.assert_array_equal(n(i1), n(i2))
        np.testing.assert_array_equal(n(d1), n(d2))


def test_compact_is_copy_on_write():
    _, p, _ = _flat_pair(52, n_rows=512, dim=8, n_lists=4)
    lc.delete(p, np.arange(0, 512, 3))
    before = {f: getattr(p, f).clone() for f in
              ("centers", "data", "indices", "list_sizes", "deleted")}
    e0, nd = p.epoch, p.n_deleted
    new, _ = lc.compact(p, lc.CompactionPolicy(shrink_capacity=True,
                                               drift_threshold=0.01))
    assert new is not p
    for f, v in before.items():
        assert torch.equal(getattr(p, f), v), f
    assert p.epoch == e0 and p.n_deleted == nd


def test_shrink_capacity_matches_reference():
    X, p, j = _flat_pair(52)
    lc.delete(p, np.arange(0, 1024, 2))
    jlc.delete(j, np.arange(0, 1024, 2))
    new, rep = lc.compact(p, lc.CompactionPolicy(shrink_capacity=True))
    jnew, jrep = jlc.compact(j, jlc.CompactionPolicy(shrink_capacity=True))
    _same_flat(new, jnew)
    assert rep.cap_after == jrep.cap_after < rep.cap_before
    assert rep.cap_after == int(n(new.list_sizes).max())
    assert new.size == 512
    surv = np.arange(1, 1024, 2)
    sp = ivf_flat.SearchParams(n_probes=8, engine="scan")
    d, i = ivf_flat.search(sp, new, t(X[surv[:16]]), 1)
    assert (n(d)[:, 0] == 0).all()
    np.testing.assert_array_equal(n(new.indices)[n(new.indices) >= 0].size,
                                  512)


@pytest.mark.parametrize("shrink", [False, True])
def test_pq_reclaim_matches_reference_and_preserves_results(rng, shrink):
    a = _pq_arrays(rng)
    p, j = _pq_pair(a)
    dels = np.arange(0, 600, 5)
    lc.delete(p, dels)
    jlc.delete(j, dels)
    Q = int_data(rng, (16, DIM), hi=4)
    results = {}
    for engine in ("scan", "bucketed"):
        sp = ivf_pq.SearchParams(n_probes=N_LISTS, engine=engine)
        results[engine] = ivf_pq.search(sp, p, t(Q), 10)
    p.reconstructed()
    pol = dict(shrink_capacity=shrink, split_above=2.0)   # split: ignored
    new, rep = lc.compact(p, lc.CompactionPolicy(**pol))
    jnew, jrep = jlc.compact(j, jlc.CompactionPolicy(**pol))
    for field in ("pq_codes", "indices", "list_sizes"):
        np.testing.assert_array_equal(n(getattr(new, field)),
                                      n(getattr(jnew, field)), err_msg=field)
    assert new._recon is None and new._scan_ops is None
    assert p._recon is not None               # the input keeps its caches
    assert (rep.cap_after, rep.lists_split) == (jrep.cap_after, 0)
    for engine, (d1, i1) in results.items():
        sp = ivf_pq.SearchParams(n_probes=N_LISTS, engine=engine)
        d2, i2 = ivf_pq.search(sp, new, t(Q), 10)
        np.testing.assert_array_equal(n(i1), n(i2))
        np.testing.assert_array_equal(n(d1), n(d2))


# Four integer blobs 100 apart (dim 8): no row is near a tie with another
# list, before or after the model pass.
_BLOB_CENTERS = np.zeros((4, 8), np.float32)
_BLOB_CENTERS[1:, 1:4] = 100 * np.eye(3, dtype=np.float32)


def _blob_pair(rng):
    base = np.concatenate([c + rng.integers(-2, 3, (256, 8))
                           for c in _BLOB_CENTERS]).astype(np.float32)
    p, j = _empty_flat_pair(_BLOB_CENTERS)
    p = ivf_flat.extend(p, t(base))
    j = jivf.extend(j, base)
    _same_flat(p, j)
    return base, p, j


def _extend_both(p, j, rows):
    p = ivf_flat.extend(p, t(rows))
    j = jivf.extend(j, rows)
    _same_flat(p, j)
    return p, j


def test_split_rebalances_hot_list(rng):
    """List 0 gets two far sub-blobs along axis 0 (1024 rows at -40, 1280
    at +40): the median of the principal projection falls between the
    base rows and the +40 blob, so the cut is clean in both packages."""
    base, p, j = _blob_pair(rng)
    e0 = np.eye(8, dtype=np.float32)[0]
    hot = np.concatenate([
        -40 * e0 + rng.integers(-1, 2, (1024, 8)),
        40 * e0 + rng.integers(-1, 2, (1280, 8))]).astype(np.float32)
    p, j = _extend_both(p, j, hot)
    before = int(n(p.list_sizes).max())
    pol = dict(split_above=2.0, shrink_capacity=True)
    new, rep = lc.compact(p, lc.CompactionPolicy(**pol))
    jnew, jrep = jlc.compact(j, jlc.CompactionPolicy(**pol))
    _same_flat(new, jnew)
    assert rep.lists_split == jrep.lists_split == 1
    assert rep.n_lists_after == jrep.n_lists_after == 5
    assert int(n(new.list_sizes).max()) < before
    allrows = np.concatenate([base, hot])
    sp = ivf_flat.SearchParams(n_probes=5, engine="scan")
    _, i = ivf_flat.search(sp, new, t(allrows[1000:1064]), 1)
    np.testing.assert_array_equal(n(i)[:, 0], np.arange(1000, 1064))


def test_recluster_snaps_drifted_center(rng):
    """512 rows at -80 on axis 0 still land in list 0 (the other centers
    are over 100 away), and pull its live mean 53 from its center, past
    0.3 x the median nearest-center gap (100, the mean of the two middle
    values of four)."""
    base, p, j = _blob_pair(rng)
    drifted = (-80 * np.eye(8, dtype=np.float32)[0]
               + rng.integers(-1, 2, (512, 8))).astype(np.float32)
    p, j = _extend_both(p, j, drifted)
    new, rep = lc.compact(p, lc.CompactionPolicy(drift_threshold=0.3))
    jnew, jrep = jlc.compact(j, jlc.CompactionPolicy(drift_threshold=0.3))
    _same_flat(new, jnew)
    assert rep.lists_reclustered == jrep.lists_reclustered == 1
    assert float(n(new.centers)[0, 0]) < -50
    sp = ivf_flat.SearchParams(n_probes=4, engine="scan")
    allrows = np.concatenate([base, drifted])
    _, i = ivf_flat.search(sp, new, t(allrows[1000:1064]), 1)
    np.testing.assert_array_equal(n(i)[:, 0], np.arange(1000, 1064))


def test_noop_when_nothing_to_do():
    _, p, _ = _flat_pair(59, n_rows=512, dim=8, n_lists=4)
    same, rep = lc.compact(p)
    assert rep is None and same is p


@pytest.mark.parametrize("count", [1, 4, 7, 10])
def test_median_matches_jnp_median(rng, count):
    """jnp.median averages the two middle values of an even count, where
    torch.median takes the lower one."""
    x = rng.standard_normal(count).astype(np.float32)
    np.testing.assert_array_equal(n(compact_mod._median(t(x))),
                                  n(jnp.median(jnp.asarray(x))))


def test_policy_checks_match_reference():
    for bad in (dict(split_above=1.0), dict(drift_threshold=0.0)):
        with pytest.raises(LogicError):
            lc.CompactionPolicy(**bad)
        with pytest.raises(Exception):
            jlc.CompactionPolicy(**bad)
