"""IVF-PQ of raft_tpu_torch against raft_tpu's.

Search parity runs both packages on the SAME index. Most cases use an
index made directly from small integer arrays (centers, codebooks,
identity rotation, random codes), so every LUT entry, codeword, bf16
product and sum is exact and ids and distances must agree bit for bit on
all four engines, each selected as the reference selects it on the CPU:

* compressed (B4): ``engine="bucketed"`` with ``bucket_cap=0``;
* recon (B3): ``index.reconstructed()`` first, then ``"bucketed"``;
* decode scan (B3): PER_CLUSTER codebooks (which the compressed tier does
  not take) with the recon auto budget set to 0, or a direct call;
* LUT scan: ``engine="scan"``, over each lut / internal dtype. The u8 LUT
  scales its terms by non-integer steps, whose f32 sum the reference's
  compiled reduction takes in an order of its own: its distances agree to
  1e-5 relative and its ids wherever no near-tie falls at the k-th slot.

``build`` end to end is held by recall@10 against exact kNN: at least the
reference's less 0.02 (the two draw different random numbers on the way).
``extend`` must give the reference's codes, ids, sizes and capacity.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance.distance_types import DistanceType as JDistance
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.neighbors.refine import refine
from test_torch_common import blobs, int_data, n, recall, t

# raft_tpu.neighbors re-exports the function under the module's name.
jrefine = importlib.import_module("raft_tpu.neighbors.refine")

RECALL_MARGIN = 0.02
DIM, PQ_DIM, N_LISTS, CAP = 16, 8, 8, 96


def _arrays(rng, bits=8, per_cluster=False):
    """Integer model arrays of a small index (identity rotation)."""
    B, L = 1 << bits, DIM // PQ_DIM
    books_lead = N_LISTS if per_cluster else PQ_DIM
    sizes = rng.integers(0, CAP + 1, N_LISTS).astype(np.int32)
    sizes[0], sizes[1] = 0, 3                     # empty and starved lists
    indices = np.full((N_LISTS, CAP), -1, np.int32)
    base = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    for l in range(N_LISTS):
        indices[l, :sizes[l]] = base[l] + np.arange(sizes[l])
    codes = rng.integers(0, B, (N_LISTS, CAP, PQ_DIM)).astype(np.int32)
    return dict(
        centers=int_data(rng, (N_LISTS, DIM), hi=4),
        rotation_matrix=np.eye(DIM, dtype=np.float32),
        pq_centers=rng.integers(-2, 3, (books_lead, B, L)).astype(np.float32),
        pq_codes=n(ivf_pq.pack_codes(t(codes), bits)),
        indices=indices, list_sizes=sizes, pq_bits=bits, pq_dim=PQ_DIM)


def _pair(rng, metric="L2Expanded", bits=8, per_cluster=False,
          deleted=None):
    a = _arrays(rng, bits, per_cluster)
    kind = 1 if per_cluster else 0
    j = jpq.Index(metric=JDistance[metric],
                  codebook_kind=jpq.CodebookGen(kind),
                  **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                     for k, v in a.items()},
                  deleted=None if deleted is None else jnp.asarray(deleted),
                  n_deleted=0 if deleted is None else int(deleted.sum()))
    p = ivf_pq.index_from_numpy(**a, codebook_kind=kind,
                                metric=JDistance[metric].value,
                                deleted=deleted, device="cpu")
    return p, j


_Q = int_data(np.random.default_rng(9), (30, DIM), hi=4)


def _search_both(p, j, k, sp, jsp=None):
    d, i = ivf_pq.search(ivf_pq.SearchParams(**sp), p, t(_Q), k)
    jd, ji = jpq.search(jpq.SearchParams(**(jsp or sp)), j, _Q, k)
    return d, i, jd, ji


def _assert_same(d, i, jd, ji, rtol=0.0):
    np.testing.assert_array_equal(n(i), n(ji))
    if rtol:
        np.testing.assert_allclose(n(d), n(jd), rtol=rtol)
    else:
        np.testing.assert_array_equal(n(d), n(jd))


METRICS = ["L2Expanded", "L2SqrtExpanded", "InnerProduct"]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("bits", [8, 4])
def test_compressed_tier_bit_identical(rng, metric, bits):
    p, j = _pair(rng, metric, bits)
    d, i, jd, ji = _search_both(p, j, 10, dict(n_probes=4,
                                               engine="bucketed"))
    assert p._scan_ops is not None and p._recon is None
    _assert_same(d, i, jd, ji, rtol=1e-6 if "Sqrt" in metric else 0.0)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("bits", [8, 4])
def test_recon_tier_bit_identical(rng, metric, bits):
    p, j = _pair(rng, metric, bits)
    np.testing.assert_array_equal(n(p.reconstructed().float()),
                                  n(j.reconstructed().astype(jnp.float32)))
    d, i, jd, ji = _search_both(p, j, 10, dict(n_probes=4,
                                               engine="bucketed"))
    assert p._scan_ops is None
    _assert_same(d, i, jd, ji, rtol=1e-6 if "Sqrt" in metric else 0.0)


@pytest.mark.parametrize("metric", ["L2Expanded", "InnerProduct"])
def test_decode_scan_through_search(rng, monkeypatch, metric):
    """PER_CLUSTER books leave the compressed tier; with the recon budget
    at 0 both packages decode on the fly."""
    monkeypatch.setattr(ivf_pq, "_RECON_AUTO_BYTES", 0)
    monkeypatch.setattr(jpq, "_RECON_AUTO_BYTES", 0)
    p, j = _pair(rng, metric, per_cluster=True)
    d, i, jd, ji = _search_both(p, j, 10, dict(n_probes=4,
                                               engine="bucketed",
                                               bucket_cap=12))
    assert p._recon is None
    _assert_same(d, i, jd, ji)


@pytest.mark.parametrize("bits", [8, 4])
def test_decode_scan_direct_equals_recon(rng, bits):
    p, j = _pair(rng, bits=bits)
    probes = ivf_pq._select_clusters(t(_Q), p.centers, 4, False)
    rotq = t(_Q)
    args = (p.pq_codes, p.pq_centers, p.centers_rot(), p.indices,
            p.list_sizes, probes, 10, False, False, 16, PQ_DIM, bits)
    d, i = ivf_pq._bucketed_decode_scan(rotq, *args)
    jd, ji = jpq._bucketed_decode_scan(
        jnp.asarray(_Q), j.pq_codes, j.pq_centers,
        jnp.asarray(n(p.centers_rot())), j.indices, j.list_sizes,
        jnp.asarray(n(probes)), 10, False, False, 16, PQ_DIM, bits, True)
    _assert_same(d, i, jd, ji)
    rd, ri = ivf_pq._bucketed_probe_scan(rotq, p.reconstructed(), p.indices,
                                         p.list_sizes, probes, 10, True,
                                         False, 16)
    np.testing.assert_array_equal(n(ri), n(i))


_DTYPES = [("float32", "float32"), ("float16", "float32"),
           ("bfloat16", "float32"), ("float32", "bfloat16"),
           ("float32", "float16"), ("bfloat16", "bfloat16"),
           ("float16", "float16")]


@pytest.mark.parametrize("metric", ["L2Expanded", "InnerProduct"])
@pytest.mark.parametrize("lut,internal", _DTYPES)
def test_lut_scan_bit_identical(rng, metric, lut, internal):
    p, j = _pair(rng, metric, bits=8)
    sp = dict(n_probes=4, engine="scan", lut_dtype=lut,
              internal_distance_dtype=internal)
    jsp = dict(sp, lut_dtype=getattr(jnp, lut),
               internal_distance_dtype=getattr(jnp, internal))
    d, i, jd, ji = _search_both(p, j, 10, sp, jsp)
    _assert_same(d, i, jd, ji)


@pytest.mark.parametrize("internal", ["float32", "bfloat16"])
def test_lut_scan_u8(rng, internal):
    p, j = _pair(rng, bits=8)
    sp = dict(n_probes=4, engine="scan", lut_dtype="uint8",
              internal_distance_dtype=internal)
    jsp = dict(sp, lut_dtype=jnp.uint8,
               internal_distance_dtype=getattr(jnp, internal))
    d, i, jd, ji = _search_both(p, j, 10, sp, jsp)
    tol = 1e-5 if internal == "float32" else 1e-2
    np.testing.assert_allclose(n(d), n(jd), rtol=tol, atol=tol)
    assert recall(i, ji) >= 0.9


@pytest.mark.parametrize("engine", ["bucketed", "scan"])
def test_search_with_deleted_mask(rng, engine):
    deleted = np.random.default_rng(2).random((N_LISTS, CAP)) < 0.4
    p, j = _pair(rng, deleted=deleted)
    d, i, jd, ji = _search_both(p, j, 10, dict(n_probes=4, engine=engine))
    _assert_same(d, i, jd, ji)
    live = set(n(p.indices)[~deleted & (n(p.indices) >= 0)].tolist())
    assert set(n(i).ravel().tolist()) <= live | {-1}


def test_int8_tables_compressed(rng):
    """int8 codeword tables: same ids where the reference's tables are
    exact (a +-127 entry per row makes the scales 1)."""
    p, j = _pair(rng)
    books = n(p.pq_centers).copy()
    books[:, 0, :], books[:, 128, :] = 127.0, -127.0
    p.pq_centers = t(books)
    j = dataclasses.replace(j, pq_centers=jnp.asarray(books))
    sp = dict(n_probes=4, engine="bucketed", compressed_lut_int8=True)
    d, i, jd, ji = _search_both(p, j, 10, sp)
    _assert_same(d, i, jd, ji)
    assert p._scan_ops_i8 is not None
    assert p._scan_ops_i8[0] is p._scan_ops[0]      # shared codes operand


# ---------------------------------------------------------------------------
# Refine.


@pytest.mark.parametrize("metric", ["L2Expanded", "L2SqrtExpanded",
                                    "InnerProduct", "L1", "CosineExpanded"])
def test_refine_matches_reference(rng, metric):
    X = int_data(rng, (200, 8))
    Q = int_data(rng, (12, 8))
    cand = rng.integers(-1, 200, (12, 30)).astype(np.int32)
    d, i = refine(t(X), t(Q), t(cand), 7, metric=DistanceType[metric])
    jd, ji = jrefine.refine(X, Q, cand, 7, metric=JDistance[metric])
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_allclose(n(d), n(jd), rtol=1e-6)


def _refine_pair(rng):
    p, j = _pair(rng)
    X = int_data(rng, (int(n(p.list_sizes).sum()), DIM), hi=4)
    return p, j, X


@pytest.mark.parametrize("engine", ["bucketed", "scan"])
@pytest.mark.parametrize("ratio", [2, 4])
def test_search_refined_matches_reference(rng, engine, ratio):
    p, j, X = _refine_pair(rng)
    sp = dict(n_probes=4, engine=engine)
    d, i = ivf_pq.search_refined(ivf_pq.SearchParams(**sp), p, t(X),
                                 t(_Q), 10, refine_ratio=ratio)
    jd, ji = jpq.search_refined(jpq.SearchParams(**sp), j, X, _Q, 10,
                                refine_ratio=ratio)
    _assert_same(d, i, jd, ji)
    assert p.__dict__.get("_conc_cache") == j.__dict__.get("_conc_cache")


@pytest.mark.parametrize("min_recall", [0.88, 0.95])
def test_min_recall_matches_reference(rng, min_recall):
    p, j, X = _refine_pair(rng)
    p._source = t(X)
    j._source = jnp.asarray(X)
    sp = dict(n_probes=4, engine="bucketed", min_recall=min_recall)
    d, i, jd, ji = _search_both(p, j, 10, sp)
    _assert_same(d, i, jd, ji)


def test_probe_concentration_matches_reference(rng):
    Q = rng.standard_normal((31, DIM)).astype(np.float32)
    C = rng.standard_normal((9, DIM)).astype(np.float32)
    ours = ivf_pq._probe_concentration(t(Q), t(C))
    ref = float(jpq._probe_concentration(jnp.asarray(Q), jnp.asarray(C)))
    assert abs(ours - ref) <= 1e-6


# ---------------------------------------------------------------------------
# Build and extend.


def test_vq_train_and_encode_match_reference(rng):
    data = int_data(rng, (3, 400, 2), hi=6)
    w = np.ones((3, 400), np.float32)
    w[1, 300:] = 0.0                          # padded rows carry no weight
    ours = ivf_pq._vq_train_batched(t(data), t(w), 16, 5)
    ref = jpq._vq_train_batched(None, jnp.asarray(data), jnp.asarray(w),
                                16, 5)
    np.testing.assert_array_equal(n(ours), n(ref))
    res = np.ascontiguousarray(data.transpose(1, 0, 2))   # (n, J, l)
    np.testing.assert_array_equal(
        n(ivf_pq._encode(t(res), ours)),
        n(jpq._encode(jnp.asarray(res), jnp.asarray(n(ours)))))


@pytest.mark.parametrize("dim", [4, 8, 16, 50, 128])
def test_pq_dim_and_rotation(dim):
    assert ivf_pq._calculate_pq_dim(dim) == jpq._calculate_pq_dim(dim)
    pq_dim = ivf_pq._calculate_pq_dim(dim)
    rot_dim = pq_dim * -(-dim // pq_dim)
    eye = ivf_pq.make_rotation_matrix(None, dim, rot_dim, False, "cpu")
    np.testing.assert_array_equal(
        n(eye), n(jpq.make_rotation_matrix(None, dim, rot_dim, False)))
    g = torch.Generator().manual_seed(0)
    r = ivf_pq.make_rotation_matrix(g, dim, rot_dim, True)
    np.testing.assert_allclose(n(r.T @ r), np.eye(dim), atol=1e-5)


def _model_pair(rng, bits=8, conservative=False):
    """The same empty index on both sides, over an integer model (centers,
    books, identity rotation), and integer rows to add."""
    a = _arrays(rng, bits)
    nbytes = ivf_pq.packed_row_bytes(PQ_DIM, bits)
    a.update(pq_codes=np.zeros((N_LISTS, 1, nbytes), np.uint8),
             indices=np.full((N_LISTS, 1), -1, np.int32),
             list_sizes=np.zeros((N_LISTS,), np.int32))
    j = jpq.Index(metric=JDistance.L2Expanded,
                  codebook_kind=jpq.CodebookGen.PER_SUBSPACE,
                  **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                     for k, v in a.items()},
                  conservative_memory_allocation=conservative)
    p = ivf_pq.index_from_numpy(**a, codebook_kind=0, metric=0,
                                device="cpu")
    p.conservative_memory_allocation = conservative
    return p, j, int_data(rng, (600, DIM), hi=4)


def _same_storage(p, j):
    for field in ("pq_codes", "indices", "list_sizes"):
        np.testing.assert_array_equal(n(getattr(p, field)),
                                      n(getattr(j, field)), err_msg=field)
    assert p.epoch == j.epoch and p._next_id == j._next_id


@pytest.mark.parametrize("bits,conservative", [(8, False), (5, True)])
def test_extend_matches_reference(rng, bits, conservative):
    p, j, X = _model_pair(rng, bits, conservative)
    p = ivf_pq.extend(p, t(X))
    j = jpq.extend(j, X)
    _same_storage(p, j)
    grow = np.repeat(X[:1], 2 * p.pq_codes.shape[1], axis=0)
    p = ivf_pq.extend(p, t(grow))
    j = jpq.extend(j, grow)
    _same_storage(p, j)
    ids = np.arange(5000, 5003, dtype=np.int32)
    p = ivf_pq.extend(p, t(X[:3]), t(ids))
    j = jpq.extend(j, X[:3], ids)
    _same_storage(p, j)


def test_extend_invalidates_caches(rng):
    p, _, X = _model_pair(rng)
    p = ivf_pq.extend(p, t(X))
    p.compressed_scan_operands()
    p.reconstructed()
    p.__dict__["_auto_cap_cache"] = {(1, 1): 8}
    p = ivf_pq.extend(p, t(X[:10]))
    assert p._scan_ops is None and p._recon is None
    assert "_auto_cap_cache" not in p.__dict__


_BUILD = {}


def _blobs_case():
    if not _BUILD:
        rng = np.random.default_rng(2)
        X = blobs(rng, 2000, DIM, n_blobs=20, std=2.0)
        Q = X[:80] + rng.standard_normal((80, DIM)).astype(np.float32)
        _, truth = jbf.knn(X, Q, 10)
        _BUILD.update(X=X, Q=Q, truth=truth)
    return _BUILD["X"], _BUILD["Q"], _BUILD["truth"]


@pytest.mark.parametrize("kw", [dict(), dict(pq_bits=4),
                                dict(codebook_kind="PER_CLUSTER",
                                     opq_iters=1)])
def test_build_recall_within_reference(kw):
    X, Q, truth = _blobs_case()
    params = dict(n_lists=16, kmeans_n_iters=6, pq_dim=PQ_DIM, **kw)
    jkw = dict(params)
    if "codebook_kind" in kw:
        params["codebook_kind"] = ivf_pq.CodebookGen[kw["codebook_kind"]]
        jkw["codebook_kind"] = jpq.CodebookGen[kw["codebook_kind"]]
    idx = ivf_pq.build(ivf_pq.IndexParams(**params), t(X))
    jidx = jpq.build(jpq.IndexParams(**jkw), X)
    assert idx.size == jidx.size == X.shape[0]
    assert sorted(n(idx.indices)[n(idx.indices) >= 0].tolist()) == list(
        range(X.shape[0]))
    _, ji = jpq.search(jpq.SearchParams(n_probes=6, engine="scan"), jidx, Q,
                       10)
    for engine in ("scan", "bucketed"):
        _, i = ivf_pq.search(ivf_pq.SearchParams(n_probes=6, engine=engine),
                             idx, t(Q), 10)
        assert recall(i, truth) >= recall(ji, truth) - RECALL_MARGIN
    rot = idx.rotation_matrix
    np.testing.assert_allclose(n(rot @ rot.T), np.eye(rot.shape[0]),
                               atol=1e-4)
    assert idx._source is not None


# ---------------------------------------------------------------------------
# Gates and checks.


def test_compressed_gate_is_the_reference_with_cuda():
    args = (True, True, 10, 2048, 64, 128, 1000, 32, 64)
    for dev in ("cpu", "cuda"):
        assert ivf_pq._compressed_tier_ok("bucketed", *args,
                                          torch.device(dev))
        assert not ivf_pq._compressed_tier_ok("scan", *args,
                                              torch.device(dev))
    assert ivf_pq._compressed_tier_ok("auto", *args, torch.device("cuda"))
    assert not ivf_pq._compressed_tier_ok("auto", *args,
                                          torch.device("cpu"))
    low = args[:-3] + (10, 32, 64)                 # load 5 < 8
    assert not ivf_pq._compressed_tier_ok("auto", *low, torch.device("cuda"))
    big = args[:3] + (1 << 20,) + args[4:]         # list block too large
    assert not ivf_pq._compressed_tier_ok("bucketed", *big,
                                          torch.device("cuda"))
    assert jpq._compressed_tier_ok("bucketed", *args)


def test_search_dtype_and_shape_checks(rng):
    p, _ = _pair(rng)
    with pytest.raises(LogicError):
        ivf_pq.search(ivf_pq.SearchParams(lut_dtype="int32"), p, t(_Q), 5)
    with pytest.raises(LogicError):
        ivf_pq.search(ivf_pq.SearchParams(internal_distance_dtype="uint8"),
                      p, t(_Q), 5)
    with pytest.raises(LogicError):
        ivf_pq.search(ivf_pq.SearchParams(), p, t(_Q[:, :4]), 5)
    assert not ivf_pq._compressed_supported(_pair(rng, per_cluster=True)[0])
