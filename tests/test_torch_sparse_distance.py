"""raft_tpu_torch.sparse.distance against raft_tpu.sparse.distance.

Each engine is forced in both packages by patching the same budget
constants (``_DENSE_BYTES``, ``_XDENSE_BYTES``, ``_STAGE_TILE_BYTES``,
``_EW_CHUNK_BYTES``), as the reference's own tests force them, and the
port's ``_route`` must name the engine forced. Every metric runs on every
engine that takes it: the dense route all 20, the x-dense gram engine the
9 gram metrics, the support-gather semiring the 10 unexpanded ones, the
block-packed scan all but Haversine (which always densifies). Both
``pairwise_distance`` and ``knn_blocked`` (k <= n and k > n) are held:
distances within rtol 1e-4 / atol 1e-4 of the reference's, ids bit for
bit except at near-ties (a differing id must sit at the reference's
distance for that slot, within the tolerance, by the reference's own
pairwise matrix).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.distance.distance_types import DistanceType
from raft_tpu.sparse import distance as jd
from raft_tpu.sparse.types import CSR as JCSR
from raft_tpu.sparse.types import csr_from_dense as j_csr_from_dense
from raft_tpu_torch.sparse import distance as td
from raft_tpu_torch.sparse.types import CSR as TCSR
from raft_tpu_torch.sparse.types import csr_from_dense
from test_torch_common import n

TOL = dict(rtol=1e-4, atol=1e-4)

# (name, data spec) of every supported metric; specs as the reference's
# tests give them.
METRICS = [
    ("L2Expanded", {}), ("L2SqrtExpanded", {}), ("L2Unexpanded", {}),
    ("L2SqrtUnexpanded", {}), ("InnerProduct", {}),
    ("CosineExpanded", {"nonzero": True}),
    ("CorrelationExpanded", {"nonzero": True}),
    ("HellingerExpanded", {"nonneg": True}),
    ("JaccardExpanded", {"nonneg": True}),
    ("DiceExpanded", {"nonneg": True}),
    ("RusselRaoExpanded", {"binary": True}),
    ("L1", {}), ("Linf", {}), ("Canberra", {}),
    ("LpUnexpanded", {"metric_arg": 3.0}),
    ("HammingUnexpanded", {"binary": True}),
    ("BrayCurtis", {}), ("JensenShannon", {"nonneg": True}),
    ("KLDivergence", {"nonneg": True, "kl": True}),
    ("Haversine", {"latlon": True}),
]
GRAM = [m for m in METRICS
        if DistanceType[m[0]] in td._GRAM_METRICS]
EW = [m for m in METRICS if DistanceType[m[0]] in td._EW_METRICS]
ENGINE_METRICS = {
    "dense": METRICS,
    "xdense": GRAM,
    "semiring": EW,
    "blocked": [m for m in METRICS if m[0] != "Haversine"],
}
CASES = [(engine, name, spec) for engine, ms in ENGINE_METRICS.items()
         for name, spec in ms]
IDS = [f"{e}-{name}" for e, name, _ in CASES]


def _force(monkeypatch, engine):
    """Patch the budgets of both packages so ``engine`` is taken."""
    patches = {"dense": {},
               "xdense": {"_DENSE_BYTES": 0},
               "semiring": {"_DENSE_BYTES": 0},
               "blocked": {"_DENSE_BYTES": 0, "_XDENSE_BYTES": 0,
                           "_EW_CHUNK_BYTES": 1,
                           "_STAGE_TILE_BYTES": 64 * 4 * 257}}[engine]
    for mod in (jd, td):
        for name, value in patches.items():
            monkeypatch.setattr(mod, name, value)


def _arrays(rng, rows, d, nnz_row, spec, dup):
    """CSR arrays with ``nnz_row`` entries a row (columns drawn with
    replacement when ``dup``, so duplicate coordinates occur), one empty
    row, and values shaped by ``spec``."""
    if dup:
        cols = rng.integers(0, d, (rows, nnz_row))
    else:
        cols = np.sort(np.argsort(rng.random((rows, d)), axis=1)[:, :nnz_row],
                       axis=1)
    vals = rng.standard_normal((rows, nnz_row)).astype(np.float32)
    if spec.get("nonneg") or spec.get("binary"):
        vals = np.abs(vals) + 0.05
    if spec.get("binary"):
        vals = (vals > 0.5).astype(np.float32)
    counts = np.full(rows, nnz_row)
    if not spec.get("nonzero") and not spec.get("kl"):
        counts[rows // 2] = 0
    keep = np.arange(nnz_row)[None, :] < counts[:, None]
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return indptr, cols[keep].astype(np.int32), vals[keep]


def _pair(indptr, cols, vals, shape):
    return (JCSR(jnp.asarray(indptr), jnp.asarray(cols), jnp.asarray(vals),
                 shape),
            TCSR(torch.as_tensor(indptr), torch.as_tensor(cols),
                 torch.as_tensor(vals), shape))


def _data(engine, spec, seed=0):
    """(reference, port) CSR pairs for x (queries) and y (database) at a
    shape the engine takes: 40 x 150 rows over 256 columns (the x-dense
    kNN needs 128 or more database rows), over 2048 columns with 12
    entries a row and duplicates for the semiring; 2 (lat, lon) columns
    for Haversine."""
    rng = np.random.default_rng(seed)
    if spec.get("latlon"):
        a = rng.uniform(-1.5, 1.5, (40, 2)).astype(np.float32)
        b = rng.uniform(-1.5, 1.5, (150, 2)).astype(np.float32)
        return ((j_csr_from_dense(a), csr_from_dense(a, device="cpu")),
                (j_csr_from_dense(b), csr_from_dense(b, device="cpu")))
    m, nrows = (37, 29) if engine == "semiring" else (40, 150)
    d, nnz_row = (2048, 12) if engine == "semiring" else (256, 20)
    dup = engine == "semiring"
    x = _pair(*_arrays(rng, m, d, nnz_row, spec, dup), (m, d))
    y = _pair(*_arrays(rng, nrows, d, nnz_row, spec, dup), (nrows, d))
    if spec.get("kl") and engine != "semiring":
        # KL's terms are finite anyway (log 0 is taken as 0), but the
        # reference's tests give y full support; the semiring needs sparse
        # rows, so there y keeps its own.
        yd = np.asarray(y[0].to_dense()) + 0.01
        y = (j_csr_from_dense(yd), csr_from_dense(yd, device="cpu"))
    return x, y


def _near_tie_ids(what, got_d, got_i, want_d, want_i, full, select_min):
    """Distances within TOL; a differing id must be at the reference's
    distance for its slot by ``full`` (the reference's pairwise
    matrix)."""
    got_d, got_i, want_d, want_i = map(n, (got_d, got_i, want_d, want_i))
    np.testing.assert_allclose(got_d, want_d, err_msg=what, **TOL)
    rows, cols = np.nonzero(got_i != want_i)
    for r, c in zip(rows, cols):
        gid = got_i[r, c]
        assert gid >= 0, what
        np.testing.assert_allclose(full[r, gid], want_d[r, c], err_msg=what,
                                   **TOL)


@pytest.mark.parametrize("engine,name,spec", CASES, ids=IDS)
def test_pairwise_distance(engine, name, spec, monkeypatch):
    _force(monkeypatch, engine)
    metric = DistanceType[name]
    (jx, tx), (jy, ty) = _data(engine, spec)
    arg = spec.get("metric_arg", 2.0)
    assert td._route(tx, ty, metric, knn=False) == engine
    got = td.pairwise_distance(tx, ty, metric=metric, metric_arg=arg)
    want = jd.pairwise_distance(jx, jy, metric=metric, metric_arg=arg)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(n(got), n(want), **TOL)


@pytest.mark.parametrize("k", [7, 200])
@pytest.mark.parametrize("engine,name,spec", CASES, ids=IDS)
def test_knn_blocked(engine, name, spec, k, monkeypatch):
    """k <= n and k > n (clamped to the database's rows)."""
    _force(monkeypatch, engine)
    metric = DistanceType[name]
    (jx, tx), (jy, ty) = _data(engine, spec)
    arg = spec.get("metric_arg", 2.0)
    assert td._route(tx, ty, metric, knn=True) == engine
    gd, gi = td.knn_blocked(ty, tx, k, metric=metric, metric_arg=arg)
    wd, wi = jd.knn_blocked(jy, jx, k, metric=metric, metric_arg=arg)
    assert tuple(gi.shape) == tuple(wi.shape) == (tx.shape[0],
                                                  min(k, ty.shape[0]))
    assert gi.dtype == torch.int32
    full = n(jd.pairwise_distance(jx, jy, metric=metric, metric_arg=arg))
    _near_tie_ids(name, gd, gi, wd, wi, full,
                  td.value_form_select_min(metric))


def test_route_never_crosses_families(monkeypatch):
    """Haversine densifies whatever the budgets; the unexpanded metrics
    never take the gram engine, the gram metrics never the semiring."""
    for mod in (jd, td):
        monkeypatch.setattr(mod, "_DENSE_BYTES", 0)
    (_, tx), (_, ty) = _data("semiring", {})
    for name, _ in METRICS:
        metric = DistanceType[name]
        for knn in (False, True):
            route = td._route(tx, ty, metric, knn)
            if metric == DistanceType.Haversine:
                assert route == "dense"
            elif metric in td._EW_METRICS:
                assert route in ("semiring", "blocked"), name
            else:
                assert route in ("xdense", "blocked"), name


def test_skewed_density_groups(monkeypatch):
    """One dense row block splits the blocks into several nnz groups; the
    pack, the groups and both entry points equal the reference's."""
    for mod in (jd, td):
        monkeypatch.setattr(mod, "_DENSE_BYTES", 0)
        monkeypatch.setattr(mod, "_XDENSE_BYTES", 0)
        monkeypatch.setattr(mod, "_STAGE_TILE_BYTES", 64 * 4 * 40)
    rng = np.random.default_rng(4)
    d, m = 400, 96
    a = np.zeros((m, d), np.float32)
    for i in range(m):
        nnz = 160 if i < 8 else 4
        a[i, rng.choice(d, size=nnz, replace=False)] = rng.normal(size=nnz)
    ja, ta = j_csr_from_dense(a), csr_from_dense(a, device="cpu")
    b = td._pick_block(m, d, False)
    assert b == jd._pick_block(m, d, False)
    (jpack, jnnz), (tpack, tnnz) = jd._block_pad_csr(ja, b), \
        td._block_pad_csr(ta, b)
    np.testing.assert_array_equal(tnnz, jnnz)
    for g, w in zip(tpack, jpack):
        np.testing.assert_array_equal(n(g), n(w))
    groups = td._nnz_groups(tnnz)
    assert len(groups) > 1
    assert [c for c, _ in groups] == [c for c, _ in jd._nnz_groups(jnnz)]
    assert td._route(ta, ta, DistanceType.L2Expanded, False) == "blocked"
    got = td.pairwise_distance(ta, ta, metric="sqeuclidean")
    np.testing.assert_allclose(
        n(got), n(jd.pairwise_distance(ja, ja, metric="sqeuclidean")), **TOL)
    gd, gi = td.knn_blocked(ta, ta, 5)
    wd, wi = jd.knn_blocked(ja, ja, 5)
    full = n(jd.pairwise_distance(ja, ja, metric=DistanceType.L2Expanded))
    _near_tie_ids("skewed", gd, gi, wd, wi, full, True)


def test_semiring_row_pack_coalesces_like_the_reference():
    """Duplicate coordinates sum, coalesced zeros become padding: the row
    pack equals the reference's."""
    rng = np.random.default_rng(5)
    indptr, cols, vals = _arrays(rng, 20, 64, 10, {}, dup=True)
    vals[::7] = 0.0
    jx, tx = _pair(indptr, cols, vals, (20, 64))
    for got, want in zip(td._row_pad_csr(tx, 8), jd._row_pad_csr(jx, 8)):
        np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.parametrize("metric", ["CosineExpanded", "CorrelationExpanded"])
def test_knn_cosine_correlation_polarity(metric, monkeypatch):
    """Cosine and correlation kNN return the nearest rows (their values
    are distances), as the reference's blocked engine does."""
    metric = DistanceType[metric]
    for mod in (jd, td):
        monkeypatch.setattr(mod, "_DENSE_BYTES", 0)
    rng = np.random.default_rng(6)
    a = rng.standard_normal((300, 700)).astype(np.float32)
    a[np.abs(a) < 1.2] = 0
    q = rng.standard_normal((37, 700)).astype(np.float32)
    q[np.abs(q) < 1.2] = 0
    q[:, 0] = a[:, 0] = 1.0
    ta, tq = csr_from_dense(a, device="cpu"), csr_from_dense(q, device="cpu")
    ja, jq = j_csr_from_dense(a), j_csr_from_dense(q)
    gd, gi = td.knn_blocked(ta, tq, 5, metric=metric)
    wd, wi = jd.knn_blocked(ja, jq, 5, metric=metric)
    full = n(td.pairwise_distance(tq, ta, metric=metric))
    np.testing.assert_allclose(n(gd), np.sort(full, axis=1)[:, :5], **TOL)
    _near_tie_ids(metric, gd, gi, wd, wi,
                  n(jd.pairwise_distance(jq, ja, metric=metric)), True)


def test_knn_k_exceeds_rows(monkeypatch):
    for mod in (jd, td):
        monkeypatch.setattr(mod, "_DENSE_BYTES", 0)
    rng = np.random.default_rng(7)
    a = rng.standard_normal((12, 20)).astype(np.float32)
    a[np.abs(a) < 1.0] = 0
    q = rng.standard_normal((5, 20)).astype(np.float32)
    gd, gi = td.knn_blocked(csr_from_dense(a, device="cpu"),
                            csr_from_dense(q, device="cpu"), 50)
    wd, wi = jd.knn_blocked(j_csr_from_dense(a), j_csr_from_dense(q), 50)
    assert tuple(gi.shape) == (5, 12) and bool((gi >= 0).all())
    np.testing.assert_array_equal(n(gi), n(wi))
    np.testing.assert_allclose(n(gd), n(wd), **TOL)


def test_high_dim_scipy_parity(monkeypatch):
    """50,000 columns at 50 entries a row, the dense route off: L2 by the
    x-dense engine and L1 by the semiring, against scipy's cdist."""
    from scipy.spatial.distance import cdist

    for mod in (jd, td):
        monkeypatch.setattr(mod, "_DENSE_BYTES", 1)
    rng = np.random.default_rng(8)
    d, m, nrows = 50_000, 24, 20
    a = np.zeros((m, d), np.float32)
    b = np.zeros((nrows, d), np.float32)
    for mat in (a, b):
        for i in range(mat.shape[0]):
            mat[i, rng.choice(d, size=50, replace=False)] = rng.normal(
                size=50)
    ta, tb = csr_from_dense(a, device="cpu"), csr_from_dense(b, device="cpu")
    assert td._route(ta, tb, DistanceType.L2SqrtUnexpanded, False) \
        == "semiring"
    np.testing.assert_allclose(n(td.pairwise_distance(ta, tb, "euclidean")),
                               cdist(a, b, "euclidean"), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(n(td.pairwise_distance(ta, tb, "l1")),
                               cdist(a, b, "cityblock"), rtol=1e-3,
                               atol=1e-3)
    got = td.pairwise_distance(ta, tb, DistanceType.L2SqrtExpanded)
    np.testing.assert_allclose(n(got), cdist(a, b, "euclidean"), rtol=1e-3,
                               atol=1e-3)

