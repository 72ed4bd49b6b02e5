"""Every pairwise metric of raft_tpu_torch against raft_tpu's.

``distance`` / ``pairwise_distance`` and ``brute_force.knn`` answer all 20
metrics of the reference. On integer-valued data the metrics built from
sums, products, maxima and one division are exact in f32 whatever the
order of summation: those must agree bit for bit (``EXACT``). The rest
carry a square root, a power, a logarithm, a trigonometric function or a
sum of non-integer terms, whose last bits differ between XLA and torch:
they agree within ``GAUSS_TOL`` (rtol 1e-5, atol 1e-4), as do all metrics
on Gaussian data. kNN ids agree bit for bit, ties included (lowest id
first), where the distances do; where they agree within a tolerance, two
ids may trade places only at a near-tie within it (:func:`_same_knn`).
Hellinger, Jensen-Shannon and KL divergence take non-negative rows,
Haversine 2-column (lat, lon) rows.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance import distance_types as jtypes
from raft_tpu.distance.distance_types import DistanceType as JDistance
from raft_tpu.distance.fused_l2_nn import fused_l2_nn_argmin as jargmin
from raft_tpu.distance.fused_l2_nn import fused_l2_nn_min_reduce as jfused
from raft_tpu.distance.pairwise import distance as jdistance
from raft_tpu.distance.pairwise import pairwise_distance as jpairwise
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu_torch.distance import distance_types as types
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.fused_l2_nn import (fused_l2_nn_argmin,
                                                 fused_l2_nn_min_reduce)
from raft_tpu_torch.distance.pairwise import distance, pairwise_distance
from raft_tpu_torch.neighbors import brute_force
from test_torch_common import GAUSS_TOL, gauss, int_data, n, t

pairwise_mod = importlib.import_module("raft_tpu_torch.distance.pairwise")

METRICS = [m for m in DistanceType if m != DistanceType.Precomputed]
EXACT = {DistanceType.L2Expanded, DistanceType.L1, DistanceType.L2Unexpanded,
         DistanceType.InnerProduct, DistanceType.Linf,
         DistanceType.JaccardExpanded, DistanceType.BrayCurtis,
         DistanceType.HammingUnexpanded, DistanceType.RusselRaoExpanded,
         DistanceType.DiceExpanded}
NON_NEGATIVE = {DistanceType.HellingerExpanded, DistanceType.JensenShannon,
                DistanceType.KLDivergence}
P = 3.0                     # the Minkowski exponent of LpUnexpanded


def _data(rng, metric, kind, m, k, d=12):
    if metric == DistanceType.Haversine:
        d = 2
    if kind == "int":
        x, y = int_data(rng, (m, d)), int_data(rng, (k, d))
        if metric not in NON_NEGATIVE:
            x, y = x - 3, y - 3
        if metric == DistanceType.Haversine:
            x, y = x * 0.25, y * 0.25         # radians
        return x, y
    x, y = gauss(rng, (m, d)), gauss(rng, (k, d))
    if metric in NON_NEGATIVE:
        x, y = np.abs(x), np.abs(y)
    return x, y


def _close(a, b, exact):
    a, b = n(a), n(b)
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, **GAUSS_TOL)


def _same_knn(d, i, jd, ji, exact):
    """kNN results agree: distances as :func:`_close`; ids bit for bit,
    except (when not ``exact``) an id that sits at another slot of the
    reference's row, or past its k-th, within the tolerance of this
    slot's distance (a near-tie the two summation orders break apart)."""
    _close(d, jd, exact)
    i, ji, jd = n(i), n(ji), n(jd)
    if exact:
        np.testing.assert_array_equal(i, ji)
        return
    tol = GAUSS_TOL["atol"] + GAUSS_TOL["rtol"] * np.abs(jd)
    for r, c in zip(*np.nonzero(i != ji)):
        at = np.flatnonzero(ji[r] == i[r, c])
        other = jd[r, at[0]] if at.size else jd[r, -1]
        assert abs(other - jd[r, c]) <= tol[r, c], (r, c, i[r], ji[r])


# ---------------------------------------------------------------------------
# Vocabulary


def test_metric_vocabulary_matches_reference():
    assert {k: v.value for k, v in types.DISTANCE_TYPES.items()} == {
        k: v.value for k, v in jtypes.DISTANCE_TYPES.items()}
    assert types.SUPPORTED_DISTANCES == jtypes.SUPPORTED_DISTANCES
    for m in DistanceType:
        jm = JDistance(m.value)
        assert m.name == jm.name
        assert types.is_min_close(m) == jtypes.is_min_close(jm)
        assert (types.value_form_select_min(m)
                == jtypes.value_form_select_min(jm))
    for name in types.DISTANCE_TYPES:
        assert types.resolve_metric(name.upper()).value == \
            jtypes.resolve_metric(name).value


# ---------------------------------------------------------------------------
# Pairwise


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_distance_every_metric(rng, metric, kind):
    x, y = _data(rng, metric, kind, 17, 23)
    got = distance(t(x), t(y), metric, metric_arg=P)
    want = jdistance(x, y, JDistance(metric.value), metric_arg=P)
    assert tuple(got.shape) == (17, 23) and got.dtype == torch.float32
    _close(got, want, kind == "int" and metric in EXACT)


@pytest.mark.parametrize("name", sorted(types.DISTANCE_TYPES))
def test_pairwise_distance_names(rng, name):
    metric = types.resolve_metric(name)
    x, y = _data(rng, metric, "int", 9, 14)
    got = pairwise_distance(t(x), t(y), metric=name, p=P)
    _close(got, jpairwise(x, y, metric=name, p=P), metric in EXACT)


def test_pairwise_default_is_euclidean(rng):
    x, y = int_data(rng, (5, 4)), int_data(rng, (6, 4))
    _close(distance(t(x), t(y)), jdistance(x, y), False)
    _close(pairwise_distance(t(x), t(y)), jpairwise(x, y), False)


@pytest.mark.parametrize("metric", [
    m for m in METRICS if m not in (
        DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
        DistanceType.InnerProduct, DistanceType.CosineExpanded,
        DistanceType.CorrelationExpanded, DistanceType.HellingerExpanded,
        DistanceType.RusselRaoExpanded, DistanceType.JaccardExpanded,
        DistanceType.DiceExpanded, DistanceType.Haversine, DistanceType.L1,
        DistanceType.Linf)], ids=lambda m: m.name)
def test_unexpanded_blocks_at_boundaries(rng, monkeypatch, metric):
    """Blocks of 5 x 7 rows (ragged at both edges) give the same bits as
    one block: each entry is computed on its own."""
    x, y = _data(rng, metric, "gauss", 23, 31)
    whole = distance(t(x), t(y), metric, metric_arg=P)
    monkeypatch.setattr(pairwise_mod, "_BLOCK_COLS", 7)
    monkeypatch.setattr(pairwise_mod, "_BLOCK_ELEMS", 5 * 7 * x.shape[1])
    blocked = distance(t(x), t(y), metric, metric_arg=P)
    assert torch.equal(torch.isnan(whole), torch.isnan(blocked))
    np.testing.assert_array_equal(n(blocked), n(whole))


def test_edge_rules_match_reference():
    """Zero rows: Jaccard and Dice give 0 for two empty rows; Canberra and
    Bray-Curtis drop 0/0 terms; cosine and correlation divide by zero
    (NaN), as in the reference; the logs skip non-positive entries."""
    x = np.array([[0, 0, 0], [1, 0, 2], [0, 3, 0]], np.float32)
    y = np.array([[0, 0, 0], [1, 0, 2], [2, 0, 0], [1, 1, 1]], np.float32)
    for metric in METRICS:
        if metric == DistanceType.Haversine:
            continue
        got = n(distance(t(x), t(y), metric, metric_arg=P))
        want = np.asarray(jdistance(x, y, JDistance(metric.value),
                                    metric_arg=P))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                      err_msg=metric.name)
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], err_msg=metric.name,
                                   **GAUSS_TOL)


def test_precomputed_is_refused(rng):
    x = t(int_data(rng, (3, 4)))
    with pytest.raises(ValueError):
        distance(x, x, DistanceType.Precomputed)
    with pytest.raises(ValueError):
        brute_force.knn(x, x, 2, metric=DistanceType.Precomputed)


# ---------------------------------------------------------------------------
# brute_force.knn over every metric


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_knn_every_metric_tiles_and_parts(rng, metric):
    """Integer data: one part across database tiles of 64 rows (the last
    ragged), three parts (one shorter than k), and k past n."""
    q, db = _data(rng, metric, "int", 9, 201)
    jm = JDistance(metric.value)
    exact = metric in EXACT
    d, i = brute_force.tiled_brute_force_knn(t(q), t(db), 10, metric,
                                             metric_arg=P, tile_db=64)
    jd, ji = jbf.tiled_brute_force_knn(q, db, 10, jm, metric_arg=P,
                                       tile_db=64)
    _same_knn(d, i, jd, ji, exact)
    parts = [db[:120], db[120:125], db[125:]]
    d, i = brute_force.knn([t(p) for p in parts], t(q), 10, metric=metric,
                           metric_arg=P)
    jd, ji = jbf.knn(parts, q, 10, metric=jm, metric_arg=P)
    _same_knn(d, i, jd, ji, exact)
    small = db[:6]
    d, i = brute_force.knn(t(small), t(q), 8, metric=metric, metric_arg=P)
    jd, ji = jbf.knn(small, q, 8, metric=jm, metric_arg=P)
    assert tuple(i.shape) == (9, 6)
    _same_knn(d, i, jd, ji, exact)


@pytest.mark.parametrize("metric", ["cosine", "correlation", "l1", "linf",
                                    "canberra", "braycurtis", "minkowski",
                                    "hellinger", "jensenshannon",
                                    "kl_divergence", "haversine"])
def test_knn_gaussian(rng, metric):
    m = types.resolve_metric(metric)
    q, db = _data(rng, m, "gauss", 11, 300)
    d, i = brute_force.knn(t(db), t(q), 7, metric=metric, metric_arg=P)
    jd, ji = jbf.knn(db, q, 7, metric=metric, metric_arg=P)
    _same_knn(d, i, jd, ji, False)


def test_knn_inner_product_family_keeps_polarity(rng):
    """Cosine and correlation select the smallest ``1 - similarity``;
    inner product the largest similarity."""
    q, db = gauss(rng, (4, 8)), gauss(rng, (50, 8))
    _, ic = brute_force.knn(t(db), t(q), 3, metric="cosine")
    sim = (q / np.linalg.norm(q, axis=1, keepdims=True)) @ (
        db / np.linalg.norm(db, axis=1, keepdims=True)).T
    np.testing.assert_array_equal(n(ic), np.argsort(-sim, axis=1)[:, :3])
    _, ii = brute_force.knn(t(db), t(q), 3, metric="inner_product")
    np.testing.assert_array_equal(n(ii),
                                  np.argsort(-(q @ db.T), axis=1)[:, :3])


# ---------------------------------------------------------------------------
# fused_l2_nn_argmin


@pytest.mark.parametrize("sqrt", [False, True])
def test_fused_l2_nn_argmin(rng, sqrt):
    x, y = int_data(rng, (150, 16)), int_data(rng, (40, 16))
    got = fused_l2_nn_argmin(t(x), t(y), sqrt=sqrt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(n(got), n(jargmin(x, y, sqrt=sqrt)))
    xg, yg = gauss(rng, (60, 8)), gauss(rng, (30, 8))
    np.testing.assert_array_equal(n(fused_l2_nn_argmin(t(xg), t(yg))),
                                  n(jargmin(xg, yg)))


# ---------------------------------------------------------------------------
# L1 and Linf on half-precision rows. The reference answers in the rows'
# dtype; the port reduces in f32 and rounds once, so the two agree within
# two units in the last place of that dtype (rtol 2 eps: 2^-9 for f16,
# 2^-6 for bf16) on Gaussian data, and exactly on integer-valued data,
# whose sums (at most 84 here) are exact in f16 and bf16 alike.

HALF = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16}
HALF_METRICS = [DistanceType.L1, DistanceType.Linf]


def _half_close(got, want, dtype, exact):
    assert got.dtype == dtype and str(want.dtype) == str(HALF[dtype].dtype)
    a = n(got.float())
    b = np.asarray(want.astype(jnp.float32))
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=2 * torch.finfo(dtype).eps)


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("dtype", list(HALF), ids=str)
@pytest.mark.parametrize("metric", HALF_METRICS, ids=lambda m: m.name)
def test_l1_linf_half_precision(rng, metric, dtype, kind):
    x, y = _data(rng, metric, kind, 17, 23)
    jx, jy = jnp.asarray(x).astype(HALF[dtype]), jnp.asarray(y).astype(
        HALF[dtype])
    got = distance(t(x).to(dtype), t(y).to(dtype), metric)
    _half_close(got, jdistance(jx, jy, JDistance(metric.value)), dtype,
                kind == "int")
    name = "l1" if metric == DistanceType.L1 else "chebyshev"
    got = pairwise_distance(t(x).to(dtype), t(y).to(dtype), metric=name)
    _half_close(got, jpairwise(jx, jy, metric=name), dtype, kind == "int")


@pytest.mark.parametrize("dtype", list(HALF), ids=str)
@pytest.mark.parametrize("metric", ["l1", "chebyshev"])
def test_knn_l1_linf_half_precision(rng, metric, dtype):
    """Integer-valued rows: distances exact, ids bit for bit (ties to the
    lowest id)."""
    q, db = _data(rng, types.resolve_metric(metric), "int", 9, 120)
    jq, jdb = (jnp.asarray(a).astype(HALF[dtype]) for a in (q, db))
    d, i = brute_force.knn(t(db).to(dtype), t(q).to(dtype), 7, metric=metric)
    jd, ji = jbf.knn(jdb, jq, 7, metric=metric)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d.float()),
                                  np.asarray(jd.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# ``precision`` at the reference's positions: fifth in distance and
# pairwise_distance, fifth in fused_l2_nn_min_reduce (after tile_n), so
# positional calls line up. The port computes at full f32 for every name.


@pytest.mark.parametrize("precision", [None, "default", "high", "highest"])
def test_precision_positional_calls_line_up(rng, precision):
    x, y = int_data(rng, (9, 6)), int_data(rng, (13, 6))
    M = DistanceType
    got = distance(t(x), t(y), M.LpUnexpanded, P, precision)
    _close(got, jdistance(x, y, JDistance.LpUnexpanded, P, precision), False)
    got = pairwise_distance(t(x), t(y), "sqeuclidean", 2.0, precision)
    _close(got, jpairwise(x, y, "sqeuclidean", 2.0, precision), True)
    d, i = fused_l2_nn_min_reduce(t(x), t(y), True, 64, precision, None)
    jd, ji = jfused(x, y, True, 64, precision, None)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_allclose(n(d), n(jd), rtol=1e-6)


def test_precision_keyword_and_refusal(rng):
    x = t(int_data(rng, (4, 3)))
    _close(distance(x, x, precision="default"), distance(x, x), True)
    _close(pairwise_distance(x, x, precision="high"),
           pairwise_distance(x, x), True)
    for call in (lambda: distance(x, x, DistanceType.L1, 2.0, "fastest"),
                 lambda: pairwise_distance(x, x, "l1", 2.0, 1),
                 lambda: fused_l2_nn_min_reduce(x, x, False, 2048, "HIGH")):
        with pytest.raises(ValueError):
            call()
