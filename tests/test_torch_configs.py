"""The reference bench's other configurations, at small sizes, against
raft_tpu: SIFT-shaped u8 rows through IVF-PQ and its ``min_recall``
recipe, indexes built with ``retain_dataset=False``, and the scan engines
answering a batch chunk by chunk (``chip_smoke.py`` phase 21 runs them at
full size on the card).

Builds draw other random numbers in the two packages, so a build is held
by recall@10 (at least the reference's less ``RECALL_MARGIN``) and by what
it keeps; searches on one shared index are held bit for bit: the integer
model of ``test_torch_ivf_pq`` makes every PQ score exact, and u8 rows
and integer queries make every refined distance exact in f32.
"""

import functools
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
from test_torch_common import blobs, int_data, n, recall, t
from test_torch_ivf_pq import _Q, DIM, _pair

RECALL_MARGIN = 0.02


def sift_u8(rng, n_rows, n_queries, dim=DIM, n_centers=20):
    """bench.py's SIFT-shaped recipe (``_family_sift1m_u8``) at a small
    size: clustered non-negative u8 rows, queries near them."""
    centers = rng.uniform(20.0, 200.0, size=(n_centers, dim))
    assign = rng.integers(0, n_centers, size=n_rows)
    db = np.clip(centers[assign] + rng.normal(scale=18.0, size=(n_rows, dim)),
                 0, 255).astype(np.uint8)
    qsel = rng.integers(0, n_rows, size=n_queries)
    q = np.clip(db[qsel].astype(np.float64)
                + rng.normal(scale=6.0, size=(n_queries, dim)),
                0, 255).astype(np.uint8)
    return db, q


_PQ = dict(n_lists=16, kmeans_n_iters=6, pq_dim=8)


def test_u8_rows_build_and_refine_over_their_source():
    """IVF-PQ built on u8 rows keeps them as its source, in both packages;
    the native search and the ``min_recall=0.95`` recipe over that u8
    source reach the reference's recall."""
    rng = np.random.default_rng(11)
    X, Qu = sift_u8(rng, 2000, 40)
    Q = Qu.astype(np.float32)
    _, truth = jbf.knn(X.astype(np.float32), Q, 10)
    Xt = t(X)
    idx = ivf_pq.build(ivf_pq.IndexParams(**_PQ), Xt)
    jidx = jpq.build(jpq.IndexParams(**_PQ), jnp.asarray(X))
    assert idx._source is Xt and idx._source.dtype == torch.uint8
    assert jidx._source.dtype == jnp.uint8
    assert idx.size == jidx.size == X.shape[0]
    for kw in (dict(), dict(min_recall=0.95)):
        _, i = ivf_pq.search(ivf_pq.SearchParams(n_probes=4, engine="scan",
                                                 **kw), idx, t(Q), 10)
        _, ji = jpq.search(jpq.SearchParams(n_probes=4, engine="scan", **kw),
                           jidx, Q, 10)
        assert recall(i, truth) >= recall(ji, truth) - RECALL_MARGIN, kw
    assert recall(i, truth) >= 0.99    # the refined recipe


@pytest.mark.parametrize("min_recall", [0.88, 0.95])
def test_min_recall_over_a_u8_source_matches_reference(rng, min_recall):
    """On one index whose retained source is u8 rows, the ``min_recall``
    recipe (compressed tier, then refine over the u8 rows) answers as the
    reference's, ids and distances bit for bit."""
    p, j = _pair(rng)
    X = rng.integers(0, 256, size=(int(n(p.list_sizes).sum()), DIM),
                     dtype=np.uint8)
    p._source, j._source = t(X), jnp.asarray(X)
    sp = dict(n_probes=4, engine="bucketed", min_recall=min_recall)
    d, i = ivf_pq.search(ivf_pq.SearchParams(**sp), p, t(_Q), 10)
    jd, ji = jpq.search(jpq.SearchParams(**sp), j, _Q, 10)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))
    assert p._source.dtype == torch.uint8


def test_retain_dataset_false_keeps_no_source(caplog):
    """``retain_dataset=False``: no source in either package; the index
    searches bit for bit as the retaining one; a ``min_recall`` search
    warns and answers the native search, in both packages."""
    rng = np.random.default_rng(17)
    X = blobs(rng, 2000, DIM, n_blobs=20, std=2.0)
    Q = X[:40] + rng.standard_normal((40, DIM)).astype(np.float32)
    kept = ivf_pq.build(ivf_pq.IndexParams(**_PQ), t(X))
    bare = ivf_pq.build(ivf_pq.IndexParams(retain_dataset=False, **_PQ),
                        t(X))
    jbare = jpq.build(jpq.IndexParams(retain_dataset=False, **_PQ), X)
    assert bare._source is None and jbare._source is None
    assert kept._source is not None
    assert torch.equal(bare.pq_codes, kept.pq_codes)
    for engine in ("bucketed", "scan"):
        sp = ivf_pq.SearchParams(n_probes=6, engine=engine)
        d, i = ivf_pq.search(sp, bare, t(Q), 10)
        kd, ki = ivf_pq.search(sp, kept, t(Q), 10)
        assert torch.equal(i, ki) and torch.equal(d, kd)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="raft_tpu_torch"):
            rd, ri = ivf_pq.search(ivf_pq.SearchParams(
                n_probes=6, engine=engine, min_recall=0.95), bare, t(Q), 10)
        assert "retains no source" in caplog.text
        assert torch.equal(ri, i) and torch.equal(rd, d)
    jsp = jpq.SearchParams(n_probes=6, engine="scan")
    jd, ji = jpq.search(jsp, jbare, Q, 10)
    jrd, jri = jpq.search(jpq.SearchParams(n_probes=6, engine="scan",
                                           min_recall=0.95), jbare, Q, 10)
    np.testing.assert_array_equal(np.asarray(jri), np.asarray(ji))
    np.testing.assert_array_equal(np.asarray(jrd), np.asarray(jd))


def test_min_recall_without_a_source_matches_reference(rng):
    """On one index without a source, a ``min_recall`` search is the
    native search in both packages, bit for bit."""
    p, j = _pair(rng)
    assert p._source is None and j._source is None
    sp = dict(n_probes=4, engine="bucketed")
    d, i = ivf_pq.search(ivf_pq.SearchParams(min_recall=0.95, **sp), p,
                         t(_Q), 10)
    jd, ji = jpq.search(jpq.SearchParams(min_recall=0.95, **sp), j, _Q, 10)
    nd, ni = ivf_pq.search(ivf_pq.SearchParams(**sp), p, t(_Q), 10)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))
    assert torch.equal(i, ni) and torch.equal(d, nd)


def _small_budget(monkeypatch, budget):
    """Both scan engines with ``_chunked_over_queries`` held to
    ``budget`` bytes a chunk."""
    small = functools.partial(ivf_flat._chunked_over_queries, budget=budget)
    monkeypatch.setattr(ivf_flat, "_chunked_over_queries", small)
    monkeypatch.setattr(ivf_pq, "_chunked_over_queries", small)


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_scan_engines_answer_chunk_by_chunk_as_one_batch(rng, monkeypatch,
                                                         kind):
    """The scan engines split a batch into query chunks under a byte
    budget: chunks of one or two queries answer as the whole batch does,
    bit for bit, and as the reference's scan engine."""
    if kind == "ivf_flat":
        X = int_data(rng, (600, DIM))
        j = jflat.build(jflat.IndexParams(n_lists=8, kmeans_n_iters=4), X)
        p = ivf_flat.index_from_numpy(j.centers, j.data, j.indices,
                                      j.list_sizes, j.metric.value,
                                      device="cpu")
        mod, jmod, Q = ivf_flat, jflat, int_data(rng, (30, DIM))
        per_q = p.data.shape[1] * DIM * 4
    else:
        p, j = _pair(rng)
        mod, jmod, Q = ivf_pq, jpq, _Q
        per_q = max(p.pq_codes.shape[1] * p.pq_dim * 4, p.pq_dim * 256 * 4)
    sp = dict(n_probes=4, engine="scan")
    whole = mod.search(mod.SearchParams(**sp), p, t(Q), 10)
    jd, ji = jmod.search(jmod.SearchParams(**sp), j, Q, 10)
    _small_budget(monkeypatch, 2 * per_q - 1)      # one query a chunk
    one = mod.search(mod.SearchParams(**sp), p, t(Q), 10)
    _small_budget(monkeypatch, 2 * per_q)          # two a chunk
    two = mod.search(mod.SearchParams(**sp), p, t(Q), 10)
    for d, i in (one, two):
        assert torch.equal(i, whole[1]) and torch.equal(d, whole[0])
    np.testing.assert_array_equal(n(whole[1]), n(ji))
    np.testing.assert_array_equal(n(whole[0]), n(jd))
