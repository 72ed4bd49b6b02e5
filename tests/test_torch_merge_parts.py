"""The multi-part kNN merge of raft_tpu_torch against raft_tpu's.

``merge_parts`` (the merge core), ``knn_merge_parts`` and
multi-part ``knn`` take the same numpy inputs in both packages. Keys are
integer-valued, so every distance is exact and ties are real: ids must be
identical (ties to the lower part-major position) and keys equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from raft_tpu.comms.topk_merge import merge_parts as jmerge_parts
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu_torch.comms.topk_merge import merge_parts
from raft_tpu_torch.neighbors import brute_force
from test_torch_common import int_data, n, t


def _parts(rng, n_parts, n_queries=9, kk=12, sort=True):
    keys = rng.integers(0, 6, (n_parts, n_queries, kk)).astype(np.float32)
    if sort:
        keys = np.sort(keys, axis=2)
    vals = rng.integers(0, 500, (n_parts, n_queries, kk)).astype(np.int32)
    return keys, vals


@pytest.mark.parametrize("n_parts", [1, 2, 3, 4])
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("k", [None, 5, 40])
def test_merge_parts_matches_reference(rng, n_parts, select_min, k):
    keys, vals = _parts(rng, n_parts)
    if not select_min:
        keys = keys[:, :, ::-1].copy()
    trans = [1000 * p for p in range(n_parts)]
    d, i = merge_parts(t(keys), t(vals), k, select_min, trans)
    jd, ji = jmerge_parts(jnp.asarray(keys), jnp.asarray(vals), k,
                          select_min, trans)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))


def test_merge_parts_unsorted_parts_and_no_translations(rng):
    keys, vals = _parts(rng, 3, sort=False)
    d, i = merge_parts(t(keys), t(vals), 7)
    jd, ji = jmerge_parts(jnp.asarray(keys), jnp.asarray(vals), 7)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))


@pytest.mark.parametrize("select_min", [True, False])
def test_knn_merge_parts_matches_reference(rng, select_min):
    keys, vals = _parts(rng, 4)
    if not select_min:
        keys = -keys
    trans = [0, 50, 100, 150]
    d, i = brute_force.knn_merge_parts(t(keys), t(vals),
                                       select_min=select_min,
                                       translations=trans)
    jd, ji = jbf.knn_merge_parts(keys, vals, select_min=select_min,
                                 translations=trans)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))


POSITIONAL_FORMS = [
    (None,),                        # n_samples alone: still the minima
    (20, False),                    # n_samples, select_min
    (None, True, [0, 100, 200, 300]),   # ..., translations
]


@pytest.mark.parametrize("args", POSITIONAL_FORMS,
                         ids=["n_samples", "select_max", "translations"])
def test_knn_merge_parts_positional_forms(rng, args):
    """``n_samples`` sits third, as in the reference, so positional calls
    line up: ``(k, v, None)`` selects the smallest keys."""
    keys, vals = _parts(rng, 4)
    if args[1:2] == (False,):
        keys = keys[:, :, ::-1].copy()
    d, i = brute_force.knn_merge_parts(t(keys), t(vals), *args)
    jd, ji = jbf.knn_merge_parts(keys, vals, *args)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))


@pytest.mark.parametrize("kwargs", [
    dict(n_samples=9), dict(select_min=False, n_samples=None),
    dict(translations=[5, 6, 7, 8], select_min=True)])
def test_knn_merge_parts_keyword_forms(rng, kwargs):
    keys, vals = _parts(rng, 4)
    if kwargs.get("select_min") is False:
        keys = keys[:, :, ::-1].copy()
    d, i = brute_force.knn_merge_parts(t(keys), t(vals), **kwargs)
    jd, ji = jbf.knn_merge_parts(keys, vals, **kwargs)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))


@pytest.mark.parametrize("sizes", [(100, 150), (60, 5, 90), (40, 40, 3, 77)])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
@pytest.mark.parametrize("offset", [0, 17])
def test_multipart_knn_matches_reference(rng, sizes, metric, offset):
    """2, 3 and 4 parts, some shorter than k (padded with the worst value
    and PAD_ID), against the reference and against one-part search."""
    X = int_data(rng, (sum(sizes), 8), hi=4)
    Q = int_data(rng, (11, 8), hi=4)
    cuts = np.cumsum(sizes)[:-1]
    parts = np.split(X, cuts)
    k = 10
    d, i = brute_force.knn([t(p) for p in parts], t(Q), k, metric=metric,
                           global_id_offset=offset)
    jd, ji = jbf.knn(parts, Q, k, metric=metric, global_id_offset=offset)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))
    sd, si = brute_force.knn(t(X), t(Q), k, metric=metric,
                             global_id_offset=offset)
    np.testing.assert_array_equal(n(i), n(si))
    np.testing.assert_array_equal(n(d), n(sd))


def test_multipart_knn_with_k_beyond_the_rows(rng):
    """Fewer rows than k in all: the tail carries the worst value and
    PAD_ID in both packages."""
    parts = [int_data(rng, (3, 4)), int_data(rng, (2, 4))]
    Q = int_data(rng, (4, 4))
    d, i = brute_force.knn([t(p) for p in parts], t(Q), 8)
    jd, ji = jbf.knn(parts, Q, 8)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))
    assert (n(i)[:, 5:] == -1).all()


@pytest.mark.parametrize("select_min", [True, False])
def test_merge_parts_orders_nan_and_zeros_as_lax_sort(select_min):
    """lax.sort standardizes its float keys (every NaN last, -0 equal to
    +0); the port's merge sorts on the same integer keys."""
    keys = np.array([[[0.0, -0.0, np.nan, 1.0]],
                     [[-np.nan, 0.0, -0.0, -1.0]]], np.float32)
    keys[1, 0, 0] = -keys[0, 0, 2]                     # a negative NaN
    vals = np.arange(8, dtype=np.int32).reshape(2, 1, 4)
    d, i = merge_parts(t(keys), t(vals), 8, select_min)
    jd, ji = jmerge_parts(jnp.asarray(keys), jnp.asarray(vals), 8,
                          select_min)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))
