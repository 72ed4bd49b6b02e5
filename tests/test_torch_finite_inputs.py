"""Non-finite inputs are rejected at the port's public entry points.

The kernels do not order NaN pairs as the plain versions do (on the card an
L2 NaN comes out of ``fmaxf`` as distance 0), and the reference disagrees
with itself on such inputs (its XLA scan ranks NaN by sign bit, its Pallas
kernel fills every slot with NaN). So every entry point that takes vectors
from the caller raises ``LogicError`` when one holds NaN or +-inf. Each
case poisons one element of one operand on CPU tensors; the last test
shows that finite inputs still match the reference.
"""

import numpy as np
import pytest

from raft_tpu.neighbors import brute_force as jbf
from raft_tpu_torch import lifecycle as lc
from raft_tpu_torch.cluster import kmeans_balanced as kb
from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_min_reduce
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
from test_torch_common import int_data, n, t

_DIM = 16
_LISTS = 4


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    return int_data(rng, (600, _DIM)), int_data(rng, (20, _DIM))


@pytest.fixture(scope="module")
def flat(data):
    return ivf_flat.build(ivf_flat.IndexParams(n_lists=_LISTS,
                                               kmeans_n_iters=2),
                          t(data[0]))


@pytest.fixture(scope="module")
def pq(data):
    return ivf_pq.build(ivf_pq.IndexParams(n_lists=_LISTS, kmeans_n_iters=2,
                                           pq_dim=8), t(data[0]))


def _kmeans():
    return KMeansBalancedParams(n_iters=2)


# entry point -> {operand: call(dataset, queries, flat, pq)}
_CALLS = {
    "brute_force.knn": {
        "dataset": lambda X, Q, f, p: brute_force.knn(X, Q, 3),
        "queries": lambda X, Q, f, p: brute_force.knn(X, Q, 3),
    },
    "brute_force.knn_parts": {
        "dataset": lambda X, Q, f, p: brute_force.knn([X[:300], X[300:]], Q,
                                                      3),
        "queries": lambda X, Q, f, p: brute_force.knn([X[:300], X[300:]], Q,
                                                      3),
    },
    "brute_force.tiled_brute_force_knn": {
        "dataset": lambda X, Q, f, p: brute_force.tiled_brute_force_knn(
            Q, X, 3, method="kernel"),
        "queries": lambda X, Q, f, p: brute_force.tiled_brute_force_knn(
            Q, X, 3, method="scan"),
    },
    "ivf_flat.build": {
        "dataset": lambda X, Q, f, p: ivf_flat.build(
            ivf_flat.IndexParams(n_lists=_LISTS, kmeans_n_iters=2), X),
    },
    "ivf_flat.extend": {
        "dataset": lambda X, Q, f, p: ivf_flat.extend(f, X[:5]),
    },
    "ivf_flat.search": {
        "queries": lambda X, Q, f, p: ivf_flat.search(
            ivf_flat.SearchParams(n_probes=2), f, Q, 3),
    },
    "ivf_pq.build": {
        "dataset": lambda X, Q, f, p: ivf_pq.build(
            ivf_pq.IndexParams(n_lists=_LISTS, kmeans_n_iters=2, pq_dim=8),
            X),
    },
    "ivf_pq.extend": {
        "dataset": lambda X, Q, f, p: ivf_pq.extend(p, X[:5]),
    },
    "ivf_pq.search": {
        "queries": lambda X, Q, f, p: ivf_pq.search(
            ivf_pq.SearchParams(n_probes=2), p, Q, 3),
    },
    "ivf_pq.search_refined": {
        "dataset": lambda X, Q, f, p: ivf_pq.search_refined(
            ivf_pq.SearchParams(n_probes=2), p, X, Q, 3),
        "queries": lambda X, Q, f, p: ivf_pq.search_refined(
            ivf_pq.SearchParams(n_probes=2), p, X, Q, 3),
    },
    "kmeans_balanced.fit": {
        "dataset": lambda X, Q, f, p: kb.fit(_kmeans(), X, 4),
    },
    "kmeans_balanced.predict": {
        "dataset": lambda X, Q, f, p: kb.predict(_kmeans(), Q, X),
        "queries": lambda X, Q, f, p: kb.predict(_kmeans(), Q, X),
    },
    "kmeans_balanced.fit_predict": {
        "dataset": lambda X, Q, f, p: kb.fit_predict(_kmeans(), X, 4),
    },
    "fused_l2_nn_min_reduce": {
        "dataset": lambda X, Q, f, p: fused_l2_nn_min_reduce(Q, X),
        "queries": lambda X, Q, f, p: fused_l2_nn_min_reduce(Q, X),
    },
    "lifecycle.upsert_flat": {
        "dataset": lambda X, Q, f, p: lc.upsert(f, X[:2], [1, 2]),
    },
    "lifecycle.upsert_pq": {
        "dataset": lambda X, Q, f, p: lc.upsert(p, X[:2], [1, 2]),
    },
}

_CASES = [(entry, operand) for entry, ops in _CALLS.items() for operand in ops]


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf],
                         ids=["nan", "+inf", "-inf"])
@pytest.mark.parametrize("entry,operand", _CASES)
def test_entry_point_rejects_non_finite(data, flat, pq, entry, operand,
                                        value):
    X, Q = (a.copy() for a in data)
    # Row 1 is in every slice the calls take (X[:2], X[:5], X[:300]).
    (X if operand == "dataset" else Q)[1, 5] = value
    epoch_f, epoch_p = flat.epoch, pq.epoch
    with pytest.raises(LogicError, match="finite"):
        _CALLS[entry][operand](t(X), t(Q), flat, pq)
    # Rejected before anything was written.
    assert (flat.epoch, pq.epoch) == (epoch_f, epoch_p)


def test_finite_inputs_still_match_the_reference(data):
    X, Q = data
    d, i = brute_force.knn(t(X), t(Q), 5)
    jd, ji = jbf.tiled_brute_force_knn(Q, X, 5, method="xla")
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))
