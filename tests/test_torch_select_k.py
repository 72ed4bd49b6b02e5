"""Parity of raft_tpu_torch.matrix.select_k with raft_tpu's select_k.

The reference returns ties lowest index first (``lax.top_k``'s order);
bare ``torch.topk`` does not. Integer-valued inputs with many ties must
give identical values and indices.
"""

import numpy as np
import pytest
import torch

from raft_tpu.matrix.select_k import SelectMethod as JMethod
from raft_tpu.matrix.select_k import select_k as jselect_k
from raft_tpu_torch.matrix.select_k import SelectMethod, select_k
from test_torch_common import n, t

_METHODS = [(SelectMethod.kAuto, JMethod.kAuto),
            (SelectMethod.kTopK, JMethod.kTopK),
            (SelectMethod.kTwoPhase, JMethod.kTwoPhase)]


def test_ties_go_to_the_lowest_index():
    x = np.array([[1, 0, 0, 0, 1]], np.float32)
    _, ti = torch.topk(-t(x), 3)
    v, i = select_k(t(x), 3, select_min=True)
    jv, ji = jselect_k(x, 3, select_min=True)
    assert n(i).tolist() == [[1, 2, 3]] == n(ji).tolist()
    np.testing.assert_array_equal(n(v), n(jv))
    assert sorted(n(ti)[0].tolist()) == [1, 2, 3]


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("method", _METHODS, ids=lambda m: m[0].name)
@pytest.mark.parametrize("batch,length,k", [(7, 50, 5), (3, 300, 64),
                                            (2, 40000, 20)])
def test_matches_reference(rng, select_min, method, batch, length, k):
    x = rng.integers(0, 6, (batch, length)).astype(np.float32)
    v, i = select_k(t(x), k, select_min=select_min, method=method[0])
    jv, ji = jselect_k(x, k, select_min=select_min, method=method[1])
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(v), n(jv))
    assert i.dtype == torch.int32


@pytest.mark.parametrize("select_min", [True, False])
def test_payload_indices(rng, select_min):
    x = rng.integers(0, 4, (5, 30)).astype(np.float32)
    payload = rng.permutation(1000)[:150].reshape(5, 30).astype(np.int32)
    v, i = select_k(t(x), 7, select_min=select_min, indices=t(payload))
    jv, ji = jselect_k(x, 7, select_min=select_min, indices=payload)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(v), n(jv))


@pytest.mark.parametrize("select_min", [True, False])
def test_k_beyond_length_pads(rng, select_min):
    x = rng.integers(0, 4, (3, 6)).astype(np.float32)
    payload = np.arange(18, dtype=np.int32).reshape(3, 6) + 100
    v, i = select_k(t(x), 9, select_min=select_min)
    jv, ji = jselect_k(x, 9, select_min=select_min)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(v), n(jv))
    _, pi = select_k(t(x), 9, select_min=select_min, indices=t(payload))
    _, jpi = jselect_k(x, 9, select_min=select_min, indices=payload)
    np.testing.assert_array_equal(n(pi), n(jpi))
    assert (n(pi)[:, 6:] == -1).all()


def test_one_dimensional_and_integer_keys(rng):
    x = rng.integers(-50, 50, 40).astype(np.int32)
    v, i = select_k(t(x), 6)
    jv, ji = jselect_k(x, 6)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(v), n(jv))
