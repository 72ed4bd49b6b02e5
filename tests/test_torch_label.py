"""raft_tpu_torch.label against raft_tpu.label.

Labels are integers, so every output is held bit for bit: the sorted
distinct labels, the monotonic remap (both bases, given classes) and the
merged labeling of two labelings through a mask.
"""

import numpy as np
import pytest
import torch

from raft_tpu import label as jl
from raft_tpu_torch import label as tl
from test_torch_common import n, t


def _same(got, want):
    got, want = n(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_get_unique_labels(seed):
    lab = np.random.default_rng(seed).choice([-4, 0, 7, 7, 12, 300], 500)
    lab = lab.astype(np.int32)
    _same(tl.get_unique_labels(t(lab)), jl.get_unique_labels(lab))


@pytest.mark.parametrize("zero_based", [True, False])
def test_make_monotonic(zero_based):
    lab = np.random.default_rng(1).choice([5, 3, 9, 100, -2], 300).astype(
        np.int32)
    mapped, classes = tl.make_monotonic(t(lab), zero_based=zero_based)
    rmapped, rclasses = jl.make_monotonic(lab, zero_based=zero_based)
    _same(mapped, rmapped)
    _same(classes, rclasses)


def test_make_monotonic_given_classes():
    lab = np.array([3, 9, 3, 5, 9], np.int32)
    classes = np.array([3, 5, 7, 9], np.int32)
    mapped, got_classes = tl.make_monotonic(t(lab), classes=t(classes))
    rmapped, rclasses = jl.make_monotonic(lab, classes=classes)
    _same(mapped, rmapped)
    _same(got_classes, rclasses)


@pytest.mark.parametrize("seed", range(6))
def test_merge_labels(seed):
    rng = np.random.default_rng(seed)
    size = int(rng.integers(20, 400))
    a = rng.integers(0, max(2, size // 4), size).astype(np.int32)
    b = rng.integers(0, max(2, size // 3), size).astype(np.int32)
    mask = rng.random(size) < rng.uniform(0.2, 0.9)
    _same(tl.merge_labels(t(a), t(b), t(mask)),
          jl.merge_labels(a, b, mask))


def test_merge_labels_chain():
    """A chain that needs several rounds: 0-1 through B, 1-2 through A,
    2-3 through B; the unmasked point keeps its A label."""
    a = np.array([0, 1, 1, 3, 3, 5], np.int32)
    b = np.array([0, 0, 2, 2, 4, 4], np.int32)
    mask = np.array([True, True, True, True, True, False])
    got = tl.merge_labels(t(a), t(b), t(mask))
    _same(got, jl.merge_labels(a, b, mask))
    assert n(got).tolist() == [0, 0, 0, 0, 0, 5]


def test_outputs_stay_on_the_inputs_device():
    lab = t(np.array([2, 1, 2], np.int32))
    assert tl.get_unique_labels(lab).device.type == "cpu"
    assert tl.make_monotonic(lab)[0].device.type == "cpu"
    if not torch.cuda.is_available():
        from raft_tpu_torch.core.error import CudaError

        with pytest.raises(CudaError):
            tl.get_unique_labels(np.array([1, 2]))
