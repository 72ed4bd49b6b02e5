"""B1's launch plan and its split-database merge, on the CPU.

``_b1_plan`` decides how many database slices the CUDA kernel sweeps side
by side and how many queries a CTA holds; the kernel merges the slices'
sorted lists by (distance, id). These tests hold the plan to its contract
(disjoint whole-tile slices covering the database, a shared-memory budget
that fits the H100, about two waves of CTAs where the shape allows) and
the plain version run slice by slice and merged to the one sweep and to
the reference Pallas kernel in interpret mode. Integer data in {0, 1}
makes exact ties that straddle the slice boundaries, so ids and distances
must agree bit for bit.
"""

import importlib

import numpy as np
import pytest
import torch

from test_torch_common import int_data, n, t

fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")

jfk = importlib.import_module("raft_tpu.ops.fused_knn")

_TIERS = [(False, False), (True, False), (True, True)]
_MS = (1, 31, 64, 129, 1000, 10_000, 500_000)
_NS = (1, 100, 128, 129, 5000, 200_000, 200_001, 1_000_000)


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("k", [1, 10, 64, 65, 128, 129, 256])
def test_plan_slices_cover_the_database(k, n_sm):
    for m in _MS:
        for rows in _NS:
            if k > rows:
                continue
            plan = fk._b1_plan(m, rows, k, n_sm)
            bounds = plan.bounds
            s = len(bounds)
            assert plan.slice_rows % fk.B1_BN == 0
            assert 1 <= s <= fk.B1_MAX_SLICES
            assert bounds[0][0] == 0 and bounds[-1][1] == rows
            for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
                assert hi == lo2 and hi - lo == plan.slice_rows
            assert all(hi > lo for lo, hi in bounds)
            if s > 1:
                assert plan.slice_rows >= fk.B1_MIN_SLICE_TILES * fk.B1_BN
            assert plan.bq in (32, 64, 128)
            assert plan.bq == 128 if k == 1 else plan.bq * k * 8 <= 65536
            for qsplit in (False, True):
                assert fk._b1_smem_bytes(plan.bq, k, qsplit) <= fk.SMEM_LIMIT
            # About two waves of CTAs, as far as m x n allows.
            blocks = -(-m // plan.bq)
            tiles = -(-rows // fk.B1_BN)
            most = max(1, min(fk.B1_MAX_SLICES,
                              tiles // fk.B1_MIN_SLICE_TILES))
            slots = n_sm * fk._b1_ctas_per_sm(k)
            # The CTAs an SM is to hold fit its 233,472 bytes of shared
            # memory (1 KB reserved per block).
            assert fk._b1_ctas_per_sm(k) * (
                fk._b1_smem_bytes(plan.bq, k, True) + 1024) <= 233472
            target = min(2 * slots, blocks * most)
            assert blocks * s >= 0.85 * target, (m, rows, k, plan)
            if blocks >= 2 * slots:
                assert s == 1


def test_plan_at_the_brute_force_shape():
    """10,000 queries x 1M rows, k=10 on 132 SMs: 79 blocks of 128, five
    slices, 395 CTAs = three full waves."""
    plan = fk._b1_plan(10_000, 1_000_000, 10, 132)
    slots = 132 * fk._b1_ctas_per_sm(10)
    s = len(plan.bounds)
    assert plan.bq == 128 and 79 * s <= 3 * slots < 79 * (s + 1)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bf16,qsplit", _TIERS)
@pytest.mark.parametrize("k", [1, 10, 65])
def test_split_plain_equals_one_sweep_and_reference(rng, metric, bf16,
                                                    qsplit, k):
    q = int_data(rng, (9, 16), hi=2)
    db = int_data(rng, (3000, 16), hi=2)
    plan = fk._b1_plan(q.shape[0], db.shape[0], k, 132)
    assert len(plan.bounds) > 3
    l2 = metric == "l2"
    sd, si = fk._fused_knn_plain(t(q), t(db), k, l2, bf16, qsplit,
                                 plan.bounds)
    od, oi = fk._fused_knn_plain(t(q), t(db), k, l2, bf16, qsplit)
    np.testing.assert_array_equal(n(si), n(oi))
    np.testing.assert_array_equal(n(sd), n(od))
    jd, ji = jfk.fused_knn(q, db, k, metric=metric, bf16=bf16, qsplit=qsplit,
                           interpret=True)
    np.testing.assert_array_equal(n(si), n(ji))
    np.testing.assert_array_equal(n(sd), n(jd) if l2 else -n(jd))


@pytest.mark.parametrize("k", [1, 7, 700])
def test_merge_keeps_the_lowest_id_across_slices(k):
    """Every row ties: the merge must return ids 0..k-1 in order, taking
    them from as many slices as it needs."""
    q = torch.zeros((3, 8))
    db = torch.ones((1500, 8))
    bounds = [(0, 512), (512, 1024), (1024, 1500)]
    d, i = fk._fused_knn_plain(q, db, k, True, False, False, bounds)
    np.testing.assert_array_equal(n(i), np.tile(np.arange(k), (3, 1)))
    assert (n(d) == 8.0).all()
