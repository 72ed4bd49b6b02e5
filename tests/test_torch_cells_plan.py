"""B2's launch plan and its plain version at cell heights off the row
blocks, on the CPU.

``_b2_plan`` decides how many query rows of a cell one CUDA CTA takes and
how many bytes of shared memory it needs; the C entry point refuses a
launch whose count differs from its own layout, so the plan is held here
to its contract over the shapes the wrapper accepts. The plain version,
which the card kernel is held to, is run at qrows 65 and 128 (a second,
ragged or full, block of rows) against the reference Pallas kernel in
interpret mode: integer data, so ids and distances agree bit for bit.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu_torch.ops import fused_knn as fk
from test_torch_common import int_data, n, t

jfk = importlib.import_module("raft_tpu.ops.fused_knn")

_QROWS = (1, 8, 15, 16, 17, 31, 32, 33, 63, 64, 65, 100, 128)
_DIMS = (16, 33, 128, 1024)
_KS = (1, 2, 10, 16, 17, 32, 64, 65, 100, 128, 129, 200, 255, 256)


@pytest.mark.parametrize("qsplit", [False, True])
@pytest.mark.parametrize("k", _KS)
def test_plan_fits_shared_memory(k, qsplit):
    for qrows in _QROWS:
        for d in _DIMS:
            plan = fk._b2_plan(qrows, d, k, qsplit)
            assert plan.bq in fk.B2_ROWS
            # Never more rows than the cell needs (past the smallest
            # block), and the most rows whose bytes fit.
            assert plan.bq <= max(16, -(-qrows // 16) * 16)
            assert plan.smem == fk._b2_smem_bytes(plan.bq, k, qsplit)
            assert plan.smem <= fk.SMEM_LIMIT and plan.smem % 16 == 0
            wider = [bq for bq in fk.B2_ROWS
                     if plan.bq < bq <= max(16, -(-qrows // 16) * 16)]
            for bq in wider:
                assert fk._b2_smem_bytes(bq, k, qsplit) > fk.SMEM_LIMIT


def test_plan_at_the_main_path():
    """64-row cells, d 128, k 10: one CTA per cell, and two CTAs share an
    SM (233,472 bytes of shared memory, 1 KB reserved per block) on every
    tier."""
    for qsplit in (False, True):
        plan = fk._b2_plan(64, 128, 10, qsplit)
        assert plan.bq == 64
        assert 2 * (plan.smem + 1024) <= 233472


def test_plan_rejects_what_the_kernel_cannot_take():
    with pytest.raises(fk.LogicError):
        fk._b2_plan(64, 128, fk.MAX_K + 1)
    with pytest.raises(fk.LogicError):
        fk._b2_plan(64, 128, 0)


def _cells_case(rng, qrows, L=5, cap=300, d=24, hi=8):
    db = int_data(rng, (L, cap, d), hi)
    invalid = rng.random((L, cap)) < 0.3
    invalid[1, :] = True               # an empty list
    invalid[3, 4:] = True              # a starved list: <= 4 valid rows
    invalid[4, 128:256] = True         # a whole tile of tombstones
    cell_list = np.array([0, 1, -1, 3, 4, 2], np.int32)
    q = int_data(rng, (cell_list.shape[0], qrows, d), hi)
    return cell_list, q, db, invalid


@pytest.mark.parametrize("qrows", [65, 128])
@pytest.mark.parametrize("l2", [True, False])
@pytest.mark.parametrize("k", [1, 10, 17])
@pytest.mark.parametrize("hi", [2, 8])
def test_plain_matches_reference_past_one_block(rng, qrows, l2, k, hi):
    cell_list, q, db, invalid = _cells_case(rng, qrows, hi=hi)
    d, i = fk.fused_cells_knn(t(cell_list), t(q), t(db), t(invalid), k,
                              l2=l2)
    jd, ji = jfk.fused_cells_knn(cell_list, q, db, invalid, k, l2=l2,
                                 interpret=True)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))
    assert (n(i)[2] == -1).all() and (n(i)[1] == -1).all()


@pytest.mark.parametrize("qrows", [65, 128])
@pytest.mark.parametrize("qsplit", [False, True])
def test_plain_bf16_store_matches_reference(rng, qrows, qsplit):
    """A bf16 store with the bf16 tier: the operands round alike, the
    integer grams are exact, so both agree bit for bit."""
    cell_list, q, db, invalid = _cells_case(rng, qrows)
    d, i = fk.fused_cells_knn(t(cell_list), t(q), t(db).to(torch.bfloat16),
                              t(invalid), 10, bf16=True, qsplit=qsplit)
    jd, ji = jfk.fused_cells_knn(cell_list, q, jnp.asarray(db, jnp.bfloat16),
                                 invalid, 10, bf16=True, qsplit=qsplit,
                                 interpret=True)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))
