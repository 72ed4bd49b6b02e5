"""Parity of raft_tpu_torch.ops.fused_knn (kernels B1 and B2) with the
reference Pallas kernels run in interpret mode.

On CPU tensors the wrappers take their plain versions, which repeat the
kernels' arithmetic and tie rules; the CUDA kernels themselves are held to
the same plain versions on the card (``test_torch_kernels_cuda.py``, marked
``cuda``, and ``chip_smoke.py``). Tolerances: exact on integer-valued
data; ``GAUSS_TOL`` for f32 on Gaussian data; on the bf16 paths the operands
round identically (to nearest even) and only the f32 summation order
differs, so ``BF16_TOL`` (rtol 1e-5, atol 1e-3) holds there.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu_torch.ops import fused_knn as fk
from test_torch_common import GAUSS_TOL, gauss, int_data, n, t

jfk = importlib.import_module("raft_tpu.ops.fused_knn")

BF16_TOL = dict(rtol=1e-5, atol=1e-3)
_TIERS = [(False, False), (True, False), (True, True)]


@pytest.mark.parametrize("metric,sqrt", [("l2", False), ("l2", True),
                                         ("ip", False)])
@pytest.mark.parametrize("bf16,qsplit", _TIERS)
def test_integer_data_bit_identical(rng, metric, sqrt, bf16, qsplit):
    q = int_data(rng, (37, 32))
    db = int_data(rng, (1000, 32))      # n not a multiple of a tile
    d, i = fk.fused_knn(t(q), t(db), 10, metric=metric, sqrt=sqrt,
                        bf16=bf16, qsplit=qsplit)
    jd, ji = jfk.fused_knn(q, db, 10, metric=metric, sqrt=sqrt, bf16=bf16,
                           qsplit=qsplit, interpret=True)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))


def test_ids_follow_distance_then_id(rng):
    """Ids equal a numpy lexsort on (distance, id), ties included."""
    q = int_data(rng, (9, 16), hi=3)
    db = int_data(rng, (300, 16), hi=3)
    d, i = fk.fused_knn(t(q), t(db), 12)
    full = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    ids = np.arange(db.shape[0])
    ref = np.stack([np.lexsort((ids, row))[:12] for row in full])
    np.testing.assert_array_equal(n(i), ref)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bf16,qsplit", _TIERS)
def test_gaussian_distances(rng, metric, bf16, qsplit):
    q = gauss(rng, (20, 48))
    db = gauss(rng, (700, 48))
    d, _ = fk.fused_knn(t(q), t(db), 8, metric=metric, bf16=bf16,
                        qsplit=qsplit)
    jd, _ = jfk.fused_knn(q, db, 8, metric=metric, bf16=bf16, qsplit=qsplit,
                          interpret=True)
    np.testing.assert_allclose(n(d), n(jd),
                               **(BF16_TOL if bf16 else GAUSS_TOL))


@pytest.mark.parametrize("k", [1, 300])
def test_k_one_and_k_equal_n(rng, k):
    q = int_data(rng, (8, 16))
    db = int_data(rng, (300, 16))
    d, i = fk.fused_knn(t(q), t(db), k)
    jd, ji = jfk.fused_knn(q, db, k, interpret=True)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))


def test_plain_version_tiles_the_database(rng, monkeypatch):
    """Several ragged db tiles in the plain sweep still give the
    reference's global (distance, id) order."""
    monkeypatch.setattr(fk, "_PLAIN_BLOCK", 13 * 97)
    q = int_data(rng, (13, 24), hi=4)
    db = int_data(rng, (1001, 24), hi=4)
    d, i = fk.fused_knn(t(q), t(db), 20)
    jd, ji = jfk.fused_knn(q, db, 20, interpret=True, bd=256)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))


def _cells_case(rng, L=5, cap=40, d=16, qrows=8):
    db = int_data(rng, (L, cap, d))
    invalid = rng.random((L, cap)) < 0.3
    invalid[1, :] = True               # an empty list
    invalid[3, 4:] = True              # a starved list: <= 4 valid rows
    cell_list = np.array([0, 1, -1, 3, 2, 4, 3, -1], np.int32)
    q = int_data(rng, (cell_list.shape[0], qrows, d))
    return cell_list, q, db, invalid


@pytest.mark.parametrize("l2", [True, False])
@pytest.mark.parametrize("k", [1, 10])
def test_cells_matches_reference(rng, l2, k):
    cell_list, q, db, invalid = _cells_case(rng)
    d, i = fk.fused_cells_knn(t(cell_list), t(q), t(db), t(invalid), k,
                              l2=l2)
    jd, ji = jfk.fused_cells_knn(cell_list, q, db, invalid, k, l2=l2,
                                 interpret=True)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))
    # -1 cells write sentinels; the starved list reports -1 past its rows.
    assert (n(i)[2] == -1).all() and np.isinf(n(d)[2]).all()
    if k == 10:
        assert (n(i)[3, :, 4:] == -1).all()
        assert (n(i)[1] == -1).all()        # cell 1 scans the empty list


def test_cells_bf16_db_with_qsplit(rng):
    cell_list, q, db, invalid = _cells_case(rng)
    q = q + 0.25                        # a query the bf16 hi half cannot hold
    d, i = fk.fused_cells_knn(t(cell_list), t(q), t(db).to(torch.bfloat16),
                              t(invalid), 10, bf16=True, qsplit=True)
    jd, ji = jfk.fused_cells_knn(cell_list, q, jnp.asarray(db, jnp.bfloat16),
                                 invalid, 10, bf16=True, qsplit=True,
                                 interpret=True)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_allclose(n(d), n(jd), **BF16_TOL)


def test_cells_gaussian_distances(rng):
    cell_list, _, _, invalid = _cells_case(rng)
    db = gauss(rng, (5, 40, 16))
    q = gauss(rng, (cell_list.shape[0], 8, 16))
    d, _ = fk.fused_cells_knn(t(cell_list), t(q), t(db), t(invalid), 6)
    jd, _ = jfk.fused_cells_knn(cell_list, q, db, invalid, 6,
                                interpret=True)
    np.testing.assert_allclose(n(d), n(jd), **GAUSS_TOL)


def test_wrappers_reject_other_devices():
    q = torch.zeros((4, 8), device="meta")
    with pytest.raises(fk.CudaError):
        fk.fused_knn(q, q, 2)
    with pytest.raises(fk.CudaError):
        fk.fused_cells_knn(torch.zeros(2, dtype=torch.int32, device="meta"),
                           torch.zeros((2, 4, 8), device="meta"),
                           torch.zeros((2, 5, 8), device="meta"),
                           torch.zeros((2, 5), dtype=torch.bool,
                                       device="meta"), 2)
