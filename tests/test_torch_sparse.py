"""raft_tpu_torch.sparse's formats, ops and linalg against raft_tpu.sparse.

The same numpy inputs go to both packages (the port on CPU tensors):
random patterns with empty rows, duplicate coordinates, unsorted COO
entries and invalid (row -1) entries. Structures (indptr, indices, rows,
cols) must agree bit for bit, values within rtol 1e-6, sums (SpMV, SpMM,
row norms, degrees of the Laplacian) within rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu import sparse as js
from raft_tpu.sparse.types import coo_from_dense as j_coo_from_dense
from raft_tpu.sparse.types import csr_from_dense as j_csr_from_dense
from raft_tpu_torch import sparse as ts
from raft_tpu_torch.sparse.types import coo_from_dense, csr_from_dense
from test_torch_common import n

VAL_TOL = dict(rtol=1e-6, atol=1e-7)
SUM_TOL = dict(rtol=1e-5, atol=1e-6)


def _dense(rng, m=30, d=20, density=0.2, empty_rows=(3, 17)):
    a = rng.random((m, d)).astype(np.float32)
    a[a > density] = 0.0
    a[[r for r in empty_rows if r < m]] = 0.0
    return a


def _coo_arrays(rng, m, d, nnz, invalid=0):
    """Unsorted entries with duplicate coordinates (integers, not a
    choice without replacement) and ``invalid`` entries at row -1."""
    rows = rng.integers(0, m, nnz).astype(np.int32)
    cols = rng.integers(0, d, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    rows[rng.choice(nnz, invalid, replace=False)] = -1
    return rows, cols, vals


def _both_coo(rows, cols, vals, shape):
    return (js.COO(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
                   shape),
            ts.COO(torch.as_tensor(rows), torch.as_tensor(cols),
                   torch.as_tensor(vals), shape))


def _both_csr(a):
    return j_csr_from_dense(a), csr_from_dense(a, device="cpu")


def _same_coo(got, want, tol=VAL_TOL):
    assert got.shape == want.shape
    for f in ("rows", "cols"):
        g, w = n(getattr(got, f)), n(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    np.testing.assert_allclose(n(got.vals), n(want.vals), **tol)


def _same_csr(got, want, tol=VAL_TOL):
    assert got.shape == want.shape
    for f in ("indptr", "indices"):
        g, w = n(getattr(got, f)), n(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    np.testing.assert_allclose(n(got.vals), n(want.vals), **tol)


# ---------------------------------------------------------------------------
# Formats


@pytest.mark.parametrize("keep_zeros", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_from_dense(seed, keep_zeros):
    a = _dense(np.random.default_rng(seed))
    _same_coo(coo_from_dense(a, keep_zeros, device="cpu"),
              j_coo_from_dense(a, keep_zeros))
    _same_csr(csr_from_dense(a, keep_zeros, device="cpu"),
              j_csr_from_dense(a, keep_zeros))


def test_from_dense_tensor_stays_on_its_device():
    a = torch.as_tensor(_dense(np.random.default_rng(0)))
    assert coo_from_dense(a).rows.device == a.device
    assert ts.convert.dense_to_csr(a).indptr.device == a.device


@pytest.mark.parametrize("seed", range(3))
def test_to_dense(seed):
    rng = np.random.default_rng(seed)
    jc, tc = _both_coo(*_coo_arrays(rng, 25, 15, 80, invalid=6), (25, 15))
    np.testing.assert_allclose(n(tc.to_dense()), n(jc.to_dense()), **SUM_TOL)
    np.testing.assert_allclose(n(ts.convert.coo_to_dense(tc)),
                               n(js.convert.coo_to_dense(jc)), **SUM_TOL)
    a = _dense(rng)
    jr, tr = _both_csr(a)
    np.testing.assert_array_equal(n(tr.to_dense()), a)
    np.testing.assert_array_equal(n(ts.convert.csr_to_dense(tr)), a)
    np.testing.assert_array_equal(n(tr.row_ids()), n(jr.row_ids()))


@pytest.mark.parametrize("invalid", [0, 5])
@pytest.mark.parametrize("seed", range(3))
def test_coo_to_csr_unsorted(seed, invalid):
    """Unsorted rows with duplicates (and invalid entries, which the
    reference counts in row 0) convert by a stable sort."""
    rng = np.random.default_rng(seed)
    jc, tc = _both_coo(*_coo_arrays(rng, 20, 12, 70, invalid), (20, 12))
    _same_csr(ts.convert.coo_to_csr(tc), js.convert.coo_to_csr(jc))


@pytest.mark.parametrize("seed", range(3))
def test_csr_to_coo_and_dense_conversions(seed):
    a = _dense(np.random.default_rng(seed))
    jr, tr = _both_csr(a)
    _same_coo(ts.convert.csr_to_coo(tr), js.convert.csr_to_coo(jr))
    _same_coo(ts.convert.dense_to_coo(a, device="cpu"),
              js.convert.dense_to_coo(a))
    _same_csr(ts.convert.dense_to_csr(a, device="cpu"),
              js.convert.dense_to_csr(a))


def test_empty_matrix():
    a = np.zeros((4, 3), np.float32)
    jr, tr = _both_csr(a)
    _same_csr(tr, jr)
    y = ts.linalg.spmv(tr, torch.ones(3))
    np.testing.assert_array_equal(n(y), np.zeros(4, np.float32))


# ---------------------------------------------------------------------------
# Ops


@pytest.mark.parametrize("seed", range(3))
def test_coo_sort(seed):
    rng = np.random.default_rng(seed)
    jc, tc = _both_coo(*_coo_arrays(rng, 20, 12, 90, invalid=4), (20, 12))
    _same_coo(ts.op.coo_sort(tc), js.op.coo_sort(jc))


def test_max_duplicates_reference_case():
    jc, tc = _both_coo(np.array([1, 0, 1], np.int32),
                       np.array([0, 1, 0], np.int32),
                       np.array([2.0, 3.0, 4.0], np.float32), (2, 2))
    got = ts.op.max_duplicates(tc)
    assert got.nnz == 2
    _same_coo(got, js.op.max_duplicates(jc))
    np.testing.assert_array_equal(n(got.to_dense()), [[0, 3], [6, 0]])


@pytest.mark.parametrize("invalid", [0, 7])
@pytest.mark.parametrize("seed", range(4))
def test_max_duplicates(seed, invalid):
    rng = np.random.default_rng(seed)
    jc, tc = _both_coo(*_coo_arrays(rng, 15, 10, 120, invalid), (15, 10))
    _same_coo(ts.op.max_duplicates(tc), js.op.max_duplicates(jc), SUM_TOL)


def test_max_duplicates_all_invalid_and_empty():
    rows = np.full(4, -1, np.int32)
    jc, tc = _both_coo(rows, np.arange(4, dtype=np.int32),
                       np.ones(4, np.float32), (3, 4))
    _same_coo(ts.op.max_duplicates(tc), js.op.max_duplicates(jc))
    z = np.zeros(0, np.int32)
    jc, tc = _both_coo(z, z, np.zeros(0, np.float32), (3, 4))
    assert ts.op.max_duplicates(tc).nnz == 0 == js.op.max_duplicates(jc).nnz


@pytest.mark.parametrize("seed", range(3))
def test_remove_zeros(seed):
    rng = np.random.default_rng(seed)
    rows, cols, vals = _coo_arrays(rng, 12, 9, 60, invalid=5)
    vals[rng.choice(60, 15, replace=False)] = 0.0
    jc, tc = _both_coo(rows, cols, vals, (12, 9))
    _same_coo(ts.op.remove_zeros(tc), js.op.remove_zeros(jc))


def test_remove_zeros_reference_case():
    jc, tc = _both_coo(np.array([0, 1], np.int32), np.array([0, 1], np.int32),
                       np.array([0.0, 5.0], np.float32), (2, 2))
    got = ts.op.remove_zeros(tc)
    assert got.nnz == 1
    _same_coo(got, js.op.remove_zeros(jc))


@pytest.mark.parametrize("start,stop", [(5, 15), (0, 30), (3, 4), (17, 18),
                                        (29, 30), (10, 10)])
def test_slice_csr(start, stop):
    a = _dense(np.random.default_rng(1))
    jr, tr = _both_csr(a)
    got = ts.op.slice_csr(tr, start, stop)
    _same_csr(got, js.op.slice_csr(jr, start, stop))
    np.testing.assert_array_equal(n(got.to_dense()), a[start:stop])


def test_csr_row_op():
    a = _dense(np.random.default_rng(2))
    jr, tr = _both_csr(a)
    got = ts.op.csr_row_op(tr, lambda r, v: v * (r + 1))
    _same_csr(got, js.op.csr_row_op(jr, lambda r, v: v * (r + 1)))


# ---------------------------------------------------------------------------
# Linalg


@pytest.mark.parametrize("seed", range(4))
def test_spmv(seed):
    rng = np.random.default_rng(seed)
    a = _dense(rng, m=40, d=25)
    x = rng.standard_normal(25).astype(np.float32)
    jr, tr = _both_csr(a)
    got = ts.linalg.spmv(tr, torch.as_tensor(x))
    np.testing.assert_allclose(n(got), n(js.linalg.spmv(jr, jnp.asarray(x))),
                               **SUM_TOL)
    np.testing.assert_allclose(n(got), a @ x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", range(4))
def test_spmm(seed):
    rng = np.random.default_rng(seed)
    a = _dense(rng, m=40, d=25)
    b = rng.standard_normal((25, 7)).astype(np.float32)
    jr, tr = _both_csr(a)
    got = ts.linalg.spmm(tr, torch.as_tensor(b))
    np.testing.assert_allclose(n(got), n(js.linalg.spmm(jr, jnp.asarray(b))),
                               **SUM_TOL)


def test_spmv_integer_values():
    """Integer entries sum exactly (the integer path of the row sums)."""
    rng = np.random.default_rng(8)
    a = rng.integers(-3, 4, (20, 12)).astype(np.int32)
    a[a < 1] = 0
    x = rng.integers(-5, 6, 12).astype(np.int32)
    jr, tr = _both_csr(a)
    got = ts.linalg.spmv(tr, torch.as_tensor(x))
    want = js.linalg.spmv(jr, jnp.asarray(x))
    assert n(got).dtype == n(want).dtype
    np.testing.assert_array_equal(n(got), n(want))
    np.testing.assert_array_equal(n(got), a @ x)


def test_spmv_with_duplicates_in_rows():
    """A CSR built from a COO with duplicate coordinates sums each row's
    entries in order."""
    rng = np.random.default_rng(7)
    jc, tc = _both_coo(*_coo_arrays(rng, 20, 10, 100), (20, 10))
    jr, tr = js.convert.coo_to_csr(jc), ts.convert.coo_to_csr(tc)
    x = rng.standard_normal(10).astype(np.float32)
    np.testing.assert_allclose(n(ts.linalg.spmv(tr, torch.as_tensor(x))),
                               n(js.linalg.spmv(jr, jnp.asarray(x))),
                               **SUM_TOL)


@pytest.mark.parametrize("seed", range(3))
def test_add(seed):
    rng = np.random.default_rng(seed)
    a, b = _dense(rng), _dense(rng)
    ja, ta = _both_csr(a)
    jb, tb = _both_csr(b)
    got = ts.linalg.add(ta, tb)
    _same_csr(got, js.linalg.add(ja, jb), SUM_TOL)
    np.testing.assert_allclose(n(got.to_dense()), a + b, rtol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_transpose(seed):
    a = _dense(np.random.default_rng(seed))
    jr, tr = _both_csr(a)
    got = ts.linalg.transpose(tr)
    _same_csr(got, js.linalg.transpose(jr))
    np.testing.assert_array_equal(n(got.to_dense()), a.T)


@pytest.mark.parametrize("seed", range(3))
def test_degree(seed):
    rng = np.random.default_rng(seed)
    jc, tc = _both_coo(*_coo_arrays(rng, 15, 10, 70, invalid=6), (15, 10))
    got = ts.linalg.degree(tc)
    want = js.linalg.degree(jc)
    assert n(got).dtype == n(want).dtype
    np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.parametrize("fn", ["row_normalize_l1", "row_normalize_max"])
@pytest.mark.parametrize("seed", range(3))
def test_row_normalize(seed, fn):
    rng = np.random.default_rng(seed)
    a = _dense(rng) - 0.05 * (_dense(rng) > 0)     # signs, empty rows
    jr, tr = _both_csr(a)
    _same_csr(getattr(ts.linalg, fn)(tr), getattr(js.linalg, fn)(jr),
              SUM_TOL)


@pytest.mark.parametrize("seed", range(3))
def test_symmetrize(seed):
    rng = np.random.default_rng(seed)
    a = _dense(rng, m=20, d=20)
    got = ts.linalg.symmetrize(coo_from_dense(a, device="cpu"))
    _same_coo(got, js.linalg.symmetrize(j_coo_from_dense(a)))
    np.testing.assert_allclose(n(got.to_dense()), (a + a.T) / 2, rtol=1e-6,
                               atol=1e-7)


def test_symmetrize_with_duplicates_and_invalid():
    rng = np.random.default_rng(9)
    jc, tc = _both_coo(*_coo_arrays(rng, 12, 12, 80, invalid=5), (12, 12))
    _same_coo(ts.linalg.symmetrize(tc), js.linalg.symmetrize(jc), SUM_TOL)


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_laplacian(seed, normalized):
    rng = np.random.default_rng(seed)
    a = _dense(rng, m=15, d=15, density=0.3)
    a = (a + a.T) / 2
    np.fill_diagonal(a, 0)
    jr, tr = _both_csr(a)
    got = ts.linalg.laplacian(tr, normalized)
    _same_csr(got, js.linalg.laplacian(jr, normalized), SUM_TOL)
    if not normalized:
        np.testing.assert_allclose(n(got.to_dense()).sum(axis=1), 0.0,
                                   atol=1e-5)
