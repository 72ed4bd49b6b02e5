"""raft_tpu_torch.linalg against raft_tpu.linalg.

Mirrors tests/test_linalg.py and tests/test_linalg_properties.py: the
same seeded numpy inputs go through the reference (on the CPU) and the
port (CPU tensors). Tolerances:

* element-wise ops: bit for bit (values and dtypes), but ``sqrt``, which
  XLA's compiled square root may round an ulp off: rtol 1e-6;
* reductions, norms, products, least squares and eigen- and singular
  values: rtol 1e-5 (atol 1e-5 for entries near zero; the two packages
  sum in different orders); the decompositions of random matrices, whose
  conditioning amplifies those sums, are held to their own reconstruction
  and to the reference's values at the tolerances of the reference's
  tests;
* eigen- and singular vectors: equal up to the sign of each column;
* ``rsvd``: the two packages draw different sketches, so on an exactly
  low-rank input the singular values agree within 1e-4 relative, and the
  reconstruction holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from raft_tpu import linalg as jl
from raft_tpu.core import operators as jops
from raft_tpu_torch import linalg
from raft_tpu_torch.core import operators as ops
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.core.resources import DeviceResources
from raft_tpu_torch.linalg import blas, decomp
from test_torch_common import n, t

TOL = dict(rtol=1e-5, atol=1e-5)


def _same(got, want):
    got, want = n(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _close(got, want, **tol):
    np.testing.assert_allclose(n(got), np.asarray(want), **(tol or TOL))


def _cols_up_to_sign(got, want, **tol):
    """Columns equal up to each one's sign."""
    got, want = n(got).astype(np.float64), np.asarray(want, np.float64)
    signs = np.sign(np.sum(got * want, axis=0))
    signs[signs == 0] = 1
    np.testing.assert_allclose(got * signs, want, **(tol or TOL))


@pytest.fixture
def mats(rng):
    a = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal((16, 8)).astype(np.float32)
    return a, b


# ---------------------------------------------------------------------------
# Element-wise: bit for bit


@pytest.mark.parametrize("name", ["add", "subtract", "multiply", "divide",
                                  "power"])
def test_binary_elementwise_bit_for_bit(mats, name):
    a, b = mats
    if name == "power":
        a = np.abs(a)
    _same(getattr(linalg, name)(t(a), t(b)), getattr(jl, name)(a, b))
    _same(getattr(linalg, name)(t(a), b), getattr(jl, name)(a, b))


@pytest.mark.parametrize("name,s", [("add_scalar", 2.5),
                                    ("subtract_scalar", -1.0),
                                    ("multiply_scalar", 3.0),
                                    ("divide_scalar", 4.0),
                                    ("power_scalar", 2.0)])
def test_scalar_elementwise_bit_for_bit(mats, name, s):
    a, _ = mats
    _same(getattr(linalg, name)(t(a), s), getattr(jl, name)(a, s))


def test_sqrt_and_generic_maps(mats):
    a, b = mats
    # XLA's compiled sqrt may round an ulp off the correctly rounded one.
    _close(linalg.sqrt(t(np.abs(a))), jl.sqrt(np.abs(a)), rtol=1e-6)
    _same(linalg.unary_op(t(a), ops.sq_op), jl.unary_op(a, jops.sq_op))
    _same(linalg.binary_op(t(a), t(b), ops.sqdiff_op),
          jl.binary_op(a, b, jops.sqdiff_op))
    f3 = lambda x, y, z: (x - y) * z   # noqa: E731 (no fusable x * y + z)
    _same(linalg.ternary_op(t(a), t(b), t(a), f3), jl.ternary_op(a, b, a, f3))
    _same(linalg.eltwise(f3, t(a), t(b), t(b)), jl.eltwise(f3, a, b, b))
    _same(linalg.map(f3, t(a), b, t(a)), jl.map(f3, a, b, a))


def test_map_offset(mats):
    _same(linalg.map_offset((2, 3), lambda i: i * 2, device="cpu"),
          jl.map_offset((2, 3), lambda i: i * 2))
    a, _ = mats
    f = lambda i, x: i + x             # noqa: E731
    _same(linalg.map_offset(a.shape, f, t(a)), jl.map_offset(a.shape, f, a))


def test_matrix_vector_op(rng):
    m = rng.standard_normal((6, 4)).astype(np.float32)
    v = rng.standard_normal(4).astype(np.float32)
    w = rng.standard_normal(6).astype(np.float32)
    _same(linalg.matrix_vector_op(t(m), t(v), ops.add_op),
          jl.matrix_vector_op(m, v, jops.add_op))
    _same(linalg.matrix_vector_op(t(m), t(w), ops.mul_op, along_rows=False),
          jl.matrix_vector_op(m, w, jops.mul_op, along_rows=False))
    f3 = lambda x, y, z: (x - y) * z   # noqa: E731
    _same(linalg.matrix_vector_op(t(m), t(v), f3, vec2=t(v)),
          jl.matrix_vector_op(m, v, f3, vec2=v))


# ---------------------------------------------------------------------------
# Reductions and norms: rtol 1e-5


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("reduce_op,init", [("add_op", None),
                                            ("add_op", 2.0),
                                            ("min_op", None),
                                            ("min_op", -0.5),
                                            ("max_op", None),
                                            ("max_op", 0.25),
                                            ("mul_op", 1.0)])
def test_reduce_matches_reference(mats, axis, reduce_op, init):
    a, _ = mats
    kw = dict(reduce_op=getattr(ops, reduce_op), init=init)
    jkw = dict(reduce_op=getattr(jops, reduce_op), init=init)
    _close(linalg.reduce(t(a), axis=axis, **kw),
           jl.reduce(a, axis=axis, **jkw))


def test_reduce_main_and_final_ops(mats):
    a, _ = mats
    _close(linalg.reduce(t(a), axis=1, main_op=ops.sq_op,
                         final_op=ops.sqrt_op),
           jl.reduce(a, axis=1, main_op=jops.sq_op, final_op=jops.sqrt_op))
    _close(linalg.coalesced_reduction(t(a), main_op=ops.abs_op),
           jl.coalesced_reduction(a, main_op=jops.abs_op))
    _close(linalg.strided_reduction(t(a), reduce_op=ops.max_op),
           jl.strided_reduction(a, reduce_op=jops.max_op))


def test_coalesced_reduction_custom_op():
    x = np.array([[1.0, 2.0, 3.0], [2.0, 2.0, 2.0]], np.float32)
    got = linalg.coalesced_reduction(t(x), reduce_op=ops.mul_op, init=1.0)
    _close(got, jl.coalesced_reduction(x, reduce_op=jops.mul_op, init=1.0))
    np.testing.assert_allclose(n(got), [6.0, 8.0])


def test_integer_sums_keep_their_dtype(rng):
    x = rng.integers(-5, 5, (6, 7)).astype(np.int32)
    _same(linalg.reduce(t(x), axis=1), jl.reduce(x, axis=1))
    _same(linalg.map_reduce(ops.identity_op, ops.add_op, t(x)),
          jl.map_reduce(jops.identity_op, jops.add_op, x))


@pytest.mark.parametrize("reduce_op,init", [("add_op", 0), ("max_op", -10.0),
                                            ("min_op", 10.0)])
def test_map_reduce_matches_reference(mats, reduce_op, init):
    """``init`` joins the fold once. The reference hands it to
    ``lax.reduce``, which may apply it once per partial reduction, so an
    ``init`` that is not idempotent under the op (3 under add) has no
    reference answer to compare with."""
    a, b = mats
    _close(linalg.map_reduce(ops.sqdiff_op, getattr(ops, reduce_op), t(a),
                             t(b), init=init),
           jl.map_reduce(jops.sqdiff_op, getattr(jops, reduce_op), a, b,
                         init=init), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("weighted", [False, True])
def test_reduce_rows_by_key(rng, weighted):
    x = rng.standard_normal((40, 4)).astype(np.float32)
    keys = rng.integers(0, 5, 40)
    keys[:3] = [-1, 5, 7]                   # out of range: dropped
    w = rng.random(40).astype(np.float32) if weighted else None
    got = linalg.reduce_rows_by_key(t(x), t(keys), 5,
                                    weights=None if w is None else t(w))
    _close(got, jl.reduce_rows_by_key(x, keys, 5, weights=w))


def test_reduce_cols_by_key(rng):
    x = rng.standard_normal((4, 30)).astype(np.float32)
    keys = rng.integers(0, 5, 30)
    _close(linalg.reduce_cols_by_key(t(x), t(keys), 5),
           jl.reduce_cols_by_key(x, keys, 5))


def test_mean_squared_error(mats):
    a, b = mats
    _close(linalg.mean_squared_error(t(a), t(b), 0.5),
           jl.mean_squared_error(a, b, 0.5))


@pytest.mark.parametrize("norm_type", ["L1Norm", "L2Norm", "LinfNorm"])
def test_norms_match_reference(mats, norm_type):
    a, _ = mats
    nt, jnt = getattr(linalg, norm_type), getattr(jl, norm_type)
    assert nt.value == jnt.value
    _close(linalg.norm(t(a), nt, axis=0), jl.norm(a, jnt, axis=0))
    _close(linalg.row_norm(t(a), nt), jl.row_norm(a, jnt))
    _close(linalg.col_norm(t(a), nt), jl.col_norm(a, jnt))
    _close(linalg.row_norm(t(a), nt, fin_op=ops.sqrt_op),
           jl.row_norm(a, jnt, fin_op=jops.sqrt_op))
    _close(linalg.normalize(t(a), nt), jl.normalize(a, jnt))


def test_normalize_leaves_zero_rows(mats):
    a, _ = mats
    a[3] = 0
    got = linalg.normalize(t(a))
    _close(got, jl.normalize(a))
    np.testing.assert_array_equal(n(got)[3], 0)
    np.testing.assert_allclose(np.linalg.norm(np.delete(n(got), 3, 0),
                                              axis=1), 1.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# BLAS


def test_gemm_variants(rng):
    a = rng.standard_normal((5, 8)).astype(np.float32)
    b = rng.standard_normal((5, 7)).astype(np.float32)
    c = rng.standard_normal((8, 7)).astype(np.float32)
    _close(linalg.gemm(t(a.T), t(b)), jl.gemm(a.T, b))
    _close(linalg.gemm(t(a), t(b), alpha=2.0, beta=0.5, c=t(c),
                       trans_a=True),
           jl.gemm(a, b, alpha=2.0, beta=0.5, c=c, trans_a=True))
    _close(linalg.gemm(t(b), t(a), trans_a=True, trans_b=False),
           jl.gemm(b, a, trans_a=True))
    _close(linalg.gemm(t(a.T), t(b.T), trans_b=True), jl.gemm(a.T, b.T,
                                                             trans_b=True))


def test_gemm_preferred_element_type(rng):
    a = rng.integers(-4, 4, (6, 5)).astype(np.float32)
    b = rng.integers(-4, 4, (5, 3)).astype(np.float32)
    got = linalg.gemm(t(a).bfloat16(), t(b).bfloat16(),
                      preferred_element_type=torch.float32)
    want = jl.gemm(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    _same(got, want)


def test_gemv_axpy_dot_transpose(rng):
    a = rng.standard_normal((6, 4)).astype(np.float32)
    x = rng.standard_normal(4).astype(np.float32)
    y = rng.standard_normal(6).astype(np.float32)
    _close(linalg.gemv(t(a), t(x)), jl.gemv(a, x))
    _close(linalg.gemv(t(a), t(y), alpha=2.0, beta=-1.0, y=t(x), trans=True),
           jl.gemv(a, y, alpha=2.0, beta=-1.0, y=x, trans=True))
    _same(linalg.axpy(2.0, t(y), t(y)), jl.axpy(2.0, y, y))
    _close(linalg.dot(t(x), t(x)), jl.dot(x, x))
    _same(linalg.transpose(t(a)), jl.transpose(a))


@pytest.mark.parametrize("precision", [None, "default", "high", "highest"])
def test_precision_names_are_taken(rng, precision):
    a = rng.standard_normal((4, 3)).astype(np.float32)
    assert blas.resolve_precision(precision) in blas.PRECISIONS
    _close(linalg.gemm(t(a), t(a.T), precision=precision),
           jl.gemm(a, a.T, precision=precision))


def test_unknown_precision_is_refused(rng):
    a = t(rng.standard_normal((4, 3)).astype(np.float32))
    for bad in ("fastest", "HIGHEST", 3):
        with pytest.raises(LogicError):
            linalg.gemm(a, a.T, precision=bad)
    assert blas.DEFAULT_PRECISION == jl.blas.DEFAULT_PRECISION


# ---------------------------------------------------------------------------
# Decompositions


def _psd(rng, n_):
    a = rng.normal(size=(n_, n_)).astype(np.float32)
    return (a @ a.T + n_ * np.eye(n_)).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_qr_matches_reference(seed):
    rng = np.random.default_rng(400 + seed)
    m = int(rng.integers(4, 120))
    k = int(rng.integers(2, min(m, 40)))
    a = rng.normal(size=(m, k)).astype(np.float32)
    q, r = linalg.qr_get_qr(t(a))
    jq, jr = jl.qr_get_qr(a)
    _cols_up_to_sign(q, jq, rtol=1e-3, atol=1e-4)
    _cols_up_to_sign(r.T, np.asarray(jr).T, rtol=1e-3, atol=1e-4)
    _cols_up_to_sign(linalg.qr_get_q(t(a)), jq, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(n(q.T @ q), np.eye(k), atol=1e-4)
    np.testing.assert_allclose(n(q @ r), a, rtol=1e-3, atol=1e-3)
    assert np.allclose(np.tril(n(r), -1), 0)


@pytest.mark.parametrize("seed", range(6))
def test_eig_matches_reference(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 40))
    a = _psd(rng, k)
    w, v = linalg.eig_dc(t(a))
    jw, jv = jl.eig_dc(a)
    _close(w, jw)
    _cols_up_to_sign(v, jv, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(n(w), np.sort(scipy.linalg.eigvalsh(a)),
                               rtol=1e-5)
    w2, v2 = linalg.eig_jacobi(t(a))
    _same(w2, n(w))
    _same(v2, n(v))


@pytest.mark.parametrize("smallest", [True, False])
def test_eig_sel_dc(rng, smallest):
    a = _psd(rng, 12)
    w, v = decomp.eig_sel_dc(t(a), 4, smallest=smallest)
    jw, jv = jl.decomp.eig_sel_dc(a, 4, smallest=smallest)
    _close(w, jw)
    _cols_up_to_sign(v, jv, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("seed", range(6))
def test_svd_qr_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    m = int(rng.integers(3, 80))
    k = int(rng.integers(2, m + 1))
    a = rng.normal(size=(m, k)).astype(np.float32)
    u, s, v = linalg.svd_qr(t(a))
    ju, js, jv = jl.svd_qr(a)
    _close(s, js)
    _cols_up_to_sign(u, ju, rtol=1e-3, atol=2e-3)
    _cols_up_to_sign(v, jv, rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(n(u @ torch.diag(s) @ v.T), a, rtol=1e-2,
                               atol=1e-3 * m)
    none_u, s2, none_v = linalg.svd_qr(t(a), gen_u=False, gen_v=False)
    assert none_u is None and none_v is None and torch.equal(s2, s)


@pytest.mark.parametrize("seed", range(4))
def test_svd_eig_matches_reference(seed):
    rng = np.random.default_rng(700 + seed)
    a = rng.normal(size=(int(rng.integers(12, 60)), 4)).astype(np.float32)
    u, s, v = linalg.svd_eig(t(a))
    ju, js, jv = jl.svd_eig(a)
    _close(s, js, rtol=1e-5, atol=1e-4)
    _cols_up_to_sign(u, ju, rtol=1e-3, atol=1e-3)
    _cols_up_to_sign(v, jv, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(n(u @ torch.diag(s) @ v.T), a, atol=2e-3)


@pytest.mark.parametrize("seed", range(4))
def test_rsvd_recovers_exactly_low_rank_input(seed):
    rng = np.random.default_rng(200 + seed)
    m = int(rng.integers(40, 200))
    k_cols = int(rng.integers(20, m))
    rank = int(rng.integers(2, 10))
    a = (rng.normal(size=(m, rank)) @ rng.normal(size=(rank, k_cols))
         ).astype(np.float32)
    h = DeviceResources("cpu", seed=seed)
    u, s, v = linalg.rsvd(t(a), rank, p=8, n_iters=2, handle=h)
    ju, js, jv = jl.rsvd(a, rank, p=8, n_iters=2)
    np.testing.assert_allclose(n(s), np.asarray(js), rtol=1e-4)
    np.testing.assert_allclose(n(s), scipy.linalg.svdvals(a)[:rank],
                               rtol=1e-4)
    np.testing.assert_allclose(n(u @ torch.diag(s) @ v.T), a, rtol=1e-3,
                               atol=1e-3 * np.abs(a).max())
    _cols_up_to_sign(u, ju, rtol=1e-3, atol=1e-3)
    _cols_up_to_sign(v, jv, rtol=1e-3, atol=1e-3)


def test_rsvd_sketch_comes_from_the_handle_and_seed(rng):
    a = t(rng.standard_normal((30, 12)).astype(np.float32))
    one = linalg.rsvd(a, 3, n_iters=0, handle=DeviceResources("cpu", seed=1))
    again = linalg.rsvd(a, 3, n_iters=0, handle=DeviceResources("cpu",
                                                                seed=1))
    other = linalg.rsvd(a, 3, n_iters=0, handle=DeviceResources("cpu",
                                                                seed=2))
    salted = linalg.rsvd(a, 3, n_iters=0, seed=5,
                         handle=DeviceResources("cpu", seed=1))
    assert torch.equal(one[0], again[0])
    assert not torch.equal(one[0], other[0])
    assert not torch.equal(one[0], salted[0])
    assert linalg.rsvd(a, 3)[1].shape == (3,)        # a handle on a's device


@pytest.mark.parametrize("seed", range(5))
def test_lstsq_matches_reference(seed):
    rng = np.random.default_rng(300 + seed)
    m = int(rng.integers(10, 150))
    k = int(rng.integers(2, min(m, 30)))
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=m).astype(np.float32)
    _close(linalg.lstsq_svd(t(a), t(b)), jl.lstsq_svd(a, b), rtol=1e-4,
           atol=1e-5)
    _close(linalg.lstsq_eig(t(a), t(b)), jl.lstsq_eig(a, b), rtol=1e-4,
           atol=1e-5)
    want, *_ = scipy.linalg.lstsq(a, b)
    np.testing.assert_allclose(n(linalg.lstsq_svd(t(a), t(b))), want,
                               rtol=1e-2, atol=1e-2)


def test_lstsq_multi_target(rng):
    a = rng.standard_normal((12, 4)).astype(np.float32)
    b = rng.standard_normal((12, 3)).astype(np.float32)
    _close(linalg.lstsq_svd(t(a), t(b)), jl.lstsq_svd(a, b), rtol=1e-4,
           atol=1e-5)
    _close(linalg.lstsq_eig(t(a), t(b)), jl.lstsq_eig(a, b), rtol=1e-4,
           atol=1e-5)


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("size", [1, 5, 24])
def test_cholesky_rank_one_update(rng, lower, size):
    a = rng.standard_normal((size, size)).astype(np.float32)
    spd = a @ a.T + size * np.eye(size, dtype=np.float32)
    v = rng.standard_normal(size).astype(np.float32)
    lo = np.linalg.cholesky(spd).astype(np.float32)
    l_in = lo if lower else np.ascontiguousarray(lo.T)
    before = l_in.copy()
    got = linalg.cholesky_rank_one_update(t(l_in), t(v), lower=lower)
    want = jl.cholesky_rank_one_update(l_in, v, lower=lower)
    _close(got, want)
    np.testing.assert_array_equal(l_in, before)        # input kept
    lg = n(got) if lower else n(got).T
    np.testing.assert_allclose(lg @ lg.T, spd + np.outer(v, v), rtol=1e-4,
                               atol=1e-4 * size)
