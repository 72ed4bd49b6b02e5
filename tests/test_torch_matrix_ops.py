"""raft_tpu_torch.matrix's ops against raft_tpu.matrix's.

Mirrors tests/test_matrix.py (its matrix-op cases) and
tests/test_matrix_properties.py over seeded random shapes. Every op moves,
selects or compares values without arithmetic, so each agrees with the
reference bit for bit, values and dtypes (int32 indices); ``argmin`` /
``argmax`` take the first index on ties and ``col_wise_sort`` is stable,
as the reference's. Only ``l2_norm`` sums, and is held at rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import matrix as jm
from raft_tpu_torch import matrix
from test_torch_common import n, t


def _same(got, want):
    got, want = n(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("seed", range(5))
def test_argminmax(seed):
    rng = np.random.default_rng(seed)
    m, k = int(rng.integers(1, 70)), int(rng.integers(1, 300))
    a = _rand(rng, m, k)
    for axis in (0, 1):
        _same(matrix.argmax(t(a), axis), jm.argmax(a, axis))
        _same(matrix.argmin(t(a), axis), jm.argmin(a, axis))


def test_argminmax_ties_take_the_first_index(rng):
    a = rng.integers(0, 3, (40, 17)).astype(np.float32)
    _same(matrix.argmin(t(a)), jm.argmin(a))
    _same(matrix.argmax(t(a)), jm.argmax(a))
    np.testing.assert_array_equal(n(matrix.argmin(t(a))), a.argmin(1))


@pytest.mark.parametrize("seed", range(5))
def test_gather_scatter_roundtrip(seed):
    rng = np.random.default_rng(10 + seed)
    m, k = int(rng.integers(4, 100)), int(rng.integers(2, 40))
    a = _rand(rng, m, k)
    rows = int(rng.integers(1, m + 1))
    idx = rng.choice(m, size=rows, replace=False).astype(np.int32)
    g = matrix.gather(t(a), t(idx))
    _same(g, jm.gather(a, idx))
    shift = lambda i: (i + 1) % m      # noqa: E731
    _same(matrix.gather(t(a), t(idx), shift), jm.gather(a, idx, shift))
    fresh = _rand(rng, rows, k)
    _same(matrix.scatter(t(a), t(idx), t(fresh)),
          jm.scatter(jnp.asarray(a), jnp.asarray(idx), jnp.asarray(fresh)))
    _same(matrix.scatter(t(a), t(idx), g), a)


@pytest.mark.parametrize("seed", range(3))
def test_gather_if(seed):
    rng = np.random.default_rng(60 + seed)
    m, k = int(rng.integers(5, 60)), int(rng.integers(2, 20))
    a = _rand(rng, m, k)
    rows = int(rng.integers(1, m))
    idx = rng.integers(0, m, size=rows).astype(np.int32)
    stencil = rng.integers(0, 2, size=rows).astype(np.int32)
    _same(matrix.gather_if(t(a), t(idx), t(stencil), lambda s: s > 0,
                           fallback=-2.0),
          jm.gather_if(a, idx, stencil, lambda s: s > 0, fallback=-2.0))


@pytest.mark.parametrize("seed", range(4))
def test_col_wise_sort(seed):
    rng = np.random.default_rng(20 + seed)
    m, k = int(rng.integers(2, 80)), int(rng.integers(1, 30))
    a = rng.integers(0, 5, (m, k)).astype(np.float32) if seed % 2 \
        else _rand(rng, m, k)
    _same(matrix.col_wise_sort(t(a)), jm.col_wise_sort(a))
    s, i = matrix.col_wise_sort(t(a), return_indices=True)
    js, ji = jm.col_wise_sort(a, return_indices=True)
    _same(s, js)
    _same(i, ji)                       # stable: ties keep row order


@pytest.mark.parametrize("seed", range(4))
def test_reverse_slice_triangular_copy(seed):
    rng = np.random.default_rng(30 + seed)
    m, k = int(rng.integers(3, 60)), int(rng.integers(3, 60))
    a = _rand(rng, m, k)
    for along in (True, False):
        _same(matrix.reverse(t(a), along_rows=along),
              jm.reverse(a, along_rows=along))
    r0, r1 = sorted(rng.integers(0, m, 2))
    c0, c1 = sorted(rng.integers(0, k, 2))
    _same(matrix.slice_(t(a), r0, c0, r1 + 1, c1 + 1),
          jm.slice_(a, r0, c0, r1 + 1, c1 + 1))
    sq = a[:min(m, k), :min(m, k)]
    _same(matrix.triangular_upper(t(sq)), jm.triangular_upper(sq))
    src = t(a)
    cp = matrix.copy(src)
    _same(cp, jm.copy(a))
    cp[0, 0] = 99.0
    assert src[0, 0] != 99.0


def test_init(rng):
    _same(matrix.init((2, 3), 3.0, device="cpu"), jm.init((2, 3), 3.0))
    _same(matrix.init((4,), 7, dtype=np.int32, device="cpu"),
          jm.init((4,), 7, dtype=jnp.int32))


@pytest.mark.parametrize("seed", range(4))
def test_sign_flip(seed):
    rng = np.random.default_rng(40 + seed)
    m, k = int(rng.integers(2, 50)), int(rng.integers(1, 20))
    a = _rand(rng, m, k)
    a[:, 0] = 0.0                       # a zero column keeps its sign
    _same(matrix.sign_flip(t(a)), jm.sign_flip(a))


@pytest.mark.parametrize("seed", range(4))
def test_linewise_row_and_col(seed):
    rng = np.random.default_rng(50 + seed)
    m, k = int(rng.integers(2, 60)), int(rng.integers(2, 60))
    a = _rand(rng, m, k)
    vrow, vcol = _rand(rng, k), _rand(rng, m)
    _same(matrix.linewise_op(t(a), t(vrow), op=torch.add, along_lines=True),
          jm.linewise_op(a, vrow, op=jnp.add, along_lines=True))
    _same(matrix.linewise_op(t(a), t(vcol), op=torch.multiply,
                             along_lines=False),
          jm.linewise_op(a, vcol, op=jnp.multiply, along_lines=False))
    f = lambda x, u, v: (x - u) * v    # noqa: E731
    _same(matrix.linewise_op(t(a), [t(vrow), t(vrow)], op=f),
          jm.linewise_op(a, [vrow, vrow], op=f))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("sign", [1, -1])
def test_shift_fill(seed, sign):
    rng = np.random.default_rng(80 + seed)
    m, k = int(rng.integers(2, 40)), int(rng.integers(3, 40))
    a = _rand(rng, m, k)
    shift = sign * int(rng.integers(1, k))
    _same(matrix.shift_fill(t(a), shift, fill_value=-1.0),
          jm.shift_fill(a, shift, fill_value=-1.0))


def test_l2_norm(rng):
    a = _rand(rng, 37, 53)
    np.testing.assert_allclose(float(matrix.l2_norm(t(a))),
                               float(jm.l2_norm(a)), rtol=1e-5)
    b = rng.integers(-3, 3, (9, 4)).astype(np.int32)
    np.testing.assert_allclose(float(matrix.l2_norm(t(b))),
                               float(jm.l2_norm(b)), rtol=1e-5)
