"""raft_tpu_torch's gram kernels and masked L2 nearest neighbor against
raft_tpu's.

Mirrors the ``masked_l2_nn`` and ``kernel_factory`` cases of
tests/test_distance.py. Tolerances:

* gram kernels: rtol 1e-5 (atol 1e-5), the products summed in another
  order;
* ``masked_l2_nn`` on integer-valued rows: distances equal and ids bit
  for bit, ties included (the lowest index wins); on Gaussian rows:
  distances within rtol 1e-5, ids equal but at near-ties within that
  tolerance; a row with no allowed group gives ``(inf, -1)`` in both.
"""

import importlib

import numpy as np
import pytest
import torch

from raft_tpu.distance import kernels as jkernels
from raft_tpu.distance.distance_types import KernelType as JKernelType
from raft_tpu.distance.masked_nn import masked_l2_nn as jmasked
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.distance import (GramMatrixBase, KernelParams,
                                     KernelType, PolynomialKernel, RBFKernel,
                                     TanhKernel, kernel_factory, masked_l2_nn)
from test_torch_common import gauss, int_data, n, t

masked_mod = importlib.import_module("raft_tpu_torch.distance.masked_nn")
TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Gram kernels


def test_kernel_vocabulary_matches_reference():
    assert [(k.name, k.value) for k in KernelType] == [
        (k.name, k.value) for k in JKernelType]
    p, jp = KernelParams(), jkernels.KernelParams()
    assert (p.kernel.value, p.degree, p.gamma, p.coef0) == (
        jp.kernel.value, jp.degree, jp.gamma, jp.coef0)


@pytest.mark.parametrize("kind", ["LINEAR", "POLYNOMIAL", "TANH", "RBF"])
@pytest.mark.parametrize("params", [dict(), dict(degree=2, gamma=0.5,
                                                 coef0=1.0),
                                    dict(degree=3, gamma=0.05, coef0=-0.3)])
def test_kernel_factory_matches_reference(rng, kind, params):
    x, y = gauss(rng, (12, 5)), gauss(rng, (9, 5))
    k = kernel_factory(KernelParams(KernelType[kind], **params))
    jk = jkernels.kernel_factory(jkernels.KernelParams(JKernelType[kind],
                                                       **params))
    assert type(k).__name__ == type(jk).__name__
    got = k(t(x), t(y))
    assert got.dtype == torch.float32 and tuple(got.shape) == (12, 9)
    np.testing.assert_allclose(n(got), np.asarray(jk(x, y)), **TOL)


def test_kernel_classes_direct(rng):
    x, y = gauss(rng, (7, 4)), gauss(rng, (6, 4))
    pairs = [(GramMatrixBase(), jkernels.GramMatrixBase()),
             (PolynomialKernel(2, 0.5, 1.0),
              jkernels.PolynomialKernel(2, 0.5, 1.0)),
             (TanhKernel(0.3, 0.1), jkernels.TanhKernel(0.3, 0.1)),
             (RBFKernel(0.7), jkernels.RBFKernel(0.7))]
    for k, jk in pairs:
        np.testing.assert_allclose(n(k(t(x), y)), np.asarray(jk(x, y)),
                                   **TOL)
        np.testing.assert_allclose(n(k.evaluate(t(x), t(y))),
                                   np.asarray(jk.evaluate(x, y)), **TOL)


def test_unknown_kernel_is_refused():
    with pytest.raises(ValueError):
        kernel_factory(KernelParams(kernel=7))


# ---------------------------------------------------------------------------
# masked_l2_nn


def _case(rng, m, groups, kind, d=6):
    """x (m, d), y in ``len(groups)`` groups of the given sizes, a random
    adjacency with row 0 allowing no group."""
    ny = int(sum(groups))
    make = int_data if kind == "int" else gauss
    x, y = make(rng, (m, d)), make(rng, (ny, d))
    group_idxs = np.cumsum(groups).astype(np.int32)
    adj = rng.integers(0, 2, (m, len(groups))).astype(bool)
    adj[0] = False
    return x, y, adj, group_idxs


def _check(got, want, exact, x=None, y=None):
    """Distances and ids against the reference's; where ids differ (only
    when not ``exact``), the two rows of ``y`` lie within the tolerance
    of each other from the row of ``x`` (a near-tie)."""
    d, i = got
    jd, ji = want
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    d, i, jd, ji = n(d), n(i), np.asarray(jd), np.asarray(ji)
    np.testing.assert_array_equal(np.isinf(d), np.isinf(jd))
    if exact:
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_array_equal(d, jd)
        return
    np.testing.assert_allclose(d, jd, **TOL)
    for r in np.flatnonzero(i != ji):
        near = [np.sum((x[r].astype(np.float64) - y[j]) ** 2)
                for j in (i[r], ji[r])]
        assert abs(near[0] - near[1]) <= 1e-5 * max(near) + 1e-5, r


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("groups", [(10, 8, 12), (1, 40, 3, 3, 30),
                                    (25,)])
def test_masked_l2_nn_matches_reference(rng, kind, sqrt, groups):
    x, y, adj, gi = _case(rng, 20, groups, kind)
    got = masked_l2_nn(t(x), t(y), t(adj), t(gi), sqrt=sqrt)
    _check(got, jmasked(x, y, adj, gi, sqrt=sqrt), kind == "int", x, y)
    assert n(got[1])[0] == -1 and np.isinf(n(got[0])[0])


def test_masked_l2_nn_ties_go_to_the_lowest_index(rng):
    """Duplicate rows in two allowed groups: the first copy wins."""
    x = int_data(rng, (6, 4))
    y = np.concatenate([x[::-1], x, x]).astype(np.float32)   # 3 groups of 6
    gi = np.array([6, 12, 18], np.int32)
    adj = np.ones((6, 3), bool)
    adj[:, 0] = False
    got = masked_l2_nn(t(x), t(y), t(adj), t(gi))
    _check(got, jmasked(x, y, adj, gi), True)
    np.testing.assert_array_equal(n(got[1]), 6 + np.arange(6))
    np.testing.assert_array_equal(n(got[0]), 0)


def test_masked_l2_nn_all_masked_and_empty_groups(rng):
    x, y = int_data(rng, (5, 3)), int_data(rng, (8, 3))
    gi = np.array([0, 8, 8], np.int32)          # empty first and last group
    adj = np.zeros((5, 3), bool)
    adj[1:, 0] = True                           # allows only the empty one
    adj[4, 1] = True
    got = masked_l2_nn(t(x), t(y), t(adj), t(gi))
    _check(got, jmasked(x, y, adj, gi), True)
    np.testing.assert_array_equal(n(got[1])[:4], -1)
    assert np.isinf(n(got[0])[:4]).all() and n(got[1])[4] >= 0


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("tile", [1, 3, 7])
def test_tiling_changes_no_answer(rng, monkeypatch, tile, kind):
    """Tiles of 1, 3 and 7 rows of x (the last ragged) give one tile's
    answer: the same bits on integer-valued rows; on Gaussian rows the
    product of another tile shape may round otherwise (rtol 1e-6)."""
    x, y, adj, gi = _case(rng, 23, (9, 14, 6), kind)
    whole = masked_l2_nn(t(x), t(y), t(adj), t(gi))
    monkeypatch.setattr(masked_mod, "_TILE_ELEMS", tile * y.shape[0])
    assert masked_mod.tile_rows(23, y.shape[0]) == tile
    tiled = masked_l2_nn(t(x), t(y), t(adj), t(gi))
    assert torch.equal(whole[1], tiled[1])
    if kind == "int":
        assert torch.equal(whole[0], tiled[0])
    else:
        np.testing.assert_allclose(n(tiled[0]), n(whole[0]), rtol=1e-6)


def test_masked_l2_nn_refusals_and_precision(rng):
    x, y, adj, gi = _case(rng, 4, (3, 3), "int")
    with pytest.raises(LogicError):
        masked_l2_nn(t(x), t(y[:, :5]), t(adj), t(gi))
    with pytest.raises(LogicError):
        masked_l2_nn(t(x), t(y), t(adj[:, :1]), t(gi))
    with pytest.raises(LogicError):
        masked_l2_nn(t(x), t(y), t(adj), t(gi), precision="fastest")
    for p in (None, "default", "high", "highest"):
        _check(masked_l2_nn(t(x), t(y), t(adj), t(gi), False, p),
               jmasked(x, y, adj, gi, False, p), True)


def test_masked_l2_nn_numpy_inputs_follow_x(rng):
    """Only x picks the device: y, adj and group_idxs follow it."""
    x, y, adj, gi = _case(rng, 6, (4, 5), "int")
    got = masked_l2_nn(t(x), y, adj, gi)
    _check(got, jmasked(x, y, adj, gi), True)
    xi, yi = x.astype(np.int32), y.astype(np.int32)
    _check(masked_l2_nn(t(xi), yi, adj, gi), jmasked(xi, yi, adj, gi), True)
