"""raft_tpu_torch.random against raft_tpu.random.

Mirrors tests/test_random.py and tests/test_random_properties.py. The two
packages draw from different generators (JAX's threefry, torch's
Philox / CPU Mersenne twister), so the parity is statistical: shapes,
dtypes and supports equal, moments and Kolmogorov-Smirnov p-values held
to each distribution's own values as the reference's tests hold them, on
both packages' draws. What takes no draw (``rng_fill``, the quadrant rule
of ``rmat_rectangular_gen`` on a given uniform matrix, the covariance
factor of ``multi_variable_gaussian`` on given normals) is held bit for
bit or within rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from raft_tpu_torch.core.error import CudaError
from raft_tpu_torch.random import RngState


def test_generator_defaults_to_the_card():
    """Without a device, ``RngState`` gives a ``cuda`` generator, never a
    CPU one; without a card it raises. ``"cpu"`` still works."""
    state = RngState(seed=3)
    if torch.cuda.is_available():
        assert state.generator().device.type == "cuda"
        assert state.next_generator().device.type == "cuda"
    else:
        with pytest.raises(CudaError, match="cuda"):
            state.generator()
        with pytest.raises(CudaError, match="cuda"):
            state.next_generator()
        assert state.base_subsequence == 0
    g = state.generator("cpu")
    assert g.device.type == "cpu"
    a = torch.rand(4, generator=g)
    b = torch.rand(4, generator=RngState(seed=3).generator("cpu"))
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Draws: both packages' samples held to the distribution.

import jax
import jax.numpy as jnp
import scipy.stats

from raft_tpu import random as jr
from raft_tpu.random import RngState as JState
from raft_tpu.random import rmat as jrmat
from raft_tpu_torch import random as tr
from raft_tpu_torch.random import rmat as trmat
from raft_tpu_torch.random import rng as trng
from test_torch_common import n, t

N = 20_000
ALPHA = 1e-3   # KS p-value floor; the seeds are fixed
CPU = dict(device="cpu")


def _both(name, seed, *args, **kwargs):
    """The reference's and the port's draw of ``name`` from one seed."""
    ref = np.asarray(getattr(jr, name)(JState(seed), *args, **kwargs))
    got = getattr(tr, name)(RngState(seed), *args, **kwargs, **CPU)
    return ref, got


# name, args, scipy distribution and its parameters
_CONTINUOUS = [
    ("uniform", (-2.0, 3.0), "uniform", (-2.0, 5.0)),
    ("normal", (1.5, 2.0), "norm", (1.5, 2.0)),
    ("lognormal", (0.5, 0.7), "lognorm", (0.7, 0, np.exp(0.5))),
    ("exponential", (1.8,), "expon", (0, 1 / 1.8)),
    ("gumbel", (0.4, 1.3), "gumbel_r", (0.4, 1.3)),
    ("logistic", (0.2, 0.9), "logistic", (0.2, 0.9)),
    ("laplace", (-0.3, 1.1), "laplace", (-0.3, 1.1)),
    ("rayleigh", (1.6,), "rayleigh", (0, 1.6)),
]


@pytest.mark.parametrize("name,args,dist,params", _CONTINUOUS,
                         ids=[c[0] for c in _CONTINUOUS])
def test_continuous_draws_follow_their_distribution(name, args, dist,
                                                    params):
    ref, got = _both(name, 3, (N,), *args)
    assert got.shape == ref.shape == (N,)
    assert n(got).dtype == ref.dtype == np.float32
    assert np.isfinite(n(got)).all()
    for sample in (ref, n(got)):
        assert scipy.stats.kstest(sample, dist, args=params).pvalue > ALPHA
    # Mean within 6 standard errors of the distribution's.
    mean, var = getattr(scipy.stats, dist).stats(*params, moments="mv")
    assert abs(n(got).mean() - mean) < 6 * np.sqrt(var / N)


@pytest.mark.parametrize("name,args", [(c[0], c[1]) for c in _CONTINUOUS],
                         ids=[c[0] for c in _CONTINUOUS])
@pytest.mark.parametrize("dtype", ["float64", "float16", "bfloat16"])
def test_draw_dtypes_follow_the_reference(name, args, dtype):
    """float64 maps to float32 as in the reference (x64 off); the half
    types stay. The port takes the dtype's name (or a torch dtype)."""
    ref = np.asarray(getattr(jr, name)(JState(4), (3, 5), *args,
                                       dtype=getattr(jnp, dtype)))
    got = getattr(tr, name)(RngState(4), (3, 5), *args, dtype=dtype, **CPU)
    assert got.shape == ref.shape == (3, 5)
    want = {"float64": torch.float32, "float16": torch.float16,
            "bfloat16": torch.bfloat16}[dtype]
    assert got.dtype == want
    assert str(ref.dtype) == str(want).replace("torch.", "")


def test_uniform_int_support_and_flatness():
    ref, got = _both("uniformInt", 11, (N,), 5, 25)
    assert n(got).dtype == ref.dtype == np.int32
    for s in (ref, n(got)):
        assert s.min() >= 5 and s.max() < 25
        np.testing.assert_allclose(np.bincount(s - 5, minlength=20) / N,
                                   1 / 20, atol=0.02)


def test_normal_int_rounds_a_normal():
    ref, got = _both("normalInt", 2, (N,), 3.0, 2.0)
    assert n(got).dtype == ref.dtype == np.int32
    for s in (ref, n(got)):
        assert abs(s.mean() - 3.0) < 0.1 and abs(s.std() - 2.0) < 0.1


def test_bernoulli_frequency():
    p = 0.37
    ref, got = _both("bernoulli", 9, (N,), p)
    assert n(got).dtype == ref.dtype == np.bool_
    for s in (ref, n(got)):
        assert abs(s.mean() - p) < 5 * np.sqrt(p * (1 - p) / N)


def test_scaled_bernoulli_signs():
    ref, got = _both("scaled_bernoulli", 8, (N,), 0.3, 2.0)
    for s in (ref, n(got)):
        assert set(np.unique(s)) == {-2.0, 2.0}
        # -scale where u > prob: P(-scale) = 1 - prob.
        assert abs((s < 0).mean() - 0.7) < 5 * np.sqrt(0.21 / N)


@pytest.mark.parametrize("w", [[0.1, 0.5, 0.15, 0.25], [0.0, 1.0, 0.0, 3.0]])
def test_discrete_matches_weights(w):
    ref, got = _both("discrete", 10, (N,), np.asarray(w, np.float32))
    assert n(got).dtype == ref.dtype == np.int32
    want = np.asarray(w) / np.sum(w)
    for s in (ref, n(got)):
        np.testing.assert_allclose(np.bincount(s, minlength=4) / N, want,
                                   atol=0.02)
    assert set(np.unique(n(got))) == set(np.flatnonzero(want))


def test_rng_fill_is_bit_for_bit():
    ref, got = _both("rng_fill", 0, (4, 3), 2.5)
    np.testing.assert_array_equal(n(got), ref)
    assert n(got).dtype == ref.dtype


def test_reproducible_streams():
    a = tr.uniform(RngState(42), 100, **CPU)
    assert torch.equal(a, tr.uniform(RngState(42), 100, **CPU))
    assert not torch.equal(a, tr.uniform(RngState(42, base_subsequence=1),
                                         100, **CPU))
    state = RngState(42)
    tr.uniform(state, 100, **CPU)
    assert state.base_subsequence == 1     # one draw, one advance


def test_draws_go_to_the_card_by_default():
    if torch.cuda.is_available():
        assert tr.normal(RngState(1), 4).device.type == "cuda"
    else:
        with pytest.raises(CudaError):
            tr.normal(RngState(1), 4)
        with pytest.raises(CudaError):
            tr.make_blobs(10, 2)


# ---------------------------------------------------------------------------
# Sampling


def test_sample_without_replacement_distinct():
    for idx in (np.asarray(jr.sample_without_replacement(JState(1), 100,
                                                         50)[1]),
                n(tr.sample_without_replacement(RngState(1), 100, 50,
                                                **CPU)[1])):
        assert idx.dtype == np.int32
        assert len(np.unique(idx)) == 50
        assert idx.min() >= 0 and idx.max() < 100


def test_sample_without_replacement_weighted_bias():
    w = np.ones(100)
    w[:10] = 1000.0
    hits = 0
    for s in range(20):
        _, idx = tr.sample_without_replacement(RngState(s), 100, 10,
                                               weights=w, **CPU)
        hits += np.isin(n(idx), np.arange(10)).sum()
    assert hits > 150


def test_sample_without_replacement_uniformity():
    n_items, k, reps = 50, 10, 300
    counts = np.zeros(n_items)
    state = RngState(seed=12)
    for _ in range(reps):
        _, out = tr.sample_without_replacement(state, n_items, k, **CPU)
        counts[n(out)] += 1
    np.testing.assert_allclose(counts / reps, k / n_items, atol=0.08)


def test_sample_without_replacement_keys_and_ties_equal_reference(
        monkeypatch):
    """Given the same Gumbel noise, both packages pick the same indices,
    bit for bit: ties (here every third key) go to the lowest index."""
    rng = np.random.default_rng(5)
    g = rng.standard_normal(60).astype(np.float32)
    g[::3] = 0.5
    inputs = rng.standard_normal((60, 3)).astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype=None: jnp.asarray(g))
    monkeypatch.setattr(trng, "gumbel",
                        lambda state, shape, device=None: t(g))
    r_out, r_idx = jr.sample_without_replacement(JState(0), 60, 25,
                                                 inputs=inputs)
    p_out, p_idx = tr.sample_without_replacement(RngState(0), 60, 25,
                                                 inputs=t(inputs))
    np.testing.assert_array_equal(n(p_idx), np.asarray(r_idx))
    np.testing.assert_array_equal(n(p_out), np.asarray(r_out))


def test_sample_without_replacement_refuses_too_many():
    from raft_tpu_torch.core.error import LogicError

    with pytest.raises(LogicError):
        tr.sample_without_replacement(RngState(0), 5, 6, **CPU)


def test_permute():
    perm = tr.permute(RngState(13), 400, **CPU)
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(np.sort(n(perm)), np.arange(400))
    x = np.arange(20, dtype=np.float32).reshape(10, 2)
    out, perm = tr.permute(RngState(2), 10, t(x))
    np.testing.assert_array_equal(n(out), x[n(perm)])
    out, perm = tr.permute(RngState(2), 2, t(x), rows=False)
    np.testing.assert_array_equal(n(out), x[:, n(perm)])


@pytest.mark.parametrize("method", ["cholesky", "jacobi"])
def test_multi_variable_gaussian_moments(method):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 4)).astype(np.float32)
    cov = (a @ a.T + 4 * np.eye(4)).astype(np.float32)
    mu = np.asarray([1.0, -2.0, 0.5, 3.0], np.float32)
    for s in (np.asarray(jr.multi_variable_gaussian(JState(14), mu, cov,
                                                    30_000, method=method)),
              n(tr.multi_variable_gaussian(RngState(14), mu, cov, 30_000,
                                           method=method, **CPU))):
        assert s.shape == (30_000, 4) and s.dtype == np.float32
        np.testing.assert_allclose(s.mean(0), mu, atol=0.1)
        np.testing.assert_allclose(np.cov(s.T), cov, rtol=0.1, atol=0.3)


@pytest.mark.parametrize("method", ["cholesky", "jacobi"])
def test_multi_variable_gaussian_on_given_normals(monkeypatch, method):
    """On the same normal draws, the samples equal the reference's within
    rtol 1e-5: the factor differs only in rounding (and, for jacobi, in
    each eigenvector's sign, which z's symmetry absorbs only in law; so
    jacobi is held through F F^T = cov instead)."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(6, 6)).astype(np.float32)
    cov = (a @ a.T + np.eye(6)).astype(np.float32)
    mu = rng.normal(size=6).astype(np.float32)
    z = rng.standard_normal((50, 6)).astype(np.float32)
    factor = trng._mvg_factor(t(cov), method)
    np.testing.assert_allclose(n(factor @ factor.T), cov, rtol=1e-4,
                               atol=1e-4 * np.abs(cov).max())
    if method == "jacobi":
        return
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(z))
    ref = np.asarray(jr.multi_variable_gaussian(JState(0), mu, cov, 50,
                                                method=method))
    got = t(mu)[None, :] + t(z) @ factor.T
    np.testing.assert_allclose(n(got), ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Dataset generators


def test_make_blobs_shapes_and_balanced_labels():
    ref_x, ref_y = jr.make_blobs(503, 8, n_clusters=4, seed=3)
    x, y = tr.make_blobs(503, 8, n_clusters=4, seed=3, **CPU)
    assert x.shape == ref_x.shape == (503, 8)
    assert n(y).dtype == np.asarray(ref_y).dtype == np.int32
    assert n(x).dtype == np.asarray(ref_x).dtype
    # Row i is cluster i % k before the shuffle: the counts are exact.
    np.testing.assert_array_equal(np.bincount(n(y)),
                                  np.bincount(np.asarray(ref_y)))
    _, y_plain = tr.make_blobs(10, 2, n_clusters=3, shuffle=False, **CPU)
    np.testing.assert_array_equal(n(y_plain), np.arange(10) % 3)


def test_make_blobs_tight_clusters_and_box():
    x, y = tr.make_blobs(600, 4, n_clusters=3, cluster_std=0.01, seed=1,
                         **CPU)
    x, y = n(x), n(y)
    for c in range(3):
        assert x[y == c].std(0).max() < 0.05
        assert np.all(np.abs(x[y == c].mean(0)) <= 10.0 + 0.05)


def test_make_blobs_given_centers():
    centers = np.array([[0.0, 0.0], [100.0, 100.0]], np.float32)
    x, y = tr.make_blobs(100, 2, centers=centers, cluster_std=0.1, seed=0,
                         **CPU)
    np.testing.assert_allclose(n(x)[n(y) == 1].mean(0), [100, 100],
                               atol=1.0)
    # A centers tensor keeps its device, and n_clusters follows it.
    x, y = tr.make_blobs(100, 2, n_clusters=7, centers=t(centers))
    assert x.device.type == "cpu" and set(n(y)) == {0, 1}


def test_make_blobs_per_feature_std():
    std = np.array([0.01, 5.0], np.float32)
    x, y = tr.make_blobs(4000, 2, n_clusters=1, cluster_std=std, seed=2,
                         **CPU)
    np.testing.assert_allclose(n(x).std(0), std, rtol=0.1)


def test_make_regression_exact_without_noise():
    for x, y, coef in (jr.make_regression(50, 6, noise=0.0, shuffle=False,
                                          seed=0),
                       tr.make_regression(50, 6, noise=0.0, shuffle=False,
                                          seed=0, **CPU)):
        np.testing.assert_allclose(n(y), n(x) @ n(coef), atol=1e-3)
    x, y, coef = tr.make_regression(40, 8, n_informative=3, n_targets=2,
                                    bias=1.5, seed=4, **CPU)
    assert x.shape == (40, 8) and y.shape == (40, 2) and coef.shape == (8, 2)
    assert (n(coef).any(axis=1)).sum() == 3
    assert n(coef).min() >= 0 and n(coef).max() < 100
    np.testing.assert_allclose(n(y), n(x) @ n(coef) + 1.5, rtol=1e-5,
                               atol=1e-3)
    x, y, coef = tr.make_regression(4000, 3, noise=2.0, seed=4, **CPU)
    resid = n(y) - n(x) @ n(coef)
    assert abs(resid.std() - 2.0) < 0.1


# ---------------------------------------------------------------------------
# R-MAT


@pytest.mark.parametrize("theta", [
    np.array([0.5, 0.25, 0.125, 0.125], np.float32),
    np.array([[0.5, 0.25, 0.125, 0.125], [0.25, 0.25, 0.25, 0.25],
              [0.125, 0.125, 0.25, 0.5], [0.75, 0.125, 0.0625, 0.0625],
              [0.5, 0.5, 0.0, 0.0], [0.0, 0.0, 0.5, 0.5]], np.float32),
], ids=["vector", "per-level"])
@pytest.mark.parametrize("r_scale,c_scale", [(6, 6), (4, 6), (6, 3)])
def test_rmat_bit_for_bit_on_given_draws(monkeypatch, theta, r_scale,
                                         c_scale):
    """One uniform matrix handed to both: the same edges, bit for bit
    (dyadic theta keeps the cumulative sums exact in both)."""
    depth = max(r_scale, c_scale)
    u = np.random.default_rng(depth).random((3000, depth), np.float32)
    fake = type("J", (), {"random": type("R", (), {
        "uniform": staticmethod(lambda key, shape: jnp.asarray(u))})})
    monkeypatch.setattr(jrmat, "jax", fake)
    r_src, r_dst = jr.rmat_rectangular_gen(JState(0), theta, r_scale,
                                           c_scale, 3000)
    levels = trmat._theta_levels(theta, depth, torch.device("cpu"))
    src, dst = trmat._edges(levels, r_scale, c_scale, t(u))
    assert src.dtype == dst.dtype == torch.int32
    np.testing.assert_array_equal(n(src), np.asarray(r_src))
    np.testing.assert_array_equal(n(dst), np.asarray(r_dst))


def test_rmat_quadrant_frequencies():
    """Each level's quadrant shares match theta within 6 standard errors,
    in both packages."""
    theta = np.array([0.57, 0.19, 0.19, 0.05], np.float32)
    r_scale = c_scale = 8
    m = 20_000
    for src, dst in (jr.rmat_rectangular_gen(JState(1), theta, r_scale,
                                             c_scale, m),
                     tr.rmat_rectangular_gen(RngState(1), theta, r_scale,
                                             c_scale, m, **CPU)):
        src, dst = n(src).astype(np.int64), n(dst).astype(np.int64)
        assert src.min() >= 0 and src.max() < 256
        assert dst.min() >= 0 and dst.max() < 256
        for lvl in range(8):
            quad = (((src >> (7 - lvl)) & 1) << 1) | ((dst >> (7 - lvl)) & 1)
            freq = np.bincount(quad, minlength=4) / m
            se = np.sqrt(theta * (1 - theta) / m)
            assert np.all(np.abs(freq - theta) < 6 * se), (lvl, freq)


def test_rmat_rectangular_and_oversized_theta():
    theta = np.array([0.25, 0.25, 0.25, 0.25], np.float32)
    src, dst = tr.rmat_rectangular_gen(RngState(3), theta, 4, 8, 2000, **CPU)
    assert n(src).max() < 16 and n(dst).max() < 256 and n(dst).max() >= 16
    src, dst = tr.rmat_rectangular_gen(RngState(1), np.full((4, 4), 0.25,
                                                            np.float32),
                                       3, 3, 10, **CPU)
    assert src.shape == dst.shape == (10,)
    assert int(src.max()) < 8 and int(dst.max()) < 8
    from raft_tpu_torch.core.error import LogicError

    with pytest.raises(LogicError):
        tr.rmat_rectangular_gen(RngState(1), np.full((2, 4), 0.25), 3, 3, 10,
                                **CPU)
