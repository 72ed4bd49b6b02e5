"""The arithmetic of B1's f32 tier on the card, emulated on the CPU.

``csrc/knn_tf32.cu`` takes the f32 gram as three TF32 tensor-core
products: each operand x is split into hi = tf32(x) (``cvt.rna``: nearest,
ties away from zero) and lo = tf32(x - hi), and the products lo(q) hi(y),
hi(q) lo(y), hi(q) hi(y) of each 8-feature ``mma.sync`` step go into a
fresh partial sum that one f32 add takes into the accumulators. The
emulation here models that arithmetic: the TF32 rounding by bit
operations, each step's products exact (two 11-bit significands) and
summed in float64, then rounded to f32 after each product of each step,
to nearest or, as the tensor core rounds its sums, toward zero.

The emulated gram is held to float64: its largest error of 2g is at most
4x that of the plain f32 product (the function the reference computes at
Precision.HIGHEST, and what the port's plain version computes) and under
chip_smoke.py's ``norm_tol`` (2e-6 of the largest |q|^2 + |y|^2). One
TF32 product, emulated the same way, fails both bars by far, so the check
has teeth. Integers below 2^11 split with lo = 0, and their gram is exact.
With the tensor core's rounding toward zero the fresh partial of each step
keeps the bias of the distances within chip_smoke.py's bar on a k-means
inertia, where one partial chained over a pair's products does not.
"""

import numpy as np
import pytest
import torch

import chip_smoke

_STEP = 8  # features of one m16n8k8 product


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: add half of the 13 dropped bits' range to the
    magnitude and clear them (finite f32 in, so no carry reaches the
    sign)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _gram_tf32(q: torch.Tensor, y: torch.Tensor, split: bool) -> torch.Tensor:
    """The kernel's gram of f32 ``q`` (m, d) and ``y`` (n, d): per 8-feature
    step, the products lo(q) hi(y), hi(q) lo(y), hi(q) hi(y) (``split``) or
    hi(q) hi(y) alone, each step's sum exact and added to the f32
    accumulator with one rounding."""
    qh, ql = _split(q)
    yh, yl = _split(y)
    terms = [(ql, yh), (qh, yl), (qh, yh)] if split else [(qh, yh)]
    acc = torch.zeros((q.shape[0], y.shape[0]), dtype=torch.float32)
    for c in range(0, q.shape[1], _STEP):
        for a, b in terms:
            step = a[:, c:c + _STEP].double() @ b[:, c:c + _STEP].double().T
            acc = (acc.double() + step).float()
    return acc


def _err(g: torch.Tensor, g64: np.ndarray) -> float:
    """Largest |2g - 2g64|."""
    return float(np.max(np.abs(2.0 * g.double().numpy() - 2.0 * g64)))


def _data(kind: str, d: int, seed: int):
    m, n = 64, 512
    if kind == "gaussian":
        rng = np.random.default_rng(seed)
        return (rng.standard_normal((m, d), dtype=np.float32),
                rng.standard_normal((n, d), dtype=np.float32))
    x, q = chip_smoke.make_data(n, d, 50, m, seed=seed)
    return q, x


def _norm_tol(q: np.ndarray, y: np.ndarray) -> float:
    return chip_smoke.REL_NORM_TOL * float(
        np.max(np.sum(q.astype(np.float64) ** 2, 1))
        + np.max(np.sum(y.astype(np.float64) ** 2, 1)))


@pytest.mark.parametrize("kind,d", [("gaussian", 33), ("gaussian", 128),
                                    ("gaussian", 1024), ("blobs", 33),
                                    ("blobs", 128), ("blobs", 1024)])
def test_split_gram_holds_the_f32_gram_accuracy(kind, d):
    q, y = _data(kind, d, 100 + d)
    g64 = q.astype(np.float64) @ y.astype(np.float64).T
    qt, yt = torch.from_numpy(q), torch.from_numpy(y)
    plain = _err(qt @ yt.T, g64)
    split = _err(_gram_tf32(qt, yt, True), g64)
    tol = _norm_tol(q, y)
    assert split <= 4.0 * plain, (split, plain)
    assert split < tol, (split, tol)


@pytest.mark.parametrize("kind,d", [("gaussian", 33), ("gaussian", 128),
                                    ("gaussian", 1024), ("blobs", 128)])
def test_one_tf32_product_fails_the_bar(kind, d):
    """The same bar, held to one TF32 product, fails: it is the split that
    passes it, not a loose bar."""
    q, y = _data(kind, d, 100 + d)
    g64 = q.astype(np.float64) @ y.astype(np.float64).T
    qt, yt = torch.from_numpy(q), torch.from_numpy(y)
    plain = _err(qt @ yt.T, g64)
    one = _err(_gram_tf32(qt, yt, False), g64)
    assert one > 4.0 * plain, (one, plain)
    assert one > _norm_tol(q, y), one


def test_tf32_rounding_is_cvt_rna():
    """Nearest, ties away from zero, on both signs: 1 + 2^-11 (a tie) goes
    up to 1 + 2^-10, 1 + 2^-11 - 2^-23 down to 1."""
    tie = np.float32(1.0) + np.float32(2.0 ** -11)
    below = np.nextafter(tie, np.float32(0.0))
    x = torch.tensor([tie, -tie, below, -below, 1.5, 0.0],
                     dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, -1.0, 1.5, 0.0]
    assert _tf32(x).tolist() == want


def test_integers_below_2_to_11_split_exactly():
    """Every integer of magnitude below 2^11 is its own TF32 value, so lo =
    0 and the split adds nothing; the gram of such rows is exact while its
    sums stay below 2^24."""
    x = torch.arange(-2047, 2048, dtype=torch.float32)
    hi, lo = _split(x)
    assert torch.equal(hi, x) and not bool(lo.any())
    rng = np.random.default_rng(7)
    for lo_v, hi_v, d in ((0, 8, 128), (-2047, 2048, 3)):
        q = rng.integers(lo_v, hi_v, (40, d)).astype(np.float32)
        y = rng.integers(lo_v, hi_v, (300, d)).astype(np.float32)
        g = _gram_tf32(torch.from_numpy(q), torch.from_numpy(y), True)
        exact = q.astype(np.int64) @ y.astype(np.int64).T
        assert np.max(np.abs(exact)) < 2 ** 24
        np.testing.assert_array_equal(g.numpy().astype(np.int64), exact)


def _rz(x: np.ndarray) -> np.ndarray:
    """float64 to f32, rounded toward zero (the tensor core's f32 sums)."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0.0))
    return f


def _gram_tc(q: np.ndarray, y: np.ndarray, span: int) -> np.ndarray:
    """The row-wise gram sum(q * y, 1) as the scan takes it on the tensor
    core: per 8-feature step the products lo(q) hi(y), hi(q) lo(y), hi(q)
    hi(y), each added to a partial sum rounded toward zero; the partial
    starts afresh every ``span`` features and is added to the f32
    accumulator rounded to nearest."""
    qh, ql = (t.numpy() for t in _split(torch.from_numpy(q)))
    yh, yl = (t.numpy() for t in _split(torch.from_numpy(y)))
    acc = np.zeros(q.shape[0], np.float32)
    for c0 in range(0, q.shape[1], span):
        part = np.zeros(q.shape[0], np.float32)
        for c in range(c0, c0 + span, _STEP):
            for a, b in ((ql, yh), (qh, yl), (qh, yh)):
                step = np.sum(a[:, c:c + _STEP].astype(np.float64)
                              * b[:, c:c + _STEP], axis=1)
                part = _rz(part.astype(np.float64) + step)
        acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def _inertia_bias(span: int) -> float:
    """Relative error of the sum of f32 distances max(|x|^2 + |c|^2 - 2g,
    0) against float64 for blobs as chip_smoke.py's Lloyd fit makes them
    (centers uniform in [-10, 10], std 1, d = 128), each point against its
    own center: what a k-means fit's inertia carries from the scan."""
    rng = np.random.default_rng(17)
    centers = rng.uniform(-10.0, 10.0, (100, 128)).astype(np.float32)
    c = centers[rng.integers(0, 100, 4000)]
    x = (c + rng.standard_normal(c.shape)).astype(np.float32)
    norms = (np.sum(x.astype(np.float64) ** 2, 1).astype(np.float32)
             + np.sum(c.astype(np.float64) ** 2, 1).astype(np.float32))
    dist = np.maximum(norms - np.float32(2.0) * _gram_tc(x, c, span), 0.0)
    ref = np.sum((x.astype(np.float64) - c) ** 2)
    return float((np.sum(dist.astype(np.float64)) - ref) / ref)


def test_step_partials_keep_the_truncation_bias_off_the_inertia_bar():
    """Rounded toward zero, the tensor core's sums bias the gram low and
    the distances high. A fresh partial for each 8-feature step (the
    kernel's) keeps a k-means inertia within chip_smoke.py's bar of
    float64 with room to spare (about 3e-6 against 1e-5); one partial
    chained over all 128 features of a pair misses it several times over
    (about 7e-5), so the emulation can tell the two apart."""
    bar = chip_smoke.INERTIA_RTOL_17
    step = _inertia_bias(_STEP)
    chained = _inertia_bias(128)
    assert 0.0 < step < 0.5 * bar, step
    assert chained > 4.0 * bar, chained
