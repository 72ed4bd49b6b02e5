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


# B2's f32 tier (csrc/cells_tf32.cu) takes the same step arithmetic over
# the cells of an IVF-Flat store: each cell's resident queries against
# its list's rows, f32 or bf16 (widened exactly, so their lo is 0), with
# tombstoned slots skipped.


def _gram_tc_cells(q: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The gram of ``q`` (m, d) and ``y`` (n, d) as the scan takes it on the
    tensor core: per 8-feature step the products lo(q) hi(y), hi(q) lo(y),
    hi(q) hi(y), each added to a fresh partial rounded toward zero, which
    one f32 add (to nearest) takes into the accumulator."""
    pad = -q.shape[1] % _STEP
    q = np.pad(q, ((0, 0), (0, pad)))
    y = np.pad(y, ((0, 0), (0, pad)))
    qh, ql = (t.numpy().astype(np.float64) for t in _split(torch.from_numpy(q)))
    yh, yl = (t.numpy().astype(np.float64) for t in _split(torch.from_numpy(y)))
    acc = np.zeros((q.shape[0], y.shape[0]), np.float32)
    for c in range(0, q.shape[1], _STEP):
        part = np.zeros_like(acc)
        for a, b in ((ql, yh), (qh, yl), (qh, yh)):
            part = _rz(part.astype(np.float64)
                       + a[:, c:c + _STEP] @ b[:, c:c + _STEP].T)
        acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def _cells_store(kind: str, store: str, d: int, seed: int):
    """Cells of 16 query rows against 4 lists of capacity 300: scattered
    tombstones, a starved list (3 valid slots), a whole tile tombstoned,
    a -1 cell. The store is f32 or bf16 (rows rounded to bf16)."""
    rng = np.random.default_rng(seed)
    L, cap, C, qrows = 4, 300, 5, 16
    if kind == "integer":
        db = rng.integers(0, 8, (L, cap, d)).astype(np.float32)
        q = rng.integers(0, 8, (C, qrows, d)).astype(np.float32)
    else:
        db = rng.standard_normal((L, cap, d), dtype=np.float32)
        q = rng.standard_normal((C, qrows, d), dtype=np.float32)
    if store == "bf16":
        db = torch.from_numpy(db).to(torch.bfloat16).float().numpy()
    invalid = rng.random((L, cap)) < 0.2
    invalid[2, 3:] = True
    invalid[3, 128:256] = True
    cells = np.array([0, 2, -1, 3, 1], np.int32)
    return cells, q, db, invalid


def _cells_tc(cells, q, db, invalid, k: int, l2: bool):
    """The scan on the emulated gram: max(|q|^2 + |y|^2 - 2g, 0) with f32
    norms, or -g; tombstones and -1 cells at (inf, -1); the top k by
    (distance, slot)."""
    C, qrows, _ = q.shape
    out_d = np.full((C, qrows, k), np.inf, np.float32)
    out_i = np.full((C, qrows, k), -1, np.int32)
    for c, lst in enumerate(cells):
        if lst < 0:
            continue
        y = db[lst]
        g = _gram_tc_cells(q[c], y)
        if l2:
            qn = np.sum(q[c].astype(np.float64) ** 2, 1).astype(np.float32)
            yn = np.sum(y.astype(np.float64) ** 2, 1).astype(np.float32)
            w = np.maximum((qn[:, None] + yn[None, :]) - np.float32(2) * g,
                           np.float32(0))
        else:
            w = -g
        w = np.where(invalid[lst][None, :], np.float32(np.inf), w)
        order = np.argsort(w, axis=1, kind="stable")[:, :k]
        out_d[c] = np.take_along_axis(w, order, 1)
        out_i[c] = np.where(np.isinf(out_d[c]), -1, order)
    return out_d, out_i


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("l2", [True, False])
@pytest.mark.parametrize("k", [1, 10])
def test_cells_integer_data_is_exact(store, l2, k):
    """Integer rows below 2^11 split with lo = 0: over cells with
    tombstones, the emulated scan equals B2's plain version bit for bit,
    distances and slots, on f32 and bf16 stores."""
    import importlib

    fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")
    cells, q, db, invalid = _cells_store("integer", store, 40, 3)
    dd, ii = _cells_tc(cells, q, db, invalid, k, l2)
    y = torch.from_numpy(db)
    if store == "bf16":
        y = y.to(torch.bfloat16)
    pd, pi = fk.fused_cells_knn(torch.from_numpy(cells), torch.from_numpy(q),
                                y, torch.from_numpy(invalid), k, l2=l2)
    np.testing.assert_array_equal(ii, pi.numpy())
    np.testing.assert_array_equal(dd, pd.numpy())


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("d", [33, 128])
def test_cells_split_gram_holds_the_f32_gram_accuracy(store, d):
    """Gaussian cells: over every valid (query, slot) pair of every cell,
    the emulated gram's largest error of 2g against float64 is at most 4x
    the plain f32 product's and under chip_smoke.py's ``norm_tol``."""
    cells, q, db, invalid = _cells_store("gaussian", store, d, 100 + d)
    split = plain = 0.0
    for c, lst in enumerate(cells):
        if lst < 0:
            continue
        y, ok = db[lst], ~invalid[lst]
        g64 = q[c].astype(np.float64) @ y.astype(np.float64).T
        g32 = torch.from_numpy(q[c]) @ torch.from_numpy(y).T
        plain = max(plain, _err(g32[:, ok], g64[:, ok]))
        split = max(split, _err(torch.from_numpy(
            _gram_tc_cells(q[c], y))[:, ok], g64[:, ok]))
    assert split <= 4.0 * plain, (split, plain)
    assert split < _norm_tol(q.reshape(-1, d), db.reshape(-1, d)), split
