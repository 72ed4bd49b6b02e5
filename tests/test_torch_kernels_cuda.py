"""The CUDA kernels on the card, held to their plain versions.

These tests need a CUDA card and skip without one (the kernels have no CPU
mode). The file imports neither JAX nor raft_tpu, so it also runs where
JAX is absent; there, skip the JAX-importing ``conftest.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Integer-valued data keeps every distance exact, so kernel and plain
version must agree bit for bit, ids and distances.
"""

import importlib

import numpy as np
import pytest
import torch

from raft_tpu_torch import lifecycle as lc
from raft_tpu_torch import serve
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.matrix.select_k import SelectMethod, select_k
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
from raft_tpu_torch.ops import pq_scan as ps
from raft_tpu_torch.ops import stream_select as ss
from chip_smoke import cells_f64_err, same_up_to_exact_ties
from test_torch_common import int_data, n

fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")

_TIERS = [(False, False), (True, False), (True, True)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(42)


def _on(dev, *arrays):
    return [torch.as_tensor(a, device=dev) for a in arrays]


# B1 cases (m, n, d, k, hi), integer data in [0, hi): the split path (m = 1
# and 129 against 200,000 rows; {0, 1} data ties across the slices), each
# BQ boundary of k, n < 128, n not a multiple of the slice, d in {33, 96,
# 1024}; the k-means assignments (k = 1 against 32, 1000 and 1024 centers,
# each tile width of the tensor-core scans, and d = 1024); the serving
# shapes (requests of 1, 16 and 32 rows against 200,000 rows, k 10 and
# 100).
_B1_CASES = [(70, 3001, 96, 1, 8), (70, 3001, 96, 16, 8),
             (70, 3001, 96, 256, 8), (1, 200_000, 96, 10, 2),
             (129, 200_000, 96, 10, 2), (129, 200_001, 33, 64, 2),
             (1, 200_000, 96, 256, 2),
             *[(200, 5000, 32, k, 2) for k in (1, 10, 64, 65, 128, 129, 256)],
             (50, 100, 33, 10, 8), (50, 100, 24, 100, 2),
             (100, 3000, 1024, 10, 8), (300, 3000, 33, 129, 2),
             (3000, 32, 128, 1, 8), (4000, 1000, 128, 1, 8),
             (2500, 1024, 128, 1, 8), (2000, 64, 128, 1, 8),
             (2000, 1000, 1024, 1, 8),
             *[(m, 200_000, 128, k, 2) for m in (1, 16, 32)
               for k in (10, 100)]]


def _launched(launch, bf16):
    """Run ``launch`` and assert it was one B1 launch through a
    tensor-core scan, on every tier: knn_tf32.cu's (``tf32_launches``)
    exactly when the f32 tier was asked for."""
    before = (fk.fused_knn.launches, fk.fused_knn.tf32_launches)
    out = launch()
    assert (fk.fused_knn.launches, fk.fused_knn.tf32_launches) == (
        before[0] + 1, before[1] + int(not bf16))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bf16,qsplit", _TIERS)
@pytest.mark.parametrize("m,rows,d,k,hi", _B1_CASES)
def test_fused_knn_kernel(dev, gen, metric, bf16, qsplit, m, rows, d, k, hi):
    q, db = _on(dev, int_data(gen, (m, d), hi), int_data(gen, (rows, d), hi))
    before = fk.fused_knn.launches
    dd, i = _launched(lambda: fk.fused_knn(q, db, k, metric=metric,
                                           bf16=bf16, qsplit=qsplit), bf16)
    assert fk.fused_knn.launches == before + 1
    pd, pi = fk._fused_knn_plain(q, db, k, metric == "l2", bf16, qsplit)
    if metric == "ip":
        pd = -pd
    np.testing.assert_array_equal(n(i), n(pi))
    np.testing.assert_array_equal(n(dd), n(pd))


def _offset_view(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts ``offset`` floats into its
    storage (off the 16-byte alignment for an odd offset)."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    v = buf[offset:].view(x.shape)
    v.copy_(x)
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bf16,qsplit", _TIERS)
@pytest.mark.parametrize("m,rows,d,k,q_off,db_off",
                         [(129, 200_000, 96, 10, 1, 1),
                          (70, 3001, 32, 1, 0, 3), (70, 3001, 128, 65, 2, 0)])
def test_fused_knn_kernel_unaligned_operands(dev, gen, metric, bf16, qsplit,
                                             m, rows, d, k, q_off, db_off):
    """Contiguous views that start off 16 bytes take the 4-byte copies and
    agree with the plain version bit for bit; the card stays usable."""
    q, db = _on(dev, int_data(gen, (m, d), 2), int_data(gen, (rows, d), 2))
    qv, dbv = _offset_view(q, q_off), _offset_view(db, db_off)
    assert (qv.data_ptr() % 16 != 0) or (dbv.data_ptr() % 16 != 0)
    dd, i = _launched(lambda: fk.fused_knn(qv, dbv, k, metric=metric,
                                           bf16=bf16, qsplit=qsplit), bf16)
    pd, pi = fk._fused_knn_plain(q, db, k, metric == "l2", bf16, qsplit)
    if metric == "ip":
        pd = -pd
    np.testing.assert_array_equal(n(i), n(pi))
    np.testing.assert_array_equal(n(dd), n(pd))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bf16,qsplit", _TIERS)
@pytest.mark.parametrize("m,rows,d,k", [(129, 200_000, 96, 10),
                                        (1, 200_000, 33, 64),
                                        (300, 5000, 1024, 129),
                                        (4000, 1000, 128, 1),
                                        (2000, 32, 1024, 1)])
def test_fused_knn_kernel_gaussian(dev, gen, metric, bf16, qsplit, m, rows,
                                   d, k):
    """Gaussian data: the kernel sums in another order than the plain
    version's matmul, so distances agree within 2e-6 of the largest
    |q|^2 + |y|^2 (chip_smoke.py's norm_tol) and near-ties may swap ids."""
    q = torch.as_tensor(gen.standard_normal((m, d), dtype=np.float32),
                        device=dev)
    db = torch.as_tensor(gen.standard_normal((rows, d), dtype=np.float32),
                         device=dev)
    l2 = metric == "l2"
    kd, ki = _launched(lambda: fk._fused_knn_cuda(q, db, k, l2, bf16, qsplit),
                       bf16)
    pd, pi = fk._fused_knn_plain(q, db, k, l2, bf16, qsplit)
    tol = 2e-6 * float(torch.max(torch.sum(q * q, 1))
                       + torch.max(torch.sum(db * db, 1)))
    assert float(torch.max(torch.abs(kd - pd))) <= tol
    assert float((ki == pi).float().mean()) >= 0.99


def _f64_err(q, db, d, i, l2):
    """Largest |d - the float64 distance of the same (query, id) pair|,
    over the slots with an id."""
    q64, y64 = q.double(), db.double()
    ok = i >= 0
    y = y64[i.long().clamp_min(0)]
    if l2:
        ref = torch.sum((q64[:, None, :] - y) ** 2, dim=2)
    else:
        ref = -torch.sum(q64[:, None, :] * y, dim=2)
    return float(torch.max(torch.abs(d.double() - ref)[ok]))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("data", ["gaussian", "blobs"])
@pytest.mark.parametrize("d", [33, 128, 1024])
@pytest.mark.parametrize("k", [1, 10, 129])
def test_fused_knn_f32_tier_against_float64(dev, gen, metric, data, d, k):
    """The f32 tier's 3xTF32 gram keeps an f32 gram's accuracy: its
    largest distance error against float64 (at the ids it returns) is at
    most 4x that of the plain version's full-f32 product on the card (at
    its own ids), on Gaussian rows and on the main path's blobs (centers
    in [-10, 10], sigma 5, queries = rows + N(0, 1))."""
    import chip_smoke

    m, rows = 200, 20_000
    if data == "gaussian":
        x = gen.standard_normal((rows, d), dtype=np.float32)
        qh = gen.standard_normal((m, d), dtype=np.float32)
    else:
        x, qh = chip_smoke.make_data(rows, d, 50, m, seed=d + k)
    q, db = _on(dev, qh, x)
    l2 = metric == "l2"
    kd, ki = _launched(lambda: fk._fused_knn_cuda(q, db, k, l2, False, False),
                       False)
    pd, pi = fk._fused_knn_plain(q, db, k, l2, False, False)
    err = _f64_err(q, db, kd, ki, l2)
    plain = _f64_err(q, db, pd, pi, l2)
    assert err <= 4.0 * plain, (err, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("l2", [True, False])
@pytest.mark.parametrize("bf16_db", [False, True])
def test_fused_cells_knn_kernel(dev, gen, l2, bf16_db):
    L, cap, d = 5, 300, 96
    db = int_data(gen, (L, cap, d))
    invalid = gen.random((L, cap)) < 0.3
    invalid[1, :] = True
    invalid[3, 4:] = True
    cells = np.array([0, 1, -1, 3, 2, 4, 3, -1], np.int32)
    q = int_data(gen, (cells.shape[0], 40, d))
    args = _on(dev, cells, q, db, invalid)
    if bf16_db:
        args[2] = args[2].to(torch.bfloat16)
    before = fk.fused_cells_knn.launches
    kd, ki = fk.fused_cells_knn(*args, 10, l2=l2, bf16=bf16_db,
                                qsplit=bf16_db)
    assert fk.fused_cells_knn.launches == before + 1
    pd, pi = fk._fused_cells_knn_plain(*args, 10, l2, bf16_db, bf16_db)
    np.testing.assert_array_equal(n(ki), n(pi))
    np.testing.assert_array_equal(n(kd), n(pd))
    assert (n(ki)[3, :, 4:] == -1).all() and (n(ki)[2] == -1).all()


def _cells_case(gen, qrows, hi=8, L=6, cap=300, d=40, C=7):
    """B2 operands on integer data in [0, hi): cap not a multiple of 128,
    an empty list (1), a starved one (2: 3 valid rows), tombstone-style
    scattered invalid slots, a list whose middle 128-slot tiles are all
    invalid (4, when cap > 512), and -1 cells."""
    db = int_data(gen, (L, cap, d), hi)
    invalid = gen.random((L, cap)) < 0.3
    invalid[1, :] = True
    invalid[2, 3:] = True
    if cap > 512:
        invalid[4, 128:512] = True
    cells = np.array([0, 1, -1, 2, 3, 4, 5, 3, -1], np.int32)[:C]
    q = int_data(gen, (C, qrows, d), hi)
    return cells, q, db, invalid


#: B2's stores: f32, bf16, and the 8-bit stores of u8 / int8 indexes
#: (integer data, shifted by -1 for int8 so that it holds negative rows).
_B2_STORES = ["f32", "bf16", "u8", "i8"]


def _as_store(x: torch.Tensor, store: str) -> torch.Tensor:
    return {"f32": lambda: x, "bf16": lambda: x.to(torch.bfloat16),
            "u8": lambda: x.to(torch.uint8),
            "i8": lambda: (x - 1).to(torch.int8)}[store]()


def _b2_counted(launch, bf16):
    """Run ``launch`` and assert it was one B2 launch, through the bf16
    tiers' tensor-core scan (``mma_launches``) when a bf16 tier was asked
    for, else through the f32 tier's 3xTF32 scan (``tf32_launches``)."""
    c = fk.fused_cells_knn
    before = (c.launches, c.mma_launches, c.tf32_launches)
    out = launch()
    assert (c.launches, c.mma_launches, c.tf32_launches) == (
        before[0] + 1, before[1] + int(bf16), before[2] + int(not bf16))
    return out


def _cells_both(dev, cells, q, db, invalid, k, l2, store, bf16, qsplit):
    """B2 on the card through the wrapper (one launch, through its tier's
    scan) and its plain version on the card's operands."""
    args = _on(dev, cells, q, db, invalid)
    args[2] = _as_store(args[2], store)
    kd, ki = _b2_counted(lambda: fk.fused_cells_knn(
        *args, k, l2=l2, bf16=bf16, qsplit=qsplit), bf16)
    pd, pi = fk._fused_cells_knn_plain(*args, k, l2, bf16, bf16 and qsplit)
    return kd, ki, pd, pi


_B2_KS = [1, 10, 16, 17, 64, 65, 128, 129, 256]
_B2_QROWS = [1, 8, 63, 64, 65, 128]


@pytest.mark.cuda
@pytest.mark.parametrize("l2", [True, False])
@pytest.mark.parametrize("bf16,qsplit", _TIERS)
@pytest.mark.parametrize("store", _B2_STORES)
@pytest.mark.parametrize("k", _B2_KS)
@pytest.mark.parametrize("qrows", _B2_QROWS)
def test_cells_kernel_grid(dev, gen, l2, bf16, qsplit, store, k, qrows):
    """B2 against its plain version, bit for bit on integer data: every
    store x tier x metric, each selection path of k (a register minimum,
    the insertion network up to 16, warp merges above, 64 / 32 / 16 rows
    a CTA), qrows off and on the row blocks, sentinels."""
    cells, q, db, invalid = _cells_case(gen, qrows)
    kd, ki, pd, pi = _cells_both(dev, cells, q, db, invalid, k, l2,
                                 store, bf16, qsplit)
    np.testing.assert_array_equal(n(ki), n(pi))
    np.testing.assert_array_equal(n(kd), n(pd))
    ki = n(ki)
    assert (ki[1] == -1).all() and (ki[2] == -1).all()
    if k > 3:
        assert (ki[3, :, 3:] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("l2", [True, False])
@pytest.mark.parametrize("bf16,qsplit", _TIERS)
@pytest.mark.parametrize("store", _B2_STORES)
@pytest.mark.parametrize("k", [1, 10, 17, 256])
@pytest.mark.parametrize("qrows", [1, 64, 65])
def test_cells_kernel_ties_and_skipped_tiles(dev, gen, l2, bf16, qsplit,
                                             store, k, qrows):
    """{0, 1} data: distances tie within a thread's micro-tile, across
    threads and across tiles, so a wrong (row, slot) map shows as a wrong
    id; cap 1000 with a list whose tiles 1-3 are all invalid (skipped)."""
    cells, q, db, invalid = _cells_case(gen, qrows, hi=2, cap=1000, d=24)
    kd, ki, pd, pi = _cells_both(dev, cells, q, db, invalid, k, l2,
                                 store, bf16, qsplit)
    np.testing.assert_array_equal(n(ki), n(pi))
    np.testing.assert_array_equal(n(kd), n(pd))


@pytest.mark.cuda
@pytest.mark.parametrize("l2", [True, False])
@pytest.mark.parametrize("bf16,qsplit", _TIERS)
@pytest.mark.parametrize("store", _B2_STORES)
@pytest.mark.parametrize("d,q_off,db_off", [(40, 1, 1), (40, 0, 1),
                                            (40, 1, 0), (33, 0, 0),
                                            (42, 0, 0), (48, 0, 4)])
def test_cells_kernel_unaligned_operands(dev, gen, l2, bf16, qsplit, store,
                                         d, q_off, db_off):
    """Operands off 16-byte alignment, and d off 16, 8 and 4, take the
    narrower copies (8-bit rows: 4-byte copies, or plain loads) and still
    agree bit for bit."""
    cells, q, db, invalid = _cells_case(gen, 65, hi=2, d=d)
    args = _on(dev, cells, q, db, invalid)
    args[2] = _as_store(args[2], store)
    qv, dbv = _offset_view(args[1], q_off), _offset_view(args[2], db_off)
    if (4 * q_off) % 16 or (db_off * dbv.element_size()) % 16:
        assert qv.data_ptr() % 16 != 0 or dbv.data_ptr() % 16 != 0
    kd, ki = _b2_counted(lambda: fk.fused_cells_knn(
        args[0], qv, dbv, args[3], 10, l2=l2, bf16=bf16, qsplit=qsplit),
        bf16)
    pd, pi = fk._fused_cells_knn_plain(*args, 10, l2, bf16, bf16 and qsplit)
    np.testing.assert_array_equal(n(ki), n(pi))
    np.testing.assert_array_equal(n(kd), n(pd))


@pytest.mark.cuda
@pytest.mark.parametrize("l2", [True, False])
@pytest.mark.parametrize("bf16,qsplit", _TIERS)
@pytest.mark.parametrize("store", _B2_STORES)
@pytest.mark.parametrize("k", [1, 10, 17, 256])
@pytest.mark.parametrize("d", [385, 1024])
def test_cells_kernel_wide_rows(dev, gen, l2, bf16, qsplit, store, k, d):
    """d past B3's resident tiles (385, and MAX_DIM 1024): the bf16 tiers
    stay on the tensor-core scan (16- or 32-row CTAs, many feature panels
    a tile, the last one partly zero) and agree bit for bit on {0, 1}
    data."""
    cells, q, db, invalid = _cells_case(gen, 65, hi=2, cap=300, d=d)
    kd, ki, pd, pi = _cells_both(dev, cells, q, db, invalid, k, l2,
                                 store, bf16, qsplit)
    np.testing.assert_array_equal(n(ki), n(pi))
    np.testing.assert_array_equal(n(kd), n(pd))


@pytest.mark.cuda
@pytest.mark.parametrize("l2", [True, False])
@pytest.mark.parametrize("bf16,qsplit", _TIERS)
@pytest.mark.parametrize("store", _B2_STORES)
@pytest.mark.parametrize("k", [1, 10, 100])
def test_cells_kernel_gaussian(dev, gen, l2, bf16, qsplit, store, k):
    """The main-path geometry (64-row cells, capacity 4096 with 700-1300
    valid rows, d 128) on Gaussian data (Gaussian queries and full-range
    integer rows on the 8-bit stores): the kernel sums in another order
    than the plain version's matmul, so distances agree within 2e-6 of the
    largest |q|^2 + |y|^2 (chip_smoke.py's norm_tol) and near-ties may
    swap ids (per-slot recall >= 0.999)."""
    L, cap, d, C = 8, 4096, 128, 24
    if store in ("u8", "i8"):
        lo, hi = (0, 256) if store == "u8" else (-128, 128)
        db = torch.as_tensor(gen.integers(lo, hi, (L, cap, d)).astype(
            np.uint8 if store == "u8" else np.int8), device=dev)
    else:
        db = torch.as_tensor(gen.standard_normal((L, cap, d),
                                                 dtype=np.float32),
                             device=dev)
        db = _as_store(db, store)
    q = torch.as_tensor(gen.standard_normal((C, 64, d), dtype=np.float32),
                        device=dev)
    invalid = torch.as_tensor(
        np.arange(cap)[None, :] >= gen.integers(700, 1300, (L, 1)),
        device=dev)
    cells = torch.as_tensor(gen.integers(-1, L, C).astype(np.int32),
                            device=dev)
    if not bf16:
        db = db.float() if db.dtype in (torch.uint8, torch.int8) else db
    kd, ki = _b2_counted(lambda: fk._fused_cells_knn_cuda(
        cells, q, db, invalid, k, l2, bf16, qsplit), bf16)
    pd, pi = fk._fused_cells_knn_plain(cells, q, db, invalid, k, l2, bf16,
                                       qsplit)
    tol = 2e-6 * float(torch.max(torch.sum(q * q, -1))
                       + torch.max(torch.sum(db.float() ** 2, -1)))
    fin = torch.isfinite(pd)
    assert torch.equal(fin, torch.isfinite(kd))
    assert float(torch.max(torch.abs(kd[fin] - pd[fin]))) <= tol
    hit = (ki[:, :, :, None] == pi[:, :, None, :]).any(dim=3)
    assert float(hit.float().mean()) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("l2", [True, False])
@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("d", [33, 128, 1024])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_cells_f32_tier_against_float64(dev, gen, l2, store, d, k):
    """B2's f32 tier's 3xTF32 gram keeps an f32 gram's accuracy on
    Gaussian cells (64 rows, 700-1300 valid slots of 2048, tombstones):
    its largest error against float64 is at most 4x the plain version's
    full-f32 product's (each at its own ids), on f32 and bf16 stores."""
    L, cap, C = 6, 2048, 12
    db = torch.as_tensor(gen.standard_normal((L, cap, d), dtype=np.float32),
                         device=dev)
    db = _as_store(db, store)
    q = torch.as_tensor(gen.standard_normal((C, 64, d), dtype=np.float32),
                        device=dev)
    invalid = np.arange(cap)[None, :] >= gen.integers(700, 1300, (L, 1))
    invalid |= gen.random((L, cap)) < 0.1
    invalid = torch.as_tensor(invalid, device=dev)
    cells = torch.as_tensor(gen.integers(-1, L, C).astype(np.int32),
                            device=dev)
    kd, ki = _b2_counted(lambda: fk._fused_cells_knn_cuda(
        cells, q, db, invalid, k, l2, False, False), False)
    pd, pi = fk._fused_cells_knn_plain(cells, q, db, invalid, k, l2, False,
                                       False)
    err = cells_f64_err(cells, q, db, kd, ki, l2)
    plain = cells_f64_err(cells, q, db, pd, pi, l2)
    assert err <= 4.0 * plain, (err, plain)
    assert torch.equal(ki >= 0, pi >= 0)


@pytest.mark.cuda
def test_entry_points_launch_the_kernels(dev, gen):
    """brute force, the k-means of build, and search go through B1/B2."""
    X = int_data(gen, (9000, 32))
    Q = int_data(gen, (300, 32))
    b1, b2 = fk.fused_knn.launches, fk.fused_cells_knn.launches
    d, i = brute_force.knn(X, Q, 10)          # numpy -> the card
    assert d.device.type == "cuda" and fk.fused_knn.launches == b1 + 1
    sd, si = brute_force.knn(torch.as_tensor(X), torch.as_tensor(Q), 10,
                             method="scan")
    np.testing.assert_array_equal(n(i), n(si))
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=16,
                                                kmeans_n_iters=4), X)
    assert fk.fused_knn.launches > b1 + 1
    vd, vi = ivf_flat.search(ivf_flat.SearchParams(n_probes=16), index, Q,
                             10)
    assert fk.fused_cells_knn.launches == b2 + 1
    # All lists probed: the IVF search is exact.
    np.testing.assert_array_equal(n(vd), n(d))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bf16,qsplit", _TIERS)
@pytest.mark.parametrize("k", [1, 10, 256])
def test_fused_batch_knn_kernel(dev, gen, metric, bf16, qsplit, k):
    """B3 on integer data, multi-tile ragged n, an empty and a starved
    slab, f32 and bf16 db."""
    B, m, nn, d = 5, 37, 700, 48
    q, db = int_data(gen, (B, m, d)), int_data(gen, (B, nn, d))
    invalid = gen.random((B, nn)) < 0.3
    invalid[1, :] = True
    invalid[3, 5:] = True
    q, db, invalid = _on(dev, q, db, invalid)
    if bf16:
        db = db.to(torch.bfloat16)
    before = fk.fused_batch_knn.launches
    kd, ki = fk.fused_batch_knn(q, db, invalid, k, metric=metric, bf16=bf16,
                                qsplit=qsplit)
    assert fk.fused_batch_knn.launches == before + 1
    pd, pi = fk._fused_batch_knn_plain(q, db.float() if not bf16 else db,
                                       invalid, k, metric == "l2", bf16,
                                       qsplit)
    if metric == "ip":
        pd = -pd
    np.testing.assert_array_equal(n(ki), n(pi))
    np.testing.assert_array_equal(n(kd), n(pd))
    assert (n(ki)[1] == -1).all()


@pytest.mark.cuda
def test_fused_batch_knn_raises_past_the_queue(dev, gen):
    q, db = _on(dev, int_data(gen, (2, 4, 8)), int_data(gen, (2, 300, 8)))
    invalid = torch.zeros((2, 300), dtype=torch.bool, device=dev)
    with pytest.raises(LogicError):
        fk.fused_batch_knn(q, db, invalid, 257)


def _batch_case(gen, m, d=48, hi=8, B=5, nn=300):
    """B3 operands on integer data in [0, hi): n off the 128-slot tile, an
    empty slab (1), a starved one (2: 3 valid slots), a slab whose second
    tile is all tombstones (4), and per-element live rows 0, 1, a middle
    count, m and past m."""
    q, db = int_data(gen, (B, m, d), hi), int_data(gen, (B, nn, d), hi)
    invalid = gen.random((B, nn)) < 0.3
    invalid[1, :] = True
    invalid[2, 3:] = True
    invalid[4, 128:256] = True
    live = np.array([0, 1, m // 2, m, m + 3], np.int32)[:B]
    return q, db, invalid, live


def _tf32_scans(launch, want):
    """Run ``launch`` and assert it loaded B2's f32-tier library
    (csrc/cells_tf32.cu) for ``want`` launches: B3's f32 tier runs B2's
    3xTF32 scan, its other tiers never do."""
    calls = []
    lib = fk._cells_tf32_lib

    def counted():
        calls.append(1)
        return lib()

    fk._cells_tf32_lib = counted
    try:
        out = launch()
    finally:
        fk._cells_tf32_lib = lib
    assert len(calls) == want
    return out


def _batch_both(dev, q, db, invalid, live, k, metric, bf16_db, bf16, qsplit,
                q_off=0, db_off=0):
    """B3 on the card through the wrapper (one launch, on operands q_off /
    db_off elements past their storage's start) and its plain version on
    the card's operands; the plain distances un-negated for ip."""
    q, db, invalid = _on(dev, q, db, invalid)
    if bf16_db:
        db = db.to(torch.bfloat16)
    lr = None if live is None else torch.as_tensor(live, device=dev)
    qv, dbv = _offset_view(q, q_off), _offset_view(db, db_off)
    before = fk.fused_batch_knn.launches
    kd, ki = _tf32_scans(lambda: fk.fused_batch_knn(
        qv, dbv, invalid, k, metric=metric, bf16=bf16, qsplit=qsplit,
        live_rows=lr), int(not bf16))
    assert fk.fused_batch_knn.launches == before + 1
    y = db if bf16 and bf16_db else db.float()
    pd, pi = fk._fused_batch_knn_plain(q, y, invalid, min(k, db.shape[1]),
                                       metric == "l2", bf16, bf16 and qsplit,
                                       lr)
    return kd, ki, (pd if metric == "l2" else -pd), pi


def _batch_exact(kd, ki, pd, pi, live, k):
    np.testing.assert_array_equal(n(ki), n(pi))
    np.testing.assert_array_equal(n(kd), n(pd))
    ki = n(ki)
    assert (ki[1] == -1).all()
    if live is not None:
        # No live row in slab 0; slab 2's rows past m // 2 are not scanned.
        assert (ki[0] == -1).all()
        assert (ki[2, ki.shape[1] // 2:] == -1).all()
    if k > 3:
        assert (ki[2, :, 3:] == -1).all()


_B3_KS = [1, 10, 16, 17, 64, 256]
_B3_MS = [1, 37, 64, 65, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bf16,qsplit", _TIERS)
@pytest.mark.parametrize("bf16_db", [False, True])
@pytest.mark.parametrize("k", _B3_KS)
@pytest.mark.parametrize("m", _B3_MS)
def test_batch_kernel_grid(dev, gen, live, metric, bf16, qsplit, bf16_db, k,
                           m):
    """B3 against its plain version, bit for bit on integer data: every
    store x tier x metric (the bf16 tier on a bf16 store runs the
    tensor-core scan, the rest B2's scan), each selection path of k (a
    register minimum, the network up to 16 with its drain schedule, warp
    merges above), m off and on the row blocks, live rows or all rows,
    sentinels of empty, starved and unscanned rows."""
    q, db, invalid, lr = _batch_case(gen, m)
    lr = lr if live else None
    kd, ki, pd, pi = _batch_both(dev, q, db, invalid, lr, k, metric,
                                 bf16_db, bf16, qsplit)
    _batch_exact(kd, ki, pd, pi, lr, k)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bf16,qsplit", _TIERS)
@pytest.mark.parametrize("bf16_db", [False, True])
@pytest.mark.parametrize("k", [1, 10, 17, 256])
@pytest.mark.parametrize("d", [16, 48, 100, 128, 1024])
def test_batch_kernel_dims(dev, gen, metric, bf16, qsplit, bf16_db, k, d):
    """Feature counts off and on the 16-feature k-step (100: zero padding
    to 112), and d 1024, which the plan sends to B2's scan."""
    q, db, invalid, lr = _batch_case(gen, 37, d=d)
    kd, ki, pd, pi = _batch_both(dev, q, db, invalid, lr, k, metric,
                                 bf16_db, bf16, qsplit)
    _batch_exact(kd, ki, pd, pi, lr, k)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bf16,qsplit", _TIERS)
@pytest.mark.parametrize("bf16_db", [False, True])
@pytest.mark.parametrize("k", [1, 10, 17, 256])
@pytest.mark.parametrize("m", [1, 65])
def test_batch_kernel_ties_and_skipped_tiles(dev, gen, metric, bf16, qsplit,
                                             bf16_db, k, m):
    """{0, 1} data: distances tie within an mma fragment, across warps and
    across tiles, so a wrong (row, slot) map shows as a wrong id; n 1000
    with a slab whose tiles 1-3 are all invalid (skipped)."""
    q, db, invalid, lr = _batch_case(gen, m, d=24, hi=2, nn=1000)
    invalid[3, 128:512] = True
    kd, ki, pd, pi = _batch_both(dev, q, db, invalid, lr, k, metric,
                                 bf16_db, bf16, qsplit)
    _batch_exact(kd, ki, pd, pi, lr, k)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bf16,qsplit", _TIERS)
@pytest.mark.parametrize("bf16_db", [False, True])
@pytest.mark.parametrize("d,q_off,db_off", [(48, 1, 1), (48, 0, 1),
                                            (48, 1, 0), (33, 0, 0),
                                            (42, 0, 0), (44, 0, 2)])
def test_batch_kernel_unaligned_operands(dev, gen, metric, bf16, qsplit,
                                         bf16_db, d, q_off, db_off):
    """Operands one element past 16-byte alignment, and d off 8, 4 and 2,
    take the narrower copies and still agree bit for bit."""
    q, db, invalid, lr = _batch_case(gen, 65, d=d, hi=2)
    kd, ki, pd, pi = _batch_both(dev, q, db, invalid, lr, 10, metric,
                                 bf16_db, bf16, qsplit, q_off, db_off)
    _batch_exact(kd, ki, pd, pi, lr, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bf16,qsplit", _TIERS)
@pytest.mark.parametrize("bf16_db", [False, True])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_batch_kernel_gaussian(dev, gen, metric, bf16, qsplit, bf16_db, k):
    """The main-path geometry (256-slot buckets with 10-60 live rows,
    capacity 4096 with 700-1300 valid rows, d 128) on Gaussian data: the
    kernel sums in another order than the plain version's matmul, so
    distances agree within 2e-6 of the largest |q|^2 + |y|^2
    (chip_smoke.py's norm_tol) and near-ties may swap ids (per-slot recall
    >= 0.999)."""
    B, cap, d, m = 16, 4096, 128, 256
    db = torch.as_tensor(gen.standard_normal((B, cap, d), dtype=np.float32),
                         device=dev)
    q = torch.as_tensor(gen.standard_normal((B, m, d), dtype=np.float32),
                        device=dev)
    if bf16_db:
        db = db.to(torch.bfloat16)
    invalid = torch.as_tensor(
        np.arange(cap)[None, :] >= gen.integers(700, 1300, (B, 1)),
        device=dev)
    lr = torch.as_tensor(gen.integers(10, 61, B).astype(np.int32),
                         device=dev)
    y = db if bf16 and bf16_db else db.float()
    kd, ki = fk._fused_batch_knn_cuda(q, y, invalid, k, metric == "l2", bf16,
                                      qsplit, lr)
    pd, pi = fk._fused_batch_knn_plain(q, y, invalid, k, metric == "l2",
                                       bf16, qsplit, lr)
    tol = 2e-6 * float(torch.max(torch.sum(q * q, -1))
                       + torch.max(torch.sum(db.float() ** 2, -1)))
    fin = torch.isfinite(pd)
    assert torch.equal(fin, torch.isfinite(kd))
    assert float(torch.max(torch.abs(kd[fin] - pd[fin]))) <= tol
    hit = (ki[:, :, :, None] == pi[:, :, None, :]).any(dim=3)
    live = torch.arange(m, device=dev)[None, :] < lr[:, None]
    assert float(hit[live].float().mean()) >= 0.999
    assert bool((ki[~live] == -1).all())


def _pq_case(gen, bits, cap=700, J=8, L=2, C=7, qrows=40, hi=4):
    """B4 operands on integer data: books in [-3, 3] with a +-127 entry
    in every row of both table halves (so the int8 tables have a scale of
    exactly 1 and dequantize to the same integers) and queries in [-hi,
    hi]; hi=0 gives {0, 1} books and queries instead (ties everywhere:
    within an mma fragment, across the slots of different threads and
    warps, and across tiles). Lists: an empty one (1), a starved one (3)
    and one whose tiles 1 and 2 hold no valid slot (4); cells: one -1."""
    B = 1 << bits
    if hi:
        books = gen.integers(-3, 4, (J, B, L)).astype(np.float32)
        books[:, 0, :] = 127.0
        books[:, B // 2, :] = -127.0
        q = gen.integers(-hi, hi + 1, (C, qrows, J * L)).astype(np.float32)
    else:
        books = gen.integers(0, 2, (J, B, L)).astype(np.float32)
        q = gen.integers(0, 2, (C, qrows, J * L)).astype(np.float32)
    codes = gen.integers(0, B, (5, cap, J)).astype(np.int32)
    packed = ivf_pq.pack_codes(torch.as_tensor(codes), bits).numpy()
    codesT = np.ascontiguousarray(packed.transpose(0, 2, 1))
    invalid = gen.random((5, cap)) < 0.2
    invalid[1, :] = True            # an empty list
    invalid[3, 5:] = True           # a starved list
    invalid[4, 128:384] = True      # dead tiles between live ones
    cells = np.array([0, 1, -1, 3, 2, 4, 3], np.int32)[:C]
    return books, cells, q, codesT, invalid


def _pq_both(dev, books, cells, q, codesT, invalid, k, J, bits, is_ip,
             int8):
    """B4 on the card through the wrapper (one launch, counted under its
    selection path) and its plain version on the CPU copies."""
    tables = [t.to(dev) for t in ps.book_tables(torch.as_tensor(books),
                                                 bits, int8=int8)]
    cells, q, codesT, invalid = _on(dev, cells, q, codesT, invalid)
    scale = tables[2] if int8 else None
    before = ps.pq_fused_scan.launches
    by_select = dict(ps.pq_fused_scan.launches_by_select)
    kd, ki = ps.pq_fused_scan(cells, q, codesT, tables[0], tables[1],
                              invalid, k, J, bits, is_ip, int8_lut=scale)
    assert ps.pq_fused_scan.launches == before + 1
    by_select[ps._b4_select(k)] += 1
    assert ps.pq_fused_scan.launches_by_select == by_select
    pd, pi = ps.pq_fused_scan(cells.cpu(), q.cpu(), codesT.cpu(),
                              tables[0].cpu(), tables[1].cpu(),
                              invalid.cpu(), k, J, bits, is_ip,
                              int8_lut=None if scale is None else scale.cpu())
    return kd, ki, pd, pi


# (J, L, qrows): rot 16 at 40 rows; rot 128 with L = 1, 2, 4 at 64, 1 and
# 40 rows; rot 96 with L = 3 (codes straddle the 32-bit words). 64 rows
# take 64-row CTAs, 40 rows 32-row CTAs (the second with 8 rows), 1 row
# a 16-row CTA.
_PQ_GEOMS = [(8, 2, 40), (128, 1, 64), (64, 2, 1), (32, 4, 40),
             (32, 3, 64)]

# k of each selection path: 1 (a register minimum), 2, 10 and 16 (queues
# in registers), 256 (warp merges).
_PQ_KS = [1, 2, 10, 16, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("is_ip", [False, True])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("k", _PQ_KS)
@pytest.mark.parametrize("J,L,qrows", _PQ_GEOMS)
def test_pq_fused_scan_kernel(dev, gen, bits, is_ip, int8, k, J, L, qrows):
    """B4 on integer codebooks and queries: pq_bits 4/8, L2/IP, f32/int8
    tables, -1 cells, empty, starved and holed lists, odd L, 1 to 64 rows
    (every CTA height, and CTAs with fewer rows than their height)."""
    if k <= 16:
        assert ps._b4_plan(qrows, J * L, J, bits, k).bq == {
            40: 32, 64: 64, 1: 16}[qrows]
    books, cells, q, codesT, invalid = _pq_case(gen, bits, J=J, L=L,
                                                qrows=qrows)
    kd, ki, pd, pi = _pq_both(dev, books, cells, q, codesT, invalid, k, J,
                              bits, is_ip, int8)
    np.testing.assert_array_equal(n(ki), n(pi))
    np.testing.assert_array_equal(n(kd), n(pd))
    assert (n(ki)[2] == -1).all() and (n(ki)[1] == -1).all()
    if k > 5:
        assert (n(ki)[3, :, 5:] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("is_ip", [False, True])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("k", _PQ_KS)
@pytest.mark.parametrize("J,L", [(256, 2), (128, 4)])
def test_pq_fused_scan_kernel_sliced_table(dev, gen, is_ip, int8, k, J, L):
    """rot 512 at pq_bits 8: the table does not fit beside the tiles, so
    the plan stages it in slices; exact on integer data."""
    assert ps._b4_plan(64, J * L, J, 8, k).sliced
    books, cells, q, codesT, invalid = _pq_case(gen, 8, J=J, L=L, qrows=64,
                                                hi=2)
    kd, ki, pd, pi = _pq_both(dev, books, cells, q, codesT, invalid, k, J, 8,
                              is_ip, int8)
    np.testing.assert_array_equal(n(ki), n(pi))
    np.testing.assert_array_equal(n(kd), n(pd))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("is_ip", [False, True])
@pytest.mark.parametrize("k", [1, 2, 10, 16, 20, 64, 256])
@pytest.mark.parametrize("J,L,qrows", [(8, 2, 64), (64, 2, 40),
                                       (256, 2, 64), (8, 2, 8)])
def test_pq_fused_scan_kernel_ties(dev, gen, bits, is_ip, k, J, L, qrows):
    """{0, 1} books and queries: distances tie within an mma fragment,
    across the slots of different threads and warps and across tiles, so
    a wrong lane-to-(row, slot) map or a merge that breaks a tie by
    anything but the slot shows as a wrong id. f32 tables (the int8 scale
    of a {0, 1} row is not exact). k covers each selection path: 1 (a
    register minimum), 2, 10 and 16 (queues in registers at 64, 32 and 16
    rows a CTA), 20, 64 and 256 (warp merges at 64, 32 and 16 rows a
    CTA)."""
    books, cells, q, codesT, invalid = _pq_case(gen, bits, J=J, L=L,
                                                qrows=qrows, hi=0)
    kd, ki, pd, pi = _pq_both(dev, books, cells, q, codesT, invalid, k, J,
                              bits, is_ip, False)
    np.testing.assert_array_equal(n(ki), n(pi))
    np.testing.assert_array_equal(n(kd), n(pd))


# B4's tolerance on Gaussian data, as chip_smoke.py states it.
_B4_REL_TOL = 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("is_ip", [False, True])
def test_pq_fused_scan_kernel_gaussian(dev, gen, is_ip):
    """The main-path geometry (64-row cells, capacity 4096, rot 128, pq_dim
    64, pq_bits 8, k = 10) on Gaussian books and queries: per-slot recall
    >= 0.999 against the plain version, distances within the tolerance.
    The launch takes 64-row CTAs, the resident table and the queues in
    registers (``_pq_both`` checks its count under ``regs``)."""
    J, L, B, C, cap = 64, 2, 256, 24, 4096
    plan = ps._b4_plan(64, J * L, J, 8, 10)
    assert (plan.bq, plan.sliced, ps._b4_select(10)) == (64, False, "regs")
    books = gen.standard_normal((J, B, L)).astype(np.float32)
    q = gen.standard_normal((C, 64, J * L)).astype(np.float32)
    codes = gen.integers(0, B, (8, cap, J)).astype(np.int32)
    codesT = np.ascontiguousarray(
        ivf_pq.pack_codes(torch.as_tensor(codes), 8).numpy()
        .transpose(0, 2, 1))
    invalid = np.arange(cap)[None, :] >= gen.integers(700, 1300, (8, 1))
    cells = gen.integers(0, 8, C).astype(np.int32)
    kd, ki, pd, pi = _pq_both(dev, books, cells, q, codesT, invalid, 10, J,
                              8, is_ip, False)
    table = torch.as_tensor(books).permute(0, 2, 1).reshape(J * L, B)
    tol = _B4_REL_TOL * (float(torch.max(torch.sum(torch.as_tensor(q) ** 2,
                                                   dim=-1)))
                         + float(torch.sum(torch.amax(table ** 2, dim=1))))
    hit = (ki.cpu()[:, :, :, None] == pi[:, :, None, :]).any(dim=3)
    assert float(hit.float().mean()) >= 0.999
    assert float(torch.max(torch.abs(kd.cpu() - pd))) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf],
                         ids=["nan", "+inf", "-inf"])
def test_entry_points_reject_non_finite_on_the_card(dev, gen, value):
    """On the card, as on the CPU, a non-finite input raises before any
    kernel is launched (an L2 NaN would come out of fmaxf as distance 0)."""
    from raft_tpu_torch.cluster import kmeans_balanced
    from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams

    X = torch.as_tensor(int_data(gen, (9000, 32)), device=dev)
    Q = torch.as_tensor(int_data(gen, (300, 32)), device=dev)
    index = ivf_pq.build(ivf_pq.IndexParams(n_lists=16, kmeans_n_iters=4,
                                            pq_dim=16), X)
    Xb, Qb = X.clone(), Q.clone()
    Xb[17, 3] = value
    Qb[5, 30] = value
    calls = [lambda: brute_force.knn(X, Qb, 10),
             lambda: brute_force.knn(Xb, Q, 10),
             lambda: ivf_pq.search(ivf_pq.SearchParams(n_probes=8), index,
                                   Qb, 10),
             lambda: kmeans_balanced.fit(KMeansBalancedParams(n_iters=4),
                                         Xb, 16)]
    for call in calls:
        before = (fk.fused_knn.launches, ps.pq_fused_scan.launches)
        with pytest.raises(LogicError, match="finite"):
            call()
        assert (fk.fused_knn.launches, ps.pq_fused_scan.launches) == before


@pytest.mark.cuda
def test_ivf_pq_entry_points_launch_b3_and_b4(dev, gen):
    """IVF-PQ build on the card, the compressed tier through B4 and the
    recon tier through B3, held to the plain path on the CPU copy of the
    same index."""
    X = int_data(gen, (9000, 32))
    Q = int_data(gen, (400, 32))
    index = ivf_pq.build(ivf_pq.IndexParams(n_lists=16, kmeans_n_iters=4,
                                            pq_dim=16), X)
    cpu = ivf_pq.index_from_numpy(
        n(index.centers), n(index.rotation_matrix), n(index.pq_centers),
        n(index.pq_codes), n(index.indices), n(index.list_sizes),
        index.pq_bits, index.pq_dim, 0, 0, device="cpu")
    b3, b4 = fk.fused_batch_knn.launches, ps.pq_fused_scan.launches
    sp = ivf_pq.SearchParams(n_probes=8)            # auto: compressed
    d, i = ivf_pq.search(sp, index, Q, 10)
    assert ps.pq_fused_scan.launches == b4 + 1
    pd, pi = ivf_pq.search(ivf_pq.SearchParams(n_probes=8,
                                               engine="bucketed"), cpu,
                           torch.as_tensor(Q), 10)
    assert np.mean(n(i) == n(pi)) > 0.99
    np.testing.assert_allclose(n(d), n(pd), rtol=1e-4, atol=1e-2)
    index.reconstructed()
    cpu.reconstructed()
    sr = ivf_pq.SearchParams(n_probes=8, engine="bucketed", bucket_cap=256)
    rd, ri = ivf_pq.search(sr, index, Q, 10)
    assert fk.fused_batch_knn.launches == b3 + 1
    prd, pri = ivf_pq.search(sr, cpu, torch.as_tensor(Q), 10)
    assert np.mean(n(ri) == n(pri)) > 0.99


_B5_KINDS = ["gauss", "int_ties", "sorted", "constant", "inf_heavy", "nan",
             "ragged"]


def _b5_keys(gen, kind):
    """Keys for B5: (16, 24576), or (13, 100000) ragged in both axes."""
    if kind == "ragged":
        return gen.standard_normal((13, 100_000)).astype(np.float32)
    x = gen.standard_normal((16, 24576)).astype(np.float32)
    if kind == "int_ties":
        x = gen.integers(0, 3, x.shape).astype(np.float32)
    elif kind == "sorted":
        x[:5] = np.sort(x[:5], axis=1)
        x[5:9] = np.sort(x[5:9], axis=1)[:, ::-1]
    elif kind == "constant":
        x[:] = 2.5
    elif kind == "inf_heavy":
        x[0, :5000] = -np.inf
        x[1, 1000:] = np.inf
        x[2] = np.inf
    elif kind == "nan":
        x[3, 100] = np.nan
        x[7, 8000:8003] = np.nan
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("kind", _B5_KINDS)
def test_stream_extract_kernel(dev, gen, kind):
    """B5's candidate arrays equal the plain version's bit for bit (NaN
    where NaN)."""
    x = torch.as_tensor(_b5_keys(gen, kind), device=dev)
    before = ss.stream_extract.launches
    v, i = ss.stream_extract(x)
    assert ss.stream_extract.launches == before + 1
    pv, pi = ss.stream_extract(x.cpu())
    np.testing.assert_array_equal(n(v), n(pv))
    np.testing.assert_array_equal(n(i), n(pi))


def _same_bits(a, b):
    """Candidate values equal by bits (so -0 != +0), NaN where NaN (a
    NaN's payload may differ: the plain version keeps the key's)."""
    a, b = n(a), n(b)
    an, bn = np.isnan(a), np.isnan(b)
    np.testing.assert_array_equal(an, bn)
    np.testing.assert_array_equal(np.where(an, 0, a).view(np.int32),
                                  np.where(bn, 0, b).view(np.int32))


# One position per sub-chunk lane in both of B5's lane layouts (16-byte:
# lane (p % 128) // 4; 4-byte: lane p % 32): p_i = i + 32 (i % 4).
_B5_LANE_SPREAD = np.arange(32) + 32 * (np.arange(32) % 4)


def _b5_edge_keys(gen, kind):
    """(4, 8192) keys whose sub-chunks hit B5's branches: ``ties_C``, C
    keys at the threshold value (the first 32 in 32 lanes, so C keys are
    <= tau; C <= 32 takes the survivor list, C > 32 the eight passes) with
    the rest above it; ``zeros``, a random sign for each of the 9 tied
    zeros; ``neg_inf`` (-inf-heavy), ``starved`` (1-7 keys below +inf),
    ``constant``; ``nan_slow``, a constant row with a NaN in one
    sub-chunk."""
    x = 5 + gen.random((4, 8192)).astype(np.float32)
    subs = x.reshape(4, 16, 512)
    if kind.startswith("ties_") or kind == "zeros":
        cnt = 9 if kind == "zeros" else int(kind[5:])
        for r in range(4):
            for s in range(16):
                pos = list(_B5_LANE_SPREAD[:min(cnt, 32)])
                rest = np.setdiff1d(np.arange(512), pos)
                pos += list(gen.permutation(rest)[:max(0, cnt - 32)])
                subs[r, s, pos] = 1.0
                if kind == "zeros":
                    subs[r, s, pos] = np.where(gen.random(cnt) < 0.5, 0.0,
                                               -0.0)
    elif kind == "neg_inf":
        x[gen.random(x.shape) < 0.3] = -np.inf
        x[1, :600] = -np.inf
    elif kind == "starved":
        x[:] = np.inf
        for r in range(4):
            for s in range(16):
                k = 1 + (r * 16 + s) % 7
                subs[r, s, gen.permutation(512)[:k]] = gen.standard_normal(k)
    elif kind == "constant":
        x[:] = 3.0
    elif kind == "nan_slow":
        x[:] = 3.0
        x[2, 1000] = np.nan
    return x


_B5_EDGES = ["ties_8", "ties_9", "ties_32", "ties_33", "ties_512", "zeros",
             "neg_inf", "starved", "constant", "nan_slow"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", _B5_EDGES)
def test_stream_extract_kernel_branches(dev, gen, kind):
    """Both branches of B5 (the survivor list and the eight passes), both
    load widths, against the plain version: positions equal, values by
    bits (the key's own zero sign)."""
    x = _b5_edge_keys(gen, kind)
    pv, pi = ss.stream_extract(torch.as_tensor(x))
    for keys in (torch.as_tensor(x, device=dev),
                 _offset_view(torch.as_tensor(x, device=dev), 1)):
        v, i = ss.stream_extract(keys)
        np.testing.assert_array_equal(n(i), n(pi))
        _same_bits(v, pv)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,length,offset", [
    (3, 8193, 0), (3, 8194, 0), (3, 8195, 0), (5, 65539, 0),
    (4, 8192, 1), (4, 8192, 2), (4, 24576, 3), (3, 9000, 0), (3, 9000, 1),
    (2, 300, 0), (2, 511, 0), (2, 513, 0)])
def test_stream_extract_kernel_load_widths(dev, gen, batch, length, offset):
    """Rows off 16 bytes (n % 4 != 0, or a view ``offset`` floats into its
    storage) take the 4-byte loads, the rest the 16-byte ones; row lengths
    off the 512-key sub-chunk read +inf past n."""
    x = gen.standard_normal((batch, length)).astype(np.float32)
    x[0, :5] = [0.0, -0.0, -np.inf, 0.0, -0.0]
    keys = _offset_view(torch.as_tensor(x, device=dev), offset)
    assert ss._b5_plan(length, keys.data_ptr()) == (
        length % 4 == 0 and offset % 4 == 0)
    v, i = ss.stream_extract(keys)
    pv, pi = ss.stream_extract(torch.as_tensor(x))
    np.testing.assert_array_equal(n(i), n(pi))
    _same_bits(v, pv)


@pytest.mark.cuda
def test_stream_extract_refuses_16_byte_loads_off_alignment(dev):
    """The C entry refuses the 16-byte loads on a row start off 16 bytes."""
    keys = _offset_view(torch.zeros((2, 8192), device=dev), 1)
    out_v = torch.empty((2, ss.n_candidates(8192)), device=dev)
    out_i = torch.empty((2, ss.n_candidates(8192)), dtype=torch.int32,
                        device=dev)
    lib = ss._lib()
    for n_keys, k in ((8192, keys), (8190, keys[:, :8190].contiguous())):
        err = lib.stream_extract_launch(
            ss._build.ptr(k), ss._build.ptr(out_v), ss._build.ptr(out_i), 2,
            n_keys, 16, 1, ss._build.stream(dev))
        assert err != 0


@pytest.mark.cuda
@pytest.mark.parametrize("select_min", [True, False])
def test_kstream_signed_zeros_on_the_card(dev, gen, select_min):
    """+0 and -0 among the extracts: the candidates keep each key's zero,
    and kStream orders them as kTopK (lax.top_k: -0 before +0)."""
    x = 5 + gen.standard_normal((8, 65536)).astype(np.float32)
    x[:, [3, 5, 600, 9000]] = [0.0, -0.0, -0.0, 0.0]
    if not select_min:
        x = -x
    keys = torch.as_tensor(x, device=dev)
    v, i = select_k(keys, 64, select_min, method=SelectMethod.kStream)
    tv, ti = select_k(keys, 64, select_min, method=SelectMethod.kTopK)
    np.testing.assert_array_equal(n(i), n(ti))
    _same_bits(v, tv)
    kv, ki = ss.stream_extract(keys if select_min else -keys)
    pv, pi = ss.stream_extract(torch.as_tensor(x if select_min else -x))
    np.testing.assert_array_equal(n(ki), n(pi))
    _same_bits(kv, pv)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", _B5_KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("select_min", [True, False])
def test_kstream_select_on_the_card(dev, gen, kind, dtype, select_min):
    """select_k(kStream) on the card equals the plain path on the CPU and
    kTopK on the card, values and ids."""
    x = torch.as_tensor(_b5_keys(gen, kind)).to(dtype)
    xc = x.to(dev)
    before = ss.stream_extract.launches
    v, i = select_k(xc, 64, select_min, method=SelectMethod.kStream)
    assert ss.stream_extract.launches == before + 1
    pv, pi = select_k(x, 64, select_min, method=SelectMethod.kStream)
    tv, ti = select_k(xc, 64, select_min, method=SelectMethod.kTopK)
    for ref_v, ref_i in ((pv, pi), (tv, ti)):
        np.testing.assert_array_equal(n(i), n(ref_i))
        np.testing.assert_array_equal(n(v.float()), n(ref_v.float()))


@pytest.mark.cuda
def test_kauto_gate_launches_b5_on_the_card(dev, gen):
    x = torch.as_tensor(gen.standard_normal((8, 65536)).astype(np.float32),
                        device=dev)
    before = ss.stream_extract.launches
    v, i = select_k(x, 64)
    assert ss.stream_extract.launches == before + 1
    tv, ti = select_k(x, 64, method=SelectMethod.kTopK)
    np.testing.assert_array_equal(n(i), n(ti))
    select_k(x[:, :10000], 10)
    select_k(x[:7], 64)
    assert ss.stream_extract.launches == before + 1


@pytest.mark.cuda
def test_lifecycle_and_multipart_knn_on_the_card(dev, gen):
    """Multi-part knn (B1 per part) equals one-part search; a tombstoned
    IVF-Flat search (B2) and its compaction return no deleted id and equal
    the CPU copy of the same index."""
    X = int_data(gen, (12000, 32))
    Q = int_data(gen, (300, 32))
    d, i = brute_force.knn(X, Q, 10)
    parts = [X[:5000], X[5000:9000], X[9000:]]
    md, mi = brute_force.knn(parts, Q, 10)
    np.testing.assert_array_equal(n(mi), n(i))
    np.testing.assert_array_equal(n(md), n(d))
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=16,
                                                kmeans_n_iters=4), X)
    # Integer centers keep the probe order exact on both devices.
    index.centers = torch.round(index.centers)
    cpu = ivf_flat.index_from_numpy(n(index.centers), n(index.data),
                                    n(index.indices), n(index.list_sizes), 0,
                                    device="cpu")
    dels = np.arange(0, 12000, 3)
    assert lc.delete(index, dels) == lc.delete(cpu, dels) == dels.size
    sp = ivf_flat.SearchParams(n_probes=16)
    b2 = fk.fused_cells_knn.launches
    td, ti = ivf_flat.search(sp, index, Q, 10)
    assert fk.fused_cells_knn.launches == b2 + 1
    cd, ci = ivf_flat.search(ivf_flat.SearchParams(n_probes=16,
                                                   engine="bucketed"), cpu,
                             torch.as_tensor(Q), 10)
    np.testing.assert_array_equal(n(ti), n(ci))
    np.testing.assert_array_equal(n(td), n(cd))
    assert not np.isin(n(ti), dels).any()
    new, rep = lc.compact(index)
    assert rep.reclaimed_slots == dels.size and new.epoch == index.epoch + 1
    nd, ni = ivf_flat.search(sp, new, Q, 10)
    np.testing.assert_array_equal(n(ni), n(ti))
    np.testing.assert_array_equal(n(nd), n(td))


def _serve_pq_index(gen):
    """A maker of one small IVF-PQ index from integer arrays (identity
    rotation) on a given device: every product of the compressed tier is
    exact."""
    L, cap, d, J = 16, 96, 16, 8
    sizes = gen.integers(40, cap + 1, L).astype(np.int32)
    indices = np.full((L, cap), -1, np.int32)
    base = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    for l in range(L):
        indices[l, :sizes[l]] = base[l] + np.arange(sizes[l])
    codes = gen.integers(0, 256, (L, cap, J)).astype(np.int32)
    arrays = (int_data(gen, (L, d), hi=4), np.eye(d, dtype=np.float32),
              gen.integers(-2, 3, (J, 256, d // J)).astype(np.float32),
              n(ivf_pq.pack_codes(torch.as_tensor(codes), 8)), indices,
              sizes)
    return lambda dev_: ivf_pq.index_from_numpy(*arrays, 8, J, 0, 0,
                                                device=dev_)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_searcher_on_the_card_equals_cpu(dev, gen, kind):
    """One Searcher on the card (B2 / B4 through engine="bucketed") and
    one on the CPU (their plain versions) over the same integer index
    give the same ids and distances, through the BatchScheduler too."""
    if kind == "ivf_flat":
        X = int_data(gen, (6000, 16))
        index = ivf_flat.build(ivf_flat.IndexParams(n_lists=16,
                                                    kmeans_n_iters=4), X)
        index.centers = torch.round(index.centers)
        cpu = ivf_flat.index_from_numpy(n(index.centers), n(index.data),
                                        n(index.indices),
                                        n(index.list_sizes), 0, device="cpu")
        sp = ivf_flat.SearchParams(n_probes=8, engine="bucketed")
        s, c = serve.Searcher.ivf_flat(index, sp), serve.Searcher.ivf_flat(
            cpu, sp)
        counter = fk.fused_cells_knn
    else:
        make = _serve_pq_index(gen)
        sp = ivf_pq.SearchParams(n_probes=8, engine="bucketed")
        s = serve.Searcher.ivf_pq(make(dev), sp)
        c = serve.Searcher.ivf_pq(make("cpu"), sp)
        counter = ps.pq_fused_scan
    assert s.device.type == "cuda" and c.device.type == "cpu"
    Q = int_data(gen, (300, 16), hi=4 if kind == "ivf_pq" else 8)
    before = counter.launches
    for rows in (1, 7, 64, 300):
        for k in (1, 10):
            a, b = s.search(Q[:rows], k), c.search(Q[:rows], k)
            np.testing.assert_array_equal(a.indices, b.indices)
            np.testing.assert_array_equal(a.distances, b.distances)
    assert counter.launches == before + 8
    grid = serve.BucketGrid.pow2(64, k_grid=(10,))
    out = []
    for searcher in (s, c):
        sched = serve.BatchScheduler(searcher, grid,
                                     serve.BatchPolicy(max_batch=64,
                                                       max_wait=0.0))
        tks = [sched.submit(Q[i:i + 1 + i % 9], 10) for i in range(0, 200, 7)]
        sched.run_until_idle()
        out.append([(tk.result().indices, tk.result().distances)
                    for tk in tks])
    for (ai, ad), (bi, bd) in zip(*out):
        np.testing.assert_array_equal(ai, bi)
        np.testing.assert_array_equal(ad, bd)


@pytest.mark.cuda
def test_serving_builds_and_loads_nothing_in_steady_state(dev, gen):
    """After one warm-up, a second warm-up and a drive over the grid count
    no kernel build or library load, and the drive's full batches launch
    B2 (a probe load of 64 x 16 / 16 >= 8)."""
    X = int_data(gen, (6000, 16))
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=16,
                                                kmeans_n_iters=4), X)
    s = serve.Searcher.ivf_flat(index, ivf_flat.SearchParams(n_probes=16))
    grid = serve.BucketGrid.pow2(64, k_grid=(10, 100))
    serve.warmup(s, grid, degrade_ladder=(1.0, 0.5, 0.25))
    second = serve.warmup(s, grid, degrade_ladder=(1.0, 0.5, 0.25))
    assert second["compile_events"] == 0 and second["degrade_rungs"] == 2
    stats = serve.ServeStats()
    sched = serve.BatchScheduler(s, grid, serve.BatchPolicy(
        max_batch=64, max_wait=0.0), stats=stats)
    b2 = fk.fused_cells_knn.launches
    with serve.CompileCounter(stats) as counter:
        tks = [sched.submit(int_data(gen, (1 + i % 13, 16)), (10, 100)[i % 2])
               for i in range(60)]
        sched.run_until_idle()
    assert all(tk.done for tk in tks)
    assert counter.count == 0 and stats.snapshot()["compile_events"] == 0
    assert fk.fused_cells_knn.launches > b2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_save_and_load_on_the_card(dev, gen, tmp_path, kind):
    """An index saved from the card loads onto the card (the default
    device) with every array intact, and searches bit for bit as the saved
    one through B2 / B4; a tombstone survives the round trip."""
    if kind == "ivf_flat":
        mod, counter = ivf_flat, fk.fused_cells_knn
        X = int_data(gen, (6000, 16))
        index = ivf_flat.build(ivf_flat.IndexParams(n_lists=16,
                                                    kmeans_n_iters=4), X)
        fields = ("centers", "data", "indices", "list_sizes", "deleted")
    else:
        mod, counter = ivf_pq, ps.pq_fused_scan
        index = _serve_pq_index(gen)(dev)
        fields = ("centers", "rotation_matrix", "pq_centers", "pq_codes",
                  "indices", "list_sizes", "deleted")
    assert lc.delete(index, np.arange(0, 600, 3)) == 200
    mod.save(str(tmp_path / "idx"), index)
    back = mod.load(str(tmp_path / "idx"))
    assert back.centers.device.type == "cuda"
    assert back.n_deleted == index.n_deleted and back.epoch == 0
    for f in fields:
        assert torch.equal(getattr(back, f), getattr(index, f)), f
    sp = mod.SearchParams(n_probes=8, engine="bucketed")
    Q = int_data(gen, (300, 16), hi=4)
    before = counter.launches
    d, i = mod.search(sp, index, Q, 10)
    bd, bi = mod.search(sp, back, Q, 10)
    assert counter.launches == before + 2
    assert torch.equal(bi, i) and torch.equal(bd, d)
    assert not np.isin(n(bi), np.arange(0, 600, 3)).any()


@pytest.mark.cuda
def test_int64_ivf_flat_on_the_card_equals_cpu(dev, gen):
    """An int64 IVF-Flat index with ids past 2^33 searches through B2 on
    the card as its CPU copy does on the plain version."""
    big = 1 << 33
    X = int_data(gen, (6000, 16))
    index = ivf_flat.build(ivf_flat.IndexParams(
        n_lists=16, kmeans_n_iters=4, idx_dtype=torch.int64,
        add_data_on_build=False), X)
    index.centers = torch.round(index.centers)
    index = ivf_flat.extend(index, X, big + np.arange(6000))
    cpu = ivf_flat.index_from_numpy(n(index.centers), n(index.data),
                                    n(index.indices), n(index.list_sizes), 0,
                                    device="cpu")
    assert index.indices.dtype == cpu.indices.dtype == torch.int64
    Q = int_data(gen, (300, 16))
    before = fk.fused_cells_knn.launches
    d, i = ivf_flat.search(ivf_flat.SearchParams(n_probes=8), index, Q, 10)
    assert fk.fused_cells_knn.launches == before + 1
    cd, ci = ivf_flat.search(ivf_flat.SearchParams(n_probes=8,
                                                   engine="bucketed"),
                             cpu, torch.as_tensor(Q), 10)
    assert i.dtype == torch.int64 and int(i.min()) >= big
    np.testing.assert_array_equal(n(i), n(ci))
    np.testing.assert_array_equal(n(d), n(cd))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l1", "braycurtis"])
def test_unexpanded_metric_on_the_card_equals_cpu(dev, gen, metric):
    """An unexpanded metric's kNN (cdist for L1, the blocked core for
    Bray-Curtis) over several database tiles on the card equals the CPU's
    bit for bit on integer data: both are sums of integers and at most one
    division, exact in any order."""
    X = int_data(gen, (20000, 24))
    Q = int_data(gen, (200, 24))
    d, i = brute_force.knn(X, Q, 10, metric=metric)
    cd, ci = brute_force.knn(torch.as_tensor(X), torch.as_tensor(Q), 10,
                             metric=metric)
    assert d.device.type == "cuda"
    np.testing.assert_array_equal(n(i), n(ci))
    np.testing.assert_array_equal(n(d), n(cd))


# ---------------------------------------------------------------------------
# Sharding: a world of one on NCCL (the chip machine has one card).


@pytest.fixture
def nccl_mesh(dev, tmp_path):
    import torch.distributed as dist

    from raft_tpu_torch import parallel

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield parallel.make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["allgather", "ring", "ring_bf16",
                                    "pipelined", "pipelined_bf16"])
def test_sharded_knn_world_of_one_equals_the_single_card_search(
        nccl_mesh, dev, gen, engine):
    from raft_tpu_torch import parallel

    X, Q = _on(dev, int_data(gen, (20000, 32)), int_data(gen, (300, 32)))
    before = fk.fused_knn.launches
    d, i = parallel.sharded_knn(nccl_mesh, X, Q, 10, merge_engine=engine,
                                pipeline_chunks=3)
    assert fk.fused_knn.launches > before
    bd, bi = brute_force.knn(X, Q, 10)
    np.testing.assert_array_equal(n(i), n(bi))
    np.testing.assert_array_equal(n(d), n(bd))
    d, i, cov = parallel.sharded_knn(nccl_mesh, X, Q, 10,
                                     merge_engine=engine, live_mask=[True])
    np.testing.assert_array_equal(n(i), n(bi))
    assert bool((cov == 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["auto", "bucketed"])
def test_sharded_ivf_flat_world_of_one_equals_the_single_card_search(
        nccl_mesh, dev, gen, engine):
    """The same centers, the same rows: the sharded index is the
    single-card one, and its search (B2 through "bucketed", and at this
    probe load through "auto") gives the same (distance, id) pairs."""
    from raft_tpu_torch import parallel
    from raft_tpu_torch.comms import ShardHealth

    X, Q = _on(dev, int_data(gen, (8192, 16)), int_data(gen, (512, 16)))
    centers = X[::512][:16].clone()
    single = ivf_flat.Index(
        metric=ivf_flat.IndexParams().metric, centers=centers,
        data=torch.zeros((16, 1, 16), device=dev),
        indices=torch.full((16, 1), -1, dtype=torch.int32, device=dev),
        list_sizes=torch.zeros(16, dtype=torch.int32, device=dev))
    single = ivf_flat.extend(single, X)
    sharded = parallel.sharded_ivf_flat_build(
        nccl_mesh, ivf_flat.IndexParams(n_lists=16), X, centers=centers)
    assert sharded.data.shape == single.data.shape
    sp = ivf_flat.SearchParams(n_probes=5, engine=engine)
    before = fk.fused_cells_knn.launches
    d, i = parallel.sharded_ivf_flat_search(nccl_mesh, sp, sharded, Q, 10)
    assert fk.fused_cells_knn.launches > before
    sd, si = ivf_flat.search(sp, single, Q, 10)
    # The merge orders exact distance ties by id, a single-card engine by
    # candidate slot.
    same_up_to_exact_ties("sharded IVF-Flat", d, i, sd, si)
    res = serve.Searcher.ivf_flat(sharded, sp, mesh=nccl_mesh,
                                  health=ShardHealth(1)).search(
        Q, 10, degraded=True)
    assert res.degraded and (res.coverage == 1).all()
    same_up_to_exact_ties("degraded sharded Searcher",
                          torch.as_tensor(res.distances),
                          torch.as_tensor(res.indices), sd.cpu(), si.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["auto", "bucketed"])
def test_routed_ivf_flat_world_of_one_equals_the_single_card_search(
        nccl_mesh, dev, gen, engine):
    """The list placement over one rank: its lists are the single-card
    ones in other slots, and the routed search (B2 over the routed group
    and its local slots) gives the single-card (distance, id) pairs."""
    from raft_tpu_torch import parallel

    X, Q = _on(dev, int_data(gen, (8192, 16)), int_data(gen, (512, 16)))
    centers = X[::512][:16].clone()
    single = ivf_flat.Index(
        metric=ivf_flat.IndexParams().metric, centers=centers,
        data=torch.zeros((16, 1, 16), device=dev),
        indices=torch.full((16, 1), -1, dtype=torch.int32, device=dev),
        list_sizes=torch.zeros(16, dtype=torch.int32, device=dev))
    single = ivf_flat.extend(single, X)
    routed = parallel.sharded_ivf_flat_build(
        nccl_mesh, ivf_flat.IndexParams(n_lists=16), X, centers=centers,
        placement="list")
    assert routed.placement == "list" and routed.pack_bytes == 0
    sp = ivf_flat.SearchParams(n_probes=5, engine=engine)
    before = fk.fused_cells_knn.launches
    d, i = parallel.sharded_ivf_flat_search(nccl_mesh, sp, routed, Q, 10)
    assert fk.fused_cells_knn.launches > before
    sd, si = ivf_flat.search(sp, single, Q, 10)
    same_up_to_exact_ties("routed IVF-Flat", d, i, sd, si)
    res = serve.Searcher.ivf_flat(routed, sp, mesh=nccl_mesh).search(Q, 10)
    same_up_to_exact_ties("routed Searcher", torch.as_tensor(res.distances),
                          torch.as_tensor(res.indices), sd.cpu(), si.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["row", "list"])
@pytest.mark.parametrize("engine", ["auto", "scan"])
def test_sharded_ivf_pq_world_of_one_equals_the_single_card_search(
        nccl_mesh, dev, gen, placement, engine):
    """The same trained model, the same rows: the sharded IVF-PQ's search
    (B4 per rank through "auto" at this probe load, the LUT scan through
    "scan") gives the single-card index's (distance, id) pairs, and its
    encode launches B1 k=1."""
    import copy

    from raft_tpu_torch import parallel

    X, Q = _on(dev, int_data(gen, (8192, 16), hi=4),
               int_data(gen, (512, 16), hi=4))
    params = ivf_pq.IndexParams(n_lists=16, pq_dim=8, kmeans_n_iters=4,
                                add_data_on_build=False)
    model = ivf_pq.build(params, X)
    single = ivf_pq.extend(copy.copy(model), X)
    before = fk.fused_knn.launches
    sharded = parallel.sharded_ivf_pq_build(nccl_mesh, params, X,
                                            model=model, placement=placement)
    assert fk.fused_knn.launches > before
    sp = ivf_pq.SearchParams(n_probes=5, engine=engine)
    before = ps.pq_fused_scan.launches
    d, i = parallel.sharded_ivf_pq_search(nccl_mesh, sp, sharded, Q, 10)
    assert (ps.pq_fused_scan.launches > before) == (engine == "auto")
    sd, si = ivf_pq.search(sp, single, Q, 10)
    same_up_to_exact_ties(f"sharded IVF-PQ ({placement})", d, i, sd, si)
    res = serve.Searcher.ivf_pq(sharded, sp, mesh=nccl_mesh).search(Q, 10)
    same_up_to_exact_ties("sharded IVF-PQ Searcher",
                          torch.as_tensor(res.distances),
                          torch.as_tensor(res.indices), sd.cpu(), si.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["row", "list"])
@pytest.mark.parametrize("kind", ["flat", "pq"])
def test_sharded_save_load_and_compact_world_of_one(
        nccl_mesh, dev, gen, tmp_path, kind, placement):
    """A sharded index with tombstones saved and loaded over a NCCL world
    of one answers as before, bit for bit (B2 / B4 on the loaded
    tensors), and a shrink_capacity compaction of the loaded index
    answers as the tombstoned one."""
    from raft_tpu_torch import parallel

    X, Q = _on(dev, int_data(gen, (8192, 16), hi=4),
               int_data(gen, (512, 16), hi=4))
    if kind == "flat":
        index = parallel.sharded_ivf_flat_build(
            nccl_mesh, ivf_flat.IndexParams(n_lists=16), X,
            centers=X[::512][:16].clone(), placement=placement)
        sp = ivf_flat.SearchParams(n_probes=5, engine="bucketed")
        search, kernel = parallel.sharded_ivf_flat_search, fk.fused_cells_knn
    else:
        params = ivf_pq.IndexParams(n_lists=16, pq_dim=8, kmeans_n_iters=4,
                                    add_data_on_build=False)
        index = parallel.sharded_ivf_pq_build(
            nccl_mesh, params, X, model=ivf_pq.build(params, X),
            placement=placement)
        sp = ivf_pq.SearchParams(n_probes=5, engine="bucketed")
        search, kernel = parallel.sharded_ivf_pq_search, ps.pq_fused_scan
    assert lc.delete(index, np.arange(0, 8192, 3), mesh=nccl_mesh) == 2731
    before = kernel.launches
    d0, i0 = search(nccl_mesh, sp, index, Q, 10)
    base = str(tmp_path / "snap")
    parallel.sharded_ivf_save(nccl_mesh, base, index)
    assert parallel.verify_sharded_manifest(base) == index.epoch
    loaded = parallel.sharded_ivf_load(nccl_mesh, base)
    assert loaded.indices.is_cuda and loaded.n_deleted == 2731
    d1, i1 = search(nccl_mesh, sp, loaded, Q, 10)
    np.testing.assert_array_equal(n(i1), n(i0))
    np.testing.assert_array_equal(n(d1), n(d0))
    new, report = lc.compact(loaded, lc.CompactionPolicy(
        shrink_capacity=True), mesh=nccl_mesh)
    assert report.reclaimed_slots == 2731 and report.live_rows == 8192 - 2731
    assert new.indices.shape[1] < loaded.indices.shape[1]
    d2, i2 = search(nccl_mesh, sp, new, Q, 10)
    same_up_to_exact_ties(f"compacted {kind} ({placement})", d2, i2, d0, i0)
    assert kernel.launches >= before + 3


# ---------------------------------------------------------------------------
# Durability and operations on the card: a world of one on NCCL.


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flat", "pq"])
def test_wal_stream_and_recover_world_of_one(nccl_mesh, dev, gen, tmp_path,
                                             kind):
    """A logged mutation stream (extend, delete, upsert, a shrinking
    compaction) through a sharded Searcher on the card, then ``recover``:
    the recovered index lands on the head epoch and answers as the live
    one (B2 / B4 on both; exact ties aside, the card's builds use
    atomics)."""
    from raft_tpu_torch import parallel

    X, Q = _on(dev, int_data(gen, (8192, 16), hi=4),
               int_data(gen, (512, 16), hi=4))
    if kind == "flat":
        index = parallel.sharded_ivf_flat_build(
            nccl_mesh, ivf_flat.IndexParams(n_lists=16), X,
            centers=X[::512][:16].clone(), placement="list")
        sp = ivf_flat.SearchParams(n_probes=5, engine="bucketed")
        kernel, make = fk.fused_cells_knn, serve.Searcher.ivf_flat
    else:
        params = ivf_pq.IndexParams(n_lists=16, pq_dim=8, kmeans_n_iters=4,
                                    add_data_on_build=False)
        index = parallel.sharded_ivf_pq_build(
            nccl_mesh, params, X, model=ivf_pq.build(params, X),
            placement="row")
        sp = ivf_pq.SearchParams(n_probes=5, engine="bucketed")
        kernel, make = ps.pq_fused_scan, serve.Searcher.ivf_pq
    root = str(tmp_path / "log")
    log = lc.MutationLog(root, n_parts=1, mesh=nccl_mesh)
    log.snapshot(index, nccl_mesh)
    s = make(index, sp, mesh=nccl_mesh, wal=log)
    s.extend(int_data(gen, (1024, 16), hi=4))
    assert s.delete(np.arange(0, 8192, 5)) > 0
    s.upsert(int_data(gen, (256, 16), hi=4), np.arange(1, 1024, 4))
    assert s.compact(lc.CompactionPolicy(shrink_capacity=True)) is not None
    assert s.epoch == 4 and log.head_epoch() == 4
    log.close()
    before = kernel.launches
    live = s.search(Q, 10)
    rec, log2 = lc.recover(nccl_mesh, root, n_parts=1)
    assert rec.epoch == 4 and rec.indices.is_cuda
    got = make(rec, sp, mesh=nccl_mesh).search(Q, 10)
    log2.close()
    assert kernel.launches >= before + 2
    same_up_to_exact_ties(f"recovered {kind}", torch.as_tensor(got.distances),
                          torch.as_tensor(got.indices),
                          torch.as_tensor(live.distances),
                          torch.as_tensor(live.indices))


@pytest.mark.cuda
def test_recall_probe_over_b2_world_of_one(nccl_mesh, dev, gen):
    """A front-rank scheduler over the routed IVF-Flat (B2) with a
    sampling probe: the truth searches are full-probe B2 launches, and
    the probe's recall equals the recall of its sampled answers against
    the single-card full-probe search."""
    from raft_tpu_torch import obs, parallel

    X = torch.as_tensor(int_data(gen, (8192, 16)), device=dev)
    centers = X[::512][:16].clone()
    index = parallel.sharded_ivf_flat_build(
        nccl_mesh, ivf_flat.IndexParams(n_lists=16), X, centers=centers,
        placement="list")
    s = serve.Searcher.ivf_flat(index, ivf_flat.SearchParams(
        n_probes=2, engine="bucketed"), mesh=nccl_mesh)
    probe = obs.RecallProbe(s, rate=0.5, seed=5)
    sampled, real = [], probe.offer

    def offer(queries, k, indices, bucket, epoch):
        hit = real(queries, k, indices, bucket, epoch)
        if hit:
            sampled.append((queries, np.asarray(indices)))
        return hit

    probe.offer = offer
    sched = serve.BatchScheduler(s, serve.BucketGrid.pow2(256,
                                                          k_grid=(10,)),
                                 serve.BatchPolicy(max_batch=256),
                                 probe=probe)
    for _ in range(8):
        sched.submit(int_data(gen, (256, 16)), 10)
        sched.run_until_idle()
    before = fk.fused_cells_knn.launches
    scored = probe.run_pending()
    assert scored == len(sampled) > 0
    assert fk.fused_cells_knn.launches >= before + scored
    full = ivf_flat.SearchParams(n_probes=16, engine="bucketed")
    hits = []
    for q, ids in sampled:
        _, truth = parallel.sharded_ivf_flat_search(nccl_mesh, full, index,
                                                    q, 10)
        truth = n(truth)
        hits += [len(np.intersect1d(ids[r], truth[r])) / 10.0
                 for r in range(q.shape[0])]
    assert probe.recall() == pytest.approx(float(np.mean(hits)), abs=1e-12)
    sched.close()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16], ids=str)
@pytest.mark.parametrize("metric", ["l1", "chebyshev"])
def test_l1_linf_half_precision_on_the_card(dev, gen, dtype, metric):
    """L1 and Linf on f16 / bf16 rows answer on the card in the rows'
    dtype, equal to the CPU's answer on integer-valued rows (every sum
    exact in both dtypes): pairwise distances and kNN ids bit for bit."""
    from raft_tpu_torch.distance import pairwise_distance

    q, db = int_data(gen, (37, 24)), int_data(gen, (700, 24))
    for x in (q, db):
        x -= 3
    qc, dbc = torch.as_tensor(q).to(dtype), torch.as_tensor(db).to(dtype)
    got = pairwise_distance(qc.to(dev), dbc.to(dev), metric=metric)
    assert got.dtype == dtype and got.device.type == "cuda"
    assert torch.equal(got.cpu(), pairwise_distance(qc, dbc, metric=metric))
    d, i = brute_force.knn(dbc.to(dev), qc.to(dev), 9, metric=metric)
    cd, ci = brute_force.knn(dbc, qc, 9, metric=metric)
    assert torch.equal(i.cpu(), ci) and torch.equal(d.cpu(), cd)


@pytest.mark.cuda
def test_lloyd_fit_on_the_card_equals_the_cpu(dev, gen):
    """Lloyd k-means from ``InitMethod.Array`` on the card (its loop on
    B1's split-bf16 tier, the returned labels from an f32 B1 launch)
    against the plain path on the CPU: labels equal except at near-ties
    (the two centroids within the expanded form's rounding of a row),
    centroids within 1e-4 of the data's scale, inertia within rtol 1e-5
    plus that rounding over the rows."""
    from raft_tpu_torch.cluster import InitMethod, KMeansParams, kmeans

    k, d = 50, 64
    centers = gen.uniform(-10, 10, (k, d)).astype(np.float32)
    y = gen.permutation(np.arange(20_000) % k)
    X = (centers[y] + gen.standard_normal((20_000, d))).astype(np.float32)
    c0 = (centers + 0.5).astype(np.float32)
    p = KMeansParams(n_clusters=k, init=InitMethod.Array, max_iter=20)
    before = fk.fused_knn.launches
    c, labels, inertia, it = kmeans.fit_predict(
        p, torch.as_tensor(X, device=dev), centroids_init=c0)
    assert fk.fused_knn.launches > before + it
    pc, pl, pinertia, pit = kmeans.fit_predict(p, torch.as_tensor(X),
                                               centroids_init=c0)
    assert labels.device.type == "cuda" and labels.dtype == torch.int32
    xn = float(np.max(np.sum(X.astype(np.float64) ** 2, axis=1)))
    cn = float(torch.max(torch.sum(pc.double() ** 2, dim=1)))
    tol = 2e-6 * (xn + cn)
    diff = n(labels) != n(pl)
    if diff.any():
        Xd = torch.as_tensor(X[diff]).double()
        d_card = torch.sum((Xd - pc.double()[torch.as_tensor(
            n(labels)[diff]).long()]) ** 2, dim=1)
        d_cpu = torch.sum((Xd - pc.double()[pl[torch.as_tensor(diff)]
                                            .long()]) ** 2, dim=1)
        assert float(torch.max(torch.abs(d_card - d_cpu))) <= tol
    assert diff.mean() <= 1e-3
    np.testing.assert_allclose(n(c), n(pc), rtol=0, atol=1e-4 * 10)
    np.testing.assert_allclose(float(inertia), float(pinertia), rtol=1e-5,
                               atol=tol * X.shape[0])


@pytest.mark.cuda
def test_knn_graph_on_the_card_equals_the_cpu(dev, gen):
    """``sparse.neighbors.knn_graph`` over 20,000 rows on the card (each
    query chunk one B1 launch, k + 1 = 11) against the plain path on the
    CPU: rows equal, ids equal except at near-ties, where the id the card
    chose is at the CPU's distance within 2e-6 of the largest |x|^2 (the
    expanded form's rounding, doubled)."""
    from raft_tpu_torch.sparse import neighbors as sn

    X = (gen.uniform(-10, 10, (40, 32))[gen.permutation(20_000) % 40]
         + gen.standard_normal((20_000, 32))).astype(np.float32)
    before = fk.fused_knn.launches
    g = sn.knn_graph(torch.as_tensor(X, device=dev), 10)
    assert fk.fused_knn.launches == before + 1
    p = sn.knn_graph(torch.as_tensor(X), 10)
    assert g.rows.device.type == "cuda" and g.cols.dtype == torch.int32
    np.testing.assert_array_equal(n(g.rows), n(p.rows))
    assert not (n(g.rows) == n(g.cols)).any()
    xn = float(np.max(np.sum(X.astype(np.float64) ** 2, axis=1)))
    tol = 2e-6 * 2 * xn
    dg = n(g.vals).astype(np.float64) ** 2
    dp = n(p.vals).astype(np.float64) ** 2
    assert np.max(np.abs(dg - dp)) <= tol
    diff = n(g.cols) != n(p.cols)
    if diff.any():
        r, c = n(g.rows)[diff], n(g.cols)[diff]
        true = np.sum((X[r].astype(np.float64) - X[c]) ** 2, axis=1)
        assert np.max(np.abs(true - dp[diff])) <= tol
    assert diff.mean() <= 1e-3


@pytest.mark.cuda
def test_sparse_row_sums_repeat_on_the_card(dev, gen):
    """SpMV, SpMM and the row normalisation add each CSR row in a fixed
    order: two runs on the card agree bit for bit, and with the CPU within
    f32 rounding."""
    from raft_tpu_torch.sparse import linalg as sl
    from raft_tpu_torch.sparse.types import CSR

    m, d, per = 50_000, 4096, 64
    indptr = np.arange(0, m * per + 1, per, dtype=np.int32)
    cols = gen.integers(0, d, m * per).astype(np.int32)
    vals = gen.standard_normal(m * per).astype(np.float32)
    x = gen.standard_normal(d).astype(np.float32)
    b = gen.standard_normal((d, 16)).astype(np.float32)
    a = CSR(*_on(dev, indptr, cols, vals), (m, d))
    xd, bd = _on(dev, x, b)
    for fn in (lambda: sl.spmv(a, xd), lambda: sl.spmm(a, bd),
               lambda: sl.row_normalize_l1(a).vals):
        first, second = fn(), fn()
        assert torch.equal(first, second)
    a_cpu = CSR(*(torch.as_tensor(v) for v in (indptr, cols, vals)), (m, d))
    np.testing.assert_allclose(n(sl.spmv(a, xd)),
                               n(sl.spmv(a_cpu, torch.as_tensor(x))),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_ball_cover_fallback_launches_b5_and_equals_the_cpu(dev, gen):
    """Queries far above a flat cloud of 131,072 rows leave every query
    unresolved at half the landmarks, so ``knn_query`` takes the dense
    scan, whose select (16 x 131,072, k=64) is B5 on the card. The same
    index on the CPU (the same landmarks) gives the same answer bit for
    bit: the distances are elementwise f32 operations in one order, and
    B5's select equals the sort's, ties included."""
    from raft_tpu_torch.distance.distance_types import DistanceType
    from raft_tpu_torch.neighbors import ball_cover as bc

    rows = 131_072
    X = np.concatenate([gen.uniform(-1, 1, (rows, 2)),
                        1e-3 * gen.standard_normal((rows, 1))],
                       axis=1).astype(np.float32)
    Q = np.concatenate([gen.uniform(-1, 1, (16, 2)), np.full((16, 1), 2000.0)],
                       axis=1).astype(np.float32)
    perm = gen.permutation(rows)[:362]
    metric = DistanceType.L2SqrtUnexpanded
    card = bc._build_from_landmarks(*_on(dev, X, perm), metric)
    cpu = bc._build_from_landmarks(torch.as_tensor(X), torch.as_tensor(perm),
                                   metric)
    for f in ("groups", "group_indices", "group_sizes", "radii"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    before = ss.stream_extract.launches
    d, i = bc.knn_query(card, torch.as_tensor(Q, device=dev), 64)
    assert ss.stream_extract.launches > before
    pd, pi = bc.knn_query(cpu, torch.as_tensor(Q), 64)
    assert torch.equal(d.cpu(), pd) and torch.equal(i.cpu(), pi)


@pytest.mark.cuda
def test_eps_neighbors_l2sq_ignores_a_global_tf32_setting(dev, gen):
    """With TF32 switched on for the whole process (which does change a
    plain product here), ``eps_neighbors_l2sq`` returns what it returns
    with it off: it asks for full-f32 products itself."""
    from raft_tpu_torch.neighbors import eps_neighbors_l2sq

    x, y = _on(dev, gen.standard_normal((2000, 64)).astype(np.float32),
               gen.standard_normal((3000, 64)).astype(np.float32))
    eps_sq = float(torch.median(torch.cdist(x[:100], y[:100]) ** 2))
    want = eps_neighbors_l2sq(x, y, eps_sq)
    full = x @ y.T
    prev = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = x @ y.T
        got = eps_neighbors_l2sq(x, y, eps_sq)
        assert torch.get_float32_matmul_precision() != "highest"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert not torch.equal(tf32, full)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("product", ["gemm", "gemv", "gram"])
def test_full_f32_products_ignore_a_global_tf32_setting(dev, gen, product):
    """Every product of ``linalg.blas`` and ``distance.pairwise.gram`` is
    the full-f32 one with TF32 switched on for the whole process, and
    the caller's setting is back afterwards."""
    from raft_tpu_torch.distance.pairwise import gram
    from raft_tpu_torch.linalg import blas

    x, y = _on(dev, gen.standard_normal((1000, 256)).astype(np.float32),
               gen.standard_normal((1500, 256)).astype(np.float32))
    fn = {"gemm": lambda: blas.gemm(x, y, trans_b=True),
          "gemv": lambda: blas.gemv(y, x[0]),
          "gram": lambda: gram(x, y)}[product]
    want = fn()
    prev = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = fn()
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_lap_cuda_graph_equals_the_cpu(dev, gen):
    """The auction's rounds replay as a CUDA graph on the card: the
    assignments equal the CPU's eager rounds bit for bit, batched and
    one problem at a time, and a round cap that leaves rows to the host
    repair gives the CPU's permutation too."""
    from raft_tpu_torch.solver import LinearAssignmentProblem, lap

    costs = gen.random((3, 300, 300)).astype(np.float32)
    costs[1] = gen.integers(0, 100, (300, 300))
    p = LinearAssignmentProblem(300, 3)
    p.solve(torch.as_tensor(costs, device=dev))
    q = LinearAssignmentProblem(300, 3)
    q.solve(torch.as_tensor(costs))
    for b in range(3):
        a, _ = lap(torch.as_tensor(costs[b], device=dev))
        assert torch.equal(a.cpu(), q.getAssignmentVector(b))
        assert torch.equal(p.getAssignmentVector(b).cpu(),
                           q.getAssignmentVector(b))
    capped = lap(torch.as_tensor(costs[0], device=dev), max_rounds=5)[0]
    assert torch.equal(capped.cpu(), lap(torch.as_tensor(costs[0]),
                                         max_rounds=5)[0])


def _blobs_on(dev, n_rows, d, n_blobs, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    centers = torch.empty((n_blobs, d), device=dev).uniform_(-10, 10,
                                                             generator=g)
    labels = torch.randint(0, n_blobs, (n_rows,), device=dev, generator=g)
    return centers[labels] + 5.0 * torch.randn((n_rows, d), device=dev,
                                               generator=g)


def _traced_syncs(fn):
    """Run ``fn`` under the profiler with ``set_sync_debug_mode("warn")``:
    ``(syncs inside a span of the port, the stacks of those outside,
    spans, profile)`` (each sync warning sorted by whether a span was open
    when raised)."""
    import traceback
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.core import nvtx

    nvtx.take_spans()
    torch.cuda.synchronize()
    inside, outside = [], []

    def show(message, *args, **kwargs):
        if "called a synchronizing CUDA operation" in str(message):
            if nvtx._open_spans():
                inside.append(1)
            else:
                outside.append("".join(traceback.format_stack(limit=12)))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    taken = nvtx.take_spans()
    assert taken.dropped == 0
    return len(inside), outside, taken.spans, prof


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["ivf_flat.search", "ivf_pq.search",
                                  "ivf_flat.build"])
def test_stage_spans_on_the_card(dev, what):
    """A flat-batch-shaped IVF-Flat search (10,000 queries, 1024 lists, 32
    probes), an IVF-PQ search of the compressed tier and a small
    hierarchical IVF-Flat build: their ``sync.*`` spans count exactly the
    host syncs ``set_sync_debug_mode`` reports inside them, and none is
    outside; every span has a device interval; a search's stages tile its
    root's device interval to 2%; each span's host interval lies within
    50 us of its record function's event in the profiler's trace."""
    if what == "ivf_flat.build":
        X = _blobs_on(dev, 50_000, 32, 100, 3)
        params = ivf_flat.IndexParams(n_lists=512)

        def fn():
            return ivf_flat.build(params, X)
    else:
        X = _blobs_on(dev, 200_000, 128, 1000, 4)
        Q = X[:10_000] + torch.randn_like(X[:10_000])
        if what == "ivf_flat.search":
            index = ivf_flat.build(ivf_flat.IndexParams(n_lists=1024), X)
            sp = ivf_flat.SearchParams(n_probes=32)

            def fn():
                return ivf_flat.search(sp, index, Q, 10)
        else:
            index = ivf_pq.build(ivf_pq.IndexParams(
                n_lists=1024, pq_dim=64, pq_bits=8), X)
            sp = ivf_pq.SearchParams(n_probes=32)

            def fn():
                return ivf_pq.search(sp, index, Q, 10)
    fn()
    inside, outside, spans, prof = _traced_syncs(fn)
    counted = sum(s.attrs.get("syncs", 1) for s in spans
                  if s.name.startswith("sync."))
    root = spans[0]
    assert root.name == what and root.parent == 0
    assert outside == []
    assert inside == counted
    assert all(s.device_ms is not None for s in spans)
    if what.endswith("search"):
        stages = sum(s.device_ms for s in spans if s.parent == root.id)
        assert abs(stages - root.device_ms) <= 0.02 * root.device_ms
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if (ev.name().startswith("raft_tpu_torch::")
                and not str(ev.device_type()).endswith("CUDA")):
            events.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    worst = 0
    for label in {s.label for s in spans}:
        group = sorted((s for s in spans if s.label == label),
                       key=lambda s: s.start_ns)
        evs = sorted(events[label])
        assert len(evs) == len(group), label
        for s, (e0, e1) in zip(group, evs):
            worst = max(worst, abs(s.start_ns - e0), abs(s.end_ns - e1))
    assert worst <= 50_000, worst
