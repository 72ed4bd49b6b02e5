"""B2's launch plan and its plain version at cell heights off the row
blocks, on the CPU.

``_b2_tf32_plan`` (the f32 tier's 3xTF32 scan) and ``_b2_mma_plan`` (the
bf16 tiers' scan) decide how many query rows of a cell one CUDA CTA takes
and how many bytes of shared memory it needs; the C entry points refuse a
launch whose count differs from their own layout, so the plans are held
here to their contract over the shapes the wrapper accepts. The plain version,
which the card kernel is held to, is run at qrows 65 and 128 (a second,
ragged or full, block of rows) against the reference Pallas kernel in
interpret mode: integer data, so ids and distances agree bit for bit.
"""

import ctypes
import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu_torch.ops import _build
from test_torch_common import int_data, n, t

fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")

jfk = importlib.import_module("raft_tpu.ops.fused_knn")

_QROWS = (1, 8, 15, 16, 17, 31, 32, 33, 63, 64, 65, 100, 128)
_TF32_DIMS = (1, 16, 33, 128, 256, 384, 385, 512, 1024)


def _r16(x):
    return -(-x // 16) * 16
_KS = (1, 2, 10, 16, 17, 32, 64, 65, 100, 128, 129, 200, 255, 256)


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("k", _KS)
def test_plan_fits_shared_memory(k, store):
    """B2's f32 tier (the 3xTF32 scan) on an f32 or bf16 store: the most
    rows a CTA whose bytes fit, at every d up to 1024 (the query block is
    resident, so d enters the count)."""
    for qrows in _QROWS:
        most = max(16, _r16(qrows))
        for d in _TF32_DIMS:
            plan = fk._b2_tf32_plan(qrows, d, k, store)
            assert plan.bq in fk.B2_ROWS
            # Never more rows than the cell needs (past the smallest
            # block), and the most rows whose bytes fit.
            assert plan.bq <= most
            assert plan.smem == fk._b2_tf32_smem_bytes(plan.bq, d, k, store)
            assert plan.smem <= fk.SMEM_LIMIT and plan.smem % 16 == 0
            for bq in fk.B2_ROWS:
                if plan.bq < bq <= most:
                    assert fk._b2_tf32_smem_bytes(bq, d, k,
                                                  store) > fk.SMEM_LIMIT


def test_plan_at_the_main_path():
    """64-row cells, d 128 on the f32 tier, k 1, 10 and 16 (each selection
    path that shares an SM): one CTA per cell, and two CTAs share an SM
    (233,472 bytes of shared memory, 1 KB reserved per block), on f32 and
    bf16 stores."""
    for store in ("f32", "bf16"):
        for k in (1, 10, 16):
            plan = fk._b2_tf32_plan(64, 128, k, store)
            assert plan.bq == 64
            assert 2 * (plan.smem + 1024) <= 233472


@pytest.mark.parametrize("args", [(64, 128, fk.MAX_K + 1, "f32"),
                                  (64, 128, 0, "f32"),
                                  (64, fk.MAX_DIM + 1, 10, "f32"),
                                  (0, 128, 10, "f32"),
                                  (64, 128, 10, "u8")])
def test_plan_rejects_what_the_kernel_cannot_take(args):
    """k past the queue or below 1, d past MAX_DIM, no rows, and an 8-bit
    store (the f32 tier reads f32 or bf16 rows)."""
    with pytest.raises(fk.LogicError):
        fk._b2_tf32_plan(*args)


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


# B2's bf16 tiers: the tensor-core scan of csrc/cells_mma.cu.
_MMA_KS = (1, 10, 16, 17, 128, 256)
_MMA_DIMS = (1, 8, 33, 128, 384, 385, 1024)
_MMA_QROWS = (8, 16, 64)
_STORES = ("bf16", "f32", "u8", "i8")


@pytest.mark.parametrize("store", _STORES)
@pytest.mark.parametrize("qsplit", [False, True])
@pytest.mark.parametrize("k", _MMA_KS)
def test_mma_plan_fits_shared_memory(k, qsplit, store):
    """Both bf16 tiers, every store: the most rows a CTA whose bytes fit,
    panels of 64 features (fewer when d is smaller), at every d up to
    1024."""
    for qrows in _MMA_QROWS:
        most = max(16, _r16(qrows))
        for d in _MMA_DIMS:
            plan = fk._b2_mma_plan(qrows, d, k, qsplit, store)
            assert plan.bq in fk.B2_ROWS and plan.bq <= most
            assert plan.pw == min(_r16(d), fk.B2_MMA_PW)
            assert plan.smem == fk._b2_mma_smem_bytes(plan.bq, d, plan.pw,
                                                      k, qsplit, store)
            assert plan.smem <= fk.SMEM_LIMIT and plan.smem % 16 == 0
            for bq in fk.B2_ROWS:
                if plan.bq < bq <= most:
                    assert fk._b2_mma_smem_bytes(
                        bq, d, plan.pw, k, qsplit, store) > fk.SMEM_LIMIT


def test_mma_plan_at_the_main_path():
    """64-row cells, d 128, k 10 and 1 on a bf16 or 8-bit store: 64 rows a
    CTA in two 64-feature panels a tile, and two CTAs share an SM
    (233,472 bytes of shared memory, 1 KB reserved per block) on both bf16
    tiers."""
    for store in ("bf16", "u8", "i8"):
        for qsplit in (False, True):
            for k in (1, 10):
                plan = fk._b2_mma_plan(64, 128, k, qsplit, store)
                assert (plan.bq, plan.pw) == (64, 64)
                assert 2 * (plan.smem + 1024) <= 233472


@pytest.mark.parametrize("store", _STORES)
@pytest.mark.parametrize("qsplit", [False, True])
def test_bf16_tiers_never_take_the_fma_scan(store, qsplit):
    """Every bf16-tier plan of B2, and of B3's tiers that run B2's scan, is
    the bf16 tensor-core scan's; the f32 tier never takes a bf16 scan: its
    plan, B2's and B3's, is the 3xTF32 scan's, and it takes no 8-bit
    store."""
    tier = "qsplit" if qsplit else "bf16"
    for k in _MMA_KS:
        for d in _MMA_DIMS:
            for qrows in _MMA_QROWS:
                plan = fk._b2_tier_plan(qrows, d, k, True, qsplit, store)
                assert isinstance(plan, fk.B2MmaPlan)
                assert fk._b3_plan(qrows, d, k, tier, store).path in (
                    "mma", "cells_mma")
                if store in ("f32", "bf16"):
                    assert isinstance(fk._b2_tier_plan(
                        qrows, d, k, False, False, store), fk.B2Tf32Plan)
                    assert fk._b3_plan(qrows, d, k, "f32",
                                       store).path == "cells_tf32"
                else:
                    with pytest.raises(fk.LogicError):
                        fk._b2_tier_plan(qrows, d, k, False, False, store)


@pytest.mark.parametrize("args", [(64, 128, fk.MAX_K + 1, True, "u8"),
                                  (64, 128, 0, True, "u8"),
                                  (64, fk.MAX_DIM + 1, 10, True, "u8"),
                                  (0, 128, 10, True, "u8"),
                                  (64, 128, 10, True, "u4")])
def test_mma_plan_rejects_what_the_kernel_cannot_take(args):
    with pytest.raises(fk.LogicError):
        fk._b2_mma_plan(*args)


@pytest.mark.parametrize("store", ["uint8", "int8"])
@pytest.mark.parametrize("qsplit", [False, True])
@pytest.mark.parametrize("k", [1, 10, 17])
@pytest.mark.parametrize("qrows", [8, 65])
def test_plain_8bit_store_matches_reference(rng, monkeypatch, store, qsplit,
                                            k, qrows):
    """A uint8 or int8 store on the bf16 tiers: the wrapper hands the plain
    version the 8-bit store itself, which it rounds to bf16 exactly; the
    reference's kernel (interpret mode) gets the same store cast to bf16.
    Full-range 8-bit rows and integer queries keep every gram and norm
    exact, so both agree bit for bit."""
    cell_list, q, _, invalid = _cells_case(rng, qrows)
    lo, hi = (0, 256) if store == "uint8" else (-128, 128)
    db = rng.integers(lo, hi, invalid.shape + (q.shape[2],)).astype(store)
    seen = []
    plain = fk._fused_cells_knn_plain

    def spy(*args):
        seen.append(args[2].dtype)
        return plain(*args)

    monkeypatch.setattr(fk, "_fused_cells_knn_plain", spy)
    d, i = fk.fused_cells_knn(t(cell_list), t(q), torch.as_tensor(db),
                              t(invalid), k, bf16=True, qsplit=qsplit)
    assert seen == [getattr(torch, store)]
    jd, ji = jfk.fused_cells_knn(cell_list, q,
                                 jnp.asarray(db).astype(jnp.bfloat16),
                                 invalid, k, bf16=True, qsplit=qsplit,
                                 interpret=True)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))


@pytest.mark.parametrize("source,entry,argtypes", [
    ("cells_tf32.cu", "fused_cells_tf32_launch", "_CELLS_TF32_ARGTYPES"),
    ("cells_mma.cu", "fused_cells_mma_launch", "_CELLS_MMA_ARGTYPES")])
def test_argtypes_follow_the_c_prototype(source, entry, argtypes):
    """Each B2 entry point's ctypes signature: a pointer for each pointer
    parameter and the stream, an int for each int."""
    text = (_build.CSRC_DIR / source).read_text()
    proto = re.search(r"int " + entry + r"\(([^)]*)\)", text)
    params = [p.strip() for p in proto.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert getattr(fk, argtypes) == want
