"""B3's launch plan and its plain version with live rows, on the CPU.

``_b3_plan`` picks B3's path (the bf16 tensor-core scan of
``csrc/batch_knn.cu``, or B2's scan of the tier with the identity cell
map: its bf16 tensor-core scan for the bf16 tiers, its 3xTF32 one for
the f32 tier), the query rows one CUDA CTA takes and the bytes of shared
memory it needs; the C entry points refuse a launch whose count differs from their own layout,
so the plan is held here to its contract over the shapes the wrapper
accepts. The plain version, which the card kernel is held to, takes the
bucket engines' ``live_rows``: on the live rows it must equal the
reference Pallas kernel in interpret mode bit for bit (integer data), and
past them give (inf, -1).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import int_data, n, t

fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")

jfk = importlib.import_module("raft_tpu.ops.fused_knn")

_MS = (1, 8, 15, 16, 17, 31, 32, 33, 37, 63, 64, 65, 100, 128, 200, 256)
_DIMS = (16, 33, 48, 100, 128, 256, 384, 512, 1024)
_KS = (1, 2, 10, 16, 17, 32, 64, 65, 100, 128, 129, 200, 255, 256)
_TIERS = [("f32", "f32"), ("bf16", "f32"), ("qsplit", "f32"),
          ("bf16", "bf16"), ("qsplit", "bf16"), ("f32", "bf16"),
          ("qsplit", "u8"), ("qsplit", "i8"), ("bf16", "u8")]


def _r16(x):
    return -(-x // 16) * 16


@pytest.mark.parametrize("tier,store", _TIERS)
@pytest.mark.parametrize("k", _KS)
def test_plan_fits_shared_memory(k, tier, store):
    for m in _MS:
        most = max(16, _r16(m))
        for d in _DIMS:
            plan = fk._b3_plan(m, d, k, tier, store)
            assert plan.smem <= fk.SMEM_LIMIT and plan.smem % 16 == 0
            assert plan.bq <= most
            if plan.path == "cells_tf32":
                # B2's f32 tier: its plan, as B2's own wrapper makes it.
                assert tier == "f32"
                assert (plan.bq, plan.smem) == tuple(
                    fk._b2_tf32_plan(m, d, k, store))
                continue
            if plan.path == "cells_mma":
                # B2's bf16 tiers: the tensor-core scan's plan, as B2's
                # own wrapper makes it; never the f32 tier's scan.
                assert tier in ("bf16", "qsplit")
                assert (plan.bq, plan.pw, plan.smem) == tuple(
                    fk._b2_mma_plan(m, d, k, tier == "qsplit", store))
                if tier == "bf16" and store == "bf16":
                    # Only when no tile of B3's own scan fits.
                    assert all(fk._b3_smem_bytes(bq, _r16(d), k)
                               > fk.SMEM_LIMIT
                               for bq in fk.B3_ROWS if bq <= most)
                continue
            assert plan.path == "mma" and (tier, store) == ("bf16", "bf16")
            assert plan.bq in fk.B3_ROWS
            assert plan.smem == fk._b3_smem_bytes(plan.bq, _r16(d), k)
            # The most rows a CTA may take whose bytes fit.
            for bq in fk.B3_ROWS:
                if plan.bq < bq <= most:
                    assert fk._b3_smem_bytes(bq, _r16(d), k) > fk.SMEM_LIMIT


def test_plan_at_the_main_path():
    """The recon tier and the decode scan: 256-slot buckets, d 128, bf16
    rows, k 10 (and 1): the tensor-core scan, 64 rows a CTA; d 1024 does
    not fit two resident row tiles and runs B2's tensor-core scan, as do
    the split query and the u8 rows of the IVF-Flat bucket engine."""
    for k in (1, 10):
        plan = fk._b3_plan(256, 128, k, "bf16", "bf16")
        assert (plan.path, plan.bq) == ("mma", 64)
    assert fk._b3_plan(256, 1024, 10, "bf16", "bf16").path == "cells_mma"
    assert fk._b3_plan(256, 128, 10, "qsplit", "u8").path == "cells_mma"
    assert fk._b3_plan(256, 128, 10, "f32", "f32").path == "cells_tf32"


@pytest.mark.parametrize("args", [(64, 128, fk.MAX_K + 1, "bf16", "bf16"),
                                  (64, 128, 0, "bf16", "bf16"),
                                  (0, 128, 10, "bf16", "bf16"),
                                  (64, 128, 10, "fp8", "bf16"),
                                  (64, 128, 10, "bf16", "int8")])
def test_plan_rejects_what_the_kernels_cannot_take(args):
    with pytest.raises(fk.LogicError):
        fk._b3_plan(*args)


def _slabs(rng, m, hi=8, B=5, nn=300, d=24):
    """Integer slabs: n off the 128-slot tile, an empty slab (1), a starved
    one (2: 3 valid slots), a whole tile of tombstones (4)."""
    q = int_data(rng, (B, m, d), hi)
    db = int_data(rng, (B, nn, d), hi)
    invalid = rng.random((B, nn)) < 0.3
    invalid[1, :] = True
    invalid[2, 3:] = True
    invalid[4, 128:256] = True
    return q, db, invalid


def _live(m):
    """Per element: none, one, a middle count, all and past all."""
    return np.array([0, 1, m // 2, m, m + 3], np.int32)


_REF = [("l2", False, False, 1), ("l2", False, False, 10),
        ("ip", False, False, 17), ("l2", True, False, 10),
        ("ip", True, False, 10), ("l2", True, True, 16)]


@pytest.mark.parametrize("m", [9, 37])
@pytest.mark.parametrize("metric,bf16,qsplit,k", _REF)
@pytest.mark.parametrize("hi", [2, 8])
def test_plain_with_live_rows_matches_reference(rng, m, metric, bf16,
                                                qsplit, k, hi):
    q, db, invalid = _slabs(rng, m, hi)
    if qsplit:
        q = q + 0.25                     # a query bf16 cannot hold
    live = _live(m)
    dbt, dbj = t(db), jnp.asarray(db)
    if bf16:
        dbt, dbj = dbt.to(torch.bfloat16), dbj.astype(jnp.bfloat16)
    d, i = fk.fused_batch_knn(t(q), dbt, t(invalid), k, metric=metric,
                              bf16=bf16, qsplit=qsplit, live_rows=t(live))
    jd, ji = jfk.fused_batch_knn(q, dbj, invalid, k, metric=metric,
                                 bf16=bf16, qsplit=qsplit, bd=128,
                                 interpret=True)
    d, i, jd, ji = n(d), n(i), n(jd), n(ji)
    worst = np.inf if metric == "l2" else -np.inf
    for b, rows in enumerate(live):
        rows = min(rows, m)
        np.testing.assert_array_equal(i[b, :rows], ji[b, :rows])
        np.testing.assert_array_equal(d[b, :rows], jd[b, :rows])
        assert (i[b, rows:] == -1).all() and (d[b, rows:] == worst).all()


@pytest.mark.parametrize("bf16", [False, True])
def test_live_rows_of_all_rows_is_the_full_scan(rng, bf16):
    """live_rows >= m everywhere gives exactly the result without it."""
    q, db, invalid = _slabs(rng, 20)
    dbt = t(db).to(torch.bfloat16) if bf16 else t(db)
    full = fk.fused_batch_knn(t(q), dbt, t(invalid), 10, bf16=bf16)
    live = torch.full((5,), 20, dtype=torch.int32)
    part = fk.fused_batch_knn(t(q), dbt, t(invalid), 10, bf16=bf16,
                              live_rows=live)
    for a, b in zip(full, part):
        assert torch.equal(a, b)
