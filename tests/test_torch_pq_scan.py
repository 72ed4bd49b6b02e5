"""Parity of raft_tpu_torch.ops.pq_scan (kernel B4 and its helpers) with
the reference run in interpret mode.

On CPU tensors ``pq_fused_scan`` takes its plain version; the CUDA kernel
is held to the same plain version on the card
(``test_torch_kernels_cuda.py`` and ``chip_smoke.py``). The reference has
two selection epilogues (``fuse_select`` 0 and 1), bit-identical by design;
the port must equal both. Integer codebooks and queries keep every bf16
product and f32 sum exact, so ids and distances must agree bit for bit;
the int8 cases put a +-127 entry in every table row so the int8 tables
dequantize to the same integers. Gaussian data agrees to ``GAUSS_TOL``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.ops import pq_scan as jps
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.ops import pq_scan as ps
from test_torch_common import GAUSS_TOL, n, t


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("int8", [False, True])
def test_book_tables_equal_reference(rng, bits, int8):
    books = rng.standard_normal((6, 1 << bits, 3)).astype(np.float32)
    ours = ps.book_tables(t(books), bits, int8=int8)
    ref = jps.book_tables(jnp.asarray(books), bits, int8=int8)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.int8 or a.dtype == torch.float32
        np.testing.assert_array_equal(n(a), n(b))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("pq_dim", [2, 8])
def test_subspace_perm_and_permute_equal_reference(rng, bits, pq_dim):
    assert ps.subspace_perm(pq_dim, bits) == jps.subspace_perm(pq_dim, bits)
    x = rng.standard_normal((3, 5, pq_dim * 3)).astype(np.float32)
    np.testing.assert_array_equal(
        n(ps.permute_subspaces(t(x), pq_dim, bits)),
        n(jps.permute_subspaces(jnp.asarray(x), pq_dim, bits)))


def _case(rng, bits, integer=True, J=8, L=2, cap=700, qrows=10):
    """Codes of 5 lists (an empty one, a starved one), 6 cells (one -1)."""
    B = 1 << bits
    if integer:
        books = rng.integers(-3, 4, (J, B, L)).astype(np.float32)
        books[:, 0, :] = 127.0           # int8 scale exactly 1 per row
        books[:, B // 2, :] = -127.0
        q = rng.integers(-4, 5, (6, qrows, J * L)).astype(np.float32)
    else:
        books = rng.standard_normal((J, B, L)).astype(np.float32)
        q = rng.standard_normal((6, qrows, J * L)).astype(np.float32)
    codes = rng.integers(0, B, (5, cap, J)).astype(np.int32)
    packed = n(ivf_pq.pack_codes(t(codes), bits))
    codesT = np.ascontiguousarray(packed.transpose(0, 2, 1))
    invalid = rng.random((5, cap)) < 0.2
    invalid[1, :] = True
    invalid[3, 5:] = True
    cells = np.array([0, 1, -1, 3, 2, 4], np.int32)
    return books, cells, q, codesT, invalid


def _both(books, cells, q, codesT, invalid, k, bits, is_ip, int8,
          fuse_select):
    tt = ps.book_tables(t(books), bits, int8=int8)
    jt = jps.book_tables(jnp.asarray(books), bits, int8=int8)
    d, i = ps.pq_fused_scan(t(cells), t(q), t(codesT), tt[0], tt[1],
                            t(invalid), k, 8, bits, is_ip,
                            int8_lut=tt[2] if int8 else None)
    jd, ji = jps.pq_fused_scan(jnp.asarray(cells), jnp.asarray(q),
                               jnp.asarray(codesT), jt[0], jt[1],
                               jnp.asarray(invalid), k, 8, bits, is_ip,
                               True, int8_lut=jt[2] if int8 else None,
                               fuse_select=fuse_select)
    return d, i, jd, ji


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("is_ip", [False, True])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("fuse_select", [0, 1])
def test_integer_scan_bit_identical(rng, bits, is_ip, int8, fuse_select):
    case = _case(rng, bits)
    d, i, jd, ji = _both(*case, 10, bits, is_ip, int8, fuse_select)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))
    assert (n(i)[2] == -1).all() and np.isinf(n(d)[2]).all()   # -1 cell
    assert (n(i)[1] == -1).all()                               # empty list
    assert (n(i)[3, :, 5:] == -1).all()                        # starved


@pytest.mark.parametrize("k", [1, 32])
def test_k_one_and_wider_queue(rng, k):
    case = _case(rng, 8)
    for fuse in (0, 1):
        d, i, jd, ji = _both(*case, k, 8, False, False, fuse)
        np.testing.assert_array_equal(n(i), n(ji))
        np.testing.assert_array_equal(n(d), n(jd))


@pytest.mark.parametrize("is_ip", [False, True])
def test_gaussian_distances(rng, is_ip):
    case = _case(rng, 8, integer=False)
    d, i, jd, ji = _both(*case, 10, 8, is_ip, False, 1)
    np.testing.assert_allclose(n(d), n(jd), **GAUSS_TOL)
    assert np.mean(n(i) == n(ji)) > 0.99


def test_wrapper_pads_capacity_and_rows(rng):
    """A capacity off the 512 granule and qrows off 8 are padded invalid
    and sliced back, as the reference does."""
    books, cells, q, codesT, invalid = _case(rng, 8, cap=300, qrows=5)
    d, i, jd, ji = _both(books, cells, q, codesT, invalid, 10, 8, False,
                         False, 0)
    assert d.shape == (6, 5, 10)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))


@pytest.mark.parametrize("bits", [4, 5, 7, 8])
def test_pack_unpack_equal_reference(rng, bits):
    codes = rng.integers(0, 1 << bits, (9, 13)).astype(np.int32)
    packed = ivf_pq.pack_codes(t(codes), bits)
    np.testing.assert_array_equal(n(packed),
                                  n(jpq.pack_codes(jnp.asarray(codes), bits)))
    np.testing.assert_array_equal(
        n(ivf_pq.unpack_codes(packed, 13, bits)),
        n(jpq.unpack_codes(jnp.asarray(n(packed)), 13, bits)))
    np.testing.assert_array_equal(n(ivf_pq.unpack_codes(packed, 13, bits)),
                                  codes)


def test_wrapper_rejects_other_devices():
    m = dict(device="meta")
    with pytest.raises(ps.CudaError):
        ps.pq_fused_scan(torch.zeros(2, dtype=torch.int32, **m),
                         torch.zeros((2, 8, 16), **m),
                         torch.zeros((2, 8, 512), dtype=torch.uint8, **m),
                         torch.zeros((1, 16, 128), **m),
                         torch.zeros((1, 16, 128), **m),
                         torch.zeros((2, 512), dtype=torch.bool, **m),
                         4, 8, 8, False)


def _geometries():
    """(rot, pq_dim) from rot 16 to 1024 with L = 1, 2, 3, 4."""
    for rot in (16, 32, 48, 96, 128, 256, 384, 512, 1024):
        for L in (1, 2, 3, 4):
            if rot % L == 0 and (rot // L) % 2 == 0:
                yield rot, rot // L


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("k", [1, 2, 10, 16, 17, 32, 33, 64, 65, 128, 129,
                               256])
def test_b4_plan_fits_every_shape(bits, k):
    """Every (qrows 1-64, rot 16-1024, pq_bits, k) gets a plan within the
    H100's 232,448 bytes of shared memory: the resident table whenever it
    fits at some row count, else the sliced one."""
    for rot, pq_dim in _geometries():
        nbytes = pq_dim if bits == 8 else pq_dim // 2
        kp = -(-rot // 16) * 16
        for qrows in (1, 8, 16, 17, 40, 64):
            plan = ps._b4_plan(qrows, rot, pq_dim, bits, k)
            assert plan.smem <= ps.SMEM_LIMIT
            assert plan.kp == kp and plan.bq in ps.B4_ROWS
            assert plan.bq <= max(16, -(-qrows // 16) * 16)
            assert plan.smem == ps._b4_smem_bytes(
                plan.bq, kp, plan.ks, bits, nbytes, k, plan.sliced)
            resident = [bq for bq in ps.B4_ROWS if bq <= max(
                16, min(64, -(-qrows // 16) * 16)) and ps._b4_smem_bytes(
                    bq, kp, kp, bits, nbytes, k, False) <= ps.SMEM_LIMIT]
            assert plan.sliced == (not resident)
            if plan.sliced:
                assert plan.ks % 16 == 0 and plan.ks < kp
            else:
                assert plan.ks == kp and plan.bq == max(resident)


@pytest.mark.parametrize("qrows,rot,pq_dim,bits,k,bq,sliced", [
    (64, 128, 64, 8, 10, 64, False),    # the IVF-PQ main path
    (64, 128, 64, 8, 64, 32, False),    # the queue takes the room
    (64, 128, 64, 8, 256, 16, False),
    (8, 128, 64, 8, 10, 16, False),     # few rows
    (64, 512, 256, 8, 10, 64, True),    # the table does not fit
    (64, 1024, 1024, 4, 256, 32, True),  # nor do the code tiles
])
def test_b4_plan_main_cases(qrows, rot, pq_dim, bits, k, bq, sliced):
    plan = ps._b4_plan(qrows, rot, pq_dim, bits, k)
    assert (plan.bq, plan.sliced) == (bq, sliced)
