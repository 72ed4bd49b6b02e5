"""raft_tpu_torch._native, the port's loader of native/host_runtime.cpp,
against raft_tpu._native.

Mirrors tests/test_native.py. The port's library is held to the NumPy
versions beside its wrappers and to the reference's wrappers: file
round trips byte for byte and bit for bit against the reference's
library, refine / merge / select within rtol 1e-5 with equal ids, the
agglomeration bit for bit. It builds into the port's build directory,
and a failed build raises instead of falling back.
"""

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import pytest

from raft_tpu import _native as jn
from raft_tpu.neighbors.refine import refine_host as j_refine_host
from raft_tpu_torch import _native as tn
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.neighbors.refine import refine_host
from raft_tpu_torch.ops import _build
from test_torch_common import t

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref_lib(tmp_path_factory):
    """The reference's wrappers over its library, built by its own
    Makefile into a private path (so no other test process sees a
    half-written library at the reference's fixed path). Its wrappers
    fall back to NumPy without a library, which would make the
    byte-for-byte checks vacuous, so the library is installed first."""
    out = tmp_path_factory.mktemp("ref_native") / "libraft_tpu_host.so"
    subprocess.run(["make", "-s", "-C", str(ROOT / "native"), f"OUT={out}"],
                   check=True, capture_output=True, timeout=300)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jn, "_lib", jn._configure(ctypes.CDLL(str(out))))
        mp.setattr(jn, "_tried", True)
        yield jn


def test_library_builds_into_the_build_directory():
    tn.get_lib()
    command, srcs, headers = tn._job()
    path = _build.library_path(tn.LIBRARY, command, headers + srcs)
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert path.name.startswith("libraft_host-") and path.suffix == ".so"
    assert tn.get_lib().raft_native_version() == 1


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "host_runtime.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tn, "SOURCE", bad)
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(tn.NativeBuildError, match="error"):
        tn.get_lib()
    with pytest.raises(tn.NativeBuildError):
        tn.read_fvecs(str(tmp_path / "x.fvecs"))
    assert list((tmp_path / "build").iterdir()) == []


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tn, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(tn.NativeBuildError, match="cannot run"):
        tn.get_lib()


# -- vecs I/O -------------------------------------------------------------


@pytest.mark.parametrize("rows,cols", [(37, 16), (1, 1), (5, 129)])
def test_fvecs_round_trip_against_the_reference(rng, tmp_path, ref_lib,
                                                rows, cols):
    data = rng.normal(size=(rows, cols)).astype(np.float32)
    mine, ref = str(tmp_path / "p.fvecs"), str(tmp_path / "r.fvecs")
    tn.write_fvecs(mine, data)
    ref_lib.write_fvecs(ref, data)
    assert open(mine, "rb").read() == open(ref, "rb").read()
    for path in (mine, ref):
        got = tn.read_fvecs(path)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, data)
        np.testing.assert_array_equal(got, ref_lib.read_fvecs(path))
        np.testing.assert_array_equal(got,
                                      tn._read_vecs_numpy(path, np.float32))


def test_bvecs_round_trip_against_the_reference(rng, tmp_path, ref_lib):
    data = rng.integers(0, 256, size=(10, 8)).astype(np.uint8)
    mine, ref = str(tmp_path / "p.bvecs"), str(tmp_path / "r.bvecs")
    tn.write_bvecs(mine, data)
    ref_lib.write_bvecs(ref, data)
    assert open(mine, "rb").read() == open(ref, "rb").read()
    got = tn.read_bvecs(mine)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(got, ref_lib.read_bvecs(mine))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_sift_shaped_bvecs_across_the_packages(tmp_path, ref_lib, writer):
    """SIFT-shaped u8 rows (bench.py's recipe, 128 wide) written by one
    package read back byte for byte by the other."""
    from test_torch_configs import sift_u8

    data, _ = sift_u8(np.random.default_rng(11), 500, 1, dim=128)
    path = str(tmp_path / "sift.bvecs")
    write, read = ((tn.write_bvecs, ref_lib.read_bvecs) if writer == "port"
                   else (ref_lib.write_bvecs, tn.read_bvecs))
    write(path, data)
    got = read(path)
    assert got.dtype == np.uint8 and got.shape == data.shape
    np.testing.assert_array_equal(got, data)


def test_ivecs_read_against_the_reference(rng, tmp_path, ref_lib):
    data = rng.integers(-1000, 1000, size=(5, 4)).astype(np.int32)
    path = str(tmp_path / "x.ivecs")
    tn._write_vecs_numpy(path, data)
    got = tn.read_ivecs(path)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(got, ref_lib.read_ivecs(path))


def test_write_matches_the_plain_writer(rng, tmp_path):
    data = rng.normal(size=(6, 3)).astype(np.float32)
    a, b = str(tmp_path / "a.fvecs"), str(tmp_path / "b.fvecs")
    tn.write_fvecs(a, data)
    tn._write_vecs_numpy(b, data)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_missing_file_raises():
    with pytest.raises(IOError):
        tn.read_fvecs("/nonexistent/file.fvecs")


# -- host refine, merge, select -------------------------------------------


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_refine_host_against_plain_and_reference(rng, ref_lib, metric):
    ds = rng.normal(size=(200, 12)).astype(np.float32)
    q = rng.normal(size=(16, 12)).astype(np.float32)
    cand = rng.integers(0, 200, size=(16, 20)).astype(np.int64)
    cand[0, 5:] = -1
    cand[1, 3] = 500                       # past the dataset: skipped
    d, i = tn.refine_host(ds, q, cand, 8, metric=metric)
    assert d.dtype == np.float32 and i.dtype == np.int64
    mcode = {"sqeuclidean": 0, "inner_product": 1}[metric]
    pd, pi = tn._refine_numpy(ds, q, cand, 8, mcode)
    rd, ri = ref_lib.refine_host(ds, q, cand, 8, metric=metric)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(d, rd)
    np.testing.assert_allclose(d, pd, rtol=1e-5, atol=1e-5)
    fin = np.isfinite(pd)
    np.testing.assert_array_equal(i[fin], pi[fin])


@pytest.mark.parametrize("select_min", [True, False])
def test_knn_merge_parts_against_plain_and_reference(rng, ref_lib,
                                                     select_min):
    p, nq, k = 4, 9, 6
    d = np.sort(rng.normal(size=(p, nq, k)).astype(np.float32), axis=2)
    if not select_min:
        d = d[:, :, ::-1].copy()
    ids = rng.integers(0, 100, size=(p, nq, k)).astype(np.int64)
    trans = np.array([0, 100, 200, 300], np.int64)
    got_d, got_i = tn.knn_merge_parts(d, ids, select_min, trans)
    want_d, want_i = tn._merge_numpy(d, ids, select_min, trans)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-6)
    np.testing.assert_array_equal(got_i, want_i)
    ref_d, ref_i = ref_lib.knn_merge_parts(d, ids, select_min, trans)
    np.testing.assert_array_equal(got_d, ref_d)
    np.testing.assert_array_equal(got_i, ref_i)
    with pytest.raises(ValueError):
        tn.knn_merge_parts(d[:0], ids[:0])


@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_host_against_plain_and_reference(rng, ref_lib, select_min):
    x = rng.normal(size=(32, 500)).astype(np.float32)
    got_v, got_i = tn.select_k_host(x, 10, select_min)
    want_v, _ = tn._select_k_numpy(x, 10, select_min)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-6)
    np.testing.assert_array_equal(np.take_along_axis(x, got_i, axis=1),
                                  got_v)
    ref_v, ref_i = ref_lib.select_k_host(x, 10, select_min)
    np.testing.assert_array_equal(got_v, ref_v)
    np.testing.assert_array_equal(got_i, ref_i)
    with pytest.raises(ValueError):
        tn.select_k_host(x[:, :5], 6)


def test_dendrogram_host_bit_for_bit_with_the_reference(rng, ref_lib):
    n = 500
    src = np.arange(1, n, dtype=np.int32)
    dst = rng.integers(0, np.maximum(src, 1)).astype(np.int32)
    w = rng.random(n - 1).astype(np.float32)
    got = tn.dendrogram_host(src, dst, w, n, 7)
    want = ref_lib.dendrogram_host(src, dst, w, n, 7)
    assert want is not None
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -- neighbors.refine.refine_host -----------------------------------------


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean"])
def test_neighbors_refine_host_equals_reference(rng, ref_lib, metric):
    ds = rng.normal(size=(300, 16)).astype(np.float32)
    q = rng.normal(size=(20, 16)).astype(np.float32)
    cand = np.stack([rng.permutation(300)[:40] for _ in range(20)]).astype(
        np.int64)
    d, i = refine_host(ds, q, cand, 10, metric=metric)
    rd, ri = j_refine_host(ds, q, cand, 10, metric=metric)
    assert isinstance(d, np.ndarray) and isinstance(i, np.ndarray)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(d, rd, rtol=1e-5)
    # Tensors (CPU here) are copied to the host first.
    d2, i2 = refine_host(t(ds), t(q), t(cand), 10, metric=metric)
    np.testing.assert_array_equal(i2, i)
    np.testing.assert_array_equal(d2, d)


def test_neighbors_refine_host_refuses_non_l2(rng):
    ds = rng.normal(size=(10, 4)).astype(np.float32)
    with pytest.raises(LogicError):
        refine_host(ds, ds[:2], np.zeros((2, 3), np.int64), 2,
                    metric="inner_product")
