"""Parity of pylibraft_torch (the pylibraft surface over the port) with
pylibraft.

Mirrors tests/test_pylibraft_api.py case by case, at its sizes: the same
numpy inputs, made from a seed, go through ``pylibraft.X`` (JAX on the
CPU) and ``pylibraft_torch.X`` with ``handle=DeviceResources(device=
"cpu")``. Tolerances:

* ids are bit-identical, ties to the lowest id (integer-valued data makes
  real ties);
* distances: pairwise distances within the JAX test's bar against scipy
  (rtol 2e-4, atol 2e-4) and within ``GAUSS_TOL`` (rtol 1e-5, atol 1e-4)
  of the JAX facade's; kNN, refine and IVF distances within
  ``GAUSS_TOL`` of the JAX facade's (the packages sum in other orders);
  k-means centroids within rtol 1e-5 / atol 1e-5, inertia and cluster
  cost within rtol 1e-5;
* the approximate indexes meet the JAX test's recall bars;
* seeded draws (``init_plus_plus``, ``rmat``, ``fit`` from k-means++) are
  held to their laws: the port draws from ``torch.Generator``, the
  reference from ``jax.random``.
"""

import jax
import numpy as np
import pytest
import torch
from scipy.spatial.distance import cdist

import pylibraft
import pylibraft_torch as plt_
from pylibraft.cluster import kmeans as jkm
from pylibraft.common import device_ndarray as jdnd
from pylibraft.distance import fused_l2_nn_argmin as jargmin
from pylibraft.distance import pairwise_distance as jpairwise
from pylibraft.neighbors import brute_force as jbf
from pylibraft.neighbors import ivf_flat as jflat
from pylibraft.neighbors import ivf_pq as jpq
from pylibraft.neighbors import refine as jrefine
from pylibraft.random import rmat as jrmat
from pylibraft_torch.cluster import kmeans as tkm
from pylibraft_torch.common import (
    DeviceResources,
    Handle,
    Stream,
    cai_wrapper,
    cuda_interruptible,
    device_ndarray,
    set_output_as,
    synchronize,
)
from pylibraft_torch.common.input_validation import (
    is_c_contiguous,
    is_f_contiguous,
)
from pylibraft_torch.common.interruptible import (
    Interruptible,
    InterruptedException,
)
from pylibraft_torch.distance import fused_l2_nn_argmin as targmin
from pylibraft_torch.distance import pairwise_distance as tpairwise
from pylibraft_torch.neighbors import brute_force as tbf
from pylibraft_torch.neighbors import ivf_flat as tflat
from pylibraft_torch.neighbors import ivf_pq as tpq
from pylibraft_torch.neighbors import refine as trefine
from pylibraft_torch.random import rmat as trmat
from raft_tpu_torch.core.error import CudaError
from test_torch_common import GAUSS_TOL, int_data

CPU = dict(handle=DeviceResources(device="cpu"))
SCIPY_TOL = dict(rtol=2e-4, atol=2e-4)
KM_TOL = dict(rtol=1e-5, atol=1e-5)


def _n(x) -> np.ndarray:
    return np.asarray(x)


def _recall(found, truth):
    hits = sum(
        len(np.intersect1d(found[r], truth[r])) for r in range(truth.shape[0])
    )
    return hits / truth.size


def _truth(q, db, k):
    return np.argsort(cdist(q, db, "sqeuclidean"), axis=1, kind="stable")[:, :k]


class TestCommon:
    def test_device_ndarray_roundtrip(self, rng):
        host = rng.normal(size=(5, 4)).astype(np.float32)
        ref = jdnd(host)
        dev = device_ndarray(host, device="cpu")
        assert dev.shape == ref.shape == (5, 4)
        assert dev.dtype == ref.dtype == np.float32
        assert dev.c_contiguous and not dev.f_contiguous
        assert dev.ndim == 2 and dev.size == 20 and len(dev) == 5
        np.testing.assert_array_equal(dev.copy_to_host(), host)
        np.testing.assert_array_equal(np.asarray(dev), ref.copy_to_host())
        row = dev[1]
        assert isinstance(row, device_ndarray)
        np.testing.assert_array_equal(row.copy_to_host(), host[1])
        # from_torch wraps with no copy; .array is the tensor itself.
        t = torch.arange(6.0).reshape(2, 3)
        wrapped = device_ndarray.from_torch(t)
        assert wrapped.array is t
        assert device_ndarray.from_torch(t.t()).f_contiguous

    def test_device_ndarray_factories(self):
        z = device_ndarray.zeros((3, 2), device="cpu")
        assert z.copy_to_host().sum() == jdnd.zeros((3, 2)).copy_to_host().sum()
        o = device_ndarray.ones((3, 2), dtype=np.int32, device="cpu")
        assert o.copy_to_host().sum() == 6 and o.dtype == np.int32
        e = device_ndarray.empty((4,), dtype="float16", device="cpu")
        assert e.shape == (4,) and e.dtype == np.float16

    def test_bfloat16_comes_home_as_float32(self):
        """numpy has no bfloat16: the host copy is float32, exactly."""
        vals = [1.5, -2.25, 3.0e38, 2.0 ** -130]
        b = device_ndarray.from_torch(torch.tensor(vals, dtype=torch.bfloat16))
        host = b.copy_to_host()
        assert b.dtype == host.dtype == np.float32
        want = torch.tensor(vals, dtype=torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(host, want)
        np.testing.assert_array_equal(np.asarray(b), want)
        assert cai_wrapper(b).dtype == np.float32

    def test_handle_sync(self):
        h = DeviceResources(device="cpu", seed=3)
        h.sync()  # nothing to wait for on the CPU
        assert Handle is DeviceResources
        assert h.getHandle() is h and h.device.type == "cpu"
        pylibraft.common.DeviceResources().sync()

    @pytest.mark.parametrize("form,streams", [
        (lambda m: m.Handle(), 0), (lambda m: m.Handle(2), 2),
        (lambda m: m.DeviceResources(n_streams=2), 2)])
    def test_handle_takes_n_streams_first(self, monkeypatch, form, streams):
        """The reference's ``Handle()``, ``Handle(n_streams)`` and
        ``DeviceResources(n_streams=)`` build in both packages. The port
        keeps the count and names ``cuda``, its default device; a card is
        stood in for, as building a handle touches none."""
        form(pylibraft.common)
        with pytest.raises(CudaError):
            form(plt_.common)  # no card, and no silent CPU
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        h = form(plt_.common)
        assert h.device == torch.device("cuda")
        assert h.n_streams == streams and "generator" not in h._slots

    def test_handle_n_streams_then_device_and_seed(self):
        """``DeviceResources(n_streams=2, device="cpu", seed=3)``: the
        port's ``device`` and ``seed`` follow ``n_streams``. The
        reference's handle takes ``n_streams`` alone."""
        pylibraft.common.DeviceResources(n_streams=2).sync()
        h = DeviceResources(n_streams=2, device="cpu", seed=3)
        assert h.n_streams == 2 and h.device == torch.device("cpu")
        same = DeviceResources(device="cpu", seed=3)
        assert torch.equal(torch.randn(8, generator=h.generator),
                           torch.randn(8, generator=same.generator))
        assert Handle(0, "cpu").device == torch.device("cpu")

    def test_output_as_array(self, rng):
        x = rng.normal(size=(4, 3)).astype(np.float32)
        try:
            set_output_as("array")
            pylibraft.common.set_output_as("array")
            out = tpairwise(x, x, metric="euclidean", **CPU)
            ref = jpairwise(x, x, metric="euclidean")
            assert isinstance(out, torch.Tensor)
            assert isinstance(ref, jax.Array)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       **GAUSS_TOL)
            set_output_as(lambda t: t.numpy() * 2)
            doubled = tpairwise(x, x, metric="euclidean", **CPU)
            np.testing.assert_allclose(doubled, 2 * out.numpy())
        finally:
            set_output_as("device_ndarray")
            pylibraft.common.set_output_as("device_ndarray")
        assert isinstance(tpairwise(x, x, **CPU), device_ndarray)

    def test_tensors_stay_and_host_input_moves_to_the_handle(self, rng):
        x = rng.normal(size=(6, 3)).astype(np.float32)
        t = torch.as_tensor(x)
        assert cai_wrapper(t, **CPU).array is t
        d = device_ndarray.from_torch(t)
        assert cai_wrapper(d, **CPU).array is t
        assert cai_wrapper(x, **CPU).array.device.type == "cpu"
        with pytest.raises(ValueError, match="more than one device"):
            tpairwise(t, torch.empty((2, 3), device="meta"), **CPU)

    def test_input_validation(self):
        x = np.zeros((3, 4), np.float32)
        t = torch.zeros((3, 4))
        assert is_c_contiguous(x) and is_c_contiguous(t)
        assert not is_f_contiguous(t) and is_f_contiguous(t.t())
        assert is_f_contiguous(np.asfortranarray(x))
        assert not is_c_contiguous(t.t())


class TestNoHiddenDevice:
    def test_host_input_without_a_handle_needs_the_card(self, rng):
        if torch.cuda.is_available():
            pytest.skip("this machine has a card: nothing to refuse")
        x = rng.normal(size=(20, 4)).astype(np.float32)
        for call in (lambda: tbf.knn(x, x, k=2),
                     lambda: tpairwise(x, x),
                     lambda: targmin(x, x),
                     lambda: tflat.build(tflat.IndexParams(n_lists=2), x),
                     lambda: tpq.build(tpq.IndexParams(n_lists=2, pq_dim=2),
                                       x),
                     lambda: tkm.fit(tkm.KMeansParams(n_clusters=2), x),
                     lambda: tkm.cluster_cost(x, x[:2]),
                     lambda: trmat(np.zeros((4, 2), np.int32),
                                   np.full(4, 0.25, np.float32), 2, 2),
                     lambda: device_ndarray(x),
                     lambda: device_ndarray.zeros((2,)),
                     lambda: DeviceResources(),
                     lambda: Stream()):
            with pytest.raises(CudaError):
                call()


class TestDistance:
    @pytest.mark.parametrize("metric", [
        "euclidean", "sqeuclidean", "cityblock", "chebyshev", "canberra",
        "cosine", "braycurtis",
    ])
    def test_distance_matches_scipy(self, rng, metric):
        x = np.abs(rng.normal(size=(30, 8))).astype(np.float32)
        y = np.abs(rng.normal(size=(20, 8))).astype(np.float32)
        got = _n(tpairwise(x, y, metric=metric, **CPU))
        want = cdist(x.astype(np.float64), y.astype(np.float64), metric)
        np.testing.assert_allclose(got, want, **SCIPY_TOL)
        ref = _n(jpairwise(x, y, metric=metric))
        np.testing.assert_allclose(got, ref, **GAUSS_TOL)

    def test_distance_out_param(self, rng):
        x = rng.normal(size=(10, 4)).astype(np.float32)
        out = np.zeros((10, 10), np.float32)
        ret = tpairwise(x, x, out=out, metric="euclidean", **CPU)
        assert ret is out
        ref = np.zeros((10, 10), np.float32)
        jpairwise(x, x, out=ref, metric="euclidean")
        np.testing.assert_allclose(out, ref, **GAUSS_TOL)
        dev_out = device_ndarray.zeros((10, 10), device="cpu")
        buf = dev_out.array
        assert tpairwise(x, x, out=dev_out, metric="euclidean",
                         **CPU) is dev_out
        assert dev_out.array is buf  # written in place
        np.testing.assert_array_equal(dev_out.copy_to_host(), out)

    def test_unsupported_metric_raises(self, rng):
        x = rng.normal(size=(4, 3)).astype(np.float32)
        with pytest.raises(ValueError):
            tpairwise(x, x, metric="not_a_metric", **CPU)
        with pytest.raises(ValueError):
            jpairwise(x, x, metric="not_a_metric")

    @pytest.mark.parametrize("data", ["gauss", "int"])
    def test_fused_l2_nn_argmin(self, rng, data):
        if data == "gauss":
            x = rng.normal(size=(50, 6)).astype(np.float32)
            y = rng.normal(size=(12, 6)).astype(np.float32)
        else:
            x, y = int_data(rng, (50, 6), 3), int_data(rng, (12, 6), 3)
        got = _n(targmin(x, y, sqrt=True, **CPU))
        np.testing.assert_array_equal(got, _n(jargmin(x, y, sqrt=True)))
        np.testing.assert_array_equal(got, cdist(x, y).argmin(axis=1))
        out = np.full(50, -1, np.int64)
        assert targmin(x, y, out=out, **CPU) is out
        np.testing.assert_array_equal(out, got)


class TestBruteForce:
    @pytest.mark.parametrize("data", ["gauss", "int"])
    def test_knn(self, rng, data):
        if data == "gauss":
            db = rng.normal(size=(200, 16)).astype(np.float32)
            q = rng.normal(size=(32, 16)).astype(np.float32)
        else:
            db, q = int_data(rng, (200, 16), 2), int_data(rng, (32, 16), 2)
        d, i = tbf.knn(db, q, k=5, **CPU)
        d, i = _n(d), _n(i)
        rd, ri = jbf.knn(db, q, k=5)
        np.testing.assert_array_equal(i, _n(ri))
        np.testing.assert_allclose(d, _n(rd), **GAUSS_TOL)
        assert _recall(i, _truth(q, db, 5)) == 1.0
        assert np.all(np.diff(d, axis=1) >= 0)
        assert i.dtype == np.int32

    def test_knn_k_from_indices(self, rng):
        db = rng.normal(size=(50, 8)).astype(np.float32)
        q = rng.normal(size=(4, 8)).astype(np.float32)
        idx = np.zeros((4, 3), np.int64)
        dist = np.zeros((4, 3), np.float32)
        tbf.knn(db, q, indices=idx, distances=dist, **CPU)
        ref_idx = np.zeros((4, 3), np.int64)
        jbf.knn(db, q, indices=ref_idx, distances=np.zeros((4, 3),
                                                           np.float32))
        np.testing.assert_array_equal(idx, ref_idx)
        assert dist.max() > 0
        with pytest.raises(ValueError, match="deducible"):
            tbf.knn(db, q, **CPU)

    def test_idx_dtype_int64_widens_the_int32_ids(self, rng):
        db = rng.normal(size=(300, 8)).astype(np.float32)
        q = rng.normal(size=(20, 8)).astype(np.float32)
        d32, i32 = tbf.knn(db, q, k=7, global_id_offset=5, **CPU)
        d64, i64 = tbf.knn(db, q, k=7, global_id_offset=5,
                           idx_dtype="int64", **CPU)
        assert i64.dtype == np.int64 and i32.dtype == np.int32
        np.testing.assert_array_equal(_n(i64), _n(i32).astype(np.int64))
        np.testing.assert_array_equal(_n(d64), _n(d32))


class TestIvfFlat:
    def test_build_search_recall(self, rng):
        db = rng.normal(size=(1000, 16)).astype(np.float32)
        q = rng.normal(size=(50, 16)).astype(np.float32)
        params = tflat.IndexParams(n_lists=16, metric="sqeuclidean")
        index = tflat.build(params, db, **CPU)
        assert index.trained
        assert index.size == 1000
        assert index.dim == 16
        assert index.n_lists == 16
        assert index.metric == params.metric == "sqeuclidean"
        d, n = tflat.search(tflat.SearchParams(n_probes=16), index, q, 10,
                            **CPU)
        assert _recall(_n(n), _truth(q, db, 10)) > 0.99  # all lists probed
        # Every list probed: both packages search exactly.
        ref = jflat.build(jflat.IndexParams(n_lists=16), db)
        rd, rn = jflat.search(jflat.SearchParams(n_probes=16), ref, q, 10)
        np.testing.assert_array_equal(_n(n), _n(rn))
        np.testing.assert_allclose(_n(d), _n(rd), **GAUSS_TOL)

    def test_save_load(self, rng, tmp_path):
        db = rng.normal(size=(300, 8)).astype(np.float32)
        index = tflat.build(tflat.IndexParams(n_lists=8), db, **CPU)
        f = str(tmp_path / "ivf_flat.bin")
        tflat.save(f, index)
        loaded = tflat.load(f, **CPU)
        assert loaded.size == index.size
        q = db[:5]
        sp = tflat.SearchParams(n_probes=4)
        d0, n0 = tflat.search(sp, index, q, 3, **CPU)
        d1, n1 = tflat.search(sp, loaded, q, 3, **CPU)
        np.testing.assert_array_equal(_n(n0), _n(n1))
        np.testing.assert_array_equal(_n(d0), _n(d1))

    @pytest.mark.parametrize("writer", ["reference", "port"])
    def test_index_files_load_across_packages(self, rng, tmp_path, writer):
        db = rng.normal(size=(400, 8)).astype(np.float32)
        q = rng.normal(size=(12, 8)).astype(np.float32)
        f = str(tmp_path / "flat")
        if writer == "reference":
            jflat.save(f, jflat.build(jflat.IndexParams(n_lists=8), db))
        else:
            tflat.save(f, tflat.build(tflat.IndexParams(n_lists=8), db,
                                      **CPU))
        ref, port = jflat.load(f), tflat.load(f, **CPU)
        assert port.size == ref.size == 400
        rd, rn = jflat.search(jflat.SearchParams(n_probes=3), ref, q, 5)
        d, n = tflat.search(tflat.SearchParams(n_probes=3), port, q, 5,
                            **CPU)
        np.testing.assert_array_equal(_n(n), _n(rn))
        np.testing.assert_allclose(_n(d), _n(rd), **GAUSS_TOL)

    def test_extend_and_int64_ids(self, rng):
        db = rng.normal(size=(500, 8)).astype(np.float32)
        q = rng.normal(size=(15, 8)).astype(np.float32)
        out = {}
        for dt in ("int32", "int64"):
            index = tflat.build(tflat.IndexParams(n_lists=8, idx_dtype=dt),
                                db[:400], **CPU)
            tflat.extend(index, db[400:], np.arange(400, 500).astype(dt),
                         **CPU)
            assert index.size == 500
            out[dt] = tflat.search(tflat.SearchParams(n_probes=8), index, q,
                                   6, **CPU)
        assert out["int64"][1].dtype == np.int64
        np.testing.assert_array_equal(_n(out["int64"][1]),
                                      _n(out["int32"][1]).astype(np.int64))
        np.testing.assert_array_equal(_n(out["int64"][0]),
                                      _n(out["int32"][0]))
        assert _recall(_n(out["int32"][1]), _truth(q, db, 6)) == 1.0

    def test_search_before_build_raises(self):
        with pytest.raises(ValueError, match="built"):
            tflat.search(tflat.SearchParams(), tflat.Index(),
                         np.zeros((1, 4), np.float32), 1, **CPU)


class TestIvfPq:
    def test_build_search_recall(self, rng):
        # Python-side parity bar: recall > 0.7 (ref test_ivf_pq.py:191).
        db = rng.normal(size=(2000, 16)).astype(np.float32)
        q = rng.normal(size=(50, 16)).astype(np.float32)
        params = tpq.IndexParams(n_lists=16, metric="sqeuclidean",
                                 pq_dim=8, pq_bits=8)
        index = tpq.build(params, db, **CPU)
        assert index.trained
        assert index.pq_dim == 8
        assert index.pq_bits == 8
        assert index.codebook_kind == params.codebook_kind == "subspace"
        d, n = tpq.search(tpq.SearchParams(n_probes=16), index, q, 10, **CPU)
        truth = _truth(q, db, 10)
        assert _recall(_n(n), truth) > 0.7
        ref = jpq.build(jpq.IndexParams(n_lists=16, metric="sqeuclidean",
                                        pq_dim=8, pq_bits=8), db)
        _, rn = jpq.search(jpq.SearchParams(n_probes=16), ref, q, 10)
        assert _recall(_n(rn), truth) > 0.7

    def test_min_recall_class_request(self, rng):
        db = rng.normal(size=(2000, 16)).astype(np.float32)
        q = rng.normal(size=(50, 16)).astype(np.float32)
        params = tpq.IndexParams(n_lists=16, metric="sqeuclidean",
                                 pq_dim=8, pq_bits=8)
        index = tpq.build(params, db, **CPU)
        sp = tpq.SearchParams(n_probes=16, min_recall=0.86)
        assert sp.min_recall == 0.86
        d, n = tpq.search(sp, index, q, 10, **CPU)
        truth = _truth(q, db, 10)
        assert _recall(_n(n), truth) > 0.86
        p2 = tpq.IndexParams(n_lists=16, metric="sqeuclidean",
                             pq_dim=8, pq_bits=8, retain_dataset=False)
        idx2 = tpq.build(p2, db, **CPU)
        d2, n2 = tpq.search(sp, idx2, q, 10, **CPU)
        assert _recall(_n(n2), truth) > 0.5

    def test_search_with_refine(self, rng):
        db = rng.normal(size=(1500, 16)).astype(np.float32)
        q = rng.normal(size=(30, 16)).astype(np.float32)
        params = tpq.IndexParams(n_lists=10, metric="sqeuclidean", pq_dim=4)
        index = tpq.build(params, db, **CPU)
        _, cand = tpq.search(tpq.SearchParams(n_probes=10), index, q, 30,
                             **CPU)
        d, n = trefine(db, q, _n(cand), k=10, metric="sqeuclidean", **CPU)
        assert _recall(_n(n), _truth(q, db, 10)) >= 0.7
        # Exact re-ranking of the same candidates: both packages agree.
        rd, rn = jrefine(db, q, _n(cand), k=10, metric="sqeuclidean")
        np.testing.assert_array_equal(_n(n), _n(rn))
        np.testing.assert_allclose(_n(d), _n(rd), **GAUSS_TOL)

    def test_save_load(self, rng, tmp_path):
        db = rng.normal(size=(500, 8)).astype(np.float32)
        index = tpq.build(tpq.IndexParams(n_lists=5, pq_dim=4), db, **CPU)
        f = str(tmp_path / "ivf_pq.bin")
        tpq.save(f, index)
        loaded = tpq.load(f, **CPU)
        assert loaded.size == index.size
        assert loaded.pq_dim == index.pq_dim
        sp = tpq.SearchParams(n_probes=5)
        d0, n0 = tpq.search(sp, index, db[:7], 4, **CPU)
        d1, n1 = tpq.search(sp, loaded, db[:7], 4, **CPU)
        np.testing.assert_array_equal(_n(n0), _n(n1))
        np.testing.assert_array_equal(_n(d0), _n(d1))

    @pytest.mark.parametrize("writer", ["reference", "port"])
    def test_index_files_load_across_packages(self, rng, tmp_path, writer):
        db = rng.normal(size=(600, 8)).astype(np.float32)
        q = rng.normal(size=(10, 8)).astype(np.float32)
        f = str(tmp_path / "pq")
        params = dict(n_lists=6, pq_dim=4)
        if writer == "reference":
            jpq.save(f, jpq.build(jpq.IndexParams(**params), db))
        else:
            tpq.save(f, tpq.build(tpq.IndexParams(**params), db, **CPU))
        ref, port = jpq.load(f), tpq.load(f, **CPU)
        assert (port.size, port.pq_dim, port.n_lists) == (
            ref.size, ref.pq_dim, ref.n_lists)
        rd, rn = jpq.search(jpq.SearchParams(n_probes=6), ref, q, 5)
        d, n = tpq.search(tpq.SearchParams(n_probes=6), port, q, 5, **CPU)
        np.testing.assert_array_equal(_n(n), _n(rn))
        np.testing.assert_allclose(_n(d), _n(rd), **GAUSS_TOL)

    def test_bad_codebook_kind(self):
        with pytest.raises(ValueError):
            tpq.IndexParams(codebook_kind="bogus")

    def test_search_dtypes(self):
        fp8 = tpq.SearchParams(lut_dtype="fp8", internal_distance_dtype="fp8")
        assert fp8.lut_dtype == fp8.internal_distance_dtype == torch.uint8
        sp = tpq.SearchParams(lut_dtype=np.float16,
                              internal_distance_dtype="bfloat16")
        assert sp.lut_dtype == torch.float16
        assert sp.internal_distance_dtype == torch.bfloat16
        assert tpq.SearchParams().lut_dtype == torch.float32
        assert tpq.IndexParams(idx_dtype="int64").params.idx_dtype \
            == torch.int64


class TestKmeans:
    def test_fit(self, rng):
        blob = np.concatenate([
            rng.normal(loc=0.0, size=(100, 4)),
            rng.normal(loc=8.0, size=(100, 4)),
        ]).astype(np.float32)
        params = tkm.KMeansParams(n_clusters=2, max_iter=50, seed=1)
        centroids, inertia, n_iter = tkm.fit(params, blob, **CPU)
        c = np.sort(_n(centroids)[:, 0])
        assert abs(c[0] - 0.0) < 1.0 and abs(c[1] - 8.0) < 1.0
        assert inertia > 0
        assert n_iter >= 1
        _, ref_inertia, _ = jkm.fit(jkm.KMeansParams(n_clusters=2,
                                                     max_iter=50, seed=1),
                                    blob)
        # Both reach the two blobs, whatever their draws.
        np.testing.assert_allclose(inertia, ref_inertia, rtol=1e-5)

    def test_fit_from_given_centroids(self, rng):
        X = rng.normal(size=(300, 5)).astype(np.float32)
        c0 = X[[3, 50, 120, 200]].copy()
        init = dict(n_clusters=4, max_iter=30, init=tkm.InitMethod.Array)
        cen, inertia, n_iter = tkm.fit(tkm.KMeansParams(**init), X,
                                       centroids=c0, **CPU)
        rcen, rinertia, rn_iter = jkm.fit(
            jkm.KMeansParams(n_clusters=4, max_iter=30,
                             init=jkm.InitMethod.Array), X, centroids=c0)
        np.testing.assert_allclose(_n(cen), _n(rcen), **KM_TOL)
        np.testing.assert_allclose(inertia, rinertia, rtol=1e-5)
        assert n_iter == rn_iter

    def test_cluster_cost(self, rng):
        x = rng.normal(size=(100, 4)).astype(np.float32)
        c = x[:3].copy()
        cost = tkm.cluster_cost(x, c, **CPU)
        assert isinstance(cost, float) and cost > 0
        np.testing.assert_allclose(cost, jkm.cluster_cost(x, c), rtol=1e-5)

    def test_init_plus_plus(self, rng):
        x = rng.normal(size=(200, 4)).astype(np.float32)
        cents = _n(tkm.init_plus_plus(x, n_clusters=5, seed=0, **CPU))
        assert cents.shape == (5, 4)
        # chosen centers are actual data points, all distinct
        d = cdist(cents, x)
        np.testing.assert_allclose(d.min(axis=1), 0, atol=1e-5)
        assert len(set(d.argmin(axis=1))) == 5
        again = _n(tkm.init_plus_plus(x, n_clusters=5, seed=0, **CPU))
        np.testing.assert_array_equal(cents, again)
        out = np.zeros((5, 4), np.float32)
        assert tkm.init_plus_plus(x, seed=0, centroids=out, **CPU) is out
        np.testing.assert_array_equal(out, cents)

    def test_init_plus_plus_exclusive_args(self, rng):
        x = rng.normal(size=(20, 4)).astype(np.float32)
        cents = np.zeros((5, 4), np.float32)
        with pytest.raises(RuntimeError):
            tkm.init_plus_plus(x, n_clusters=4, centroids=cents, **CPU)
        with pytest.raises(RuntimeError):
            tkm.init_plus_plus(x, **CPU)

    def test_compute_new_centroids(self, rng):
        x = rng.normal(size=(100, 4)).astype(np.float32)
        c = x[:4].copy()
        labels = cdist(x, c).argmin(axis=1).astype(np.int32)
        new = np.zeros_like(c)
        assert tkm.compute_new_centroids(x, c, labels, new, **CPU) is new
        want = np.stack([x[labels == j].mean(axis=0) for j in range(4)])
        np.testing.assert_allclose(new, want, rtol=1e-4, atol=1e-5)
        ref = np.zeros_like(c)
        jkm.compute_new_centroids(x, c, labels, ref)
        np.testing.assert_allclose(new, ref, **KM_TOL)

    def test_compute_new_centroids_weight_per_cluster(self, rng):
        x = rng.normal(size=(60, 3)).astype(np.float32)
        c = x[:3].copy()
        labels = cdist(x, c).argmin(axis=1).astype(np.int32)
        w = rng.uniform(0.5, 2.0, size=60).astype(np.float32)
        for weights, want in ((None, np.bincount(labels, minlength=3)),
                              (w, np.bincount(labels, w, minlength=3))):
            new = np.zeros_like(c)
            wpc = np.zeros((3,), np.float32)
            tkm.compute_new_centroids(x, c, labels, new,
                                      sample_weights=weights,
                                      weight_per_cluster=wpc, **CPU)
            np.testing.assert_allclose(wpc, want, rtol=1e-6)
            ref_new, ref_wpc = np.zeros_like(c), np.zeros((3,), np.float32)
            jkm.compute_new_centroids(x, c, labels, ref_new,
                                      sample_weights=weights,
                                      weight_per_cluster=ref_wpc)
            np.testing.assert_allclose(wpc, ref_wpc, rtol=1e-6)
            np.testing.assert_allclose(new, ref_new, **KM_TOL)

    def test_kmeans_params_fields(self):
        p = tkm.KMeansParams(n_clusters=7, max_iter=12, tol=1e-3, seed=9,
                             init=tkm.InitMethod.Random, metric="sqeuclidean")
        assert p.n_clusters == 7
        assert p.max_iter == 12
        assert p.tol == 1e-3
        assert p.seed == 9
        assert p.init == tkm.InitMethod.Random
        with pytest.raises(ValueError):
            tkm.KMeansParams(metric="bogus")


class TestRandom:
    THETA = np.array([0.5, 0.2, 0.2, 0.1], np.float32)

    def _held_to_theta(self, edges, scale):
        """The top level's quadrant shares within 6 standard errors of
        theta."""
        half = 1 << (scale - 1)
        quad = 2 * (edges[:, 0] >= half) + (edges[:, 1] >= half)
        n = edges.shape[0]
        share = np.bincount(quad, minlength=4) / n
        se = np.sqrt(self.THETA * (1 - self.THETA) / n)
        assert np.all(np.abs(share - self.THETA) <= 6 * se), share

    def test_rmat(self):
        out = np.zeros((20000, 2), np.int32)
        ret = trmat(out, self.THETA, 8, 8, seed=3, **CPU)
        assert ret is out
        assert out.min() >= 0
        assert out.max() < 256
        self._held_to_theta(out, 8)
        ref = np.zeros((20000, 2), np.int32)
        jrmat(ref, self.THETA, 8, 8, seed=3)
        self._held_to_theta(ref, 8)
        again = np.zeros_like(out)
        trmat(again, self.THETA, 8, 8, seed=3, **CPU)
        np.testing.assert_array_equal(out, again)

    def test_rmat_stays_on_the_device_of_out(self):
        t = torch.zeros((5000, 2), dtype=torch.int64)
        # A returned tensor is wrapped, as every facade output is.
        assert trmat(t, self.THETA, 6, 10, seed=4, **CPU).array is t
        d = device_ndarray.zeros((5000, 2), dtype=np.int32, device="cpu")
        assert trmat(d, self.THETA, 6, 10, seed=4, **CPU) is d
        np.testing.assert_array_equal(d.copy_to_host(), t.numpy())
        assert int(t[:, 0].max()) < 64 and int(t[:, 1].max()) < 1024


class TestCommonShims:
    def test_stream(self):
        s = Stream(device="cpu")
        s.sync()
        assert s.get_ptr() == 0 and s.device.type == "cpu"
        ref = pylibraft.common.Stream()
        ref.sync()
        assert isinstance(ref.get_ptr(), int)

    def test_interruptible_scope(self):
        with cuda_interruptible():
            x = torch.arange(16.0) * 3
            synchronize(x)
        assert float(x[1]) == 3.0

    def test_cancel_raises(self):
        Interruptible.get_token().cancel()
        with pytest.raises(InterruptedException):
            synchronize(torch.ones(4))

    def test_sigint_cancels_and_chains(self):
        import signal

        seen = []
        prev = signal.signal(signal.SIGINT, lambda s, f: seen.append(s))
        try:
            with cuda_interruptible():
                assert signal.getsignal(signal.SIGINT) is not prev
                signal.raise_signal(signal.SIGINT)
                assert seen == [signal.SIGINT]
                with pytest.raises(InterruptedException):
                    synchronize(torch.ones(2))
            assert signal.getsignal(signal.SIGINT) is not None
        finally:
            signal.signal(signal.SIGINT, prev)
