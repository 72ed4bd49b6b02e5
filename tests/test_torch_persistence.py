"""save / load of both IVF indexes, across raft_tpu and raft_tpu_torch.

Both packages write the same npz layout (IVF-Flat version 3, IVF-PQ
version 4 with bit-packed codes), so a file written by either loads in the
other. Each case writes with one package, loads with the other, and holds
the loaded arrays to the written ones bit for bit (keys, dtypes, values)
and the two packages' searches of the one file to each other: the indexes
have integer centers, rows and codebooks, so every distance is exact and
ids must agree bit for bit (IVF-Flat distances within rtol 1e-6, the
tolerance of its own parity tests). The port loads onto the CPU here;
``load`` defaults to the card.
"""

import dataclasses
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import lifecycle as jlc
from raft_tpu.core import retry as jretry
from raft_tpu.core import serialize as jserialize
from raft_tpu.distance.distance_types import DistanceType as JDistance
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import lifecycle as lc
from raft_tpu_torch.core import retry, serialize
from raft_tpu_torch.core.error import CudaError, LogicError
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
from test_torch_common import int_data, n, t

DIM, N_LISTS, PQ_DIM, CAP = 16, 8, 8, 96
FLAT_RTOL = 1e-6

_RNG = np.random.default_rng(21)
_X = int_data(_RNG, (900, DIM))
_Q = int_data(_RNG, (25, DIM))
_DELS = np.arange(0, 900, 7)


@pytest.fixture(scope="module")
def jflat():
    """The reference's IVF-Flat index over ``_X``, its centers rounded to
    integers."""
    j = jivf.build(jivf.IndexParams(n_lists=N_LISTS, kmeans_n_iters=3), _X)
    return dataclasses.replace(j, centers=jnp.round(j.centers))


def _pq_arrays(bits, per_cluster=False, seed=0):
    """A small IVF-PQ model from integer arrays (identity rotation)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(40, CAP + 1, N_LISTS).astype(np.int32)
    indices = np.full((N_LISTS, CAP), -1, np.int32)
    base = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    for l in range(N_LISTS):
        indices[l, :sizes[l]] = base[l] + np.arange(sizes[l])
    codes = rng.integers(0, 1 << bits, (N_LISTS, CAP, PQ_DIM))
    lead = N_LISTS if per_cluster else PQ_DIM
    return dict(centers=int_data(rng, (N_LISTS, DIM), hi=4),
                rotation_matrix=np.eye(DIM, dtype=np.float32),
                pq_centers=rng.integers(-2, 3, (lead, 1 << bits,
                                                DIM // PQ_DIM)
                                        ).astype(np.float32),
                pq_codes=n(ivf_pq.pack_codes(t(codes), bits)),
                indices=indices, list_sizes=sizes, pq_bits=bits,
                pq_dim=PQ_DIM)


def _jpq(a, per_cluster=False):
    return jpq.Index(metric=JDistance.L2Expanded,
                     codebook_kind=jpq.CodebookGen(int(per_cluster)),
                     **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                            else v) for k, v in a.items()})


def _same_file(f1, f2):
    """Two npz files hold the same keys, dtypes and values."""
    with np.load(f1) as a, np.load(f2) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _same_search(out, jout, rtol=0.0):
    (d, i), (jd, ji) = out, jout
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_allclose(n(d), n(jd), rtol=rtol, atol=0)


# ---------------------------------------------------------------------------
# IVF-Flat


@pytest.mark.parametrize("tombstones", [False, True])
def test_flat_reference_file_loads_in_the_port(tmp_path, jflat, tombstones):
    j = jflat
    if tombstones:
        j = dataclasses.replace(j)
        assert jlc.delete(j, _DELS) > 0
    jivf.save(str(tmp_path / "ref"), j)
    p = ivf_flat.load(str(tmp_path / "ref"), device="cpu")
    assert p.epoch == 0 and p.n_deleted == j.n_deleted
    assert "_auto_cap_cache" not in p.__dict__
    assert (p.deleted is None) == (not tombstones)
    for field in ("centers", "data", "indices", "list_sizes"):
        np.testing.assert_array_equal(n(getattr(p, field)),
                                      n(getattr(j, field)), err_msg=field)
    for engine in ("scan", "bucketed"):
        sp = dict(n_probes=3, engine=engine)
        _same_search(
            ivf_flat.search(ivf_flat.SearchParams(**sp), p, t(_Q), 10),
            jivf.search(jivf.SearchParams(**sp), j, _Q, 10), FLAT_RTOL)
    # The port's save of the loaded index is the same file.
    ivf_flat.save(str(tmp_path / "port"), p)
    _same_file(tmp_path / "ref.npz", tmp_path / "port.npz")


@pytest.mark.parametrize("tombstones", [False, True])
def test_flat_port_file_loads_in_the_reference(tmp_path, jflat, tombstones):
    p = ivf_flat.index_from_numpy(n(jflat.centers), n(jflat.data),
                                  n(jflat.indices), n(jflat.list_sizes), 0,
                                  device="cpu")
    if tombstones:
        assert lc.delete(p, _DELS) > 0
    ivf_flat.save(str(tmp_path / "port.npz"), p)
    with np.load(tmp_path / "port.npz") as z:
        assert ("deleted" in z.files) == tombstones
        assert z["version"] == ivf_flat.SERIALIZATION_VERSION == 3
    j = jivf.load(str(tmp_path / "port.npz"))
    assert j.n_deleted == p.n_deleted
    _same_search(ivf_flat.search(ivf_flat.SearchParams(n_probes=3), p,
                                 t(_Q), 10),
                 jivf.search(jivf.SearchParams(n_probes=3), j, _Q, 10),
                 FLAT_RTOL)
    jivf.save(str(tmp_path / "ref"), j)
    _same_file(tmp_path / "ref.npz", tmp_path / "port.npz")


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "uint8", "float16"])
def test_flat_low_precision_data_layout_both_ways(tmp_path, dtype):
    """The reference builds on bf16, f16 and 8-bit rows. numpy has no
    bfloat16: its bf16 arrays (centers and data) land in the file as the
    2-byte void type ``|V2``. The port reads them as bf16 tensors and
    writes them back in the same layout, byte for byte. The reference's
    own ``load`` cannot read a ``|V2`` array (``jnp.asarray`` refuses the
    void type), its own file or the port's alike."""
    X = _X[:400] - (0 if dtype == "uint8" else 4)
    j = jivf.build(jivf.IndexParams(n_lists=4, kmeans_n_iters=2),
                   jnp.asarray(X).astype(dtype))
    jivf.save(str(tmp_path / "ref"), j)
    p = ivf_flat.load(str(tmp_path / "ref"), device="cpu")
    want = {"bfloat16": torch.bfloat16, "int8": torch.int8,
            "uint8": torch.uint8, "float16": torch.float16}[dtype]
    assert p.data.dtype == want
    if dtype == "bfloat16":
        assert p.centers.dtype == torch.bfloat16
        with np.load(tmp_path / "ref.npz") as z:
            assert z["data"].dtype == np.dtype("V2")
        np.testing.assert_array_equal(
            n(p.data.float()), np.asarray(j.data.astype(jnp.float32)))
    ivf_flat.save(str(tmp_path / "port"), p)
    _same_file(tmp_path / "ref.npz", tmp_path / "port.npz")
    if dtype == "bfloat16":
        for name in ("ref", "port"):
            with pytest.raises(TypeError, match="V2"):
                jivf.load(str(tmp_path / name))
        return
    j2 = jivf.load(str(tmp_path / "port"))
    assert j2.data.dtype == j.data.dtype
    np.testing.assert_array_equal(np.asarray(j2.data.astype(jnp.float32)),
                                  np.asarray(j.data.astype(jnp.float32)))
    if dtype in ("int8", "uint8"):
        # f32 centers: both packages search the 8-bit rows.
        _same_search(ivf_flat.search(ivf_flat.SearchParams(n_probes=2), p,
                                     t(_Q), 5),
                     jivf.search(jivf.SearchParams(n_probes=2), j, _Q, 5),
                     FLAT_RTOL)


# ---------------------------------------------------------------------------
# IVF-PQ


@pytest.mark.parametrize("bits,per_cluster", [(4, False), (5, False),
                                              (8, False), (8, True)])
@pytest.mark.parametrize("tombstones", [False, True])
def test_pq_files_load_both_ways(tmp_path, bits, per_cluster, tombstones):
    a = _pq_arrays(bits, per_cluster, seed=bits)
    j = _jpq(a, per_cluster)
    if tombstones:
        assert jlc.delete(j, _DELS) > 0
    jpq.save(str(tmp_path / "ref"), j)
    p = ivf_pq.load(str(tmp_path / "ref"), device="cpu")
    assert (p.pq_bits, p.pq_dim, p.codebook_kind.value, p.n_deleted,
            p.epoch) == (bits, PQ_DIM, int(per_cluster), j.n_deleted, 0)
    assert p._recon is None and p._scan_ops is None and p._source is None
    q = _Q % 4
    engines = ["scan"] + (["bucketed"] if bits == 8 and not per_cluster
                          else [])
    for engine in engines:
        sp = dict(n_probes=3, engine=engine)
        _same_search(ivf_pq.search(ivf_pq.SearchParams(**sp), p, t(q), 10),
                     jpq.search(jpq.SearchParams(**sp), j, q, 10))
    ivf_pq.save(str(tmp_path / "port"), p)
    _same_file(tmp_path / "ref.npz", tmp_path / "port.npz")
    j2 = jpq.load(str(tmp_path / "port"))
    _same_search(ivf_pq.search(ivf_pq.SearchParams(n_probes=3,
                                                   engine="scan"),
                               p, t(q), 10),
                 jpq.search(jpq.SearchParams(n_probes=3, engine="scan"),
                            j2, q, 10))


def test_pq_built_index_round_trip(tmp_path):
    """A reference-built index (trained codebooks, a random rotation)
    crosses both ways with every array intact, and the port's delete on
    the loaded index writes the ``deleted`` key."""
    j = jpq.build(jpq.IndexParams(n_lists=4, pq_dim=PQ_DIM, pq_bits=5,
                                  kmeans_n_iters=2,
                                  force_random_rotation=True), _X)
    jpq.save(str(tmp_path / "ref"), j)
    p = ivf_pq.load(str(tmp_path / "ref"), device="cpu")
    ivf_pq.save(str(tmp_path / "port"), p)
    _same_file(tmp_path / "ref.npz", tmp_path / "port.npz")
    lc.delete(p, _DELS)
    ivf_pq.save(str(tmp_path / "del"), p)
    j2 = jpq.load(str(tmp_path / "del"))
    assert j2.n_deleted == p.n_deleted > 0
    np.testing.assert_array_equal(np.asarray(j2.deleted), n(p.deleted))
    # A loaded index keeps no dataset: search_refined needs it passed.
    with pytest.raises(LogicError, match="dataset"):
        ivf_pq.search_refined(ivf_pq.SearchParams(n_probes=4), p, None,
                              t(_Q), 3)
    d, i = ivf_pq.search_refined(ivf_pq.SearchParams(n_probes=4), p, t(_X),
                                 t(_Q), 3)
    assert not np.isin(n(i), _DELS).any()


# ---------------------------------------------------------------------------
# Refusals, names and IO retries


def _rewrite(path, **changes):
    z = dict(np.load(path))
    z.update(changes)
    np.savez(path, **z)


@pytest.mark.parametrize("kind", ["flat", "pq"])
def test_version_mismatch_refused(tmp_path, jflat, kind):
    f = str(tmp_path / "idx.npz")
    if kind == "flat":
        ivf_flat.save(f, ivf_flat.index_from_numpy(
            n(jflat.centers), n(jflat.data), n(jflat.indices),
            n(jflat.list_sizes), 0, device="cpu"))
        _rewrite(f, version=np.int64(2))
        with pytest.raises(LogicError, match="version mismatch: 2"):
            ivf_flat.load(f, device="cpu")
    else:
        jpq.save(f, _jpq(_pq_arrays(8)))
        _rewrite(f, version=np.int64(3))
        with pytest.raises(LogicError, match="v3 unpacked-codes"):
            ivf_pq.load(f, device="cpu")
        with pytest.raises(Exception, match="v3 unpacked-codes"):
            jpq.load(f)


@pytest.mark.parametrize("id_dtype", [np.uint32, np.int16])
@pytest.mark.parametrize("kind", ["flat", "pq"])
def test_unsupported_id_dtype_refused(tmp_path, jflat, kind, id_dtype):
    f = str(tmp_path / "idx.npz")
    if kind == "flat":
        jivf.save(f, jflat)
        mod = ivf_flat
    else:
        jpq.save(f, _jpq(_pq_arrays(8)))
        mod = ivf_pq
    with np.load(f) as z:
        ids = z["indices"]
    _rewrite(f, indices=ids.astype(id_dtype))
    with pytest.raises(LogicError, match="idx_dtype"):
        mod.load(f, device="cpu")


def test_suffix_added_on_load_and_save(tmp_path, jflat):
    p = ivf_flat.index_from_numpy(n(jflat.centers), n(jflat.data),
                                  n(jflat.indices), n(jflat.list_sizes), 0,
                                  device="cpu")
    ivf_flat.save(tmp_path / "plain", p)          # a Path, no suffix
    assert os.path.exists(tmp_path / "plain.npz")
    for name in (str(tmp_path / "plain"), str(tmp_path / "plain.npz"),
                 tmp_path / "plain"):
        q = ivf_flat.load(name, device="cpu")
        assert torch.equal(q.indices, p.indices)


def test_load_defaults_to_the_card(tmp_path, jflat):
    jivf.save(str(tmp_path / "ref"), jflat)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: nothing to refuse")
    for mod in (ivf_flat, ivf_pq):
        with pytest.raises(CudaError):
            mod.load(str(tmp_path / "ref"))


@pytest.mark.parametrize("kind", ["flat", "pq"])
@pytest.mark.parametrize("op", ["save", "load"])
def test_transient_oserror_is_retried(tmp_path, monkeypatch, jflat, kind,
                                      op):
    """One ``OSError`` from the filesystem is retried (``DEFAULT_IO_RETRY``
    schedule, the reference's), and a persistent one raises after the
    policy's attempts with the original type."""
    mod = ivf_flat if kind == "flat" else ivf_pq
    if kind == "flat":
        index = ivf_flat.index_from_numpy(
            n(jflat.centers), n(jflat.data), n(jflat.indices),
            n(jflat.list_sizes), 0, device="cpu")
    else:
        index = ivf_pq.index_from_numpy(**_pq_arrays(8), codebook_kind=0,
                                        metric=0, device="cpu")
    f = str(tmp_path / "idx")
    mod.save(f, index)
    target = "savez" if op == "save" else "load"
    real = getattr(np, target)
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) <= fails:
            raise OSError("transient")
        return real(*a, **kw)

    monkeypatch.setattr(np, target, flaky)
    run = ((lambda **kw: mod.save(f, index, **kw)) if op == "save"
           else (lambda **kw: mod.load(f, device="cpu", **kw)))
    policy = retry.RetryPolicy(max_attempts=3, base_delay=0.0,
                               retry_on=(OSError,))
    assert policy.delays() == jretry.RetryPolicy(
        max_attempts=3, base_delay=0.0, retry_on=(OSError,)).delays()
    fails = 1
    run(retry=policy)
    assert len(calls) == 2
    calls.clear()
    fails = 5
    with pytest.raises(OSError, match="transient"):
        run(retry=policy)
    assert len(calls) == 3
    assert retry.DEFAULT_IO_RETRY.delays() == \
        jretry.DEFAULT_IO_RETRY.delays()


# ---------------------------------------------------------------------------
# core/serialize


@pytest.mark.parametrize("dtype", ["float32", "int64", "uint8", "bool",
                                   "bfloat16"])
def test_serialize_mdspan_bytes_both_ways(dtype):
    a = np.arange(24).reshape(2, 3, 4) % 5
    # The reference takes numpy too; bf16 only exists as a JAX dtype here.
    ja = (jnp.asarray(a).astype(dtype) if dtype == "bfloat16"
          else a.astype(dtype))
    pa = (torch.as_tensor(a).to(torch.bfloat16) if dtype == "bfloat16"
          else torch.as_tensor(a.astype(dtype)))
    js, ps = io.BytesIO(), io.BytesIO()
    jserialize.serialize_mdspan(js, ja)
    serialize.serialize_mdspan(ps, pa)
    assert js.getvalue() == ps.getvalue()
    ps.seek(0)
    back = serialize.from_numpy(serialize.deserialize_mdspan(ps))
    assert back.dtype == pa.dtype and torch.equal(back, pa)
    js.seek(0)
    jback = jserialize.deserialize_mdspan(js)
    assert jback.tobytes() == np.asarray(ja).tobytes()


@pytest.mark.parametrize("dtype,value", [
    ("int8", -5), ("uint8", 200), ("int32", -123456), ("uint32", 4000000000),
    ("int64", 1 << 40), ("uint64", 1 << 63), ("float32", 1.5),
    ("float64", -2.25), ("bool", True)])
def test_serialize_scalar_bytes_both_ways(dtype, value):
    js, ps = io.BytesIO(), io.BytesIO()
    jserialize.serialize_scalar(js, value, dtype)
    serialize.serialize_scalar(ps, value, dtype)
    assert js.getvalue() == ps.getvalue()
    js.seek(0)
    ps.seek(0)
    assert serialize.deserialize_scalar(js, dtype) == value
    assert jserialize.deserialize_scalar(ps, dtype) == value
