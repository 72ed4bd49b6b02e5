"""int64 neighbor ids in raft_tpu_torch, held against raft_tpu.

The reference's int64 ids need JAX's global x64 switch, which
``tests/conftest.py`` turns off. So the parity cases run both packages in
a subprocess with ``JAX_ENABLE_X64=1``, as ``tests/test_int64_ids.py``
runs the reference's own. Under x64 the reference keeps float64 as
float64, so every vector handed to it there is float32. The data, centers
and codebooks are integer valued, so ids must agree bit for bit and
distances exactly (IVF-Flat within rtol 1e-6; cosine, ``1 - s``, within
two f32 ulps of 1). The port's id dtype needs no switch; the in-process
cases run the port alone.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raft_tpu_torch import lifecycle as lc
from raft_tpu_torch import serve
from raft_tpu_torch.comms.topk_merge import merge_parts
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.core.mdarray import validate_idx_dtype
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
from raft_tpu_torch.neighbors.refine import refine
from test_torch_common import int_data, n, recall, t

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIG = 1 << 33

_X64_SCRIPT = r"""
import dataclasses, os, tempfile
import jax, jax.numpy as jnp, numpy as np, torch
assert jax.config.jax_enable_x64
jax.config.update("jax_default_matmul_precision", "highest")
from raft_tpu import lifecycle as jlc, serve as jserve
from raft_tpu.distance.distance_types import DistanceType as JD
from raft_tpu.neighbors import brute_force as jbf, ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import lifecycle as lc, serve
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq

BIG = 1 << 33
rng = np.random.default_rng(0)
X = rng.integers(0, 8, (1200, 16)).astype(np.float32)
Q = rng.integers(0, 8, (30, 16)).astype(np.float32)
tmp = tempfile.mkdtemp()
t = torch.as_tensor
n = np.asarray


def same(out, jout, rtol=0.0, atol=0.0):
    (d, i), (jd, ji) = out, jout
    assert i.dtype == torch.int64 and n(ji).dtype == np.int64, (i.dtype,
                                                                n(ji).dtype)
    np.testing.assert_array_equal(i.numpy(), n(ji))
    np.testing.assert_allclose(d.numpy(), n(jd), rtol=rtol, atol=atol)


# brute force: offsets past 2^32, several parts, short parts padded (cosine
# distances 1 - s within 2 f32 ulps of 1: s has a square root each side)
for parts in ([X], [X[:500], X[500:503], X[503:]], [X[:4], X[4:9]]):
    for metric in ("sqeuclidean", "l1", "cosine"):
        for k in (1, 10):
            same(brute_force.knn([t(p) for p in parts], t(Q), k,
                                 metric=metric, idx_dtype=torch.int64,
                                 global_id_offset=1 << 32),
                 jbf.knn(parts, Q, k, metric=metric, idx_dtype=jnp.int64,
                         global_id_offset=1 << 32),
                 atol=2 * 2.0 ** -23 if metric == "cosine" else 0.0)

# IVF-Flat: the reference's centers (rounded), no rows; both packages
# extend with ids past 2^31, search, save, load, delete, upsert, compact.
model = jivf.build(jivf.IndexParams(n_lists=8, kmeans_n_iters=3,
                                    idx_dtype=jnp.int64,
                                    add_data_on_build=False), X)
j = dataclasses.replace(model, centers=jnp.round(model.centers))
assert j.indices.dtype == jnp.int64
p = ivf_flat.index_from_numpy(n(j.centers), n(j.data), n(j.indices),
                              n(j.list_sizes), 0, device="cpu")
assert p.indices.dtype == torch.int64
ids = BIG + np.arange(len(X), dtype=np.int64)
p = ivf_flat.extend(p, t(X), t(ids))
j = jivf.extend(j, X, ids)
for f in ("data", "indices", "list_sizes"):
    np.testing.assert_array_equal(getattr(p, f).numpy(), n(getattr(j, f)))
for engine in ("scan", "bucketed"):
    sp = dict(n_probes=3, engine=engine)
    same(ivf_flat.search(ivf_flat.SearchParams(**sp), p, t(Q), 10),
         jivf.search(jivf.SearchParams(**sp), j, Q, 10), 1e-6)
ivf_flat.save(os.path.join(tmp, "pf"), p)
jivf.save(os.path.join(tmp, "jf"), j)
jl = jivf.load(os.path.join(tmp, "pf"))
pl = ivf_flat.load(os.path.join(tmp, "jf"), device="cpu")
assert jl.indices.dtype == jnp.int64 and pl.indices.dtype == torch.int64
same(ivf_flat.search(ivf_flat.SearchParams(n_probes=3), pl, t(Q), 10),
     jivf.search(jivf.SearchParams(n_probes=3), jl, Q, 10), 1e-6)
dels = BIG + np.arange(0, len(X), 5, dtype=np.int64)
assert lc.delete(p, t(dels)) == jlc.delete(j, dels) > 0
up = np.concatenate([dels[:10], BIG + len(X) + np.arange(10)])
vec = rng.integers(0, 8, (20, 16)).astype(np.float32)
p = lc.upsert(p, t(vec), t(up))
j = jlc.upsert(j, vec, up)
assert p._next_id == j._next_id == int(up.max()) + 1 > BIG
same(ivf_flat.search(ivf_flat.SearchParams(n_probes=3), p, t(Q), 10),
     jivf.search(jivf.SearchParams(n_probes=3), j, Q, 10), 1e-6)
ivf_flat.save(os.path.join(tmp, "pdel"), p)
jd = jivf.load(os.path.join(tmp, "pdel"))
np.testing.assert_array_equal(n(jd.deleted), p.deleted.numpy())
for shrink in (False, True):
    pol = dict(shrink_capacity=shrink)
    pc, prep = lc.compact(p, lc.CompactionPolicy(**pol))
    jc, jrep = jlc.compact(j, jlc.CompactionPolicy(**pol))
    assert pc.indices.dtype == torch.int64
    assert prep.reclaimed_slots == jrep.reclaimed_slots
    np.testing.assert_array_equal(pc.indices.numpy(), n(jc.indices))
    same(ivf_flat.search(ivf_flat.SearchParams(n_probes=3), pc, t(Q), 10),
         jivf.search(jivf.SearchParams(n_probes=3), jc, Q, 10), 1e-6)
s = serve.Searcher.ivf_flat(pc, ivf_flat.SearchParams(n_probes=3))
js = jserve.Searcher.ivf_flat(jc, jivf.SearchParams(n_probes=3))
r, jr = s.search(Q, 10), js.search(Q, 10)
assert r.indices.dtype == np.int64
np.testing.assert_array_equal(r.indices, n(jr.indices))

# IVF-PQ: an integer model (identity rotation) with no rows; both packages
# extend with ids past 2^31 and encode the same codes.
L, J, B = 8, 8, 256
a = dict(centers=rng.integers(0, 4, (L, 16)).astype(np.float32),
         rotation_matrix=np.eye(16, dtype=np.float32),
         pq_centers=rng.integers(-2, 3, (J, B, 2)).astype(np.float32),
         pq_codes=np.zeros((L, 1, J), np.uint8),
         indices=np.full((L, 1), -1, np.int64),
         list_sizes=np.zeros((L,), np.int32), pq_bits=8, pq_dim=J)
jp = jpq.Index(metric=JD.L2Expanded, codebook_kind=jpq.CodebookGen(0),
               **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                  for k, v in a.items()})
pp = ivf_pq.index_from_numpy(**a, codebook_kind=0, metric=0, device="cpu")
Xp = X % 4
pp = ivf_pq.extend(pp, t(Xp), t(ids))
jp = jpq.extend(jp, Xp, ids)
for f in ("pq_codes", "indices", "list_sizes"):
    np.testing.assert_array_equal(getattr(pp, f).numpy(), n(getattr(jp, f)))
Qp = Q % 4
for engine in ("scan", "bucketed"):
    sp = dict(n_probes=3, engine=engine)
    same(ivf_pq.search(ivf_pq.SearchParams(**sp), pp, t(Qp), 10),
         jpq.search(jpq.SearchParams(**sp), jp, Qp, 10))
ivf_pq.save(os.path.join(tmp, "pp"), pp)
jpq.save(os.path.join(tmp, "jp"), jp)
jpl = jpq.load(os.path.join(tmp, "pp"))
ppl = ivf_pq.load(os.path.join(tmp, "jp"), device="cpu")
same(ivf_pq.search(ivf_pq.SearchParams(n_probes=3), ppl, t(Qp), 10),
     jpq.search(jpq.SearchParams(n_probes=3), jpl, Qp, 10))
assert lc.delete(pp, t(dels)) == jlc.delete(jp, dels) > 0
pp = lc.upsert(pp, t(vec % 4), t(up))
jp = jlc.upsert(jp, vec % 4, up)
same(ivf_pq.search(ivf_pq.SearchParams(n_probes=3), pp, t(Qp), 10),
     jpq.search(jpq.SearchParams(n_probes=3), jp, Qp, 10))
ppc, _ = lc.compact(pp)
jpc, _ = jlc.compact(jp)
np.testing.assert_array_equal(ppc.indices.numpy(), n(jpc.indices))
s = serve.Searcher.ivf_pq(ppc, ivf_pq.SearchParams(n_probes=3))
js = jserve.Searcher.ivf_pq(jpc, jpq.SearchParams(n_probes=3))
r, jr = s.search(Qp, 10), js.search(Qp, 10)
np.testing.assert_array_equal(r.indices, n(jr.indices))
np.testing.assert_array_equal(r.distances, n(jr.distances))
print("OK")
"""


def test_int64_parity_x64_subprocess():
    env = dict(os.environ)
    env.update({"JAX_ENABLE_X64": "1", "JAX_PLATFORMS": "cpu",
                "PYTHONPATH": _REPO})
    out = subprocess.run([sys.executable, "-c", _X64_SCRIPT], env=env,
                         cwd=_REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "OK" in out.stdout


# ---------------------------------------------------------------------------
# The port alone


_RNG = np.random.default_rng(4)
_X = int_data(_RNG, (700, 16))
_Q = int_data(_RNG, (20, 16))


@pytest.mark.parametrize("dtype,want", [
    (torch.int32, torch.int32), (torch.int64, torch.int64),
    ("int64", torch.int64), (np.int32, torch.int32),
    (np.dtype("int64"), torch.int64), (torch.int16, None),
    (np.uint32, None), ("float32", None), ("not-a-dtype", None),
    (None, None)])
def test_validate_idx_dtype(dtype, want):
    if want is None:
        with pytest.raises(LogicError, match="idx_dtype"):
            validate_idx_dtype(dtype)
    else:
        assert validate_idx_dtype(dtype) == want


@pytest.mark.parametrize("parts", [1, 3])
def test_brute_force_offsets_past_2_32(parts):
    db = [t(_X)] if parts == 1 else [t(_X[:300]), t(_X[300:302]),
                                     t(_X[302:])]
    d32, i32 = brute_force.knn(db, t(_Q), 10)
    d64, i64 = brute_force.knn(db, t(_Q), 10, idx_dtype=torch.int64,
                               global_id_offset=1 << 32)
    assert i32.dtype == torch.int32 and i64.dtype == torch.int64
    assert torch.equal(d32, d64)
    assert torch.equal(i64 - (1 << 32), i32.long())
    with pytest.raises(LogicError, match="int64"):
        brute_force.knn(db, t(_Q), 10, global_id_offset=1 << 32)
    with pytest.raises(LogicError, match="idx_dtype"):
        brute_force.knn(db, t(_Q), 10, idx_dtype=torch.float32)


def test_merge_parts_translations_past_2_31():
    keys = torch.tensor([[[1.0, 3.0]], [[2.0, float("inf")]]])
    vals = torch.tensor([[[0, 1]], [[0, -1 - (3 << 31)]]])
    d, i = merge_parts(keys, vals, translations=[5, 3 << 31])
    assert i.dtype == torch.int64
    assert i.tolist() == [[5, (3 << 31)]] and d.tolist() == [[1.0, 2.0]]
    d, i = merge_parts(keys, vals, k=4, translations=[5, 3 << 31])
    assert i.tolist() == [[5, 3 << 31, 6, -1]]
    with pytest.raises(LogicError, match="do not fit"):
        merge_parts(keys, vals.int(), translations=[0, 3 << 31])


@pytest.fixture(scope="module")
def flat64():
    """The port's own int64 IVF-Flat build, extended with ids past 2^33."""
    idx = ivf_flat.build(ivf_flat.IndexParams(
        n_lists=8, kmeans_n_iters=3, idx_dtype=torch.int64,
        add_data_on_build=False), t(_X))
    return ivf_flat.extend(idx, t(_X), t(BIG + np.arange(len(_X))))


def test_flat_build_extend_search_save_load(tmp_path, flat64):
    assert flat64.indices.dtype == torch.int64
    full = ivf_flat.build(ivf_flat.IndexParams(
        n_lists=8, kmeans_n_iters=3, idx_dtype="int64"), t(_X))
    assert full.indices.dtype == torch.int64
    d, i = ivf_flat.search(ivf_flat.SearchParams(n_probes=8), flat64,
                           t(_Q), 5)
    # Every list probed: exact kNN distances (ids may differ at ties).
    bd, _ = brute_force.knn(t(_X), t(_Q), 5)
    assert i.dtype == torch.int64 and int(i.min()) >= BIG
    assert torch.equal(d, bd)
    ivf_flat.save(str(tmp_path / "f"), flat64)
    back = ivf_flat.load(str(tmp_path / "f"), device="cpu")
    assert torch.equal(back.indices, flat64.indices)
    d2, i2 = ivf_flat.search(ivf_flat.SearchParams(n_probes=8), back,
                             t(_Q), 5)
    assert torch.equal(i2, i) and torch.equal(d2, d)


def test_int32_index_refuses_ids_it_cannot_hold():
    idx = ivf_flat.build(ivf_flat.IndexParams(n_lists=4, kmeans_n_iters=2),
                         t(_X))
    with pytest.raises(LogicError, match="do not fit"):
        ivf_flat.extend(idx, t(_X[:2]), t(np.array([1, BIG])))
    with pytest.raises(LogicError, match="do not fit"):
        lc.upsert(idx, t(_X[:2]), t(np.array([1, BIG])))
    pq = ivf_pq.build(ivf_pq.IndexParams(n_lists=4, kmeans_n_iters=2,
                                         pq_dim=8), t(_X))
    with pytest.raises(LogicError, match="do not fit"):
        ivf_pq.extend(pq, t(_X[:2]), t(np.array([1, BIG])))
    # A delete of an id past int32 cannot hit a slot: it would otherwise
    # wrap onto id BIG mod 2^32 = 0.
    e0 = idx.epoch
    assert lc.delete(idx, t(np.array([BIG], np.int64))) == 0
    assert idx.epoch == e0


def test_pq_int64_extend_search_refine():
    pq = ivf_pq.build(ivf_pq.IndexParams(
        n_lists=8, kmeans_n_iters=3, pq_dim=8, idx_dtype=torch.int64,
        add_data_on_build=False), t(_X))
    pq = ivf_pq.extend(pq, t(_X), t(BIG + np.arange(len(_X))))
    d, i = ivf_pq.search(ivf_pq.SearchParams(n_probes=8), pq, t(_Q), 5)
    assert i.dtype == torch.int64 and int(i.min()) >= BIG
    _, bi = brute_force.knn(t(_X), t(_Q), 5)
    assert recall(i - BIG, bi) >= 0.5
    # refine keeps int64 candidate ids (rows of the dataset).
    cand = torch.arange(40, dtype=torch.int64).repeat(len(_Q), 1)
    rd, ri = refine(t(_X), t(_Q), cand, 3)
    assert ri.dtype == torch.int64
    rd32, ri32 = refine(t(_X), t(_Q), cand.int(), 3)
    assert ri32.dtype == torch.int32
    assert torch.equal(ri, ri32.long()) and torch.equal(rd, rd32)


def test_mutations_keep_int64_ids_past_2_33(flat64):
    p = ivf_flat.index_from_numpy(
        n(flat64.centers), n(flat64.data), n(flat64.indices),
        n(flat64.list_sizes), 0, device="cpu")
    dels = BIG + np.arange(0, 300, 3)
    assert lc.delete(p, t(dels)) == 100
    up = BIG + np.array([0, 3, 10 ** 6])
    p = lc.upsert(p, t(_X[:3] + 1), t(up))
    assert p._next_id == BIG + 10 ** 6 + 1
    p = ivf_flat.extend(p, t(_X[:2]))
    assert int(p.indices.max()) == BIG + 10 ** 6 + 2
    for shrink in (False, True):
        c, rep = lc.compact(p, lc.CompactionPolicy(shrink_capacity=shrink))
        assert c.indices.dtype == torch.int64 and rep.reclaimed_slots
        _, i = ivf_flat.search(ivf_flat.SearchParams(n_probes=8), c,
                               t(_Q), 10)
        live = i[i >= 0]
        assert int(live.min()) >= BIG
        assert not np.isin(n(live), dels[2:]).any()


def test_searcher_cache_keeps_int32_and_int64_answers_apart():
    """An int32 index and its int64 copy at the same epoch, behind one
    shared ResultCache: neither's answer serves the other."""
    base = ivf_flat.build(ivf_flat.IndexParams(n_lists=8, kmeans_n_iters=3),
                          t(_X))
    wide = ivf_flat.index_from_numpy(
        n(base.centers), n(base.data), n(base.indices).astype(np.int64),
        n(base.list_sizes), 0, device="cpu")
    wide.epoch = base.epoch
    cache = serve.ResultCache(capacity=64)
    sp = ivf_flat.SearchParams(n_probes=3)
    grid = serve.BucketGrid.pow2(32, k_grid=(10,))
    pol = serve.BatchPolicy(max_batch=32, max_wait=0.0)
    out = {}
    for name, idx in (("narrow", base), ("wide", wide)):
        s = serve.Searcher.ivf_flat(idx, sp)
        assert s.id_dtype == idx.indices.dtype and s.epoch == base.epoch
        sched = serve.BatchScheduler(s, grid, pol, cache=cache)
        tk = sched.submit(_Q[:5], 10)
        sched.flush()
        out[name] = tk.result().indices
        sched.close()
    assert cache.hits == 0 and len(cache) == 2
    assert out["narrow"].dtype == np.int32 and out["wide"].dtype == np.int64
    np.testing.assert_array_equal(out["narrow"], out["wide"])
