"""Time the main path's kernels and entry points for the raft_tpu_torch
found at a given repository root.

    python3 tools/ab_main_path.py <repository root> [b1 | b2]

To compare two commits on one card, unpack the parent into a gitignored
directory (``git archive <parent> | tar -x -C build/parent``) and run, in
one go on one card, parent, change, change, parent::

    for r in build/parent . . build/parent; do
        python3 tools/ab_main_path.py $r; done

This script times every root, so a metric that an older root's copy of it
lacks is read on both. With ``b2`` it times B2's metrics alone (the
IVF-Flat search, ``b2*`` and ``u8_*`` below); with ``b1`` B1's alone
(``bf_ms``, the k=1 shapes, ``lloyd_1000_*``, ``req16_*``,
``graph_chunk_ms`` and ``b1_regs``), building B1's libraries only.

Each run builds that root's kernels, makes the 1M x 128 rows and 10,000
queries of its ``chip_smoke.py`` and prints one JSON line, times by CUDA
events (median) unless named ``_s``:

* ``bf_ms``: kernel B1 (``fused_knn``) at the brute-force shape (k=10,
  f32);
* ``train_32_f32_ms`` ... ``extend_1024_f32_ms``: B1 at the five k=1
  assignment shapes of the builds (the 500,000-row trainset against 32 and
  1024 centers, f32 and split-bf16; all 1M rows against 1024 centers,
  f32). The centers are every 1000th row: the time of a k=1 scan does not
  depend on where they lie;
* ``lloyd_1000_f32_ms``, ``lloyd_1000_bf16_ms``: B1 at Lloyd's shape,
  all 1M rows against 1000 centers (every 1000th row), k=1, f32 and
  split-bf16;
* ``req16_k10_ms``, ``req16_k100_ms``: B1's f32 tier at a 16-row request
  (the first 16 queries) against the 1M rows, k=10 and 100 (serving);
  ``req16_k10_device`` / ``req16_k100_device``: its device milliseconds
  by kernel (``torch.profiler``: the norm pre-pass, the scan, the slice
  merge);
* ``graph_chunk_ms``: one chunk of ``sparse.neighbors.knn_graph`` over
  the 1M rows (131,072 queries, k=16, f32), median of 2;
* ``b1_regs``: ptxas' [registers, spill store bytes] of each instance of
  B1's scans, by library and kernel name (``b1`` only);
* ``lloyd_fit_s``: ``kmeans.fit`` of the 1M rows, 1000 clusters from
  those centers (``InitMethod.Array``), ``max_iter`` 10 and ``tol`` 0 so
  that every root runs ten split-bf16 assignments and one f32, host
  clock around a synchronise;
* ``ivf_flat_build_s``, ``ivf_pq_build_s``: the first ``build`` of each
  index (1024 lists), host clock around a synchronise;
* ``search_ms``: the IVF-Flat search of the 10,000 queries at 32 probes;
* ``b2_ms``, ``b2_k1_ms``: kernel B2 (``fused_cells_knn``) alone at that
  search's cells (6024 cells x 64 rows, capacity 4096, d 128, k=10 and 1,
  f32); ``b2_device``, ``b2_k1_device``: its device milliseconds by kernel
  (``torch.profiler``: the pre-pass, the scan);
* ``b2_bf16_ms``, ``b2_split_ms``: B2's bf16 tier and its bf16 +
  split-query tier at those cells on a bf16 copy of the store;
* ``b2_f32_regs``: ptxas' registers (and spill bytes) of each instance
  of B2's f32-tier scan (the 3xTF32 scan, or the FMA scan in a root older
  than it), by kernel, query rows, store and selection;
* ``u8_search_ms``: the IVF-Flat search (``engine="bucketed"``) of
  phase 21 (a): 1000 queries at 32 probes on an index of chip_smoke.py's
  SIFT-shaped u8 rows (1M x 128, 1024 lists); ``u8_device_ms``,
  ``u8_copy_ms``: that search's device time and its copy kernels' by
  ``torch.profiler``; ``b2_u8_split_ms``: B2's split tier alone at that
  search's cells, on the u8 store where the root's B2 takes it, else on
  the bf16 copy its search makes (``b2_u8_store`` says which);
* ``select_10000x1024_k32_ms``, ``select_10000x320_k10_ms``: ``select_k``
  of a 10,000 x 1024 selection of 32 (the coarse probe) and a 10,000 x
  320 selection of 10 (the final merge);
* ``ivf_pq_search_ms``: the IVF-PQ compressed search of the 10,000
  queries at 32 probes (through kernel B4);
* ``b4_ms``: kernel B4 (``pq_fused_scan``) alone at that search's cells
  (6024 cells x 64 rows, capacity 4096, rot 128, k=10);
* ``recon_search_ms``: the IVF-PQ recon tier (``reconstructed()``, then
  ``engine="bucketed"``, ``bucket_cap=256``) on the first 1000 queries;
* ``b3_ms``: kernel B3 (``fused_batch_knn``) alone at that search's shape
  (1024 buckets of 256 query slots, ~31 live, against the (1024, 4096,
  128) bf16 cache, k=10), called as that root's engine calls it (with the
  buckets' live rows where the root's B3 takes them);
* ``b3_decode_ms``: B3 at one decode-scan launch (the first 32 lists,
  decoded), likewise;
* ``decode_search_ms``: the decode scan of those 1000 queries (the
  probes, the rotation, then 32 blocks of 32 lists decoded and scanned),
  as ``search`` runs it when the cache would be too large;
* ``b5_ms``: kernel B5 (``stream_extract``) alone on 1024 x 262,144
  Gaussian keys made on the card (the ``kAuto`` gate's high corner);
* ``select_1024x262144_k256_ms``: ``select_k`` through ``kAuto`` on those
  keys, k=256 (B5, the rank and the audit).
"""
import importlib
import inspect
import json
import re
import subprocess
import sys
import time

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from raft_tpu_torch.cluster import InitMethod, KMeansParams, kmeans  # noqa
from raft_tpu_torch.core.error import LogicError  # noqa: E402
from raft_tpu_torch.matrix.select_k import select_k  # noqa: E402
from raft_tpu_torch.distance.pairwise import gram  # noqa: E402
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq  # noqa: E402
from raft_tpu_torch.ops import _build  # noqa: E402
from raft_tpu_torch.ops import pq_scan as ps  # noqa: E402
from raft_tpu_torch.ops import stream_select as ss  # noqa: E402

fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")


def build_s(mod, X):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = mod.build(mod.IndexParams(n_lists=cs.N_LISTS), X)
    torch.cuda.synchronize()
    return index, time.perf_counter() - t0


def b2_f32_regs():
    """ptxas' [registers, spill store bytes] of each instance of B2's
    f32-tier scan, by "<kernel> <query rows> [<store>] <selection>": the
    3xTF32 scan (b2_tf32_kernel), or in a root older than it the FMA scan
    (b2_scan_kernel, whose names carry no store)."""
    sel = ("k=1", "network", "merge")
    regs = {}
    for lib, pat in (
            ("cells_tf32", r"(b2_tf32)_kernelILi(\d+)ELb([01])ELi(\d)E"),
            ("cells_knn", r"(b2_scan)_kernelILi(\d+)E(?:Lb0ELb0E)?()Li(\d)E")):
        name, spill = None, 0
        for line in _build.BUILD_LOG.get(lib, "").splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name, spill = m.group(1), 0
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            t = name and re.search(pat, name)
            if m and t:
                store = {"0": " f32", "1": " bf16", "": ""}[t.group(3)]
                regs[f"{t.group(1)} {t.group(2)}{store} "
                     f"{sel[int(t.group(4))]}"] = [int(m.group(1)), spill]
    return regs


def b1_regs():
    """ptxas' [registers, spill store bytes] of each B1 scan instance of
    the libraries built, by "<library> <kernel template arguments>"."""
    regs = {}
    for lib in ("fused_knn", "knn_tf32", "knn_mma"):
        name, spill = None, 0
        for line in _build.BUILD_LOG.get(lib, "").splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name, spill = m.group(1), 0
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            t = name and re.search(r"(b1_\w*?_kernel)I(\w*?)E+v", name)
            if m and t:
                regs[f"{lib} {t.group(1)} {t.group(2)}"] = [int(m.group(1)),
                                                            spill]
    return regs


def b1_metrics(out, X, Q):
    """B1's metrics: the brute-force shape, the k=1 shapes, a 16-row
    request and a knn_graph chunk."""
    out["bf_ms"] = cs.time_ms(
        lambda: fk._fused_knn_cuda(Q, X, cs.K, True, False, False), 5)
    T = X[::2][:cs.N_ROWS // 2].contiguous()
    C1024 = X[::1000][:cs.N_LISTS].contiguous()
    C32 = C1024[::cs.N_LISTS // 32].contiguous()
    for name, A, C, bf16 in (("train_32_f32", T, C32, False),
                             ("train_32_bf16", T, C32, True),
                             ("train_1024_f32", T, C1024, False),
                             ("train_1024_bf16", T, C1024, True),
                             ("extend_1024_f32", X, C1024, False)):
        out[name + "_ms"] = cs.time_ms(
            lambda: fk._fused_knn_cuda(A, C, 1, True, bf16, bf16), 5)
    del T
    C1000 = X[::1000][:1000].contiguous()
    for name, bf16 in (("lloyd_1000_f32", False), ("lloyd_1000_bf16", True)):
        out[name + "_ms"] = cs.time_ms(
            lambda: fk._fused_knn_cuda(X, C1000, 1, True, bf16, bf16), 5)
    Q16 = Q[:16].contiguous()
    for k in (10, 100):
        out[f"req16_k{k}_ms"] = cs.time_ms(
            lambda: fk._fused_knn_cuda(Q16, X, k, True, False, False), 21)
        out[f"req16_k{k}_device"] = device_by_kernel(
            lambda: fk._fused_knn_cuda(Q16, X, k, True, False, False), "b1_")
    out["graph_chunk_ms"] = cs.time_ms(
        lambda: fk._fused_knn_cuda(X[:131072], X, 16, True, False, False), 2)


def device_by_kernel(fn, scan: str, reps: int = 5):
    """Device milliseconds per call of ``fn`` by kernel, from one
    ``torch.profiler`` trace of ``reps`` calls: the norm pre-pass, the
    scan (kernels whose name holds ``scan``), the slice merge, anything
    else."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        key = ("norms" if "norms" in e.key else "merge" if "merge" in e.key
               else "scan" if scan in e.key else "other")
        out[key] = out.get(key, 0.0) + e.self_device_time_total / reps / 1e3
    return out


def b2_metrics(out, index, Q):
    """The B2 metrics at the main path's IVF-Flat search and phase 21
    (a)'s u8 search."""
    sp = ivf_flat.SearchParams(n_probes=cs.N_PROBES)
    out["search_ms"] = cs.time_ms(lambda: ivf_flat.search(sp, index, Q, cs.K),
                                  11)
    cells, bucket, _ = ivf_flat._invert_probe_map_cells(
        ivf_flat._coarse_probe(Q, index.centers, cs.N_PROBES, True),
        index.n_lists, ivf_flat._CELL_QROWS)
    Qc = Q[torch.clamp_min(bucket, 0)].contiguous()
    invalid = (torch.arange(index.data.shape[1], device=dev)[None, :]
               >= index.list_sizes[:, None]).contiguous()
    for name, k in (("b2", cs.K), ("b2_k1", 1)):
        out[name + "_ms"] = cs.time_ms(lambda: fk._fused_cells_knn_cuda(
            cells, Qc, index.data, invalid, k, True, False, False), 11)
        out[name + "_device"] = device_by_kernel(
            lambda: fk._fused_cells_knn_cuda(cells, Qc, index.data, invalid,
                                             k, True, False, False), "b2_")
    data16 = index.data.to(torch.bfloat16)
    for name, qsplit in (("b2_bf16_ms", False), ("b2_split_ms", True)):
        out[name] = cs.time_ms(lambda: fk._fused_cells_knn_cuda(
            cells, Qc, data16, invalid, cs.K, True, True, qsplit), 11)
    out["b2_f32_regs"] = b2_f32_regs()
    del Qc, data16

    db, q = cs.sift_rows_21()
    X8 = torch.as_tensor(db, device=dev)
    Q8 = torch.as_tensor(q, device=dev).float()
    flat = ivf_flat.build(ivf_flat.IndexParams(n_lists=cs.N_LISTS), X8)
    sp = ivf_flat.SearchParams(n_probes=cs.N_PROBES, engine="bucketed")
    out["u8_search_ms"] = cs.time_ms(
        lambda: ivf_flat.search(sp, flat, Q8, cs.K), 11)
    copy_ms, dev_ms, _ = cs.device_split_ms(
        lambda: ivf_flat.search(sp, flat, Q8, cs.K), "copy_kernel")
    out["u8_device_ms"], out["u8_copy_ms"] = dev_ms, copy_ms
    cells, bucket, _ = ivf_flat._invert_probe_map_cells(
        ivf_flat._coarse_probe(Q8, flat.centers, cs.N_PROBES, True),
        flat.n_lists, min(ivf_flat._CELL_QROWS, Q8.shape[0]))
    Qc = Q8[torch.clamp_min(bucket, 0)].contiguous()
    invalid = (torch.arange(flat.data.shape[1], device=dev)[None, :]
               >= flat.list_sizes[:, None]).contiguous()
    try:
        fk._fused_cells_knn_cuda(cells, Qc, flat.data, invalid, cs.K, True,
                                 True, True)
        store, out["b2_u8_store"] = flat.data, "uint8"
    except LogicError:
        store, out["b2_u8_store"] = flat.data.to(torch.bfloat16), "bf16"
    out["b2_u8_split_ms"] = cs.time_ms(lambda: fk._fused_cells_knn_cuda(
        cells, Qc, store, invalid, cs.K, True, True, True), 11)


dev = torch.device("cuda")
if sys.argv[2:] == ["b1"]:
    _build.build_all([n for n in ("fused_knn", "knn_tf32", "knn_mma")
                      if n in _build.sources()])
else:
    _build.build_all()
Xh, Qh = cs.make_data(cs.N_ROWS, cs.DIM, cs.N_BLOBS, cs.N_QUERIES)
X, Q = torch.as_tensor(Xh, device=dev), torch.as_tensor(Qh, device=dev)
del Xh, Qh
out = {"root": sys.argv[1],
       "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()}
if sys.argv[2:] == ["b1"]:
    b1_metrics(out, X, Q)
    out["b1_regs"] = b1_regs()
    print(json.dumps(out), flush=True)
    sys.exit(0)
if sys.argv[2:] == ["b2"]:
    index, out["ivf_flat_build_s"] = build_s(ivf_flat, X)
    b2_metrics(out, index, Q)
    print(json.dumps(out), flush=True)
    sys.exit(0)
b1_metrics(out, X, Q)
C1000 = X[::1000][:1000].contiguous()
torch.cuda.synchronize()
t0 = time.perf_counter()
kmeans.fit(KMeansParams(n_clusters=1000, init=InitMethod.Array, max_iter=10,
                        tol=0.0), X, centroids_init=C1000)
torch.cuda.synchronize()
out["lloyd_fit_s"] = time.perf_counter() - t0
index, out["ivf_flat_build_s"] = build_s(ivf_flat, X)
pq_index, out["ivf_pq_build_s"] = build_s(ivf_pq, X)
g = torch.Generator(device=dev)
g.manual_seed(1)
a = torch.randn((10000, 1024), generator=g, device=dev)
b = torch.randn((10000, 320), generator=g, device=dev)
b2_metrics(out, index, Q)
out["select_10000x1024_k32_ms"] = cs.time_ms(lambda: select_k(a, 32), 21)
out["select_10000x320_k10_ms"] = cs.time_ms(lambda: select_k(b, 10), 21)
sp_pq = ivf_pq.SearchParams(n_probes=cs.N_PROBES)
out["ivf_pq_search_ms"] = cs.time_ms(
    lambda: ivf_pq.search(sp_pq, pq_index, Q, cs.K), 11)
codesT, lo, hi, invalid, crot_p = pq_index.compressed_scan_operands()
J, bits = pq_index.pq_dim, pq_index.pq_bits
probes = ivf_pq._select_clusters(Q, pq_index.centers, cs.N_PROBES, False)
rotq_p = ps.permute_subspaces(gram(Q, pq_index.rotation_matrix), J, bits)
cell_list, bucket, _ = ivf_flat._invert_probe_map_cells(
    probes, pq_index.n_lists, ivf_flat._CELL_QROWS)
Qc = (rotq_p[torch.clamp_min(bucket, 0)]
      - crot_p[torch.clamp_min(cell_list, 0).long()][:, None, :]).contiguous()
out["b4_ms"] = cs.time_ms(lambda: ps._pq_fused_scan_cuda(
    cell_list, Qc, codesT, lo, hi, invalid, cs.K, J, bits, False), 11)
del Qc
Qs = Q[:cs.N_SUB]
recon = pq_index.reconstructed()
sp_r = ivf_pq.SearchParams(n_probes=cs.N_PROBES, engine="bucketed",
                           bucket_cap=cs.BUCKET_CAP)
out["recon_search_ms"] = cs.time_ms(
    lambda: ivf_pq.search(sp_r, pq_index, Qs, cs.K), 11)
bucket, _ = ivf_flat._invert_probe_map(
    ivf_pq._select_clusters(Qs, pq_index.centers, cs.N_PROBES, False),
    pq_index.n_lists, cs.BUCKET_CAP)
Qb = gram(Qs, pq_index.rotation_matrix)[torch.clamp_min(bucket, 0)]
invalid = (torch.arange(recon.shape[1], device=dev)[None, :]
           >= pq_index.list_sizes[:, None]).contiguous()
extra = ()
if "live_rows" in inspect.signature(fk._fused_batch_knn_cuda).parameters:
    extra = ((bucket >= 0).sum(1).to(torch.int32),)
out["b3_ms"] = cs.time_ms(lambda: fk._fused_batch_knn_cuda(
    Qb, recon, invalid, cs.K, True, True, False, *extra), 11)
blk = 32
drecon = ivf_pq._decode_lists_block(
    pq_index.pq_codes[:blk], pq_index.centers_rot()[:blk],
    pq_index.pq_centers.reshape(-1), J, 1 << bits, recon.shape[2] // J, bits,
    False)
dargs = (Qb[:blk].contiguous(), drecon, invalid[:blk].contiguous(), cs.K,
         True, True, False) + tuple(x[:blk].contiguous() for x in extra)
out["b3_decode_ms"] = cs.time_ms(lambda: fk._fused_batch_knn_cuda(*dargs),
                                 11)
del drecon, dargs


def decode_search():
    pr = ivf_pq._select_clusters(Qs, pq_index.centers, cs.N_PROBES, False)
    return ivf_pq._bucketed_decode_scan(
        gram(Qs, pq_index.rotation_matrix), pq_index.pq_codes,
        pq_index.pq_centers, pq_index.centers_rot(), pq_index.indices,
        pq_index.list_sizes, pr, cs.K, False, False, cs.BUCKET_CAP, J, bits,
        pq_index.deleted)


out["decode_search_ms"] = cs.time_ms(decode_search, 5)
keys = torch.randn((1024, 262144), generator=g, device=dev)
out["b5_ms"] = cs.time_ms(lambda: ss._stream_extract_cuda(keys), 11)
out["select_1024x262144_k256_ms"] = cs.time_ms(lambda: select_k(keys, 256),
                                               11)
print(json.dumps(out), flush=True)
