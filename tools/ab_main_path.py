"""Time the main path's kernels and entry points for the raft_tpu_torch
found at a given repository root.

    python3 tools/ab_main_path.py <repository root>

To compare two commits on one card, unpack the parent into a gitignored
directory (``git archive <parent> | tar -x -C build/parent``) and run, in
one go on one card, parent, change, change, parent::

    for r in build/parent . . build/parent; do
        python3 tools/ab_main_path.py $r; done

This script times every root, so a metric that an older root's copy of it
lacks is read on both.

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
* ``ivf_flat_build_s``, ``ivf_pq_build_s``: the first ``build`` of each
  index (1024 lists), host clock around a synchronise;
* ``search_ms``: the IVF-Flat search of the 10,000 queries at 32 probes;
* ``b2_ms``: kernel B2 (``fused_cells_knn``) alone at that search's cells
  (6024 cells x 64 rows, capacity 4096, d 128, k=10, f32);
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
import inspect
import json
import subprocess
import sys
import time

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from raft_tpu_torch.matrix.select_k import select_k  # noqa: E402
from raft_tpu_torch.distance.pairwise import gram  # noqa: E402
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq  # noqa: E402
from raft_tpu_torch.ops import _build  # noqa: E402
from raft_tpu_torch.ops import fused_knn as fk  # noqa: E402
from raft_tpu_torch.ops import pq_scan as ps  # noqa: E402
from raft_tpu_torch.ops import stream_select as ss  # noqa: E402


def build_s(mod, X):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = mod.build(mod.IndexParams(n_lists=cs.N_LISTS), X)
    torch.cuda.synchronize()
    return index, time.perf_counter() - t0


dev = torch.device("cuda")
_build.build_all()
Xh, Qh = cs.make_data(cs.N_ROWS, cs.DIM, cs.N_BLOBS, cs.N_QUERIES)
X, Q = torch.as_tensor(Xh, device=dev), torch.as_tensor(Qh, device=dev)
del Xh, Qh
out = {"root": sys.argv[1],
       "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip(),
       "bf_ms": cs.time_ms(
           lambda: fk._fused_knn_cuda(Q, X, cs.K, True, False, False), 5)}
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
index, out["ivf_flat_build_s"] = build_s(ivf_flat, X)
pq_index, out["ivf_pq_build_s"] = build_s(ivf_pq, X)
sp = ivf_flat.SearchParams(n_probes=cs.N_PROBES)
g = torch.Generator(device=dev)
g.manual_seed(1)
a = torch.randn((10000, 1024), generator=g, device=dev)
b = torch.randn((10000, 320), generator=g, device=dev)
out["search_ms"] = cs.time_ms(lambda: ivf_flat.search(sp, index, Q, cs.K), 11)
cells, bucket, _ = ivf_flat._invert_probe_map_cells(
    ivf_flat._coarse_probe(Q, index.centers, cs.N_PROBES, True),
    index.n_lists, ivf_flat._CELL_QROWS)
Qc = Q[torch.clamp_min(bucket, 0)].contiguous()
invalid = (torch.arange(index.data.shape[1], device=dev)[None, :]
           >= index.list_sizes[:, None]).contiguous()
out["b2_ms"] = cs.time_ms(lambda: fk._fused_cells_knn_cuda(
    cells, Qc, index.data, invalid, cs.K, True, False, False), 11)
del Qc
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
