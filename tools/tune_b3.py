"""Build variants of kernel B3 and time them at its main-path shapes.

    python3 tools/tune_b3.py VARIANT [VARIANT ...]

A VARIANT is ``name[@dir]``: ``batch_knn.cu`` of the source directory
``dir`` (default ``raft_tpu_torch/csrc``) built with the package's nvcc
flags, all variants at once into ``build/tune_b3/``. A variant is an
edited copy of the sources::

    cp -r raft_tpu_torch/csrc build/v1   # then edit build/v1/batch_knn.cu
    python3 tools/tune_b3.py base v1@build/v1

A variant's candidate buffer (``B3_CAND`` in its source) sets the plan's
shared-memory count for it. Each variant is first held to the plain
version on integer data (ids and distances equal; k = 1, 10 and 17, live
rows and all rows), then timed by CUDA events (median of 5) on two sets
of operands made on the card: ``synth``, uniform lists from a seed (1024
buckets of 256 query slots with 10-52 live rows against 1024 bf16 lists
of capacity 4096 with 500-1454 valid rows, d 128), and ``real``, the
IVF-PQ recon tier's operands of ``chip_smoke.py``'s main path (1M x 128
rows from its seed, ``ivf_pq.build`` with 1024 lists, the first 1000
queries, 32 probes, 256-slot buckets with their live rows, the (1024,
4096, 128) bf16 cache, skewed as real lists are). For each: L2 at k = 10
and k = 1, one decode-scan launch (the first 32 lists) at k = 10, the
device times of the pre-pass and of the scan by ``torch.profiler``, and
the recon shape at k = 10 with 32 query rows a CTA. The script prints
ptxas' register and spill lines of the B3 scans and the card line.
"""
import ctypes
import importlib
import json
import re
import sys

import torch

from tune_common import ROOT, build, card_line, parse, time_ms

sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from raft_tpu_torch.distance.pairwise import gram  # noqa: E402
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq  # noqa: E402
from raft_tpu_torch.ops import _build  # noqa: E402

fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")


def use(path, src):
    lib = ctypes.CDLL(str(path))
    lib.fused_batch_knn_launch.argtypes = fk._BATCH_ARGTYPES
    lib.fused_batch_knn_launch.restype = ctypes.c_int
    fk._batch_lib = lambda: lib
    text = (src / "batch_knn.cu").read_text()
    fk.B3_CAND = int(re.search(r"B3_CAND = (\d+);", text).group(1))


def small_operands(g, dev):
    """Integer slabs for the exactness check: 12 slabs of 700 slots, 70
    query rows, d 48, 10-52 live rows."""
    db = torch.randint(0, 8, (12, 700, 48), generator=g, device=dev)
    q = torch.randint(0, 8, (12, 70, 48), generator=g, device=dev)
    sizes = torch.randint(100, 700, (12, 1), generator=g, device=dev)
    invalid = torch.arange(700, device=dev)[None, :] >= sizes
    live = torch.randint(10, 53, (12,), generator=g, device=dev)
    return (q.float().contiguous(), db.to(torch.bfloat16).contiguous(),
            invalid, live.to(torch.int32))


def synthetic_operands(g, dev):
    """Uniform lists, as tools/tune_b2.py and tune_b4.py use: 1024
    buckets of 256 query slots with 10-52 live rows, against 1024 bf16
    lists of capacity 4096 with 500-1454 valid rows, d 128 (Gaussian)."""
    db = torch.randn((1024, 4096, 128), generator=g, device=dev)
    q = torch.randn((1024, 256, 128), generator=g, device=dev)
    sizes = torch.randint(500, 1455, (1024, 1), generator=g, device=dev)
    invalid = torch.arange(4096, device=dev)[None, :] >= sizes
    live = torch.randint(10, 53, (1024,), generator=g, device=dev)
    return (q.contiguous(), db.to(torch.bfloat16).contiguous(), invalid,
            live.to(torch.int32))


def main_operands(dev):
    """The recon tier's B3 operands on the main path, and one decode-scan
    launch's (the first 32 lists, decoded)."""
    Xh, Qh = cs.make_data(cs.N_ROWS, cs.DIM, cs.N_BLOBS, cs.N_QUERIES)
    X, Q = torch.as_tensor(Xh, device=dev), torch.as_tensor(Qh, device=dev)
    index = ivf_pq.build(ivf_pq.IndexParams(n_lists=cs.N_LISTS), X)
    Qs = Q[:cs.N_SUB]
    recon = index.reconstructed()
    probes = ivf_pq._select_clusters(Qs, index.centers, cs.N_PROBES, False)
    bucket, _ = ivf_flat._invert_probe_map(probes, index.n_lists,
                                           cs.BUCKET_CAP)
    Qb = gram(Qs, index.rotation_matrix)[torch.clamp_min(bucket, 0)]
    invalid = (torch.arange(recon.shape[1], device=dev)[None, :]
               >= index.list_sizes[:, None]).contiguous()
    live = (bucket >= 0).sum(1).to(torch.int32)
    J, bits = index.pq_dim, index.pq_bits
    drecon = ivf_pq._decode_lists_block(
        index.pq_codes[:32], index.centers_rot()[:32],
        index.pq_centers.reshape(-1), J, 1 << bits, recon.shape[2] // J,
        bits, False)
    return ((Qb.contiguous(), recon, invalid, live),
            (Qb[:32].contiguous(), drecon, invalid[:32].contiguous(),
             live[:32].contiguous()))


def main():
    variants = [parse(s, _build.CSRC_DIR) for s in sys.argv[1:]]
    print(f"card: {card_line()}", flush=True)
    libs = build(variants, "batch_knn.cu", "b3_scan_kernel", "tune_b3",
                 _build.nvcc_path(), _build.NVCC_FLAGS)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    small = small_operands(g, dev)
    synth = synthetic_operands(g, dev)
    sets = (("synth", synth, tuple(x[:32].contiguous() for x in synth)),
            ("real",) + main_operands(dev))
    srcs = dict(variants)
    for name, path in libs.items():
        use(path, srcs[name])
        q, db, inv, live = small
        ok = True
        for k in (1, 10, 17):
            for lr in (live, None):
                kd, ki = fk._fused_batch_knn_cuda(q, db, inv, k, True, True,
                                                  False, lr)
                pd, pi = fk._fused_batch_knn_plain(q, db, inv, k, True, True,
                                                   False, lr)
                ok = ok and torch.equal(kd, pd) and torch.equal(ki, pi)
        res = {"variant": name, "exact_vs_plain": ok}
        for tag, (q, db, inv, live), decode in sets:
            for k in (10, 1):
                res[f"{tag}_recon_k{k}_ms"] = time_ms(
                    lambda: fk._fused_batch_knn_cuda(q, db, inv, k, True,
                                                     True, False, live))
            for part, what in (("prepass", "b2_norms_kernel"),
                               ("scan", "b3_scan_kernel")):
                res[f"{tag}_recon_k10_{part}_dev_ms"] = cs.device_ms(
                    lambda: fk._fused_batch_knn_cuda(q, db, inv, 10, True,
                                                     True, False, live),
                    what)
                res[f"{tag}_decode_k10_{part}_dev_ms"] = cs.device_ms(
                    lambda: fk._fused_batch_knn_cuda(*decode[:3], 10, True,
                                                     True, False, decode[3]),
                    what)
            res[f"{tag}_decode_k10_ms"] = time_ms(
                lambda: fk._fused_batch_knn_cuda(*decode[:3], 10, True, True,
                                                 False, decode[3]))
            # The same recon call at 32 query rows a CTA.
            rows, fk.B3_ROWS = fk.B3_ROWS, (32, 16)
            res[f"{tag}_recon_k10_bq32_ms"] = time_ms(
                lambda: fk._fused_batch_knn_cuda(q, db, inv, 10, True, True,
                                                 False, live))
            fk.B3_ROWS = rows
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
