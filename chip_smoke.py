#!/usr/bin/env python3
"""Smoke run of the raft_tpu_torch port on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero and prints
no result line):

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every kernel under ``raft_tpu_torch/csrc`` with ``nvcc``;
3. kernel vs plain: B1 (``fused_knn``), B2 (``fused_cells_knn``), B3
   (``fused_batch_knn``) and B4 (``pq_fused_scan``) against their plain
   PyTorch versions on the card, on integer-valued data (ids and distances
   must be identical) and Gaussian data (distances within a stated
   tolerance);
4. the main path, with every launch counter set to 0 just before it and
   read just after: brute-force kNN of 10,000 queries against 1,000,000 x
   128 clustered rows (k=10, through B1), IVF-Flat build with 1024 lists
   (k-means assignments through B1) and IVF-Flat search with 32 probes
   (through B2) at recall@10 >= 0.995 against the brute-force result;
5. timings at the main-path shapes: each kernel, its plain version, and a
   library yardstick (``torch`` matmul + ``torch.topk``, which the port
   never calls), beside the kernel's bound on an H100 SXM; B1 is also held
   against its plain version at every k=1 assignment shape of the build
   (trainset x 32 and x 1024 centers on both tiers, rows x 1024 in f32);
6. the IVF-PQ path on the same rows and queries, the counters again set to
   0 before it and read after each step: build with 1024 lists (pq_dim 64,
   pq_bits 8), the compressed search with 32 probes (through B4, recall@10
   >= 0.80 against brute force), the LUT-scan engine and the recon tier
   (``reconstructed()`` then ``engine="bucketed"``, ``bucket_cap=256``,
   through B3) on the first 1000 queries, each within 0.01 of the
   compressed tier's recall there, and the decode scan (B3), whose ids
   must equal the recon tier's; then B3 and B4 held against their plain
   versions and timed at those shapes;
7. a ``kernels`` line, the card line, and the result line.

The data is made with numpy from a fixed seed: 1000 Gaussian blobs
(centers uniform in [-10, 10], sigma 5), queries = database rows + N(0, 1).
The script imports neither JAX nor raft_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 5
N_ROWS = 1_000_000
DIM = 128
N_BLOBS = 1000
BLOB_STD = 5.0
N_QUERIES = 10_000
K = 10
N_LISTS = 1024
N_PROBES = 32
RECALL_BF = 0.999
RECALL_IVF = 0.995
RECALL_PQ = 0.80          # compressed tier against brute force
RECALL_PQ_V5E = 0.864     # BENCH_r05, TPU v5e, same shape (for reference)
PQ_TIER_GAP = 0.01        # LUT scan and recon tier against compressed
N_SUB = 1000              # queries of the LUT-scan and recon-tier steps
BUCKET_CAP = 256

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

# Expanded-L2 cancellation: |q|^2 + |y|^2 - 2 q.y carries f32 rounding of
# the norms' size, summed in another order by the kernel and by cuBLAS.
# Gaussian comparisons allow 2e-6 of the largest |q|^2 + |y|^2 (about 32
# f32 ulps of it); integer-valued data must agree exactly.
REL_NORM_TOL = 2e-6


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_data(n_rows, dim, n_blobs, n_queries, seed=SEED):
    """Clustered rows and queries (rows + unit noise), as float32 numpy."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10.0, 10.0, (n_blobs, dim)).astype(np.float32)
    labels = rng.permutation(np.arange(n_rows) % n_blobs)
    X = centers[labels]
    X += BLOB_STD * rng.standard_normal((n_rows, dim), dtype=np.float32)
    Q = X[:n_queries] + rng.standard_normal((n_queries, dim),
                                            dtype=np.float32)
    return X, Q


def recall(found, truth) -> float:
    """Mean share of each row of ``truth`` that ``found`` contains."""
    hit = (found[:, :, None] == truth[:, None, :]).any(dim=2)
    return float(hit.float().mean())


def norm_tol(q, y) -> float:
    import torch

    qn = float(torch.max(torch.sum(q.float() ** 2, dim=-1)))
    yn = float(torch.max(torch.sum(y.float() ** 2, dim=-1)))
    return REL_NORM_TOL * (qn + yn)


def max_err(a, b) -> float:
    """Largest |a - b| over entries finite in both; the inf patterns must
    agree."""
    import torch

    ia, ib = torch.isinf(a), torch.isinf(b)
    if not torch.equal(ia, ib):
        raise AssertionError("inf patterns differ")
    fin = ~ia
    if not bool(fin.any()):
        return 0.0
    return float(torch.max(torch.abs(a[fin] - b[fin])))


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn()`` by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_kernels(dev) -> None:
    """Phase 3: both kernels against their plain versions on the card."""
    import torch

    from raft_tpu_torch.ops import fused_knn as fk

    rng = np.random.default_rng(SEED)
    for m, n, d, k in ((37, 1000, 32, 1), (100, 5000, 128, 10),
                       (64, 3001, 64, 256), (33, 129, 128, 129)):
        for integer in (True, False):
            if integer:
                q = rng.integers(0, 8, (m, d)).astype(np.float32)
                y = rng.integers(0, 8, (n, d)).astype(np.float32)
            else:
                q = rng.standard_normal((m, d), dtype=np.float32)
                y = rng.standard_normal((n, d), dtype=np.float32)
            qt, yt = torch.as_tensor(q, device=dev), torch.as_tensor(y,
                                                                      device=dev)
            for metric in ("l2", "ip"):
                for bf16, qsplit in ((False, False), (True, False),
                                     (True, True)):
                    kd, ki = fk._fused_knn_cuda(qt, yt, k, metric == "l2",
                                                bf16, qsplit)
                    pd, pi = fk._fused_knn_plain(qt, yt, k, metric == "l2",
                                                 bf16, qsplit)
                    torch.cuda.synchronize()
                    tag = (f"B1 m={m} n={n} d={d} k={k} {metric} "
                           f"bf16={bf16} qsplit={qsplit} "
                           f"{'int' if integer else 'gauss'}")
                    if integer:
                        ok = torch.equal(ki, pi) and torch.equal(kd, pd)
                        err = max_err(kd, pd)
                    else:
                        err = max_err(kd, pd)
                        ok = err <= norm_tol(qt, yt)
                    if not ok:
                        raise AssertionError(f"{tag}: kernel != plain "
                                             f"(max err {err})")
        log(f"B1 ok m={m} n={n} d={d} k={k} (l2/ip, f32/bf16/qsplit, "
            f"int exact / gauss max err within tol)")

    for L, cap, d, C, qrows, k in ((6, 300, 32, 9, 64, 10),
                                   (5, 129, 128, 7, 8, 256),
                                   (4, 2048, 128, 6, 64, 1)):
        db = rng.integers(0, 8, (L, cap, d)).astype(np.float32)
        invalid = rng.random((L, cap)) < 0.3
        invalid[1, :] = True            # an empty list
        invalid[2, 3:] = True           # a starved list: 3 valid rows < k
        cells = rng.integers(-1, L, C).astype(np.int32)
        cells[0], cells[1], cells[-1] = 1, 2, -1
        q = rng.integers(0, 8, (C, qrows, d)).astype(np.float32)
        args = [torch.as_tensor(a, device=dev)
                for a in (cells, q, db, invalid)]
        for bf16_db in (False, True):
            a = list(args)
            if bf16_db:
                a[2] = a[2].to(torch.bfloat16)
            for l2 in (True, False):
                kd, ki = fk._fused_cells_knn_cuda(*a, k, l2, bf16_db,
                                                  bf16_db)
                pd, pi = fk._fused_cells_knn_plain(*a, k, l2, bf16_db,
                                                   bf16_db)
                torch.cuda.synchronize()
                if not (torch.equal(ki, pi) and torch.equal(kd, pd)):
                    raise AssertionError(
                        f"B2 L={L} cap={cap} d={d} k={k} l2={l2} "
                        f"bf16_db={bf16_db}: kernel != plain")
            if k > 3 and not bool((ki[1, :, 3:] == -1).all()):
                raise AssertionError("B2 starved list did not report -1")
        log(f"B2 ok L={L} cap={cap} d={d} cells={C} qrows={qrows} k={k} "
            f"(-1 cells, masks, starved list, f32/bf16 db, l2/ip)")


def _pq_case(rng, bits, integer=True, J=64, L=2, cap=1500, n_cells=9,
             qrows=64):
    """B4 operands: codes of 6 lists (an empty one, a starved one with 5
    valid slots), n_cells cells (one -1). Integer books put a +-127 entry
    in every table row, so the int8 tables dequantize to the same
    integers (scale 1)."""
    import torch

    from raft_tpu_torch.neighbors import ivf_pq

    B = 1 << bits
    if integer:
        books = rng.integers(-3, 4, (J, B, L)).astype(np.float32)
        books[:, 0, :] = 127.0
        books[:, B // 2, :] = -127.0
        q = rng.integers(-4, 5, (n_cells, qrows, J * L)).astype(np.float32)
    else:
        books = rng.standard_normal((J, B, L)).astype(np.float32)
        q = rng.standard_normal((n_cells, qrows, J * L)).astype(np.float32)
    codes = rng.integers(0, B, (6, cap, J)).astype(np.int32)
    packed = ivf_pq.pack_codes(torch.as_tensor(codes), bits).numpy()
    codesT = np.ascontiguousarray(packed.transpose(0, 2, 1))
    invalid = rng.random((6, cap)) < 0.2
    invalid[1, :] = True
    invalid[3, 5:] = True
    cells = rng.integers(0, 6, n_cells).astype(np.int32)
    cells[0], cells[1], cells[2] = 1, 3, -1
    return books, cells, q, codesT, invalid


def check_kernels_b3_b4(dev) -> None:
    """Phase 3 for B3 and B4: kernel against plain version on the card."""
    import torch

    from raft_tpu_torch.ops import fused_knn as fk
    from raft_tpu_torch.ops import pq_scan as ps

    rng = np.random.default_rng(SEED + 1)
    # B3: n > the reference's 2048-row db tile (2500, 3001) and ragged
    # (3001, 129); an empty slab (1) and a starved one (2: 3 valid rows).
    for B, m, nn, d, k in ((6, 37, 2500, 64, 10), (5, 70, 3001, 128, 256),
                           (4, 9, 129, 32, 1)):
        q = rng.integers(0, 8, (B, m, d)).astype(np.float32)
        db = rng.integers(0, 8, (B, nn, d)).astype(np.float32)
        invalid = rng.random((B, nn)) < 0.3
        invalid[1, :] = True
        invalid[2, 3:] = True
        qt, dbt, inv = (torch.as_tensor(a, device=dev)
                        for a in (q, db, invalid))
        for l2 in (True, False):
            for bf16, qsplit in ((False, False), (True, False),
                                 (True, True)):
                y = dbt.to(torch.bfloat16) if bf16 else dbt
                kd, ki = fk._fused_batch_knn_cuda(qt, y, inv, k, l2, bf16,
                                                  qsplit)
                pd, pi = fk._fused_batch_knn_plain(qt, y, inv, k, l2, bf16,
                                                   qsplit)
                torch.cuda.synchronize()
                if not (torch.equal(ki, pi) and torch.equal(kd, pd)):
                    raise AssertionError(
                        f"B3 B={B} m={m} n={nn} d={d} k={k} l2={l2} "
                        f"bf16={bf16} qsplit={qsplit}: kernel != plain")
        if not bool((ki[1] == -1).all()) or (k > 3 and not bool(
                (ki[2, :, 3:] == -1).all())):
            raise AssertionError("B3 empty/starved slab did not report -1")
        log(f"B3 ok B={B} m={m} n={nn} d={d} k={k} (l2/ip, f32/bf16/qsplit, "
            f"empty and starved slabs, bit-identical)")

    # B4 on integer codebooks and queries: bit-identical.
    for bits in (4, 8):
        for k in (1, 10, 256):
            books, cells, q, codesT, invalid = _pq_case(rng, bits)
            ops = [torch.as_tensor(a, device=dev)
                   for a in (cells, q, codesT, invalid)]
            for int8 in (False, True):
                tabs = [x.to(dev) for x in ps.book_tables(
                    torch.as_tensor(books), bits, int8=int8)]
                scale = tabs[2] if int8 else None
                for is_ip in (False, True):
                    args = (ops[0], ops[1], ops[2], tabs[0], tabs[1],
                            ops[3], k, 64, bits, is_ip, scale)
                    kd, ki = ps._pq_fused_scan_cuda(*args)
                    pd, pi = ps._pq_fused_scan_plain(*args)
                    torch.cuda.synchronize()
                    if not (torch.equal(ki, pi) and torch.equal(kd, pd)):
                        raise AssertionError(
                            f"B4 bits={bits} k={k} int8={int8} "
                            f"ip={is_ip}: kernel != plain")
                    if not (bool((ki[0] == -1).all())
                            and bool((ki[2] == -1).all())
                            and (k <= 5 or bool((ki[1, :, 5:] == -1)
                                                .all()))):
                        raise AssertionError("B4 sentinels missing")
            log(f"B4 ok bits={bits} k={k} (l2/ip, f32/int8 tables, -1 cell, "
                f"empty and starved lists, bit-identical)")

    # B4 on Gaussian data: within 2e-6 of the largest |q|^2 + |cw|^2.
    books, cells, q, codesT, invalid = _pq_case(rng, 8, integer=False)
    ops = [torch.as_tensor(a, device=dev) for a in (cells, q, codesT,
                                                    invalid)]
    lo, hi = (x.to(dev) for x in ps.book_tables(torch.as_tensor(books), 8))
    table = torch.cat([lo[0], hi[0]], dim=1)
    tol = REL_NORM_TOL * (float(torch.max(torch.sum(ops[1] ** 2, dim=-1)))
                          + float(torch.sum(torch.amax(table ** 2, dim=1))))
    for is_ip in (False, True):
        args = (ops[0], ops[1], ops[2], lo, hi, ops[3], 10, 64, 8, is_ip)
        kd, ki = ps._pq_fused_scan_cuda(*args)
        pd, pi = ps._pq_fused_scan_plain(*args)
        err = max_err(kd, pd)
        agree = float((ki == pi).float().mean())
        log(f"B4 gauss ip={is_ip}: max |d| err {err:.3e} (tol {tol:.3e}), "
            f"id agreement {agree:.6f}")
        if err > tol or agree < RECALL_BF:
            raise AssertionError("B4 Gaussian disagrees with plain")


def main_path(dev, X, Q):
    """Phase 4: the port's main path through its user entry points, with
    the launch counters read around it. Returns what phase 5 needs."""
    import torch

    from raft_tpu_torch.neighbors import brute_force, ivf_flat
    from raft_tpu_torch.ops import fused_knn as fk

    fk.fused_knn.launches = 0
    fk.fused_cells_knn.launches = 0
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    bf_d, bf_i = brute_force.knn(X, Q, K)
    torch.cuda.synchronize()
    bf_s = time.perf_counter() - t0
    bf_launches = fk.fused_knn.launches

    t0 = time.perf_counter()
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=N_LISTS), X)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = fk.fused_knn.launches - bf_launches

    sp = ivf_flat.SearchParams(n_probes=N_PROBES)
    t0 = time.perf_counter()
    iv_d, iv_i = ivf_flat.search(sp, index, Q, K)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0

    launches = {"fused_knn": fk.fused_knn.launches,
                "fused_cells_knn": fk.fused_cells_knn.launches}
    log(f"main path: brute force {bf_s:.3f} s ({bf_launches} B1 launch), "
        f"IVF-Flat build {build_s:.3f} s ({build_launches} B1 launches), "
        f"first search {search_s:.3f} s "
        f"({launches['fused_cells_knn']} B2 launch)")
    if bf_launches < 1 or build_launches < 1 \
            or launches["fused_cells_knn"] < 1:
        raise AssertionError(f"a kernel of the main path did not launch: "
                             f"{launches}")

    for name, t in (("bf", bf_d), ("ivf", iv_d)):
        if not bool(torch.isfinite(t).all()) or t.shape != (N_QUERIES, K):
            raise AssertionError(f"{name} distances not finite (q, k)")
    rec = recall(iv_i, bf_i)
    log(f"IVF-Flat recall@{K} vs brute force: {rec:.6f} "
        f"(bar {RECALL_IVF})")
    if rec < RECALL_IVF:
        raise AssertionError(f"IVF-Flat recall {rec} < {RECALL_IVF}")

    search_ms = time_ms(lambda: ivf_flat.search(sp, index, Q, K), reps=5)
    log(f"IVF-Flat search: {search_ms:.3f} ms per {N_QUERIES} queries = "
        f"{N_QUERIES / search_ms * 1e3:.1f} QPS (n_probes={N_PROBES}, "
        f"k={K})")
    log(f"IVF-Flat build: {build_s:.3f} s (n_lists={N_LISTS}, first call)")
    return {"bf": (bf_d, bf_i), "index": index, "launches": launches}


def b1_entry(dev, X, Q, bf):
    """Phase 5 for B1 at the brute-force shape."""
    import torch

    from raft_tpu_torch.ops import fused_knn as fk

    m, n, d = Q.shape[0], X.shape[0], X.shape[1]
    pd, pi = fk._fused_knn_plain(Q, X, K, True, False, False)
    kd, ki = bf
    err = max_err(kd, pd)
    rec = recall(ki, pi)
    log(f"B1 vs plain at main path: recall@{K} {rec:.6f} (bar {RECALL_BF}), "
        f"max |d| err {err:.3e} (tol {norm_tol(Q, X):.3e})")
    if rec < RECALL_BF or err > norm_tol(Q, X):
        raise AssertionError("B1 disagrees with its plain version")

    ms = time_ms(lambda: fk._fused_knn_cuda(Q, X, K, True, False, False), 5)
    plain_ms = time_ms(
        lambda: fk._fused_knn_plain(Q, X, K, True, False, False), 2)
    yn = torch.sum(X * X, dim=1)
    chunk = 2500

    def library():
        for s in range(0, m, chunk):
            g = torch.addmm(yn, Q[s:s + chunk], X.t(), alpha=-2.0)
            torch.topk(g, K, dim=1, largest=False)

    lib_ms = time_ms(library, 3)
    ops = 2.0 * m * n * d
    nbytes = 4.0 * (m * d + n * d) + 8.0 * m * K
    bound = max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
    log(f"B1 timing m={m} n={n} d={d} k={K}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, library (addmm + topk over {-(-m // chunk)} "
        f"query chunks) {lib_ms:.3f} ms, bound {bound:.3f} ms (FP32 ops)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if ops / PEAK_FP32 >= nbytes / PEAK_BYTES
            else "bytes", "library_ms": lib_ms}


def b1_kmeans_shape(dev, X, centers):
    """B1 at the k=1 assignment shapes of the IVF-Flat build, each held
    against its plain version: the trainset (half the rows) against the
    32 mesocluster-sized and the 1024 list-sized center sets on the f32 and
    split-bf16 tiers (the balancing EM runs both), and every row against
    the 1024 centers in f32 (the extend assignment). Arg-min agreement must
    reach RECALL_BF and the distances agree within ``norm_tol``."""
    import torch

    from raft_tpu_torch.ops import fused_knn as fk

    T = X[::2][:N_ROWS // 2].contiguous()
    C1024 = centers.contiguous()
    C32 = centers[::N_LISTS // 32].contiguous()
    cases = [("train", T, C32, "f32", False),
             ("train", T, C32, "split-bf16", True),
             ("train", T, C1024, "f32", False),
             ("train", T, C1024, "split-bf16", True),
             ("extend", X, C1024, "f32", False)]
    for what, A, C, tier, bf16 in cases:
        m, n, d = A.shape[0], C.shape[0], C.shape[1]
        kd, ki = fk._fused_knn_cuda(A, C, 1, True, bf16, bf16)
        pd, pi = fk._fused_knn_plain(A, C, 1, True, bf16, bf16)
        torch.cuda.synchronize()
        agree = float((ki == pi).float().mean())
        err = max_err(kd, pd)
        tol = norm_tol(A, C)
        tag = f"B1 k-means {what} m={m} n={n} d={d} k=1 {tier}"
        log(f"{tag}: arg-min agreement {agree:.6f} (bar {RECALL_BF}), max "
            f"|d| err {err:.3e} (tol {tol:.3e})")
        if agree < RECALL_BF or err > tol:
            raise AssertionError(f"{tag}: kernel disagrees with plain")
        del kd, ki, pd, pi
        ms = time_ms(lambda: fk._fused_knn_cuda(A, C, 1, True, bf16, bf16),
                     5)
        ops = 2.0 * m * n * d * (2 if bf16 else 1)
        peak = PEAK_BF16 if bf16 else PEAK_FP32
        nbytes = 4.0 * (m * d + n * d) + 8.0 * m
        bound = max(ops / peak, nbytes / PEAK_BYTES) * 1e3
        log(f"{tag}: kernel {ms:.3f} ms, bound {bound:.3f} ms")


def b2_entry(dev, Q, index):
    """Phase 5 for B2 at the IVF-Flat search shape."""
    import torch

    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import fused_knn as fk

    qrows = ivf_flat._CELL_QROWS
    probes = ivf_flat._coarse_probe(Q, index.centers, N_PROBES, True)
    cell_list, bucket, _ = ivf_flat._invert_probe_map_cells(
        probes, index.n_lists, qrows)
    Qc = Q[torch.clamp_min(bucket, 0)].contiguous()
    cap = index.data.shape[1]
    invalid = (torch.arange(cap, device=dev)[None, :]
               >= index.list_sizes[:, None]).contiguous()
    data = index.data
    args = (cell_list, Qc, data, invalid)

    kd, ki = fk._fused_cells_knn_cuda(*args, K, True, False, False)
    pd, pi = fk._fused_cells_knn_plain(*args, K, True, False, False)
    err = max_err(kd, pd)
    live = cell_list >= 0
    rec = recall(ki[live].reshape(-1, K), pi[live].reshape(-1, K))
    log(f"B2 vs plain at main path: per-slot recall@{K} {rec:.6f}, max |d| "
        f"err {err:.3e} (tol {norm_tol(Q, data):.3e})")
    if rec < RECALL_BF or err > norm_tol(Q, data):
        raise AssertionError("B2 disagrees with its plain version")

    ms = time_ms(lambda: fk._fused_cells_knn_cuda(*args, K, True, False,
                                                  False), 5)
    plain_ms = time_ms(lambda: fk._fused_cells_knn_plain(*args, K, True,
                                                         False, False), 2)
    dn = torch.sum(data * data, dim=2)
    step = 512

    def library():
        for s in range(0, cell_list.shape[0], step):
            lst = torch.clamp_min(cell_list[s:s + step], 0).long()
            g = torch.baddbmm(dn[lst][:, None, :], Qc[s:s + step],
                              data[lst].transpose(1, 2), alpha=-2.0)
            g.masked_fill_(invalid[lst][:, None, :], float("inf"))
            torch.topk(g, K, dim=2, largest=False)

    lib_ms = time_ms(library, 3)

    sizes = index.list_sizes.long()
    used = torch.unique(cell_list[live].long())
    pair_rows = float(torch.sum(sizes[probes.long()]))
    ops = 2.0 * DIM * pair_rows
    nbytes = (4.0 * Qc.numel() + 4.0 * DIM * float(torch.sum(sizes[used]))
              + float(used.numel() * cap) + 4.0 * cell_list.numel()
              + 8.0 * kd.numel())
    bound = max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
    log(f"B2 timing cells={cell_list.shape[0]} (used {int(live.sum())}) "
        f"qrows={qrows} cap={cap} d={DIM} k={K}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, library (gather + baddbmm + topk over "
        f"{step}-cell chunks) {lib_ms:.3f} ms, bound {bound:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if ops / PEAK_FP32 >= nbytes / PEAK_BYTES
            else "bytes", "library_ms": lib_ms}


def _launches():
    from raft_tpu_torch.ops import fused_knn as fk
    from raft_tpu_torch.ops import pq_scan as ps

    return {"fused_knn": fk.fused_knn.launches,
            "fused_cells_knn": fk.fused_cells_knn.launches,
            "fused_batch_knn": fk.fused_batch_knn.launches,
            "pq_fused_scan": ps.pq_fused_scan.launches}


def _step(before):
    """Launches of each kernel since ``before``."""
    now = _launches()
    return {k: now[k] - before[k] for k in now}


def pq_path(dev, X, Q, bf_i):
    """Phase 6: the IVF-PQ path through its entry points, with the launch
    counters set to 0 before it and read around each step."""
    import torch

    from raft_tpu_torch.distance.pairwise import gram
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import fused_knn as fk
    from raft_tpu_torch.ops import pq_scan as ps

    for fn in (fk.fused_knn, fk.fused_cells_knn, fk.fused_batch_knn,
               ps.pq_fused_scan):
        fn.launches = 0
    torch.cuda.synchronize()
    steps = {}

    before = _launches()
    t0 = time.perf_counter()
    index = ivf_pq.build(ivf_pq.IndexParams(n_lists=N_LISTS), X)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    steps["build"] = _step(before)

    sp = ivf_pq.SearchParams(n_probes=N_PROBES)
    before = _launches()
    t0 = time.perf_counter()
    cd, ci = ivf_pq.search(sp, index, Q, K)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    steps["compressed"] = _step(before)
    if not bool(torch.isfinite(cd).all()) or cd.shape != (N_QUERIES, K):
        raise AssertionError("IVF-PQ distances not finite (q, k)")
    rec = recall(ci, bf_i)
    log(f"IVF-PQ build {build_s:.3f} s (n_lists={N_LISTS}, pq_dim "
        f"{index.pq_dim}, pq_bits {index.pq_bits}, cap "
        f"{index.pq_codes.shape[1]}, first call); compressed search recall@"
        f"{K} vs brute force {rec:.6f} (bar {RECALL_PQ}; TPU v5e "
        f"{RECALL_PQ_V5E}), first search {first_s:.3f} s")
    if rec < RECALL_PQ:
        raise AssertionError(f"IVF-PQ recall {rec} < {RECALL_PQ}")
    search_ms = time_ms(lambda: ivf_pq.search(sp, index, Q, K), reps=5)
    log(f"IVF-PQ compressed search: {search_ms:.3f} ms per {N_QUERIES} "
        f"queries = {N_QUERIES / search_ms * 1e3:.1f} QPS")

    Qs, truth = Q[:N_SUB], bf_i[:N_SUB]
    rec_c = recall(ci[:N_SUB], truth)
    before = _launches()
    t0 = time.perf_counter()
    _, li = ivf_pq.search(ivf_pq.SearchParams(n_probes=N_PROBES,
                                              engine="scan"), index, Qs, K)
    torch.cuda.synchronize()
    lut_s = time.perf_counter() - t0
    steps["lut_scan"] = _step(before)
    rec_l = recall(li, truth)

    t0 = time.perf_counter()
    index.reconstructed()
    torch.cuda.synchronize()
    recon_s = time.perf_counter() - t0
    sp_r = ivf_pq.SearchParams(n_probes=N_PROBES, engine="bucketed",
                               bucket_cap=BUCKET_CAP)
    before = _launches()
    t0 = time.perf_counter()
    _, ri = ivf_pq.search(sp_r, index, Qs, K)
    torch.cuda.synchronize()
    recon_search_s = time.perf_counter() - t0
    steps["recon"] = _step(before)
    rec_r = recall(ri, truth)
    recon_ms = time_ms(lambda: ivf_pq.search(sp_r, index, Qs, K), reps=5)

    probes = ivf_pq._select_clusters(Qs, index.centers, N_PROBES, False)
    rotq = gram(Qs, index.rotation_matrix)
    before = _launches()
    t0 = time.perf_counter()
    _, di = ivf_pq._bucketed_decode_scan(
        rotq, index.pq_codes, index.pq_centers, index.centers_rot(),
        index.indices, index.list_sizes, probes, K, False, False,
        BUCKET_CAP, index.pq_dim, index.pq_bits, index.deleted)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    steps["decode_scan"] = _step(before)

    log(f"first {N_SUB} queries: recall@{K} compressed {rec_c:.6f}, LUT "
        f"scan {rec_l:.6f} ({lut_s:.3f} s), recon tier {rec_r:.6f} (cache "
        f"{recon_s:.3f} s, first search {recon_search_s:.3f} s, then "
        f"{recon_ms:.3f} ms), decode scan {decode_s:.3f} s")
    log(f"IVF-PQ launches per step: {steps}")
    if abs(rec_l - rec_c) > PQ_TIER_GAP or abs(rec_r - rec_c) > PQ_TIER_GAP:
        raise AssertionError(f"tier recalls differ by more than "
                             f"{PQ_TIER_GAP}: compressed {rec_c}, LUT scan "
                             f"{rec_l}, recon {rec_r}")
    if not torch.equal(di, ri):
        raise AssertionError("decode scan ids differ from the recon tier's")
    if (steps["build"]["fused_knn"] < 1
            or steps["compressed"]["pq_fused_scan"] < 1
            or steps["recon"]["fused_batch_knn"] < 1
            or steps["decode_scan"]["fused_batch_knn"] < 1):
        raise AssertionError(f"a kernel of the IVF-PQ path did not launch: "
                             f"{steps}")
    total = {k: sum(st[k] for st in steps.values())
             for k in steps["build"]}
    return {"index": index, "launches": total, "search_ms": search_ms,
            "probes_sub": probes, "rotq_sub": rotq}


def b4_entry(dev, Q, index, search_ms):
    """Phase 6 timings for B4 at the compressed-search shape."""
    import torch

    from raft_tpu_torch.distance.pairwise import gram
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
    from raft_tpu_torch.ops import fused_knn as fk
    from raft_tpu_torch.ops import pq_scan as ps

    codesT, lo, hi, invalid, crot_p = index.compressed_scan_operands()
    J, bits = index.pq_dim, index.pq_bits
    probes = ivf_pq._select_clusters(Q, index.centers, N_PROBES, False)
    rotq_p = ps.permute_subspaces(gram(Q, index.rotation_matrix), J, bits)
    cell_list, bucket, _ = ivf_flat._invert_probe_map_cells(
        probes, index.n_lists, ivf_flat._CELL_QROWS)
    safe = torch.clamp_min(cell_list, 0).long()
    Qc = (rotq_p[torch.clamp_min(bucket, 0)]
          - crot_p[safe][:, None, :]).contiguous()
    args = (cell_list, Qc, codesT, lo, hi, invalid, K, J, bits, False)

    kd, ki = ps._pq_fused_scan_cuda(*args)
    pd, pi = ps._pq_fused_scan_plain(*args)
    table = torch.cat([lo[0], hi[0]], dim=1)
    tol = REL_NORM_TOL * (float(torch.max(torch.sum(Qc ** 2, dim=-1)))
                          + float(torch.sum(torch.amax(table ** 2, dim=1))))
    err = max_err(kd, pd)
    live = cell_list >= 0
    rec = recall(ki[live].reshape(-1, K), pi[live].reshape(-1, K))
    log(f"B4 vs plain at main path: per-slot recall@{K} {rec:.6f}, max |d| "
        f"err {err:.3e} (tol {tol:.3e})")
    if rec < RECALL_BF or err > tol:
        raise AssertionError("B4 disagrees with its plain version")

    ms = time_ms(lambda: ps._pq_fused_scan_cuda(*args), 5)
    plain_ms = time_ms(lambda: ps._pq_fused_scan_plain(*args), 2)
    step = 128

    def library():
        for s in range(0, cell_list.shape[0], step):
            lst = safe[s:s + step]
            cw = ps.decode_codewords(codesT[lst], table, J, bits)
            cwn = torch.sum(cw * cw, dim=1)[:, None, :]
            g = torch.baddbmm(cwn.to(torch.bfloat16),
                              Qc[s:s + step].to(torch.bfloat16),
                              cw.to(torch.bfloat16), alpha=-2.0)
            g.masked_fill_(invalid[lst][:, None, :], float("inf"))
            torch.topk(g, K, dim=2, largest=False)

    lib_ms = time_ms(library, 3)
    # The same cells through B2's bf16 tier over the reconstruction cache:
    # the same tile loop and product, with rows read instead of decoded.
    recon = index.reconstructed()
    b2_ms = time_ms(lambda: fk._fused_cells_knn_cuda(
        cell_list, Qc, recon, invalid[:, :recon.shape[1]].contiguous(), K,
        True, True, False), 5)
    sizes = index.list_sizes.long()
    used = torch.unique(cell_list[live].long())
    rot = Qc.shape[2]
    pair_rows = float(torch.sum(sizes[probes.long()]))
    ops = 2.0 * rot * pair_rows
    nbytes = (4.0 * Qc.numel() + codesT.shape[1] * float(
        torch.sum(sizes[used])) + float(used.numel() * codesT.shape[2])
        + 4.0 * table.numel() + 4.0 * cell_list.numel() + 8.0 * kd.numel())
    bound = max(ops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
    log(f"B4 timing cells={cell_list.shape[0]} (used {int(live.sum())}) "
        f"qrows={Qc.shape[1]} capp={codesT.shape[2]} rot={rot} k={K}: kernel "
        f"{ms:.3f} ms ({ms / search_ms:.1%} of the {search_ms:.3f} ms "
        f"search), plain {plain_ms:.3f} ms, library (decode + bf16 baddbmm + "
        f"topk over {step}-cell chunks) {lib_ms:.3f} ms, bound {bound:.3f} "
        f"ms; B2 on the bf16 recon cache at the same cells {b2_ms:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if ops / PEAK_BF16 >= nbytes / PEAK_BYTES
            else "bytes", "library_ms": lib_ms}


def b3_entry(dev, index, probes, rotq):
    """Phase 6 timings for B3 at the recon-tier shape (first N_SUB
    queries, bucket_cap 256, the bf16 reconstruction cache)."""
    import torch

    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import fused_knn as fk

    recon = index.reconstructed()
    n_lists, cap, d = recon.shape
    bucket, route = ivf_flat._invert_probe_map(probes, n_lists, BUCKET_CAP)
    Qb = rotq[torch.clamp_min(bucket, 0)].contiguous()
    invalid = (torch.arange(cap, device=dev)[None, :]
               >= index.list_sizes[:, None]).contiguous()
    args = (Qb, recon, invalid, K, True, True, False)
    kd, ki = fk._fused_batch_knn_cuda(*args)
    pd, pi = fk._fused_batch_knn_plain(*args)
    err = max_err(kd, pd)
    yn = torch.sum(recon.float() ** 2, dim=2)
    tol = REL_NORM_TOL * (float(torch.max(torch.sum(Qb ** 2, dim=-1)))
                          + float(torch.max(yn)))
    rec = recall(ki.reshape(-1, K), pi.reshape(-1, K))
    log(f"B3 vs plain at main path: per-slot recall@{K} {rec:.6f}, max |d| "
        f"err {err:.3e} (tol {tol:.3e})")
    if rec < RECALL_BF or err > tol:
        raise AssertionError("B3 disagrees with its plain version")

    ms = time_ms(lambda: fk._fused_batch_knn_cuda(*args), 5)
    plain_ms = time_ms(lambda: fk._fused_batch_knn_plain(*args), 2)
    step = 128
    ynb = yn.to(torch.bfloat16)

    def library():
        for s in range(0, n_lists, step):
            g = torch.baddbmm(ynb[s:s + step, None, :],
                              Qb[s:s + step].to(torch.bfloat16),
                              recon[s:s + step].transpose(1, 2), alpha=-2.0)
            g.masked_fill_(invalid[s:s + step, None, :], float("inf"))
            torch.topk(g, K, dim=2, largest=False)

    lib_ms = time_ms(library, 3)
    sizes = index.list_sizes.long()
    keep = route[2]
    pair_rows = float(torch.sum(sizes[route[0][keep].long()]))
    ops = 2.0 * d * pair_rows
    nbytes = (4.0 * Qb.numel() + 2.0 * d * float(torch.sum(sizes))
              + float(invalid.numel()) + 8.0 * kd.numel())
    bound = max(ops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
    log(f"B3 timing batch={n_lists} m={BUCKET_CAP} n={cap} d={d} k={K} "
        f"(bf16 db): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
        f"(bf16 baddbmm + topk over {step}-list chunks) {lib_ms:.3f} ms, "
        f"bound {bound:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if ops / PEAK_BF16 >= nbytes / PEAK_BYTES
            else "bytes", "library_ms": lib_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    dev = torch.device("cuda")

    from raft_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc per source: {_build.BUILD_SECONDS})")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    check_kernels(dev)
    check_kernels_b3_b4(dev)

    t0 = time.perf_counter()
    Xh, Qh = make_data(N_ROWS, DIM, N_BLOBS, N_QUERIES)
    X = torch.as_tensor(Xh, device=dev)
    Q = torch.as_tensor(Qh, device=dev)
    del Xh, Qh
    log(f"data: {N_ROWS} x {DIM} rows, {N_QUERIES} queries in "
        f"{time.perf_counter() - t0:.2f} s")

    mp = main_path(dev, X, Q)
    b1 = b1_entry(dev, X, Q, mp["bf"])
    b1_kmeans_shape(dev, X, mp["index"].centers)
    b2 = b2_entry(dev, Q, mp["index"])
    del mp["index"]
    torch.cuda.empty_cache()

    pq = pq_path(dev, X, Q, mp["bf"][1])
    b4 = b4_entry(dev, Q, pq["index"], pq["search_ms"])
    b3 = b3_entry(dev, pq["index"], pq["probes_sub"], pq["rotq_sub"])

    kernels = [
        dict(name="fused_knn", route="cuda",
             source="raft_tpu_torch/csrc/fused_knn.cu",
             replaces="raft_tpu/ops/fused_knn.py:179",
             launches=mp["launches"]["fused_knn"]
             + pq["launches"]["fused_knn"], **b1),
        dict(name="fused_cells_knn", route="cuda",
             source="raft_tpu_torch/csrc/fused_knn.cu",
             replaces="raft_tpu/ops/fused_knn.py:426",
             launches=mp["launches"]["fused_cells_knn"], **b2),
        dict(name="fused_batch_knn", route="cuda",
             source="raft_tpu_torch/csrc/fused_knn.cu",
             replaces="raft_tpu/ops/fused_knn.py:277",
             launches=pq["launches"]["fused_batch_knn"], **b3),
        dict(name="pq_fused_scan", route="cuda",
             source="raft_tpu_torch/csrc/pq_scan.cu",
             replaces="raft_tpu/ops/pq_scan.py:440",
             launches=pq["launches"]["pq_fused_scan"], **b4),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
