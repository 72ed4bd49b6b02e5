#!/usr/bin/env python3
"""Smoke run of the raft_tpu_torch port on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero and prints
no result line):

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every kernel under ``raft_tpu_torch/csrc`` with ``nvcc``;
3. kernel vs plain: B1 (``fused_knn``) and B2 (``fused_cells_knn``) against
   their plain PyTorch versions on the card, on integer-valued data (ids
   and distances must be identical) and Gaussian data (distances within a
   stated tolerance);
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
6. a ``kernels`` line, the card line, and the result line.

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

    kernels = [
        dict(name="fused_knn", route="cuda",
             source="raft_tpu_torch/csrc/fused_knn.cu",
             replaces="raft_tpu/ops/fused_knn.py:179",
             launches=mp["launches"]["fused_knn"], **b1),
        dict(name="fused_cells_knn", route="cuda",
             source="raft_tpu_torch/csrc/fused_knn.cu",
             replaces="raft_tpu/ops/fused_knn.py:426",
             launches=mp["launches"]["fused_cells_knn"], **b2),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
