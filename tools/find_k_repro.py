"""Whether ``find_k`` on the card repeats itself, and what moves it:

    python3 tools/find_k_repro.py

On the data of ``chip_smoke.py``'s phase 17 (c) (``make_blobs(200,000 x
32, 8 centers, std 0.3)``, ``kmax`` 16) it runs, twice in each mode, the
port as it runs and then under ``torch.use_deterministic_algorithms``
(where ``index_add_`` sums in a fixed order): the centroid update's
``reduce_rows_by_key`` on fixed labels, one seeded k-means++ fit at k=8,
and ``find_k``. It prints each run's k, inertia, iterations and B1
launches, and whether the two runs of a mode agree bit for bit. It builds
B1 only (about 20 s), then takes a few seconds.
"""

import importlib
import os
import sys
import time
from pathlib import Path

# cuBLAS needs a fixed workspace for deterministic mode.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from raft_tpu_torch import random as rnd  # noqa: E402
from raft_tpu_torch.cluster import KMeansParams, kmeans  # noqa: E402
from raft_tpu_torch.linalg.reduce import reduce_rows_by_key  # noqa: E402
from raft_tpu_torch.ops import _build  # noqa: E402
from raft_tpu_torch.random import RngState  # noqa: E402

fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")


def runs(X, blobs, kmax):
    """Two of each step; returns the lines to print."""
    labels = torch.arange(X.shape[0], device=X.device) % blobs
    sums = [reduce_rows_by_key(X, labels, blobs) for _ in range(2)]
    fits = [kmeans.fit(KMeansParams(n_clusters=blobs,
                                    rng_state=RngState(0)), X)
            for _ in range(2)]
    finds = []
    for _ in range(2):
        before = fk.fused_knn.launches
        k, inertia, it = kmeans.find_k(X, kmax=kmax)
        finds.append((k, float(inertia), it,
                      fk.fused_knn.launches - before))
    return [f"reduce_rows_by_key equal: {torch.equal(*sums)}",
            f"fit at k={blobs}: centroids equal "
            f"{torch.equal(fits[0][0], fits[1][0])}, inertia "
            f"{float(fits[0][1])!r} / {float(fits[1][1])!r}, iterations "
            f"{fits[0][2]} / {fits[1][2]}",
            *(f"find_k run {i}: k {k}, inertia {inertia!r}, {it} iterations, "
              f"{n} B1 launches" for i, (k, inertia, it, n)
              in enumerate(finds, 1)),
            f"find_k runs equal: {finds[0] == finds[1]}"]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("find_k_repro: CUDA is not available")
    t0 = time.perf_counter()
    _build.build_all(["knn_tf32"])
    card = cs.card_line()
    print(f"build {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    rows, dim, blobs, std, kmax = cs.FINDK_17
    X, _ = rnd.make_blobs(rows, dim, n_clusters=blobs, cluster_std=std,
                          seed=cs.SEED + 17, device="cuda")
    for mode in ("as the port runs", "deterministic algorithms"):
        torch.use_deterministic_algorithms(mode != "as the port runs",
                                           warn_only=True)
        for line in runs(X, blobs, kmax):
            print(f"{mode}: {line}", flush=True)
    torch.use_deterministic_algorithms(False)


if __name__ == "__main__":
    main()
