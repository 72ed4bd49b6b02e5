"""Run a breadth phase of ``chip_smoke.py`` alone, on the card, over phase
4's data:

    python3 tools/breadth_phase.py        # phase 16
    python3 tools/breadth_phase.py 17     # phase 17
    python3 tools/breadth_phase.py 18     # phase 18
    python3 tools/breadth_phase.py 19     # phase 19
    python3 tools/breadth_phase.py 21     # phase 21

It builds the kernels, makes the 1M x 128 rows and 10,000 queries of
``chip_smoke.py``, then for phase 16 builds an IVF-Flat index with 1024
lists (its build and k=1 search need B1 and B2) and calls
``chip_smoke.breadth_phase``; for phase 17 builds an IVF-PQ index with
1024 lists and takes phase 6's 100 candidates a query from its compressed
search (B4), then calls ``chip_smoke.slice17_phase``; phase 18 needs
only the rows (``chip_smoke.slice18_phase``); phase 19 takes phase 4's
brute-force answer (B1) and calls ``chip_smoke.slice19_phase``; phase
21 takes phase 4's brute-force answer, an IVF-Flat index with 1024 lists
and its 32-probe search (B2), and an IVF-PQ index with 1024 lists and
its compressed search's recall (B4), then calls
``chip_smoke.slice21_phase`` (its own 1M u8 and 10M rows besides). The
phases' checks are fatal. It prints the phase's seconds, its launches
and the peak device memory. About 50 s of build; phase 16 takes about
15 s.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from raft_tpu_torch.neighbors import (  # noqa: E402
    brute_force, ivf_flat, ivf_pq)
from raft_tpu_torch.ops import _build  # noqa: E402


def main() -> None:
    phase = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    if phase not in (16, 17, 18, 19, 21):
        raise SystemExit(f"no breadth phase {phase}: 16, 17, 18, 19 or 21")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    card = cs.card_line()
    Xh, Qh = cs.make_data(cs.N_ROWS, cs.DIM, cs.N_BLOBS, cs.N_QUERIES)
    X = torch.as_tensor(Xh, device=dev)
    Q = torch.as_tensor(Qh, device=dev)
    if phase == 16:
        index = ivf_flat.build(ivf_flat.IndexParams(n_lists=cs.N_LISTS), X)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        launches = cs.breadth_phase(dev, X, Q, index, card)
    elif phase == 17:
        index = ivf_pq.build(ivf_pq.IndexParams(n_lists=cs.N_LISTS), X)
        _, cand = ivf_pq.search(ivf_pq.SearchParams(n_probes=cs.N_PROBES),
                                index, Q, cs.N_CAND_17)
        del index
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        launches = cs.slice17_phase(dev, X, Q, cand, card)["launches"]
    elif phase == 18:
        del Q
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        launches = cs.slice18_phase(dev, X, card)["launches"]
    elif phase == 19:
        bf = brute_force.knn(X, Q, cs.K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        launches = cs.slice19_phase(dev, X, Q, bf, card)["launches"]
    else:
        bf = brute_force.knn(X, Q, cs.K)
        flat = ivf_flat.build(ivf_flat.IndexParams(n_lists=cs.N_LISTS), X)
        iv = ivf_flat.search(ivf_flat.SearchParams(n_probes=cs.N_PROBES),
                             flat, Q, cs.K)
        pq = ivf_pq.build(ivf_pq.IndexParams(n_lists=cs.N_LISTS), X)
        _, pi = ivf_pq.search(ivf_pq.SearchParams(n_probes=cs.N_PROBES), pq,
                              Q, cs.K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        launches = cs.slice21_phase(dev, X, Q, bf, iv, flat, pq,
                                    cs.recall(pi, bf[1]), card)["launches"]
    print(f"phase {phase} alone {time.perf_counter() - t0:.3f} s, launches "
          f"{launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]",
          flush=True)


if __name__ == "__main__":
    main()
