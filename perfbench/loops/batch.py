"""Closed loop of fixed-size query batches (ann-benchmarks' batch mode).

Set-up builds the index from the cell's rows (with ``center_seed``, the
same blobs for every seed: the scan's work follows their geometry, which
the run's seed would otherwise change by up to a tenth) and makes a pool
of ``pool_batches`` x ``batch`` queries on the device. The window sends the
pool's batches in turn through the system's search at ``k``, one after
the other, and copies each batch's ids to the host; ``qps`` is every
query answered over the window's length. Each batch's scan work (for
the roofline) is counted at set-up from the index's list sizes and the
batch's probed lists.

The check judges ``check_rows`` seeded rows of ``check_batches`` seeded
iterations of the window (among its first 32; the last one where the
window ran none of those), and the index.
"""

from __future__ import annotations

import time

import torch

from perfbench import data, roofline
from perfbench.harness import Cell, checks, seeded_sample, worst
from perfbench.reference.common import blob_inertia, sqdist

#: Iterations among which the checked ones are drawn.
CHECK_SPAN = 32


def probe_ids(centers: torch.Tensor, Q: torch.Tensor, n_probes: int):
    """The probed lists of each query, for counting work only."""
    return torch.topk(sqdist(Q, centers.float()), n_probes, dim=1,
                      largest=False).indices


def setup(cell: Cell) -> None:
    cfg, tr, st = cell.cfg, cell.traffic, cell.state
    X, labels = data.blobs(cfg, cell.seed, cell.device,
                           tr.get("center_seed"))
    st["X"] = X
    B, nb = tr["batch"], tr["pool_batches"]
    pool = data.queries(cfg, X, B * nb, cell.seed)
    index = cell.system.build(cfg, X)
    for _ in range(2):
        _, i = cell.system.search(index, cfg, pool[:B], tr["k"])
        i.cpu()
    cell.sync()
    work = []
    for b in range(nb):
        pid = probe_ids(index.centers, pool[b * B:(b + 1) * B],
                        cfg["n_probes"])
        work.append(roofline.ivf_scan_work(
            pid, index.list_sizes, cfg["dim"], tr["k"],
            cell.system.scan_row_bytes(index), 4.0 * cfg["dim"]))
    rng = data.host_rng(cell.seed, 4)
    st.update(X=X, labels=labels, pool=pool, index=index, work=work,
              keep=set(seeded_sample(rng, CHECK_SPAN,
                                     tr["check_batches"]).tolist()))


def measure(cell: Cell, seconds: float) -> dict:
    cfg, tr, st = cell.cfg, cell.traffic, cell.state
    B, nb, k = tr["batch"], tr["pool_batches"], tr["k"]
    pool, index, search = st["pool"], st["index"], cell.system.search
    kept = []
    it = 0
    before = cell.system.counters()
    t0 = time.perf_counter()
    while True:
        b = it % nb
        with cell.mark("search"):
            d, i = search(index, cfg, pool[b * B:(b + 1) * B], k)
        with cell.mark("ids_to_host"):
            ih = i.cpu()
        if it in st["keep"]:
            kept.append((b, d, ih))
        last = (b, d, ih)
        it += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    after = cell.system.counters()
    work = {}
    for j in range(it):
        work = roofline.add(work, st["work"][j % nb])
    st["kept"] = kept or [last]
    return {"qps": it * B / elapsed, "attempted": it * B, "failed": 0,
            "window_s": elapsed, "batches": it, "work": work,
            "pairs": work.get("pairs", 0), "cap": int(index.indices.shape[1]),
            "counters": {key: after[key] - before[key] for key in after}}


def check(cell: Cell, window: dict) -> dict:
    cfg, tr, st = cell.cfg, cell.traffic, cell.state
    B, k = tr["batch"], tr["k"]
    X, pool, ref = st["X"], st["pool"], cell.reference
    snap = cell.system.snapshot(st.pop("index"), keep_data=True)
    blob = blob_inertia(X, st.pop("labels"))
    readings = [ref.judge_index(snap, X, cfg, cell.seed, blob)]
    snap.pop("data", None)
    prep = ref.prepare(snap, X, cfg)
    rng = data.host_rng(cell.seed, 5)
    for b, d, ih in st.pop("kept"):
        rows = torch.as_tensor(seeded_sample(rng, B, tr["check_rows"]),
                               device=X.device)
        Q = pool[b * B:(b + 1) * B][rows]
        readings.append(ref.judge_search(prep, Q, k, d[rows],
                                         ih.to(X.device)[rows], cfg))
    return checks(worst(readings), cfg)
