"""Index builds, one after another, on the cell's rows.

Set-up makes the rows and a fixed sample of ``check_rows`` queries, and
runs one build and search to load the libraries. With ``center_seed``
every seed gets the same blob centres (its own row order and noise): the
build's work follows the blobs' geometry, which the run's seed would
otherwise change by a few percent. In the window each
build starts after the previous index is freed; each built index is
searched once by the sample at ``k`` (ids to the host) and copies of its
centres and list membership are kept for the check (its stored rows too
for ``keep_data_builds`` seeded builds among the first eight).
``build_s`` is the window over the number of complete builds.

The check holds every build's index and answers to the reference.
"""

from __future__ import annotations

import time

from perfbench import data
from perfbench.harness import Cell, checks, seeded_sample, worst
from perfbench.reference.common import blob_inertia


def setup(cell: Cell) -> None:
    cfg, tr, st = cell.cfg, cell.traffic, cell.state
    X, labels = data.blobs(cfg, cell.seed, cell.device,
                           tr.get("center_seed"))
    st["X"] = X
    Q = data.queries(cfg, X, tr["check_rows"], cell.seed)
    index = cell.system.build(cfg, X)
    cell.system.search(index, cfg, Q, tr["k"])[1].cpu()
    del index
    cell.sync()
    rng = data.host_rng(cell.seed, 4)
    st.update(X=X, labels=labels, Q=Q, keep=set(seeded_sample(
        rng, 8, tr["keep_data_builds"]).tolist()))


def measure(cell: Cell, seconds: float) -> dict:
    cfg, tr, st = cell.cfg, cell.traffic, cell.state
    X, Q, system = st["X"], st["Q"], cell.system
    kept = []
    builds = 0
    before = system.counters()
    t0 = time.perf_counter()
    while True:
        with cell.mark("build"):
            index = system.build(cfg, X)
        with cell.mark("search"):
            d, i = system.search(index, cfg, Q, tr["k"])
            ih = i.cpu()
        kept.append((system.snapshot(index, keep_data=builds in st["keep"]),
                     d, ih))
        del index
        builds += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    after = system.counters()
    st["kept"] = kept
    return {"build_s": elapsed / builds, "attempted": builds, "failed": 0,
            "window_s": elapsed, "builds": builds,
            "counters": {key: after[key] - before[key] for key in after}}


def check(cell: Cell, window: dict) -> dict:
    cfg, tr, st = cell.cfg, cell.traffic, cell.state
    X, Q, ref = st["X"], st["Q"], cell.reference
    blob = blob_inertia(X, st.pop("labels"))
    readings = []
    for snap, d, ih in st.pop("kept"):
        readings.append(ref.judge_index(snap, X, cfg, cell.seed, blob))
        snap.pop("data", None)
        prep = ref.prepare(snap, X, cfg)
        readings.append(ref.judge_search(prep, Q, tr["k"], d,
                                         ih.to(X.device), cfg))
    return checks(worst(readings), cfg)
