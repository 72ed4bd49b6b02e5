"""Stage table of one cell of ``BENCHMARK.json`` from the port's spans.

    python3 tools/stage_table.py --workload flat-batch --seed 12345 \\
        [--seconds 15] [--cost]

Sets the cell up as ``perfbench.run`` does, measures one traced window
(the profiler on, as a ``--trace 1`` run) and prints one JSON line:

* ``stages``: for each span name under the cell's roots (the searches in
  the batch cells, the builds in the build cell), per batch or build:
  host ms, device ms (CUDA event pairs), idle ms (device idle gaps whose
  midpoint the span is the innermost of) and host syncs;
* ``metrics``: the cell's per-layer metrics as the traced run reads them,
  with ``idle_share`` beside them;
* ``tiling``: the window's sum of the search stages' device ms over
  their roots' (less 1), and the share of roots whose stages sum to
  within 2% of the root's own;
* with ``--cost`` (batch cells): the wall and host ms of a batch under
  the profiler with the port's ranges on and off, 1500 pairs of batches
  in alternating order, the pairs' median difference, and the host us of
  one empty range.

Needs the card. The device's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import spans, spec  # noqa: E402
from perfbench.devtrace import DeviceTrace  # noqa: E402
from perfbench.readers import idle_share  # noqa: E402
from perfbench.run import make_cell  # noqa: E402


def tiling(sp):
    """How the search roots' stages tile them on the device: the window's
    sum of the stages' device ms over the roots' (less 1), and the share
    of roots whose stages sum to within 2% of their own (None without
    device intervals)."""
    roots = [s for s in sp or () if s.parent == 0
             and s.name in spans.SEARCH_ROOTS]
    pairs = []
    for root in roots:
        kids = [s.device_ms for s in sp if s.parent == root.id]
        if root.device_ms is None or None in kids:
            return None
        pairs.append((sum(kids), root.device_ms))
    if not pairs:
        return None
    return {"sum": sum(k for k, _ in pairs) / sum(r for _, r in pairs) - 1,
            "within_2pct": sum(abs(k - r) <= 0.02 * r for k, r in pairs)
            / len(pairs)}


def cost(cell, pairs: int = 1500) -> dict:
    """The wall and host ms of a batch of the cell's loop (search, ids to
    the host) under the profiler with the port's ranges on and off, in
    pairs of batches whose order alternates; the medians of each side and
    of the pairs' differences; and one empty range's host us."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.core import nvtx

    cfg, tr, st = cell.cfg, cell.traffic, cell.state
    B, live = tr["batch"], nvtx._profiling
    side = {True: ([], []), False: ([], [])}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for i in range(2 * pairs):
            on = (i % 2 == 0) != (i // 2 % 2 == 1)
            nvtx._profiling = live if on else (lambda: False)
            try:
                q = st["pool"][(i % tr["pool_batches"]) * B:][:B]
                t0 = time.perf_counter()
                ids = cell.system.search(st["index"], cfg, q, tr["k"])[1]
                t1 = time.perf_counter()
                ids.cpu()
                t2 = time.perf_counter()
            finally:
                nvtx._profiling = live
            side[on][0].append((t2 - t0) * 1e3)
            side[on][1].append((t1 - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            with nvtx.range_scope("cost.empty"):
                pass
        empty_us = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    nvtx.take_spans()
    out = {"range_us": empty_us, "pairs": pairs}
    for k, name in ((0, "wall"), (1, "host")):
        on, off = side[True][k], side[False][k]
        diff = [a - b for a, b in zip(on, off)]
        out[name] = {"on_ms": statistics.median(on),
                     "off_ms": statistics.median(off),
                     "diff_us": 1e3 * statistics.median(diff),
                     "diff_quartiles_us": [1e3 * q for q in
                                           statistics.quantiles(diff, n=4)],
                     "diff_mean_us": 1e3 * statistics.fmean(diff)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--cost", action="store_true")
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    bench = spec.load_benchmark()
    cell = make_cell(bench, args.workload, args.seed, "cuda", True)
    loop = spec.module("loops", cell.traffic["loop"])
    loop.setup(cell)
    cell.sync()
    with DeviceTrace(True) as dt:
        window = loop.measure(cell, args.seconds)
    ctx = SimpleNamespace(window=window, trace=dt.summary, cell=cell)
    batch = cell.traffic["loop"] == "batch"
    roots, count = ((spans.SEARCH_ROOTS, "batches") if batch
                    else (spans.BUILD_ROOTS, "builds"))
    out = {"workload": args.workload, "seed": args.seed,
           "count": window[count], "window_s": window["window_s"],
           "stages": spans.stage_table(ctx, roots, count),
           "metrics": {m["name"]: spec.module("metrics", m["name"]).read(ctx)
                       for m in spec.cell_metrics(bench, cell.name)
                       ["per_layer"]},
           "idle_share": idle_share(ctx),
           "tiling": tiling(ctx.spans) if batch else None,
           "breakdown": dt.summary and dt.summary.breakdown()}
    if args.cost and batch:
        out["cost"] = cost(cell)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
