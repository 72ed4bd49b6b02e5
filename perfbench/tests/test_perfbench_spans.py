"""The readers of the port's spans (``perfbench/spans.py``) against cases
worked out by hand, a port without the span log, and a small traced run
on the CPU."""

import time
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

from perfbench import run, spans, spec
from perfbench.devtrace import TraceSummary

BENCH = spec.load_benchmark()
NEW = ("search_host_ms.qps", "engine_device_ms.qps", "search_idle_share.qps",
       "search_syncs.qps", "train_ms.build", "extend_ms.build",
       "build_syncs.build")


class S:
    """A hand-made span."""

    def __init__(self, name, id, parent, root, start, end, device_ms=None,
                 **attrs):
        self.name, self.id, self.parent, self.root = name, id, parent, root
        self.start_ns, self.end_ns = start, end
        self.device_ms, self.attrs = device_ms, attrs


def read(name, ctx):
    return spec.module("metrics", name).read(ctx)


def search_ctx():
    """One batch in a 10 us window. The search root [1000, 5000) holds
    check (with sync.finite), probe (with a two-sync bincount), scan and
    select; the device idles over [1100, 1800) (midpoint in sync.finite,
    inside check and the root: counted once), [4000, 5500) (midpoint in
    select) and [8000, 9000) (no span: the harness's)."""
    sp = [S("ivf_flat.search", 1, 0, 1, 1000, 5000, 3.0, k=10),
          S("search.check", 2, 1, 1, 1000, 1500, 0.5),
          S("sync.finite", 3, 2, 1, 1200, 1480, 0.25),
          S("search.probe", 4, 1, 1, 1500, 2500, 1.0),
          S("sync.bincount", 5, 4, 1, 2000, 2100, 0.1, syncs=2),
          S("search.scan", 6, 1, 1, 2500, 4500, 1.0),
          S("search.select", 7, 1, 1, 4500, 5000, 0.5)]
    ops = [("a", 0, 1100), ("b", 1800, 3000), ("c", 2900, 4000),
           ("d", 5500, 8000), ("e", 9000, 10000)]
    return SimpleNamespace(window={"batches": 1}, spans=sp,
                           trace=TraceSummary((0, 10000), ops, []))


def build_ctx():
    """Two builds (train 300 / 320 ms, extend 50 / 60 ms of device time,
    3 syncs each) and a search after each with a sync of its own."""
    sp = []
    for b, t in ((0, 0), (1, 10 ** 6)):
        r = 100 * b + 10
        sp += [S("ivf_flat.build", r, 0, r, t, t + 900),
               S("sync.finite", r + 1, r, r, t, t + 10),
               S("build.train", r + 2, r, r, t + 10, t + 600, 300.0 + 20 * b),
               S("sync.pp_row", r + 3, r + 2, r, t + 20, t + 30),
               S("build.extend", r + 4, r, r, t + 600, t + 900, 50.0 + 10 * b),
               S("sync.size", r + 5, r + 4, r, t + 610, t + 620),
               S("ivf_flat.search", r + 6, 0, r + 6, t + 950, t + 990),
               S("sync.finite", r + 7, r + 6, r + 6, t + 950, t + 960)]
    return SimpleNamespace(window={"builds": 2}, spans=sp, trace=None)


def test_search_readers_by_hand():
    ctx = search_ctx()
    assert read("search_host_ms.qps", ctx) == pytest.approx(4000e-6)
    # check + probe + select; scan left out; children not summed twice.
    assert read("engine_device_ms.qps", ctx) == pytest.approx(2.0)
    assert read("search_syncs.qps", ctx) == 3
    # Inside the root: 700 + 1500 ns of the 3200 idle, of 10000.
    assert read("search_idle_share.qps", ctx) == pytest.approx(22.0)
    assert read("idle_share.qps", ctx) == pytest.approx(32.0)


def test_stage_table_by_hand():
    table = spans.stage_table(search_ctx(), spans.SEARCH_ROOTS, "batches")
    assert table["sync.finite"] == pytest.approx({
        "spans": 1, "host_ms": 280e-6, "device_ms": 0.25, "idle_ms": 700e-6,
        "syncs": 1})
    assert table["search.select"]["idle_ms"] == pytest.approx(1500e-6)
    assert table["search.check"]["idle_ms"] == 0.0
    assert table["sync.bincount"]["syncs"] == 2


def test_build_readers_by_hand():
    ctx = build_ctx()
    assert read("train_ms.build", ctx) == pytest.approx(310.0)
    assert read("extend_ms.build", ctx) == pytest.approx(55.0)
    # The searches' syncs are not the builds'.
    assert read("build_syncs.build", ctx) == 3


def test_a_gap_outside_every_root_counts_nowhere():
    ctx = search_ctx()
    ctx.trace = TraceSummary((0, 10000), [("a", 0, 8000),
                                          ("b", 9000, 10000)], [])
    assert read("search_idle_share.qps", ctx) == 0.0


def test_readers_find_nothing_without_spans(monkeypatch):
    for ctx in (SimpleNamespace(window={"batches": 3, "builds": 3},
                                spans=None, trace=search_ctx().trace),
                SimpleNamespace(window={"batches": 0, "builds": 0},
                                spans=search_ctx().spans + build_ctx().spans,
                                trace=None)):
        assert [read(n, ctx) for n in NEW] == [None] * len(NEW)
    # Spans of the other kind of call only, or no device intervals.
    ctx = search_ctx()
    ctx.window["builds"] = 1
    for s in ctx.spans:
        s.device_ms = None
    assert [read(n, ctx) for n in ("engine_device_ms.qps", "train_ms.build",
                                   "extend_ms.build", "build_syncs.build")
            ] == [None] * 4
    # A port without the span log (an older checkout).
    from raft_tpu_torch.core import nvtx

    monkeypatch.delattr(nvtx, "take_spans")
    ctx = SimpleNamespace(window={"batches": 3}, trace=None)
    assert read("search_host_ms.qps", ctx) is None and ctx.spans is None


def test_a_small_traced_run_on_the_cpu():
    """The batch loop at a tiny size under the CPU profiler: the host
    readers find the searches and their syncs; the device readers, with
    no trace and no events, find nothing."""
    cell = run.make_cell(BENCH, "flat-batch", 2 ** 31 + 7, "cpu", True)
    cell.cfg.update(n_rows=6000, n_lists=32, n_probes=8)
    cell.cfg["dataset"]["n_blobs"] = 16
    cell.traffic.update(batch=256, pool_batches=2)
    loop = spec.module("loops", "batch")
    loop.setup(cell)
    spans.of(SimpleNamespace())
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        window = loop.measure(cell, 0.5)
    ctx = SimpleNamespace(window=window, trace=None, cell=cell)
    sp = spans.of(ctx)
    roots = [s for s in sp if s.parent == 0]
    assert len(roots) == window["batches"]
    assert all(s.name == "ivf_flat.search" and s.start_ns >= t0
               for s in roots)
    assert 0 < read("search_host_ms.qps", ctx) < 1e3 * window["window_s"]
    # The scan engine at this load: the finite check alone syncs.
    assert read("search_syncs.qps", ctx) == 1
    assert read("engine_device_ms.qps", ctx) is None
    assert read("search_idle_share.qps", ctx) is None
