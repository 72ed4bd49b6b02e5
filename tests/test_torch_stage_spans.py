"""The port's stage spans (``core/nvtx.py``) on the CPU.

Off, a range is one flag check: no record function, no span. Under
``torch.profiler`` the IVF searches and builds log their stage tree in
order, with parent and root ids and their counts, each span's host
interval on the profiler's clock; the log is bounded and counts what it
drops. (The device intervals and the sync counts against
``torch.cuda.set_sync_debug_mode`` are card tests, in
``test_torch_kernels_cuda.py``.)
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raft_tpu_torch.core import nvtx
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
from test_torch_common import blobs

#: A span's host interval against its profiler event (ns).
CLOCK_NS = 50_000


@pytest.fixture
def drained():
    """An empty log before and after the test."""
    nvtx.take_spans()
    yield
    nvtx.take_spans()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    X = torch.as_tensor(blobs(rng, 6000, 16, 40))
    Q = torch.as_tensor(blobs(rng, 120, 16, 40))
    flat = ivf_flat.build(ivf_flat.IndexParams(n_lists=32), X)
    pq = ivf_pq.build(ivf_pq.IndexParams(n_lists=32, pq_dim=8, pq_bits=8),
                      X)
    return X, Q, flat, pq


def _search(kind, data):
    X, Q, flat, pq = data
    if kind == "ivf_flat":
        return ivf_flat.search(ivf_flat.SearchParams(
            n_probes=8, engine="bucketed"), flat, Q, 5)
    return ivf_pq.search(ivf_pq.SearchParams(n_probes=8, engine="bucketed"),
                         pq, Q, 5)


def _flat_build(data):
    # 300 lists > 256: the hierarchical k-means, every stage of it.
    return ivf_flat.build(ivf_flat.IndexParams(n_lists=300, kmeans_n_iters=4),
                          data[0])


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    taken = nvtx.take_spans()
    assert taken.dropped == 0
    return taken.spans, prof


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def _stages(spans, parent):
    return [s.name for s in _children(spans, parent)
            if not s.name.startswith("sync.")]


def _only(spans, name):
    found = [s for s in spans if s.name == name]
    assert len(found) == 1, (name, found)
    return found[0]


def test_off_is_one_flag_check(monkeypatch, drained, data):
    """No profiler, no tool: no record function, no NVTX push, no span;
    a range is the one shared null context."""
    made = []
    monkeypatch.setattr(nvtx, "_record_function",
                        lambda label: made.append(label))
    pushed = []
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", pushed.append)

    @nvtx.traced
    def f(x):
        return x + 1

    assert nvtx.range_scope("a", rows=3) is nvtx.range_scope("b")
    with nvtx.range_scope("outer"):
        f(torch.ones(2))
        nvtx.push_range("inner")
        nvtx.pop_range()
    _search("ivf_flat", data)
    _search("ivf_pq", data)
    assert made == [] and pushed == []
    assert nvtx.take_spans() == ([], 0)


def test_nvtx_pushes_only_with_a_tool(monkeypatch, drained):
    """An injected tool gets an NVTX range for every range, profiler or
    not; without one no range pushes."""
    pushed, popped = [], []
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", pushed.append)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: popped.append(1))
    with profile(activities=[ProfilerActivity.CPU]):
        with nvtx.range_scope("plain"):
            pass
    assert pushed == [] and popped == []
    monkeypatch.setattr(nvtx, "_NVTX_TOOL", True)
    with nvtx.range_scope("tool", domain="dom"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        nvtx.push_range("both")
        nvtx.pop_range()
    assert pushed == ["dom::tool", "raft_tpu_torch::both"]
    assert len(popped) == 2
    assert [s.name for s in nvtx.take_spans().spans] == ["plain", "both"]


@pytest.mark.parametrize("kind,stages", [
    ("ivf_flat", ["search.check", "search.probe", "search.invert",
                  "search.scan", "search.route", "search.select"]),
    ("ivf_pq", ["search.check", "search.probe", "search.rotate",
                "search.invert", "search.scan", "search.route",
                "search.select"])])
def test_search_logs_its_stage_tree(drained, data, kind, stages):
    spans, _ = _profiled(lambda: _search(kind, data))
    root = spans[0]
    assert (root.name, root.parent, root.root) == (f"{kind}.search", 0,
                                                   root.id)
    assert root.attrs == {"k": 5}
    assert [s.name for s in spans[1:] if s.parent == root.id] == stages
    assert all(s.root == root.id for s in spans)
    assert [s.id for s in spans] == sorted(s.id for s in spans)
    check, invert = _only(spans, "search.check"), _only(spans,
                                                        "search.invert")
    finite, count = _only(spans, "sync.finite"), _only(spans,
                                                       "sync.bincount")
    assert finite.parent == check.id and count.parent == invert.id
    assert count.attrs == {"syncs": 2}
    assert _only(spans, "search.probe").attrs == {"rows": 120, "probes": 8}
    assert _only(spans, "search.select").attrs == {"rows": 120, "k": 5}
    assert _only(spans, "search.scan").attrs["k"] == 5
    for s in spans:
        assert s.start_ns <= s.end_ns and s.device_ms is None
        if s.parent:
            up = next(p for p in spans if p.id == s.parent)
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns


def test_ivf_flat_build_logs_its_stage_tree(drained, data):
    spans, _ = _profiled(lambda: _flat_build(data))
    root = spans[0]
    assert (root.name, root.parent, root.attrs) == ("ivf_flat.build", 0,
                                                    {"lists": 300})
    assert _stages(spans, root) == ["build.train", "build.extend"]
    train, extend = (_only(spans, "build.train"),
                     _only(spans, "build.extend"))
    assert _stages(spans, train) == ["kmeans.meso", "kmeans.meso_predict",
                                     "kmeans.fine_seed", "kmeans.fine_em",
                                     "kmeans.polish"]
    assert _stages(spans, _only(spans, "kmeans.meso")) == ["kmeans.em"]
    assert _stages(spans, extend) == ["extend.predict", "extend.pack"]
    # 18 mesoclusters: two rows read a pick of k-means++; two masks a
    # seeding round.
    fine = _only(spans, "kmeans.fine_seed")
    assert [s.name for s in _children(spans, fine)] == (
        ["sync.seed_mask"] * (2 * fine.attrs["rounds"]))
    meso = _only(spans, "kmeans.meso")
    assert [s.name for s in _children(spans, meso)] == (
        ["sync.pp_row"] * 36 + ["kmeans.em"])
    assert [s.name for s in _children(spans, _only(
        spans, "kmeans.meso_predict"))] == [
        "sync.bincount", "sync.meso_counts", "sync.upload", "sync.upload"]
    assert [s.name for s in _children(spans, _only(spans, "extend.pack"))
            ] == ["sync.size", "sync.bincount", "sync.max_count",
                  "sync.bincount", "sync.max_count", "sync.max_id",
                  "sync.max_id"]
    assert [s.name for s in _children(spans, root)] == [
        "sync.finite", "build.train", "build.extend"]
    assert all(s.root == root.id for s in spans)


def test_ivf_pq_build_logs_its_stage_tree(drained, data):
    spans, _ = _profiled(lambda: ivf_pq.build(ivf_pq.IndexParams(
        n_lists=32, pq_dim=8, pq_bits=8, kmeans_n_iters=4), data[0]))
    root = spans[0]
    assert root.name == "ivf_pq.build"
    assert _stages(spans, root) == ["build.train", "build.codebooks",
                                    "build.extend"]
    assert _stages(spans, _only(spans, "build.extend")) == [
        "build.encode", "extend.pack"]
    assert _stages(spans, _only(spans, "build.train")) == ["kmeans.em"]


@pytest.mark.parametrize("what", ["ivf_flat", "ivf_pq", "build"])
def test_host_intervals_match_the_profiler(drained, data, what):
    """Each span's start and end lie within 50 us of its record
    function's event (a warm second call)."""
    fn = ((lambda: _flat_build(data)) if what == "build"
          else (lambda: _search(what, data)))
    _profiled(fn)
    spans, prof = _profiled(fn)
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("raft_tpu_torch::"):
            events.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    by_label = {}
    for s in spans:
        by_label.setdefault(s.label, []).append(s)
    assert set(by_label) <= set(events)
    worst = 0
    for label, group in by_label.items():
        evs = sorted(events[label])
        assert len(evs) == len(group), label
        for s, (e0, e1) in zip(sorted(group, key=lambda s: s.start_ns),
                               evs):
            worst = max(worst, abs(s.start_ns - e0), abs(s.end_ns - e1))
    assert worst <= CLOCK_NS, worst


def test_the_log_is_bounded(monkeypatch, drained):
    monkeypatch.setattr(nvtx, "MAX_SPANS", 5)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(8):
            with nvtx.range_scope("outer", i=i):
                with nvtx.range_scope("inner"):
                    pass
    taken = nvtx.take_spans()
    assert [s.name for s in taken.spans] == ["outer", "inner"] * 2 + [
        "outer"]
    assert taken.dropped == 11
    assert nvtx.take_spans() == ([], 0)


def test_take_leaves_out_open_spans_and_push_pop_log(drained):
    with profile(activities=[ProfilerActivity.CPU]):
        nvtx.push_range("a")
        with nvtx.range_scope("b"):
            open_now = nvtx.take_spans()
        nvtx.pop_range()
    assert open_now == ([], 0)
    # Both were drained while open: closing them logs nothing more.
    assert nvtx.take_spans() == ([], 0)
    with profile(activities=[ProfilerActivity.CPU]):
        nvtx.push_range("a")
        with nvtx.range_scope("b"):
            pass
        nvtx.pop_range()
    a, b = nvtx.take_spans().spans
    assert (a.name, b.name, b.parent, b.root) == ("a", "b", a.id, a.id)
