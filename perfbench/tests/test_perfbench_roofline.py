"""The roofline arithmetic against a case worked out by hand, and the
device trace's reduction on made-up events."""

from types import SimpleNamespace

import pytest
import torch

from perfbench import devtrace, readers, roofline


def test_scan_work_by_hand():
    # Two queries probe lists (0, 1) and (1, 2) of sizes 10, 20, 30.
    probe = torch.tensor([[0, 1], [1, 2]])
    sizes = torch.tensor([10, 20, 30], dtype=torch.int32)
    w = roofline.ivf_scan_work(probe, sizes, dim=4, k=2, row_bytes=16.0,
                               query_bytes=16.0)
    # pairs: 10 + 20 + 20 + 30 = 80; ops 2 x 4 x 80.
    assert w["pairs"] == 80 and w["ops"] == 640.0
    # 2 queries x 16 B + 60 rows x 16 B + 2 x 2 probes x 2 x 8 B.
    assert w["bytes"] == 32.0 + 960.0 + 64.0
    assert roofline.bound_s(640.0, 1056.0, "f32") == pytest.approx(
        max(640.0 / (495e12 / 3.0), 1056.0 / 3.35e12))
    assert roofline.bound_s(1e12, 1.0, "bf16") == pytest.approx(1e12 / 989e12)


class Ev:
    def __init__(self, name, start, dur, cuda, annot=False):
        self._n, self._s, self._d, self._c, self._a = (name, start, dur,
                                                       cuda, annot)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._c else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._a


def test_trace_summary_by_hand():
    events = [Ev(devtrace.WINDOW, 0, 1000, False, True),
              Ev("perfbench.search", 0, 600, False, True),
              Ev("aten::item", 400, 200, False),
              Ev("perfbench.window", 0, 1000, True, True),
              Ev("void (anonymous namespace)::b2_tf32_kernel<64, 1>"
                 "(float const*)", 100, 200, True),
              Ev("void at::native::reduce_kernel<512>(int)", 250, 150, True),
              Ev("Memcpy DtoH (Device -> Pinned)", 700, 100, True),
              Ev("void cell_norms::b1_norms_kernel(int)", 1500, 100, True)]
    s = devtrace.summarize(events)
    assert s.window_s == pytest.approx(1e-6)
    # Busy: [100, 400) and [700, 800) within the window.
    assert s.busy_s == pytest.approx(400e-9)
    by = s.seconds_by_name()
    assert by["b2_tf32_kernel"] == pytest.approx(200e-9)
    assert by["at::native::reduce_kernel"] == pytest.approx(150e-9)
    assert "cell_norms::b1_norms_kernel" not in by
    gaps = dict(s.breakdown()["idle_gaps"])
    # [0, 100) under the search range, [400, 700) under aten::item,
    # [800, 1000) under the window alone.
    assert gaps["perfbench.search"] == pytest.approx(100e-9)
    assert gaps["aten::item"] == pytest.approx(300e-9)
    assert gaps["host:python"] == pytest.approx(200e-9)
    ctx = SimpleNamespace(trace=s, window={
        "work": {"ops": 2.0 * 165e12 * 1e-7, "bytes": 0.0}})
    # Bound 0.2 us of f32 products against 0.2 us of b2 kernels.
    assert readers.scan_roofline(ctx, ("b2_",), "f32") == pytest.approx(
        100.0)
    assert readers.idle_share(ctx) == pytest.approx(60.0)
    assert readers.engine_share(ctx) == pytest.approx(15.0)
