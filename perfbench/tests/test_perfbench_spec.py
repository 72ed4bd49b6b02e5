"""BENCHMARK.json against the benchmark's contract, and every cell's
parts found by name."""

import json
import re
import shutil

import pytest

from perfbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in seen
        seen.add(c["name"])
        assert c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    w = spec.workload(BENCH, cell)
    cfg = spec.config(w["config"])
    tr = spec.traffic(w["traffic"])
    assert cfg["name"] == w["config"]
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert (spec.REPO / entry["file"]).is_file()
    loop = spec.module("loops", tr["loop"])
    assert all(callable(getattr(loop, f)) for f in ("setup", "measure",
                                                    "check"))
    ref = spec.module("reference", cfg["reference"])
    assert callable(ref.judge_search) and callable(ref.judge_index)
    assert (spec.HERE / "systems" / f"{cfg['system']}.py").is_file()
    wanted = spec.cell_metrics(BENCH, cell)
    e2e = [m["name"] for m in wanted["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert wanted["per_layer"]
    for m in wanted["per_layer"]:
        assert m["moves"] in e2e
        assert callable(spec.module("metrics", m["name"]).read)


def test_every_config_used_and_layers_named_alike():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"serve", "engines", "kernels", "device"}


def test_new_files_are_found_without_an_edit(tmp_path, monkeypatch):
    """A later change adds a configuration, a mix and a metric as files:
    the harness finds them by name, and no file that is there changes."""
    copy = tmp_path / "perfbench"
    shutil.copytree(spec.HERE, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    cfg = json.loads((copy / "configs" / "sift1m-ivf-flat.json").read_text())
    cfg["name"] = "other-config"
    (copy / "configs" / "other-config.json").write_text(json.dumps(cfg))
    (copy / "traffic" / "other-mix.json").write_text(
        json.dumps({"loop": "batch", "batch": 7}))
    (copy / "metrics" / "other_metric.x.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    monkeypatch.setattr(spec, "HERE", copy)
    assert spec.config("other-config")["name"] == "other-config"
    assert spec.traffic("other-mix")["batch"] == 7
    assert spec.module("metrics", "other_metric.x").read(None) == 42.0
    assert all(p.read_bytes() == b for p, b in before.items())
