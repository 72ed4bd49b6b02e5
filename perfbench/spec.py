"""Find a cell's parts by name.

``BENCHMARK.json`` at the repository root lists the cells. Each part of a
cell lives in a file of its own under this folder, found by the name the
benchmark gives it:

* ``configs/<config>.json``: the configuration's sizes, its index
  parameters, the name of its system adapter and of its plain reference,
  and the limits of its correctness check;
* ``traffic/<traffic>.json``: the traffic mix's parameters, with the name
  of the loop that drives it;
* ``systems/<system>.py``: how the port builds and searches the index;
* ``loops/<loop>.py``: the generator and driver of one kind of traffic;
* ``reference/<reference>.py``: the plain reference that judges answers;
* ``metrics/<metric>.py``: the reader of one per-layer metric.

Adding a configuration, a mix or a metric adds files and entries; no file
here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
BENCHMARK = REPO / "BENCHMARK.json"


def load_benchmark(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` loaded as a module (a name may hold dots)."""
    key = f"perfbench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.name} under perfbench")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def reports(entry: dict, cell: str, e2e_of_cell: List[str]) -> bool:
    """Whether a metric entry is reported in ``cell``: the cells its
    ``workloads`` lists, or else every cell (an end-to-end metric) or every
    cell that reports the end-to-end metric it moves (a per-layer one)."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    if "moves" in entry:
        return entry["moves"] in e2e_of_cell
    return True


def cell_metrics(bench: dict, cell: str) -> Dict[str, List[dict]]:
    """The end-to-end and per-layer metric entries that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if reports(m, cell, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if reports(m, cell, names)]
    return {"end_to_end": e2e, "per_layer": per_layer}
