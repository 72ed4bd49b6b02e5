"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (counted in ``setup_s`` from the process's first line here) makes
the inputs from the seed on the card, builds the system and warms every
shape the cell's traffic uses. The loop then measures for ``--seconds``;
with ``--trace 1`` under the profiler, for at most ``TRACE_SECONDS``,
and the per-layer readers reduce its trace. Once the window has closed and the peak memory is read, the
plain reference judges the answers; each number compared is printed
beside its limit, on standard error and under ``checks``, the last key of
the result line. The last line of standard output is one JSON object.

The run fails (exit code not 0, no result line) without enough CUDA
cards, or if the process has loaded ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``raft_tpu`` by the end of the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from perfbench import spec  # noqa: E402
from perfbench.devtrace import DeviceTrace  # noqa: E402
from perfbench.harness import Cell  # noqa: E402

#: Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "raft_tpu")
#: The longest window of a traced run: its per-layer metrics are ratios
#: of the window, and the trace's reduction grows with its length.
TRACE_SECONDS = 15.0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def make_cell(bench: dict, name: str, seed: int, device: str,
              trace: bool) -> Cell:
    w = spec.workload(bench, name)
    return cell_of(name, w["config"], w["traffic"], seed, device, trace)


def cell_of(name: str, config: str, traffic: str, seed: int, device: str,
            trace: bool) -> Cell:
    """A cell of a configuration and a mix, by their names."""
    cfg = spec.config(config)
    return Cell(name=name, cfg=cfg, traffic=spec.traffic(traffic),
                system=spec.module("systems", cfg["system"]),
                reference=spec.module("reference", cfg["reference"]),
                seed=seed, device=device, trace=trace)


def run_cell(bench: dict, cell: Cell, seconds: float,
             t_start: float = T_START) -> dict:
    """Set up, measure and check one cell; returns the result object."""
    import torch

    loop = spec.module("loops", cell.traffic["loop"])
    wanted = spec.cell_metrics(bench, cell.name)
    on_card = cell.device != "cpu"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_loop = time.perf_counter()
    loop.setup(cell)
    cell.sync()
    setup_s = time.perf_counter() - t_start
    if cell.trace:
        seconds = min(seconds, TRACE_SECONDS)
    from raft_tpu_torch.serve.stats import CompileCounter

    with DeviceTrace(cell.trace and on_card) as dt, CompileCounter() as cc:
        window = loop.measure(cell, seconds)
    # Kernel builds and first library loads inside the window (none is
    # expected: set-up warmed every shape).
    window["compile_events"] = cc.count
    # Set-up before the cell's own: imports and the card's context.
    window["setup_start_s"] = t_loop - t_start
    cell.sync()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules loaded in the run: {', '.join(found)}")
    if cell.trace:
        ctx = SimpleNamespace(window=window, trace=dt.summary, cell=cell)
        metrics = {}
        for m in wanted["per_layer"]:
            value = spec.module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {}
        for m in wanted["end_to_end"]:
            value = setup_s if m["name"] == "setup_s" else window[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = loop.check(cell, window)
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": (torch.cuda.get_device_name(0) if on_card else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": all(c["ok"] for c in checks.values()),
           "attempted": window["attempted"], "failed": window["failed"],
           "metrics": metrics, "device": device}
    out["window"] = {k: v for k, v in window.items()
                     if isinstance(v, (int, float))}
    if cell.trace and dt.summary is not None:
        device["busy_s"] = dt.summary.busy_s
        device["window_s"] = dt.summary.window_s
        out["breakdown"] = dt.summary.breakdown()
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    chips = spec.workload(bench, args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cell = make_cell(bench, args.workload, args.seed, "cuda",
                     bool(args.trace))
    out = run_cell(bench, cell, args.seconds)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
