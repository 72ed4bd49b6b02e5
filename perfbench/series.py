"""Run one cell several times, one process a run, and summarise.

    python3 -m perfbench.series --workload <cell> --seeds 11,12,13 \\
        --seconds 20 [--trace 1] [--out chiprun_out/<file>.jsonl]

Each run is ``python3 -m perfbench.run`` with its own seed, one after the
other on this machine's card. The result lines (with each run's exit
code, wall seconds and the end of its standard error) go to ``--out``;
standard output gets one short line a run, then each metric's median and
its spread: the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) over the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def spread(values) -> float:
    if len(values) < 2:
        return 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    print(f"card: {card()}", flush=True)
    runs = []
    out = open(args.out, "a") if args.out else None
    try:
        for seed in seeds:
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "-m", "perfbench.run", "--workload",
                 args.workload, "--seed", str(seed), "--seconds",
                 str(args.seconds), "--trace", str(args.trace)],
                capture_output=True, text=True)
            wall = time.perf_counter() - t0
            lines = p.stdout.strip().splitlines()
            res = None
            if p.returncode == 0 and lines:
                res = json.loads(lines[-1])
            rec = {"workload": args.workload, "seed": seed,
                   "trace": args.trace, "rc": p.returncode, "wall_s": wall,
                   "result": res, "stderr": p.stderr[-4000:]}
            runs.append(rec)
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            if res is None:
                print(f"seed {seed}: rc {p.returncode} wall {wall:.1f} s\n"
                      f"{p.stderr[-3000:]}", flush=True)
                continue
            m = {k: round(v["value"], 6) for k, v in res["metrics"].items()}
            c = {k: v["value"] for k, v in res["checks"].items()}
            print(f"seed {seed}: correct {res['correct']} wall {wall:.1f} s "
                  f"attempted {res['attempted']} failed {res['failed']} "
                  f"peak {res['device']['memory_peak_bytes']} {m} "
                  f"checks {c}"
                  + (f" busy {res['device'].get('busy_s')} window "
                     f"{res['device'].get('window_s')}" if args.trace
                     else ""), flush=True)
    finally:
        if out:
            out.close()
    ok = [r["result"] for r in runs if r["result"] is not None]
    names = sorted({k for r in ok for k in r["metrics"]})
    for n in names:
        vals = [r["metrics"][n]["value"] for r in ok if n in r["metrics"]]
        print(f"{n}: median {statistics.median(vals)!r} spread "
              f"{spread(vals):.4%} over {len(vals)} runs", flush=True)
    return 0 if len(ok) == len(runs) else 1


if __name__ == "__main__":
    sys.exit(main())
