"""What the kernel tuning tools (``tune_b1.py``, ``tune_b2.py``,
``tune_b4.py``) share: variant specs, one parallel ``nvcc`` per variant
with ptxas' register and spill report, and CUDA-event timing."""
import re
import subprocess
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def parse(spec, default):
    """``name[@dir]`` -> (name, source directory, ``default`` without)."""
    name, _, src = spec.partition("@")
    return name, Path(src) if src else default


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def build(variants, source, kernel, out, nvcc, flags):
    """Build ``source`` (a file name) of every (name, dir) variant into
    ``build/<out>/lib<name>.so`` at once with ``nvcc`` and ``flags``;
    print each build's time and the registers and spill stores of the
    entry functions whose name holds ``kernel``. Returns {name: path} of
    the variants that built."""
    out = ROOT / "build" / out
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in variants:
        lib = out / f"lib{name}.so"
        cmd = [nvcc, *flags, "-o", str(lib), str(src / source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib, time.perf_counter())
    libs = {}
    for name, (proc, lib, t0) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: build failed\n{text[-4000:]}", flush=True)
            continue
        regs, spills, kern = [], [], None
        for line in text.splitlines():
            if "entry function" in line:
                kern = line
            elif kern and kernel in kern:
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    regs.append(int(m.group(1)))
                m = re.search(r"(\d+) bytes spill stores", line)
                if m:
                    spills.append(int(m.group(1)))
        print(f"{name}: built in {time.perf_counter() - t0:.1f} s; "
              f"{kernel} registers {sorted(set(regs))}, spill stores "
              f"{sorted(set(spills))}", flush=True)
        libs[name] = lib
    return libs


def time_ms(fn, reps=5):
    """Median milliseconds of ``fn()`` by CUDA events, after one call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]
