"""Build variants of B2's bf16 tiers (``csrc/cells_mma.cu``) and time them
at the main-path shape.

    python3 tools/tune_b2_mma.py VARIANT [VARIANT ...]

A VARIANT is ``name[@dir]``: ``cells_mma.cu`` of the source directory
``dir`` (default ``raft_tpu_torch/csrc``) built with the package's nvcc
flags, all variants at once into ``build/tune_b2_mma/``. A variant is an
edited copy of the sources; its ``CN`` (read from its ``cells_mma.cu``)
sets the shared-memory count the plan hands its C entry, and a name that
holds ``pw<N>`` stages panels of N features (default ``B2_MMA_PW``)::

    cp -r raft_tpu_torch/csrc build/c1   # then edit build/c1/cells_mma.cu
    python3 tools/tune_b2_mma.py base base-pw128 c1@build/c1

Each variant is first held to the plain version on integer data (ids and
distances equal; k = 1, 10 and 17, bf16 / u8 / int8 / f32 stores, both
bf16 tiers), then timed by CUDA events (median of 5) and by
``torch.profiler`` (the scan kernel's device time) on operands made on
the card from a seed at the main-path shape of the IVF-Flat search: 6024
cells x 64 query rows, each list's cells side by side as the probe
inversion packs them, 1024 lists of capacity 4096 with 977 valid rows on
average (uniform in [500, 1454]), d 128, L2: the split tier on a bf16 and
a u8 store at k = 10, the bf16 tier at k = 10, the split tier at k = 1.
The script also prints ptxas' register and spill lines of the scans and
the card line.
"""
import ctypes
import importlib
import json
import re
import sys

import torch

from tune_common import ROOT, build, card_line, parse, time_ms

sys.path.insert(0, str(ROOT))

from raft_tpu_torch.ops import _build  # noqa: E402

fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")
PW = fk.B2_MMA_PW


def use(path, src, name):
    """Route the bf16 tiers to the variant library at ``path``, with the
    plan's constants read from its source and its name."""
    lib = ctypes.CDLL(str(path))
    lib.fused_cells_mma_launch.argtypes = fk._CELLS_MMA_ARGTYPES
    lib.fused_cells_mma_launch.restype = ctypes.c_int
    fk._cells_mma_lib = lambda: lib
    text = (src / "cells_mma.cu").read_text()
    fk.B2_MMA_CAND = int(re.search(r"constexpr int CN = (\d+);",
                                   text).group(1))
    m = re.search(r"pw(\d+)", name)
    fk.B2_MMA_PW = int(m.group(1)) if m else PW


def operands(g, dev, n_lists, cap, n_cells, d, lo_size, hi_size, integer):
    if integer:
        db = torch.randint(0, 8, (n_lists, cap, d), generator=g, device=dev)
        q = torch.randint(0, 8, (n_cells, 64, d), generator=g, device=dev)
    else:
        db = torch.randn((n_lists, cap, d), generator=g, device=dev)
        q = torch.randn((n_cells, 64, d), generator=g, device=dev)
    sizes = torch.randint(lo_size, hi_size, (n_lists, 1), generator=g,
                          device=dev)
    invalid = torch.arange(cap, device=dev)[None, :] >= sizes
    cells = torch.sort(torch.randint(0, n_lists, (n_cells,), generator=g,
                                     device=dev))[0].to(torch.int32)
    return cells, q.float().contiguous(), db.float().contiguous(), invalid


def as_store(y, store):
    return {"f32": lambda: y, "bf16": lambda: y.to(torch.bfloat16),
            "u8": lambda: y.to(torch.uint8),
            "i8": lambda: (y - 4).to(torch.int8)}[store]()


def scan_ms(fn, reps=5):
    """Device milliseconds per call of the scan kernel (the pre-pass left
    out), from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if "b2_mma_kernel" in e.key)
    return round(us / reps / 1e3, 3) if us > 0 else None


def main():
    variants = [parse(s, _build.CSRC_DIR) for s in sys.argv[1:]]
    print(f"card: {card_line()}", flush=True)
    # One build a source directory; the pw<N> variants share it.
    dirs = {}
    for name, src in variants:
        dirs.setdefault(src, re.sub(r"-?pw\d+", "", name) or name)
    libs = build([(lib, src) for src, lib in dirs.items()], "cells_mma.cu",
                 "b2_mma", "tune_b2_mma", _build.nvcc_path(),
                 _build.NVCC_FLAGS)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    small = operands(g, dev, 16, 1000, 40, 40, 100, 1000, True)
    c, q, db, inv = operands(g, dev, 1024, 4096, 6024, 128, 500, 1455,
                             False)
    db16 = db.to(torch.bfloat16)
    db8 = torch.randint(0, 256, db.shape, generator=g, device=dev).to(
        torch.uint8)
    del db
    cases = [(k, store, qsplit) for k in (1, 10, 17)
             for store in ("bf16", "u8", "i8", "f32")
             for qsplit in (False, True)]

    def args(store):
        cells, qq, y, invalid = small
        return cells, qq, as_store(y, store), invalid

    plain = {case: fk._fused_cells_knn_plain(*args(case[1]), case[0], True,
                                             True, case[2])
             for case in cases}
    for name, src in variants:
        lib = libs.get(dirs[src])
        if lib is None:
            continue
        use(lib, src, name)
        ok = True
        for (k, store, qsplit), (pd, pi) in plain.items():
            kd, ki = fk._fused_cells_knn_cuda(*args(store), k, True, True,
                                              qsplit)
            ok = ok and torch.equal(kd, pd) and torch.equal(ki, pi)
        res = {"variant": name, "pw": fk.B2_MMA_PW, "cn": fk.B2_MMA_CAND,
               "exact_vs_plain": ok}
        for tag, y, k, qsplit in (("split_k10", db16, 10, True),
                                  ("split_u8_k10", db8, 10, True),
                                  ("bf16_k10", db16, 10, False),
                                  ("split_k1", db16, 1, True)):
            def run():
                return fk._fused_cells_knn_cuda(c, q, y, inv, k, True, True,
                                                qsplit)
            res[f"{tag}_ms"] = round(time_ms(run), 3)
            res[f"{tag}_scan_ms"] = scan_ms(run)
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
