"""Build variants of kernel B2 and time them at its main-path shape.

    python3 tools/tune_b2.py VARIANT [VARIANT ...]

A VARIANT is ``name[@dir]``: ``cells_knn.cu`` of the source directory
``dir`` (default ``raft_tpu_torch/csrc``) built with the package's nvcc
flags, all variants at once into ``build/tune_b2/``. A variant is an
edited copy of the sources::

    cp -r raft_tpu_torch/csrc build/v1   # then edit build/v1/cells_knn.cu
    python3 tools/tune_b2.py base v1@build/v1

Each variant is first held to the plain version on integer data (ids and
distances equal; k = 1, 10 and 17, f32 and bf16 stores), then timed by
CUDA events (median of 5) on operands made on the card from a seed at the
main-path shape of the IVF-Flat search: 6024 cells x 64 query rows, each
list's cells side by side as the probe inversion packs them, 1024 lists
of capacity 4096 with 977 valid rows on average (uniform in [500, 1454]),
d 128, L2: the f32 store at k = 10 and k = 1, and the bf16 store on the
bf16 tier at k = 10; then the f32 store at k = 10 with longer lists
(uniform in [1200, 2300), 14 live tiles on average, as the main path's
probes weight them). The script also prints ptxas' register and spill
lines of the B2 scans and the card line.
"""
import ctypes
import json
import sys

import torch

from tune_common import ROOT, build, card_line, parse, time_ms

sys.path.insert(0, str(ROOT))

from raft_tpu_torch.ops import _build  # noqa: E402
from raft_tpu_torch.ops import fused_knn as fk  # noqa: E402


def use(path):
    lib = ctypes.CDLL(str(path))
    lib.fused_cells_knn_launch.argtypes = fk._CELLS_ARGTYPES
    lib.fused_cells_knn_launch.restype = ctypes.c_int
    fk._cells_lib = lambda: lib


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


def main():
    variants = [parse(s, _build.CSRC_DIR) for s in sys.argv[1:]]
    print(f"card: {card_line()}", flush=True)
    libs = build(variants, "cells_knn.cu", "b2_scan_kernel", "tune_b2", _build.nvcc_path(),
                 _build.NVCC_FLAGS)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    small = operands(g, dev, 16, 1000, 40, 40, 100, 1000, True)
    c, q, db, inv = operands(g, dev, 1024, 4096, 6024, 128, 500, 1455, False)
    db16 = db.to(torch.bfloat16)
    inv_long = torch.arange(4096, device=dev)[None, :] >= torch.randint(
        1200, 2300, (1024, 1), generator=g, device=dev)
    cases = [(k, store) for k in (1, 10, 17) for store in ("f32", "bf16")]

    def args(ops, store):
        cells, qq, y, invalid = ops
        return cells, qq, y.to(torch.bfloat16) if store == "bf16" else y, \
            invalid

    plain = {case: fk._fused_cells_knn_plain(*args(small, case[1]), case[0],
                                             True, case[1] == "bf16", False)
             for case in cases}
    for name, path in libs.items():
        use(path)
        ok = True
        for (k, store), (pd, pi) in plain.items():
            kd, ki = fk._fused_cells_knn_cuda(*args(small, store), k, True,
                                              store == "bf16", False)
            ok = ok and torch.equal(kd, pd) and torch.equal(ki, pi)
        res = {"variant": name, "exact_vs_plain": ok}
        for k in (10, 1):
            res[f"main_k{k}_ms"] = round(time_ms(
                lambda: fk._fused_cells_knn_cuda(c, q, db, inv, k, True,
                                                 False, False)), 3)
        res["main_bf16_k10_ms"] = round(time_ms(
            lambda: fk._fused_cells_knn_cuda(c, q, db16, inv, 10, True, True,
                                             False)), 3)
        res["main_long_k10_ms"] = round(time_ms(
            lambda: fk._fused_cells_knn_cuda(c, q, db, inv_long, 10, True,
                                             False, False)), 3)
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
