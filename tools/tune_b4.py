"""Build variants of kernel B4 and time them at its main-path shape.

    python3 tools/tune_b4.py VARIANT [VARIANT ...]

A VARIANT is ``name[@dir]``: ``pq_scan.cu`` of the source directory
``dir`` (default ``raft_tpu_torch/csrc``) built with the package's nvcc
flags, all variants at once into ``build/tune_b4/``. A variant is an
edited copy of the sources::

    cp -r raft_tpu_torch/csrc build/v1   # then edit build/v1/pq_scan.cu
    python3 tools/tune_b4.py base v1@build/v1

Each variant is first held to the plain version on integer data (ids and
distances equal, k = 1 and 10), then timed by CUDA events (median of 5)
on operands made on the card from a seed at the main-path shape of the
IVF-PQ compressed search: 6024 cells x 64 query rows, 1024 lists of
capacity 4096 with 977 valid slots on average (uniform in [500, 1454]),
rot 128, pq_dim 64, pq_bits 8, f32 tables, L2, k = 10 and k = 1. The
script also prints ptxas' register and spill lines of the B4 kernels and
the card line.
"""
import ctypes
import json
import sys

import torch

from tune_common import ROOT, build, card_line, parse, time_ms

sys.path.insert(0, str(ROOT))

from raft_tpu_torch.ops import _build  # noqa: E402
from raft_tpu_torch.ops import pq_scan as ps  # noqa: E402


def use(path):
    lib = ctypes.CDLL(str(path))
    lib.pq_fused_scan_launch.argtypes = ps._ARGTYPES
    lib.pq_fused_scan_launch.restype = ctypes.c_int
    ps._lib = lambda: lib


def operands(g, dev, n_lists, capp, n_cells, J, L, lo_size, hi_size,
             integer):
    B = 256
    if integer:
        books = torch.randint(-3, 4, (J, B, L), generator=g, device=dev)
        q = torch.randint(-4, 5, (n_cells, 64, J * L), generator=g,
                          device=dev)
    else:
        books = torch.randn((J, B, L), generator=g, device=dev)
        q = torch.randn((n_cells, 64, J * L), generator=g, device=dev)
    lo, hi = ps.book_tables(books.float(), 8)
    codesT = torch.randint(0, B, (n_lists, J, capp), generator=g,
                           device=dev).to(torch.uint8)
    sizes = torch.randint(lo_size, hi_size, (n_lists, 1), generator=g,
                          device=dev)
    invalid = torch.arange(capp, device=dev)[None, :] >= sizes
    cells = torch.randint(0, n_lists, (n_cells,), generator=g, device=dev,
                          dtype=torch.int32)
    return cells, q.float().contiguous(), codesT, lo, hi, invalid


def main():
    variants = [parse(s, _build.CSRC_DIR) for s in sys.argv[1:]]
    print(f"card: {card_line()}", flush=True)
    libs = build(variants, "pq_scan.cu", "b4_scan_kernel", "tune_b4", _build.nvcc_path(),
                 _build.NVCC_FLAGS)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    small = operands(g, dev, 16, 1024, 40, 64, 2, 100, 1000, True)
    main_ops = operands(g, dev, 1024, 4096, 6024, 64, 2, 500, 1455, False)
    plain = {k: ps._pq_fused_scan_plain(*small, k, 64, 8, False)
             for k in (1, 10)}
    for name, path in libs.items():
        use(path)
        ok = all(torch.equal(kd, pd) and torch.equal(ki, pi)
                 for k, (pd, pi) in plain.items()
                 for kd, ki in [ps._pq_fused_scan_cuda(*small, k, 64, 8, False)])
        res = {"variant": name, "exact_vs_plain": ok}
        for k in (10, 1):
            res[f"main_k{k}_ms"] = round(time_ms(
                lambda: ps._pq_fused_scan_cuda(*main_ops, k, 64, 8, False)), 3)
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
