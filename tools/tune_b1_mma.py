"""Build variants of B1's bf16 tiers (``csrc/knn_mma.cu``) and time them
at the k-means assignment shapes.

    python3 tools/tune_b1_mma.py VARIANT [VARIANT ...]

A VARIANT is ``name[@dir]``: ``knn_mma.cu`` of the source directory
``dir`` (default ``raft_tpu_torch/csrc``) built with the package's nvcc
flags, all variants at once into ``build/tune_mma/``. A variant is an
edited copy of the sources; its ``STAGES`` and ``BK`` (read from its
``knn_mma.cu``) set the shared-memory count the plan hands its C entry::

    cp -r raft_tpu_torch/csrc build/s3   # then edit build/s3/knn_mma.cu
    python3 tools/tune_b1_mma.py base s3@build/s3

Each variant is first held to the plain version on integer data (ids and
distances equal: k = 1 at each tile width, k = 10 and 64, the split-
database path, both tiers, L2 and inner product), then timed by CUDA
events (median of 5) on random rows made on the card: the train
assignments 500,000 x 32 and 500,000 x 1024 and Lloyd's 1M x 1000, d =
128, k = 1, on the bf16 and split-bf16 tiers. The script also prints
ptxas' register and spill lines of the scan kernels, the card line, and
once the f32 tier (the FMA scan) and ``addmm`` + ``argmin`` at the same
shapes as the yardsticks.
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


def use(path, src):
    """Route the bf16 tiers to the variant library at ``path``, with the
    plan's constants read from its source."""
    lib = ctypes.CDLL(str(path))
    lib.fused_knn_mma_launch.argtypes = fk._MMA_ARGTYPES
    lib.fused_knn_mma_launch.restype = ctypes.c_int
    fk._mma_lib = lambda: lib
    text = (src / "knn_mma.cu").read_text()
    for name, attr in (("STAGES", "B1_MMA_STAGES"), ("BK", "B1_MMA_BK")):
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        setattr(fk, attr, int(m.group(1)))
    fk.B1_MMA_SA = fk.B1_MMA_BK + 8


def main():
    variants = [parse(s, _build.CSRC_DIR) for s in sys.argv[1:]]
    print(f"card: {card_line()}", flush=True)
    libs = build(variants, "knn_mma.cu", "b1_mma", "tune_mma",
                 _build.nvcc_path(), _build.NVCC_FLAGS)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    X = 3.0 * torch.randn((1_000_000, 128), generator=g, device=dev)
    T = X[::2].contiguous()
    C1024 = X[::977][:1024].contiguous()
    shapes = {"train_500k_x_32": (T, C1024[::32].contiguous()),
              "train_500k_x_1024": (T, C1024),
              "lloyd_1M_x_1000": (X, C1024[:1000].contiguous())}
    checks = []
    for m, n, d, k, hi in ((3000, 32, 128, 1, 8), (2000, 64, 128, 1, 8),
                           (4000, 1000, 128, 1, 8), (129, 200_000, 96, 10, 2),
                           (100, 5000, 33, 64, 8), (2000, 1000, 1024, 1, 8)):
        q = torch.randint(0, hi, (m, d), generator=g, device=dev).float()
        y = torch.randint(0, hi, (n, d), generator=g, device=dev).float()
        for l2 in (True, False):
            for qsplit in (False, True):
                checks.append(((q, y, k, l2, True, qsplit),
                               fk._fused_knn_plain(q, y, k, l2, True, qsplit)))
    for name, src in variants:
        if name not in libs:
            continue
        use(libs[name], src)
        ok = all(torch.equal(kd, pd) and torch.equal(ki, pi)
                 for args, (pd, pi) in checks
                 for kd, ki in [fk._fused_knn_cuda(*args)])
        res = {"variant": name, "exact_vs_plain": ok}
        for s, (a, c) in shapes.items():
            for tier, qsplit in (("bf16", False), ("split", True)):
                ms = time_ms(lambda: fk._fused_knn_cuda(a, c, 1, True, True,
                                                        qsplit))
                ops = 2.0 * a.shape[0] * c.shape[0] * a.shape[1] * (
                    2 if qsplit else 1)
                res[f"{s}_{tier}"] = {"ms": round(ms, 4),
                                      "tflops": round(ops / ms / 1e9, 1)}
        print(json.dumps(res), flush=True)
    base = {}
    for s, (a, c) in shapes.items():
        cn = torch.sum(c * c, dim=1)
        base[s] = {
            "f32_fma_ms": round(time_ms(lambda: fk._fused_knn_cuda(
                a, c, 1, True, False, False)), 4),
            "addmm_argmin_ms": round(time_ms(lambda: torch.argmin(
                torch.addmm(cn, a, c.t(), alpha=-2.0), dim=1)), 4)}
    print(json.dumps({"yardsticks": base}), flush=True)


if __name__ == "__main__":
    main()
