"""Build variants of kernel B1 and time them at its main-path shapes.

    python3 tools/tune_b1.py VARIANT [VARIANT ...]

A VARIANT is ``name[@dir]``: ``fused_knn.cu`` of the source directory
``dir`` (default ``raft_tpu_torch/csrc``) built with the package's nvcc
flags, all variants at once into ``build/tune/``. A variant is an edited
copy of the sources, for example ``knn_gemm.cuh`` with another chunk depth
``BK`` or another minimum of blocks in ``__launch_bounds__``::

    cp -r raft_tpu_torch/csrc build/bk32   # then edit build/bk32
    python3 tools/tune_b1.py base bk32@build/bk32
 Each variant is first held to the plain
version on integer data (the split path and k=1, ids and distances equal),
then timed by CUDA events (median of 5) with random data made on the card:
the brute-force shape (10,000 x 1M x 128, k=10, 1 and 64, f32) and the k=1
assignments of 500,000 rows against 1024 centers (f32 and split-bf16). The
script also prints ptxas' register and spill lines of the B1 scan kernels,
the card line, the SM clock and power drawn under a B1 run, and the FP32
rate of a cuBLAS 8192^3 matrix product (TF32 off) as what this card
reaches outside B1.
"""
import ctypes
import importlib
import json
import subprocess
import sys

import torch

from tune_common import ROOT, build, card_line, parse, time_ms

sys.path.insert(0, str(ROOT))

from raft_tpu_torch.ops import _build  # noqa: E402

fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")


def use(path):
    lib = ctypes.CDLL(str(path))
    lib.fused_knn_launch.argtypes = fk._KNN_ARGTYPES
    lib.fused_knn_launch.restype = ctypes.c_int
    fk._lib = lambda: lib


def main():
    variants = [parse(s, _build.CSRC_DIR) for s in sys.argv[1:]]
    print(f"card: {card_line()}", flush=True)
    libs = build(variants, "fused_knn.cu", "b1_scan_kernel", "tune", _build.nvcc_path(),
                 _build.NVCC_FLAGS)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    X = torch.randn((1_000_000, 128), generator=g, device=dev)
    Q = torch.randn((10_000, 128), generator=g, device=dev)
    C = X[::977][:1024].contiguous()
    T = X[:500_000]
    qi = torch.randint(0, 2, (129, 96), generator=g, device=dev).float()
    yi = torch.randint(0, 2, (200_000, 96), generator=g, device=dev).float()
    checks = [(qi, yi, k, bf16) for k in (1, 10) for bf16 in (False, True)]
    plain = [fk._fused_knn_plain(a, b, k, True, bf, bf)
             for a, b, k, bf in checks]
    shapes = {"bf_k10_f32": (Q, X, 10, False), "bf_k1_f32": (Q, X, 1, False),
              "bf_k64_f32": (Q, X, 64, False),
              "train1024_k1_f32": (T, C, 1, False),
              "train1024_k1_split_bf16": (T, C, 1, True)}
    for name, path in libs.items():
        use(path)
        ok = all(
            torch.equal(kd, pd) and torch.equal(ki, pi)
            for (a, b, k, bf), (pd, pi) in zip(checks, plain)
            for kd, ki in [fk._fused_knn_cuda(a, b, k, True, bf, bf)])
        res = {"variant": name, "exact_vs_plain": ok}
        for s, (a, b, k, bf) in shapes.items():
            try:
                ms = time_ms(lambda: fk._fused_knn_cuda(a, b, k, True, bf, bf))
            except Exception as e:  # a variant whose CTA does not fit
                res[s] = str(e)
                continue
            ops = 2.0 * a.shape[0] * b.shape[0] * a.shape[1] * (2 if bf else 1)
            res[s] = {"ms": round(ms, 3), "tflops": round(ops / ms / 1e9, 2)}
        for _ in range(5):
            fk._fused_knn_cuda(Q, X, 10, True, False, False)
        res["under_load"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        torch.cuda.synchronize()
        print(json.dumps(res), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.randn((8192, 8192), generator=g, device=dev)
    ms = time_ms(lambda: torch.mm(a, a))
    print(json.dumps({"cublas_sgemm_8192_tflops":
                      round(2 * 8192 ** 3 / ms / 1e9, 2)}), flush=True)


if __name__ == "__main__":
    main()
