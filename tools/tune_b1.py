"""Build variants of kernel B1's f32 tier (``csrc/knn_tf32.cu``, the 3xTF32
tensor-core scan) and time them at its main-path shapes (the bf16 tiers
are csrc/knn_mma.cu, see tune_b1_mma.py).

    python3 tools/tune_b1.py VARIANT [VARIANT ...]

A VARIANT is ``name[@dir]``: ``knn_tf32.cu`` of the source directory
``dir`` (default ``raft_tpu_torch/csrc``) built with the package's nvcc
flags, all variants at once into ``build/tune/``. A variant is an edited
copy of the sources; its ``STAGES``, ``BK``, ``SF`` and ``CN`` (read from
its ``knn_tf32.cu``) set the shared-memory count the plan hands its C
entry::

    cp -r raft_tpu_torch/csrc build/s3   # then edit build/s3/knn_tf32.cu
    python3 tools/tune_b1.py base s3@build/s3

Each variant is first held to the plain version on integer data (the
split path at k=10, k=1 against 32 centers, a 16-row request at k=100;
ids and distances equal) and to float64 (``f64_ratio``: its largest
distance error against float64 over that of the plain version's full-f32
product, as tests/test_torch_kernels_cuda.py's float64 test measures it,
on Gaussian rows and chip_smoke.py's blobs at d 128 and 1024, k=10, L2
and inner product; the test's bar is 4), then timed by CUDA events (median of 5) with
random data made on the card: the brute-force shape (10,000 x 1M x 128,
k=10, 1 and 64), the k=1 assignments of 500,000 rows against 32 and 1024
centers, and a 16-row request against the 1M rows at k=10 and 100. The
script also prints ptxas' register and spill lines of the scan kernels,
the card line, the SM clock and power drawn under a B1 run, and the rates
of a cuBLAS 8192^3 matrix product with TF32 off and on as what this card
reaches outside B1.
"""
import ctypes
import importlib
import json
import re
import subprocess
import sys

import torch

from tune_common import ROOT, build, card_line, parse, time_ms

sys.path.insert(0, str(ROOT))

from raft_tpu_torch.ops import _build  # noqa: E402

fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")


def use(path, src):
    """Route the f32 tier to the variant library at ``path``, with the
    plan's constants read from its source."""
    lib = ctypes.CDLL(str(path))
    lib.fused_knn_tf32_launch.argtypes = fk._TF32_ARGTYPES
    lib.fused_knn_tf32_launch.restype = ctypes.c_int
    fk._tf32_lib = lambda: lib
    text = (src / "knn_tf32.cu").read_text()
    for name, attr in (("STAGES", "B1_TF32_STAGES"), ("BK", "B1_TF32_BK"),
                       ("CN", "B1_TF32_CAND")):
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        setattr(fk, attr, int(m.group(1)))
    m = re.search(r"constexpr int SF = BK \+ (\d+);", text)
    fk.B1_TF32_SF = fk.B1_TF32_BK + int(m.group(1))


def f64_err(q, db, d, i, l2):
    """Largest |d - the float64 distance of the same (query, id) pair|."""
    q64, y = q.double(), db.double()[i.long().clamp_min(0)]
    ref = (torch.sum((q64[:, None, :] - y) ** 2, dim=2) if l2
           else -torch.sum(q64[:, None, :] * y, dim=2))
    return float(torch.max(torch.abs(d.double() - ref)[i >= 0]))


def accuracy_cases(dev):
    """(name, q, db) of the float64 check: Gaussian rows and blobs."""
    import numpy as np

    import chip_smoke

    rng = np.random.default_rng(3)
    out = []
    for d in (128, 1024):
        x = rng.standard_normal((20_000, d), dtype=np.float32)
        q = rng.standard_normal((200, d), dtype=np.float32)
        out.append((f"gauss{d}", q, x))
        x, q = chip_smoke.make_data(20_000, d, 50, 200, seed=d)
        out.append((f"blobs{d}", q, x))
    return [(n, torch.as_tensor(q, device=dev), torch.as_tensor(x, device=dev))
            for n, q, x in out]


def main():
    variants = [parse(s, _build.CSRC_DIR) for s in sys.argv[1:]]
    print(f"card: {card_line()}", flush=True)
    libs = build(variants, "knn_tf32.cu", "b1_tf32", "tune",
                 _build.nvcc_path(), _build.NVCC_FLAGS)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    X = torch.randn((1_000_000, 128), generator=g, device=dev)
    Q = torch.randn((10_000, 128), generator=g, device=dev)
    C = X[::977][:1024].contiguous()
    T = X[:500_000]
    qi = torch.randint(0, 2, (129, 96), generator=g, device=dev).float()
    yi = torch.randint(0, 2, (200_000, 96), generator=g, device=dev).float()
    ci = torch.randint(0, 8, (3000, 128), generator=g, device=dev).float()
    checks = [(qi, yi, 10, False), (ci, ci[:32].contiguous(), 1, False),
              (qi[:16].contiguous(), yi, 100, False)]
    plain = [fk._fused_knn_plain(a, b, k, True, bf, bf)
             for a, b, k, bf in checks]
    Q16 = Q[:16].contiguous()
    shapes = {"bf_k10_f32": (Q, X, 10, False), "bf_k1_f32": (Q, X, 1, False),
              "bf_k64_f32": (Q, X, 64, False),
              "train32_k1_f32": (T, C[:32].contiguous(), 1, False),
              "train1024_k1_f32": (T, C, 1, False),
              "req16_k10_f32": (Q16, X, 10, False),
              "req16_k100_f32": (Q16, X, 100, False)}
    acc = accuracy_cases(dev)
    plain_acc = {(case, l2): fk._fused_knn_plain(a, b, 10, l2, False, False)
                 for case, a, b in acc for l2 in (True, False)}
    srcs = dict(variants)
    for name, path in libs.items():
        use(path, srcs[name])
        ok = all(
            torch.equal(kd, pd) and torch.equal(ki, pi)
            for (a, b, k, bf), (pd, pi) in zip(checks, plain)
            for kd, ki in [fk._fused_knn_cuda(a, b, k, True, bf, bf)])
        res = {"variant": name, "exact_vs_plain": ok, "f64_ratio": {}}
        for case, a, b in acc:
            for l2 in (True, False):
                kd, ki = fk._fused_knn_cuda(a, b, 10, l2, False, False)
                pd, pi = plain_acc[(case, l2)]
                res["f64_ratio"][f"{case}_{'l2' if l2 else 'ip'}"] = round(
                    f64_err(a, b, kd, ki, l2) / f64_err(a, b, pd, pi, l2), 3)
        for s, (a, b, k, bf) in shapes.items():
            try:
                ms = time_ms(lambda: fk._fused_knn_cuda(a, b, k, True, bf, bf))
            except Exception as e:  # a variant whose CTA does not fit
                res[s] = str(e)
                continue
            ops = 2.0 * a.shape[0] * b.shape[0] * a.shape[1]
            res[s] = {"ms": round(ms, 3), "tflops": round(ops / ms / 1e9, 2)}
        for _ in range(5):
            fk._fused_knn_cuda(Q, X, 10, True, False, False)
        res["under_load"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        torch.cuda.synchronize()
        print(json.dumps(res), flush=True)
    a = torch.randn((8192, 8192), generator=g, device=dev)
    rates = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        ms = time_ms(lambda: torch.mm(a, a))
        rates[f"cublas_8192_{'tf32' if tf32 else 'sgemm'}_tflops"] = round(
            2 * 8192 ** 3 / ms / 1e9, 2)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(rates), flush=True)


if __name__ == "__main__":
    main()
