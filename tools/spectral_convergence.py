"""How far the spectral ``partition`` converges at the Lanczos defaults,
by graph size.

    python3 tools/spectral_convergence.py [cpu|cuda] [n ...]

For each n (default 2000 3000 4000 6000 8000) it builds ``chip_smoke``'s
phase-19 (e) graph at that size: 8 Gaussian blobs in 16 dimensions, the
symmetrised kNN graph (k=15, unit weights) and seeded unit edges between
consecutive blobs, their number scaled with the blob size (600 at 4000
vertices) so the 8 smallest Laplacian eigenvalues keep their spread
below the 9th. Then it runs ``spectral.partition`` (Lanczos with ncv =
4k + 32 = 64, no restart, as the reference) and prints, beside the
float64 spectrum and the host's seconds for it, the largest float64
residual |L u - w u| / ||L|| of the 8 Ritz pairs and the ARI against
the blobs. Phase 19 holds the residuals to 1e-3 ||L||.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from raft_tpu_torch.spectral import partition  # noqa: E402
from raft_tpu_torch.stats import adjusted_rand_index  # noqa: E402


def main() -> None:
    dev = torch.device(sys.argv[1] if len(sys.argv) > 1 else "cpu")
    sizes = [int(a) for a in sys.argv[2:]] or [2000, 3000, 4000, 6000, 8000]
    rows0, dim, blobs, k = cs.SPEC_19
    bridges0 = cs.SPEC_BRIDGES_19
    for n in sizes:
        cs.SPEC_19 = (n, dim, blobs, k)
        cs.SPEC_BRIDGES_19 = round(bridges0 * n / rows0)
        A, y = cs._spectral_graph_19(dev)
        Ah = cs._host_sparse_19(A)
        Lh = np.diag(np.asarray(Ah.sum(1)).ravel()) - Ah.toarray()
        t0 = time.perf_counter()
        lam = np.linalg.eigvalsh(Lh)
        eig_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        labels, w, U = partition(A, blobs)
        secs = time.perf_counter() - t0
        Ud, wd = U.double().cpu().numpy(), w.double().cpu().numpy()
        resid = max(float(np.linalg.norm(Lh @ Ud[:, j] - wd[j] * Ud[:, j]))
                    for j in range(blobs)) / float(lam[-1])
        ari = float(adjusted_rand_index(y, labels))
        print(f"n {n}, {cs.SPEC_BRIDGES_19} bridges a pair: 8 smallest "
              f"{np.round(lam[:blobs], 4).tolist()}, the 9th {lam[blobs]:.4f}, "
              f"||L|| {lam[-1]:.2f} (host eigvalsh {eig_s:.2f} s); "
              f"partition {secs:.3f} s, largest "
              f"residual {resid:.3e} ||L||, ARI {ari:.6f} [{dev}]",
              flush=True)
    cs.SPEC_19, cs.SPEC_BRIDGES_19 = (rows0, dim, blobs, k), bridges0


if __name__ == "__main__":
    main()
