"""Run phase 16 of ``chip_smoke.py`` (the breadth modules) alone, on the
card, over phase 4's data and a fresh IVF-Flat build of it.

    python3 tools/breadth_phase.py

It builds the kernels (the IVF-Flat build and its k=1 search need B1 and
B2), makes the 1M x 128 rows and 10,000 queries of ``chip_smoke.py``,
builds the index with 1024 lists and calls ``chip_smoke.breadth_phase``,
whose checks are fatal; then it prints the phase's seconds, its launches
and the peak device memory. About 50 s of build and 15 s of phase.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from raft_tpu_torch.neighbors import ivf_flat  # noqa: E402
from raft_tpu_torch.ops import _build  # noqa: E402


def main() -> None:
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    card = cs.card_line()
    Xh, Qh = cs.make_data(cs.N_ROWS, cs.DIM, cs.N_BLOBS, cs.N_QUERIES)
    X = torch.as_tensor(Xh, device=dev)
    Q = torch.as_tensor(Qh, device=dev)
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=cs.N_LISTS), X)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    launches = cs.breadth_phase(dev, X, Q, index, card)
    print(f"phase 16 alone {time.perf_counter() - t0:.3f} s, launches "
          f"{launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]",
          flush=True)


if __name__ == "__main__":
    main()
