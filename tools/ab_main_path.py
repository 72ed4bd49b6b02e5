"""Time the IVF-Flat main-path search and the two selections under it,
for the raft_tpu_torch found at a given repository root.

    python3 tools/ab_main_path.py <repository root>

To compare two commits on one card, unpack the parent into a gitignored
directory (``git archive <parent> | tar -x -C build/parent``) and run, in
one go on one card, parent, change, change, parent::

    for r in build/parent . . build/parent; do
        python3 tools/ab_main_path.py $r; done

Each run builds the 1M x 128 IVF-Flat index of that root's
``chip_smoke.py`` (1024 lists) and prints the median search time of
10,000 queries at 32 probes, and the ``select_k`` times of a 10,000 x
1024 selection of 32 (the coarse probe) and a 10,000 x 320 selection of
10 (the final merge), by CUDA events.
"""
import sys

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from raft_tpu_torch.matrix.select_k import select_k  # noqa: E402
from raft_tpu_torch.neighbors import ivf_flat  # noqa: E402

dev = torch.device("cuda")
Xh, Qh = cs.make_data(cs.N_ROWS, cs.DIM, cs.N_BLOBS, cs.N_QUERIES)
X, Q = torch.as_tensor(Xh, device=dev), torch.as_tensor(Qh, device=dev)
index = ivf_flat.build(ivf_flat.IndexParams(n_lists=cs.N_LISTS), X)
sp = ivf_flat.SearchParams(n_probes=cs.N_PROBES)
g = torch.Generator(device=dev)
g.manual_seed(1)
a = torch.randn((10000, 1024), generator=g, device=dev)
b = torch.randn((10000, 320), generator=g, device=dev)
out = {"search_ms": cs.time_ms(lambda: ivf_flat.search(sp, index, Q, cs.K),
                               11),
       "select_10000x1024_k32_ms": cs.time_ms(lambda: select_k(a, 32), 21),
       "select_10000x320_k10_ms": cs.time_ms(lambda: select_k(b, 10), 21)}
print(sys.argv[1], out, flush=True)
