"""Bid rounds and time per round of the auction LAP at phase 19 (a)'s
shapes, with the rounds as a CUDA graph or issued eagerly.

    python3 tools/lap_rounds.py [cpu|cuda] [batch] [n] [mode,mode,...]

Makes ``chip_smoke.py``'s phase-19 (a) costs (integer in [0, 100), then
uniform float; ``batch`` x ``n`` x ``n``, default 8 x 1024), solves each
set with ``LinearAssignmentProblem`` and the first slice with ``lap``,
and prints the bid rounds issued (the rounds between two host checks
are ``_CHECK_EVERY``, so counts move in steps of it, frozen problems
included), the seconds (host clock around a synchronise) and the time
per round. The modes (default ``graph,eager,eager,graph`` on ``cuda``,
``eager`` on the CPU) run the whole set once each, in order: ``graph``
as ``_auction`` runs on the card, ``eager`` with the capture skipped, so
the same rounds are issued one kernel at a time. Each mode's answers
must equal the first mode's.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from raft_tpu_torch.solver import LinearAssignmentProblem, lap  # noqa: E402
from raft_tpu_torch.solver import linear_assignment as la  # noqa: E402


def main() -> None:
    dev = torch.device(sys.argv[1] if len(sys.argv) > 1 else "cpu")
    B = int(sys.argv[2]) if len(sys.argv) > 2 else cs.LAP_19[0]
    n = int(sys.argv[3]) if len(sys.argv) > 3 else cs.LAP_19[1]
    modes = (sys.argv[4] if len(sys.argv) > 4 else
             "graph,eager,eager,graph" if dev.type == "cuda" else
             "eager").split(",")
    calls = [0]
    rounds, capture = la._Auction.rounds, la._Auction.capture

    def counting(self):
        calls[0] += 1
        rounds(self)

    la._Auction.rounds = counting
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(cs.SEED + 190)
    costs = {"integer": rng.integers(0, cs.LAP_INT_19, (B, n, n)).astype(
        np.float32), "float": rng.random((B, n, n), dtype=np.float32)}
    first = {}
    for mode in modes:
        la._Auction.capture = (capture if mode == "graph"
                               else lambda self: None)
        for kind, ch in costs.items():
            C = torch.as_tensor(ch, device=dev)
            for what, fn in (("batch", lambda: LinearAssignmentProblem(
                    n, B)), ("lap, slice 0", None)):
                calls[0] = 0
                sync()
                t0 = time.perf_counter()
                if fn is None:
                    got = lap(C[0])[0]
                else:
                    p = fn()
                    p.solve(C)
                    got = p._row_assignments
                sync()
                secs = time.perf_counter() - t0
                r = calls[0] * la._CHECK_EVERY
                ref = first.setdefault((kind, what), got)
                if not torch.equal(got, ref):
                    raise AssertionError(f"{mode} {kind} {what}: the "
                                         f"assignment differs from "
                                         f"{modes[0]}'s")
                print(f"{mode} {kind} {what} ({B if what == 'batch' else 1}"
                      f" x {n} x {n}): {r} rounds, {secs:.3f} s, "
                      f"{secs / r * 1e6:.1f} us a round [{dev}]", flush=True)
    la._Auction.rounds, la._Auction.capture = rounds, capture


if __name__ == "__main__":
    main()
