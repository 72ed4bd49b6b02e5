"""The controls and planted faults of the correctness check, read on the
chip.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3 \\
        --variants program,search,build --seconds 3 \\
        [--out chiprun_out/<file>.jsonl]

For each seed, in one process, the cell runs once a variant, whole
(set-up, window, check) through ``run.run_cell`` at its own sizes with a
short window, and one line is printed a (seed, variant): whether the run
came out correct, and each number compared. The variants:

* ``program``: the cell as it is (the sound runs' readings);
* ``search``: the search's control: the reference one precision below
  the configuration's (``control_search`` of the cell's reference,
  TF32-rounded products) in the program's place, or, where the system
  has a lower path of its own (``CONTROL_PATH`` of its adapter: IVF-PQ's
  int8 look-up tables), that path;
* ``build``: the index's control: inside the port's build, the rows'
  assignment to the centres (and IVF-PQ's encoding) by the reference in
  TF32;
* ``unchanged``: a planted fault: the coarse k-means returns the centres
  it was initialised with (``kmeans_balanced``'s strided sample);
* ``books_unchanged``: a planted fault (IVF-PQ): the codebooks' training
  returns its initial codebooks;
* ``iters1``: the build at one k-means iteration in place of the
  configuration's (a reading, to see what the training checks resolve).

The limits in the configurations sit between the program's readings and
the controls' and faults'. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from types import SimpleNamespace

from perfbench import spec
from perfbench.run import make_cell, run_cell


def _port(name: str):
    return importlib.import_module("raft_tpu_torch." + name)


def _patch(cell, obj, name: str, value) -> None:
    """Set ``obj.name`` for this run; :func:`restore` puts it back."""
    cell.state.setdefault("_restore", []).append(
        (obj, name, getattr(obj, name)))
    setattr(obj, name, value)


def _own_system(cell) -> SimpleNamespace:
    """A copy of the cell's system adapter whose entries can be replaced
    without touching the module."""
    sysm = cell.system
    cell.system = SimpleNamespace(**{k: getattr(sysm, k) for k in dir(sysm)
                                     if not k.startswith("__")})
    return cell.system


def install_search(cell) -> None:
    """The search's control in the program's place."""
    sysm, ref = cell.system, cell.reference
    ctl = _own_system(cell)
    lower = getattr(sysm, "CONTROL_PATH", None)
    if lower is not None:
        ctl.search = lambda index, cfg, Q, k: sysm.search(
            index, cfg, Q, k, **lower)
    else:
        cache = {}

        def search(index, cfg, Q, k):
            if id(index) not in cache:
                cache.clear()
                snap = sysm.snapshot(index, keep_data=False)
                cache[id(index)] = ref.prepare(snap, cell.state["X"], cfg)
            return ref.control_search(cache[id(index)], Q, k, cfg)

        ctl.search = search


def install_build(cell) -> None:
    """The index's control: the build's row assignment (and IVF-PQ's
    encoding) by the reference in TF32."""
    import torch

    flat = spec.module("reference", "ivf_flat")
    _patch(cell, _port("cluster.kmeans_balanced"), "_predict",
           lambda params, centroids, X: flat.control_labels(
               X, centroids).to(torch.int32))
    if cell.cfg["system"] == "ivf_pq":
        _patch(cell, _port("neighbors.ivf_pq"), "_nearest_code",
               spec.module("reference", "ivf_pq").control_nearest_code)


def install_unchanged(cell) -> None:
    """The coarse k-means returns its initial centres unchanged."""
    def initial(params, X, n_clusters):
        return X[::max(X.shape[0] // n_clusters, 1)][:n_clusters].clone()

    _patch(cell, _port("cluster.kmeans_balanced"), "_fit", initial)


def install_books_unchanged(cell) -> None:
    """The codebooks' training returns its initial codebooks."""
    mod = _port("neighbors.ivf_pq")
    train = mod._vq_train_batched
    _patch(cell, mod, "_vq_train_batched",
           lambda data, weights, book_size, n_iters, init=None: train(
               data, weights, book_size, 0, init=init))


def install_iters1(cell) -> None:
    """The build at one k-means iteration (the reference keeps the
    configuration's)."""
    build = cell.system.build
    _own_system(cell).build = lambda cfg, X: build(
        dict(cfg, kmeans_n_iters=1), X)


VARIANTS = {"program": None, "search": install_search,
            "build": install_build, "unchanged": install_unchanged,
            "books_unchanged": install_books_unchanged,
            "iters1": install_iters1}


def restore(cell) -> None:
    for obj, name, value in reversed(cell.state.pop("_restore", [])):
        setattr(obj, name, value)


def run_variant(bench: dict, cell, variant: str, seconds: float) -> dict:
    """One whole run of ``cell`` with ``variant`` installed."""
    if VARIANTS[variant] is not None:
        VARIANTS[variant](cell)
    try:
        return run_cell(bench, cell, seconds, time.perf_counter())
    finally:
        restore(cell)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="program,search,build")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    bench = spec.load_benchmark()
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            for variant in args.variants.split(","):
                cell = make_cell(bench, args.workload, seed, "cuda", False)
                res = run_variant(bench, cell, variant, args.seconds)
                del cell
                torch.cuda.empty_cache()
                rec = {"workload": args.workload, "seed": seed,
                       "variant": variant, "correct": res["correct"],
                       "readings": {k: v["value"]
                                    for k, v in res["checks"].items()},
                       "window": res["window"]}
                print(json.dumps(rec), flush=True)
                if out:
                    out.write(json.dumps(rec) + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
